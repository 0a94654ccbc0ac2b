"""granite-34b [dense] — arXiv:2405.04324 (llama-arch, code; MQA kv=1).

88L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152.
MQA means the decode KV cache cannot be head-sharded — the framework
sequence-shards it with distributed-LSE attention (DESIGN.md §4)."""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab=49152,
    act="silu",
    glu=True,
    rope_theta=10000.0,
)

SMOKE = dataclasses.replace(
    CONFIG, name="granite-34b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=1, d_head=16, d_ff=192, vocab=256, dtype="float32",
    remat=False)
