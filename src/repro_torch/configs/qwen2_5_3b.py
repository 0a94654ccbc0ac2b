"""qwen2.5-3b [dense] — hf:Qwen/Qwen2.5-3B family (GQA, QKV bias).

36L d_model=2048 16H (GQA kv=2) d_ff=11008 vocab=151936."""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    d_ff=11008,
    vocab=151936,
    act="silu",
    glu=True,
    qkv_bias=True,
    rope_theta=1000000.0,
    tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, name="qwen2.5-3b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_head=16, d_ff=128, vocab=256, dtype="float32",
    remat=False)
