"""qwen3-4b [dense] — hf:Qwen/Qwen3-4B family (qk_norm, GQA).

36L d_model=2560 32H (GQA kv=8) d_ff=9728 vocab=151936."""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=9728,
    vocab=151936,
    act="silu",
    glu=True,
    qk_norm=True,
    rope_theta=1000000.0,
    tie_embeddings=True,
    d_head=128,
)

SMOKE = dataclasses.replace(
    CONFIG, name="qwen3-4b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_head=16, d_ff=128, vocab=256, dtype="float32",
    remat=False)
