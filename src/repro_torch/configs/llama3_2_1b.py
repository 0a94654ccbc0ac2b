"""llama3.2-1b [dense] — hf:meta-llama/Llama-3.2-1B.

16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256.
Canonical NeCTAr target: the ReLU-sparse + int8 decode path applies
directly (enable with relu_sparse=True variants in examples)."""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab=128256,
    act="silu",
    glu=True,
    rope_theta=500000.0,
    tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, name="llama3.2-1b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_head=16, d_ff=128, vocab=256, dtype="float32",
    remat=False)
