"""The paper's own end-to-end model: 1.7M-parameter ReLU-Llama trained on
TinyStories (paper §V-A). Same values as the reference config."""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nectar-relu-llama-1.7m",
    family="dense",
    n_layers=6,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_ff=640,
    vocab=2048,
    act="relu",
    glu=False,
    rope_theta=10000.0,
    tie_embeddings=True,
    relu_sparse=True,
    sparse_k_frac=0.25,
    int8_weights=True,
    dtype="float32",
    remat=False,
)

SMOKE = dataclasses.replace(CONFIG, name="nectar-relu-llama-smoke")

# Scaled-down draft model for speculative decoding (repro_torch.spec): the
# target's vocab, about 8x fewer parameters.
DRAFT = dataclasses.replace(
    CONFIG,
    name="nectar-relu-llama-draft",
    n_layers=2,
    d_model=64,
    n_heads=2,
    n_kv_heads=2,
    d_ff=256,
)
