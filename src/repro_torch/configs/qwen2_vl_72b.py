"""qwen2-vl-72b [vlm] — arXiv:2409.12191 (M-RoPE, dynamic resolution).

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.
Backbone only: the vision frontend is a stub — the caller passes
precomputed patch embeddings (``vision_embeds``), added to the first
positions, and the M-RoPE positions (``mrope_positions``) as model
inputs."""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab=152064,
    act="silu",
    glu=True,
    qkv_bias=True,
    mrope=True,
    rope_theta=1000000.0,
    frontend="vision_stub",
)

SMOKE = dataclasses.replace(
    CONFIG, name="qwen2-vl-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_head=16, d_ff=128, vocab=256, dtype="float32",
    remat=False)
