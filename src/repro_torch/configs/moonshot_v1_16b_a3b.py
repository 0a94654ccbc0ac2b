"""moonshot-v1-16b-a3b [moe] — hf:moonshotai/Moonlight-16B-A3B family.

48L d_model=2048 16H (kv=16, MHA) d_ff=1408 (per expert) vocab=163840,
MoE 64 experts top-6 + 2 shared experts (DeepSeek-style fine-grained)."""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=163840,
    act="silu",
    glu=True,
    rope_theta=50000.0,
    n_experts=64,
    top_k=6,
    n_shared_experts=2,
)

SMOKE = dataclasses.replace(
    CONFIG, name="moonshot-v1-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_head=16, d_ff=48, vocab=256, n_experts=8, top_k=2,
    n_shared_experts=1, dtype="float32", remat=False)
