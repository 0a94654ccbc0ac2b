"""llama4-maverick-400b-a17b [moe] — hf:meta-llama/Llama-4 family.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 (per expert) vocab=202048,
MoE 128 experts top-1 + 1 shared expert, INTERLEAVED with dense layers
(HF interleave_moe_layer_step=2 — all-MoE would be ~775B params; the
alternating pattern lands at the named ~400B total / ~17B active).
Expert routing composes with the paper's ReLU sparsity (DESIGN.md §5).
Trains with 8-bit Adam moments so optimizer state fits the single-pod
HBM budget."""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    act="silu",
    glu=True,
    rope_theta=500000.0,
    n_experts=128,
    top_k=1,
    n_shared_experts=1,
    d_head=128,
    block_pattern=("attn", "moe"),
)

SMOKE = dataclasses.replace(
    CONFIG, name="llama4-maverick-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_head=16, d_ff=96, vocab=256, n_experts=8, top_k=1,
    n_shared_experts=1, dtype="float32", remat=False)
