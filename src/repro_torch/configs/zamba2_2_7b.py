"""zamba2-2.7b [hybrid] — arXiv:2411.15242 (Mamba2 + shared attn blocks).

54L d_model=2560 32H (kv=32, MHA in the shared block) d_ff=10240
vocab=32000, ssm_state=64. Pattern unit: 5 Mamba2 blocks + 1 invocation of
the SHARED attention+FFN block (params shared across all 9 invocations).
Runs long_500k: Mamba2 state is O(1); the shared-attn KV is
sequence-sharded with distributed-LSE combine."""

import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    act="gelu",
    glu=True,
    rope_theta=10000.0,
    ssm_state=64,
    ssm_expand=2,
    ssm_conv=4,
    block_pattern=("mamba2", "mamba2", "mamba2", "mamba2", "mamba2",
                   "shared_attn"),
)

SMOKE = dataclasses.replace(
    CONFIG, name="zamba2-smoke", n_layers=6, d_model=64, n_heads=4,
    n_kv_heads=4, d_head=16, d_ff=128, vocab=256, ssm_state=16,
    dtype="float32", remat=False)
