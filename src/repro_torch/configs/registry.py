"""Config registry of the port: the configs it serves, by name."""

from __future__ import annotations

from typing import Dict

from repro_torch.configs import (granite_34b, llama3_2_1b,
                                 llama4_maverick_400b_a17b,
                                 moonshot_v1_16b_a3b,
                                 nectar_relu_llama_1p7m, qwen2_5_3b,
                                 qwen3_4b, xlstm_125m, zamba2_2_7b)
from repro_torch.configs.base import ModelConfig

# every module's CONFIG, and its SMOKE and DRAFT where it has them
REGISTRY: Dict[str, ModelConfig] = {
    c.name: c for m in (nectar_relu_llama_1p7m, llama3_2_1b, granite_34b,
                        zamba2_2_7b, xlstm_125m, qwen3_4b, qwen2_5_3b,
                        moonshot_v1_16b_a3b, llama4_maverick_400b_a17b)
    for c in (getattr(m, a, None) for a in ("CONFIG", "SMOKE", "DRAFT"))
    if c is not None}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]
