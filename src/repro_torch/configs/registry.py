"""Config registry of the port: the configs it serves, by name."""

from __future__ import annotations

from typing import Dict

from repro_torch.configs import nectar_relu_llama_1p7m
from repro_torch.configs.base import ModelConfig

REGISTRY: Dict[str, ModelConfig] = {
    c.name: c for c in (nectar_relu_llama_1p7m.CONFIG,
                        nectar_relu_llama_1p7m.SMOKE)}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]
