"""Weights of the JAX reference in the port's tensors.

``from_jax_params`` takes the tree ``repro.models.transformer.init_params``
returns, with its leaves already converted to numpy arrays by the caller,
and gives the port's parameter tree: the same keys, the same stacked
layout, each array on ``device``. This module imports no JAX.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer


def _shapes(tree: dict, prefix: str = "") -> Dict[str, Tuple[int, ...]]:
    out: Dict[str, Tuple[int, ...]] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = tuple(v.shape)
    return out


def _convert(tree: dict, dtype: torch.dtype, device: torch.device) -> dict:
    return {k: _convert(v, dtype, device) if isinstance(v, dict)
            else torch.tensor(np.asarray(v), dtype=dtype, device=device)
            for k, v in tree.items()}


def from_jax_params(np_tree: dict, cfg: ModelConfig,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> dict:
    """Convert the reference's parameter tree (numpy leaves) key for key.
    Raises when its keys or shapes differ from the port's layout."""
    device = resolve_device(device)
    want = _shapes(transformer.init_params(cfg, torch.Generator(),
                                           device="meta"))
    got = _shapes(np_tree)
    if got != want:
        diff = sorted(set(got.items()) ^ set(want.items()))
        raise ValueError(f"{cfg.name}: parameter tree does not match the "
                         f"port's layout; differing (key, shape): {diff}")
    return _convert(np_tree, getattr(torch, cfg.dtype), device)
