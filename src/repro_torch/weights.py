"""Weights of the JAX reference in the port's tensors.

``from_jax_params`` takes the tree ``repro.models.transformer.init_params``
returns, with its leaves already converted to numpy arrays by the caller,
and gives the port's parameter tree: the same keys, the same stacked
layout, each array on ``device``. ``from_jax_predictors`` does the same
for the reference's stacked sparsity predictors (self-speculation), and
``from_jax_opt_state`` for its optimizer state (an ``AdamState`` or
``Adam8State``), so a reference run resumes in the port. This module
imports no JAX.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.sparsity import SparsityPredictor
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.train import optimizer as opt


def _leaves(tree: dict, prefix: str = "") -> Dict[str, object]:
    out: Dict[str, object] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _layout(tree: dict) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """key -> (shape, dtype name) of every leaf; numpy's ``bfloat16``
    (ml_dtypes) and torch's have the same name."""
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in _leaves(tree).items()}


def _convert(tree: dict, like: dict, device: torch.device) -> dict:
    """Each leaf as a tensor of the dtype of its place in ``like``,
    through float32: numpy has no bfloat16 of its own, and widening bf16
    to f32 and narrowing it back is exact."""
    return {k: _convert(v, like[k], device) if isinstance(v, dict)
            else torch.from_numpy(np.array(v, dtype=np.float32)).to(
                device=device, dtype=like[k].dtype)
            for k, v in tree.items()}


def from_jax_params(np_tree: dict, cfg: ModelConfig,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> dict:
    """Convert the reference's parameter tree (numpy leaves) key for key,
    every leaf in its own dtype: a bf16 config keeps f32 leaves where the
    reference keeps them (Mamba2's ``A_log``, ``dt_bias`` and ``D``, the
    xLSTM gate biases). Raises when its keys, shapes or dtypes differ
    from the port's layout."""
    device = resolve_device(device)
    like = transformer.init_params(cfg, torch.Generator(), device="meta")
    want, got = _layout(like), _layout(np_tree)
    if got != want:
        diff = sorted(set(got.items()) ^ set(want.items()))
        raise ValueError(f"{cfg.name}: parameter tree does not match the "
                         f"port's layout; differing (key, (shape, dtype)): "
                         f"{diff}")
    return _convert(np_tree, like, device)


def from_jax_predictors(np_pred, cfg: ModelConfig,
                        device: Optional[Union[str, torch.device]] = None
                        ) -> SparsityPredictor:
    """Convert the reference's stacked ``SparsityPredictor`` (numpy leaves
    ``w_in`` [n_units, d_model, r] and ``w_out`` [n_units, r, d_ff], e.g.
    ``jax.tree.map(np.asarray, preds)``) into the port's, on ``device``.
    Raises when the shapes do not fit ``cfg``."""
    device = resolve_device(device)
    w_in, w_out = np.asarray(np_pred.w_in), np.asarray(np_pred.w_out)
    r = w_in.shape[-1] if w_in.ndim == 3 else -1
    if w_in.shape != (cfg.n_units, cfg.d_model, r) \
            or w_out.shape != (cfg.n_units, r, cfg.d_ff):
        raise ValueError(
            f"{cfg.name}: predictor shapes {w_in.shape} and {w_out.shape} "
            f"are not [{cfg.n_units}, {cfg.d_model}, r] and "
            f"[{cfg.n_units}, r, {cfg.d_ff}]")
    return SparsityPredictor(
        torch.tensor(w_in, dtype=torch.float32, device=device),
        torch.tensor(w_out, dtype=torch.float32, device=device))


def from_jax_opt_state(np_state, cfg: ModelConfig,
                       device: Optional[Union[str, torch.device]] = None):
    """Convert the reference's optimizer state (its ``AdamState`` or
    ``Adam8State`` with numpy leaves, e.g. ``jax.tree.map(np.asarray,
    state)``) into the port's, on ``device``: the same fields, each tree
    keyed as the params. Raises when the fields, keys, shapes or dtypes
    differ from what the port's optimizer keeps for ``cfg``."""
    device = resolve_device(device)
    params = transformer.init_params(cfg, torch.Generator(), device="meta")
    fields = getattr(np_state, "_fields", None)
    kinds = {opt.AdamState._fields: opt.adam_init,
             opt.Adam8State._fields: opt.adam8_init}
    if fields not in kinds:
        raise TypeError(f"not an AdamState or Adam8State: fields {fields}")
    like = kinds[fields](params)
    out = []
    for name, mine, theirs in zip(fields, like, np_state):
        if name == "step":
            step = np.asarray(theirs)
            if step.shape != () or step.dtype != np.int32:
                raise ValueError(f"{cfg.name}: step {step.dtype}"
                                 f"{list(step.shape)}, want int32[]")
            out.append(torch.tensor(int(step), dtype=torch.int32,
                                    device=device))
            continue
        want, got = _layout(mine), _layout(theirs)
        if got != want:
            diff = sorted(set(got.items()) ^ set(want.items()))
            raise ValueError(f"{cfg.name}: optimizer field {name!r} does not "
                             f"match the port's layout; differing (key, "
                             f"(shape, dtype)): {diff}")
        out.append(_convert(theirs, mine, device))
    return type(like)(*out)
