"""Checkpointing: atomic, manifest-driven, keep-last-k (the port of
``repro.train.checkpoint``).

Layout, the reference's:
  <dir>/step_<N>.tmp/   (written)  -> atomic rename -> <dir>/step_<N>/
      manifest.json     step, n_leaves, data cursor, mesh shape, tree
                        structure, dtypes, shapes
      arrays.npz        leaf_<i>: the leaves in the reference's order
                        (``repro_torch.tree``: dict keys sorted, a
                        NamedTuple's fields in order)
Resume is exact: params, optimizer state and the data cursor. A bf16 leaf
is stored as f32 (numpy has no bf16 of its own; widening is exact) and
narrowed back on restore, so it round-trips bit for bit, and an f32
checkpoint written by either package restores in the other.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.tree import leaves, structure, unflatten


def _dtype_name(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def save(ckpt_dir: str, step: int, state: Any, *, data_cursor: int = 0,
         mesh_shape=None, keep: int = 3) -> str:
    """state: a nested dict / NamedTuple of tensors (params, optimizer
    state, ...). Returns the published directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = leaves(state)
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{f"leaf_{i}": _to_numpy(x) for i, x in enumerate(flat)})
    manifest = {
        "step": step,
        "n_leaves": len(flat),
        "data_cursor": data_cursor,
        "mesh_shape": list(mesh_shape) if mesh_shape else None,
        "treedef": structure(state),
        "dtypes": [_dtype_name(x) if hasattr(x, "dtype")
                   else str(np.asarray(x).dtype) for x in flat],
        "shapes": [list(np.shape(x)) for x in flat],
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic publish
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, d))


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def read_manifest(ckpt_dir: str, step: int) -> dict:
    with open(os.path.join(ckpt_dir, f"step_{step:08d}",
                           "manifest.json")) as f:
        return json.load(f)


def restore(ckpt_dir: str, step: int, like: Any,
            device: Optional[Union[str, torch.device]] = None
            ) -> Tuple[Any, dict]:
    """Restore into the structure of ``like`` (its leaves give the
    dtypes; ``like`` may live on the meta device), each leaf on
    ``device`` (default CUDA, see ``resolve_device``). Returns (state,
    manifest). Raises when the leaf count or a shape differs."""
    device = resolve_device(device)
    manifest = read_manifest(ckpt_dir, step)
    flat_like = leaves(like)
    if manifest["n_leaves"] != len(flat_like):
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, "
                         f"the structure to restore {len(flat_like)}")
    data = np.load(os.path.join(ckpt_dir, f"step_{step:08d}", "arrays.npz"))
    flat = []
    for i, want in enumerate(flat_like):
        a = data[f"leaf_{i}"]
        if tuple(a.shape) != tuple(want.shape):
            raise ValueError(f"leaf {i}: checkpoint shape {a.shape}, the "
                             f"structure's {tuple(want.shape)}")
        flat.append(torch.from_numpy(np.array(a)).to(device=device,
                                                      dtype=want.dtype))
    return unflatten(like, flat), manifest


def restore_params(ckpt_dir: str, step: int, params: Any,
                   device: Optional[Union[str, torch.device]] = None) -> Any:
    """The params of a checkpoint written as {"params": ...} (the
    reference serve's form) or as a training run's {"params", "opt"}
    with either optimizer's state, told apart by their leaf counts.
    ``params`` gives the structure (the meta device will do)."""
    from repro_torch.train import optimizer as opt
    n = read_manifest(ckpt_dir, step)["n_leaves"]
    for like in ({"params": params},
                 {"params": params, "opt": opt.adam_init(params)},
                 {"params": params, "opt": opt.adam8_init(params)}):
        if len(leaves(like)) == n:
            return restore(ckpt_dir, step, like, device=device)[0]["params"]
    raise ValueError(f"checkpoint step {step} in {ckpt_dir} has {n} leaves: "
                     f"neither params alone nor params and an optimizer "
                     f"state of this model")
