"""Activation sparsity — the ReLU-Llama technique (paper §V-A).

After ReLU most FFN hidden activations are exactly zero, so the rows of
W_down for those units never need to be read. The subset the serving path
needs: the shared hidden activation, the dense and the top-k gathered
down-projections, and the k the config asks for.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops


def apply_act(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "relu":
        return torch.relu(x)
    if act == "silu":
        return torch.nn.functional.silu(x)
    if act == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        return torch.nn.functional.gelu(x, approximate="tanh")
    if act == "relu2":
        r = torch.relu(x)
        return r * r
    raise ValueError(f"unknown activation {act!r}")


def topk_indices(h: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Indices of the k largest |h| along the last dim: (idx i32[..., k],
    valid bool[..., k]), ``valid`` marking entries that are nonzero."""
    mag = h.abs()
    top, idx = torch.topk(mag, k, dim=-1)
    return idx.to(torch.int32), top > 0


def active_fraction_to_k(d_ff: int, frac: float, multiple: int = 128) -> int:
    """Target active fraction -> k, a multiple of ``multiple``."""
    k = max(multiple, int(round(d_ff * frac / multiple)) * multiple)
    return min(k, d_ff)


def ffn_hidden(x: torch.Tensor, w_up: torch.Tensor, act: str = "relu",
               w_gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The hidden activation h shared by the dense and the gathered
    down-projections."""
    if w_gate is not None:
        return apply_act(x @ w_gate, act) * (x @ w_up)
    return apply_act(x @ w_up, act)


def down_dense(h: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """Dense down-projection: streams all of W_down."""
    return h @ w_down


def down_sparse(h: torch.Tensor, w_down: torch.Tensor, k: int
                ) -> torch.Tensor:
    """Gathered down-projection (the paper's C2): contract only the top-k
    active units' rows of W_down. Inactive slots carry the sentinel index
    d_ff, which the gather kernel skips. h: [..., d_ff] -> [..., d]."""
    idx, valid = topk_indices(h, k)
    hk = torch.where(valid, torch.gather(h, -1, idx.long()), 0.0)
    idx = torch.where(valid, idx, w_down.shape[0])
    lead = h.shape[:-1]
    out = ops.sparse_gather_matvec(hk.reshape(-1, k).contiguous(),
                                   idx.reshape(-1, k).contiguous(), w_down)
    return out.reshape(*lead, w_down.shape[1]).to(h.dtype)


def dense_ffn(x, w_up, w_down, act="relu", w_gate=None):
    return down_dense(ffn_hidden(x, w_up, act, w_gate), w_down)


def gathered_sparse_ffn(x, w_up, w_down, k, act="relu", w_gate=None):
    return down_sparse(ffn_hidden(x, w_up, act, w_gate), w_down, k)
