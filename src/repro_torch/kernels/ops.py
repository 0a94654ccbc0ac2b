"""Kernel entry points of the port, dispatched by the tensor's device.

A CPU tensor goes to the kernel's plain PyTorch version (``ref``). Any
other tensor goes to the CUDA kernel, whose wrapper launches it or raises:
no build or launch failure falls back to the plain version.

``LAUNCHES[name]`` counts the CUDA launches of each kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, decode_attn, ref, sparse_ffn

LAUNCHES = build.LAUNCHES


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, tables: torch.Tensor,
                    lens: torch.Tensor) -> torch.Tensor:
    """Paged attention through block tables (kernel 1)."""
    if q.device.type == "cpu":
        return ref.paged_attention_plain(q, k_pool, v_pool, tables, lens)
    return decode_attn.paged_attention(q, k_pool, v_pool, tables, lens)


def sparse_gather_matvec(h: torch.Tensor, idx: torch.Tensor,
                         w_down: torch.Tensor) -> torch.Tensor:
    """Gathered down-projection over active rows of W_down (kernel 2)."""
    if h.device.type == "cpu":
        return ref.sparse_gather_matvec_plain(h, idx, w_down)
    return sparse_ffn.sparse_gather_matvec(h, idx, w_down)
