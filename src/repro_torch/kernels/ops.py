"""Kernel entry points of the port, dispatched by the tensor's device.

A CPU tensor goes to the kernel's plain PyTorch version (``ref``). Any
other tensor goes to the CUDA kernel, whose wrapper launches it or raises:
no build or launch failure falls back to the plain version. The signatures
are the reference's ``repro.kernels.ops`` ones without ``use_pallas``.

``LAUNCHES[name]`` counts the CUDA launches of each kernel.
"""

from __future__ import annotations

import torch

from repro_torch.core import quant
from repro_torch.kernels import (build, decode_attn, nmce_matvec, ref,
                                 relu_ffn, sparse_ffn)

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


def relu_ffn_fused(x: torch.Tensor, w_up: torch.Tensor,
                   w_down: torch.Tensor) -> torch.Tensor:
    """Fused ReLU-FFN with dead-block skip (kernel 3). x f[M, d]; returns
    f32[M, d]."""
    if x.device.type == "cpu":
        return ref.relu_ffn_plain(x, w_up, w_down)
    return relu_ffn.relu_ffn(x, w_up, w_down)


def nmce_matmul(x: torch.Tensor, w_q: quant.QuantizedTensor,
                saturate_int16: bool = False) -> torch.Tensor:
    """Quantized activation x int8-weight matmul (kernel 4, the NMCE path).

    x: float[M, K] (quantized per row on the fly), w_q: int8[K, N] with
    per-column scales. Returns f32[M, N]."""
    x_q = quant.quantize_int8(x, axis=0)
    xs = x_q.scale.reshape(-1, 1)
    ws = w_q.scale.reshape(1, -1)
    if x.device.type == "cpu":
        return ref.nmce_matmul_plain(x_q.q, w_q.q, xs, ws,
                                     saturate_int16=saturate_int16)
    return nmce_matvec.nmce_matmul(x_q.q, w_q.q.contiguous(), xs.contiguous(),
                                   ws.contiguous(),
                                   saturate_int16=saturate_int16)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor) -> torch.Tensor:
    """GQA flash-decode over a contiguous cache (kernel 5). q f[B, Hq, Dh];
    k, v f[B, S, Kv, Dh]; kv_len i32[B]. Returns f32[B, Hq, Dh]."""
    if q.device.type == "cpu":
        return ref.decode_attention_plain(q, k, v, kv_len)
    return decode_attn.decode_attention(q, k, v, kv_len)
