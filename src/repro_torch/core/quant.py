"""Int8 quantization with NeCTAr NMCE arithmetic semantics (own copy of
``repro.core.quant``).

The NMCE (paper Fig. 4) computes int8 x int8 dot products of 64-byte vectors
and writes each *saturated int16* result to an MMIO register. Here:

  * symmetric int8 quantization (per-tensor / per-channel scales),
  * the exact saturating-int16 MAC the engine performs (``saturating_mac``),
  * W8A8 matmuls with exact integer accumulation and a dequant epilogue,
  * bit-exact NMCE mode (``saturate_int16``) for faithfulness tests.

Integer sums are exact on either device: ``torch.matmul`` has no integer
kernel on CUDA, so ``int_matmul`` sums the int8 products in float64, where
every partial sum of these shapes is an integer below 2^53, and the int32
result of the reference is reproduced bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

INT8_MIN, INT8_MAX = -128, 127
INT16_MIN, INT16_MAX = -32768, 32767

# NMCE ISA constants (paper §II-B): 64B vector register, count <= 32 ops.
NMCE_VREG_BYTES = 64
NMCE_MAX_COUNT = 32


@dataclasses.dataclass
class QuantizedTensor:
    """int8 values + fp32 scale(s). ``axis`` is the quantization axis
    (scales broadcast along it); ``axis=None`` means per-tensor."""

    q: torch.Tensor           # int8
    scale: torch.Tensor       # f32, shape broadcastable to q
    axis: Optional[int] = None

    @property
    def shape(self):
        return self.q.shape

    @property
    def dtype(self):
        return self.q.dtype

    def dequantize(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return (self.q.float() * self.scale).to(dtype)


def _absmax(x: torch.Tensor, axis: Optional[int]) -> torch.Tensor:
    if axis is None:
        return x.abs().max()
    axis = axis % x.ndim
    reduce_axes = tuple(i for i in range(x.ndim) if i != axis)
    if not reduce_axes:
        return x.abs()
    return x.abs().amax(dim=reduce_axes, keepdim=True)


def quantize_int8(x: torch.Tensor,
                  axis: Optional[int] = None) -> QuantizedTensor:
    """Symmetric int8 quantization. ``axis`` keeps a scale per slice of that
    axis (e.g. per-output-channel for weights). ``x / scale`` divides in f32
    and rounds half to even, as the reference does."""
    xf = x.float()
    amax = _absmax(xf, axis)
    # divide by a tensor, not the number 127: PyTorch's CUDA kernels turn a
    # division by a Python number into a product with its reciprocal,
    # which can land 1 ulp away from the reference's amax / 127
    scale = torch.where(amax > 0, amax / torch.full_like(amax, INT8_MAX),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale), INT8_MIN, INT8_MAX)
    return QuantizedTensor(q=q.to(torch.int8), scale=scale, axis=axis)


def dequantize(qt: QuantizedTensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return qt.dequantize(dtype)


def saturating_mac(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """Bit-exact NMCE dot product: int8 x int8 -> integer accumulate ->
    saturate to int16 (paper Fig. 4: "saturated int16 result").

    v1, v2: int8 tensors whose last dim is the reduction dim (<= 64
    elements per NMCE op in hardware; callers chunk longer reductions)."""
    acc = (v1.long() * v2.long()).sum(dim=-1)
    return torch.clamp(acc, INT16_MIN, INT16_MAX).to(torch.int16)


def nmce_dot_stream(v1reg: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """One NMCE command: ``count`` dot products of the stationary 64B
    ``v1reg`` (int8[64]) against streamed ``rows`` (int8[count, 64]),
    each saturated to int16 — the Fig. 4 programming model."""
    if v1reg.shape[-1] != NMCE_VREG_BYTES or rows.shape[-1] != NMCE_VREG_BYTES:
        raise ValueError(f"NMCE operands are {NMCE_VREG_BYTES} bytes wide, "
                         f"got {tuple(v1reg.shape)} and {tuple(rows.shape)}")
    return saturating_mac(rows, v1reg[None, :])


def int_matmul(x: torch.Tensor, w: torch.Tensor,
               saturate_int16: bool = False) -> torch.Tensor:
    """Exact integer x[..., K] @ w[K, N] of int8 operands -> int64.

    ``saturate_int16`` zero-pads K to a multiple of 64, clips each 64-wide
    chunk's dot to int16 and sums the chunks. The products are summed in
    float64, where every partial sum is an integer below 2^53 and so exact,
    because neither device has an integer matmul kernel for every dtype."""
    if not saturate_int16:
        return torch.matmul(x.double(), w.double()).long()
    k = x.shape[-1]
    pad = (-k) % NMCE_VREG_BYTES
    xd, wd = x.double(), w.double()
    if pad:
        xd = torch.nn.functional.pad(xd, (0, pad))
        wd = torch.nn.functional.pad(wd, (0, 0, 0, pad))
    kc = xd.shape[-1] // NMCE_VREG_BYTES
    xc = xd.reshape(*xd.shape[:-1], kc, NMCE_VREG_BYTES)
    wc = wd.reshape(kc, NMCE_VREG_BYTES, wd.shape[-1])
    # per-chunk dot -> saturate int16 (the engine) -> accumulation across
    # chunks (the CPU, paper Fig. 5)
    part = torch.einsum("...ck,ckn->...cn", xc, wc)
    part = torch.clamp(part, INT16_MIN, INT16_MAX)
    return part.long().sum(dim=-2)


def w8a8_matmul(x_q: QuantizedTensor, w_q: QuantizedTensor,
                out_dtype: torch.dtype = torch.float32,
                saturate_int16: bool = False) -> torch.Tensor:
    """Quantized matmul: x[int8 (..., K)] @ w[int8 (K, N)] with exact
    integer accumulation, dequantized by scale_x * scale_w."""
    acc = int_matmul(x_q.q, w_q.q, saturate_int16)
    scale_w = w_q.scale
    if w_q.axis == 1:
        scale_w = scale_w.reshape((1,) * (acc.ndim - 1) + (-1,))
    elif w_q.axis == 0:
        raise ValueError("weight scales must be per-output-channel (axis=1) "
                         "or per-tensor (axis=None)")
    return (acc.to(torch.int32).float() * x_q.scale * scale_w).to(out_dtype)


def quantized_linear(x: torch.Tensor, w_q: QuantizedTensor,
                     bias: Optional[torch.Tensor] = None,
                     out_dtype: Optional[torch.dtype] = None,
                     saturate_int16: bool = False) -> torch.Tensor:
    """Dynamic-activation-quant linear: quantize x per row to int8, run
    W8A8, dequantize. This is the software contract of the NMCE path."""
    out_dtype = out_dtype or x.dtype
    x_q = quantize_int8(x, axis=x.ndim - 2 if x.ndim >= 2 else None)
    y = w8a8_matmul(x_q, w_q, out_dtype=torch.float32,
                    saturate_int16=saturate_int16)
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def quant_dequant(x: torch.Tensor, axis: Optional[int] = None
                  ) -> torch.Tensor:
    """Fake-quant roundtrip (used by tests and QAT-style ablations)."""
    return quantize_int8(x, axis=axis).dequantize(x.dtype)


def quantize_tree(params, axis: int = 1, min_size: int = 1024):
    """Quantize every >=2D leaf (weights) of a nested dict to int8 per
    output channel; small leaves (norms, biases) stay fp. ``axis`` is
    kept for the reference's signature: the scale axis is always the
    leaf's last."""
    if isinstance(params, dict):
        return {k: quantize_tree(v, axis, min_size) for k, v in params.items()}
    if params.ndim >= 2 and params.numel() >= min_size:
        return quantize_int8(params, axis=params.ndim - 1)
    return params


def tree_bytes(params) -> int:
    """Total parameter bytes (counting int8 leaves as 1B) — the off-chip
    traffic unit the paper argues in."""
    if isinstance(params, dict):
        return sum(tree_bytes(v) for v in params.values())
    if isinstance(params, QuantizedTensor):
        return tree_bytes(params.q) + tree_bytes(params.scale)
    return params.numel() * params.element_size()
