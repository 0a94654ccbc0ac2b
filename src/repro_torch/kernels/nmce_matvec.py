"""Kernel 4: the NMCE W8A8 matmul (csrc/nmce_matmul.cu).

The port of ``repro.kernels.nmce_matvec.nmce_matmul``: x_q i8[M, K] @ w_q
i8[K, N] with exact int32 accumulation and the fused dequant
``float(acc) * x_scale * w_scale``; ``saturate_int16`` clips each 64-wide K
chunk to int16 before the cross-chunk sum. Bit-equal to its plain version
``ref.nmce_matmul_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build


def _fn():
    fn = build.load("nmce_matmul").nmce_matmul_i8
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _check(x_q, w_q, x_scale, w_scale):
    for name, t, dtype in (("x_q", x_q, torch.int8), ("w_q", w_q, torch.int8),
                           ("x_scale", x_scale, torch.float32),
                           ("w_scale", w_scale, torch.float32)):
        if t.device != x_q.device or t.device.type != "cuda":
            raise ValueError(f"nmce_matmul: {name} must be on the CUDA "
                             f"device of x_q, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"nmce_matmul: {name} must be {dtype}, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"nmce_matmul: {name} must be contiguous")
    if x_q.ndim != 2 or w_q.ndim != 2 or x_q.shape[1] != w_q.shape[0] \
            or x_scale.numel() != x_q.shape[0] \
            or w_scale.numel() != w_q.shape[1]:
        raise ValueError(
            f"nmce_matmul: shapes x_q{tuple(x_q.shape)} w_q{tuple(w_q.shape)}"
            f" x_scale{tuple(x_scale.shape)} w_scale{tuple(w_scale.shape)}")
    K, N = w_q.shape
    if K % 4 or N % 4 or x_q.data_ptr() % 4 or w_q.data_ptr() % 4:
        raise ValueError("nmce_matmul: needs K % 4 == 0, N % 4 == 0 and "
                         "4-byte aligned bases (32-bit loads of 4 int8 "
                         f"values), got K={K}, N={N}")


def nmce_matmul(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor,
                w_scale: torch.Tensor,
                saturate_int16: bool = False) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (no synchronise).

    x_q i8[M, K]; w_q i8[K, N]; x_scale f32[M, 1]; w_scale f32[1, N].
    Returns f32[M, N]."""
    _check(x_q, w_q, x_scale, w_scale)
    M, K = x_q.shape
    N = w_q.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=x_q.device)
    if M == 0 or N == 0:
        return out
    if K == 0:
        return out.zero_()
    fn = _fn()
    with torch.cuda.device(x_q.device):
        err = fn(x_q.data_ptr(), w_q.data_ptr(), x_scale.data_ptr(),
                 w_scale.data_ptr(), out.data_ptr(), M, K, N,
                 int(saturate_int16), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"nmce_matmul kernel launch failed: cudaError "
                           f"{err}")
    build.LAUNCHES["nmce_matmul"] += 1
    return out
