"""Kernel 2: the activation-sparse gathered down-projection
(csrc/sparse_gather.cu).

The port of ``repro.kernels.sparse_ffn.sparse_gather_matvec``:
out[b] = sum_j h[b, j] * w_down[idx[b, j]], with idx == d_ff naming an
empty slot. Its plain version is ``ref.sparse_gather_matvec_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build


def _fn():
    fn = build.load("sparse_gather").sparse_gather_matvec_f32
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _check(h, idx, w_down):
    for name, t, dtype in (("h", h, torch.float32),
                           ("idx", idx, torch.int32),
                           ("w_down", w_down, torch.float32)):
        if t.device != h.device or t.device.type != "cuda":
            raise ValueError(f"sparse_gather_matvec: {name} must be on the "
                             f"CUDA device of h, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"sparse_gather_matvec: {name} must be {dtype}, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"sparse_gather_matvec: {name} must be "
                             f"contiguous")
    if h.ndim != 2 or idx.shape != h.shape or w_down.ndim != 2:
        raise ValueError(f"sparse_gather_matvec: shapes h{tuple(h.shape)} "
                         f"idx{tuple(idx.shape)} w{tuple(w_down.shape)}")
    if w_down.shape[1] % 4 or w_down.data_ptr() % 16:
        raise ValueError("sparse_gather_matvec: w_down needs d % 4 == 0 and "
                         "a 16-byte aligned base (float4 row loads)")


def sparse_gather_matvec(h: torch.Tensor, idx: torch.Tensor,
                         w_down: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (no synchronise).

    h f32[B, k]; idx i32[B, k]; w_down f32[d_ff, d]. Returns f32[B, d]."""
    _check(h, idx, w_down)
    B, k = h.shape
    d_ff, d = w_down.shape
    out = torch.empty((B, d), dtype=torch.float32, device=h.device)
    if B == 0 or k == 0:
        return out.zero_()
    fn = _fn()
    with torch.cuda.device(h.device):
        err = fn(h.data_ptr(), idx.data_ptr(), w_down.data_ptr(),
                 out.data_ptr(), B, k, d_ff, d,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"sparse_gather_matvec kernel launch failed: "
                           f"cudaError {err}")
    build.LAUNCHES["sparse_gather_matvec"] += 1
    return out
