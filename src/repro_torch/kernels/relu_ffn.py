"""Kernel 3: the fused ReLU-FFN with dead-block skip (csrc/relu_ffn.cu).

The port of ``repro.kernels.relu_ffn.relu_ffn``: relu(x @ w_up) @ w_down,
where a d_ff block whose hidden values are all <= 0 skips its down MAC.
Any d_ff: the kernel's last block is a tail. Its plain version is
``ref.relu_ffn_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build


_BLOCK_F = 128               # kBF in relu_ffn.cu: hidden units per block
_TILE_ROWS = 16              # kBM in relu_ffn.cu: rows of x per tile


def _fn():
    fn = build.load("relu_ffn").relu_ffn_f32
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _check(x, w_up, w_down):
    for name, t in (("x", x), ("w_up", w_up), ("w_down", w_down)):
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(f"relu_ffn: {name} must be on the CUDA device "
                             f"of x, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"relu_ffn: {name} must be torch.float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"relu_ffn: {name} must be contiguous")
    if x.ndim != 2 or w_up.ndim != 2 or w_up.shape[0] != x.shape[1] \
            or w_down.shape != (w_up.shape[1], x.shape[1]):
        raise ValueError(f"relu_ffn: shapes x{tuple(x.shape)} "
                         f"w_up{tuple(w_up.shape)} w_down{tuple(w_down.shape)}")


def relu_ffn(x: torch.Tensor, w_up: torch.Tensor,
             w_down: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel (its two passes) on the current stream, no
    synchronise. x f32[M, d]; w_up f32[d, f]; w_down f32[f, d]. Returns
    f32[M, d]."""
    _check(x, w_up, w_down)
    M, d = x.shape
    f = w_up.shape[1]
    out = torch.empty((M, d), dtype=torch.float32, device=x.device)
    if M == 0 or d == 0:
        return out
    if f == 0:
        return out.zero_()
    fn = _fn()
    # scratch of the two passes: each live block's partial product, and
    # which (d_ff block, row tile) pairs are live
    n_fb, n_mt = -(-f // _BLOCK_F), -(-M // _TILE_ROWS)
    partial = torch.empty((n_fb, M, d), dtype=torch.float32, device=x.device)
    live = torch.empty((n_fb, n_mt), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
                 out.data_ptr(), partial.data_ptr(), live.data_ptr(), M, d, f,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"relu_ffn kernel launch failed: cudaError {err}")
    build.LAUNCHES["relu_ffn"] += 1
    return out
