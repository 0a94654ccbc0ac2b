"""Kernel 3: the fused ReLU-FFN with dead-block skip (csrc/relu_ffn.cu).

The port of ``repro.kernels.relu_ffn.relu_ffn``: relu(x @ w_up) @ w_down,
where a d_ff block whose hidden values are all <= 0 skips its down MAC.
Any d_ff: the kernel's last block is a tail. Its plain version is
``ref.relu_ffn_plain``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_SMEM_LIMIT = 232_448        # bytes of shared memory one block may use
# relu_ffn.cu: d_ff blocks of 64 hidden units (the skip unit); row tiles
# of 16, 32 or 64 rows; a 4-stage ring of a weight tile [64][64] and an x
# tile [rows][64]; hidden blocks [rows][64], at most 256 rows x blocks of
# them in shared memory; 1024 bytes of alignment slack and an mbarrier per
# stage
_BLOCK_F = 64
_ROW_TILES = (16, 32, 64)
_STAGES = 4
_H_ROWS = 256


@functools.cache
def ffn_plan(M: int, d: int, f: int, n_sm: int) -> dict:
    """The launch relu_ffn.cu makes for these shapes: the row tile ``bm``
    (one tile for M <= 64, so every weight byte is read once; above, the
    largest that still fills the card), the split of the d_ff blocks
    (``n_split`` ranges of ``bps`` blocks, ``hb`` of them in shared memory
    at a time, enough splits to give every SM a CTA), its grid, dynamic
    shared memory in bytes and the floats of its partials (0 when
    n_split == 1). Shapes and the SM count only; one plan per shape is
    kept, and callers must not change it."""
    n_fb = -(-f // _BLOCK_F)
    if M <= _ROW_TILES[-1]:
        bm = next(b for b in _ROW_TILES if b >= M)
    else:
        bm = _ROW_TILES[-1]
        while bm > 16 and -(-M // bm) * n_fb < n_sm:
            bm //= 2
    n_mt = -(-M // bm)
    bps = -(-n_fb // max(1, -(-n_sm // n_mt)))
    n_split = -(-n_fb // bps)
    hb = min(bps, _H_ROWS // bm)
    smem = 1024 + 4 * (_STAGES * (64 * 64 + bm * 64) + hb * bm * 64) \
        + 8 * _STAGES
    return {"bm": bm, "n_split": n_split, "bps": bps, "hb": hb,
            "grid": (n_split, n_mt), "smem": smem,
            "scratch": n_split * M * d if n_split > 1 else 0}


def _fn():
    fn = build.load("relu_ffn").relu_ffn_f32
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, p]
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
        if t.data_ptr() % 16:
            raise ValueError(f"relu_ffn: {name} needs a 16-byte aligned "
                             f"base (TMA tensor copies)")
    if x.ndim != 2 or w_up.ndim != 2 or w_up.shape[0] != x.shape[1] \
            or w_down.shape != (w_up.shape[1], x.shape[1]):
        raise ValueError(f"relu_ffn: shapes x{tuple(x.shape)} "
                         f"w_up{tuple(w_up.shape)} w_down{tuple(w_down.shape)}")


def relu_ffn(x: torch.Tensor, w_up: torch.Tensor,
             w_down: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel (and its combine pass when d_ff is split
    across CTAs) on the current stream, no synchronise. x f32[M, d]; w_up
    f32[d, f]; w_down f32[f, d]. Returns f32[M, d]."""
    _check(x, w_up, w_down)
    M, d = x.shape
    f = w_up.shape[1]
    if M == 0 or d == 0 or f == 0:
        return x.new_zeros((M, d))
    if d % 4 or f % 4:
        # the kernel's tensor maps need rows of a multiple of 16 bytes:
        # zero rows and columns add nothing (relu(0) = 0)
        dp, fp = -(-d // 4) * 4, -(-f // 4) * 4
        out = relu_ffn(torch.nn.functional.pad(x, (0, dp - d)),
                       torch.nn.functional.pad(w_up, (0, fp - f, 0, dp - d)),
                       torch.nn.functional.pad(w_down,
                                               (0, dp - d, 0, fp - f)))
        return out[:, :d].contiguous()
    out = torch.empty((M, d), dtype=torch.float32, device=x.device)
    plan = ffn_plan(M, d, f, build.sm_count(x.device.index))
    if plan["grid"][1] > 65535 or plan["smem"] > _SMEM_LIMIT:
        raise ValueError(f"relu_ffn: M={M} needs grid {plan['grid']} and "
                         f"{plan['smem']} bytes of shared memory (limits "
                         f"65535, {_SMEM_LIMIT})")
    partial = live = None
    if plan["n_split"] > 1:
        # each split's partial product, then which (split, row tile) pairs
        # had a live block, in one allocation
        n_live = plan["n_split"] * plan["grid"][1]
        buf = torch.empty(plan["scratch"] + n_live, dtype=torch.float32,
                          device=x.device)
        partial = buf.data_ptr()
        live = partial + 4 * plan["scratch"]
    fn = _fn()
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
                 out.data_ptr(), partial, live, M, d, f, plan["bm"],
                 plan["n_split"], plan["bps"], plan["hb"],
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"relu_ffn kernel launch failed: cudaError {err}")
    build.count_launch("relu_ffn")
    return out
