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


_SMEM_LIMIT = 232_448        # bytes of shared memory one block may use
# sparse_gather.cu: CTAs of 8 warps over tiles of 32 float4 columns; a
# k-split holds at least _MIN_SLOTS slots and aims at _CTAS_PER_SM CTAs
# per SM; the CTA's shared memory is the warps' partials (8 x 32 float4)
# and the split's h and idx
_WARPS = 8
_TILE = 32
_MIN_SLOTS = 128
_CTAS_PER_SM = 4


def gather_plan(B: int, k: int, d: int, n_sm: int) -> dict:
    """The launch sparse_gather.cu makes for these shapes: its grid, the
    k-split ``n_split`` of ``per`` slots each (none empty) and its dynamic
    shared memory in bytes."""
    n_tiles = -(-(d // 4) // _TILE)
    n_split = max(1, min(-(-_CTAS_PER_SM * n_sm // (B * n_tiles)),
                         -(-k // _MIN_SLOTS)))
    per = -(-k // n_split)
    while 16 * _WARPS * _TILE + 8 * per > _SMEM_LIMIT:
        n_split += 1                    # a split's h and idx must fit
        per = -(-k // n_split)
    n_split = -(-k // per)
    return {"grid": (B, n_tiles, n_split), "n_split": n_split, "per": per,
            "smem": 16 * _WARPS * _TILE + 8 * per}


def _fn():
    fn = build.load("sparse_gather").sparse_gather_matvec_f32
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
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
    if -(-(w_down.shape[1] // 4) // _TILE) > 65535:
        raise ValueError(f"sparse_gather_matvec: d={w_down.shape[1]} needs "
                         f"more than 65535 column tiles")


def sparse_gather_matvec(h: torch.Tensor, idx: torch.Tensor,
                         w_down: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel (and its combine pass when k is split across
    CTAs) on the current stream, no synchronise.

    h f32[B, k]; idx i32[B, k]; w_down f32[d_ff, d]. Returns f32[B, d]."""
    _check(h, idx, w_down)
    B, k = h.shape
    d_ff, d = w_down.shape
    out = torch.empty((B, d), dtype=torch.float32, device=h.device)
    if B == 0 or d == 0:
        return out
    if k == 0 or d_ff == 0:
        return out.zero_()
    plan = gather_plan(B, k, d, build.sm_count(h.device.index))
    n_split = plan["n_split"]
    part = None
    if n_split > 1:       # each split's partial sums
        part = torch.empty((n_split, B, d), dtype=torch.float32,
                           device=h.device)
    fn = _fn()
    with torch.cuda.device(h.device):
        err = fn(h.data_ptr(), idx.data_ptr(), w_down.data_ptr(),
                 out.data_ptr(), None if part is None else part.data_ptr(),
                 B, k, d_ff, d, n_split,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"sparse_gather_matvec kernel launch failed: "
                           f"cudaError {err}")
    build.count_launch("sparse_gather_matvec")
    return out
