"""Kernel 4: the NMCE W8A8 matmul (csrc/nmce_matmul.cu).

The port of ``repro.kernels.nmce_matvec.nmce_matmul``: x_q i8[M, K] @ w_q
i8[K, N] with exact int32 accumulation and the fused dequant
``float(acc) * x_scale * w_scale``; ``saturate_int16`` clips each 64-wide K
chunk to int16 before the cross-chunk sum. Bit-equal to its plain version
``ref.nmce_matmul_plain``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_SMEM_LIMIT = 232_448        # bytes of shared memory one block may use
# nmce_matmul.cu: CTAs of 128 output columns and up to 64 rows (16-row mma
# tiles); K in chunks of 64 (NMCE_VREG_BYTES); an 8-stage ring of [64][128]
# int8 weight tiles with two mbarriers each and 1024 bytes of alignment
# slack; the CTA's x rows over its K range, each padded by 16 bytes
_BN = 128
_CHUNK = 64
_STAGES = 8
_X_PAD = 16
_ROWS = 64
# below this many weight bytes one CTA per column tile walks all of K: a
# split's second launch costs more than the walk
_SPLIT_MIN_BYTES = 1 << 20


@functools.cache
def nmce_plan(M: int, K: int, N: int, n_sm: int) -> dict:
    """The launch nmce_matmul.cu makes for these shapes: ``mt`` 16-row mma
    tiles per CTA (all M rows up to 64, else tiles of 64), the split of
    the K chunks (``n_split`` ranges of ``cps`` chunks: as many CTAs as
    fit in one wave of one CTA per SM, and few enough chunks that the
    CTA's x rows fit in shared memory), its grid, dynamic shared memory
    in bytes, the int32 partials (0 when n_split == 1) and whether N lets
    the weights come by TMA (``tma``; the wrapper also needs a 16-byte
    aligned base). Shapes and the SM count only; one plan per shape is
    kept, and callers must not change it."""
    rows = min(M, _ROWS)
    mt = -(-rows // 16)
    n_mt = -(-M // (16 * mt))
    n_nt = -(-N // _BN)
    n_ch = -(-K // _CHUNK)
    fixed = 1024 + _STAGES * (_CHUNK * _BN + 16) + rows * _X_PAD
    cps_max = (_SMEM_LIMIT - fixed) // (rows * _CHUNK)
    base = n_nt * n_mt
    want = 1 if K * N < _SPLIT_MIN_BYTES else max(1, n_sm // base)
    cps = min(cps_max, -(-n_ch // want))
    n_split = -(-n_ch // cps)
    return {"mt": mt, "n_split": n_split, "cps": cps,
            "grid": (n_nt, n_split, n_mt),
            "smem": fixed + rows * cps * _CHUNK, "tma": N % 16 == 0,
            "scratch": n_split * M * N if n_split > 1 else 0}


def _fn():
    fn = build.load("nmce_matmul").nmce_matmul_i8
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, p]
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
    """Launch the CUDA kernel (and its combine pass when K is split across
    CTAs) on the current stream, no synchronise.

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
    plan = nmce_plan(M, K, N, build.sm_count(x_q.device.index))
    if plan["grid"][2] > 65535:
        raise ValueError(f"nmce_matmul: M={M} needs {plan['grid'][2]} row "
                         f"tiles (limit 65535)")
    partial = None
    if plan["n_split"] > 1:
        partial = torch.empty(plan["scratch"], dtype=torch.int32,
                              device=x_q.device)
    tma = plan["tma"] and w_q.data_ptr() % 16 == 0
    fn = _fn()
    with torch.cuda.device(x_q.device):
        err = fn(x_q.data_ptr(), w_q.data_ptr(), x_scale.data_ptr(),
                 w_scale.data_ptr(), out.data_ptr(),
                 None if partial is None else partial.data_ptr(), M, K, N,
                 int(saturate_int16), plan["n_split"], plan["cps"], int(tma),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"nmce_matmul kernel launch failed: cudaError "
                           f"{err}")
    build.count_launch("nmce_matmul")
    return out
