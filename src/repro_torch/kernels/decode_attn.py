"""Kernel 1: paged attention through block tables (csrc/paged_attention.cu).

The port of ``repro.kernels.decode_attn.paged_attention``: S query rows
per slot read the shared KV block pools through per-row block tables,
query j of row b attending kv positions <= lens[b]+j. Its plain version is
``ref.paged_attention_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_SMEM_LIMIT = 232_448        # bytes of shared memory one block may use
_MAX_BLOCK_TOKENS = 32       # kMaxBlockTokens in the .cu source
_HEAD_DIMS = (32, 64, 128)


def _fn():
    fn = build.load("paged_attention").paged_attention_f32
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, i,
                       ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def _check(q, k_pool, v_pool, tables, lens):
    for name, t, dtype in (("q", q, torch.float32),
                           ("k_pool", k_pool, torch.float32),
                           ("v_pool", v_pool, torch.float32),
                           ("tables", tables, torch.int32),
                           ("lens", lens, torch.int32)):
        if t.device != q.device or t.device.type != "cuda":
            raise ValueError(f"paged_attention: {name} must be on the CUDA "
                             f"device of q, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"paged_attention: {name} must be {dtype}, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be contiguous")
    B, S, Hq, Dh = q.shape
    n_blocks, bs, Kv, dh = k_pool.shape
    if v_pool.shape != k_pool.shape or dh != Dh or Hq % Kv \
            or tables.ndim != 2 or tables.shape[0] != B \
            or lens.shape != (B,):
        raise ValueError(
            f"paged_attention: shapes q{tuple(q.shape)} "
            f"pools{tuple(k_pool.shape)}/{tuple(v_pool.shape)} "
            f"tables{tuple(tables.shape)} lens{tuple(lens.shape)}")
    if Dh not in _HEAD_DIMS or bs > _MAX_BLOCK_TOKENS:
        raise ValueError(f"paged_attention: needs d_head in {_HEAD_DIMS} "
                         f"and block_size <= {_MAX_BLOCK_TOKENS}, got "
                         f"d_head={Dh}, block_size={bs}")
    R = S * (Hq // Kv)
    smem = 4 * (2 * R * Dh + 2 * R + _MAX_BLOCK_TOKENS * (2 * Dh + 1))
    if smem > _SMEM_LIMIT:
        raise ValueError(f"paged_attention: {R} query rows per KV head need "
                         f"{smem} bytes of shared memory (> {_SMEM_LIMIT})")


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, tables: torch.Tensor,
                    lens: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (no synchronise).

    q f32[B, S, Hq, Dh]; k_pool/v_pool f32[n_blocks, bs, Kv, Dh]; tables
    i32[B, MB] with sentinel ``n_blocks``; lens i32[B] (context committed
    before this step). Returns f32[B, S, Hq, Dh]."""
    _check(q, k_pool, v_pool, tables, lens)
    B, S, Hq, Dh = q.shape
    n_blocks, bs, Kv, _ = k_pool.shape
    out = torch.empty_like(q)
    if B == 0 or S == 0 or tables.shape[1] == 0:
        return out.zero_()
    fn = _fn()
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 tables.data_ptr(), lens.data_ptr(), out.data_ptr(),
                 B, S, Hq, Kv, Dh, n_blocks, bs, tables.shape[1],
                 Dh ** -0.5, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"cudaError {err}")
    build.LAUNCHES["paged_attention"] += 1
    return out
