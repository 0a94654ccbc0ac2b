"""The two attention kernels of ``repro.kernels.decode_attn``.

Kernel 1, ``paged_attention`` (csrc/paged_attention.cu): S query rows per
slot read the shared KV block pools through per-row block tables, query j
of row b attending kv positions <= lens[b]+j. Its plain version is
``ref.paged_attention_plain``.

Kernel 5, ``decode_attention`` (csrc/decode_attention.cu): one query token
per row against a contiguous [B, S, Kv, Dh] cache in f32 or bf16, masked
to the first kv_len[b] positions. Its plain version is
``ref.decode_attention_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_SMEM_LIMIT = 232_448        # bytes of shared memory one block may use
_MAX_BLOCK_TOKENS = 32       # kMaxBlockTokens in paged_attention.cu
_HEAD_DIMS = (32, 64, 128)
_CHUNK = 32                  # kChunk in decode_attention.cu
_DECODE_WARPS = 4            # kWarps in decode_attention.cu


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


def _decode_fn(kv_dtype: torch.dtype):
    lib = build.load("decode_attention")
    fn = lib.decode_attention_bf16 if kv_dtype == torch.bfloat16 \
        else lib.decode_attention_f32
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def _decode_smem(G: int, Dh: int) -> int:
    """Shared-memory bytes of one block (the layout in the .cu source:
    the queries, then per warp a padded K chunk, a V chunk and the
    softmax state)."""
    per_warp = _CHUNK * (Dh + 1) + _CHUNK * Dh + G * Dh + 2 * G
    return 4 * (G * Dh + _DECODE_WARPS * per_warp)


def _decode_check(q, k, v, kv_len):
    for name, t, dtypes in (("q", q, (torch.float32,)),
                            ("k", k, (torch.float32, torch.bfloat16)),
                            ("v", v, (k.dtype,)),
                            ("kv_len", kv_len, (torch.int32,))):
        if t.device != q.device or t.device.type != "cuda":
            raise ValueError(f"decode_attention: {name} must be on the "
                             f"CUDA device of q, got {t.device}")
        if t.dtype not in dtypes:
            raise TypeError(f"decode_attention: {name} must be one of "
                            f"{dtypes}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be contiguous")
    B, Hq, Dh = q.shape
    if k.ndim != 4 or v.shape != k.shape or k.shape[0] != B \
            or k.shape[3] != Dh or Hq % k.shape[2] or kv_len.shape != (B,):
        raise ValueError(
            f"decode_attention: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
            f"v{tuple(v.shape)} kv_len{tuple(kv_len.shape)}")
    if Dh not in _HEAD_DIMS:
        raise ValueError(f"decode_attention: needs d_head in {_HEAD_DIMS}, "
                         f"got {Dh}")
    smem = _decode_smem(Hq // k.shape[2], Dh)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"decode_attention: {Hq // k.shape[2]} query heads "
                         f"per KV head need {smem} bytes of shared memory "
                         f"(> {_SMEM_LIMIT})")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (no synchronise).

    q f32[B, Hq, Dh]; k, v [B, S, Kv, Dh] in f32 or bf16; kv_len i32[B]
    (positions [0, min(kv_len, S)) are visible). Returns f32[B, Hq, Dh]."""
    _decode_check(q, k, v, kv_len)
    B, Hq, Dh = q.shape
    S, Kv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if B == 0 or S == 0:
        return out.zero_()
    fn = _decode_fn(k.dtype)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
                 out.data_ptr(), B, S, Hq, Kv, Dh, Dh ** -0.5,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: "
                           f"cudaError {err}")
    build.LAUNCHES["decode_attention"] += 1
    return out
