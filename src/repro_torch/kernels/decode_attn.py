"""The two attention kernels of ``repro.kernels.decode_attn``.

Kernel 1, ``paged_attention`` (csrc/paged_attention.cu): S query rows per
slot read the shared KV block pools (f32 or bf16) through per-row block
tables, query j of row b attending kv positions <= lens[b]+j; a sentinel
table entry inside that limit (padding positions, IDLE rows) reads block 0,
as the reference's index map clamps it. Its plain version is
``ref.paged_attention_plain``.

Kernel 5, ``decode_attention`` (csrc/decode_attention.cu): one query token
per row against a contiguous [B, S, Kv, Dh] cache in f32 or bf16, masked
to the first kv_len[b] positions. Its plain version is
``ref.decode_attention_plain``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_SMEM_LIMIT = 232_448        # bytes of shared memory one block may use
# the head sizes each kernel is built for: every paged config's d_head,
# and for kernel 5 also zamba2-2.7b's 80 (its shared attention decodes
# through the slot engine)
_PAGED_HEAD_DIMS = (16, 32, 64, 128)
_DECODE_HEAD_DIMS = (16, 32, 64, 80, 128)
# decode_attention.cu: 4 warps a CTA, each with its own two-stage ring of
# chunks of 32 / max(1, Dh // 32) keys (16 at Dh 80); a CTA takes 1, 4, 8 or 16 query
# heads of one KV head (more heads take more CTAs)
_DECODE_WARPS = 4
_DECODE_ROWS = (1, 4, 8, 16)
# paged_attention.cu: 4 warps a CTA; S*G >= _TILE_MIN_ROWS query rows per
# KV head take the tile kernel (tiles of 32 or 64 rows, 32-key chunks,
# padded P rows of 40 floats); fewer take the rows kernel (each warp its
# own two-stage ring of chunks of 32 / max(1, Dh / 32) keys, rows padded to
# 1, 4 or 16). A 16-byte copy moves 4 f32 or 8 bf16 pool values.
_PAGED_WARPS = 4
_TILE_MIN_ROWS = 16
_TILE_CHUNK = 32
_TILE_PS = 40
_CTAS_PER_SM = 2             # the split aims at this many CTAs per SM


def paged_plan(B: int, S: int, Hq: int, Kv: int, Dh: int, bs: int, MB: int,
               n_sm: int, dtype_bytes: int = 4) -> dict:
    """The launch paged_attention.cu makes for these shapes and a pool
    of ``dtype_bytes``-byte values: which kernel ("rows" or "tile"), the
    rows it pads to (``rows``), its grid, the context split ``n_split``
    (from MB, never from lens) and its dynamic shared memory in bytes (the
    layout in the .cu source)."""
    R = S * (Hq // Kv)
    table = 4 * (-(-MB // 4) * 4)
    ve = 16 // dtype_bytes                  # pool values per 16-byte copy
    if R >= _TILE_MIN_ROWS:
        rt = 32 if R <= 32 else 64
        kc, ks = _TILE_CHUNK, Dh + ve
        smem = (table + 4 * rt * (Dh + 4)
                + 2 * kc * (ks + Dh) * dtype_bytes + 4 * rt * _TILE_PS)
        n_rt, min_chunks, kind = -(-R // rt), 2, "tile"
    else:
        rt = 1 if R == 1 else 4 if R <= 4 else 16
        lpk = max(1, Dh // 32)
        kc, ks = 32 // lpk, Dh + ve * lpk
        smem = table + 4 * rt * Dh + _PAGED_WARPS * (
            2 * kc * (ks + Dh) * dtype_bytes + 4 * rt * kc)
        n_rt, min_chunks, kind = 1, _PAGED_WARPS, "rows"
    base = B * Kv * n_rt
    n_chunks = -(-MB * bs // kc)
    n_split = max(1, min(-(-_CTAS_PER_SM * n_sm // base),
                         -(-n_chunks // min_chunks)))
    return {"kind": kind, "rows": rt, "grid": (n_split, Kv * n_rt, B),
            "n_split": n_split, "smem": smem}


def _fn(pool_dtype: torch.dtype):
    lib = build.load("paged_attention")
    fn = lib.paged_attention_bf16 if pool_dtype == torch.bfloat16 \
        else lib.paged_attention_f32
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i,
                       ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def _check(q, k_pool, v_pool, tables, lens):
    for name, t, dtypes in (("q", q, (torch.float32,)),
                            ("k_pool", k_pool,
                             (torch.float32, torch.bfloat16)),
                            ("v_pool", v_pool, (k_pool.dtype,)),
                            ("tables", tables, (torch.int32,)),
                            ("lens", lens, (torch.int32,))):
        if t.device != q.device or t.device.type != "cuda":
            raise ValueError(f"paged_attention: {name} must be on the CUDA "
                             f"device of q, got {t.device}")
        if t.dtype not in dtypes:
            raise TypeError(f"paged_attention: {name} must be one of "
                            f"{dtypes}, got {t.dtype}")
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
    if Dh not in _PAGED_HEAD_DIMS:
        raise ValueError(f"paged_attention: needs d_head in "
                         f"{_PAGED_HEAD_DIMS}, got d_head={Dh}")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("paged_attention: the pools need a 16-byte aligned "
                         "base (16-byte cp.async copies)")
    if B > 65535 or Kv * -(-S * (Hq // Kv) // 32) > 65535:
        raise ValueError(f"paged_attention: grid too large for B={B}, "
                         f"S={S}, Hq={Hq}, Kv={Kv}")


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, tables: torch.Tensor,
                    lens: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel (and its combine pass when the context is
    split across CTAs) on the current stream, no synchronise.

    q f32[B, S, Hq, Dh]; k_pool/v_pool [n_blocks, bs, Kv, Dh], both f32 or
    both bf16; tables i32[B, MB] with sentinel ``n_blocks``; lens i32[B]
    (context committed before this step); Dh 16, 32, 64 or 128. Returns
    f32[B, S, Hq, Dh]."""
    _check(q, k_pool, v_pool, tables, lens)
    B, S, Hq, Dh = q.shape
    n_blocks, bs, Kv, _ = k_pool.shape
    MB = tables.shape[1]
    out = torch.empty_like(q)
    if B == 0 or S == 0 or MB == 0 or n_blocks == 0:
        return out.zero_()
    plan = paged_plan(B, S, Hq, Kv, Dh, bs, MB,
                      build.sm_count(q.device.index), k_pool.element_size())
    if plan["smem"] > _SMEM_LIMIT:
        raise ValueError(f"paged_attention: a table of {MB} entries needs "
                         f"{plan['smem']} bytes of shared memory "
                         f"(> {_SMEM_LIMIT})")
    n_split = plan["n_split"]
    part_o = part_ml = part = None
    if n_split > 1:
        # the partial state of every split: acc f32[n_split, B, S, Hq, Dh]
        # then (m, l) f32[n_split, B, S, Hq, 2], in one allocation
        n = n_split * B * S * Hq
        part = torch.empty(n * (Dh + 2), dtype=torch.float32,
                           device=q.device)
        part_o, part_ml = part.data_ptr(), part.data_ptr() + 4 * n * Dh
    fn = _fn(k_pool.dtype)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 tables.data_ptr(), lens.data_ptr(), out.data_ptr(),
                 part_o, part_ml, B, S, Hq, Kv, Dh, n_blocks, bs, MB, n_split,
                 Dh ** -0.5, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: "
                           f"cudaError {err}")
    build.count_launch("paged_attention")
    return out


@functools.cache
def decode_plan(B: int, S: int, Hq: int, Kv: int, Dh: int,
                dtype_bytes: int, n_sm: int) -> dict:
    """The launch decode_attention.cu makes for these shapes: the query
    heads per CTA it pads to (``rows``), its grid, the context split
    ``n_split`` (from S, B*Kv and the SM count, never from kv_len) and its
    dynamic shared memory in bytes (the layout in the .cu source: the
    queries, then per warp a two-stage ring of K and V chunks and P). One
    plan per shape is kept, and callers must not change it."""
    G = Hq // Kv
    rm = next(r for r in _DECODE_ROWS if r >= min(G, _DECODE_ROWS[-1]))
    n_gt = -(-G // rm)
    lpk = max(1, Dh // 32)
    kc = 32 // lpk
    ks = Dh + (16 // dtype_bytes) * lpk
    stage = kc * (ks + Dh) * dtype_bytes
    smem = 4 * rm * Dh + _DECODE_WARPS * (2 * stage + 4 * rm * kc)
    base = B * Kv * n_gt
    n_chunks = -(-S // kc)
    n_split = max(1, min(-(-_CTAS_PER_SM * n_sm // base),
                         -(-n_chunks // _DECODE_WARPS)))
    return {"rows": rm, "chunk": kc, "grid": (n_split, Kv * n_gt, B),
            "n_split": n_split, "smem": smem}


def _decode_fn(kv_dtype: torch.dtype):
    lib = build.load("decode_attention")
    fn = lib.decode_attention_bf16 if kv_dtype == torch.bfloat16 \
        else lib.decode_attention_f32
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i,
                       ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


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
    if Dh not in _DECODE_HEAD_DIMS:
        raise ValueError(f"decode_attention: needs d_head in "
                         f"{_DECODE_HEAD_DIMS}, got {Dh}")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("decode_attention: k and v need a 16-byte aligned "
                         "base (16-byte cp.async copies)")
    if B > 65535:
        raise ValueError(f"decode_attention: grid too large for B={B}")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel (and its combine pass when the context is
    split across CTAs) on the current stream, no synchronise.

    q f32[B, Hq, Dh]; k, v [B, S, Kv, Dh] in f32 or bf16; kv_len i32[B]
    (positions [0, min(kv_len, S)) are visible); Dh 16, 32, 64, 80 or 128.
    Returns f32[B, Hq, Dh]."""
    _decode_check(q, k, v, kv_len)
    B, Hq, Dh = q.shape
    S, Kv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if B == 0 or S == 0:
        return out.zero_()
    plan = decode_plan(B, S, Hq, Kv, Dh, k.element_size(),
                       build.sm_count(q.device.index))
    if plan["smem"] > _SMEM_LIMIT or plan["grid"][1] > 65535:
        raise ValueError(f"decode_attention: {Hq // Kv} query heads per KV "
                         f"head need grid {plan['grid']} and {plan['smem']} "
                         f"bytes of shared memory (limits 65535, "
                         f"{_SMEM_LIMIT})")
    n_split = plan["n_split"]
    part_o = part_ml = part = None
    if n_split > 1:
        # the partial state of every split: acc f32[n_split, B, Hq, Dh]
        # then (m, l) f32[n_split, B, Hq, 2], in one allocation
        n = n_split * B * Hq
        part = torch.empty(n * (Dh + 2), dtype=torch.float32,
                           device=q.device)
        part_o, part_ml = part.data_ptr(), part.data_ptr() + 4 * n * Dh
    fn = _decode_fn(k.dtype)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
                 out.data_ptr(), part_o, part_ml, B, S, Hq, Kv, Dh, n_split,
                 Dh ** -0.5, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: "
                           f"cudaError {err}")
    build.count_launch("decode_attention")
    return out
