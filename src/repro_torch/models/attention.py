"""Multi-head attention (MHA/GQA) with a KV cache: the contiguous slot
cache (prefill and single-token decode) and the paged serving step; the
projections take qwen2.5's QKV bias and qwen3's per-head qk-norm."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops, ref
from repro_torch.models import layers, rope
from repro_torch.serve import kv_cache


def init_attn(generator: torch.Generator, cfg: ModelConfig,
              dtype: torch.dtype, device: torch.device) -> dict:
    d, dh = cfg.d_model, cfg.d_head
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    p = {"wq": layers.dense_init(generator, (d, nq * dh), dtype, device),
         "wk": layers.dense_init(generator, (d, nkv * dh), dtype, device),
         "wv": layers.dense_init(generator, (d, nkv * dh), dtype, device),
         "wo": layers.dense_init(generator, (nq * dh, d), dtype, device)}
    if cfg.qkv_bias:
        for name, n in (("bq", nq), ("bk", nkv), ("bv", nkv)):
            p[name] = torch.zeros(n * dh, dtype=dtype, device=device)
    if cfg.qk_norm:
        for name in ("q_norm", "k_norm"):
            p[name] = torch.ones(dh, dtype=dtype, device=device)
    return p


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  dtype: torch.dtype, device: torch.device) -> dict:
    """Contiguous per-slot KV storage [batch, max_len, Kv, Dh]."""
    shape = (batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_paged_kv_cache(cfg: ModelConfig, n_blocks: int, block_size: int,
                        dtype: torch.dtype, device: torch.device,
                        int8_kv: bool = False) -> dict:
    """Block-pool KV storage: requests own scattered fixed-size token
    blocks. Block index ``n_blocks`` is the invalid sentinel — writes
    through it drop, reads through it see nothing. (The serving cache
    allocates a few more blocks behind the pool, which no table names:
    ``transformer.init_paged_cache`` and ``_store_paged``.)

    ``int8_kv``: 1 byte per element plus one f32 scale per (token, head)
    for each of K and V (the ``kv_cache.quantize_kv`` layout), as
    ``paged_kv.kv_bytes_per_token`` counts it."""
    shape = (n_blocks, block_size, cfg.n_kv_heads, cfg.d_head)
    if not int8_kv:
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    sshape = shape[:-1] + (1,)
    return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(sshape, dtype=torch.float32,
                                   device=device),
            "v_scale": torch.zeros(sshape, dtype=torch.float32,
                                   device=device)}


def _qkv(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """The q, k, v projections of x [B, S, d] per head, before RoPE: the
    bias (``qkv_bias``) after the products, the per-head RMS norm
    (``qk_norm``) after the reshape."""
    B, S, _ = x.shape
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, cfg.n_heads, cfg.d_head)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.d_head)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.d_head)
    if cfg.qk_norm:
        q = layers.head_rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = layers.head_rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def causal_attention(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """Full-sequence causal GQA attention, softmax in f32: query i sees keys
    [0, i]. q [B, S, Hq, Dh]; k, v [B, S, Kv, Dh]. Returns f32[B, S, Hq, Dh].

    The reference computes this with ``models/flash.blockwise_attention``,
    an online softmax in pure JAX (no Pallas kernel); one masked softmax
    over all keys is the same function."""
    B, S, Hq, Dh = q.shape
    Kv = k.shape[2]
    qg = q.reshape(B, S, Kv, Hq // Kv, Dh).float() * Dh ** -0.5
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())
    pos = torch.arange(S, device=q.device)
    s = s.masked_fill(pos[None, :] > pos[:, None], ref.NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, S, Hq, Dh)


def attn_forward(p: dict, cfg: ModelConfig, x: torch.Tensor,
                 cos: torch.Tensor, sin: torch.Tensor,
                 cache: Optional[dict] = None) -> torch.Tensor:
    """Attention for a prefill (full sequence, causal, starting at
    position 0). x: [B, S, d]; cos/sin: [B, S, dh//2]. With ``cache`` the
    segment's K/V are written at [0, S) of it in place (the reference
    returns the updated cache instead). Returns [B, S, d]."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, cfg, x)
    q = rope.apply_rope(q, cos, sin)
    k = rope.apply_rope(k, cos, sin)
    if cache is not None:
        cache["k"][:, :S] = k.to(cache["k"].dtype)
        cache["v"][:, :S] = v.to(cache["v"].dtype)
    o = causal_attention(q, k, v).to(x.dtype)
    return o.reshape(B, S, cfg.n_heads * cfg.d_head) @ p["wo"]


def attn_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
                cos: torch.Tensor, sin: torch.Tensor, cache: dict,
                lens: torch.Tensor) -> torch.Tensor:
    """One-token decode: x [B, 1, d]; ``lens`` i32[B] is each row's
    current context length. The new K/V are written at position lens[b]
    in place (a row whose lens[b] is past the cache drops its write, as
    the reference's ``mode="drop"`` does) and the query attends to the
    first lens[b]+1 positions through the decode-attention kernel
    (``ops.decode_attention``), which clamps that count to the cache
    length. Returns [B, 1, d]."""
    B = x.shape[0]
    q, k, v = _qkv(p, cfg, x)
    q = rope.apply_rope(q, cos, sin)
    k = rope.apply_rope(k, cos, sin)
    rows = torch.arange(B, device=x.device)
    # a dropped write rewrites the slot's last entry with itself: no
    # boolean indexing, so no device-to-host sync
    at = lens.long().clamp(max=cache["k"].shape[1] - 1)
    keep = (lens.long() < cache["k"].shape[1])[:, None, None]
    for name, new in (("k", k), ("v", v)):
        c = cache[name]
        c[rows, at] = torch.where(keep, new[:, 0].to(c.dtype), c[rows, at])
    o = ops.decode_attention(q[:, 0].float().contiguous(), cache["k"],
                             cache["v"], lens + 1)
    o = o.reshape(B, 1, cfg.n_heads * cfg.d_head).to(x.dtype)
    return o @ p["wo"]


def _write_rows(blk: torch.Tensor, off: torch.Tensor, n_blocks: int,
                block_size: int, trash_rows: int) -> torch.Tensor:
    """Where each (blk, off) entry of a step writes, as a token row of the
    pool's slab (``_store_paged``): a real block's row, or for an entry
    whose block is the sentinel a row of the ``trash_rows`` trash tokens
    behind the pool, which no table names and nothing reads. Entry e
    takes trash row e, so no row is named twice. Returns i64[E]; nothing
    here reads a device value on the host."""
    if blk.numel() > trash_rows:
        raise ValueError(f"a step of {blk.numel()} KV entries needs as many "
                         f"trash rows behind the pool, the cache has "
                         f"{trash_rows}: make it with init_paged_cache and a "
                         f"max_width that covers the step")
    e = torch.arange(blk.numel(), device=blk.device).reshape(blk.shape)
    dst = torch.where(blk < n_blocks, blk.long() * block_size + off,
                      n_blocks * block_size + e)
    return dst.reshape(-1)


def _store_paged(cache: dict, name: str, dst: torch.Tensor,
                 val: torch.Tensor) -> None:
    """Scatter ``val`` [B, S, Kv, Dh] into pool leaf ``name`` at the slab
    rows ``dst`` (``_write_rows``); the sentinel entries land in the trash
    blocks. int8 pools (the leaf has a ``{name}_scale`` sibling) store
    ``kv_cache.quantize_kv``'s bytes and per-(token, head) scales. The
    reference's functional ``.at[blk, off].set(val, mode="drop")`` becomes
    an in-place write of fixed shape: no boolean mask, so no device-to-host
    sync, and no row is named twice, so it is deterministic. Each leaf
    [n_blocks, bs, ...] is a view of one layer's slab, whose
    ``cache["trash_rows"]`` trash tokens follow the pool in memory
    (``transformer.init_paged_cache``); the write goes through the slab
    and lands in the engine's cache without a copy."""
    writes = [(cache[name], val)]
    if f"{name}_scale" in cache:
        (q8, scale), _ = kv_cache.quantize_kv(val, val)
        writes = [(cache[name], q8), (cache[f"{name}_scale"], scale)]
    for leaf, v in writes:
        rows = leaf.shape[0] * leaf.shape[1] + cache["trash_rows"]
        slab = leaf.as_strided((rows,) + leaf.shape[2:], leaf.stride()[1:])
        slab[dst] = v.reshape((-1,) + v.shape[2:]).to(leaf.dtype)


def _read_paged(cache: dict, name: str, tables: torch.Tensor
                ) -> torch.Tensor:
    """Pool leaf ``name`` gathered through the block tables into [B,
    MB*bs, Kv, Dh], int8 pools dequantized to f32 (sentinel blocks gather
    zero scales, hence zeros)."""
    g = ref._gather_paged(cache[name], tables)
    if f"{name}_scale" not in cache:
        return g
    return g.float() * ref._gather_paged(cache[f"{name}_scale"], tables)


def attn_step_paged(p: dict, cfg: ModelConfig, x: torch.Tensor,
                    cos: torch.Tensor, sin: torch.Tensor, cache: dict,
                    lens: torch.Tensor, n_valid: torch.Tensor,
                    tables: torch.Tensor, block_size: int,
                    backend: str = "naive") -> torch.Tensor:
    """One attention entry for every serving phase, through block tables.

    Row b's queries sit at positions lens[b]+j for j in [0, S); their KV
    scatters through the row's table (positions j >= n_valid[b] are
    padding and drop at the sentinel) and query j attends to [0,
    lens[b]+j]. ``backend`` picks the read: "naive" is the plain masked
    read over the gathered tables (int8 pools dequantize there), "flash"
    the paged-attention kernel (``ops.paged_attention``), which reads the
    fp pools directly.

    x: [B, S, d]; lens/n_valid: i32[B]; tables: i32[B, MB] (inactive rows
    all-sentinel). Writes ``cache["k"]``/``cache["v"]`` in place (their
    trash size ``cache["trash_rows"]``) and returns the attention output
    [B, S, d]."""
    B, S, _ = x.shape
    n_blocks = cache["k"].shape[0]
    MB = tables.shape[1]
    q, k, v = _qkv(p, cfg, x)
    q = rope.apply_rope(q, cos, sin)
    k = rope.apply_rope(k, cos, sin)
    j = torch.arange(S, device=x.device)
    gpos = lens[:, None].long() + j[None, :]                 # [B, S]
    col = (gpos // block_size).clamp(max=MB - 1)
    blk = torch.gather(tables, 1, col)
    blk = torch.where((j[None, :] < n_valid[:, None])
                      & (gpos // block_size < MB), blk, n_blocks)
    off = gpos % block_size
    dst = _write_rows(blk, off, n_blocks, block_size, cache["trash_rows"])
    _store_paged(cache, "k", dst, k)
    _store_paged(cache, "v", dst, v)
    if backend == "flash":
        # the kernel reads an f32 q (the pools are f32 for every model):
        # a bf16 model's q widens exactly, as for the decode kernel
        o = ops.paged_attention(q.float().contiguous(), cache["k"],
                                cache["v"], tables, lens)
    else:
        o = ref.gathered_attention(q, _read_paged(cache, "k", tables),
                                   _read_paged(cache, "v", tables), lens)
    o = o.reshape(B, S, cfg.n_heads * cfg.d_head).to(x.dtype)
    return o @ p["wo"]
