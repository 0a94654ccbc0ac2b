"""Multi-head attention (MHA/GQA) with a KV cache: the contiguous slot
cache (prefill and single-token decode) and the paged serving step."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops, ref
from repro_torch.models import layers, rope


def init_attn(generator: torch.Generator, cfg: ModelConfig,
              dtype: torch.dtype, device: torch.device) -> dict:
    d, dh = cfg.d_model, cfg.d_head
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    return {"wq": layers.dense_init(generator, (d, nq * dh), dtype, device),
            "wk": layers.dense_init(generator, (d, nkv * dh), dtype, device),
            "wv": layers.dense_init(generator, (d, nkv * dh), dtype, device),
            "wo": layers.dense_init(generator, (nq * dh, d), dtype, device)}


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  dtype: torch.dtype, device: torch.device) -> dict:
    """Contiguous per-slot KV storage [batch, max_len, Kv, Dh]."""
    shape = (batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_paged_kv_cache(cfg: ModelConfig, n_blocks: int, block_size: int,
                        dtype: torch.dtype, device: torch.device) -> dict:
    """Block-pool KV storage (fp pools only): requests own scattered
    fixed-size token blocks. Block index ``n_blocks`` is the invalid
    sentinel — writes through it drop, reads through it see nothing."""
    shape = (n_blocks, block_size, cfg.n_kv_heads, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _qkv(p: dict, cfg: ModelConfig, x: torch.Tensor):
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, cfg.n_heads, cfg.d_head)
    k = (x @ p["wk"]).reshape(B, S, cfg.n_kv_heads, cfg.d_head)
    v = (x @ p["wv"]).reshape(B, S, cfg.n_kv_heads, cfg.d_head)
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


def _store_paged(pool: torch.Tensor, blk: torch.Tensor, off: torch.Tensor,
                 val: torch.Tensor) -> None:
    """Scatter ``val`` [B, S, Kv, Dh] into ``pool`` at (blk, off); entries
    whose block is the sentinel drop. The reference's functional
    ``.at[blk, off].set(val, mode="drop")`` becomes an in-place write here:
    ``pool`` is a view of the stacked [n_units, ...] pool, so the write
    lands in the engine's cache without a copy."""
    keep = blk < pool.shape[0]
    pool[blk[keep].long(), off[keep].long()] = val[keep].to(pool.dtype)


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
    read over the gathered tables, "flash" the paged-attention kernel
    (``ops.paged_attention``), which reads the pools directly.

    x: [B, S, d]; lens/n_valid: i32[B]; tables: i32[B, MB] (inactive rows
    all-sentinel). Writes ``cache["k"]``/``cache["v"]`` in place and
    returns the attention output [B, S, d]."""
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
    _store_paged(cache["k"], blk, off, k)
    _store_paged(cache["v"], blk, off, v)
    if backend == "flash":
        o = ops.paged_attention(q.contiguous(), cache["k"], cache["v"],
                                tables, lens)
    else:
        o = ref.paged_attention_plain(q, cache["k"], cache["v"], tables,
                                      lens)
    o = o.reshape(B, S, cfg.n_heads * cfg.d_head).to(x.dtype)
    return o @ p["wo"]
