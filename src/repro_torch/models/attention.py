"""Paged multi-head attention (MHA/GQA) for the serving step."""

from __future__ import annotations

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
