"""Multi-head attention (MHA/GQA) with a KV cache: the contiguous slot
cache (prefill and single-token decode) and the paged serving step; the
projections take qwen2.5's QKV bias and qwen3's per-head qk-norm. Under
an activation-sharding scope (dist.sharding) the paged step runs tensor
parallel: each shard computes its own heads against its head slice of
the block pool."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import sharding
from repro_torch.kernels import ops, ref
from repro_torch.models import flash, layers, rope
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
                        int8_kv: bool = False,
                        kv_heads: Optional[int] = None) -> dict:
    """Block-pool KV storage: requests own scattered fixed-size token
    blocks. Block index ``n_blocks`` is the invalid sentinel — writes
    through it drop, reads through it see nothing. (The serving cache
    allocates a few more blocks behind the pool, which no table names:
    ``transformer.init_paged_cache`` and ``_store_paged``.)

    ``int8_kv``: 1 byte per element plus one f32 scale per (token, head)
    for each of K and V (the ``kv_cache.quantize_kv`` layout), as
    ``paged_kv.kv_bytes_per_token`` counts it. ``kv_heads`` (default the
    config's) is a shard's head slice of a KV-head-sharded pool."""
    shape = (n_blocks, block_size, kv_heads or cfg.n_kv_heads, cfg.d_head)
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
    (``qk_norm``) after the reshape. Under an activation-sharding scope a
    column-sharded projection runs once per shard and its blocks are
    gathered on the home device (``sharding.colwise``); off-scope that is
    ``x @ w + b``."""
    B, S, _ = x.shape
    q = sharding.colwise(x, p["wq"], p.get("bq"))
    k = sharding.colwise(x, p["wk"], p.get("bk"))
    v = sharding.colwise(x, p["wv"], p.get("bv"))
    q = q.reshape(B, S, cfg.n_heads, cfg.d_head)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.d_head)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.d_head)
    if cfg.qk_norm:
        q = layers.head_rms_norm(q, sharding.whole(p["q_norm"]),
                                 cfg.norm_eps)
        k = layers.head_rms_norm(k, sharding.whole(p["k_norm"]),
                                 cfg.norm_eps)
    return q, k, v


def attn_forward(p: dict, cfg: ModelConfig, x: torch.Tensor,
                 cos: torch.Tensor, sin: torch.Tensor,
                 cache: Optional[dict] = None,
                 block_kv: int = 512) -> torch.Tensor:
    """Attention for training and prefill (full sequence, causal, starting
    at position 0). x: [B, S, d]; cos/sin: [B, S, dh//2]. With ``cache``
    the segment's K/V are written at [0, S) of it in place (the reference
    returns the updated cache instead). The read is the reference's
    blockwise flash attention (``flash.blockwise_attention``, with its
    recompute-per-block backward), or its lower-triangle schedule
    (``flash.block_causal_attention``) under ``cfg.block_causal`` when S
    is longer than a block. Returns [B, S, d]."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, cfg, x)
    q = rope.apply_rope(q, cos, sin)
    k = rope.apply_rope(k, cos, sin)
    if cache is not None:
        cache["k"][:, :S] = k.to(cache["k"].dtype)
        cache["v"][:, :S] = v.to(cache["v"].dtype)
    qg = q.reshape(B, S, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
                   cfg.d_head)
    if cfg.block_causal and S > block_kv:
        o = flash.block_causal_attention(qg, k, v, block_q=block_kv,
                                         block_kv=block_kv)
    else:
        o = flash.blockwise_attention(qg, k, v, causal=True,
                                      block_kv=block_kv)
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
    scope = sharding.current_scope()
    if scope is not None:
        return _attn_step_paged_mesh(p, cfg, x, cos, sin, cache, lens,
                                     n_valid, tables, block_size, scope[0],
                                     scope[1])
    B, S, _ = x.shape
    q, k, v = _qkv(p, cfg, x)
    q = rope.apply_rope(q, cos, sin)
    k = rope.apply_rope(k, cos, sin)
    dst = _step_rows(cache, lens, n_valid, tables, block_size, S)
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


def _step_rows(cache: dict, lens: torch.Tensor, n_valid: torch.Tensor,
               tables: torch.Tensor, block_size: int, S: int
               ) -> torch.Tensor:
    """The slab rows (``_write_rows``) where a step's S positions a row
    write their K/V: row b's position j at lens[b]+j through its table,
    the padding past n_valid[b] and positions past the table at the
    sentinel (the trash blocks)."""
    n_blocks = cache["k"].shape[0]
    MB = tables.shape[1]
    j = torch.arange(S, device=lens.device)
    gpos = lens[:, None].long() + j[None, :]                 # [B, S]
    col = (gpos // block_size).clamp(max=MB - 1)
    blk = torch.gather(tables, 1, col)
    blk = torch.where((j[None, :] < n_valid[:, None])
                      & (gpos // block_size < MB), blk, n_blocks)
    off = gpos % block_size
    return _write_rows(blk, off, n_blocks, block_size, cache["trash_rows"])


def _kv_seq_mesh(seq_len: int, mesh, policy):
    """The mesh where a single-token step's attention should run through
    the LSE-combine collective: ``policy.shard_kv_seq``, a real 'model'
    axis, and a gathered sequence that divides across it (the
    reference's ``_kv_seq_scope``); None otherwise."""
    if not policy.shard_kv_seq or "model" not in mesh.axis_names:
        return None
    msize = mesh.shape["model"]
    if msize <= 1 or seq_len % msize != 0:
        return None
    return mesh


def _shard_qkv(p: dict, cfg: ModelConfig, x: torch.Tensor, i: int, n: int):
    """Shard i's q, k, v heads [B, S, H/n, Dh] before RoPE, from its
    column blocks of wq/wk/wv (heads are contiguous columns, so with GQA
    its q heads read its own KV heads); the bias contributes its block
    of the columns, the per-head qk-norm weights are whole."""
    B, S, _ = x.shape
    out = []
    for w, b, heads in (("wq", "bq", cfg.n_heads), ("wk", "bk", cfg.n_kv_heads),
                        ("wv", "bv", cfg.n_kv_heads)):
        wi = p[w].shards[i]
        y = x.to(wi.device) @ wi
        if cfg.qkv_bias:
            c = wi.shape[-1]
            y = y + sharding.column_block(p[b], i, i * c, (i + 1) * c
                                          ).to(wi.device)
        out.append(y.reshape(B, S, heads // n, cfg.d_head))
    q, k, v = out
    if cfg.qk_norm:
        dev = q.device
        q = layers.head_rms_norm(q, sharding.whole(p["q_norm"]).to(dev),
                                 cfg.norm_eps)
        k = layers.head_rms_norm(k, sharding.whole(p["k_norm"]).to(dev),
                                 cfg.norm_eps)
    return q, k, v


def _attn_step_paged_mesh(p: dict, cfg: ModelConfig, x: torch.Tensor,
                          cos: torch.Tensor, sin: torch.Tensor, cache: dict,
                          lens: torch.Tensor, n_valid: torch.Tensor,
                          tables: torch.Tensor, block_size: int, mesh,
                          policy) -> torch.Tensor:
    """``attn_step_paged`` under an activation-sharding scope (the naive
    read; the runner refuses the flash backend under a mesh, as the
    reference does).

    With a KV-head-sharded pool (its K/V leaves ``Sharded`` on axis 3),
    shard i computes its contiguous heads from its column blocks of
    wq/wk/wv, writes and reads only its head slice of every block, and
    attends on its device; the heads' outputs are gathered on the home
    device. A replicated pool (KV heads that do not divide) takes the
    gathered q/k/v and attends once on the home device. With
    ``shard_kv_seq`` a single-token step's gathered logical sequence
    goes through ``lse_combine_decode_attention`` instead. Then o is
    multiplied by the column-sharded wo and gathered again
    (``constrain_tp_exact``), as the reference's
    ``attention.attn_step_paged`` under exact_tp: no sum of partial
    products anywhere."""
    B, S, _ = x.shape
    home = mesh.home
    dst = _step_rows(cache, lens, n_valid, tables, block_size, S)
    if isinstance(cache["k"], sharding.Sharded):
        n = len(cache["k"].shards)
        qs, kgs, vgs = [], [], []
        for i in range(n):
            q, k, v = _shard_qkv(p, cfg, x, i, n)
            dev = q.device
            c, s = cos.to(dev), sin.to(dev)
            q, k = rope.apply_rope(q, c, s), rope.apply_rope(k, c, s)
            part = {name: leaf.shards[i] for name, leaf in cache.items()
                    if isinstance(leaf, sharding.Sharded)}
            part["trash_rows"] = cache["trash_rows"]
            d = dst.to(dev)
            _store_paged(part, "k", d, k)
            _store_paged(part, "v", d, v)
            t = tables.to(dev)
            qs.append(q)
            kgs.append(_read_paged(part, "k", t))
            vgs.append(_read_paged(part, "v", t))
    else:
        q, k, v = _qkv(p, cfg, x)
        q = rope.apply_rope(q, cos, sin)
        k = rope.apply_rope(k, cos, sin)
        _store_paged(cache, "k", dst, k)
        _store_paged(cache, "v", dst, v)
        qs, kgs, vgs = [q], [_read_paged(cache, "k", tables)], \
            [_read_paged(cache, "v", tables)]
    kv_mesh = _kv_seq_mesh(kgs[0].shape[1], mesh, policy) if S == 1 \
        else None
    if kv_mesh is not None:
        from repro_torch.dist.collectives import lse_combine_decode_attention
        q = torch.cat([t.to(home) for t in qs], dim=2)
        kg = torch.cat([t.to(home) for t in kgs], dim=2)
        vg = torch.cat([t.to(home) for t in vgs], dim=2)
        qg = q.reshape(B, 1, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads,
                       cfg.d_head)
        o = lse_combine_decode_attention(kv_mesh, qg[:, 0], kg, vg,
                                         lens + 1)[:, None]
    else:
        o = torch.cat([ref.gathered_attention(q, kg, vg, lens.to(q.device))
                       .to(home) for q, kg, vg in zip(qs, kgs, vgs)], dim=2)
    o = sharding.constrain_tp_exact(
        o.reshape(B, S, cfg.n_heads * cfg.d_head).to(x.dtype))
    return sharding.colwise(o, p["wo"])

