"""Plain PyTorch versions of the port's CUDA kernels.

Each one computes exactly what its kernel computes, in straightforward
tensor code: the CPU tests hold them against the JAX reference,
``chip_smoke.py`` holds each kernel against its plain version on the card,
and ``ops`` sends CPU tensors here.
"""

from __future__ import annotations

import torch

from repro_torch.core import quant

NEG_INF = -1e30


def _gather_paged(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """[n_blocks, bs, Kv, Dh] gathered through tables i32[B, MB] ->
    [B, MB*bs, Kv, Dh]. Entries outside [0, n_blocks) (the sentinel
    ``n_blocks``) fill zeros."""
    n_blocks = pool.shape[0]
    B, MB = tables.shape
    valid = (tables >= 0) & (tables < n_blocks)
    g = pool[torch.where(valid, tables, 0).long()]      # [B, MB, bs, Kv, Dh]
    g = g.masked_fill(~valid[:, :, None, None, None], 0.0)
    return g.reshape(B, MB * pool.shape[1], *pool.shape[2:])


def _gather_clamped(pool: torch.Tensor, tables: torch.Tensor
                    ) -> torch.Tensor:
    """[n_blocks, bs, Kv, Dh] gathered through tables i32[B, MB] ->
    [B, MB*bs, Kv, Dh], an entry outside [0, n_blocks) (the sentinel)
    reading block 0, as the reference kernel's index map clamps it."""
    n_blocks = pool.shape[0]
    B, MB = tables.shape
    valid = (tables >= 0) & (tables < n_blocks)
    g = pool[torch.where(valid, tables, 0).long()]      # [B, MB, bs, Kv, Dh]
    return g.reshape(B, MB * pool.shape[1], *pool.shape[2:])


def paged_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, tables: torch.Tensor,
                          lens: torch.Tensor) -> torch.Tensor:
    """Paged GQA attention for S query rows per slot.

    q f[B, S, Hq, Dh]; k_pool/v_pool f[n_blocks, bs, Kv, Dh]; tables
    i32[B, MB] (sentinel ``n_blocks``); lens i32[B]. Query j of row b sits
    at position lens[b]+j and sees kv positions <= lens[b]+j. The tables
    are gathered into one logical sequence and masked per query. A
    sentinel entry inside a query's causal limit reads block 0, as the
    reference kernel does (its index map clamps the sentinel): only
    padding positions and IDLE rows meet one, and an MoE block routes
    those rows too. Returns f32[B, S, Hq, Dh]."""
    return gathered_attention(q, _gather_clamped(k_pool, tables),
                              _gather_clamped(v_pool, tables), lens)


def gathered_attention(q: torch.Tensor, kg: torch.Tensor, vg: torch.Tensor,
                       lens: torch.Tensor) -> torch.Tensor:
    """The masked read of ``paged_attention_plain`` over K/V already
    gathered through the tables: kg, vg [B, Skv, Kv, Dh]. Query j of row b
    sees positions <= lens[b]+j. Returns f32[B, S, Hq, Dh]."""
    B, S, Hq, Dh = q.shape
    Kv = kg.shape[2]
    G = Hq // Kv
    kg, vg = kg.float(), vg.float()
    qg = q.reshape(B, S, Kv, G, Dh).float() * Dh ** -0.5
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, kg)
    Skv = kg.shape[1]
    gpos = lens[:, None].long() + torch.arange(S, device=q.device)[None, :]
    vis = torch.arange(Skv, device=q.device)[None, None, :] \
        <= gpos[:, :, None]                             # [B, S, Skv]
    s = s.masked_fill(~vis[:, None, None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, vg)
    return o.reshape(B, S, Hq, Dh)


def sparse_gather_matvec_plain(h: torch.Tensor, idx: torch.Tensor,
                               w_down: torch.Tensor) -> torch.Tensor:
    """out[b] = sum_j h[b, j] * w_down[idx[b, j]], where idx == d_ff names
    an empty slot (a zero row). h f[B, k]; idx i32[B, k]; w_down
    f[d_ff, d]. Returns f32[B, d]."""
    d = w_down.shape[1]
    wpad = torch.cat([w_down, w_down.new_zeros(1, d)], dim=0)
    rows = wpad.index_select(0, idx.reshape(-1).long())
    rows = rows.reshape(*idx.shape, d)
    return torch.einsum("bk,bkd->bd", h.float(), rows.float())


def relu_ffn_plain(x: torch.Tensor, w_up: torch.Tensor,
                   w_down: torch.Tensor) -> torch.Tensor:
    """Fused ReLU-FFN (non-GLU): relu(x @ w_up) @ w_down. x f[M, d];
    w_up f[d, f]; w_down f[f, d]. Returns f32[M, d]. A d_ff block whose
    hidden values are all <= 0 adds exactly zero, so the kernel's skip of
    such blocks needs no counterpart here."""
    return (torch.relu(x @ w_up) @ w_down).float()


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor,
                           kv_len: torch.Tensor) -> torch.Tensor:
    """GQA decode attention over a contiguous cache, softmax in f32.

    q f[B, Hq, Dh]; k, v f[B, S, Kv, Dh] (f32 or bf16); kv_len i32[B].
    Position s of row b is visible iff s < kv_len[b], so kv_len >= S shows
    all S positions (and kv_len <= 0, with every score at NEG_INF, spreads
    the softmax evenly over all S). Returns f32[B, Hq, Dh]."""
    B, Hq, Dh = q.shape
    S, Kv = k.shape[1], k.shape[2]
    qg = q.reshape(B, Kv, Hq // Kv, Dh).float() * Dh ** -0.5
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.float())
    vis = torch.arange(S, device=q.device)[None, :] < kv_len[:, None].long()
    s = s.masked_fill(~vis[:, None, None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    return o.reshape(B, Hq, Dh)


def nmce_matmul_plain(x_q: torch.Tensor, w_q: torch.Tensor,
                      x_scale: torch.Tensor, w_scale: torch.Tensor,
                      saturate_int16: bool = False) -> torch.Tensor:
    """W8A8 matmul: x_q i8[M, K] @ w_q i8[K, N] with exact integer
    accumulation, then f32 ``acc * x_scale * w_scale`` (x_scale f32[M, 1],
    w_scale f32[1, N]), in that order. ``saturate_int16`` clips each
    64-wide K chunk (K zero-padded to a multiple of 64) to int16 before the
    cross-chunk sum. Bit-exact on either device (``quant.int_matmul``)."""
    acc = quant.int_matmul(x_q, w_q, saturate_int16)
    return acc.to(torch.int32).float() * x_scale * w_scale
