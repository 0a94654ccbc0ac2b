"""Plain PyTorch versions of the port's CUDA kernels.

Each one computes exactly what its kernel computes, in straightforward
tensor code: the CPU tests hold them against the JAX reference,
``chip_smoke.py`` holds each kernel against its plain version on the card,
and ``ops`` sends CPU tensors here.
"""

from __future__ import annotations

import torch

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


def paged_attention_plain(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, tables: torch.Tensor,
                          lens: torch.Tensor) -> torch.Tensor:
    """Paged GQA attention for S query rows per slot.

    q f[B, S, Hq, Dh]; k_pool/v_pool f[n_blocks, bs, Kv, Dh]; tables
    i32[B, MB] (sentinel ``n_blocks``); lens i32[B]. Query j of row b sits
    at position lens[b]+j and sees kv positions <= lens[b]+j. The tables
    are gathered into one logical sequence and masked per query.
    Returns f32[B, S, Hq, Dh]."""
    B, S, Hq, Dh = q.shape
    Kv = k_pool.shape[2]
    G = Hq // Kv
    kg = _gather_paged(k_pool, tables).float()          # [B, Skv, Kv, Dh]
    vg = _gather_paged(v_pool, tables).float()
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
