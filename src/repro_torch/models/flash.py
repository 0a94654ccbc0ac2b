"""Blockwise (flash-style) attention: an online softmax over KV blocks,
with a backward that recomputes each block.

The port of ``repro.models.flash``. Memory stays O(Sq * block) instead of
O(Sq * Skv) in the forward and in the backward: the autograd Function
saves (q, k, v, o, lse) and recomputes each block's probabilities from
the log-sum-exp, FlashAttention-2 style, as the reference's custom VJP
does. The reference writes this in pure JAX (no Pallas kernel), so plain
PyTorch ops are its port. The reference's ``unroll`` flag only changes
how XLA lowers its scans; a Python loop over the blocks has no such
choice, so the port takes no ``unroll``.

Every score and output is summed in f32 over the operands' own values
(``preferred_element_type=jnp.float32``), as the reference does. Two
forward steps differ for a bf16 model: the reference scales q in bf16
and rounds the probabilities to V's dtype before the P·V product (the
TPU's MXU takes bf16 operands); here both stay f32. A card run and a CPU
run that each take those roundings part by more than either's distance
from the f32 forward (musicgen-medium's 48-layer slot prefill;
qwen2-vl-72b's ``Model.forward`` at d_head 128, whose scale is no power
of two). f32 models, every training test's, are not affected. Causal
handling: fully masked blocks are still computed (static shapes), as in
the reference.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

NEG_INF = -1e30


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q [B, Sq, Kv, G, Dh], k [B, Skv, Kv, Dh] -> f32[B, Kv, G, Sq, Skv]."""
    return torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float())


def _gqa_out(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p f32[B, Kv, G, Sq, Skv], v [B, Skv, Kv, Dh] -> f32[B, Kv, G, Sq,
    Dh]."""
    return torch.einsum("bkgqs,bskd->bkgqd", p, v.float())


def _blocks(k: torch.Tensor, v: torch.Tensor, block_kv: int):
    """(block size, number of blocks, k and v zero-padded to whole
    blocks)."""
    Skv = k.shape[1]
    blk = min(block_kv, Skv)
    n_blocks = -(-Skv // blk)
    pad = n_blocks * blk - Skv
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    return blk, n_blocks, k, v


def _bias(kv_pos: torch.Tensor, q_pos: torch.Tensor, Skv: int,
          causal: bool, kv_len: Optional[torch.Tensor]) -> torch.Tensor:
    """The additive f32 mask of one KV block, broadcastable to [B, Kv, G,
    Sq, blk]: 0 where a query sees a key, NEG_INF elsewhere."""
    if causal:
        bias = torch.where(kv_pos[None, :] <= q_pos[:, None], 0.0, NEG_INF)
    else:
        bias = torch.where(kv_pos[None, :] < Skv, 0.0, NEG_INF)
    bias = bias[None, None, None]
    if kv_len is not None:
        lbias = torch.where(kv_pos[None, :] < kv_len[:, None], 0.0, NEG_INF)
        bias = bias + lbias[:, None, None, None]
    return bias


def _scaled(q: torch.Tensor) -> torch.Tensor:
    """q * d_head ** -0.5 in f32."""
    return q.float() * q.shape[-1] ** -0.5


def _blockwise_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, block_kv: int = 512,
                   q_offset: Optional[Union[int, torch.Tensor]] = None,
                   kv_len: Optional[torch.Tensor] = None,
                   q_offset_static: int = 0):
    """Online-softmax attention.

    q: [B, Sq, n_kv, group, d_head]; k, v: [B, Skv, n_kv, d_head].
    ``causal`` masks with queries at positions q_offset + arange(Sq)
    (q_offset defaults to Skv - Sq + q_offset_static); ``kv_len`` i32[B]
    masks each row's tail. Returns (o [B, Sq, n_kv, group, d_head] in
    q's dtype, lse f32[B, n_kv, group, Sq] in the scaled scores' units,
    -inf for a fully masked row)."""
    B, Sq, Kv, G, Dh = q.shape
    Skv = k.shape[1]
    blk, n_blocks, k, v = _blocks(k, v, block_kv)
    dev = q.device
    qf = _scaled(q)
    start = Skv - Sq + q_offset_static if q_offset is None else q_offset
    q_pos = start + torch.arange(Sq, device=dev)
    if n_blocks == 1:
        # one block: the recurrence's function in the plain softmax's
        # order (probabilities normalised before P·V). A bf16 model's
        # card-against-CPU checks sit within a few per cent of their
        # bounds, and each rounding order moves both; this one, the
        # serving prefill's since the first slice, keeps them
        s = _gqa_scores(qf, k) + _bias(torch.arange(Skv, device=dev), q_pos,
                                       Skv, causal, kv_len)
        alive = s.amax(dim=-1) > NEG_INF / 2
        p = torch.where(alive[..., None], torch.softmax(s, dim=-1), 0.0)
        lse = torch.where(alive, torch.logsumexp(s, dim=-1), -torch.inf)
        o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
        return o.to(q.dtype), lse
    m = torch.full((B, Kv, G, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Kv, G, Sq), dtype=torch.float32, device=dev)
    o = torch.zeros((B, Kv, G, Sq, Dh), dtype=torch.float32, device=dev)
    for i in range(n_blocks):
        kc, vc = k[:, i * blk:(i + 1) * blk], v[:, i * blk:(i + 1) * blk]
        kv_pos = i * blk + torch.arange(blk, device=dev)
        s = _gqa_scores(qf, kc) + _bias(kv_pos, q_pos, Skv, causal, kv_len)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # a fully masked row keeps m at NEG_INF: exp(s - m) would be 1
        alive = m_new > NEG_INF / 2
        p = torch.exp(s - torch.where(alive, m_new, 0.0)[..., None])
        p = torch.where(alive[..., None], p, 0.0)
        corr = torch.where(alive, torch.exp(m - m_new), 0.0)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + _gqa_out(p, vc)
        m = m_new
    o = o / torch.clamp(l, min=1e-30)[..., None]
    lse = torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-30)),
                      -torch.inf)
    return o.movedim(-2, 1).to(q.dtype), lse


def _bwd_pass(q, k, v, o, lse, do, *, causal: bool, block_kv: int,
              kv_len: Optional[torch.Tensor]):
    """FlashAttention-2-style backward: each block's probabilities are
    recomputed from lse; memory O(Sq * block). Returns (dq, dk, dv) in
    the dtypes of q, k and v."""
    B, Sq, Kv, G, Dh = q.shape
    Skv = k.shape[1]
    blk, n_blocks, k, v = _blocks(k, v, block_kv)
    dev = q.device
    qf = _scaled(q)
    q_pos = (Skv - Sq) + torch.arange(Sq, device=dev)
    dof = do.float()
    # D[t] = rowsum(do * o)
    Dt = torch.einsum("bqkgd,bqkgd->bkgq", dof, o.float())
    alive = torch.isfinite(lse)
    lse_safe = torch.where(alive, lse, 0.0)
    dq = torch.zeros((B, Sq, Kv, G, Dh), dtype=torch.float32, device=dev)
    dks, dvs = [], []
    for i in range(n_blocks):
        kc, vc = k[:, i * blk:(i + 1) * blk], v[:, i * blk:(i + 1) * blk]
        kv_pos = i * blk + torch.arange(blk, device=dev)
        s = _gqa_scores(qf, kc) + _bias(kv_pos, q_pos, Skv, causal, kv_len)
        p = torch.where(alive[..., None], torch.exp(s - lse_safe[..., None]),
                        0.0)
        # dv = p^T do; dp = do v^T; ds = p * (dp - D)
        dvs.append(torch.einsum("bkgqs,bqkgd->bskd", p, dof))
        dp = torch.einsum("bqkgd,bskd->bkgqs", dof, vc.float())
        dsc = (p * (dp - Dt[..., None])).to(q.dtype).float()
        dq = dq + torch.einsum("bkgqs,bskd->bqkgd", dsc, kc.float())
        dks.append(torch.einsum("bkgqs,bqkgd->bskd", dsc, qf))
    dk = torch.cat(dks, dim=1)[:, :Skv]
    dv = torch.cat(dvs, dim=1)[:, :Skv]
    dq = (dq * Dh ** -0.5).to(q.dtype)
    return dq, dk.to(k.dtype), dv.to(v.dtype)


class _Flash(torch.autograd.Function):
    """Blockwise attention whose backward recomputes each block (the
    reference's ``_flash`` custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len, causal, block_kv):
        o, lse = _blockwise_fwd(q, k, v, causal=causal, block_kv=block_kv,
                                kv_len=kv_len)
        ctx.save_for_backward(q, k, v, o, lse, kv_len)
        ctx.causal, ctx.block_kv = causal, block_kv
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, kv_len = ctx.saved_tensors
        dq, dk, dv = _bwd_pass(q, k, v, o, lse, do, causal=ctx.causal,
                               block_kv=ctx.block_kv, kv_len=kv_len)
        return dq, dk, dv, None, None, None


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, block_kv: int = 512,
                        q_offset: Optional[Union[int, torch.Tensor]] = None,
                        kv_len: Optional[torch.Tensor] = None,
                        q_offset_static: int = 0) -> torch.Tensor:
    """Flash attention (see ``_blockwise_fwd`` for the shapes). Without a
    query offset, an input that requires a gradient goes through the
    recompute-per-block backward; with one, autograd differentiates the
    forward's own ops, as the reference's has no rule of its own there."""
    if q_offset is not None or q_offset_static != 0:
        return _blockwise_fwd(q, k, v, causal=causal, block_kv=block_kv,
                              q_offset=q_offset, kv_len=kv_len,
                              q_offset_static=q_offset_static)[0]
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Flash.apply(q, k, v, kv_len, causal, block_kv)
    return _blockwise_fwd(q, k, v, causal=causal, block_kv=block_kv,
                          kv_len=kv_len)[0]


def block_causal_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, block_q: int = 512,
                           block_kv: int = 512) -> torch.Tensor:
    """Causal attention on the lower-triangle schedule: query block i
    attends kv[: (i+1) * block], about half the FLOPs of masked full
    blocks. Equal block sizes line the per-block causal offset up
    (Skv_i - Sq_i = i * blk)."""
    Sq = q.shape[1]
    assert q.shape[1] == k.shape[1], "self-attention only"
    blk = min(block_q, Sq)
    assert block_kv == block_q or Sq <= blk, \
        "equal q/kv blocks required for offset alignment"
    n = -(-Sq // blk)
    if n <= 1:
        return blockwise_attention(q, k, v, causal=True, block_kv=block_kv)
    assert Sq % blk == 0, (Sq, blk)
    return torch.cat([
        blockwise_attention(q[:, i * blk:(i + 1) * blk],
                            k[:, :(i + 1) * blk], v[:, :(i + 1) * blk],
                            causal=True, block_kv=blk)
        for i in range(n)], dim=1)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        q_offset: Optional[Union[int, torch.Tensor]] = None,
                        kv_len: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """The plain O(S^2)-memory masked softmax, the oracle of the tests.
    Shapes as ``_blockwise_fwd``; returns [B, Sq, n_kv, group, d_head] in
    q's dtype."""
    Sq, Skv = q.shape[1], k.shape[1]
    dev = q.device
    s = _gqa_scores(_scaled(q), k)
    start = Skv - Sq if q_offset is None else q_offset
    q_pos = start + torch.arange(Sq, device=dev)
    kv_pos = torch.arange(Skv, device=dev)
    if causal:
        s = s.masked_fill(~(kv_pos[None, :] <= q_pos[:, None]), NEG_INF)
    if kv_len is not None:
        lm = kv_pos[None, :] < kv_len[:, None]
        s = s.masked_fill(~lm[:, None, None, None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return _gqa_out(p, v).movedim(-2, 1).to(q.dtype)
