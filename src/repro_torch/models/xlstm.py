"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, parallelizable)
and sLSTM (scalar memory, sequential) with stabilized exponential gating.

mLSTM prefill uses a blockwise parallel form (flash-style online
rescaling with the gate-decay bias; the reference's ``lax.scan`` over
blocks is a Python loop here); decode is the O(1) matrix-memory
recurrence. sLSTM is a true nonlinear recurrence (block-diagonal R per
head), a per-token loop.

Forget gates use log-sigmoid; input gates are exponential with the
running stabilizer m (paper App. A). Like ``models.ssm``, the functions
return their new state and ``models.transformer`` copies it into the
stacked cache.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers
from repro_torch.models.ssm import _causal_conv, check_chunked_len

NEG_INF = -1e30
BLOCK = 256     # the reference's mLSTM block


def check_prompt_len(S: int) -> None:
    """Raise ValueError for a prompt the blockwise mLSTM refuses."""
    check_chunked_len(S, BLOCK)


# ---------------------------------------------------------------------------
# mLSTM cell


def mlstm_parallel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   i_pre: torch.Tensor, f_pre: torch.Tensor,
                   block: int = BLOCK, initial_state=None,
                   return_state: bool = False):
    """Blockwise-parallel mLSTM.

    q, k, v: [B, S, H, P]; i_pre/f_pre: f32[B, S, H] gate pre-activations.
    initial_state: optional (C [B,H,P,P], n [B,H,P], m [B,H]) from a
    prefix. Returns y [B, S, H, P] (and the final state if
    ``return_state``)."""
    B, S, H, P = q.shape
    logf = F.logsigmoid(f_pre.float())                         # [B,S,H]
    i_pre = i_pre.float()
    scale = P ** -0.5

    check_chunked_len(S, block)
    blk = min(block, S)
    nb = S // blk

    qb = q.reshape(B, nb, blk, H, P)
    kb = k.reshape(B, nb, blk, H, P)
    vb = v.reshape(B, nb, blk, H, P)
    # BLOCK-LOCAL inclusive cumsum of log-forget: the carried state already
    # folds in all decay up to the block start, so inter-block decay to
    # query t is F_local[t] (global offsets cancel for intra-block terms)
    Fb = torch.cumsum(logf.reshape(B, nb, blk, H), dim=2)
    ib = i_pre.reshape(B, nb, blk, H)

    dev = q.device
    if initial_state is not None:
        C_in, n_in, m_in = (t.float() for t in initial_state)
    else:
        C_in = torch.zeros((B, H, P, P), dtype=torch.float32, device=dev)
        n_in = torch.zeros((B, H, P), dtype=torch.float32, device=dev)
        m_in = torch.full((B, H), NEG_INF, dtype=torch.float32, device=dev)
    causal = torch.tril(torch.ones((blk, blk), dtype=torch.bool,
                                   device=dev))
    neg = torch.tensor(NEG_INF, dtype=torch.float32, device=dev)
    ys = []
    for c in range(nb):
        qf = qb[:, c].float() * scale
        kf = kb[:, c].float()
        vf = vb[:, c].float()
        Fc, ic = Fb[:, c], ib[:, c]                           # [B,blk,H]

        # intra-block decay bias: D[t,s] = F[t]-F[s]+i[s], s<=t
        Db = Fc[:, :, None, :] - Fc[:, None, :, :] + ic[:, None, :, :]
        Db = torch.where(causal[None, :, :, None], Db, neg)
        # the inter contribution enters with bias F[t] (+ the carried m_in)
        m_inter = Fc + m_in[:, None, :]                        # [B,blk,H]
        m_t = torch.maximum(Db.amax(dim=2), m_inter)           # [B,blk,H]

        s_qk = torch.einsum("bthp,bshp->btsh", qf, kf)
        Sm = s_qk * torch.exp(Db - m_t[:, :, None, :])
        num = torch.einsum("btsh,bshp->bthp", Sm, vf)
        den = Sm.sum(dim=2)                                    # [B,blk,H]

        # inter-block: C_in contributes exp(F[t]+m_in - m_t) * q C_in
        w_int = torch.exp(m_inter - m_t)                       # [B,blk,H]
        num = num + torch.einsum("bthp,bhpe->bthe", qf, C_in) \
            * w_int[..., None]
        den = den + torch.einsum("bthp,bhp->bth", qf, n_in) * w_int

        n_t = torch.maximum(den.abs(), torch.exp(-m_t))
        ys.append(num / n_t[..., None])

        # the state at the end of the block
        F_end = Fc[:, -1, :]                                   # [B,H]
        m_upd = Fc[:, -1:, :] - Fc + ic                        # [B,blk,H]
        m_new = torch.maximum(F_end + m_in, m_upd.amax(dim=1))
        w_st = torch.exp(m_upd - m_new[:, None, :])            # [B,blk,H]
        carry = torch.exp(F_end + m_in - m_new)
        C_in = carry[:, :, None, None] * C_in \
            + torch.einsum("bsh,bshp,bshe->bhpe", w_st, kf, vf)
        n_in = carry[:, :, None] * n_in \
            + torch.einsum("bsh,bshp->bhp", w_st, kf)
        m_in = m_new
    y = torch.stack(ys, dim=1).reshape(B, S, H, P).to(q.dtype)
    if return_state:
        return y, (C_in, n_in, m_in)
    return y


def mlstm_step(state, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               i_pre: torch.Tensor, f_pre: torch.Tensor):
    """One-token recurrence. q, k, v: [B, H, P]; gates f32[B, H].
    state: (C [B,H,P,P], n [B,H,P], m [B,H]). Returns (state, y)."""
    C, n, m = state
    P = q.shape[-1]
    logf = F.logsigmoid(f_pre.float())
    i_pre = i_pre.float()
    m_new = torch.maximum(logf + m, i_pre)
    fw = torch.exp(logf + m - m_new)
    iw = torch.exp(i_pre - m_new)
    kf = k.float()
    vf = v.float()
    C_new = fw[..., None, None] * C \
        + iw[..., None, None] * torch.einsum("bhp,bhe->bhpe", kf, vf)
    n_new = fw[..., None] * n + iw[..., None] * kf
    qf = q.float() * P ** -0.5
    num = torch.einsum("bhp,bhpe->bhe", qf, C_new)
    den = torch.maximum(torch.einsum("bhp,bhp->bh", qf, n_new).abs(),
                        torch.exp(-m_new))
    y = (num / den[..., None]).to(q.dtype)
    return (C_new, n_new, m_new), y


# ---------------------------------------------------------------------------
# sLSTM cell (sequential; block-diagonal recurrence per head)


def slstm_scan(x_z: torch.Tensor, x_i: torch.Tensor, x_f: torch.Tensor,
               x_o: torch.Tensor, R: dict, state0):
    """x_*: [B, S, H, P] input pre-activations; R: {z,i,f,o}: [H, P, P].
    state0: (c, n, h, m) each [B, H, P].
    Returns (y [B, S, H, P], final_state)."""
    c, n, h, m = state0
    ys = []
    for t in range(x_z.shape[1]):
        xz, xi, xf, xo = x_z[:, t], x_i[:, t], x_f[:, t], x_o[:, t]
        # jnp promotes a bf16 R against the f32 state to f32
        rz, ri, rf, ro = (torch.einsum("bhp,hpe->bhe", h, R[g].to(h.dtype))
                          for g in "zifo")
        z = torch.tanh((xz + rz).float())
        i_pre = (xi + ri).float()
        logf = F.logsigmoid((xf + rf).float())
        o = torch.sigmoid((xo + ro).float())
        # per-unit stabilizer (m is [B,H,P] for sLSTM)
        m_new = torch.maximum(logf + m, i_pre)
        fw = torch.exp(logf + m - m_new)
        iw = torch.exp(i_pre - m_new)
        c = fw * c + iw * z
        n = fw * n + iw
        h = (o * c / torch.clamp(n, min=1e-6)).to(h.dtype)
        m = m_new
        ys.append(h)
    return torch.stack(ys, dim=1), (c, n, h, m)


# ---------------------------------------------------------------------------
# Blocks


def init_mlstm_block(generator: torch.Generator, cfg: ModelConfig,
                     dtype: torch.dtype, device: torch.device) -> dict:
    """The reference's init law (not its bits); ``b_if`` stays f32."""
    d = cfg.d_model
    d_in = 2 * d
    H = cfg.n_heads
    ones = dict(dtype=dtype, device=device)
    conv_w = torch.randn((4, d_in), generator=generator,
                         device=generator.device) * 0.25
    return {
        "norm": torch.ones(d, **ones),
        "w_up": layers.dense_init(generator, (d, 2 * d_in), dtype, device),
        "conv_w": conv_w.to(device=device, dtype=dtype),
        "conv_b": torch.zeros(d_in, **ones),
        "wq": layers.dense_init(generator, (d_in, d_in), dtype, device),
        "wk": layers.dense_init(generator, (d_in, d_in), dtype, device),
        "wv": layers.dense_init(generator, (d_in, d_in), dtype, device),
        "w_if": layers.dense_init(generator, (d_in, 2 * H), dtype, device,
                                  scale=0.01),
        "b_if": torch.cat([torch.zeros(H), 3.0 * torch.ones(H)]).to(
            dtype=torch.float32, device=device),
        "out_norm": torch.ones(d_in, **ones),
        "w_down": layers.dense_init(generator, (d_in, d), dtype, device),
    }


def init_mlstm_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device: torch.device) -> dict:
    d_in = 2 * cfg.d_model
    H = cfg.n_heads
    P = d_in // H
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "C": torch.zeros((batch, H, P, P), **f32),
        "n": torch.zeros((batch, H, P), **f32),
        "m": torch.full((batch, H), NEG_INF, **f32),
        "conv": torch.zeros((batch, 3, d_in), dtype=dtype, device=device),
    }


def _mlstm_qkvif(p: dict, cfg: ModelConfig, xm: torch.Tensor,
                 conv_state: Optional[torch.Tensor] = None):
    """The shared projection path. xm: [B, S, d_in]."""
    B, S, d_in = xm.shape
    H = cfg.n_heads
    P = d_in // H
    xc, new_conv = _causal_conv(xm, p["conv_w"], p["conv_b"], conv_state)
    q = (xc @ p["wq"]).reshape(B, S, H, P)
    k = (xc @ p["wk"]).reshape(B, S, H, P)
    v = (xm @ p["wv"]).reshape(B, S, H, P)
    gif = (xc @ p["w_if"]).float() + p["b_if"]
    i_pre, f_pre = gif[..., :H], gif[..., H:]
    return q, k, v, i_pre, f_pre, new_conv


def mlstm_block_forward(p: dict, cfg: ModelConfig, x: torch.Tensor,
                        cache: Optional[dict] = None):
    """x: [B, S, d] -> (x + out, new_cache or None)."""
    h = layers.rms_norm(x, p["norm"], cfg.norm_eps)
    up = h @ p["w_up"]
    d_in = 2 * cfg.d_model
    xm, z = up[..., :d_in], up[..., d_in:]
    conv_state = cache["conv"] if cache is not None else None
    q, k, v, i_pre, f_pre, new_conv = _mlstm_qkvif(p, cfg, xm, conv_state)
    init_state = None
    if cache is not None:
        init_state = (cache["C"], cache["n"], cache["m"])
    res = mlstm_parallel(q, k, v, i_pre, f_pre, initial_state=init_state,
                         return_state=cache is not None)
    if cache is not None:
        y, (C, n, m) = res
        new_cache = {"C": C, "n": n, "m": m,
                     "conv": new_conv.to(cache["conv"].dtype)}
    else:
        y, new_cache = res, None
    B, S = x.shape[:2]
    y = y.reshape(B, S, d_in)
    y = layers.rms_norm(y, p["out_norm"], cfg.norm_eps)
    out = (y * F.silu(z)) @ p["w_down"]
    return x + out, new_cache


def mlstm_block_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
                       cache: dict):
    """x: [B, 1, d] -> (x + out, new_cache)."""
    h = layers.rms_norm(x, p["norm"], cfg.norm_eps)
    up = h @ p["w_up"]
    d_in = 2 * cfg.d_model
    xm, z = up[..., :d_in], up[..., d_in:]
    q, k, v, i_pre, f_pre, new_conv = _mlstm_qkvif(p, cfg, xm,
                                                   cache["conv"])
    state = (cache["C"], cache["n"], cache["m"])
    (C, n, m), y = mlstm_step(state, q[:, 0], k[:, 0], v[:, 0],
                              i_pre[:, 0], f_pre[:, 0])
    B = x.shape[0]
    y = y.reshape(B, 1, d_in)
    y = layers.rms_norm(y, p["out_norm"], cfg.norm_eps)
    out = (y * F.silu(z)) @ p["w_down"]
    return x + out, {"C": C, "n": n, "m": m,
                     "conv": new_conv.to(cache["conv"].dtype)}


def init_slstm_block(generator: torch.Generator, cfg: ModelConfig,
                     dtype: torch.dtype, device: torch.device) -> dict:
    """The reference's init law (not its bits); ``b_zifo`` stays f32."""
    d = cfg.d_model
    H = cfg.n_heads
    P = d // H
    f_up = max(1, int(round(d * 4 / 3 / 64)) * 64)
    R = {g: (torch.randn((H, P, P), generator=generator,
                         device=generator.device) * P ** -0.5).to(
                             device=device, dtype=dtype)
         for g in "zifo"}
    return {
        "norm": torch.ones(d, dtype=dtype, device=device),
        "w_zifo": layers.dense_init(generator, (d, 4 * d), dtype, device),
        "b_zifo": torch.cat([torch.zeros(2 * d), 3.0 * torch.ones(d),
                             torch.zeros(d)]).to(dtype=torch.float32,
                                                 device=device),
        "R": R,
        "out_norm": torch.ones(d, dtype=dtype, device=device),
        "w_up": layers.dense_init(generator, (d, 2 * f_up), dtype, device),
        "w_down": layers.dense_init(generator, (f_up, d), dtype, device),
    }


def init_slstm_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device: torch.device) -> dict:
    """c, n, h and m, each f32[batch, H, P] of zeros (four tensors: the
    cache is written in place)."""
    H = cfg.n_heads
    P = cfg.d_model // H
    return {g: torch.zeros((batch, H, P), dtype=torch.float32,
                           device=device) for g in "cnhm"}


def _slstm_core(p: dict, cfg: ModelConfig, x: torch.Tensor, state):
    B, S, d = x.shape
    H = cfg.n_heads
    P = d // H
    pre = (x @ p["w_zifo"]).float() + p["b_zifo"]
    xz, xi, xf, xo = [pre[..., i * d:(i + 1) * d].reshape(B, S, H, P)
                      for i in range(4)]
    y, final = slstm_scan(xz, xi, xf, xo, p["R"], state)
    return y.reshape(B, S, d).to(x.dtype), final


def slstm_block_forward(p: dict, cfg: ModelConfig, x: torch.Tensor,
                        cache: Optional[dict] = None):
    """x: [B, S, d] -> (x + out, new_cache or None)."""
    h = layers.rms_norm(x, p["norm"], cfg.norm_eps)
    B = x.shape[0]
    src = cache if cache is not None \
        else init_slstm_cache(cfg, B, x.dtype, x.device)
    y, final = _slstm_core(p, cfg, h, tuple(src[g] for g in "cnhm"))
    y = layers.rms_norm(y, p["out_norm"], cfg.norm_eps)
    f2 = p["w_up"].shape[1] // 2
    up = y @ p["w_up"]
    # jax.nn.gelu is the tanh approximation
    y = (F.gelu(up[..., :f2], approximate="tanh") * up[..., f2:]) \
        @ p["w_down"]
    new_cache = dict(zip("cnhm", final)) if cache is not None else None
    return x + y, new_cache


def slstm_block_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
                       cache: dict):
    return slstm_block_forward(p, cfg, x, cache)
