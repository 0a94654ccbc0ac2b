"""Mamba2 / SSD blocks (arXiv:2405.21060), chunked-parallel and recurrent.

Prefill uses the chunked SSD algorithm: a quadratic, attention-like
product within each chunk and a recurrent state carried from chunk to
chunk (the reference's ``lax.scan`` over chunks is a Python loop here,
with the state in f32). Decode is the O(1) recurrence. State: h [B, H, P,
N] with P = head dim, N = ssm_state.

The functions return their new state instead of writing it, as the
reference's do; ``models.transformer`` copies it into the stacked cache.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers


def ssm_dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    H = cfg.ssm_heads or max(1, d_in // 64)
    P = d_in // H
    N = cfg.ssm_state
    return d_in, H, P, N


def init_mamba2(generator: torch.Generator, cfg: ModelConfig,
                dtype: torch.dtype, device: torch.device) -> dict:
    """The reference's init law (not its bits). ``A_log``, ``dt_bias`` and
    ``D`` stay f32 whatever ``dtype`` is, as in the reference."""
    d = cfg.d_model
    d_in, H, P, N = ssm_dims(cfg)
    conv_ch = d_in + 2 * N  # conv over (x, B, C)
    gdev = generator.device
    f32 = dict(dtype=torch.float32, device=device)
    w_in = layers.dense_init(generator, (d, 2 * d_in + 2 * N + H), dtype,
                             device)
    conv_w = torch.randn((cfg.ssm_conv, conv_ch), generator=generator,
                         device=gdev) * (1.0 / cfg.ssm_conv)
    u = torch.rand(H, generator=generator, device=gdev)
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt = torch.exp(lo + (hi - lo) * u)
    return {
        # in_proj -> [z(d_in), x(d_in), B(N), C(N), dt(H)]
        "w_in": w_in,
        "conv_w": conv_w.to(device=device, dtype=dtype),
        "conv_b": torch.zeros(conv_ch, dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H)).to(**f32),
        "dt_bias": torch.log(torch.expm1(dt)).to(**f32),
        "D": torch.ones(H, **f32),
        "norm": torch.ones(d_in, dtype=dtype, device=device),
        "w_out": layers.dense_init(generator, (d_in, d), dtype, device),
    }


def init_mamba2_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                      device: torch.device) -> dict:
    d_in, H, P, N = ssm_dims(cfg)
    conv_ch = d_in + 2 * N
    return {
        "ssm": torch.zeros((batch, H, P, N), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_ch), dtype=dtype,
                            device=device),
    }


def _causal_conv(xbc: torch.Tensor, conv_w: torch.Tensor,
                 conv_b: torch.Tensor,
                 conv_state: Optional[torch.Tensor] = None):
    """Depthwise causal conv over time. xbc: [B, S, C], conv_w: [W, C].
    Returns (silu(y) [B, S, C], new_state [B, W-1, C])."""
    W = conv_w.shape[0]
    if conv_state is None:
        pad = torch.zeros((xbc.shape[0], W - 1, xbc.shape[2]),
                          dtype=xbc.dtype, device=xbc.device)
    else:
        pad = conv_state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)                 # [B, S+W-1, C]
    S = xbc.shape[1]
    y = sum(xp[:, i:i + S] * conv_w[i] for i in range(W))
    y = y + conv_b
    new_state = xp[:, -(W - 1):] if W > 1 else pad
    return F.silu(y), new_state


def _split_proj(z_x_b_c_dt: torch.Tensor, cfg: ModelConfig):
    d_in, H, P, N = ssm_dims(cfg)
    z = z_x_b_c_dt[..., :d_in]
    x = z_x_b_c_dt[..., d_in:2 * d_in]
    Bc = z_x_b_c_dt[..., 2 * d_in:2 * d_in + N]
    Cc = z_x_b_c_dt[..., 2 * d_in + N:2 * d_in + 2 * N]
    dt = z_x_b_c_dt[..., 2 * d_in + 2 * N:]
    return z, x, Bc, Cc, dt


CHUNK = 128     # the reference's SSD chunk


def check_chunked_len(S: int, chunk: int) -> None:
    """The reference's limit on a parallel pass over S positions in chunks
    of ``chunk``: min(chunk, S) must divide S (its ``assert S % Q == 0``).
    A prompt longer than the chunk must be a multiple of it."""
    Q = min(chunk, S)
    if Q < 1 or S % Q:
        raise ValueError(f"a sequence of {S} positions needs a length that "
                         f"is at most {chunk} or a multiple of {chunk} (the "
                         f"reference's chunked scan does not pad)")


def check_prompt_len(S: int) -> None:
    """Raise ValueError for a prompt the chunked Mamba2 scan refuses."""
    check_chunked_len(S, CHUNK)


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, h0: torch.Tensor,
                chunk: int = CHUNK):
    """Chunked SSD scan.

    xh: [B, S, H, P], dt: f32[B, S, H], A: f32[H] (negative),
    Bm/Cm: [B, S, N], h0: f32[B, H, P, N].
    Returns (y f32[B, S, H, P], h_final f32[B, H, P, N])."""
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    check_chunked_len(S, chunk)
    Q = min(chunk, S)
    n_chunks = S // Q

    xf = xh.float().reshape(Bsz, n_chunks, Q, H, P)
    dtf = dt.reshape(Bsz, n_chunks, Q, H)
    Bf = Bm.float().reshape(Bsz, n_chunks, Q, N)
    Cf = Cm.float().reshape(Bsz, n_chunks, Q, N)

    la = dtf * A  # log decay per step [B, nc, Q, H]
    lacum = torch.cumsum(la, dim=2)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=xh.device))
    h = h0.float()
    ys = []
    for c in range(n_chunks):
        xc, dtc, bc, cc, lac = (xf[:, c], dtf[:, c], Bf[:, c], Cf[:, c],
                                lacum[:, c])
        # intra-chunk: scores[t,s] = (C_t . B_s) * exp(lac_t - lac_s) * dt_s
        cb = torch.einsum("btn,bsn->bts", cc, bc)                # [B,Q,Q]
        dec = torch.exp(lac[:, :, None, :] - lac[:, None, :, :])  # [B,t,s,H]
        w = torch.where(causal[None, :, :, None],
                        cb[..., None] * dec * dtc[:, None, :, :],
                        torch.zeros((), device=xh.device))
        y_intra = torch.einsum("btsh,bshp->bthp", w, xc)
        # inter-chunk: y_inter[t] = (C_t . h_in) * exp(lac_t)
        y_inter = torch.einsum("btn,bhpn->bthp", cc, h) \
            * torch.exp(lac)[..., None]
        # h' = exp(lac_end)*h + sum_s exp(lac_end-lac_s)*dt_s*x_s B_s^T
        lend = lac[:, -1:, :]                                    # [B,1,H]
        wst = torch.exp(lend - lac) * dtc                        # [B,Q,H]
        dh = torch.einsum("bsh,bshp,bsn->bhpn", wst, xc, bc)
        h = torch.exp(lend[:, 0])[:, :, None, None] * h + dh
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(Bsz, S, H, P)
    return y, h


def mamba2_forward(p: dict, cfg: ModelConfig, x: torch.Tensor,
                   cache: Optional[dict] = None, chunk: int = CHUNK):
    """Full-sequence forward (prefill). x: [B, S, d].
    Returns (out [B, S, d], new_cache or None)."""
    B, S, d = x.shape
    d_in, H, P, N = ssm_dims(cfg)
    zxbcdt = x @ p["w_in"]
    z, xs, Bc, Cc, dt = _split_proj(zxbcdt, cfg)
    xbc = torch.cat([xs, Bc, Cc], dim=-1)
    conv_state = cache["conv"] if cache is not None else None
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    xs, Bc, Cc = (xbc[..., :d_in], xbc[..., d_in:d_in + N],
                  xbc[..., d_in + N:])

    dtf = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xs.reshape(B, S, H, P)
    h0 = (cache["ssm"] if cache is not None
          else torch.zeros((B, H, P, N), dtype=torch.float32,
                           device=x.device))
    y, h_final = ssd_chunked(xh, dtf, A, Bc, Cc, h0, chunk=chunk)
    y = y + xh.float() * p["D"][None, None, :, None]
    y = y.reshape(B, S, d_in).to(x.dtype)
    y = y * F.silu(z)
    y = layers.rms_norm(y, p["norm"], cfg.norm_eps)
    out = y @ p["w_out"]
    new_cache = None
    if cache is not None:
        new_cache = {"ssm": h_final,
                     "conv": new_conv.to(cache["conv"].dtype)}
    return out, new_cache


def mamba2_decode(p: dict, cfg: ModelConfig, x: torch.Tensor,
                  cache: dict):
    """One-token recurrence. x: [B, 1, d]. Returns (out [B, 1, d], the new
    cache)."""
    B = x.shape[0]
    d_in, H, P, N = ssm_dims(cfg)
    zxbcdt = x @ p["w_in"]
    z, xs, Bc, Cc, dt = _split_proj(zxbcdt, cfg)
    xbc = torch.cat([xs, Bc, Cc], dim=-1)                 # [B, 1, C]
    # conv over (state || current)
    window = torch.cat([cache["conv"].to(xbc.dtype), xbc], dim=1)
    y = torch.einsum("bwc,wc->bc", window, p["conv_w"]) + p["conv_b"]
    xbc1 = F.silu(y)                                      # [B, C]
    new_conv = window[:, 1:]
    xs1, Bc1, Cc1 = (xbc1[..., :d_in], xbc1[..., d_in:d_in + N],
                     xbc1[..., d_in + N:])
    dtf = F.softplus(dt[:, 0].float() + p["dt_bias"])    # [B, H]
    A = -torch.exp(p["A_log"])
    xh = xs1.reshape(B, H, P).float()
    decay = torch.exp(dtf * A)                            # [B, H]
    h = cache["ssm"] * decay[:, :, None, None] \
        + torch.einsum("bh,bhp,bn->bhpn", dtf, xh, Bc1.float())
    yh = torch.einsum("bn,bhpn->bhp", Cc1.float(), h)
    yh = yh + xh * p["D"][None, :, None]
    yv = yh.reshape(B, 1, d_in).to(x.dtype)
    yv = yv * F.silu(z)
    yv = layers.rms_norm(yv, p["norm"], cfg.norm_eps)
    out = yv @ p["w_out"]
    return out, {"ssm": h, "conv": new_conv.to(cache["conv"].dtype)}


def mamba2_reference(p: dict, cfg: ModelConfig,
                     x: torch.Tensor) -> torch.Tensor:
    """Step-by-step recurrent oracle (tests): the same math, no chunks."""
    B, S, d = x.shape
    cache = init_mamba2_cache(cfg, B, x.dtype, x.device)
    outs = []
    for t in range(S):
        o, cache = mamba2_decode(p, cfg, x[:, t:t + 1], cache)
        outs.append(o)
    return torch.cat(outs, dim=1)
