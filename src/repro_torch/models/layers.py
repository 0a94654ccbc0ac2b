"""Shared primitive layers (functional, on tensors)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def dense_init(generator: torch.Generator, shape: Sequence[int],
               dtype: torch.dtype, device: torch.device,
               scale: Optional[float] = None) -> torch.Tensor:
    """Truncated-normal fan-in init: N(0, 1) cut at ±3, times
    ``fan_in ** -0.5`` — the reference's law, not its bits. The draw runs
    on the generator's device and the result moves to ``device``. On the
    meta device (a tree of shapes: the dry run, a layout to convert
    into) nothing is drawn or allocated."""
    if torch.device(device).type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else fan_in ** -0.5
    w = torch.empty(tuple(shape), dtype=torch.float32,
                    device=generator.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=generator)
    return (w * std).to(device=device, dtype=dtype)


def embed_init(generator: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return dense_init(generator, (vocab, d), dtype, device, scale=d ** -0.5)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in fp32, cast back to the input dtype."""
    xf = x.float()
    scale = torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (xf * scale * gamma.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last dim in fp32, cast back to the input dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).pow(2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(x.dtype)


def head_rms_norm(x: torch.Tensor, gamma: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """Per-head RMSNorm over d_head (qwen3's qk_norm), in fp32, cast back
    to the input dtype. x: [..., H, d_head]."""
    xf = x.float()
    scale = torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (xf * scale * gamma.float()).to(x.dtype)


def sinusoidal_positions(positions: torch.Tensor, d: int,
                         max_scale: float = 10000.0) -> torch.Tensor:
    """The classic sin/cos table (musicgen's backbone): f32[..., d] for
    positions i32[...]. ``log(max_scale)`` and the frequencies are
    computed in f32, as the reference computes them: a float64 log moves
    a frequency by an ulp, which at positions in the thousands moves the
    angle by ~1e-4 rad. The division is by a tensor (a CUDA division by
    a Python number becomes a product with its reciprocal)."""
    half = d // 2
    dev = positions.device
    f32 = dict(dtype=torch.float32, device=dev)
    # filled on the device (no host copy: a CUDA graph may capture this)
    log_scale = torch.log(torch.full((), max_scale, **f32))
    freqs = torch.exp(-log_scale * torch.arange(half, **f32)
                      / torch.full((), float(half), **f32))
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Mean next-token CE in fp32. labels: i32[...], logits: [..., V]; a
    ``mask`` weighs each position and the sum is divided by max(sum of the
    mask, 1)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is not None:
        m = mask.float()
        return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
    return nll.mean()
