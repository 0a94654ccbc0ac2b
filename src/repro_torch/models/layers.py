"""Shared primitive layers (functional, on tensors)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def dense_init(generator: torch.Generator, shape: Sequence[int],
               dtype: torch.dtype, device: torch.device,
               scale: Optional[float] = None) -> torch.Tensor:
    """Truncated-normal fan-in init: N(0, 1) cut at ±3, times
    ``fan_in ** -0.5`` — the reference's law, not its bits. The draw runs
    on the generator's device and the result moves to ``device``."""
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


def head_rms_norm(x: torch.Tensor, gamma: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """Per-head RMSNorm over d_head (qwen3's qk_norm), in fp32, cast back
    to the input dtype. x: [..., H, d_head]."""
    xf = x.float()
    scale = torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (xf * scale * gamma.float()).to(x.dtype)
