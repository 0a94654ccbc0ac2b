"""Rotary position embeddings (RoPE), neox half-split pairing."""

from __future__ import annotations

import torch


def rope_freqs(d_head: int, theta: float,
               device: torch.device) -> torch.Tensor:
    """Inverse frequencies f32[d_head//2]."""
    exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                        device=device) / d_head
    return 1.0 / (theta ** exps)


def rope_cos_sin(positions: torch.Tensor, d_head: int, theta: float):
    """positions i32[B, S] -> (cos, sin) f32[B, S, d_head//2]."""
    ang = positions.float()[..., None] * rope_freqs(d_head, theta,
                                                    positions.device)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: [B, S, H, d_head]; cos/sin: [B, S, d_head//2] (broadcast over H).
    Pairs (x[..., :half], x[..., half:]) — the HF 'neox' convention."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    c = cos[..., None, :].float()
    s = sin[..., None, :].float()
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s],
                     dim=-1).to(x.dtype)
