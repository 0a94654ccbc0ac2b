"""Rotary position embeddings (RoPE) and qwen2-vl's M-RoPE, neox
half-split pairing."""

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


def mrope_cos_sin(positions: torch.Tensor, d_head: int, theta: float,
                  sections=(16, 24, 24)):
    """Qwen2-VL M-RoPE: positions i32[3, B, S] (temporal, height, width);
    the d_head//2 frequency slots are split into three sections, each
    rotated by its own position channel (arXiv:2409.12191). With three
    equal channels every slot reads the same position, and the product is
    ``rope_cos_sin``'s, bit for bit."""
    half = d_head // 2
    if positions.shape[0] != 3 or sum(sections) != half:
        raise ValueError(f"M-RoPE needs positions [3, B, S] and sections "
                         f"summing to {half}; got {tuple(positions.shape)} "
                         f"and {tuple(sections)}")
    dev = positions.device
    freqs = rope_freqs(d_head, theta, dev)
    # the position channel of each frequency slot, 0, 1 or 2 (the
    # reference's jnp.repeat of the sections), made on the device: no
    # host copy, so a CUDA graph can capture it
    slot = torch.arange(half, device=dev)
    sec = (slot >= sections[0]).long() \
        + (slot >= sections[0] + sections[1]).long()
    ang = positions.float()[sec].movedim(0, -1) * freqs     # [B, S, half]
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
