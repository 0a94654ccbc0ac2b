"""Blockwise int8 codec for optimizer moments and cross-pod gradient
compression (bitsandbytes-style: per-256-element absmax scales).

The port of ``repro.dist.compression``. Layout: a tensor of ``size``
elements flattens to ``(nb, BLOCK)`` int8 with an f32 scale per block,
whatever the source tensor's shape. Rounding is half to even
(``torch.round``, as ``jnp.round``), and every division is by a tensor:
a CUDA division by a Python number becomes a product with its
reciprocal, which can move a quotient by an ulp and a code by one.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.tree import leaves, tree_map, unflatten

BLOCK = 256


def encode_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: any-shape float -> (q i8[nb, BLOCK], scale f32[nb, 1])."""
    flat = x.float().reshape(-1)
    n = flat.numel()
    nb = -(-n // BLOCK)
    pad = nb * BLOCK - n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(nb, BLOCK)
    amax = blocks.abs().amax(dim=1, keepdim=True)
    scale = torch.where(amax > 0, amax / amax.new_tensor(127.0), 1.0)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def decode_int8(q: torch.Tensor, scale: torch.Tensor, shape,
                size: int) -> torch.Tensor:
    """Inverse of encode_int8: back to f32[shape] (the first ``size``
    elements)."""
    flat = (q.float() * scale).reshape(-1)
    return flat[:size].reshape(shape)


def compress_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """Quantize-dequantize through the wire format (error injection)."""
    q, s = encode_int8(x)
    return decode_int8(q, s, x.shape, x.numel()).to(x.dtype)


def compression_ratio(x: torch.Tensor) -> float:
    """Wire bytes / fp32 bytes for one tensor (int8 payload + f32
    scales)."""
    nb = -(-x.numel() // BLOCK)
    return (nb * BLOCK + nb * 4) / (x.numel() * 4)


# --- error-feedback compression (cross-pod int8_ef gradients) --------------


def init_residuals(tree: Any) -> Any:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), tree)


def ef_compress_tree(tree: Any, residuals: Any) -> Tuple[Any, Any]:
    """int8-compress a gradient tree with error feedback: the quantization
    error is carried into the next step instead of being dropped, so tiny
    gradients survive on average. Returns (compressed_tree,
    new_residuals)."""

    def one(g, r):
        y = g.float() + r
        c = compress_roundtrip(y)
        return c.to(g.dtype), y - c

    out = [one(g, r) for g, r in zip(leaves(tree), leaves(residuals))]
    return (unflatten(tree, [c for c, _ in out]),
            unflatten(tree, [r for _, r in out]))
