"""Threefry-2x32 and the Gumbel-max draw of ``jax.random.categorical``, on
torch tensors.

The reference draws every sampled token as ``jax.random.categorical(key,
logits)`` with a raw uint32[2] key from ``sampling.request_key``. Under
``jax_threefry_partitionable`` (on by default in jax 0.9) the random bits
of a draw over V categories are ``bits1 ^ bits2`` of ``threefry2x32(k1,
k2, hi, lo)`` over the 64-bit counter iota(V) split into its high and low
words; the uniform keeps the top 23 bits as the mantissa of a float in
[1, 2), minus 1, floored at the smallest normal f32; the Gumbel noise is
``-log(-log(u))``; the token is ``argmax(noise + logits)``.

torch's ``uint32`` lacks most operations, so the words are held in int64
and masked to 32 bits after every add and rotate: the bits equal jax's
exactly, on either device.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor):
    """The Threefry-2x32 hash of 20 rounds (jax's
    ``prng._threefry2x32_lowering``). Keys and counts are int64 tensors
    holding uint32 values that broadcast together; returns the two output
    words, int64 in [0, 2**32)."""
    ks = (k1 & _MASK, k2 & _MASK, (k1 ^ k2 ^ 0x1BD11BDA) & _MASK)
    x = [(x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _MASK
    return x[0], x[1]


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """32 random bits for each of ``n`` categories of every row, as
    ``jax.random.bits(key, (n,))`` draws them: keys int64[B, 2] (uint32
    words) -> int64[B, n] in [0, 2**32)."""
    lo = torch.arange(n, dtype=torch.int64, device=keys.device)
    hi = torch.zeros_like(lo)             # n < 2**32: the high words are 0
    b1, b2 = threefry2x32(keys[:, :1], keys[:, 1:], hi[None], lo[None])
    return b1 ^ b2


def uniform(keys: torch.Tensor, n: int) -> torch.Tensor:
    """f32[B, n] uniforms in [tiny, 1) from the bits (jax's ``_uniform``
    with minval tiny, maxval 1)."""
    bits = (random_bits(keys, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp(floats, min=_TINY)


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """f32[B, n] Gumbel noise, mode "low": ``-log(-log(u))``."""
    return -torch.log(-torch.log(uniform(keys, n)))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """One draw per row from softmax(logits): argmax of Gumbel noise plus
    logits f32[B, V] (entries at -inf are never drawn). Returns the int64
    token ids [B]."""
    return torch.argmax(gumbel(keys, logits.shape[-1]) + logits, dim=-1)
