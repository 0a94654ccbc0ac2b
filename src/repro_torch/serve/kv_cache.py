"""KV-cache utilities: sizing, int8 KV quantization, slot management for
continuous batching (the reference's, on torch tensors)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig


def kv_bytes(cfg: ModelConfig, batch: int, max_len: int,
             bytes_per_el: int = 2) -> int:
    """Decode-cache footprint of a contiguous [batch, max_len] cache."""
    n_attn = sum(1 for k in cfg.layer_kinds()
                 if k in ("attn", "shared_attn", "moe"))
    return (2 * n_attn * batch * max_len * cfg.n_kv_heads * cfg.d_head
            * bytes_per_el)


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    amax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    # divide by tensors, not Python numbers: CUDA turns x / 127.0 into a
    # product with the reciprocal, which can differ from the CPU's quotient
    scale = torch.where(amax > 0, amax / amax.new_tensor(127.0),
                        amax.new_tensor(1.0))
    q = torch.clamp(torch.round(x / scale), -128, 127).to(torch.int8)
    return q, scale.float()


def quantize_kv(cache_k: torch.Tensor, cache_v: torch.Tensor):
    """int8 per-(token, head) KV quantization: ``amax / 127`` over the
    last axis, ``round(x / scale)`` (half to even) clipped to [-128, 127],
    f32 scales. Returns ((k_q, k_scale), (v_q, v_scale))."""
    return _quantize(cache_k), _quantize(cache_v)


def dequantize_kv(kq: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return (kq.float() * scale).to(dtype)


@dataclasses.dataclass
class SlotAllocator:
    """Fixed-slot continuous batching: requests claim a batch row; freed on
    completion."""

    n_slots: int

    def __post_init__(self):
        self.free: List[int] = list(range(self.n_slots))
        self.active: dict = {}

    def alloc(self, request_id) -> Optional[int]:
        if not self.free:
            return None
        slot = self.free.pop(0)
        self.active[request_id] = slot
        return slot

    def release(self, request_id) -> None:
        """Idempotent: releasing an unknown/already-released id is a no-op
        (finish and preemption paths may race on the same request)."""
        slot = self.active.pop(request_id, None)
        if slot is not None:
            self.free.append(slot)
