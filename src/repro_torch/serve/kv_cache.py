"""Slot management for continuous batching (copied from the reference)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional


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
