"""Block-table paged KV cache management (host side, numpy).

The port's copy of the reference's ``PagedKVCache``, trimmed to what the
synchronous paged engine uses: a free-list block allocator, per-slot
block lists and the i32[B, MB] tables the device step reads through.
Block index ``n_blocks`` is the sentinel the device path understands:
writes through it drop, reads through it see nothing. Prefix sharing,
copy-on-write, truncation and defrag come with later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np


@dataclasses.dataclass
class PagedKVCache:
    """Free-list block allocator + per-slot block tables."""

    n_blocks: int
    block_size: int
    max_batch: int
    max_blocks_per_seq: int

    def __post_init__(self):
        self.free: List[int] = list(range(self.n_blocks))
        self.owned: Dict[int, List[int]] = {}      # slot -> physical blocks
        self._tables = np.full((self.max_batch, self.max_blocks_per_seq),
                               self.n_blocks, np.int32)

    @property
    def n_free(self) -> int:
        return len(self.free)

    def blocks_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    def allocate(self, slot: int, upto_len: int) -> bool:
        """Grow ``slot`` to cover logical positions [0, upto_len).
        All-or-nothing; returns False (state unchanged) when the pool or
        the slot's table row can't cover it."""
        need = self.blocks_for(upto_len)
        if need > self.max_blocks_per_seq:
            return False
        blocks = self.owned.setdefault(slot, [])
        grow = need - len(blocks)
        if grow <= 0:
            return True
        if grow > self.n_free:
            return False
        for _ in range(grow):
            b = self.free.pop(0)
            self._tables[slot, len(blocks)] = b
            blocks.append(b)
        return True

    def free_slot(self, slot: int) -> int:
        """Release every block held by ``slot`` (idempotent). Returns the
        number of blocks released."""
        blocks = self.owned.pop(slot, [])
        self.free.extend(blocks)
        self._tables[slot, :] = self.n_blocks
        return len(blocks)

    def tables(self) -> np.ndarray:
        return self._tables
