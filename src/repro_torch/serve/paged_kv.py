"""Block-table paged KV cache management (host side, numpy).

The port's copy of the reference's ``PagedKVCache``: a free-list block
allocator with per-slot block tables and REFCOUNTED blocks. Several slots
may map the same physical block (prefix sharing, serve.prefix_cache), and
the radix index may hold finished requests' blocks for reuse; a block
returns to the free list only when no slot references it AND the index
does not hold it. Index-held blocks that no slot references sit on an LRU
reclaim list that admission counts as allocatable, so caching never
shrinks the admissible batch. A write into a block referenced elsewhere
goes through copy-on-write (``cow_for_write``), so sharing is invisible to
correctness. ``defrag`` compacts the live blocks; the byte gauges feed
``metrics.summary()["kv_pool"]``.

Block index ``n_blocks`` is the sentinel the device path understands:
writes through it drop, reads through it see nothing. ``truncate`` is
the speculative rollback; ``export_blocks`` and ``import_blocks`` carry
the disagg handoff between two pools.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig


def kv_bytes_per_token(cfg: ModelConfig, int8_kv: bool = False) -> float:
    """Off-chip KV bytes one token adds across all attention layers.
    int8 KV (kv_cache.quantize_kv) stores 1 byte/element plus one f32
    scale per (token, head) for each of K and V."""
    n_attn = sum(1 for k in cfg.layer_kinds()
                 if k in ("attn", "shared_attn", "moe"))
    per_el = 1 if int8_kv else 2
    el = 2 * n_attn * cfg.n_kv_heads * cfg.d_head * per_el
    scales = 2 * n_attn * cfg.n_kv_heads * 4 if int8_kv else 0
    return float(el + scales)


@dataclasses.dataclass
class PagedKVCache:
    """Free-list block allocator + per-slot block tables + refcounts.

    Slots are batch rows of the jit'd decode step; each active slot owns an
    ordered list of physical blocks covering its logical positions
    [0, len). ``tables()`` materializes the i32[B, MB] array the device
    path reads through (sentinel-padded). ``ref[b]`` counts how many slots
    currently map block ``b``; ``index`` (optional, duck-typed — see
    serve.prefix_cache.RadixPrefixCache) may additionally hold blocks for
    prefix reuse and is asked to reclaim its LRU blocks when the free
    list runs dry.
    """

    cfg: ModelConfig
    n_blocks: int
    block_size: int
    max_batch: int
    max_blocks_per_seq: int
    int8_kv: bool = False
    # KV-head shards of the device pool ('model' mesh axis). Bookkeeping
    # here is per-BLOCK and shard-agnostic — this factor only scales the
    # byte gauges to what one device actually holds (stats()).
    model_shards: int = 1

    def __post_init__(self):
        self.free: List[int] = list(range(self.n_blocks))
        self.owned: Dict[int, List[int]] = {}      # slot -> physical blocks
        self.ref: Dict[int, int] = {}              # block -> slot refcount
        self.index = None                          # prefix index (reclaimer)
        self._tables = np.full((self.max_batch, self.max_blocks_per_seq),
                               self.n_blocks, np.int32)
        self.alloc_count = 0
        self.free_count = 0
        self.share_count = 0                       # blocks mapped via share()
        self.cow_count = 0                         # copy-on-write splits
        self.hwm_blocks = 0                        # high-water mark (in use)
        self.pinned: Set[int] = set()              # slots mid-step

    # --- capacity ---------------------------------------------------------
    @property
    def n_free(self) -> int:
        """Allocatable blocks: the free list PLUS index-held blocks no slot
        references (the LRU reclaim list) — admission control must see
        cached blocks as capacity, or caching would shrink the batch."""
        return len(self.free) + self.n_reclaimable

    @property
    def n_reclaimable(self) -> int:
        return self.index.n_reclaimable() if self.index is not None else 0

    @property
    def n_used(self) -> int:
        return self.n_blocks - len(self.free)

    def blocks_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    def can_allocate(self, slot: int, upto_len: int) -> bool:
        have = len(self.owned.get(slot, ()))
        return self.blocks_for(upto_len) - have <= self.n_free

    def _take_block(self) -> int:
        """Pop an allocatable block, evicting from the prefix index's LRU
        reclaim list when the free list is dry. Caller must have checked
        ``n_free`` first (all-or-nothing contract)."""
        if not self.free:
            freed = self.index.reclaim(1)
            if not freed:
                raise RuntimeError("n_free promised capacity the prefix "
                                   "index cannot reclaim")
            self.free.extend(freed)
        return self.free.pop(0)

    def _release_block(self, b: int) -> None:
        """Drop one slot reference; a block nobody references returns to
        the free list unless the prefix index still holds it (then it
        becomes reclaimable — freed lazily, in LRU order, on demand)."""
        r = self.ref.get(b, 0) - 1
        if r > 0:
            self.ref[b] = r
            return
        self.ref.pop(b, None)
        if self.index is not None and self.index.holds(b):
            self.index.on_ref_changed(b)   # now reclaimable
            return
        self.free.append(b)

    # --- alloc / free -----------------------------------------------------
    def allocate(self, slot: int, upto_len: int) -> bool:
        """Grow ``slot`` to cover logical positions [0, upto_len).
        All-or-nothing; returns False (state unchanged) when the pool or
        the slot's table row can't cover it. New blocks start at ref 1."""
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
            b = self._take_block()
            self._tables[slot, len(blocks)] = b
            blocks.append(b)
            self.ref[b] = 1
            self.alloc_count += 1
        self.hwm_blocks = max(self.hwm_blocks, self.n_used)
        return True

    def share(self, slot: int, blocks: List[int]) -> None:
        """Map already-populated physical blocks (a matched prefix) as the
        FIRST blocks of ``slot``'s table (refcount++ each). Must run at
        admission, before the slot allocates anything of its own."""
        own = self.owned.setdefault(slot, [])
        if own:
            raise RuntimeError(f"share() must precede allocate() for slot "
                               f"{slot}")
        for b in blocks:
            self._tables[slot, len(own)] = b
            own.append(b)
            r = self.ref.get(b, 0)
            self.ref[b] = r + 1
            if r == 0 and self.index is not None and self.index.holds(b):
                self.index.on_ref_changed(b)   # revived from reclaimable
            self.share_count += 1
        self.hwm_blocks = max(self.hwm_blocks, self.n_used)

    def free_slot(self, slot: int) -> int:
        """Release every block reference held by ``slot`` (idempotent).
        Returns the number of references dropped (not necessarily blocks
        freed — shared/cached blocks survive their siblings)."""
        blocks = self.owned.pop(slot, [])
        for b in blocks:
            self._release_block(b)
        self._tables[slot, :] = self.n_blocks
        self.free_count += len(blocks)
        self.pinned.discard(slot)
        return len(blocks)

    def truncate(self, slot: int, new_len: int) -> int:
        """Speculative rollback: shrink ``slot`` to cover only positions
        [0, new_len), releasing whole tail blocks. The partial tail block
        (the one holding position new_len-1) is kept: its stale positions
        >= new_len are masked by ``lens`` on the read path and overwritten
        by the next write. A second call with the same length frees
        nothing. Returns the references dropped (shared blocks survive
        their siblings, as in ``free_slot``)."""
        blocks = self.owned.get(slot)
        if not blocks:
            return 0
        keep = self.blocks_for(max(new_len, 0))
        freed = blocks[keep:]
        if not freed:
            return 0
        del blocks[keep:]
        for b in freed:
            self._release_block(b)
        self._tables[slot, keep:] = self.n_blocks
        self.free_count += len(freed)
        return len(freed)

    def tables(self) -> np.ndarray:
        return self._tables

    # --- copy-on-write ----------------------------------------------------
    def block_shared(self, slot: int, block_idx: int) -> bool:
        """True if table position ``block_idx`` of ``slot`` maps a block
        also referenced elsewhere (another slot, or the prefix index) —
        writing through it would corrupt the other readers."""
        b = self.owned[slot][block_idx]
        if self.ref.get(b, 0) > 1:
            return True
        return self.index is not None and self.index.holds(b)

    def cow_block(self, slot: int, block_idx: int) -> Optional[Tuple[int, int]]:
        """Give ``slot`` a private copy of a shared block before a write.
        Returns (src, dst) for the engine to mirror on the device pools,
        or None when the block is already private. The source keeps its
        other references (and its prefix-index entry) untouched."""
        if not self.block_shared(slot, block_idx):
            return None
        if self.n_free < 1:
            raise RuntimeError(
                "copy-on-write needs a free block: pool exhausted "
                f"({self.n_blocks} blocks, 0 allocatable)")
        blocks = self.owned[slot]
        src = blocks[block_idx]
        dst = self._take_block()
        blocks[block_idx] = dst
        self._tables[slot, block_idx] = dst
        self.ref[dst] = 1
        self._release_block(src)
        self.cow_count += 1
        self.alloc_count += 1
        self.hwm_blocks = max(self.hwm_blocks, self.n_used)
        return src, dst

    def cow_for_write(self, slot: int, start: int, n_tokens: int
                      ) -> List[Tuple[int, int]]:
        """Copy-on-write every shared block the write span
        [start, start+n_tokens) touches. Returns the (src, dst) device
        copies to apply (ModelRunner.copy_blocks) BEFORE the step runs."""
        if n_tokens <= 0:
            return []
        blocks = self.owned.get(slot, [])
        lo = start // self.block_size
        hi = min((start + n_tokens - 1) // self.block_size + 1, len(blocks))
        pairs = []
        for idx in range(lo, hi):
            pair = self.cow_block(slot, idx)
            if pair is not None:
                pairs.append(pair)
        return pairs

    # --- handoff (disaggregated prefill/decode: serve.disagg) -------------
    def export_blocks(self, slot: int) -> List[int]:
        """Snapshot ``slot``'s physical block ids for a cross-pool handoff.
        A pure read: refcounts, tables and the free list are untouched;
        pair it with ``pin(slot)`` so defrag cannot move the blocks before
        the importer has copied them."""
        return list(self.owned.get(slot, ()))

    def import_blocks(self, slot: int, n_tokens: int) -> Optional[List[int]]:
        """Receive a handoff: allocate fresh private (ref=1) blocks in THIS
        pool covering [0, n_tokens) for ``slot`` and return their physical
        ids in logical order, for ``ModelRunner.import_blocks_from`` to
        fill. All-or-nothing: None (state unchanged, no ``owned`` entry
        left behind) when the pool cannot cover it. The source pool's
        blocks are never referenced across pools: sharing (copy-on-write,
        the prefix index) stays within one pool."""
        if not self.allocate(slot, n_tokens):
            if not self.owned.get(slot):       # drop allocate's empty
                self.owned.pop(slot, None)     # setdefault residue
            return None
        return list(self.owned[slot])

    # --- pinning (a verify step in flight) ---------------------------------
    def pin(self, slot: int) -> None:
        """Freeze ``slot``'s physical block ids: a step in flight has
        captured them in a device block table, so defrag must not move
        them until the step commits (unpin)."""
        self.pinned.add(slot)

    def unpin(self, slot: int) -> None:
        self.pinned.discard(slot)

    # --- defrag -----------------------------------------------------------
    def defrag(self) -> Optional[np.ndarray]:
        """Compact live blocks into the lowest physical ids. Returns the
        i32[n_blocks] gather permutation ``perm`` (new storage row i =
        old row perm[i]) for the engine to apply to the device pools, or
        None if already compact. With block indirection defrag is never
        needed for correctness — it restores locality for the streaming
        prefetcher after heavy churn (paper's best-offset prefetcher
        expects near-sequential block reads). Blocks referenced by pinned
        slots (a step in flight) are never moved — even when a sibling shares
        them; everything else (including index-held reclaimable blocks)
        compacts around them, and the prefix index is remapped in place."""
        pinned_blocks = {b for s in self.pinned
                         for b in self.owned.get(s, ())}
        live: Set[int] = set(self.index.blocks()) if self.index else set()
        for blocks in self.owned.values():
            live.update(blocks)
        movable = sorted(live - pinned_blocks)
        targets = [i for i in range(self.n_blocks)
                   if i not in pinned_blocks]
        targets = targets[:len(movable)]
        if movable == targets:
            return None
        remap = {old: new for old, new in zip(movable, targets)
                 if old != new}
        perm = np.arange(self.n_blocks, dtype=np.int32)
        for old, new in remap.items():
            perm[new] = old
        for slot, blocks in self.owned.items():
            nb = [remap.get(b, b) for b in blocks]
            if nb != blocks:
                self.owned[slot] = nb
                self._tables[slot, :len(nb)] = nb
        self.ref = {remap.get(b, b): r for b, r in self.ref.items()}
        if self.index is not None:
            self.index.on_defrag(remap)
        new_live = {remap.get(b, b) for b in live}
        self.free = [i for i in range(self.n_blocks) if i not in new_live]
        return perm

    # --- byte accounting (paper Table II currency) ------------------------
    def bytes_per_block(self) -> float:
        return self.block_size * kv_bytes_per_token(self.cfg, self.int8_kv)

    def used_bytes(self) -> float:
        return self.n_used * self.bytes_per_block()

    def capacity_bytes(self) -> float:
        return self.n_blocks * self.bytes_per_block()

    def reset_counters(self) -> None:
        """Restart the event counters (a fresh measurement window, e.g.
        after benchmark warmup). Allocation STATE — owned blocks,
        refcounts, tables, free list — is untouched; the high-water mark
        restarts from the current occupancy."""
        self.alloc_count = 0
        self.free_count = 0
        self.share_count = 0
        self.cow_count = 0
        self.hwm_blocks = self.n_used

    def fragmentation(self) -> float:
        """How scattered the free list is: 1 - (longest contiguous free
        run / free blocks). 0 when the free space is one run (or empty) —
        the streaming-prefetcher-friendly state defrag restores."""
        if not self.free:
            return 0.0
        runs, best, cur = sorted(self.free), 1, 1
        for a, b in zip(runs, runs[1:]):
            cur = cur + 1 if b == a + 1 else 1
            best = max(best, cur)
        return 1.0 - best / len(runs)

    def stats(self) -> dict:
        """Pool-pressure snapshot for metrics.summary()["kv_pool"]: sizes,
        byte gauges (global AND per-shard under sharded serving), event
        counters since the last reset_counters(), high-water mark, and
        free-list fragmentation."""
        return {"n_blocks": self.n_blocks, "n_free": self.n_free,
                "model_shards": self.model_shards,
                "per_shard_used_bytes":
                    self.used_bytes() / self.model_shards,
                "per_shard_capacity_bytes":
                    self.capacity_bytes() / self.model_shards,
                "n_free_list": len(self.free),
                "n_reclaimable": self.n_reclaimable,
                "n_used": self.n_used, "used_bytes": self.used_bytes(),
                "capacity_bytes": self.capacity_bytes(),
                "allocs": self.alloc_count, "frees": self.free_count,
                "shared": self.share_count, "cow": self.cow_count,
                "high_water_blocks": self.hwm_blocks,
                "high_water_frac": self.hwm_blocks / max(self.n_blocks, 1),
                "fragmentation": self.fragmentation()}
