"""Radix-tree prefix cache: share KV blocks between requests with a
common token prefix.

Decode on NeCTAr-class hardware is memory-bandwidth-bound — the paper's
near-memory matrix-vector units exist because weight/KV streaming
dominates — so re-prefilling the same system prompt for every request
burns the scarcest resource (off-chip bytes, Table II). The unified
``ModelRunner.step`` already reads per-row block tables, so requests
sharing a prompt prefix can share *physical* KV blocks: this module is
the index that finds them.

Structure: a radix tree over token-IDs at BLOCK granularity — each node
is one full block (``block_size`` tokens), keyed by that block's exact
token content, mapping to the physical block id whose device KV holds
those tokens' keys/values. Properties that make this sound:

  * only FULL blocks are indexed, and matching is capped at
    ``len(tokens) - 1`` so at least one suffix token always runs through
    the model (the completing prefill chunk is where first-token logits
    come from);
  * matched blocks are mapped read-only (``PagedKVCache.share`` bumps
    refcounts); any write that would land in a shared block — a rollback
    into a partial tail, a partial-block share — copy-on-writes first
    (``cow_for_write``), so siblings can never observe each other;
  * KV content is deterministic in (token ids, positions): a block
    prefilled by one request is bit-identical to what any other request
    would have computed for the same prefix, so greedy output is
    token-identical with the cache on or off.

Lifecycle: blocks are inserted when their content becomes final (prefill
completion for prompt blocks, request completion for generated blocks).
While any slot still maps a block it is pinned by its refcount; once the
last slot releases it, the block becomes RECLAIMABLE — it stays indexed
(a future request may match it) but admission control counts it as
allocatable, and ``reclaim`` evicts leaf-first in LRU order when the
free list runs dry. Caching therefore never shrinks the admissible
batch; it only changes which bytes the pool's "free" capacity holds.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serve.paged_kv import PagedKVCache


class _Node:
    """One full block of the indexed prefix: ``key`` is the block's exact
    token content, ``block`` the physical block id holding its KV."""

    __slots__ = ("key", "block", "parent", "children", "last_used")

    def __init__(self, key: Optional[Tuple[int, ...]], block: int,
                 parent: Optional["_Node"]):
        self.key = key
        self.block = block
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.last_used = 0


class RadixPrefixCache:
    """Block-granular radix index over token prefixes -> physical blocks.

    Registers itself as ``pool.index``: the pool consults it for
    reclaimable capacity (``n_reclaimable``), asks it to evict LRU blocks
    when the free list is dry (``reclaim``), and remaps it on defrag.
    """

    def __init__(self, pool: PagedKVCache):
        self.pool = pool
        self.block_size = pool.block_size
        self.root = _Node(key=None, block=-1, parent=None)
        self._by_block: Dict[int, _Node] = {}
        self._clock = 0
        self._n_reclaimable: Optional[int] = None   # memo (see on_ref)
        # counters (serve.metrics surfaces these)
        self.lookups = 0
        self.hits = 0                 # lookups matching >= 1 block
        self.tokens_matched = 0
        self.inserts = 0
        self.evictions = 0
        pool.index = self

    # --- helpers ----------------------------------------------------------
    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def __len__(self) -> int:
        return len(self._by_block)

    def holds(self, block: int) -> bool:
        return block in self._by_block

    def blocks(self) -> List[int]:
        return list(self._by_block)

    # --- lookup -----------------------------------------------------------
    def match(self, tokens, record: bool = True) -> Tuple[List[int], int]:
        """Longest indexed block-aligned prefix of ``tokens``, capped at
        ``len(tokens) - 1`` so a suffix of at least one token remains to
        prefill (first-token logits must come from a real forward pass).
        Returns (physical blocks, tokens covered) and LRU-touches the
        matched path. The caller maps the blocks with ``pool.share``
        before allocating anything else for the slot.

        ``record=False`` skips the hit counters: a blocked admission
        retries its lookup every tick, and those retries must not
        inflate the reported hit rate (the scheduler records once, on
        successful admission, via ``record_lookup``)."""
        toks = np.asarray(tokens).reshape(-1)
        bs = self.block_size
        max_blocks = max((len(toks) - 1) // bs, 0)
        node, blocks = self.root, []
        while len(blocks) < max_blocks:
            key = tuple(int(t) for t in
                        toks[len(blocks) * bs:(len(blocks) + 1) * bs])
            child = node.children.get(key)
            if child is None:
                break
            node = child
            blocks.append(child.block)
        t = self._tick()
        while node is not self.root:
            node.last_used = t
            node = node.parent
        if record:
            self.record_lookup(len(blocks) * bs)
        return blocks, len(blocks) * bs

    def record_lookup(self, tokens_matched: int) -> None:
        """Count one admission-level lookup outcome toward the hit-rate
        counters (exactly once per admitted request)."""
        self.lookups += 1
        if tokens_matched > 0:
            self.hits += 1
            self.tokens_matched += tokens_matched

    def reset_counters(self) -> None:
        """Restart the event counters (a fresh measurement window, e.g.
        after benchmark warmup); the tree and its contents survive."""
        self.lookups = self.hits = self.tokens_matched = 0
        self.inserts = self.evictions = 0

    # --- insert -----------------------------------------------------------
    def insert(self, tokens, blocks: List[int]) -> int:
        """Index the full blocks of a sequence whose KV is final:
        ``blocks[i]`` holds tokens [i*bs, (i+1)*bs). First writer wins —
        an existing node keeps its block and the caller's private copy of
        the same content simply stays unindexed (freed normally when its
        slot releases it). Returns the number of nodes added."""
        toks = np.asarray(tokens).reshape(-1)
        bs = self.block_size
        n_full = min(len(toks) // bs, len(blocks))
        node, added, t = self.root, 0, self._tick()
        for i in range(n_full):
            key = tuple(int(x) for x in toks[i * bs:(i + 1) * bs])
            child = node.children.get(key)
            if child is None:
                b = blocks[i]
                if b in self._by_block:
                    # one physical block cannot live at two tree positions
                    # (possible only after exotic cow/rollback interleaving)
                    break
                child = _Node(key=key, block=b, parent=node)
                node.children[key] = child
                self._by_block[b] = child
                added += 1
                self.inserts += 1
            child.last_used = t
            node = child
        if added:
            self._n_reclaimable = None
        return added

    # --- reclaim (the pool's lazy free path) ------------------------------
    def on_ref_changed(self, block: int) -> None:
        """Pool hook: a block's slot refcount crossed the 0 boundary —
        the memoized reclaimable count is stale. Called only for blocks
        the index holds, so unindexed churn stays free."""
        self._n_reclaimable = None

    def n_reclaimable(self) -> int:
        """Blocks the pool may treat as allocatable: indexed blocks whose
        whole subtree carries no slot reference (leaf-first cascading
        eviction can free every one of them). A zero-ref interior node
        above a still-referenced child is NOT reclaimable — evicting it
        would orphan live entries. Memoized: ``n_free`` sits on the
        per-tick allocation path, and the count only changes on indexed
        refcount 0<->1 transitions, inserts, and reclaims."""
        if self._n_reclaimable is None:
            self._n_reclaimable = self._count_reclaimable()
        return self._n_reclaimable

    def _count_reclaimable(self) -> int:
        """Indexed blocks less the locked ones: a node is locked when it
        or a descendant is referenced, so the locked nodes are the
        referenced ones and their ancestors, found up the parent links,
        each node once (no recursion: a chain of cached blocks is as deep
        as its sequence is long)."""
        ref = self.pool.ref
        locked = set()
        for b, node in self._by_block.items():
            if ref.get(b, 0) <= 0:
                continue
            while node is not self.root and node not in locked:
                locked.add(node)
                node = node.parent
        return len(self._by_block) - len(locked)

    def reclaim(self, n: int) -> List[int]:
        """Evict up to ``n`` LRU unreferenced LEAF blocks from the index
        (cascading: a parent whose last child leaves becomes a leaf).
        Returns the physical block ids, now free for the pool to hand
        out. Never touches a block any slot still references."""
        ref = self.pool.ref
        freed: List[int] = []
        while len(freed) < n:
            leaves = [nd for nd in self._by_block.values()
                      if not nd.children and ref.get(nd.block, 0) == 0]
            if not leaves:
                break
            victim = min(leaves, key=lambda nd: nd.last_used)
            del victim.parent.children[victim.key]
            del self._by_block[victim.block]
            freed.append(victim.block)
            self.evictions += 1
        if freed:
            self._n_reclaimable = None
        return freed

    # --- pool maintenance hooks -------------------------------------------
    def on_defrag(self, remap: Dict[int, int]) -> None:
        """Pool defrag moved physical blocks: rewrite the index's ids."""
        if not remap:
            return
        moved = {}
        for b, nd in self._by_block.items():
            nb = remap.get(b, b)
            nd.block = nb
            moved[nb] = nd
        self._by_block = moved

    # --- introspection ----------------------------------------------------
    def stats(self) -> dict:
        return {"nodes": len(self._by_block),
                "reclaimable": self.n_reclaimable(),
                "lookups": self.lookups, "hits": self.hits,
                "hit_rate": self.hits / max(self.lookups, 1),
                "tokens_matched": self.tokens_matched,
                "inserts": self.inserts, "evictions": self.evictions}


__all__ = ["RadixPrefixCache"]
