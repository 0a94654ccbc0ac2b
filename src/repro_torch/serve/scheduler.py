"""Request scheduler: admission control, chunked prefill interleaved with
decode, FIFO/priority ordering, preemption-by-eviction, prefix reuse.

The port's copy of the reference's scheduler: pure host policy over slots
and the block pool. Preemption is vLLM-style recompute: the victim's blocks are freed and its
prompt plus already generated tokens replay through chunked prefill when
capacity returns (under speculation the prompt only: the generated tokens
re-feed through verify steps, ``SchedEntry.resync``).

With ``ServeConfig.prefix_cache`` a radix index over token prefixes
(serve.prefix_cache) rides along: admission matches the longest cached
block-aligned prefix, maps those physical blocks into the new slot
(refcount++), and chunked prefill covers only the uncached suffix —
including on replay after eviction, where the victim's own prompt blocks
are usually still indexed and re-prefill collapses to a table remap.

A disagg prefill engine parks a request at ``State.HANDOFF`` once its
prompt KV is final: a parked entry is neither a prefill nor a decode row
(``prefill_entries``, ``decode_entries``, ``decode_only`` skip it), but
it holds its slot and blocks, stays preemptable (``pick_victim``) and,
evicted, replays its prefill and parks again.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional

import numpy as np

from repro_torch.configs.base import ServeConfig
from repro_torch.serve.kv_cache import SlotAllocator
from repro_torch.serve.paged_kv import PagedKVCache
from repro_torch.serve.sampling import SamplingParams


@dataclasses.dataclass
class Request:
    """One generation request.

    ``sampling`` carries the per-request decoding contract (temperature,
    top-k/top-p, repetition penalty, stop sequences, max_tokens,
    logprobs) end-to-end: api.submit -> scheduler -> engine -> runner.
    ``sampling.max_tokens`` tightens ``max_new`` at admission; when
    ``sampling.logprobs`` is set, ``logprobs_out[i]`` is the chosen-token
    log-probability of ``tokens_out[i]``; ``sampling.prompt_logprobs``
    fills ``prompt_logprobs_out[i]`` with the log-probability of
    ``prompt[i]`` given ``prompt[:i]`` (index 0 is None — no prefix).
    ``submitted_at`` is the front end's submit time (``obs.trace.now_s``;
    None when the engine is called directly); ``metrics`` is the request's
    ``serve.metrics.RequestMetrics`` record once the engine has it."""
    rid: int
    prompt: np.ndarray          # i32[S] (or [S, nc]: codebooks)
    max_new: int = 16
    tokens_out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    priority: int = 0           # larger = more urgent (policy="priority")
    sampling: SamplingParams = dataclasses.field(
        default_factory=SamplingParams)
    logprobs_out: List[float] = dataclasses.field(default_factory=list)
    prompt_logprobs_out: List[Optional[float]] = dataclasses.field(
        default_factory=list)
    submitted_at: Optional[float] = None
    metrics: Optional[object] = dataclasses.field(default=None, repr=False,
                                                  compare=False)


class State(enum.Enum):
    WAITING = "waiting"
    PREFILL = "prefill"
    RUNNING = "running"
    HANDOFF = "handoff"         # prefill done, parked for disagg export
    DONE = "done"


@dataclasses.dataclass
class SchedEntry:
    req: Request
    seq: int                    # admission-order tiebreak
    state: State = State.WAITING
    slot: Optional[int] = None
    pos: int = 0                # prefill frontier (tokens written)
    ctx_len: int = 0            # device lens[slot] mirror once RUNNING
    replay: bool = False        # re-prefill after eviction
    cached_len: int = 0         # prefix-cache hit: tokens mapped at admit
    plp_prev: Optional[np.ndarray] = None  # prompt-logprobs chunk seam:
    #                              last-position logits of the prior chunk
    resync_replay: bool = False  # spec mode: replay prompt only, then
    #                              re-feed generated KV via verify steps
    resync: List[int] = dataclasses.field(default_factory=list)

    def prefill_tokens(self) -> np.ndarray:
        """What chunked prefill must process: the prompt, plus — after an
        eviction — every generated token except the last (whose KV is
        written by the next decode step, same as the steady-state
        invariant).

        Speculative engines replay the prompt ONLY (resync_replay): the
        generated tokens' KV was first written by verify steps through the
        sparse-gather FFN, and a dense-prefill recompute of those
        positions would differ in the last bits and could flip a later
        greedy argmax. The engine re-feeds them through the same verify
        step instead (``resync``)."""
        prompt = np.asarray(self.req.prompt)
        if not self.replay or self.resync_replay \
                or len(self.req.tokens_out) <= 1:
            return prompt
        gen = np.asarray(self.req.tokens_out[:-1], dtype=prompt.dtype)
        return np.concatenate([prompt, gen], axis=0)


class Scheduler:
    """Decides, per tick, which prefill chunk runs and which rows decode."""

    def __init__(self, scfg: ServeConfig, pool: PagedKVCache, prefix=None):
        if scfg.policy not in ("fifo", "priority"):
            raise ValueError(f"unknown scheduling policy {scfg.policy!r}")
        self.scfg = scfg
        self.pool = pool
        self.prefix = prefix        # RadixPrefixCache | None
        self.slots = SlotAllocator(scfg.max_batch)
        self.waiting: List[SchedEntry] = []
        self.active: Dict[int, SchedEntry] = {}     # rid -> PREFILL/RUNNING
        self._seq = 0
        self.n_preemptions = 0
        self.n_rejected = 0

    # --- ordering ---------------------------------------------------------
    def _key(self, e: SchedEntry):
        if self.scfg.policy == "priority":
            return (-e.req.priority, e.seq)
        return (e.seq,)

    # --- admission --------------------------------------------------------
    def submit(self, req: Request) -> bool:
        """Admission control: bounded queue; beyond it, shed load at the
        door instead of growing tail latency unboundedly."""
        if len(self.waiting) >= self.scfg.max_queue:
            self.n_rejected += 1
            return False
        e = SchedEntry(req=req, seq=self._seq)
        self._seq += 1
        self.waiting.append(e)
        self.waiting.sort(key=self._key)
        return True

    def admit(self) -> List[SchedEntry]:
        """Move waiting requests into slots while a slot AND enough
        allocatable blocks for at least the first prefill chunk exist.

        With a prefix index, the longest cached block-aligned prefix is
        mapped into the slot first (``pool.share``: refcount++, no new
        blocks, no prefill work) and the chunk budget covers only the
        uncached suffix. The share is rolled back (free_slot) if the
        suffix's first chunk doesn't fit — matched-but-unadmitted blocks
        must drop back to reclaimable, not leak references."""
        admitted = []
        while self.waiting and self.slots.free:
            e = self.waiting[0]
            toks = e.prefill_tokens()
            shared: List[int] = []
            cached_len = 0
            if self.prefix is not None \
                    and not e.req.sampling.prompt_logprobs:
                # prompt_logprobs needs real logits for every prompt
                # position — cached positions never run through the model.
                # record=False: a blocked head-of-line request repeats
                # this lookup every tick; stats count once, on admission.
                shared, cached_len = self.prefix.match(toks, record=False)
            first = min(self.scfg.prefill_chunk, len(toks) - cached_len)
            # capacity precheck BEFORE touching refcounts: new blocks for
            # the suffix chunk, plus one reclaimable revived per matched
            # block nobody references (sharing it removes it from the
            # pool's allocatable count). Conservative, so a blocked
            # request never churns share/free counters while it waits.
            need_new = self.pool.blocks_for(cached_len + first) \
                - len(shared)
            revived = sum(1 for b in shared
                          if self.pool.ref.get(b, 0) == 0)
            if need_new + revived > self.pool.n_free:
                break
            slot = self.slots.alloc(e.req.rid)
            self.pool.share(slot, shared)
            if not self.pool.can_allocate(slot, cached_len + first):
                self.pool.free_slot(slot)      # precheck was conservative,
                self.slots.release(e.req.rid)  # not wrong — roll back
                break
            if self.prefix is not None \
                    and not e.req.sampling.prompt_logprobs:
                self.prefix.record_lookup(cached_len)
            e.slot = slot
            e.state = State.PREFILL
            e.pos = cached_len
            e.cached_len = cached_len
            self.waiting.pop(0)
            self.active[e.req.rid] = e
            admitted.append(e)
        return admitted

    # --- prefix indexing --------------------------------------------------
    def index_prefix(self, e: SchedEntry, tokens, n_tokens: int) -> None:
        """Insert ``e``'s leading full blocks into the prefix index once
        their KV is final: ``tokens[:n_tokens]`` have device KV written
        and no future write can touch a full block below that frontier
        (rollback keeps whole blocks; writes past the frontier COW)."""
        if self.prefix is None or e.slot is None:
            return
        blocks = self.pool.owned.get(e.slot, [])
        n_full = min(n_tokens // self.pool.block_size, len(blocks))
        if n_full > 0:
            toks = np.asarray(tokens).reshape(-1)
            self.prefix.insert(toks[:n_full * self.pool.block_size],
                               blocks[:n_full])

    # --- per-tick picks ---------------------------------------------------
    def prefill_entries(self) -> List[SchedEntry]:
        """Active mid-prefill entries in policy order — the engine gives
        each one a PREFILL row of the unified step this tick."""
        return sorted((e for e in self.active.values()
                       if e.state == State.PREFILL), key=self._key)

    def decode_entries(self) -> List[SchedEntry]:
        return sorted((e for e in self.active.values()
                       if e.state == State.RUNNING), key=lambda e: e.slot)

    def decode_only(self) -> bool:
        """True when this tick is pure decode steady state: no queued
        admissions and no active entry still prefilling (or replaying a
        prefill). The async engine overlaps or bursts only such ticks;
        anything else runs the synchronous tick, which keeps admission and
        preemption in the order of the synchronous engine."""
        if self.waiting:
            return False
        return not any(e.state == State.PREFILL
                       for e in self.active.values())

    # --- preemption -------------------------------------------------------
    def pick_victim(self, e: SchedEntry) -> Optional[SchedEntry]:
        """Lowest-precedence active request ranking strictly BELOW the
        requester. The strict ordering matters: if eviction were mutual,
        two requests too big to coexist would evict each other forever.
        With it, the highest-precedence request always wins its blocks and
        runs to completion; the loser defers until capacity returns."""
        ek = self._key(e)
        cands = [v for v in self.active.values()
                 if v.req.rid != e.req.rid and self._key(v) > ek]
        if not cands:
            return None
        return max(cands, key=self._key)

    def preempt(self, e: SchedEntry) -> None:
        """Evict: release block refs + slot, requeue for recompute.
        Blocks the prefix index holds (the victim's own prompt, typically)
        merely drop to reclaimable — if they survive until readmission,
        the replay prefill matches them and skips the recompute."""
        self.pool.free_slot(e.slot)
        self.slots.release(e.req.rid)
        del self.active[e.req.rid]
        e.slot = None
        e.pos = 0
        e.ctx_len = 0
        e.cached_len = 0
        e.state = State.WAITING
        e.replay = bool(e.req.tokens_out)
        e.resync_replay = e.replay and self.scfg.spec is not None
        e.resync = []
        if e.req.sampling.prompt_logprobs:
            P = len(np.asarray(e.req.prompt).reshape(-1))
            if len(e.req.prompt_logprobs_out) < P:
                # mid-prefill eviction: the chunk-seam logits are stale
                # after replay restarts at pos 0 — recompute from scratch
                e.req.prompt_logprobs_out.clear()
        e.plp_prev = None
        self.waiting.append(e)
        self.waiting.sort(key=self._key)
        self.n_preemptions += 1

    def finish(self, e: SchedEntry) -> None:
        # index the finished request's blocks BEFORE releasing them: the
        # generated tokens extend the cached chain (multi-turn traffic
        # re-sends prompt+response as the next prompt). KV is valid up to
        # the committed frontier — the final token's KV was never written
        # (steady-state invariant), so it never indexes.
        if self.prefix is not None:
            if e.state == State.PREFILL:
                self.index_prefix(e, e.prefill_tokens(), e.pos)
            else:
                prompt = np.asarray(e.req.prompt).reshape(-1)
                seq = np.concatenate(
                    [prompt, np.asarray(e.req.tokens_out, prompt.dtype)])
                kv_valid = len(prompt) + max(len(e.req.tokens_out) - 1, 0)
                self.index_prefix(e, seq, kv_valid)
        e.state = State.DONE
        e.req.done = True
        self.pool.free_slot(e.slot)
        self.slots.release(e.req.rid)
        del self.active[e.req.rid]

    # --- introspection ----------------------------------------------------
    @property
    def n_waiting(self) -> int:
        return len(self.waiting)

    @property
    def n_active(self) -> int:
        return len(self.active)

    @property
    def idle(self) -> bool:
        return not self.waiting and not self.active
