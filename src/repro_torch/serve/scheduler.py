"""Request scheduler: admission control, chunked prefill interleaved with
decode, FIFO/priority ordering, preemption-by-eviction.

The port's copy of the reference's scheduler (pure host policy over slots
and the block pool), without the prefix-cache and speculative-decoding
branches that later slices bring. Preemption is vLLM-style recompute: the
victim's blocks are freed and its prompt plus already generated tokens
replay through chunked prefill when capacity returns.
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
    """One generation request. ``sampling`` carries the per-request
    decoding contract; ``sampling.max_tokens`` tightens ``max_new`` at
    admission; with ``sampling.logprobs``, ``logprobs_out[i]`` is the
    log-probability of ``tokens_out[i]``."""
    rid: int
    prompt: np.ndarray          # i32[S]
    max_new: int = 16
    tokens_out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    priority: int = 0           # larger = more urgent (policy="priority")
    sampling: SamplingParams = dataclasses.field(
        default_factory=SamplingParams)
    logprobs_out: List[float] = dataclasses.field(default_factory=list)


class State(enum.Enum):
    WAITING = "waiting"
    PREFILL = "prefill"
    RUNNING = "running"
    DONE = "done"


@dataclasses.dataclass
class SchedEntry:
    req: Request
    seq: int                    # admission-order tiebreak
    state: State = State.WAITING
    slot: Optional[int] = None
    pos: int = 0                # prefill frontier (tokens written)
    ctx_len: int = 0            # committed context once RUNNING
    replay: bool = False        # re-prefill after eviction

    def prefill_tokens(self) -> np.ndarray:
        """What chunked prefill must process: the prompt, plus — after an
        eviction — every generated token except the last (whose KV the
        next decode step writes)."""
        prompt = np.asarray(self.req.prompt)
        if not self.replay or len(self.req.tokens_out) <= 1:
            return prompt
        gen = np.asarray(self.req.tokens_out[:-1], dtype=prompt.dtype)
        return np.concatenate([prompt, gen], axis=0)


class Scheduler:
    """Decides, per tick, which prefill chunks run and which rows decode."""

    def __init__(self, scfg: ServeConfig, pool: PagedKVCache):
        if scfg.policy not in ("fifo", "priority"):
            raise ValueError(f"unknown scheduling policy {scfg.policy!r}")
        self.scfg = scfg
        self.pool = pool
        self.slots = SlotAllocator(scfg.max_batch)
        self.waiting: List[SchedEntry] = []
        self.active: Dict[int, SchedEntry] = {}     # rid -> PREFILL/RUNNING
        self._seq = 0

    def _key(self, e: SchedEntry):
        if self.scfg.policy == "priority":
            return (-e.req.priority, e.seq)
        return (e.seq,)

    def submit(self, req: Request) -> bool:
        """Admission control: a bounded queue; beyond it, shed load."""
        if len(self.waiting) >= self.scfg.max_queue:
            return False
        e = SchedEntry(req=req, seq=self._seq)
        self._seq += 1
        self.waiting.append(e)
        self.waiting.sort(key=self._key)
        return True

    def admit(self) -> List[SchedEntry]:
        """Move waiting requests into slots while a slot AND enough
        allocatable blocks for the first prefill chunk exist."""
        admitted = []
        while self.waiting and self.slots.free:
            e = self.waiting[0]
            first = min(self.scfg.prefill_chunk, len(e.prefill_tokens()))
            if self.pool.blocks_for(first) > self.pool.n_free:
                break
            e.slot = self.slots.alloc(e.req.rid)
            e.state = State.PREFILL
            e.pos = 0
            self.waiting.pop(0)
            self.active[e.req.rid] = e
            admitted.append(e)
        return admitted

    def prefill_entries(self) -> List[SchedEntry]:
        """Active mid-prefill entries in policy order."""
        return sorted((e for e in self.active.values()
                       if e.state == State.PREFILL), key=self._key)

    def decode_entries(self) -> List[SchedEntry]:
        return sorted((e for e in self.active.values()
                       if e.state == State.RUNNING), key=lambda e: e.slot)

    def pick_victim(self, e: SchedEntry) -> Optional[SchedEntry]:
        """Lowest-precedence active request ranking strictly BELOW the
        requester (strict, so two requests too big to coexist cannot evict
        each other forever)."""
        ek = self._key(e)
        cands = [v for v in self.active.values()
                 if v.req.rid != e.req.rid and self._key(v) > ek]
        if not cands:
            return None
        return max(cands, key=self._key)

    def preempt(self, e: SchedEntry) -> None:
        """Evict: release blocks + slot, requeue for recompute."""
        self.pool.free_slot(e.slot)
        self.slots.release(e.req.rid)
        del self.active[e.req.rid]
        e.slot = None
        e.pos = 0
        e.ctx_len = 0
        e.state = State.WAITING
        e.replay = bool(e.req.tokens_out)
        self.waiting.append(e)
        self.waiting.sort(key=self._key)

    def finish(self, e: SchedEntry) -> None:
        e.state = State.DONE
        e.req.done = True
        self.pool.free_slot(e.slot)
        self.slots.release(e.req.rid)
        del self.active[e.req.rid]

    @property
    def n_active(self) -> int:
        return len(self.active)

    @property
    def idle(self) -> bool:
        return not self.waiting and not self.active
