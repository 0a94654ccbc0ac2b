"""Inference engine: the paged scheduler engine and the legacy slot engine.

The port of the reference engine's two synchronous modes:

  * ``ServeConfig(paged=True)``: every phase of every request — chunked
    prefill and single-token decode — is a ROW of one batched
    ``ModelRunner.step`` per tick. The engine is pure host policy:
    admission (serve.scheduler), block accounting (serve.paged_kv),
    building the per-tick ``StepBatch`` and committing greedy tokens.
  * ``ServeConfig(paged=False)``, the default: fixed slots over a
    contiguous [max_batch, max_seq] KV cache. ``add_request`` prefills the
    prompt at once into a batch-1 cache and splices it into a free slot;
    each ``step`` decodes one token for every slot.

Speculative decoding, the async tick pipeline, sharded serving, disagg
handoff, the prefix cache, int8 KV, prompt log-probabilities, tracing and
sampled rows are later slices of the port: asking for any of them raises
``NotImplementedError`` (or ``ValueError`` where the reference's slot mode
refuses them too).
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ServeConfig
from repro_torch.device import resolve_device
from repro_torch.models import Model
from repro_torch.serve import (kv_cache, metrics as metrics_mod, paged_kv,
                               sampling)
from repro_torch.serve.runner import DECODE, PREFILL, ModelRunner
from repro_torch.serve.scheduler import Request, SchedEntry, Scheduler, State


def _to(tree: dict, device: torch.device) -> dict:
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def _paged_only(scfg: ServeConfig) -> List[str]:
    """The features ``scfg`` asks for that the reference serves in paged
    mode only: its slot engine refuses them with a ValueError."""
    return [name for name, on in (
        ("async serving (ServeConfig.async_cfg)",
         scfg.async_cfg is not None and scfg.async_cfg.enabled),
        ("speculative decode (ServeConfig.spec)", scfg.spec is not None),
        ("roofline profiling (ObsConfig.profile)", scfg.obs.profile),
        ("prefix_cache", scfg.prefix_cache),
        ("sharded serving (ServeConfig.mesh)",
         scfg.mesh is not None and scfg.mesh.n_devices > 1)) if on]


def _unsupported(scfg: ServeConfig) -> List[str]:
    """The ServeConfig features outside this slice that ``scfg`` asks
    for."""
    return [name for name, on in (
        ("spec", scfg.spec is not None),
        ("async_cfg", scfg.async_cfg is not None
         and scfg.async_cfg.enabled),
        ("mesh", scfg.mesh is not None and scfg.mesh.n_devices > 1),
        ("prefix_cache", scfg.prefix_cache),
        ("kv_quant", scfg.kv_quant),
        ("obs", scfg.obs.enabled or scfg.obs.profile)) if on]


class Engine:
    """The serving front door: host-side policy over one ModelRunner
    (paged mode) or over the slot cache (slot mode, the default).

    Construct with a ModelConfig, its params and a ServeConfig; submit
    work with ``add_request(Request)`` (or the batch loop ``run``),
    advance with ``step()`` — one tick = at most one batched device step
    — and read results off ``Request.tokens_out`` / ``metrics.summary()``.
    ``device`` defaults to CUDA; the params move there."""

    def __init__(self, cfg: ModelConfig, params: dict, scfg: ServeConfig,
                 device: Optional[Union[str, torch.device]] = None):
        self.device = resolve_device(device)
        paged_only = [] if scfg.paged else _paged_only(scfg)
        if paged_only:
            raise ValueError(f"{', '.join(paged_only)} requires the paged "
                             f"engine (paged=True)")
        missing = _unsupported(scfg)
        if missing:
            raise NotImplementedError(
                f"not in this slice of the port: {', '.join(missing)}")
        self.cfg = cfg
        self.scfg = scfg
        self.model = Model(cfg)
        self.params = _to(params, self.device)
        self.metrics = metrics_mod.MetricsCollector()
        self._requests: Dict[int, Request] = {}
        self._rids = itertools.count()
        if scfg.paged:
            self.pool = paged_kv.PagedKVCache(
                n_blocks=scfg.pool_blocks, block_size=scfg.block_size,
                max_batch=scfg.max_batch,
                max_blocks_per_seq=scfg.blocks_per_seq)
            self.sched = Scheduler(scfg, self.pool)
            self.runner = ModelRunner(self.model, self.params, scfg,
                                      self.device)
        else:
            self._init_slots()

    def new_rid(self) -> int:
        """Engine-global request id: every front end draws from here."""
        rid = next(self._rids)
        while rid in self._requests:
            rid = next(self._rids)
        return rid

    # ------------------------------------------------------------------
    # request loop

    def run(self, requests: List[Request], max_steps: int = 256
            ) -> Dict[int, Request]:
        """Continuous batching loop: admit whenever capacity frees, one
        scheduler tick per iteration."""
        pending = list(requests)
        done: Dict[int, Request] = {}
        steps = 0
        while (pending or self._busy()) and steps < max_steps:
            while pending and self.add_request(pending[0]):
                pending.pop(0)
            if pending and not self._busy():
                pending.pop(0)        # structurally unservable (too long)
            for rid in self.step():
                done[rid] = self._requests[rid]
            steps += 1
        return done

    @property
    def admission_free(self) -> int:
        """How many more requests ``add_request`` would take right now:
        the scheduler's queue headroom in paged mode, the free slots in
        slot mode."""
        if self.scfg.paged:
            return max(self.scfg.max_queue - len(self.sched.waiting), 0)
        return len(self.alloc.free)

    def _busy(self) -> bool:
        if self.scfg.paged:
            return not self.sched.idle
        return bool(self._active) or bool(self._done_at_admit)

    def can_serve(self, req: Request) -> bool:
        """False means no amount of waiting will ever admit ``req``."""
        return len(np.asarray(req.prompt)) + 1 <= self.scfg.max_seq

    def add_request(self, req: Request) -> bool:
        prev = self._requests.get(req.rid)
        if prev is not None and prev is not req and not prev.done:
            raise ValueError(
                f"request id {req.rid} is already in flight; use "
                f"Engine.new_rid() to allocate ids")
        if req.sampling.prompt_logprobs:
            if not self.scfg.paged:
                raise ValueError(
                    "prompt_logprobs needs the paged engine's all-position "
                    "prefill logits (ServeConfig(paged=True))")
            raise NotImplementedError("prompt_logprobs is a later slice")
        sampling.check_greedy(sampling.effective_params(req.sampling))
        if not self.can_serve(req):
            return False
        if req.sampling.max_tokens is not None:
            req.max_new = min(req.max_new, req.sampling.max_tokens)
        if not self.scfg.paged:
            return self._add_request_slots(req)
        if not self.sched.submit(req):
            return False                       # queue full: shed load
        self._requests[req.rid] = req
        self.metrics.on_arrival(req.rid, len(np.asarray(req.prompt)))
        return True

    def forget(self, rid: int) -> None:
        """Drop a finished request's record (and its metrics entry)."""
        req = self._requests.get(rid)
        if req is not None and req.done:
            del self._requests[rid]
            self.metrics.requests.pop(rid, None)

    def step(self) -> List[int]:
        """One engine tick; returns the rids that finished this tick."""
        if self.scfg.paged:
            return self._tick_paged()
        return self._step_slots()

    # ------------------------------------------------------------------
    # one tick

    def _sample_rows(self, last_logits: torch.Tensor
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """One batched greedy sample over every row (add_request admits
        greedy rows only); rows nobody reads get garbage."""
        return sampling.greedy_batch(last_logits)

    def _append_token(self, req: Request, tok: int, lp: float) -> str:
        """Commit one token to the request stream. Returns "ok", "stop" (a
        stop sequence matched and was truncated off) or "max"."""
        req.tokens_out.append(tok)
        if req.sampling.logprobs:
            req.logprobs_out.append(float(lp))
        if req.sampling.stop:
            cut = sampling.stop_truncate(req.tokens_out, req.sampling.stop)
            if cut is not None:
                del req.tokens_out[cut:]
                del req.logprobs_out[cut:]
                return "stop"
        if len(req.tokens_out) >= req.max_new:
            return "max"
        return "ok"

    def _commit_emitted(self, e: SchedEntry, tok: int, lp: float,
                        finished: List[int], first: bool = False) -> bool:
        """Commit one token; finishes the entry on stop/max. Returns False
        when the request is done."""
        status = self._append_token(e.req, tok, lp)
        if status != "stop":
            if first:
                self.metrics.on_first_token(e.req.rid)
            else:
                self.metrics.on_token(e.req.rid)
        if status != "ok":
            self._finish(e, finished)
            return False
        return True

    def _ensure_blocks(self, e: SchedEntry, upto_len: int) -> str:
        """Grow e's block list to cover [0, upto_len), evicting only
        victims that rank strictly below e until it fits. Returns "ok",
        "defer" (retry next tick) or "never" (cannot fit a table row)."""
        if self.pool.blocks_for(upto_len) > self.pool.max_blocks_per_seq:
            return "never"
        while not self.pool.allocate(e.slot, upto_len):
            victim = self.sched.pick_victim(e)
            if victim is None:
                if self.sched.n_active <= 1:
                    raise RuntimeError(
                        f"KV pool too small: {self.pool.n_blocks} blocks "
                        f"of {self.pool.block_size} cannot hold one "
                        f"request of {upto_len} tokens")
                return "defer"
            self.metrics.on_preemption(victim.req.rid)
            self.sched.preempt(victim)
        return "ok"

    def _tick_paged(self) -> List[int]:
        """One tick = one batched ModelRunner.step serving every phase:
        capacity resolution (may evict), one device step over prefill and
        decode rows, one batched sample and the host-side commit."""
        finished: List[int] = []
        self.sched.admit()

        prefill_plan: List[Tuple[SchedEntry, int, int]] = []
        for e in self.sched.prefill_entries():
            if e.req.rid not in self.sched.active:
                continue                       # evicted making room above
            valid = min(self.scfg.prefill_chunk,
                        len(e.prefill_tokens()) - e.pos)
            st = self._ensure_blocks(e, e.pos + valid)
            if st == "never":
                self._finish(e, finished)      # prompt can't fit: give up
            elif st == "ok":
                prefill_plan.append((e, e.pos, valid))
        deferred = set()
        for e in list(self.sched.decode_entries()):
            if e.req.rid not in self.sched.active:
                continue
            st = self._ensure_blocks(e, e.ctx_len + 1)
            if st == "never":
                self._finish(e, finished)      # context ceiling reached
            elif st == "defer":
                deferred.add(e.req.rid)        # wait for capacity
        prefill_plan = [(e, pos, v) for e, pos, v in prefill_plan
                        if e.req.rid in self.sched.active]
        run_rows = [e for e in self.sched.decode_entries()
                    if e.req.rid not in deferred]
        if not prefill_plan and not run_rows:
            return finished

        rows: List[Tuple[int, int, np.ndarray, int]] = []
        for e, pos, valid in prefill_plan:
            rows.append((e.slot, PREFILL,
                         np.asarray(e.prefill_tokens()[pos:pos + valid],
                                    np.int32), pos))
        for e in run_rows:
            rows.append((e.slot, DECODE,
                         np.asarray([e.req.tokens_out[-1]], np.int32),
                         e.ctx_len))
        batch = self.runner.new_batch(max(len(r[2]) for r in rows),
                                      self.pool.tables())
        for slot, phase, toks, start in rows:
            batch.add_row(slot, phase, toks, start)
        out = self.runner.step(batch)

        completing = {e.req.rid for e, pos, valid in prefill_plan
                      if pos + valid >= len(e.prefill_tokens())}
        tok_np = lp_np = None
        if run_rows or any(not e.replay for e, _, _ in prefill_plan
                           if e.req.rid in completing):
            tok_np, lp_np = self._sample_rows(out.last_logits)

        # prefill rows: advance the frontier; a completing row emits its
        # first token (a replayed row already knows its next token)
        for e, pos, valid in prefill_plan:
            e.pos = pos + valid
            self.metrics.on_prefill_chunk(valid)
            if e.req.rid not in completing:
                continue
            e.ctx_len = e.pos
            e.state = State.RUNNING
            if e.replay:
                e.replay = False
            else:
                self._commit_emitted(e, int(tok_np[e.slot]),
                                     lp_np[e.slot], finished, first=True)
        self._commit_decode(run_rows, tok_np, lp_np, finished)
        return finished

    def _commit_decode(self, rows: List[SchedEntry], tok_np, lp_np,
                       finished: List[int]) -> None:
        """Commit one sampled token per decode row."""
        if not rows:
            return
        for e in rows:
            alive = self._commit_emitted(e, int(tok_np[e.slot]),
                                         lp_np[e.slot], finished)
            e.ctx_len += 1
            if alive and e.ctx_len + 1 > self.scfg.max_seq:
                self._finish(e, finished)
        self.metrics.on_decode_step()

    def _finish(self, e: SchedEntry, finished: List[int]) -> None:
        self.metrics.on_finish(e.req.rid)
        self.sched.finish(e)
        finished.append(e.req.rid)

    # ------------------------------------------------------------------
    # legacy fixed-slot mode

    def _init_slots(self) -> None:
        scfg = self.scfg
        self.alloc = kv_cache.SlotAllocator(scfg.max_batch)
        self.cache = self.model.init_cache(scfg.max_batch, scfg.max_seq,
                                           device=self.device)
        self._active: Dict[int, Request] = {}
        self._done_at_admit: List[int] = []    # finished during prefill

    def _finish_slot(self, req: Request) -> None:
        req.done = True
        self.alloc.release(req.rid)
        self._active.pop(req.rid, None)
        self.metrics.on_finish(req.rid)

    def _add_request_slots(self, req: Request) -> bool:
        slot = self.alloc.alloc(req.rid)
        if slot is None:
            return False
        self._requests[req.rid] = req
        self._active[req.rid] = req
        prompt = np.asarray(req.prompt, np.int32).reshape(-1)
        self.metrics.on_arrival(req.rid, len(prompt))
        # prefill into a batch-1 cache, then splice that row into the live
        # cache at ``slot`` (slots advance independently via lens[b])
        tmp = self.model.init_cache(1, len(prompt), device=self.device)
        with torch.no_grad():
            logits, tmp = self.model.prefill(
                self.params, torch.tensor(prompt[None], device=self.device),
                tmp)
        self._merge_slot(tmp, slot, len(prompt))
        tok, lp = sampling.sample_np(logits[0, 0].cpu().numpy(),
                                     sampling.effective_params(req.sampling))
        status = self._append_token(req, tok, lp)
        if status != "stop":
            self.metrics.on_first_token(req.rid)
        if status != "ok":                     # same checks the paged
            self._finish_slot(req)             # path makes after prefill
            self._done_at_admit.append(req.rid)
        return True

    def _merge_slot(self, tmp: dict, slot: int, prompt_len: int) -> None:
        """Write tmp's single row into row ``slot`` of the live cache, in
        place. Positions past the prompt are zeroed, so the row ends as the
        reference's splice of a fresh max_seq-long cache leaves it."""
        for name, leaf in self.cache["units"]["b0"].items():
            leaf[:, slot, :prompt_len] = tmp["units"]["b0"][name][:, 0]
            leaf[:, slot, prompt_len:] = 0
        self.cache["lens"][slot] = prompt_len

    def _step_slots(self) -> List[int]:
        """One batched decode step across all slots (idle slots decode a
        padding token that nobody reads)."""
        finished = self._done_at_admit
        self._done_at_admit = []
        if not self._active:
            return finished
        reqs = list(self._active.values())
        slots = {req.rid: self.alloc.active[req.rid] for req in reqs}
        tok = np.zeros((self.scfg.max_batch, 1), np.int32)
        for req in reqs:
            tok[slots[req.rid], 0] = req.tokens_out[-1]
        with torch.no_grad():
            logits, self.cache = self.model.decode_step(
                self.params, torch.tensor(tok, device=self.device),
                self.cache)
        tok_np, lp_np = self._sample_rows(logits[:, 0])
        done_now = []
        for req in reqs:
            slot = slots[req.rid]
            status = self._append_token(req, int(tok_np[slot]), lp_np[slot])
            if status != "stop":
                self.metrics.on_token(req.rid)
            if status != "ok":
                self._finish_slot(req)
                done_now.append(req.rid)
        self.metrics.on_decode_step()
        return finished + done_now
