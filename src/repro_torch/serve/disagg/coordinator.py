"""DisaggCoordinator: a dedicated prefill engine and a dedicated decode
engine with a paged-KV block handoff between them.

Request lifecycle::

    add_request -> prefill engine (chunked prefill, first token)
                -> park at State.HANDOFF (slot pinned, blocks held)
                -> kv_handoff: export_blocks -> import_blocks + block copy
                -> decode engine (RUNNING row, width-1 decode ticks)
                -> finish

The two phases have opposite rooflines: prefill is compute-bound, decode
weight-bandwidth-bound. On one engine, decode rows ride in prefill-width
batches whenever a prompt streams in; with an engine per phase the decode
engine's ticks stay width 1 whatever the prefill load.

The handoff moves a block table: the prefill pool exports its physical
block ids, the decode pool allocates fresh private blocks, and
``ModelRunner.import_blocks_from`` copies the storage rows across pools
(every leaf, int8 scales included, so quantized KV arrives bit for bit).
The copy runs in place on the current stream. Both engines live on one
device and issue on its one stream, so the copy is ordered after the
prefill steps that wrote the source blocks and before any later step
that reuses them: the coordinator needs no fence where the reference
waits on the copied pool (``jax.block_until_ready``), and adds none. The
decode engine's radix index takes over the matched prefix on adoption,
so decode-side multi-turn reuse still hits; ``DisaggConfig.
direct_max_suffix`` sends mostly-cached prompts straight to the decode
engine.

The coordinator has Engine's front-door surface (``new_rid``,
``can_serve``, ``add_request``, ``step``, ``run``, ``_requests``,
``metrics``), so ``serve.api.StreamingServer`` and a ``serve.fleet``
Replica wrap it unchanged: a disagg pool is one routable backend of the
router.

Identity caveat (as the fleet's): a non-speculative preemption replay
re-derives the generated tokens' KV through the dense prefill FFN, which
is not bit-identical; token identity holds where the pool fits the active
set.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.configs.base import DisaggConfig, ModelConfig, ServeConfig
from repro_torch.device import Devices, resolve_device
from repro_torch.obs import make_tracer
from repro_torch.serve.engine import Engine, _to
from repro_torch.serve.metrics import _ms, percentile
from repro_torch.serve.scheduler import Request, State


class _PoolView:
    """The combined block-pool capacity of both engines: what a fleet
    Replica's ``free_block_frac`` routing signal should see (the disagg
    backend is one unit of capacity, not two half-reports)."""

    def __init__(self, coord: "DisaggCoordinator"):
        self._coord = coord

    @property
    def n_free(self) -> int:
        return self._coord.prefill.pool.n_free \
            + self._coord.decode.pool.n_free

    @property
    def n_blocks(self) -> int:
        return self._coord.prefill.pool.n_blocks \
            + self._coord.decode.pool.n_blocks


class _PrefixView:
    """The better of both radix lookups, for the router's affinity probes:
    a prefix is warm here whether its blocks live on the decode engine
    (adopted or finished requests) or still on the prefill engine."""

    def __init__(self, coord: "DisaggCoordinator"):
        self._coord = coord

    def match(self, tokens, record: bool = False):
        best = ([], 0)
        for eng in (self._coord.decode, self._coord.prefill):
            if eng.prefix is not None:
                m = eng.prefix.match(tokens, record=record)
                if m[1] > best[1]:
                    best = m
        return best


class MergedCollector:
    """One metrics view over the coordinator's two engines, with both the
    single-engine surface (``summary()``, ``requests``) and the one
    ``metrics.fleet_summary`` reads (``window_start`` and the counter
    properties).

    A RequestMetrics record MOVES with its request (arrival and TTFT
    stamped at prefill, TPOT and finish at decode, one row end to end),
    so the decode collector holds nearly everything; requests that finish
    during prefill (a stop, or max_new=1) stay on the prefill collector
    and the merge covers them."""

    def __init__(self, coord: "DisaggCoordinator"):
        self._coord = coord

    @property
    def _p(self):
        return self._coord.prefill.metrics

    @property
    def _d(self):
        return self._coord.decode.metrics

    @property
    def registry(self):
        """The scrape target (Prometheus endpoint): the decode engine's
        registry, the side that carries the latency."""
        return self._d.registry

    @property
    def requests(self) -> Dict[int, object]:
        merged = dict(self._p.requests)
        merged.update(self._d.requests)
        return merged

    @property
    def window_start(self) -> Optional[float]:
        starts = [t for t in (self._p.window_start, self._d.window_start)
                  if t is not None]
        return min(starts) if starts else None

    @property
    def prefix_lookups(self) -> int:
        return self._p.prefix_lookups + self._d.prefix_lookups

    @property
    def prefix_hits(self) -> int:
        return self._p.prefix_hits + self._d.prefix_hits

    @property
    def prefix_cached_tokens(self) -> int:
        return self._p.prefix_cached_tokens + self._d.prefix_cached_tokens

    @property
    def prefill_chunks(self) -> int:
        return self._p.prefill_chunks + self._d.prefill_chunks

    @property
    def decode_steps(self) -> int:
        return self._p.decode_steps + self._d.decode_steps

    @property
    def evictions(self) -> int:
        return self._p.evictions + self._d.evictions

    def summary(self) -> dict:
        """The decode engine's summary (TPOT and the prefill-interference
        split live there), with the pool-wide counters and end-to-end
        latency percentiles recomputed over the MERGED request set (the
        queue waits too: a request is admitted on either engine), the
        handoff counters, and the prefill engine's own summary under
        ``"prefill_engine"``."""
        out = self._d.summary()
        waits = self._p.queue_waits() + self._d.queue_waits()
        done = [r for r in self.requests.values()
                if r.finished_at is not None]
        ttfts = [r.ttft for r in done if r.ttft is not None]
        lats = [r.latency for r in done if r.latency is not None]
        n_tok = sum(r.n_generated for r in done)
        t0 = self.window_start
        wall = (max(r.finished_at for r in done) - t0) \
            if done and t0 is not None else None
        out.update({
            "n_finished": len(done),
            "generated_tokens": n_tok,
            "tokens_per_s": (n_tok / wall) if wall else None,
            "ttft_p50_ms": _ms(percentile(ttfts, 50)),
            "ttft_p99_ms": _ms(percentile(ttfts, 99)),
            "latency_p50_ms": _ms(percentile(lats, 50)),
            "latency_p99_ms": _ms(percentile(lats, 99)),
            "queue_wait_p50_ms": _ms(percentile(waits, 50)),
            "queue_wait_p99_ms": _ms(percentile(waits, 99)),
            "prefill_chunks": self.prefill_chunks,
            "evictions": self.evictions,
            "prefix_lookups": self.prefix_lookups,
            "prefix_hits": self.prefix_hits,
            "prefix_hit_rate": (self.prefix_hits
                                / max(self.prefix_lookups, 1)),
            "prefix_cached_tokens": self.prefix_cached_tokens,
            "n_handoffs": self._coord.n_handoffs,
            "n_decode_direct": self._coord.n_decode_direct,
            "handoff_blocks": self._coord.handoff_blocks,
            "prefill_engine": self._p.summary(),
        })
        return out


class DisaggCoordinator:
    """Engine-shaped front door over a dedicated prefill engine and a
    dedicated decode engine (see the module docstring). Construct like an
    Engine plus an optional ``DisaggConfig``; ``device`` defaults to CUDA
    (both engines live on it; without a card it raises, asking for
    ``device="cpu"``). Drive it through ``add_request``/``step`` (or
    ``run``), or wrap it in a StreamingServer or a fleet Replica."""

    def __init__(self, cfg: ModelConfig, params: dict, scfg: ServeConfig,
                 dcfg: Optional[DisaggConfig] = None, drafter=None,
                 draft_params: Optional[dict] = None,
                 device: Devices = None):
        # under scfg.mesh ``device`` is the shards' sequence, which both
        # engines take; the params move to its first (home) device
        shards = list(device) if isinstance(device, (list, tuple)) else None
        self.device = resolve_device(shards[0] if shards else device)
        if not scfg.paged:
            raise ValueError("disaggregated serving requires the paged "
                             "engine (ServeConfig.paged=True): the handoff "
                             "is a paged-KV block transfer")
        self.cfg = cfg
        self.scfg = scfg
        self.dcfg = dcfg if dcfg is not None else DisaggConfig()
        # ONE tracer through both engines: a request's lifecycle (arrival
        # on the prefill engine ... finish on the decode engine) and the
        # kv_handoff spans land in one ordered record
        self.tracer = make_tracer(scfg.obs)
        # the weights move to the device once; both engines share them
        params = _to(params, self.device)
        # prefill engine: no speculation (drafting and verify are decode
        # work), optionally a smaller batch and pool: a request holds a
        # prefill slot only until its handoff
        pre_scfg = dataclasses.replace(
            scfg, spec=None,
            max_batch=self.dcfg.prefill_batch or scfg.max_batch,
            n_kv_blocks=self.dcfg.prefill_blocks or scfg.n_kv_blocks)
        self.prefill = Engine(cfg, params, pre_scfg,
                              device=shards or self.device,
                              tracer=self.tracer)
        self.decode = Engine(cfg, params, scfg, device=shards or self.device,
                             drafter=drafter, draft_params=draft_params,
                             tracer=self.tracer)
        self._requests: Dict[int, Request] = {}
        self._next_rid = 0
        self.n_handoffs = 0
        self.n_decode_direct = 0
        self.handoff_blocks = 0
        self.metrics = MergedCollector(self)
        self.pool = _PoolView(self)
        self.prefix = _PrefixView(self) \
            if (self.decode.prefix is not None
                or self.prefill.prefix is not None) else None

    # ------------------------------------------------------------------
    # Engine-shaped front door (StreamingServer / Replica)

    def new_rid(self) -> int:
        rid = self._next_rid
        while rid in self._requests:
            rid += 1
        self._next_rid = rid + 1
        return rid

    def can_serve(self, req: Request) -> bool:
        return self.decode.can_serve(req)

    @property
    def admission_free(self) -> int:
        """The router's accepting signal: intake headroom at the prefill
        engine's bounded queue (the front door for new work)."""
        return self.prefill.admission_free

    @property
    def queue_depth(self) -> int:
        """In-flight load across both engines (a request is on exactly one
        engine at a time; parked entries count on the prefill side until
        released)."""
        return (self.prefill.sched.n_waiting + self.prefill.sched.n_active
                + self.decode.sched.n_waiting + self.decode.sched.n_active)

    def add_request(self, req: Request) -> bool:
        """Place one request: straight onto the decode engine when its
        radix index already covers the prompt up to a
        ``direct_max_suffix`` tail (re-prefilling and re-copying blocks the
        decode pool holds would be waste), else onto the prefill engine
        for prefill and handoff. False = intake full (shed or retry), as
        Engine.add_request."""
        prev = self._requests.get(req.rid)
        if prev is not None and prev is not req and not prev.done:
            raise ValueError(
                f"request id {req.rid} is already in flight; use "
                f"new_rid() to allocate ids")
        if not self.can_serve(req):
            return False
        if self._decode_direct(req):
            if not self.decode.add_request(req):
                return False
            self.n_decode_direct += 1
        elif not self.prefill.submit_prefill(req):
            return False
        self._requests[req.rid] = req
        return True

    def _decode_direct(self, req: Request) -> bool:
        if self.dcfg.direct_max_suffix <= 0 \
                or self.decode.prefix is None \
                or req.sampling.prompt_logprobs:
            return False
        toks = np.asarray(req.prompt).reshape(-1)
        _, matched = self.decode.prefix.match(toks, record=False)
        return matched > 0 \
            and len(toks) - matched <= self.dcfg.direct_max_suffix

    def _busy(self) -> bool:
        return not self.prefill.sched.idle or not self.decode.sched.idle

    def step(self) -> List[int]:
        """One coordinator tick: at most one prefill-engine tick, the
        handoffs, then at most one decode-engine tick. Returns the rids
        finished on either engine."""
        finished: List[int] = []
        pre_sched = self.prefill.sched
        # the prefill tick runs only for work that is not parked (parked
        # HANDOFF entries keep the scheduler busy but need no tick)
        if pre_sched.waiting or any(e.state is not State.HANDOFF
                                    for e in pre_sched.active.values()):
            finished.extend(self.prefill.step())
        self._transfer_ready()
        # interference class: the decode engine's tokens this tick overlap
        # prefill iff the paired engine still has prefill in flight
        # (admitted chunks or waiting prompts)
        self.decode.external_prefill_overlap = bool(pre_sched.waiting) \
            or any(e.state is State.PREFILL
                   for e in pre_sched.active.values())
        if not self.decode.sched.idle:
            finished.extend(self.decode.step())
        return finished

    def _transfer_ready(self) -> None:
        """Move every exportable parked request to the decode engine. A
        packet that does not fit (decode slots or blocks exhausted) stays
        parked and retries next tick; a parked request preempted
        mid-handoff exports None and retries once its replay parks it
        again. No fence follows the copies (module docstring)."""
        ready = self.prefill.handoff_ready()
        if not ready:
            return
        moved = blocks = 0
        with self.tracer.span("kv_handoff", n_ready=len(ready)):
            for rid in ready:
                packet = self.prefill.export_handoff(rid)
                if packet is None:
                    continue
                if not self.decode.adopt_handoff(packet,
                                                 self.prefill.runner):
                    break                      # decode full: retry later
                self.prefill.release_handoff(rid)
                moved += 1
                blocks += len(packet.blocks)
        self.n_handoffs += moved
        self.handoff_blocks += blocks

    def forget(self, rid: int) -> None:
        req = self._requests.get(rid)
        if req is None or not req.done:
            return
        self.prefill.forget(rid)
        self.decode.forget(rid)
        del self._requests[rid]

    def run(self, requests: List[Request], max_steps: int = 256
            ) -> Dict[int, Request]:
        """Continuous-batching loop, as Engine.run."""
        pending = list(requests)
        done: Dict[int, Request] = {}
        steps = 0
        while (pending or self._busy()) and steps < max_steps:
            while pending and self.add_request(pending[0]):
                pending.pop(0)
            if pending and not self._busy():
                pending.pop(0)    # structurally unservable
            for rid in self.step():
                done[rid] = self._requests[rid]
            steps += 1
        return done

    def reset_metrics(self) -> None:
        """A fresh measurement window on both engines (see
        Engine.reset_metrics); the handoff counters restart with it. The
        shared tracer resets once per engine, which is idempotent."""
        self.prefill.reset_metrics()
        self.decode.reset_metrics()
        self.n_handoffs = 0
        self.n_decode_direct = 0
        self.handoff_blocks = 0


__all__ = ["DisaggCoordinator", "MergedCollector"]
