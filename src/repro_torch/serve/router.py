"""Fleet router: one front door over N engine replicas (the port's copy of
the reference's router).

The router owns request placement for a ``serve.fleet.Fleet``. Every
incoming request is scored against each routable replica and dispatched
to the winner; the caller-facing surface is the StreamingServer contract
(``submit`` returns a rid immediately, ``poll`` advances the fleet one
tick and returns per-request token deltas, ``result``/``busy``/
``drain_all``) so moving from one engine to a fleet is a constructor
swap, not an API migration.

Routing policy (``policy="affinity"``, the default) scores each
accepting replica as

    W_AFFINITY * matched_prefix_frac      # radix-probe: cached fraction
  + W_FREE     * free_block_frac          # KV headroom
  - W_LOAD     * queue_depth / max_batch  # waiting + running load

The affinity term dominates by construction: a replica that already
holds a request's prompt prefix in its radix index serves it with the
cached blocks (admission maps them and prefills only the suffix),
so routing TO the blocks converts a fleet of independent caches into
one partitioned cache — aggregate index capacity scales with replica
count instead of every replica thrashing over the same superset of
prefixes. ``round_robin`` (ignore state, cycle) and ``least_loaded``
(queue depth only) exist as baselines.

Session stickiness (``sticky_sessions``): a request carrying a session
id routes to the replica that served the session before — its KV blocks
for the shared turns are still indexed there — for as long as that
replica stays ACTIVE. A full sticky replica makes the request WAIT in
the router queue rather than migrate (migrating would re-prefill the
whole history elsewhere: worse than waiting one tick). A DRAINING or
removed replica breaks the binding: the request falls back to scored
routing and re-binds wherever it lands.

Overflow: when no replica can accept, requests queue AT THE ROUTER in
a bounded FIFO (surfaced as the ``fleet_queue_depth`` gauge) instead of
failing admission per-replica; past ``max_queue`` the router sheds with
``FleetSaturated`` — the caller's backpressure signal.

Parallel polling (``parallel=True``) ticks the busy replicas from a
thread pool. On one card that buys no device parallelism: the replicas
share its stream and the host's interpreter. It stays safe with async
replicas, whose runners capture CUDA graphs: a capture runs in
``capture_error_mode="thread_local"`` under the capture lock
(``kernels.build.CAPTURE_LOCK``), and the launch counters count each
thread's launches apart from another thread's open capture.
"""

from __future__ import annotations

import itertools
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.device import Devices, resolve_device
from repro_torch.obs.registry import Registry
from repro_torch.serve.engine import _to
from repro_torch.serve.fleet import Fleet, Replica
from repro_torch.serve.metrics import fleet_summary as _fleet_summary
from repro_torch.serve.sampling import SamplingParams

POLICIES = ("affinity", "round_robin", "least_loaded")

# affinity must dominate load at any realistic depth: a full-prefix hit
# (1.0) outweighs max_batch of queued work (W_LOAD), while W_FREE only
# breaks ties between equally-warm replicas
W_AFFINITY = 1.0
W_FREE = 0.1
W_LOAD = 0.25


class FleetSaturated(RuntimeError):
    """Every replica's admission is full AND the router queue is at its
    bound — the caller must back off (shed load upstream)."""


@dataclass
class _Pending:
    """A request waiting at the router for replica capacity."""
    rid: int
    prompt: np.ndarray
    max_new: int
    priority: int
    session: Optional[str]
    sampling: Optional[SamplingParams]
    pinned: Optional[int] = None     # sticky-wait: only this replica


@dataclass
class Decision:
    """One routing decision (a bounded log of them shows affinity
    steering traffic to the warm replica)."""
    rid: int
    replica: int
    policy: str
    reason: str                      # "affinity" | "sticky" | ...
    matched_tokens: int = 0
    score: float = 0.0
    queue_depth: int = 0
    extra: dict = field(default_factory=dict)


class Router:
    """Front-door placement over a Fleet, StreamingServer-shaped."""

    def __init__(self, fleet: Fleet, policy: str = "affinity",
                 max_queue: int = 512, sticky_sessions: bool = True,
                 parallel: bool = False, decision_log: int = 256):
        if policy not in POLICIES:
            raise ValueError(f"unknown router policy {policy!r}; "
                             f"known: {POLICIES}")
        self.fleet = fleet
        self.policy = policy
        self.max_queue = max_queue
        self.sticky = sticky_sessions
        self.parallel = parallel
        self._rids = itertools.count()
        self._rr = 0                             # round-robin cursor
        self._pending: deque = deque()
        self._placement: Dict[int, int] = {}     # rid -> replica id
        self.sessions: Dict[str, int] = {}       # session -> replica id
        self.decisions: deque = deque(maxlen=decision_log)
        self.registry = Registry()
        r = self.registry
        self._c_dispatched = r.counter("router_dispatched_total",
                                       "requests placed on a replica")
        self._c_queued = r.counter("router_queued_total",
                                   "requests that waited at the router")
        self._c_shed = r.counter("router_shed_total",
                                 "requests rejected (FleetSaturated)")
        self._c_sticky = r.counter("router_sticky_hits_total",
                                   "session requests kept on their replica")
        self._c_rerouted = r.counter(
            "router_session_rerouted_total",
            "session bindings broken by drain/removal")
        r.gauge_group("fleet", self._fleet_gauges)

    def _fleet_gauges(self) -> dict:
        return {
            "queue_depth": len(self._pending),
            "replicas_active": self.fleet.n_active,
            "replicas_live": len(self.fleet.live()),
        }

    # ------------------------------------------------------------------
    # placement

    def _score(self, rep: Replica, prompt: np.ndarray) -> tuple:
        matched = rep.probe(prompt) if self.policy == "affinity" else 0
        frac = matched / max(len(prompt), 1)
        score = (W_AFFINITY * frac + W_FREE * rep.free_block_frac
                 - W_LOAD * rep.queue_depth / max(self.fleet.scfg.max_batch,
                                                  1))
        # sort key: best score first, then shallowest queue, then lowest
        # id — deterministic placement for any probe outcome
        return (-score, rep.queue_depth, rep.id), matched, score

    def _pick(self, item: _Pending) -> Optional[Replica]:
        """Choose a replica for ``item`` or None (stay queued). Handles
        session bindings before policy scoring."""
        fleet = self.fleet
        if item.pinned is not None:
            rep = fleet.replicas.get(item.pinned)
            if rep is not None and rep.state.value == "active":
                if rep.accepting:
                    self._c_sticky.inc()
                    self._log(item.rid, rep, "sticky")
                    return rep
                return None                             # keep waiting
            item.pinned = None    # binding broken: fall through to the
            #                       sticky check, which unbinds the session
        if self.sticky and item.session is not None:
            bound = self.sessions.get(item.session)
            if bound is not None:
                rep = fleet.replicas.get(bound)
                if rep is not None and rep.state.value == "active":
                    if rep.accepting:
                        self._c_sticky.inc()
                        self._log(item.rid, rep, "sticky")
                        return rep
                    # sticky-wait: the session's blocks live here; wait
                    # for a slot rather than re-prefill the history on a
                    # cold replica
                    item.pinned = rep.id
                    return None
                # drained or removed: fall back to scored routing
                del self.sessions[item.session]
                self._c_rerouted.inc()
        candidates = [r for r in fleet.active() if r.accepting]
        if not candidates:
            return None
        if self.policy == "round_robin":
            order = fleet.active()
            for i in range(len(order)):
                rep = order[(self._rr + i) % len(order)]
                if rep.accepting:
                    self._rr = (self._rr + i + 1) % len(order)
                    self._log(item.rid, rep, "round_robin")
                    return rep
            return None
        if self.policy == "affinity":
            # hold-for-warm: score ALL active replicas first. If the
            # best one holds this prompt's prefix but is full, WAIT for
            # it (same reasoning as session sticky-wait: migrating
            # means re-prefilling the prefix cold elsewhere, which both
            # costs more than a tick of queueing AND duplicates the
            # family's blocks on a second replica, eroding the
            # partitioning that makes fleet cache capacity additive).
            best, _, best_m, best_s = self._best_scored(
                item, fleet.active())
            if best is not None and best_m > 0:
                if not best.accepting:
                    return None          # hold for the warm replica
                self._log(item.rid, best, "affinity_hit",
                          matched=best_m, score=best_s)
                return best
        best, best_key, best_m, best_s = self._best_scored(item, candidates)
        reason = "affinity_hit" if self.policy == "affinity" \
            and best_m > 0 else self.policy
        self._log(item.rid, best, reason, matched=best_m, score=best_s)
        return best

    def _best_scored(self, item: _Pending, candidates: List[Replica]):
        """Best (replica, sort key, matched tokens, score) for ``item``
        among ``candidates`` (all assumed accepting)."""
        best, best_key, best_m, best_s = None, None, 0, 0.0
        for rep in candidates:
            key, matched, score = self._score(rep, item.prompt)
            if best_key is None or key < best_key:
                best, best_key, best_m, best_s = rep, key, matched, score
        return best, best_key, best_m, best_s

    def _log(self, rid: int, rep: Replica, reason: str,
             matched: int = 0, score: float = 0.0) -> None:
        self.decisions.append(Decision(
            rid=rid, replica=rep.id, policy=self.policy, reason=reason,
            matched_tokens=matched, score=score,
            queue_depth=rep.queue_depth))

    def _dispatch(self, item: _Pending, rep: Replica) -> None:
        rep.server.submit(item.prompt, max_new=item.max_new,
                          priority=item.priority, rid=item.rid,
                          sampling=item.sampling)
        rep.dispatched += 1
        self._placement[item.rid] = rep.id
        if self.sticky and item.session is not None:
            self.sessions[item.session] = rep.id
        self._c_dispatched.inc()

    # ------------------------------------------------------------------
    # StreamingServer-shaped surface

    def submit(self, prompt, max_new: int = 16, priority: int = 0,
               session: Optional[str] = None,
               sampling: Optional[SamplingParams] = None) -> int:
        """Route one request; returns its fleet-wide rid immediately.
        ``session`` opts into stickiness. Raises ValueError for a prompt
        no replica can EVER serve (structurally too long — replicas are
        homogeneous, so one check covers the fleet) and FleetSaturated
        when every replica and the router queue are full."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) + 1 > self.fleet.scfg.max_seq:
            raise ValueError(
                f"prompt of {len(prompt)} tokens cannot fit "
                f"max_seq={self.fleet.scfg.max_seq} on any replica")
        rid = next(self._rids)
        item = _Pending(rid=rid, prompt=prompt, max_new=max_new,
                        priority=priority, session=session,
                        sampling=sampling)
        rep = self._pick(item)
        if rep is not None:
            self._dispatch(item, rep)
            return rid
        if len(self._pending) >= self.max_queue:
            self._c_shed.inc()
            raise FleetSaturated(
                f"all {self.fleet.n_active} active replica(s) saturated "
                f"and router queue at max_queue={self.max_queue}")
        self._pending.append(item)
        self._c_queued.inc()
        return rid

    def _retry_pending(self) -> None:
        """One placement pass over the whole router queue. The scan is
        full-width, not head-only: a sticky-waiting head pinned to a
        full replica must not wedge unpinned requests behind it.

        Under the affinity policy the pass matches requests to CAPACITY
        rather than walking FIFO order: when the fleet is saturated,
        replicas re-fill the instant a slot frees, so a FIFO walk hands
        the head to whichever replica freed first — no choice left, and
        placement degrades to arrival order (the hit rate then FALLS
        with fleet size). Instead, while any
        replica accepts, the queue dispatches the pending request with
        the strongest claim — longest radix-prefix match on its best
        replica, FIFO position breaking ties — turning the router queue
        into an affinity batching stage. A request no replica has warm
        yields to matched ones for a few ticks but cannot starve: every
        pass ends by placing unmatched work on whatever capacity is
        left, and the tie-break keeps those in FIFO order."""
        if not self._pending:
            return
        keep: deque = deque()
        if self.policy != "affinity":
            while self._pending:
                item = self._pending.popleft()
                rep = self._pick(item)
                if rep is not None:
                    self._dispatch(item, rep)
                else:
                    keep.append(item)
            self._pending = keep
            return
        # sticky / pinned items first, FIFO — their target is fixed, so
        # matching cannot improve on it
        loose: List[_Pending] = []
        while self._pending:
            item = self._pending.popleft()
            if item.pinned is not None or (
                    self.sticky and item.session is not None
                    and item.session in self.sessions):
                rep = self._pick(item)
                if rep is not None:
                    self._dispatch(item, rep)
                else:
                    keep.append(item)
            else:
                loose.append(item)
        # best-claim matching over the rest, with hold-for-warm: an
        # item whose warmest replica is full WAITS for it instead of
        # prefilling cold elsewhere (see _pick). The spill valve keeps
        # that from idling capacity: if every queued item is holding
        # while some replica sits IDLE, the oldest item spills onto it
        # — one duplicated prefix beats a dark replica.
        while loose:
            active = self.fleet.active()
            accepting = [r for r in active if r.accepting]
            if not accepting:
                break
            best = None          # ((-score, fifo pos), idx, rep, m, s)
            holding = False
            for i, item in enumerate(loose):
                if self.sticky and item.session is not None \
                        and item.session in self.sessions:
                    continue     # bound mid-pass by an earlier dispatch
                rep, key, m, s = self._best_scored(item, active)
                if not rep.accepting:
                    if m > 0:
                        holding = True
                        continue             # hold for the warm replica
                    rep, key, m, s = self._best_scored(item, accepting)
                k = (key[0], i)
                if best is None or k < best[0]:
                    best = (k, i, rep, m, s)
            if best is None:
                if not holding:
                    break        # only freshly-bound sessions remain
                idle = [r for r in accepting if r.idle]
                if not idle:
                    break        # all holds, no dark capacity: wait
                item = next((it for it in loose if not (
                    self.sticky and it.session is not None
                    and it.session in self.sessions)), None)
                if item is None:
                    break
                loose.remove(item)
                rep, _, m, s = self._best_scored(item, idle)
                self._log(item.rid, rep, "spill", matched=m, score=s)
                self._dispatch(item, rep)
                continue
            _, i, rep, m, s = best
            item = loose.pop(i)
            reason = "affinity_hit" if m > 0 else self.policy
            self._log(item.rid, rep, reason, matched=m, score=s)
            self._dispatch(item, rep)
        for item in loose:       # now-bound sessions route via _pick
            if self.sticky and item.session is not None \
                    and item.session in self.sessions:
                rep = self._pick(item)
                if rep is not None:
                    self._dispatch(item, rep)
                    continue
            keep.append(item)
        self._pending = keep

    def poll(self) -> Dict[int, List]:
        """One fleet tick: reap drained replicas, place queued requests,
        advance every live replica one engine tick, merge the deltas.
        rids are fleet-global, so the merged dict is collision-free."""
        for rep in self.fleet.reap():
            # a reaped replica's sessions can never be honored again;
            # drop the bindings now so the next turn re-routes cleanly
            stale = [s for s, b in self.sessions.items() if b == rep.id]
            for s in stale:
                del self.sessions[s]
                self._c_rerouted.inc()
        self._retry_pending()
        out: Dict[int, List] = {}
        busy = [r for r in self.fleet.live() if r.server.busy]
        if self.parallel and len(busy) > 1:
            with ThreadPoolExecutor(max_workers=len(busy)) as ex:
                for delta in ex.map(lambda r: r.server.poll(), busy):
                    out.update(delta)
        else:
            for rep in busy:
                out.update(rep.server.poll())
        return out

    def result(self, rid: int, forget: bool = False):
        """Finished request by fleet rid — found via the placement map,
        which keeps working after the replica is drained and removed
        (stopped replicas stay addressable for pickup)."""
        rep_id = self._placement.get(rid)
        if rep_id is None:
            return None
        rep = self.fleet.get(rep_id)
        if rep is None:
            return None
        req = rep.server.result(rid, forget=forget)
        if forget and req is not None:
            del self._placement[rid]
        return req

    @property
    def busy(self) -> bool:
        return bool(self._pending) \
            or any(r.server.busy for r in self.fleet.live())

    @property
    def queue_depth(self) -> int:
        """Requests waiting at the router (the fleet_queue_depth gauge)."""
        return len(self._pending)

    def drain_all(self, max_steps: int = 10000) -> Dict[int, object]:
        """Run the whole fleet to completion; returns finished requests
        keyed by fleet rid."""
        for _ in range(max_steps):
            if not self.busy:
                break
            self.poll()
        self.poll()      # final reap pass: ``busy`` goes False the tick
        #                  the last request finishes, before the drained-
        #                  and-now-idle replicas have been retired
        out = {}
        for rid in list(self._placement):
            req = self.result(rid)
            if req is not None:
                out[rid] = req
        return out

    # ------------------------------------------------------------------
    # introspection

    def fleet_summary(self) -> dict:
        """Aggregated fleet metrics (metrics.fleet_summary) plus the
        router's own counters. Stopped replicas' collectors are
        included — requests a drained replica finished still happened."""
        collectors = {}
        for rep in list(self.fleet.live()) \
                + list(self.fleet.stopped.values()):
            collectors[rep.id] = rep.engine.metrics
        out = _fleet_summary(collectors,
                             replica_info=self.fleet.health(),
                             fleet_queue_depth=len(self._pending))
        out["router"] = {
            "policy": self.policy,
            "dispatched": self._c_dispatched.value,
            "queued": self._c_queued.value,
            "shed": self._c_shed.value,
            "sticky_hits": self._c_sticky.value,
            "session_rerouted": self._c_rerouted.value,
            "sessions": len(self.sessions),
        }
        return out


def build_fleet(cfg, params, scfg, n_replicas: int = 2,
                policy: str = "affinity", disagg=None,
                device: Devices = None, **router_kw) -> Router:
    """Fleet + Router in one call (what ``launch.serve --replicas N``
    uses). ``disagg`` (a configs.base.DisaggConfig) makes every replica a
    disaggregated prefill/decode pool (serve.disagg.DisaggCoordinator)
    instead of a single Engine: the coordinator has the Engine surface
    the Replica wraps, so routing, stickiness and drain work unchanged.
    ``device`` defaults to CUDA, as Fleet's (a sequence of devices, one
    a shard, for mesh replicas)."""
    shards = list(device) if isinstance(device, (list, tuple)) else None
    device = resolve_device(shards[0] if shards else device)
    params = _to(params, device)
    factory = None
    if disagg is not None:
        from repro_torch.serve.disagg import DisaggCoordinator
        factory = lambda: DisaggCoordinator(  # noqa: E731
            cfg, params, scfg, dcfg=disagg, device=device)
    return Router(Fleet(cfg, params, scfg, n_replicas=n_replicas,
                        engine_factory=factory, device=shards or device),
                  policy=policy, **router_kw)


__all__ = ["Router", "FleetSaturated", "Decision", "build_fleet",
           "POLICIES"]
