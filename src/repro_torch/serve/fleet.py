"""Replica fleet: the lifecycle of N independent engine replicas.

NeCTAr scales by composing many small units behind one dispatch fabric;
the serving analogue is a FLEET of fixed-size ``Engine`` replicas behind
a front-door router (serve.router) instead of one ever-growing engine.
Each replica is a whole serving stack (its own scheduler, paged KV pool,
radix prefix index, metrics collector), so replicas share no mutable
state; they share only the read-only weights, which sit once on the
device.

This module owns the LIFECYCLE half:

  * ``spawn``: bring up a new replica (a fresh Engine over the shared
    params);
  * ``health``: per-replica state, queue depth, free KV blocks and
    admission headroom;
  * ``drain``: accept no new work, finish what is in flight; the router
    also stops steering prefix-affinity traffic to a drained replica;
  * ``remove``/``reap``: retire drained replicas once idle;
  * ``scale_down``: elastic shrink: ``dist.elastic.degrade_mesh`` gives
    the surviving replica count (the fleet is the outermost, replicated
    axis of the pod mesh; the model axis inside a replica never
    shrinks) and the excess replicas drain.

The scheduling half (which replica gets which request) lives in
serve.router; the two touch only through the small Replica surface
(``accepting``, ``probe``, ``queue_depth``, ``server``).
"""

from __future__ import annotations

import enum
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.device import Devices, resolve_device
from repro_torch.dist import elastic
from repro_torch.serve.api import StreamingServer
from repro_torch.serve.engine import Engine, _to


class ReplicaState(enum.Enum):
    ACTIVE = "active"        # routable: accepts new requests
    DRAINING = "draining"    # finishes in-flight work, accepts nothing new
    STOPPED = "stopped"      # removed from the fleet (kept for result pickup)


class Replica:
    """One serving replica: an Engine (or an Engine-shaped backend such as
    the disagg coordinator) and its streaming front end. The router talks
    to replicas only through this surface."""

    def __init__(self, replica_id: int, engine: Engine):
        self.id = replica_id
        self.engine = engine
        self.server = StreamingServer(engine)
        self.state = ReplicaState.ACTIVE
        self.dispatched = 0          # requests routed here (router bumps)

    # --- routing signals ---------------------------------------------------
    @property
    def accepting(self) -> bool:
        """True when the router may hand this replica a new request:
        ACTIVE and the engine's admission queue has headroom. A DRAINING
        replica never accepts."""
        return self.state is ReplicaState.ACTIVE \
            and self.engine.admission_free > 0

    @property
    def queue_depth(self) -> int:
        """In-flight load: waiting + active requests on this replica.
        Backends that span several schedulers (the disagg coordinator)
        report their own combined depth."""
        qd = getattr(self.engine, "queue_depth", None)
        if qd is not None:
            return qd
        sched = getattr(self.engine, "sched", None)
        if sched is None:
            return len(self.engine._requests)
        return sched.n_waiting + sched.n_active

    @property
    def free_block_frac(self) -> float:
        pool = getattr(self.engine, "pool", None)
        if pool is None:
            return 0.0
        return pool.n_free / max(pool.n_blocks, 1)

    @property
    def idle(self) -> bool:
        return not self.server.busy

    def probe(self, prompt) -> int:
        """Prefix-affinity probe: the tokens of ``prompt`` whose KV this
        replica's radix index already holds (0 without a prefix cache).
        A DRAINING replica reports 0: its prefixes stop attracting traffic
        the moment the drain starts. ``record=False`` keeps the router's
        probes out of the replica's hit-rate counters."""
        if self.state is not ReplicaState.ACTIVE:
            return 0
        prefix = getattr(self.engine, "prefix", None)
        if prefix is None:
            return 0
        _, matched = prefix.match(np.asarray(prompt).reshape(-1),
                                  record=False)
        return matched

    def health(self) -> dict:
        return {
            "state": self.state.value,
            "accepting": self.accepting,
            "busy": self.server.busy,
            "queue_depth": self.queue_depth,
            "admission_free": self.engine.admission_free,
            "free_block_frac": self.free_block_frac,
            "dispatched": self.dispatched,
        }


class Fleet:
    """N independent Engine replicas sharing read-only params.

    One (cfg, params, scfg) triple builds every replica, so any replica
    can serve any request and the router's admissibility check holds
    fleet-wide. ``device`` defaults to CUDA (every replica's engine lives
    there; without a card it raises, asking for ``device="cpu"``); the
    params move there once. Replicas of a ``scfg.mesh`` take ``device``
    as a sequence of devices, one a shard, the first the home device.
    ``engine_factory`` builds a replica's backend instead (build_fleet
    passes a disagg coordinator's)."""

    def __init__(self, cfg, params, scfg, n_replicas: int = 1,
                 engine_factory: Optional[Callable[[], Engine]] = None,
                 device: Devices = None):
        shards = list(device) if isinstance(device, (list, tuple)) else None
        self.device = resolve_device(shards[0] if shards else device)
        if not scfg.paged:
            raise ValueError("the serving fleet routes over paged engines "
                             "(ServeConfig.paged=True): the slot engine "
                             "has no admission queue or prefix index to "
                             "route by")
        self.cfg = cfg
        self.params = _to(params, self.device)
        self.scfg = scfg
        self._factory = engine_factory or (
            lambda: Engine(cfg, self.params, scfg,
                           device=shards or self.device))
        self.replicas: Dict[int, Replica] = {}
        self.stopped: Dict[int, Replica] = {}
        self._next_id = 0
        for _ in range(max(n_replicas, 1)):
            self.spawn()

    # --- lifecycle ---------------------------------------------------------
    def spawn(self) -> Replica:
        """Bring up one new replica (elastic scale-up)."""
        rep = Replica(self._next_id, self._factory())
        self.replicas[rep.id] = rep
        self._next_id += 1
        return rep

    def get(self, replica_id) -> Optional[Replica]:
        """Replica by id, live or stopped (stopped replicas stay
        addressable so finished results remain retrievable)."""
        rep = self.replicas.get(replica_id)
        return rep if rep is not None else self.stopped.get(replica_id)

    def live(self) -> List[Replica]:
        """Replicas that still need polling: ACTIVE + DRAINING, id order."""
        return [self.replicas[i] for i in sorted(self.replicas)]

    def active(self) -> List[Replica]:
        """Routable replicas (the only ones new traffic may reach)."""
        return [r for r in self.live()
                if r.state is ReplicaState.ACTIVE]

    def drain(self, replica_id: int) -> Replica:
        """Start draining: the replica finishes its in-flight requests but
        accepts no new ones and stops advertising its prefixes."""
        rep = self.replicas[replica_id]
        if rep.state is ReplicaState.ACTIVE:
            rep.state = ReplicaState.DRAINING
        return rep

    def remove(self, replica_id: int, force: bool = False) -> bool:
        """Retire a DRAINING replica once idle. ``force`` skips the idle
        check (a crash: in-flight work is lost as a dead host loses it)."""
        rep = self.replicas.get(replica_id)
        if rep is None:
            return False
        if not force and not (rep.state is ReplicaState.DRAINING
                              and rep.idle):
            return False
        rep.state = ReplicaState.STOPPED
        self.stopped[replica_id] = self.replicas.pop(replica_id)
        return True

    def reap(self) -> List[Replica]:
        """Remove every drained and idle replica, then re-pin surviving
        sharded replicas (``reshard_surviving``): the scale-down's last
        step."""
        removed = [r for r in self.live()
                   if r.state is ReplicaState.DRAINING and r.idle]
        for rep in removed:
            self.remove(rep.id)
        if removed:
            self.reshard_surviving()
        return removed

    # --- elastic scaling ---------------------------------------------------
    def scale_down(self, n_failed: int = 1) -> List[int]:
        """Elastic shrink by ``n_failed`` replicas: the pod mesh is
        (replicas, model_shards) with replicas outermost, so
        ``degrade_mesh`` gives the surviving replica count (floored at
        one: the fleet never drains its last replica). The youngest
        replicas drain; ``reap`` retires them once idle."""
        n_live = len(self.live())
        model = self.scfg.mesh.model if self.scfg.mesh is not None else 1
        target = elastic.degrade_mesh((n_live, model), n_failed)[0]
        victims = sorted(self.replicas)[target:]
        for rid in victims:
            self.drain(rid)
        return victims

    def reshard_surviving(self) -> int:
        """Re-place each surviving mesh-sharded replica's weights with
        ``dist.elastic.reshard_params`` (pure data movement; values kept
        exactly) under the engine's own policy: the runner's placed params
        are replaced, the engine's whole ones stay. Meshless replicas
        have nothing to move. Returns the replicas resharded."""
        n = 0
        for rep in self.live():
            mesh = getattr(rep.engine, "mesh", None)
            if mesh is None:
                continue
            runner = rep.engine.runner
            runner.params = elastic.reshard_params(
                runner.params, self.cfg, mesh, policy=rep.engine._policy)
            n += 1
        return n

    # --- introspection -----------------------------------------------------
    def health(self) -> Dict[int, dict]:
        return {r.id: r.health() for r in self.live()}

    @property
    def n_active(self) -> int:
        return len(self.active())


__all__ = ["Fleet", "Replica", "ReplicaState"]
