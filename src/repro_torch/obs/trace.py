"""Tracer: the engine's phase totals, per-tick phase spans and per-request
lifecycle timelines.

The engine is instrumented unconditionally: every tick runs under
``with tracer.tick():``, every phase under ``with tracer.span(name):``,
and ``StreamingServer`` runs its own work under ``span("front_end")``.
There are two tiers, both on one clock (``time.perf_counter_ns``, the
clock ``now_s`` reads and the benchmark's device-trace markers are
aligned to):

  * counting (``CountingTracer``, the default, one per engine): running
    totals of nanoseconds by phase. Entering or leaving a phase reads the
    clock once and credits the time since the previous boundary to the
    phase being left, so each host statement inside a phase is credited
    to exactly one phase, the innermost open one (a tick's statements
    outside every phase below it to ``tick``). No ``Span`` object, no
    event, no CUDA event and no wait. The totals run for the tracer's
    life; a window (``serve.metrics``) or a request (its admission to its
    finish) takes their difference.
  * recording (``Tracer``, ``ObsConfig(enabled=True)``): the same totals,
    a ``Span`` for every phase, the requests' lifecycle events and a
    ``tick_stats`` entry per tick.

The phases (``PHASES``): ``front_end`` (``StreamingServer``'s submit and
poll outside ``engine.step``), ``tick``, ``schedule`` (admission control,
capacity, allocation, the async tick's choice) with ``admit`` (the
scheduler's admission) inside it, ``draft``, ``batch_assemble``,
``device_dispatch`` (the host issuing an eager step: ``ModelRunner.step``,
the slot engine's decode and prefill), ``graph_dispatch`` (graph work:
``decode_burst`` and ``graph_step``), ``sample_sync`` (the sampler's
launches and inputs), ``device_wait`` (the host blocked on the device:
the sampler's copy, ``HostCopy.wait``, the verify rows' logits),
``postprocess`` (commit, finish, the metrics) and ``kv_handoff`` (the
disagg coordinator's block moves).

Device time (recording tier): each step's ``DeviceClock`` is a pair of
``torch.cuda.Event(enable_timing=True)`` recorded on the runner's stream
before the step's first launch and after its last (a graph replay counts
as its launches); on the CPU, the host time of the step's dispatch (the
ops run eagerly inside it). A clock is never waited for: it is read at
the end of a tick once its end event has completed, which it has after
any wait the tick made past it (the sampler's copy, ``HostCopy.wait``),
and its time goes to the tick that dispatched the step. A step no wait
has passed yet (a prefill chunk that samples nothing, an overlap tick's
step) is read at a later tick's end, into its own tick's entry. The eager
step is issued one op at a time by the host, so the span also holds the
gaps in which the device waits for the host: an UPPER bound on the
device's busy time, and an attainment computed from it (``obs.profile``)
a LOWER bound. A tick's ``host_ms`` is its wall less its device time, at
least 0: a step whose device work ran past its tick (no wait in it) may
read longer than the tick.

Spans are recorded AT EXIT with (t0, t1, depth, tick), in seconds since
the tracer's ``epoch_ns`` (a ``perf_counter_ns`` reading, written by the
exporters): ``epoch_ns + t * 1e9`` lays a span over anything else on the
clock. Request events record (rid, name, t, tick, attrs). Storage is
bounded by ObsConfig.max_events: past it, new entries are dropped and
counted (``dropped``), never silently wrapped (tools/check_trace.py warns
on a truncated trace).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import torch

from repro_torch.configs.base import ObsConfig

PHASES = ("front_end", "tick", "schedule", "admit", "draft",
          "batch_assemble", "device_dispatch", "graph_dispatch",
          "sample_sync", "device_wait", "postprocess", "kv_handoff")


def now_s() -> float:
    """Seconds on the tracer's clock (``time.perf_counter_ns``)."""
    return time.perf_counter_ns() / 1e9


@dataclasses.dataclass
class Span:
    """One closed phase span. Times are seconds since the tracer's
    ``epoch_ns``."""
    name: str
    t0: float
    t1: float
    depth: int
    tick: int
    attrs: Optional[dict] = None

    @property
    def dur(self) -> float:
        return self.t1 - self.t0


@dataclasses.dataclass
class Event:
    """One request-lifecycle instant (arrival, first_token, ...)."""
    rid: int
    name: str
    t: float
    tick: int
    attrs: Optional[dict] = None


class CountingTracer:
    """The default tracer (tracing off): running totals of nanoseconds by
    phase (module docstring). Not thread-safe: one engine's tick loop
    drives it; ``phase_seconds`` may be read from another thread."""

    enabled = False
    spans: tuple = ()
    events: tuple = ()
    tick_stats: tuple = ()
    dropped = 0
    _now_ns = staticmethod(time.perf_counter_ns)

    def __init__(self):
        self._ns: Dict[Optional[str], int] = dict.fromkeys(PHASES, 0)
        self._cur: Optional[str] = None     # None: outside every phase
        self._stack: List[Optional[str]] = []
        self._t = self._now_ns()
        self._next: Optional[str] = None

    # --- the phase clock ---------------------------------------------------
    def _push(self, name: str, t: int) -> None:
        ns, cur = self._ns, self._cur
        ns[cur] = ns.get(cur, 0) + t - self._t
        self._stack.append(cur)
        self._cur, self._t = name, t

    def _pop(self, t: int) -> None:
        ns, cur = self._ns, self._cur
        ns[cur] = ns.get(cur, 0) + t - self._t
        self._cur, self._t = self._stack.pop(), t

    def snapshot(self) -> Dict[str, int]:
        """The totals (ns by phase) up to now, the open phase credited to
        now: read at a request's admission and finish."""
        t = self._now_ns()
        ns, cur = self._ns, self._cur
        ns[cur] = ns.get(cur, 0) + t - self._t
        self._t = t
        return {k: v for k, v in ns.items() if k is not None}

    def phase_seconds(self, since: Optional[Dict[str, int]] = None
                      ) -> Dict[str, float]:
        """Seconds by phase up to the last boundary, less ``since`` (a
        ``snapshot``) where given."""
        since = since or {}
        return {k: (v - since.get(k, 0)) / 1e9
                for k, v in list(self._ns.items()) if k is not None}

    # --- the hooks -----------------------------------------------------------
    def span(self, name: str, **attrs):
        """Enter phase ``name`` (nests; the innermost open phase is the one
        credited). The tracer is its own context manager: nothing is made,
        and nothing refers back to it (no cycle keeps it alive)."""
        self._next = name
        return self

    def __enter__(self):
        self._push(self._next, self._now_ns())
        return self

    def __exit__(self, *exc):
        self._pop(self._now_ns())
        return False

    def tick(self):
        return self.span("tick")

    def tick_attrs(self, **attrs) -> None:
        pass

    def event(self, rid: int, name: str, **attrs) -> None:
        pass

    def device_clock(self, device: torch.device):
        return None

    def device_wait(self):
        """The phase in which the host blocks on the device."""
        return self.span("device_wait")

    def reset(self) -> None:
        """A fresh window: the totals run on (windows take differences)."""


class DeviceClock:
    """The device time of one step (module docstring): made before the
    step's first launch, ``stop`` after its last. ``stop`` hands the clock
    to its tracer, which reads it once ``done``: nothing here waits."""

    __slots__ = ("_sink", "_now_ns", "_start", "_end", "_t0", "_s", "tick")

    def __init__(self, tr: "Tracer", events: bool):
        # the tracer's list of stopped clocks, not the tracer: a pending
        # clock makes no cycle with it
        self._sink, self._now_ns = tr._clocks, tr._now_ns
        self._start = self._end = None
        if events:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        self._t0 = self._now_ns()
        self._s = 0.0
        self.tick = tr.n_ticks

    def stop(self) -> None:
        if self._start is not None:
            self._end = torch.cuda.Event(enable_timing=True)
            self._end.record()
        self._s = (self._now_ns() - self._t0) / 1e9
        self._sink.append(self)

    def done(self) -> bool:
        return self._end is None or self._end.query()

    def seconds(self) -> float:
        if self._end is not None:
            return self._start.elapsed_time(self._end) / 1e3
        return self._s


class _SpanCM:
    """Context manager recording one span on exit (recording tier)."""

    __slots__ = ("tr", "name", "t0", "attrs", "annot")

    def __init__(self, tr: "Tracer", name: str, attrs: Optional[dict]):
        self.tr = tr
        self.name = name
        self.attrs = attrs
        self.annot = None

    def __enter__(self):
        tr = self.tr
        tr._depth += 1
        if tr.cfg.torch_annotations:
            self.annot = torch.profiler.record_function(self.name)
            self.annot.__enter__()
        self.t0 = tr._now_ns()
        tr._push(self.name, self.t0)
        return self

    def __exit__(self, *exc):
        tr = self.tr
        t1 = tr._now_ns()
        tr._pop(t1)
        tr._depth -= 1
        if self.annot is not None:
            self.annot.__exit__(*exc)
        if tr._in_tick:
            tr._phase_s[self.name] = tr._phase_s.get(self.name, 0.0) \
                + (t1 - self.t0) / 1e9
        tr._record(Span(self.name, (self.t0 - tr.epoch_ns) / 1e9,
                        (t1 - tr.epoch_ns) / 1e9, tr._depth, tr.n_ticks,
                        self.attrs))
        return False


class _TickCM:
    """Context manager for one engine tick: opens the ``tick`` span,
    resets the per-tick accumulators and folds a tick_stats entry (host
    and device attribution plus the engine's tick_attrs) on exit."""

    __slots__ = ("tr", "t0")

    def __init__(self, tr: "Tracer"):
        self.tr = tr

    def __enter__(self):
        tr = self.tr
        tr._phase_s = {}
        tr._tick_attrs = {}
        tr._device_s = 0.0
        tr._in_tick = True
        tr._depth += 1
        self.t0 = tr._now_ns()
        tr._push("tick", self.t0)
        return self

    def __exit__(self, *exc):
        tr = self.tr
        tr._read_clocks()
        t1 = tr._now_ns()
        tr._pop(t1)
        tr._depth -= 1
        tr._in_tick = False
        tick = tr.n_ticks
        t0, t1 = (self.t0 - tr.epoch_ns) / 1e9, (t1 - tr.epoch_ns) / 1e9
        tr._record(Span("tick", t0, t1, tr._depth, tick, None))
        dur = t1 - t0
        device = tr._device_s
        entry = {
            "tick": tick,
            "t0_s": t0,
            "dur_ms": dur * 1e3,
            "device_ms": device * 1e3,
            "host_ms": max(dur - device, 0.0) * 1e3,
            "phases_ms": {k: v * 1e3 for k, v in tr._phase_s.items()},
        }
        entry.update(tr._tick_attrs)
        tr.tick_stats.append(entry)
        tr.n_ticks = tick + 1
        return False


class Tracer(CountingTracer):
    """The recording tracer (ObsConfig(enabled=True)).

    One per engine (or one shared by a disagg pool's two engines); not
    thread-safe (the tick loop is single-threaded host code). ``spans``
    and ``events`` hold the raw record; ``tick_stats`` is the per-tick
    aggregate (host_ms, device_ms, padding waste, row counts) and the
    exporters (``obs.export``) turn the record into Perfetto and JSONL
    files."""

    enabled = True

    def __init__(self, cfg: Optional[ObsConfig] = None):
        super().__init__()
        self.cfg = cfg if cfg is not None else ObsConfig(enabled=True)
        self.reset()

    # --- lifecycle --------------------------------------------------------
    def reset(self) -> None:
        """A fresh measurement window (``Engine.reset_metrics``): the epoch
        restarts, so exported timestamps are relative to the window; the
        phase totals run on."""
        self.epoch_ns = self._now_ns()
        self.spans: List[Span] = []
        self.events: List[Event] = []
        self.tick_stats: List[dict] = []
        self.n_ticks = 0
        self.dropped = 0
        self._depth = 0
        self._phase_s: Dict[str, float] = {}
        self._tick_attrs: dict = {}
        self._device_s = 0.0
        self._in_tick = False
        self._clocks: List[DeviceClock] = []

    def _record(self, item) -> None:
        store = self.spans if type(item) is Span else self.events
        if len(self.spans) + len(self.events) >= self.cfg.max_events:
            self.dropped += 1
            return
        store.append(item)

    # --- spans ------------------------------------------------------------
    def span(self, name: str, **attrs):
        """Open a phase span; nests (depth tracked) and records on exit.
        With ``tick_spans`` off only the phase totals run."""
        if not self.cfg.tick_spans:
            return CountingTracer.span(self, name)
        return _SpanCM(self, name, attrs or None)

    def tick(self):
        """Open one engine-tick span; on exit a tick_stats entry with host
        and device attribution is folded."""
        if not self.cfg.tick_spans:
            return CountingTracer.span(self, "tick")
        return _TickCM(self)

    def tick_attrs(self, **attrs) -> None:
        """Attach per-tick engine facts (row-kind counts, batch width,
        pad_waste_frac, ...) to the current tick's stats entry."""
        self._tick_attrs.update(attrs)

    # --- device time ------------------------------------------------------
    def device_clock(self, device: torch.device) -> Optional[DeviceClock]:
        """A started DeviceClock for one step on ``device`` (None without
        ``tick_spans``: no tick entry would take its time)."""
        if not self.cfg.tick_spans:
            return None
        return DeviceClock(self, device.type == "cuda")

    def _read_clocks(self) -> None:
        """Read every stopped clock whose end has completed (no wait) into
        its own tick: the current one, or the entry already folded."""
        keep = []
        for c in self._clocks:
            if not c.done():
                keep.append(c)
            elif c.tick >= self.n_ticks:
                self._device_s += c.seconds()
            else:
                e = self.tick_stats[c.tick]
                e["device_ms"] += c.seconds() * 1e3
                e["host_ms"] = max(e["dur_ms"] - e["device_ms"], 0.0)
        self._clocks[:] = keep

    # --- request timeline -------------------------------------------------
    def event(self, rid: int, name: str, **attrs) -> None:
        """One request-lifecycle instant on request ``rid``'s timeline."""
        if not self.cfg.timeline:
            return
        self._record(Event(rid, name, (self._now_ns() - self.epoch_ns) / 1e9,
                           self.n_ticks, attrs or None))

    def timeline(self, rid: int) -> List[Event]:
        """Request ``rid``'s lifecycle events in time order."""
        return sorted((e for e in self.events if e.rid == rid),
                      key=lambda e: e.t)

    # --- aggregates -------------------------------------------------------
    def tick_summary(self) -> dict:
        """Means over tick_stats. Ticks that ran no device step still
        count. Per-tick costs are normalized by DEVICE ticks: an async
        burst of K iterations records one entry with ``device_ticks=K``,
        so host_ms_per_tick is host overhead per emitted decode step
        either way; other ticks count 1."""
        ts = self.tick_stats
        if not ts:
            return {"n_ticks": 0, "host_ms_per_tick": None,
                    "device_ms_per_tick": None, "pad_waste_frac": None}
        n = len(ts)
        ndev = sum(int(t.get("device_ticks", 1)) or 1 for t in ts)
        padded = [t["pad_waste_frac"] for t in ts
                  if t.get("pad_waste_frac") is not None]
        return {
            "n_ticks": n,
            "n_device_ticks": ndev,
            "host_ms_per_tick": sum(t["host_ms"] for t in ts) / ndev,
            "device_ms_per_tick": sum(t["device_ms"] for t in ts) / ndev,
            "pad_waste_frac": (sum(padded) / len(padded)) if padded
            else None,
        }

    def phase_ms_per_tick(self) -> Dict[str, float]:
        """Mean per-tick duration of each phase span."""
        if not self.tick_stats:
            return {}
        acc: Dict[str, float] = {}
        for t in self.tick_stats:
            for k, v in t["phases_ms"].items():
                acc[k] = acc.get(k, 0.0) + v
        return {k: v / len(self.tick_stats) for k, v in acc.items()}


def make_tracer(cfg: Optional[ObsConfig]):
    """ObsConfig -> a fresh CountingTracer (tracing off) or a fresh
    recording Tracer. ``profile`` implies tracing: attainment joins the
    static cost with the ticks' device time."""
    if cfg is None or not (cfg.enabled or cfg.profile):
        return CountingTracer()
    return Tracer(cfg)


__all__ = ["CountingTracer", "DeviceClock", "Event", "PHASES", "Span",
           "Tracer", "make_tracer", "now_s"]
