"""Tracer: per-tick phase spans and per-request lifecycle timelines.

The engine is instrumented unconditionally: every tick runs under
``with tracer.tick():`` and every phase under ``with tracer.span(...):``.
The DEFAULT tracer is ``NULL_TRACER``, whose ``span``/``tick`` return a
shared no-op singleton: no allocation, no clock read, no CUDA event, no
host sync. ``ObsConfig(enabled=True)`` swaps in the recording ``Tracer``
(``make_tracer``), which is where all cost lives.

Attribution within one tick:

  device_ms = the device time of the tick's steps, measured by a
              ``DeviceClock`` around each step's device work and read in
              its ``device_wait`` span:
                * on a CUDA device, the time between two
                  ``torch.cuda.Event(enable_timing=True)`` recorded on the
                  runner's stream before the step's first launch and after
                  its last (a graph replay counts as its launches). The
                  eager step is issued one op at a time by the host, so
                  this span also holds the gaps in which the device waits
                  for the host: it is an UPPER bound on the device's busy
                  time, and an attainment computed from it
                  (``obs.profile``) a LOWER bound;
                * on the CPU, the host time inside the step's
                  ``device_dispatch`` and ``device_wait`` spans (the ops
                  run eagerly inside the dispatch);
  host_ms   = tick wall time - device_ms (at least 0).

A tick that reconciles an async overlap tick waits for, and so reads
the device time of, the step the tick before it dispatched: that device
work ran beside both ticks' host work by design, so there device_ms may
exceed the tick's wall and host_ms, clamped at 0, is not the rest of it.
Every other step is dispatched and waited for within one tick.

The reference reads device time as the duration of its ``device_wait``
span, around ``block_until_ready`` after jax's asynchronous dispatch of
one executable. The port's eager step does its work while the host
issues it, so that span would hold only the last kernels' tail on the
card and nothing on the CPU.

Each tick also records per-phase durations (``phases_ms``), the
engine's ``tick_attrs`` (row-kind counts, width, padding waste, live
keys) and ``device_ticks``.

Spans are recorded AT EXIT with (t0, t1, depth, tick); request events
record (rid, name, t, tick, attrs). Storage is bounded by
ObsConfig.max_events: past it, new entries are dropped and counted
(``dropped``), never silently wrapped (tools/check_trace.py warns on a
truncated trace).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import torch

from repro_torch.configs.base import ObsConfig


@dataclasses.dataclass
class Span:
    """One closed phase span. Times are seconds on the tracer's monotonic
    clock (``perf_counter``), relative to the tracer epoch."""
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


class _NullSpan:
    """The shared no-op context manager of the disabled path: one module
    instance, ``__slots__ = ()``, so entering a span allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled-mode tracer: every hook is a no-op returning shared
    singletons. The engine and the runner never branch on ``if tracer``;
    they call through, and this class makes that free."""

    __slots__ = ()
    enabled = False
    spans: tuple = ()
    events: tuple = ()
    tick_stats: tuple = ()
    dropped = 0

    def span(self, name, **attrs):
        return NULL_SPAN

    def tick(self):
        return NULL_SPAN

    def tick_attrs(self, **attrs):
        pass

    def event(self, rid, name, **attrs):
        pass

    def device_clock(self, device):
        return None

    def device_wait(self, clock):
        return NULL_SPAN

    def reset(self):
        pass


NULL_TRACER = NullTracer()


class DeviceClock:
    """The device time of one step (see the module docstring). ``stop``
    after the step's last launch; ``wait`` (inside the ``device_wait``
    span) blocks until the step's work is done; ``seconds`` then reads the
    span. Made only by a recording tracer with ``fence_device`` on."""

    __slots__ = ("_start", "_end", "_t0", "_dispatch_s", "_wait_s")

    def __init__(self, device: torch.device):
        self._start = self._end = None
        if device.type == "cuda":
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        self._t0 = time.perf_counter()
        self._dispatch_s = self._wait_s = 0.0

    def stop(self) -> None:
        if self._start is not None:
            self._end = torch.cuda.Event(enable_timing=True)
            self._end.record()
        self._dispatch_s = time.perf_counter() - self._t0

    def wait(self) -> None:
        t = time.perf_counter()
        if self._end is not None:
            self._end.synchronize()
        self._wait_s = time.perf_counter() - t

    def seconds(self) -> float:
        if self._end is not None:
            return self._start.elapsed_time(self._end) / 1e3
        return self._dispatch_s + self._wait_s


class _SpanCM:
    """Context manager recording one span on exit (enabled mode)."""

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
        self.t0 = tr._now() - tr.epoch
        return self

    def __exit__(self, *exc):
        tr = self.tr
        t1 = tr._now() - tr.epoch
        tr._depth -= 1
        if self.annot is not None:
            self.annot.__exit__(*exc)
        tr._phase_s[self.name] = tr._phase_s.get(self.name, 0.0) \
            + (t1 - self.t0)
        tr._record(Span(self.name, self.t0, t1, tr._depth, tr.n_ticks,
                        self.attrs))
        return False


class _DeviceWaitCM:
    """The ``device_wait`` span of ``Tracer.device_wait``."""

    __slots__ = ("tr", "clock", "span")

    def __init__(self, tr: "Tracer", clock: Optional[DeviceClock]):
        self.tr = tr
        self.clock = clock

    def __enter__(self):
        self.span = self.tr.span("device_wait")
        self.span.__enter__()
        return self

    def __exit__(self, *exc):
        if self.clock is not None:
            self.clock.wait()
        self.span.__exit__(*exc)
        if self.clock is not None:
            self.tr._device_s += self.clock.seconds()
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
        tr._depth += 1
        self.t0 = tr._now() - tr.epoch
        return self

    def __exit__(self, *exc):
        tr = self.tr
        t1 = tr._now() - tr.epoch
        tr._depth -= 1
        tick = tr.n_ticks
        tr._record(Span("tick", self.t0, t1, tr._depth, tick, None))
        dur = t1 - self.t0
        device = tr._device_s
        entry = {
            "tick": tick,
            "t0_s": self.t0,
            "dur_ms": dur * 1e3,
            "device_ms": device * 1e3,
            "host_ms": max(dur - device, 0.0) * 1e3,
            "phases_ms": {k: v * 1e3 for k, v in tr._phase_s.items()},
        }
        entry.update(tr._tick_attrs)
        tr.tick_stats.append(entry)
        tr.n_ticks = tick + 1
        return False


class Tracer:
    """The recording tracer (ObsConfig(enabled=True)).

    One per engine; not thread-safe (the tick loop is single-threaded host
    code). ``spans`` and ``events`` hold the raw record; ``tick_stats`` is
    the per-tick aggregate (host_ms, device_ms, padding waste, row counts)
    and the exporters (``obs.export``) turn the record into Perfetto and
    JSONL files."""

    _now = staticmethod(time.perf_counter)

    def __init__(self, cfg: Optional[ObsConfig] = None):
        self.cfg = cfg if cfg is not None else ObsConfig(enabled=True)
        self.enabled = True
        self.reset()

    # --- lifecycle --------------------------------------------------------
    def reset(self) -> None:
        """A fresh measurement window (``Engine.reset_metrics``); the epoch
        restarts, so exported timestamps are relative to the window."""
        self.epoch = self._now()
        self.spans: List[Span] = []
        self.events: List[Event] = []
        self.tick_stats: List[dict] = []
        self.n_ticks = 0
        self.dropped = 0
        self._depth = 0
        self._phase_s: Dict[str, float] = {}
        self._tick_attrs: dict = {}
        self._device_s = 0.0

    def _record(self, item) -> None:
        store = self.spans if type(item) is Span else self.events
        if len(self.spans) + len(self.events) >= self.cfg.max_events:
            self.dropped += 1
            return
        store.append(item)

    # --- spans ------------------------------------------------------------
    def span(self, name: str, **attrs):
        """Open a phase span; nests (depth tracked) and records on exit."""
        if not self.cfg.tick_spans:
            return NULL_SPAN
        return _SpanCM(self, name, attrs or None)

    def tick(self):
        """Open one engine-tick span; on exit a tick_stats entry with host
        and device attribution is folded."""
        if not self.cfg.tick_spans:
            return NULL_SPAN
        return _TickCM(self)

    def tick_attrs(self, **attrs) -> None:
        """Attach per-tick engine facts (row-kind counts, batch width,
        pad_waste_frac, ...) to the current tick's stats entry."""
        self._tick_attrs.update(attrs)

    # --- device time ------------------------------------------------------
    def device_clock(self, device: torch.device) -> Optional[DeviceClock]:
        """A started DeviceClock for one step on ``device``, or None when
        ``fence_device`` is off (no event, no wait)."""
        if not self.cfg.fence_device:
            return None
        return DeviceClock(device)

    def device_wait(self, clock: Optional[DeviceClock]):
        """The ``device_wait`` span: on exit it waits for ``clock``'s step
        (where there is one) and adds its device time to the current
        tick."""
        return _DeviceWaitCM(self, clock)

    # --- request timeline -------------------------------------------------
    def event(self, rid: int, name: str, **attrs) -> None:
        """One request-lifecycle instant on request ``rid``'s timeline."""
        if not self.cfg.timeline:
            return
        self._record(Event(rid, name, self._now() - self.epoch,
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
    """ObsConfig -> NULL_TRACER (disabled; the shared no-op singleton) or
    a fresh recording Tracer. ``profile`` implies tracing: attainment
    joins the static cost with the ticks' device time."""
    if cfg is None or not (cfg.enabled or cfg.profile):
        return NULL_TRACER
    return Tracer(cfg)


__all__ = ["DeviceClock", "Event", "NULL_SPAN", "NULL_TRACER", "NullTracer",
           "Span", "Tracer", "make_tracer"]
