"""Metrics registry: shared counter/gauge/histogram substrate (the port's
copy of the reference's).

The registry is the single place the serving metrics live:
``metrics.summary()`` and the exporters (Prometheus text here, Perfetto
and JSONL in obs.export) read from it, so a new counter is visible
everywhere by construction.

Naming convention: ``<subsystem>_<noun>_<unit>``
with a ``_total`` suffix for monotonic counters — e.g.
``engine_decode_steps_total``, ``spec_drafted_tokens_total``,
``request_ttft_seconds`` (histogram). Subsystems: engine, sched, pool,
prefix, spec, traffic, request, mesh.

Gauge groups adapt the existing pull-style stats dicts: registering
``gauge_group("pool", pool.stats)`` exposes every key of ``stats()`` as
a ``pool_<key>`` gauge, evaluated at collect time — the pool keeps
owning its numbers, the registry owns discovery and export.

Labeled gauge groups are the two-level variant for per-entity series
(per width bucket, per request): ``labeled_gauge_group("bucket_
attainment", "bucket", fn)`` with ``fn() -> {label_value: {suffix:
value}}`` exposes ``bucket_attainment_<suffix>{bucket="<value>"}``.
Label VALUES pass through ``escape_label_value`` (backslash, quote,
newline — the Prometheus text-format escapes), so entity names the
registry doesn't control (request ids, bucket labels) can't corrupt
the exposition.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

# default latency buckets (seconds): 1ms .. ~33s, x2 steps
DEFAULT_BUCKETS = tuple(0.001 * 2 ** i for i in range(16))


def escape_label_value(v: str) -> str:
    """Prometheus text-format label-value escaping: backslash FIRST
    (escaping the escapes an earlier pass introduced would double
    them), then double-quote and newline."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def escape_help(v: str) -> str:
    """HELP-line escaping: backslash and newline only (quotes are legal
    in help text)."""
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


class Counter:
    """Monotonic counter. ``inc`` only; fractional increments allowed
    (byte counters)."""

    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0

    def inc(self, n=1) -> None:
        self.value += n


class Gauge:
    """Point-in-time value: ``set()`` for push style, ``fn`` for pull
    style (evaluated at collect time)."""

    __slots__ = ("name", "help", "fn", "_value")

    def __init__(self, name: str, help: str = "",
                 fn: Optional[Callable[[], float]] = None):
        self.name = name
        self.help = help
        self.fn = fn
        self._value = 0

    def set(self, v) -> None:
        self._value = v

    @property
    def value(self):
        return self.fn() if self.fn is not None else self._value


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics): ``le`` upper
    bounds plus +Inf, with ``sum`` and ``count``."""

    __slots__ = ("name", "help", "bounds", "counts", "sum", "count")

    def __init__(self, name: str, help: str = "",
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        self.name = name
        self.help = help
        self.bounds = tuple(sorted(buckets))
        self.counts = [0] * (len(self.bounds) + 1)   # last = +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.sum += v
        self.count += 1
        for i, b in enumerate(self.bounds):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def cumulative(self) -> List[Tuple[float, int]]:
        out, acc = [], 0
        for b, c in zip(self.bounds + (math.inf,), self.counts):
            acc += c
            out.append((b, acc))
        return out

    @property
    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None


class Registry:
    """Flat name -> metric map. ``counter``/``gauge``/``histogram`` are
    get-or-create (idempotent, so call sites don't coordinate);
    ``gauge_group`` splices a pull-style stats dict in under a prefix."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._groups: Dict[str, Callable[[], dict]] = {}
        # prefix -> (label name, fn() -> {label value: {suffix: value}},
        # Prometheus type)
        self._labeled: Dict[str, tuple] = {}

    def _get(self, cls, name: str, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, **kw)
        elif type(m) is not cls:
            raise ValueError(f"metric {name!r} already registered as "
                             f"{type(m).__name__}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help=help)

    def gauge(self, name: str, help: str = "",
              fn: Optional[Callable[[], float]] = None) -> Gauge:
        g = self._get(Gauge, name, help=help)
        if fn is not None:
            g.fn = fn
        return g

    def histogram(self, name: str, help: str = "",
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS
                  ) -> Histogram:
        return self._get(Histogram, name, help=help, buckets=buckets)

    def gauge_group(self, prefix: str, fn: Callable[[], dict]) -> None:
        """Expose every numeric key of ``fn()`` as ``<prefix>_<key>``
        gauges, re-evaluated at each collect. Non-numeric values are
        skipped (export formats are numeric)."""
        self._groups[prefix] = fn

    def labeled_gauge_group(self, prefix: str, label: str,
                            fn: Callable[[], dict]) -> None:
        """Per-entity gauge series: ``fn() -> {label_value: {suffix:
        value}}`` exposes ``<prefix>_<suffix>{<label>="<value>"}``
        gauges, re-evaluated at each collect/scrape. Label values are
        escaped at exposition time — callers pass raw strings."""
        self._labeled[prefix] = (label, fn, "gauge")

    def labeled_counter_group(self, prefix: str, label: str,
                              fn: Callable[[], dict]) -> None:
        """``labeled_gauge_group`` for monotonic per-entity totals (the
        engine's seconds by phase): exposed with the counter type."""
        self._labeled[prefix] = (label, fn, "counter")

    # --- reads ------------------------------------------------------------
    def _group_values(self) -> Dict[str, float]:
        out = {}
        for prefix, fn in self._groups.items():
            try:
                d = fn()
            except Exception:   # noqa: BLE001 — a dead gauge must not
                continue        # take down the whole scrape
            for k, v in d.items():
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                out[f"{prefix}_{k}"] = v
        return out

    def _labeled_series(self) -> List[tuple]:
        """Flattened labeled-group samples: (metric name, label name,
        raw label value, value, type), suffix-major so exposition can
        emit one TYPE line per metric name."""
        out: List[tuple] = []
        for prefix, (label, fn, kind) in self._labeled.items():
            try:
                d = fn()
            except Exception:   # noqa: BLE001 — a dead gauge must not
                continue        # take down the whole scrape
            series: Dict[str, List[tuple]] = {}
            for lv, metrics in d.items():
                if not isinstance(metrics, dict):
                    continue
                for k, v in metrics.items():
                    if isinstance(v, bool) \
                            or not isinstance(v, (int, float)):
                        continue
                    series.setdefault(f"{prefix}_{k}", []).append(
                        (str(lv), v))
            for name in sorted(series):
                for lv, v in sorted(series[name]):
                    out.append((name, label, lv, v, kind))
        return out

    def collect(self) -> Dict[str, object]:
        """Snapshot: {name: value} for counters/gauges (group gauges
        included), {name: {"sum","count","mean","buckets"}} for
        histograms."""
        out: Dict[str, object] = {}
        for name, m in self._metrics.items():
            if isinstance(m, Histogram):
                out[name] = {"sum": m.sum, "count": m.count,
                             "mean": m.mean,
                             "buckets": [(b, c) for b, c
                                         in m.cumulative()]}
            else:
                out[name] = m.value
        out.update(self._group_values())
        for name, label, lv, v, _ in self._labeled_series():
            out[f'{name}{{{label}="{escape_label_value(lv)}"}}'] = v
        return out

    def value(self, name: str, default=0):
        m = self._metrics.get(name)
        return default if m is None else m.value

    def prometheus_text(self) -> str:
        """Prometheus exposition format (text/plain; version 0.0.4)."""
        lines: List[str] = []
        for name, m in sorted(self._metrics.items()):
            if m.help:
                lines.append(f"# HELP {name} {escape_help(m.help)}")
            if isinstance(m, Counter):
                lines.append(f"# TYPE {name} counter")
                lines.append(f"{name} {m.value}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name} {m.value}")
            else:
                lines.append(f"# TYPE {name} histogram")
                for b, acc in m.cumulative():
                    le = "+Inf" if math.isinf(b) else repr(b)
                    lines.append(f'{name}_bucket{{le="{le}"}} {acc}')
                lines.append(f"{name}_sum {m.sum}")
                lines.append(f"{name}_count {m.count}")
        for name, v in sorted(self._group_values().items()):
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {v}")
        last = None
        for name, label, lv, v, kind in self._labeled_series():
            if name != last:
                lines.append(f"# TYPE {name} {kind}")
                last = name
            lines.append(
                f'{name}{{{label}="{escape_label_value(lv)}"}} {v}')
        return "\n".join(lines) + "\n"


__all__ = ["Counter", "DEFAULT_BUCKETS", "Gauge", "Histogram", "Registry",
           "escape_help", "escape_label_value"]
