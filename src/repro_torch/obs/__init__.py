"""Tracing and telemetry for the serving stack (the port's copy of the
reference's ``obs``).

  trace     Tracer / NULL_TRACER: per-tick phase spans (schedule ->
            draft -> batch_assemble -> device_dispatch -> device_wait ->
            sample_sync -> postprocess), request lifecycle events, per-tick
            host/device/padding aggregates; a tick's device time comes
            from CUDA events around its steps on the card. Disabled mode
            is a shared no-op singleton.
  registry  Counter/Gauge/Histogram registry that the engine, scheduler,
            pool, prefix cache and spec metrics register into;
            ``metrics.summary()`` and every exporter read from it.
  export    Perfetto/Chrome-trace JSON (one lane per engine phase, one per
            request), JSONL structured log, Prometheus text and a scrape
            endpoint on localhost.
  costmodel Static cost of the serving step per width bucket, counted from
            shapes: totals and the per-scope split.
  profile   Roofline attainment (ObsConfig.profile): static cost joined
            with the ticks' device time, per bucket, against the active
            chip's spec (roofline.hw).

Turn on with ``ServeConfig(obs=ObsConfig(enabled=True))``; greedy output
is token-identical with tracing on or off (tracing observes, it never
schedules).
"""

from repro_torch.obs.export import (perfetto_trace, start_metrics_server,
                                    write_jsonl, write_perfetto)
from repro_torch.obs.profile import ServingProfiler, attainment_table
from repro_torch.obs.registry import Counter, Gauge, Histogram, Registry
from repro_torch.obs.trace import (NULL_TRACER, Event, NullTracer, Span,
                                   Tracer, make_tracer)

__all__ = [
    "Counter", "Event", "Gauge", "Histogram", "NULL_TRACER", "NullTracer",
    "Registry", "ServingProfiler", "Span", "Tracer", "attainment_table",
    "make_tracer", "perfetto_trace", "start_metrics_server",
    "write_jsonl", "write_perfetto",
]
