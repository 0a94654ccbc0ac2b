"""Tracing and telemetry for the serving stack (the port's copy of the
reference's ``obs``).

  trace     CountingTracer (always on, one per engine): seconds by engine
            phase (front_end -> tick -> schedule/admit -> draft ->
            batch_assemble -> device_dispatch | graph_dispatch ->
            sample_sync -> device_wait -> postprocess), one clock read at
            each phase boundary, no span, event, CUDA event or wait.
            Tracer (``ObsConfig(enabled=True)``): the same totals plus
            per-tick phase spans, request lifecycle events and per-tick
            host/device/padding aggregates; a tick's device time comes
            from CUDA events around its steps on the card, read once the
            tick's own waits have passed them (tracing adds no wait).
            Every time is on ``time.perf_counter_ns`` (``now_s``), and the
            recording tracer's ``epoch_ns`` lays its spans over a device
            trace.
  registry  Counter/Gauge/Histogram registry that the engine, scheduler,
            pool, prefix cache and spec metrics register into;
            ``metrics.summary()`` and every exporter read from it. The
            phase totals are ``engine_phase_seconds_total{phase=...}``,
            each request's wait from submit to its first slot
            ``request_queue_wait_seconds``.
  export    Perfetto/Chrome-trace JSON (one lane per engine phase, one per
            request), JSONL structured log, Prometheus text and a scrape
            endpoint on localhost.
  costmodel Static cost of the serving step per width bucket, counted from
            shapes: totals and the per-scope split.
  profile   Roofline attainment (ObsConfig.profile): static cost joined
            with the ticks' device time, per bucket, against the active
            chip's spec (roofline.hw).

Turn the recording on with ``ServeConfig(obs=ObsConfig(enabled=True))``;
greedy output is token-identical with tracing on or off (tracing
observes, it never schedules or waits).
"""

from repro_torch.obs.export import (perfetto_trace, start_metrics_server,
                                    write_jsonl, write_perfetto)
from repro_torch.obs.profile import ServingProfiler, attainment_table
from repro_torch.obs.registry import Counter, Gauge, Histogram, Registry
from repro_torch.obs.trace import (PHASES, CountingTracer, Event, Span,
                                   Tracer, make_tracer, now_s)

__all__ = [
    "Counter", "CountingTracer", "Event", "Gauge", "Histogram", "PHASES",
    "Registry", "ServingProfiler", "Span", "Tracer", "attainment_table",
    "make_tracer", "now_s",
    "perfetto_trace", "start_metrics_server", "write_jsonl",
    "write_perfetto",
]
