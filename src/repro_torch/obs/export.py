"""Exporters: Chrome-trace/Perfetto JSON, JSONL event log, Prometheus
(the port's copy of the reference's).

Perfetto layout (open the file at https://ui.perfetto.dev or
chrome://tracing):

  * pid 1 "engine": one LANE (tid) per engine phase — front_end, tick,
    schedule, admit, draft, batch_assemble, device_dispatch,
    graph_dispatch, sample_sync, device_wait, postprocess — so the host's
    blocked time reads directly off the device_wait lane. Spans are
    complete ("X") events in microseconds.
  * pid 2 "requests": one lane per request id. Each request gets a
    whole-lifetime span (arrival -> finish/last event) plus thread-
    scoped instant ("i") events for every lifecycle step (admitted,
    prefix_hit, prefill_chunk, first_token, preempted, spec_verify,
    spec_rollback, cow, finish) with their attrs.

The JSONL log is the machine-readable twin: one JSON object per line,
``{"kind": "meta" | "span" | "event" | "tick", ...}`` with microsecond
timestamps relative to the tracer epoch — grep/jq-friendly, and what
tools/check_trace.py validates. Both files carry the epoch itself
(``epoch_ns``, a ``time.perf_counter_ns`` reading): ``epoch_ns + ts * 1e3``
is a timestamp on the host clock that a device trace's markers are
aligned to.
"""

from __future__ import annotations

import json
import threading
from typing import Optional

from repro_torch.obs.registry import Registry
from repro_torch.obs.trace import Tracer

ENGINE_PID = 1
REQUEST_PID = 2


def _us(t: float) -> float:
    return round(t * 1e6, 3)


def perfetto_trace(tracer: Tracer, registry: Optional[Registry] = None,
                   profiler=None) -> dict:
    """Tracer record -> Chrome trace-event JSON (dict; json.dump it).
    Events are sorted by timestamp (monotonic ts is asserted by
    tools/check_trace.py). Registry counters ride along in
    ``metadata`` so a trace file is self-describing. ``profiler`` (an
    obs.profile.ServingProfiler) adds per-tick COUNTER tracks ("C"
    events on the engine process: achieved_gflops / achieved_gbs /
    roofline_attainment) — the time-resolved view of the per-bucket
    attainment table."""
    events = []
    meta = [
        {"ph": "M", "pid": ENGINE_PID, "name": "process_name",
         "args": {"name": "engine"}},
        {"ph": "M", "pid": REQUEST_PID, "name": "process_name",
         "args": {"name": "requests"}},
    ]
    # --- engine phase lanes ---
    lanes = {}
    for s in tracer.spans:
        tid = lanes.get(s.name)
        if tid is None:
            tid = lanes[s.name] = len(lanes)
            meta.append({"ph": "M", "pid": ENGINE_PID, "tid": tid,
                         "name": "thread_name", "args": {"name": s.name}})
            meta.append({"ph": "M", "pid": ENGINE_PID, "tid": tid,
                         "name": "thread_sort_index",
                         "args": {"sort_index": tid}})
        ev = {"ph": "X", "pid": ENGINE_PID, "tid": tid, "name": s.name,
              "ts": _us(s.t0), "dur": _us(max(s.dur, 0.0)),
              "args": {"tick": s.tick, "depth": s.depth}}
        if s.attrs:
            ev["args"].update(s.attrs)
        events.append(ev)
    # --- request lanes ---
    first_last = {}
    for e in tracer.events:
        t0, t1 = first_last.get(e.rid, (e.t, e.t))
        first_last[e.rid] = (min(t0, e.t), max(t1, e.t))
    for rid, (t0, t1) in sorted(first_last.items()):
        meta.append({"ph": "M", "pid": REQUEST_PID, "tid": rid,
                     "name": "thread_name", "args": {"name": f"req {rid}"}})
        events.append({"ph": "X", "pid": REQUEST_PID, "tid": rid,
                       "name": f"req {rid}", "ts": _us(t0),
                       "dur": _us(max(t1 - t0, 0.0)),
                       "args": {"rid": rid}})
    for e in tracer.events:
        ev = {"ph": "i", "pid": REQUEST_PID, "tid": e.rid, "name": e.name,
              "ts": _us(e.t), "s": "t",
              "args": {"rid": e.rid, "tick": e.tick}}
        if e.attrs:
            ev["args"].update(e.attrs)
        events.append(ev)
    # --- roofline counter tracks (obs.profile) ---
    if profiler is not None:
        for name, t0, val in profiler.tick_counters(tracer.tick_stats):
            events.append({"ph": "C", "pid": ENGINE_PID, "name": name,
                           "ts": _us(t0),
                           "args": {"value": round(float(val), 6)}})
    events.sort(key=lambda ev: (ev["ts"], ev.get("dur", 0.0)))
    trace = {
        "traceEvents": meta + events,
        "displayTimeUnit": "ms",
        "metadata": {
            "tool": "repro_torch.obs",
            "epoch_ns": tracer.epoch_ns,
            "n_ticks": tracer.n_ticks,
            "dropped": tracer.dropped,
            "tick_summary": tracer.tick_summary(),
        },
    }
    if registry is not None:
        trace["metadata"]["metrics"] = {
            k: v for k, v in registry.collect().items()
            if isinstance(v, (int, float))}
    return trace


def write_perfetto(tracer: Tracer, path: str,
                   registry: Optional[Registry] = None,
                   profiler=None) -> str:
    with open(path, "w") as f:
        json.dump(perfetto_trace(tracer, registry, profiler=profiler), f)
    return path


def write_jsonl(tracer: Tracer, path: str) -> str:
    """Structured event log: meta header, then every span, request
    event, and per-tick stats entry as one JSON object per line."""
    with open(path, "w") as f:
        f.write(json.dumps({
            "kind": "meta", "tool": "repro_torch.obs",
            "epoch_ns": tracer.epoch_ns, "n_ticks": tracer.n_ticks,
            "n_spans": len(tracer.spans), "n_events": len(tracer.events),
            "dropped": tracer.dropped}) + "\n")
        for s in tracer.spans:
            rec = {"kind": "span", "name": s.name, "ts_us": _us(s.t0),
                   "dur_us": _us(max(s.dur, 0.0)), "depth": s.depth,
                   "tick": s.tick}
            if s.attrs:
                rec["attrs"] = s.attrs
            f.write(json.dumps(rec) + "\n")
        for e in tracer.events:
            rec = {"kind": "event", "rid": e.rid, "name": e.name,
                   "ts_us": _us(e.t), "tick": e.tick}
            if e.attrs:
                rec["attrs"] = e.attrs
            f.write(json.dumps(rec) + "\n")
        for t in tracer.tick_stats:
            f.write(json.dumps({"kind": "tick", **t}) + "\n")
    return path


# ---------------------------------------------------------------------------
# Prometheus scrape endpoint


def start_metrics_server(registry_fn, port: int, host: str = "127.0.0.1"):
    """Serve ``GET /metrics`` (Prometheus text format) on ``host:port``
    (localhost by default; port 0 takes a free one, read it back from
    ``server.server_address``) from a daemon thread. ``registry_fn`` is a
    zero-arg callable returning the CURRENT registry — the engine swaps
    registries on reset_metrics(), so the server must not capture one
    instance. Returns the HTTPServer; call ``.shutdown()`` and
    ``.server_close()`` to stop."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):                       # noqa: N802 (http API)
            if self.path.rstrip("/") not in ("", "/metrics"):
                self.send_response(404)
                self.end_headers()
                return
            body = registry_fn().prometheus_text().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):              # silence per-request noise
            pass

    srv = ThreadingHTTPServer((host, port), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


__all__ = ["ENGINE_PID", "REQUEST_PID", "perfetto_trace",
           "start_metrics_server", "write_jsonl", "write_perfetto"]
