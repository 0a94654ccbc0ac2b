"""The port's tracing and telemetry (repro_torch.obs) on the CPU, against
the reference's (repro.obs), and what the port adds to it.

The same seeded prompts go through the reference's engine and the port's
(``device="cpu"``, the reference's weights through
``weights.from_jax_params``) with ``ObsConfig(enabled=True)``, in the
paged sync, speculative (n-gram), async overlap (K = 1), async loop
(K = 8), prefix-cached and slot engines. Each request's lifecycle events
(name, tick and attributes), the integer tick attributes tick for tick,
the summary keys, the registry's counters and the Prometheus exposition
(names and labels; values wherever they are not times) must be equal;
the port's additions (each request's queue wait, the engine's seconds by
phase, the graph work's own phase) are listed exactly. Beside them: the
tracer core, the counting tier (phases that tile each tick, each
request's phase seconds, no wait added by tracing), token identity with
tracing on and off, the exporters against ``tools/check_trace.py``, the
registry, the metrics endpoint and the async engine's attribution.
"""

import gc
import importlib.util
import json
import os
import time
import urllib.request
import weakref

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs.base import AsyncConfig as JaxAsyncConfig
from repro.configs.base import ObsConfig as JaxObsConfig
from repro.configs.base import ServeConfig as JaxServeConfig
from repro.configs.base import SpecConfig as JaxSpecConfig
from repro.models import Model as JaxModel
from repro.serve.engine import Engine as JaxEngine
from repro.serve.scheduler import Request as JaxRequest
from repro_torch.configs import get_config as torch_get_config
from repro_torch.configs.base import (AsyncConfig, ObsConfig, ServeConfig,
                                      SpecConfig)
from repro_torch.obs import (PHASES, CountingTracer, Registry, Tracer,
                             make_tracer, perfetto_trace,
                             start_metrics_server, write_jsonl,
                             write_perfetto)
from repro_torch.obs.registry import escape_help, escape_label_value
from repro_torch.obs.trace import DeviceClock
from repro_torch.serve import metrics as metrics_mod
from repro_torch.serve.engine import Engine
from repro_torch.serve.runner import DECODE
from repro_torch.serve.scheduler import Request
from repro_torch.weights import from_jax_params

_TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools", "check_trace.py")
_spec = importlib.util.spec_from_file_location("check_trace", _TOOLS)
check_trace = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(check_trace)


def _check_port_ordering(path, tmp_path):
    """``check_trace``'s async ordering (``--expect-ordering``) on the
    port's JSONL, its ``graph_dispatch`` spans (the async ticks' graph
    work) counted as the dispatch of their tick: every ``sample_sync``
    starts after the dispatch of the tick it reconciles closed."""
    with open(path) as f:
        recs = [json.loads(ln) for ln in f if ln.strip()]
    for r in recs:
        if r["kind"] == "span" and r["name"] == "graph_dispatch":
            r["name"] = "device_dispatch"
    out = tmp_path / ("ordering." + os.path.basename(path))
    out.write_text("".join(json.dumps(r) + "\n" for r in recs))
    return check_trace.check_jsonl(str(out), expect_ordering=True)

# what the port's summary adds to the reference's: the requests' queue
# wait and the window's seconds by engine phase
PORT_SUMMARY_KEYS = {"queue_wait_p50_ms", "queue_wait_p99_ms",
                     "engine_phase_s"}
# ... and its registry: the queue wait's histogram and a counter a phase
PORT_METRICS = {"request_queue_wait_seconds"} | {
    f'engine_phase_seconds_total{{phase="{p}"}}' for p in PHASES}
PORT_TYPES = {"# TYPE request_queue_wait_seconds histogram",
              "# TYPE engine_phase_seconds_total counter"}
# the phases the port's ticks add to the reference's: the graph work of
# the async ticks (the reference's jitted dispatch is device_dispatch)
PORT_TICK_PHASES = {"overlap": {"graph_dispatch"},
                    "loop": {"graph_dispatch"}}

# the integer (and categorical) tick attributes held equal tick for tick
TICK_KEYS = ("rows_prefill", "rows_decode", "rows_verify", "width",
             "valid_tokens", "pad_waste_frac", "device_ticks", "async_mode")

BASE = dict(max_batch=2, max_seq=64, block_size=8, prefill_chunk=16)
# (serve config keywords, prompt lengths, max_new) of each engine case
CASES = {
    "paged": (dict(paged=True), [5, 40, 21], 8),
    "preempt": (dict(paged=True, prefill_chunk=8, n_kv_blocks=8),
                [20, 20], 16),
    "spec": (dict(paged=True, max_seq=96, spec=dict(drafter="ngram", k=3)),
             [12, 12, 12], 10),
    "overlap": (dict(paged=True,
                     async_cfg=dict(enabled=True, max_device_ticks=1)),
                [5, 9, 14], 10),
    "loop": (dict(paged=True,
                  async_cfg=dict(enabled=True, max_device_ticks=8)),
             [5, 9, 14], 10),
    "prefix": (dict(paged=True, prefix_cache=True), None, 6),
    "slot": (dict(paged=False), [5, 9, 14], 8),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch intra-op thread for the module (many small ops beside
    other test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def nectar():
    cfg = get_config("nectar-relu-llama-1.7m")
    jparams = JaxModel(cfg).init(jax.random.PRNGKey(0))
    tcfg = torch_get_config(cfg.name)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return cfg, jparams, tcfg, tparams


def _prompts(cfg, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, size=int(n), dtype=np.int32)
            for n in lengths]


def _case_prompts(cfg, lengths):
    if lengths is not None:
        return _prompts(cfg, lengths)
    # a shared 24-token system prompt: prefix hits and copy-on-write
    rng = np.random.default_rng(3)
    system = rng.integers(0, cfg.vocab, 24, dtype=np.int32)
    return [np.concatenate([system, s]) for s in _prompts(cfg, [3, 7, 5])]


def _scfg(side, kw, obs):
    kw = dict(BASE, **kw)
    S, O, A, SC = ((ServeConfig, ObsConfig, AsyncConfig, SpecConfig)
                   if side == "port" else
                   (JaxServeConfig, JaxObsConfig, JaxAsyncConfig,
                    JaxSpecConfig))
    if "async_cfg" in kw:
        kw["async_cfg"] = A(**kw["async_cfg"])
    if "spec" in kw:
        kw["spec"] = SC(**kw["spec"])
    return S(obs=O(**obs), **kw)


def _serve(nectar, side, case, obs=(("enabled", True),)):
    cfg, jparams, tcfg, tparams = nectar
    kw, lengths, max_new = CASES[case]
    prompts = _case_prompts(cfg, lengths)
    scfg = _scfg(side, kw, dict(obs))
    if side == "port":
        eng = Engine(tcfg, tparams, scfg, device="cpu")
        reqs = [Request(rid=i, prompt=p, max_new=max_new)
                for i, p in enumerate(prompts)]
    else:
        eng = JaxEngine(cfg, jparams, scfg)
        reqs = [JaxRequest(rid=i, prompt=p, max_new=max_new)
                for i, p in enumerate(prompts)]
    done = eng.run(reqs, max_steps=2000)
    return {i: [int(t) for t in r.tokens_out] for i, r in done.items()}, eng


_RUNS = {}


def _pair(nectar, case):
    """The reference's and the port's traced serve of ``case`` (cached:
    several tests read each pair)."""
    if case not in _RUNS:
        _RUNS[case] = (_serve(nectar, "ref", case),
                       _serve(nectar, "port", case))
    return _RUNS[case]


def _timelines(tracer, rids):
    return {rid: [(e.name, e.tick, dict(e.attrs or {}))
                  for e in tracer.timeline(rid)] for rid in rids}


def _prom(text):
    """Prometheus exposition -> ({series: value}, {TYPE lines})."""
    series, types = {}, set()
    for line in text.splitlines():
        if line.startswith("# TYPE"):
            types.add(line)
        elif line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            series[name] = float(value)
    return series, types


def _timed(name):
    """Series whose values are times (or rates and shares derived from
    them): histograms of seconds, the roofline gauges."""
    return "_seconds" in name or name.startswith("bucket_attainment")


# ---------------------------------------------------------------------------
# the port against the reference


@pytest.mark.parametrize("case", list(CASES))
def test_lifecycle_events_equal_the_reference(nectar, case):
    """Each request's (name, tick, attributes) sequence is the
    reference's: arrival, admitted, prefix_hit, prefill_chunk,
    first_token, preempted, replay_done, spec_draft/verify/rollback/
    resync, cow, finish."""
    (rtoks, ref), (ptoks, port) = _pair(nectar, case)
    assert ptoks == rtoks
    rids = sorted(rtoks)
    want = _timelines(ref.tracer, rids)
    got = _timelines(port.tracer, rids)
    assert got == want
    names = {n for tl in got.values() for n, _, _ in tl}
    assert {"arrival", "first_token", "finish"} <= names
    extra = {"preempt": {"preempted", "replay_done"},
             "spec": {"spec_draft", "spec_verify"},
             "prefix": {"prefix_hit"}}.get(case, set())
    assert extra <= names


@pytest.mark.parametrize("case", list(CASES))
def test_tick_attributes_equal_the_reference(nectar, case):
    (_, ref), (_, port) = _pair(nectar, case)
    assert port.tracer.n_ticks == ref.tracer.n_ticks > 0
    want = [{k: t.get(k) for k in TICK_KEYS} for t in ref.tracer.tick_stats]
    got = [{k: t.get(k) for k in TICK_KEYS} for t in port.tracer.tick_stats]
    assert got == want
    # a tick that waits for a step the tick before dispatched (the
    # deferred reconcile of overlap ticks) reads that step's device time,
    # which overlapped both ticks' host work
    deferred = {sp.tick for sp in port.tracer.spans
                if sp.name == "sample_sync"
                and sp.attrs.get("reconciles_tick", sp.tick) < sp.tick}
    for t in port.tracer.tick_stats:
        if t["tick"] in deferred:
            assert t["host_ms"] == pytest.approx(
                max(t["dur_ms"] - t["device_ms"], 0.0))
        else:
            assert t["host_ms"] + t["device_ms"] \
                == pytest.approx(t["dur_ms"])


@pytest.mark.parametrize("case", list(CASES))
def test_summary_and_registry_equal_the_reference(nectar, case):
    """The summary keys (``ticks`` and ``phase_ms_per_tick`` included),
    every registry counter and gauge, and the Prometheus exposition's
    names, labels and TYPE lines; values wherever they are not times. The
    port adds exactly ``PORT_SUMMARY_KEYS``, ``PORT_METRICS`` (with their
    series and ``PORT_TYPES``) and ``PORT_TICK_PHASES``."""
    (_, ref), (_, port) = _pair(nectar, case)
    rs, ps = ref.metrics.summary(), port.metrics.summary()
    assert set(ps) - set(rs) == PORT_SUMMARY_KEYS and set(rs) <= set(ps)
    assert {"ticks", "phase_ms_per_tick"} <= set(ps)
    assert set(ps["ticks"]) == set(rs["ticks"])
    for key in ("n_ticks", "n_device_ticks"):
        assert ps["ticks"][key] == rs["ticks"][key]
    assert set(ps["phase_ms_per_tick"]) \
        == set(rs["phase_ms_per_tick"]) | PORT_TICK_PHASES.get(case, set())
    assert set(ps["engine_phase_s"]) == set(PHASES)
    rc, pc = ref.metrics.registry.collect(), port.metrics.registry.collect()
    assert set(pc) - set(rc) == PORT_METRICS and set(rc) <= set(pc)
    assert pc["request_queue_wait_seconds"]["count"] == len(
        port.metrics.requests) > 0
    for name, v in rc.items():
        if isinstance(v, dict):            # a histogram
            assert pc[name]["count"] == v["count"], name
            if not _timed(name):
                assert pc[name] == v, name
        elif not _timed(name):
            assert pc[name] == v, name
    (rser, rtypes) = _prom(ref.metrics.registry.prometheus_text())
    (pser, ptypes) = _prom(port.metrics.registry.prometheus_text())
    added = {n for n in set(pser) - set(rser)
             if not n.startswith("request_queue_wait_seconds_")}
    assert added == PORT_METRICS - {"request_queue_wait_seconds"}
    assert set(rser) <= set(pser) and ptypes - rtypes == PORT_TYPES
    assert rtypes <= ptypes
    for name, v in rser.items():
        if not _timed(name) or name.endswith("_count"):
            assert pser[name] == v, name


def test_registry_counters_reconcile_with_spec_events(nectar):
    (_, _), (_, eng) = _pair(nectar, "spec")
    verifies = [e for e in eng.tracer.events if e.name == "spec_verify"]
    assert verifies
    reg = eng.metrics.registry
    assert sum(e.attrs["drafted"] for e in verifies) \
        == reg.value("spec_drafted_tokens_total")
    assert sum(e.attrs["emitted"] for e in verifies) \
        == reg.value("spec_emitted_tokens_total")
    for e in eng.tracer.events:
        if e.name == "spec_rollback":
            assert e.attrs["rejected"] > 0


@pytest.mark.parametrize("case", ["paged", "spec", "overlap", "loop",
                                  "slot"])
def test_greedy_tokens_identical_tracing_on_off(nectar, case):
    """Tracing observes, it never schedules."""
    off, _ = _serve(nectar, "port", case, obs=())
    on, eng = _serve(nectar, "port", case)
    assert on == off
    assert eng.tracer.n_ticks > 0 and eng.tracer.spans


# ---------------------------------------------------------------------------
# tracer core


def test_span_nesting_and_device_attribution():
    """Spans record at exit with their depth; a tick's device_ms is the
    device time of its clocks, read at its end (on the CPU the host time
    of the dispatch), host_ms the rest."""
    tr = Tracer(ObsConfig(enabled=True))
    with tr.tick():
        with tr.span("schedule"):
            with tr.span("admit"):
                pass
        with tr.span("device_dispatch"):
            clock = tr.device_clock(torch.device("cpu"))
            time.sleep(0.002)
            clock.stop()
        with tr.device_wait():
            pass
        tr.tick_attrs(width=4, pad_waste_frac=0.5)
    assert [s.name for s in tr.spans] == ["admit", "schedule",
                                          "device_dispatch", "device_wait",
                                          "tick"]
    by = {s.name: s for s in tr.spans}
    assert by["admit"].depth == 2 and by["schedule"].depth == 1
    assert by["tick"].depth == 0
    assert by["schedule"].t0 <= by["admit"].t0
    assert by["admit"].t1 <= by["schedule"].t1
    [t] = tr.tick_stats
    assert t["tick"] == 0 and t["width"] == 4
    assert 2.0 <= t["device_ms"] <= t["dur_ms"]
    assert t["device_ms"] <= (by["device_dispatch"].dur
                              + by["device_wait"].dur) * 1e3
    assert t["host_ms"] + t["device_ms"] == pytest.approx(t["dur_ms"])
    assert tr.tick_summary()["pad_waste_frac"] == 0.5


def test_unfenced_step_dispatches_without_a_wait(nectar):
    """``ModelRunner.step`` runs in its device_dispatch span and returns
    without a device_wait span: traced, its clock is read at the tick's
    end (on the CPU, done at once); with the counting tracer it makes no
    clock and only the phase total moves."""
    _, _, tcfg, tparams = nectar
    for obs in (ObsConfig(enabled=True), ObsConfig()):
        eng = Engine(tcfg, tparams, ServeConfig(paged=True, obs=obs,
                                                **BASE), device="cpu")
        runner, tr = eng.runner, eng.tracer
        batch = runner.new_batch(1, eng.pool.tables())
        batch.add_row(0, DECODE, [5], 0)
        before = tr.snapshot()
        with tr.tick():
            runner.step(batch)
        moved = {k for k, v in tr.phase_seconds(since=before).items() if v}
        assert moved == {"tick", "device_dispatch"}
        if obs.enabled:
            names = [s.name for s in tr.spans if s.tick == tr.n_ticks - 1]
            assert names.count("device_dispatch") == 1
            assert "device_wait" not in names and not tr._clocks
            assert tr.tick_stats[-1]["device_ms"] > 0
        else:
            assert tr.device_clock(eng.device) is None and tr.spans == ()


class _StubTimingEvent:
    """A CUDA timing event without a card: ``query`` reports its work done
    from the second poll on; ``synchronize`` and ``wait`` are waits, and
    counted; ``elapsed_time`` is 5 ms, and only once the end is done."""

    waits = 0

    def __init__(self, enable_timing=False):
        self.polls = 0

    def record(self, stream=None):
        pass

    def query(self):
        self.polls += 1
        return self.polls > 1

    def synchronize(self):
        type(self).waits += 1

    def wait(self, stream=None):
        type(self).waits += 1

    def elapsed_time(self, end):
        assert end.polls > 1, "a clock read before its end was done"
        return 5.0


def test_fence_off_makes_no_clock(monkeypatch):
    """The no-wait rule in the tracer: the counting tier makes no clock; a
    recording clock is never waited for. A step still running at its
    tick's end stays pending and is read at a later tick's end, into its
    own tick's entry."""
    monkeypatch.setattr(torch.cuda, "Event", _StubTimingEvent,
                        raising=False)
    monkeypatch.setattr(_StubTimingEvent, "waits", 0)
    assert CountingTracer().device_clock(torch.device("cuda")) is None
    tr = Tracer(ObsConfig(enabled=True))
    with tr.tick():
        clock = tr.device_clock(torch.device("cuda"))
        clock.stop()
    assert tr.tick_stats[0]["device_ms"] == 0.0 and tr._clocks == [clock]
    with tr.tick():
        pass
    first, second = tr.tick_stats
    assert first["device_ms"] == 5.0 and second["device_ms"] == 0.0
    assert first["host_ms"] == max(first["dur_ms"] - 5.0, 0.0)
    assert not tr._clocks and _StubTimingEvent.waits == 0


def test_device_clock_on_the_cpu_adds_dispatch_and_wait():
    """On the CPU a clock's device time is the host time of the step's
    dispatch (its ops run there): done at once, nothing to wait for."""
    tr = Tracer(ObsConfig(enabled=True))
    clock = DeviceClock(tr, events=False)
    time.sleep(0.001)
    clock.stop()
    assert clock.done() and clock.seconds() >= 0.001
    assert tr._clocks == [clock]


def test_tracer_max_events_bound():
    tr = Tracer(ObsConfig(enabled=True, max_events=4))
    for i in range(10):
        tr.event(0, "e", i=i)
    assert len(tr.events) == 4 and tr.dropped == 6
    tr.reset()
    assert tr.dropped == 0 and not tr.events


def test_tick_summary_empty_is_none():
    s = Tracer(ObsConfig(enabled=True)).tick_summary()
    assert s["n_ticks"] == 0
    assert s["host_ms_per_tick"] is None
    assert s["device_ms_per_tick"] is None
    assert s["pad_waste_frac"] is None


def test_torch_annotations_open_profiler_ranges():
    tr = Tracer(ObsConfig(enabled=True, torch_annotations=True))
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.tick():
            with tr.span("schedule"):
                torch.ones(4).sum()
    assert any(e.key == "schedule" for e in prof.key_averages())


# ---------------------------------------------------------------------------
# the counting tier: phases that tile each tick, each request's record


def _port_engine(nectar, case, obs=None):
    """The port's engine of ``case`` (tracing off by default)."""
    _, _, tcfg, tparams = nectar
    kw, lengths, max_new = CASES[case]
    scfg = _scfg("port", kw, {} if obs is None else obs)
    return Engine(tcfg, tparams, scfg, device="cpu"), \
        _case_prompts(tcfg, lengths), max_new


def _tick_kind(before: dict, after: dict, had_pending: bool) -> str:
    """sync, reconcile (a sync tick that first commits an overlap tick's
    tokens), overlap or burst, from the async counters' deltas."""
    if after["loop_bursts"] > before["loop_bursts"]:
        return "burst"
    if after["overlap_ticks"] > before["overlap_ticks"]:
        return "overlap"
    return "reconcile" if had_pending else "sync"


@pytest.mark.parametrize("case", ["paged", "overlap", "loop"])
def test_each_tick_kind_is_tiled_by_its_phases(nectar, case):
    """Every tick of every kind (sync, reconcile, overlap, burst) is tiled
    by the phase clock: its phases' seconds sum to its wall on the
    tracer's clock (to within 0.2 ms of a host clock around it), and the
    tick's own statements outside every phase (``tick``) take at most 5%
    of each kind's ticks. The last request arrives while the first two
    decode, so an async engine's next tick reconciles in a sync tick."""
    eng, prompts, max_new = _port_engine(nectar, case)
    tr = eng.tracer
    reqs = [Request(rid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)]
    kinds = {}
    step = eng.step

    def timed_step():
        before, pending = eng.async_stats(), eng._pending is not None
        t0, snap0 = time.perf_counter_ns(), tr.snapshot()
        out = step()
        snap1, t1 = tr.snapshot(), time.perf_counter_ns()
        d = {k: snap1[k] - snap0[k] for k in snap1}
        assert abs(sum(d.values()) - (t1 - t0)) < 200_000
        acc = kinds.setdefault(
            _tick_kind(before, eng.async_stats(), pending), [0, 0])
        acc[0] += sum(d.values())
        acc[1] += d["tick"]
        return out
    eng.step = timed_step
    for req in reqs[:2]:
        assert eng.add_request(req)
    for n in range(2000):
        if n == 4:
            assert eng.add_request(reqs[2])
        if n > 4 and not eng._busy():
            break
        eng.step()
    assert all(r.done for r in reqs)
    want = {"paged": {"sync"}, "overlap": {"sync", "reconcile", "overlap"},
            "loop": {"sync", "burst"}}[case]
    assert want <= set(kinds)
    for kind, (wall, rest) in kinds.items():
        assert rest <= 0.05 * wall, (kind, rest, wall)


class _ManualClock:
    """A phase clock that moves only when the test moves it."""

    def __init__(self):
        self.ns = 0

    def __call__(self):
        return self.ns


def test_request_phase_seconds_are_the_totals_difference(nectar):
    """A request's ``phase_s`` is the difference of the engine's phase
    totals between its admission and its finish. The clock moves only
    where the test moves it (3 ms in each forward step, inside
    device_dispatch; 1 ms in each sample launch, inside sample_sync; 0.5
    ms in each admission, inside admit), so each phase's seconds are also
    known from the steps a request lived through."""
    eng, prompts, max_new = _port_engine(nectar, "preempt")
    tr, clock = eng.tracer, _ManualClock()
    tr._now_ns = clock
    counts = {"steps": 0, "samples": 0, "admits": 0}
    seen = {}

    def moving(fn, key, ns):
        def call(*a, **kw):
            counts[key] += 1
            clock.ns += ns
            return fn(*a, **kw)
        return call
    model = eng.runner.model
    model.forward_step = moving(model.forward_step, "steps", 3_000_000)
    eng.sampler.launch = moving(eng.sampler.launch, "samples", 1_000_000)
    eng.sched.admit = moving(eng.sched.admit, "admits", 500_000)
    col = eng.metrics
    on_admit, on_finish = col.on_admit, col.on_finish

    def admit(rid):
        first = col.requests[rid].admitted_at is None
        on_admit(rid)
        if first:
            seen[rid] = [tr.snapshot(), dict(counts)]

    def finish(rid):
        on_finish(rid)
        seen[rid] += [tr.snapshot(), dict(counts)]
    col.on_admit, col.on_finish = admit, finish
    reqs = [Request(rid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)]
    done = eng.run(reqs, max_steps=2000)
    assert col.evictions > 0               # admitted again after a preempt
    for rid, req in done.items():
        t_a, n_a, t_f, n_f = seen[rid]
        r = req.metrics
        assert r.phase_s == {k: (t_f[k] - t_a[k]) / 1e9 for k in t_f}
        assert r.phase_s["device_dispatch"] == pytest.approx(
            3e-3 * (n_f["steps"] - n_a["steps"]))
        assert r.phase_s["sample_sync"] == pytest.approx(
            1e-3 * (n_f["samples"] - n_a["samples"]))
        assert r.phase_s["admit"] == pytest.approx(
            5e-4 * (n_f["admits"] - n_a["admits"]))


def test_request_record_stamps_ordered_and_kept_after_forget(nectar):
    """Through the StreamingServer with one slot and a queue of one: each
    request's submitted_at <= arrival <= admitted_at <= first_token_at <=
    finished_at; the two held in the server's backlog (queue full) count
    that wait (their arrival is later than their submit, their queue wait
    longer than the backlog); the record stays on the finished Request after
    ``result(forget=True)``; the summary and the registry show the queue
    waits and the window's phase totals."""
    from repro_torch.serve.api import StreamingServer
    _, _, tcfg, tparams = nectar
    eng = Engine(tcfg, tparams, ServeConfig(
        paged=True, max_batch=1, max_queue=1, max_seq=64, block_size=8,
        prefill_chunk=16), device="cpu")
    srv = StreamingServer(eng)
    rids = [srv.submit(p, max_new=4) for p in _prompts(tcfg, [6, 9, 5])]
    assert len(srv._backlog) == 2
    srv.drain()
    recs = {}
    for rid in rids:
        req = srv.result(rid, forget=True)
        r = recs[rid] = req.metrics
        assert rid not in eng.metrics.requests and r.rid == rid
        assert r.submitted_at <= r.arrival <= r.admitted_at \
            <= r.first_token_at <= r.finished_at
        assert r.queue_wait == r.admitted_at - r.submitted_at >= 0
        assert set(r.phase_s) == set(PHASES)
        assert r.phase_s["front_end"] > 0 and r.phase_s["admit"] > 0
    for held in (recs[rid] for rid in rids[1:]):
        assert held.arrival - held.submitted_at > 0
        assert held.queue_wait > held.arrival - held.submitted_at
    s = eng.metrics.summary()
    waits = sorted(r.queue_wait for r in recs.values())
    assert s["queue_wait_p50_ms"] == pytest.approx(waits[1] * 1e3)
    assert s["engine_phase_s"]["front_end"] > 0
    reg = eng.metrics.registry.collect()
    assert reg["request_queue_wait_seconds"]["count"] == 3
    assert reg['engine_phase_seconds_total{phase="device_dispatch"}'] \
        == s["engine_phase_s"]["device_dispatch"] > 0
    eng.reset_metrics()
    assert eng.metrics.summary()["queue_wait_p50_ms"] is None


@pytest.mark.parametrize("case", ["paged", "overlap", "loop"])
def test_recording_tracer_adds_no_wait(nectar, case, monkeypatch):
    """With tracing on, every step's clock takes timing events (stubbed:
    the CPU has none) and none is waited for; the ticks wait in
    ``device_wait`` exactly as often as with tracing off, and the tokens
    are the same."""
    monkeypatch.setattr(torch.cuda, "Event", _StubTimingEvent,
                        raising=False)
    monkeypatch.setattr(_StubTimingEvent, "waits", 0)
    waits, toks = {}, {}
    for label, obs in (("off", None), ("on", {"enabled": True})):
        eng, prompts, max_new = _port_engine(nectar, case, obs)
        tr = eng.tracer
        if obs is not None:
            tr.device_clock = lambda device, tr=tr: DeviceClock(tr, True)
        device_wait = tr.device_wait

        def counted(label=label, device_wait=device_wait):
            waits[label] = waits.get(label, 0) + 1
            return device_wait()
        tr.device_wait = counted
        done = eng.run([Request(rid=i, prompt=p, max_new=max_new)
                        for i, p in enumerate(prompts)], max_steps=2000)
        toks[label] = {i: list(r.tokens_out) for i, r in done.items()}
    assert toks["on"] == toks["off"]
    assert waits["on"] == waits["off"] > 0
    assert _StubTimingEvent.waits == 0
    timed = [t for t in tr.tick_stats if t["device_ms"] > 0]
    assert timed and all(t["device_ms"] % 5.0 == 0 for t in timed)


# ---------------------------------------------------------------------------
# the disabled fast path


def test_null_tracer_shared_singletons():
    """Tracing off, an engine gets its own CountingTracer (its totals are
    its own), whose hooks return one shared context manager: no Span,
    event or clock."""
    for cfg in (None, ObsConfig(enabled=False)):
        ct = make_tracer(cfg)
        assert type(ct) is CountingTracer and not ct.enabled
        assert ct.span("schedule", rows=2) is ct.span("admit") is ct.tick()
        assert ct.device_wait() is ct.tick()
        assert ct.device_clock(torch.device("cpu")) is None
        ct.event(0, "arrival")
        ct.tick_attrs(width=1)
        assert ct.events == () and ct.spans == () and ct.tick_stats == ()
    assert make_tracer(None) is not make_tracer(None)
    assert isinstance(make_tracer(ObsConfig(profile=True)), Tracer)


@pytest.mark.parametrize("case", ["paged", "loop"])
@pytest.mark.parametrize("enabled", [False, True])
def test_engine_leaves_no_reference_cycle(nectar, case, enabled):
    """An engine's runner, metrics collector and tracer go with the engine
    by reference counting alone, tracing on or off: none waits for the
    cyclic garbage collector, whose run may fall inside a later CUDA graph
    capture, where freeing another graph is not allowed."""
    cfg, _, tcfg, tparams = nectar
    kw, lengths, max_new = CASES[case]
    prompts = _case_prompts(cfg, lengths)
    gc.collect()
    gc.disable()
    try:
        eng = Engine(tcfg, tparams, _scfg("port", kw, dict(enabled=enabled)),
                     device="cpu")
        eng.run([Request(rid=i, prompt=p, max_new=max_new)
                 for i, p in enumerate(prompts)], max_steps=2000)
        refs = {name: weakref.ref(o) for name, o in (
            ("engine", eng), ("runner", eng.runner),
            ("metrics", eng.metrics), ("tracer", eng.tracer))}
        del eng
        assert {n: r() is None for n, r in refs.items()} \
            == dict.fromkeys(refs, True)
    finally:
        gc.enable()


def test_disabled_overhead_under_2pct(nectar):
    """The per-tick cost of the hooks with tracing off (one tick() and the
    span, event and device-clock calls a busy tick makes, through the
    counting tracer's phase clock) is < 2% of a real tick of the port's
    paged engine."""
    _, _, tcfg, tparams = nectar
    eng = Engine(tcfg, tparams, ServeConfig(paged=True, **BASE),
                 device="cpu")
    assert type(eng.tracer) is CountingTracer
    assert eng.runner.tracer is eng.tracer
    eng.run([Request(rid=i, prompt=p, max_new=4)
             for i, p in enumerate(_prompts(tcfg, [8, 8]))], max_steps=200)
    reqs = [Request(rid=10 + i, prompt=p, max_new=8)
            for i, p in enumerate(_prompts(tcfg, [8, 8], seed=1))]
    t0 = time.perf_counter()
    n_ticks = 0
    pending = list(reqs)
    while pending or eng._busy():
        while pending and eng.add_request(pending[0]):
            pending.pop(0)
        eng.step()
        n_ticks += 1
    tick_s = (time.perf_counter() - t0) / max(n_ticks, 1)
    N = 2000
    tr = eng.tracer
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    for _ in range(N):
        with tr.tick():
            with tr.span("schedule"):
                with tr.span("admit"):
                    tr.event(0, "admitted", slot=0)
            with tr.span("batch_assemble"):
                tr.tick_attrs(width=1, pad_waste_frac=0.0)
            with tr.span("device_dispatch", width=1, has_prefill=False):
                tr.device_clock(cpu)
            with tr.span("sample_sync", rows=2):
                with tr.device_wait():
                    pass
            with tr.span("postprocess"):
                tr.event(0, "first_token")
    hook_s = (time.perf_counter() - t0) / N
    assert hook_s < 0.02 * tick_s, (hook_s, tick_s)


# ---------------------------------------------------------------------------
# exporters


def test_exports_pass_check_trace(nectar, tmp_path):
    (_, _), (_, eng) = _pair(nectar, "paged")
    trace = perfetto_trace(eng.tracer, eng.metrics.registry)
    evs = [e for e in trace["traceEvents"] if e["ph"] != "M"]
    assert evs and all(b["ts"] >= a["ts"] for a, b in zip(evs, evs[1:]))
    lanes = {e["args"]["name"] for e in trace["traceEvents"]
             if e["ph"] == "M" and e.get("pid") == 1
             and e["name"] == "thread_name"}
    assert {"tick", "schedule", "device_dispatch", "device_wait",
            "sample_sync", "postprocess"} <= lanes
    assert trace["metadata"]["n_ticks"] == eng.tracer.n_ticks
    assert trace["metadata"]["metrics"]["request_finished_total"] == 3
    p = write_perfetto(eng.tracer, str(tmp_path / "t.trace.json"),
                       registry=eng.metrics.registry)
    assert check_trace.check_perfetto(p) == []
    j = write_jsonl(eng.tracer, str(tmp_path / "t.events.jsonl"))
    assert check_trace.check_jsonl(j, expect_ordering=True) == []
    assert _check_port_ordering(j, tmp_path) == []
    with open(j) as f:
        kinds = [json.loads(ln)["kind"] for ln in f]
    assert kinds[0] == "meta" and {"span", "event", "tick"} <= set(kinds)


def test_check_trace_fails_a_corrupted_export(nectar, tmp_path):
    """The port's files, corrupted: events out of order and a negative
    duration in the Perfetto file; a finish before its arrival and no
    meta header in the JSONL log."""
    (_, _), (_, eng) = _pair(nectar, "paged")
    p = write_perfetto(eng.tracer, str(tmp_path / "t.trace.json"))
    trace = json.load(open(p))
    spans = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    spans[0]["dur"] = -1.0
    trace["traceEvents"].reverse()
    json.dump(trace, open(p, "w"))
    errs = check_trace.check_perfetto(p)
    assert any("not monotonic" in e for e in errs)
    assert any("bad dur" in e for e in errs)
    j = write_jsonl(eng.tracer, str(tmp_path / "t.events.jsonl"))
    lines = open(j).read().splitlines()[1:]          # drop the meta line
    recs = [json.loads(ln) for ln in lines]
    for r in recs:
        if r["kind"] == "event" and r["rid"] == 0 and r["name"] == "finish":
            r["ts_us"] = -1.0
    open(j, "w").write("\n".join(json.dumps(r) for r in recs) + "\n")
    errs = check_trace.check_jsonl(j)
    assert any("precedes" in e for e in errs)
    assert any("no meta header" in e for e in errs)


@pytest.mark.parametrize("case", ["overlap", "loop"])
def test_async_attribution(nectar, case, tmp_path):
    """Overlap ticks defer their wait one tick: the blocking sample_sync
    names the dispatch tick (``reconciles_tick``); a burst records one
    tick with ``device_ticks`` = its iterations, and tick_summary
    normalizes per device tick. The JSONL passes --expect-ordering."""
    (_, _), (_, eng) = _pair(nectar, case)
    tr = eng.tracer
    st = eng.async_stats()
    if case == "overlap":
        deferred = [s for s in tr.spans if s.name == "sample_sync"
                    and "reconciles_tick" in s.attrs
                    and s.attrs["reconciles_tick"] < s.tick]
        assert deferred
        assert all(s.attrs["reconciles_tick"] == s.tick - 1
                   for s in deferred)
        overlap = [t for t in tr.tick_stats
                   if t.get("async_mode") == "overlap"]
        assert overlap and all(t["device_ticks"] == 1 for t in overlap)
    else:
        bursts = [t for t in tr.tick_stats if t.get("async_mode") == "loop"]
        assert bursts and any(t["device_ticks"] > 1 for t in bursts)
        assert sum(t["device_ticks"] for t in bursts) \
            == st["loop_device_ticks"]
        s = tr.tick_summary()
        assert s["n_device_ticks"] > s["n_ticks"]
        assert s["host_ms_per_tick"] == pytest.approx(
            sum(t["host_ms"] for t in tr.tick_stats) / s["n_device_ticks"])
        assert all(t["device_ms"] > 0 for t in bursts)
    j = write_jsonl(tr, str(tmp_path / "a.events.jsonl"))
    assert check_trace.check_jsonl(j, expect_ordering=True) == []
    assert _check_port_ordering(j, tmp_path) == []
    # a graph dispatch that closed after its tick's sample_sync began fails
    recs = [json.loads(ln) for ln in open(j)]
    spans = [r for r in recs if r["kind"] == "span"]
    syncs = {(r.get("attrs") or {}).get("reconciles_tick", r["tick"]): r
             for r in spans if r["name"] == "sample_sync"}
    g = next(r for r in spans if r["name"] == "graph_dispatch"
             and r["tick"] in syncs)
    g["dur_us"] = syncs[g["tick"]]["ts_us"] - g["ts_us"] + 1.0
    bad = tmp_path / "bad.events.jsonl"
    bad.write_text("".join(json.dumps(r) + "\n" for r in recs))
    errs = _check_port_ordering(str(bad), tmp_path)
    assert any("before that tick's device_dispatch closed" in e
               for e in errs)
    p = write_perfetto(tr, str(tmp_path / "a.trace.json"))
    assert check_trace.check_perfetto(p) == []


def test_slot_engine_timeline_and_summary(nectar):
    (_, _), (_, eng) = _pair(nectar, "slot")
    tr = eng.tracer
    assert {"tick", "device_dispatch", "device_wait", "sample_sync"} \
        <= {s.name for s in tr.spans}
    assert eng.metrics.summary()["ticks"]["n_ticks"] == tr.n_ticks


def test_reset_metrics_restarts_the_trace_window(nectar):
    _, _, tcfg, tparams = nectar
    eng = Engine(tcfg, tparams, ServeConfig(
        paged=True, obs=ObsConfig(enabled=True), **BASE), device="cpu")
    eng.run([Request(rid=0, prompt=_prompts(tcfg, [6])[0], max_new=3)])
    assert eng.tracer.n_ticks > 0
    eng.reset_metrics()
    assert eng.tracer.n_ticks == 0 and not eng.tracer.events
    assert eng.metrics.tracer is eng.tracer
    assert eng.metrics.summary()["ticks"]["n_ticks"] == 0


# ---------------------------------------------------------------------------
# the metrics endpoint


def test_metrics_server_serves_the_live_registry(nectar):
    (_, _), (_, eng) = _pair(nectar, "paged")
    srv = start_metrics_server(lambda: eng.metrics.registry, 0)
    try:
        host, port = srv.server_address
        assert host == "127.0.0.1"
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
            body = r.read().decode()
            ctype = r.headers["Content-Type"]
        assert ctype.startswith("text/plain")
        assert "request_finished_total 3" in body
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{port}/nope",
                                   timeout=10)
    finally:
        srv.shutdown()
        srv.server_close()


# ---------------------------------------------------------------------------
# the registry (the reference's cases, on the port's copy)


def test_registry_basics_and_parity():
    reg = Registry()
    c = reg.counter("x_events_total", help="things")
    c.inc()
    c.inc(3)
    assert reg.counter("x_events_total") is c
    reg.gauge("x_depth").set(7)
    reg.gauge_group("pool", lambda: {"free": 5, "name": "skip-me",
                                     "frag": 0.25})
    h = reg.histogram("x_wait_seconds", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 10.0):
        h.observe(v)
    snap = reg.collect()
    assert snap["x_events_total"] == 4 and snap["x_depth"] == 7
    assert snap["pool_free"] == 5 and snap["pool_frag"] == 0.25
    assert "pool_name" not in snap
    assert snap["x_wait_seconds"]["count"] == 3
    assert snap["x_wait_seconds"]["mean"] == pytest.approx(10.55 / 3)
    text = reg.prometheus_text()
    for line in ("# TYPE x_events_total counter", "x_events_total 4",
                 "# HELP x_events_total things",
                 'x_wait_seconds_bucket{le="0.1"} 1',
                 'x_wait_seconds_bucket{le="+Inf"} 3',
                 "x_wait_seconds_count 3", "pool_free 5"):
        assert line in text
    with pytest.raises(ValueError):
        reg.gauge("x_events_total")


def test_registry_dead_gauge_group_survives():
    reg = Registry()

    def boom():
        raise RuntimeError("gone")

    reg.gauge_group("dead", boom)
    reg.counter("ok_total").inc()
    assert reg.collect()["ok_total"] == 1
    assert "dead" not in reg.prometheus_text()


def test_prometheus_label_value_escaping():
    assert escape_label_value('sa"id') == 'sa\\"id'
    assert escape_label_value('a\\b') == 'a\\\\b'
    assert escape_label_value('two\nlines') == 'two\\nlines'
    assert escape_label_value('\\"') == '\\\\\\"'
    assert escape_help('why\\so\nserious "ok"') == \
        'why\\\\so\\nserious "ok"'
    reg = Registry()
    evil = 'req\\7 say "hi"\nplease'
    reg.labeled_gauge_group("bucket_attainment", "bucket",
                            lambda: {evil: {"attainment": 0.5}})
    text = reg.prometheus_text()
    assert ('bucket_attainment_attainment{bucket='
            '"req\\\\7 say \\"hi\\"\\nplease"} 0.5') in text
    assert "\nreq" not in text


def test_prometheus_labeled_gauges_repull():
    reg = Registry()
    pulls = {"n": 0}

    def fn():
        pulls["n"] += 1
        return {"decode": {"attain": pulls["n"]}}

    reg.labeled_gauge_group("bucket", "bucket", fn)
    t1 = reg.prometheus_text()
    assert t1.count("# TYPE bucket_attain gauge") == 1
    assert 'bucket_attain{bucket="decode"} 1' in t1
    assert 'bucket_attain{bucket="decode"} 2' in reg.prometheus_text()


# ---------------------------------------------------------------------------
# summary() of empty windows


def test_summary_zero_requests_is_null_not_zero(nectar):
    _, _, tcfg, _ = nectar
    col = metrics_mod.MetricsCollector(tcfg, ServeConfig(paged=True))
    s = col.summary()
    assert s["n_finished"] == 0
    for key in ("tokens_per_s", "ttft_p50_ms", "ttft_p99_ms",
                "latency_p50_ms", "tpot_p50_ms", "ttft_hit_p50_ms"):
        assert s[key] is None, key
    assert s["spec_acceptance_rate"] == 0.0
    assert s["prefix_hit_rate"] == 0.0
    assert "ticks" not in s


def test_summary_unfinished_requests_are_null(nectar):
    _, _, tcfg, _ = nectar
    col = metrics_mod.MetricsCollector(tcfg, ServeConfig(paged=True))
    col.on_arrival(0, 10)
    col.on_preemption(0)
    s = col.summary()
    assert s["n_finished"] == 0 and s["evictions"] == 1
    assert s["tokens_per_s"] is None and s["latency_p99_ms"] is None
    assert col.registry.value("request_arrivals_total") == 1
    assert col.registry.value("request_finished_total") == 0
