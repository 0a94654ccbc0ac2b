"""Driving the program: its engine built from a configuration, set-up,
the measured window of a closed loop of clients over
``StreamingServer.submit``/``poll``, and what the window leaves for the
readers and the correctness check.

The harness instruments the program from outside, around the calls into
its layers (``instrument``): the runner's eager step and decode burst, the
sampler's sync and the scheduler's admission. It records each device
step's shape in the window (for the padding, the operations and kernel
1's roofline) and, while the profiler runs, a host span around each call
(for naming the device's idle gaps). The program itself is not changed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from bench.harness import trace as trace_mod

PROFILE_TRIES = 3               # sub-windows a traced run may profile
KERNEL1 = "paged_attention_kernel"


class Recorder:
    """Steps and host spans, recorded from the harness's side."""

    def __init__(self):
        self.steps: List[tuple] = []        # in the window
        self.prof_steps: List[tuple] = []   # while profiling
        self.spans: List[tuple] = []
        self.recording = False      # steps, in the window
        self.spanning = False       # host spans and steps, while profiling
        self.tick_s: Dict[str, float] = {}  # window ticks' seconds by kind
        self.tick_n: Dict[str, int] = {}
        self._depth = 0
        self._last = ""

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.spanning:
            yield
            return
        t0 = time.perf_counter_ns()
        self._depth += 1
        try:
            yield
        finally:
            self._depth -= 1
            self.spans.append((name, t0, time.perf_counter_ns(),
                               self._depth))

    def step(self, batch) -> None:
        """An eager step: ("step", width, row starts, valid tokens, row
        phases)."""
        rec = ("step", int(batch.tokens.shape[1]), batch.row_start.copy(),
               batch.n_valid.copy(), batch.phase.copy())
        self._keep(rec)

    def burst(self, lens0, alive0, budget, k: int) -> None:
        """A decode burst of k iterations: ("burst", k, row starts, tokens
        each live row emits; no stops, so exactly its budget)."""
        n = np.where(np.asarray(alive0) > 0, np.asarray(budget), 0)
        self._keep(("burst", int(k), np.asarray(lens0).copy(),
                    n.astype(np.int64), None))

    def _keep(self, rec) -> None:
        self._last = f"eager width {rec[1]}" if rec[0] == "step" \
            else rec[0]
        if self.recording:
            self.steps.append(rec)
        if self.spanning:
            self.prof_steps.append(rec)

    @contextlib.contextmanager
    def tick(self):
        """An engine tick: its seconds, by the kind of device step it ran
        (window only)."""
        self._last = "no device step"
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.recording:
                k = self._last
                self.tick_s[k] = self.tick_s.get(k, 0.0) \
                    + time.perf_counter() - t0
                self.tick_n[k] = self.tick_n.get(k, 0) + 1


def signature(fn, names) -> inspect.Signature:
    """``fn``'s signature, checked to have the parameters the harness
    reads by name; a program whose call lost or renamed one stops the run
    here instead of being counted wrong."""
    sig = inspect.signature(fn)
    missing = [n for n in names if n not in sig.parameters]
    if missing:
        raise TypeError(
            f"bench: {getattr(fn, '__qualname__', fn)} has no parameter "
            f"{missing}; bench/harness/driver.py reads {list(names)} by "
            f"name: bring it up to date with the program")
    return sig


def instrument(engine, rec: Recorder) -> None:
    """Wrap the engine's calls into its layers (instance attributes only).
    Each wrapped call's arguments are bound by name to the program's own
    signature."""
    runner = engine.runner
    step, burst, gstep = runner.step, runner.decode_burst, runner.graph_step
    step_sig = signature(step, ("batch",))
    gstep_sig = signature(gstep, ("batch",))
    burst_sig = signature(burst, ("lens0", "alive0", "budget", "k_burst"))

    def traced_step(*a, **kw):
        rec.step(step_sig.bind(*a, **kw).arguments["batch"])
        with rec.span("runner.step (eager dispatch)"):
            return step(*a, **kw)

    def traced_burst(*a, **kw):
        b = burst_sig.bind(*a, **kw).arguments
        rec.burst(b["lens0"], b["alive0"], b["budget"], b["k_burst"])
        with rec.span("runner.decode_burst (graph replays)"):
            host = burst(*a, **kw)
        wait = host.wait

        def traced_wait():
            with rec.span("burst wait"):
                return wait()
        host.wait = traced_wait
        return host

    def traced_graph_step(*a, **kw):
        rec.step(gstep_sig.bind(*a, **kw).arguments["batch"])
        with rec.span("runner.graph_step"):
            return gstep(*a, **kw)

    runner.step, runner.decode_burst = traced_step, traced_burst
    runner.graph_step = traced_graph_step
    sample, admit = engine._sample_rows, engine.sched.admit

    def traced_sample(*a):
        with rec.span("sampler sync"):
            return sample(*a)

    def traced_admit(*a):
        with rec.span("scheduler admit"):
            return admit(*a)

    engine._sample_rows, engine.sched.admit = traced_sample, traced_admit
    engine_step = engine.step

    def traced_engine_step():
        with rec.tick(), rec.span("engine.step (host policy)"):
            return engine_step()
    engine.step = traced_engine_step


def warm_up(engine, prompts: List[np.ndarray], short: int, block: int,
            vocab: int, seed: int) -> None:
    """Set-up through the served path: every ``prompts`` sequence as a
    one-token request (their blocks land in the prefix cache; the wide
    prefill step warms), then ``short`` short requests that decode in
    bursts and in synchronous ticks."""
    from repro_torch.serve.api import StreamingServer
    server = StreamingServer(engine)
    rng = np.random.default_rng([int(seed), 77])
    for p in prompts:
        server.submit(p, max_new=1)
    for _ in range(short):
        server.submit(rng.integers(0, vocab, 2 * block + 3), max_new=24)
    server.drain(max_steps=1_000_000)
    for rid in list(server._finished):
        server.result(rid, forget=True)


@dataclasses.dataclass
class Client:
    """One request as its client saw it: submit time, deliveries
    (host time, how many tokens), the tokens delivered, finish time."""
    rid: int
    req: object
    submit_t: float
    deliveries: List[tuple] = dataclasses.field(default_factory=list)
    tokens: List[int] = dataclasses.field(default_factory=list)
    done_t: Optional[float] = None
    request: object = None          # the engine's Request, once finished
    cached: int = 0                 # prompt tokens the prefix cache held


@dataclasses.dataclass
class Window:
    t0: float
    t1: float
    clients: List[Client]
    steps: List[tuple]
    prof_steps: List[tuple]
    trace: Optional[dict]
    async_delta: Dict[str, float]
    profile_tries: int = 0
    tick_s: Optional[Dict[str, float]] = None
    tick_n: Optional[Dict[str, int]] = None
    preemptions: int = 0


def _async_snapshot(engine) -> Dict[str, float]:
    st = engine.async_stats()
    return {k: st[k] for k in ("sync_ticks", "overlap_ticks", "loop_bursts",
                               "loop_device_ticks", "device_ticks")}


def run_window(engine, traffic, seconds: float, rec: Recorder,
               trace_s: float = 0.0, n_layers: int = 0) -> Window:
    """The measured window: every client's first request at t0, then a
    closed loop until t0 + seconds. With ``trace_s`` the profiler covers
    the window's last ``trace_s`` seconds; a sub-window whose trace lacks
    some of kernel 1's launches (the profiler drops events now and then)
    is profiled again after the window, up to PROFILE_TRIES in all."""
    from repro_torch.serve.api import StreamingServer
    server = StreamingServer(engine)
    engine.reset_metrics()
    a0 = _async_snapshot(engine)
    live: Dict[int, Client] = {}
    done: List[Client] = []
    metrics = engine.metrics

    def submit(req, now):
        rid = server.submit(req.prompt, max_new=req.max_new)
        live[rid] = Client(rid, req, now)

    def poll():
        deltas = server.poll()
        now = time.perf_counter()
        for rid, toks in deltas.items():
            c = live.get(rid)
            if c is not None:
                c.deliveries.append((now, len(toks)))
                c.tokens.extend(int(t) for t in toks)
        for rid in [r for r in live if r in server._finished]:
            c = live.pop(rid)
            c.done_t = now
            m = metrics.requests.get(rid)
            c.cached = m.cached_prompt_tokens if m is not None else 0
            c.request = server.result(rid, forget=True)
            done.append(c)
            yield c

    t0 = time.perf_counter()
    t1 = t0 + seconds
    rec.recording = True
    for req in traffic.initial():
        submit(req, t0)
    steps, a1 = None, None
    prof, tr, tries = None, None, 0
    prof_steps: List[tuple] = []
    while True:
        now = time.perf_counter()
        if steps is None and now >= t1:
            rec.recording = False
            steps, a1 = list(rec.steps), _async_snapshot(engine)
            preempted = metrics.evictions
            for c in live.values():
                m = metrics.requests.get(c.rid)
                c.cached = m.cached_prompt_tokens if m is not None else 0
        if trace_s and prof is None and tr is None and tries < PROFILE_TRIES \
                and now >= t1 - trace_s:
            prof, tries = _start_profile(rec), tries + 1
        if prof is not None and steps is not None \
                and time.perf_counter() >= prof.t0 + trace_s:
            # a profiled sub-window runs trace_s seconds; a later try
            # profiles the same loop after the window
            prof.stop()
            rec.spanning = False
            prof_steps = rec.prof_steps
            tr = _read_profile(prof, rec, prof_steps, n_layers)
            prof = None
        if steps is not None and prof is None \
                and (tr is not None or not trace_s or tries >= PROFILE_TRIES):
            break
        with rec.span("harness loop"):
            for _ in poll():
                submit(traffic.next(), time.perf_counter())
    return Window(t0=t0, t1=t1, clients=done + list(live.values()),
                  steps=steps, prof_steps=prof_steps, trace=tr,
                  async_delta={k: a1[k] - a0[k] for k in a0},
                  profile_tries=tries, tick_s=dict(rec.tick_s),
                  tick_n=dict(rec.tick_n),
                  preemptions=preempted)


def _start_profile(rec: Recorder):
    prof = trace_mod.Profile()
    rec.spans, rec.prof_steps = [], []
    prof.start()
    rec.spanning = True
    return prof


def _read_profile(prof, rec: Recorder, steps: List[tuple],
                  n_layers: int) -> Optional[dict]:
    """The sub-window's trace, or None where it lost some of kernel 1's
    launches (one a layer of every eager step and burst iteration)."""
    events = prof.events()
    want = n_layers * sum(s[1] if s[0] == "burst" else 1 for s in steps)
    got = sum(1 for e in events if KERNEL1 in e[0])
    if got != want:
        print(f"trace: {got} of {want} kernel-1 launches in the profiled "
              f"sub-window; profiling another", file=sys.stderr, flush=True)
        return None
    return trace_mod.read(events, prof.marks, rec.spans,
                          prof.t1 - prof.t0)
