"""One run of one cell: set-up, the window, the metrics and the check.

Everything a cell is made of is found by name: the cell in
``BENCHMARK.json``, its configuration in the file that entry names, its
traffic mix in ``bench/traffic/<traffic>.json`` and each metric's reader
in ``bench/metrics/`` (``<name>.py``, else the module of the part of the
name before its first dot, so ``mfu.decode`` and ``mfu.prompt`` share
``mfu.py``). A new cell, configuration, mix or metric is new files and
entries; nothing here changes.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

from bench.harness import driver, model, oracle, traffic as traffic_mod

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
SHORT_WARM = 4          # short requests set-up decodes (bursts, sync ticks)
TRACE_S = 5.0           # seconds of a traced run's profiled sub-window


def log(t_start: float, what: str) -> None:
    """A progress line on standard error: seconds since the run started."""
    print(f"bench: {time.perf_counter() - t_start:8.2f} s  {what}",
          file=sys.stderr, flush=True)


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find_cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                   f"{[w['name'] for w in spec['workloads']]}")


def cell_metrics(spec: dict, cell: str, per_layer: bool) -> List[dict]:
    """The metrics a cell reports: those without ``workloads`` and those
    that list it."""
    group = spec["per_layer" if per_layer else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def reader(name: str, bench: Path = BENCH):
    """The reader module of metric ``name``."""
    for stem in (name, name.split(".")[0]):
        path = bench / "metrics" / f"{stem}.py"
        if path.exists():
            mod_name = "bench_metric_" + stem.replace(".", "_").replace(
                "-", "_")
            spec = importlib.util.spec_from_file_location(mod_name, path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod
    raise FileNotFoundError(f"no reader for metric {name!r} in "
                            f"{bench / 'metrics'}")


def forbidden_modules() -> List[str]:
    """The JAX stack or the JAX package among the loaded modules, compared
    by whole top-level names (``repro_torch`` is not ``repro``)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


@dataclasses.dataclass
class Run:
    """What a reader reads: the cell's sizes, the window and its steps,
    the trace, the engine's counters and the card's peaks."""
    cell: str
    hf: dict
    max_batch: int
    seconds: float
    setup_s: float
    window: driver.Window
    peaks: dict
    n_layers: int
    pool_bytes: int                 # bytes of one KV value as pooled

    def in_window(self, t: float) -> bool:
        return self.window.t0 <= t <= self.window.t1


def _merged_serve(conf: dict, mix: dict) -> dict:
    serve = dict(conf.get("serve", {}))
    serve.update(mix.get("serve", {}))
    serve["max_batch"] = int(mix["clients"])
    return serve


def build(conf: dict, mix: dict):
    """(ModelConfig, ServeConfig) of a configuration under a mix; the pool
    is ``pool_gib`` of KV blocks."""
    serve = _merged_serve(conf, mix)
    if "pool_gib" in serve:
        serve["n_kv_blocks"] = model.pool_blocks(conf["config"], serve)
        del serve["pool_gib"]
    cfg = model.model_config(conf, conf.get("dtype", "bfloat16"))
    return cfg, model.serve_config(serve)


def run(cell_name: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", spec: Optional[dict] = None,
        bench: Path = BENCH, t_start: Optional[float] = None,
        hook: Optional[Callable] = None, control: bool = False) -> dict:
    """One run; returns the result line's dict (its ``checks`` last).
    ``hook(engine)`` runs once the engine is built (tests plant faults
    there)."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    spec = load_spec(bench.parent) if spec is None else spec
    cell = find_cell(spec, cell_name)
    cconf = next(c for c in spec["configs"] if c["name"] == cell["config"])
    conf = json.loads((bench.parent / cconf["file"]).read_text())
    mix = json.loads((bench / "traffic" / f"{cell['traffic']}.json")
                     .read_text())
    hf = conf["config"]
    dev = torch.device(device)
    cfg, scfg = build(conf, mix)
    dtype = getattr(torch, conf.get("dtype", "bfloat16"))
    weights = model.make_weights(hf, dtype, seed, dev)
    log(t_start, "weights made")
    from repro_torch.serve.engine import Engine
    engine = Engine(cfg, model.port_params(weights), scfg, device=dev)
    log(t_start, f"engine built: {scfg.pool_blocks} KV blocks")
    if hook is not None:
        hook(engine)
    pool_bytes = engine.runner.cache["units"]["b0"]["k"].element_size()
    rec = driver.Recorder()
    driver.instrument(engine, rec)
    gen = traffic_mod.make(mix, seed, hf["vocab_size"], scfg.prefill_chunk,
                           scfg.block_size)
    driver.warm_up(engine, gen.warm_prompts(), SHORT_WARM, scfg.block_size,
                   hf["vocab_size"], seed)
    if dev.type == "cuda":
        if trace:
            from bench.harness import trace as trace_mod
            trace_mod.Profile.warm()
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    # the window's own peak: set-up's (the pool built at twice its size)
    # is reported beside it
    setup_peak = 0
    if dev.type == "cuda":
        setup_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    log(t_start, "set-up done; the window opens")
    traced = trace and dev.type == "cuda"
    window = driver.run_window(engine, gen, seconds, rec,
                               trace_s=TRACE_S if traced else 0.0,
                               n_layers=hf["num_hidden_layers"])
    log(t_start, f"window closed ({window.profile_tries} profiled)")
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    from bench.harness import counting
    run_rec = Run(cell=cell_name, hf=hf, max_batch=scfg.max_batch,
                  seconds=seconds, setup_s=setup_s, window=window,
                  peaks=counting.PEAKS.get(kind, {}),
                  n_layers=hf["num_hidden_layers"], pool_bytes=pool_bytes)
    metrics = {}
    for m in cell_metrics(spec, cell_name, per_layer=trace):
        v = reader(m["name"], bench).read(run_rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    # the check: the program's state goes first, the weights stay
    finished = [c for c in window.clients
                if c.done_t is not None and c.done_t <= window.t1]
    del engine, rec
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    log(t_start, f"checking a sample of {len(finished)} finished "
        f"requests and an admitted one")
    result = oracle.check(weights, hf, window.clients, window.t1, seed,
                          oracle.limits(cell_name, bench), control=control)
    attempted = sum(1 for c in window.clients if c.submit_t <= window.t1)
    failed = sum(1 for c in finished
                 if len(c.request.tokens_out) < c.req.max_new)
    out = {"correct": result["correct"] and failed == 0,
           "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                      "kind": kind, "count": 1,
                      "memory_peak_bytes": int(peak),
                      "setup_memory_peak_bytes": int(setup_peak)},
           "samples": samples(window),
           "window": {"ticks_s": window.tick_s, "ticks": window.tick_n,
                      "preemptions": window.preemptions,
                      "async": window.async_delta,
                      "profiled_tries": window.profile_tries,
                      "recursion_limit": sys.getrecursionlimit()}}
    if window.trace is not None:
        out["window"]["trace_markers"] = window.trace["markers"]
        out["window"]["trace_clock_offset_ns"] = window.trace[
            "clock_offset_ns"]
    if trace and window.trace is not None:
        out["device"]["busy_s"] = window.trace["busy_s"]
        out["device"]["window_s"] = window.trace["window_s"]
        out["breakdown"] = {"device_ops": window.trace["device_ops"],
                            "idle_gaps": window.trace["idle_gaps"]}
    if control:
        out["control_max_gap"] = result["control_max_gap"]
    out["checks"] = result["checks"]
    return out


def samples(window: driver.Window) -> Dict[str, int]:
    """How many requests each end-to-end reading rests on."""
    t0, t1 = window.t0, window.t1
    first = sum(1 for c in window.clients if not c.req.resumed
                and c.deliveries and t0 <= c.deliveries[0][0] <= t1)
    tpot = sum(1 for c in window.clients
               if sum(n for t, n in c.deliveries if t0 <= t <= t1) >= 2)
    done = sum(1 for c in window.clients
               if c.done_t is not None and c.done_t <= t1)
    return {"ttft": first, "tpot": tpot, "finished": done}
