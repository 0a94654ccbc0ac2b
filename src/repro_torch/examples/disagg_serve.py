"""Disaggregated prefill/decode demo on the port: one prefill engine, one
decode engine, the handoff a paged-KV block copy (docs/disagg.md).

  * a long-prompt burst arriving mid-decode without dragging the steady
    decoders into prefill-wide mixed ticks: the monolithic engine run
    next to it shows the artifact (decode rows padded to the prefill
    chunk width),
  * the handoff timeline of one request on the shared tracer,
  * the wall-clock TPOT interference split,
  * the invariant: greedy disagg output is token-identical to the
    monolithic engine, per request.

    PYTHONPATH=src python -m repro_torch.examples.disagg_serve \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np

from repro_torch.configs import get_config
from repro_torch.configs.base import DisaggConfig, ObsConfig, ServeConfig
from repro_torch.examples import device_name, resolve, seeded
from repro_torch.models import Model
from repro_torch.serve.disagg import DisaggCoordinator
from repro_torch.serve.engine import Engine
from repro_torch.serve.scheduler import Request

SCFG = ServeConfig(max_batch=4, max_seq=128, paged=True, block_size=8,
                   n_kv_blocks=128, prefill_chunk=16, max_queue=8,
                   obs=ObsConfig(enabled=True))


def make_trace(cfg) -> dict:
    """3 steady decoders from tick 0 and two 48-token burst prompts
    arriving mid-decode. Fresh Request objects per call (they mutate);
    the seeded rng makes every call the same."""
    rng = np.random.default_rng(0)
    arrivals = {0: [Request(rid=i,
                            prompt=rng.integers(0, cfg.vocab, size=8,
                                                dtype=np.int32),
                            max_new=20)
                    for i in range(3)]}
    for i in range(2):
        arrivals.setdefault(4 + i * 6, []).append(
            Request(rid=100 + i,
                    prompt=rng.integers(0, cfg.vocab, size=48,
                                        dtype=np.int32),
                    max_new=2))
    return arrivals


def drive(system, arrivals) -> dict:
    reqs = [r for rs in arrivals.values() for r in rs]
    for t in range(2000):
        for r in arrivals.get(t, ()):
            if not system.add_request(r):
                raise RuntimeError(f"request {r.rid} was not admitted")
        system.step()
        if t >= max(arrivals) and all(r.done for r in reqs):
            break
    return {r.rid: list(map(int, r.tokens_out)) for r in reqs}


def decode_width_waste(ticks):
    """Padding charged to decode rows at the tick width; (waste share,
    mixed ticks)."""
    num = den = mixed = 0
    for t in ticks:
        nd = t.get("rows_decode", 0)
        if nd:
            num += nd * (t.get("width", 1) - 1)
            den += nd * t.get("width", 1)
            mixed += bool(t.get("rows_prefill", 0))
    return (num / den if den else 0.0), mixed


def warm(system) -> None:
    """Run the trace's width buckets once outside the measured window, so
    the TPOT split reads scheduling, not first-call costs."""
    rng = np.random.default_rng(99)
    system.run([Request(rid=-1, prompt=rng.integers(0, 1000, size=8,
                                                    dtype=np.int32),
                        max_new=2),
                Request(rid=-2, prompt=rng.integers(0, 1000, size=48,
                                                    dtype=np.int32),
                        max_new=2)], max_steps=500)
    system.forget(-1)
    system.forget(-2)
    system.reset_metrics()


def run_system(system, cfg) -> dict:
    """Warm, drive the trace, and read tokens, mixed ticks, the decode
    width waste and the summary."""
    warm(system)
    toks = drive(system, make_trace(cfg))
    waste, mixed = decode_width_waste(system.tracer.tick_stats)
    return {"tokens": toks, "waste": waste, "mixed_ticks": mixed,
            "summary": system.metrics.summary()}


def serve(cfg, params, device) -> dict:
    """The trace through a monolithic engine and a disagg pool."""
    mono = run_system(Engine(cfg, params, SCFG, device=device), cfg)
    coord = DisaggCoordinator(cfg, params, SCFG, dcfg=DisaggConfig(),
                              device=device)
    dis = run_system(coord, cfg)
    t0 = None
    timeline = []
    for ev in coord.tracer.timeline(100):
        t0 = t0 if t0 is not None else ev.t
        timeline.append((ev.t - t0, ev.name, ev.attrs))
    dis["timeline"] = timeline
    return {"mono": mono, "disagg": dis}


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve(args.device)
    cfg = get_config("nectar-relu-llama-1.7m")
    params = Model(cfg).init(seeded(device, 0), device=device)

    out = serve(cfg, params, device)
    mono, dis = out["mono"], out["disagg"]
    print(f"monolithic engine (shared batch, mixed ticks) on "
          f"{device_name(device)}:")
    print(f"    {mono['mixed_ticks']} mixed ticks, decode width waste "
          f"{mono['waste']:.3f} (decode rows padded to chunk width 16)")
    s = dis["summary"]
    print("\ndisagg pool (dedicated engine per phase):")
    print(f"    {dis['mixed_ticks']} mixed ticks, decode width waste "
          f"{dis['waste']:.3f}, {s['n_handoffs']} handoffs "
          f"({s['handoff_blocks']} KV blocks moved)")
    print("\nhandoff timeline (burst rid 100, shared tracer):")
    for dt, name, attrs in dis["timeline"]:
        print(f"    +{dt * 1e3:7.1f}ms  {name:16s} {attrs or ''}")
    print("\nwall-clock TPOT split (one host drives both engines: the "
          "overlap bucket\nshrinks only under parallel deployment; the "
          "structural win is the waste above):")
    for name, summ in (("monolithic", mono["summary"]), ("disagg", s)):
        print(f"    {name:10s} steady p99 "
              f"{summ['tpot_p99_steady_ms']:7.1f}ms | prefill-overlap "
              f"p99 {summ['tpot_p99_prefill_overlap_ms']:7.1f}ms")
    if mono["tokens"] != dis["tokens"]:
        raise SystemExit("disagg_serve: greedy identity broke")
    print("\nidentity: disagg output token-identical to monolithic "
          f"({sum(map(len, dis['tokens'].values()))} tokens) OK")
    return out


if __name__ == "__main__":
    main()
