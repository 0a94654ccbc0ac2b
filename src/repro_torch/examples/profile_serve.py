"""Roofline attainment profiling demo on the port (docs/observability.md).

Runs the paged engine with ``ObsConfig(profile=True)``, prints the
per-bucket attainment table (achieved GFLOP/s, GB/s, arithmetic
intensity, share of the active roofline: the H100 SXM on the card, the
nominal CPU host on the CPU), and shows where the same numbers surface
programmatically: ``metrics.summary()["bucket_attainment"]`` and the
Prometheus ``bucket_attainment_*`` labelled gauges.

    PYTHONPATH=src python -m repro_torch.examples.profile_serve \\
        [--device cpu]

Equivalent CLI: PYTHONPATH=src python -m repro_torch.launch.serve --paged \\
    --profile
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np

from repro_torch.configs import get_config
from repro_torch.configs.base import ObsConfig, ServeConfig
from repro_torch.examples import device_name, resolve, seeded
from repro_torch.models import Model
from repro_torch.obs import attainment_table
from repro_torch.serve.engine import Engine
from repro_torch.serve.scheduler import Request

SCFG = ServeConfig(max_batch=4, max_seq=96, paged=True, block_size=8,
                   prefill_chunk=16, obs=ObsConfig(enabled=True,
                                                   profile=True))


def serve(cfg, params, device) -> dict:
    """6 requests of 4-11 prompt tokens, 12 new ones (default_rng(0)):
    tokens by rid, the profiler's rows, the summary and the Prometheus
    attainment gauges."""
    eng = Engine(cfg, params, SCFG, device=device)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab,
                                        size=4 + int(rng.integers(0, 8)),
                                        dtype=np.int32),
                    max_new=12)
            for i in range(6)]
    eng.run(reqs, max_steps=2000)
    prom = eng.metrics.registry.prometheus_text()
    return {"tokens": {r.rid: [int(t) for t in r.tokens_out] for r in reqs},
            "rows": eng.profiler.report(eng.tracer.tick_stats),
            "summary": eng.metrics.summary(),
            "gauges": [line for line in prom.splitlines()
                       if line.startswith("bucket_attainment_attainment")]}


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve(args.device)
    cfg = get_config("nectar-relu-llama-1.7m")
    params = Model(cfg).init(seeded(device, 0), device=device)

    out = serve(cfg, params, device)
    print(f"attainment on {device_name(device)}:")
    print(attainment_table(out["rows"]))
    decode = next(r for r in out["summary"]["bucket_attainment"]
                  if r["bucket"] == "decode")
    print(f"\ndecode bucket: attain={decode['attain']:.3f} "
          f"bound={decode['bound']} AI={decode['AI']:.2f}")
    print("\nPrometheus bucket_attainment gauges:")
    for line in out["gauges"]:
        print(f"  {line}")
    return dict(out, decode=decode)


if __name__ == "__main__":
    main()
