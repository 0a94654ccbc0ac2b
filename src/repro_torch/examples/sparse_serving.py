"""Serving-system demo on the port: continuous batching with slot reuse,
per-step traffic stats, the heterogeneous dispatch report (judged at the
H100 SXM the port runs on), int8 KV quantization.

    PYTHONPATH=src python -m repro_torch.examples.sparse_serving \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ServeConfig
from repro_torch.core import heterogeneous
from repro_torch.examples import device_name, resolve, seeded
from repro_torch.models import Model
from repro_torch.serve import kv_cache
from repro_torch.serve.engine import Engine
from repro_torch.serve.scheduler import Request


def requests(cfg) -> list:
    """6 requests of 3-9 prompt tokens and 4-11 new ones (default_rng(1))."""
    rng = np.random.default_rng(1)
    return [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab,
                                        size=int(rng.integers(3, 10)),
                                        dtype=np.int32),
                    max_new=int(rng.integers(4, 12)))
            for i in range(6)]


def serve(cfg, params, device) -> dict:
    """The 6 requests through 2 slots of the slot engine: tokens by rid,
    the step count and the last step's traffic."""
    eng = Engine(cfg, params, ServeConfig(max_batch=2, max_seq=64),
                 device=device)
    done = eng.run(requests(cfg), max_steps=200)
    s = eng.stats[-1]
    return {"tokens": {rid: [int(t) for t in r.tokens_out]
                       for rid, r in sorted(done.items())},
            "prompt_lens": {rid: len(r.prompt)
                            for rid, r in sorted(done.items())},
            "n_slots": eng.alloc.n_slots, "steps": len(eng.stats),
            "last_step": {"weight_bytes": s.weight_bytes,
                          "kv_bytes": s.kv_bytes,
                          "sparse_savings_bytes": s.sparse_savings_bytes}}


def kv_roundtrip(device) -> float:
    """The relative error of an int8 KV round trip on a [2, 64, 4, 32]
    normal K."""
    g = seeded(device, 2)
    k = torch.randn((2, 64, 4, 32), generator=g, device=g.device)
    v = torch.randn((2, 64, 4, 32), generator=g, device=g.device)
    (kq, ks), _ = kv_cache.quantize_kv(k, v)
    kd = kv_cache.dequantize_kv(kq, ks)
    return float(torch.linalg.norm(kd - k) / torch.linalg.norm(k))


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve(args.device)
    cfg = get_config("nectar-relu-llama-1.7m")
    params = Model(cfg).init(seeded(device, 0), device=device)

    print("heterogeneous placement of decode matmul sites (paper C4, at "
          "the H100 SXM):")
    rep = heterogeneous.decode_regime_report(cfg.d_model, cfg.d_ff,
                                             cfg.vocab, batch=4)
    for site, regime in rep.items():
        print(f"    {site:18s} -> {regime}")

    out = serve(cfg, params, device)
    print(f"served {len(out['tokens'])} requests over {out['n_slots']} "
          f"slots in {out['steps']} steps on {device_name(device)}")
    for rid, toks in out["tokens"].items():
        print(f"    req {rid}: prompt {out['prompt_lens'][rid]} toks -> "
              f"{len(toks)} new toks")
    s = out["last_step"]
    print(f"last-step traffic: weight={s['weight_bytes']:,.0f}B "
          f"kv={s['kv_bytes']:,.0f}B "
          f"sparse_saved={s['sparse_savings_bytes']:,.0f}B")

    rel = kv_roundtrip(device)
    print(f"int8 KV cache: 2x smaller, roundtrip rel err {rel:.4f}")
    return dict(out, regimes=rep, kv_rel_err=rel)


if __name__ == "__main__":
    main()
