"""Production serving demo on the port: the paged engine's unified step,
per-request SamplingParams and the streaming API.

  * tokens stream out of ``api.generate`` while other requests decode:
    prefill and decode rows share one batched device step per tick,
  * per-request SamplingParams: a greedy request, a temperature/top-k
    request and a stop-sequence request multiplex in the same batch,
  * priority scheduling and preemption under a tiny block pool, with
    TTFT/TPOT/p99 metrics at the end.

    PYTHONPATH=src python -m repro_torch.examples.streaming_serve \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np

from repro_torch.configs import get_config
from repro_torch.configs.base import ServeConfig
from repro_torch.examples import device_name, resolve, seeded
from repro_torch.models import Model
from repro_torch.serve import api
from repro_torch.serve.engine import Engine
from repro_torch.serve.sampling import SamplingParams

SCFG = ServeConfig(max_batch=2, max_seq=96, paged=True, block_size=8,
                   prefill_chunk=16, policy="priority")


def serve(cfg, params, device) -> dict:
    """The example's traffic, prompts from ``default_rng(0)``: one stream,
    a long prompt among four short higher-priority ones, then greedy,
    seeded temperature/top-k and stop-sequence requests on one prompt."""
    rng = np.random.default_rng(0)
    eng = Engine(cfg, params, SCFG, device=device)
    out = {"pool_blocks": eng.pool.n_blocks,
           "pool_capacity_bytes": eng.pool.capacity_bytes()}

    prompt = rng.integers(0, cfg.vocab, size=9, dtype=np.int32)
    out["stream"] = [int(t) for t in api.generate(eng, prompt, max_new=8)]

    # the long prefill streams in chunks between the short requests' decode
    srv = api.StreamingServer(eng)
    long_rid = srv.submit(rng.integers(0, cfg.vocab, 64, dtype=np.int32),
                          max_new=8, priority=0)
    short_rids = [srv.submit(rng.integers(0, cfg.vocab,
                                          int(rng.integers(4, 10)),
                                          dtype=np.int32),
                             max_new=8, priority=5)
                  for _ in range(4)]
    done = srv.drain()
    out["long_rid"], out["short_rids"] = long_rid, short_rids
    out["batch"] = {rid: (len(r.prompt), [int(t) for t in r.tokens_out])
                    for rid, r in sorted(done.items())}

    prompt = rng.integers(0, cfg.vocab, size=9, dtype=np.int32)
    g = srv.submit(prompt, max_new=8)
    t = srv.submit(prompt, max_new=8,
                   sampling=SamplingParams(temperature=0.8, top_k=32,
                                           seed=7, logprobs=True))
    done = srv.drain()
    greedy = [int(x) for x in done[g].tokens_out]
    stop = tuple(greedy[2:4])
    s_rid = srv.submit(prompt, max_new=8,
                       sampling=SamplingParams(stop=(stop,)))
    done = srv.drain()
    out.update(greedy=greedy, sampled=[int(x) for x in done[t].tokens_out],
               sampled_logprob0=float(done[t].logprobs_out[0]), stop=stop,
               stopped=[int(x) for x in done[s_rid].tokens_out],
               summary=eng.metrics.summary(), pool=eng.pool.stats())
    return out


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve(args.device)
    cfg = get_config("nectar-relu-llama-1.7m")
    params = Model(cfg).init(seeded(device, 0), device=device)

    out = serve(cfg, params, device)
    print(f"paged engine on {device_name(device)}: {out['pool_blocks']} "
          f"blocks x {SCFG.block_size} tokens "
          f"({out['pool_capacity_bytes']:,.0f} KV bytes)")
    print("streaming generate:", " ".join(map(str, out["stream"])))
    print(f"served {len(out['batch'])} requests (1 long prompt + "
          f"{len(out['short_rids'])} short, priority-first)")
    for rid, (n_prompt, toks) in out["batch"].items():
        kind = "long " if rid == out["long_rid"] else "short"
        print(f"    req {rid} ({kind}): {n_prompt} prompt toks -> "
              f"{len(toks)} generated")
    print(f"sampling: greedy={out['greedy']}")
    print(f"          temp0.8/top-k32={out['sampled']} "
          f"(logprob[0]={out['sampled_logprob0']:.2f})")
    print(f"          stop={out['stop']} -> {out['stopped']} "
          f"(truncated before the match)")
    s = out["summary"]
    print(f"metrics: {s['tokens_per_s']:.1f} tok/s  "
          f"ttft p50={s['ttft_p50_ms']:.1f}ms p99={s['ttft_p99_ms']:.1f}ms  "
          f"tpot p50={s['tpot_p50_ms']:.2f}ms  evictions={s['evictions']}")
    print(f"traffic: weight={s['weight_bytes']:,.0f}B "
          f"kv={s['kv_bytes']:,.0f}B "
          f"sparse_saved={s['sparse_savings_bytes']:,.0f}B")
    print("pool:", out["pool"])
    return out


if __name__ == "__main__":
    main()
