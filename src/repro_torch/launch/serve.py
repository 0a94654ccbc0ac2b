"""Serving entry point of the port: the continuous-batching engine with
the NeCTAr decode paths (sparse FFN gather through the CUDA kernels),
the params of the latest checkpoint in ``--ckpt-dir`` or random weights
from a seeded generator.

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch nectar-relu-llama-1.7m --requests 8 --max-new 16 \\
        --max-batch 4 [--paged] [--prefix-cache] [--kv-quant] \\
        [--spec ngram|selfspec --spec-k 4] [--attn-backend flash] \\
        [--async --async-k 8 --async-sync-every 0] \\
        [--obs] [--trace-out PREFIX] [--metrics-port PORT] [--profile] \\
        [--disagg [--disagg-prefill-batch N] [--disagg-prefill-blocks N] \\
         [--direct-max-suffix N]] [--replicas N --router-policy affinity] \\
        [--temperature 0.7 --seed 0] [--ckpt-dir CKPT] [--device cpu]

``--model`` is another name for ``--arch``. The recurrent families
(``--model zamba2-smoke``, ``--model xlstm-smoke``) serve through the slot
engine; a paged flag is refused for them with the reference's error.
It runs on the CUDA device unless ``--device cpu`` is given, and prints a
JSON summary (paged: the requests' queue wait, submit to their first
slot, as ``queue_wait_p50_ms`` and ``queue_wait_p99_ms``, and the
engine's seconds by phase as ``engine_phase_s``, with tracing off too;
with ``--async``, the engine's ``async_stats()`` under
"async"; with tracing, the tracer's ``ticks``; with ``--profile``, the
per-bucket ``bucket_attainment`` rows, whose table is printed first).
``--trace-out PREFIX`` writes PREFIX.trace.json (Perfetto) and
PREFIX.events.jsonl; ``--metrics-port`` serves the Prometheus text on
localhost while the requests run.

``--disagg`` serves through a DisaggCoordinator (a prefill engine and a
decode engine with the KV block handoff; the summary adds
``n_handoffs``, ``n_decode_direct`` and the interference split's p99s).
``--replicas N`` (N > 1) serves through a fleet of N replicas behind the
router (``--router-policy``), each replica a disagg pool under
``--disagg``; the requests come in sessions of two, and the summary is
the fleet's (``--metrics-port`` then serves the router's registry).

``--mesh N`` (N > 1, with ``--paged``) serves through a tensor-parallel
mesh of N shards (weights and the KV-head-sharded block pool, the naive
read); ``--shard-kv-seq`` also splits a decode step's gathered KV
sequence over the shards and merges them with the LSE-combine
collective. Without ``--device`` the shards are the first N visible CUDA
devices (fewer raise make_serving_mesh's ValueError); with it, N shards
on that one device (``--device cuda:0 --mesh 4``, ``--device cpu --mesh
4``). The summary then adds ``mesh`` and ``kv_pool_per_shard_bytes``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import (AsyncConfig, DisaggConfig,
                                      MeshConfig, ObsConfig, ServeConfig,
                                      SpecConfig)
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models import Model
from repro_torch.obs import (attainment_table, start_metrics_server,
                             write_jsonl, write_perfetto)
from repro_torch.serve.disagg import DisaggCoordinator
from repro_torch.serve.engine import Engine
from repro_torch.serve.router import POLICIES, build_fleet
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.scheduler import Request
from repro_torch.train import checkpoint

def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", "--model", dest="arch",
                    default="nectar-relu-llama-1.7m",
                    help="a registry config; the recurrent families "
                         "(zamba2-*, xlstm-*) serve through the slot "
                         "engine and refuse the paged flags")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--dense", action="store_true",
                    help="disable the sparse decode path (ablation)")
    ap.add_argument("--paged", action="store_true",
                    help="paged-KV scheduler engine (chunked prefill, "
                         "preemption)")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--policy", default="fifo", choices=("fifo", "priority"))
    ap.add_argument("--attn-backend", default="naive",
                    choices=("naive", "flash"),
                    help="paged attention read: the plain gather, or the "
                         "CUDA paged-attention kernel")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix prefix cache (implies --paged)")
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV pools (implies --paged; naive backend)")
    ap.add_argument("--spec", default=None, choices=("ngram", "selfspec"),
                    help="speculative decode drafter (implies --paged; the "
                         "'model' drafter needs trained draft weights: use "
                         "the API)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="draft length, also the adaptive-K ceiling")
    ap.add_argument("--async", dest="async_", action="store_true",
                    help="asynchronous engine ticks (implies --paged): "
                         "double-buffered dispatch and device-resident "
                         "decode bursts; output stays token-identical to "
                         "the synchronous engine")
    ap.add_argument("--async-k", type=int, default=8,
                    help="max device ticks per decode burst (1 = "
                         "double-buffered overlap only)")
    ap.add_argument("--async-sync-every", type=int, default=0,
                    help="force a synchronous tick every N ticks (0 = off)")
    ap.add_argument("--obs", action="store_true",
                    help="tracing: per-tick phase spans, request "
                         "timelines, host/device attribution (the "
                         "summary's \"ticks\")")
    ap.add_argument("--trace-out", default=None, metavar="PREFIX",
                    help="write PREFIX.trace.json (Perfetto) and "
                         "PREFIX.events.jsonl; implies --obs")
    ap.add_argument("--metrics-port", type=int, default=0,
                    help="serve Prometheus text on "
                         "127.0.0.1:PORT/metrics while serving")
    ap.add_argument("--profile", action="store_true",
                    help="roofline attainment per width bucket (implies "
                         "--obs and --paged); prints the table")
    ap.add_argument("--replicas", type=int, default=1,
                    help="serve through a fleet of N engine replicas "
                         "behind the prefix-affinity router (implies "
                         "--paged and the prefix cache)")
    ap.add_argument("--router-policy", default="affinity", choices=POLICIES,
                    help="fleet placement: scored radix-prefix affinity, "
                         "round robin, or queue depth only")
    ap.add_argument("--disagg", action="store_true",
                    help="disaggregated serving: a prefill engine and a "
                         "decode engine with the paged-KV block handoff "
                         "(implies --paged; with --replicas N every "
                         "replica is a disagg pool)")
    ap.add_argument("--disagg-prefill-batch", type=int, default=0,
                    help="the prefill engine's max_batch (0 = --max-batch)")
    ap.add_argument("--disagg-prefill-blocks", type=int, default=0,
                    help="the prefill engine's KV pool blocks (0 = as the "
                         "decode engine's)")
    ap.add_argument("--direct-max-suffix", type=int, default=0,
                    help="with --disagg: prompts whose uncached tail is <= N "
                         "tokens go straight to the decode engine (implies "
                         "the prefix cache; 0 = off)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; > 0 samples")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--repetition-penalty", type=float, default=1.0)
    ap.add_argument("--seed", "--sample-seed", dest="seed", type=int,
                    default=0, help="per-request sampling seed")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu runs the plain "
                         "versions of the kernels)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="serve the params of the latest checkpoint there "
                         "(python -m repro_torch.launch.train writes them); "
                         "random weights when it holds none")
    ap.add_argument("--mesh", type=int, default=1,
                    help="model-axis shards for sharded serving (paged "
                         "engine, naive read): the first N visible CUDA "
                         "devices, or N shards on --device")
    ap.add_argument("--shard-kv-seq", action="store_true",
                    help="with --mesh: also shard the gathered decode KV "
                         "sequence over 'model' and merge via the "
                         "LSE-combine collective")
    return ap


def main(argv: Optional[List[str]] = None) -> dict:
    ap = parser()
    args = ap.parse_args(argv)
    mesh = None if args.mesh <= 1 else MeshConfig(
        model=args.mesh, shard_kv_seq=args.shard_kv_seq)
    if mesh is not None:
        # the shards: N visible cards (fewer raise), or N on --device
        shards = make_serving_mesh(mesh, None if args.device is None
                                   else [args.device] * args.mesh).devices
        device = resolve_device(shards[0])
    else:
        shards = None
        device = resolve_device(args.device)
    cfg = get_config(args.arch)
    latest = None if args.ckpt_dir is None \
        else checkpoint.latest_step(args.ckpt_dir)
    if latest is None:
        gen = torch.Generator(device=device).manual_seed(0)
        params = Model(cfg).init(gen, device=device)
    else:
        params = checkpoint.restore_params(
            args.ckpt_dir, latest,
            Model(cfg).init(torch.Generator(), device="meta"), device=device)
        print(f"[serve] loaded checkpoint step {latest}", file=sys.stderr)
    fleet = args.replicas > 1
    paged = args.paged or args.prefix_cache or args.kv_quant \
        or args.spec is not None or args.async_ or args.profile \
        or args.disagg or fleet
    # --spec-k is the user's cap: adaptive K may shrink below it, never
    # exceed it
    spec = None if args.spec is None else SpecConfig(
        drafter=args.spec, k=args.spec_k, k_max=args.spec_k)
    async_cfg = None if not args.async_ else AsyncConfig(
        enabled=True, max_device_ticks=args.async_k,
        sync_every=args.async_sync_every)
    obs = ObsConfig(enabled=args.obs or args.trace_out is not None
                    or args.profile, profile=args.profile)
    scfg = ServeConfig(max_batch=args.max_batch, max_seq=args.max_seq,
                       sparse_decode=not args.dense, paged=paged,
                       prefix_cache=args.prefix_cache or fleet or (
                           args.disagg and args.direct_max_suffix > 0),
                       kv_quant=args.kv_quant, spec=spec,
                       block_size=args.block_size,
                       prefill_chunk=args.prefill_chunk, policy=args.policy,
                       attn_backend=args.attn_backend, async_cfg=async_cfg,
                       obs=obs, mesh=mesh)
    dcfg = None if not args.disagg else DisaggConfig(
        prefill_batch=args.disagg_prefill_batch,
        prefill_blocks=args.disagg_prefill_blocks,
        direct_max_suffix=args.direct_max_suffix)
    sp = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                        top_p=args.top_p,
                        repetition_penalty=args.repetition_penalty,
                        seed=args.seed)
    if fleet:
        return _serve_fleet(args, cfg, params, scfg, dcfg, sp, device,
                            shards)
    if dcfg is not None:
        eng = DisaggCoordinator(cfg, params, scfg, dcfg=dcfg,
                                device=list(shards) if shards else device)
    else:
        eng = Engine(cfg, params, scfg,
                     device=list(shards) if shards else device)
    server = None
    if args.metrics_port:
        server = _metrics_server(lambda: eng.metrics.registry,
                                 args.metrics_port)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab,
                                        size=4 + int(rng.integers(0, 8)),
                                        dtype=np.int32),
                    max_new=args.max_new, sampling=sp)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    try:
        done = eng.run(reqs, max_steps=10000)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
    dt = time.perf_counter() - t0
    n_tok = sum(len(r.tokens_out) for r in done.values())
    stats = eng.prefill.stats + eng.decode.stats if dcfg is not None \
        else eng.stats
    savings = sum(s.sparse_savings_bytes for s in stats)
    total_w = sum(s.weight_bytes + s.sparse_savings_bytes for s in stats)
    out = {"device": str(device) if device.type == "cpu"
           else torch.cuda.get_device_name(device),
           "requests": len(done), "tokens": n_tok,
           "tokens_per_s": n_tok / dt,
           "weight_bytes_saved_frac": savings / max(total_w, 1),
           "ckpt_step": latest}
    if paged:
        s = eng.metrics.summary()
        out.update({"ttft_p99_ms": s["ttft_p99_ms"],
                    "tpot_p50_ms": s["tpot_p50_ms"],
                    "evictions": s["evictions"],
                    "prefix_hits": s["prefix_hits"],
                    "prefix_cached_tokens": s["prefix_cached_tokens"],
                    "kv_pool_capacity_bytes":
                        s["kv_pool"]["capacity_bytes"],
                    "queue_wait_p50_ms": s["queue_wait_p50_ms"],
                    "queue_wait_p99_ms": s["queue_wait_p99_ms"],
                    "engine_phase_s": s["engine_phase_s"]})
        if dcfg is not None:
            out.update({
                "n_handoffs": s["n_handoffs"],
                "n_decode_direct": s["n_decode_direct"],
                "tpot_p99_steady_ms": s["tpot_p99_steady_ms"],
                "tpot_p99_prefill_overlap_ms":
                    s["tpot_p99_prefill_overlap_ms"]})
        if mesh is not None:
            out["mesh"] = s["mesh"]
            out["kv_pool_per_shard_bytes"] = \
                s["kv_pool"]["per_shard_capacity_bytes"]
        if spec is not None:
            out.update({
                "spec_steps": s["spec_steps"],
                "spec_acceptance_rate": s["spec_acceptance_rate"],
                "spec_tokens_per_verify": s["spec_tokens_per_verify"]})
    if args.async_ and dcfg is None:
        out["async"] = eng.async_stats()
    if eng.tracer.enabled:
        out["ticks"] = eng.tracer.tick_summary()
    if args.profile:
        prof = eng.decode.profiler if dcfg is not None else eng.profiler
        rows = prof.report(eng.tracer.tick_stats)
        out["bucket_attainment"] = rows
        print(attainment_table(rows))
    if args.trace_out:
        trace = write_perfetto(eng.tracer, args.trace_out + ".trace.json",
                               registry=eng.metrics.registry,
                               profiler=getattr(eng, "profiler", None))
        events = write_jsonl(eng.tracer, args.trace_out + ".events.jsonl")
        out["trace_files"] = [trace, events]
    print(json.dumps(out, indent=1))
    return out


def _metrics_server(registry_fn, port: int):
    server = start_metrics_server(registry_fn, port)
    print(f"[serve] metrics on 127.0.0.1:{port}/metrics", file=sys.stderr)
    return server


def _serve_fleet(args, cfg, params, scfg, dcfg, sp, device,
                 shards=None) -> dict:
    """``--replicas N``: N replicas (disagg pools under ``--disagg``)
    behind the router; request i joins session ``demo-{i % (n // 2)}``.
    Prints and returns the fleet's summary."""
    router = build_fleet(cfg, params, scfg, n_replicas=args.replicas,
                         policy=args.router_policy, disagg=dcfg,
                         device=list(shards) if shards else device)
    server = None
    if args.metrics_port:
        server = _metrics_server(lambda: router.registry, args.metrics_port)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    try:
        for i in range(args.requests):
            router.submit(rng.integers(0, cfg.vocab,
                                       size=4 + int(rng.integers(0, 8)),
                                       dtype=np.int32),
                          max_new=args.max_new, sampling=sp,
                          session=f"demo-{i % max(args.requests // 2, 1)}")
        done = router.drain_all()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
    dt = time.perf_counter() - t0
    n_tok = sum(len(r.tokens_out) for r in done.values())
    s = router.fleet_summary()
    out = {"device": str(device) if device.type == "cpu"
           else torch.cuda.get_device_name(device),
           "requests": len(done), "tokens": n_tok,
           "tokens_per_s": n_tok / dt,
           "n_replicas": s["n_replicas"],
           "prefix_hit_rate": s["prefix_hit_rate"],
           "ttft_p99_ms": s["ttft_p99_ms"],
           "fleet_queue_depth": s["fleet_queue_depth"],
           "router": s["router"],
           "per_replica_dispatched": {
               i: h["dispatched"] for i, h in s["replicas"].items()}}
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
