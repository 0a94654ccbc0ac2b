"""Sharded serving demo on the port: the paged engine partitioned over a
4-shard 'model' mesh (ServeConfig(mesh=MeshConfig(model=4))), with one
device a shard: ``["cuda:0"] * 4`` on the card, ``["cpu"] * 4`` on the
CPU (docs/sharding_port.md).

  * transformer weights shard over 'model' (output-dim tensor
    parallelism) and the paged KV block pool partitions its KV-head
    axis, so the host-side block machinery is untouched by sharding,
  * greedy output is checked token-identical to the single-device
    engine,
  * per-shard KV pool stats: what one shard holds.

    PYTHONPATH=src python -m repro_torch.examples.sharded_serve \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np

from repro_torch.configs import get_config
from repro_torch.configs.base import MeshConfig, ServeConfig
from repro_torch.examples import device_name, resolve, seeded
from repro_torch.models import Model
from repro_torch.serve.engine import Engine
from repro_torch.serve.scheduler import Request

N_SHARDS = 4


def prompts(cfg) -> list:
    """6 requests sharing a 16-token system prompt (default_rng(0)):
    through a 4-slot batch, the last two admit after the first wave
    published it, so they hit the prefix cache."""
    rng = np.random.default_rng(0)
    sys_prompt = rng.integers(0, cfg.vocab, size=16, dtype=np.int32)
    return [np.concatenate(
        [sys_prompt, rng.integers(0, cfg.vocab, size=int(n), dtype=np.int32)])
        for n in (5, 21, 9, 13, 7, 11)]


def serve(cfg, params, device, prompts, mesh=None):
    """The prompts through the paged engine with the prefix cache, on one
    device or on ``mesh`` (one shard a device: ``[device] * n``);
    (tokens by rid, the engine)."""
    scfg = ServeConfig(max_batch=4, max_seq=96, paged=True, block_size=8,
                       prefill_chunk=16, prefix_cache=True, mesh=mesh)
    dev = device if mesh is None else [device] * mesh.n_devices
    eng = Engine(cfg, params, scfg, device=dev)
    done = eng.run([Request(rid=i, prompt=p, max_new=12)
                    for i, p in enumerate(prompts)], max_steps=3000)
    return {i: [int(t) for t in r.tokens_out] for i, r in done.items()}, eng


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve(args.device)
    cfg = get_config("nectar-relu-llama-1.7m")
    params = Model(cfg).init(seeded(device, 0), device=device)
    ps = prompts(cfg)

    print(f"devices: {N_SHARDS} shards on {device_name(device)} ({device})")
    single, _ = serve(cfg, params, device, ps)
    sharded, eng = serve(cfg, params, device, ps,
                         mesh=MeshConfig(model=N_SHARDS))
    if sharded != single:
        raise SystemExit("sharded output diverged from single-device")
    print(f"token-identity over {len(ps)} requests (model={N_SHARDS} mesh "
          f"vs single device): OK")

    s = eng.metrics.summary()
    print("mesh:", s["mesh"])
    pool = s["kv_pool"]
    print(f"KV pool: {pool['n_blocks']} blocks x {eng.pool.block_size} "
          f"tokens, {pool['capacity_bytes'] / 1024:.1f} KiB total")
    print(f"  per shard: {pool['per_shard_capacity_bytes'] / 1024:.1f} "
          f"KiB across {pool['model_shards']} shards "
          f"({cfg.n_kv_heads // pool['model_shards']} of "
          f"{cfg.n_kv_heads} KV heads each)")
    print(f"  high water: {pool['high_water_blocks']} blocks "
          f"({pool['per_shard_used_bytes'] / 1024:.1f} KiB/shard now); "
          f"prefix hits: {s['prefix_hits']}/{s['prefix_lookups']}")
    leaf = eng.runner.cache["units"]["b0"]["k"]
    print(f"  pool leaf {tuple(leaf.shards[0].shape)} a shard, split "
          f"{leaf.spec}")
    return {"single": single, "sharded": sharded, "summary": s}


if __name__ == "__main__":
    main()
