"""Serving-fleet demo on the port: two replicas behind the prefix-affinity
router (docs/fleet.md).

  * shared-prefix traffic from two tenants (prompt families) partitioned
    across replicas: the router probes each replica's radix index and
    routes every family to wherever its blocks live,
  * the routing decision log (which replica, why, how many prefix tokens
    matched),
  * per-replica prefix hit rates and the aggregated fleet summary,
  * session stickiness: a multi-turn session keeps landing on the
    replica that holds its history.

    PYTHONPATH=src python -m repro_torch.examples.fleet_serve [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np

from repro_torch.configs import get_config
from repro_torch.configs.base import ServeConfig
from repro_torch.examples import device_name, resolve, seeded
from repro_torch.models import Model
from repro_torch.serve.router import build_fleet

SCFG = ServeConfig(max_batch=2, max_seq=96, paged=True, prefix_cache=True,
                   block_size=8, n_kv_blocks=48, prefill_chunk=16,
                   max_queue=4)
TENANTS = ("tenant-A", "tenant-B")


def serve(cfg, params, device) -> dict:
    """Two tenants' traffic (default_rng(0)): a cold round, 8 warm
    requests, then a 3-turn session; the decisions, placements, the fleet
    summary and the session's replicas."""
    rng = np.random.default_rng(0)
    router = build_fleet(cfg, params, SCFG, n_replicas=2, policy="affinity",
                         device=device)
    # each tenant: a 32-token shared system prompt + unique tails
    families = {name: rng.integers(0, cfg.vocab, 32, dtype=np.int32)
                for name in TENANTS}

    def prompt_for(name):
        tail = rng.integers(0, cfg.vocab, int(rng.integers(4, 10)),
                            dtype=np.int32)
        return np.concatenate([families[name], tail])

    # cold round: each tenant's first request prefills somewhere and
    # publishes the family prefix there on finish
    rids = {}
    for name in families:
        rids[router.submit(prompt_for(name), max_new=6)] = name
    router.drain_all()
    # warm traffic: routed to wherever the family's blocks live
    for i in range(8):
        name = TENANTS[i % 2]
        rids[router.submit(prompt_for(name), max_new=6)] = name
    router.drain_all()
    out = {"replicas": len(router.fleet.live()), "policy": router.policy,
           "tenants": rids,
           "decisions": [(d.rid, d.replica, d.reason, d.matched_tokens,
                          d.queue_depth)
                         for d in router.decisions if d.rid in rids],
           "placement": {rid: router._placement[rid] for rid in rids},
           "tokens": {rid: [int(t) for t in router.result(rid).tokens_out]
                      for rid in rids},
           "summary": router.fleet_summary()}

    # session stickiness: three turns of one conversation
    hist = prompt_for("tenant-A")
    homes = []
    for _turn in range(3):
        rid = router.submit(hist, max_new=4, session="chat-0")
        router.drain_all()
        homes.append(router._placement[rid])
        hist = np.concatenate(
            [hist, np.asarray(router.result(rid).tokens_out, np.int32)])
    out.update(session_homes=homes, session_history=[int(t) for t in hist],
               sticky_hits=router.fleet_summary()["router"]["sticky_hits"])
    return out


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve(args.device)
    cfg = get_config("nectar-relu-llama-1.7m")
    params = Model(cfg).init(seeded(device, 0), device=device)

    out = serve(cfg, params, device)
    print(f"fleet on {device_name(device)}: {out['replicas']} replicas x "
          f"{SCFG.n_kv_blocks} blocks, policy={out['policy']}")
    print("\nrouting decisions (rid -> replica, why):")
    for rid, rep, reason, matched, depth in out["decisions"]:
        print(f"    req {rid:2d} ({out['tenants'][rid]}) -> replica {rep}  "
              f"[{reason}, {matched} prefix toks matched, depth {depth}]")
    per_tenant = {}
    for rid, name in out["tenants"].items():
        per_tenant.setdefault(name, set()).add(out["placement"][rid])
    for name, reps in sorted(per_tenant.items()):
        print(f"{name}: served entirely by replica(s) {sorted(reps)}")

    s = out["summary"]
    print("\nper-replica:")
    for rep_id, r in sorted(s["per_replica"].items()):
        h = s["replicas"][rep_id]
        print(f"    replica {rep_id}: {h['dispatched']} requests, "
              f"hit_rate={r['prefix_hit_rate']:.2f}, "
              f"cached_tokens={r['prefix_cached_tokens']}")
    print(f"fleet: {s['tokens_per_s']:.1f} tok/s aggregate, "
          f"hit_rate={s['prefix_hit_rate']:.2f}, "
          f"ttft p50={s['ttft_p50_ms']:.1f}ms, "
          f"router={s['router']['dispatched']} dispatched / "
          f"{s['router']['queued']} queued / {s['router']['shed']} shed")
    print(f"\nsession chat-0: 3 turns -> replica(s) "
          f"{sorted(set(out['session_homes']))} "
          f"(sticky_hits={out['sticky_hits']})")
    return out


if __name__ == "__main__":
    main()
