"""Four serving examples of the port (``repro_torch.examples``:
streaming_serve, sharded_serve, disagg_serve, fleet_serve) on the CPU,
each against the same calls made through the reference's API at the
example's settings, on the reference's weights
(``Model(cfg).init(PRNGKey(0))`` through ``from_jax_params``): greedy
tokens (and the seeded sampled row) identical, integer counters and
routing decisions equal. The mesh example runs on ``["cpu"] * 4`` and is
held to the reference's single-device engine. Each ``main`` also runs
under ``--device cpu``.
"""

import importlib.util
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs.base import DisaggConfig as JaxDisaggConfig
from repro.configs.base import ObsConfig as JaxObsConfig
from repro.configs.base import ServeConfig as JaxServeConfig
from repro.models import Model as JaxModel
from repro.serve import api as jax_api
from repro.serve.disagg import DisaggCoordinator as JaxDisagg
from repro.serve.engine import Engine as JaxEngine
from repro.serve.router import build_fleet as jax_build_fleet
from repro.serve.sampling import SamplingParams as JaxSamplingParams
from repro.serve.scheduler import Request as JaxRequest
from repro_torch.configs import get_config as torch_get_config
from repro_torch.examples import (disagg_serve, fleet_serve, sharded_serve,
                                  streaming_serve)
from repro_torch.weights import from_jax_params

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the module: the serves' small eager ops crawl
    when torch's threads oversubscribe a host that runs other test
    workers."""
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


def int_keys(summary):
    return {k: v for k, v in summary.items()
            if isinstance(v, int) and not isinstance(v, bool)}


def _reference_example(name):
    """A script of ``examples/`` as a module (its functions, not main)."""
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# streaming_serve


def _reference_streaming(cfg, params):
    """examples/streaming_serve.py's calls, results kept."""
    rng = np.random.default_rng(0)
    eng = JaxEngine(cfg, params, JaxServeConfig(
        max_batch=2, max_seq=96, paged=True, block_size=8,
        prefill_chunk=16, policy="priority"))
    out = {"pool_blocks": eng.pool.n_blocks}
    prompt = rng.integers(0, cfg.vocab, size=9, dtype=np.int32)
    out["stream"] = [int(t) for t in jax_api.generate(eng, prompt,
                                                      max_new=8)]
    srv = jax_api.StreamingServer(eng)
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
                   sampling=JaxSamplingParams(temperature=0.8, top_k=32,
                                              seed=7, logprobs=True))
    done = srv.drain()
    greedy = [int(x) for x in done[g].tokens_out]
    stop = tuple(greedy[2:4])
    s_rid = srv.submit(prompt, max_new=8,
                       sampling=JaxSamplingParams(stop=(stop,)))
    done = srv.drain()
    out.update(greedy=greedy, sampled=[int(x) for x in done[t].tokens_out],
               sampled_logprob0=float(done[t].logprobs_out[0]), stop=stop,
               stopped=[int(x) for x in done[s_rid].tokens_out],
               summary=eng.metrics.summary(), pool=eng.pool.stats())
    return out


def test_streaming_serve_equals_the_references(nectar):
    cfg, jparams, tcfg, tparams = nectar
    got = streaming_serve.serve(tcfg, tparams, "cpu")
    want = _reference_streaming(cfg, jparams)
    for key in ("pool_blocks", "stream", "long_rid", "short_rids", "batch",
                "greedy", "sampled", "stop", "stopped"):
        assert got[key] == want[key], key
    assert got["sampled_logprob0"] == pytest.approx(want["sampled_logprob0"],
                                                    abs=1e-4)
    assert int_keys(got["summary"]) == int_keys(want["summary"])
    assert int_keys(got["pool"]) == int_keys(want["pool"])


# ---------------------------------------------------------------------------
# sharded_serve


def test_sharded_serve_equals_the_references_single_device(nectar):
    cfg, jparams, tcfg, tparams = nectar
    prompts = sharded_serve.prompts(tcfg)
    single, eng1 = sharded_serve.serve(tcfg, tparams, "cpu", prompts)
    from repro_torch.configs.base import MeshConfig
    sharded, eng4 = sharded_serve.serve(tcfg, tparams, "cpu", prompts,
                                        mesh=MeshConfig(model=4))
    jeng = JaxEngine(cfg, jparams, JaxServeConfig(
        max_batch=4, max_seq=96, paged=True, block_size=8, prefill_chunk=16,
        prefix_cache=True))
    done = jeng.run([JaxRequest(rid=i, prompt=p, max_new=12)
                     for i, p in enumerate(prompts)], max_steps=3000)
    want = {i: [int(t) for t in r.tokens_out] for i, r in done.items()}
    assert single == want and sharded == want
    s1, s4 = eng1.metrics.summary(), eng4.metrics.summary()
    assert int_keys(s1) == int_keys(jeng.metrics.summary())
    assert int_keys(s4) == int_keys(s1)
    assert s4["prefix_hits"] == 2
    pool = s4["kv_pool"]
    assert pool["model_shards"] == 4
    assert pool["per_shard_capacity_bytes"] * 4 == pool["capacity_bytes"]
    assert s4["mesh"]["shape"] == {"data": 1, "model": 4}


def test_sharded_serve_main_checks_token_identity(capsys):
    out = sharded_serve.main(["--device", "cpu"])
    assert out["sharded"] == out["single"]
    assert "token-identity over 6 requests" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# disagg_serve


def _reference_run(ref, system, cfg):
    ref.warm(system)
    toks = ref.drive(system, ref.make_trace(cfg))
    waste, mixed = ref.decode_width_waste(system.tracer.tick_stats)
    return {"tokens": toks, "waste": waste, "mixed_ticks": mixed,
            "summary": system.metrics.summary()}


def test_disagg_serve_equals_the_references(nectar):
    cfg, jparams, tcfg, tparams = nectar
    got = disagg_serve.serve(tcfg, tparams, "cpu")
    ref = _reference_example("disagg_serve")
    scfg = JaxServeConfig(max_batch=4, max_seq=128, paged=True,
                          block_size=8, n_kv_blocks=128, prefill_chunk=16,
                          max_queue=8, obs=JaxObsConfig(enabled=True))
    mono = _reference_run(ref, JaxEngine(cfg, jparams, scfg), cfg)
    coord = JaxDisagg(cfg, jparams, scfg, dcfg=JaxDisaggConfig())
    dis = _reference_run(ref, coord, cfg)
    for mine, want in ((got["mono"], mono), (got["disagg"], dis)):
        assert mine["tokens"] == want["tokens"]
        assert mine["mixed_ticks"] == want["mixed_ticks"]
        assert mine["waste"] == want["waste"]
        assert int_keys(mine["summary"]) == int_keys(want["summary"])
    assert got["mono"]["tokens"] == got["disagg"]["tokens"]
    assert got["disagg"]["summary"]["n_handoffs"] == 5   # every request
    assert [name for _, name, _ in got["disagg"]["timeline"]] \
        == [ev.name for ev in coord.tracer.timeline(100)]


def test_disagg_serve_main_checks_identity(capsys):
    disagg_serve.main(["--device", "cpu"])
    assert "token-identical to monolithic" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# fleet_serve


def _reference_fleet(cfg, params):
    """examples/fleet_serve.py's calls, results kept."""
    rng = np.random.default_rng(0)
    scfg = JaxServeConfig(max_batch=2, max_seq=96, paged=True,
                          prefix_cache=True, block_size=8, n_kv_blocks=48,
                          prefill_chunk=16, max_queue=4)
    router = jax_build_fleet(cfg, params, scfg, n_replicas=2,
                             policy="affinity")
    families = {name: rng.integers(0, cfg.vocab, 32, dtype=np.int32)
                for name in ("tenant-A", "tenant-B")}

    def prompt_for(name):
        tail = rng.integers(0, cfg.vocab, int(rng.integers(4, 10)),
                            dtype=np.int32)
        return np.concatenate([families[name], tail])

    rids = {}
    for name in families:
        rids[router.submit(prompt_for(name), max_new=6)] = name
    router.drain_all()
    for i in range(8):
        name = ("tenant-A", "tenant-B")[i % 2]
        rids[router.submit(prompt_for(name), max_new=6)] = name
    router.drain_all()
    out = {"tenants": rids,
           "decisions": [(d.rid, d.replica, d.reason, d.matched_tokens,
                          d.queue_depth)
                         for d in router.decisions if d.rid in rids],
           "placement": {rid: router._placement[rid] for rid in rids},
           "tokens": {rid: [int(t) for t in router.result(rid).tokens_out]
                      for rid in rids},
           "summary": router.fleet_summary()}
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


def test_fleet_serve_equals_the_references(nectar):
    cfg, jparams, tcfg, tparams = nectar
    got = fleet_serve.serve(tcfg, tparams, "cpu")
    want = _reference_fleet(cfg, jparams)
    for key in ("tenants", "decisions", "placement", "tokens",
                "session_homes", "session_history", "sticky_hits"):
        assert got[key] == want[key], key
    assert int_keys(got["summary"]["router"]) \
        == int_keys(want["summary"]["router"])
    for rep_id, r in want["summary"]["per_replica"].items():
        assert int_keys(got["summary"]["per_replica"][rep_id]) \
            == int_keys(r), rep_id
    assert got["replicas"] == 2 and got["policy"] == "affinity"


def test_fleet_serve_main_runs(capsys):
    out = fleet_serve.main(["--device", "cpu"])
    assert out["sticky_hits"] == 2
    assert "session chat-0" in capsys.readouterr().out


def test_streaming_serve_main_runs(capsys):
    out = streaming_serve.main(["--device", "cpu"])
    assert len(out["stream"]) == 8
    assert "truncated before the match" in capsys.readouterr().out
