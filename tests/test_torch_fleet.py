"""The port's serving fleet (serve.fleet, serve.router, dist.elastic) on
the CPU, against the JAX reference's.

Every regime of the reference's ``tests/test_fleet.py`` runs through both
packages on the same weights (``init_params(PRNGKey(0))`` through
``weights.from_jax_params``) and the same seeded prompts, at the
reference tests' ``_scfg`` sizing (no preemption unless a test asks for
it). What must agree, exactly: greedy tokens (and the port's fleet
against the port's single engine), the router's decisions as ``(rid,
replica, reason, matched_tokens)``, placements, session bindings, the
router's counters, replica states, evictions and the integer keys of
``fleet_summary``. Beside them: ``parallel=True`` polling (a thread pool)
against serial polling with sync and async replicas, and
``degrade_mesh`` against the reference's.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import get_config
from repro.dist import elastic as jax_elastic
from repro.models import Model as JaxModel
from repro.serve import api as japi
from repro.serve import fleet as jfleet
from repro.serve import router as jrouter
from repro.serve.engine import Engine as JaxEngine
from repro_torch.configs import base as tbase
from repro_torch.configs import get_config as torch_get_config
from repro_torch.dist import elastic
from repro_torch.serve import api, fleet, router
from repro_torch.serve.engine import Engine
from repro_torch.weights import from_jax_params

# integer keys of fleet_summary that must equal the reference's
INT_KEYS = ("n_replicas", "n_finished", "generated_tokens",
            "prefix_lookups", "prefix_hits", "prefix_cached_tokens",
            "prefill_chunks", "decode_steps", "evictions",
            "fleet_queue_depth")


class Side:
    """One package's fleet surface: the reference's or the port's on the
    CPU."""

    def __init__(self, port, cfg, params):
        self.port, self.cfg, self.params = port, cfg, params
        self.base = tbase if port else jbase
        self.fleet = fleet if port else jfleet
        self.router = router if port else jrouter
        self.Server = api.StreamingServer if port \
            else japi.StreamingServer
        self.dev = {"device": "cpu"} if port else {}

    def scfg(self, **kw):
        base = dict(max_batch=2, max_seq=64, paged=True, prefix_cache=True,
                    block_size=4, n_kv_blocks=32, prefill_chunk=8,
                    max_queue=8)
        base.update(kw)
        return self.base.ServeConfig(**base)

    def build(self, scfg, **kw):
        return self.router.build_fleet(self.cfg, self.params, scfg, **kw,
                                       **self.dev)

    def make_fleet(self, scfg, n):
        return self.fleet.Fleet(self.cfg, self.params, scfg, n_replicas=n,
                                **self.dev)

    def single(self, scfg, prompts, max_new):
        """Greedy tokens of one engine through StreamingServer."""
        cls = Engine if self.port else JaxEngine
        eng = cls(self.cfg, self.params, scfg, **self.dev)
        server = self.Server(eng)
        rids = [server.submit(p, max_new=max_new) for p in prompts]
        server.drain(max_steps=10000)
        return [[int(t) for t in eng._requests[r].tokens_out] for r in rids]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch intra-op thread for the module: beside the other test
    workers, torch's default thread count oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sides():
    cfg = get_config("nectar-relu-llama-1.7m")
    jparams = JaxModel(cfg).init(jax.random.PRNGKey(0))
    tcfg = torch_get_config(cfg.name)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return Side(False, cfg, jparams), Side(True, tcfg, tparams)


def _family_prompts(vocab, n, family_seed, shared=16, seed=1):
    """n prompts sharing one ``shared``-token family prefix, each with a
    unique short tail (the reference tests' traffic)."""
    rng = np.random.default_rng(family_seed)
    head = rng.integers(0, vocab, size=shared, dtype=np.int32)
    tails = np.random.default_rng(seed)
    return [np.concatenate([head, tails.integers(0, vocab, size=3 + i % 3,
                                                 dtype=np.int32)])
            for i in range(n)]


def _decisions(r):
    return [(d.rid, d.replica, d.reason, d.matched_tokens)
            for d in r.decisions]


def _tokens(r, rids):
    return [[int(t) for t in r.result(rid).tokens_out] for rid in rids]


def _both(sides, scenario):
    """Run ``scenario(side)`` for the reference and the port; the port's
    record must equal the reference's. Returns the port's."""
    want, got = (scenario(side) for side in sides)
    assert got == want
    return got


# ---------------------------------------------------------------------------
# construction and entry points


def test_fleet_requires_paged(sides):
    port = sides[1]
    with pytest.raises(ValueError, match="paged"):
        fleet.Fleet(port.cfg, port.params,
                    tbase.ServeConfig(max_batch=2, max_seq=64), n_replicas=2,
                    device="cpu")
    with pytest.raises(ValueError, match="unknown router policy"):
        port.build(port.scfg(), n_replicas=1, policy="nearest")


# ---------------------------------------------------------------------------
# the invariant: routing only places work


@pytest.mark.parametrize("policy", router.POLICIES)
def test_policy_matches_reference(sides, policy):
    """Two families of three prompts through two replicas: the port's
    decisions, placements and tokens equal the reference's, the tokens
    equal a single engine's, and both replicas served."""
    def scenario(side):
        v = side.cfg.vocab
        prompts = (_family_prompts(v, 3, family_seed=10)
                   + _family_prompts(v, 3, family_seed=20))
        r = side.build(side.scfg(), n_replicas=2, policy=policy)
        rids = [r.submit(p, max_new=4) for p in prompts]
        r.drain_all()
        return (_tokens(r, rids), _decisions(r),
                [r._placement[x] for x in rids],
                [rep.dispatched for rep in r.fleet.live()],
                side.single(side.scfg(), prompts, 4))
    toks, _, _, dispatched, single = _both(sides, scenario)
    assert toks == single
    assert all(n > 0 for n in dispatched)


def test_round_robin_cycles(sides):
    def scenario(side):
        r = side.build(side.scfg(), n_replicas=2, policy="round_robin")
        rids = [r.submit(p, max_new=2)
                for p in _family_prompts(side.cfg.vocab, 4, family_seed=3)]
        return [r._placement[x] for x in rids]
    assert _both(sides, scenario) == [0, 1, 0, 1]


def test_affinity_routes_to_warm_replica(sides):
    def scenario(side):
        r = side.build(side.scfg(), n_replicas=2, policy="affinity")
        first, second = _family_prompts(side.cfg.vocab, 2, family_seed=7)
        rid0 = r.submit(first, max_new=2)
        r.drain_all()
        rid1 = r.submit(second, max_new=2)
        out = (r._placement[rid0], r._placement[rid1], _decisions(r))
        r.drain_all()
        return out + (_tokens(r, [rid0, rid1]),)
    home, second, decisions, _ = _both(sides, scenario)
    assert second == home
    assert decisions[-1][2] == "affinity_hit" and decisions[-1][3] > 0


# ---------------------------------------------------------------------------
# session stickiness


def test_session_sticky_waits_for_full_replica(sides):
    def scenario(side):
        r = side.build(side.scfg(max_queue=1), n_replicas=2)
        p1, p2 = _family_prompts(side.cfg.vocab, 2, family_seed=5)
        rid1 = r.submit(p1, max_new=2, session="s")
        rid2 = r.submit(p2, max_new=2, session="s")
        queued = (rid2 in r._placement, r.queue_depth)
        r.drain_all()
        return (r._placement[rid1], r._placement[rid2], queued,
                r.fleet_summary()["router"], _tokens(r, [rid1, rid2]))
    home, later, queued, counters, _ = _both(sides, scenario)
    assert later == home and queued == (False, 1)
    assert counters["sticky_hits"] >= 1


def test_session_sticky_under_preemption(sides):
    def scenario(side):
        r = side.build(side.scfg(n_kv_blocks=8), n_replicas=2)
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, side.cfg.vocab, size=10, dtype=np.int32)
                   for _ in range(3)]
        rids = [r.submit(p, max_new=8, session="s") for p in prompts]
        r.drain_all()
        placed = sorted({r._placement[x] for x in rids})
        home = r.fleet.get(placed[0])
        return (placed, home.engine.metrics.summary()["evictions"],
                _tokens(r, rids), _decisions(r))
    placed, evictions, toks, _ = _both(sides, scenario)
    assert len(placed) == 1 and evictions > 0
    assert all(len(t) == 8 for t in toks)


def test_sticky_fallback_on_drain(sides):
    def scenario(side):
        r = side.build(side.scfg(), n_replicas=2)
        p1, p2 = _family_prompts(side.cfg.vocab, 2, family_seed=9)
        rid1 = r.submit(p1, max_new=2, session="s")
        home = r._placement[rid1]
        r.drain_all()
        r.fleet.drain(home)
        rid2 = r.submit(p2, max_new=2, session="s")
        out = (home, r._placement[rid2], r.sessions["s"],
               r.fleet_summary()["router"]["session_rerouted"])
        r.drain_all()
        return out + (_tokens(r, [rid1, rid2]),)
    home, other, bound, rerouted, _ = _both(sides, scenario)
    assert other != home and bound == other and rerouted >= 1


# ---------------------------------------------------------------------------
# lifecycle: drain / reap / results after removal / scale-down


def test_drain_finishes_inflight_then_reaps(sides):
    def scenario(side):
        r = side.build(side.scfg(), n_replicas=2)
        prompts = _family_prompts(side.cfg.vocab, 4, family_seed=11)
        rids = [r.submit(p, max_new=3) for p in prompts]
        victim = r._placement[rids[0]]
        r.fleet.drain(victim)
        rep = r.fleet.get(victim)
        during = (rep.state.value, rep.accepting, rep.probe(prompts[0]))
        r.drain_all()
        return (during, victim in r.fleet.replicas,
                r.fleet.get(victim).state.value, _tokens(r, rids))
    during, still_live, state, toks = _both(sides, scenario)
    assert during == ("draining", False, 0)
    assert not still_live and state == "stopped"
    assert all(len(t) == 3 for t in toks)


def test_scale_down_floors_at_one(sides):
    def scenario(side):
        f = side.make_fleet(side.scfg(), 3)
        out = [f.scale_down(1)]
        f.reap()
        out.append(sorted(f.replicas))
        out.append(f.scale_down(10))
        f.reap()
        out.append(sorted(f.replicas))
        out.append(f.scale_down(1))
        out.append(f.replicas[0].state.value)
        out.append(f.reshard_surviving())
        return out
    assert _both(sides, scenario) == [[2], [0, 1], [1], [0], [],
                                      "active", 0]


def test_scale_down_keeps_inflight_tokens(sides):
    """scale_down(1) drains the youngest replica while it serves; its
    in-flight requests finish with the tokens a single engine gives, and
    reap retires it once idle."""
    def scenario(side):
        r = side.build(side.scfg(), n_replicas=2, policy="round_robin")
        prompts = _family_prompts(side.cfg.vocab, 4, family_seed=17)
        rids = [r.submit(p, max_new=4) for p in prompts]
        r.poll()
        victims = r.fleet.scale_down(1)
        r.drain_all()
        return (victims, sorted(r.fleet.replicas), sorted(r.fleet.stopped),
                _tokens(r, rids), side.single(side.scfg(), prompts, 4))
    victims, live, stopped, toks, single = _both(sides, scenario)
    assert victims == [1] and live == [0] and stopped == [1]
    assert toks == single


@pytest.mark.parametrize("shape,n_failed", [
    ((4, 2), 1), ((4, 2), 3), ((4, 2), 7), ((2,), 1), ((1,), 1),
    ((8, 4, 2), 2), ((4, 2), 0), ((3, 1), 2)])
def test_degrade_mesh_matches_reference(shape, n_failed):
    assert elastic.degrade_mesh(shape, n_failed) \
        == jax_elastic.degrade_mesh(shape, n_failed)


# ---------------------------------------------------------------------------
# the bounded router queue and up-front rejection


def test_router_overflow_bounded_queue(sides):
    def scenario(side):
        r = side.build(side.scfg(max_queue=1), n_replicas=1, max_queue=2)
        prompts = _family_prompts(side.cfg.vocab, 4, family_seed=13)
        rids = [r.submit(p, max_new=2) for p in prompts[:3]]
        depth = r.registry.collect()["fleet_queue_depth"]
        with pytest.raises(side.router.FleetSaturated):
            r.submit(prompts[3], max_new=2)
        shed = r.fleet_summary()["router"]["shed"]
        r.drain_all()
        return depth, shed, r.queue_depth, _tokens(r, rids)
    depth, shed, left, _ = _both(sides, scenario)
    assert (depth, shed, left) == (2, 1, 0)


def test_prompt_too_long_rejected_upfront(sides):
    port = sides[1]
    r = port.build(port.scfg(), n_replicas=2)
    with pytest.raises(ValueError, match="max_seq"):
        r.submit(np.zeros(64, np.int32), max_new=2)


# ---------------------------------------------------------------------------
# aggregated metrics


def test_fleet_summary_aggregates(sides):
    def scenario(side):
        r = side.build(side.scfg(), n_replicas=2)
        v = side.cfg.vocab
        prompts = (_family_prompts(v, 2, family_seed=15)
                   + _family_prompts(v, 2, family_seed=16))
        rids = [r.submit(p, max_new=3) for p in prompts]
        r.drain_all()
        s = r.fleet_summary()
        return ({k: s[k] for k in INT_KEYS}, s["router"],
                sorted(s["replicas"]),
                {i: {k: h[k] for k in ("state", "accepting", "busy",
                                       "queue_depth", "admission_free",
                                       "dispatched")}
                 for i, h in s["replicas"].items()},
                [p["generated_tokens"] for p in s["per_replica"].values()],
                sorted(s), _tokens(r, rids))
    ints, counters, replicas, _, per_rep, keys, _ = _both(sides, scenario)
    assert ints["n_replicas"] == 2 and ints["n_finished"] == 4
    assert ints["generated_tokens"] == 12 == sum(per_rep)
    assert counters["dispatched"] == 4 and replicas == [0, 1]
    port = sides[1]
    r = port.build(port.scfg(), n_replicas=2)
    r.submit(_family_prompts(port.cfg.vocab, 1, family_seed=15)[0],
             max_new=2)
    r.drain_all()
    assert r.fleet_summary()["tokens_per_s"] > 0


# ---------------------------------------------------------------------------
# parallel polling


@pytest.mark.parametrize("async_k", [0, 1, 4],
                         ids=["sync", "async_overlap", "async_loop4"])
def test_parallel_polling_keeps_tokens(sides, async_k):
    """``parallel=True`` ticks the busy replicas from a thread pool: the
    same tokens, decisions and per-replica counters as serial polling,
    with sync and with async replicas."""
    port = sides[1]
    acfg = None if not async_k else tbase.AsyncConfig(
        enabled=True, max_device_ticks=async_k)
    prompts = (_family_prompts(port.cfg.vocab, 3, family_seed=21)
               + _family_prompts(port.cfg.vocab, 3, family_seed=22))
    out = []
    for parallel in (False, True):
        r = port.build(port.scfg(async_cfg=acfg), n_replicas=2,
                       parallel=parallel)
        rids = [r.submit(p, max_new=6) for p in prompts]
        r.drain_all()
        s = r.fleet_summary()
        out.append((_tokens(r, rids), _decisions(r),
                    {k: s[k] for k in INT_KEYS}))
    assert out[1] == out[0]
    assert out[0][0] == port.single(port.scfg(), prompts, 6)


def test_launch_counters_count_each_thread_apart():
    """The launch counters under threads (a router polling replicas from a
    pool): concurrent launches and replays lose no count, and a capture's
    tally takes only the capturing thread's launches. Sixteen threads on
    a shortened switch interval; every join is bounded."""
    import sys
    import threading
    from repro_torch.kernels import build
    saved = dict(build.LAUNCHES)
    interval = sys.getswitchinterval()
    n_threads, n_iter = 16, 2000
    tallies, errors = [], []
    barrier = threading.Barrier(n_threads + 1, timeout=60)

    def launcher():
        try:
            barrier.wait()
            for _ in range(n_iter):
                build.count_launch("paged_attention")
                build.add_replay({"sparse_gather_matvec": 1}, 2)
        except Exception as exc:                  # reported below
            errors.append(exc)

    def capturer():
        with build.capturing() as tally:
            barrier.wait()
            for _ in range(n_iter):
                build.count_launch("decode_attention")
        tallies.append(tally)
    try:
        sys.setswitchinterval(1e-6)
        for key in build.LAUNCHES:
            build.LAUNCHES[key] = 0
        threads = [threading.Thread(target=launcher)
                   for _ in range(n_threads - 1)]
        threads.append(threading.Thread(target=capturer))
        for t in threads:
            t.start()
        barrier.wait()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads) and not errors
        n = (n_threads - 1) * n_iter
        assert build.LAUNCHES["paged_attention"] == n
        assert build.LAUNCHES["sparse_gather_matvec"] == 2 * n
        assert build.LAUNCHES["decode_attention"] == 0
        assert tallies == [dict(dict.fromkeys(build.LAUNCHES, 0),
                                decode_attention=n_iter)]
    finally:
        sys.setswitchinterval(interval)
        build.LAUNCHES.update(saved)
