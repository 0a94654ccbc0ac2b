"""The port's async engine core on the CPU, against its synchronous engine
and against the reference's async engine.

The harness is the reference's (``tests/test_async_differential.py``):
the same ``_scfg`` defaults, ``_drive`` with per-request arrival ticks,
``_results`` and the ``_differential`` oracle, run on the port's
``Engine(device="cpu")`` with the reference's weights
(``init_params(PRNGKey(0))`` through ``weights.from_jax_params``). For
every flavor of ``FLAVORS`` and every directed regime of the reference
file the port's async engine must give its synchronous engine's tokens,
``done`` and ``n_generated`` exactly, logprobs within 1e-3; the
reference's async engine must give the same tokens and the same integer
``async_stats()``. Beside them: the port's ``transformer.decode_burst``
against the reference's, the sync-free paged KV write against the
reference's drop-mode scatter, and the async CLI and engine surfaces.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config
from repro.configs.base import AsyncConfig as JaxAsyncConfig
from repro.configs.base import ServeConfig as JaxServeConfig
from repro.configs.base import SpecConfig as JaxSpecConfig
from repro.models import Model as JaxModel
from repro.models import attention as jax_attention
from repro.models import transformer as jax_transformer
from repro.serve import sampling as jax_sampling
from repro.serve.engine import Engine as JaxEngine
from repro.serve.sampling import SamplingParams as JaxSamplingParams
from repro.serve.scheduler import Request as JaxRequest
from repro_torch.configs import get_config as torch_get_config
from repro_torch.configs.base import AsyncConfig, ServeConfig, SpecConfig
from repro_torch.models import Model
from repro_torch.models import attention, transformer
from repro_torch.serve import sampling
from repro_torch.serve.engine import Engine
from repro_torch.serve.runner import STOP_L, STOP_NS
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.scheduler import Request
from repro_torch.weights import from_jax_params

# the reference file's flavors, as AsyncConfig keywords
OVERLAP = dict(enabled=True, max_device_ticks=1)
LOOP4 = dict(enabled=True, max_device_ticks=4)
LOOP6 = dict(enabled=True, max_device_ticks=6)
LOOP4_SYNC2 = dict(enabled=True, max_device_ticks=4, sync_every=2)
FLAVORS = (OVERLAP, LOOP4, LOOP6, LOOP4_SYNC2)
FLAVOR_IDS = ("overlap", "loop4", "loop6", "loop4_sync2")
STAT_KEYS = ("sync_ticks", "overlap_ticks", "loop_bursts",
             "loop_device_ticks", "device_ticks")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch intra-op thread for the module: the engines here run
    many small ops next to other test workers, and torch's default of
    one thread per core then oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def nectar():
    return load_nectar()


def load_nectar():
    cfg = get_config("nectar-relu-llama-1.7m")
    jparams = JaxModel(cfg).init(jax.random.PRNGKey(0))
    tcfg = torch_get_config(cfg.name)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return cfg, jparams, tcfg, tparams


# ---------------------------------------------------------------------------
# the harness: blueprints are (rid, prompt, max_new, SamplingParams
# keywords), so that each package builds its own requests


def _scfg(side, async_cfg=None, spec=None, **kw):
    kw.setdefault("max_batch", 3)
    kw.setdefault("max_seq", 64)
    kw.setdefault("paged", True)
    kw.setdefault("block_size", 8)
    kw.setdefault("prefill_chunk", 16)
    S, A, SC = ((ServeConfig, AsyncConfig, SpecConfig) if side == "port"
                else (JaxServeConfig, JaxAsyncConfig, JaxSpecConfig))
    return S(async_cfg=None if async_cfg is None else A(**async_cfg),
             spec=None if spec is None else SC(**spec), **kw)


def _engine(nectar, side, **kw):
    cfg, jparams, tcfg, tparams = nectar
    if side == "port":
        return Engine(tcfg, tparams, _scfg(side, **kw), device="cpu")
    return JaxEngine(cfg, jparams, _scfg(side, **kw))


def _drive(eng, reqs, arrivals):
    """Run the engine with a per-request arrival tick (engine ticks, so
    the async engine sees arrivals earlier in device time)."""
    pending = sorted(zip(arrivals, reqs), key=lambda t: (t[0], t[1].rid))
    tick = 0
    while pending or eng._busy():
        while pending and pending[0][0] <= tick \
                and eng.add_request(pending[0][1]):
            pending.pop(0)
        eng.step()
        tick += 1
        assert tick < 4000, "engine failed to drain"


def _results(eng, reqs):
    out = {}
    for r in reqs:
        m = eng.metrics.requests.get(r.rid)
        out[r.rid] = {
            "tokens": [int(t) for t in r.tokens_out],
            "logprobs": [float(x) for x in r.logprobs_out],
            "done": r.done,
            "n_generated": None if m is None else m.n_generated,
        }
    return out


def _fresh_requests(blueprints, side="port"):
    R, SP = ((Request, SamplingParams) if side == "port"
             else (JaxRequest, JaxSamplingParams))
    return [R(rid=rid, prompt=np.asarray(p, np.int32), max_new=mn,
              sampling=SP(**sp))
            for rid, p, mn, sp in blueprints]


def _run(nectar, side, blueprints, arrivals, **kw):
    reqs = _fresh_requests(blueprints, side)
    eng = _engine(nectar, side, **kw)
    _drive(eng, reqs, arrivals)
    return _results(eng, reqs), eng


def _same(a, b):
    if not b:
        return False
    if (a["tokens"], a["done"], a["n_generated"]) \
            != (b["tokens"], b["done"], b["n_generated"]):
        return False
    return len(a["logprobs"]) == len(b["logprobs"]) and all(
        abs(x - y) <= 1e-3 for x, y in zip(a["logprobs"], b["logprobs"]))


def differential(nectar, blueprints, arrivals, async_cfg, reference=True,
                 **scfg_kw):
    """THE oracle: the workload through the port's synchronous engine and
    its async engine (tokens, done and n_generated exact, logprobs within
    1e-3, the same totals), and, with ``reference``, through the
    reference's async engine (the same tokens and done, the same integer
    async_stats). Returns the engines (port sync, port async, reference
    async or None)."""
    want, sync_eng = _run(nectar, "port", blueprints, arrivals, **scfg_kw)
    got, async_eng = _run(nectar, "port", blueprints, arrivals,
                          async_cfg=async_cfg, **scfg_kw)
    assert all(_same(want[r], got.get(r, {})) for r in want), (
        f"async {async_cfg} diverged from the synchronous engine:\n"
        + "\n".join(f"rid {r}:\n  sync  {want[r]}\n  async {got[r]}"
                    for r in want if not _same(want[r], got.get(r, {}))))
    s_sync = sync_eng.metrics.summary()
    s_async = async_eng.metrics.summary()
    assert s_async["n_finished"] == s_sync["n_finished"] == len(blueprints)
    assert sum(len(v["tokens"]) for v in got.values()) \
        == sum(len(v["tokens"]) for v in want.values())
    ref_eng = None
    if reference:
        ref, ref_eng = _run(nectar, "reference", blueprints, arrivals,
                            async_cfg=async_cfg, **scfg_kw)
        for r in want:
            assert (got[r]["tokens"], got[r]["done"]) \
                == (ref[r]["tokens"], ref[r]["done"]), (r, got[r], ref[r])
        mine, theirs = async_eng.async_stats(), ref_eng.async_stats()
        assert {k: mine[k] for k in STAT_KEYS} \
            == {k: theirs[k] for k in STAT_KEYS}, (mine, theirs)
    return sync_eng, async_eng, ref_eng


def greedy_blueprints(cfg, lengths, max_new=10, seed=0, sp=None):
    rng = np.random.default_rng(seed)
    sp = sp or {}
    return [(i, rng.integers(0, cfg.vocab, size=int(n)), max_new, sp)
            for i, n in enumerate(lengths)]


def _probe(nectar, blueprints, arrivals, **kw):
    """The port's synchronous tokens for ``blueprints``."""
    reqs = _fresh_requests(blueprints)
    _drive(_engine(nectar, "port", **kw), reqs, arrivals)
    return reqs


# ---------------------------------------------------------------------------
# directed regimes, each for every flavor

flavors = pytest.mark.parametrize("acfg", FLAVORS, ids=FLAVOR_IDS)


@flavors
def test_plain_greedy(nectar, acfg):
    cfg = nectar[0]
    bp = greedy_blueprints(cfg, [5, 21, 9])
    _, eng, _ = differential(nectar, bp, [0, 0, 2], acfg)
    st_ = eng.async_stats()
    if acfg["max_device_ticks"] > 1:
        assert st_["loop_bursts"] > 0
    else:
        assert st_["overlap_ticks"] > 0


@flavors
def test_plain_greedy_through_the_flash_read(nectar, acfg):
    """attn_backend="flash", the main path's read (on the CPU its plain
    version), port async against port sync."""
    cfg = nectar[0]
    bp = greedy_blueprints(cfg, [5, 21, 9], seed=1)
    differential(nectar, bp, [0, 0, 2], acfg, reference=False,
                 attn_backend="flash")


@flavors
def test_sampled_rows(nectar, acfg):
    """Seeded on-device sampling: the async paths draw the same
    per-request key sequence (the draw counters advance identically)."""
    cfg = nectar[0]
    sp = dict(temperature=0.7, top_k=12, top_p=0.9, seed=3, logprobs=True)
    mixed = dict(logprobs=True)            # greedy rows ride along
    bp = [(0, np.arange(7) % cfg.vocab, 9, sp),
          (1, np.arange(13) % cfg.vocab, 12, mixed),
          (2, (np.arange(5) * 3) % cfg.vocab, 8, sp)]
    differential(nectar, bp, [0, 1, 1], acfg)


@flavors
def test_stop_sequences_span_burst_boundary(nectar, acfg):
    """Stops taken from the synchronous engine's own output so that a
    match crosses a burst boundary, one falls inside a burst and one
    never matches: the device's early exit and the host's replay
    agree."""
    cfg = nectar[0]
    probe = _probe(nectar, greedy_blueprints(cfg, [6, 11], max_new=14),
                   [0, 0])
    assert all(len(r.tokens_out) == 14 for r in probe)
    stops0 = (tuple(probe[0].tokens_out[3:5]),)
    stops1 = (tuple(probe[1].tokens_out[5:7]), (cfg.vocab - 1,) * 3)
    bp = [(0, np.asarray(probe[0].prompt), 14, dict(stop=stops0)),
          (1, np.asarray(probe[1].prompt), 14,
           dict(stop=stops1, logprobs=True))]
    sync_eng, _, _ = differential(nectar, bp, [0, 0], acfg)
    assert len(sync_eng._requests[0].tokens_out) < 14   # the stop fired


@flavors
def test_long_stop_matches_on_the_host(nectar, acfg):
    """A stop longer than the device window (STOP_L) cannot end a row on
    the device: the replay still truncates identically."""
    cfg = nectar[0]
    probe = _probe(nectar, greedy_blueprints(cfg, [9], max_new=12), [0])
    long_stop = tuple(probe[0].tokens_out[2:2 + STOP_L + 2])
    assert len(long_stop) > STOP_L
    bp = [(0, np.asarray(probe[0].prompt), 12, dict(stop=(long_stop,)))]
    _, eng, _ = differential(nectar, bp, [0], acfg)
    if acfg["max_device_ticks"] > 1:
        assert eng.async_stats()["loop_bursts"] > 0


@flavors
def test_preemption_pressure(nectar, acfg):
    """A pool too small for the load: eviction and replay are sync work;
    async ticks fall back to sync when an allocation would need a
    victim."""
    cfg = nectar[0]
    bp = greedy_blueprints(cfg, [20, 20, 18], max_new=14, seed=5)
    sync_eng, _, _ = differential(nectar, bp, [0, 0, 1], acfg, max_batch=2,
                                  n_kv_blocks=8, prefill_chunk=8)
    assert sync_eng.metrics.summary()["evictions"] > 0


@flavors
def test_shared_prefix_cache(nectar, acfg):
    """Prefix-cache hits change the block layout, never values; staggered
    arrivals let a same-prefix request wait while the async engine runs
    decode ticks."""
    cfg = nectar[0]
    rng = np.random.default_rng(11)
    shared = rng.integers(0, cfg.vocab, size=16)
    bp = [(0, shared, 10, {}),
          (1, np.concatenate([shared, rng.integers(0, cfg.vocab, size=5)]),
           10, {}),
          (2, shared.copy(), 8, {})]
    _, eng, _ = differential(nectar, bp, [0, 3, 6], acfg, prefix_cache=True)
    assert eng.metrics.summary()["prefix_hits"] > 0


@flavors
def test_spec_decode_falls_back_to_sync(nectar, acfg):
    """Speculative engines never take async ticks: async_cfg composes as a
    no-op."""
    cfg = nectar[0]
    bp = greedy_blueprints(cfg, [12, 12], max_new=10, seed=7)
    _, eng, _ = differential(nectar, bp, [0, 0], acfg,
                             spec=dict(drafter="ngram", k=3), max_seq=96)
    st_ = eng.async_stats()
    assert st_["loop_bursts"] == 0 and st_["overlap_ticks"] == 0
    assert st_["sync_ticks"] > 0


@flavors
def test_int8_kv_quantization(nectar, acfg):
    """int8 KV rounding happens inside forward_step on both paths: the
    async iteration quantizes exactly as the per-tick engine."""
    cfg = nectar[0]
    bp = greedy_blueprints(cfg, [9, 17], max_new=10, seed=9)
    differential(nectar, bp, [0, 0], acfg, kv_quant=True)


@flavors
def test_repetition_penalty_forces_sync(nectar, acfg):
    """Rep-penalty rows sample against live host presence: any such row
    pins the engine to sync ticks."""
    cfg = nectar[0]
    sp = dict(temperature=0.8, repetition_penalty=1.3, seed=2)
    bp = [(0, np.arange(8) % cfg.vocab, 10, sp),
          (1, np.arange(6) % cfg.vocab, 10, {})]
    _, eng, _ = differential(nectar, bp, [0, 0], acfg)
    st_ = eng.async_stats()
    assert st_["loop_bursts"] == 0 and st_["overlap_ticks"] == 0


@flavors
def test_forced_sync_cadence(nectar, acfg):
    """sync_every bounds reconcile latency: every 2nd tick runs sync even
    in pure-decode steady state."""
    cfg = nectar[0]
    bp = greedy_blueprints(cfg, [5], max_new=16, seed=13)
    _, eng, _ = differential(nectar, bp, [0], dict(acfg, sync_every=2))
    assert eng.async_stats()["sync_ticks"] >= 3


@flavors
def test_max_seq_ceiling_finish(nectar, acfg):
    """Requests that reach the context ceiling mid-burst finish at the
    same token as in the synchronous engine."""
    cfg = nectar[0]
    bp = greedy_blueprints(cfg, [24, 26], max_new=40, seed=15)
    differential(nectar, bp, [0, 0], acfg, max_seq=32)


def test_async_config_fields_and_refusals(nectar):
    """AsyncConfig has the reference's fields and defaults; the slot
    engine refuses async as the reference's does, and max_device_ticks
    must be >= 1."""
    _, _, tcfg, tparams = nectar
    assert AsyncConfig() == AsyncConfig(enabled=False, max_device_ticks=8,
                                        sync_every=0)
    assert {f: getattr(AsyncConfig(), f) for f in
            ("enabled", "max_device_ticks", "sync_every")} \
        == {f: getattr(JaxAsyncConfig(), f) for f in
            ("enabled", "max_device_ticks", "sync_every")}
    with pytest.raises(ValueError, match="paged=True"):
        Engine(tcfg, tparams, ServeConfig(async_cfg=AsyncConfig(
            enabled=True)), device="cpu")
    with pytest.raises(ValueError, match="max_device_ticks"):
        Engine(tcfg, tparams, ServeConfig(paged=True, async_cfg=AsyncConfig(
            enabled=True, max_device_ticks=0)), device="cpu")


def test_flush_async_commits_the_pending_tick(nectar):
    """flush_async (also run by defrag) commits the in-flight overlap
    tick; the rids it finishes come out of the next step()."""
    cfg = nectar[0]
    reqs = _fresh_requests(greedy_blueprints(cfg, [5, 7], max_new=4))
    eng = _engine(nectar, "port", async_cfg=OVERLAP)
    for r in reqs:
        eng.add_request(r)
    while eng._pending is None:
        eng.step()
    before = [len(r.tokens_out) for r in reqs]
    eng.flush_async()
    assert eng._pending is None
    assert [len(r.tokens_out) for r in reqs] == [n + 1 for n in before]
    eng.step()
    assert eng._pending is not None
    eng.defrag()
    assert eng._pending is None
    done = set()
    while eng._busy():
        done.update(eng.step())
    done.update(eng.step())
    assert done == {0, 1}
    assert all(len(r.tokens_out) == 4 for r in reqs)


# ---------------------------------------------------------------------------
# transformer.decode_burst against the reference's


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_decode_burst_matches_reference(nectar, sampled):
    """Same weights, cache, tables, tok0, lens0, alive0, budgets, stops and
    hist0 (a dead row, a stop that fires, a budget of 1): emitted, n_emit
    and lens exact, lp within 1e-5, pools within 2e-4."""
    cfg, jparams, tcfg, tparams = nectar
    B, NB, BS, MB, K = 4, 24, 8, 6, 6
    rng = np.random.default_rng(21 + sampled)
    lens0 = np.array([5, 17, 9, 30], np.int32)
    alive0 = np.array([1, 1, 0, 1], np.int32)
    budget = np.array([6, 1, 4, 5], np.int32)
    tables = np.full((B, MB), NB, np.int32)
    free = list(rng.permutation(NB))
    for b in range(B):
        n = -(-(int(lens0[b]) + K) // BS)
        tables[b, :n] = [free.pop() for _ in range(n)]
    shape = (cfg.n_units, NB, BS, cfg.n_kv_heads, cfg.d_head)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    tok0 = rng.integers(0, cfg.vocab, B).astype(np.int32)
    hist0 = np.full((B, STOP_L), -1, np.int32)
    hist0[:, -2:] = rng.integers(0, cfg.vocab, (B, 2))
    temp = np.array([0.8, 0.0, 1.0, 0.6], np.float32)
    top_k = np.array([0, 0, 20, 5], np.int32)
    top_p = np.array([1.0, 1.0, 0.9, 1.0], np.float32)
    keys = np.stack([[sampling.request_key(7, b, j) for b in range(B)]
                     for j in range(K)])

    def reference(stops, stop_len):
        jc = JaxModel(cfg).init_paged_cache(B, NB, BS, MB, jnp.float32)
        jc["units"]["b0"] = {"k": jnp.asarray(k), "v": jnp.asarray(v)}
        if sampled:
            def sample_fn(last, i):
                return jax_sampling._sample_batch(
                    last, jnp.zeros((B, 1), bool), jnp.asarray(temp),
                    jnp.asarray(top_k), jnp.asarray(top_p),
                    jnp.ones((B,), jnp.float32),
                    jnp.asarray(keys.astype(np.uint32))[i])
        else:
            def sample_fn(last, i):
                return jax_sampling._greedy_batch(last)
        em, lp, jc, lens, n_emit = jax_transformer.decode_burst(
            jparams, cfg, jc, jnp.asarray(tables), jnp.asarray(tok0),
            jnp.asarray(lens0), jnp.asarray(alive0), jnp.asarray(budget),
            jnp.asarray(stops), jnp.asarray(stop_len), jnp.asarray(hist0),
            sample_fn, BS, "naive", jnp.asarray(K, jnp.int32), K)
        return [np.asarray(a) for a in (em, lp, lens, n_emit,
                                        jc["units"]["b0"]["k"],
                                        jc["units"]["b0"]["v"])]

    def port(stops, stop_len):
        tc = Model(tcfg).init_paged_cache(B, NB, BS, MB, device="cpu")
        tc["units"]["b0"]["k"].copy_(torch.from_numpy(k))
        tc["units"]["b0"]["v"].copy_(torch.from_numpy(v))
        t = torch.from_numpy
        no_presence = torch.zeros((B, 1), dtype=torch.bool)
        tkeys = t(keys.astype(np.int64))

        def sample_fn(last, i):
            return sampling.Sampler().device_call(
                last, no_presence, t(temp), t(top_k), t(top_p),
                torch.ones(B), tkeys.index_select(0, i.view(1))[0],
                greedy_only=not sampled)
        with torch.no_grad():
            em, lp, tc, lens, n_emit = transformer.decode_burst(
                tparams, tcfg, tc, t(tables), t(tok0), t(lens0), t(alive0),
                t(budget), t(stops), t(stop_len), t(hist0), sample_fn, BS,
                "naive", K, K)
        return [a.numpy() for a in (em, lp, lens, n_emit,
                                    tc["units"]["b0"]["k"],
                                    tc["units"]["b0"]["v"])]

    stops = np.full((B, STOP_NS, STOP_L), -1, np.int32)
    stop_len = np.zeros((B, STOP_NS), np.int32)
    first = reference(stops, stop_len)
    # a stop that fires at row 0's third token, another that never does
    stops[0, 0, -2:] = first[0][0, 1:3]
    stop_len[0, 0] = 2
    stops[3, 1, -1] = cfg.vocab            # no such token
    stop_len[3, 1] = 1
    for s_, sl in ((np.full_like(stops, -1), np.zeros_like(stop_len)),
                   (stops, stop_len)):
        want, got = reference(s_, sl), port(s_, sl)
        for name, a, b in zip(("emitted", "lens", "n_emit"),
                              (got[0], got[2], got[3]),
                              (want[0], want[2], want[3])):
            np.testing.assert_array_equal(a, b, err_msg=name)
        np.testing.assert_allclose(got[1], want[1], atol=1e-5, rtol=0)
        for a, b in zip(got[4:], want[4:]):
            np.testing.assert_allclose(a, b, atol=2e-4, rtol=2e-4)
    # the stop ended row 0 before its budget; row 1 had a budget of 1,
    # row 2 was dead
    assert want[3][0] <= 3 < budget[0] and want[3][1] == 1 \
        and want[3][2] == 0


# ---------------------------------------------------------------------------
# the sync-free paged KV write


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("max_width", [8, None],
                         ids=["step_width", "sequence_width"])
def test_store_paged_equals_drop_mode_scatter(nectar, int8, max_width):
    """A mixed step's writes (a prefill row with padding, decode rows, an
    IDLE row, a row past its table): the port's pools equal the
    reference's ``.at[blk, off].set(val, mode="drop")``, int8 bytes and
    scales included, with a trash just as large as the step and with the
    default one."""
    _, _, tcfg, _ = nectar
    B, S, NB, BS, MB = 5, 8, 12, 4, 3
    rng = np.random.default_rng(3 + int8)
    blk = rng.permutation(NB)[:B * 2].reshape(B, 2)
    blk = np.repeat(blk, S // 2, axis=1)                # two blocks a row
    off = np.tile(np.arange(S // 2), (B, 2))
    blk[0, 5:] = NB                                     # prefill padding
    blk[1, 1:] = NB                                     # decode rows
    blk[2, 1:] = NB
    blk[3, :] = NB                                      # IDLE
    blk[4, 4:] = NB                                     # past its table
    val = rng.standard_normal((B, S, tcfg.n_kv_heads, tcfg.d_head)) \
        .astype(np.float32)
    cache = Model(tcfg).init_paged_cache(B, NB, BS, MB, device="cpu",
                                         int8_kv=int8, max_width=max_width)
    unit = {k: v[0] for k, v in cache["units"]["b0"].items()}
    for leaf in unit.values():
        if leaf.dtype == torch.int8:
            leaf.copy_(torch.from_numpy(
                rng.integers(-128, 128, leaf.shape).astype(np.int8)))
        else:
            leaf.copy_(torch.from_numpy(
                rng.standard_normal(leaf.shape).astype(np.float32)))
    jcache = {k: jnp.asarray(v.numpy()) for k, v in unit.items()}
    assert cache["trash_rows"] == B * (max_width or MB * BS)
    unit["trash_rows"] = cache["trash_rows"]
    dst = attention._write_rows(torch.from_numpy(blk), torch.from_numpy(off),
                                NB, BS, unit["trash_rows"])
    for name in ("k", "v"):
        attention._store_paged(unit, name, dst, torch.from_numpy(val))
        jcache.update(jax_attention._store_paged(
            jcache, name, jnp.asarray(blk), jnp.asarray(off),
            jnp.asarray(val)))
    del unit["trash_rows"]
    assert set(jcache) == set(unit)
    for name, leaf in unit.items():
        np.testing.assert_array_equal(leaf.numpy(),
                                      np.asarray(jcache[name]), name)


def test_store_paged_refuses_a_step_wider_than_the_trash(nectar):
    """A step with more KV entries than the cache has trash rows raises
    (its sentinel entries would need a row twice) and writes nothing."""
    _, _, tcfg, tparams = nectar
    B, NB, BS, MB = 3, 6, 4, 2
    cache = Model(tcfg).init_paged_cache(B, NB, BS, MB, device="cpu",
                                         max_width=1)
    assert cache["trash_rows"] == BS
    before = {k: v.clone() for k, v in cache["units"]["b0"].items()}
    S = 2
    toks = torch.zeros((B, S), dtype=torch.int32)
    cache["lens"].zero_()
    with pytest.raises(ValueError, match="trash rows"):
        transformer.forward_step(
            tparams, tcfg, toks, cache, torch.full((B,), S, dtype=torch.int32),
            torch.ones(B, dtype=torch.bool), BS)
    for k, v in cache["units"]["b0"].items():
        assert torch.equal(v, before[k]), k


class _HostReads(TorchDispatchMode):
    """Records every op that reads a device value on the host (a scalar
    read, nonzero, masked_select, or indexing by a boolean mask)."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__.split(".")[0]
        bool_index = name in ("index", "index_put", "index_put_") and any(
            isinstance(i, torch.Tensor) and i.dtype == torch.bool
            for i in (args[1] if len(args) > 1 else ()) or ())
        if name in ("_local_scalar_dense", "nonzero", "masked_select",
                    "item") or bool_index:
            self.seen.append(name)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("backend", ["naive", "flash"])
def test_decode_iteration_reads_nothing_back(nectar, backend):
    """One decode iteration of the async engine (forward_step with its
    paged KV write, the sample, the loop's bookkeeping) dispatches no op
    that reads a device value on the host: the property that lets the
    card run it without a sync, and capture it as a graph."""
    _, _, tcfg, tparams = nectar
    eng = Engine(tcfg, tparams, _scfg("port", attn_backend=backend,
                                      async_cfg=LOOP4), device="cpu")
    r = _fresh_requests(greedy_blueprints(tcfg, [9, 12], max_new=6))
    for req in r:
        eng.add_request(req)
    eng.step()                          # the prefills, synchronously
    runner = eng.runner
    st = runner._burst(True, 4)
    B = eng.scfg.max_batch
    keys = np.zeros((4, B, 2), np.int64)
    keys[..., 1] = 5
    runner._stage_burst(
        st, eng.pool.tables(), np.array([3, 4, 0], np.int32),
        np.array([9, 12, 0], np.int32), np.array([1, 1, 0], np.int32),
        np.array([4, 4, 0], np.int32),
        np.full((B, STOP_NS, STOP_L), -1, np.int32),
        np.zeros((B, STOP_NS), np.int32), np.full((B, STOP_L), -1, np.int32),
        keys, np.array([0.7, 0.0, 0.0], np.float32), np.zeros(B, np.int32),
        np.ones(B, np.float32))
    with _HostReads() as mode:
        runner._iterate(st, 2)
    assert mode.seen == []
    assert st.state["n_emit"].tolist() == [2, 2, 0]


# ---------------------------------------------------------------------------
# the CLI's async block through the engine API


def test_async_cli_summary_has_the_reference_keys():
    """async_stats() has the reference's keys, and overlap_frac its
    definition."""
    from repro_torch.launch import serve as cli
    s = cli.main(["--device", "cpu", "--arch", "nectar-relu-llama-smoke",
                  "--async", "--async-k", "8", "--requests", "3",
                  "--max-new", "5", "--max-batch", "3"])
    a = s["async"]
    assert set(a) == set(STAT_KEYS) | {"overlap_frac"}
    assert a["loop_bursts"] > 0 and s["tokens"] == 15
    assert a["overlap_frac"] == pytest.approx(
        (a["overlap_ticks"] + a["loop_device_ticks"]) / a["device_ticks"])
