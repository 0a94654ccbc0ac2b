"""The port's disaggregated prefill/decode serving on the CPU, against the
JAX reference's.

Every regime of the reference's ``tests/test_disagg.py`` runs twice, on
the same weights (the reference's ``init_params(PRNGKey(0))`` through
``weights.from_jax_params``) and the same seeded prompts: once through
``repro.serve.disagg.DisaggCoordinator`` and once through the port's
(``device="cpu"``, the plain versions of the kernels). The sizing is the
reference tests' ``_scfg`` (a pool that fits the active set: no
preemption unless a test asks for it). What must agree:

  * greedy tokens, exactly (and the port's coordinator against the port's
    single paged engine);
  * the integer counters: ``n_handoffs``, ``handoff_blocks``,
    ``n_decode_direct``, ``decode_steps``, ``prefill_chunks``,
    ``evictions``, the prefix counters, the interference split's sample
    counts;
  * the lifecycle of a handoff step by step (parking, export, preemption
    mid-handoff, back-pressure) and the tracer's per-request events;
  * the KV the handoff moves: bit for bit between the port's two pools,
    and within 2e-4 of the reference's (f32; int8 payloads within one
    quantization step, their scales, a row's absmax / 127, within 5e-4
    relative: the second chunk of an int8 prefill reads the first's
    dequantized KV, which widens the f32 rounding gap).

Beside them: the async decode engine against the sync one in a
coordinator, a fleet of disagg pools, and the block import's guards.
"""

import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs import base as jbase
from repro.models import Model as JaxModel
from repro.serve import api as japi
from repro.serve.disagg import DisaggCoordinator as JaxCoordinator
from repro.serve.engine import Engine as JaxEngine
from repro.serve.paged_kv import PagedKVCache as JaxPagedKVCache
from repro.serve.router import build_fleet as jax_build_fleet
from repro.serve.scheduler import Request as JaxRequest
from repro.serve.scheduler import State as JaxState
from repro_torch.configs import base as tbase
from repro_torch.configs import get_config as torch_get_config
from repro_torch.obs import write_jsonl, write_perfetto
from repro_torch.serve import api
from repro_torch.serve.disagg import DisaggCoordinator
from repro_torch.serve.engine import Engine
from repro_torch.serve.paged_kv import PagedKVCache
from repro_torch.serve.router import build_fleet
from repro_torch.serve.scheduler import Request, State
from repro_torch.weights import from_jax_params

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "check_trace", ROOT / "tools" / "check_trace.py")
check_trace = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(check_trace)

# integer keys of the merged summary that must equal the reference's
INT_KEYS = ("n_finished", "generated_tokens", "decode_steps",
            "prefill_chunks", "evictions", "spec_steps", "prefix_lookups",
            "prefix_hits", "prefix_cached_tokens", "n_handoffs",
            "n_decode_direct", "handoff_blocks", "tpot_overlap_samples",
            "tpot_steady_samples")
KV_ATOL = 2e-4       # f32 KV rows, port against reference
SCALE_RTOL = 5e-4    # int8 KV scales, port against reference


class Side:
    """One package's serving surface at the reference tests' sizes: the
    reference's (``port=False``) or the port's on the CPU."""

    def __init__(self, port, cfg, params):
        self.port, self.cfg, self.params = port, cfg, params
        self.base = tbase if port else jbase
        self.Request = Request if port else JaxRequest
        self.State = State if port else JaxState
        self.Server = api.StreamingServer if port \
            else japi.StreamingServer
        self.Pool = PagedKVCache if port else JaxPagedKVCache
        self.dev = {"device": "cpu"} if port else {}

    def scfg(self, **kw):
        base = dict(max_batch=2, max_seq=64, paged=True, prefix_cache=True,
                    block_size=4, n_kv_blocks=32, prefill_chunk=8,
                    max_queue=8)
        base.update(kw)
        return self.base.ServeConfig(**base)

    def engine(self, scfg):
        cls = Engine if self.port else JaxEngine
        return cls(self.cfg, self.params, scfg, **self.dev)

    def coord(self, scfg, dcfg=None):
        cls = DisaggCoordinator if self.port else JaxCoordinator
        return cls(self.cfg, self.params, scfg, dcfg=dcfg, **self.dev)

    def build_fleet(self, scfg, **kw):
        fn = build_fleet if self.port else jax_build_fleet
        return fn(self.cfg, self.params, scfg, **kw, **self.dev)

    def run(self, eng, prompts, max_new=4):
        done = eng.run([self.Request(rid=i, prompt=p, max_new=max_new)
                        for i, p in enumerate(prompts)], max_steps=4000)
        return {i: [int(t) for t in r.tokens_out] for i, r in done.items()}


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


def _prompts(vocab, n, seed=0, lo=4, hi=12):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(rng.integers(lo, hi)),
                         dtype=np.int32) for _ in range(n)]


def _ints(summary):
    return {k: summary[k] for k in INT_KEYS}


# ---------------------------------------------------------------------------
# construction guards


def test_requires_paged_and_prefill_engine_never_speculates(sides):
    _, port = sides
    with pytest.raises(ValueError, match="paged"):
        DisaggCoordinator(port.cfg, port.params,
                          tbase.ServeConfig(max_batch=2, max_seq=64),
                          device="cpu")
    scfg = port.scfg(spec=tbase.SpecConfig(drafter="ngram", k=2))
    coord = port.coord(scfg)
    assert coord.decode.spec is not None and coord.prefill.spec is None
    with pytest.raises(ValueError, match="speculate"):
        port.engine(scfg).submit_prefill(
            Request(rid=0, prompt=np.zeros(4, np.int32)))
    with pytest.raises(ValueError, match="paged"):
        Engine(port.cfg, port.params, tbase.ServeConfig(max_batch=2),
               device="cpu").submit_prefill(
            Request(rid=0, prompt=np.zeros(4, np.int32)))


# ---------------------------------------------------------------------------
# the contract: the handoff moves state, never tokens


def _shared_head(vocab):
    rng = np.random.default_rng(7)
    head = rng.integers(0, vocab, size=12, dtype=np.int32)
    return [np.concatenate([head, rng.integers(0, vocab, size=3 + i,
                                               dtype=np.int32)])
            for i in range(4)]


def _self_repeating(vocab):
    rng = np.random.default_rng(3)
    return [np.tile(rng.integers(0, vocab, size=4, dtype=np.int32), 3)
            for _ in range(3)]


# regime -> (ServeConfig keywords for side.scfg, prompts of a vocab,
# max_new); the reference file's identity and metrics regimes
REGIMES = {
    "plain": (lambda b: dict(prefix_cache=False),
              lambda v: _prompts(v, 6, seed=1), 4),
    "prefix_cache": (lambda b: {}, _shared_head, 4),
    "int8_kv": (lambda b: dict(kv_quant=True),
                lambda v: _prompts(v, 4, seed=2), 4),
    "spec": (lambda b: dict(spec=b.SpecConfig(drafter="ngram", k=2,
                                              k_max=4)),
             _self_repeating, 6),
    "interference": (lambda b: {},
                     lambda v: _prompts(v, 6, seed=8, lo=8, hi=16), 6),
    "merged_summary": (lambda b: {}, lambda v: _prompts(v, 4, seed=12), 4),
}


# what the port's summary adds to the reference's: the requests' queue
# wait and the window's seconds by engine phase
PORT_SUMMARY_KEYS = {"queue_wait_p50_ms", "queue_wait_p99_ms",
                     "engine_phase_s"}


@pytest.mark.parametrize("regime", list(REGIMES))
def test_regime_matches_reference(sides, regime):
    """Tokens identical to the reference's coordinator and to the port's
    single paged engine; the merged summary's integer counters equal the
    reference's (handoffs, blocks moved, decode steps, prefill chunks,
    evictions, prefix and spec counters, the interference split's sample
    counts), its keys the reference's and exactly the port's additions
    (``PORT_SUMMARY_KEYS``), each request's queue wait counted once."""
    kw, make_prompts, max_new = REGIMES[regime]
    ref, port = sides
    prompts = make_prompts(ref.cfg.vocab)
    want_coord = ref.coord(ref.scfg(**kw(ref.base)))
    want = ref.run(want_coord, prompts, max_new)
    coord = port.coord(port.scfg(**kw(port.base)))
    got = port.run(coord, prompts, max_new)
    assert got == want
    assert got == port.run(port.engine(port.scfg(**kw(port.base))),
                           prompts, max_new)
    s, ws = coord.metrics.summary(), want_coord.metrics.summary()
    assert _ints(s) == _ints(ws)
    assert s["n_handoffs"] == len(prompts) and s["evictions"] == 0
    assert set(s) - set(ws) == PORT_SUMMARY_KEYS and set(ws) <= set(s)
    assert set(s["prefill_engine"]) - set(ws["prefill_engine"]) \
        == PORT_SUMMARY_KEYS
    # each request is admitted once, on one of the two engines
    assert len(coord.prefill.metrics.queue_waits()
               + coord.decode.metrics.queue_waits()) == len(prompts)
    if regime == "prefix_cache":
        assert s["prefix_hits"] > 0
    if regime == "interference":
        # every gap after a first token lands in exactly one bucket, and
        # both buckets fill
        n_gaps = sum(max(r.n_generated - 1, 0)
                     for r in coord.metrics.requests.values())
        assert s["tpot_overlap_samples"] + s["tpot_steady_samples"] \
            == n_gaps
        assert s["tpot_overlap_samples"] > 0 < s["tpot_steady_samples"]
    if regime == "merged_summary":
        assert s["generated_tokens"] == 16 and s["handoff_blocks"] > 0
        assert s["prefill_engine"]["prefill_chunks"] > 0
        coord.reset_metrics()
        s = coord.metrics.summary()
        assert s["n_finished"] == 0 and s["n_handoffs"] == 0


def test_decode_direct_fast_path(sides):
    """A prompt whose prefix the decode engine holds skips the prefill
    engine; the counters and tokens equal the reference's."""
    out = []
    for side in sides:
        rng = np.random.default_rng(11)
        head = rng.integers(0, side.cfg.vocab, size=16, dtype=np.int32)
        first = np.concatenate([head, rng.integers(0, side.cfg.vocab,
                                                   size=4, dtype=np.int32)])
        again = np.concatenate([head, rng.integers(0, side.cfg.vocab,
                                                   size=3, dtype=np.int32)])
        coord = side.coord(side.scfg(),
                           side.base.DisaggConfig(direct_max_suffix=8))
        d0 = coord.run([side.Request(rid=0, prompt=first, max_new=3)],
                       max_steps=2000)
        after_first = (coord.n_decode_direct, coord.n_handoffs)
        d1 = coord.run([side.Request(rid=1, prompt=again, max_new=3)],
                       max_steps=2000)
        out.append((after_first, coord.n_decode_direct, coord.n_handoffs,
                    list(d0[0].tokens_out), list(d1[1].tokens_out),
                    _ints(coord.metrics.summary())))
    assert out[1] == out[0]
    assert out[1][0] == (0, 1) and out[1][1:3] == (1, 1)
    mono = sides[1].run(sides[1].engine(sides[1].scfg()),
                        [first, again], max_new=3)
    assert [int(t) for t in out[1][4]] == mono[1]


# ---------------------------------------------------------------------------
# export/import round trip


def test_pool_roundtrip_matches_reference(sides):
    """The reference test's randomized export/import bookkeeping (shared
    prefixes, pinned exporters, arbitrary importer occupancy), run through
    both pools: the same exports, the same imported ids, refcounts and
    free lists, and capacity misses all-or-nothing with no ``owned``
    residue."""
    ref, port = sides
    states = []
    for side in sides:
        rng = np.random.default_rng(0)
        log = []
        for trial in range(20):
            src = side.Pool(side.cfg, n_blocks=16, block_size=4,
                            max_batch=4, max_blocks_per_seq=8,
                            int8_kv=bool(trial % 2))
            n_tok = int(rng.integers(1, 24))
            assert src.allocate(0, n_tok)
            exported = src.export_blocks(0)
            assert exported == src.owned[0]
            src.share(1, exported)
            src.pin(0)
            before = (list(src.free), {b: src.ref[b] for b in exported})
            assert src.export_blocks(0) == exported
            assert (list(src.free),
                    {b: src.ref[b] for b in exported}) == before
            dst = side.Pool(side.cfg, n_blocks=16, block_size=4,
                            max_batch=4, max_blocks_per_seq=8)
            occupied = int(rng.integers(0, 9))
            if occupied:
                assert dst.allocate(3, occupied * 4)
            got = dst.import_blocks(0, n_tok)
            assert got == dst.owned[0] and all(dst.ref[b] == 1 for b in got)
            free_before, owned_before = dst.n_free, dict(dst.owned)
            assert dst.import_blocks(2, (dst.n_free + 1) * 4) is None
            assert dst.n_free == free_before and dst.owned == owned_before
            assert 2 not in dst.owned
            log.append((exported, got, list(dst.free), dict(dst.ref)))
        states.append(log)
    assert states[1] == states[0]


def _park(eng, rid, max_ticks=50):
    for _ in range(max_ticks):
        if rid in eng.handoff_ready():
            return
        eng.step()
    raise AssertionError(f"request {rid} never parked")


@pytest.mark.parametrize("kv_quant", [False, True], ids=["f32", "int8"])
def test_handoff_copies_bytes_exactly(sides, kv_quant):
    """Engine-level handoff: the adopted blocks equal the exported ones
    bit for bit on every leaf (int8 payloads and scales included), the
    pools are written in place (same storage before and after), the
    source drops every reference on release, and the adopted row decodes
    to the reference's tokens. The moved KV equals the reference's within
    KV_ATOL (f32), one quantization step (int8) and SCALE_RTOL
    (scales)."""
    ref, port = sides
    kv = {}
    for side in sides:
        scfg = side.scfg(prefix_cache=False, kv_quant=kv_quant)
        pre, dec = side.engine(scfg), side.engine(scfg)
        req = side.Request(rid=0, prompt=_prompts(side.cfg.vocab, 1, seed=5,
                                                  lo=9, hi=10)[0],
                           max_new=4)
        assert pre.submit_prefill(req)
        _park(pre, 0)
        e = pre.sched.active[0]
        assert e.state is side.State.HANDOFF and e.slot in pre.pool.pinned
        packet = pre.export_handoff(0)
        assert packet is not None and len(req.tokens_out) == 1
        if side.port:
            leaves = dec.runner.cache["units"]["b0"]
            ptrs = {k: v.data_ptr() for k, v in leaves.items()}
        assert dec.adopt_handoff(packet, pre.runner)
        dst = dec.pool.export_blocks(dec.sched.active[0].slot)
        if side.port:
            src_leaves = pre.runner.cache["units"]["b0"]
            assert {k: v.data_ptr() for k, v in leaves.items()} == ptrs
            assert len(leaves) == (4 if kv_quant else 2)
            for name, leaf in leaves.items():
                assert torch.equal(leaf[:, dst],
                                   src_leaves[name][:, packet.blocks])
            kv["port"] = {k: v[:, dst].numpy()
                          for k, v in leaves.items()}
        else:
            kv["ref"] = {k: np.asarray(v[:, dst]) for k, v in
                         dec.runner.cache["units"]["b0"].items()}
        pre.release_handoff(0)
        assert pre.pool.n_used == 0
        assert 0 not in pre.sched.active and 0 not in pre._requests
        for _ in range(50):
            if req.done:
                break
            dec.step()
        kv[("tokens", side.port)] = list(req.tokens_out)
    assert kv[("tokens", True)] == kv[("tokens", False)]
    assert len(kv[("tokens", True)]) == 4
    assert kv["port"].keys() == kv["ref"].keys()
    for name, a in kv["port"].items():
        b = kv["ref"][name]
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if a.dtype == np.int8:
            assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() \
                <= 1, name
        elif kv_quant:
            np.testing.assert_allclose(a, b, rtol=SCALE_RTOL, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, atol=KV_ATOL, rtol=0,
                                       err_msg=name)


def _preemption_script(side):
    """The reference test's mid-handoff preemption, recording what it
    observes: a parked low-priority entry is evicted by a high-priority
    prefill, its export refused, the winner moved, the loser replayed and
    parked again, both decoded."""
    cfg = side.cfg
    pre = side.engine(side.scfg(prefix_cache=False, policy="priority",
                                n_kv_blocks=6))
    dec = side.engine(side.scfg(prefix_cache=False))
    rng = np.random.default_rng(9)
    low = side.Request(rid=0, prompt=rng.integers(0, cfg.vocab, size=12,
                                                  dtype=np.int32),
                       max_new=3, priority=0)
    high = side.Request(rid=1, prompt=rng.integers(0, cfg.vocab, size=16,
                                                   dtype=np.int32),
                        max_new=3, priority=5)
    seen = []
    assert pre.submit_prefill(low)
    _park(pre, 0)
    seen.append(pre.handoff_ready())
    assert pre.submit_prefill(high)
    for _ in range(50):
        if pre.handoff_ready() == [1]:
            break
        pre.step()
    seen.append((0 in pre.sched.active,
                 [(en.req.rid, en.state.value) for en in pre.sched.waiting],
                 pre.export_handoff(0) is None, pre.metrics.evictions))
    packet = pre.export_handoff(1)
    assert dec.adopt_handoff(packet, pre.runner)
    pre.release_handoff(1)
    for _ in range(50):
        if pre.handoff_ready() == [0]:
            break
        pre.step()
    packet = pre.export_handoff(0)
    seen.append((packet.draw_ctr, packet.ctx_len, len(packet.blocks)))
    assert dec.adopt_handoff(packet, pre.runner)
    pre.release_handoff(0)
    for _ in range(100):
        if low.done and high.done:
            break
        dec.step()
    seen.append(([int(t) for t in low.tokens_out],
                 [int(t) for t in high.tokens_out]))
    return seen


def test_mid_handoff_preemption(sides):
    """A parked HANDOFF entry stays preemptable: eviction refuses its
    export, its replayed prefill parks it again, and the retried handoff
    completes; every observation equals the reference's."""
    want = _preemption_script(sides[0])
    got = _preemption_script(sides[1])
    assert got == want
    assert got[1][0] is False and got[1][2] is True and got[1][3] >= 1
    assert got[2][0] == 1
    assert [len(t) for t in got[3]] == [3, 3]


def test_adopt_backpressure_all_or_nothing(sides):
    """adopt_handoff into a full pool fails with its state unchanged (no
    slot, no ``owned`` entry left behind); the source stays parked."""
    out = []
    for side in sides:
        pre = side.engine(side.scfg(prefix_cache=False))
        dec = side.engine(side.scfg(prefix_cache=False, n_kv_blocks=2))
        req = side.Request(rid=0, prompt=_prompts(side.cfg.vocab, 1, seed=6,
                                                  lo=11, hi=12)[0],
                           max_new=2)
        assert pre.submit_prefill(req)
        _park(pre, 0)
        packet = pre.export_handoff(0)
        free_before = dec.pool.n_free
        ok = dec.adopt_handoff(packet, dec.runner)
        out.append((ok, dec.pool.n_free == free_before,
                     dict(dec.pool.owned), sorted(dec.sched.slots.free),
                     0 in dec.sched.active, pre.handoff_ready()))
    assert out[1] == out[0]
    assert out[1][0] is False and out[1][1] and out[1][2] == {}
    assert out[1][5] == [0]


# ---------------------------------------------------------------------------
# the structural claim and the tracer's record


def test_no_mixed_ticks_and_trace(sides, tmp_path):
    """With one tracer over both engines, no tick of the pool mixes
    prefill and decode rows (the single engine's ticks do, on the same
    traffic); the ticks' row kinds equal the reference's tick for tick;
    each request's events equal the reference's, the handoff milestones
    in order; the Perfetto and JSONL exports pass tools/check_trace.py
    with the ``kv_handoff`` lane."""
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, sides[0].cfg.vocab, size=n, dtype=np.int32)
               for n in (5, 28, 6, 26, 4, 30)]
    rows, names = [], []
    for side in sides:
        scfg = side.scfg(obs=side.base.ObsConfig(enabled=True))
        mono = side.engine(scfg)
        side.run(mono, prompts, max_new=6)
        assert any(t.get("rows_prefill", 0) and t.get("rows_decode", 0)
                   for t in mono.tracer.tick_stats)
        coord = side.coord(scfg)
        side.run(coord, prompts, max_new=6)
        ticks = coord.tracer.tick_stats
        assert coord.n_handoffs == len(prompts)
        assert not any(t.get("rows_prefill", 0) and t.get("rows_decode", 0)
                       for t in ticks)
        rows.append([(t.get("rows_prefill", 0), t.get("rows_decode", 0))
                     for t in ticks])
        names.append({rid: [e.name for e in coord.tracer.timeline(rid)]
                      for rid in range(len(prompts))})
    assert rows[1] == rows[0]
    assert names[1] == names[0]
    tr = coord.tracer
    assert any(s.name == "kv_handoff" for s in tr.spans)
    for rid, seq in names[1].items():
        for a, b in zip(("handoff_ready", "handoff_adopt",
                         "handoff_release"),
                        ("handoff_adopt", "handoff_release", "finish")):
            assert seq.index(a) < seq.index(b)
    pf, jl = str(tmp_path / "d.trace.json"), str(tmp_path / "d.jsonl")
    write_perfetto(tr, pf, registry=coord.metrics.registry)
    write_jsonl(tr, jl)
    assert check_trace.check_perfetto(pf, expect_spans=["kv_handoff"]) == []
    assert check_trace.check_jsonl(jl) == []


# ---------------------------------------------------------------------------
# front ends over the coordinator


def test_streaming_server_wraps_coordinator(sides):
    out = []
    for side in sides:
        coord = side.coord(side.scfg())
        server = side.Server(coord)
        rids = [server.submit(p, max_new=3)
                for p in _prompts(side.cfg.vocab, 3, seed=14)]
        server.drain(max_steps=4000)
        out.append([[int(t) for t in coord._requests[r].tokens_out]
                    for r in rids])
    assert out[1] == out[0] and all(len(t) == 3 for t in out[1])


def test_fleet_of_disagg_pools(sides):
    """A round-robin fleet of two disagg pools: each pool moved KV, and
    tokens, routing decisions and per-replica handoffs equal the
    reference's."""
    out = []
    for side in sides:
        router = side.build_fleet(side.scfg(), n_replicas=2,
                                  policy="round_robin",
                                  disagg=side.base.DisaggConfig())
        rids = [router.submit(p, max_new=3)
                for p in _prompts(side.cfg.vocab, 4, seed=15)]
        router.drain_all()
        out.append(([[int(t) for t in router.result(r).tokens_out]
                     for r in rids],
                    [(d.rid, d.replica, d.reason, d.matched_tokens)
                     for d in router.decisions],
                    [rep.engine.n_handoffs for rep in router.fleet.live()]))
    assert out[1] == out[0]
    assert all(n > 0 for n in out[1][2])


# ---------------------------------------------------------------------------
# the async decode engine in a coordinator


@pytest.mark.parametrize("k", [1, 4], ids=["overlap", "loop4"])
def test_async_disagg_matches_sync(sides, k):
    """Both engines async (overlap ticks, or bursts of 4): the same tokens
    and counters as the port's sync coordinator (all but the interference
    split's sample counts: a burst's tokens share one tick's class), and
    the same tokens and integer summary, split included, as the
    reference's async coordinator; the decode engine ran async ticks."""
    ref, port = sides
    prompts = _prompts(port.cfg.vocab, 6, seed=8, lo=8, hi=16)
    sync = port.coord(port.scfg())
    want = port.run(sync, prompts, max_new=8)
    acfg = dict(enabled=True, max_device_ticks=k)
    coord = port.coord(port.scfg(async_cfg=tbase.AsyncConfig(**acfg)))
    assert port.run(coord, prompts, max_new=8) == want
    got, base = _ints(coord.metrics.summary()), _ints(sync.metrics.summary())
    assert {k_: v for k_, v in got.items() if not k_.startswith("tpot")} \
        == {k_: v for k_, v in base.items() if not k_.startswith("tpot")}
    stats = coord.decode.async_stats()
    assert stats["overlap_ticks" if k == 1 else "loop_bursts"] > 0
    jcoord = ref.coord(ref.scfg(async_cfg=jbase.AsyncConfig(**acfg)))
    assert ref.run(jcoord, prompts, max_new=8) == want
    assert got == _ints(jcoord.metrics.summary())
    assert {key: v for key, v in stats.items() if key != "overlap_frac"} \
        == {key: v for key, v in jcoord.decode.async_stats().items()
            if key != "overlap_frac"}


# ---------------------------------------------------------------------------
# the block import's guards


def test_import_blocks_from_guards(sides):
    """Lengths must match and every id must lie in the pools proper (the
    trash blocks behind a pool are never named); an empty import is a
    no-op."""
    port = sides[1]
    a = port.engine(port.scfg(prefix_cache=False))
    b = port.engine(port.scfg(prefix_cache=False))
    n = a.pool.n_blocks
    with pytest.raises(ValueError, match="destinations"):
        b.runner.import_blocks_from(a.runner, [0, 1], [2])
    with pytest.raises(ValueError, match="outside the pool"):
        b.runner.import_blocks_from(a.runner, [n], [0])
    with pytest.raises(ValueError, match="outside the pool"):
        b.runner.import_blocks_from(a.runner, [0], [-1])
    small = port.engine(port.scfg(prefix_cache=False, n_kv_blocks=4))
    with pytest.raises(ValueError, match="outside the pool"):
        small.runner.import_blocks_from(a.runner, [0], [4])
    b.runner.import_blocks_from(a.runner, [], [])
    q8 = port.engine(port.scfg(prefix_cache=False, kv_quant=True))
    with pytest.raises(ValueError, match="different leaves"):
        q8.runner.import_blocks_from(a.runner, [0], [0])
