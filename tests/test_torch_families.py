"""The attention variants (qwen3's qk-norm, qwen2.5's QKV bias) and the MoE
family (moonshot, llama4-maverick) in the port, on the CPU, against the
JAX reference.

Tolerances: ``head_rms_norm`` and the q/k/v projections within 1e-6 (the
same f32 operations); ``route``'s dispatch table exact, its gates and aux
loss within 1e-6, with capacity dropping tokens and without; ``moe_forward``
within 1e-5 of the reference's and within 1e-4 of the dense oracle
``moe_reference`` at capacity_factor 8 (nothing dropped); each new
SMOKE's forward and decode logits within 2e-4 of the reference's on its
weights (``from_jax_params``, with the QKV biases and the q/k norm gains
drawn away from their zero and one init so that they matter); greedy
tokens through the paged (plain read, flash read's plain version, prefix
cache) and slot engines, seeded sampled rows, the async engine and n-gram
speculation identical to the reference's on ``tests/test_paged_serving``'s
``_prompts``. bf16 trees keep each leaf's dtype, the router f32, and are
judged as ``tests/test_torch_bf16.py`` judges bf16. The cost model counts
an MoE block's products as ``FlopCounterMode`` does within 1%.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import test_torch_bf16
from repro.configs import get_config
from repro.configs.base import AsyncConfig as JaxAsyncConfig
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.configs.base import ServeConfig as JaxServeConfig
from repro.configs.base import SpecConfig as JaxSpecConfig
from repro.models import Model as JaxModel
from repro.models import attention as jax_attention
from repro.models import layers as jax_layers
from repro.models import moe as jax_moe
from repro.models import transformer as jax_transformer
from repro.serve import sampling as jax_sampling
from repro.serve.engine import Engine as JaxEngine
from repro.serve.scheduler import Request as JaxRequest
from repro_torch.configs import get_config as torch_get_config
from repro_torch.configs.base import AsyncConfig, ServeConfig, SpecConfig
from repro_torch.models import Model, attention, layers, moe, transformer
from repro_torch.obs import costmodel
from repro_torch.serve import sampling
from repro_torch.serve.engine import Engine
from repro_torch.serve.runner import DECODE, PREFILL
from repro_torch.serve.scheduler import Request
from repro_torch.weights import from_jax_params

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # property tests are skipped on clean environments
    from conftest import given, settings, st  # no-op stand-ins

SMOKES = ["qwen3-4b-smoke", "qwen2.5-3b-smoke", "moonshot-v1-smoke",
          "llama4-maverick-smoke"]
CONFIGS = ["qwen3-4b", "qwen2.5-3b", "moonshot-v1-16b-a3b",
           "llama4-maverick-400b-a17b"]
BASE = dict(max_batch=2, max_seq=64, block_size=8, prefill_chunk=16)
LENGTHS = [5, 21, 9, 13, 30, 3]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompts(cfg, lengths, seed=0):
    """``tests/test_paged_serving.py``'s prompt draw."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, size=int(n), dtype=np.int32)
            for n in lengths]


def _perturbed(jparams, seed=1):
    """The reference's tree with every QKV bias drawn from N(0, 0.1^2)
    and every q/k norm gain from 1 + N(0, 0.1^2), in each leaf's dtype."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in ("bq", "bk", "bv", "q_norm", "k_norm"):
                base = 1.0 if k.endswith("norm") else 0.0
                out[k] = jnp.asarray(
                    base + 0.1 * rng.standard_normal(v.shape), v.dtype)
            else:
                out[k] = v
        return out
    return walk(jparams)


_TREES = {}


def _trees(name):
    """(cfg, reference params, port cfg, port params) of a SMOKE, the
    reference's ``init(PRNGKey(0))`` perturbed, converted once."""
    if name not in _TREES:
        cfg = get_config(name)
        jparams = _perturbed(JaxModel(cfg).init(jax.random.PRNGKey(0)))
        tcfg = torch_get_config(name)
        tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                                  device="cpu")
        _TREES[name] = (cfg, jparams, tcfg, tparams)
    return _TREES[name]


def _run_both(name, prompts, max_new=8, sps=None, jkw=None, tkw=None,
              **kw):
    cfg, jparams, tcfg, tparams = _trees(name)
    sps = sps or [None] * len(prompts)
    jeng = JaxEngine(cfg, jparams, JaxServeConfig(**dict(kw, **(jkw or {}))))
    jdone = jeng.run([JaxRequest(
        rid=i, prompt=p, max_new=max_new,
        sampling=jax_sampling.SamplingParams(**(sp or {})))
        for i, (p, sp) in enumerate(zip(prompts, sps))], max_steps=2000)
    eng = Engine(tcfg, tparams, ServeConfig(**dict(kw, **(tkw or {}))),
                 device="cpu")
    done = eng.run([Request(
        rid=i, prompt=p, max_new=max_new,
        sampling=sampling.SamplingParams(**(sp or {})))
        for i, (p, sp) in enumerate(zip(prompts, sps))], max_steps=2000)
    want = {i: [int(t) for t in r.tokens_out] for i, r in jdone.items()}
    got = {i: [int(t) for t in r.tokens_out] for i, r in done.items()}
    return want, got, jeng, eng


# ---------------------------------------------------------------------------
# configs and refusals


@pytest.mark.parametrize("name", CONFIGS + SMOKES)
def test_config_copies_equal_the_reference(name):
    assert dataclasses.asdict(torch_get_config(name)) \
        == dataclasses.asdict(get_config(name))


@pytest.mark.parametrize("name,what", [("qwen2-vl-72b", "rope"),
                                       ("musicgen-medium", "token stream")])
def test_frontends_stay_refused_naming_item_8c(name, what):
    cfg = get_config(name)
    tcfg = torch_get_config("qwen3-4b-smoke")
    tcfg = dataclasses.replace(
        tcfg, name=cfg.name, mrope=cfg.mrope, pos_emb=cfg.pos_emb,
        n_codebooks=cfg.n_codebooks, frontend=cfg.frontend)
    with pytest.raises(NotImplementedError, match="item 8c") as err:
        transformer.check_supported(tcfg)
    assert what in str(err.value) and "frontend" in str(err.value)


# ---------------------------------------------------------------------------
# layers and attention


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_rms_norm_matches_the_reference(dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 5, 4, 16)).astype(np.float32) * 3
    g = (1 + 0.1 * rng.standard_normal(16)).astype(np.float32)
    jx, jg = jnp.asarray(x, dtype), jnp.asarray(g, dtype)
    want = np.asarray(jax_layers.head_rms_norm(jx, jg, 1e-6), np.float32)
    tx = torch.tensor(np.asarray(jx, np.float32)).to(getattr(torch, dtype))
    tg = torch.tensor(np.asarray(jg, np.float32)).to(tx.dtype)
    got = layers.head_rms_norm(tx, tg, 1e-6)
    assert got.dtype == tx.dtype
    tol = 1e-6 if dtype == "float32" else 0
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("name", ["qwen3-4b-smoke", "qwen2.5-3b-smoke"])
def test_qkv_with_bias_and_qk_norm_matches_the_reference(name):
    cfg, jparams, tcfg, tparams = _trees(name)
    jp = jax.tree.map(lambda a: a[1], jparams["units"]["b0"]["attn"])
    tp = {k: v[1] for k, v in tparams["units"]["b0"]["attn"].items()}
    assert set(tp) == set(jp)
    assert ("bq" in tp) == cfg.qkv_bias and ("q_norm" in tp) == cfg.qk_norm
    x = np.random.default_rng(5).standard_normal(
        (2, 7, cfg.d_model)).astype(np.float32)
    want = jax_attention._qkv(jp, cfg, jnp.asarray(x))
    got = attention._qkv(tp, tcfg, torch.from_numpy(x))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=1e-6)


# ---------------------------------------------------------------------------
# MoE


def _moe_cfg(name="moonshot-v1-smoke", **kw):
    base = get_config(name)
    cfg = JaxModelConfig(**{**base.__dict__, "name": "t", **kw})
    return cfg, dataclasses.replace(torch_get_config(name), name="t", **kw)


def _moe_params(cfg, seed):
    jp = jax_moe.init_moe(jax.random.PRNGKey(seed), cfg, jnp.float32)
    return jp, {k: ({kk: torch.tensor(np.asarray(vv))
                     for kk, vv in v.items()} if isinstance(v, dict)
                    else torch.tensor(np.asarray(v)))
                for k, v in jp.items()}


@pytest.mark.parametrize("T,top_k,cf", [(8, 2, 1.25), (64, 2, 1.25),
                                        (256, 2, 1.25), (96, 1, 1.0),
                                        (200, 6, 1.25), (64, 2, 8.0)])
def test_route_tables_exact_and_gates_within_1e_6(T, top_k, cf):
    """Skewed logits (a few favored experts) make capacity bind at the
    larger T: the drops, and every slot, must be the reference's."""
    cfg, tcfg = _moe_cfg(top_k=top_k, capacity_factor=cf,
                         n_experts=16 if top_k == 6 else 8)
    rng = np.random.default_rng(T + top_k)
    logits = (rng.standard_normal((T, cfg.n_experts))
              + np.linspace(0, 2, cfg.n_experts)).astype(np.float32)
    cap = jax_moe.capacity(T, cfg)
    assert moe.capacity(T, tcfg) == cap
    jt, jg, ja = jax_moe.route(jnp.asarray(logits), cfg, cap)
    tt, tg, ta = moe.route(torch.from_numpy(logits), tcfg, cap)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert tt.dtype == torch.int32
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6,
                               rtol=0)
    assert float(ta) == pytest.approx(float(ja), abs=1e-6)
    kept = int((tt.numpy() < T).sum())
    if T >= 200:
        assert kept < T * top_k       # capacity dropped some assignments
    if cf == 8.0:
        assert kept == T * top_k


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 2 ** 16), t=st.sampled_from([8, 16, 32]),
       topk=st.sampled_from([1, 2]))
def test_moe_route_conservation(seed, t, topk):
    """``tests/test_models.py``'s property against the port, and the
    port's table equal to the reference's on the same logits."""
    cfg, tcfg = _moe_cfg(top_k=topk)
    E = cfg.n_experts
    logits = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (t, E)))
    cap = moe.capacity(t, tcfg)
    table, gates, aux = moe.route(torch.tensor(logits), tcfg, cap)
    tb, gt = table.numpy(), gates.numpy()
    assert ((tb == t) == (gt == 0.0)).all()
    counts = np.bincount(tb[tb < t], minlength=t)
    assert (counts <= topk).all()
    sums = np.zeros(t)
    np.add.at(sums, tb[tb < t], gt[tb < t])
    assert (sums <= 1.0 + 1e-5).all()
    assert np.isfinite(float(aux))
    jt, _, _ = jax_moe.route(jnp.asarray(logits), cfg, cap)
    np.testing.assert_array_equal(tb, np.asarray(jt))


@pytest.mark.parametrize("name,B,S", [("moonshot-v1-smoke", 2, 8),
                                      ("moonshot-v1-smoke", 4, 32),
                                      ("llama4-maverick-smoke", 3, 16)])
def test_moe_forward_matches_the_reference(name, B, S):
    cfg, tcfg = _moe_cfg(name)
    jp, tp = _moe_params(cfg, B + S)
    assert tp["router"].dtype == torch.float32
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(S),
                                     (B, S, cfg.d_model)))
    want, jaux = jax_moe.moe_forward(jp, cfg, jnp.asarray(x))
    got, aux = moe.moe_forward(tp, tcfg, torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    assert float(aux) == pytest.approx(float(jaux), abs=1e-6)


def test_moe_dispatch_matches_dense_reference():
    """``tests/test_models.py``'s case against the port: generous capacity
    so nothing drops, then the routed output is the dense oracle's."""
    cfg, tcfg = _moe_cfg(capacity_factor=8.0)
    jp, tp = _moe_params(cfg, 8)
    x = torch.tensor(np.asarray(
        jax.random.normal(jax.random.PRNGKey(9), (2, 8, cfg.d_model))))
    y, aux = moe.moe_forward(tp, tcfg, x)
    y_ref = moe.moe_reference(tp, tcfg, x)
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), rtol=1e-4,
                               atol=1e-4)
    assert aux.shape == ()
    want = jax_moe.moe_reference(jp, cfg, jnp.asarray(x.numpy()))
    np.testing.assert_allclose(y_ref.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_moe_capacity_drops_are_bounded():
    cfg, tcfg = _moe_cfg()
    _, tp = _moe_params(cfg, 10)
    x = torch.tensor(np.asarray(
        jax.random.normal(jax.random.PRNGKey(11), (2, 16, cfg.d_model))))
    y, _ = moe.moe_forward(tp, tcfg, x)
    assert torch.isfinite(y).all()


def test_moe_combine_adds_in_slot_order():
    """A token's expert rows are added to zero in the table's slot order
    (expert-major), the order of the reference's scatter-add: equal bit
    for bit to that sequential sum in bf16, where order matters."""
    rng = np.random.default_rng(0)
    E, cap, d, T, k = 6, 8, 5, 9, 3
    table = np.full((E, cap), T, np.int32)
    for t in range(T):
        for e in rng.choice(E, k, replace=False):
            free = np.flatnonzero(table[e] == T)
            table[e, free[0]] = t
    ye = torch.tensor(rng.standard_normal((E, cap, d)) * 100,
                      dtype=torch.bfloat16)
    got = moe.combine(ye, torch.from_numpy(table), T, k)
    want = torch.zeros(T + 1, d, dtype=torch.bfloat16)
    for e in range(E):
        for s in range(cap):
            want[table[e, s]] = want[table[e, s]] + ye[e, s]
    assert torch.equal(got, want[:T])


def test_moe_step_reads_no_device_value_on_the_host(monkeypatch):
    """Nothing in ``moe_forward`` asks for a host value: no ``.item()``,
    ``tolist`` or conversion to a Python number (the async engine's
    captured decode burst replays an MoE stack)."""
    cfg, tcfg = _moe_cfg()
    _, tp = _moe_params(cfg, 3)
    x = torch.randn(4, 1, cfg.d_model)

    def refuse(*_a, **_k):
        raise AssertionError("a host read in moe_forward")
    for name in ("item", "tolist", "__bool__", "__int__", "__float__",
                 "nonzero"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    y, aux = moe.moe_forward(tp, tcfg, x)
    monkeypatch.undo()
    assert y.shape == x.shape and torch.isfinite(y).all()


# ---------------------------------------------------------------------------
# the SMOKEs through the model and the engines


@pytest.mark.parametrize("name", SMOKES)
def test_forward_and_decode_logits_match_the_reference(name):
    cfg, jparams, tcfg, tparams = _trees(name)
    tok = np.random.default_rng(2).integers(0, cfg.vocab, (2, 12)) \
        .astype(np.int32)
    hidden, _, jcache = jax_transformer.forward(
        jparams, cfg, {"tokens": jnp.asarray(tok)},
        cache=jax_transformer.init_cache(cfg, 2, 32, jnp.float32))
    want = np.asarray(jax_transformer.project_logits(jparams, cfg, hidden))
    cache = transformer.init_cache(tcfg, 2, 32, device="cpu")
    th, cache = transformer.forward(tparams, tcfg, torch.from_numpy(tok),
                                    cache=cache)
    got = transformer.project_logits(tparams, tcfg, th).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
    nxt = np.argmax(want[:, -1], -1).astype(np.int32)[:, None]
    for _ in range(3):
        jl, jcache = jax_transformer.decode_step(jparams, cfg,
                                                 jnp.asarray(nxt), jcache)
        tl, cache = transformer.decode_step(tparams, tcfg,
                                            torch.from_numpy(nxt), cache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-4,
                                   rtol=0)
        nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]


@pytest.mark.parametrize("kw", [dict(paged=True, attn_backend="flash"),
                                dict(paged=False)], ids=["flash", "slot"])
@pytest.mark.parametrize("name", SMOKES)
def test_engines_serve_like_the_reference(name, kw):
    cfg = get_config(name)
    want, got, _, _ = _run_both(name, _prompts(cfg, LENGTHS),
                                **dict(BASE, **kw))
    assert got == want


@pytest.mark.parametrize("name", ["qwen2.5-3b-smoke",
                                  "llama4-maverick-smoke"])
def test_paged_plain_read_and_prefix_cache_like_the_reference(name):
    """The plain read over the gathered tables, and the radix prefix cache
    (copy-on-write of every block position's pools: maverick's unit
    holds an attention and an MoE block)."""
    cfg = get_config(name)
    rng = np.random.default_rng(4)
    head = rng.integers(0, cfg.vocab, 16, dtype=np.int32)
    prompts = [np.concatenate([head, p]) for p in _prompts(cfg, [3, 30, 9])]
    want, got, jeng, eng = _run_both(name, prompts, paged=True,
                                     prefix_cache=True, **BASE)
    assert got == want
    assert eng.metrics.prefix_hits == jeng.metrics.prefix_hits >= 1
    if name.startswith("llama4"):
        assert set(eng.runner.cache["units"]) == {"b0", "b1"}


@pytest.mark.parametrize("paged", [True, False])
@pytest.mark.parametrize("name", ["qwen3-4b-smoke", "moonshot-v1-smoke"])
def test_seeded_sampled_rows_like_the_reference(name, paged):
    cfg = get_config(name)
    prompts = _prompts(cfg, [5, 21, 9, 14], seed=11)
    sps = [dict(temperature=1.0, top_k=40, top_p=0.9, seed=3 + i)
           for i in range(len(prompts))]
    want, got, _, _ = _run_both(name, prompts, sps=sps,
                                **dict(BASE, paged=paged))
    assert got == want


def test_moonshot_async_equals_sync_and_the_reference():
    """The async engine at K = 4 (captured bursts on the card, eager here)
    gives the synchronous engine's tokens and the reference's async
    engine's, with equal integer async stats."""
    name = "moonshot-v1-smoke"
    cfg, jparams, tcfg, tparams = _trees(name)
    prompts = _prompts(cfg, LENGTHS)
    kw = dict(BASE, paged=True, attn_backend="flash")
    want, sync, _, _ = _run_both(name, prompts, max_new=16, **kw)
    acfg = dict(enabled=True, max_device_ticks=4)
    jwant, got, jeng, eng = _run_both(
        name, prompts, max_new=16,
        jkw=dict(async_cfg=JaxAsyncConfig(**acfg)),
        tkw=dict(async_cfg=AsyncConfig(**acfg)), **kw)
    assert got == sync == want == jwant
    stats = eng.async_stats()
    assert stats["loop_bursts"] > 0
    for key in ("sync_ticks", "overlap_ticks", "loop_bursts",
                "loop_device_ticks", "device_ticks"):
        assert stats[key] == jeng.async_stats()[key], key


def test_qwen3_ngram_speculation_like_the_reference():
    name = "qwen3-4b-smoke"
    cfg = get_config(name)
    rng = np.random.default_rng(6)
    # repeated phrases give the n-gram drafter something to propose
    prompts = [np.tile(rng.integers(0, cfg.vocab, int(n), dtype=np.int32), 3)
               for n in (4, 7, 5)]
    spec = dict(drafter="ngram", k=4, k_max=6)
    want, got, jeng, eng = _run_both(
        name, prompts, max_new=12, jkw=dict(spec=JaxSpecConfig(**spec)),
        tkw=dict(spec=SpecConfig(**spec)), paged=True, max_batch=3,
        max_seq=96, block_size=8, prefill_chunk=16)
    assert got == want
    assert eng.metrics.spec_steps == jeng.metrics.spec_steps > 0


# ---------------------------------------------------------------------------
# bf16 trees


@pytest.mark.parametrize("name", ["qwen3-4b-smoke", "moonshot-v1-smoke",
                                  "llama4-maverick-smoke"])
def test_bf16_trees_keep_each_leafs_dtype(name):
    cfg, tcfg = test_torch_bf16._bf16(name)
    jparams = jax.tree.map(np.asarray, _perturbed(
        JaxModel(cfg).init(jax.random.PRNGKey(0))))
    tparams = from_jax_params(jparams, tcfg, device="cpu")
    want = dict(test_torch_bf16._leaves(jparams))
    got = dict(test_torch_bf16._leaves(tparams))
    assert set(got) == set(want)
    for key, leaf in want.items():
        assert str(got[key].dtype) == f"torch.{leaf.dtype}", key
        np.testing.assert_array_equal(got[key].float().numpy(),
                                      leaf.astype(np.float32))
        f32 = key.endswith("/router")
        assert (leaf.dtype == np.float32) == f32, key
    own = Model(tcfg).init(torch.Generator(), device="meta")
    assert dict((k, v.dtype) for k, v in test_torch_bf16._leaves(own)) \
        == {k: v.dtype for k, v in got.items()}
    if "moe" in cfg.pattern_unit():
        pos = f"b{cfg.pattern_unit().index('moe')}"
        moe_p = jparams["units"][pos]["moe"]
        moe_p["router"] = moe_p["router"].astype(jnp.bfloat16)
        with pytest.raises(ValueError, match="router"):
            from_jax_params(jparams, tcfg, device="cpu")


def test_bf16_qwen3_served_through_both_packages():
    """``tests/test_torch_bf16.py``'s judgement of a bf16 SMOKE."""
    test_torch_bf16.test_bf16_smoke_served_through_both_packages(
        "qwen3-4b-smoke", True)


# a router's top-k boundary gap (f32 logits) that bf16 rounding may cross;
# the gaps met on moonshot-v1-smoke are 0.0035-0.015 (ROADMAP §3)
ROUTER_TIE = 0.05


def _routing(record, n_layers, T):
    """Per layer, each token's kept experts, from the dispatch tables one
    forward recorded in order."""
    assert len(record) == n_layers
    return [[frozenset(np.argwhere(tb == t)[:, 0].tolist())
             for t in range(T)] for tb in record]


def _first_routing_difference(a, b, logits_f32, k):
    """The first token whose kept experts differ in some layer between two
    routings (T where none does), after checking that it is a router
    near-tie: the f32 router's k-th and (k+1)-th logits within ROUTER_TIE
    in the first layer that differs (an earlier token's routing, alike in
    both, gives every later token the same capacity ranks, so the first
    difference cannot be a drop alone)."""
    T = len(a[0])
    for t in range(T):
        layers_ = [L for L in range(len(a)) if a[L][t] != b[L][t]]
        if layers_:
            z = np.sort(logits_f32[layers_[0]][t])
            gap = float(z[-k] - z[-k - 1])
            assert gap <= ROUTER_TIE, (t, layers_[0], gap)
            return t, gap
    return T, None


@pytest.mark.parametrize("paged", [True, False])
def test_bf16_moe_served_through_both_packages(paged, monkeypatch):
    """moonshot-v1-smoke in bf16, served through both packages, judged by
    ROADMAP §3's bf16 rule with one change the router forces: expert
    choice is discrete, so where bf16 rounding reorders two experts at a
    router near-tie (or a capacity drop follows from one), the logits
    jump. Each package's bf16 forward is held to the f32 forward of the
    same rounded weights only at positions before its first routing
    difference (its every MoE layer keeping the f32 forward's experts for
    every token so far); that first difference must sit at a near-tie of
    the f32 router (within ROUTER_TIE). There the port's error lies
    within BF16_SLACK of the reference's. Tokens may part where the f32
    top-2 margin is within twice the reference's error, or at or after a
    routing difference of either package."""
    name = "moonshot-v1-smoke"
    cfg, tcfg = test_torch_bf16._bf16(name)
    f32_tcfg = torch_get_config(name)
    jparams = JaxModel(cfg).init(jax.random.PRNGKey(0))
    jparams_f32 = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    fparams = from_jax_params(jax.tree.map(np.asarray, jparams_f32),
                              f32_tcfg, device="cpu")
    kw = dict(paged=paged, max_batch=3, max_seq=96, block_size=8,
              prefill_chunk=16)
    prompts = test_torch_bf16._prompts(cfg)
    jdone = JaxEngine(cfg, jparams, JaxServeConfig(**kw)).run(
        [JaxRequest(rid=i, prompt=p, max_new=8)
         for i, p in enumerate(prompts)], max_steps=1000)
    tdone = Engine(tcfg, tparams, ServeConfig(**kw), device="cpu").run(
        [Request(rid=i, prompt=p, max_new=8)
         for i, p in enumerate(prompts)], max_steps=1000)
    want = {i: [int(t) for t in r.tokens_out] for i, r in jdone.items()}
    got = {i: [int(t) for t in r.tokens_out] for i, r in tdone.items()}

    tables, router = [], []
    port_route, jax_route = moe.route, jax_moe.route

    def port_rec(logits, c, cap):
        out = port_route(logits, c, cap)
        tables.append(out[0].numpy())
        router.append(logits.float().numpy())
        return out

    def jax_rec(logits, c, cap):
        out = jax_route(logits, c, cap)
        jax.debug.callback(lambda t: tables.append(np.asarray(t)), out[0],
                           ordered=True)
        return out
    monkeypatch.setattr(moe, "route", port_rec)
    monkeypatch.setattr(jax_moe, "route", jax_rec)

    L, k = cfg.n_layers, cfg.top_k
    ref_err, port_err, parted_from, gaps = [], [], {}, []
    for i, p in enumerate(prompts):
        seq = np.concatenate([p, np.asarray(want[i], np.int32)])
        T = len(seq)
        tokens = torch.from_numpy(seq[None])
        tables.clear(), router.clear()
        fl = transformer.project_logits(
            fparams, f32_tcfg, transformer.forward(fparams, f32_tcfg,
                                                   tokens)[0])[0].numpy()
        f32_route, f32_router = _routing(tables, L, T), list(router)
        tables.clear()
        tl = transformer.project_logits(
            tparams, tcfg, transformer.forward(tparams, tcfg,
                                               tokens)[0])[0].numpy()
        port_at, port_gap = _first_routing_difference(
            _routing(tables, L, T), f32_route, f32_router, k)
        tables.clear()
        jl, _ = JaxModel(cfg).forward(jparams, {"tokens": jnp.asarray(
            seq[None])})
        jl = np.asarray(jl, np.float32)[0]
        ref_at, ref_gap = _first_routing_difference(
            _routing(tables, L, T), f32_route, f32_router, k)
        gaps += [g for g in (port_gap, ref_gap) if g is not None]
        lo = len(p) - 1
        port_err.append(np.abs(tl - fl)[lo:max(lo, port_at)].ravel())
        ref_err.append(np.abs(jl - fl)[lo:max(lo, ref_at)].ravel())
        parted_from[i] = (min(port_at, ref_at), fl)
    ref_err, port_err = np.concatenate(ref_err), np.concatenate(port_err)
    assert ref_err.size and port_err.size
    assert ref_err.max() > 0
    assert port_err.max() <= test_torch_bf16.BF16_SLACK * ref_err.max(), \
        (port_err.max(), ref_err.max(), gaps)
    assert port_err.mean() \
        <= test_torch_bf16.BF16_MEAN_SLACK * ref_err.mean(), \
        (port_err.mean(), ref_err.mean())
    bound = 2 * ref_err.max()
    for i, p in enumerate(prompts):
        w, g = want[i], got[i]
        step = next((s for s, (a, b) in enumerate(zip(w, g)) if a != b),
                    None)
        if step is None:
            assert len(w) == len(g)
            continue
        pos = len(p) - 1 + step
        first, fl = parted_from[i]
        z = np.sort(fl[pos])
        assert pos >= first or z[-1] - z[-2] <= bound, (i, step)


# ---------------------------------------------------------------------------
# the cost model


@pytest.mark.parametrize("w,hp", [(1, False), (16, True)])
def test_cost_model_counts_moe_products_as_flop_counter(w, hp, monkeypatch):
    """On moonshot-v1-smoke the paged step's product scopes (attn, the
    MoE block's ffn_dense, logits) equal what FlopCounterMode counts in
    that scope's code, within 1%; its MoE products are the f32 router,
    all E x capacity(R) expert rows and the shared expert."""
    name = "moonshot-v1-smoke"
    _, _, tcfg, tparams = _trees(name)
    eng = Engine(tcfg, tparams, ServeConfig(paged=True, **BASE),
                 device="cpu")
    counts = dict.fromkeys(("attn", "ffn_dense", "ffn_sparse", "logits"), 0)

    def counted(scope, fn):
        def wrapper(*args, **kwargs):
            with FlopCounterMode(display=False) as fc:
                out = fn(*args, **kwargs)
            counts[scope] += fc.get_total_flops()
            return out
        return wrapper
    monkeypatch.setattr(attention, "attn_step_paged",
                        counted("attn", attention.attn_step_paged))
    monkeypatch.setattr(moe, "moe_forward",
                        counted("ffn_dense", moe.moe_forward))
    monkeypatch.setattr(transformer, "project_logits",
                        counted("logits", transformer.project_logits))
    runner = eng.runner
    B, MB = runner.scfg.max_batch, runner.scfg.blocks_per_seq
    batch = runner.new_batch(w, np.arange(B * MB, dtype=np.int32)
                             .reshape(B, MB))
    for slot in range(B):
        batch.add_row(slot, PREFILL if hp else DECODE,
                      np.arange(1, w + 1), 8)
    runner.step(batch)
    cost = costmodel.step_cost(runner, w, hp)
    assert counts["ffn_sparse"] == 0
    for scope, n in counts.items():
        assert cost.by_scope[scope]["flops"] == pytest.approx(n, rel=0.01), \
            scope
    R = B * w
    cap = moe.capacity(R, tcfg)
    d, f, E = tcfg.d_model, tcfg.d_ff, tcfg.n_experts
    fs = f * tcfg.n_shared_experts
    per_layer = 2 * R * d * E + 3 * 2 * E * cap * d * f + 3 * 2 * R * d * fs
    assert cost.by_scope["ffn_dense"]["flops"] == tcfg.n_layers * per_layer
