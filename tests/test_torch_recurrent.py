"""The recurrent families in the port (``models/ssm.py``,
``models/xlstm.py``, blocks by kind in ``models/transformer.py``, the
slot engine over recurrent state and the sequential drafting path), on
the CPU, against the JAX reference.

Each of the reference's own cases (``tests/test_models.py``) runs through
both packages on the same numpy-seeded inputs and the reference's
weights, carried across with ``from_jax_params``. Tolerances: block
outputs, states and logits within atol=2e-4, rtol=1e-4 of the
reference's (f32 sums in another order drift by ~1e-6 relative); inside
the port, chunked against recurrent forms within the reference's own
bounds (1e-4 for Mamba2, 2e-4 for mLSTM, 2e-3 for decode against a full
forward); greedy and seeded sampled tokens identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs.base import ServeConfig as JaxServeConfig
from repro.models import Model as JaxModel
from repro.models import ssm as jssm
from repro.models import xlstm as jxlstm
from repro.serve.engine import Engine as JaxEngine
from repro.serve.sampling import SamplingParams as JaxSamplingParams
from repro.serve.scheduler import Request as JaxRequest
from repro.spec import SelfSpecDrafter as JaxSelfSpec
from repro.spec.drafter import ModelDrafter as JaxModelDrafter
from repro_torch.configs import get_config as torch_get_config
from repro_torch.configs.base import ServeConfig
from repro_torch.models import Model
from repro_torch.models import ssm, transformer, xlstm
from repro_torch.serve.engine import Engine
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.scheduler import Request
from repro_torch.spec import SelfSpecDrafter
from repro_torch.spec.drafter import ModelDrafter
from repro_torch.weights import from_jax_params

TOL = dict(atol=2e-4, rtol=1e-4)
FAMILIES = ["zamba2-smoke", "xlstm-smoke"]
SLOT_KW = dict(paged=False, max_batch=3, max_seq=96)
LENGTHS = [5, 37, 9, 60, 3, 21]


def _t(tree):
    """A numpy/jax tree as f32 CPU tensors, key for key."""
    return {k: _t(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in tree.items()}


def _np(x):
    return np.asarray(x, dtype=np.float32)


@pytest.fixture(scope="module")
def models():
    out = {}
    for name in FAMILIES:
        cfg = get_config(name)
        jparams = JaxModel(cfg).init(jax.random.PRNGKey(0))
        tcfg = torch_get_config(name)
        out[name] = (cfg, jparams, tcfg, from_jax_params(
            jax.tree.map(np.asarray, jparams), tcfg, device="cpu"))
    return out


def test_configs_match_the_reference():
    """The copies of zamba2-2.7b and xlstm-125m (CONFIG and SMOKE): the
    same fields, pattern unit and analytic parameter count."""
    for name in ("zamba2-2.7b", "zamba2-smoke", "xlstm-125m",
                 "xlstm-smoke"):
        ref, port = get_config(name), torch_get_config(name)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.pattern_unit() == ref.pattern_unit()
        assert port.param_count() == ref.param_count()
    assert torch_get_config("zamba2-2.7b").param_count() == 1_984_767_520
    assert torch_get_config("zamba2-2.7b").d_head == 80


# ---------------------------------------------------------------------------
# the reference's cases of tests/test_models.py, through both packages


def _mamba_case(seed, B, S):
    cfg = get_config("zamba2-smoke")
    p = jssm.init_mamba2(jax.random.PRNGKey(seed), cfg, jnp.float32)
    x = (np.random.default_rng(seed).standard_normal((B, S, cfg.d_model))
         * 0.5).astype(np.float32)
    return cfg, torch_get_config(cfg.name), p, _t(p), x


def test_mamba2_chunked_matches_recurrent():
    cfg, tcfg, jp, tp, x = _mamba_case(2, 2, 16)
    y_par, _ = ssm.mamba2_forward(tp, tcfg, torch.from_numpy(x), chunk=8)
    y_rec = ssm.mamba2_reference(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(y_par.numpy(), y_rec.numpy(), rtol=1e-4,
                               atol=1e-4)
    j_par, _ = jssm.mamba2_forward(jp, cfg, jnp.asarray(x), chunk=8)
    j_rec = jssm.mamba2_reference(jp, cfg, jnp.asarray(x))
    np.testing.assert_allclose(y_par.numpy(), _np(j_par), **TOL)
    np.testing.assert_allclose(y_rec.numpy(), _np(j_rec), **TOL)


def test_mamba2_prefill_state_continues_decode():
    cfg, tcfg, jp, tp, x = _mamba_case(4, 1, 12)
    xt = torch.from_numpy(x)
    y_full, _ = ssm.mamba2_forward(tp, tcfg, xt, chunk=4)
    cache = ssm.init_mamba2_cache(tcfg, 1, torch.float32, "cpu")
    y_pre, cache = ssm.mamba2_forward(tp, tcfg, xt[:, :8], cache=cache,
                                      chunk=4)
    jc = jssm.init_mamba2_cache(cfg, 1, jnp.float32)
    _, jc = jssm.mamba2_forward(jp, cfg, jnp.asarray(x[:, :8]), cache=jc,
                                chunk=4)
    outs = [y_pre]
    for t in range(8, 12):
        o, cache = ssm.mamba2_decode(tp, tcfg, xt[:, t:t + 1], cache)
        jo, jc = jssm.mamba2_decode(jp, cfg, jnp.asarray(x[:, t:t + 1]), jc)
        np.testing.assert_allclose(o.numpy(), _np(jo), **TOL)
        outs.append(o)
    np.testing.assert_allclose(y_full.numpy(), torch.cat(outs, 1).numpy(),
                               rtol=1e-4, atol=1e-4)
    for leaf in ("ssm", "conv"):
        assert cache[leaf].dtype == torch.float32
        np.testing.assert_allclose(cache[leaf].numpy(), _np(jc[leaf]), **TOL)


def _mlstm_inputs(seed, B, S, H, P):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, S, H, P)).astype(np.float32)
               for _ in range(3))
    i_pre = rng.standard_normal((B, S, H)).astype(np.float32)
    f_pre = (rng.standard_normal((B, S, H)) + 2.0).astype(np.float32)
    return q, k, v, i_pre, f_pre


def test_mlstm_parallel_matches_recurrent():
    B, S, H, P = 2, 24, 2, 8
    arrs = _mlstm_inputs(6, B, S, H, P)
    q, k, v, i_pre, f_pre = (torch.from_numpy(a) for a in arrs)
    y_par, st_par = xlstm.mlstm_parallel(q, k, v, i_pre, f_pre, block=8,
                                         return_state=True)
    state = (torch.zeros((B, H, P, P)), torch.zeros((B, H, P)),
             torch.full((B, H), xlstm.NEG_INF))
    ys = []
    for t in range(S):
        state, y = xlstm.mlstm_step(state, q[:, t], k[:, t], v[:, t],
                                    i_pre[:, t], f_pre[:, t])
        ys.append(y)
    y_rec = torch.stack(ys, dim=1)
    np.testing.assert_allclose(y_par.numpy(), y_rec.numpy(), rtol=2e-4,
                               atol=2e-4)
    for a, b in zip(st_par[:2], state[:2]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=2e-4)
    j_par, j_st = jxlstm.mlstm_parallel(*(jnp.asarray(a) for a in arrs),
                                        block=8, return_state=True)
    np.testing.assert_allclose(y_par.numpy(), _np(j_par), **TOL)
    for a, b in zip(st_par, j_st):
        np.testing.assert_allclose(a.numpy(), _np(b), **TOL)


def test_mlstm_initial_state_resume():
    """parallel(x[0:S]) == parallel(x[0:h]) -> parallel(x[h:S], state)."""
    B, S, H, P = 1, 16, 2, 8
    arrs = _mlstm_inputs(7, B, S, H, P)
    q, k, v, ip, fp = (torch.from_numpy(a) for a in arrs)
    y_full = xlstm.mlstm_parallel(q, k, v, ip, fp, block=4)
    y1, st = xlstm.mlstm_parallel(q[:, :8], k[:, :8], v[:, :8], ip[:, :8],
                                  fp[:, :8], block=4, return_state=True)
    y2 = xlstm.mlstm_parallel(q[:, 8:], k[:, 8:], v[:, 8:], ip[:, 8:],
                              fp[:, 8:], block=4, initial_state=st)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                               y_full.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(
        y_full.numpy(), _np(jxlstm.mlstm_parallel(
            *(jnp.asarray(a) for a in arrs), block=4)), **TOL)


def test_slstm_block_matches_reference(models):
    """The sLSTM block's per-token scan, its R dict and f32 state."""
    cfg, jparams, tcfg, tparams = models["xlstm-smoke"]
    jp = jax.tree.map(lambda a: a[0], jparams["units"]["b1"])
    tp = transformer._index(tparams["units"]["b1"], 0)
    x = np.random.default_rng(8).standard_normal(
        (2, 9, cfg.d_model)).astype(np.float32)
    jc = jxlstm.init_slstm_cache(cfg, 2, jnp.float32)
    jy, jc = jxlstm.slstm_block_forward(jp, cfg, jnp.asarray(x), jc)
    tc = xlstm.init_slstm_cache(tcfg, 2, torch.float32, "cpu")
    ty, tc = xlstm.slstm_block_forward(tp, tcfg, torch.from_numpy(x), tc)
    np.testing.assert_allclose(ty.numpy(), _np(jy), **TOL)
    for g in "cnhm":
        np.testing.assert_allclose(tc[g].numpy(), _np(jc[g]), **TOL)


@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_then_decode_matches_forward(models, name):
    """Teacher-forced decode after a prefill of 8 reproduces the
    full-forward logits (the reference's bound, 2e-3), and every logit of
    the port is within TOL of the reference's: forward, prefill and each
    decode step, with every cache leaf."""
    cfg, jparams, tcfg, tparams = models[name]
    jm, tm = JaxModel(cfg), Model(tcfg)
    B, S, pre = 2, 12, 8
    toks = np.random.default_rng(13).integers(0, cfg.vocab, (B, S),
                                              dtype=np.int32)
    j_full, _ = jm.forward(jparams, {"tokens": jnp.asarray(toks)})
    hidden, _, _ = transformer.forward(tparams, tcfg, torch.from_numpy(toks))
    t_full = transformer.project_logits(tparams, tcfg, hidden)
    np.testing.assert_allclose(t_full.numpy(), _np(j_full), **TOL)

    jc = jm.init_cache(B, 16, jnp.float32)
    tc = tm.init_cache(B, 16, device="cpu")
    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks[:, :pre])}, jc)
    tl, tc = tm.prefill(tparams, torch.from_numpy(toks[:, :pre]), tc)
    np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL)
    errs = []
    for t in range(pre, S):
        jl, jc = jm.decode_step(jparams, jnp.asarray(toks[:, t:t + 1]), jc)
        tl, tc = tm.decode_step(tparams, torch.from_numpy(toks[:, t:t + 1]),
                                tc)
        np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL)
        errs.append(float((tl[:, 0] - t_full[:, t]).abs().max()))
    assert max(errs) < 2e-3, errs
    np.testing.assert_array_equal(tc["lens"].numpy(), np.asarray(jc["lens"]))
    leaves = jax.tree_util.tree_leaves_with_path(jc["units"])
    assert len(leaves) == sum(len(v) for v in tc["units"].values())
    for path, leaf in leaves:
        got = tc["units"]
        for key in path:
            got = got[key.key]
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), _np(leaf), **TOL)


def test_cache_layout_by_block_kind():
    """One cache entry per block position, every shared_attn invocation a
    KV cache of its own; params keep the shared block outside the units."""
    cfg = torch_get_config("zamba2-smoke")
    c = Model(cfg).init_cache(3, 24, device="cpu")
    assert sorted(c["units"]) == [f"b{j}" for j in range(6)]
    assert c["units"]["b5"]["k"].shape == (cfg.n_units, 3, 24,
                                           cfg.n_kv_heads, cfg.d_head)
    assert c["units"]["b0"]["ssm"].shape[:2] == (cfg.n_units, 3)
    p = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    assert sorted(p["units"]) == [f"b{j}" for j in range(5)]
    assert p["shared"]["attn"]["wq"].shape == (cfg.d_model,
                                               cfg.n_heads * cfg.d_head)
    xc = Model(torch_get_config("xlstm-smoke")).init_cache(2, 8,
                                                           device="cpu")
    assert torch.equal(xc["units"]["b0"]["m"],
                       torch.full_like(xc["units"]["b0"]["m"],
                                       xlstm.NEG_INF))
    assert sorted(xc["units"]["b1"]) == ["c", "h", "m", "n"]


# ---------------------------------------------------------------------------
# the slot engine


def _prompts(cfg, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, size=int(n), dtype=np.int32)
            for n in lengths]


def _sps(n, port):
    cls = SamplingParams if port else JaxSamplingParams
    return [cls(temperature=(0.7, 1.0)[i % 2], top_k=(0, 40)[(i // 2) % 2],
                top_p=(1.0, 0.9)[i % 2], seed=i) for i in range(n)]


def _serve(engine, req_cls, prompts, sps=None, max_new=8):
    reqs = [req_cls(rid=i, prompt=p, max_new=max_new) if sps is None
            else req_cls(rid=i, prompt=p, max_new=max_new, sampling=sps[i])
            for i, p in enumerate(prompts)]
    done = engine.run(reqs, max_steps=1000)
    return {i: [int(t) for t in r.tokens_out] for i, r in done.items()}


@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("name", FAMILIES)
def test_slot_engine_matches_reference_slot_engine(models, name, sampled):
    """Six prompts of 3..60 tokens through three slots: requests wait for
    a slot, slots are reused, idle slots decode padding and their
    recurrent state advances until the next admission overwrites it.
    Greedy rows, or seeded sampled rows (temperature, top-k, top-p)."""
    cfg, jparams, tcfg, tparams = models[name]
    prompts = _prompts(cfg, LENGTHS)
    want = _serve(JaxEngine(cfg, jparams, JaxServeConfig(**SLOT_KW)),
                  JaxRequest, prompts, _sps(6, False) if sampled else None)
    eng = Engine(tcfg, tparams, ServeConfig(**SLOT_KW), device="cpu")
    got = _serve(eng, Request, prompts, _sps(6, True) if sampled else None)
    assert got == want
    assert eng.metrics.summary()["n_finished"] == len(prompts)
    assert eng.admission_free == SLOT_KW["max_batch"]


def test_merge_slot_writes_whole_recurrent_rows(models):
    """A recurrent leaf's row is replaced whole by the admitted prompt's
    state; a KV leaf's row keeps the prompt's positions and zeroes the
    rest."""
    _, _, tcfg, tparams = models["zamba2-smoke"]
    eng = Engine(tcfg, tparams, ServeConfig(**SLOT_KW), device="cpu")
    for leaf in ("ssm", "conv"):
        eng.cache["units"]["b0"][leaf].fill_(7.0)
    eng.cache["units"]["b5"]["k"].fill_(7.0)
    prompt = _prompts(tcfg, [11])[0]
    eng.add_request(Request(rid=0, prompt=prompt, max_new=4))
    slot = eng.alloc.active[0]
    tmp = eng.model.init_cache(1, 11, device="cpu")
    eng.model.prefill(eng.params, torch.from_numpy(prompt[None]), tmp)
    for leaf in ("ssm", "conv"):
        assert torch.equal(eng.cache["units"]["b0"][leaf][:, slot],
                           tmp["units"]["b0"][leaf][:, 0])
    k = eng.cache["units"]["b5"]["k"][:, slot]
    assert torch.equal(k[:, :11], tmp["units"]["b5"]["k"][:, 0])
    assert not k[:, 11:].any()
    other = 1 - slot
    assert (eng.cache["units"]["b0"]["ssm"][:, other] == 7.0).all()


@pytest.mark.parametrize("name,ok,bad", [
    ("zamba2-smoke", [128, 256], [129, 200]),
    ("xlstm-smoke", [200, 256], [257, 300])])
def test_prompt_length_limit_matches_the_reference(models, name, ok, bad):
    """A prompt longer than a chunk (Mamba2: 128) or a block (mLSTM: 256)
    must be a multiple of it: the reference's prefill asserts, the port's
    raises ValueError at the same lengths (and its engine before it takes
    a slot). Neither pads."""
    cfg, jparams, tcfg, tparams = models[name]
    jm, tm = JaxModel(cfg), Model(tcfg)
    for S in ok + bad:
        toks = np.random.default_rng(S).integers(0, cfg.vocab, (1, S),
                                                 dtype=np.int32)
        if S in bad:
            with pytest.raises(AssertionError):
                jm.prefill(jparams, {"tokens": jnp.asarray(toks)},
                           jm.init_cache(1, S, jnp.float32))
            with pytest.raises(ValueError, match="multiple of"):
                tm.prefill(tparams, torch.from_numpy(toks),
                           tm.init_cache(1, S, device="cpu"))
        else:
            jl, _ = jm.prefill(jparams, {"tokens": jnp.asarray(toks)},
                               jm.init_cache(1, S, jnp.float32))
            tl, _ = tm.prefill(tparams, torch.from_numpy(toks),
                               tm.init_cache(1, S, device="cpu"))
            np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL)
    eng = Engine(tcfg, tparams, ServeConfig(paged=False, max_batch=2,
                                            max_seq=512), device="cpu")
    with pytest.raises(ValueError, match="multiple of"):
        eng.add_request(Request(rid=0, prompt=np.zeros(bad[0], np.int32),
                                max_new=2))
    assert eng.admission_free == 2 and not eng._busy()


# ---------------------------------------------------------------------------
# refusals the reference keeps


@pytest.mark.parametrize("name", FAMILIES)
def test_paged_engine_refuses_recurrent_families(models, name):
    """tests/test_paged_serving.py:225's refusal, with the reference's
    message, from the cache and from the paged engine."""
    cfg, jparams, tcfg, tparams = models[name]
    with pytest.raises(ValueError, match="attention-only") as want:
        JaxModel(cfg).init_paged_cache(1, 4, 4, 4, jnp.float32)
    with pytest.raises(ValueError, match="attention-only") as got:
        Model(tcfg).init_paged_cache(1, 4, 4, 4, device="cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="attention-only"):
        Engine(tcfg, tparams, ServeConfig(paged=True, max_batch=2,
                                          max_seq=32), device="cpu")


def test_selfspec_requires_attention_stack(models):
    """tests/test_spec.py:220's refusal, with the reference's message."""
    cfg, jparams, tcfg, tparams = models["zamba2-smoke"]
    with pytest.raises(ValueError, match="attention") as want:
        JaxSelfSpec(cfg, None, 64)
    with pytest.raises(ValueError, match="attention") as got:
        SelfSpecDrafter(tcfg, tparams, 64, device="cpu")
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the sequential drafter of recurrent draft models


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("name", FAMILIES)
def test_sequential_drafter_matches_the_reference(models, name,
                                                  temperature):
    """A recurrent draft model drafts one request at a time through a
    batch-1 cache: proposals (and, sampled, their proposal laws), the
    re-feed from scratch when the context parts from the fed stream, the
    early stop at a full cache and ``steps`` all equal the reference's."""
    cfg, jparams, tcfg, tparams = models[name]
    kw = dict(max_seq=40, temperature=temperature, seed=3, max_batch=2)
    jd = JaxModelDrafter(cfg, jparams, **kw)
    td = ModelDrafter(tcfg, tparams, device="cpu", **kw)
    assert not td._batched
    rng = np.random.default_rng(21)
    ctx = {r: list(rng.integers(0, cfg.vocab, 9 + 4 * r)) for r in range(3)}
    for it in range(4):
        items = [(r, np.asarray(c, np.int32), 3 + (r + it) % 2)
                 for r, c in ctx.items()]
        want = jd.propose_batch(items)
        got = td.propose_batch(items)
        for (jt, jq), (tt, tq) in zip(want, got):
            assert list(tt) == list(jt)
            assert (tq is None) == (jq is None)
            if jq is not None:
                np.testing.assert_allclose(tq, jq, atol=1e-6)
        assert td.steps == jd.steps
        for (r, c, _), (toks, _) in zip(items, got):
            # accept a prefix, then (every other round) diverge
            n = len(toks) // 2 if (r + it) % 2 else len(toks)
            ctx[r] = list(c) + list(toks[:n]) + ([5] if n < len(toks)
                                                  else [])
    td.forget(0)
    jd.forget(0)
    assert 0 not in td._seq_caches and 0 not in td._fed
    long_ctx = np.arange(38, dtype=np.int32) % cfg.vocab
    assert [list(t) for t, _ in td.propose_batch([(9, long_ctx, 4)])] \
        == [list(t) for t, _ in jd.propose_batch([(9, long_ctx, 4)])]
    assert td.steps == jd.steps
