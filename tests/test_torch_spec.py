"""Speculative decoding in the port (``repro_torch.spec`` and the paged
engine's spec tick), on the CPU, against the JAX reference.

Both packages run on the same weights (``init_params`` of the reference,
carried across with ``from_jax_params``; the self-speculation predictors
with ``from_jax_predictors``) and the same numpy-seeded prompts. Greedy
spec output must equal the port's non-spec paged engine and the
reference's spec engine token for token; seeded sampled spec rows must
equal the reference's token for token, since both draw their acceptance
uniforms from the same numpy streams (they could part only where a
uniform lands within the logits' noise, about 1e-6, of its accept
threshold min(1, p/q); no such near-tie occurs in these rows).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs.base import ServeConfig as JaxServeConfig
from repro.configs.base import SpecConfig as JaxSpecConfig
from repro.core import sparsity as jax_sparsity
from repro.models import Model as JaxModel
from repro.serve import paged_kv as jax_paged_kv
from repro.serve.engine import Engine as JaxEngine
from repro.serve.prefix_cache import RadixPrefixCache as JaxRadix
from repro.serve.sampling import SamplingParams as JaxSamplingParams
from repro.serve.scheduler import Request as JaxRequest
from repro import spec as jax_spec
from repro.spec import selfspec as jax_selfspec
from repro_torch import spec as tspec
from repro_torch.configs import get_config as torch_get_config
from repro_torch.configs.base import ServeConfig, SpecConfig
from repro_torch.core import sparsity
from repro_torch.models import Model
from repro_torch.serve import api, paged_kv
from repro_torch.serve.engine import Engine
from repro_torch.serve.prefix_cache import RadixPrefixCache
from repro_torch.serve.runner import DECODE, VERIFY
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.scheduler import Request
from repro_torch.spec import selfspec
from repro_torch.weights import from_jax_params, from_jax_predictors

DRAFT = "nectar-relu-llama-draft"
BASE_KW = dict(max_batch=3, max_seq=96, paged=True, block_size=8,
               prefill_chunk=16)
SPECS = {
    "ngram": dict(drafter="ngram", k=4, k_max=6),
    "model": dict(drafter="model", k=3, k_max=4, draft_name=DRAFT),
    "selfspec": dict(drafter="selfspec", k=3, k_max=4),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the port's CPU ops here. These tests run
    next to other test workers, and torch's default of one thread per
    core then oversubscribes the host, and the predictor's small
    autograd steps slow down by orders of magnitude."""
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


@pytest.fixture(scope="module")
def draft():
    dcfg = get_config(DRAFT)
    jparams = JaxModel(dcfg).init(jax.random.PRNGKey(7))
    tcfg = torch_get_config(DRAFT)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return dcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def preds(nectar):
    """The reference's calibrated self-spec predictors (rank 16, seed 0),
    and the same predictors in the port."""
    cfg, jparams, tcfg, _ = nectar
    jp = jax_selfspec.calibrate_predictors(cfg, jparams, 16, seed=0)
    return jp, from_jax_predictors(jax.tree.map(np.asarray, jp), tcfg,
                                   device="cpu")


def _prompts(cfg, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, size=int(n), dtype=np.int32)
            for n in lengths]


def _spec_prompts(cfg):
    """Random prompts and a repetitive one (the n-gram drafter's case)."""
    return _prompts(cfg, [5, 23, 9, 40]) \
        + [np.tile(np.array([3, 1, 4, 1, 5], np.int32), 8)]


def _drafters(name, nectar, draft, preds, max_seq=BASE_KW["max_seq"],
              max_batch=BASE_KW["max_batch"]):
    """(reference drafter, port drafter) for spec ``name``; None for the
    ones the engines build from the config alone."""
    if name != "selfspec":
        return None, None
    cfg, jparams, tcfg, tparams = nectar
    jd = jax_spec.SelfSpecDrafter(cfg, jparams, max_seq, max_batch=max_batch)
    jd.preds = preds[0]
    td = tspec.SelfSpecDrafter(tcfg, tparams, max_seq, max_batch=max_batch,
                               device="cpu", preds=preds[1])
    return jd, td


def _serve_reference(cfg, params, prompts, max_new=10, drafter=None,
                     draft_params=None, sps=None, **kw):
    eng = JaxEngine(cfg, params, JaxServeConfig(**kw), drafter=drafter,
                    draft_params=draft_params)
    done = eng.run([JaxRequest(rid=i, prompt=p, max_new=max_new,
                               sampling=(JaxSamplingParams() if sps is None
                                         else sps[i][0]))
                    for i, p in enumerate(prompts)], max_steps=2000)
    return {i: [int(t) for t in r.tokens_out] for i, r in done.items()}, eng


def _serve_port(cfg, params, prompts, max_new=10, drafter=None,
                draft_params=None, sps=None, **kw):
    eng = Engine(cfg, params, ServeConfig(**kw), device="cpu",
                 drafter=drafter, draft_params=draft_params)
    done = eng.run([Request(rid=i, prompt=p, max_new=max_new,
                            sampling=(SamplingParams() if sps is None
                                      else sps[i][1]))
                    for i, p in enumerate(prompts)], max_steps=2000)
    return {i: [int(t) for t in r.tokens_out] for i, r in done.items()}, eng


def _serve_both(name, nectar, draft, preds, prompts, max_new=10, sps=None,
                **kw):
    cfg, jparams, tcfg, tparams = nectar
    jd, td = _drafters(name, nectar, draft, preds,
                       max_seq=kw.get("max_seq", BASE_KW["max_seq"]),
                       max_batch=kw.get("max_batch", BASE_KW["max_batch"]))
    want, jeng = _serve_reference(
        cfg, jparams, prompts, max_new, drafter=jd, draft_params=draft[1],
        sps=sps, spec=JaxSpecConfig(**SPECS[name]), **kw)
    got, eng = _serve_port(
        tcfg, tparams, prompts, max_new, drafter=td, draft_params=draft[3],
        sps=sps, spec=SpecConfig(**SPECS[name]), **kw)
    return want, jeng, got, eng


@pytest.fixture(scope="module")
def baseline(nectar):
    """The port's non-spec paged engine on ``_spec_prompts``."""
    _, _, tcfg, tparams = nectar
    return _serve_port(tcfg, tparams, _spec_prompts(tcfg), **BASE_KW)[0]


# ---------------------------------------------------------------------------
# greedy token identity, through every drafter


@pytest.mark.parametrize("name", list(SPECS))
def test_greedy_spec_token_identical(nectar, draft, preds, baseline, name):
    """Speculation changes cost, never content: the port's spec engine
    equals its non-spec paged engine and the reference's spec engine, and
    the drafter saw the same stream (verify steps, drafted and accepted
    tokens, draft-model steps) as the reference's."""
    cfg = nectar[0]
    want, jeng, got, eng = _serve_both(name, nectar, draft, preds,
                                       _spec_prompts(cfg), **BASE_KW)
    assert got == baseline
    assert got == want
    assert eng.pool.n_free == eng.pool.n_blocks
    m, jm = eng.metrics, jeng.metrics
    assert m.spec_steps > 0
    assert (m.spec_steps, m.spec_drafted, m.spec_accepted, m.spec_emitted) \
        == (jm.spec_steps, jm.spec_drafted, jm.spec_accepted,
            jm.spec_emitted)
    assert getattr(eng.drafter, "steps", 0) \
        == getattr(jeng.drafter, "steps", 0)
    assert eng.kctl.k == jeng.kctl.k


@pytest.mark.parametrize("name", list(SPECS))
def test_spec_summary_and_weight_stream_match_the_reference(
        nectar, draft, preds, name):
    """The summary's spec keys, their values, and the traffic totals with
    the drafter's own weight stream folded in (0 for n-gram)."""
    cfg = nectar[0]
    prompts = _prompts(cfg, [9, 17], seed=11)
    _, jeng, _, eng = _serve_both(name, nectar, draft, preds, prompts,
                                  max_new=8, **BASE_KW)
    js, s = jeng.metrics.summary(), eng.metrics.summary()
    for key in ("spec_steps", "spec_acceptance_rate",
                "spec_tokens_per_verify", "spec_per_request",
                "generated_tokens", "decode_steps"):
        assert s[key] == js[key], key
    for key in ("weight_bytes", "sparse_savings_bytes", "kv_bytes"):
        assert s[key] == pytest.approx(js[key], rel=1e-12), key
    per_step = eng.drafter.weight_bytes_per_step(eng.scfg)
    assert per_step == jeng.drafter.weight_bytes_per_step(jeng.scfg)
    assert (per_step > 0) == (name != "ngram")
    assert eng._draft_steps_seen == jeng._draft_steps_seen
    assert (eng._draft_steps_seen > 0) == (name != "ngram")
    assert sum(r["emitted"] for r in s["spec_per_request"].values()) \
        == s["generated_tokens"] - len(prompts)   # first tokens: prefill


def test_verify_step_matches_sequential_decode(nectar):
    """One K+1-position VERIFY row of the port's forward_step gives the
    logits chain of feeding the same tokens one DECODE row at a time
    (2e-4), and the reference's verify logits on the same weights."""
    cfg, jparams, tcfg, tparams = nectar
    model, jmodel = Model(tcfg), JaxModel(cfg)
    bs, MB, nb = 8, 8, 16
    prompt = _prompts(cfg, [13], seed=4)[0]
    toks = _prompts(cfg, [4], seed=5)[0]           # pending + 3 drafts
    P = len(prompt)
    tables = np.full((1, MB), nb, np.int32)
    tables[0] = np.arange(MB)

    def fresh():
        c = model.init_paged_cache(1, nb, bs, MB, device="cpu")
        c["block_tables"] = torch.tensor(tables)
        c["lens"] = torch.zeros(1, dtype=torch.int32)
        with torch.no_grad():
            model.forward_step(
                tparams, torch.tensor(np.pad(prompt, (0, 16 - P))[None]), c,
                torch.tensor([P], dtype=torch.int32),
                torch.ones(1, dtype=torch.bool), bs)
        return c

    def step(c, t, lens):
        c["lens"] = torch.tensor([lens], dtype=torch.int32)
        with torch.no_grad():
            return model.forward_step(
                tparams, torch.tensor(np.asarray(t, np.int32)[None]), c,
                torch.tensor([len(t)], dtype=torch.int32),
                torch.zeros(1, dtype=torch.bool), bs,
                has_prefill=False)[0].numpy()

    verify = step(fresh(), toks, P)
    c = fresh()
    seq = np.stack([step(c, [t], P + i)[0] for i, t in enumerate(toks)])
    np.testing.assert_allclose(verify, seq, rtol=2e-4, atol=2e-4)
    assert list(verify.argmax(-1)) == list(seq.argmax(-1))

    jc = jmodel.init_paged_cache(1, nb, bs, MB, jnp.float32)
    jc["block_tables"] = jnp.asarray(tables)
    jc["lens"] = jnp.zeros((1,), jnp.int32)
    _, jc = jmodel.forward_step(
        jparams, jnp.asarray(np.pad(prompt, (0, 16 - P))[None]), jc,
        jnp.full((1,), P, jnp.int32), jnp.ones((1,), bool), bs)
    jc["lens"] = jnp.full((1,), P, jnp.int32)
    jv, _ = jmodel.forward_step(jparams, jnp.asarray(toks[None]), jc,
                                jnp.full((1,), len(toks), jnp.int32),
                                jnp.zeros((1,), bool), bs)
    np.testing.assert_allclose(verify, np.asarray(jv)[0], rtol=2e-4,
                               atol=2e-4)


def test_verify_rows_take_the_sparse_ffn(nectar):
    """A step of VERIFY and DECODE rows only is a no-prefill step: the
    runner asks the model for the sparse FFN alone."""
    _, _, tcfg, tparams = nectar
    eng = Engine(tcfg, tparams, ServeConfig(spec=SpecConfig(k_max=5),
                                            **BASE_KW), device="cpu")
    assert 6 in eng.runner.buckets
    seen = []
    fwd = eng.model.forward_step

    def recording(*args, **kw):
        seen.append(kw["has_prefill"])
        return fwd(*args, **kw)

    eng.model.forward_step = recording
    batch = eng.runner.new_batch(6, eng.pool.tables())
    batch.add_row(0, VERIFY, np.arange(6), 0)
    batch.add_row(1, DECODE, np.arange(1), 0)
    eng.runner.step(batch)
    assert batch.tokens.shape[1] == 6 and seen == [False]


# ---------------------------------------------------------------------------
# acceptance rules and adaptive K, against the reference on the same
# arrays and RNG streams


def _accept_case(rng, m=5, V=12):
    logits = rng.standard_normal((m + 1, V)).astype(np.float32) * 2
    draft = rng.integers(0, V, m).astype(np.int32)
    q = rng.dirichlet(np.ones(V), m).astype(np.float32)
    return draft, q, logits


@pytest.mark.parametrize("rule", ["greedy", "rejection", "rejection_onehot",
                                  "filtered_greedy", "filtered_sampled"])
def test_accept_rules_match_the_reference(rule):
    rng = np.random.default_rng(3)
    j_rng, t_rng = np.random.default_rng(9), np.random.default_rng(9)
    kw = dict(temperature=0.8, top_k=6, top_p=0.9, repetition_penalty=1.3)
    if rule == "filtered_greedy":
        kw = dict(temperature=0.0, repetition_penalty=1.3)
    for _ in range(200):
        draft, q, logits = _accept_case(rng)
        if rule == "greedy":
            target = logits.argmax(-1).astype(np.int32)
            n = int(rng.integers(0, len(draft) + 1))
            draft[:n] = target[:n]                 # accept n, then differ
            got = tspec.greedy_accept(draft, target)
            want = jax_spec.greedy_accept(draft, target)
        elif rule.startswith("rejection"):
            qd = None if rule.endswith("onehot") else q
            got = tspec.rejection_accept(t_rng, draft, qd, logits, 0.8)
            want = jax_spec.rejection_accept(j_rng, draft, qd, logits, 0.8)
        else:
            seen = rng.integers(0, 12, 4)
            got = tspec.filtered_accept(t_rng, draft, q, logits,
                                        SamplingParams(**kw), seen)
            want = jax_spec.filtered_accept(j_rng, draft, q, logits,
                                            JaxSamplingParams(**kw), seen)
        assert got == want
    assert t_rng.random() == j_rng.random()      # the streams kept step


def test_adaptive_k_sequences_match_the_reference():
    kw = dict(k=4, k_min=1, k_max=6, accept_low=0.4, accept_high=0.7,
              ema_decay=0.5)
    t = tspec.AdaptiveK.from_config(SpecConfig(**kw))
    j = jax_spec.AdaptiveK.from_config(JaxSpecConfig(**kw))
    fracs = np.concatenate([np.zeros(8), np.ones(12),
                            np.random.default_rng(0).random(40)])
    assert [t.update(f) for f in fracs] == [j.update(f) for f in fracs]
    assert t.ema == j.ema


def test_ngram_proposals_match_the_reference():
    rng = np.random.default_rng(5)
    t, j = tspec.NGramDrafter(n=3), jax_spec.NGramDrafter(n=3)
    ctx = np.array([5, 6, 7, 8, 9, 1, 2, 5, 6, 7], np.int32)
    assert list(t.propose(0, ctx, 4)[0]) == [8, 9, 1, 2]
    assert len(t.propose(0, np.array([1, 2, 3], np.int32), 4)[0]) == 0
    for _ in range(300):
        ctx = rng.integers(0, 6, int(rng.integers(0, 40))).astype(np.int32)
        k = int(rng.integers(0, 7))
        (a, qa), (b, qb) = t.propose(0, ctx, k), j.propose(0, ctx, k)
        assert list(a) == list(b) and qa is None and qb is None
    assert t.weight_bytes_per_step(ServeConfig()) == 0.0


# ---------------------------------------------------------------------------
# the model and self-spec drafters


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_model_drafter_resyncs_after_rollback(draft, temperature):
    """Proposals after a diverging commit equal a fresh drafter's, and the
    reference's on the same weights, token for token (and proposal law
    for law when the drafter samples)."""
    dcfg, djparams, dtcfg, dtparams = draft
    ctx = _prompts(dcfg, [9], seed=6)[0]
    ctx2 = np.concatenate([ctx, np.array([11, 12], np.int32)])
    kw = dict(max_seq=64, temperature=temperature, seed=3)
    port = tspec.ModelDrafter(dtcfg, dtparams, device="cpu", **kw)
    ref = jax_spec.ModelDrafter(dcfg, djparams, **kw)
    for c in (ctx, ctx2, ctx2[:7]):
        (a, qa), (b, qb) = port.propose(0, c, 3), ref.propose(0, c, 3)
        assert list(a) == list(b)
        if temperature > 0:
            np.testing.assert_allclose(qa, qb, atol=1e-6)
        else:
            assert qa is None and qb is None
    assert port.steps == ref.steps
    fresh = tspec.ModelDrafter(dtcfg, dtparams, device="cpu", **kw)
    a = port.propose(1, ctx2, 3)[0]
    assert list(fresh.propose(1, ctx2, 3)[0]) == list(a)
    port.forget(0)
    assert 0 not in port._caches and 0 not in port._fed


def test_model_drafter_batches_rows_and_parks_the_rest(draft):
    """propose_batch drafts every row in shared steps: rows at different
    catch-up depths ride the same step (parked rows write nothing), and
    each row drafts what it drafts alone."""
    dcfg, djparams, dtcfg, dtparams = draft
    ctxs = _prompts(dcfg, [3, 11, 6], seed=12)
    port = tspec.ModelDrafter(dtcfg, dtparams, max_seq=48, max_batch=4,
                              device="cpu")
    ref = jax_spec.ModelDrafter(dcfg, djparams, max_seq=48, max_batch=4)
    items = [(rid, c, 3) for rid, c in enumerate(ctxs)]
    got, want = port.propose_batch(items), ref.propose_batch(items)
    assert [list(t) for t, _ in got] == [list(t) for t, _ in want]
    assert port.steps == ref.steps == max(len(c) for c in ctxs) + 2
    for rid, c in enumerate(ctxs):
        alone = tspec.ModelDrafter(dtcfg, dtparams, max_seq=48,
                                   max_batch=4, device="cpu")
        assert list(alone.propose(rid, c, 3)[0]) == list(got[rid][0])
    # a parked row's cache is untouched past its frontier
    k = port._cache["units"]["b0"]["k"]
    slot = port._caches[0]
    assert torch.count_nonzero(k[:, slot, len(ctxs[0]) + 2:]) == 0


def test_predictor_functions_match_the_reference(preds):
    cfg = get_config("nectar-relu-llama-1.7m")
    jp, tp = preds
    x = np.random.default_rng(2).standard_normal((3, 5, cfg.d_model)
                                                  ).astype(np.float32)
    h = np.maximum(np.random.default_rng(3).standard_normal(
        (3, 5, cfg.d_ff)), 0).astype(np.float32)
    for u in range(cfg.n_units):
        ju = jax_sparsity.SparsityPredictor(jp.w_in[u], jp.w_out[u])
        tu = tp.unit(u)
        xt, ht = torch.tensor(x), torch.tensor(h)
        np.testing.assert_allclose(tu.logits(xt).numpy(),
                                   np.asarray(ju.logits(x)), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(tu.predict_topk(xt, 32)[0].numpy(),
                                      np.asarray(ju.predict_topk(x, 32)[0]))
        assert float(tu.loss(xt, ht)) == pytest.approx(
            float(ju.loss(x, h)), rel=1e-5)
        assert float(tu.recall_at_k(xt, ht, 32)) == pytest.approx(
            float(ju.recall_at_k(x, h, 32)), rel=1e-5)


def test_train_predictor_matches_the_reference(nectar):
    """From the same initial predictor and probe inputs, 120 SGD steps
    through torch.autograd land on the reference's weights."""
    cfg, jparams, tcfg, tparams = nectar
    xs = np.random.default_rng(0).standard_normal(
        (256, cfg.d_model)).astype(np.float32)
    hs = np.asarray(jax_sparsity.ffn_hidden(
        xs, jparams["units"]["b0"]["ffn"]["w_up"][0], "relu"))
    j0 = jax_sparsity.SparsityPredictor.init(jax.random.PRNGKey(1),
                                             cfg.d_model, cfg.d_ff, rank=16)
    want = jax_sparsity.train_predictor(j0, xs, hs, steps=120)
    t0 = sparsity.SparsityPredictor(torch.tensor(np.asarray(j0.w_in)),
                                    torch.tensor(np.asarray(j0.w_out)))
    got = sparsity.train_predictor(t0, torch.tensor(xs), torch.tensor(hs),
                                   steps=120)
    for a, b in ((got.w_in, want.w_in), (got.w_out, want.w_out)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-5 * np.abs(b).max()
    np.testing.assert_allclose(
        selfspec.calibration_targets(
            tcfg, tparams, torch.tensor(xs))[0].numpy(), hs, atol=1e-5)


def test_calibrated_recall_within_the_reference(nectar, preds):
    """The port's own seeded calibration (torch.Generator) reaches a
    recall at k no worse than the reference's, within 0.05, on fresh
    probe inputs."""
    cfg, jparams, tcfg, tparams = nectar
    mine = selfspec.calibrate_predictors(tcfg, tparams, 16, seed=0,
                                         device="cpu")
    assert mine.w_in.shape == (cfg.n_units, cfg.d_model, 16)
    xs = np.random.default_rng(21).standard_normal(
        (512, cfg.d_model)).astype(np.float32)
    hs = selfspec.calibration_targets(tcfg, tparams, torch.tensor(xs))
    k = 32
    for u in range(cfg.n_units):
        ju = jax_sparsity.SparsityPredictor(preds[0].w_in[u],
                                            preds[0].w_out[u])
        want = float(ju.recall_at_k(xs, hs[u].numpy(), k))
        got = float(mine.unit(u).recall_at_k(torch.tensor(xs), hs[u], k))
        assert got >= want - 0.05


def test_predicted_sparse_ffn_matches_the_reference(nectar, preds):
    """The self-spec FFN: the up-column gather in plain PyTorch, the
    down-row gather through ops.sparse_gather_matvec (kernel 2's plain
    version here), k = 32 of 640."""
    cfg, jparams, tcfg, tparams = nectar
    x = np.random.default_rng(8).standard_normal((4, 1, cfg.d_model)
                                                  ).astype(np.float32)
    for u in (0, cfg.n_units - 1):
        jffn = jax.tree.map(lambda a: a[u], jparams["units"]["b0"]["ffn"])
        tffn = {k: v[u] for k, v in tparams["units"]["b0"]["ffn"].items()}
        ju = jax_sparsity.SparsityPredictor(preds[0].w_in[u],
                                            preds[0].w_out[u])
        want = np.asarray(jax_selfspec.predicted_sparse_ffn(
            jffn, cfg, ju, x, 32))
        got = selfspec.predicted_sparse_ffn(tffn, tcfg, preds[1].unit(u),
                                            torch.tensor(x), 32)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_selfspec_drafts_match_the_reference(nectar, preds):
    """With the same predictors both packages' self-spec drafters give
    the same draft logits (within 1e-4) and the same drafts."""
    cfg, jparams, tcfg, tparams = nectar
    jd = jax_spec.SelfSpecDrafter(cfg, jparams, 64, max_batch=2)
    jd.preds = preds[0]
    td = tspec.SelfSpecDrafter(tcfg, tparams, 64, max_batch=2,
                               device="cpu", preds=preds[1])
    assert td.k_active == jd.k_active == 32
    logits = {}
    for name, d in (("port", td), ("ref", jd)):
        step = d._step

        def recording(tok, lens, step=step, name=name):
            out = step(tok, lens)
            logits.setdefault(name, []).append(out)
            return out
        d._step = recording
    ctxs = _prompts(cfg, [12, 5], seed=13)
    items = [(rid, c, 4) for rid, c in enumerate(ctxs)]
    got, want = td.propose_batch(items), jd.propose_batch(items)
    assert [list(t) for t, _ in got] == [list(t) for t, _ in want]
    for a, b in zip(logits["port"], logits["ref"]):
        np.testing.assert_allclose(a[:2], b[:2], atol=1e-4)


# ---------------------------------------------------------------------------
# paged-KV rollback and pinning, against the reference's pool


def _pools(n_blocks=12, block_size=4, max_batch=3, mbs=6, prefix=False):
    kw = dict(n_blocks=n_blocks, block_size=block_size, max_batch=max_batch,
              max_blocks_per_seq=mbs)
    jpool = jax_paged_kv.PagedKVCache(get_config("nectar-relu-llama-smoke"),
                                      **kw)
    tpool = paged_kv.PagedKVCache(
        torch_get_config("nectar-relu-llama-smoke"), **kw)
    if prefix:
        return (jpool, JaxRadix(jpool)), (tpool, RadixPrefixCache(tpool))
    return (jpool, None), (tpool, None)


def test_truncate_frees_the_tail_and_is_idempotent():
    (jpool, _), (pool, _) = _pools(n_blocks=8, max_batch=2)
    for p in (pool, jpool):
        assert p.allocate(0, 18)                 # 5 blocks, partial tail
    assert pool.n_free == 3
    assert pool.truncate(0, 10) == jpool.truncate(0, 10) == 2
    assert pool.n_free == 5
    assert pool.truncate(0, 10) == 0             # a second call: no-op
    assert pool.truncate(0, 9) == 0              # same block count
    assert list(pool.tables()[0, 3:]) == [8, 8, 8]
    assert pool.truncate(0, 0) == 3              # full rollback
    assert pool.truncate(1, 5) == 0              # unknown slot
    assert pool.n_free == 8
    assert pool.allocate(0, 18) and pool.n_free == 3


def test_truncate_releases_shared_blocks_by_refcount():
    """Under the prefix cache a truncated tail may hold blocks another
    slot or the radix index also references: truncate drops one
    reference each (through _release_block), a block the index holds
    turns reclaimable instead of free, and both packages end in the same
    state."""
    jside, tside = _pools(prefix=True)
    toks = np.arange(100, 112, dtype=np.int32)           # 3 full blocks
    states = []
    for pool, radix in (jside, tside):
        assert pool.allocate(0, 12)
        radix.insert(toks, list(pool.owned[0]))           # index holds 3
        blocks, n = radix.match(toks)
        pool.share(1, blocks[:2])                         # slot 1 maps 2
        assert pool.allocate(1, 14)
        out = [pool.truncate(1, 5), pool.truncate(1, 5),  # drops 1 shared
               pool.truncate(0, 4),                       # drops 2 indexed
               pool.truncate(1, 0)]
        states.append((out, dict(pool.ref), list(pool.free), pool.n_free,
                       radix.n_reclaimable(), pool.tables().copy()))
    (jo, jref, jfree, jn, jrec, jtab), (to, tref, tfree, tn, trec, ttab) \
        = states
    assert to == jo == [2, 0, 2, 2]
    assert (tref, tfree, tn, trec) == (jref, jfree, jn, jrec)
    np.testing.assert_array_equal(ttab, jtab)
    pool = tside[0]
    assert pool.ref == {pool.owned[0][0]: 1}
    assert tn == 12 - 1 and trec == 2           # two indexed, unreferenced


def test_defrag_never_moves_pinned_blocks():
    (jpool, _), (pool, _) = _pools(n_blocks=8, max_batch=3, mbs=4)
    for p in (pool, jpool):
        p.allocate(0, 8)
        p.allocate(1, 8)
        p.allocate(2, 4)
        p.free_slot(0)
        p.pin(1)
    perm = pool.defrag()
    np.testing.assert_array_equal(perm, jpool.defrag())
    assert pool.owned[1] == [2, 3]               # pinned: untouched
    assert pool.owned[2] == [0]                  # compacted into a hole
    assert list(perm[2:4]) == [2, 3]
    pool.unpin(1)
    pool.defrag()
    assert pool.owned[1] == [1, 2]               # movable after unpin


# ---------------------------------------------------------------------------
# preemption, the prefix cache, sampled rows, streaming


def test_preempted_spec_request_emits_identical_tokens(nectar, draft,
                                                       preds):
    """A pool too small for both requests forces evict + replay mid-
    speculation: the resync path re-feeds the generated tokens through
    verify rows, and the output equals the unconstrained spec serve, the
    non-spec serve and the reference's tight spec serve."""
    cfg, _, tcfg, tparams = nectar
    prompts = _prompts(cfg, [12, 14], seed=3)
    kw = dict(max_batch=2, max_seq=64, paged=True, block_size=4,
              prefill_chunk=8)
    base, _ = _serve_port(tcfg, tparams, prompts, max_new=16, **kw)
    free, _ = _serve_port(tcfg, tparams, prompts, max_new=16,
                          spec=SpecConfig(**SPECS["ngram"]), **kw)
    want, jeng, tight, eng = _serve_both("ngram", nectar, draft, preds,
                                         prompts, max_new=16,
                                         n_kv_blocks=10, **kw)
    assert eng.sched.n_preemptions == jeng.sched.n_preemptions > 0
    assert base == free == tight == want
    assert eng.pool.n_free == eng.pool.n_blocks


def test_spec_with_prefix_cache(nectar, draft, preds):
    """Prompts sharing a system prefix, the radix cache on: tokens equal
    the cache-off spec serve and the reference's, and so do the hit and
    copy-on-write counts."""
    cfg, _, tcfg, tparams = nectar
    rng = np.random.default_rng(14)
    head = np.tile(np.array([7, 2, 9, 2], np.int32), 5)       # 20 tokens
    prompts = [np.concatenate([head, rng.integers(0, cfg.vocab, int(n),
                                                  dtype=np.int32)])
               for n in (0, 3, 11, 0)]
    kw = dict(BASE_KW, max_batch=2)
    off, _ = _serve_port(tcfg, tparams, prompts, max_new=12,
                         spec=SpecConfig(**SPECS["ngram"]), **kw)
    want, jeng, got, eng = _serve_both("ngram", nectar, draft, preds,
                                       prompts, max_new=12,
                                       prefix_cache=True, **kw)
    assert got == off == want
    assert eng.metrics.prefix_hits == jeng.metrics.prefix_hits > 0
    assert eng.pool.cow_count == jeng.pool.cow_count
    assert eng.pool.n_free == eng.pool.n_blocks


def test_verify_write_into_a_shared_tail_copies_it_first(nectar, baseline):
    """After a rollback a slot's partial tail block may be referenced
    elsewhere: the next verify row's write copies it before the tables
    are snapshot, so the other reader's bytes never change, and the
    request's tokens stay those of the non-spec serve."""
    _, _, tcfg, tparams = nectar
    eng = Engine(tcfg, tparams,
                 ServeConfig(spec=SpecConfig(**SPECS["ngram"]), **BASE_KW),
                 device="cpu")
    prompt = _spec_prompts(tcfg)[-1]
    req = Request(rid=eng.new_rid(), prompt=prompt, max_new=10)
    assert eng.add_request(req)
    pool, spare = eng.pool, BASE_KW["max_batch"] - 1
    k = eng.runner.cache["units"]["b0"]["k"]
    while True:
        eng.step()
        e = eng.sched.active[req.rid]
        if e.ctx_len % pool.block_size and e.ctx_len > len(prompt):
            break
    tail = pool.owned[e.slot][e.ctx_len // pool.block_size]
    pool.share(spare, [tail])                  # a second reader
    before = k[:, tail].clone()
    eng.step()
    assert pool.cow_count == 1
    assert tail not in pool.owned[e.slot] and pool.ref[tail] == 1
    assert torch.equal(k[:, tail], before)
    pool.free_slot(spare)
    eng.run([], max_steps=100)
    assert req.tokens_out == baseline[4]
    assert pool.n_free == pool.n_blocks


@pytest.mark.parametrize("name,kw", [
    ("ngram", dict(temperature=0.7)),
    ("ngram", dict(temperature=0.9, top_k=40, repetition_penalty=1.2)),
    ("model", dict(temperature=0.7)),
])
def test_sampled_spec_rows_match_the_reference(nectar, draft, preds, name,
                                               kw):
    """Seeded sampled spec rows (rejection sampling; with top-k and a
    repetition penalty, the filtered rule) match the reference token for
    token: both draw their accept uniforms from the same numpy streams."""
    cfg = nectar[0]
    prompts = _spec_prompts(cfg)[2:]
    sps = [(JaxSamplingParams(seed=i, **kw), SamplingParams(seed=i, **kw))
           for i in range(len(prompts))]
    want, jeng, got, eng = _serve_both(name, nectar, draft, preds, prompts,
                                       max_new=12, sps=sps, **BASE_KW)
    assert got == want
    assert eng.metrics.spec_steps == jeng.metrics.spec_steps > 0
    assert eng.metrics.spec_accepted == jeng.metrics.spec_accepted
    assert eng.pool.n_free == eng.pool.n_blocks


def test_streaming_generate_with_drafter(nectar, baseline):
    _, _, tcfg, tparams = nectar
    eng = Engine(tcfg, tparams,
                 ServeConfig(spec=SpecConfig(**SPECS["ngram"]), **BASE_KW),
                 device="cpu")
    prompt = _spec_prompts(tcfg)[-1]
    assert list(api.generate(eng, prompt, max_new=10)) == baseline[4]
    server = api.StreamingServer(
        Engine(tcfg, tparams,
               ServeConfig(spec=SpecConfig(**SPECS["ngram"]), **BASE_KW),
               device="cpu"))
    prompts = _spec_prompts(tcfg)
    rids = [server.submit(p, max_new=10) for p in prompts]
    streamed = {rid: [] for rid in rids}
    while server.busy:
        for rid, toks in server.poll().items():
            streamed[rid].extend(toks)
    assert [streamed[r] for r in rids] == [baseline[i]
                                           for i in range(len(prompts))]
    assert server.engine.metrics.summary()["spec_tokens_per_verify"] > 1


# ---------------------------------------------------------------------------
# refusals


def test_spec_refusals(nectar, draft):
    """The slot engine, codebook and M-RoPE models, an unknown drafter, a
    model drafter without weights or with another vocab: each refused
    with the reference's error type. A recurrent draft model is taken,
    for the sequential drafting path, as the reference takes it."""
    _, _, tcfg, tparams = nectar
    dtcfg, dtparams = draft[2], draft[3]
    with pytest.raises(ValueError, match="paged"):
        Engine(tcfg, tparams, ServeConfig(spec=SpecConfig()), device="cpu")
    for bad in (dict(n_codebooks=4), dict(mrope=True)):
        with pytest.raises(ValueError, match="plain token streams"):
            Engine(dataclasses.replace(tcfg, **bad), tparams,
                   ServeConfig(paged=True, spec=SpecConfig()), device="cpu")
    with pytest.raises(ValueError, match="unknown drafter"):
        Engine(tcfg, tparams, ServeConfig(paged=True, spec=SpecConfig(
            drafter="oracle")), device="cpu")
    with pytest.raises(ValueError, match="draft_params"):
        Engine(tcfg, tparams, ServeConfig(paged=True, spec=SpecConfig(
            drafter="model", draft_name=DRAFT)), device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        tspec.make_drafter(SpecConfig(drafter="model", draft_name=DRAFT),
                           dataclasses.replace(tcfg, vocab=4096), tparams,
                           ServeConfig(paged=True), draft_params=dtparams,
                           device="cpu")
    # a recurrent draft model is no longer refused: it drafts one request
    # at a time (tests/test_torch_recurrent.py holds that path)
    assert not tspec.ModelDrafter(dataclasses.replace(dtcfg, family="ssm"),
                                  dtparams, 64, device="cpu")._batched
    with pytest.raises(ValueError, match="attention"):
        tspec.SelfSpecDrafter(dataclasses.replace(tcfg, family="moe"),
                              tparams, 64, device="cpu")
    with pytest.raises(ValueError, match="predictor shapes"):
        from_jax_predictors(jax_sparsity.SparsityPredictor(
            np.zeros((2, 128, 16)), np.zeros((2, 16, 640))), tcfg,
            device="cpu")


def test_draft_config_copy_equals_the_reference():
    assert dataclasses.asdict(torch_get_config(DRAFT)) \
        == dataclasses.asdict(get_config(DRAFT))
    assert dataclasses.asdict(SpecConfig()) \
        == dataclasses.asdict(JaxSpecConfig())
