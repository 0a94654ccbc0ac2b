"""The port's sampling on the CPU, against the JAX reference.

``serve.prng`` re-derives ``jax.random.categorical``'s threefry bits,
uniforms and Gumbel noise on torch tensors: bits and uniforms are integer
work and must be equal, each log of the Gumbel noise within 1 ulp of
XLA's (two libm implementations). The batched sampler and the engines'
seeded streams must give the reference's tokens; chosen-token and prompt
log-probabilities agree within 2e-4 (f32 logits of six layers summed in
another order). Weights come from ``init_params(PRNGKey(0))`` through
``from_jax_params``; prompts from seeded numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs.base import ServeConfig as JaxServeConfig
from repro.models import Model as JaxModel
from repro.serve import sampling as jax_sampling
from repro.serve.engine import Engine as JaxEngine
from repro.serve.scheduler import Request as JaxRequest
from repro_torch.configs import get_config as torch_get_config
from repro_torch.configs.base import ServeConfig
from repro_torch.serve import prng, sampling
from repro_torch.serve.engine import Engine
from repro_torch.serve.scheduler import Request
from repro_torch.weights import from_jax_params

LOGPROB_ATOL = 2e-4
KEYS = [(0, 0, 0), (7, 3, 5), (None, 12345, 99), (2 ** 31 + 5, 2 ** 33 + 1, 1),
        (123456789, 4, 0)]


@pytest.fixture(scope="module")
def nectar():
    cfg = get_config("nectar-relu-llama-1.7m")
    jparams = JaxModel(cfg).init(jax.random.PRNGKey(0))
    tcfg = torch_get_config(cfg.name)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return cfg, jparams, tcfg, tparams


def _prompts(cfg, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, size=int(n), dtype=np.int32)
            for n in lengths]


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("V", [256, 2048])
@pytest.mark.parametrize("seed,rid,ctr", KEYS)
def test_threefry_bits_and_uniforms_equal_jax(seed, rid, ctr, V):
    """``prng.random_bits`` equals ``jax.random.bits`` and ``prng.uniform``
    equals jax's uniform on [tiny, 1) bit for bit, for keys from the
    ported ``request_key`` (itself equal to the reference's)."""
    key = sampling.request_key(seed, rid, ctr)
    np.testing.assert_array_equal(key, jax_sampling.request_key(seed, rid,
                                                                ctr))
    k = torch.tensor(key.astype(np.int64))[None]
    want = np.asarray(jax.random.bits(jnp.asarray(key), (V,)))
    got = prng.random_bits(k, V)[0].numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, want)
    tiny = np.finfo(np.float32).tiny
    want_u = np.asarray(jax.random.uniform(jnp.asarray(key), (V,),
                                           minval=tiny, maxval=1.0))
    np.testing.assert_array_equal(prng.uniform(k, V)[0].numpy(), want_u)


@pytest.mark.parametrize("seed,rid,ctr", KEYS)
def test_gumbel_noise_within_one_ulp_per_log(seed, rid, ctr):
    """Gumbel noise is -log(-log(u)) on equal uniforms: each log is
    within 1 ulp of XLA's on the same input, and the noise as a whole
    within 8 f32 ulps of 1.0 of jax's (one ulp of the inner log near 1
    grows by the outer log's slope there)."""
    key = sampling.request_key(seed, rid, ctr)
    k = torch.tensor(key.astype(np.int64))[None]
    u = prng.uniform(k, 2048)[0]
    inner_t = (-torch.log(u)).numpy()
    inner_j = np.asarray(-jnp.log(jnp.asarray(u.numpy())))
    assert _ulps(inner_t, inner_j).max() <= 1
    outer_t = (-torch.log(torch.tensor(inner_j))).numpy()
    outer_j = np.asarray(-jnp.log(jnp.asarray(inner_j)))
    assert _ulps(outer_t, outer_j).max() <= 1
    want = np.asarray(jax.random.gumbel(jnp.asarray(key), (2048,)))
    got = prng.gumbel(k, 2048)[0].numpy()
    assert np.abs(got - want).max() <= 8 * np.finfo(np.float32).eps


def _random_batch(rng, B=16, V=2048):
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    presence = rng.random((B, V)) < 0.05
    temp = rng.choice([0.0, 0.7, 1.0, 1.5], B).astype(np.float32)
    top_k = rng.choice([0, 1, 40, 500], B).astype(np.int32)
    top_p = rng.choice([1.0, 0.9, 0.5], B).astype(np.float32)
    rep = rng.choice([1.0, 1.2, 0.8], B).astype(np.float32)
    keys = np.stack([jax_sampling.request_key(int(s), r, int(c))
                     for s, r, c in zip(rng.integers(0, 100, B), range(B),
                                        rng.integers(0, 50, B))])
    return logits, presence, temp, top_k, top_p, rep, keys


@pytest.mark.parametrize("seed", range(6))
def test_sample_batch_tokens_equal_reference(seed):
    """Mixed rows (greedy and sampled, top-k, top-p, penalties above and
    below 1): the tokens equal the reference's ``_sample_batch``, the
    chosen-token log-probabilities within 2e-4; the Sampler's all-greedy
    fast path is the plain argmax."""
    args = _random_batch(np.random.default_rng(seed))
    jt, jl = jax_sampling._sample_batch(*map(jnp.asarray, args))
    logits, presence, temp, top_k, top_p, rep, keys = args
    tt, tl = sampling.sample_batch(
        torch.tensor(logits), torch.tensor(presence), torch.tensor(temp),
        torch.tensor(top_k), torch.tensor(top_p), torch.tensor(rep),
        torch.tensor(keys.astype(np.int64)))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                               atol=LOGPROB_ATOL, rtol=0)
    B = len(temp)
    tok, lp = sampling.Sampler().launch(torch.tensor(logits), presence,
                                        np.zeros(B, np.float32), top_k,
                                        top_p, np.ones(B, np.float32), keys)
    np.testing.assert_array_equal(tok.cpu().numpy(),
                                  np.argmax(logits, axis=-1))


@pytest.mark.parametrize("sp_kw", [
    dict(temperature=0.7),
    dict(temperature=1.0, top_k=40),
    dict(temperature=1.0, top_p=0.9),
    dict(temperature=0.7, top_k=5, top_p=0.8, repetition_penalty=1.3),
    dict(repetition_penalty=1.2),
])
def test_numpy_mirrors_equal_reference(sp_kw):
    """``softmax``, ``token_logprob``, ``filter_logits_np`` and
    ``sample_np`` (with the same numpy generator) equal the reference's
    exactly: the same f64 numpy arithmetic."""
    rng = np.random.default_rng(3)
    z = (rng.standard_normal(256) * 2).astype(np.float32)
    seen = rng.integers(0, 256, 12)
    tsp = sampling.SamplingParams(**sp_kw)
    jsp = jax_sampling.SamplingParams(**sp_kw)
    np.testing.assert_array_equal(sampling.softmax(z, 0.7),
                                  jax_sampling.softmax(z, 0.7))
    assert sampling.token_logprob(z, 5) == jax_sampling.token_logprob(z, 5)
    np.testing.assert_array_equal(
        sampling.filter_logits_np(z, tsp, seen),
        jax_sampling.filter_logits_np(z, jsp, seen))
    for s in range(5):
        assert sampling.sample_np(z, tsp, np.random.default_rng(s), seen) \
            == jax_sampling.sample_np(z, jsp, np.random.default_rng(s), seen)


SAMPLED = [
    dict(temperature=0.7, seed=3),
    dict(temperature=1.0, top_k=40, seed=1),
    dict(temperature=1.0, top_p=0.9, seed=2),
    dict(temperature=1.0, top_k=40, top_p=0.9, repetition_penalty=1.2,
         seed=4),
    dict(repetition_penalty=1.2),
]


def _serve_both(cfg, jparams, tcfg, tparams, prompts, sps, max_new=8,
                **kw):
    jeng = JaxEngine(cfg, jparams, JaxServeConfig(**kw))
    jdone = jeng.run([JaxRequest(
        rid=i, prompt=p, max_new=max_new,
        sampling=jax_sampling.SamplingParams(**sp))
        for i, (p, sp) in enumerate(zip(prompts, sps))], max_steps=2000)
    eng = Engine(tcfg, tparams, ServeConfig(**kw), device="cpu")
    done = eng.run([Request(rid=i, prompt=p, max_new=max_new,
                            sampling=sampling.SamplingParams(**sp))
                    for i, (p, sp) in enumerate(zip(prompts, sps))],
                   max_steps=2000)
    return jdone, done, jeng, eng


@pytest.mark.parametrize("sp_kw", SAMPLED)
@pytest.mark.parametrize("paged", [True, False])
def test_engine_seeded_streams_equal_reference(nectar, sp_kw, paged):
    """Seeded streams through the paged engine (the batched sampler) and
    the slot engine (its first token from ``sample_np``, later ones from
    the batched sampler) equal the reference's token for token; with
    ``logprobs`` the chosen-token log-probabilities agree within 2e-4."""
    cfg, jparams, tcfg, tparams = nectar
    prompts = _prompts(cfg, [5, 21, 9, 14], seed=11)
    sps = [dict(sp_kw, logprobs=True, seed=(sp_kw.get("seed") or 0) + i)
           for i in range(len(prompts))]
    kw = dict(paged=paged, max_batch=2, max_seq=96, block_size=8,
              prefill_chunk=16)
    jdone, done, _, _ = _serve_both(cfg, jparams, tcfg, tparams, prompts,
                                    sps, **kw)
    for rid in jdone:
        assert done[rid].tokens_out \
            == [int(t) for t in jdone[rid].tokens_out], rid
        np.testing.assert_allclose(done[rid].logprobs_out,
                                   jdone[rid].logprobs_out,
                                   atol=LOGPROB_ATOL, rtol=0)


@pytest.mark.parametrize("n_kv_blocks", [0, 9])
def test_prompt_logprobs_match_reference(nectar, n_kv_blocks):
    """Prompt log-probabilities over prompts longer than one prefill
    chunk, with a roomy pool and with one so tight that requests are
    preempted mid-prefill and replayed: within 2e-4 of the reference,
    position 0 None, tokens identical."""
    cfg, jparams, tcfg, tparams = nectar
    prompts = _prompts(cfg, [30, 41, 12], seed=3)
    sps = [dict(prompt_logprobs=True), dict(prompt_logprobs=True,
                                            temperature=0.8, seed=5),
           dict()]
    kw = dict(paged=True, max_batch=2, max_seq=96, block_size=8,
              prefill_chunk=16, n_kv_blocks=n_kv_blocks,
              attn_backend="naive")
    jdone, done, jeng, eng = _serve_both(cfg, jparams, tcfg, tparams,
                                         prompts, sps, max_new=12, **kw)
    assert eng.metrics.evictions == jeng.metrics.evictions
    if n_kv_blocks:
        assert eng.metrics.evictions > 0
    for rid in jdone:
        want, got = jdone[rid].prompt_logprobs_out, \
            done[rid].prompt_logprobs_out
        assert len(got) == len(want)
        if want:
            assert got[0] is None and want[0] is None
            np.testing.assert_allclose(got[1:], want[1:],
                                       atol=LOGPROB_ATOL, rtol=0)
            assert len(got) == len(prompts[rid])
        assert done[rid].tokens_out \
            == [int(t) for t in jdone[rid].tokens_out]


@pytest.mark.parametrize("paged", [True, False])
def test_stop_sequences_match_reference(nectar, paged):
    """A stop sequence taken from the reference's own greedy stream
    truncates both engines at the same place, with the match removed."""
    cfg, jparams, tcfg, tparams = nectar
    prompts = _prompts(cfg, [7, 13], seed=8)
    kw = dict(paged=paged, max_batch=2, max_seq=96, block_size=8,
              prefill_chunk=16)
    jfull, _, _, _ = _serve_both(cfg, jparams, tcfg, tparams, prompts,
                                 [{}, {}], max_new=12, **kw)
    stop = tuple(int(t) for t in jfull[0].tokens_out[4:6])
    sps = [dict(stop=(stop,)), dict(stop=((1, 2, 3),))]
    jdone, done, _, _ = _serve_both(cfg, jparams, tcfg, tparams, prompts,
                                    sps, max_new=12, **kw)
    for rid in jdone:
        assert done[rid].tokens_out \
            == [int(t) for t in jdone[rid].tokens_out]
    assert len(done[0].tokens_out) <= 4
    assert sampling.stop_truncate(done[0].tokens_out + list(stop),
                                  (stop,)) == len(done[0].tokens_out)
