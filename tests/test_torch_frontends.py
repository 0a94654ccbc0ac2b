"""The frontends in the port (qwen2-vl's M-RoPE and vision stub, musicgen's
sinusoidal positions, codebook streams and audio stub), on the CPU, against
the JAX reference. ``tests/test_torch_forward.py`` holds ``Model.forward``
and decode for all ten architectures of ``tests/test_system.py``.

Weights are the reference's ``init(PRNGKey(k))`` carried across by
``weights.from_jax_params``; inputs are seeded numpy draws. Tolerances:

  * ``mrope_cos_sin`` within 1.2e-7 of the reference's at d_head 16 and
    128 with three distinct channels (the same f32 product; the cos and
    sin of the two libraries part by an ulp), and bit-equal to
    ``rope_cos_sin`` with three equal channels;
  * ``sinusoidal_positions``: the frequencies within one f32 ulp of the
    reference's (XLA's exp is not correctly rounded, torch's is closer),
    so an angle p * f parts by up to p ulps of f: the tables within
    2e-6 + p * 2^-23 at every position p in [0, 4096) at d 64 and 1536;
  * ``Model.forward`` with the vision stub's embeddings and M-RoPE
    positions of three distinct channels (a t/h/w grid), and with the
    audio stub's, within 2e-4 of the reference's;
  * teacher-forced decode after prefill within 2e-3 of the full forward
    (the reference's ``tests/test_models.py`` case) and within 2e-4 of
    the reference's decode;
  * greedy tokens identical to the reference's, each an [nc] array for
    musicgen, through every engine the reference serves these models
    with (slot, paged plain read and flash's plain version, async K = 4
    and seeded sampled rows for qwen2-vl; the disagg coordinator and, for
    qwen2-vl, the fleet router); where the reference raises, the port
    raises the same error type;
  * the cost model's codebook step against ``FlopCounterMode`` within 1%.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import base as jbase
from repro.configs import get_config
from repro.core import sparsity as jax_sparsity
from repro.models import Model as JaxModel
from repro.models import layers as jax_layers
from repro.models import rope as jax_rope
from repro.serve import sampling as jax_sampling
from repro.serve.disagg import DisaggCoordinator as JaxCoordinator
from repro.serve.engine import Engine as JaxEngine
from repro.serve.router import build_fleet as jax_build_fleet
from repro.serve.scheduler import Request as JaxRequest
from repro.spec import selfspec as jax_selfspec
from repro_torch.configs import base as tbase
from repro_torch.configs import get_config as torch_get_config
from repro_torch.configs.registry import REGISTRY
from repro_torch.models import Model, attention, ffn, layers, rope
from repro_torch.models import transformer
from repro_torch.obs import costmodel
from repro_torch.serve import sampling
from repro_torch.serve.disagg import DisaggCoordinator
from repro_torch.serve.engine import Engine
from repro_torch.serve.router import build_fleet
from repro_torch.serve.runner import DECODE, PREFILL
from repro_torch.serve.scheduler import Request
from repro_torch.spec import selfspec
from repro_torch.weights import from_jax_params, from_jax_predictors

BASE = dict(max_batch=2, max_seq=64, block_size=8, prefill_chunk=16)
LENGTHS = [5, 21, 9, 13, 30, 3]
FRONTENDS = ["musicgen-smoke", "qwen2-vl-smoke"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_TREES = {}


def _trees(name, seed=0):
    """(cfg, reference params, port cfg, port params) of a config, the
    reference's ``init(PRNGKey(seed))``, converted once."""
    if (name, seed) not in _TREES:
        cfg = get_config(name)
        jparams = JaxModel(cfg).init(jax.random.PRNGKey(seed))
        tcfg = torch_get_config(name)
        tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                                  device="cpu")
        _TREES[name, seed] = (cfg, jparams, tcfg, tparams)
    return _TREES[name, seed]


def _t(a):
    return torch.from_numpy(np.array(a))


def _prompts(cfg, lengths, seed=0):
    """``tests/test_paged_serving.py``'s prompt draw; a codebook model's
    prompts are [L, nc]."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, size=(int(n), cfg.n_codebooks)
                         if cfg.n_codebooks else int(n), dtype=np.int32)
            for n in lengths]


def _tokens(done):
    return {i: [np.asarray(t).tolist() for t in r.tokens_out]
            for i, r in done.items()}


def _run_both(name, prompts, max_new=8, sps=None, jkw=None, tkw=None,
              **kw):
    cfg, jparams, tcfg, tparams = _trees(name)
    sps = sps or [None] * len(prompts)
    jeng = JaxEngine(cfg, jparams,
                     jbase.ServeConfig(**dict(kw, **(jkw or {}))))
    jdone = jeng.run([JaxRequest(
        rid=i, prompt=p, max_new=max_new,
        sampling=jax_sampling.SamplingParams(**(sp or {})))
        for i, (p, sp) in enumerate(zip(prompts, sps))], max_steps=2000)
    eng = Engine(tcfg, tparams,
                 tbase.ServeConfig(**dict(kw, **(tkw or {}))), device="cpu")
    done = eng.run([Request(
        rid=i, prompt=p, max_new=max_new,
        sampling=sampling.SamplingParams(**(sp or {})))
        for i, (p, sp) in enumerate(zip(prompts, sps))], max_steps=2000)
    return _tokens(jdone), _tokens(done), jeng, eng


# ---------------------------------------------------------------------------
# configs, positions


def test_check_supported_accepts_every_registry_config():
    for cfg in REGISTRY.values():
        transformer.check_supported(cfg)
    bad = dataclasses.replace(torch_get_config("qwen2-vl-smoke"),
                              block_pattern=("attn", "conv"))
    with pytest.raises(NotImplementedError, match="conv"):
        transformer.check_supported(bad)


@pytest.mark.parametrize("d_head", [16, 128])
def test_mrope_matches_the_reference_and_equals_rope_on_equal_channels(
        d_head):
    cfg = dataclasses.replace(torch_get_config("qwen2-vl-smoke"),
                              d_head=d_head)
    sections = transformer._mrope_sections(cfg)
    assert sections == {16: (2, 3, 3), 128: (16, 24, 24)}[d_head]
    rng = np.random.default_rng(d_head)
    pos = rng.integers(0, 4096, (3, 2, 11)).astype(np.int32)
    assert not np.array_equal(pos[0], pos[1])
    want = jax_rope.mrope_cos_sin(jnp.asarray(pos), d_head, 1e6,
                                  sections=sections)
    got = rope.mrope_cos_sin(_t(pos), d_head, 1e6, sections=sections)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1.2e-7,
                                   rtol=0)
    same = _t(np.broadcast_to(pos[:1], pos.shape))
    for m, r in zip(rope.mrope_cos_sin(same, d_head, 1e6, sections),
                    rope.rope_cos_sin(same[0], d_head, 1e6)):
        assert torch.equal(m, r)
    with pytest.raises(ValueError, match="sections"):
        rope.mrope_cos_sin(_t(pos), d_head, 1e6, sections=(1, 1, 1))


@pytest.mark.parametrize("d", [64, 1536])
def test_sinusoidal_positions_match_the_reference(d):
    pos = np.arange(4096, dtype=np.int32)
    want = np.asarray(jax_layers.sinusoidal_positions(jnp.asarray(pos), d))
    got = layers.sinusoidal_positions(_t(pos), d).numpy()
    assert got.shape == want.shape == (4096, d) and got.dtype == np.float32
    # the frequencies are the angles at position 1
    half = d // 2
    f_want = np.arcsin(want[1, :half]).astype(np.float32)
    ulp = np.spacing(np.abs(f_want))
    f_got = np.arcsin(got[1, :half]).astype(np.float32)
    assert np.all(np.abs(f_got - f_want) <= 1.5 * ulp + 1e-7)
    bound = 2e-6 + pos[:, None] * 2.0 ** -23
    assert np.all(np.abs(got - want) <= bound)


# ---------------------------------------------------------------------------
# the frontends


@pytest.mark.parametrize("name", FRONTENDS)
def test_prefill_then_decode_matches_forward(name):
    cfg, jparams, tcfg, tparams = _trees(name, seed=12)
    B, S, pre = 1, 12, 8
    shape = (B, S, cfg.n_codebooks) if cfg.n_codebooks else (B, S)
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(13), shape, 0,
                                         cfg.vocab))
    jm, tm = JaxModel(cfg), Model(tcfg)
    full, _ = tm.forward(tparams, _t(toks))
    _, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks[:, :pre])},
                       jm.init_cache(B, 16, jnp.float32))
    _, tc = tm.prefill(tparams, _t(toks[:, :pre]),
                       tm.init_cache(B, 16, device="cpu"))
    errs = []
    for t in range(pre, S):
        jl, jc = jm.decode_step(jparams, jnp.asarray(toks[:, t:t + 1]), jc)
        tl, tc = tm.decode_step(tparams, _t(toks[:, t:t + 1]), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-4,
                                   rtol=0)
        errs.append(float((tl[:, 0] - full[:, t]).abs().max()))
    assert max(errs) < 2e-3, errs


def test_vision_stub_and_distinct_mrope_channels_match_the_reference():
    """qwen2-vl-smoke with patch embeddings over the first half of the
    positions and M-RoPE positions of a t/h/w grid (a 1 x 2 x 4 image,
    then text), through forward and prefill."""
    cfg, jparams, tcfg, tparams = _trees("qwen2-vl-smoke")
    B, S = 2, 16
    rng = np.random.default_rng(21)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    vis = rng.standard_normal((B, S // 2, cfg.d_model)).astype(np.float32)
    grid = np.stack([np.zeros(8), np.repeat(np.arange(2), 4),
                     np.tile(np.arange(4), 2)]).astype(np.int32)
    text = np.broadcast_to(4 + np.arange(S - 8), (3, S - 8))
    pos = np.broadcast_to(np.concatenate([grid, text], 1)[:, None],
                          (3, B, S)).astype(np.int32)
    assert not np.array_equal(pos[1], pos[2])
    jb = {"tokens": jnp.asarray(toks), "vision_embeds": jnp.asarray(vis),
          "mrope_positions": jnp.asarray(pos)}
    want, _ = JaxModel(cfg).forward(jparams, jb)
    got, _ = Model(tcfg).forward(tparams, _t(toks), vision_embeds=_t(vis),
                                 mrope_positions=_t(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=0)
    plain, _ = Model(tcfg).forward(tparams, _t(toks))
    assert float((plain - got).abs().max()) > 1e-2   # the inputs matter
    jm, tm = JaxModel(cfg), Model(tcfg)
    jl, _ = jm.prefill(jparams, jb, jm.init_cache(B, 24, jnp.float32))
    tl, tc = tm.prefill(tparams, _t(toks), tm.init_cache(B, 24,
                                                         device="cpu"),
                        vision_embeds=_t(vis), mrope_positions=_t(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-4,
                               rtol=0)


def test_audio_stub_matches_the_reference():
    cfg, jparams, tcfg, tparams = _trees("musicgen-smoke")
    rng = np.random.default_rng(22)
    toks = rng.integers(0, cfg.vocab, (2, 10, cfg.n_codebooks)) \
        .astype(np.int32)
    aud = rng.standard_normal((2, 4, cfg.d_model)).astype(np.float32)
    want, _ = JaxModel(cfg).forward(jparams, {
        "tokens": jnp.asarray(toks), "audio_embeds": jnp.asarray(aud)})
    got, _ = Model(tcfg).forward(tparams, _t(toks), audio_embeds=_t(aud))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=0)
    # the other frontend's input is not read, as in the reference
    other, _ = Model(tcfg).forward(tparams, _t(toks), vision_embeds=_t(aud))
    plain, _ = Model(tcfg).forward(tparams, _t(toks))
    assert torch.equal(other, plain)
    # a decode step with a frame embedding (the reference's batch_extra)
    jm, tm = JaxModel(cfg), Model(tcfg)
    _, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks)},
                       jm.init_cache(2, 16, jnp.float32))
    _, tc = tm.prefill(tparams, _t(toks), tm.init_cache(2, 16, device="cpu"))
    nxt, frame = toks[:, -1:], aud[:, :1]
    jl, _ = jm.decode_step(jparams, jnp.asarray(nxt), jc,
                           batch_extra={"audio_embeds": jnp.asarray(frame)})
    tl, _ = tm.decode_step(tparams, _t(nxt), tc, audio_embeds=_t(frame))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-4,
                               rtol=0)


def test_selfspec_step_adds_sinusoidal_positions_as_the_reference():
    """The self-speculation draft step on a sinusoidal-position variant of
    nectar, with random predictors, against the reference's."""
    cfg, jparams, tcfg, tparams = _trees("nectar-relu-llama-smoke")
    cfg = dataclasses.replace(cfg, pos_emb="sin")
    tcfg = dataclasses.replace(tcfg, pos_emb="sin")
    jpred = jax.vmap(lambda k: jax_sparsity.SparsityPredictor.init(
        k, cfg.d_model, cfg.d_ff, rank=8))(
        jax.random.split(jax.random.PRNGKey(3), cfg.n_units))
    tpred = from_jax_predictors(jax.tree.map(np.asarray, jpred), tcfg,
                                device="cpu")
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 6)) \
        .astype(np.int32)
    jm, tm = JaxModel(cfg), Model(tcfg)
    _, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks)},
                       jm.init_cache(2, 16, jnp.float32))
    _, tc = tm.prefill(tparams, _t(toks), tm.init_cache(2, 16, device="cpu"))
    nxt = toks[:, -1:]
    jstep = jax.jit(jax_selfspec.selfspec_decode_step,
                    static_argnums=(1, 3))
    for _ in range(3):
        jl, jc = jstep(jparams, cfg, jpred, 32, jnp.asarray(nxt), jc)
        tl, tc = selfspec.selfspec_decode_step(tparams, tcfg, tpred, 32,
                                               _t(nxt), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-4,
                                   rtol=0)
        nxt = np.argmax(np.asarray(jl), -1).astype(np.int32)


# ---------------------------------------------------------------------------
# serving


@pytest.mark.parametrize("kw", [dict(paged=False),
                                dict(paged=True),
                                dict(paged=True, attn_backend="flash")],
                         ids=["slot", "naive", "flash"])
@pytest.mark.parametrize("name", FRONTENDS)
def test_engines_serve_like_the_reference(name, kw):
    cfg = get_config(name)
    # the reference's slot engine compiles a prefill per prompt length
    lengths = [4, 4, 9, 4] if not kw["paged"] else LENGTHS
    want, got, _, eng = _run_both(name, _prompts(cfg, lengths),
                                  **dict(BASE, **kw))
    assert got == want and len(got) == len(lengths)
    for toks in got.values():
        assert len(toks) == 8
        if cfg.n_codebooks:
            assert all(len(t) == cfg.n_codebooks for t in toks)


@pytest.mark.parametrize("paged", [True, False])
def test_seeded_sampled_rows_like_the_reference(paged):
    """qwen2-vl-smoke's seeded sampled rows; musicgen-smoke serves a
    sampled request greedy, as the reference does."""
    cfg = get_config("qwen2-vl-smoke")
    prompts = _prompts(cfg, [5, 21, 9, 14] if paged else [5, 5, 9],
                       seed=11)
    sps = [dict(temperature=1.0, top_k=40, top_p=0.9, seed=3 + i)
           for i in range(len(prompts))]
    want, got, _, _ = _run_both("qwen2-vl-smoke", prompts, sps=sps,
                                **dict(BASE, paged=paged))
    assert got == want
    mcfg = get_config("musicgen-smoke")
    prompts = _prompts(mcfg, [6, 6], seed=12)
    sps = [dict(temperature=1.0, seed=5, stop=[[1, 2]]), None]
    want, got, _, _ = _run_both("musicgen-smoke", prompts, sps=sps,
                                **dict(BASE, paged=paged))
    greedy = _run_both("musicgen-smoke", prompts, **dict(BASE,
                                                         paged=paged))[1]
    assert got == want == greedy


def test_qwen2_vl_async_equals_sync_and_the_reference():
    """The async engine at K = 4 (M-RoPE models pass the async gate; a
    codebook model's ticks stay synchronous)."""
    cfg, jparams, tcfg, tparams = _trees("qwen2-vl-smoke")
    prompts = _prompts(cfg, LENGTHS)
    kw = dict(BASE, paged=True)
    want, got, jeng, eng = _run_both(
        "qwen2-vl-smoke", prompts, max_new=12,
        jkw=dict(async_cfg=jbase.AsyncConfig(enabled=True,
                                             max_device_ticks=4)),
        tkw=dict(async_cfg=tbase.AsyncConfig(enabled=True,
                                             max_device_ticks=4)), **kw)
    sync = _run_both("qwen2-vl-smoke", prompts, max_new=12, **kw)[1]
    assert got == want == sync
    stats = eng.async_stats()
    assert stats == jeng.async_stats() and stats["loop_bursts"] > 0
    mcfg = get_config("musicgen-smoke")
    mprompts = _prompts(mcfg, [5, 9, 3])
    want, got, jeng, eng = _run_both(
        "musicgen-smoke", mprompts, max_new=6,
        jkw=dict(async_cfg=jbase.AsyncConfig(enabled=True,
                                             max_device_ticks=4)),
        tkw=dict(async_cfg=tbase.AsyncConfig(enabled=True,
                                             max_device_ticks=4)), **kw)
    assert got == want
    assert eng.async_stats() == jeng.async_stats()
    assert eng.async_stats()["loop_bursts"] == 0


def test_refusals_raise_the_references_errors():
    """Speculation and the prefix cache for codebook and M-RoPE models,
    prompt log-probabilities for codebook models, a flat prompt to a
    codebook model: ValueError in both packages."""
    for name in FRONTENDS:
        cfg, jparams, tcfg, tparams = _trees(name)
        for kw in (dict(paged=True, spec=True),
                   dict(paged=True, prefix_cache=True)):
            def make(base, eng, c, p, **dev):
                k = dict(kw)
                if k.pop("spec", False):
                    k["spec"] = base.SpecConfig()
                return eng(c, p, base.ServeConfig(**k), **dev)
            with pytest.raises(ValueError) as want:
                make(jbase, JaxEngine, cfg, jparams)
            with pytest.raises(ValueError) as got:
                make(tbase, Engine, tcfg, tparams, device="cpu")
            assert str(got.value) == str(want.value)
    cfg, jparams, tcfg, tparams = _trees("musicgen-smoke")
    prompt = _prompts(cfg, [4])[0]
    # a flat token list (the serve CLI's prompts) to a codebook model
    flat = prompt[:, 0].copy()
    for paged in (True, False):
        with pytest.raises(ValueError):
            JaxEngine(cfg, jparams, jbase.ServeConfig(paged=paged)).run(
                [JaxRequest(rid=0, prompt=flat, max_new=2)])
        with pytest.raises(ValueError):
            Engine(tcfg, tparams, tbase.ServeConfig(paged=paged),
                   device="cpu").run([Request(rid=0, prompt=flat,
                                              max_new=2)])
    for paged in (True, False):
        sp = dict(prompt_logprobs=True)
        with pytest.raises(ValueError, match="plain token"):
            JaxEngine(cfg, jparams, jbase.ServeConfig(paged=paged)) \
                .add_request(JaxRequest(rid=0, prompt=prompt, max_new=2,
                             sampling=jax_sampling.SamplingParams(**sp)))
        with pytest.raises(ValueError, match="plain token"):
            Engine(tcfg, tparams, tbase.ServeConfig(paged=paged),
                   device="cpu").add_request(Request(
                       rid=0, prompt=prompt, max_new=2,
                       sampling=sampling.SamplingParams(**sp)))


@pytest.mark.parametrize("name", FRONTENDS)
def test_disagg_and_fleet_like_the_reference(name):
    """Both models through the disagg coordinator (the prefix cache off:
    they refuse it), and through a two-replica fleet router, affinity and
    round robin: qwen2-vl's tokens are the reference's; the router takes
    a prompt as a flat token list, so a codebook prompt fails inside the
    replica's step in both packages (ValueError), as a prefix-cached
    fleet of either model is refused (ValueError)."""
    cfg, jparams, tcfg, tparams = _trees(name)
    prompts = _prompts(cfg, [5, 21, 9, 13])

    def scfg(base, **kw):
        return base.ServeConfig(**dict(
            dict(max_batch=2, max_seq=64, paged=True, block_size=4,
                 n_kv_blocks=32, prefill_chunk=8, max_queue=8), **kw))
    jc = JaxCoordinator(cfg, jparams, scfg(jbase))
    want = _tokens(jc.run([JaxRequest(rid=i, prompt=p, max_new=4)
                           for i, p in enumerate(prompts)], max_steps=4000))
    tc = DisaggCoordinator(tcfg, tparams, scfg(tbase), device="cpu")
    got = _tokens(tc.run([Request(rid=i, prompt=p, max_new=4)
                          for i, p in enumerate(prompts)], max_steps=4000))
    assert got == want and len(got) == len(prompts)
    assert tc.metrics.summary()["n_handoffs"] \
        == jc.metrics.summary()["n_handoffs"] == len(prompts)

    def fleet(fn, base, c, p, policy, **dev):
        r = fn(c, p, scfg(base), n_replicas=2, policy=policy, **dev)
        rids = [r.submit(q, max_new=4) for q in prompts]
        r.drain_all()
        return [[np.asarray(t).tolist() for t in r.result(x).tokens_out]
                for x in rids]
    for policy in ("affinity", "round_robin"):
        if cfg.n_codebooks:
            with pytest.raises(ValueError):
                fleet(jax_build_fleet, jbase, cfg, jparams, policy)
            with pytest.raises(ValueError):
                fleet(build_fleet, tbase, tcfg, tparams, policy,
                      device="cpu")
        else:
            assert fleet(build_fleet, tbase, tcfg, tparams, policy,
                         device="cpu") \
                == fleet(jax_build_fleet, jbase, cfg, jparams, policy)
    for fn, base, c, p, dev in (
            (jax_build_fleet, jbase, cfg, jparams, {}),
            (build_fleet, tbase, tcfg, tparams, {"device": "cpu"})):
        with pytest.raises(ValueError, match="prefix caching"):
            fn(c, p, scfg(base, prefix_cache=True), n_replicas=2, **dev)


# ---------------------------------------------------------------------------
# cost model


@pytest.mark.parametrize("w,hp", [(1, False), (16, True)])
def test_cost_model_counts_codebook_products_as_flop_counter(w, hp,
                                                             monkeypatch):
    """On musicgen-smoke the paged step's product scopes (attn, the dense
    FFN, the nc-head logits) equal what FlopCounterMode counts in that
    scope's code within 1%; the sampler costs 0, as the reference's
    reports it for codebook logits."""
    _, _, tcfg, tparams = _trees("musicgen-smoke")
    eng = Engine(tcfg, tparams, tbase.ServeConfig(paged=True, **BASE),
                 device="cpu")
    counts = dict.fromkeys(("attn", "ffn_dense", "logits"), 0)

    def counted(scope, fn):
        def wrapper(*args, **kwargs):
            with FlopCounterMode(display=False) as fc:
                out = fn(*args, **kwargs)
            counts[scope] += fc.get_total_flops()
            return out
        return wrapper
    monkeypatch.setattr(attention, "attn_step_paged",
                        counted("attn", attention.attn_step_paged))
    monkeypatch.setattr(ffn, "ffn_step", counted("ffn_dense", ffn.ffn_step))
    monkeypatch.setattr(transformer, "project_logits",
                        counted("logits", transformer.project_logits))
    runner = eng.runner
    B, MB = runner.scfg.max_batch, runner.scfg.blocks_per_seq
    nc = tcfg.n_codebooks
    batch = runner.new_batch(w, np.arange(B * MB, dtype=np.int32)
                             .reshape(B, MB))
    assert batch.tokens.shape == (B, w, nc)
    for slot in range(B):
        batch.add_row(slot, PREFILL if hp else DECODE,
                      np.arange(w * nc).reshape(w, nc) % tcfg.vocab, 8)
    out = runner.step(batch)
    assert tuple(out.last_logits.shape) == (B, nc, tcfg.vocab)
    cost = costmodel.step_cost(runner, w, hp)
    for scope, n in counts.items():
        assert cost.by_scope[scope]["flops"] == pytest.approx(n, rel=0.01), \
            scope
    assert counts["logits"] == 2 * B * w * tcfg.d_model * nc * tcfg.vocab
    assert costmodel.sampler_cost(B, tcfg.vocab, nc) \
        == {"flops": 0.0, "bytes": 0.0}
