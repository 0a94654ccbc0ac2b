"""The port's paged engine and streaming API on the CPU.

Greedy tokens of the port's ``Engine(device="cpu")`` are held against the
JAX reference ``Engine(ServeConfig(paged=True, attn_backend="flash"))`` on
the same weights (``init_params(PRNGKey(0))``) and seeded prompts; they
must be identical. On a mismatch the failure names the first divergent
step and the port's top-2 logit margin there: a near-tie flipped by
summation order shows a margin of order 1e-6, a real fault a large one.
"""

import jax
import numpy as np
import pytest

from repro.configs import get_config
from repro.configs.base import ServeConfig as JaxServeConfig
from repro.models import Model as JaxModel
from repro.serve.engine import Engine as JaxEngine
from repro.serve.scheduler import Request as JaxRequest
from repro_torch.configs import get_config as torch_get_config
from repro_torch.configs.base import (AsyncConfig, MeshConfig, ServeConfig,
                                      SpecConfig)
from repro_torch.serve import api
from repro_torch.serve.engine import Engine
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.scheduler import Request
from repro_torch.weights import from_jax_params

ENGINE_KW = dict(paged=True, attn_backend="flash", max_batch=2,
                 block_size=8, prefill_chunk=16, max_seq=128)
LENGTHS = [3, 70, 21, 37, 9]


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


def _serve_reference(cfg, params, prompts, max_new=8, **kw):
    eng = JaxEngine(cfg, params, JaxServeConfig(**kw))
    done = eng.run([JaxRequest(rid=i, prompt=p, max_new=max_new)
                    for i, p in enumerate(prompts)], max_steps=1000)
    return {i: [int(t) for t in r.tokens_out] for i, r in done.items()}, eng


def _serve_port(cfg, params, prompts, max_new=8, **kw):
    """Serve through the port, recording the top-2 logit margin behind
    every committed token as {(rid, index): margin}."""
    eng = Engine(cfg, params, ServeConfig(**kw), device="cpu")
    margins, last = {}, {}
    sample, append = eng._sample_rows, eng._append_token

    def recording_sample(pairs, last_logits):
        last["z"] = last_logits.numpy()
        return sample(pairs, last_logits)

    def recording_append(req, slot, tok, lp):
        z = np.sort(last["z"][slot])
        margins[(req.rid, len(req.tokens_out))] = float(z[-1] - z[-2])
        return append(req, slot, tok, lp)

    eng._sample_rows, eng._append_token = recording_sample, recording_append
    done = eng.run([Request(rid=i, prompt=p, max_new=max_new)
                    for i, p in enumerate(prompts)], max_steps=1000)
    return ({i: [int(t) for t in r.tokens_out] for i, r in done.items()},
            eng, margins)


def _assert_same_tokens(want, got, margins):
    assert set(got) == set(want)
    for rid in sorted(want):
        w, g = want[rid], got[rid]
        if w == g:
            continue
        step = next((i for i, (a, b) in enumerate(zip(w, g)) if a != b),
                    min(len(w), len(g)))
        pytest.fail(f"request {rid} diverges at generated token {step}: "
                    f"reference {w[step:step + 3]} port {g[step:step + 3]}; "
                    f"port top-2 logit margin there "
                    f"{margins.get((rid, step))}")


def test_engine_greedy_tokens_match_reference_flash_engine(nectar):
    """Prompts of 3..70 tokens (some longer than one prefill chunk),
    max_batch=2 so requests queue; the pool is large enough that nothing
    is preempted."""
    cfg, jparams, tcfg, tparams = nectar
    prompts = _prompts(cfg, LENGTHS)
    want, _ = _serve_reference(cfg, jparams, prompts, **ENGINE_KW)
    got, eng, margins = _serve_port(tcfg, tparams, prompts, **ENGINE_KW)
    _assert_same_tokens(want, got, margins)
    assert eng.metrics.evictions == 0
    assert eng.pool.n_free == eng.pool.n_blocks   # every block returned
    s = eng.metrics.summary()
    assert s["n_finished"] == len(prompts)
    assert s["generated_tokens"] == 8 * len(prompts)


def test_engine_preemption_replay_matches_reference(nectar):
    """A pool too small for both slots forces preemption-by-recompute:
    the port replays evicted requests as the reference does, so the two
    stay token-identical (replayed decode KV goes through the dense
    prefill FFN on both sides)."""
    cfg, jparams, tcfg, tparams = nectar
    prompts = _prompts(cfg, [30, 41, 12], seed=3)
    kw = dict(ENGINE_KW, attn_backend="naive", n_kv_blocks=9)
    want, jeng = _serve_reference(cfg, jparams, prompts, max_new=12, **kw)
    got, eng, margins = _serve_port(tcfg, tparams, prompts, max_new=12,
                                    **kw)
    _assert_same_tokens(want, got, margins)
    assert eng.metrics.evictions == jeng.metrics.evictions > 0
    assert eng.pool.n_free == eng.pool.n_blocks


def test_generate_and_streaming_server_stream_the_engine_tokens(nectar):
    _, _, tcfg, tparams = nectar
    prompts = _prompts(tcfg, [11, 26, 5], seed=5)
    kw = dict(ENGINE_KW, attn_backend="naive")
    ref, _, _ = _serve_port(tcfg, tparams, prompts, max_new=6, **kw)

    eng = Engine(tcfg, tparams, ServeConfig(**kw), device="cpu")
    assert list(api.generate(eng, prompts[0], max_new=6)) == ref[0]

    server = api.StreamingServer(
        Engine(tcfg, tparams, ServeConfig(**kw), device="cpu"))
    rids = [server.submit(p, max_new=6) for p in prompts]
    streamed = {rid: [] for rid in rids}
    while server.busy:
        for rid, toks in server.poll().items():
            streamed[rid].extend(toks)
    assert [streamed[r] for r in rids] == [ref[i] for i in range(3)]
    assert server.result(rids[0], forget=True).tokens_out == ref[0]
    assert rids[0] not in server.engine._requests


def test_stop_sequences_and_max_tokens(nectar):
    _, _, tcfg, tparams = nectar
    prompt = _prompts(tcfg, [9], seed=2)[0]
    kw = dict(ENGINE_KW, attn_backend="naive")
    full = list(api.generate(Engine(tcfg, tparams, ServeConfig(**kw),
                                    device="cpu"), prompt, max_new=8))
    stop = tuple(full[2:4])
    cut = next(i for i in range(len(full) - 1)
               if tuple(full[i:i + 2]) == stop)
    eng = Engine(tcfg, tparams, ServeConfig(**kw), device="cpu")
    out = list(api.generate(eng, prompt, max_new=8,
                            sampling=SamplingParams(stop=(stop,))))
    assert out == full[:cut]
    eng = Engine(tcfg, tparams, ServeConfig(**kw), device="cpu")
    out = list(api.generate(eng, prompt, max_new=8,
                            sampling=SamplingParams(max_tokens=3,
                                                    logprobs=True)))
    assert out == full[:3]
    req = next(iter(eng._requests.values()))
    assert len(req.logprobs_out) == 3
    assert all(np.isfinite(lp) and lp <= 0.0 for lp in req.logprobs_out)


@pytest.mark.parametrize("scfg_kw", [
    dict(paged=True, mesh=MeshConfig(model=2)),
    # tracing (ObsConfig) was refused here before the observability slice
    dict(paged=True, mesh=MeshConfig(data=2)),
])
def test_engine_raises_for_features_of_later_slices(nectar, scfg_kw):
    """A mesh was refused here (NotImplementedError) before the
    multi-device slice. Now a mesh of two shards needs a device per shard
    (one device is refused), and data > 1 stays refused, as the
    reference's engine refuses it."""
    _, _, tcfg, tparams = nectar
    with pytest.raises(ValueError, match="sequence of 2 devices|data > 1"):
        Engine(tcfg, tparams, ServeConfig(**scfg_kw), device="cpu")


def test_async_engine_serves_the_sync_engines_tokens(nectar):
    """``async_cfg`` is served (it was refused before the async slice):
    the async engine's greedy tokens through the flash read equal the
    synchronous engine's, and it ran device-resident bursts."""
    _, _, tcfg, tparams = nectar
    prompts = _prompts(tcfg, LENGTHS[:3], seed=3)
    out = {}
    for acfg in (None, AsyncConfig(enabled=True)):
        eng = Engine(tcfg, tparams, ServeConfig(**ENGINE_KW, async_cfg=acfg),
                     device="cpu")
        done = eng.run([Request(rid=i, prompt=p, max_new=8)
                        for i, p in enumerate(prompts)], max_steps=1000)
        out[acfg is None] = {i: list(r.tokens_out) for i, r in done.items()}
    assert out[False] == out[True] and len(out[True]) == 3
    assert eng.async_stats()["loop_bursts"] > 0


@pytest.mark.parametrize("scfg_kw", [
    dict(spec=SpecConfig()),
    dict(prefix_cache=True),
])
def test_slot_engine_serves_and_raises_for_paged_only_features(nectar,
                                                               scfg_kw):
    """``paged=False`` (the default) builds the slot engine, which serves;
    spec and the prefix cache need the paged engine, and the slot engine
    refuses them with a ValueError, as the reference does."""
    _, _, tcfg, tparams = nectar
    eng = Engine(tcfg, tparams, ServeConfig(max_batch=2, max_seq=32),
                 device="cpu")
    assert not eng.scfg.paged
    out = list(api.generate(eng, np.arange(5, dtype=np.int32), max_new=3))
    assert len(out) == 3
    with pytest.raises(ValueError, match="paged=True"):
        Engine(tcfg, tparams, ServeConfig(paged=False, **scfg_kw),
               device="cpu")


@pytest.mark.parametrize("sp", [
    SamplingParams(temperature=0.8),
    SamplingParams(repetition_penalty=1.3),
    SamplingParams(prompt_logprobs=True),
])
def test_engine_raises_for_sampled_rows(nectar, sp):
    """Sampled rows, the repetition penalty and prompt log-probabilities,
    which earlier slices refused with NotImplementedError, are admitted
    and served through the normal entry points now."""
    _, _, tcfg, tparams = nectar
    eng = Engine(tcfg, tparams, ServeConfig(paged=True), device="cpu")
    req = Request(rid=0, prompt=np.arange(4, dtype=np.int32), max_new=3,
                  sampling=sp)
    assert eng.add_request(req)
    eng.run([], max_steps=100)
    assert req.done and len(req.tokens_out) == 3
    if sp.prompt_logprobs:
        assert req.prompt_logprobs_out[0] is None
        assert len(req.prompt_logprobs_out) == 4
        assert all(lp <= 0.0 for lp in req.prompt_logprobs_out[1:])
