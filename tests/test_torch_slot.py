"""The port's slot engine (``ServeConfig(paged=False)``, the default) and the
model calls under it, on the CPU, against the JAX reference.

Weights come from ``repro.models.transformer.init_params(PRNGKey(0))``,
converted through ``repro_torch.weights.from_jax_params``; prompts and
teacher-forced tokens from seeded numpy. Tolerances: logits atol=2e-4,
rtol=1e-4 (six layers of f32 matmuls summed in another order by each
library drift by ~1e-6 relative) and greedy tokens identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs.base import ServeConfig as JaxServeConfig
from repro.models import Model as JaxModel
from repro.serve.engine import Engine as JaxEngine
from repro.serve.scheduler import Request as JaxRequest
from repro_torch.configs import get_config as torch_get_config
from repro_torch.configs.base import ServeConfig
from repro_torch.models import Model as TorchModel
from repro_torch.serve import api
from repro_torch.serve.engine import Engine
from repro_torch.serve.scheduler import Request
from repro_torch.weights import from_jax_params

LOGIT_TOL = dict(atol=2e-4, rtol=1e-4)
SLOT_KW = dict(paged=False, max_batch=3, max_seq=96)
# the prompt lengths of tests/test_paged_serving.py's equivalence tests
LENGTHS = [5, 37, 9, 60, 3, 21]


@pytest.fixture(scope="module")
def nectar():
    cfg = get_config("nectar-relu-llama-1.7m")
    jparams = JaxModel(cfg).init(jax.random.PRNGKey(0))
    tcfg = torch_get_config(cfg.name)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return cfg, jparams, tcfg, tparams


def _prompts(cfg, lengths, seed=0):
    """tests/test_paged_serving.py:28's prompts: seeded numpy token ids."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, size=int(n), dtype=np.int32)
            for n in lengths]


def test_prefill_and_teacher_forced_decode_match_reference(nectar):
    """A batch-2 prefill of 11 tokens, then 6 decode steps on given tokens
    with rows at different context lengths (row 1 restarts 4 positions
    back, overwriting its cache there as the slot engine's decode does)."""
    cfg, jparams, tcfg, tparams = nectar
    rng = np.random.default_rng(1)
    B, S, max_len, steps = 2, 11, 32, 6
    prompt = rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
    feed = rng.integers(0, cfg.vocab, (steps, B, 1), dtype=np.int32)

    jm, tm = JaxModel(cfg), TorchModel(tcfg)
    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(prompt)},
                        jm.init_cache(B, max_len, jnp.float32))
    tl, tc = tm.prefill(tparams, torch.from_numpy(prompt),
                        tm.init_cache(B, max_len, device="cpu"))
    assert tl.shape == (B, 1, cfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    np.testing.assert_array_equal(tc["lens"].numpy(), np.asarray(jc["lens"]))
    for leaf in ("k", "v"):
        np.testing.assert_allclose(
            tc["units"]["b0"][leaf].numpy(),
            np.asarray(jc["units"]["b0"][leaf]), atol=1e-4, rtol=1e-4)

    lens = np.array([S, S - 4], np.int32)
    jc = dict(jc, lens=jnp.asarray(lens))
    tc = dict(tc, lens=torch.from_numpy(lens))
    for t in range(steps):
        jl, jc = jm.decode_step(jparams, jnp.asarray(feed[t]), jc)
        tl, tc = tm.decode_step(tparams, torch.from_numpy(feed[t]), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    np.testing.assert_array_equal(tc["lens"].numpy(), lens + steps)


def _serve_reference(cfg, params, prompts, max_new=8, **kw):
    eng = JaxEngine(cfg, params, JaxServeConfig(**kw))
    done = eng.run([JaxRequest(rid=i, prompt=p, max_new=max_new)
                    for i, p in enumerate(prompts)], max_steps=1000)
    return {i: [int(t) for t in r.tokens_out] for i, r in done.items()}


def _serve_port(cfg, params, prompts, max_new=8, **kw):
    """Serve through the port's engine, recording the top-2 logit margin
    behind every committed token as {(rid, index): margin}: in slot mode
    the first token's from the prefill logits, later ones from the decode
    step's; in paged mode all from the batched step's."""
    eng = Engine(cfg, params, ServeConfig(**kw), device="cpu")
    margins, last = {}, {}
    sample, append = eng._sample_rows, eng._append_token
    prefill = eng.model.prefill

    def recording_prefill(*args):
        logits, cache = prefill(*args)
        last["prefill"] = logits[0, 0].numpy()
        return logits, cache

    def recording_sample(last_logits):
        last["decode"] = last_logits.numpy()
        return sample(last_logits)

    def recording_append(req, tok, lp):
        if kw.get("paged"):        # every token comes from a batched step
            z = last["decode"][eng.sched.active[req.rid].slot]
        elif not req.tokens_out:   # the slot engine's prefill token
            z = last["prefill"]
        else:
            z = last["decode"][eng.alloc.active[req.rid]]
        z = np.sort(z)
        margins[(req.rid, len(req.tokens_out))] = float(z[-1] - z[-2])
        return append(req, tok, lp)

    eng.model.prefill = recording_prefill
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


def test_slot_engine_matches_reference_slot_engine(nectar):
    """Six prompts of 3..60 tokens through three slots: requests wait for
    a slot, slots are reused, idle slots decode padding."""
    cfg, jparams, tcfg, tparams = nectar
    prompts = _prompts(cfg, LENGTHS)
    want = _serve_reference(cfg, jparams, prompts, **SLOT_KW)
    got, eng, margins = _serve_port(tcfg, tparams, prompts, **SLOT_KW)
    _assert_same_tokens(want, got, margins)
    s = eng.metrics.summary()
    assert s["n_finished"] == len(prompts)
    assert s["generated_tokens"] == 8 * len(prompts)
    assert eng.admission_free == SLOT_KW["max_batch"]   # every slot free
    assert not eng._busy()


def test_slot_engine_matches_port_paged_engine(nectar):
    """The slot engine and the paged engine of the port agree token for
    token on the same prompts (decode through the decode-attention
    kernel's plain version and through paged attention)."""
    _, _, tcfg, tparams = nectar
    prompts = _prompts(tcfg, LENGTHS)
    slot, _, margins = _serve_port(tcfg, tparams, prompts, **SLOT_KW)
    paged, _, _ = _serve_port(tcfg, tparams, prompts, paged=True,
                              attn_backend="flash", max_batch=3, max_seq=96,
                              block_size=8, prefill_chunk=16)
    _assert_same_tokens(paged, slot, margins)


def test_slot_engine_max_new_1_emits_one_token(nectar):
    """The reference's regression (test_paged_serving.py, max_new=1): the
    prefill token is the only one, and the request finishes at admission."""
    _, _, tcfg, tparams = nectar
    prompts = _prompts(tcfg, [7])
    got, eng, _ = _serve_port(tcfg, tparams, prompts, max_new=1,
                              paged=False, max_batch=2, max_seq=32)
    paged, _, _ = _serve_port(tcfg, tparams, prompts, max_new=1, paged=True,
                              max_batch=2, max_seq=32, block_size=8)
    assert len(got[0]) == 1 and got == paged
    assert eng.metrics.decode_steps == 0


def test_streaming_server_over_the_slot_engine(nectar):
    """StreamingServer keeps a backlog while every slot is taken and
    streams the same tokens the batch loop gives."""
    _, _, tcfg, tparams = nectar
    prompts = _prompts(tcfg, [11, 26, 5, 9], seed=5)
    kw = dict(paged=False, max_batch=2, max_seq=64)
    ref, _, _ = _serve_port(tcfg, tparams, prompts, max_new=5, **kw)
    eng = Engine(tcfg, tparams, ServeConfig(**kw), device="cpu")
    server = api.StreamingServer(eng)
    rids = [server.submit(p, max_new=5) for p in prompts]
    assert eng.admission_free == 0 and len(server._backlog) == 2
    streamed = {rid: [] for rid in rids}
    while server.busy:
        for rid, toks in server.poll().items():
            streamed[rid].extend(toks)
    assert [streamed[r] for r in rids] == [ref[i] for i in range(4)]
    assert list(api.generate(eng, prompts[0], max_new=5)) == ref[0]
