"""The port's speculative-decoding example
(``repro_torch.examples.spec_decode``) on the CPU, against the same calls
through the reference's API at the example's settings, on the
reference's weights (target ``PRNGKey(0)``, draft model ``PRNGKey(7)``,
through ``from_jax_params``). The self-spec drafter of both packages
takes the reference's calibrated predictors (the reference engine's own
defaults; the port's through ``from_jax_predictors``). The n-gram stream
and every drafter of the menu give the reference's greedy tokens, spec
counters and final K, and the menu's outputs are identical across
drafters. ``main`` also runs under ``--device cpu``.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs.base import ServeConfig as JaxServeConfig
from repro.configs.base import SpecConfig as JaxSpecConfig
from repro.models import Model as JaxModel
from repro.serve import api as jax_api
from repro.serve.engine import Engine as JaxEngine
from repro.serve.scheduler import Request as JaxRequest
from repro.spec import SelfSpecDrafter as JaxSelfSpecDrafter
from repro_torch.configs import get_config as torch_get_config
from repro_torch.examples import spec_decode
from repro_torch.spec import SelfSpecDrafter
from repro_torch.weights import from_jax_params, from_jax_predictors

SPEC_KEYS = ("spec_steps", "generated_tokens", "spec_acceptance_rate",
             "spec_tokens_per_verify")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Self-spec's small eager ops crawl when torch's threads oversubscribe
    a host that runs other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    cfg = get_config("nectar-relu-llama-1.7m")
    dcfg = get_config(spec_decode.DRAFT_NAME)
    jparams = JaxModel(cfg).init(jax.random.PRNGKey(0))
    jdraft = JaxModel(dcfg).init(jax.random.PRNGKey(7))
    tcfg = torch_get_config(cfg.name)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    tdraft = from_jax_params(jax.tree.map(np.asarray, jdraft),
                             torch_get_config(dcfg.name), device="cpu")
    return cfg, jparams, jdraft, tcfg, tparams, tdraft


def _jax_scfg(spec):
    return JaxServeConfig(max_batch=2, max_seq=256, paged=True,
                          block_size=16, prefill_chunk=32, spec=spec)


def _jax_spec(spec):
    return None if spec is None else JaxSpecConfig(
        drafter=spec.drafter, k=spec.k, k_max=spec.k_max,
        draft_name=spec.draft_name)


def test_stream_equals_the_references(weights):
    cfg, jparams, _, tcfg, tparams, _ = weights
    got = spec_decode.stream(tcfg, tparams, "cpu")
    rng = np.random.default_rng(0)
    eng = JaxEngine(cfg, jparams, _jax_scfg(
        JaxSpecConfig(drafter="ngram", k=6, k_max=6)))
    motif = rng.integers(0, cfg.vocab, size=7, dtype=np.int32)
    want = [int(t) for t in jax_api.generate(eng, np.tile(motif, 6),
                                             max_new=16)]
    assert got["tokens"] == want
    summ = eng.metrics.summary()
    for key in SPEC_KEYS:
        assert got["summary"][key] == summ[key], key


def test_menu_equals_the_references(weights):
    cfg, jparams, jdraft, tcfg, tparams, tdraft = weights
    jd = JaxSelfSpecDrafter(cfg, jparams, 256, max_batch=2)
    td = SelfSpecDrafter(
        tcfg, tparams, 256, max_batch=2, device="cpu",
        preds=from_jax_predictors(jax.tree.map(np.asarray, jd.preds), tcfg,
                                  device="cpu"))
    label_ss = spec_decode.MENU[3][0]
    got = spec_decode.menu(tcfg, tparams, "cpu", tdraft,
                           drafters={label_ss: td})
    prompts = spec_decode.repetitive_prompts(tcfg)
    for label, spec in spec_decode.MENU:
        eng = JaxEngine(cfg, jparams, _jax_scfg(_jax_spec(spec)),
                        drafter=jd if label == label_ss else None,
                        draft_params=jdraft if spec and spec.drafter
                        == "model" else None)
        reqs = [JaxRequest(rid=i, prompt=p, max_new=24)
                for i, p in enumerate(prompts)]
        eng.run(reqs, max_steps=5000)
        mine = got[label]
        assert mine["tokens"] == {i: [int(t) for t in r.tokens_out]
                                  for i, r in enumerate(reqs)}, label
        summ = eng.metrics.summary()
        for key in SPEC_KEYS:
            assert mine["summary"][key] == summ[key], (label, key)
        assert mine["final_k"] == (eng.kctl.k if spec else None), label
    outs = [r["tokens"] for r in got.values()]
    assert all(o == outs[0] for o in outs[1:])
    assert got["ngram"]["summary"]["spec_steps"] > 0


def test_main_runs_on_the_cpu(capsys):
    out = spec_decode.main(["--device", "cpu"])
    assert out["identical"]
    assert out["stream"]["summary"]["spec_steps"] > 0
    assert "token-identical across drafters: True" in capsys.readouterr().out
