"""The paper's end-to-end application on the port
(``repro_torch.examples.relu_llama_e2e``), on the CPU, against the
reference's example.

From the reference's weights (``Model(cfg).init(PRNGKey(0))`` through
``from_jax_params``) the port trains three steps on the CPU; on the
weights it trained:
  * each layer's ReLU sparsity within 1e-6 of the reference example's
    computation;
  * the dense and the NeCTAr-sparse serves token-identical to the
    reference's slot engine on the same requests, with equal step counts
    and equal weight bytes per token (``eng.stats``), hence the same
    weight-read reduction.
``main`` also runs under ``--device cpu`` at two training steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs.base import ServeConfig as JaxServeConfig
from repro.core import sparsity as jax_sp
from repro.models import Model as JaxModel
from repro.models import layers as jax_layers
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch.configs import get_config as torch_get_config
from repro_torch.examples import relu_llama_e2e
from repro_torch.weights import from_jax_params


def to_jax(tree):
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree.detach().cpu().numpy())


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the module: the serves' small eager ops crawl
    when torch's threads oversubscribe a host that runs other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trained():
    """(reference cfg, port cfg, the port's weights after 3 steps from the
    reference's init, the same weights as the reference's tree, info)."""
    cfg = get_config("nectar-relu-llama-1.7m")
    tcfg = torch_get_config(cfg.name)
    jparams = JaxModel(cfg).init(jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    tparams, info = relu_llama_e2e.train(tcfg, tparams, "cpu", 3)
    return cfg, tcfg, tparams, to_jax(tparams), info


def _reference_sparsity(cfg, params):
    """The reference example's step 2, verbatim in its arithmetic."""
    src = relu_llama_e2e.source(cfg)
    batch = {k: jnp.asarray(v) for k, v in src.batch_at(0).items()}
    x = jnp.take(params["embed"], batch["tokens"], axis=0)
    fracs = []
    for u in range(cfg.n_units):
        p0 = jax.tree.map(lambda a: a[u], params["units"]["b0"])
        h = jax_layers.rms_norm(x, p0["norm2"], cfg.norm_eps)
        hidden = jax.nn.relu(h @ p0["ffn"]["w_up"])
        fracs.append(float(jax_sp.sparsity_fraction(hidden)))
    return fracs


def test_training_runs_three_steps(trained):
    *_, info = trained
    assert info["steps_done"] == 3
    assert [s for s, _ in info["history"]] == [0, 2]
    assert all(np.isfinite(m["ce"]) for _, m in info["history"])


def test_sparsity_equals_the_references(trained):
    cfg, tcfg, tparams, jparams, _ = trained
    got = relu_llama_e2e.layer_sparsity(tcfg, tparams, "cpu")
    want = _reference_sparsity(cfg, jparams)
    assert len(got) == cfg.n_units
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert all(0.3 < f < 0.7 for f in got)


def test_dense_and_sparse_serves_equal_the_references(trained):
    cfg, tcfg, tparams, jparams, _ = trained
    got = relu_llama_e2e.serve_modes(tcfg, tparams, "cpu")
    rng = np.random.default_rng(0)
    for mode, sparse in relu_llama_e2e.MODES:
        eng = JaxEngine(cfg, jparams, JaxServeConfig(
            max_batch=4, max_seq=96, sparse_decode=sparse))
        reqs = [JaxRequest(rid=i, prompt=rng.integers(0, cfg.vocab, size=8,
                                                      dtype=np.int32),
                           max_new=24) for i in range(8)]
        done = eng.run(reqs, max_steps=1000)
        mine = got[mode]
        assert mine["tokens"] == {rid: [int(t) for t in r.tokens_out]
                                  for rid, r in sorted(done.items())}, mode
        assert mine["n_tokens"] == 8 * 24
        assert mine["steps"] == len(eng.stats)
        assert mine["weight_bytes_per_token"] == float(np.mean(
            [s.weight_bytes for s in eng.stats])), mode
    rep = relu_llama_e2e.report(got)
    assert rep["weight_read_reduction"] > 1.3


def test_main_runs_on_the_cpu(capsys):
    out = relu_llama_e2e.main(["--steps", "2", "--device", "cpu"])
    assert out["device"] == "CPU"
    assert len(out["sparsity"]) == 6
    assert out["weight_read_reduction"] > 1.3
    assert out["paper_chip_infs_per_s"]["sparse"] \
        > out["paper_chip_infs_per_s"]["dense"]
    text = capsys.readouterr().out
    assert "tok/s on CPU" in text and "3.2 GB/s" in text
