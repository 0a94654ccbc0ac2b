"""``Model.loss`` and its gradients in the port against the JAX
reference, on the CPU: the paper's nectar-relu-llama-1.7m and the ten
architectures of ``tests/test_system.py`` (ARCHS) at their SMOKE sizes.

Weights are the reference's ``init(PRNGKey(1))`` carried across by
``weights.from_jax_params``; inputs are ``tests/test_system.py``'s
``make_batch`` (random tokens and labels, the frontends' stub embeddings
and M-RoPE positions) plus a mask that drops the last quarter of the
positions (nectar: a TinyStoriesSynth batch). Tolerances: the loss, and
``ce``, ``aux`` and ``ppl`` (relative), within 1e-5; every gradient leaf
within 1e-4 relative (Frobenius), the reference's ``jax.value_and_grad``
of its ``Model.loss`` at ``highest`` matmul precision against torch
autograd through the port's (kernel 3's rule and flash's backward
included).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_system import ARCHS, SMOKE_OF, make_batch
from repro.configs import get_config
from repro.models import Model as JaxModel
from repro.train import data as jdata
from repro_torch.configs import get_config as torch_get_config
from repro_torch.models import Model
from repro_torch.train import loop
from repro_torch.tree import leaves
from repro_torch.weights import from_jax_params


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg):
    if cfg.name.startswith("nectar"):
        b = jdata.TinyStoriesSynth(jdata.DataConfig(
            seq_len=32, batch_size=4, vocab_size=cfg.vocab)).batch_at(3)
        return {k: np.asarray(v) for k, v in b.items()}
    b = {k: np.asarray(v) for k, v in make_batch(cfg).items()}
    B, S = b["tokens"].shape[:2]
    b["mask"] = np.ones((B, S), np.float32)
    b["mask"][:, 3 * S // 4:] = 0.0
    return b


@pytest.mark.parametrize("name", ["nectar-relu-llama-1.7m"]
                         + [SMOKE_OF[a] for a in ARCHS])
def test_loss_and_gradients_match_the_reference(name):
    cfg = get_config(name)
    jparams = JaxModel(cfg).init(jax.random.PRNGKey(1))
    tcfg = torch_get_config(name)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    b = _batch(cfg)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, bb: JaxModel(cfg).loss(p, bb), has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in b.items()})
    loss, metrics = Model(tcfg).loss(
        tparams, {k: torch.from_numpy(v) for k, v in b.items()})
    l2, m2, grads = loop.value_and_grad(
        tparams, tcfg, {k: torch.from_numpy(v) for k, v in b.items()})
    assert float(loss) == float(l2)
    assert abs(float(loss) - float(jl)) <= 1e-5
    assert abs(float(metrics["ce"]) - float(jm["ce"])) <= 1e-5
    assert abs(float(metrics["aux"]) - float(jm["aux"])) <= 1e-5
    assert abs(float(metrics["ppl"]) / float(jm["ppl"]) - 1) <= 1e-5
    flat_j = jax.tree_util.tree_flatten_with_path(jg)[0]
    flat_t = leaves(grads)
    assert len(flat_j) == len(flat_t)
    for (path, want), got in zip(flat_j, flat_t):
        want = np.asarray(want, np.float64)
        got = got.double().numpy()
        assert got.shape == want.shape, jax.tree_util.keystr(path)
        err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert err <= 1e-4, (jax.tree_util.keystr(path), err)
