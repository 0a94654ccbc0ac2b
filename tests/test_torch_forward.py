"""``Model.forward``, ``param_count``, prefill and decode of the port for
each of the ten architectures of ``tests/test_system.py`` (ARCHS, at their
SMOKE sizes), on the CPU, against the JAX reference.

Weights are the reference's ``init(PRNGKey(1))`` carried across by
``weights.from_jax_params``; inputs are ``tests/test_system.py``'s
``make_batch`` (the vision and audio stubs' embeddings over the first half
of the positions, M-RoPE positions for qwen2-vl). Tolerances: the logits
of the reference's shape within 2e-4 (f32, other summation orders), the
aux loss within 1e-6 (MoE; 0 elsewhere), ``param_count`` equal; prefill
then one ``decode_step`` gives lens 9 and logits within 2e-4 of the
reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_system import ARCHS, SMOKE_OF, make_batch
from repro.configs import get_config
from repro.models import Model as JaxModel
from repro_torch.configs import get_config as torch_get_config
from repro_torch.models import Model
from repro_torch.weights import from_jax_params


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_TREES = {}


def _trees(name):
    """(cfg, reference params, port cfg, port params) of a SMOKE, the
    reference's ``init(PRNGKey(1))`` (``tests/test_system.py``'s),
    converted once."""
    if name not in _TREES:
        cfg = get_config(name)
        jparams = JaxModel(cfg).init(jax.random.PRNGKey(1))
        tcfg = torch_get_config(name)
        tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                                  device="cpu")
        _TREES[name] = (cfg, jparams, tcfg, tparams)
    return _TREES[name]


def _t(a):
    return torch.from_numpy(np.array(a))


def _batch(cfg):
    """``make_batch``'s inputs, without the labels, for both packages."""
    b = {k: v for k, v in make_batch(cfg).items() if k != "labels"}
    return b, {k: _t(v) for k, v in b.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_model_forward_matches_the_reference(arch):
    cfg, jparams, tcfg, tparams = _trees(SMOKE_OF[arch])
    jb, tb = _batch(cfg)
    want, jaux = JaxModel(cfg).forward(jparams, jb)
    model = Model(tcfg)
    got, aux = model.forward(tparams, **tb)
    expect = (2, 16, cfg.n_codebooks, cfg.vocab) if cfg.n_codebooks \
        else (2, 16, cfg.vocab)
    assert tuple(got.shape) == tuple(want.shape) == expect
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=0)
    assert aux.shape == () and aux.dtype == torch.float32
    assert abs(float(aux) - float(jaux)) <= 1e-6
    assert model.param_count(tparams) == JaxModel(cfg).param_count(jparams)
    if cfg.n_codebooks:
        nc, V, d = cfg.n_codebooks, cfg.vocab, cfg.d_model
        assert tparams["embed"].shape == (nc, V, d)
        assert tparams["head"].shape == (nc, d, V)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_after_prefill_matches_the_reference(arch):
    cfg, jparams, tcfg, tparams = _trees(SMOKE_OF[arch])
    toks = np.asarray(make_batch(cfg, S=8)["tokens"])
    jm, tm = JaxModel(cfg), Model(tcfg)
    _, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks)},
                       jm.init_cache(2, 24, jnp.float32))
    _, tc = tm.prefill(tparams, _t(toks), tm.init_cache(2, 24,
                                                        device="cpu"))
    tok = np.zeros((2, 1, cfg.n_codebooks) if cfg.n_codebooks else (2, 1),
                   np.int32)
    want, jc = jm.decode_step(jparams, jnp.asarray(tok), jc)
    got, tc = tm.decode_step(tparams, _t(tok), tc)
    assert torch.isfinite(got).all()
    assert int(tc["lens"][0]) == int(jc["lens"][0]) == 9
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=0)


