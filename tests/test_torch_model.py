"""The port's ``forward_step`` against the JAX reference on the full
nectar-relu-llama-1.7m config, both attention backends, four batch shapes.

Weights come from ``repro.models.transformer.init_params(PRNGKey(0))``,
converted through ``repro_torch.weights.from_jax_params``; the KV pools,
tables and tokens from seeded numpy. Tolerances: logits atol=2e-4,
rtol=1e-4 and pools atol=rtol=1e-4 — six layers of f32 matmuls summed in
another order by each library drift by ~1e-6 relative, well inside them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import Model as JaxModel
from repro_torch.configs import get_config as torch_get_config
from repro_torch.models import Model as TorchModel
from repro_torch.weights import from_jax_params

LOGIT_TOL = dict(atol=2e-4, rtol=1e-4)
POOL_TOL = dict(atol=1e-4, rtol=1e-4)
BS, NB, MB = 8, 40, 8


@pytest.fixture(scope="module")
def nectar():
    cfg = get_config("nectar-relu-llama-1.7m")
    jparams = JaxModel(cfg).init(jax.random.PRNGKey(0))
    tcfg = torch_get_config(cfg.name)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return cfg, jparams, tcfg, tparams


# (S, lens, n_valid, is_prefill): row b writes n_valid[b] tokens at
# positions lens[b]+j; n_valid 0 is an IDLE row
SHAPES = {
    "prefill_chunk": (16, [0, 16, 5], [16, 9, 16], [True, True, True]),
    "decode": (1, [5, 30, 17], [1, 1, 1], [False, False, False]),
    "verify": (5, [7, 21, 2], [5, 3, 5], [False, False, False]),
    "mixed_idle": (16, [3, 25, 0], [16, 1, 0], [True, False, False]),
}


def _inputs(cfg, S, lens, n_valid, seed):
    rng = np.random.default_rng(seed)
    B = len(lens)
    shape = (cfg.n_layers, NB, BS, cfg.n_kv_heads, cfg.d_head)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    tables = np.full((B, MB), NB, np.int32)
    free = list(rng.permutation(NB))
    for b in range(B):
        if n_valid[b]:
            n = -(-(lens[b] + n_valid[b]) // BS)
            tables[b, :n] = [free.pop() for _ in range(n)]
    tokens = rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
    return k, v, tables, tokens


@pytest.mark.parametrize("backend", ["naive", "flash"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_forward_step_matches_reference(nectar, shape, backend):
    cfg, jparams, tcfg, tparams = nectar
    S, lens, n_valid, is_prefill = SHAPES[shape]
    lens, n_valid = np.asarray(lens, np.int32), np.asarray(n_valid, np.int32)
    is_prefill = np.asarray(is_prefill)
    has_prefill = bool(is_prefill.any())
    k, v, tables, tokens = _inputs(cfg, S, lens, n_valid, seed=S)

    jm = JaxModel(cfg)
    jc = jm.init_paged_cache(len(lens), NB, BS, MB, jnp.float32)
    jc["units"]["b0"] = {"k": jnp.asarray(k), "v": jnp.asarray(v)}
    jc["lens"], jc["block_tables"] = jnp.asarray(lens), jnp.asarray(tables)
    jl, jc = jm.forward_step(jparams, jnp.asarray(tokens), jc,
                             jnp.asarray(n_valid), jnp.asarray(is_prefill),
                             BS, backend=backend, has_prefill=has_prefill)

    tm = TorchModel(tcfg)
    tc = tm.init_paged_cache(len(lens), NB, BS, MB, device="cpu")
    tc["units"]["b0"]["k"].copy_(torch.from_numpy(k))
    tc["units"]["b0"]["v"].copy_(torch.from_numpy(v))
    tc["lens"] = torch.from_numpy(lens)
    tc["block_tables"] = torch.from_numpy(tables)
    tl = tm.forward_step(tparams, torch.from_numpy(tokens), tc,
                         torch.from_numpy(n_valid),
                         torch.from_numpy(is_prefill), BS, backend=backend,
                         has_prefill=has_prefill)

    assert tl.shape == (len(lens), S, cfg.vocab)
    jl = np.asarray(jl)
    for b, nv in enumerate(n_valid):
        # only valid positions are defined: padding and IDLE rows read
        # through sentinels, which the two packages fill differently
        np.testing.assert_allclose(tl[b, :nv].numpy(), jl[b, :nv],
                                   **LOGIT_TOL)
    for leaf in ("k", "v"):
        np.testing.assert_allclose(tc["units"]["b0"][leaf].numpy(),
                                   np.asarray(jc["units"]["b0"][leaf]),
                                   **POOL_TOL)


def test_from_jax_params_rejects_a_foreign_layout(nectar):
    cfg, jparams, tcfg, _ = nectar
    tree = jax.tree.map(np.asarray, jparams)
    tree["units"]["b0"]["ffn"]["w_down"] = \
        tree["units"]["b0"]["ffn"]["w_down"][:, :-1]
    with pytest.raises(ValueError, match="w_down"):
        from_jax_params(tree, tcfg, device="cpu")
