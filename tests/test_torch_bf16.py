"""bf16 configs in the port, on the CPU, against the JAX reference.

* ``from_jax_params`` carries the reference's bf16 trees across with each
  leaf's own dtype (bf16, and f32 where the reference keeps f32: Mamba2's
  ``A_log``, ``dt_bias`` and ``D``, the xLSTM gate biases), values exact.
* ``project_logits`` returns f32 logits summed from the bf16 operands'
  values, as the reference's ``preferred_element_type=jnp.float32`` does,
  never rounded to bf16; f32 models multiply as before, bit for bit.
* A bf16 SMOKE served through both packages is judged by ROADMAP §3's
  bf16 rule. Both packages are held to the f32 forward of the same
  bf16-rounded weights: the reference's own bf16 error there (its largest
  and mean |logit - f32 logit| over the served positions, measured here:
  about 0.04 / 0.006 on llama3.2-1b-smoke, 0.07 / 0.013 on zamba2-smoke)
  bounds the port's, with BF16_SLACK for the other rounding order of the
  port's bf16 ops (the port measured 0.041 / 0.006 and 0.085 / 0.013).
  Tokens are compared where the f32 forward's top-2 margin exceeds twice
  the reference's largest error; below it a bf16 rounding on either side
  may flip the argmax.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs.base import ServeConfig as JaxServeConfig
from repro.models import Model as JaxModel
from repro.models import transformer as jax_transformer
from repro.serve.engine import Engine as JaxEngine
from repro.serve.scheduler import Request as JaxRequest
from repro_torch.configs import get_config as torch_get_config
from repro_torch.configs.base import ServeConfig
from repro_torch.models import Model, transformer
from repro_torch.serve.engine import Engine
from repro_torch.serve.scheduler import Request
from repro_torch.weights import from_jax_params

# the port's bf16 error against the f32 forward may exceed the reference's
# by this factor (max) and BF16_MEAN_SLACK (mean)
BF16_SLACK = 1.5
BF16_MEAN_SLACK = 1.25
LENGTHS = [5, 37, 9, 60, 3, 21]


def _bf16(name):
    return (dataclasses.replace(get_config(name), dtype="bfloat16"),
            dataclasses.replace(torch_get_config(name), dtype="bfloat16"))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("name", ["llama3.2-1b-smoke", "zamba2-smoke",
                                  "xlstm-smoke"])
def test_from_jax_params_keeps_each_leafs_dtype(name):
    cfg, tcfg = _bf16(name)
    jparams = jax.tree.map(np.asarray, JaxModel(cfg).init(
        jax.random.PRNGKey(0)))
    tparams = from_jax_params(jparams, tcfg, device="cpu")
    want = dict(_leaves(jparams))
    got = dict(_leaves(tparams))
    assert set(got) == set(want)
    dtypes = set()
    for key, leaf in want.items():
        assert str(got[key].dtype) == f"torch.{leaf.dtype}", key
        np.testing.assert_array_equal(got[key].float().numpy(),
                                      leaf.astype(np.float32))
        dtypes.add(str(leaf.dtype))
    assert "bfloat16" in dtypes
    # the port's own init keeps the same layout (from_jax_params checks
    # every leaf's dtype against it)
    own = Model(tcfg).init(torch.Generator().manual_seed(0), device="cpu")
    assert {k: str(v.dtype) for k, v in _leaves(own)} \
        == {k: str(v.dtype) for k, v in _leaves(tparams)}
    if name == "zamba2-smoke":
        for leaf in ("A_log", "dt_bias", "D"):
            assert tparams["units"]["b0"]["mamba"][leaf].dtype \
                == torch.float32
        assert tparams["units"]["b0"]["mamba"]["w_in"].dtype \
            == torch.bfloat16
    if name == "xlstm-smoke":
        assert tparams["units"]["b0"]["b_if"].dtype == torch.float32
        assert tparams["units"]["b1"]["b_zifo"].dtype == torch.float32
        assert tparams["units"]["b1"]["R"]["z"].dtype == torch.bfloat16


def test_from_jax_params_rejects_a_leaf_of_another_dtype():
    cfg, tcfg = _bf16("zamba2-smoke")
    jparams = jax.tree.map(np.asarray, JaxModel(cfg).init(
        jax.random.PRNGKey(0)))
    mamba = jparams["units"]["b0"]["mamba"]
    mamba["A_log"] = mamba["A_log"].astype(jnp.bfloat16)
    with pytest.raises(ValueError, match="A_log"):
        from_jax_params(jparams, tcfg, device="cpu")


@pytest.mark.parametrize("name", ["llama3.2-1b-smoke", "zamba2-smoke"])
def test_project_logits_sums_bf16_operands_in_f32(name):
    """Tied (llama3.2-1b-smoke) and untied (zamba2-smoke) vocab matrices:
    f32 logits within 1e-5 of the reference's (the same exact products
    summed in another order), off the bf16 grid; the f32 config's logits
    are the plain f32 product, bit for bit."""
    cfg, tcfg = _bf16(name)
    jparams = JaxModel(cfg).init(jax.random.PRNGKey(1))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    x = np.random.default_rng(2).standard_normal(
        (3, 5, cfg.d_model)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(np.asarray(xb, np.float32)).to(torch.bfloat16)
    want = np.asarray(jax_transformer.project_logits(jparams, cfg, xb))
    got = transformer.project_logits(tparams, tcfg, xt)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    on_grid = got == got.to(torch.bfloat16).float()
    assert on_grid.float().mean() < 0.01
    # a vocab wider than one widened slice takes several slices
    old = transformer._LOGIT_SLICE
    transformer._LOGIT_SLICE = 3 * cfg.d_model
    try:
        sliced = transformer.project_logits(tparams, tcfg, xt)
    finally:
        transformer._LOGIT_SLICE = old
    np.testing.assert_allclose(sliced.numpy(), got.numpy(), atol=1e-5,
                               rtol=1e-5)
    f32 = torch_get_config(name)
    fparams = {k: v.float() if torch.is_tensor(v) else v
               for k, v in tparams.items() if k in ("embed", "head")}
    xf = torch.from_numpy(x)
    w = fparams["embed"].t() if f32.tie_embeddings else fparams["head"]
    assert torch.equal(transformer.project_logits(fparams, f32, xf), xf @ w)


def _prompts(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, size=int(n), dtype=np.int32)
            for n in LENGTHS]


def _f32_logits(cfg, jparams_f32, seq):
    """The f32 forward's logits f32[S, V] of one token stream."""
    logits, _ = JaxModel(dataclasses.replace(cfg, dtype="float32")).forward(
        jparams_f32, {"tokens": jnp.asarray(seq[None])})
    return np.asarray(logits, np.float32)[0]


@pytest.mark.parametrize("name,paged", [("llama3.2-1b-smoke", False),
                                        ("llama3.2-1b-smoke", True),
                                        ("zamba2-smoke", False)])
def test_bf16_smoke_served_through_both_packages(name, paged):
    """Six prompts, eight greedy tokens each, through the reference's
    engine and the port's (slot or paged) in bf16. On the token streams
    the reference served: the port's bf16 logits against the f32 forward
    of the same rounded weights, within BF16_SLACK of the reference's own
    bf16 error; then each request's tokens, which may part only where the
    f32 forward's top-2 margin is within twice that error."""
    cfg, tcfg = _bf16(name)
    jparams = JaxModel(cfg).init(jax.random.PRNGKey(0))
    jparams_f32 = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    kw = dict(paged=paged, max_batch=3, max_seq=96, block_size=8,
              prefill_chunk=16)
    prompts = _prompts(cfg)
    jdone = JaxEngine(cfg, jparams, JaxServeConfig(**kw)).run(
        [JaxRequest(rid=i, prompt=p, max_new=8)
         for i, p in enumerate(prompts)], max_steps=1000)
    tdone = Engine(tcfg, tparams, ServeConfig(**kw), device="cpu").run(
        [Request(rid=i, prompt=p, max_new=8)
         for i, p in enumerate(prompts)], max_steps=1000)
    want = {i: [int(t) for t in r.tokens_out] for i, r in jdone.items()}
    got = {i: [int(t) for t in r.tokens_out] for i, r in tdone.items()}
    assert set(got) == set(want)

    ref_err, port_err, f32 = [], [], {}
    for i, p in enumerate(prompts):
        seq = np.concatenate([p, np.asarray(want[i], np.int32)])
        f32[i] = _f32_logits(cfg, jparams_f32, seq)
        jl, _ = JaxModel(cfg).forward(jparams, {"tokens": jnp.asarray(
            seq[None])})
        hidden, _, _ = transformer.forward(tparams, tcfg,
                                           torch.from_numpy(seq[None]))
        tl = transformer.project_logits(tparams, tcfg, hidden)[0].numpy()
        served = slice(len(p) - 1, len(seq) - 1)
        ref_err.append(np.abs(np.asarray(jl, np.float32)[0]
                              - f32[i])[served].ravel())
        port_err.append(np.abs(tl - f32[i])[served].ravel())
    ref_err, port_err = np.concatenate(ref_err), np.concatenate(port_err)
    assert ref_err.max() > 0        # bf16 rounds: the reference has error
    assert port_err.max() <= BF16_SLACK * ref_err.max(), \
        (port_err.max(), ref_err.max())
    assert port_err.mean() <= BF16_MEAN_SLACK * ref_err.mean(), \
        (port_err.mean(), ref_err.mean())

    bound = 2 * ref_err.max()
    for i, p in enumerate(prompts):
        w, g = want[i], got[i]
        step = next((s for s, (a, b) in enumerate(zip(w, g)) if a != b),
                    None)
        if step is None:
            assert len(w) == len(g)
            continue
        z = np.sort(f32[i][len(p) - 1 + step])
        margin = float(z[-1] - z[-2])
        assert margin <= bound, (
            f"request {i} parts at token {step}: reference "
            f"{w[step:step + 3]} port {g[step:step + 3]}, f32 top-2 margin "
            f"{margin} > {bound}")
