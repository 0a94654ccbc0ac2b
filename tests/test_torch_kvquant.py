"""The port's int8 KV cache on the CPU, against the JAX reference.

``kv_cache.quantize_kv`` is held bit for bit (the same per-(token, head)
``amax / 127`` scale and round-half-to-even, divided by tensors), the
byte accounting exactly, and the paged engine's int8 naive serve to the
reference's tokens, identical, on the reference's weights
(``init_params(PRNGKey(0))`` through ``from_jax_params``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs.base import ServeConfig as JaxServeConfig
from repro.models import Model as JaxModel
from repro.serve import kv_cache as jax_kv_cache
from repro.serve import paged_kv as jax_paged_kv
from repro.serve.engine import Engine as JaxEngine
from repro.serve.scheduler import Request as JaxRequest
from repro_torch.configs import get_config as torch_get_config
from repro_torch.configs.base import ServeConfig
from repro_torch.serve import kv_cache, paged_kv
from repro_torch.serve.engine import Engine
from repro_torch.serve.scheduler import Request
from repro_torch.weights import from_jax_params


@pytest.fixture(scope="module")
def nectar():
    cfg = get_config("nectar-relu-llama-1.7m")
    jparams = JaxModel(cfg).init(jax.random.PRNGKey(0))
    tcfg = torch_get_config(cfg.name)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return cfg, jparams, tcfg, tparams


def _kv(seed, shape=(6, 16, 2, 32)):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape)
         * rng.random(shape[:-1] + (1,)) * 10).astype(np.float32)
    x[0, 0, 0] = 0.0                             # an all-zero (token, head)
    x[0, 1, 0, :4] = [127.0, 63.5, -64.5, -127.0]  # exact halves
    return x


@pytest.mark.parametrize("seed", range(4))
def test_quantize_kv_bit_equal_to_reference(seed):
    """int8 values and f32 scales equal the reference's bit for bit,
    zero rows (scale 1) and exact halves (round to even) included; the
    dequantized values too."""
    k, v = _kv(seed), _kv(seed + 100)
    (jk, jks), (jv, jvs) = jax_kv_cache.quantize_kv(jnp.asarray(k),
                                                    jnp.asarray(v))
    (tk, tks), (tv, tvs) = kv_cache.quantize_kv(torch.tensor(k),
                                                torch.tensor(v))
    for got, want in ((tk, jk), (tks, jks), (tv, jv), (tvs, jvs)):
        assert got.dtype == torch.int8 or got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        kv_cache.dequantize_kv(tk, tks, torch.float32).numpy(),
        np.asarray(jax_kv_cache.dequantize_kv(jk, jks, jnp.float32)))


@pytest.mark.parametrize("name", ["nectar-relu-llama-1.7m",
                                  "llama3.2-1b-smoke", "granite-34b-smoke"])
@pytest.mark.parametrize("int8", [False, True])
def test_kv_bytes_per_token_equals_reference(name, int8):
    assert paged_kv.kv_bytes_per_token(torch_get_config(name), int8) \
        == jax_paged_kv.kv_bytes_per_token(get_config(name), int8)


def _prompts(cfg, lengths, seed=0, shared=0):
    rng = np.random.default_rng(seed)
    head = rng.integers(0, cfg.vocab, size=shared, dtype=np.int32)
    return [np.concatenate([head, rng.integers(0, cfg.vocab, size=int(n),
                                               dtype=np.int32)])
            for n in lengths]


def _serve(engine_cls, request_cls, cfg, params, prompts, max_new=8,
           **kw):
    base = dict(paged=True, max_batch=2, max_seq=96, block_size=8,
                prefill_chunk=16, kv_quant=True)
    scfg = dict(base, **kw)
    if engine_cls is Engine:
        eng = Engine(cfg, params, ServeConfig(**scfg), device="cpu")
    else:
        eng = JaxEngine(cfg, params, JaxServeConfig(**scfg))
    done = eng.run([request_cls(rid=i, prompt=p, max_new=max_new)
                    for i, p in enumerate(prompts)], max_steps=2000)
    return {i: [int(t) for t in r.tokens_out] for i, r in done.items()}, eng


def test_int8_paged_serve_tokens_equal_reference(nectar):
    """The paged engine with int8 pools and the naive dequantizing read:
    greedy tokens identical to the reference's int8 engine, the pools
    int8 with f32 scales, and the KV byte counters equal."""
    cfg, jparams, tcfg, tparams = nectar
    prompts = _prompts(cfg, [3, 37, 9, 21], seed=2)
    want, jeng = _serve(JaxEngine, JaxRequest, cfg, jparams, prompts)
    got, eng = _serve(Engine, Request, tcfg, tparams, prompts)
    assert got == want
    leaves = eng.runner.cache["units"]["b0"]
    assert leaves["k"].dtype == torch.int8 and leaves["v"].dtype == torch.int8
    assert leaves["k_scale"].dtype == torch.float32
    assert leaves["k_scale"].shape[-1] == 1
    s, js = eng.metrics.summary(), jeng.metrics.summary()
    assert s["kv_bytes"] == js["kv_bytes"]
    assert s["kv_pool"] == js["kv_pool"]


def test_flash_with_kv_quant_is_refused_as_the_reference_refuses(nectar):
    cfg, jparams, tcfg, tparams = nectar
    kw = dict(paged=True, kv_quant=True, attn_backend="flash")
    with pytest.raises(ValueError) as want:
        JaxEngine(cfg, jparams, JaxServeConfig(**kw))
    with pytest.raises(ValueError) as got:
        Engine(tcfg, tparams, ServeConfig(**kw), device="cpu")
    assert str(got.value) == str(want.value)


def test_prefix_cache_with_int8_kv(nectar):
    """int8 pools share and copy like fp pools (the scale leaves ride
    along in copy_blocks): tokens identical cache on, cache off and in
    the reference, with the reference's hits."""
    cfg, jparams, tcfg, tparams = nectar
    prompts = _prompts(cfg, [5, 7, 6], seed=6, shared=24)
    off, _ = _serve(Engine, Request, tcfg, tparams, prompts)
    on, eng = _serve(Engine, Request, tcfg, tparams, prompts,
                     prefix_cache=True)
    want, jeng = _serve(JaxEngine, JaxRequest, cfg, jparams, prompts,
                        prefix_cache=True)
    assert on == off == want
    assert eng.metrics.prefix_hits == jeng.metrics.prefix_hits >= 1
    assert eng.pool.ref == {} and eng.pool.n_free == eng.pool.n_blocks


def test_copy_blocks_moves_int8_bytes_and_scales(nectar):
    """ModelRunner.copy_blocks copies every leaf of every layer, int8
    values and their scales, and apply_perm permutes them all."""
    _, _, tcfg, tparams = nectar
    eng = Engine(tcfg, tparams, ServeConfig(paged=True, kv_quant=True,
                                            max_batch=2, max_seq=64,
                                            block_size=8), device="cpu")
    leaves = eng.runner.cache["units"]["b0"]
    g = torch.Generator().manual_seed(0)
    for name, leaf in leaves.items():
        if leaf.dtype == torch.int8:
            leaf.copy_(torch.randint(-128, 128, leaf.shape, generator=g,
                                     dtype=torch.int8))
        else:
            leaf.copy_(torch.rand(leaf.shape, generator=g))
    before = {k: v.clone() for k, v in leaves.items()}
    eng.runner.copy_blocks([(3, 5), (0, 1)])
    for k, v in leaves.items():
        assert torch.equal(v[:, 5], before[k][:, 3])
        assert torch.equal(v[:, 1], before[k][:, 0])
        assert torch.equal(v[:, 2], before[k][:, 2])
    perm = np.roll(np.arange(eng.pool.n_blocks), 3)
    mid = {k: v.clone() for k, v in leaves.items()}
    eng.runner.apply_perm(perm)
    for k, v in leaves.items():
        assert torch.equal(v, mid[k][:, torch.as_tensor(perm).long()])
