"""Training in the port against the JAX reference, on the CPU.

The reference's parameters (``from_jax_params``) and the reference's
batches go through both packages: the masked cross-entropy (with
codebooks), the chunked loss, flash attention's forward and its
recompute-per-block backward (``dq``, ``dk``, ``dv`` against ``jax.vjp``
through the reference's custom VJP, with ``kv_len`` and the block-causal
schedule), kernel 3's autograd rule (``torch.autograd.gradcheck`` in f64,
and against ``jax.grad`` of the reference's ``dense_ffn``), remat,
microbatch accumulation, and the 60-step nectar run of
``tests/test_system.py``'s end-to-end test.

Tolerances: losses and metrics within 1e-6 (the cross-entropy) and 1e-5
(model losses); gradients within 1e-5 relative (Frobenius) for a single
function, attention within 2e-6. The 60-step trajectory: the reference
against itself, jitted and eager on the same host, drifts apart by up
to 1.85e-3 in ``ce`` by step 26 (chaos seeded by the first Adam steps,
whose update is about sign(g) for tiny g), so the port is held within
1e-3 over the first 20 steps and within 5e-3 over all 60.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.core import sparsity as jsparsity
from repro.models import Model as JaxModel
from repro.models import flash as jflash
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro.train import data as jdata
from repro.train import optimizer as jopt
from repro.train.loop import make_train_step as jax_make_train_step
from repro.train.loop import run_training as jax_run_training
from repro_torch.configs import get_config as torch_get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core import sparsity
from repro_torch.kernels import ops
from repro_torch.models import Model, flash, layers, transformer
from repro_torch.train import data, loop
from repro_torch.train import optimizer as opt
from repro_torch.tree import leaves
from repro_torch.weights import from_jax_params

NECTAR = "nectar-relu-llama-1.7m"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(want, got):
    """Relative Frobenius error of ``got`` against ``want``."""
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


_TREES = {}


def _nectar(name=NECTAR):
    """(reference cfg, reference params, port cfg, port params): the
    reference's ``init(PRNGKey(0))``, converted once."""
    if name not in _TREES:
        cfg = get_config(name)
        jp = JaxModel(cfg).init(jax.random.PRNGKey(0))
        tcfg = torch_get_config(name)
        _TREES[name] = (cfg, jp, tcfg, from_jax_params(
            jax.tree.map(np.asarray, jp), tcfg, device="cpu"))
    return _TREES[name]


def _batch(seq=32, batch=4, index=0):
    """A TinyStoriesSynth batch: (numpy, jax, torch)."""
    b = jdata.TinyStoriesSynth(jdata.DataConfig(
        seq_len=seq, batch_size=batch, vocab_size=2048)).batch_at(index)
    return (b, {k: jnp.asarray(v) for k, v in b.items()},
            {k: _t(v) for k, v in b.items()})


# ---------------------------------------------------------------------------
# the loss


@pytest.mark.parametrize("case", ["plain", "mask", "codebooks", "no_weight"])
def test_softmax_cross_entropy_matches_the_reference(case):
    rng = np.random.default_rng(0)
    shape = (2, 5, 3) if case == "codebooks" else (2, 5)
    logits = (rng.standard_normal(shape + (11,)) * 3).astype(np.float32)
    labels = rng.integers(0, 11, shape).astype(np.int32)
    mask = None
    if case != "plain":
        mask = (rng.random(shape) > 0.3).astype(np.float32)
    if case == "no_weight":
        mask = np.zeros(shape, np.float32)      # max(sum, 1) keeps it 0
    want = jlayers.softmax_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask))
    got = layers.softmax_cross_entropy(_t(logits), _t(labels),
                                       None if mask is None else _t(mask))
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - float(want)) <= 1e-6


@pytest.mark.parametrize("token_chunk", [2, 8, 12])
def test_chunked_loss_equals_the_unchunked_one(token_chunk):
    """Chunks of 2, 8 and 12 tokens (12 is cut to 4 chunks of 8 over S
    32, as the reference cuts it) give the one-chunk loss, metrics and
    gradients; the reference's chunked loss agrees."""
    cfg, jp, tcfg, tp = _nectar()
    nb, jb, tb = _batch()
    whole, wm = transformer.loss_fn(tp, tcfg, tb)
    flat = [t.detach().requires_grad_(True) for t in leaves(tp)]
    from repro_torch.tree import unflatten
    got, gm = transformer.loss_fn(unflatten(tp, flat), tcfg, tb,
                                  token_chunk=token_chunk)
    g_chunk = torch.autograd.grad(got, flat)
    got = got.detach()
    _, _, g_whole = loop.value_and_grad(tp, tcfg, tb)
    assert abs(float(got) - float(whole)) <= 1e-6
    for k in wm:
        assert abs(float(gm[k]) - float(wm[k])) <= 1e-6 * max(
            1.0, abs(float(wm[k])))
    for a, b in zip(leaves(g_whole), g_chunk):
        assert _rel(a.numpy(), b.numpy()) <= 1e-6
    want, _ = jtransformer.loss_fn(jp, cfg, jb, token_chunk=token_chunk)
    assert abs(float(got) - float(want)) <= 1e-5


# ---------------------------------------------------------------------------
# flash attention


def _attn_inputs(seed, B, Sq, Skv, Kv, G, Dh):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((B, Sq, Kv, G, Dh), (B, Skv, Kv, Dh), (B, Skv, Kv, Dh))]


def test_blockwise_attention_matches_reference():
    """``tests/test_models.py``'s case: blocks of 8 over 33 positions
    against the plain masked softmax, and against the reference's."""
    q, k, v = _attn_inputs(0, 2, 33, 33, 2, 3, 16)
    out = flash.blockwise_attention(_t(q), _t(k), _t(v), causal=True,
                                    block_kv=8)
    ref = flash.reference_attention(_t(q), _t(k), _t(v), causal=True)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-5,
                               atol=2e-5)
    want = jflash.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=True, block_kv=8)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2e-6,
                               rtol=0)
    np.testing.assert_allclose(
        ref.numpy(), np.asarray(jflash.reference_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)),
        atol=2e-6, rtol=0)


def test_blockwise_attention_kv_len_mask():
    """``tests/test_models.py``'s kv_len case, and a query offset."""
    q, k, v = _attn_inputs(1, 3, 1, 40, 2, 2, 8)
    kv_len = np.array([1, 17, 40], np.int32)
    out = flash.blockwise_attention(_t(q), _t(k), _t(v), causal=False,
                                    kv_len=_t(kv_len), block_kv=16)
    ref = flash.reference_attention(_t(q), _t(k), _t(v), causal=False,
                                    kv_len=_t(kv_len))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=2e-5,
                               atol=2e-5)
    want = jflash.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
        kv_len=jnp.asarray(kv_len), block_kv=16)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2e-6,
                               rtol=0)
    q4 = np.repeat(q, 4, axis=1)
    off = flash.blockwise_attention(_t(q4), _t(k), _t(v), causal=True,
                                    q_offset=7, block_kv=16)
    np.testing.assert_allclose(off.numpy(), flash.reference_attention(
        _t(q4), _t(k), _t(v), causal=True, q_offset=7).numpy(),
        rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("case", ["causal", "kv_len", "block_causal",
                                  "one_block"])
def test_flash_backward_matches_the_reference_vjp(case):
    """dq, dk, dv of the recompute-per-block backward against jax.vjp
    through the reference's custom VJP (and through its block-causal
    schedule), for an upstream gradient drawn from a seed."""
    shapes = {"causal": (2, 33, 33, 2, 3, 16), "kv_len": (3, 20, 20, 2, 2, 8),
              "block_causal": (2, 32, 32, 2, 2, 8),
              "one_block": (1, 12, 12, 1, 4, 32)}[case]
    q, k, v = _attn_inputs(2, *shapes)
    do = np.random.default_rng(3).standard_normal(q.shape).astype(np.float32)
    kv_len = np.array([3, 20, 11][:shapes[0]], np.int32)

    def jfn(q, k, v):
        if case == "block_causal":
            return jflash.block_causal_attention(q, k, v, block_q=8,
                                                 block_kv=8)
        return jflash.blockwise_attention(
            q, k, v, causal=case != "kv_len", block_kv=8,
            kv_len=jnp.asarray(kv_len) if case == "kv_len" else None)

    def tfn(q, k, v):
        if case == "block_causal":
            return flash.block_causal_attention(q, k, v, block_q=8,
                                                block_kv=8)
        return flash.blockwise_attention(
            q, k, v, causal=case != "kv_len", block_kv=8,
            kv_len=_t(kv_len) if case == "kv_len" else None)

    want_o, vjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    out = tfn(tq, tk, tv)
    assert "_Flash" in type(out.grad_fn).__name__ or case == "block_causal"
    got = torch.autograd.grad(out, (tq, tk, tv), _t(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_o),
                               atol=2e-6, rtol=0)
    for name, w, g in zip("qkv", want, got):
        assert _rel(w, g.numpy()) <= 1e-5, name
    # and the plain masked softmax's autograd, the oracle
    tq2, tk2, tv2 = (_t(a).requires_grad_(True) for a in (q, k, v))
    plain = flash.reference_attention(
        tq2, tk2, tv2, causal=case != "kv_len",
        kv_len=_t(kv_len) if case == "kv_len" else None)
    for g, p in zip(got, torch.autograd.grad(plain, (tq2, tk2, tv2),
                                             _t(do))):
        assert _rel(p.numpy(), g.numpy()) <= 1e-5


def test_attention_forward_goes_through_flash():
    """The slot prefill and ``Model.forward`` read attention through
    ``flash.blockwise_attention`` (the one-softmax read is gone), and a
    block-causal config longer than a block takes the lower-triangle
    schedule with the same values."""
    _, _, tcfg, tp = _nectar()
    tokens = _t(np.random.default_rng(4).integers(0, 2048, (2, 24),
                                                  dtype=np.int32))
    calls = []
    real = flash.blockwise_attention

    def spy(*a, **kw):
        calls.append(kw["block_kv"])
        return real(*a, **kw)

    flash.blockwise_attention = spy
    try:
        logits, _ = Model(tcfg).forward(tp, tokens)
        bc = dataclasses.replace(tcfg, block_causal=True)
        p0 = {k: v[0] for k, v in tp["units"]["b0"]["attn"].items()}
        x = torch.randn(2, 24, tcfg.d_model,
                        generator=torch.Generator().manual_seed(0))
        cos, sin = transformer._rope_tables(
            tcfg, transformer._positions(tcfg, torch.zeros(2,
                                         dtype=torch.int32), 24))
        from repro_torch.models import attention
        n = len(calls)
        a = attention.attn_forward(p0, tcfg, x, cos, sin, block_kv=8)
        b = attention.attn_forward(p0, bc, x, cos, sin, block_kv=8)
    finally:
        flash.blockwise_attention = real
    assert calls[:tcfg.n_layers] == [512] * tcfg.n_layers
    assert calls[n:] == [8] + [8] * 3      # one full read, 3 triangle blocks
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-6, rtol=0)
    assert torch.isfinite(logits).all()


# ---------------------------------------------------------------------------
# kernel 3 with a gradient


def test_relu_ffn_function_gradcheck_f64():
    rng = np.random.default_rng(5)
    x, wu, wd = (torch.tensor(rng.standard_normal(s), dtype=torch.float64,
                              requires_grad=True)
                 for s in ((6, 4), (4, 7), (7, 4)))
    assert torch.autograd.gradcheck(ops.relu_ffn_fused, (x, wu, wd))
    out = ops.relu_ffn_fused(x, wu, wd)
    assert type(out.grad_fn).__name__ == "ReluFFNBackward"
    with torch.no_grad():
        assert ops.relu_ffn_fused(x, wu, wd).grad_fn is None


def test_relu_ffn_function_matches_jax_grad_of_dense_ffn():
    """x, W_up and W_down gradients of a cotangent's dot with the FFN,
    against jax.grad of the reference's ``dense_ffn`` (nectar's widths,
    64 rows)."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((64, 128)).astype(np.float32)
    wu = (rng.standard_normal((128, 640)) * 128 ** -0.5).astype(np.float32)
    wd = (rng.standard_normal((640, 128)) * 640 ** -0.5).astype(np.float32)
    dy = rng.standard_normal((64, 128)).astype(np.float32)
    want = jax.grad(lambda a, b, c: jnp.sum(
        jsparsity.dense_ffn(a, b, c) * dy), argnums=(0, 1, 2))(
        *map(jnp.asarray, (x, wu, wd)))
    tx, tu, td = (_t(a).requires_grad_(True) for a in (x, wu, wd))
    out = ops.relu_ffn_fused(tx, tu, td)
    got = torch.autograd.grad(out, (tx, tu, td), _t(dy))
    for w, g in zip(want, got):
        assert _rel(w, g.numpy()) <= 1e-5


def _count_ffn_calls(monkeypatch):
    """Count the calls of kernel 3's device dispatch (``ops._relu_ffn``):
    on the card each is one launch."""
    calls = []
    real = ops._relu_ffn

    def spy(*a):
        calls.append(a[0].shape)
        return real(*a)

    monkeypatch.setattr(ops, "_relu_ffn", spy)
    return calls


def test_training_step_runs_kernel_3_once_per_layer(monkeypatch):
    """A nectar train step calls kernel 3's dispatch 6 times (once a
    layer, in the forward: the backward runs plain products) with the
    training rows (B * S), and every leaf gets a gradient through it."""
    _, _, tcfg, tp = _nectar()
    _, _, tb = _batch(seq=64, batch=8)
    calls = _count_ffn_calls(monkeypatch)
    step = loop.make_train_step(tcfg, TrainConfig(lr=1e-3, warmup_steps=1))
    step(tp, opt.adam_init(tp), tb)
    assert calls == [(512, 128)] * 6


def test_remat_on_and_off_give_equal_gradients(monkeypatch):
    """``cfg.remat`` checkpoints each unit: the backward recomputes the
    unit's forward (kernel 3 dispatched twice a layer), values
    unchanged."""
    _, _, tcfg, tp = _nectar()
    _, _, tb = _batch()
    calls = _count_ffn_calls(monkeypatch)
    l0, m0, g0 = loop.value_and_grad(tp, tcfg, tb)
    assert len(calls) == 6
    l1, m1, g1 = loop.value_and_grad(
        tp, dataclasses.replace(tcfg, remat=True), tb)
    assert len(calls) == 6 + 12
    assert float(l0) == float(l1)
    for a, b in zip(leaves(g0), leaves(g1)):
        assert _rel(a.numpy(), b.numpy()) <= 1e-6


def test_microbatch_two_matches_a_single_batch():
    """``microbatch=2`` against the whole batch: the same loss and
    gradient (Adam's first moment after one step is (1 - b1) g) within
    1e-5, and the reference's microbatched step agrees."""
    cfg, jp, tcfg, tp = _nectar()
    nb, jb, tb = _batch(seq=32, batch=4)
    base = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    outs = {}
    for n in (0, 2):
        step = loop.make_train_step(tcfg, TrainConfig(microbatch=n, **base))
        outs[n] = step(tp, opt.adam_init(tp), tb)
    (_, s0, m0), (_, s2, m2) = outs[0], outs[2]
    assert abs(float(m0["loss"]) - float(m2["loss"])) <= 1e-5
    for a, b in zip(leaves(s0.m), leaves(s2.m)):
        assert _rel(a.numpy(), b.numpy()) <= 1e-5
    jstep = jax_make_train_step(cfg, JaxTrainConfig(microbatch=2, **base))
    _, js, jm = jstep(jp, jopt.adam_init(jp), jb)
    assert abs(float(jm["loss"]) - float(m2["loss"])) <= 1e-5
    assert abs(float(jm["ce"]) - float(m2["ce"])) <= 1e-5
    for a, b in zip(jax.tree.leaves(js.m), leaves(s2.m)):
        assert _rel(a, b.numpy()) <= 1e-4


# ---------------------------------------------------------------------------
# the paper's workload: 60 steps of the 1.7M ReLU-Llama


def test_sixty_step_trajectory_matches_the_reference():
    """``tests/test_system.py::test_e2e_train_reduces_loss_and_develops_
    sparsity`` through both packages from the reference's initial params:
    ``ce`` at every step (see the module docstring for the bars), the
    loss falling below 0.7x, and layer-0 ReLU sparsity above 0.45."""
    cfg, jp, tcfg, tp = _nectar()
    jsrc = jdata.TinyStoriesSynth(jdata.DataConfig(
        seq_len=64, batch_size=8, vocab_size=cfg.vocab))
    src = data.TinyStoriesSynth(data.DataConfig(
        seq_len=64, batch_size=8, vocab_size=tcfg.vocab))
    kw = dict(lr=3e-3, warmup_steps=5, total_steps=60, seed=0)
    _, _, jinfo = jax_run_training(JaxModel(cfg), cfg, JaxTrainConfig(**kw),
                                   jsrc, steps=60, params=jp, log_every=1)
    params, _, info = loop.run_training(
        Model(tcfg), tcfg, TrainConfig(**kw), src, steps=60, params=tp,
        log_every=1, device="cpu")
    want = [m["ce"] for _, m in jinfo["history"]]
    got = [m["ce"] for _, m in info["history"]]
    assert [s for s, _ in info["history"]] == list(range(60))
    assert info["steps_done"] == 60
    diff = [abs(a - b) for a, b in zip(want, got)]
    assert max(diff[:20]) <= 1e-3, diff
    assert max(diff) <= 5e-3, diff
    assert got[-1] < got[0] * 0.7, (got[0], got[-1])
    tokens = _t(src.batch_at(0)["tokens"]).long()
    x = params["embed"][tokens]
    h = layers.rms_norm(x, params["units"]["b0"]["norm2"][0], tcfg.norm_eps)
    hidden = torch.relu(h @ params["units"]["b0"]["ffn"]["w_up"][0])
    frac = float(sparsity.sparsity_fraction(hidden))
    assert frac > 0.45, frac
