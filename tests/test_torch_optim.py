"""The port's optimizer, int8 codec, data, checkpoints and fault handling
against the JAX reference, on the CPU.

The cases of ``tests/test_substrate.py`` (Adam8 tracking fp32 Adam, the
clip, int8 compression and error feedback, checkpoint round trip and GC,
bit-exact resume, deterministic seekable data, stragglers, restarts, the
preemption guard) run through the port; then the port against the
reference: ``adam_update`` and ``adam8_update`` after 5 steps within
1e-6 (int8 codes within one step), the codec's codes and scales equal,
``TinyStoriesSynth`` batches bit-equal, checkpoints restored across the
packages (a reference run resumed in the port), the sparsity measures of
``core/sparsity.py``'s training side, and ``python -m
repro_torch.launch.train --device cpu`` for 3 steps and a resume.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.core import sparsity as jsparsity
from repro.dist import compression as jcompression
from repro.models import Model as JaxModel
from repro.train import checkpoint as jcheckpoint
from repro.train import data as jdata
from repro.train import optimizer as jopt
from repro.train.loop import make_train_step as jax_make_train_step
from repro_torch.configs import get_config as torch_get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core import sparsity
from repro_torch.dist import compression
from repro_torch.launch import train as train_cli
from repro_torch.models import Model
from repro_torch.train import checkpoint, data, fault
from repro_torch.train import optimizer as opt
from repro_torch.train.loop import run_training
from repro_torch.tree import leaves
from repro_torch.weights import from_jax_opt_state, from_jax_params

ROOT = Path(__file__).resolve().parents[1]
NECTAR = "nectar-relu-llama-1.7m"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# tests/test_substrate.py's cases through the port


def _quad_problem():
    target = _t(jax.random.normal(jax.random.PRNGKey(0), (64, 32)))
    params = {"w": torch.zeros((64, 32))}

    def loss(p):
        return torch.mean((p["w"] - target) ** 2)

    def grad(p):
        w = p["w"].clone().requires_grad_(True)
        return {"w": torch.autograd.grad(loss({"w": w}), w)[0]}

    return params, loss, grad


def test_adam8_tracks_adam_fp32():
    params, loss, grad = _quad_problem()
    tcfg = TrainConfig(lr=1e-2, warmup_steps=0, total_steps=200,
                       weight_decay=0.0)
    p32, s32 = dict(params), opt.adam_init(params)
    p8, s8 = dict(params), opt.adam8_init(params)
    for _ in range(50):
        p32, s32 = opt.adam_update(p32, grad(p32), s32, tcfg)
        p8, s8 = opt.adam8_update(p8, grad(p8), s8, tcfg)
    l32, l8 = float(loss(p32)), float(loss(p8))
    assert l8 < 0.9 * float(loss(params))
    assert abs(l8 - l32) / max(l32, 1e-9) < 0.2, (l32, l8)
    # int8 moments: 2 bytes a parameter and 8 bytes of scales a block
    assert opt.state_bytes(s8) == 4 + 2 * (64 * 32 + 8 * 4)
    assert opt.state_bytes(s32) == 4 + 2 * 4 * 64 * 32


def test_grad_clip_global_norm():
    g = {"a": torch.ones(10) * 10}
    clipped, gn = opt.clip_by_global_norm(g, 1.0)
    assert abs(float(torch.linalg.norm(clipped["a"])) - 1.0) < 1e-5
    assert float(gn) > 30
    small, _ = opt.clip_by_global_norm({"a": torch.ones(4) * 0.1}, 1.0)
    assert torch.equal(small["a"], torch.ones(4) * 0.1)


@pytest.mark.parametrize("seed", [0, 1, 7, 123, 65535])
def test_int8_compression_bounded_error(seed):
    x = _t(jax.random.normal(jax.random.PRNGKey(seed), (1000,))) * 3
    y = compression.compress_roundtrip(x)
    pad = (-x.numel()) % compression.BLOCK
    blocks = torch.nn.functional.pad(x, (0, pad)).reshape(-1, 256)
    bound = blocks.abs().amax(dim=1) / 127.0
    err = torch.nn.functional.pad((y - x).abs(), (0, pad)).reshape(-1, 256)
    assert bool((err.amax(dim=1) <= bound * 0.5 + 1e-7).all())


def test_error_feedback_accumulates_residual():
    g = {"w": torch.ones(512) * 1e-4}
    r = compression.init_residuals(g)
    total = torch.zeros(512)
    for _ in range(50):
        comp, r = compression.ef_compress_tree(g, r)
        total = total + comp["w"]
    np.testing.assert_allclose(total.numpy(), (g["w"] * 50).numpy(),
                               rtol=0.05)


def test_compression_ratio_about_quarter():
    assert compression.compression_ratio(torch.zeros(10000)) < 0.27


def test_checkpoint_roundtrip_and_gc(tmp_path):
    state = {"params": {"w": torch.arange(12.0).reshape(3, 4),
                        "h": torch.arange(6.0).to(torch.bfloat16)},
             "step": torch.tensor(7, dtype=torch.int32)}
    for s in (1, 2, 3, 4):
        checkpoint.save(str(tmp_path), s, state, data_cursor=s * 10, keep=2)
    assert checkpoint.latest_step(str(tmp_path)) == 4
    restored, man = checkpoint.restore(str(tmp_path), 4, state,
                                       device="cpu")
    assert torch.equal(restored["params"]["w"], state["params"]["w"])
    assert restored["params"]["h"].dtype == torch.bfloat16
    assert torch.equal(restored["params"]["h"], state["params"]["h"])
    assert restored["step"].dtype == torch.int32 and int(restored["step"]) == 7
    assert man["data_cursor"] == 40
    assert man["dtypes"] == ["bfloat16", "float32", "int32"]
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000004"]
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.restore(str(tmp_path), 4, {"w": state["step"]},
                           device="cpu")


def _nectar_run(steps, src, tcfg, **kw):
    cfg = torch_get_config(NECTAR)
    return run_training(Model(cfg), cfg, tcfg, src, steps=steps,
                        device="cpu", **kw)


def test_train_resume_is_bit_exact(tmp_path):
    """6 steps straight against 3 + checkpoint + restore + 3."""
    tcfg = TrainConfig(lr=1e-3, warmup_steps=2, total_steps=6, seed=0)
    src = data.TinyStoriesSynth(data.DataConfig(seq_len=32, batch_size=2,
                                                vocab_size=2048))
    pA, oA, _ = _nectar_run(6, src, tcfg)
    pB, oB, _ = _nectar_run(3, src, tcfg)
    checkpoint.save(str(tmp_path), 3, {"p": pB, "o": oB}, data_cursor=3)
    restored, man = checkpoint.restore(str(tmp_path), 3, {"p": pB, "o": oB},
                                       device="cpu")
    pC, oC, info = _nectar_run(6, src, tcfg, params=restored["p"],
                               opt_state=restored["o"],
                               start_step=man["data_cursor"])
    assert info["steps_done"] == 3
    for a, c in zip(leaves(pA) + leaves(oA), leaves(pC) + leaves(oC)):
        assert torch.equal(a, c)


def test_data_deterministic_and_seekable():
    src = data.TinyStoriesSynth(data.DataConfig(seq_len=64, batch_size=4))
    b1 = src.batch_at(17)
    b2 = data.TinyStoriesSynth(data.DataConfig(seq_len=64,
                                               batch_size=4)).batch_at(17)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert b1["tokens"].shape == (4, 64)
    assert b1["tokens"].max() < data.VOCAB_SIZE
    assert not np.array_equal(src.batch_at(0)["tokens"],
                              src.batch_at(1)["tokens"])
    assert data.resume_cursor(5, grad_accum=4) == 20


def test_straggler_detector_flags_slow_host():
    det = fault.StragglerDetector(n_hosts=8, threshold=1.5)
    for _ in range(20):
        times = [1.0] * 8
        times[3] = 2.5
        flagged = det.observe(times)
    assert flagged == [3]


def test_restart_policy_retries_then_succeeds():
    calls = {"n": 0}

    def flaky(attempt):
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("node died")
        return 42

    assert fault.RestartPolicy(max_restarts=5, backoff_s=0.0).run(flaky) == 42
    assert calls["n"] == 3
    with pytest.raises(RuntimeError):
        fault.RestartPolicy(max_restarts=1, backoff_s=0.0).run(
            lambda a: (_ for _ in ()).throw(RuntimeError("down")))


def test_preemption_guard_checkpoints_midway():
    tcfg = TrainConfig(lr=1e-3, warmup_steps=1, total_steps=10, seed=0)
    src = data.TinyStoriesSynth(data.DataConfig(seq_len=16, batch_size=2,
                                                vocab_size=2048))
    guard = fault.PreemptionGuard()
    saved = {}

    def on_ckpt(step, params, opt_state):
        saved["step"] = step

    guard.should_stop = True
    _, _, info = _nectar_run(10, src, tcfg, guard=guard,
                             on_checkpoint=on_ckpt)
    assert info["steps_done"] == 1 and saved["step"] == 1


def test_preemption_guard_handles_sigterm():
    """The handler flips the flag; the previous handlers come back."""
    import signal
    before = (signal.getsignal(signal.SIGTERM),
              signal.getsignal(signal.SIGINT))
    try:
        guard = fault.PreemptionGuard().install()
        assert guard.install() is guard
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.should_stop
    finally:
        signal.signal(signal.SIGTERM, before[0])
        signal.signal(signal.SIGINT, before[1])


# ---------------------------------------------------------------------------
# the port against the reference


def _opt_trees(seed):
    """A small params tree with leaves off the 256 block (and a vector,
    which takes no decay), and 5 gradients, each from a seed."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (40, 24), "b": (24,), "n": {"x": (3, 300)}}

    def draw(s):
        return {k: draw(v) if isinstance(v, dict)
                else rng.standard_normal(v).astype(np.float32)
                for k, v in s.items()}

    return draw(shapes), [draw(shapes) for _ in range(5)]


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else _t(v)
            for k, v in tree.items()}


def _close(want_tree, got_tree, **tol):
    for w, g in zip(jax.tree.leaves(want_tree), leaves(got_tree)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


@pytest.mark.parametrize("eight_bit", [False, True])
def test_adam_updates_match_the_reference(eight_bit):
    """5 steps of AdamW (warm-up 2 of 10 steps, decay 0.1) from the same
    params and gradients: params and moments within 1e-6, the int8 codes
    within one step and the scales within 1e-6."""
    params, grads = _opt_trees(0)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1)
    jinit, jupd = jopt.make_optimizer(JaxTrainConfig(adam_8bit=eight_bit,
                                                     **kw))
    tcfg = TrainConfig(adam_8bit=eight_bit, **kw)
    init, upd = opt.make_optimizer(tcfg)
    jp, tp = _jax(params), _torch(params)
    js, ts = jinit(jp), init(tp)
    for g in grads:
        jp, js = jupd(jp, _jax(g), js, JaxTrainConfig(adam_8bit=eight_bit,
                                                      **kw))
        tp, ts = upd(tp, _torch(g), ts, tcfg)
        assert float(opt.lr_schedule(tcfg, ts.step)) == pytest.approx(
            float(jopt.lr_schedule(JaxTrainConfig(**kw), js.step)),
            rel=1e-7, abs=0)
    assert int(ts.step) == int(js.step) == 5
    _close(jp, tp, rtol=1e-6, atol=1e-6)
    if not eight_bit:
        _close(js.m, ts.m, rtol=1e-6, atol=1e-7)
        _close(js.v, ts.v, rtol=1e-6, atol=1e-7)
        return
    for f in ("m_q", "v_q"):
        for w, g in zip(jax.tree.leaves(getattr(js, f)),
                        leaves(getattr(ts, f))):
            assert g.dtype == torch.int8
            assert np.abs(g.numpy().astype(int)
                          - np.asarray(w).astype(int)).max() <= 1
    _close(js.m_s, ts.m_s, rtol=1e-6, atol=0)
    _close(js.v_s, ts.v_s, rtol=1e-6, atol=0)


def test_int8_codec_matches_the_reference():
    """Codes and scales equal, half-way quotients rounded to even, and
    the decode of both packages' codes equal."""
    x = (np.random.default_rng(2).standard_normal(1000) * 3).astype(
        np.float32)
    x[:4] = [127.0, 0.5, 1.5, -2.5]           # scale 1: 0.5 -> 0, 1.5 -> 2
    x[256:512] = 0.0                           # an all-zero block: scale 1
    jq, js = jcompression.encode_int8(jnp.asarray(x))
    q, s = compression.encode_int8(_t(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q[0, :4].tolist() == [127, 0, 2, -2]
    np.testing.assert_array_equal(
        compression.decode_int8(q, s, (1000,), 1000).numpy(),
        np.asarray(jcompression.decode_int8(jq, js, (1000,), 1000)))


@pytest.mark.parametrize("seq,batch,index", [(64, 8, 0), (64, 8, 59),
                                             (32, 2, 3), (128, 16, 1000)])
def test_data_batches_are_bit_equal_to_the_reference(seq, batch, index):
    want = jdata.TinyStoriesSynth(jdata.DataConfig(
        seq_len=seq, batch_size=batch, vocab_size=2048)).batch_at(index)
    got = data.TinyStoriesSynth(data.DataConfig(
        seq_len=seq, batch_size=batch, vocab_size=2048)).batch_at(index)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert data.VOCAB == jdata.VOCAB


def _reference_run(steps, eight_bit=False):
    """The reference's nectar params and optimizer state after ``steps``
    jitted train steps on TinyStoriesSynth batches."""
    cfg = get_config(NECTAR)
    jt = JaxTrainConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                        adam_8bit=eight_bit)
    init, _ = jopt.make_optimizer(jt)
    jp = JaxModel(cfg).init(jax.random.PRNGKey(0))
    js = init(jp)
    step = jax.jit(jax_make_train_step(cfg, jt))
    src = jdata.TinyStoriesSynth(jdata.DataConfig(seq_len=16, batch_size=2,
                                                  vocab_size=cfg.vocab))
    for i in range(steps):
        jp, js, _ = step(jp, js, {k: jnp.asarray(v)
                                  for k, v in src.batch_at(i).items()})
    return jp, js


@pytest.mark.parametrize("eight_bit", [False, True])
def test_reference_checkpoint_restores_in_the_port(tmp_path, eight_bit):
    """A reference training checkpoint ({"params", "opt"}) restores in the
    port into the structure ``launch.train`` resumes with, equal to
    ``from_jax_params`` / ``from_jax_opt_state`` of the same state; the
    port then saves it, and the reference restores the port's file to
    the same arrays."""
    jp, js = _reference_run(2, eight_bit)
    jcheckpoint.save(str(tmp_path / "ref"), 2, {"params": jp, "opt": js},
                     data_cursor=2)
    tcfg = torch_get_config(NECTAR)
    like = train_cli.like_state(Model(tcfg), TrainConfig(adam_8bit=eight_bit))
    state, man = checkpoint.restore(str(tmp_path / "ref"), 2, like,
                                    device="cpu")
    assert man["data_cursor"] == 2 and man["n_leaves"] == len(leaves(like))
    want_p = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    want_o = from_jax_opt_state(jax.tree.map(np.asarray, js), tcfg,
                                device="cpu")
    assert type(state["opt"]) is type(want_o)
    for a, b in zip(leaves(state), leaves({"params": want_p,
                                           "opt": want_o})):
        assert a.dtype == b.dtype and torch.equal(a, b)
    checkpoint.save(str(tmp_path / "port"), 2, state, data_cursor=2)
    back, man2 = jcheckpoint.restore(str(tmp_path / "port"), 2,
                                     {"params": jp, "opt": js})
    assert set(man2) == set(man)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(
            {"params": jp, "opt": js})):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_reference_run_resumes_in_the_port():
    """3 reference steps, then 1 step in the port from the converted
    state, against a 4th reference step: the same loss, and params within
    1e-5 relative."""
    jp, js = _reference_run(3)
    cfg = get_config(NECTAR)
    jt = JaxTrainConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    src = jdata.TinyStoriesSynth(jdata.DataConfig(seq_len=16, batch_size=2,
                                                  vocab_size=cfg.vocab))
    b = src.batch_at(3)
    jp4, _, jm = jax.jit(jax_make_train_step(cfg, jt))(
        jp, js, {k: jnp.asarray(v) for k, v in b.items()})
    tcfg = torch_get_config(NECTAR)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    ts = from_jax_opt_state(jax.tree.map(np.asarray, js), tcfg, device="cpu")
    assert int(ts.step) == 3
    from repro_torch.train.loop import make_train_step
    tp4, ts4, tm = make_train_step(tcfg, TrainConfig(
        lr=1e-3, warmup_steps=1, total_steps=10))(
        tp, ts, {k: _t(v) for k, v in b.items()})
    assert int(ts4.step) == 4
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5
    for w, g in zip(jax.tree.leaves(jp4), leaves(tp4)):
        w = np.asarray(w)
        assert np.linalg.norm(g.numpy() - w) <= 1e-5 * np.linalg.norm(w)


def test_from_jax_opt_state_checks_the_layout():
    tcfg = torch_get_config(NECTAR)
    jp = JaxModel(get_config(NECTAR)).init(jax.random.PRNGKey(0))
    js = jax.tree.map(np.asarray, jopt.adam_init(jp))
    bad = js._replace(m=dict(js.m, embed=js.m["embed"][:5]))
    with pytest.raises(ValueError, match="embed"):
        from_jax_opt_state(bad, tcfg, device="cpu")
    with pytest.raises(TypeError):
        from_jax_opt_state({"step": 0}, tcfg, device="cpu")


def test_sparsity_training_side_matches_the_reference():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((6, 16)).astype(np.float32)
    wu, wg = (rng.standard_normal((16, 40)).astype(np.float32)
              for _ in range(2))
    wd = rng.standard_normal((40, 16)).astype(np.float32)
    h = np.maximum(x @ wu, 0)
    assert sparsity.relufy_act("silu") == jsparsity.relufy_act("silu")
    # the mean of 0/1 values: f32 sums in another order, an ulp apart
    assert float(sparsity.sparsity_fraction(_t(h))) == pytest.approx(
        float(jsparsity.sparsity_fraction(jnp.asarray(h))), rel=1e-6)
    assert float(sparsity.sparsity_fraction(_t(h), eps=0.5)) == \
        pytest.approx(float(jsparsity.sparsity_fraction(jnp.asarray(h),
                                                        eps=0.5)), rel=1e-6)
    np.testing.assert_array_equal(
        sparsity.threshold_mask(_t(h), 0.3).numpy(),
        np.asarray(jsparsity.threshold_mask(jnp.asarray(h), 0.3)))
    for gate, act, tau in ((None, "relu", 0.0), (wg, "silu", 0.2)):
        want = jsparsity.masked_dense_ffn(
            *map(jnp.asarray, (x, wu, wd)), act=act,
            w_gate=None if gate is None else jnp.asarray(gate), tau=tau)
        got = sparsity.masked_dense_ffn(
            _t(x), _t(wu), _t(wd), act=act,
            w_gate=None if gate is None else _t(gate), tau=tau)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                                   rtol=1e-5)
    for args in ((128, 640, 4.0, False, 0.25), (2048, 8192, 2.0, True)):
        assert sparsity.ffn_weight_bytes(*args) == \
            jsparsity.ffn_weight_bytes(*args)
    stats, jstats = (sparsity.SparsityStats.init(3, decay=0.9, device="cpu"),
                     jsparsity.SparsityStats.init(3, decay=0.9))
    for fr in ([0.5, 0.6, 0.7], [0.9, 0.1, 0.4], [0.2, 0.2, 0.2]):
        stats = stats.update(torch.tensor(fr))
        jstats = jstats.update(jnp.asarray(fr, jnp.float32))
    np.testing.assert_allclose(stats.ema.numpy(), np.asarray(jstats.ema),
                               rtol=1e-6)
    assert int(stats.count) == int(jstats.count) == 3


def test_train_cli_trains_then_resumes(tmp_path):
    """``python -m repro_torch.launch.train --device cpu``: 3 steps with
    checkpoints every 2; a run asking for the other optimizer's state
    fails to restore (its restarts too) and exits non-zero; a run to 5
    steps resumes from the newest checkpoint (step 2) and trains steps 2
    to 4."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    ckpt = str(tmp_path / "ckpt")
    base = [sys.executable, "-m", "repro_torch.launch.train", "--device",
            "cpu", "--seq", "16", "--batch", "2", "--ckpt-dir", ckpt,
            "--checkpoint-every", "2"]
    first = subprocess.run(base + ["--steps", "3"], capture_output=True,
                           text=True, env=env, timeout=600, check=True)
    assert "[train] checkpoint @ 2" in first.stdout
    assert checkpoint.latest_step(ckpt) == 2
    out = json.loads(first.stdout[first.stdout.index("{"):])
    assert out["steps_done"] == 3 and out["final"][0] == 2
    second = subprocess.run(base + ["--steps", "5", "--adam-8bit"],
                            capture_output=True, text=True, env=env,
                            timeout=600)
    # a checkpoint of fp32 Adam does not restore into 8-bit Adam's state
    assert second.returncode != 0 and "leaves" in second.stderr
    third = subprocess.run(base + ["--steps", "5"], capture_output=True,
                           text=True, env=env, timeout=600, check=True)
    assert "[train] resumed from step 2" in third.stdout
    out = json.loads(third.stdout[third.stdout.index("{"):])
    assert out["start_step"] == 2 and out["steps_done"] == 3
    assert out["final"][0] == 4 and np.isfinite(out["final"][1]["ce"])
    assert checkpoint.latest_step(ckpt) == 4
