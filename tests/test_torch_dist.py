"""The port's distribution layer against the reference's, on the CPU.

Meshes are ``["cpu"] * n`` (launch.mesh: one controller, n shards). The
inputs are ``tests/dist_worker.py``'s shapes, seeded with numpy:

  * ``lse_combine_decode_attention`` and ``ring_attention`` against
    ``repro.models.flash.reference_attention`` at that file's tolerances
    (2e-5, 3e-5), and against the reference's own collectives run once
    in a subprocess under 8 forced host devices (this file runs itself as
    that script), within 2e-5;
  * ``hierarchical_grad_allreduce`` on a (pod 2, data 2, model 2) mesh;
  * the sharded train step (``compile_train_step``) on a (data 2,
    model 4) mesh against the port's unsharded ``make_train_step`` and
    the reference's single-device step, fp32 and 8-bit Adam;
  * ``reshard_params`` round trips, ``degrade_mesh``, and the fleet's
    ``reshard_surviving``.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/dist_worker.py's shapes
LSE = dict(B=2, Kv=2, G=2, Dh=16, S=64, kv_len=[13, 64])
RING = dict(B=1, S=64, Kv=2, G=2, Dh=16)


def _inputs():
    """The collectives' inputs, f32 numpy, from one seeded generator."""
    rng = np.random.default_rng(0)
    p = LSE
    lse = (rng.standard_normal((p["B"], p["Kv"], p["G"], p["Dh"])),
           rng.standard_normal((p["B"], p["S"], p["Kv"], p["Dh"])),
           rng.standard_normal((p["B"], p["S"], p["Kv"], p["Dh"])),
           np.asarray(p["kv_len"], np.int32))
    r = RING
    ring = (rng.standard_normal((r["B"], r["S"], r["Kv"], r["G"], r["Dh"])),
            rng.standard_normal((r["B"], r["S"], r["Kv"], r["Dh"])),
            rng.standard_normal((r["B"], r["S"], r["Kv"], r["Dh"])))
    f32 = lambda a: a.astype(np.float32)  # noqa: E731
    return (tuple(f32(a) for a in lse[:3]) + (lse[3],),
            tuple(f32(a) for a in ring))


def _reference_collectives(out_path):
    """Run as a script under 8 forced host devices: the reference's
    collectives on ``_inputs()``, saved to ``out_path``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.dist import collectives
    from repro.dist.ring import ring_attention
    from repro.launch.mesh import make_mesh
    assert jax.device_count() == 8, jax.devices()
    mesh = make_mesh((2, 4), ("data", "model"))
    (q, k, v, kl), (rq, rk, rv) = _inputs()
    sh = NamedSharding(mesh, P(None, "model"))
    out = {"lse": np.asarray(collectives.lse_combine_decode_attention(
        mesh, jnp.asarray(q), jax.device_put(jnp.asarray(k), sh),
        jax.device_put(jnp.asarray(v), sh), jnp.asarray(kl)))}
    for causal in (True, False):
        out[f"ring_{causal}"] = np.asarray(ring_attention(
            mesh, jnp.asarray(rq), jnp.asarray(rk), jnp.asarray(rv),
            causal=causal, block_kv=16))
    np.savez(out_path, **out)


if __name__ == "__main__":
    _reference_collectives(sys.argv[1])
    sys.exit(0)


import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.configs.base import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.dist import elastic as jelastic  # noqa: E402
from repro.models import Model as JaxModel  # noqa: E402
from repro.models import flash as jflash  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train.loop import make_train_step as jax_step  # noqa: E402
from repro_torch.configs import get_config as torch_get_config  # noqa: E402
from repro_torch.configs.base import (MeshConfig, ServeConfig,  # noqa: E402
                                      TrainConfig)
from repro_torch.dist import collectives, elastic  # noqa: E402
from repro_torch.dist import sharding as shd  # noqa: E402
from repro_torch.dist.ring import ring_attention  # noqa: E402
from repro_torch.launch.mesh import (make_mesh, make_production_mesh,  # noqa: E402,E501
                                     make_serving_mesh, mesh_info)
from repro_torch.models import Model  # noqa: E402
from repro_torch.serve.fleet import Fleet  # noqa: E402
from repro_torch.serve.scheduler import Request  # noqa: E402
from repro_torch.train import loop, optimizer as opt  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(shape, axes):
    return make_mesh(shape, axes, ["cpu"] * int(np.prod(shape)))


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# the mesh


def test_mesh_coords_and_index_are_row_major():
    m = _mesh((2, 2, 2), ("pod", "data", "model"))
    assert m.size == 8 and m.axis_names == ("pod", "data", "model")
    assert [m.coords(i)["model"] for i in range(4)] == [0, 1, 0, 1]
    assert m.coords(5) == {"pod": 1, "data": 0, "model": 1}
    assert all(m.index(**m.coords(i)) == i for i in range(8))
    assert mesh_info(m) == {"shape": {"pod": 2, "data": 2, "model": 2},
                            "n_devices": 8,
                            "axes": ["pod", "data", "model"]}
    assert make_production_mesh() == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True) == {"pod": 2, "data": 16,
                                                    "model": 16}
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_mesh((2, 2), ("data", "model"), ["cpu"] * 3)


def test_serving_mesh_takes_a_device_list_or_the_visible_cards():
    m = make_serving_mesh(MeshConfig(model=4), ["cpu"] * 4)
    assert dict(m.shape) == {"data": 1, "model": 4}
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="needs 2 devices"):
            make_serving_mesh(MeshConfig(model=2))


@pytest.mark.parametrize("spec", [(None, "model"), ("data", None),
                                  (("data", "model"), None),
                                  ("model", "data"), ()])
def test_shard_tree_and_gather_tree_round_trip(spec):
    mesh = _mesh((2, 4), ("data", "model"))
    x = torch.arange(8 * 16, dtype=torch.float32).reshape(8, 16)
    placed = shd.place(x, spec, mesh)
    assert torch.equal(shd.gather_tree({"x": placed})["x"], x)
    if any(spec):
        for i, s in enumerate(placed.shards):
            assert torch.equal(s, x[placed.slices(i)])
            assert s.is_contiguous()


# ---------------------------------------------------------------------------
# the collectives


def test_lse_combine_matches_reference_attention():
    (q, k, v, kl), _ = _inputs()
    mesh = _mesh((2, 4), ("data", "model"))
    ks = shd.place(_t(k), (None, "model"), mesh)
    vs = shd.place(_t(v), (None, "model"), mesh)
    out = collectives.lse_combine_decode_attention(mesh, _t(q), ks, vs,
                                                   _t(kl))
    B, Kv, G, Dh = q.shape
    ref = jflash.reference_attention(jnp.asarray(q).reshape(B, 1, Kv, G, Dh),
                                     jnp.asarray(k), jnp.asarray(v),
                                     causal=False, kv_len=jnp.asarray(kl))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref[:, 0]),
                               rtol=2e-5, atol=2e-5)
    # whole K/V in, the same answer
    whole = collectives.lse_combine_decode_attention(mesh, _t(q), _t(k),
                                                     _t(v), _t(kl))
    assert torch.equal(whole, out)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_reference_attention(causal):
    _, (q, k, v) = _inputs()
    mesh = _mesh((2, 4), ("data", "model"))
    out = ring_attention(mesh, _t(q), _t(k), _t(v), causal=causal,
                         block_kv=16)
    ref = jflash.reference_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=3e-5,
                               atol=3e-5)


def test_collectives_match_the_references_on_8_forced_devices(tmp_path):
    """The reference's own lse-combine and ring attention, run once in a
    subprocess under --xla_force_host_platform_device_count=8 on the same
    inputs, against the port's within 2e-5."""
    out = tmp_path / "ref.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        str(out)], capture_output=True, text=True,
                       timeout=300, cwd=REPO, env=env)
    assert r.returncode == 0, r.stderr[-4000:]
    ref = np.load(out)
    (q, k, v, kl), (rq, rk, rv) = _inputs()
    mesh = _mesh((2, 4), ("data", "model"))
    got = collectives.lse_combine_decode_attention(mesh, _t(q), _t(k),
                                                   _t(v), _t(kl))
    np.testing.assert_allclose(got.numpy(), ref["lse"], rtol=2e-5,
                               atol=2e-5)
    for causal in (True, False):
        got = ring_attention(mesh, _t(rq), _t(rk), _t(rv), causal=causal,
                             block_kv=16)
        np.testing.assert_allclose(got.numpy(), ref[f"ring_{causal}"],
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("codec", [False, True])
def test_hierarchical_allreduce_sums_over_pod_and_data(codec):
    """dist_worker's check: a replicated input summed over pod x data (4
    copies) on a (2, 2, 2) mesh, with and without an identity codec."""
    mesh = _mesh((2, 2, 2), ("pod", "data", "model"))
    g = {"w": torch.arange(32.0).reshape(8, 4) / 7.0,
         "b": torch.tensor(2.0)}
    ident = (lambda x: x, lambda x: x) if codec else None
    out = collectives.hierarchical_grad_allreduce(mesh, g, compress=ident)
    np.testing.assert_allclose(out["w"].numpy(), (g["w"] * 4).numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(float(out["b"]), 8.0, rtol=1e-6)
    # per-shard inputs: shard i holds i + 1; model coordinate 0 is read
    per = [{"x": torch.tensor(float(i + 1))} for i in range(8)]
    got = collectives.hierarchical_grad_allreduce(mesh, per,
                                                  compress=ident)
    assert float(got["x"]) == 1 + 3 + 5 + 7


# ---------------------------------------------------------------------------
# the sharded train step


def _train_setup(adam_8bit):
    base = get_config("llama3.2-1b-smoke")
    cfg = dataclasses.replace(base, d_ff=128, vocab=256, n_heads=4,
                              n_kv_heads=4)
    tbase = torch_get_config("llama3.2-1b-smoke")
    tcfg_m = dataclasses.replace(tbase, d_ff=128, vocab=256, n_heads=4,
                                 n_kv_heads=4)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=4, adam_8bit=adam_8bit)
    jp = JaxModel(cfg).init(jax.random.PRNGKey(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg_m, device="cpu")
    rng = np.random.default_rng(3)
    B, S = 4, 16
    nb = {"tokens": rng.integers(0, 256, (B, S), dtype=np.int32),
          "labels": rng.integers(0, 256, (B, S), dtype=np.int32),
          "mask": (rng.random((B, S)) < 0.9).astype(np.float32)}
    return cfg, jp, tcfg_m, tp, kw, nb


def _code_flips(state_a, state_b):
    """Elements whose int8 moment codes differ between two Adam8 states,
    as a boolean tree over the params' shapes (by leaf), and the largest
    code difference."""
    flips, worst = [], 0
    for qa, qb in zip(leaves(state_a.m_q) + leaves(state_a.v_q),
                      leaves(state_b.m_q) + leaves(state_b.v_q)):
        d = (qa.int() - qb.int()).abs()
        worst = max(worst, int(d.max()))
        flips.append(d.reshape(-1) > 0)
    return flips, worst


@pytest.mark.parametrize("adam_8bit", [False, True])
def test_sharded_train_step_matches_the_unsharded_step(adam_8bit):
    """Three steps of compile_train_step on a (data 2, model 4) mesh
    against the port's unsharded make_train_step from the same params:
    loss within 1e-5 at each step and params within 1e-5 after three
    (the per-shard gradients are summed in another order). Under 8-bit
    Adam an int8 moment code may land one step apart at a rounding
    boundary; params are held to 1e-5 wherever every code agrees and to
    2 x the steps' summed lr where one differs, and the codes differ by
    at most one at under 1e-4 of the elements. w_up is
    stored split over 'model'; the reference's single-device step agrees
    with the loss within 1e-5 at each step."""
    cfg, jp, tcfg_m, tp, kw, nb = _train_setup(adam_8bit)
    tcfg = TrainConfig(**kw)
    init, _ = opt.make_optimizer(tcfg)
    state = init(tp)
    batch = {k: _t(v) for k, v in nb.items()}
    mesh = _mesh((2, 4), ("data", "model"))
    fn, (p_sh, o_sh, x_sh) = loop.compile_train_step(tcfg_m, tcfg, mesh,
                                                     tp, state, batch)
    P = shd.shard_tree(tp, p_sh, mesh)
    O = shd.shard_tree(state, o_sh, mesh)
    X = shd.shard_tree(batch, x_sh, mesh)
    up = P["units"]["b0"]["ffn"]["w_up"]
    assert isinstance(up, shd.Sharded) and up.spec[-1] == "model"
    assert {tuple(s.shape) for s in up.shards} == {(2, 64, 32)}
    assert len(X["tokens"].shards) == 8
    step = loop.make_train_step(tcfg_m, tcfg)
    jstep = jax.jit(jax_step(cfg, JaxTrainConfig(**kw)))
    jinit, _ = jopt.make_optimizer(JaxTrainConfig(**kw))
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    p1, s1, jparams, jstate = tp, state, jp, jinit(jp)
    for _ in range(3):
        P, O, m = fn(P, O, X)
        p1, s1, m1 = step(p1, s1, batch)
        jparams, jstate, jm = jstep(jparams, jstate, jb)
        assert abs(float(m["loss"]) - float(m1["loss"])) <= 1e-5
        assert abs(float(m["ce"]) - float(m1["ce"])) <= 1e-5
        assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5
    got = shd.gather_tree(P)
    assert isinstance(O.step, torch.Tensor) and int(O.step) == 3
    if not adam_8bit:
        for a, b in zip(leaves(got), leaves(p1)):
            assert float((a - b).abs().max()) <= 1e-5
        for a, b in zip(leaves(shd.gather_tree(O.m)), leaves(s1.m)):
            assert float((a - b).abs().max()) <= 1e-6
        return
    flips, worst = _code_flips(shd.gather_tree(O), s1)
    n = len(leaves(got))
    assert worst <= 1
    total = sum(int(f.numel()) for f in flips[:n])
    assert sum(int(f.sum()) for f in flips) <= 1e-4 * total
    # a flipped code moves its element's update by at most one step's
    # lr either way a step: 2 x the sum of the steps' lr
    bound = 2 * sum(float(opt.lr_schedule(tcfg, torch.tensor(t)))
                    for t in (1, 2, 3))
    worst_flipped = 0.0
    for a, b, fm, fv in zip(leaves(got), leaves(p1), flips[:n], flips[n:]):
        flipped = (fm | fv)[:a.numel()].reshape(a.shape)
        diff = (a - b).abs()
        assert float(diff[~flipped].max()) <= 1e-5
        if flipped.any():
            worst_flipped = max(worst_flipped, float(diff[flipped].max()))
    assert worst_flipped <= bound


def test_opt_shardings_follow_the_reference_rule():
    """fp32 moments take the params' specs; int8 moment blocks shard nb
    over the widest divisible axis set; the step replicates."""
    cfg, _, tcfg_m, tp, kw, _ = _train_setup(True)
    mesh = _mesh((2, 4), ("data", "model"))
    state = opt.adam8_init(tp)
    p_sh = shd.params_shardings(tp, tcfg_m, mesh)
    o_sh = loop._opt_shardings(state, p_sh, mesh)
    assert o_sh.step == ()
    specs = []
    shd.map_with(lambda leaf, spec: specs.append(spec), state.m_q, o_sh.m_q)
    for q, spec in zip(leaves(state.m_q), specs):
        nb = q.shape[0]
        want = (("data", "model"), None) if nb % 8 == 0 else \
            ("model", None) if nb % 4 == 0 else ()
        assert spec == want, (q.shape, spec)
    fp = loop._opt_shardings(opt.adam_init(tp), p_sh, mesh)
    assert fp.m is p_sh and fp.v is p_sh


# ---------------------------------------------------------------------------
# elastic and the fleet


def test_reshard_params_round_trips_the_references_leaves_bit_equal():
    cfg = get_config("llama3.2-1b-smoke")
    jp = JaxModel(cfg).init(jax.random.PRNGKey(0))
    tcfg = torch_get_config("llama3.2-1b-smoke")
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    p8 = elastic.reshard_params(tp, tcfg, _mesh((2, 4), ("data", "model")))
    assert any(isinstance(t, shd.Sharded) for t in leaves(p8))
    p4 = elastic.reshard_params(p8, tcfg, _mesh((1, 4), ("data", "model")))
    for a, b in zip(jax.tree.leaves(jp), leaves(shd.gather_tree(p4))):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # the policy passes through, values untouched
    p = elastic.reshard_params(tp, tcfg, _mesh((1, 4), ("data", "model")),
                               policy=shd.ShardingPolicy(exact_tp=True))
    for a, b in zip(leaves(tp), leaves(shd.gather_tree(p))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape,n_failed", [((4, 2), 1), ((2, 4), 1),
                                            ((1, 4), 1), ((3, 2, 4), 2)])
def test_degrade_mesh_unchanged(shape, n_failed):
    assert elastic.degrade_mesh(shape, n_failed) \
        == jelastic.degrade_mesh(shape, n_failed)


def test_reshard_surviving_counts_the_mesh_replicas():
    """A fleet of two model-2 replicas: scale_down(1) drains one, reap
    retires it (and reshards the survivor), and reshard_surviving returns
    the one mesh replica left, whose weights keep their values; a
    meshless fleet returns 0."""
    tcfg = torch_get_config("nectar-relu-llama-smoke")
    params = Model(tcfg).init(torch.Generator().manual_seed(0), device="cpu")
    scfg = ServeConfig(paged=True, max_batch=2, max_seq=64, block_size=8,
                       mesh=MeshConfig(model=2))
    fleet = Fleet(tcfg, params, scfg, n_replicas=2, device=["cpu"] * 2)
    eng = fleet.replicas[0].engine
    before = shd.gather_tree(eng.runner.params)
    assert fleet.reshard_surviving() == 2
    assert fleet.scale_down(1) == [1]
    assert [r.id for r in fleet.reap()] == [1]
    assert fleet.reshard_surviving() == 1
    after = shd.gather_tree(eng.runner.params)
    for a, b in zip(leaves(before), leaves(after)):
        assert torch.equal(a, b)
    done = eng.run([Request(rid=0, prompt=np.arange(5, dtype=np.int32),
                            max_new=3)], max_steps=100)
    assert len(done[0].tokens_out) == 3
    plain = Fleet(tcfg, params, dataclasses.replace(scfg, mesh=None),
                  n_replicas=2, device="cpu")
    assert plain.reshard_surviving() == 0
