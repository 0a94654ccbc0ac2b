"""Sharded MoE serving in the port against the reference, on the CPU.

moonshot-v1-smoke (every block MoE) and llama4-maverick-smoke (an
attention block and an MoE block a unit) on the reference's weights
(``from_jax_params``), served by the port's sharded paged engine on
meshes of ``["cpu"] * n`` with ``tests/mesh_worker.py``'s prompt lengths
and seeds:

  * tokens identical to the reference's single-device paged engine, and
    every step's logits within 2e-4 of the port's unsharded engine;
  * one step's MoE input, fed to the sharded block under the engine's
    scope, routes to the unsharded block's dispatch table and gates bit
    for bit, capacity drops included, and gives its output;
  * ``summary()["mesh"]`` is the reference's (``mesh_info`` of the mesh
    and its pool rule: KV heads split only where they divide), the pool
    follows ``cache_shardings``, and every router and expert leaf is
    ``Sharded`` on its last dim (the column-parallel expert products of
    ``models/moe.py``).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config
from repro.configs.base import ServeConfig as JaxServeConfig
from repro.configs.base import SpecConfig as JaxSpecConfig
from repro.launch.mesh import mesh_info as jax_mesh_info
from repro.models import Model as JaxModel
from repro.serve.engine import Engine as JaxEngine
from repro.serve.scheduler import Request as JaxRequest
from repro_torch.configs import get_config as torch_get_config
from repro_torch.configs.base import MeshConfig, ServeConfig, SpecConfig
from repro_torch.dist import sharding as shd
from repro_torch.models import moe
from repro_torch.serve.engine import Engine
from repro_torch.serve.scheduler import Request
from repro_torch.weights import from_jax_params

NAMES = ["moonshot-v1-smoke", "llama4-maverick-smoke"]
LOGIT_TOL = 2e-4
EXPERT_LEAVES = ("router", "w_up", "w_gate", "w_down")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_MODELS = {}


def _model(name):
    if name not in _MODELS:
        cfg = get_config(name)
        jp = JaxModel(cfg).init(jax.random.PRNGKey(0))
        tcfg = torch_get_config(name)
        tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg,
                             device="cpu")
        _MODELS[name] = cfg, jp, tcfg, tp
    return _MODELS[name]


def _prompts(vocab, lengths, seed=0, shared=0):
    """tests/mesh_worker.py's prompts, in the model's vocab."""
    rng = np.random.default_rng(seed)
    sys_p = rng.integers(0, vocab, size=shared, dtype=np.int32)
    return [np.concatenate(
        [sys_p, rng.integers(0, vocab, size=int(n), dtype=np.int32)])
        for n in lengths]


# (prompt lengths, seed, shared prefix, engine settings, max_new), as
# tests/mesh_worker.py's check_greedy and check_spec_prefix
SETS = {
    "greedy": ([5, 23, 9, 14], 0, 0, dict(max_batch=3, max_seq=64), 8),
    "spec_prefix": ([5, 9, 7], 1, 24, dict(
        prefix_cache=True, spec=("ngram", 3, 4)), 10),
}


def _kw(settings, spec_cls):
    kw = dict(max_batch=2, max_seq=96, paged=True, block_size=8,
              prefill_chunk=16)
    kw.update(settings)
    if "spec" in kw:
        d, k, k_max = kw["spec"]
        kw["spec"] = spec_cls(drafter=d, k=k, k_max=k_max)
    return kw


_REF = {}


def _reference(name, setting):
    """The reference's single-device paged engine's tokens."""
    if (name, setting) not in _REF:
        cfg, jp, _, _ = _model(name)
        lengths, seed, shared, settings, max_new = SETS[setting]
        prompts = _prompts(cfg.vocab, lengths, seed, shared)
        with jax.default_matmul_precision("highest"):
            eng = JaxEngine(cfg, jp, JaxServeConfig(
                **_kw(settings, JaxSpecConfig)))
            done = eng.run([JaxRequest(rid=i, prompt=p, max_new=max_new)
                            for i, p in enumerate(prompts)], max_steps=3000)
        _REF[(name, setting)] = {i: [int(t) for t in r.tokens_out]
                                 for i, r in done.items()}
    return _REF[(name, setting)]


def _port_serve(name, setting, model=1, moe_inputs=None):
    """(tokens, engine, every step's logits); ``moe_inputs`` collects the
    input of every MoE block call."""
    _, _, tcfg, tp = _model(name)
    lengths, seed, shared, settings, max_new = SETS[setting]
    prompts = _prompts(tcfg.vocab, lengths, seed, shared)
    eng = Engine(tcfg, tp, ServeConfig(
        **_kw(settings, SpecConfig),
        mesh=MeshConfig(model=model) if model > 1 else None),
        device=["cpu"] * model if model > 1 else "cpu")
    log = []
    step = eng.runner.step

    def rec(batch):
        out = step(batch)
        log.append(out.logits.clone())
        return out
    eng.runner.step = rec
    forward = moe.moe_forward

    def spy(p, cfg, x):
        moe_inputs.append(x.clone())
        return forward(p, cfg, x)
    if moe_inputs is not None:
        moe.moe_forward = spy
    try:
        done = eng.run([Request(rid=i, prompt=p, max_new=max_new)
                        for i, p in enumerate(prompts)], max_steps=3000)
    finally:
        moe.moe_forward = forward
    return {i: [int(t) for t in r.tokens_out] for i, r in done.items()}, \
        eng, log


_PORT = {}


def _unsharded(name, setting):
    """The port's unsharded serve, with its MoE blocks' inputs."""
    if (name, setting) not in _PORT:
        inputs = []
        _PORT[(name, setting)] = _port_serve(name, setting,
                                             moe_inputs=inputs) + (inputs,)
    return _PORT[(name, setting)]


def _references_mesh_summary(tcfg, model):
    """The reference engine's ``_mesh_summary`` for MeshConfig(model=n):
    its mesh_info, the pool split over 'model' only where the KV heads
    divide, and shard_kv_seq off."""
    info = jax_mesh_info(AbstractMesh((1, model), ("data", "model")))
    info["kv_pool_shards"] = model if tcfg.n_kv_heads % model == 0 else 1
    info["shard_kv_seq"] = False
    return info


def _moe_units(eng):
    cfg = eng.cfg
    return [eng.runner.params["units"][f"b{j}"]["moe"]
            for j, kind in enumerate(cfg.pattern_unit()) if kind == "moe"]


@pytest.mark.parametrize("name,setting,model", [
    (n, s, m) for n in NAMES
    for s, m in (("greedy", 2), ("greedy", 4), ("spec_prefix", 2))])
def test_sharded_moe_serves_the_references_tokens(name, setting, model):
    ref = _reference(name, setting)
    base, beng, blog, _ = _unsharded(name, setting)
    out, eng, log = _port_serve(name, setting, model)
    assert base == ref
    assert out == ref
    assert len(blog) == len(log)
    for a, b in zip(blog, log):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= LOGIT_TOL

    tcfg = eng.cfg
    ss, bs = eng.metrics.summary(), beng.metrics.summary()
    assert ss["mesh"] == _references_mesh_summary(tcfg, model)
    assert bs["mesh"] == {}
    for key in ("generated_tokens", "decode_steps", "prefill_chunks"):
        assert bs[key] == ss[key], key
    if setting == "spec_prefix":
        assert ss["spec_steps"] > 0 and ss["prefix_hits"] >= 1

    # the pool as cache_shardings decides: split on the KV-head axis
    # where the heads divide (maverick-smoke's 2 at model 4 do not)
    split = tcfg.n_kv_heads % model == 0
    assert eng.pool.model_shards == (model if split else 1)
    for pools in eng.runner.cache["units"].values():
        for leaf in pools.values():
            if split:
                assert isinstance(leaf, shd.Sharded)
                assert leaf.spec[3] == "model"
                assert len(leaf.shards) == model
            else:
                assert isinstance(leaf, torch.Tensor)
    eng.runner.check_cache_layout()

    for p in _moe_units(eng):
        for key in EXPERT_LEAVES:
            leaf = p[key]
            assert isinstance(leaf, shd.Sharded), key
            assert leaf.spec[-1] == "model", key
            assert all(e is None for e in leaf.spec[:-1]), key
            assert len(leaf.model_parts()) == model, key
            for t in leaf.shards:
                assert t.shape[-1] == leaf.shape[-1] // model, key
        for key in p["shared"]:
            assert len(p["shared"][key].model_parts()) == model, key


@pytest.mark.parametrize("name,model", [(n, m) for n in NAMES
                                        for m in (2, 4)])
def test_a_steps_routing_equals_the_unsharded(name, model):
    """The first MoE input of the unsharded serve that drops assignments
    at capacity, through the sharded engine's first MoE block under its
    scope: the dispatch table and gates are the unsharded block's, bit
    for bit, and so is the output."""
    _, _, _, inputs = _unsharded(name, "greedy")
    _, eng, _ = _port_serve(name, "greedy", model)
    cfg = eng.cfg
    whole = shd.gather_tree(_moe_units(eng)[0])
    placed = _moe_units(eng)[0]

    def unit(tree):
        return {k: unit(v) if isinstance(v, dict) else v[0]
                for k, v in tree.items()}

    routes = []
    real = moe.route

    def spy(logits, c, cap):
        out = real(logits, c, cap)
        routes.append(out)
        return out

    def drops(table, T):
        return T * cfg.top_k - int((table < T).sum())

    moe.route = spy
    try:
        x = None
        for cand in inputs:
            routes.clear()
            moe.moe_forward(unit(whole), cfg, cand)
            if drops(routes[0][0], cand.shape[0] * cand.shape[1]) > 0:
                x = cand
                break
        assert x is not None, "no step dropped an assignment at capacity"
        routes.clear()
        want, _ = moe.moe_forward(unit(whole), cfg, x)
        with eng.runner._scope():
            got, _ = moe.moe_forward(unit(placed), cfg, x)
    finally:
        moe.route = real
    (t0, g0, _), (t1, g1, _) = routes
    assert torch.equal(t0, t1)
    assert torch.equal(g0, g1)
    assert drops(t1, x.shape[0] * x.shape[1]) > 0
    assert torch.equal(want, got)
