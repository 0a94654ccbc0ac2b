"""Sharded serving in the port against the reference, on the CPU.

The port's mesh is one controller driving several shards
(launch.mesh): here ``["cpu"] * n``. Each case of the reference's
``tests/mesh_worker.py`` runs with its prompts, seeds and settings, on
the reference's weights (``from_jax_params``):

  * the port's sharded paged engine is token-identical to the
    reference's single-device paged engine (which the reference's own
    worker proves equal to its sharded engine), and to the port's
    unsharded engine, with every step's logits within 2e-4 of it (the
    column-sharded products are each GEMM's columns, bit-equal where the
    GEMM's sum order does not depend on the column count, which a CPU
    probe found at 7 of 8 shapes);
  * ``summary()["mesh"]`` has the reference's keys and values, the pool's
    per-shard gauges tile back to the whole pool, and every K/V leaf
    (and scale leaf under int8) is split on its KV-head axis 3;
  * copy-on-write under sharding keeps the shared block's bytes frozen
    on every shard.

Then the spec decisions (``_param_spec``, ``cache_shardings``) against
the reference's on every leaf of every registry config, the engine's
refusals, and the CLI's ``--mesh``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config
from repro.configs.base import MeshConfig as JaxMeshConfig
from repro.configs.base import ServeConfig as JaxServeConfig
from repro.configs.base import SpecConfig as JaxSpecConfig
from repro.configs.registry import list_configs
from repro.dist import sharding as jshd
from repro.models import Model as JaxModel
from repro.serve.engine import Engine as JaxEngine
from repro.serve.scheduler import Request as JaxRequest
from repro_torch.configs import get_config as torch_get_config
from repro_torch.configs.base import MeshConfig, ServeConfig, SpecConfig
from repro_torch.dist import sharding as shd
from repro_torch.kernels import ops
from repro_torch.launch import serve as cli
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import Model
from repro_torch.serve.engine import Engine
from repro_torch.serve.scheduler import Request
from repro_torch.weights import from_jax_params

NECTAR = "nectar-relu-llama-1.7m"
LOGIT_TOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def nectar():
    cfg = get_config(NECTAR)
    jp = JaxModel(cfg).init(jax.random.PRNGKey(0))
    tcfg = torch_get_config(NECTAR)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return cfg, jp, tcfg, tp


def _prompts(vocab, lengths, seed=0, shared=0):
    """tests/mesh_worker.py's prompts."""
    rng = np.random.default_rng(seed)
    sys_p = rng.integers(0, vocab, size=shared, dtype=np.int32)
    return [np.concatenate(
        [sys_p, rng.integers(0, vocab, size=int(n), dtype=np.int32)])
        for n in lengths]


# tests/mesh_worker.py's checks: (prompt lengths, seed, shared prefix,
# engine settings, max_new)
SETS = {
    "greedy": ([5, 23, 9, 14], 0, 0, dict(max_batch=3, max_seq=64), 8),
    "spec_prefix": ([5, 9, 7], 1, 24, dict(
        prefix_cache=True, spec=("ngram", 3, 4)), 10),
    "int8": ([6, 19, 11], 2, 0, dict(kv_quant=True), 8),
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


def _reference(nectar, name):
    """The reference's single-device paged engine's tokens on a set."""
    if name not in _REF:
        cfg, jp, _, _ = nectar
        lengths, seed, shared, settings, max_new = SETS[name]
        prompts = _prompts(cfg.vocab, lengths, seed, shared)
        with jax.default_matmul_precision("highest"):
            eng = JaxEngine(cfg, jp, JaxServeConfig(
                **_kw(settings, JaxSpecConfig)))
            done = eng.run([JaxRequest(rid=i, prompt=p, max_new=max_new)
                            for i, p in enumerate(prompts)], max_steps=3000)
        _REF[name] = {i: [int(t) for t in r.tokens_out]
                      for i, r in done.items()}
    return _REF[name]


def _recording(eng):
    """Every step's logits of ``eng``'s runner, in order."""
    log = []
    step = eng.runner.step

    def rec(batch):
        out = step(batch)
        log.append(out.logits.clone())
        return out
    eng.runner.step = rec
    return log


def _port_serve(nectar, name, model=1, kv_seq=False):
    _, _, tcfg, tp = nectar
    lengths, seed, shared, settings, max_new = SETS[name]
    prompts = _prompts(tcfg.vocab, lengths, seed, shared)
    mesh = MeshConfig(model=model, shard_kv_seq=kv_seq) if model > 1 \
        else None
    eng = Engine(tcfg, tp, ServeConfig(**_kw(settings, SpecConfig),
                                       mesh=mesh),
                 device=["cpu"] * model if model > 1 else "cpu")
    log = _recording(eng)
    done = eng.run([Request(rid=i, prompt=p, max_new=max_new)
                    for i, p in enumerate(prompts)], max_steps=3000)
    return {i: [int(t) for t in r.tokens_out] for i, r in done.items()}, \
        eng, log


_PORT = {}


def _unsharded(nectar, name):
    if name not in _PORT:
        _PORT[name] = _port_serve(nectar, name)
    return _PORT[name]


def _assert_shard_consistent(eng, model, kv_seq=False):
    """tests/mesh_worker.py's _assert_shard_consistent: the summary
    reports the mesh truthfully, the per-shard byte gauges tile the pool,
    and every pool leaf is split on its KV-head axis into ``model``
    slices."""
    s = eng.metrics.summary()
    assert s["mesh"] == {"shape": {"data": 1, "model": model},
                         "n_devices": model, "axes": ["data", "model"],
                         "kv_pool_shards": eng.pool.model_shards,
                         "shard_kv_seq": kv_seq}
    pool = s["kv_pool"]
    assert pool["model_shards"] == eng.pool.model_shards == model
    assert pool["per_shard_capacity_bytes"] * pool["model_shards"] \
        == pool["capacity_bytes"]
    assert pool["per_shard_used_bytes"] * pool["model_shards"] \
        == pool["used_bytes"]
    kv = eng.cfg.n_kv_heads
    for pools in eng.runner.cache["units"].values():
        for name, leaf in pools.items():
            assert isinstance(leaf, shd.Sharded), name
            assert leaf.spec[3] == "model" and len(leaf.shards) == model
            assert leaf.shape[3] == kv
            for t in leaf.shards:
                assert t.shape[3] == kv // model
                assert t.shape[:3] == leaf.shape[:3]
    eng.runner.check_cache_layout()


def _logits_close(want, got):
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= LOGIT_TOL


@pytest.mark.parametrize("name,model,kv_seq", [
    ("greedy", 2, False), ("greedy", 4, False), ("greedy", 4, True),
    ("spec_prefix", 4, False), ("int8", 2, False)])
def test_sharded_engine_serves_the_references_tokens(nectar, name, model,
                                                     kv_seq):
    ref = _reference(nectar, name)
    base, beng, blog = _unsharded(nectar, name)
    out, eng, log = _port_serve(nectar, name, model, kv_seq)
    assert base == ref
    assert out == ref
    _logits_close(blog, log)
    _assert_shard_consistent(eng, model, kv_seq)
    bs, ss = beng.metrics.summary(), eng.metrics.summary()
    for key in ("generated_tokens", "decode_steps", "prefill_chunks"):
        assert bs[key] == ss[key], key
    assert bs["mesh"] == {}
    if name == "spec_prefix":
        assert ss["spec_steps"] > 0 and ss["prefix_hits"] >= 1
    if name == "int8":
        names = {n for pools in eng.runner.cache["units"].values()
                 for n in pools}
        assert names == {"k", "v", "k_scale", "v_scale"}


@pytest.mark.parametrize("name", ["qwen2.5-3b-smoke", "qwen3-4b-smoke"])
def test_replicated_pool_when_kv_heads_do_not_divide(name):
    """2 KV heads at model 4: the weights still shard on their columns
    (qwen2.5's QKV bias split alike, qwen3's qk-norm whole; the tied
    embedding on its vocab rows), the pool stays one replicated slab on
    the home device, and the serve is token-identical to the unsharded
    engine with every step's logits within 2e-4."""
    tcfg = torch_get_config(name)
    assert tcfg.n_kv_heads == 2 and tcfg.tie_embeddings
    tp = Model(tcfg).init(torch.Generator().manual_seed(0), device="cpu")
    prompts = _prompts(tcfg.vocab, [5, 23, 9, 14])

    def serve(model):
        mesh = MeshConfig(model=model) if model > 1 else None
        eng = Engine(tcfg, tp, ServeConfig(
            **_kw(dict(max_batch=3, max_seq=64), SpecConfig), mesh=mesh),
            device=["cpu"] * model if model > 1 else "cpu")
        log = _recording(eng)
        done = eng.run([Request(rid=i, prompt=p, max_new=8)
                        for i, p in enumerate(prompts)], max_steps=3000)
        return {i: [int(t) for t in r.tokens_out]
                for i, r in done.items()}, eng, log

    base, _, blog = serve(1)
    out, eng, log = serve(4)
    assert out == base
    _logits_close(blog, log)
    assert eng.pool.model_shards == 1
    assert eng.metrics.summary()["mesh"]["kv_pool_shards"] == 1
    for pools in eng.runner.cache["units"].values():
        for leaf in pools.values():
            assert isinstance(leaf, torch.Tensor)
            assert leaf.shape[3] == 2
    units = eng.runner.params["units"]["b0"]["attn"]
    for w in ("wq", "wk", "wv", "wo"):
        assert len(units[w].model_parts()) == 4, w
    if tcfg.qkv_bias:
        assert units["bk"].spec[-1] == "model"
    embed = eng.runner.params["embed"]
    assert embed.spec == ("model", None)
    assert {tuple(t.shape) for t in embed.shards} == {
        (tcfg.vocab // 4, tcfg.d_model)}
    assert eng.params is None


def test_kernel_2_runs_once_per_shard(nectar, monkeypatch):
    """Each decode row's down-projection runs kernel 2's wrapper once a
    shard, on the shard's [d_ff, d/n] column block of W_down."""
    _, _, tcfg, _ = nectar
    seen = []
    real = ops.sparse_gather_matvec

    def spy(h, idx, w):
        seen.append(tuple(w.shape))
        return real(h, idx, w)
    monkeypatch.setattr(ops, "sparse_gather_matvec", spy)
    _port_serve(nectar, "int8")
    n_plain = len(seen)
    plain_shapes = set(seen)
    seen.clear()
    _port_serve(nectar, "int8", model=2)
    assert len(seen) == 2 * n_plain > 0
    assert plain_shapes == {(tcfg.d_ff, tcfg.d_model)}
    assert set(seen) == {(tcfg.d_ff, tcfg.d_model // 2)}


def test_kv_seq_decode_goes_through_the_lse_combine(nectar, monkeypatch):
    """With shard_kv_seq, every single-token step's attention runs through
    lse_combine_decode_attention (once a layer); without it, never."""
    from repro_torch.dist import collectives
    calls = []
    real = collectives.lse_combine_decode_attention

    def spy(mesh, q, k, v, kv_len):
        calls.append(q.shape)
        return real(mesh, q, k, v, kv_len)
    monkeypatch.setattr(collectives, "lse_combine_decode_attention", spy)
    _port_serve(nectar, "greedy", model=4)
    assert calls == []
    _, eng, _ = _port_serve(nectar, "greedy", model=4, kv_seq=True)
    decode_steps = eng.metrics.summary()["decode_steps"]
    assert decode_steps > 0
    assert len(calls) >= decode_steps * eng.cfg.n_layers // 2


def test_copy_on_write_keeps_the_shared_block_on_every_shard(nectar):
    """tests/mesh_worker.py's check_cow: a sibling reference forced onto a
    running request's partial tail block mid-stream; its next write
    copies the block (each shard its head slice), the shared block's
    bytes stay frozen on every shard, and the output is unchanged."""
    cfg, jp, tcfg, tp = nectar
    prompt = _prompts(tcfg.vocab, [10], seed=3)[0]
    kw = dict(max_batch=2, max_seq=64, paged=True, block_size=8,
              prefill_chunk=16, prefix_cache=True)

    with jax.default_matmul_precision("highest"):
        jeng = JaxEngine(cfg, jp, JaxServeConfig(**kw))
        jeng.run([JaxRequest(rid=0, prompt=prompt, max_new=10)],
                 max_steps=3000)
    single = [int(t) for t in jeng._requests[0].tokens_out]

    def run(model, force_share):
        mesh = MeshConfig(model=model) if model > 1 else None
        eng = Engine(tcfg, tp, ServeConfig(**kw, mesh=mesh),
                     device=["cpu"] * model if model > 1 else "cpu")
        eng.add_request(Request(rid=0, prompt=prompt, max_new=10))
        for _ in range(3):
            eng.step()
        frozen = None
        if force_share:
            e = next(iter(eng.sched.active.values()))
            assert e.ctx_len % 8 != 0           # mid-block frontier
            b = eng.pool.owned[e.slot][e.ctx_len // 8]
            eng.pool.share(1, [b])              # a "sibling" reader
            leaf = eng.runner.cache["units"]["b0"]["k"]
            frozen = (b, [t[:, b].clone() for t in leaf.shards])
        while eng._busy():
            eng.step()
        toks = [int(t) for t in eng._requests[0].tokens_out]
        if force_share:
            assert eng.pool.cow_count >= 1
            b, before = frozen
            leaf = eng.runner.cache["units"]["b0"]["k"]
            assert len(before) == model
            for t, was in zip(leaf.shards, before):
                assert torch.equal(t[:, b], was)
            eng.pool.free_slot(1)
        return toks

    assert run(1, False) == single
    assert run(2, False) == single
    assert run(2, True) == single


def test_mesh_requires_paged(nectar):
    """The reference's test_mesh_requires_paged: a mesh on the slot engine
    is refused loudly, and model=1 is no mesh (no devices needed)."""
    _, _, tcfg, tp = nectar
    with pytest.raises(ValueError, match="paged"):
        Engine(tcfg, tp, ServeConfig(paged=False, mesh=MeshConfig(model=2)),
               device=["cpu"] * 2)
    eng = Engine(tcfg, tp, ServeConfig(paged=True, max_batch=2, max_seq=64,
                                       block_size=8,
                                       mesh=MeshConfig(model=1)),
                 device="cpu")
    assert eng.mesh is None
    assert eng.metrics.summary()["mesh"] == {}
    done = eng.run([Request(rid=0, prompt=np.arange(5, dtype=np.int32),
                            max_new=4)], max_steps=200)
    assert len(done[0].tokens_out) == 4


@pytest.mark.parametrize("kw,match", [
    (dict(mesh=MeshConfig(model=2, data=2)), "data > 1"),
    (dict(mesh=MeshConfig(model=2), attn_backend="flash"), "naive"),
])
def test_sharded_engine_keeps_the_references_refusals(nectar, kw, match):
    _, _, tcfg, tp = nectar
    with pytest.raises(ValueError, match=match):
        Engine(tcfg, tp, ServeConfig(paged=True, max_seq=64, **kw),
               device=["cpu"] * kw["mesh"].n_devices)


def test_mesh_needs_a_device_per_shard(nectar):
    """One device for a mesh of two is refused; with no device list the
    mesh takes the visible CUDA devices (none here)."""
    _, _, tcfg, tp = nectar
    scfg = ServeConfig(paged=True, max_seq=64, mesh=MeshConfig(model=2))
    with pytest.raises(ValueError, match="sequence of 2 devices"):
        Engine(tcfg, tp, scfg, device="cpu")
    with pytest.raises(ValueError, match="needs 2 devices"):
        Engine(tcfg, tp, scfg)


def test_async_engine_under_a_mesh_keeps_loop_mode_off(nectar):
    """The async engine under a mesh runs overlap ticks and no decode
    bursts (the reference gates loop mode off), with the sync tokens."""
    from repro_torch.configs.base import AsyncConfig
    _, _, tcfg, tp = nectar
    base, _, _ = _unsharded(nectar, "greedy")
    lengths, seed, shared, settings, max_new = SETS["greedy"]
    prompts = _prompts(tcfg.vocab, lengths, seed, shared)
    eng = Engine(tcfg, tp, ServeConfig(
        **_kw(settings, SpecConfig), mesh=MeshConfig(model=2),
        async_cfg=AsyncConfig(enabled=True, max_device_ticks=8)),
        device=["cpu"] * 2)
    done = eng.run([Request(rid=i, prompt=p, max_new=max_new)
                    for i, p in enumerate(prompts)], max_steps=3000)
    assert {i: [int(t) for t in r.tokens_out]
            for i, r in done.items()} == base
    st = eng.async_stats()
    assert st["loop_bursts"] == 0 and st["overlap_ticks"] > 0


def test_import_blocks_reslices_between_meshes(nectar):
    """A disagg-style block handoff from a model-2 pool into a model-4
    pool and into an unsharded one moves every head's bytes exactly."""
    _, _, tcfg, tp = nectar
    engines = {}
    for m in (2, 4, 1):
        engines[m] = Engine(tcfg, tp, ServeConfig(
            paged=True, max_batch=2, max_seq=64, block_size=8,
            mesh=MeshConfig(model=m) if m > 1 else None),
            device=["cpu"] * m if m > 1 else "cpu")
    src = engines[2].runner
    g = torch.Generator().manual_seed(1)
    for t in src.cache["units"]["b0"]["k"].shards:
        t.copy_(torch.randn(t.shape, generator=g))
    whole = src.cache["units"]["b0"]["k"].gather()
    for m in (4, 1):
        dst = engines[m].runner
        dst.import_blocks_from(src, [1, 3], [0, 5])
        got = dst.cache["units"]["b0"]["k"]
        got = got.gather() if isinstance(got, shd.Sharded) else got
        assert torch.equal(got[:, [0, 5]], whole[:, [1, 3]])


# ---------------------------------------------------------------------------
# the spec decisions, leaf by leaf, against the reference's

MESHES = [(("model",), (2,)), (("model",), (4,)), (("model",), (8,)),
          (("data", "model"), (2, 4))]
POLICIES = [dict(fsdp=f, exact_tp=e) for f in (False, True)
            for e in (False, True)]


def _ref_spec(spec, ndim):
    s = tuple(spec)
    return s + (None,) * (ndim - len(s))


def _leaves_with_path(tree):
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out.append((tuple(getattr(p, "key", getattr(p, "idx", None))
                          for p in path), leaf))
    return out


_SHAPES = {}


def _shapes(name):
    if name not in _SHAPES:
        cfg = get_config(name)
        _SHAPES[name] = jax.eval_shape(
            lambda: JaxModel(cfg).init(jax.random.PRNGKey(0)))
    return _SHAPES[name]


@pytest.mark.parametrize("name", list_configs())
def test_param_spec_decides_as_the_reference(name):
    shapes = _leaves_with_path(_shapes(name))
    n = 0
    for axes, sizes in MESHES:
        mesh = make_mesh(sizes, axes, ["cpu"] * int(np.prod(sizes)))
        jmesh = AbstractMesh(sizes, axes)
        for pol in POLICIES:
            for path, leaf in shapes:
                want = _ref_spec(jshd._param_spec(
                    leaf.shape, jmesh, jshd.ShardingPolicy(**pol)),
                    len(leaf.shape))
                got = shd._pad(shd._param_spec(
                    leaf.shape, mesh, shd.ShardingPolicy(**pol)),
                    len(leaf.shape))
                assert got == want, (path, leaf.shape, axes, sizes, pol)
                n += 1
    assert n > 0


@pytest.mark.parametrize("name", list_configs())
def test_cache_shardings_decide_as_the_reference(name):
    cfg = get_config(name)
    model = JaxModel(cfg)
    trees = [(False, jax.eval_shape(lambda: model.init_cache(
        4, 32, jnp.float32)))]
    if all(k in ("attn", "moe", "shared_attn")
           for k in cfg.pattern_unit()) and "shared_attn" not in \
            cfg.pattern_unit():
        for q in (False, True):
            trees.append((True, jax.eval_shape(
                lambda q=q: model.init_paged_cache(4, 16, 8, 4, jnp.float32,
                                                   int8_kv=q))))
    for axes, sizes in MESHES:
        mesh = make_mesh(sizes, axes, ["cpu"] * int(np.prod(sizes)))
        jmesh = AbstractMesh(sizes, axes)
        for kv_seq in (False, True):
            for paged, tree in trees:
                jfn = jshd.cache_shardings(
                    cfg, jmesh, 4, jshd.ShardingPolicy(shard_kv_seq=kv_seq),
                    paged=paged)
                fn = shd.cache_shardings(
                    cfg, mesh, 4, shd.ShardingPolicy(shard_kv_seq=kv_seq),
                    paged=paged)
                for jpath, leaf in jax.tree_util.tree_flatten_with_path(
                        tree)[0]:
                    path = tuple(getattr(p, "key", None) for p in jpath)
                    want = _ref_spec(jfn(jpath, leaf).spec, len(leaf.shape))
                    got = shd._pad(fn(path, leaf), len(leaf.shape))
                    assert got == want, (path, leaf.shape, sizes, paged)


def test_batch_shardings_decide_as_the_reference():
    for axes, sizes in MESHES + [(("pod", "data", "model"), (2, 2, 2))]:
        mesh = make_mesh(sizes, axes, ["cpu"] * int(np.prod(sizes)))
        jmesh = AbstractMesh(sizes, axes)
        for b in (1, 2, 4, 6):
            want = jshd.batch_shardings(None, jmesh, b, 16, "train")
            got = shd.batch_shardings(None, mesh, b, 16, "train")
            assert set(got) == set(want)
            for k in want:
                assert got[k] == tuple(want[k].spec), (k, b, sizes)


# ---------------------------------------------------------------------------
# the CLI


def test_cli_mesh_flags_build_the_references_mesh_config(monkeypatch):
    seen = []
    real = cli.Engine

    def spy(cfg, params, scfg, device=None, **kw):
        seen.append((scfg, device))
        return real(cfg, params, scfg, device=device, **kw)
    monkeypatch.setattr(cli, "Engine", spy)
    out = cli.main(["--device", "cpu", "--arch", "nectar-relu-llama-smoke",
                    "--paged", "--mesh", "2", "--shard-kv-seq",
                    "--requests", "2", "--max-new", "2"])
    scfg, device = seen[0]
    assert dataclasses.asdict(scfg.mesh) == dataclasses.asdict(
        JaxMeshConfig(model=2, shard_kv_seq=True))
    assert [str(d) for d in device] == ["cpu", "cpu"]
    assert out["tokens"] == 4
    assert out["mesh"]["shape"] == {"data": 1, "model": 2}
    assert out["mesh"]["shard_kv_seq"] is True
    assert out["kv_pool_per_shard_bytes"] * 2 \
        == out["kv_pool_capacity_bytes"]


def test_cli_mesh_without_devices_raises_make_serving_mesh_error():
    if torch.cuda.device_count() >= 2:
        pytest.skip("this host has two CUDA devices")
    with pytest.raises(ValueError, match="needs 2 devices"):
        cli.main(["--paged", "--mesh", "2"])
