"""The port's shapes table, analytic roofline and dry run against the
reference's, on the CPU.

  * every case of ``tests/test_launch_roofline.py``, through the port;
  * every analytic function of ``roofline.analysis`` equal (``==``) to the
    reference's for every registry config and each of its applicable
    shapes, and ``SHAPES`` / ``applicable_shapes`` /
    ``supports_long_context`` as the reference's;
  * ``input_specs`` (meta tensors) of the same shapes and dtypes as the
    reference's ShapeDtypeStructs, for every arch and shape;
  * ``estimate_cell_memory`` from the port's shard decisions equal to the
    reference's from its NamedShardings on an abstract mesh of the same
    shape (one pod and two);
  * ``run_cell`` into a temporary directory: ``cell_roofline`` of the
    record at ``hw.V5E`` equal to the reference's analytic branch on the
    same record, and at ``hw.H100_SXM`` one ``ok`` row a cell.
"""

import json
import math
import os

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config
from repro.configs import base as jbase
from repro.configs.registry import list_configs
from repro.dist import sharding as jshd
from repro.models import Model as JaxModel
from repro.roofline import analysis as janalysis
from repro.train import loop as jloop
from repro.train import optimizer as jopt
from repro_torch.configs import base
from repro_torch.configs import get_config as torch_get_config
from repro_torch.launch import dryrun
from repro_torch.roofline import analysis, hw


def _jax_dryrun():
    """The reference's dry-run module. Importing it sets XLA_FLAGS (512
    forced host devices), harmless here, as the device count binds at the
    first backend init (done already); the variable is put back so that a
    later test's subprocess does not inherit it."""
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as jdryrun
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return jdryrun


# ---------------------------------------------------------------------------
# tests/test_launch_roofline.py, through the port


def test_input_specs_train_shapes():
    cfg = torch_get_config("llama3.2-1b")
    specs = dryrun.input_specs(cfg, "train_4k")["batch"]
    assert specs["tokens"].shape == (256, 4096)
    assert specs["labels"].dtype == torch.int32
    assert specs["mask"].shape == (256, 4096)
    assert all(t.device.type == "meta" for t in specs.values())


def test_input_specs_decode_cache():
    cfg = torch_get_config("granite-34b")
    specs = dryrun.input_specs(cfg, "decode_32k")
    assert specs["tokens"].shape == (128, 1)
    kv = specs["cache"]["units"]["b0"]["k"]
    assert kv.shape == (88, 128, 32768, 1, 128)  # MQA kv=1
    assert kv.device.type == "meta"
    assert specs["cache"]["lens"].shape == (128,)


def test_input_specs_vlm_frontend_stub():
    cfg = torch_get_config("qwen2-vl-72b")
    specs = dryrun.input_specs(cfg, "prefill_32k")["batch"]
    assert "vision_embeds" in specs and "mrope_positions" in specs
    assert specs["mrope_positions"].shape == (3, 32, 32768)


def test_input_specs_audio_codebooks():
    cfg = torch_get_config("musicgen-medium")
    specs = dryrun.input_specs(cfg, "train_4k")["batch"]
    assert specs["tokens"].shape == (256, 4096, 4)


HLO = """
  %ag = bf16[16,1024]{1,0} all-gather(%x), replica_groups=[16,16]<=[256]
  %ar = f32[64]{0} all-reduce(%y), to_apply=%add
  %rs.1 = f32[4,4]{1,0} reduce-scatter(%z), dimensions={0}
  %cp = bf16[8]{0} collective-permute(%w)
  %notacoll = f32[2,2]{1,0} add(%a, %b)
  %ags = (bf16[4]{0}, bf16[16]{0}) all-gather-start(%v)
  %agd = bf16[16]{0} all-gather-done(%ags)
"""


def test_parse_collectives_counts_bytes():
    out = dryrun.parse_collectives(HLO)
    assert out["counts"] == {"all-gather": 2, "all-reduce": 1,
                             "reduce-scatter": 1, "collective-permute": 1}
    assert out["bytes_by_type"]["all-gather"] == 16 * 1024 * 2 + 40
    assert out["bytes_by_type"]["all-reduce"] == 64 * 4
    assert out == _jax_dryrun().parse_collectives(HLO)


def test_roofline_terms_dominance():
    t = hw.roofline_terms(flops=1e12, hbm_bytes=1e13, collective_bytes=0,
                          n_chips=256, chip=hw.V5E)
    assert t["bound"] == "memory_s"
    t2 = hw.roofline_terms(flops=1e12, hbm_bytes=1e10,
                           collective_bytes=1e13, n_chips=256, chip=hw.V5E)
    assert t2["bound"] == "collective_s"
    # the port's default chip is the card's
    assert hw.roofline_terms(1e12, 1e13, 0, 256) \
        == hw.roofline_terms(1e12, 1e13, 0, 256, chip=hw.H100_SXM)
    assert hw.ridge_point() == hw.ridge_point(hw.H100_SXM)


def test_model_flops_decode_vs_train():
    cfg = torch_get_config("llama3.2-1b")
    f_train = analysis.model_flops(cfg, "train_4k")
    f_dec = analysis.model_flops(cfg, "decode_32k")
    assert f_train / f_dec == pytest.approx(3 * 256 * 4096 / 128, rel=1e-6)


def test_analytic_flops_cover_recurrent_families():
    for arch in ("zamba2-2.7b", "xlstm-125m"):
        cfg = torch_get_config(arch)
        f = analysis.analytic_hlo_flops(cfg, "train_4k")
        assert f > analysis.model_flops(cfg, "train_4k")


def test_slstm_correction_only_for_xlstm():
    assert analysis.slstm_correction_flops(
        torch_get_config("xlstm-125m"), "train_4k") > 0
    assert analysis.slstm_correction_flops(
        torch_get_config("llama3.2-1b"), "train_4k") == 0


def test_non_embed_params_moe_active():
    cfg = torch_get_config("llama4-maverick-400b-a17b")
    n_active = analysis.non_embed_params(cfg, active_only=True)
    n_total = analysis.non_embed_params(cfg, active_only=False)
    assert n_total > 10 * n_active


@pytest.mark.parametrize("shape_name", list(base.SHAPES))
def test_shapes_table(shape_name):
    sh = base.SHAPES[shape_name]
    assert sh["kind"] in ("train", "prefill", "decode")
    assert sh["seq"] * sh["batch"] > 0
    assert sh == jbase.SHAPES[shape_name]


# ---------------------------------------------------------------------------
# the analytic functions against the reference's


def _calls(cfg, shape):
    """(name, args, kwargs) of every analytic call on one cell."""
    out = [("n_moe_layers", (cfg,), {}), ("_expert_params", (cfg,), {}),
           ("non_embed_params", (cfg,), {}),
           ("non_embed_params", (cfg,), {"active_only": False})]
    for fn in ("model_flops", "model_bytes", "slstm_correction_flops",
               "attention_flops", "ssd_flops", "mlstm_flops",
               "analytic_hlo_flops"):
        out.append((fn, (cfg, shape), {}))
    out.append(("ssd_flops", (cfg, shape), {"chunk": 64}))
    out.append(("mlstm_flops", (cfg, shape), {"block": 128}))
    for kw in ({}, {"chips": 512, "tp": 8}, {"moe_ws": True},
               {"ws_dense": True}, {"fused_attention": True,
                                    "ffn_down_frac": 0.25},
               {"weight_bpe": 1.0, "kv_bpe": 1.0}):
        out.append(("analytic_hlo_bytes", (cfg, shape), kw))
    for kw in ({}, {"chips": 512}, {"moe_ws": True}, {"ws_dense": True},
               {"seq_shard": True}, {"seq_shard": False, "tp": 8}):
        out.append(("analytic_collective_bytes", (cfg, shape), kw))
    return out


@pytest.mark.parametrize("name", list_configs())
def test_analytic_functions_equal_the_references(name):
    cfg, tcfg = get_config(name), torch_get_config(name)
    assert tcfg.supports_long_context == cfg.supports_long_context
    assert base.applicable_shapes(tcfg) == jbase.applicable_shapes(cfg)
    for shape in base.applicable_shapes(tcfg):
        for fn, args, kw in _calls(tcfg, shape):
            jargs = (cfg,) + args[1:]
            want = getattr(janalysis, fn)(*jargs, **kw)
            got = getattr(analysis, fn)(*args, **kw)
            assert type(got) is type(want), (fn, shape, kw)
            assert got == want, (fn, shape, kw)


# ---------------------------------------------------------------------------
# the dry run against the reference's


def _flat(tree, prefix=()):
    """{path: (shape, dtype name)} of a dict tree of meta tensors or
    ShapeDtypeStructs."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: (tuple(tree.shape), str(tree.dtype).replace("torch.",
                                                                ""))}


@pytest.mark.parametrize("arch", dryrun.ARCHS)
def test_input_specs_equal_the_references(arch):
    jdr = _jax_dryrun()
    assert dryrun.ARCHS == jdr.ARCHS
    cfg, tcfg = get_config(arch), torch_get_config(arch)
    for shape in base.applicable_shapes(tcfg):
        got = _flat(dryrun.input_specs(tcfg, shape))
        want = _flat(jdr.input_specs(cfg, shape))
        assert got == want, shape


def _ref_memory(cfg, shape_name, jmesh):
    """The reference's analytic memory estimate of one cell, from its
    own shardings on an abstract mesh (no device)."""
    jdr = _jax_dryrun()
    sh = jbase.SHAPES[shape_name]
    model = JaxModel(cfg)
    params_sh = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    if sh["kind"] == "train":
        policy = jdr.train_policy(cfg)
        init, _ = jopt.make_optimizer(jdr.train_config(cfg))
        opt_sh = jax.eval_shape(init, params_sh)
        p_sh = jshd.params_shardings(params_sh, cfg, jmesh, policy)
        o_sh = jloop._opt_shardings(opt_sh, p_sh, jmesh)
        return jdr.estimate_cell_memory(cfg, shape_name, jmesh, policy,
                                        params_sh, p_sh, opt_sh, o_sh)
    policy = jdr.serve_policy(cfg)
    cache = jdr.cache_specs(cfg, sh["batch"], sh["seq"])
    p_sh = jshd.params_shardings(params_sh, cfg, jmesh, policy)
    c_sh = jax.tree_util.tree_map_with_path(
        jshd.cache_shardings(cfg, jmesh, sh["batch"], policy), cache)
    return jdr.estimate_cell_memory(cfg, shape_name, jmesh, policy,
                                    params_sh, p_sh, cache_sh=cache,
                                    c_shard=c_sh)


@pytest.mark.parametrize("arch", dryrun.ARCHS)
def test_estimate_cell_memory_equals_the_references(arch):
    cfg, tcfg = get_config(arch), torch_get_config(arch)
    for multi_pod in (False, True):
        mesh = dryrun.production_mesh(multi_pod)
        jmesh = AbstractMesh(tuple(mesh.shape.values()), mesh.axis_names)
        for shape in base.applicable_shapes(tcfg):
            _, _, got = dryrun.build_cell(tcfg, shape, mesh)
            want = _ref_memory(cfg, shape, jmesh)
            assert got == want, (shape, multi_pod)


def _rows_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        a, b = got[k], want[k]
        if isinstance(b, float) and math.isnan(b):
            assert math.isnan(a), k
        else:
            assert a == b, k


def test_run_cell_records_feed_both_rooflines(tmp_path, monkeypatch):
    """Every cell's record: at V5E the port's row is the reference's
    analytic branch on the same record, and at the H100 every cell has an
    ok row whose memory is judged against the card's 80 GiB."""
    monkeypatch.setattr(analysis, "ART_DIR", str(tmp_path))
    monkeypatch.setattr(janalysis, "ART_DIR", str(tmp_path))
    recs = dryrun.main(["--all"])
    cells = list(dryrun.all_cells())
    assert len(recs) == len(cells) == len(list(tmp_path.iterdir()))
    for rec, (arch, shape) in zip(recs, cells):
        assert rec["ok"] and rec["method"] == "analytic", rec.get("error")
        assert (rec["arch"], rec["shape"]) == (arch, shape)
        assert rec["mesh"] == {"shape": {"data": 16, "model": 16},
                               "n_devices": 256, "axes": ["data", "model"]}
        with open(tmp_path / f"{arch}__{shape}__pod.json") as f:
            assert json.load(f) == rec
        got = analysis.cell_roofline(arch, shape, chip=hw.V5E)
        want = janalysis.cell_roofline(arch, shape, chip=hw.V5E)
        assert want["method"] == "analytic"
        _rows_equal(got, want)
        assert got["hlo_collective_diagnostic"] == pytest.approx(
            got["collective_bytes_global"], rel=1e-12)
    rows = analysis.full_table(chip=hw.H100_SXM)
    assert [(r["arch"], r["shape"]) for r in rows] == cells
    for r in rows:
        assert r["ok"] and r["method"] == "analytic"
        assert r["fits_hbm"] == (r["mem_gib_per_device"] < 80.0)
        assert r["bound"] in ("compute", "memory", "collective")
        assert r["step_s_lower_bound"] > 0
        assert analysis.improvement_hint(r)
    table = analysis.format_table(rows)
    assert len(table.splitlines()) == len(rows) + 2
    # a second run reads the records back (cached) unless forced
    again = dryrun.run_cell(*cells[0])
    assert again == recs[0]
    assert analysis.cell_roofline("llama3.2-1b", "long_500k") is None


def test_dry_run_allocates_nothing():
    """The largest cell's params (about 400B) and its decode cache are
    meta tensors: no storage is allocated on any device."""
    cfg = torch_get_config("llama4-maverick-400b-a17b")
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        else:
            leaves.append(t)
    walk(dryrun.param_specs(cfg))
    n_params = sum(t.numel() for t in leaves)
    walk(dryrun.input_specs(cfg, "decode_32k")["cache"])
    assert all(t.device.type == "meta" for t in leaves)
    assert n_params > 3e11
