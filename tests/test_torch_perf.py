"""The port's perf variants (``repro_torch.launch.perf``) on the CPU,
against the reference's ``repro.launch.perf``.

The dry-run records of the cells used are written once by the port's
``dryrun.run_cell`` into a temporary directory, which both packages'
``ART_DIR`` point at (and their ``PERF_DIR`` at two of its
subdirectories). Only the reference's MODELED path is called: its LOWERED
path imports ``repro.launch.dryrun``, which sets XLA_FLAGS and compiles.

  * every MODELED variant alone and two compositions at ``hw.V5E`` equal
    the reference's ``run_variant`` record key for key (NaN-aware), but
    for the wall time and the note, which names the port's counterpart;
    the port adds the chip's name and the memory per device;
  * the port's LOWERED rows: ``no_remat`` moves a train cell's compute
    term by the ratio of its FLOP counts with and without remat,
    ``serve_replicated`` moves only the memory per device, and
    ``block_causal`` none of the terms; each row equals the reference's
    analytic ``cell_roofline`` on the same record, with ``arch@variant``
    in the reference's registry too;
  * ``moe_ws`` raises in the port with its dry run's error, the
    TypeError the reference's ``ShardingPolicy`` raises for the same
    field;
  * a cached record is read back unchanged, and one of another chip is
    counted again;
  * at the H100 SXM every row has one of the three bounds and a positive
    step.
"""

import dataclasses
import json
import math
import os

import jax
import pytest

from repro.configs import registry as jregistry
from repro.dist import sharding as jshd
from repro.roofline import analysis as janalysis
from repro.roofline import hw as jhw
from repro_torch.configs import get_config, registry
from repro_torch.launch import dryrun, perf
from repro_torch.roofline import analysis, hw

CELLS = [("llama3.2-1b", "decode_32k"), ("llama3.2-1b", "train_4k"),
         ("moonshot-v1-16b-a3b", "decode_32k"),
         ("granite-34b", "decode_32k")]
MODELED = list(perf.MODELED_SPECS) + ["int8_stream+sparse_ffn",
                                      "kv_quant+flash_fusion"]
LOWERED = [("no_remat", "llama3.2-1b", "train_4k"),
           ("serve_replicated", "granite-34b", "decode_32k"),
           ("block_causal", "llama3.2-1b", "train_4k")]


def _jax_perf():
    """The reference's perf module. Its import sets XLA_FLAGS (512 forced
    host devices): the backend is up first, so the count does not bind,
    and the variable is put back for later subprocesses."""
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import perf as jperf
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return jperf


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """The dry-run records of CELLS, written once by the port."""
    art = tmp_path_factory.mktemp("dryrun")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(analysis, "ART_DIR", str(art))
        for cell in CELLS:
            assert dryrun.run_cell(*cell)["ok"]
    return art


@pytest.fixture
def dirs(records, tmp_path, monkeypatch):
    """Both packages read the records and write their perf records into
    directories of their own; the port's registry and policy overrides
    are restored after the test."""
    jperf = _jax_perf()
    for mod in (analysis, janalysis):
        monkeypatch.setattr(mod, "ART_DIR", str(records))
    monkeypatch.setattr(perf, "PERF_DIR", str(tmp_path / "port"))
    monkeypatch.setattr(jperf, "PERF_DIR", str(tmp_path / "reference"))
    monkeypatch.setattr(registry, "REGISTRY", dict(registry.REGISTRY))
    monkeypatch.setattr(dryrun, "POLICY_OVERRIDES", {})
    return jperf


def _equal(a, b):
    if isinstance(b, dict):
        assert a.keys() == b.keys()
        return all(_equal(a[k], b[k]) for k in b)
    if isinstance(b, float) and math.isnan(b):
        return math.isnan(a)
    return a == b


# ---------------------------------------------------------------------------
# MODELED variants against the reference


@pytest.mark.parametrize("cell", CELLS[:3], ids=lambda c: "x".join(c))
@pytest.mark.parametrize("variant", MODELED)
def test_modeled_variants_equal_the_references(dirs, cell, variant):
    jperf = dirs
    got = perf.run_variant(*cell, variant, force=True, chip=hw.V5E)
    want = jperf.run_variant(*cell, variant, force=True)
    assert set(got) - set(want) == {"chip", "mem_gib_per_device"}
    for key in set(want) - {"wall_s", "note"}:
        assert _equal(got[key], want[key]), key
    assert got["modeled"] and got["chip"] == "tpu-v5e"
    # one note a part, each naming the port's implementation
    assert got["note"].count(";") == want["note"].count(";")
    assert "Pallas" not in got["note"]
    for part, name in zip(got["note"].split("; "), variant.split("+")):
        assert part == perf.MODELED_SPECS[name][2]


def test_modeled_notes_name_the_ports_counterparts():
    notes = {v: spec[2] for v, spec in perf.MODELED_SPECS.items()}
    assert "csrc/nmce_matmul.cu" in notes["int8_stream"]
    assert "csrc/sparse_gather.cu" in notes["sparse_ffn"]
    assert "serve/kv_cache.quantize_kv" in notes["kv_quant"]
    assert "kernels 1 and 5" in notes["flash_fusion"]
    assert "dist/compression.py" in notes["grad_compression"]
    jperf = _jax_perf()
    assert list(perf.MODELED_SPECS) == list(jperf.MODELED_SPECS)
    assert {v: s[:2] for v, s in perf.MODELED_SPECS.items()} \
        == {v: s[:2] for v, s in jperf.MODELED_SPECS.items()}
    assert perf.LOWERED == jperf.LOWERED


# ---------------------------------------------------------------------------
# LOWERED variants: the port's analytic rows


@pytest.mark.parametrize("variant,arch,shape", LOWERED)
def test_lowered_rows(dirs, monkeypatch, variant, arch, shape):
    got = perf.run_variant(arch, shape, variant, force=True, chip=hw.V5E)
    before, after = got["before"], got["after"]
    assert not got["modeled"]
    if variant == "no_remat":
        cfg = get_config(arch)
        ratio = analysis.analytic_hlo_flops(
            dataclasses.replace(cfg, remat=False), shape) \
            / analysis.analytic_hlo_flops(cfg, shape)
        assert ratio < 1
        assert after["compute_s"] == pytest.approx(
            before["compute_s"] * ratio, rel=1e-12)
        moved = {"compute_s"}
    else:
        moved = set()
    for key in ("compute_s", "memory_s", "collective_s"):
        assert (after[key] != before[key]) == (key in moved), key
    mem = got["mem_gib_per_device"]
    assert (mem["after"] > mem["before"]) == (variant == "serve_replicated")
    if variant != "serve_replicated":
        assert mem["after"] == mem["before"]

    # the reference's analytic branch on the same record and config
    vname = f"{arch}@{variant}"
    cfg_patch, _ = perf.LOWERED[variant]
    jcfg = dataclasses.replace(jregistry.get_config(arch), name=vname,
                               **cfg_patch)
    monkeypatch.setitem(jregistry.REGISTRY, vname, jcfg)
    want = janalysis.cell_roofline(vname, shape, chip=jhw.V5E)
    assert want["method"] == "analytic"
    for key in perf.TERMS:
        assert after[key] == want[key], key
    assert mem["after"] == want["mem_gib_per_device"]


def test_moe_ws_fails_in_both_packages(dirs, records):
    with pytest.raises(RuntimeError, match="dry run failed") as err:
        perf.run_variant("moonshot-v1-16b-a3b", "decode_32k", "moe_ws",
                         force=True)
    # the reference's dry run replaces the same field into its policy
    # (src/repro/launch/dryrun.py:76/83), and fails on the same TypeError
    with pytest.raises(TypeError) as jerr:
        dataclasses.replace(jshd.ShardingPolicy(),
                            **perf.LOWERED["moe_ws"][1])
    assert f"TypeError: {jerr.value}" in str(err.value)
    with open(records / "moonshot-v1-16b-a3b@moe_ws__decode_32k__pod.json") \
            as f:
        rec = json.load(f)
    assert not rec["ok"] and rec["error"] == f"TypeError: {jerr.value}"


# ---------------------------------------------------------------------------
# the record cache, and the card's rows


def test_cached_record_is_read_back(dirs, tmp_path):
    cell = CELLS[0]
    first = perf.run_variant(*cell, "int8_stream", force=True)
    path = tmp_path / "port" / "llama3.2-1b__decode_32k__int8_stream.json"
    with open(path) as f:
        assert json.load(f) == first
    assert perf.run_variant(*cell, "int8_stream") == first
    # a record of another chip is counted again
    v5e = perf.run_variant(*cell, "int8_stream", chip=hw.V5E)
    assert v5e["chip"] == "tpu-v5e" and first["chip"] == "h100-sxm"
    assert v5e["after"] != first["after"]


@pytest.mark.parametrize("cell", CELLS[:3], ids=lambda c: "x".join(c))
def test_rows_at_the_h100(dirs, cell):
    for variant in MODELED + ["no_remat", "serve_replicated",
                              "block_causal"]:
        out = perf.run_variant(*cell, variant, force=True)
        assert out["chip"] == "h100-sxm"
        for side in ("before", "after"):
            assert out[side]["bound"] in ("compute", "memory",
                                          "collective"), variant
            assert out[side]["step_s_lower_bound"] > 0, variant
        assert out["step_speedup"] > 0


def test_main_writes_the_record(dirs, tmp_path):
    out = perf.main(["--arch", "llama3.2-1b", "--shape", "decode_32k",
                     "--variant", "int8_stream+sparse_ffn", "--force"])
    assert out["step_speedup"] > 1
    assert os.path.exists(tmp_path / "port" /
                          "llama3.2-1b__decode_32k__int8_stream+sparse_ffn"
                          ".json")
