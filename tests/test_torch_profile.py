"""The port's roofline profiler and cost model (repro_torch.obs.profile,
obs.costmodel, roofline.hw) on the CPU, against the reference's.

One profiled serve of the reference's profile test (``max_batch=2,
max_seq=64, block_size=8, prefill_chunk=16``, prompts of 5, 21 and 9
tokens) through the port: every bucket reports attainment in (0, 1]
against CPU_HOST; the cost model, counted from shapes, meets every
assertion of the reference's ``test_scope_split_sums_to_bucket_total``
(which the reference's HLO parser no longer meets), its totals lie
within 5% of the reference's XLA ``cost_analysis()`` per bucket at table
capacity, and its product scopes equal what
``torch.utils.flop_counter.FlopCounterMode`` counts on the port's CPU
step within 1%. Beside them: token identity with profiling on and off,
the summary, Prometheus and Perfetto surfaces, the table, and the chip
table with its H100 SXM entry.
"""

import importlib.util
import json
import os
import types

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_config
from repro.configs.base import ObsConfig as JaxObsConfig
from repro.configs.base import ServeConfig as JaxServeConfig
from repro.models import Model as JaxModel
from repro.obs import costmodel as jax_costmodel
from repro.serve.engine import Engine as JaxEngine
from repro_torch.configs import get_config as torch_get_config
from repro_torch.configs.base import ObsConfig, ServeConfig
from repro_torch.core import sparsity
from repro_torch.models import attention, transformer
from repro_torch.obs import attainment_table, costmodel, write_perfetto
from repro_torch.obs.profile import ServingProfiler, bucket_label
from repro_torch.roofline import hw
from repro_torch.serve.engine import Engine
from repro_torch.serve.runner import DECODE, PREFILL
from repro_torch.serve.scheduler import Request
from repro_torch.weights import from_jax_params

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "check_trace", os.path.join(_REPO, "tools", "check_trace.py"))
check_trace = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(check_trace)

KW = dict(max_batch=2, max_seq=64, paged=True, block_size=8,
          prefill_chunk=16)
BUCKETS = {"decode": (1, False), "prefill16": (16, True)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def nectar():
    cfg = get_config("nectar-relu-llama-1.7m")
    jparams = JaxModel(cfg).init(jax.random.PRNGKey(0))
    tcfg = torch_get_config(cfg.name)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return cfg, jparams, tcfg, tparams


def _prompts(cfg, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, size=int(n), dtype=np.int32)
            for n in lengths]


def _serve(nectar, max_new=8, **kw):
    _, _, tcfg, tparams = nectar
    eng = Engine(tcfg, tparams, ServeConfig(**KW, **kw), device="cpu")
    reqs = [Request(rid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(_prompts(tcfg, [5, 21, 9]))]
    done = eng.run(reqs, max_steps=2000)
    return {i: [int(t) for t in r.tokens_out] for i, r in done.items()}, eng


@pytest.fixture(scope="module")
def profiled(nectar):
    return _serve(nectar, obs=ObsConfig(enabled=True, profile=True))


@pytest.fixture(scope="module")
def reference_totals(nectar):
    """XLA's cost_analysis() totals of the reference's step per bucket
    (its unrolled twin, compiled from abstract arguments)."""
    cfg, jparams, _, _ = nectar
    eng = JaxEngine(cfg, jparams, JaxServeConfig(
        **KW, obs=JaxObsConfig(enabled=True, profile=True)))
    return {name: jax_costmodel.step_cost(eng.runner, w, hp).flops
            for name, (w, hp) in BUCKETS.items()}


# ---------------------------------------------------------------------------
# attainment rows


def test_buckets_attainment_in_unit_interval(profiled):
    _, eng = profiled
    rows = eng.profiler.report(eng.tracer.tick_stats)
    assert {r["bucket"] for r in rows} == set(BUCKETS)
    for r in rows:
        assert r["chip"] == hw.CPU_HOST.name
        assert r["ticks"] > 0 and r["dev_ms"] > 0
        assert r["GFLOP/s"] > 0 and r["GB/s"] > 0 and r["AI"] > 0
        assert 0.0 < r["attain"] <= 1.0
        assert r["attain_raw"] == pytest.approx(r["attain"])
        assert r["bound"] in ("compute_s", "memory_s", "collective_s")


def test_scope_split_sums_to_bucket_total(profiled):
    """The assertions of the reference's test of the same name: the
    scopes sum to the bucket total, the named scopes attribute most of it,
    decode runs the sparse FFN and prefill the dense one."""
    _, eng = profiled
    rows = {r["bucket"]: r for r in
            eng.profiler.report(eng.tracer.tick_stats)}
    for r in rows.values():
        split = sum(s["flops"] for s in r["scopes"].values())
        assert split == pytest.approx(r["flops"], rel=0.05)
        assert 0.5 < r["scope_attributed_frac"] <= 1.0
        fracs = {k: s["flops_frac"] for k, s in r["scopes"].items()}
        assert sum(fracs.values()) == pytest.approx(1.0, rel=0.05)

    def flops(bucket, scope):
        return rows[bucket]["scopes"].get(scope, {}).get("flops", 0.0)

    assert flops("decode", "ffn_sparse") > flops("decode", "ffn_dense")
    assert flops("prefill16", "ffn_dense") > flops("prefill16",
                                                   "ffn_sparse")


@pytest.mark.parametrize("bucket", list(BUCKETS))
def test_totals_within_5pct_of_the_reference_xla_count(profiled,
                                                       reference_totals,
                                                       bucket):
    """At table capacity (the CPU's plain read gathers every row's whole
    table) the port's step FLOPs lie within 5% of XLA's count of the
    reference's step."""
    _, eng = profiled
    w, hp = BUCKETS[bucket]
    cost = eng.profiler.static_cost(w, hp)
    assert cost.n_keys == costmodel.capacity_keys(eng.runner.scfg)
    assert cost.flops == pytest.approx(reference_totals[bucket], rel=0.05)


@pytest.mark.parametrize("bucket", list(BUCKETS))
def test_product_scopes_match_flop_counter(profiled, bucket, monkeypatch):
    """Each product scope (attn, ffn_dense, ffn_sparse, logits) equals
    the matmul FLOPs FlopCounterMode counts in that scope's code on the
    port's CPU step, within 1%."""
    _, eng = profiled
    w, hp = BUCKETS[bucket]
    counts = dict.fromkeys(("attn", "ffn_dense", "ffn_sparse", "logits"),
                           0)

    def counted(scope, fn):
        def wrapper(*args, **kwargs):
            with FlopCounterMode(display=False) as fc:
                out = fn(*args, **kwargs)
            counts[scope] += fc.get_total_flops()
            return out
        return wrapper

    monkeypatch.setattr(attention, "attn_step_paged",
                        counted("attn", attention.attn_step_paged))
    monkeypatch.setattr(sparsity, "ffn_hidden", counted(
        "ffn_dense" if hp else "ffn_sparse", sparsity.ffn_hidden))
    monkeypatch.setattr(sparsity, "down_dense",
                        counted("ffn_dense", sparsity.down_dense))
    monkeypatch.setattr(sparsity, "down_sparse",
                        counted("ffn_sparse", sparsity.down_sparse))
    monkeypatch.setattr(transformer, "project_logits",
                        counted("logits", transformer.project_logits))
    runner = eng.runner
    B, MB = runner.scfg.max_batch, runner.scfg.blocks_per_seq
    batch = runner.new_batch(w, np.arange(B * MB, dtype=np.int32)
                             .reshape(B, MB))
    for slot in range(B):
        batch.add_row(slot, PREFILL if hp else DECODE,
                      np.arange(1, w + 1), 8)
    runner.step(batch)
    cost = eng.profiler.static_cost(w, hp)
    for scope, n in counts.items():
        # a step without prefill rows never runs the dense FFN
        assert (n == 0) == (scope == "ffn_dense" and not hp), scope
        assert cost.by_scope[scope]["flops"] == pytest.approx(n, rel=0.01), \
            scope


def test_live_keys_charge_only_what_kernel_1_reads(profiled):
    """Where kernel 1 runs (a CUDA device, the flash backend), the
    attention read is charged for the tick's live keys, not the table
    capacity; elsewhere the count is the capacity whatever it is given."""
    _, eng = profiled
    runner = eng.runner
    full = eng.profiler.static_cost(1, False)
    assert eng.profiler.static_cost(1, False, n_keys=16).flops == full.flops

    card = ServeConfig(**dict(KW, attn_backend="flash"))
    on_the_card = types.SimpleNamespace(
        cfg=runner.cfg, scfg=card, params=runner.params,
        device=torch.device("cuda"))
    cap = costmodel.capacity_keys(card)
    live = costmodel.step_cost(on_the_card, 1, False, n_keys=16)
    at_cap = costmodel.step_cost(on_the_card, 1, False)
    assert at_cap.n_keys == cap and live.n_keys == 16
    assert live.by_scope["attn"]["flops"] < at_cap.by_scope["attn"]["flops"]
    assert live.by_scope["attn"]["bytes"] < at_cap.by_scope["attn"]["bytes"]
    cfg = runner.cfg
    per_key = 4 * cfg.n_heads * cfg.d_head * cfg.n_layers
    assert at_cap.by_scope["attn"]["flops"] \
        - live.by_scope["attn"]["flops"] == per_key * (cap - 16)


def test_tick_records_live_keys(profiled):
    _, eng = profiled
    ticks = [t for t in eng.tracer.tick_stats if t.get("width")]
    assert ticks
    for t in ticks:
        bs = eng.scfg.block_size
        assert t["n_keys"] > 0 and t["n_keys"] % bs == 0


def test_greedy_tokens_identical_profile_on_off(nectar):
    off, _ = _serve(nectar)
    on, eng = _serve(nectar, obs=ObsConfig(enabled=True, profile=True))
    assert off == on and eng.profiler is not None


def test_profile_requires_paged_engine(nectar):
    _, _, tcfg, tparams = nectar
    with pytest.raises(ValueError, match="paged"):
        Engine(tcfg, tparams, ServeConfig(
            max_batch=2, max_seq=64, paged=False,
            obs=ObsConfig(enabled=True, profile=True)), device="cpu")


def test_profiling_keeps_async_ticks_sync(nectar):
    """As in the reference, a profiled async engine takes no async tick:
    its buckets are the runner's eager steps."""
    from repro_torch.configs.base import AsyncConfig
    toks, eng = _serve(nectar, obs=ObsConfig(enabled=True, profile=True),
                       async_cfg=AsyncConfig(enabled=True,
                                             max_device_ticks=4))
    st = eng.async_stats()
    assert st["overlap_ticks"] == st["loop_bursts"] == 0
    assert toks == _serve(nectar)[0]


# ---------------------------------------------------------------------------
# surfaces


def test_summary_and_prometheus_carry_bucket_attainment(profiled):
    _, eng = profiled
    summ = eng.metrics.summary()
    buckets = {r["bucket"]: r for r in summ["bucket_attainment"]}
    assert 0.0 < buckets["decode"]["attain"] <= 1.0
    text = eng.metrics.registry.prometheus_text()
    assert "# TYPE bucket_attainment_attainment gauge" in text
    assert 'bucket_attainment_attainment{bucket="decode"}' in text
    assert 'bucket_attainment_achieved_gflops{bucket="prefill16"}' in text


def test_perfetto_counter_tracks_validate(profiled, tmp_path):
    _, eng = profiled
    path = str(tmp_path / "roofline.trace.json")
    write_perfetto(eng.tracer, path, registry=eng.metrics.registry,
                   profiler=eng.profiler)
    want = ["achieved_gflops", "achieved_gbs", "roofline_attainment"]
    assert check_trace.check_perfetto(path, expect_counters=want) == []
    counters = [e for e in json.load(open(path))["traceEvents"]
                if e["ph"] == "C"]
    assert len(counters) >= 3
    assert check_trace.check_perfetto(path, expect_counters=["nope"])


def test_attainment_table_renders(profiled):
    _, eng = profiled
    table = attainment_table(eng.profiler.report(eng.tracer.tick_stats))
    for word in ("decode", "prefill16", "attain", "attain_raw", "flops:",
                 "cpu-host"):
        assert word in table
    assert attainment_table([]).startswith("(no profiled ticks")


def test_bucket_labels():
    assert bucket_label(1, False) == "decode"
    assert bucket_label(16, True) == "prefill16"
    assert bucket_label(9, False) == "verify9"


# ---------------------------------------------------------------------------
# the chip table


def test_active_chip_follows_the_device(monkeypatch):
    assert hw.active_chip("cpu") is hw.CPU_HOST
    assert hw.active_chip(torch.device("cpu")) is hw.CPU_HOST
    assert hw.active_chip("h100-sxm") is hw.H100_SXM
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev=None: "NVIDIA H100 80GB HBM3")
    assert hw.active_chip("cuda") is hw.H100_SXM
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev=None: "NVIDIA H100 PCIe")
    with pytest.raises(ValueError, match="NVIDIA H100 PCIe"):
        hw.active_chip("cuda")


def test_h100_sxm_entry_and_dtype_peaks():
    c = hw.H100_SXM
    assert (c.peak_flops, c.peak_int8_ops, c.peak_f32_flops) \
        == (989.4e12, 1978.9e12, 66.9e12)
    assert (c.hbm_bw, c.hbm_gib, c.ici_links) == (3.35e12, 80.0, 18)
    assert c.vmem_bytes == 228 * 1024
    assert hw.peak_for(c, torch.float32) == 66.9e12
    assert hw.peak_for(c, torch.bfloat16) == 989.4e12
    assert hw.peak_for(c, torch.int8) == 1978.9e12
    assert hw.CPU_HOST.peak_f32_flops == hw.CPU_HOST.peak_flops
    t = hw.roofline_terms(66.9e12, 0.0, 0.0, 1, chip=c,
                          peak=hw.peak_for(c, torch.float32))
    assert t["step_s_lower_bound"] == pytest.approx(1.0)
    assert t["bound"] == "compute_s"
    assert hw.ridge_point(c) == pytest.approx(989.4e12 / 3.35e12)


def test_profiler_judges_f32_weights_at_the_f32_peak(profiled):
    _, eng = profiled
    prof = ServingProfiler(eng.runner, chip=hw.H100_SXM)
    assert prof.peak == hw.H100_SXM.peak_f32_flops
