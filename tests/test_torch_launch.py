"""The port's serve CLI and the metrics summary it prints, on the CPU.

``python -m repro_torch.launch.serve --device cpu`` serves a SMOKE config
end to end; ``--ckpt-dir`` serves the latest checkpoint's params;
``--mesh`` without ``--paged`` is refused, as the reference's CLI
refuses it (its serving is in tests/test_torch_mesh.py); ``--spec
ngram|selfspec`` serves
speculatively and ``--async`` through the async engine; ``--obs``,
``--trace-out``, ``--metrics-port`` and ``--profile`` add the reference
CLI's output keys, and so do ``--disagg*``, ``--direct-max-suffix``,
``--replicas`` and ``--router-policy``; ``--model zamba2-smoke`` and
``--model xlstm-smoke`` serve through the slot engine and refuse the
paged flags; ``metrics.summary()`` has the reference's keys, the
speculative-decoding counters included.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs.base import ServeConfig as JaxServeConfig
from repro.models import Model as JaxModel
from repro.serve.engine import Engine as JaxEngine
from repro.serve.scheduler import Request as JaxRequest
from repro_torch.configs import get_config as torch_get_config
from repro_torch.configs.base import ServeConfig
from repro_torch.launch import serve as cli
from repro_torch.models import Model
from repro_torch.serve.engine import Engine
from repro_torch.serve.scheduler import Request
from repro_torch.weights import from_jax_params

ROOT = Path(__file__).resolve().parents[1]
# the reference's summary keys of speculative decoding
SPEC_KEYS = {"spec_steps", "spec_acceptance_rate", "spec_tokens_per_verify",
             "spec_per_request"}


def test_cli_serves_on_the_cpu():
    """The module runs as a program: paged engine, prefix cache, seeded
    sampled rows, a JSON summary on stdout."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "nectar-relu-llama-smoke", "--requests", "3",
         "--max-new", "3", "--max-batch", "2", "--prefix-cache",
         "--temperature", "0.7", "--seed", "1"],
        capture_output=True, text=True, env=env, timeout=600, check=True)
    s = json.loads(out.stdout)
    assert s["device"] == "cpu" and s["requests"] == 3 and s["tokens"] == 9
    assert s["evictions"] == 0 and s["kv_pool_capacity_bytes"] > 0


@pytest.mark.parametrize("argv", [
    ["--kv-quant", "--max-new", "2", "--requests", "2"],
    ["--max-new", "2", "--requests", "2"],
])
def test_cli_main_in_process(argv):
    """int8 KV implies the paged engine; the default is the slot engine."""
    s = cli.main(["--device", "cpu", "--arch", "nectar-relu-llama-smoke",
                  *argv])
    assert s["tokens"] == 4
    assert ("kv_pool_capacity_bytes" in s) == ("--kv-quant" in argv)


@pytest.mark.parametrize("flags,match", [
    (["--mesh", "2"], "requires the paged engine"),
    (["--mesh", "2", "--shard-kv-seq"], "requires the paged engine"),
])
def test_cli_refuses_flags_of_later_slices(flags, match):
    """``--mesh`` and ``--shard-kv-seq`` were refused as later slices'
    flags before the multi-device slice. They are served now, through the
    paged engine only: on the slot engine (no ``--paged``) a mesh is
    refused with the engine's ValueError, as the reference's CLI does."""
    with pytest.raises(ValueError, match=match):
        cli.main(["--device", "cpu", "--arch", "nectar-relu-llama-smoke",
                  *flags])


def test_cli_serves_the_latest_checkpoint(tmp_path, capsys, monkeypatch):
    """``--ckpt-dir`` (refused until the training slice) serves the
    params of the newest checkpoint there, a training run's {"params",
    "opt"} with either optimizer's state: the engine gets them bit for
    bit; an empty directory serves the seeded random weights."""
    from repro_torch.train import checkpoint
    from repro_torch.train import optimizer as opt
    from repro_torch.tree import leaves
    cfg = torch_get_config("nectar-relu-llama-smoke")
    params = Model(cfg).init(torch.Generator().manual_seed(5), device="cpu")
    old = Model(cfg).init(torch.Generator().manual_seed(6), device="cpu")
    ckpt = str(tmp_path / "ckpt")
    checkpoint.save(ckpt, 3, {"params": old, "opt": opt.adam_init(old)})
    checkpoint.save(ckpt, 7, {"params": params,
                              "opt": opt.adam8_init(params)})
    seen = []

    def spy(cfg, p, *a, **kw):
        seen.append(p)
        return Engine(cfg, p, *a, **kw)

    monkeypatch.setattr(cli, "Engine", spy)
    argv = ["--device", "cpu", "--arch", "nectar-relu-llama-smoke",
            "--requests", "2", "--max-new", "3", "--max-batch", "2"]
    s = cli.main(argv + ["--ckpt-dir", ckpt])
    assert s["ckpt_step"] == 7 and s["tokens"] == 6
    assert "[serve] loaded checkpoint step 7" in capsys.readouterr().err
    assert all(torch.equal(a, b) for a, b in zip(leaves(seen[0]),
                                                  leaves(params)))
    empty = cli.main(argv + ["--ckpt-dir", str(tmp_path / "none")])
    assert empty["ckpt_step"] is None and empty["tokens"] == 6
    assert not torch.equal(seen[1]["embed"], params["embed"])



@pytest.mark.parametrize("flags", [
    ["--async"], ["--async", "--async-k", "2"],
    ["--async", "--async-sync-every", "2"]])
def test_cli_serves_async(flags):
    """``--async`` (which implies the paged engine), ``--async-k`` and
    ``--async-sync-every`` are served (they were refused before the async
    slice) and the summary carries the engine's ``async_stats()``."""
    s = cli.main(["--device", "cpu", "--arch", "nectar-relu-llama-smoke",
                  "--requests", "3", "--max-new", "4", "--max-batch", "2",
                  *flags])
    assert s["tokens"] == 12 and "kv_pool_capacity_bytes" in s
    a = s["async"]
    assert a["device_ticks"] > 0 and a["sync_ticks"] > 0
    k = int(flags[flags.index("--async-k") + 1]) if "--async-k" in flags \
        else 8
    assert (a["loop_bursts"] > 0) == (k > 1)
    if "--async-sync-every" in flags:
        assert a["sync_ticks"] >= a["loop_bursts"]


def test_cli_serves_async_as_a_program():
    """``python -m repro_torch.launch.serve --async --async-k 8`` serves on
    the CPU and prints the async block."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "nectar-relu-llama-smoke", "--requests", "3",
         "--max-new", "6", "--max-batch", "3", "--async", "--async-k", "8"],
        capture_output=True, text=True, env=env, timeout=600, check=True)
    s = json.loads(out.stdout)
    assert s["requests"] == 3 and s["tokens"] == 18
    a = s["async"]
    assert a["loop_bursts"] > 0 and a["loop_device_ticks"] > 0
    assert 0.0 < a["overlap_frac"] <= 1.0


@pytest.mark.parametrize("drafter", ["ngram", "selfspec"])
def test_cli_serves_speculatively(drafter):
    """``--spec`` (which implies the paged engine) and ``--spec-k`` run as
    a program and print the reference CLI's spec summary keys. The
    program runs single-threaded: beside the other test workers, torch's
    default thread count oversubscribes the host and self-spec's
    predictor calibration then takes minutes instead of a second."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "nectar-relu-llama-smoke", "--requests", "3",
         "--max-new", "6", "--max-batch", "2", "--spec", drafter,
         "--spec-k", "3"],
        capture_output=True, text=True, env=env, timeout=600, check=True)
    s = json.loads(out.stdout)
    assert s["requests"] == 3 and s["tokens"] == 18
    assert {"spec_steps", "spec_acceptance_rate",
            "spec_tokens_per_verify"} <= set(s)
    assert s["spec_steps"] > 0 and s["spec_tokens_per_verify"] >= 1.0
    assert 0.0 <= s["spec_acceptance_rate"] <= 1.0


def test_cli_refuses_the_model_drafter(capsys):
    """The draft model needs trained weights: the CLI offers ngram and
    selfspec only, as the reference's does."""
    with pytest.raises(SystemExit) as exc:
        cli.main(["--device", "cpu", "--spec", "model"])
    assert exc.value.code != 0
    assert "--spec" in capsys.readouterr().err


@pytest.mark.parametrize("name", ["zamba2-smoke", "xlstm-smoke"])
def test_cli_serves_the_recurrent_families(name, monkeypatch):
    """``--model zamba2-smoke`` / ``xlstm-smoke`` serve through the slot
    engine; a paged flag is refused for them with the reference CLI's
    error."""
    s = cli.main(["--device", "cpu", "--model", name, "--requests", "3",
                  "--max-new", "3", "--max-batch", "2"])
    assert s["device"] == "cpu" and s["requests"] == 3 and s["tokens"] == 9
    from repro.launch import serve as jax_cli
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", name, "--paged",
                                      "--requests", "1", "--max-new", "1"])
    with pytest.raises(ValueError, match="attention-only") as want:
        jax_cli.main()
    for flags in (["--paged"], ["--prefix-cache"], ["--async"]):
        with pytest.raises(ValueError, match="attention-only") as got:
            cli.main(["--device", "cpu", "--model", name, "--requests",
                      "1", "--max-new", "1", *flags])
        assert str(got.value) == str(want.value)


# what the port's summary adds to the reference's: the requests' queue
# wait and the window's seconds by engine phase
PORT_SUMMARY_KEYS = {"queue_wait_p50_ms", "queue_wait_p99_ms",
                     "engine_phase_s"}


@pytest.mark.parametrize("paged", [True, False])
def test_summary_has_the_reference_keys(paged):
    """The reference's summary keys, the spec counters included, and
    exactly the port's additions (``PORT_SUMMARY_KEYS``); the nested pool
    and index gauges too."""
    cfg = get_config("nectar-relu-llama-smoke")
    jparams = JaxModel(cfg).init(jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams),
                              torch_get_config(cfg.name), device="cpu")
    kw = dict(paged=paged, max_batch=2, max_seq=64, block_size=8,
              prefix_cache=paged)
    prompt = np.arange(1, 12, dtype=np.int32)
    jeng = JaxEngine(cfg, jparams, JaxServeConfig(**kw))
    jeng.run([JaxRequest(rid=0, prompt=prompt, max_new=3)])
    eng = Engine(torch_get_config(cfg.name), tparams, ServeConfig(**kw),
                 device="cpu")
    eng.run([Request(rid=0, prompt=prompt, max_new=3)])
    js, s = jeng.metrics.summary(), eng.metrics.summary()
    assert set(s) - set(js) == PORT_SUMMARY_KEYS and set(js) <= set(s)
    assert SPEC_KEYS <= set(s)
    assert set(s["kv_pool"]) == set(js["kv_pool"])
    assert set(s["prefix_index"]) == set(js["prefix_index"])
    for key in ("n_finished", "generated_tokens", "decode_steps",
                "prefill_chunks", "spec_steps", "spec_acceptance_rate",
                "spec_tokens_per_verify", "spec_per_request",
                "weight_bytes", "kv_bytes",
                "sparse_savings_bytes", "prefix_lookups", "kv_pool",
                "tpot_overlap_samples", "tpot_steady_samples"):
        assert s[key] == js[key], key
    assert len(eng.stats) == len(jeng.stats)
    eng.reset_metrics()
    assert eng.metrics.summary()["n_finished"] == 0


# ---------------------------------------------------------------------------
# observability flags (--obs, --trace-out, --metrics-port, --profile)

SMOKE = ["--arch", "nectar-relu-llama-smoke", "--requests", "3",
         "--max-new", "4", "--max-batch", "2", "--paged"]


def _reference_cli(argv, monkeypatch, capsys):
    """The reference CLI's JSON output for ``argv`` (its metrics server
    replaced by a stub: the output does not depend on it)."""
    import repro.obs
    from repro.launch import serve as ref_cli
    monkeypatch.setattr(repro.obs, "start_metrics_server",
                        lambda fn, port: None)
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    capsys.readouterr()
    ref_cli.main()
    lines = capsys.readouterr().out.splitlines()
    return json.loads("\n".join(lines[lines.index("{"):]))


# the two CLIs' output without the flags, shared by the flag cases
_BASE = {}


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("flags", [
    ["--obs"], ["--trace-out", "TRACE"], ["--metrics-port", "PORT"],
    ["--profile"]], ids=["obs", "trace-out", "metrics-port", "profile"])
def test_cli_obs_flags_add_the_reference_keys(flags, tmp_path, monkeypatch,
                                              capsys):
    """Each flag adds to the summary the keys it adds to the reference
    CLI's (``ticks``, ``trace_files``, ``bucket_attainment``), with the
    same nested keys; the trace files pass tools/check_trace.py."""
    flags = [str(tmp_path / "t") if f == "TRACE" else
             str(_free_port()) if f == "PORT" else f for f in flags]
    if not _BASE:
        _BASE["ref"] = _reference_cli(SMOKE, monkeypatch, capsys)
        _BASE["port"] = cli.main(["--device", "cpu", *SMOKE])
    ref_base, base = _BASE["ref"], _BASE["port"]
    ref = _reference_cli(SMOKE + flags, monkeypatch, capsys)
    out = cli.main(["--device", "cpu", *SMOKE, *flags])
    added = set(out) - set(base)
    assert added == set(ref) - set(ref_base)
    if "ticks" in added:
        assert set(out["ticks"]) == set(ref["ticks"])
        assert out["ticks"]["n_ticks"] == ref["ticks"]["n_ticks"]
    if "bucket_attainment" in added:
        got = {r["bucket"]: r for r in out["bucket_attainment"]}
        want = {r["bucket"]: r for r in ref["bucket_attainment"]}
        assert set(got) == set(want)
        for b, r in got.items():
            assert set(want[b]) <= set(r) and 0 < r["attain"] <= 1
            assert r["ticks"] == want[b]["ticks"]
        assert "roofline attainment vs cpu-host" in capsys.readouterr().out
    if "trace_files" in added:
        spec = importlib.util.spec_from_file_location(
            "check_trace", ROOT / "tools" / "check_trace.py")
        check_trace = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(check_trace)
        trace, events = out["trace_files"]
        assert check_trace.check_perfetto(trace) == []
        assert check_trace.check_jsonl(events, expect_ordering=True) == []


def test_cli_metrics_port_serves_while_the_requests_run(monkeypatch,
                                                        capsys):
    """``--metrics-port`` serves the engine's live registry on localhost
    during the run and stops with it."""
    import urllib.request
    port = _free_port()
    seen = {}

    class ScrapingEngine(Engine):
        def run(self, *args, **kwargs):
            done = super().run(*args, **kwargs)
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
                seen["body"] = r.read().decode()
            return done

    monkeypatch.setattr(cli, "Engine", ScrapingEngine)
    cli.main(["--device", "cpu", *SMOKE, "--metrics-port", str(port)])
    assert "request_finished_total 3" in seen["body"]
    assert f"127.0.0.1:{port}/metrics" in capsys.readouterr().err
    import urllib.error
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                               timeout=2)


# ---------------------------------------------------------------------------
# disagg and fleet flags (--disagg*, --direct-max-suffix, --replicas,
# --router-policy)


@pytest.mark.parametrize("flags", [
    ["--disagg"],
    ["--disagg", "--disagg-prefill-batch", "1",
     "--disagg-prefill-blocks", "24"],
    ["--disagg", "--direct-max-suffix", "4"],
    ["--replicas", "2"],
    ["--replicas", "2", "--router-policy", "round_robin"],
    ["--replicas", "2", "--router-policy", "least_loaded", "--disagg"]],
    ids=["disagg", "disagg-prefill-sizes", "direct-max-suffix", "replicas",
         "round-robin", "fleet-of-disagg-pools"])
def test_cli_serves_disagg_and_fleet(flags, monkeypatch, capsys):
    """The six flags are served with the reference CLI's meaning: a disagg
    serve adds the reference's keys (``n_handoffs``, ``n_decode_direct``,
    the interference split's p99s) with its counts; a fleet serve prints
    the reference's fleet summary keys (the port says ``tokens_per_s``
    where the reference says ``tok_per_s_cpu``, and adds ``device``) with
    its router counters and per-replica dispatch counts."""
    if not _BASE:
        _BASE["ref"] = _reference_cli(SMOKE, monkeypatch, capsys)
        _BASE["port"] = cli.main(["--device", "cpu", *SMOKE])
    ref = _reference_cli(SMOKE + flags, monkeypatch, capsys)
    out = cli.main(["--device", "cpu", *SMOKE, *flags])
    assert out["requests"] == ref["requests"] == 3
    assert out["tokens"] == ref["tokens"] == 12
    if "--replicas" in flags:
        assert set(out) - {"device", "tokens_per_s"} \
            == set(ref) - {"tok_per_s_cpu"}
        assert out["router"] == ref["router"]
        assert {str(k): v for k, v in out["per_replica_dispatched"].items()} \
            == ref["per_replica_dispatched"]
        assert out["n_replicas"] == 2
        return
    assert set(out) - set(_BASE["port"]) == set(ref) - set(_BASE["ref"])
    assert (out["n_handoffs"], out["n_decode_direct"]) \
        == (ref["n_handoffs"], ref["n_decode_direct"])
    assert out["n_handoffs"] + out["n_decode_direct"] == 3
