"""What the benchmark runs loads neither the JAX stack nor the JAX package,
reads nothing under ``benchmarks/``, and never falls back to the CPU.

Each check runs in a fresh interpreter: this test process already holds
JAX (``tests/conftest.py`` loads it for the JAX package's tests). Top-level
module names are compared whole: the measured package ``repro_torch``
begins with ``repro``, the JAX package's name."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

from bench.harness import cell

ROOT = cell.ROOT
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

_PROBE = r"""
import json, sys, tempfile
from pathlib import Path
root = Path(sys.argv[1])
sys.path[:0] = [str(root), str(root / "src")]
opened = []
def audit(event, args):
    if event == "open" and isinstance(args[0], (str, bytes, Path)):
        p = str(args[0] if not isinstance(args[0], bytes) else args[0].decode())
        if str(root / "benchmarks") in str(Path(p).resolve()):
            opened.append(p)
sys.addaudithook(audit)
import torch
torch.set_num_threads(1)
from bench.harness import cell, smoke
from bench import calibrate, run  # noqa: F401  (every entry point)
for name in ("qwen3-4b.long-decode", "qwen2.5-3b.doc-repeat"):
    with tempfile.TemporaryDirectory() as tmp:
        b, spec = smoke.smoke_bench(tmp, name)
        out = cell.run(name, 3, 1.0, name.endswith("repeat"), device="cpu",
                       spec=spec, bench=b)
tops = sorted({m.split(".")[0] for m in sys.modules})
print(json.dumps({"modules": tops, "opened": opened,
                  "correct": out["correct"]}))
"""


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "JAX_PLATFORMS")}
    env["OMP_NUM_THREADS"] = "1"
    return env


def test_a_run_loads_no_jax_and_reads_no_benchmarks_folder():
    out = subprocess.run([sys.executable, "-c", _PROBE, str(ROOT)],
                         capture_output=True, text=True, env=_env(),
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch" in res["modules"]
    assert not FORBIDDEN & set(res["modules"]), res["modules"]
    assert res["opened"] == []
    assert res["correct"]


def test_no_card_means_an_error_and_no_result():
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "qwen3-4b.long-decode",
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True,
        env=dict(_env(), CUDA_VISIBLE_DEVICES=""), timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "CUDA card" in out.stderr


def test_benchmark_files_alone_are_no_run(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's folder
    (no program) exits with an error and prints no result."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(cell.BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "qwen3-4b.long-decode",
         "--seed", "7", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, env=_env(), timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "src/repro_torch" in out.stderr


def test_sources_name_neither_jax_nor_the_benchmarks_folder():
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|repro)(\s|\.|$)",
                     re.M)
    for path in cell.BENCH.rglob("*.py"):
        text = path.read_text()
        assert not bad.search(text), path
        if not path.name.startswith("test_bench_"):
            assert "benchmarks/" not in text, path
