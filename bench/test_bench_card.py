"""On the card: each cell's control fails its limit and the program passes
it, at the cell's own size, on three seeds (``bench/calibrate.py``, one
process a cell; minutes a cell). Skips without a card."""

import json
import subprocess
import sys

import pytest

from bench.harness import cell, oracle

SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in
                                  cell.load_spec()["workloads"]])
def test_control_fails_and_program_passes(name):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "bench/calibrate.py", "--workload", name,
         "--seconds", "10", "--seeds", *map(str, SEEDS)],
        cwd=cell.ROOT, capture_output=True, text=True, timeout=3000)
    assert out.returncode == 0, out.stderr[-3000:]
    limit = oracle.limits(name)["max_gap"]
    for line in out.stdout.strip().splitlines():
        r = json.loads(line)
        assert r["max_gap"] <= limit < r["control_max_gap"], r
