"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the NVIDIA card(s) the
cell asks for. ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics and the device trace. The last line of
standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``,
and last ``checks``: each number the correctness check compared, with
its limit); the same checks are the last lines of standard error.

Exits non-zero and prints no result when there is no CUDA card (or fewer
than the cell asks for), when the program (``src/repro_torch``) is not in
the checkout, or when the JAX stack or the JAX package is loaded once the
window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "bench-cache"
# The program's radix prefix index walks its tree recursively, one Python
# frame a KV block (``serve/prefix_cache.py`` ``_count_reclaimable``): a
# 16k-token document is about 1,030 blocks, past CPython's default limit
# of 1,000 frames. A deployment serving such documents raises the limit;
# so does the benchmark (pure-Python frames, no C stack), and every result
# line records it (``window.recursion_limit``).
RECURSION_LIMIT = 10_000


def _fixed_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("bench: the program (src/repro_torch) is not in this checkout",
              file=sys.stderr)
        return 2
    _fixed_caches()
    sys.setrecursionlimit(RECURSION_LIMIT)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from bench.harness import cell
    spec = cell.load_spec(ROOT)
    want = cell.find_cell(spec, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < want:
        print(f"bench: the cell needs {want} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = cell.run(args.workload, args.seed, args.seconds, bool(args.trace),
                   device="cuda", spec=spec, t_start=T_START)
    out["card"] = _power_limit()
    checks = out.pop("checks")
    out["checks"] = checks          # last
    found = cell.forbidden_modules()
    if found:
        print(f"bench: loaded in this process: {found}", file=sys.stderr)
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
