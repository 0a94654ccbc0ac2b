"""Readings that set a cell's correctness limit (``bench/checks/<cell>.json``).

    python3 bench/calibrate.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

For each seed, in one process: a run of the cell as the benchmark makes
it (its set-up, traffic and window, here as long as ``--seconds``), the
check's sample judged by the float32 reference, and on the same sample
the control (the reference in float8 e4m3, the precision below the
configurations' bfloat16). One JSON line a seed: ``max_gap`` (the
program's widest gap: the lower readings) and ``control_max_gap`` (the
upper). The benchmark's own runs never run the control.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None,
                    help="also append each line to this file")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from bench import run as bench_run
    from bench.harness import cell
    bench_run._fixed_caches()
    sys.setrecursionlimit(bench_run.RECURSION_LIMIT)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    t = T_START
    for seed in args.seeds:
        out = cell.run(args.workload, seed, args.seconds, False,
                       device="cuda", t_start=t, control=True)
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "max_gap": out["checks"]["max_gap"]["value"],
                           "control_max_gap": out["control_max_gap"],
                           "judged_tokens":
                               out["checks"]["judged_tokens"]["value"],
                           "metrics": out["metrics"],
                           "samples": out["samples"]})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        # the next seed's pool is built at twice its size: hand back every
        # block this one's left cached
        del out
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
