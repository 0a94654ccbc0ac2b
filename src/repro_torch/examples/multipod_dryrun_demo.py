"""Drive the port's multi-pod dry run for one cell and print its roofline
terms at the H100 SXM.

(The full sweep is ``python -m repro_torch.launch.dryrun --all --mesh
both``.) The dry run counts from shapes on meta devices, so this runs in
process and needs no card.

    PYTHONPATH=src python -m repro_torch.examples.multipod_dryrun_demo \\
        [--arch llama3.2-1b] [--shape decode_32k]
"""

from __future__ import annotations

import argparse
import json
from typing import Optional

from repro_torch.launch import dryrun
from repro_torch.roofline import analysis


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--device", default="cuda",
                    help="accepted for a common command line; the dry run "
                         "touches no device")
    args = ap.parse_args(argv)

    records = {}
    for mesh in ("pod", "multipod"):
        argv_mesh = ["--arch", args.arch, "--shape", args.shape,
                     "--mesh", mesh]
        print("$ python -m repro_torch.launch.dryrun", " ".join(argv_mesh))
        records[mesh] = dryrun.main(argv_mesh)[0]

    row = analysis.cell_roofline(args.arch, args.shape)
    print(json.dumps(row, indent=1))
    hint = analysis.improvement_hint(row)
    print("hint:", hint)
    return {"records": records, "row": row, "hint": hint}


if __name__ == "__main__":
    main()
