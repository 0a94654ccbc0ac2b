"""Training entry point of the port: the reference's CLI with the whole
fault-tolerance story wired in: the preemption guard (SIGTERM or SIGINT
-> checkpoint -> exit), the restart policy (reload the latest checkpoint
and retry), deterministic seekable data and atomic keep-k checkpoints.
A run resumes from the latest checkpoint in ``--ckpt-dir``.

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch nectar-relu-llama-1.7m --steps 200 --ckpt-dir CKPT \\
        [--adam-8bit] [--device cpu]

It runs on the CUDA device unless ``--device cpu`` is given, and prints
a JSON summary: the last logged step's metrics and the wall time.
``python -m repro_torch.launch.serve --ckpt-dir CKPT`` serves the
latest checkpoint's params.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import List, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.device import resolve_device
from repro_torch.models import Model
from repro_torch.train import checkpoint, data, fault
from repro_torch.train import optimizer as opt
from repro_torch.train.loop import run_training


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="nectar-relu-llama-1.7m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "nectar_ckpt"))
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--adam-8bit", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu runs the plain "
                         "versions of the kernels)")
    return ap


def like_state(model: Model, tcfg: TrainConfig) -> dict:
    """The structure of a training checkpoint, {"params", "opt"}, on the
    meta device (no memory): what ``checkpoint.restore`` fills."""
    params = model.init(torch.Generator(), device="meta")
    init, _ = opt.make_optimizer(tcfg)
    return {"params": params, "opt": init(params)}


def main(argv: Optional[List[str]] = None) -> dict:
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    model = Model(cfg)
    tcfg = TrainConfig(lr=args.lr, warmup_steps=10, total_steps=args.steps,
                       checkpoint_every=args.checkpoint_every,
                       adam_8bit=args.adam_8bit)
    src = data.TinyStoriesSynth(data.DataConfig(
        seq_len=args.seq, batch_size=args.batch, vocab_size=cfg.vocab))
    guard = fault.PreemptionGuard().install()
    out = {}

    def attempt(n):
        params = opt_state = None
        start = 0
        latest = checkpoint.latest_step(args.ckpt_dir)
        if latest is not None:
            restored, man = checkpoint.restore(
                args.ckpt_dir, latest, like_state(model, tcfg), device=device)
            params, opt_state = restored["params"], restored["opt"]
            start = man["data_cursor"]
            print(f"[train] resumed from step {latest}")

        def on_ckpt(step, p, o):
            checkpoint.save(args.ckpt_dir, step, {"params": p, "opt": o},
                            data_cursor=step, keep=tcfg.keep_checkpoints)
            print(f"[train] checkpoint @ {step}")

        params, opt_state, info = run_training(
            model, cfg, tcfg, src, steps=args.steps, params=params,
            opt_state=opt_state, start_step=start, guard=guard,
            on_checkpoint=on_ckpt, device=device)
        out.update(final=info["history"][-1] if info["history"] else None,
                   wall_s=info["wall_s"], start_step=start,
                   steps_done=info["steps_done"])
        print(json.dumps(out, indent=1))
        return info["steps_done"]

    fault.RestartPolicy(max_restarts=2).run(attempt)
    return out


if __name__ == "__main__":
    main()
