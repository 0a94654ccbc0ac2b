"""The paper's end-to-end application (NeCTAr §V-A, Table II), on the port:

  1. train the 1.7M ReLU-Llama on (synthetic) TinyStories,
  2. measure the activation sparsity ReLU induces,
  3. serve it with batched requests through the slot engine, dense vs
     NeCTAr-sparse decode,
  4. report the off-chip weight-read reduction (the paper: "halves weight
     reads") and tokens/s on the device that served.

    PYTHONPATH=src python -m repro_torch.examples.relu_llama_e2e \\
        [--steps 200] [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ServeConfig, TrainConfig
from repro_torch.core import sparsity as sp
from repro_torch.device import resolve_device
from repro_torch.examples import device_name, resolve, sync
from repro_torch.models import Model, layers
from repro_torch.serve.engine import Engine
from repro_torch.serve.scheduler import Request
from repro_torch.train import data
from repro_torch.train.loop import run_training

# the paper chip's off-chip rate: Table II's 3.2 GB/s NeCTAr SoC
PAPER_CHIP_BYTES_PER_S = 3.2e9
MODES = (("dense", False), ("nectar-sparse", True))


def source(cfg) -> data.TinyStoriesSynth:
    return data.TinyStoriesSynth(data.DataConfig(
        seq_len=64, batch_size=8, vocab_size=cfg.vocab))


def train(cfg, params, device, steps: int):
    """``steps`` steps of the example's schedule from ``params`` (None: the
    trainer's own seeded init); (params, info)."""
    tcfg = TrainConfig(lr=3e-3, warmup_steps=10, total_steps=steps)
    params, _, info = run_training(Model(cfg), cfg, tcfg, source(cfg),
                                   steps=steps, params=params, log_every=25,
                                   device=device)
    return params, info


@torch.no_grad()
def layer_sparsity(cfg, params, device) -> list:
    """The fraction of zeros after ReLU in each layer's FFN hidden, on
    batch 0 of the source (every layer reads the embedded tokens, as the
    reference's example does)."""
    batch = source(cfg).batch_at(0)
    tokens = torch.as_tensor(batch["tokens"]).to(resolve_device(device))
    x = params["embed"][tokens.long()]
    b0 = params["units"]["b0"]
    fracs = []
    for u in range(cfg.n_units):
        h = layers.rms_norm(x, b0["norm2"][u], cfg.norm_eps)
        hidden = torch.relu(h @ b0["ffn"]["w_up"][u])
        fracs.append(float(sp.sparsity_fraction(hidden)))
    return fracs


def make_engine(cfg, params, device, sparse: bool) -> Engine:
    """The example's slot engine, dense or NeCTAr-sparse decode."""
    return Engine(cfg, params, ServeConfig(max_batch=4, max_seq=96,
                                           sparse_decode=sparse),
                  device=device)


def requests(cfg) -> dict:
    """Per mode, 8 requests of 8-token prompts and 24 new tokens (one
    ``default_rng(0)`` stream, the dense mode's drawn first)."""
    rng = np.random.default_rng(0)
    return {mode: [Request(rid=i, prompt=rng.integers(0, cfg.vocab, size=8,
                                                      dtype=np.int32),
                           max_new=24) for i in range(8)]
            for mode, _ in MODES}


def run_mode(eng: Engine, reqs, device) -> dict:
    """Serve ``reqs``: tokens by rid, tokens/s, seconds, steps and the
    mean weight bytes of a decode step."""
    sync(device)
    t0 = time.perf_counter()
    done = eng.run(reqs, max_steps=1000)
    sync(device)
    dt = time.perf_counter() - t0
    n_tok = sum(len(r.tokens_out) for r in done.values())
    return {"tokens": {rid: [int(t) for t in r.tokens_out]
                       for rid, r in sorted(done.items())},
            "n_tokens": n_tok, "wall_s": dt, "tokens_per_s": n_tok / dt,
            "steps": len(eng.stats),
            "weight_bytes_per_token": float(np.mean(
                [s.weight_bytes for s in eng.stats]))}


def serve_modes(cfg, params, device) -> dict:
    """The requests through the slot engine with dense and then sparse
    decode; ``run_mode``'s record per mode."""
    reqs = requests(cfg)
    return {mode: run_mode(make_engine(cfg, params, device, sparse),
                           reqs[mode], device)
            for mode, sparse in MODES}


def report(results: dict) -> dict:
    """The weight-read reduction and the paper chip's modeled inferences
    a second (a 64-token completion at Table II's rate)."""
    wd = results["dense"]["weight_bytes_per_token"]
    ws = results["nectar-sparse"]["weight_bytes_per_token"]
    per = PAPER_CHIP_BYTES_PER_S / 64
    return {"weight_read_reduction": wd / ws,
            "paper_chip_infs_per_s": {"dense": per / wd, "sparse": per / ws}}


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve(args.device)
    where = device_name(device)

    cfg = get_config("nectar-relu-llama-1.7m")
    print(f"[1/4] training {cfg.name} ({cfg.param_count():,} params, "
          f"act={cfg.act}, glu={cfg.glu}) on synthetic TinyStories "
          f"({where})")
    params, info = train(cfg, None, device, args.steps)
    for step, m in info["history"]:
        print(f"    step {step:4d}  ce={m['ce']:.3f}")

    print("[2/4] activation sparsity after ReLU (paper mechanism):")
    fracs = layer_sparsity(cfg, params, device)
    print("    per-layer frac zeros:", " ".join(f"{f:.2f}" for f in fracs))

    results = serve_modes(cfg, params, device)
    for mode, _ in MODES:
        r = results[mode]
        print(f"[3/4] served 8 requests, {mode} decode: {r['n_tokens']} "
              f"tokens in {r['wall_s']:.2f}s ({r['tokens_per_s']:.1f} "
              f"tok/s on {where}), weight bytes/token="
              f"{r['weight_bytes_per_token']:,.0f}")

    rep = report(results)
    infs = rep["paper_chip_infs_per_s"]
    print("[4/4] paper-claim check (Table II / ref [11]):")
    print(f"    weight-read reduction: {rep['weight_read_reduction']:.2f}x "
          f"(paper: ~2x 'halve weight reads')")
    print(f"    modeled infs/s of the paper's NeCTAr SoC (64-token "
          f"completion at 3.2 GB/s): dense={infs['dense']:.2f} "
          f"sparse={infs['sparse']:.2f} (paper measured 1.19 -> 1.28 "
          f"infs/s)")
    return {"device": where, "params": params, "history": info["history"],
            "train_wall_s": info["wall_s"], "sparsity": fracs,
            "serve": results, **rep}


if __name__ == "__main__":
    main()
