"""Quickstart on the port: build a model from the registry, train it a
little on the synthetic TinyStories stream, and greedy-decode a
continuation.

    PYTHONPATH=src python -m repro_torch.examples.quickstart \\
        [--arch llama3.2-1b-smoke] [--steps 40] [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Optional

import torch

from repro_torch.configs import get_config, list_configs
from repro_torch.configs.base import TrainConfig
from repro_torch.device import resolve_device
from repro_torch.examples import device_name, resolve
from repro_torch.models import Model
from repro_torch.train import data
from repro_torch.train.loop import run_training


def source(cfg) -> data.TinyStoriesSynth:
    return data.TinyStoriesSynth(data.DataConfig(
        seq_len=48, batch_size=4, vocab_size=cfg.vocab))


def train(cfg, params, device, steps: int):
    """``steps`` steps from ``params`` (None: the trainer's seeded init);
    (params, info)."""
    tcfg = TrainConfig(lr=3e-3, warmup_steps=5, total_steps=steps)
    params, _, info = run_training(Model(cfg), cfg, tcfg, source(cfg),
                                   steps=steps, params=params, log_every=10,
                                   device=device)
    return params, info


@torch.no_grad()
def decode(cfg, params, device, n_new: int = 12):
    """Greedy continuation of the first 8 tokens of batch 999: the prompt
    and 1 + ``n_new`` tokens (prefill, then one decode step a token)."""
    device = resolve_device(device)
    model = Model(cfg)
    prompt = torch.as_tensor(source(cfg).batch_at(999)["tokens"][:1, :8])
    cache = model.init_cache(1, 64, torch.float32, device=device)
    logits, cache = model.prefill(params, prompt.to(device), cache)
    toks = [int(torch.argmax(logits[0, -1]))]
    for _ in range(n_new):
        tok = torch.tensor([[toks[-1]]], dtype=torch.int32, device=device)
        lg, cache = model.decode_step(params, tok, cache)
        toks.append(int(torch.argmax(lg[0, 0])))
    return [int(t) for t in prompt[0]], toks


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="nectar-relu-llama-1.7m",
                    help=f"one of: {', '.join(list_configs())}")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve(args.device)

    cfg = get_config(args.arch)
    print(f"arch={cfg.name} family={cfg.family} "
          f"params~{cfg.param_count():,} on {device_name(device)}")
    params, info = train(cfg, None, device, args.steps)
    for step, m in info["history"]:
        print(f"  step {step:4d}  ce={m['ce']:.3f}  ppl={m['ppl']:.1f}")

    prompt, toks = decode(cfg, params, device)
    inv = {v: k for k, v in data.VOCAB.items()}
    print("prompt :", " ".join(inv.get(t, "?") for t in prompt))
    print("decoded:", " ".join(inv.get(t, "?") for t in toks))
    return {"params": params, "history": info["history"], "prompt": prompt,
            "decoded": toks}


if __name__ == "__main__":
    main()
