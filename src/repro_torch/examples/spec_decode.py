"""Speculative decoding demo on the port: draft/verify on the paged engine.

  * a token stream produced by draft->verify ticks (api.generate works
    unchanged: speculation changes cost, never content),
  * all three drafters (n-gram prompt lookup, a scaled-down draft model,
    self-speculation through the sparsity predictor),
  * acceptance-rate / tokens-per-verify metrics and adaptive K on
    repetitive text, and greedy outputs token-identical across drafters.

    PYTHONPATH=src python -m repro_torch.examples.spec_decode [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np

from repro_torch.configs import get_config
from repro_torch.configs.base import ServeConfig, SpecConfig
from repro_torch.examples import device_name, resolve, seeded
from repro_torch.models import Model
from repro_torch.serve import api
from repro_torch.serve.engine import Engine
from repro_torch.serve.scheduler import Request

DRAFT_NAME = "nectar-relu-llama-draft"
# the drafter menu: (label, SpecConfig or None for the baseline)
MENU = (("baseline (no spec)", None),
        ("ngram", SpecConfig(drafter="ngram", k=4, k_max=6)),
        ("model (draft cfg)", SpecConfig(drafter="model", k=4, k_max=6,
                                         draft_name=DRAFT_NAME)),
        ("selfspec (predictor)", SpecConfig(drafter="selfspec", k=4,
                                            k_max=6)))


def scfg(spec) -> ServeConfig:
    return ServeConfig(max_batch=2, max_seq=256, paged=True, block_size=16,
                       prefill_chunk=32, spec=spec)


def stream(cfg, params, device) -> dict:
    """A 7-token motif repeated 6 times, streamed through the n-gram
    drafter (default_rng(0)'s first draw)."""
    rng = np.random.default_rng(0)
    eng = Engine(cfg, params, scfg(SpecConfig(drafter="ngram", k=6,
                                              k_max=6)), device=device)
    motif = rng.integers(0, cfg.vocab, size=7, dtype=np.int32)
    toks = [int(t) for t in api.generate(eng, np.tile(motif, 6),
                                         max_new=16)]
    return {"tokens": toks, "summary": eng.metrics.summary()}


def repetitive_prompts(cfg) -> list:
    """Two prompts of a 7-token motif repeated 6 times, drawn after the
    stream's motif from the same default_rng(0)."""
    rng = np.random.default_rng(0)
    rng.integers(0, cfg.vocab, size=7, dtype=np.int32)
    return [np.tile(rng.integers(0, cfg.vocab, 7, dtype=np.int32), 6)
            for _ in range(2)]


def run_one(cfg, params, device, spec, prompts, max_new=24,
            draft_params=None, drafter=None) -> dict:
    """The prompts through one drafter (``drafter`` injects a ready one):
    tokens by rid, the metrics summary and the final K."""
    eng = Engine(cfg, params, scfg(spec), device=device,
                 draft_params=draft_params, drafter=drafter)
    reqs = [Request(rid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)]
    eng.run(reqs, max_steps=5000)
    return {"tokens": {i: [int(t) for t in r.tokens_out]
                       for i, r in enumerate(reqs)},
            "summary": eng.metrics.summary(),
            "final_k": eng.kctl.k if spec is not None else None}


def menu(cfg, params, device, draft_params, drafters=None) -> dict:
    """Every drafter of MENU on the repetitive prompts; ``drafters`` maps
    a label to a ready drafter for it."""
    prompts = repetitive_prompts(cfg)
    drafters = drafters or {}
    return {label: run_one(
        cfg, params, device, spec, prompts,
        draft_params=draft_params if spec and spec.drafter == "model"
        else None, drafter=drafters.get(label)) for label, spec in MENU}


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve(args.device)
    cfg = get_config("nectar-relu-llama-1.7m")
    params = Model(cfg).init(seeded(device, 0), device=device)

    st = stream(cfg, params, device)
    s = st["summary"]
    print(f"streaming generate (ngram drafter, {device_name(device)}):",
          " ".join(map(str, st["tokens"])))
    print(f"  {s['spec_steps']} verify steps for {s['generated_tokens']} "
          f"tokens (acceptance {s['spec_acceptance_rate']:.2f})\n")

    dparams = Model(get_config(DRAFT_NAME)).init(seeded(device, 7),
                                                 device=device)
    runs = menu(cfg, params, device, dparams)
    print("drafter menu, repetitive prompts:")
    for label, r in runs.items():
        s = r["summary"]
        k = "-" if r["final_k"] is None else r["final_k"]
        print(f"  {label:<22} verify_steps={s['spec_steps']:<4} "
              f"accept={s['spec_acceptance_rate']:.2f}  "
              f"tok/verify={s['spec_tokens_per_verify']:.2f}  final_K={k}")
    outs = [r["tokens"] for r in runs.values()]
    same = all(o == outs[0] for o in outs[1:])
    print(f"  greedy outputs token-identical across drafters: {same}")
    return {"stream": st, "menu": runs, "identical": same}


if __name__ == "__main__":
    main()
