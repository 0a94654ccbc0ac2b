"""The correctness check of a served model, and its control.

Once the window has closed, a sample of the requests the window finished
(drawn from the seed, the longest always in it), and one request that
the window admitted and prefilled whole (unfinished where one is), are
run through the plain float32 reference (``bench/reference``), each
prompt with the tokens the program served to its client after it. Every served token was greedy, so it should be
the reference's best at its position, up to the program's rounding: the
number compared is the widest gap by which a served token's logit lies
below the reference's best there (``max_gap``, in logits).

The control puts the reference in the program's place at the precision
below the configuration's (bfloat16 -> float8 e4m3, ``quant="fp8"``): at
each judged position it takes the token the fp8 forward puts first and
reads that token's gap in the float32 reference. ``bench/calibrate.py``
reads it; a run never does.

A cell's limits live in ``bench/checks/<cell>.json``: how many finished
requests the check samples (``requests``; the admitted one comes on top)
and the limit on ``max_gap``, with the readings it was set from.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Dict

import numpy as np

from bench.reference import qwen

BENCH = Path(__file__).resolve().parents[1]


def limits(cell: str, bench: Path = BENCH) -> dict:
    return json.loads((bench / "checks" / f"{cell}.json").read_text())


def sample(clients: list, t1: float, seed: int, n: int) -> list:
    """The requests judged: the longest that finished by ``t1`` (prompt
    and served tokens), n - 1 more of those drawn from the seed, and one
    that the window admitted (not under way at its start) and that has
    served a token: one whose prompt the prefix cache held none of, so
    that the window prefilled all of it, before one it held part of; an
    unfinished one before a finished one not yet judged; the most served
    tokens first."""
    order = sorted(clients, key=lambda c: c.rid)
    finished = [c for c in order if c.done_t is not None and c.done_t <= t1]
    picked = []
    if finished:
        total = [len(c.req.prompt) + len(c.tokens) for c in finished]
        first = int(np.argmax(total))
        rest = [i for i in range(len(finished)) if i != first]
        rng = np.random.default_rng([int(seed), 99])
        pick = rng.permutation(len(rest))[:max(n - 1, 0)]
        picked = [finished[first]] + [finished[rest[i]]
                                      for i in sorted(pick)]
    admitted = [c for c in order if not c.req.resumed and c.tokens
                and all(c is not p for p in picked)]
    if admitted:
        picked.append(max(admitted, key=lambda c: (
            c.cached == 0, c.done_t is None or c.done_t > t1,
            len(c.tokens))))
    return picked


def sequence(c):
    """(tokens, judged positions, served tokens) of one request as its
    client saw it: logits at position p predict the token at p + 1."""
    prompt = np.asarray(c.req.prompt, np.int64).reshape(-1)
    served = np.asarray(c.tokens, np.int64).reshape(-1)
    toks = np.concatenate([prompt, served])
    judge = list(range(len(prompt) - 1, len(toks) - 1))
    return toks, judge, served


def gaps(weights: dict, hf: dict, c, control: bool = False
         ) -> Dict[str, np.ndarray]:
    """Per served token: ``served`` = the reference's best logit minus the
    served token's; with ``control``, ``control`` = the same gap of the
    token the fp8 forward puts first."""
    import torch
    dev = weights["embed"].device
    toks, judge, served = sequence(c)
    t = torch.as_tensor(toks, device=dev)
    ref = qwen.forward(weights, hf, t, judge)
    best = ref.max(dim=-1).values
    s = torch.as_tensor(served, device=dev)
    out = {"served": (best - ref.gather(1, s[:, None])[:, 0]).cpu().numpy()}
    if control:
        low = qwen.forward(weights, hf, t, judge, quant="fp8")
        pick = low.argmax(dim=-1)
        out["control"] = (best - ref.gather(1, pick[:, None])[:, 0]
                          ).cpu().numpy()
    return out


def check(weights: dict, hf: dict, clients: list, t1: float, seed: int,
          lim: dict, control: bool = False) -> dict:
    """``correct`` and the numbers compared, each beside its limit; the
    same lines go to standard error, last. With ``control`` (calibration
    only) the result also holds the control's widest gap on the same
    sample (``control_max_gap``)."""
    picked = sample(clients, t1, seed, int(lim["requests"]))
    widest = low = None
    n_tok = 0
    for c in picked:
        g = gaps(weights, hf, c, control=control)
        n_tok += len(g["served"])
        widest = max(float(g["served"].max()), widest or 0.0)
        if control:
            low = max(float(g["control"].max()), low or 0.0)
    ok = widest is not None and widest <= lim["max_gap"]
    checks = {"max_gap": {"value": widest, "limit": lim["max_gap"]},
              "judged_tokens": {"value": n_tok, "limit": 1},
              "judged_requests": {"value": len(picked), "limit": 1}}
    ok = ok and n_tok >= 1
    for name, c in checks.items():
        cmp = "<=" if name == "max_gap" else ">="
        print(f"check {name} {c['value']} {cmp} {c['limit']}",
              file=sys.stderr)
    out = {"correct": bool(ok), "checks": checks}
    if control:
        out["control_max_gap"] = low
    return out
