"""Acceptance rules for speculative decoding (numpy, on the host).

Each rule consumes the target logits of one verify pass: ``logits[j]`` is
the target's distribution for the token FOLLOWING position j, the
position draft ``d_{j+1}`` claims. Greedy acceptance reproduces the
non-speculative greedy stream token for token; rejection-sampling
acceptance (Leviathan et al., "Fast Inference from Transformers via
Speculative Decoding") keeps temperature sampling distribution-correct:
each emitted token is marginally distributed exactly as if the target had
sampled it alone. The rules are built on the same primitives as the
host sampler (``serve.sampling``): one softmax, one categorical draw.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve.sampling import (SamplingParams, categorical_np,
                                        filter_logits_np, softmax)


def greedy_accept(draft: np.ndarray,
                  target_argmax: np.ndarray) -> Tuple[List[int], int]:
    """Accept the longest draft prefix matching the target argmax chain.

    draft: i32[m]; target_argmax: i32[m+1]. Returns (emitted tokens,
    n_accepted): the accepted prefix plus one token the target supplies
    for free (the correction at the first divergence, or the bonus token
    when everything matched), so a verify step emits >= 1 token."""
    a = 0
    emitted: List[int] = []
    for j, d in enumerate(np.asarray(draft).tolist()):
        if d != int(target_argmax[j]):
            break
        emitted.append(int(d))
        a += 1
    emitted.append(int(target_argmax[a]))
    return emitted, a


def _accept_one(rng: np.random.Generator, d: int, p: np.ndarray,
                q: Optional[np.ndarray]) -> Tuple[bool, np.ndarray]:
    """The accept test of draft token ``d`` against target law ``p``:
    accept with probability min(1, p(d)/q(d)); returns (accepted, the
    residual law a rejection draws from). ``q`` None is a deterministic
    (one-hot) proposal."""
    if q is None:
        q_d = 1.0
        resid = p.copy()
        resid[d] = 0.0
    else:
        q = q.astype(np.float64)
        q_d = q[d]
        resid = np.maximum(p - q, 0.0)
    if rng.random() < min(1.0, p[d] / max(q_d, 1e-12)):
        return True, resid
    return False, resid


def _resample(rng: np.random.Generator, resid: np.ndarray,
              p: np.ndarray) -> int:
    total = resid.sum()
    if total <= 0:                      # q == p exactly: resample p
        resid, total = p, p.sum()
    return categorical_np(rng, resid / total)


def rejection_accept(rng: np.random.Generator, draft: np.ndarray,
                     qdists: Optional[np.ndarray], logits: np.ndarray,
                     temperature: float) -> Tuple[List[int], int]:
    """Distribution-correct acceptance for temperature sampling: each
    draft x ~ q is accepted with probability min(1, p(x)/q(x)); the first
    rejection emits a sample of ``normalize(max(p - q, 0))`` and stops; if
    every draft survives, a bonus sample of the next position's p.

    draft: i32[m]; qdists: f32[m, V] proposal laws, or None for a
    deterministic drafter (one-hot q: the accept probability is p(x), the
    residual p with x's mass removed); logits: f32[m+1, V]."""
    m = len(draft)
    emitted: List[int] = []
    for j in range(m):
        d = int(draft[j])
        p = softmax(logits[j], temperature)
        ok, resid = _accept_one(rng, d, p,
                                None if qdists is None else qdists[j])
        if ok:
            emitted.append(d)
            continue
        emitted.append(_resample(rng, resid, p))
        return emitted, j
    emitted.append(categorical_np(rng, softmax(logits[m], temperature)))
    return emitted, m


def filtered_accept(rng: np.random.Generator, draft: np.ndarray,
                    qdists: Optional[np.ndarray], logits: np.ndarray,
                    sp: SamplingParams, seen: Sequence[int]
                    ) -> Tuple[List[int], int]:
    """Acceptance under a request's full SamplingParams: the target law
    at every position is the filtered one (repetition penalty, top-k,
    top-p at the request temperature, ``filter_logits_np``), the law the
    non-speculative sampler draws from. The penalty's seen-set advances
    with each accepted token, as sequential decoding would advance it.

    ``sp`` carries a resolved temperature; ``seen`` is the committed
    stream (prompt + generated). A draft token the filters exclude has
    p(x) = 0 and is rejected with probability 1."""
    seen = set(int(t) for t in seen)
    greedy = (sp.temperature or 0.0) <= 0
    m = len(draft)
    emitted: List[int] = []

    def target(j):
        z = filter_logits_np(logits[j], sp, seen)
        if greedy:
            return int(np.argmax(z)), None
        return None, softmax(z, sp.temperature)

    for j in range(m):
        d = int(draft[j])
        tgt, p = target(j)
        if greedy:
            if d != tgt:
                emitted.append(tgt)         # correction at divergence
                return emitted, j
            emitted.append(d)
            seen.add(d)
            continue
        ok, resid = _accept_one(rng, d, p,
                                None if qdists is None else qdists[j])
        if ok:
            emitted.append(d)
            seen.add(d)
            continue
        emitted.append(_resample(rng, resid, p))
        return emitted, j
    tgt, p = target(m)                      # all accepted: bonus token
    emitted.append(tgt if greedy else categorical_np(rng, p))
    return emitted, m
