"""The one traffic generator: a closed loop of clients over a queue of
requests, every length drawn from the seed.

A traffic mix is a JSON file of parameters (``bench/traffic/<mix>.json``)
that this module reads; nothing here knows a mix by name. Its keys:

- ``clients``: the closed loop's concurrency. Each client sends its next
  request, the queue's next entry, as soon as its last one has finished.
- ``prompt``, ``output``: length laws (tokens) of the prompt (with
  ``shared``: the question after the document) and of the answer. A law is
  ``{"median", "sigma", "min", "max"}``: lognormal, clipped.
- ``shared`` (optional): documents that several requests ask about.
  ``doc`` is the document length law, ``asks`` how many requests ask about
  each document, and ``spacing`` how many queue places lie between two
  asks of one document (coprime with ``asks``): ask k of document m sits at
  queue place ``asks * m + k * spacing``, so the asks of one document go
  to different clients at interleaved times. A prompt is its document,
  then its question.
- Lengths follow each law along a low-discrepancy sequence
  (``_Stream``): any stretch of the queue spreads evenly over the law.
  The sizes at each place are the same for every seed, and so is the
  order in which the clients' first requests take their slots, so the
  seed does not change the work a window holds (a window finishes some
  tens of requests, and which long documents fall in it set its tail);
  the seed draws only the tokens and the weights.
- ``serve``: ServeConfig fields this mix sets (``max_batch`` is the
  concurrency).
- ``warm_max`` (optional): the most tokens of a first request's context
  that set-up writes (its residual output is kept whole).

The window opens on a loop in its steady state, not on a cold start. Each
client's first request is drawn from the law of the request in flight at a
random instant (its lifetime in engine ticks, length-biased) at an age
spread uniformly over that lifetime; these sizes are the same for every
seed. What it has already done by that age,
prompt chunks prefilled or tokens generated (as prompt tokens), is written
into the prefix cache in set-up (``warm_prompts``); its first token
arrives within the window, but it is a request already under way, so it
adds no sample of time to first token (``resumed``). Documents that the
queue's first entries ask about again are warmed the same way.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
from typing import List

import numpy as np

_NORMAL = statistics.NormalDist()
# stream tags: each kind of draw has its own stream of the seed
_DOC, _QUESTION, _PROMPT, _OUTPUT, _DOCLEN, _WARM, _AGE = range(7)
_NEG = 1 << 20          # offset of the documents asked before the window


@dataclasses.dataclass
class Req:
    """One request as a client sends it: prompt tokens, the answer's
    length, and whether it is a request already under way when the window
    opens."""
    prompt: np.ndarray
    max_new: int
    resumed: bool = False


def law_value(law: dict, u: float) -> int:
    """The clipped lognormal law's quantile at u in (0, 1), in tokens."""
    v = math.exp(math.log(law["median"]) + law["sigma"] * _NORMAL.inv_cdf(u))
    return int(min(max(round(v), law["min"]), law["max"]))


# irrational steps of the length sequences, one a kind of draw
_STEPS = (0.6180339887498949, 0.4142135623730951, 0.7320508075688772,
          0.2360679774997897, 0.6457513110645906, 0.1622776601683793)


class _Stream:
    """Lengths of one kind: place i takes the law's quantile at
    frac(0.5 + (i + 1) * step), a Kronecker sequence: every stretch of
    places spreads evenly over the law, and every seed serves the same
    sizes at the same places."""

    def __init__(self, tag: int, law: dict):
        self.law, self.step = law, _STEPS[tag % len(_STEPS)]

    def __getitem__(self, i: int) -> int:
        return law_value(self.law, (0.5 + (i + 1) * self.step) % 1.0)


def _tokens(seed: int, tag: int, key: int, n: int, vocab: int) -> np.ndarray:
    return np.random.default_rng([seed, tag, key + _NEG]).integers(
        0, vocab, n, dtype=np.int64).astype(np.int32)


class ClosedLoop:
    """The queue of one run: ``initial()`` gives each client's first
    request, ``next()`` the queue's entries in order, and ``warm_prompts``
    what set-up writes into the prefix cache. ``chunk`` is the engine's
    prefill chunk and ``block`` its KV block size (the prefix cache maps
    whole blocks)."""

    def __init__(self, params: dict, seed: int, vocab: int, chunk: int,
                 block: int):
        self.p, self.seed, self.vocab = params, int(seed), vocab
        self.chunk, self.block = chunk, block
        self.clients = int(params["clients"])
        self.shared = params.get("shared")
        self._q = _Stream(_QUESTION if self.shared else _PROMPT,
                          params["prompt"])
        self._out = _Stream(_OUTPUT, params["output"])
        self._doc = _Stream(_DOCLEN, self.shared["doc"]) \
            if self.shared else None
        self._place = 0
        self._initial = self._make_initial()

    # -- the queue ---------------------------------------------------------
    def _doc_tokens(self, m: int) -> np.ndarray:
        return _tokens(self.seed, _DOC, m, self._doc[m + _NEG], self.vocab)

    def entry(self, q: int) -> Req:
        """Queue place q (0 = the first request after the clients' first
        ones)."""
        out = self._out[q]
        if not self.shared:
            return Req(_tokens(self.seed, _PROMPT, q, self._q[q], self.vocab),
                       out)
        m, _ = self.ask(q)
        question = _tokens(self.seed, _QUESTION, q, self._q[q], self.vocab)
        return Req(np.concatenate([self._doc_tokens(m), question]), out)

    def ask(self, q: int):
        """(document, ask) at queue place q: the unique k < asks with
        q - k * spacing divisible by asks."""
        asks = int(self.shared.get("asks", 1))
        spacing = int(self.shared.get("spacing", 1))
        for k in range(asks):
            if (q - k * spacing) % asks == 0:
                return (q - k * spacing) // asks, k
        raise ValueError(f"spacing {spacing} is not coprime with asks {asks}")

    def next(self) -> Req:
        req = self.entry(self._place)
        self._place += 1
        return req

    # -- the steady state at the window's start ----------------------------
    def _ticks(self, prompt_len: int, out: int) -> int:
        return -(-prompt_len // self.chunk) + out

    def _make_initial(self) -> List[tuple]:
        """Each client's first request: (Req, warm prefix length). Its sizes
        do not depend on the seed: a grid of candidates at fixed quantiles
        is weighted by lifetime in ticks, the k-th client takes the one at
        quantile (k + 0.5) / clients of that weight, at the age
        frac(0.5 + (k + 1) * step) of its lifetime. The seed draws the
        tokens."""
        c = self.clients
        cap = int(self.p.get("warm_max", 1 << 30))
        grid = max(16 * c, 256)
        q_law = self.p["prompt"]
        cands = []
        for i in range(grid):
            out = law_value(self.p["output"], (i + 0.5) / grid)
            q = law_value(q_law, (0.5 + i * _STEPS[1]) % 1.0)
            d = law_value(self.shared["doc"], (0.5 + i * _STEPS[2]) % 1.0) \
                if self.shared else 0
            cands.append((i, d, q, out, self._ticks(d + q, out)))
        cands.sort(key=lambda x: (x[4], x[0]))
        cum = np.cumsum([x[4] for x in cands], dtype=np.float64)
        first = []
        for k in range(c):
            i, d, q, out, life = cands[int(np.searchsorted(
                cum, (k + 0.5) / c * cum[-1]))]
            prompt = _tokens(self.seed, _WARM, i, q, self.vocab)
            if self.shared:
                prompt = np.concatenate([
                    _tokens(self.seed, _WARM, -1 - i, d, self.vocab), prompt])
            age = int((0.5 + (k + 1) * _STEPS[0]) % 1.0 * life)
            pre = -(-len(prompt) // self.chunk)
            if age < pre:
                # mid-prefill: the chunks done so far are cached
                first.append((Req(prompt, out, resumed=True),
                              min(age * self.chunk, cap)))
                continue
            # decoding: the tokens generated so far join the prompt (at
            # most warm_max tokens of context); the rest of its output
            # is its residual
            done = min(age - pre, out - 1)
            kept = min(done, max(cap - len(prompt), 0))
            gen = _tokens(self.seed, _AGE, k, kept, self.vocab)
            full = np.concatenate([prompt, gen])
            first.append((Req(full, out - done, resumed=True), len(full)))
        return first

    def initial(self) -> List[Req]:
        """The clients' first requests, in one fixed order for every seed
        (it sets which slot and request id each takes): a shuffle of the
        lifetime-sorted list, so that long and short ones interleave."""
        order = np.random.default_rng(_AGE).permutation(len(self._initial))
        return [self._initial[i][0] for i in order]

    def warm_prompts(self) -> List[np.ndarray]:
        """Token sequences whose whole blocks set-up writes into the prefix
        cache: the clients' first requests up to their age, and the
        documents that the queue's first entries ask about again (asked
        before the window in a steady loop)."""
        out = []
        for req, n in self._initial:
            n = n // self.block * self.block
            if n >= self.block:
                out.append(req.prompt[:n])
        if self.shared and int(self.shared.get("asks", 1)) > 1:
            asks = int(self.shared["asks"])
            spacing = int(self.shared["spacing"])
            earlier = sorted({(q - k * spacing) // asks
                              for k in range(1, asks)
                              for q in range(k * spacing)
                              if (q - k * spacing) % asks == 0})
            cap = int(self.p.get("warm_max", 1 << 30)) // self.block \
                * self.block
            out.extend(self._doc_tokens(m)[:cap] for m in earlier if m < 0)
        return out


def make(params: dict, seed: int, vocab: int, chunk: int, block: int):
    """The generator the mix names (``generator``), built for one run."""
    kind = params.get("generator", "closed_loop")
    if kind != "closed_loop":
        raise ValueError(f"unknown traffic generator {kind!r}; this harness "
                         f"has closed_loop")
    return ClosedLoop(params, seed, vocab, chunk, block)
