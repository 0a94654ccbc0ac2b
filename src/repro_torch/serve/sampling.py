"""Per-request sampling: ``SamplingParams``, the stop-sequence helpers, the
batched greedy path and the host greedy sample of one row (``sample_np``).

Greedy rows reduce to ``argmax(logits)`` plus the log-probability of the
chosen token, as in the reference. Rows that sample (temperature > 0) or
penalise repetition raise ``NotImplementedError`` in this slice: seeded
parity with the reference needs its threefry draws.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """How one request turns logits into tokens (the reference's
    contract). ``temperature=None`` means unset (greedy unless the engine
    provides a default); ``stop`` is a tuple of token-id sequences and
    generation truncates before a match; ``max_tokens`` caps the
    generated length; ``logprobs`` asks for the chosen token's
    log-probability per step."""

    temperature: Optional[float] = None
    top_k: int = 0
    top_p: float = 1.0
    repetition_penalty: float = 1.0
    stop: Tuple[Tuple[int, ...], ...] = ()
    max_tokens: Optional[int] = None
    logprobs: bool = False
    prompt_logprobs: bool = False
    seed: Optional[int] = None

    def __post_init__(self):
        if self.temperature is not None and self.temperature < 0:
            object.__setattr__(self, "temperature", 0.0)
        if not (0.0 < self.top_p <= 1.0):
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if self.repetition_penalty <= 0:
            raise ValueError("repetition_penalty must be > 0, got "
                             f"{self.repetition_penalty}")
        if self.max_tokens is not None and self.max_tokens < 1:
            raise ValueError(f"max_tokens must be >= 1, got {self.max_tokens}")
        stop = tuple(tuple(int(t) for t in s) for s in self.stop)
        if any(len(s) == 0 for s in stop):
            raise ValueError("empty stop sequence")
        object.__setattr__(self, "stop", stop)

    @property
    def is_greedy(self) -> bool:
        return (self.temperature or 0.0) <= 0


def effective_params(sp: SamplingParams,
                     fallback_temperature: float = 0.0) -> SamplingParams:
    """Resolve a request's params to a concrete temperature: unset (None)
    inherits the engine default; an explicit value always wins."""
    t = sp.temperature
    if t is None:
        t = fallback_temperature if fallback_temperature > 0 else 0.0
    return dataclasses.replace(sp, temperature=float(t))


def check_greedy(sp: SamplingParams) -> None:
    """Raise for a row this slice cannot sample."""
    if not sp.is_greedy or sp.repetition_penalty != 1.0:
        raise NotImplementedError(
            "the port samples greedy rows only (temperature 0, no "
            "repetition penalty); seeded sampling is a later slice")


def stop_truncate(tokens: Sequence[int],
                  stop: Tuple[Tuple[int, ...], ...]) -> Optional[int]:
    """If ``tokens`` ends with any stop sequence, return the length to
    truncate to (match excluded); else None."""
    n = len(tokens)
    for seq in stop:
        m = len(seq)
        if m and n >= m and tuple(int(t) for t in tokens[n - m:]) == seq:
            return n - m
    return None


def stop_holdback(tokens: Sequence[int],
                  stop: Tuple[Tuple[int, ...], ...]) -> int:
    """How many trailing tokens might still be retracted: the longest
    suffix of ``tokens`` that is a PROPER prefix of a stop sequence."""
    best = 0
    n = len(tokens)
    for seq in stop:
        for m in range(min(len(seq) - 1, n), 0, -1):
            if tuple(int(t) for t in tokens[n - m:]) == seq[:m]:
                best = max(best, m)
                break
    return best


def sample_np(logits: np.ndarray, sp: SamplingParams,
              rng: Optional[np.random.Generator] = None,
              seen: Sequence[int] = ()) -> Tuple[int, float]:
    """Host sampling of one row (the slot engine's batch-1 prefill uses
    it): (token, its log-probability). Greedy is a plain argmax, as in
    the reference; sampled rows raise (``check_greedy``), so ``rng`` and
    ``seen`` (the repetition-penalty history) are unused in this slice."""
    check_greedy(sp)
    z = np.asarray(logits, np.float64)
    tok = int(np.argmax(z))
    lse = z.max() + np.log(np.exp(z - z.max()).sum())    # f64, as the
    return tok, float(z[tok] - lse)                       # reference


def greedy_batch(logits: torch.Tensor
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """logits f[B, V] -> (tokens i32[B], log-prob of each chosen token
    f32[B]) on the host; one device sync."""
    logits = logits.float()
    tok = torch.argmax(logits, dim=-1)
    lp = torch.log_softmax(logits, dim=-1).gather(1, tok[:, None])[:, 0]
    return (tok.to(torch.int32).cpu().numpy(), lp.cpu().numpy())
