"""Serving metrics, trimmed: per-request TTFT/TPOT, latency percentiles,
token counts and tokens/s. Empty windows report ``None``, never a fake 0.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class RequestMetrics:
    rid: int
    arrival: float
    prompt_len: int = 0
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    n_generated: int = 0
    preemptions: int = 0

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.arrival

    @property
    def latency(self) -> Optional[float]:
        if self.finished_at is None:
            return None
        return self.finished_at - self.arrival

    @property
    def tpot(self) -> Optional[float]:
        """Time per output token after the first (decode cadence)."""
        if self.finished_at is None or self.first_token_at is None \
                or self.n_generated <= 1:
            return None
        return (self.finished_at - self.first_token_at) \
            / (self.n_generated - 1)


def percentile(values: List[float], p: float) -> Optional[float]:
    if not values:
        return None
    return float(np.percentile(np.asarray(values), p))


def _ms(v: Optional[float]) -> Optional[float]:
    return None if v is None else v * 1e3


class MetricsCollector:
    """Accumulates per-request and per-step serving counts."""

    def __init__(self, clock=time.monotonic):
        self.clock = clock
        self.requests: Dict[int, RequestMetrics] = {}
        self._t0: Optional[float] = None
        self.decode_steps = 0
        self.prefill_chunks = 0
        self.prefill_tokens = 0
        self.evictions = 0

    def on_arrival(self, rid: int, prompt_len: int) -> None:
        at = self.clock()
        if self._t0 is None:
            self._t0 = at
        self.requests[rid] = RequestMetrics(rid=rid, arrival=at,
                                            prompt_len=prompt_len)

    def on_first_token(self, rid: int) -> None:
        r = self.requests[rid]
        if r.first_token_at is None:
            r.first_token_at = self.clock()
        r.n_generated += 1

    def on_token(self, rid: int) -> None:
        self.requests[rid].n_generated += 1

    def on_finish(self, rid: int) -> None:
        self.requests[rid].finished_at = self.clock()

    def on_preemption(self, rid: int) -> None:
        self.requests[rid].preemptions += 1
        self.evictions += 1

    def on_decode_step(self) -> None:
        self.decode_steps += 1

    def on_prefill_chunk(self, n_tokens: int) -> None:
        self.prefill_chunks += 1
        self.prefill_tokens += n_tokens

    def summary(self) -> dict:
        done = [r for r in self.requests.values()
                if r.finished_at is not None]
        ttfts = [r.ttft for r in done if r.ttft is not None]
        lats = [r.latency for r in done]
        tpots = [r.tpot for r in done if r.tpot is not None]
        n_tok = sum(r.n_generated for r in done)
        wall = (max(r.finished_at for r in done) - self._t0) \
            if done and self._t0 is not None else None
        return {"n_finished": len(done),
                "generated_tokens": n_tok,
                "tokens_per_s": (n_tok / wall) if wall else None,
                "ttft_p50_ms": _ms(percentile(ttfts, 50)),
                "ttft_p99_ms": _ms(percentile(ttfts, 99)),
                "tpot_p50_ms": _ms(percentile(tpots, 50)),
                "tpot_p99_ms": _ms(percentile(tpots, 99)),
                "latency_p50_ms": _ms(percentile(lats, 50)),
                "latency_p99_ms": _ms(percentile(lats, 99)),
                "decode_steps": self.decode_steps,
                "prefill_chunks": self.prefill_chunks,
                "prefill_tokens": self.prefill_tokens,
                "evictions": self.evictions}
