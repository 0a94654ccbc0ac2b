"""Best-offset prefetch scheduling (paper §II-D, Michaud HPCA'16).

The hardware prefetcher scores candidate offsets over learning rounds and
adopts the argmax. A GPU program has two software-visible streaming
channels where the same idea applies:

  1. the HBM->shared-memory block pipeline inside a kernel: the
     *lookahead depth* is the number of stages of the kernel's
     ``cp.async``/TMA ring in shared memory (how many blocks ahead the
     copies run); too shallow stalls the math, too deep overflows the
     228 KiB of shared memory an SM has (on the TPU it was the depth of
     the HBM->VMEM DMA pipeline of a Pallas kernel);
  2. host->device input staging: how many batches to keep in flight.

``BestOffsetScheduler`` is a faithful port of the scoring loop; ``choose_
lookahead``/``simulate_pipeline`` apply it to a latency model of a block
pipeline, where ``vmem_blocks`` is the number of blocks the on-chip
buffer holds (shared memory on the card).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence


@dataclasses.dataclass
class BestOffsetScheduler:
    """Michaud's best-offset learner.

    Each learning phase runs ``rounds`` rounds; in a round, every candidate
    offset d is tested against the recent-request history: if (addr - d) was
    recently requested (i.e. a prefetch issued d ahead would have been
    timely), d scores a point. At phase end the best offset is adopted and
    scores reset. ``bad_score`` gates prefetching off when nothing scores
    (the paper's stride-0 rows show ~1x — no harm when streams are absent).

    Default offsets = Michaud's list (2^i * 3^j * 5^k <= 256).
    """

    offsets: Sequence[int] = (
        1, 2, 3, 4, 5, 6, 8, 9, 10, 12, 15, 16, 18, 20, 24, 25, 27, 30, 32,
        36, 40, 45, 48, 50, 54, 60, 64, 72, 75, 80, 81, 90, 96, 100, 108,
        120, 125, 128, 135, 144, 150, 160, 162, 180, 192, 200, 216, 225,
        240, 243, 250, 256)
    rounds: int = 16
    bad_score: int = 1
    history: int = 64

    def __post_init__(self):
        self.scores: Dict[int, int] = {d: 0 for d in self.offsets}
        self.best_offset: int = 1
        self.enabled: bool = True
        self._recent: List[int] = []
        self._round = 0

    def observe(self, addr: int) -> None:
        """Feed one demand access (block-granular address)."""
        for d in self.offsets:
            if addr - d in self._recent:
                self.scores[d] += 1
        self._recent.append(addr)
        if len(self._recent) > self.history:
            self._recent.pop(0)
        self._round += 1
        if self._round >= self.rounds * len(self.offsets):
            self._end_phase()

    def _end_phase(self) -> None:
        best = max(self.scores, key=lambda d: self.scores[d])
        score = self.scores[best]
        self.enabled = score > self.bad_score
        if self.enabled:
            self.best_offset = best
        self.scores = {d: 0 for d in self.offsets}
        self._round = 0

    def train_on_stream(self, addrs: Sequence[int]) -> int:
        for a in addrs:
            self.observe(a)
        return self.best_offset if self.enabled else 0


def strided_stream(n: int, stride_blocks: int) -> List[int]:
    """The Fig. 7 microbenchmark: sequential accesses at a fixed stride."""
    return [i * stride_blocks for i in range(n)]


# ---------------------------------------------------------------------------
# Applying the learned offset to a block pipeline (lookahead depth)


def simulate_pipeline(n_blocks: int, t_fetch: float, t_compute: float,
                      lookahead: int) -> float:
    """Cycle-accurate-enough model of a double/multi-buffered block pipeline:
    ``lookahead`` copies may be in flight; compute of block i waits for its
    fetch. Returns total time. lookahead=0 means no overlap (serial)."""
    if lookahead <= 0:
        return n_blocks * (t_fetch + t_compute)
    fetch_done = [0.0] * n_blocks
    compute_done = 0.0
    dma_free = 0.0
    for i in range(n_blocks):
        # the copy of block i may start once it is within ``lookahead`` of
        # the block being computed, and the (single) copy engine is free
        earliest = compute_done if i == 0 else max(
            dma_free, compute_done - (lookahead - 1) * t_compute)
        start = max(dma_free, 0.0 if i < lookahead else earliest)
        fetch_done[i] = start + t_fetch
        dma_free = fetch_done[i]
        compute_done = max(compute_done, fetch_done[i]) + t_compute
    return compute_done


def choose_lookahead(t_fetch: float, t_compute: float, vmem_blocks: int,
                     n_blocks: int = 64) -> int:
    """Best-offset-style selection applied to pipeline depth: score each
    candidate depth by simulated throughput, pick the argmax (ties -> the
    shallowest, to minimize the on-chip buffer's footprint)."""
    best_d, best_t = 1, float("inf")
    for d in range(1, max(2, vmem_blocks)):
        t = simulate_pipeline(n_blocks, t_fetch, t_compute, d)
        if t < best_t - 1e-12:
            best_t, best_d = t, d
    return best_d


def pipeline_efficiency(t_fetch: float, t_compute: float, lookahead: int,
                        n_blocks: int = 64) -> float:
    """Achieved fraction of the ideal max(t_fetch, t_compute) bound."""
    ideal = n_blocks * max(t_fetch, t_compute)
    actual = simulate_pipeline(n_blocks, t_fetch, t_compute, lookahead)
    return ideal / actual
