"""Arithmetic over a window that several readers share: percentiles, the
client-side samples, and the tokens and positions of the device steps the
harness recorded (``driver.Recorder``)."""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import numpy as np

DECODE = 2      # the runner's DECODE row phase


def percentile(values: List[float], p: float) -> Optional[float]:
    """Percentile of a sample (numpy's linear rule), None for an empty one,
    a single sample itself (``repro_torch.serve.metrics.percentile``'s
    arithmetic, copied)."""
    if not values:
        return None
    if len(values) == 1:
        return float(values[0])
    return float(np.percentile(np.asarray(values), p))


def in_window(run, c) -> List[Tuple[float, int]]:
    """A client's deliveries inside the window."""
    return [(t, n) for t, n in c.deliveries
            if run.window.t0 <= t <= run.window.t1]


def ttft_s(run) -> List[float]:
    """Submit to first token, of every new request whose first token
    reached its client within the window."""
    return [c.deliveries[0][0] - c.submit_t for c in run.window.clients
            if not c.req.resumed and c.deliveries
            and run.in_window(c.deliveries[0][0])]


def tpot_s(run) -> List[float]:
    """Each request's in-window span over its in-window tokens less one,
    where it has two or more."""
    out = []
    for c in run.window.clients:
        d = in_window(run, c)
        n = sum(k for _, k in d)
        if n >= 2:
            out.append((d[-1][0] - d[0][0]) / (n - 1))
    return out


def rows(step) -> Iterator[Tuple[np.ndarray, np.ndarray, int]]:
    """(row starts, valid tokens, width) of each device pass of a step: an
    eager step is one pass, a burst one pass an iteration, in which row r
    is live while it has tokens left to emit."""
    kind, k, starts, valid = step[0], step[1], step[2], step[3]
    if kind == "step":
        yield starts.astype(np.int64), valid.astype(np.int64), k
        return
    for j in range(k):
        live = valid > j
        yield ((starts + j) * live).astype(np.int64), live.astype(np.int64), 1


def decode_rows(step) -> Iterator[int]:
    """Decode tokens of each device pass of a step."""
    if step[0] == "step":
        yield int(((step[4] == DECODE) & (step[3] > 0)).sum())
        return
    for _, valid, _ in rows(step):
        yield int(valid.sum())


def ctx_sum(starts: np.ndarray, valid: np.ndarray) -> Tuple[int, float]:
    """(tokens, sum of their key counts) of rows with ``valid`` queries at
    positions starts + j: a query at position p reads p + 1 keys."""
    s = starts.astype(np.float64)
    m = valid.astype(np.float64)
    return int(m.sum()), float((s * m + m * (m + 1) / 2).sum())
