"""95th percentile, over every request with two or more tokens inside the
window, of its in-window span over its in-window tokens less one (host
clock, client side)."""

from bench.harness import window_math


def read(run):
    v = window_math.percentile(window_math.tpot_s(run), 95)
    return None if v is None else v * 1e3
