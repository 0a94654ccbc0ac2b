"""95th percentile of submit to first token, over every new request whose
first token reached its client through ``poll`` inside the window (host
clock, client side)."""

from bench.harness import window_math


def read(run):
    v = window_math.percentile(window_math.ttft_s(run), 95)
    return None if v is None else v * 1e3
