"""Every token delivered to its client inside the window, over the
window's length (host clock, client side)."""

from bench.harness import window_math


def read(run):
    n = sum(k for c in run.window.clients
            for _, k in window_math.in_window(run, c))
    return n / run.seconds
