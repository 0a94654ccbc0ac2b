"""Engine, paged: decode tokens over the device passes that carry decode
rows (eager steps and every iteration of a decode burst) in the window,
from the step shapes the harness records around the runner."""

from bench.harness import window_math


def read(run):
    rows = [n for s in run.window.steps
            for n in window_math.decode_rows(s) if n > 0]
    return sum(rows) / len(rows) if rows else None
