"""Runner: 1 - valid positions over max_batch x width, summed over the
window's device passes (eager steps, and each burst iteration at width 1),
from the step shapes the harness records around the runner."""

from bench.harness import window_math


def read(run):
    valid = total = 0
    for s in run.window.steps:
        for _, v, width in window_math.rows(s):
            valid += int(v.sum())
            total += run.max_batch * width
    return 100.0 * (1.0 - valid / total) if total else None
