"""Device: 1 - the union of the device's intervals (kernels, copies) over
the profiled sub-window's length, from torch.profiler's CUDA activity."""


def read(run):
    tr = run.window.trace
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
