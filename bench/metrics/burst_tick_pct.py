"""Engine, async ticks: the device decode iterations run inside graph
bursts, as a share of every device step in the window (the engine's
``async_stats()`` counters, window deltas)."""


def read(run):
    a = run.window.async_delta
    if not a["device_ticks"]:
        return None
    return 100.0 * a["loop_device_ticks"] / a["device_ticks"]
