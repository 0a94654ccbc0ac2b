"""Set-up: from the process's start to the window's, with the imports, the
weights made on the card, the engine and its pool, the kernels' build or
load, the graphs' capture and the warm-up through the served path (host
clock)."""


def read(run):
    return run.setup_s
