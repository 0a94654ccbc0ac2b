"""Training: the optimizer, data, checkpoints, fault handling and the
loop (the port of ``repro.train``)."""
