"""The port's serving subsystem: the synchronous paged engine
(``engine.Engine``) over one batched model step (``runner.ModelRunner``),
with the streaming front ends in ``api``."""
