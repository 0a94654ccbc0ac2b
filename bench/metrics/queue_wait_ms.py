"""Front end and scheduler admission: the median, over the new requests
that finished inside the window, of each one's wait from
``StreamingServer.submit`` (before any backlog) to its first slot
(``admitted_at - submitted_at`` of the program's record,
``harness/records.py``). The window's opening requests (``resumed``) are
left out: they all arrive at its start, a burst no user sends."""

from bench.harness import records, window_math


def read(run):
    waits = [r.admitted_at - r.submitted_at
             for c, r in records.finished(run) if not c.req.resumed]
    v = window_math.percentile(waits, 50)
    return None if v is None else v * 1e3
