"""The program's own record of each request, read on the requests that
finished inside the window: ``Request.metrics``
(``repro_torch.serve.metrics.RequestMetrics``), kept on the Request that
``StreamingServer.result`` returns. Its stamps (``submitted_at``,
``admitted_at``, ``finished_at``) are on the program's clock
(``time.perf_counter_ns``), and ``phase_s`` holds the engine's seconds by
phase from the request's admission to its finish (the always-on phase
totals of ``repro_torch.obs.trace``).

A program that keeps no such record gives no request here, and a reader
built on it returns None. So does a run off the card (no peaks): there
the model's work runs inside the host's dispatch, and the benchmark's
times are the card's."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

# the engine's host policy: admission and capacity, drafting, the step's
# batch, the commit, and the front end's own work
HOST_POLICY = ("schedule", "admit", "draft", "batch_assemble",
               "postprocess", "front_end")
EAGER_DISPATCH = ("device_dispatch",)


def finished(run) -> List[Tuple[object, object]]:
    """(client, record) of every request that finished inside the window
    and whose record has its admission; none off the card."""
    if not run.peaks:
        return []
    out = []
    for c in run.window.clients:
        if c.done_t is None or c.done_t > run.window.t1:
            continue
        r = getattr(c.request, "metrics", None)
        if getattr(r, "admitted_at", None) is not None:
            out.append((c, r))
    return out


def phase_pct(run, phases: Sequence[str]) -> Optional[float]:
    """The engine's seconds in ``phases`` summed over the window's
    finished requests (each over its own admission to finish), over the
    sum of those lives, in %."""
    spent = lives = 0.0
    for _, r in finished(run):
        if r.phase_s is None:
            continue
        spent += sum(r.phase_s.get(p, 0.0) for p in phases)
        lives += r.finished_at - r.admitted_at
    return 100.0 * spent / lives if lives > 0 else None
