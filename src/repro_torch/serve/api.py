"""Streaming request API over the engine.

``generate()`` yields tokens as the scheduler produces them while the
engine keeps serving every other in-flight request. ``StreamingServer`` is
the multi-client front door: submit returns immediately, ``poll()``
advances the engine one tick and reports per-request deltas, ``drain()``
runs to completion.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np

from repro_torch.serve.engine import Engine
from repro_torch.serve.sampling import SamplingParams, stop_holdback
from repro_torch.serve.scheduler import Request


class StreamingServer:
    """Non-blocking serving loop: one tick per poll, streamed deltas."""

    def __init__(self, engine: Engine):
        self.engine = engine
        self._cursors: Dict[int, int] = {}
        self._finished: Dict[int, Request] = {}
        self._backlog: List[Request] = []

    def submit(self, prompt, max_new: int = 16, priority: int = 0,
               rid: Optional[int] = None,
               sampling: Optional[SamplingParams] = None) -> int:
        """Queue a request; returns its rid immediately. Requests the
        engine's admission control rejects (queue full) wait in a local
        backlog and re-submit as capacity frees."""
        rid = self.engine.new_rid() if rid is None else rid
        req = Request(rid=rid, prompt=np.asarray(prompt, np.int32),
                      max_new=max_new, priority=priority,
                      sampling=sampling or SamplingParams())
        if not self.engine.can_serve(req):
            raise ValueError(
                f"prompt of {len(req.prompt)} tokens cannot fit "
                f"max_seq={self.engine.scfg.max_seq}")
        self._cursors[rid] = 0
        if not self.engine.add_request(req):
            self._backlog.append(req)
        return rid

    def poll(self) -> Dict[int, List]:
        """One engine tick. Returns {rid: [new tokens]} for every request
        that made progress; finished requests are kept for ``result()``."""
        while self._backlog and self.engine.add_request(self._backlog[0]):
            self._backlog.pop(0)
        if self._backlog and not self.engine._busy():
            # the idle engine still refuses the head request: it is
            # unservable, shed it so the backlog cannot wedge the server
            req = self._backlog.pop(0)
            self._cursors.pop(req.rid, None)
            self._finished[req.rid] = req
        for rid in self.engine.step():
            self._finished[rid] = self.engine._requests[rid]
        out: Dict[int, List] = {}
        for rid, cur in list(self._cursors.items()):
            req = self.engine._requests.get(rid)
            if req is None:
                continue
            upto = len(req.tokens_out)
            if req.sampling.stop and not req.done:
                # a partial stop-sequence match may still be retracted
                upto -= stop_holdback(req.tokens_out, req.sampling.stop)
            if upto > cur:
                out[rid] = req.tokens_out[cur:upto]
                self._cursors[rid] = upto
            if req.done:
                del self._cursors[rid]
        return out

    def result(self, rid: int, forget: bool = False) -> Optional[Request]:
        """Finished request by id; ``forget=True`` releases the engine's
        and the server's record on pickup."""
        req = self._finished.get(rid)
        if forget and req is not None:
            del self._finished[rid]
            self.engine.forget(rid)
        return req

    @property
    def busy(self) -> bool:
        return bool(self._backlog) or self.engine._busy() \
            or bool(self._cursors)

    def drain(self, max_steps: int = 10000) -> Dict[int, Request]:
        for _ in range(max_steps):
            if not self.busy:
                break
            self.poll()
        return dict(self._finished)


def generate(engine: Engine, prompt, max_new: int = 16,
             priority: int = 0, max_steps: int = 10000,
             sampling: Optional[SamplingParams] = None) -> Iterator:
    """Streaming generation: yields each new token as soon as its step
    lands, while the engine keeps serving concurrent requests."""
    server = StreamingServer(engine)
    rid = server.submit(prompt, max_new=max_new, priority=priority,
                        sampling=sampling)
    for _ in range(max_steps):
        yield from server.poll().get(rid, [])
        req = engine._requests.get(rid)
        if req is not None and req.done:
            return
        if not server.busy:
            return
