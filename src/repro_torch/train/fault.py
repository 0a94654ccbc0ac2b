"""Fault tolerance: preemption-safe checkpointing, straggler detection,
restart orchestration (the port's copy of ``repro.train.fault``).

The failure model at scale: (a) preemption signals (save now, exit), (b)
silent node slowdowns (stragglers), (c) hard failures (restart from the
last checkpoint, possibly on fewer nodes).
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, List, Optional


@dataclasses.dataclass
class PreemptionGuard:
    """Installs SIGTERM/SIGINT handlers that flip ``should_stop``; the train
    loop checks it each step and checkpoints before exiting."""

    should_stop: bool = False
    _installed: bool = False

    def install(self):
        if self._installed:
            return self

        def _handler(signum, frame):
            self.should_stop = True

        signal.signal(signal.SIGTERM, _handler)
        signal.signal(signal.SIGINT, _handler)
        self._installed = True
        return self


@dataclasses.dataclass
class StragglerDetector:
    """Per-host step-time EWMA; flags hosts slower than ``threshold`` x the
    fleet median. Policy hooks: 'log' | 'exclude' (elastic restart without
    the slow host)."""

    n_hosts: int
    decay: float = 0.9
    threshold: float = 1.5

    def __post_init__(self):
        self.ewma = [0.0] * self.n_hosts
        self.count = 0

    def observe(self, step_times: List[float]) -> List[int]:
        assert len(step_times) == self.n_hosts
        for i, t in enumerate(step_times):
            self.ewma[i] = (t if self.count == 0
                            else self.decay * self.ewma[i]
                            + (1 - self.decay) * t)
        self.count += 1
        med = sorted(self.ewma)[self.n_hosts // 2]
        if med <= 0:
            return []
        return [i for i, e in enumerate(self.ewma)
                if e > self.threshold * med]


@dataclasses.dataclass
class RestartPolicy:
    """Retry-with-backoff restart driver used by launch.train: wraps the
    train loop; on exception, reloads the latest checkpoint and retries
    (optionally on a degraded mesh)."""

    max_restarts: int = 3
    backoff_s: float = 1.0

    def run(self, fn: Callable[[int], Optional[int]]) -> int:
        """fn(attempt) -> final step; raises to trigger restart."""
        attempt = 0
        while True:
            try:
                return fn(attempt)
            except KeyboardInterrupt:
                raise
            except Exception:
                attempt += 1
                if attempt > self.max_restarts:
                    raise
                time.sleep(self.backoff_s * attempt)
