"""Adaptive draft length K.

K draft tokens cost K cheap steps plus a verify pass over K+1 positions;
the payoff is the accepted prefix. When acceptance collapses, long drafts
only burn verify work and pool blocks, so the controller shrinks K, and
grows it back, up to the verify step's fixed width (k_max), while the
drafter keeps being right. Separate low and high thresholds keep K from
oscillating on noisy acceptance."""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.configs.base import SpecConfig


@dataclasses.dataclass
class AdaptiveK:
    k: int
    k_min: int
    k_max: int
    accept_low: float
    accept_high: float
    decay: float
    ema: Optional[float] = None

    @classmethod
    def from_config(cls, spec: SpecConfig) -> "AdaptiveK":
        return cls(k=min(spec.k, spec.k_max), k_min=spec.k_min,
                   k_max=spec.k_max, accept_low=spec.accept_low,
                   accept_high=spec.accept_high, decay=spec.ema_decay)

    def update(self, accept_frac: float) -> int:
        """Fold one verify step's acceptance fraction into the EMA and
        move K one notch against or with it. Returns the new K."""
        if self.ema is None:
            self.ema = accept_frac
        else:
            self.ema = self.decay * self.ema + (1 - self.decay) * accept_frac
        if self.ema < self.accept_low:
            self.k = max(self.k - 1, self.k_min)
        elif self.ema > self.accept_high:
            self.k = min(self.k + 1, self.k_max)
        return self.k
