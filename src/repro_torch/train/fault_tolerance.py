"""Fault tolerance for the port: the straggler watchdog.

A copy of ``StragglerWatchdog`` from the reference's
``repro.train.fault_tolerance`` (pure Python, so it flags the same rounds
for the same wall times).  ``serve.engine.SpikeEngine`` times each dispatch
round with it; rounds slower than ``threshold`` x the EMA are flagged, and
the flags feed the engine's degradation ladder and ``stats()``.  The
reference module's checkpoint manager, retry policy and elastic replan are
not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional


@dataclasses.dataclass
class StragglerWatchdog:
    threshold: float = 2.0
    ema_decay: float = 0.9
    warmup_steps: int = 3
    on_straggler: Optional[Callable[[int, float, float], None]] = None

    _ema: float = dataclasses.field(default=0.0, init=False)
    _n: int = dataclasses.field(default=0, init=False)
    flagged: list = dataclasses.field(default_factory=list, init=False)

    def record(self, step: int, wall_s: float):
        self._n += 1
        if self._n <= self.warmup_steps:
            # seed the EMA on early steps (skip compile-dominated step 0 bias
            # by averaging rather than trusting the first sample)
            self._ema = wall_s if self._n == 1 else 0.5 * (self._ema + wall_s)
            return
        if wall_s > self.threshold * self._ema:
            self.flagged.append((step, wall_s, self._ema))
            if self.on_straggler:
                self.on_straggler(step, wall_s, self._ema)
        self._ema = self.ema_decay * self._ema + (1 - self.ema_decay) * wall_s
