"""Fault tolerance for the port: the straggler watchdog, the retry policy
and the elastic replan.

Copies of the reference's ``repro.train.fault_tolerance`` (pure Python, so
they give the same verdicts, backoffs and meshes for the same inputs):

* ``StragglerWatchdog``: ``serve.engine.SpikeEngine`` times each dispatch
  round with it; rounds slower than ``threshold`` x the EMA are flagged, and
  the flags feed the engine's degradation ladder and ``stats()``;
* ``RetryPolicy``: exponential backoff with counter-based seeded jitter (a
  splitmix64 hash of (seed, counter), no wall-clock entropy) and a
  per-attempt timeout, consumed by ``serve.engine.FaultAwareRouter``;
* ``elastic_replan``: the largest valid (data, model) mesh within a
  surviving device count (``SpikeEngine.replan_degraded``).

The reference's checkpoint manager is not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
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


def _splitmix64(x: int) -> int:
    """One splitmix64 round: a strong 64-bit integer mix (pure int math)."""
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


def counter_uniform(seed: int, counter: int) -> float:
    """Deterministic uniform in [0, 1) from (seed, counter): the serving
    plane's jitter source, so retries are reproducible."""
    return _splitmix64(_splitmix64(seed) ^ counter) / 2.0 ** 64


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Retry/backoff knobs for re-routing requests across serving replicas.

    ``backoff_s(attempt, counter)`` is the sleep before retry number
    ``attempt`` (1-based): exponential in the attempt, capped at
    ``max_backoff_s``, jittered by ``jitter`` (fractional, symmetric) with
    the counter-based uniform above.  ``attempt_timeout_s`` bounds one
    replica drain: a drain past it marks the replica slow.
    """

    max_attempts: int = 3
    base_backoff_s: float = 0.01
    backoff_multiplier: float = 2.0
    max_backoff_s: float = 1.0
    jitter: float = 0.5
    seed: int = 0
    attempt_timeout_s: Optional[float] = None

    def backoff_s(self, attempt: int, counter: int) -> float:
        base = min(
            self.base_backoff_s * self.backoff_multiplier ** max(0, attempt - 1),
            self.max_backoff_s,
        )
        u = counter_uniform(self.seed, counter)
        return base * (1.0 + self.jitter * (2.0 * u - 1.0))


class ReplanResult(tuple):
    """``((data, model), ("data", "model"))``, equal to the plain 2-tuple,
    plus ``dropped_chips``: the surviving devices the replanned mesh leaves
    idle as spares."""

    dropped_chips: int

    def __new__(cls, mesh_shape, axis_names, dropped_chips):
        self = super().__new__(cls, (mesh_shape, axis_names))
        self.dropped_chips = int(dropped_chips)
        return self


def elastic_replan(n_chips: int, *, model_parallel: int = 16) -> ReplanResult:
    """Largest valid (data, model) mesh within the surviving chip count.

    Model parallelism is pinned; the data axis absorbs the loss and is
    rounded down to a power of two.  Leftover chips stay idle as spares
    (``dropped_chips``)."""
    if n_chips < model_parallel:
        raise ValueError(f"need >= {model_parallel} chips, have {n_chips}")
    data = n_chips // model_parallel
    # largest power-of-two data axis keeps batch divisibility
    data = 2 ** int(math.log2(data))
    return ReplanResult((data, model_parallel), ("data", "model"),
                        n_chips - data * model_parallel)
