"""Overload-control primitives for the serving plane.

A copy of the reference's ``repro.serve.overload`` (standard library only),
used by ``serve.engine.SpikeEngine``.

The paper's operating point (44 MInf/s @ 29 mW) is an edge budget: wearables
and IoT gateways see bursty open-loop traffic, not closed-loop benchmark
batches.  This module holds the host-side control-plane pieces ``SpikeEngine``
uses to survive that traffic without losing the datapath's bit-exactness:

  * ``AdmissionVerdict`` — the return value of ``SpikeEngine.submit``: was the
    request admitted, and is the queue past its high-water mark
    (backpressure)?  Callers that ignore it keep the pre-overload behavior.
  * ``LadderLevel`` / ``DegradationLadder`` — a graceful-degradation ladder.
    Under sustained pressure (queue depth beyond the high-water mark, or
    straggling dispatch rounds flagged by the watchdog EMA) the engine steps
    *down* a level, trading per-request cost for headroom: event streams are
    truncated to fewer timesteps, the cost tier drops to fewer read ports,
    and the bucket ceiling shrinks so rounds stay small and latency bounded.
    When pressure clears for ``step_up_after`` consecutive rounds it steps
    back up.  Every transition is recorded and surfaced through
    ``SpikeEngine.stats()``.

Nothing here touches the device datapath: level 0 with no queue bound and no
deadlines is bit-identical to the pre-overload engine (property-tested).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class AdmissionVerdict:
    """Outcome of one ``SpikeEngine.submit`` admission decision.

    ``admitted`` is False only when a bounded queue is full (``reason ==
    "queue_full"``); ``backpressure`` is True when the request was admitted
    but the queue is past its high-water mark — the caller should slow down
    (an open-loop caller can't, which is exactly when sheds start).
    """

    admitted: bool
    backpressure: bool = False
    reason: str = "ok"                # "ok" | "queue_full"
    queue_depth: int = 0              # depth after this decision


@dataclasses.dataclass(frozen=True)
class LadderLevel:
    """One rung: every field None means "no change from the engine's base".

    ``event_t_cap``   — truncate event streams to at most this many timesteps.
    ``read_ports``    — cost tier for telemetry accounting (fewer decoupled
                        read ports = lower energy per access).
    ``bucket_cap``    — ceiling on the continuous-batching round size (and so
                        on the padded bucket), keeping per-round latency low.
    ``fuse_cap``      — ceiling on the engine's round-fusion factor (how many
                        legacy bucket-rounds may coalesce into one super-batch
                        dispatch).  Degraded rungs cap fusion so a shed/deadline
                        sweep between rounds stays frequent under pressure.
    """

    name: str
    event_t_cap: Optional[int] = None
    read_ports: Optional[int] = None
    bucket_cap: Optional[int] = None
    fuse_cap: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class DegradationLadder:
    """Ordered service levels, full service first.

    ``step_down_after`` consecutive pressured rounds move one level down;
    ``step_up_after`` consecutive clear rounds move one level back up.
    Hysteresis (step_up_after > step_down_after) keeps the ladder from
    oscillating at the saturation boundary.
    """

    levels: tuple[LadderLevel, ...]
    step_down_after: int = 2
    step_up_after: int = 6

    def __post_init__(self):
        assert self.levels, "ladder needs at least the full-service level"
        assert self.step_down_after >= 1 and self.step_up_after >= 1

    def level(self, i: int) -> LadderLevel:
        return self.levels[max(0, min(i, len(self.levels) - 1))]

    @property
    def n_levels(self) -> int:
        return len(self.levels)

    @staticmethod
    def default(max_batch: int = 128,
                read_ports: int = 4) -> "DegradationLadder":
        """The canonical 4-rung ladder for the paper's cell options.

        full -> shorter event streams -> half the read-port tier + half the
        bucket ceiling -> survival (T<=2, single-port tier, quarter buckets).
        Bucket caps stay powers of two so degraded rounds still land on the
        engine's compiled bucket ladder.
        """
        def _pow2_floor(n: int) -> int:
            p = 1
            while p * 2 <= n:
                p *= 2
            return p

        half = max(8, _pow2_floor(max_batch) // 2)
        quarter = max(8, _pow2_floor(max_batch) // 4)
        return DegradationLadder(levels=(
            LadderLevel("full"),
            LadderLevel("reduced_t", event_t_cap=8),
            LadderLevel("economy", event_t_cap=4,
                        read_ports=max(1, read_ports // 2), bucket_cap=half,
                        fuse_cap=2),
            LadderLevel("survival", event_t_cap=2, read_ports=1,
                        bucket_cap=quarter, fuse_cap=1),
        ))
