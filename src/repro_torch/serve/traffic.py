"""Open-loop traffic generation + chaos harness for the ESAM serving plane.

The port of the reference's ``repro.serve.traffic`` (numpy only: the same
seed gives the same arrivals and requests as the reference's).

Closed-loop benchmarks (serve a list, time the wall) can never overload the
engine: the caller waits for the drain before offering more work.  Real edge
traffic is *open-loop* — arrivals come on the traffic's schedule, not the
server's — so saturation shows up as queue growth, deadline sheds, and tail
latency, which is exactly what this module measures:

  * ``TrafficConfig`` + ``build_requests`` — seeded Poisson arrivals
    (exponential inter-arrival gaps) over a mixed request blend: static
    spike requests and event streams with a per-request T drawn from
    ``event_t_choices``.  Fully deterministic in ``seed`` (one
    ``np.random.default_rng((seed, i))`` per request, a counter-based
    scheme like the repo's STDP RNG — replays are bit-identical).
  * ``ChaosConfig`` + ``install_chaos`` — replica slowdowns (an injected
    stall per dispatch round, which the engine's watchdog EMA sees like any
    real straggler), mid-drain crashes (the engine's round hook raises
    ``ReplicaCrashError`` after N rounds, so a round's requests are popped
    but never served — the router's retry path must recover them), and
    request storms (a burst of extra arrivals at one instant).
  * ``run_open_loop`` — drives a ``SpikeEngine`` or ``FaultAwareRouter``
    with the arrival schedule against the wall clock and distills a
    ``TrafficReport``: p50/p99/p99.9 latency, shed / rejected / retry /
    deadline-miss counts, and goodput-under-SLO (completed within the SLO
    per offered request — the number an edge deployment actually ships).
    ``schedule=`` takes a ``build_requests`` result the caller keeps, to
    read the served requests afterwards; ``observability=`` brackets the
    run with trace instants and folds the metrics snapshot into the
    report.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from repro_torch.serve.engine import (EventRequest, FaultAwareRouter,
                                     SpikeRequest)


class ReplicaCrashError(RuntimeError):
    """Injected mid-drain replica crash (chaos harness)."""


# ------------------------------------------------------------------ #
# open-loop request generation
# ------------------------------------------------------------------ #
@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    """Seeded open-loop traffic description.

    ``rate_hz`` is the mean Poisson arrival rate; ``p_event`` the fraction
    of event-stream requests (T drawn uniformly from ``event_t_choices``);
    ``deadline_s`` an optional per-request relative deadline — the engine
    sheds requests still queued past arrival + deadline.
    """

    rate_hz: float
    n_requests: int
    seed: int = 0
    p_event: float = 0.0
    event_t_choices: tuple = (2, 4)
    n_in: int = 768
    spike_p: float = 0.3
    deadline_s: Optional[float] = None


def arrival_times(cfg: TrafficConfig) -> np.ndarray:
    """Poisson arrival offsets (seconds from traffic start), seeded."""
    rng = np.random.default_rng((cfg.seed, 0x0A221))
    gaps = rng.exponential(1.0 / cfg.rate_hz, size=cfg.n_requests)
    return np.cumsum(gaps)


def _one_request(cfg: TrafficConfig, i: int, salt: int = 0):
    rng = np.random.default_rng((cfg.seed, salt, i))
    if rng.random() < cfg.p_event:
        t = int(rng.choice(cfg.event_t_choices))
        ev = (rng.random((t, cfg.n_in)) < cfg.spike_p).astype(np.uint8)
        return EventRequest(events=ev)
    spikes = (rng.random(cfg.n_in) < cfg.spike_p).astype(np.uint8)
    return SpikeRequest(spikes=spikes)


def build_requests(cfg: TrafficConfig, *, chaos: "ChaosConfig" = None):
    """The full arrival schedule: ``(requests, arrival_offsets_s)`` sorted
    by arrival.  A chaos request storm splices ``storm_size`` extra
    requests in at ``storm_at_s`` (all due at the same instant)."""
    reqs = [_one_request(cfg, i) for i in range(cfg.n_requests)]
    arr = arrival_times(cfg)
    if chaos is not None and chaos.storm_size:
        storm = [_one_request(cfg, i, salt=0x570F) for i in
                 range(chaos.storm_size)]
        storm_at = np.full(chaos.storm_size, float(chaos.storm_at_s))
        arr = np.concatenate([arr, storm_at])
        reqs = reqs + storm
        order = np.argsort(arr, kind="stable")
        arr = arr[order]
        reqs = [reqs[j] for j in order]
    return reqs, arr


def warmup_engine(server, cfg: TrafficConfig, *, aot: bool = True) -> dict:
    """AOT-warm every (bucket, T) shape an open-loop run of ``cfg`` can
    dispatch — the whole static bucket ladder, plus the temporal grid for
    each T the blend can draw (``event_t_choices`` when ``p_event > 0``;
    degraded-ladder t-caps are expanded inside ``SpikeEngine.warmup``).
    Router-aware: warms every replica behind a ``FaultAwareRouter``.
    Returns ``{replica_index: warmup_times}``."""
    engines = (server.engines if isinstance(server, FaultAwareRouter)
               else [server])
    ts = (tuple(int(t) for t in cfg.event_t_choices)
          if cfg.p_event > 0 else ())
    return {i: eng.warmup(event_ts=ts, aot=aot)
            for i, eng in enumerate(engines)}


# ------------------------------------------------------------------ #
# chaos harness
# ------------------------------------------------------------------ #
@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """What to break, where, and when.

    ``slowdown``: replica index -> injected stall (seconds) per dispatch
    round.  ``crash_replica``/``crash_after_rounds``: that replica's drain
    raises ``ReplicaCrashError`` once it has run N more rounds.
    ``storm_at_s``/``storm_size``: a burst of extra arrivals at one instant
    (consumed by ``build_requests``).
    """

    slowdown: tuple = ()                 # ((replica_idx, stall_s), ...)
    crash_replica: Optional[int] = None
    crash_after_rounds: int = 1
    storm_at_s: float = 0.0
    storm_size: int = 0

    def stall_s(self, idx: int) -> float:
        return dict(self.slowdown).get(idx, 0.0)


def install_chaos(engines, chaos: ChaosConfig, *, sleep=time.sleep) -> None:
    """Arm each engine's round hook with this chaos plan.  Crash rounds are
    counted from installation (each engine's current round index)."""
    for idx, eng in enumerate(engines):
        stall = chaos.stall_s(idx)
        crash_at = None
        if chaos.crash_replica == idx:
            crash_at = eng._rounds + chaos.crash_after_rounds

        def hook(round_idx, _stall=stall, _crash_at=crash_at, _idx=idx):
            if _crash_at is not None and round_idx >= _crash_at:
                raise ReplicaCrashError(
                    f"chaos: replica {_idx} crashed at round {round_idx}")
            if _stall:
                sleep(_stall)

        eng.round_hook = hook


# ------------------------------------------------------------------ #
# the open-loop run + report
# ------------------------------------------------------------------ #
@dataclasses.dataclass
class TrafficReport:
    n_offered: int
    n_completed: int
    n_shed: int              # deadline sheds (engine-side)
    n_rejected: int          # bounded-queue rejections
    n_failed: int            # retry budget exhausted (router)
    n_deadline_miss: int     # completed, but after their deadline
    p50_ms: float
    p99_ms: float
    p999_ms: float
    mean_ms: float
    goodput_slo: float       # completed within SLO / offered
    slo_s: Optional[float]
    duration_s: float
    offered_rate_hz: float
    completed_rate_hz: float
    retries: int = 0
    crashes: int = 0
    timeouts: int = 0
    degraded_routes: int = 0
    backpressure_events: int = 0
    ladder_transitions: int = 0
    max_degradation_level: int = 0
    #: metrics-registry snapshot (``Registry.snapshot()``) when the run was
    #: driven with an observability handle; None otherwise
    metrics: Optional[dict] = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _percentiles_ms(lat_s: np.ndarray):
    if lat_s.size == 0:
        return 0.0, 0.0, 0.0, 0.0
    ms = lat_s * 1e3
    p50, p99, p999 = np.percentile(ms, [50.0, 99.0, 99.9])
    return float(p50), float(p99), float(p999), float(ms.mean())


def run_open_loop(server, cfg: TrafficConfig, *,
                  slo_s: Optional[float] = None,
                  chaos: Optional[ChaosConfig] = None,
                  schedule=None,
                  observability=None,
                  clock=time.monotonic, sleep=time.sleep,
                  max_wall_s: float = 120.0) -> TrafficReport:
    """Drive ``server`` (a ``SpikeEngine`` or ``FaultAwareRouter``) with the
    open-loop schedule and return the distilled :class:`TrafficReport`.

    Requests are admitted when their arrival time comes due (never before —
    open-loop), deadlines are anchored at the *nominal* arrival (queueing
    delay counts against the SLO, as it does for a user), and each drain's
    completion timestamp closes out every request it finished.  Latency is
    completion minus nominal arrival.  ``schedule`` is
    ``build_requests(cfg, chaos=chaos)``'s ``(requests, arrivals)`` when
    the caller wants the served requests; by default it is built here.

    ``observability`` (an ``obs.Observability``, typically the handle the
    engines were built with) brackets the run with ``traffic_start`` and
    ``traffic_end`` instants and folds the metrics-registry snapshot into
    ``TrafficReport.metrics``; the engines emit the real spans.
    """
    is_router = isinstance(server, FaultAwareRouter)
    engines = server.engines if is_router else [server]
    if chaos is not None:
        install_chaos(engines, chaos, sleep=sleep)
    reqs, arr = (schedule if schedule is not None
                 else build_requests(cfg, chaos=chaos))
    n = len(reqs)
    tracer = observability.tracer if observability is not None else None
    if tracer is not None:
        tracer.instant("traffic_start", cat="traffic", n_offered=n,
                       rate_hz=cfg.rate_hz, p_event=cfg.p_event)
    t0 = clock()
    completed_at = np.full(n, np.nan)
    done = [False] * n
    i = 0
    while True:
        now = clock() - t0
        if now > max_wall_s:
            break
        admitted_any = False
        while i < n and arr[i] <= now:
            r = reqs[i]
            if cfg.deadline_s is not None:
                r.deadline_s = t0 + float(arr[i]) + cfg.deadline_s
            if is_router:
                server.route(r)
            else:
                server.submit(r)
            admitted_any = True
            i += 1
        backlog = (server.backlog() if is_router
                   else server.queue_depth())
        if not admitted_any and backlog == 0:
            if i >= n:
                break
            wait = (t0 + float(arr[i])) - clock()
            if wait > 0:
                sleep(min(wait, 0.05))
            continue
        server.serve()
        t_done = clock() - t0
        for j in range(n):
            if not done[j] and (reqs[j].logits is not None
                                or reqs[j].status != "pending"):
                done[j] = True
                if reqs[j].logits is not None:
                    completed_at[j] = t_done

    duration = clock() - t0
    completed = ~np.isnan(completed_at)
    lat = completed_at[completed] - arr[completed]
    p50, p99, p999, mean_ms = _percentiles_ms(lat)
    statuses = [r.status for r in reqs]
    n_shed = statuses.count("shed")
    n_rejected = statuses.count("rejected")
    n_failed = statuses.count("failed")
    miss = 0
    if cfg.deadline_s is not None:
        miss = int((lat > cfg.deadline_s).sum())
    slo = slo_s if slo_s is not None else cfg.deadline_s
    goodput = (float((lat <= slo).sum()) / n if slo is not None
               else float(completed.sum()) / n) if n else 0.0

    retries = crashes = timeouts = degraded = 0
    if is_router:
        st = server.stats()
        retries, crashes = st["retries"], st["crashes"]
        timeouts, degraded = st["timeouts"], st["degraded_route"]
    estats = [e.stats() for e in engines]
    if tracer is not None:
        tracer.instant("traffic_end", cat="traffic",
                       n_completed=int(completed.sum()),
                       duration_s=duration)
    metrics_snapshot = (observability.metrics.snapshot()
                        if observability is not None
                        and observability.metrics is not None else None)
    return TrafficReport(
        n_offered=n,
        n_completed=int(completed.sum()),
        n_shed=n_shed,
        n_rejected=n_rejected,
        n_failed=n_failed,
        n_deadline_miss=miss,
        p50_ms=p50, p99_ms=p99, p999_ms=p999, mean_ms=mean_ms,
        goodput_slo=goodput, slo_s=slo,
        duration_s=duration,
        offered_rate_hz=n / max(duration, 1e-9),
        completed_rate_hz=float(completed.sum()) / max(duration, 1e-9),
        retries=retries, crashes=crashes, timeouts=timeouts,
        degraded_routes=degraded,
        backpressure_events=sum(s["backpressure_events"] for s in estats),
        ladder_transitions=sum(s["ladder_transitions"] for s in estats),
        max_degradation_level=max(
            (max((tr["to_level"] for tr in s["ladder_transition_log"]),
                 default=0) for s in estats), default=0),
        metrics=metrics_snapshot,
    )
