"""ESAM spike-classification serving on one device: ``SpikeEngine``.

Requests are bit-packed on the host into the wire format (32 spikes per
word, the paper's parallel-pulse inter-tile bus), padded to a power-of-two
bucket, and run through ONE packed ``EsamPlan`` per round: on the card the
whole tile cascade is one CUDA launch.  With ``telemetry=True`` the plan
also returns each tile's arbiter loads (one ``tile_loads`` launch) and the
paper-unit cost of every request is computed on the device in one
``request_stats`` launch (``_stats_fn``, the counterpart of the reference's
``_stats_jit``), which writes the round's logits and stats into one slab.
The slab leaves the card in one copy a round, into pinned host memory, and
one flush per drain attaches it to the requests and folds exact float64
totals, so ``stats()`` is a pure host read.

Beside single spike planes (``SpikeRequest``) the engine serves event
streams (``EventRequest``, ``submit_events``): T timesteps of spike planes,
drained in rounds of requests that share T through the temporal plan
(``mode="temporal"``).

The reference's serving planes around the datapath are here too: round
fusion (``fuse_rounds``), the overlapped drain (``overlap=True``: a
packer thread fills pinned host slots while the previous round runs),
cold start (``warmup``: every shape run once, and on the card one CUDA graph
a bucket, replayed from then on), and the overload plane (bounded
admission, deadlines, the degradation ladder, the straggler watchdog).

Fault-aware serving: ``SpikeEngine(faults=)`` serves through plans built
with that ``FaultModel`` (its masks read at the plans' 4 ports, as the
reference's engine reads them), scores each tile's health from the
telemetry, and ``replan_degraded`` rebuilds its plan for a surviving device
count.  ``FaultAwareRouter`` drains traffic across several engines around
degraded, slow and crashed replicas, with ``RetryPolicy`` backoff.

Observability (``observability=``, an ``obs.Observability``): the engine
and the router emit the reference's spans, instants and metrics (request
lifecycles, each round's pack, dispatch, device drain and telemetry flush,
admission, sheds, the ladder, warmup, crashes and re-routes) and call the
device profiler's hooks around each round.  Off by default; the off path
is the instrumented path bit for bit.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import math
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from repro_torch.core import packing
from repro_torch.core.esam import cost_model as cm
from repro_torch.core.esam.temporal import TemporalConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.telemetry import ops as tele
from repro_torch.obs import Observability, record_warmup_times
from repro_torch.serve.overload import (  # noqa: F401  (AdmissionVerdict re-exported)
    AdmissionVerdict,
    DegradationLadder,
    LadderLevel,
)
from repro_torch.train import fault_tolerance as ft


@dataclasses.dataclass
class SpikeRequest:
    spikes: np.ndarray                     # {0,1}[n_in] (any dtype)
    # overload plane (optional): absolute deadline in the engine's clock —
    # requests still queued past it are shed instead of dispatched
    deadline_s: Optional[float] = None
    # lifecycle: "pending" -> "done" | "shed" (deadline) | "rejected"
    # (bounded queue full) | "failed" (a router's retry budget exhausted)
    status: str = "pending"
    attempts: int = 0                      # router retry count
    # filled by the engine:
    logits: Optional[np.ndarray] = None    # float32[n_classes]
    label: Optional[int] = None            # argmax readout
    # filled when the engine runs with telemetry (paper-unit hardware cost):
    cycles: Optional[int] = None           # CIM clock cycles, summed over tiles
    latency_ns: Optional[float] = None     # cycles * cell clock period
    energy_pj: Optional[float] = None      # per-inference energy (pJ/inf)


@dataclasses.dataclass
class EventRequest:
    """An event-stream classification request: T timesteps of spike planes.

    ``events``: {0,1}[T, n_in] (any dtype), or wire-format uint32
    ``[T, ceil(n_in/32)]``.  T may differ per request — the engine drains
    event rounds of requests that share T.
    """

    events: np.ndarray
    # overload plane (optional): see SpikeRequest
    deadline_s: Optional[float] = None
    status: str = "pending"
    attempts: int = 0
    # filled by the engine:
    logits: Optional[np.ndarray] = None    # float32[n_classes]
    label: Optional[int] = None            # argmax readout
    served_steps: Optional[int] = None     # timesteps served (a degraded
    #                                        ladder level may truncate)
    # filled when the engine runs with telemetry (paper-unit hardware cost):
    cycles: Optional[int] = None           # CIM cycles, summed over T steps
    latency_ns: Optional[float] = None     # cycles * cell clock period
    energy_pj: Optional[float] = None      # whole-stream energy
    energy_pj_per_step: Optional[float] = None  # energy_pj / T

    @property
    def n_steps(self) -> int:
        return int(np.asarray(self.events).shape[0])


@functools.lru_cache(maxsize=None)
def _stats_fn(topology: tuple, read_ports: int, temporal: bool):
    """One cost function per (topology, ports, mode), shared by every
    engine: the counterpart of the reference's ``_stats_jit``.  It takes a
    round's plan result and returns its slab (``tele.stats_columns``: the
    logits, then the per-request cost), one ``request_stats`` launch on the
    card.  Sharing it makes every engine's telemetry bit-identical by
    construction."""
    def fn(res) -> torch.Tensor:
        return tele.request_stats(res.loads, topology, read_ports,
                                  temporal=temporal, logits=res.logits)
    return fn


def _logits_only(res) -> torch.Tensor:
    return res.logits


# ------------------------------------------------------------------ #
# stats(): the reference's versioned schema, every section
# ------------------------------------------------------------------ #
STATS_SCHEMA_VERSION = 1

_STATS_SCHEMA: dict[str, dict[str, str]] = {
    # engine identity + configuration
    "identity": {
        "stats_schema_version": "int",
        "requests": "int",              # legacy alias of n_requests
        "n_requests": "int",
        "telemetry": "bool",
        "cell": "str",
        "read_ports": "int",
        "data_parallel": "int",
    },
    # tile health + dispatch watchdog
    "health": {
        "faulted": "bool",
        "tile_health": "list",
        "health": "float",
        "degraded": "bool",
        "dispatch_rounds": "int",
        "straggler_rounds": "int",
    },
    # overload plane: admission, deadlines, degradation ladder
    "overload": {
        "queue_depth": "int",
        "queue_limit": "int|None",
        "high_water": "int|None",
        "shed_deadline": "int",
        "rejected_full": "int",
        "backpressure_events": "int",
        "degradation_level": "int",
        "degradation_level_name": "str",
        "ladder_transitions": "int",
        "ladder_transition_log": "list",
    },
    # per-round host/dispatch observability
    "rounds": {
        "rounds_static": "int",
        "rounds_event": "int",
        "rows_real_total": "int",
        "rows_padded_total": "int",
        "pad_fraction": "float",
        "rounds_per_bucket": "dict",
        "padded_rows_per_bucket": "dict",
        "real_rows_per_bucket": "dict",
        "pad_fraction_per_bucket": "dict",
        "host_pack_s_total": "float",
        "dispatch_s_total": "float",
    },
    # fused dispatch
    "fusion": {
        "fuse_rounds": "int",
        "overlap": "bool",
        "fused_rounds": "int",
        "rounds_saved": "int",
    },
    # event-stream (temporal plane) aggregates
    "events": {
        "n_event_requests": "int",
        "timesteps_total": "int",
        "event_energy_pj_mean": "float",
        "event_latency_ns_mean": "float",
        "event_cycles_mean": "float",
        "energy_pj_per_timestep": "float",
    },
    # paper-unit hardware cost aggregates (zero-filled before any traffic)
    "cost": {
        "cycles_mean": "float",
        "latency_ns_mean": "float",
        "energy_pj_per_inf": "float",
        "throughput_inf_s": "float",
        "throughput_pipelined_inf_s": "float",
    },
}


def stats_schema() -> dict[str, dict[str, str]]:
    """The schema of ``SpikeEngine.stats()``: section -> key -> type name
    (``"int|None"`` marks optionally-unset config knobs).  ``stats()``
    returns exactly the union of these keys."""
    return {section: dict(keys) for section, keys in _STATS_SCHEMA.items()}


def _bucket_sizes(max_batch: int, min_bucket: int, dp: int) -> list[int]:
    """Power-of-two bucket ladder: min_bucket, 2*min_bucket, ... >= max_batch.

    Every bucket is a multiple of the data-parallel degree ``dp`` so a padded
    batch always divides the mesh; the smallest bucket never exceeds the
    (rounded-up) ``max_batch`` itself.
    """
    top = 1
    while top < max_batch:
        top <<= 1
    lo = max(min(min_bucket, top), dp)
    b = 1
    while b < lo:
        b <<= 1
    sizes = [b]
    while sizes[-1] < top:
        sizes.append(sizes[-1] * 2)
    return sizes


class _HostSlot:
    """One slot of the overlapped drain's input ring: int32 words the
    packer thread fills through a uint32 numpy view.  Pinned on the card
    (so the copy to the device is asynchronous; ``event`` marks its end),
    plain numpy on the CPU."""

    def __init__(self, pinned: bool):
        self.pinned = pinned
        self.tensor: Optional[torch.Tensor] = None
        self.words: Optional[np.ndarray] = None
        self.event = None

    def claim(self, shape: tuple) -> np.ndarray:
        """Wait until the slot's last copy to the device has ended, grow it
        if need be, and return a uint32 view of ``shape`` to pack into."""
        if self.event is not None:
            self.event.synchronize()
            self.event = None
        n = math.prod(shape)
        if self.words is None or self.words.size < n:
            if self.pinned:
                self.tensor = torch.empty((n,), dtype=torch.int32,
                                          pin_memory=True)
                self.words = self.tensor.numpy().view(np.uint32)
            else:
                self.words = np.empty((n,), np.uint32)
        return self.words[:n].reshape(shape)


class SpikeEngine:
    """Continuously batched ESAM serving on one device.

    Requests enter admission queues (``submit``; ``serve`` is submit +
    drain) and are dispatched in rounds of up to ``max_batch`` requests, each
    zero-padded up to the next power-of-two bucket (silent pad rows are exact
    for the binary CIM MAC).  Static requests run through one packed plan;
    event streams through the temporal plan of their T, whose LIF dynamics
    come from ``temporal`` (default ``TemporalConfig(n_steps=1)``: no leak,
    reset to zero, which makes a T=1 stream the static path bit for bit).
    ``device`` defaults to ``"cuda"`` and must be the network's device.

    ``fuse_rounds`` coalesces up to that many legacy rounds into one
    dispatch (``"auto"`` = the data-parallel degree, 1 on one device; the
    bucket ladder extends to ``max_batch * fuse``); fusion changes when work
    is dispatched, never what is computed.  ``overlap=True`` packs round
    N+1 on a background thread (numpy only) into one of two host slots
    while round N is dispatched; every torch call stays on the caller's
    thread.  ``warmup()`` runs every bucket (and the event (bucket, T)
    grid) before the first request and, on the card, captures each as one
    CUDA graph keyed by (bucket, effective read ports, T); a warmed round is
    then the input copy, one replay and one copy out.

    The overload plane: ``queue_limit`` bounds admission (``submit``
    rejects past it) and ``high_water`` (default half the limit) flags
    backpressure; requests carry optional ``deadline_s`` in the engine's
    ``clock`` and are shed once past it; ``ladder`` (a
    ``DegradationLadder``) steps service down under sustained pressure
    (queue depth past the high-water mark, or a round the ``watchdog``
    flags) and back up when it clears.  ``round_hook(round)`` runs before
    each round inside the watchdog's timing.

    ``faults`` (a ``FaultModel``) goes to the static plan and to every
    event plan; ``stats()["faulted"]`` reports it.

    ``observability`` (an ``Observability``) instruments the engine as the
    reference's is: every lane off by default, and each emission guarded,
    so the off path holds no instruments.
    """

    def __init__(self, net, *, max_batch: int = 128, min_bucket: int = 8,
                 fuse_rounds=None,  # None | "auto" | int >= 1
                 overlap: bool = False,
                 telemetry: bool = False, read_ports: int = 4,
                 temporal: Optional[TemporalConfig] = None,
                 faults=None,  # Optional[faults.FaultModel]
                 watchdog: Optional[ft.StragglerWatchdog] = None,
                 health_threshold: float = 0.75,
                 queue_limit: Optional[int] = None,
                 high_water: Optional[int] = None,
                 ladder: Optional[DegradationLadder] = None,
                 clock=time.monotonic,
                 round_hook=None,
                 observability: Optional[Observability] = None,
                 device="cuda"):
        dev = resolve_device(device)
        if net.device != dev:
            raise ValueError(f"network lives on {net.device}, engine asked "
                             f"for {dev}")
        if fuse_rounds is not None and fuse_rounds != "auto":
            if int(fuse_rounds) < 1:
                raise ValueError(f"fuse_rounds must be >= 1, got "
                                 f"{fuse_rounds!r}")
        self.net = net
        self.device = dev
        self.max_batch = max_batch
        self.n_in = net.topology[0]
        self.telemetry = telemetry
        self.read_ports = read_ports
        self.faults = faults
        self.health_threshold = health_threshold
        self._min_bucket = min_bucket
        # dispatch-round straggler watchdog: each round's host wall time
        # (packing + dispatch; device work is asynchronous) feeds its EMA
        self._watchdog = watchdog or ft.StragglerWatchdog()
        self._rounds = 0
        # ---- overload plane ---------------------------------------- #
        self._clock = clock
        self._queue_limit = queue_limit
        if high_water is None and queue_limit is not None:
            high_water = max(1, queue_limit // 2)
        self._high_water = high_water
        self._ladder = ladder
        self._ladder_level = 0
        self._pressure_streak = 0
        self._clear_streak = 0
        self._ladder_flagged_seen = 0
        self._transitions: list[dict] = []
        self.round_hook = round_hook
        # ---- observability plane ----------------------------------- #
        # every lane defaults off; each emission is guarded, so the off
        # path is the instrumented path bit for bit (spans observe, never
        # perturb: tests/test_torch_obs_identity.py)
        self._obs = observability
        self._tracer = observability.tracer if observability else None
        self._metrics = observability.metrics if observability else None
        self._profiler = observability.profile if observability else None
        # id(request) -> (async span id, admit ts us); removed at every
        # terminal transition, so the map never outgrows the queue
        self._req_spans: dict[int, tuple[int, float]] = {}
        self._m = self._make_instruments(self._metrics)
        self._shed_deadline = 0
        self._rejected_full = 0
        self._backpressure_events = 0
        self._round_counters = {
            "rounds_static": 0, "rounds_event": 0, "rows_real": 0,
            "rows_padded": 0, "host_pack_s": 0.0, "dispatch_s": 0.0,
            "fused_rounds": 0, "rounds_saved": 0,
        }
        self._rounds_per_bucket: dict[int, int] = {}
        self._padded_rows_per_bucket: dict[int, int] = {}
        self._real_rows_per_bucket: dict[int, int] = {}
        # ---- fusion, overlap, graphs ------------------------------- #
        self._fuse_arg = fuse_rounds
        self._fuse = self._fuse_factor(1)
        self._overlap = bool(overlap)
        self._pool: Optional[ThreadPoolExecutor] = None
        self._slots = [_HostSlot(dev.type == "cuda") for _ in range(2)]
        self._next_slot = 0
        self._buckets = _bucket_sizes(max_batch * self._fuse, min_bucket, 1)
        #: CUDA graphs this engine captured and replayed (the wrappers'
        #: launch counters see captures, never replays)
        self._graph_counts = {"captures": 0, "replays": 0}
        self._plan = net.plan(mode="packed", telemetry=telemetry,
                              faults=faults)
        # LIF dynamics of event streams; n_steps comes from each request
        self._temporal = temporal or TemporalConfig(n_steps=1)
        n_tiles = len(net.topology) - 1
        # tile-health calibration: expected mean drain cycles per tile on
        # the reference activity profile (the paper's 53%/50% point)
        topo = net.topology
        ref = [
            np.full((1, cm.tile_geometry(topo[t], topo[t + 1])[0]),
                    float(cm.REF_SPIKES_PER_GROUP[t])
                    if t < len(cm.REF_SPIKES_PER_GROUP) else 64.0)
            for t in range(n_tiles)
        ]
        self._expected_tile_cycles = cm.request_stats(
            topo, ref, read_ports).cycles_per_tile.mean(axis=0)
        # admission queues + per-round results awaiting one host flush:
        # (requests, host slab, event marking its copy out or None)
        self._pending: list[SpikeRequest] = []
        self._pending_events: list[EventRequest] = []
        self._inflight: list[tuple[list, torch.Tensor, object]] = []
        # exact float64 telemetry totals, folded in at each drain flush
        self._served = 0
        self._served_events = 0
        self._served_timesteps = 0
        self._totals = {
            "cycles": 0.0,
            "cycles_per_tile": np.zeros((n_tiles,), np.float64),
            "latency_ns": 0.0,
            "energy_pj": 0.0,
        }
        self._event_totals = {"cycles": 0.0, "latency_ns": 0.0,
                              "energy_pj": 0.0}

    # -------------------------------------------------------------- #
    # observability plane: instruments + span helpers (no-ops when off)
    # -------------------------------------------------------------- #
    @staticmethod
    def _make_instruments(reg) -> Optional[dict]:
        """Register every engine metric up front (the reference's 22, their
        names, labels and help), so a scrape shows the whole zeroed surface
        before the first request.  Counters go up by exactly the values
        ``stats()`` folds, so the two reconcile."""
        if reg is None:
            return None
        c, g, h = reg.counter, reg.gauge, reg.histogram
        return {
            "submitted": c("esam_requests_submitted_total",
                           "requests admitted to the engine queue"),
            "rejected": c("esam_requests_rejected_total",
                          "bounded-queue admission rejections"),
            "shed": c("esam_requests_shed_total",
                      "requests shed on an expired deadline"),
            "served_static": c("esam_requests_served_total",
                               "requests served", kind="static"),
            "served_event": c("esam_requests_served_total",
                              "requests served", kind="event"),
            "timesteps": c("esam_timesteps_served_total",
                           "event-stream timesteps served"),
            "rounds": c("esam_dispatch_rounds_total",
                        "continuous-batching dispatch rounds"),
            "fused": c("esam_fused_rounds_total",
                       "rounds that coalesced >1 legacy bucket-round"),
            "rounds_saved": c("esam_rounds_saved_total",
                              "legacy bucket-rounds saved by fusion"),
            "rows_real": c("esam_rows_real_total",
                           "real (non-padded) rows dispatched"),
            "rows_padded": c("esam_rows_padded_total",
                             "zero-padded bucket rows dispatched"),
            "backpressure": c("esam_backpressure_events_total",
                              "admissions past the high-water mark"),
            "ladder_transitions": c("esam_ladder_transitions_total",
                                    "degradation-ladder level changes"),
            "energy": c("esam_energy_pj_total",
                        "modeled inference energy (pJ), telemetry lane"),
            "cycles": c("esam_cycles_total",
                        "modeled CIM cycles, telemetry lane"),
            "queue_depth": g("esam_queue_depth",
                             "requests admitted and awaiting dispatch"),
            "ladder_level": g("esam_degradation_level",
                              "current degradation-ladder level (0=full)"),
            "health": g("esam_health",
                        "weakest-tile health score in [0,1]"),
            "pack_s": h("esam_round_pack_seconds",
                        "host-side wire-format packing time per round"),
            "dispatch_s": h("esam_round_dispatch_seconds",
                            "plan dispatch-call time per round"),
            "queue_s": h("esam_request_queue_seconds",
                         "admit -> round-formation queue wait"),
            "latency_s": h("esam_request_latency_seconds",
                           "admit -> terminal-state request latency"),
        }

    def _obs_admit(self, r) -> None:
        """Open the request's async span and book the admission."""
        if self._m is not None:
            self._m["submitted"].inc()
            self._m["queue_depth"].set(self.queue_depth())
        if self._tracer is not None:
            rid = self._tracer.next_id()
            self._req_spans[id(r)] = (rid, self._tracer.now_us())
            self._tracer.begin_async(
                "request", rid,
                kind="event" if isinstance(r, EventRequest) else "static",
                deadline_s=r.deadline_s, dp=1)

    def _obs_close(self, r, status: str, **args) -> None:
        """Close the request's async span at a terminal transition."""
        entry = self._req_spans.pop(id(r), None)
        if entry is None:
            return
        rid, t_admit = entry
        now = self._tracer.now_us()
        if self._m is not None:
            self._m["latency_s"].observe((now - t_admit) / 1e6)
        self._tracer.end_async("request", rid, status=status, **args)

    def _obs_abandon(self, reqs) -> None:
        """Close the spans of requests this engine will never finish: its
        replica crashed and the router takes them elsewhere, where each
        opens a span of its own.  No latency is observed (the request has
        not ended).  The reference leaves these spans open."""
        if self._tracer is None:
            return
        for r in reqs:
            entry = self._req_spans.pop(id(r), None)
            if entry is not None:
                self._tracer.end_async("request", entry[0], status="crashed")

    def _obs_queue_spans(self, reqs, bucket: int) -> None:
        """Per-request queue-wait spans: admit time -> round formation."""
        now = self._tracer.now_us()
        for r in reqs:
            entry = self._req_spans.get(id(r))
            if entry is None:
                continue
            rid, t_admit = entry
            self._tracer.complete("queue", t_admit, now - t_admit,
                                  cat="request", req=rid, bucket=bucket)
            if self._m is not None:
                self._m["queue_s"].observe((now - t_admit) / 1e6)

    # -------------------------------------------------------------- #
    # admission + dispatch
    # -------------------------------------------------------------- #
    def queue_depth(self) -> int:
        """Requests currently admitted and awaiting dispatch (both queues)."""
        return len(self._pending) + len(self._pending_events)

    def submit(self, requests):
        """Queue requests without dispatching (single request or list).

        ``SpikeRequest`` and ``EventRequest`` objects may be mixed; each goes
        to its own queue.  Returns an :class:`AdmissionVerdict` per request
        (a single verdict for a single request): with ``queue_limit`` a full
        queue rejects the request (``status="rejected"``, nothing queued),
        and depth past the high-water mark flags ``backpressure``.
        """
        single = isinstance(requests, (SpikeRequest, EventRequest))
        if single:
            requests = [requests]
        verdicts = []
        for r in requests:
            depth = self.queue_depth()
            if self._queue_limit is not None and depth >= self._queue_limit:
                r.status = "rejected"
                self._rejected_full += 1
                if self._m is not None:
                    self._m["rejected"].inc()
                if self._tracer is not None:
                    self._tracer.instant("rejected", queue_depth=depth)
                verdicts.append(AdmissionVerdict(
                    admitted=False, reason="queue_full", queue_depth=depth))
                continue
            if isinstance(r, EventRequest):
                self._pending_events.append(r)
            else:
                self._pending.append(r)
            if self._obs is not None:
                self._obs_admit(r)
            depth += 1
            bp = self._high_water is not None and depth > self._high_water
            if bp:
                self._backpressure_events += 1
                if self._m is not None:
                    self._m["backpressure"].inc()
            verdicts.append(AdmissionVerdict(
                admitted=True, backpressure=bp, queue_depth=depth))
        return verdicts[0] if single else verdicts

    def submit_events(self, requests):
        """Queue event-stream requests (single ``EventRequest`` or list)."""
        if isinstance(requests, EventRequest):
            requests = [requests]
        if not all(isinstance(r, EventRequest) for r in requests):
            raise TypeError("submit_events takes EventRequests only")
        return self.submit(requests)

    def serve(self, requests=None) -> list:
        """Enqueue ``requests`` (optional), shed expired deadlines, drain both
        queues — static rounds first, then event rounds — and flush results.

        Returns the list of requests served in this call (the passed-in list
        when given, else everything that was pending)."""
        if requests is not None:
            self.submit(requests)
            out = requests if isinstance(requests, list) else [requests]
        else:
            out = list(self._pending) + list(self._pending_events)
        self._shed_expired()
        self._drain_static()
        self._drain_events()
        self._flush()
        return out

    # -------------------------------------------------------------- #
    # drain loops: synchronous and overlapped (double-buffered)
    # -------------------------------------------------------------- #
    def _pop_static_round(self) -> list[SpikeRequest]:
        """Pop one round's worth of static requests (up to the fused
        budget)."""
        self._ladder_tick()
        budget = self._round_budget()
        reqs = self._pending[: budget]
        del self._pending[: budget]
        return reqs

    def _pop_event_round(self) -> tuple[list[EventRequest], int]:
        """Pop one event round: the head request's effective T (a degraded
        ladder level caps it) and the requests that share it, in arrival
        order, up to the fused budget."""
        self._ladder_tick()
        budget = self._round_budget()
        t_cap = self._level().event_t_cap
        t = self._pending_events[0].n_steps
        if t_cap is not None:
            t = min(t, t_cap)
        round_reqs, rest = [], []
        for r in self._pending_events:
            eff = r.n_steps if t_cap is None else min(r.n_steps, t_cap)
            if eff == t and len(round_reqs) < budget:
                round_reqs.append(r)
            else:
                rest.append(r)
        self._pending_events = rest
        return round_reqs, t

    def _drain_static(self) -> None:
        if self._overlap:
            self._drain_overlap("_pending", self._form_static_round)
            return
        while self._pending:
            self._timed_round(self._dispatch, self._pop_static_round())
            self._shed_expired()

    def _drain_events(self) -> None:
        if self._overlap:
            self._drain_overlap("_pending_events", self._form_event_round)
            return
        while self._pending_events:
            round_reqs, t = self._pop_event_round()
            self._timed_round(self._dispatch_events, round_reqs, t)
            self._shed_expired()

    def _claim_slot(self, shape: tuple) -> tuple[_HostSlot, np.ndarray]:
        """The next host slot of the ring (main thread: it may wait on the
        slot's last copy and allocate pinned memory)."""
        slot = self._slots[self._next_slot]
        self._next_slot ^= 1
        return slot, slot.claim(shape)

    def _form_static_round(self):
        """Pop a round and split it into (pack, launch) halves: the pack
        (numpy into a host slot) runs on the packer thread while the
        previous round is dispatched; the launch runs torch on the caller's
        thread.  Everything the closures touch is captured here."""
        reqs = self._pop_static_round()
        bucket = self._bucket(len(reqs))
        slot, view = self._claim_slot(
            (bucket, packing.packed_width(self.n_in)))
        return (lambda: self._pack_static(reqs, bucket, out=view),
                lambda packed, pack_s: self._launch_static(
                    reqs, bucket, packed, pack_s, slot=slot))

    def _form_event_round(self):
        reqs, t = self._pop_event_round()
        bucket = self._bucket(len(reqs))
        for r in reqs:
            r.served_steps = t
        events = [np.asarray(r.events) for r in reqs]  # capture on main thread
        slot, view = self._claim_slot(
            (t, bucket, packing.packed_width(self.n_in)))
        return (lambda: self._pack_events(events, t, bucket, out=view),
                lambda packed, pack_s: self._launch_events(
                    reqs, bucket, t, packed, pack_s, slot=slot))

    def _drain_overlap(self, queue_name: str, form) -> None:
        """Double-buffered drain: a bounded depth-2 ring of formed rounds —
        the packer thread builds round N+1's wire-format batch while round
        N's dispatch runs on the caller's thread.  The watchdog times the
        dispatch half.  A raising round hook aborts with formed rounds
        popped but unserved (the crash-mid-drain state)."""
        pool = self._packer_pool()
        ring: collections.deque = collections.deque()
        try:
            while getattr(self, queue_name) or ring:
                while getattr(self, queue_name) and len(ring) < 2:
                    pack, launch = form()
                    ring.append((pool.submit(pack), launch))
                fut, launch = ring.popleft()
                packed, pack_s = fut.result()
                self._timed_round(launch, packed, pack_s)
                self._shed_expired()
        finally:
            while ring:
                ring.popleft()[0].cancel()

    def _packer_pool(self) -> ThreadPoolExecutor:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="spike-packer")
        return self._pool

    def close(self) -> None:
        """Shut down the background packer thread (no-op when never used)."""
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    # -------------------------------------------------------------- #
    # cold start: every shape before the first request
    # -------------------------------------------------------------- #
    def _warm_ports(self) -> list[int]:
        """The read-port options a round may be costed at: the engine's and
        every ladder level's (one option, which no graph keys on, without
        telemetry)."""
        ports = {self._effective_read_ports()}
        if self._ladder is not None and self.telemetry:
            ports |= {lv.read_ports for lv in self._ladder.levels
                      if lv.read_ports is not None}
        return sorted(ports)

    def _epilogue(self, ports: int, temporal: bool):
        """What a round runs after its plan: the stats (which carry the
        logits into the round's slab), or the logits alone."""
        if not self.telemetry:
            return _logits_only
        return _stats_fn(self.net.topology, ports, temporal)

    def _graph_key(self, ports: int):
        return ports if self.telemetry else None

    def warmup(self, *, event_ts=(), aot: bool = True) -> dict:
        """Run every shape the drain can dispatch before the first request.

        The static plan runs once at every bucket of the engine's ladder;
        ``event_ts`` adds the temporal (bucket, T) grid, expanded with the
        ladder's ``event_t_cap`` rungs.  On the card, with ``aot=True``,
        each (bucket, T) is then captured as one CUDA graph for every
        read-port option a round may be costed at (the engine's and the
        ladder's), and served rounds replay it.  Returns seconds per shape
        (``static``, ``event_t<T>``), ``telemetry_s`` (an eager pass of the
        cost model over every shape, with telemetry on), ``graphs`` (graphs
        captured: 0 on the CPU and with ``aot=False``) and ``total_s``.
        Nothing is recorded: counters, totals and the in-flight results are
        untouched."""
        t0 = time.perf_counter()
        ts = {int(t) for t in event_ts}
        if ts and self._ladder is not None:
            caps = {lv.event_t_cap for lv in self._ladder.levels
                    if lv.event_t_cap is not None}
            ts |= {min(t, c) for t in set(ts) for c in caps}
        plans = [("static", self._plan, False)] + [
            (f"event_t{t}", self._event_plan(t), True) for t in sorted(ts)]
        captures0 = sum(p.captures for _, p, _ in plans)
        times: dict = {}
        for name, plan, temporal in plans:
            per: dict = {}
            for ports in self._warm_ports():
                got = plan.warmup(self._buckets, aot=aot,
                                  epilogue=self._epilogue(ports, temporal),
                                  key=self._graph_key(ports))
                for b, s in got.items():
                    per[b] = per.get(b, 0.0) + s
            times[name] = per
        graphs = sum(p.captures for _, p, _ in plans) - captures0
        self._graph_counts["captures"] += graphs
        if self.telemetry:
            # the cost model alone, eagerly over every shape's plan output
            ports = self._effective_read_ports()
            tw0 = time.perf_counter()
            for _, plan, temporal in plans:
                for b in self._buckets:
                    self._epilogue(ports, temporal)(
                        plan(plan.input_buffer(b)))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            times["telemetry_s"] = time.perf_counter() - tw0
        times["graphs"] = graphs
        times["total_s"] = time.perf_counter() - t0
        if self._metrics is not None:
            # seconds a shape; the graph count is not a time
            record_warmup_times(self._metrics, {
                k: v for k, v in times.items() if k != "graphs"})
        if self._tracer is not None:
            self._tracer.instant("warmup_done", cat="engine",
                                 total_s=times["total_s"],
                                 shapes=len(self._buckets) + len(ts))
        return times

    def graph_counts(self) -> dict[str, int]:
        """CUDA graphs this engine captured (warmup and re-captures after a
        weight change) and replayed (one a warmed round)."""
        return dict(self._graph_counts)

    # -------------------------------------------------------------- #
    # overload plane: deadline shedding + degradation ladder
    # -------------------------------------------------------------- #
    def _shed_expired(self) -> None:
        """Drop still-queued requests whose deadline already passed
        (``status="shed"``, counted in ``stats()["shed_deadline"]``).
        Requests without a deadline never shed."""
        now = None
        for name in ("_pending", "_pending_events"):
            queue = getattr(self, name)
            if not any(r.deadline_s is not None for r in queue):
                continue
            if now is None:
                now = self._clock()
            keep = []
            for r in queue:
                if r.deadline_s is not None and now > r.deadline_s:
                    r.status = "shed"
                    self._shed_deadline += 1
                    if self._m is not None:
                        self._m["shed"].inc()
                    if self._tracer is not None:
                        self._tracer.instant("shed", deadline_s=r.deadline_s)
                        self._obs_close(r, "shed")
                else:
                    keep.append(r)
            setattr(self, name, keep)

    def _level(self) -> LadderLevel:
        if self._ladder is None:
            return LadderLevel("full")
        return self._ladder.level(self._ladder_level)

    def _round_limit(self) -> int:
        cap = self._level().bucket_cap
        return self.max_batch if cap is None else max(1, min(self.max_batch,
                                                             cap))

    def _fuse_factor(self, dp: int) -> int:
        """Resolve ``fuse_rounds``: None => 1 (the legacy drain), ``"auto"``
        => the data-parallel degree, an int => itself."""
        if self._fuse_arg is None:
            return 1
        if self._fuse_arg == "auto":
            return max(1, int(dp))
        return max(1, int(self._fuse_arg))

    def _round_budget(self) -> int:
        """Requests per dispatch round: the ladder's bucket ceiling times
        the fusion factor (capped by the level's ``fuse_cap``)."""
        cap = self._level().fuse_cap
        fuse = self._fuse if cap is None else max(1, min(self._fuse, cap))
        return self._round_limit() * fuse

    def _effective_read_ports(self) -> int:
        ports = self._level().read_ports
        return self.read_ports if ports is None else ports

    def _ladder_tick(self) -> None:
        """One pressure observation per dispatch round: queue depth past the
        high-water mark, or a round the watchdog flagged since the last
        tick.  ``step_down_after`` pressured rounds in a row move one level
        down, ``step_up_after`` clear ones one level up."""
        if self._ladder is None:
            return
        flagged = len(self._watchdog.flagged)
        straggler = flagged > self._ladder_flagged_seen
        self._ladder_flagged_seen = flagged
        deep = (self._high_water is not None
                and self.queue_depth() > self._high_water)
        if deep or straggler:
            self._pressure_streak += 1
            self._clear_streak = 0
            if (self._pressure_streak >= self._ladder.step_down_after
                    and self._ladder_level < self._ladder.n_levels - 1):
                self._record_transition(
                    self._ladder_level + 1,
                    "queue_depth" if deep else "straggler")
                self._pressure_streak = 0
        else:
            self._clear_streak += 1
            self._pressure_streak = 0
            if (self._clear_streak >= self._ladder.step_up_after
                    and self._ladder_level > 0):
                self._record_transition(self._ladder_level - 1,
                                        "pressure_cleared")
                self._clear_streak = 0

    def _record_transition(self, to_level: int, reason: str) -> None:
        self._transitions.append({
            "round": self._rounds,
            "from_level": self._ladder_level,
            "to_level": to_level,
            "from": self._ladder.level(self._ladder_level).name,
            "to": self._ladder.level(to_level).name,
            "reason": reason,
        })
        if self._m is not None:
            self._m["ladder_transitions"].inc()
            self._m["ladder_level"].set(to_level)
        if self._tracer is not None:
            self._tracer.instant(
                "ladder_transition", cat="ladder", round=self._rounds,
                from_level=self._ladder_level, to_level=to_level,
                reason=reason)
        self._ladder_level = to_level

    def _timed_round(self, dispatch, *args) -> None:
        """One dispatch round under the straggler watchdog: its host wall
        time feeds the EMA.  The round hook runs inside the timed section; a
        raising hook aborts the round before dispatch.  The device
        profiler's window opens and closes around rounds here."""
        t0 = time.perf_counter()
        if self._profiler is not None:
            self._profiler.on_round_start(self._rounds)
        trace_t0 = (self._tracer.now_us() if self._tracer is not None
                    else 0.0)
        if self.round_hook is not None:
            self.round_hook(self._rounds)
        dispatch(*args)
        if self._tracer is not None:
            self._tracer.complete(
                "round", trace_t0, self._tracer.now_us() - trace_t0,
                cat="round", round=self._rounds, level=self._level().name,
                dp=1)
        if self._profiler is not None:
            self._profiler.on_round_end(self._rounds)
        if self._m is not None:
            self._m["rounds"].inc()
            self._m["queue_depth"].set(self.queue_depth())
        self._watchdog.record(self._rounds, time.perf_counter() - t0)
        self._rounds += 1

    def _bucket(self, n: int) -> int:
        for b in self._buckets:
            if n <= b:
                return b
        return self._buckets[-1]

    def _note_round(self, kind: str, bucket: int, n_real: int, pack_s: float,
                    dispatch_s: float, n_legacy: int = 1) -> None:
        """Fold one round into the aggregates; ``n_legacy`` is how many
        legacy rounds it replaced (more than 1: a fused round)."""
        c = self._round_counters
        c[f"rounds_{kind}"] += 1
        c["rows_real"] += n_real
        c["rows_padded"] += bucket - n_real
        c["host_pack_s"] += pack_s
        c["dispatch_s"] += dispatch_s
        if n_legacy > 1:
            c["fused_rounds"] += 1
            c["rounds_saved"] += n_legacy - 1
        if self._m is not None:
            self._m[f"served_{kind}"].inc(n_real)
            self._m["rows_real"].inc(n_real)
            self._m["rows_padded"].inc(bucket - n_real)
            self._m["pack_s"].observe(pack_s)
            self._m["dispatch_s"].observe(dispatch_s)
            if n_legacy > 1:
                self._m["fused"].inc()
                self._m["rounds_saved"].inc(n_legacy - 1)
        self._rounds_per_bucket[bucket] = (
            self._rounds_per_bucket.get(bucket, 0) + 1)
        self._padded_rows_per_bucket[bucket] = (
            self._padded_rows_per_bucket.get(bucket, 0) + bucket - n_real)
        self._real_rows_per_bucket[bucket] = (
            self._real_rows_per_bucket.get(bucket, 0) + n_real)

    def _n_legacy(self, n: int) -> int:
        """Legacy bucket-rounds a round of ``n`` requests replaces."""
        return max(1, math.ceil(n / self._round_limit()))

    # -------------------------------------------------------------- #
    # a round: host pack, then the device half
    # -------------------------------------------------------------- #
    def _pack_static(self, reqs: list[SpikeRequest], bucket: int,
                     out: Optional[np.ndarray] = None
                     ) -> tuple[np.ndarray, float]:
        """Host half of a round: bit-pack to the padded wire format (numpy
        only: safe on the packer thread), into ``out`` when given."""
        trace_t0 = self._tracer.now_us() if self._tracer is not None else 0.0
        t0 = time.perf_counter()
        packed = packing.pack_padded_rows_np(
            [r.spikes for r in reqs], bucket, self.n_in)
        if out is not None:
            out[...] = packed
            packed = out
        pack_s = time.perf_counter() - t0
        if self._tracer is not None:
            self._tracer.complete(
                "pack", trace_t0, self._tracer.now_us() - trace_t0,
                cat="round", kind="static", bucket=bucket, n_real=len(reqs))
        return packed, pack_s

    def _run_round(self, plan, bucket: int, packed: np.ndarray,
                   slot: Optional[_HostSlot], temporal: bool):
        """The device half of a round, on the caller's thread: the words to
        the device, the plan and its epilogue (or the round's CUDA graph),
        and the round's one slab out.  Returns (host slab, copy event)."""
        ports = self._effective_read_ports()
        words = packing.words_from_np(packed)
        cuda = self.device.type == "cuda"
        pinned = cuda and slot is not None and slot.pinned
        if pinned:
            words = slot.tensor[: words.numel()].view(words.shape)
        g = None
        if cuda:
            captures0 = plan.captures
            g = plan.graph(bucket, self._graph_key(ports))
            self._graph_counts["captures"] += plan.captures - captures0
        if g is not None:
            slab = g.replay(words)
            self._graph_counts["replays"] += 1
        else:
            # a pinned slot copies asynchronously; a pageable array (the
            # synchronous drain) synchronously
            x = words.to(self.device, non_blocking=pinned)
            slab = self._epilogue(ports, temporal)(plan(x))
        if pinned:
            slot.event = torch.cuda.Event()
            slot.event.record()
        if not cuda:
            return slab, None
        # the one copy out: the graph overwrites its outputs at the next
        # replay, and the flush reads pinned host memory after this event
        host = torch.empty(slab.shape, dtype=slab.dtype, pin_memory=True)
        host.copy_(slab, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def _launch_static(self, reqs: list[SpikeRequest], bucket: int,
                       packed: np.ndarray, pack_s: float,
                       slot: Optional[_HostSlot] = None) -> None:
        """Device half of a static round; the results stay in flight (no
        host sync here)."""
        if self._tracer is not None:
            self._obs_queue_spans(reqs, bucket)
        trace_t1 = self._tracer.now_us() if self._tracer is not None else 0.0
        t1 = time.perf_counter()
        host, done = self._run_round(self._plan, bucket, packed, slot, False)
        t2 = time.perf_counter()
        if self._tracer is not None:
            self._trace_dispatch(trace_t1, "static", bucket, len(reqs))
        self._note_round("static", bucket, len(reqs), pack_s, t2 - t1,
                         self._n_legacy(len(reqs)))
        self._served += len(reqs)
        self._inflight.append((reqs, host, done))

    def _trace_dispatch(self, trace_t1: float, kind: str, bucket: int,
                        n_real: int, **steps) -> None:
        """A round's ``dispatch`` span from ``trace_t1``, after the ``fuse``
        instant of a round that coalesced legacy rounds."""
        n_legacy = self._n_legacy(n_real)
        if n_legacy > 1:
            self._tracer.instant("fuse", cat="round", bucket=bucket,
                                 rounds_coalesced=n_legacy)
        self._tracer.complete(
            "dispatch", trace_t1, self._tracer.now_us() - trace_t1,
            cat="round", kind=kind, bucket=bucket, **steps, n_real=n_real,
            dp=1)

    def _dispatch(self, reqs: list[SpikeRequest]) -> None:
        """One round (synchronous drain): pad to the bucket, pack, launch."""
        bucket = self._bucket(len(reqs))
        packed, pack_s = self._pack_static(reqs, bucket)
        self._launch_static(reqs, bucket, packed, pack_s)

    def _event_plan(self, n_steps: int):
        """The temporal plan for streams of ``n_steps`` (cached per spec on
        the network)."""
        cfg = dataclasses.replace(self._temporal, n_steps=n_steps)
        return self.net.plan(mode="temporal", temporal=cfg,
                             telemetry=self.telemetry, faults=self.faults)

    def _pack_events(self, events: list[np.ndarray], n_steps: int,
                     bucket: int, out: Optional[np.ndarray] = None
                     ) -> tuple[np.ndarray, float]:
        """Host half of an event round: uint32 wire words
        ``[n_steps, bucket, W]``, zero (silent) past the real streams (numpy
        only: safe on the packer thread), into ``out`` when given."""
        width = packing.packed_width(self.n_in)
        trace_t0 = self._tracer.now_us() if self._tracer is not None else 0.0
        t0 = time.perf_counter()
        if out is None:
            packed = np.zeros((n_steps, bucket, width), np.uint32)
        else:
            packed = out
            packed[...] = 0
        for i, ev in enumerate(events):
            if ev.shape[0] < n_steps:
                raise ValueError(f"stream {i} holds {ev.shape[0]} steps, "
                                 f"the round serves {n_steps}")
            if ev.dtype == np.uint32 and ev.shape[-1] == width:
                packed[:, i] = ev[:n_steps]
            elif ev.shape[1:] == (self.n_in,):
                packed[:, i] = packing.pack_spikes_np(ev[:n_steps] != 0)
            else:
                raise ValueError(f"stream {i} has shape {ev.shape}, want "
                                 f"[T, {self.n_in}] spikes or uint32 "
                                 f"[T, {width}] words")
        pack_s = time.perf_counter() - t0
        if self._tracer is not None:
            self._tracer.complete(
                "pack", trace_t0, self._tracer.now_us() - trace_t0,
                cat="round", kind="event", bucket=bucket, t=n_steps,
                n_real=len(events))
        return packed, pack_s

    def _launch_events(self, reqs: list[EventRequest], bucket: int,
                       n_steps: int, packed: np.ndarray, pack_s: float,
                       slot: Optional[_HostSlot] = None) -> None:
        """Device half of an event round; results stay in flight."""
        if self._tracer is not None:
            self._obs_queue_spans(reqs, bucket)
        trace_t1 = self._tracer.now_us() if self._tracer is not None else 0.0
        t1 = time.perf_counter()
        host, done = self._run_round(self._event_plan(n_steps), bucket,
                                     packed, slot, True)
        t2 = time.perf_counter()
        if self._tracer is not None:
            self._trace_dispatch(trace_t1, "event", bucket, len(reqs),
                                 t=n_steps)
        self._note_round("event", bucket, len(reqs), pack_s, t2 - t1,
                         self._n_legacy(len(reqs)))
        self._served_events += len(reqs)
        self._served_timesteps += len(reqs) * n_steps
        if self._m is not None:
            self._m["timesteps"].inc(len(reqs) * n_steps)
        self._inflight.append((reqs, host, done))

    def _dispatch_events(self, reqs: list[EventRequest], n_steps: int) -> None:
        """One event round (synchronous drain): same-T streams padded to a
        bucket, packed, launched.  ``n_steps`` is the effective T (a
        degraded ladder level truncates longer streams to it)."""
        bucket = self._bucket(len(reqs))
        for r in reqs:
            r.served_steps = n_steps
        packed, pack_s = self._pack_events(
            [np.asarray(r.events) for r in reqs], n_steps, bucket)
        self._launch_events(reqs, bucket, n_steps, packed, pack_s)

    def _flush(self) -> None:
        """Attach logits/labels (+ per-request cost) and fold the telemetry
        totals: each round's slab is read once, after its copy out ended.
        Totals accumulate in float64, masking each bucket's padded rows."""
        for reqs, host, done in self._inflight:
            n = len(reqs)
            is_event = bool(reqs) and isinstance(reqs[0], EventRequest)
            kind = "event" if is_event else "static"
            trace_t0 = (self._tracer.now_us() if self._tracer is not None
                        else 0.0)
            # the wait on the round's copy out (where the reference's
            # np.asarray waits on the device)
            if done is not None:
                done.synchronize()
            slab = host.numpy()
            if self._tracer is not None:
                self._tracer.complete(
                    "device_drain", trace_t0,
                    self._tracer.now_us() - trace_t0, cat="flush",
                    kind=kind, n_real=n)
                trace_t0 = self._tracer.now_us()
            self._attach(reqs, slab, is_event)
            if self._tracer is not None:
                self._tracer.complete(
                    "telemetry_flush", trace_t0,
                    self._tracer.now_us() - trace_t0, cat="flush",
                    kind=kind, n_real=n, telemetry=self.telemetry)
            if self._obs is not None:
                for r in reqs:
                    self._obs_close(r, "done", label=r.label)
        self._inflight.clear()
        if self._m is not None and self.telemetry and self._served:
            self._m["health"].set(self.health())

    def _attach(self, reqs: list, slab: np.ndarray, is_event: bool) -> None:
        """One round's slab onto its requests, and into the float64 totals
        (and the cycles and energy counters, by exactly the sums folded)."""
        n = len(reqs)
        n_tiles = len(self.net.topology) - 1
        cols = tele.stats_columns(n_tiles, self.net.topology[-1], is_event)
        # one copy a round that the requests' logits view: the slab's
        # pinned buffer goes back to its pool
        logits = slab[:n, cols["logits"]].copy()
        for r, row, label in zip(reqs, logits,
                                 logits.argmax(axis=1).tolist()):
            r.logits = row
            r.label = label
            r.status = "done"
        if not self.telemetry:
            return
        cycles = slab[:, cols["cycles"].start]
        latency = slab[:, cols["latency_ns"].start]
        energy = slab[:, cols["energy_pj"].start]
        for r, c, lat, e in zip(reqs, cycles[:n].astype(np.int64).tolist(),
                                latency[:n].tolist(), energy[:n].tolist()):
            r.cycles, r.latency_ns, r.energy_pj = c, lat, e
        if is_event:
            per_step = slab[:n, cols["energy_pj_per_step"].start].tolist()
            for r, e in zip(reqs, per_step):
                r.energy_pj_per_step = e
            tot = self._event_totals
        else:
            tot = self._totals
            # per-tile stage totals feed the pipelined-throughput model
            tot["cycles_per_tile"] += slab[
                :n, cols["cycles_per_tile"]].astype(np.float64).sum(axis=0)
        cycles_sum = float(cycles[:n].sum(dtype=np.float64))
        energy_sum = float(energy[:n].sum(dtype=np.float64))
        tot["cycles"] += cycles_sum
        tot["latency_ns"] += float(latency[:n].sum(dtype=np.float64))
        tot["energy_pj"] += energy_sum
        if self._m is not None:
            self._m["cycles"].inc(cycles_sum)
            self._m["energy"].inc(energy_sum)

    # -------------------------------------------------------------- #
    # tile health from the telemetry totals
    # -------------------------------------------------------------- #
    def tile_health(self) -> np.ndarray:
        """Per-tile health in [0, 1]: ``1 - |measured - expected| /
        expected`` of each tile's mean drain cycles against the reference
        activity calibration, clipped.  Tiles with no traffic yet (or
        telemetry off) score 1.0."""
        n_tiles = len(self.net.topology) - 1
        if not self.telemetry or self._served == 0:
            return np.ones((n_tiles,))
        measured = self._totals["cycles_per_tile"] / self._served
        dev = np.abs(measured - self._expected_tile_cycles) / np.maximum(
            self._expected_tile_cycles, 1e-9)
        return np.clip(1.0 - dev, 0.0, 1.0)

    def health(self) -> float:
        """Engine health: the weakest tile's score (pipeline bottleneck)."""
        return float(self.tile_health().min())

    def replan_degraded(self, n_devices: int) -> ft.ReplanResult:
        """Degraded-mesh operation: flush what is in flight, pick the mesh
        ``elastic_replan`` gives ``n_devices`` surviving devices (model
        parallel 1), and rebuild the bucket ladder and the serving plan with
        the same fault model.  Telemetry totals survive.

        The port serves on one device: a data axis above 1 needs sharded
        plans, which are not ported (ROADMAP, multi-device), and raises
        ``NotImplementedError`` rather than serving on one device."""
        self._flush()
        if self._tracer is not None:
            self._tracer.instant("replan_degraded", cat="engine",
                                 n_devices=int(n_devices))
        plan = ft.elastic_replan(max(1, int(n_devices)), model_parallel=1)
        (data, _), _ = plan
        if data > 1:
            raise NotImplementedError(
                f"a data axis of {data} needs sharded serving plans, which "
                "are not ported (ROADMAP: multi-device)")
        self._fuse = self._fuse_factor(data)
        self._buckets = _bucket_sizes(
            self.max_batch * self._fuse, self._min_bucket, data)
        self._plan = self.net.plan(mode="packed", telemetry=self.telemetry,
                                   faults=self.faults)
        return plan

    # -------------------------------------------------------------- #
    # aggregate telemetry
    # -------------------------------------------------------------- #
    def _pad_fraction_per_bucket(self) -> dict[int, float]:
        out = {}
        for b in sorted(set(self._padded_rows_per_bucket)
                        | set(self._real_rows_per_bucket)):
            pad = self._padded_rows_per_bucket.get(b, 0)
            real = self._real_rows_per_bucket.get(b, 0)
            out[b] = pad / (pad + real) if (pad + real) else 0.0
        return out

    def stats(self) -> dict:
        """Aggregate telemetry in the reference's schema (all seven
        sections, the same keys and meanings).  Safe to call at any time; a
        pure host read."""
        spec = cm.cell_spec(self.read_ports)
        n = self._served
        ne, nt = self._served_events, self._served_timesteps
        et = self._event_totals
        c = self._round_counters
        health = self.health()
        base = {
            "stats_schema_version": STATS_SCHEMA_VERSION,
            "requests": n,          # legacy key
            "n_requests": n,
            "telemetry": self.telemetry,
            "cell": spec.name,
            "read_ports": self.read_ports,
            "data_parallel": 1,
            "faulted": self.faults is not None,
            "tile_health": [float(h) for h in self.tile_health()],
            "health": health,
            "degraded": health < self.health_threshold,
            "dispatch_rounds": self._rounds,
            "straggler_rounds": len(self._watchdog.flagged),
            "queue_depth": self.queue_depth(),
            "queue_limit": self._queue_limit,
            "high_water": self._high_water,
            "shed_deadline": self._shed_deadline,
            "rejected_full": self._rejected_full,
            "backpressure_events": self._backpressure_events,
            "degradation_level": self._ladder_level,
            "degradation_level_name": self._level().name,
            "ladder_transitions": len(self._transitions),
            "ladder_transition_log": list(self._transitions),
            "rounds_static": c["rounds_static"],
            "rounds_event": c["rounds_event"],
            "rows_real_total": c["rows_real"],
            "rows_padded_total": c["rows_padded"],
            "pad_fraction": (
                c["rows_padded"] / max(1, c["rows_real"] + c["rows_padded"])),
            "rounds_per_bucket": dict(self._rounds_per_bucket),
            "padded_rows_per_bucket": dict(self._padded_rows_per_bucket),
            "real_rows_per_bucket": dict(self._real_rows_per_bucket),
            "pad_fraction_per_bucket": self._pad_fraction_per_bucket(),
            "host_pack_s_total": c["host_pack_s"],
            "dispatch_s_total": c["dispatch_s"],
            "fuse_rounds": self._fuse,
            "overlap": self._overlap,
            "fused_rounds": c["fused_rounds"],
            "rounds_saved": c["rounds_saved"],
            "n_event_requests": ne,
            "timesteps_total": nt,
            "event_energy_pj_mean": et["energy_pj"] / ne if ne else 0.0,
            "event_latency_ns_mean": et["latency_ns"] / ne if ne else 0.0,
            "event_cycles_mean": et["cycles"] / ne if ne else 0.0,
            "energy_pj_per_timestep": et["energy_pj"] / nt if nt else 0.0,
        }
        if n == 0:
            return {**base, "cycles_mean": 0.0, "latency_ns_mean": 0.0,
                    "energy_pj_per_inf": 0.0, "throughput_inf_s": 0.0,
                    "throughput_pipelined_inf_s": 0.0}
        mean_latency_ns = self._totals["latency_ns"] / n
        # pipelined rate: tiles overlap consecutive samples, so the slowest
        # mean tile stage sets the cadence
        bottleneck_cycles = float(np.max(self._totals["cycles_per_tile"])) / n
        return {
            **base,
            "cycles_mean": self._totals["cycles"] / n,
            "latency_ns_mean": mean_latency_ns,
            "energy_pj_per_inf": self._totals["energy_pj"] / n,
            # un-pipelined modeled rate implied by the mean latency
            "throughput_inf_s":
                1e9 / mean_latency_ns if mean_latency_ns else 0.0,
            "throughput_pipelined_inf_s":
                1e9 / (bottleneck_cycles * spec.clock_ns)
                if bottleneck_cycles else 0.0,
        }


# ------------------------------------------------------------------ #
# fault-aware routing across SpikeEngine replicas
# ------------------------------------------------------------------ #
class AllReplicasDownError(RuntimeError):
    """Every replica has crashed: nothing can serve."""


class AllReplicasDegradedError(RuntimeError):
    """Every live replica is below the health threshold and the router was
    built with ``on_all_degraded="raise"``."""


class FaultAwareRouter:
    """Drains spike traffic around degraded, stalled and crashed replicas.

    Holds N ``SpikeEngine`` replicas (on one card here, each possibly with
    its own ``FaultModel``) and routes every request by tile health:
    round-robin across the replicas whose weakest tile scores at least
    ``health_threshold``.  When every live replica is degraded the router
    raises (``on_all_degraded="raise"``) or falls back to the healthiest one,
    and counts each fallback in ``stats()["degraded_route"]``.  Health comes
    from each engine's telemetry: the router does no device work.

    ``retry`` (a ``RetryPolicy``): a replica whose drain raises is taken out
    of rotation and every request it held but did not complete is re-routed
    to a survivor after exponential backoff with counter-based jitter.  A
    drain past ``retry.attempt_timeout_s`` counts a timeout and marks the
    replica slow: round-robin prefers the others from then on.  A request
    whose retry budget runs out gets ``status="failed"``, never lost.

    ``observability`` (an ``Observability``): every counter is mirrored
    into ``esam_router_<name>_total``, the replicas down and slow into
    gauges, and each replica drain, crash, re-route, slow mark and
    degraded route is traced.
    """

    def __init__(self, engines, *, health_threshold: float = 0.75,
                 retry: Optional[ft.RetryPolicy] = None,
                 on_all_degraded: str = "fallback",
                 observability: Optional[Observability] = None,
                 sleep=time.sleep, clock=time.monotonic):
        if not engines:
            raise ValueError("router needs at least one engine")
        if on_all_degraded not in ("fallback", "raise"):
            raise ValueError(f"on_all_degraded must be 'fallback' or "
                             f"'raise', got {on_all_degraded!r}")
        self.engines = list(engines)
        self.health_threshold = health_threshold
        self.retry = retry or ft.RetryPolicy()
        self.on_all_degraded = on_all_degraded
        self.routed = [0] * len(self.engines)
        self.counters = {"retries": 0, "crashes": 0, "timeouts": 0,
                         "degraded_route": 0, "rejected_full": 0,
                         "failed": 0}
        self._rr = 0
        self._down: set[int] = set()
        self._slow: set[int] = set()
        self._assigned: list[list] = [[] for _ in self.engines]
        self._backoff_counter = 0
        self._sleep = sleep
        self._clock = clock
        self._tracer = observability.tracer if observability else None
        self._metrics = observability.metrics if observability else None

    def _count(self, name: str, n: int = 1) -> None:
        """Bump a router counter, mirrored into ``esam_router_*_total``."""
        self.counters[name] += n
        if self._metrics is not None:
            self._metrics.counter(
                f"esam_router_{name}_total",
                "fault-aware router event counter").inc(n)

    def _health_gauges(self) -> None:
        if self._metrics is not None:
            self._metrics.gauge(
                "esam_router_replicas_down",
                "replicas out of rotation (crashed)").set(len(self._down))
            self._metrics.gauge(
                "esam_router_replicas_slow",
                "replicas flagged slow (drain timeout)").set(len(self._slow))

    def backlog(self) -> int:
        """Routed requests not yet completed on a live replica."""
        return sum(len(self._assigned[i]) for i in range(len(self.engines))
                   if i not in self._down)

    def route(self, request, *, exclude=()) -> Optional[int]:
        """Queue one request on the chosen replica; returns its index, or
        ``None`` when every candidate's bounded queue rejected it (the
        request's status is then ``"rejected"``, counted in
        ``stats()["rejected_full"]``)."""
        avoid = set(exclude) | self._down
        candidates = [i for i in range(len(self.engines)) if i not in avoid]
        if not candidates:
            raise AllReplicasDownError(
                f"all {len(self.engines)} replicas are down")
        scores = {i: self.engines[i].health() for i in candidates}
        healthy = [i for i in candidates
                   if scores[i] >= self.health_threshold]
        fast = [i for i in healthy if i not in self._slow]
        pool = fast or healthy
        if pool:
            idx = pool[self._rr % len(pool)]
            self._rr += 1
            order = [idx] + [i for i in pool if i != idx] + sorted(
                (i for i in candidates if i not in pool),
                key=lambda i: -scores[i])
        else:
            # every live candidate is degraded: count it, and raise if so
            # configured
            self._count("degraded_route")
            if self._tracer is not None:
                self._tracer.instant("degraded_route", cat="router",
                                     scores={i: float(s)
                                             for i, s in scores.items()})
            if self.on_all_degraded == "raise":
                raise AllReplicasDegradedError(
                    f"all live replicas below health threshold "
                    f"{self.health_threshold} (scores: {scores})")
            order = sorted(candidates, key=lambda i: -scores[i])
        for idx in order:
            verdict = self.engines[idx].submit(request)
            if verdict is None or verdict.admitted:
                request.status = "pending"   # clear any earlier rejection
                if pool and idx not in pool:
                    # the healthy queues were full and the request spilled
                    # onto a degraded replica
                    self._count("degraded_route")
                self._assigned[idx].append(request)
                self.routed[idx] += 1
                return idx
        self._count("rejected_full")
        return None

    def serve(self, requests=None) -> list:
        """Route ``requests`` (optional), then drain every live replica,
        re-routing work off any replica that crashes or stalls."""
        if requests is not None:
            if isinstance(requests, (SpikeRequest, EventRequest)):
                requests = [requests]
            for r in requests:
                self.route(r)
        self._drain()
        return requests if requests is not None else []

    def _drain(self) -> None:
        """Drain passes until every routed request is terminal.  A crash
        re-routes its victims, possibly onto a replica already drained this
        pass, hence the outer loop; each pass completes requests or downs a
        replica."""
        max_passes = 2 * len(self.engines) + 2
        for _ in range(max_passes):
            for idx, eng in enumerate(self.engines):
                if idx in self._down:
                    continue
                if not (self._assigned[idx] or eng.queue_depth()):
                    continue
                trace_t0 = (self._tracer.now_us()
                            if self._tracer is not None else 0.0)
                t0 = self._clock()
                try:
                    eng.serve()
                except Exception:
                    self._on_crash(idx)
                    continue
                dt = self._clock() - t0
                if self._tracer is not None:
                    self._tracer.complete(
                        "replica_drain", trace_t0,
                        self._tracer.now_us() - trace_t0, cat="router",
                        replica=idx, drain_s=dt)
                to = self.retry.attempt_timeout_s
                if to is not None and dt > to:
                    self._count("timeouts")
                    self._slow.add(idx)
                    if self._tracer is not None:
                        self._tracer.instant("replica_slow", cat="router",
                                             replica=idx, drain_s=dt,
                                             timeout_s=to)
                    self._health_gauges()
                self._assigned[idx] = [
                    r for r in self._assigned[idx]
                    if r.logits is None and r.status == "pending"]
            if self.backlog() == 0:
                return

    def _on_crash(self, idx: int) -> None:
        """A crashed replica leaves the rotation; its incomplete requests
        are re-routed with backoff.  Requests it completed keep their
        results: each request's result attaches on exactly one replica."""
        self._count("crashes")
        self._down.add(idx)
        self._health_gauges()
        victims = [r for r in self._assigned[idx]
                   if r.logits is None and r.status == "pending"]
        if self._tracer is not None:
            self._tracer.instant("replica_crash", cat="router", replica=idx,
                                 victims=len(victims))
        self._assigned[idx] = []
        # empty the dead replica's queues: its pending requests are the
        # victims being re-routed (exactly once depends on this)
        eng = self.engines[idx]
        eng._pending.clear()
        eng._pending_events.clear()
        eng._inflight.clear()
        eng._obs_abandon(victims)
        for r in victims:
            r.attempts += 1
            if r.attempts >= self.retry.max_attempts:
                r.status = "failed"
                self._count("failed")
                continue
            self._backoff_counter += 1
            self._sleep(self.retry.backoff_s(r.attempts,
                                             self._backoff_counter))
            try:
                dest = self.route(r, exclude={idx})
            except AllReplicasDownError:
                r.status = "failed"
                self._count("failed")
                continue
            if dest is not None:
                self._count("retries")
                if self._tracer is not None:
                    self._tracer.instant("reroute", cat="router",
                                         from_replica=idx, to_replica=dest,
                                         attempt=r.attempts)

    def stats(self) -> dict:
        per_engine = [
            {"health": h, "degraded": h < self.health_threshold,
             "down": i in self._down, "slow": i in self._slow,
             "routed": n, "n_requests": e.stats()["n_requests"]}
            for i, (e, n, h) in enumerate(zip(
                self.engines, self.routed,
                (e.health() for e in self.engines)))
        ]
        return {
            "n_engines": len(self.engines),
            "health_threshold": self.health_threshold,
            "routed": list(self.routed),
            "engines": per_engine,
            "down": sorted(self._down),
            "slow": sorted(self._slow),
            "backlog": self.backlog(),
            **self.counters,
        }
