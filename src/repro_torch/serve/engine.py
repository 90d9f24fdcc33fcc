"""ESAM spike-classification serving: the static path of ``SpikeEngine``.

Requests are bit-packed on the host into the wire format (32 spikes per
word, the paper's parallel-pulse inter-tile bus), padded to a power-of-two
bucket, and run through ONE packed ``EsamPlan`` per round — on the card, the
whole tile cascade is one CUDA launch.  With ``telemetry=True`` the plan also
returns each tile's arbiter loads and the paper-unit hardware cost is
computed on the device (``cost_model.request_stats_device``); logits and
telemetry stay on the device until one flush per drain attaches them to the
requests and folds exact float64 totals, so ``stats()`` is a pure host read.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import packing
from repro_torch.core.esam import cost_model as cm
from repro_torch.kernels.common import resolve_device


@dataclasses.dataclass
class SpikeRequest:
    spikes: np.ndarray                     # {0,1}[n_in] (any dtype)
    # lifecycle: "pending" -> "done"
    status: str = "pending"
    # filled by the engine:
    logits: Optional[np.ndarray] = None    # float32[n_classes]
    label: Optional[int] = None            # argmax readout
    # filled when the engine runs with telemetry (paper-unit hardware cost):
    cycles: Optional[int] = None           # CIM clock cycles, summed over tiles
    latency_ns: Optional[float] = None     # cycles * cell clock period
    energy_pj: Optional[float] = None      # per-inference energy (pJ/inf)


@dataclasses.dataclass(frozen=True)
class AdmissionVerdict:
    """Outcome of one ``SpikeEngine.submit`` admission decision.

    The engine's queue is unbounded, as the reference's is by default, so
    every request is admitted.
    """

    admitted: bool
    backpressure: bool = False
    reason: str = "ok"                # "ok" | "queue_full"
    queue_depth: int = 0              # depth after this decision


# ------------------------------------------------------------------ #
# stats(): the reference's versioned schema, for the sections ported so far
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
    """The schema of ``SpikeEngine.stats()``: section -> key -> type name.

    ``stats()`` returns exactly the union of these keys.
    """
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


class SpikeEngine:
    """Continuously batched ESAM serving over one packed plan, on one device.

    Requests enter an admission queue (``submit``; ``serve`` is submit +
    drain) and are dispatched in rounds of up to ``max_batch`` requests, each
    zero-padded up to the next power-of-two bucket (silent pad rows are exact
    for the binary CIM MAC).  ``device`` defaults to ``"cuda"`` and must be
    the network's device.
    """

    def __init__(self, net, *, max_batch: int = 128, min_bucket: int = 8,
                 telemetry: bool = False, read_ports: int = 4,
                 device="cuda"):
        dev = resolve_device(device)
        if net.device != dev:
            raise ValueError(f"network lives on {net.device}, engine asked "
                             f"for {dev}")
        self.net = net
        self.device = dev
        self.max_batch = max_batch
        self.n_in = net.topology[0]
        self.telemetry = telemetry
        self.read_ports = read_ports
        self._buckets = _bucket_sizes(max_batch, min_bucket, 1)
        self._plan = net.plan(mode="packed", telemetry=telemetry)
        # admission queue + per-round device results awaiting one host flush
        self._pending: list[SpikeRequest] = []
        self._inflight: list[tuple[list, torch.Tensor, Optional[dict]]] = []
        self._round_counters = {
            "rounds_static": 0, "rows_real": 0, "rows_padded": 0,
            "host_pack_s": 0.0, "dispatch_s": 0.0,
        }
        self._rounds_per_bucket: dict[int, int] = {}
        self._padded_rows_per_bucket: dict[int, int] = {}
        self._real_rows_per_bucket: dict[int, int] = {}
        # exact float64 telemetry totals, folded in at each drain flush
        self._served = 0
        self._totals = {
            "cycles": 0.0,
            "cycles_per_tile": np.zeros((len(net.topology) - 1,), np.float64),
            "latency_ns": 0.0,
            "energy_pj": 0.0,
        }

    # -------------------------------------------------------------- #
    # admission + dispatch
    # -------------------------------------------------------------- #
    def queue_depth(self) -> int:
        """Requests currently admitted and awaiting dispatch."""
        return len(self._pending)

    def submit(self, requests):
        """Queue requests without dispatching (single request or list).

        Returns an :class:`AdmissionVerdict` per request (a single verdict
        for a single request).
        """
        single = isinstance(requests, SpikeRequest)
        if single:
            requests = [requests]
        verdicts = []
        for r in requests:
            self._pending.append(r)
            verdicts.append(AdmissionVerdict(
                admitted=True, queue_depth=self.queue_depth()))
        return verdicts[0] if single else verdicts

    def serve(self, requests=None) -> list:
        """Enqueue ``requests`` (optional), drain the queue, flush results.

        Returns the list of requests served in this call (the passed-in list
        when given, else everything that was pending)."""
        if requests is not None:
            self.submit(requests)
            out = requests if isinstance(requests, list) else [requests]
        else:
            out = list(self._pending)
        while self._pending:
            self._dispatch(self._pop_static_round())
        self._flush()
        return out

    def _pop_static_round(self) -> list[SpikeRequest]:
        reqs = self._pending[: self.max_batch]
        del self._pending[: self.max_batch]
        return reqs

    def _bucket(self, n: int) -> int:
        for b in self._buckets:
            if n <= b:
                return b
        return self._buckets[-1]

    def _note_round(self, bucket: int, n_real: int, pack_s: float,
                    dispatch_s: float) -> None:
        c = self._round_counters
        c["rounds_static"] += 1
        c["rows_real"] += n_real
        c["rows_padded"] += bucket - n_real
        c["host_pack_s"] += pack_s
        c["dispatch_s"] += dispatch_s
        self._rounds_per_bucket[bucket] = (
            self._rounds_per_bucket.get(bucket, 0) + 1)
        self._padded_rows_per_bucket[bucket] = (
            self._padded_rows_per_bucket.get(bucket, 0) + bucket - n_real)
        self._real_rows_per_bucket[bucket] = (
            self._real_rows_per_bucket.get(bucket, 0) + n_real)

    def _pack_static(self, reqs: list[SpikeRequest],
                     bucket: int) -> tuple[np.ndarray, float]:
        """Host half of a round: bit-pack to the padded wire format."""
        t0 = time.perf_counter()
        packed = packing.pack_padded_rows_np(
            [r.spikes for r in reqs], bucket, self.n_in)
        return packed, time.perf_counter() - t0

    def _launch_static(self, reqs: list[SpikeRequest], bucket: int,
                       packed: np.ndarray, pack_s: float) -> None:
        """Device half: copy the words over and run the plan; every result
        stays on the device (no host sync here)."""
        t1 = time.perf_counter()
        res = self._plan(packing.words_from_np(packed).to(self.device))
        rs = None
        if self.telemetry:
            rs = cm.request_stats_device(
                self.net.topology, res.loads, self.read_ports)
        t2 = time.perf_counter()
        self._note_round(bucket, len(reqs), pack_s, t2 - t1)
        self._served += len(reqs)
        self._inflight.append((reqs, res.logits, rs))

    def _dispatch(self, reqs: list[SpikeRequest]) -> None:
        """One round: pad to the bucket, pack, launch."""
        bucket = self._bucket(len(reqs))
        packed, pack_s = self._pack_static(reqs, bucket)
        self._launch_static(reqs, bucket, packed, pack_s)

    def _flush(self) -> None:
        """Attach logits/labels (+ per-request cost) and fold the telemetry
        totals — the drain's only device-to-host transfers.  Totals
        accumulate in float64, masking each bucket's zero-padded rows."""
        for reqs, logits_t, rs in self._inflight:
            n = len(reqs)
            logits = logits_t.cpu().numpy()
            for i, r in enumerate(reqs):
                r.logits = logits[i]
                r.label = int(logits[i].argmax())
                r.status = "done"
            if rs is None:
                continue
            host = {k: v.cpu().numpy() for k, v in rs.items()}
            cycles, latency, energy = (
                host["cycles"], host["latency_ns"], host["energy_pj"])
            for i, r in enumerate(reqs):
                r.cycles = int(cycles[i])
                r.latency_ns = float(latency[i])
                r.energy_pj = float(energy[i])
            tot = self._totals
            # per-tile stage totals feed the pipelined-throughput model
            tot["cycles_per_tile"] += host["cycles_per_tile"].astype(
                np.float64)[:n].sum(axis=0)
            tot["cycles"] += float(cycles[:n].sum(dtype=np.float64))
            tot["latency_ns"] += float(latency[:n].sum(dtype=np.float64))
            tot["energy_pj"] += float(energy[:n].sum(dtype=np.float64))
        self._inflight.clear()

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
        """Aggregate telemetry: the reference's identity, rounds and cost
        keys with their meanings.  Safe to call at any time; a pure host
        read."""
        spec = cm.cell_spec(self.read_ports)
        n = self._served
        c = self._round_counters
        base = {
            "stats_schema_version": STATS_SCHEMA_VERSION,
            "requests": n,          # legacy key
            "n_requests": n,
            "telemetry": self.telemetry,
            "cell": spec.name,
            "read_ports": self.read_ports,
            "data_parallel": 1,
            "rounds_static": c["rounds_static"],
            "rounds_event": 0,
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
