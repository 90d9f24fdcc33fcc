"""Observability plane of the port: tracing, metrics and device profiling.

The serving stack (``SpikeEngine``, ``FaultAwareRouter``, the traffic
harness, the online-learning driver) takes one optional
:class:`Observability` handle and, when given, emits:

  * request-lifecycle and round-phase spans into a
    :class:`~repro_torch.obs.trace.Tracer` (exportable as Perfetto
    ``trace_event`` JSON),
  * counters, gauges and latency histograms into a
    :class:`~repro_torch.obs.metrics.Registry` (scraped over HTTP by
    :class:`~repro_torch.obs.http.MetricsServer`, snapshotted into
    ``TrafficReport`` and ``--report-json``),
  * ``torch.profiler`` captures around drain rounds through a
    :class:`~repro_torch.obs.profile.DeviceProfiler`.

Everything defaults off (``observability=None``), and the off path is
property-tested bit-identical to the instrumented path: spans observe,
never perturb.  ``obs.metrics``, ``obs.trace`` and ``obs.http`` are copies
of the reference's stdlib-only modules; ``obs.profile`` also holds
``kernel_timer``, ``record_warmup_times`` and the CUDA-event timers that the
kernel bench and ``chip_smoke.py`` share.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

from repro_torch.obs.metrics import REGISTRY, Registry
from repro_torch.obs.profile import (DeviceProfiler, TorchProfiler,
                                     kernel_timer, record_warmup_times)
from repro_torch.obs.trace import Tracer

__all__ = ["Observability", "Registry", "REGISTRY", "Tracer",
           "DeviceProfiler", "TorchProfiler", "kernel_timer",
           "record_warmup_times"]


@dataclasses.dataclass
class Observability:
    """The bundle a serving component is instrumented with.

    Any field may be None: tracing, metrics and profiling are independent
    lanes; a component guards each emission on the lane being present.
    """

    tracer: Optional[Tracer] = None
    metrics: Optional[Registry] = None
    profile: Optional[DeviceProfiler] = None

    @classmethod
    def enabled(cls, *, clock=time.monotonic, capacity: int = 1 << 16,
                registry: Optional[Registry] = None,
                profile: Optional[DeviceProfiler] = None) -> "Observability":
        """Tracer and metrics on (the common case); profiling opt-in."""
        return cls(tracer=Tracer(clock=clock, capacity=capacity),
                   metrics=REGISTRY if registry is None else registry,
                   profile=profile)
