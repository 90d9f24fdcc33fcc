"""Observability plane of the port: the metrics registry and the kernel
timing lanes.

``obs.metrics`` is a copy of the reference's registry (counters, gauges,
log-bucketed histograms, Prometheus text); ``obs.profile`` holds
``kernel_timer`` and ``record_warmup_times`` as the reference has them, and
the CUDA-event timers that the kernel bench and ``chip_smoke.py`` share.
The reference's tracer, HTTP scrape server, ``DeviceProfiler`` and the
engine's wiring are not ported yet.
"""

from repro_torch.obs.metrics import REGISTRY, Registry
from repro_torch.obs.profile import kernel_timer, record_warmup_times

__all__ = ["Registry", "REGISTRY", "kernel_timer", "record_warmup_times"]
