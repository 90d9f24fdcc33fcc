"""Timing lanes: ``kernel_timer``, ``record_warmup_times`` and CUDA-event
timers.

* :func:`kernel_timer` -- the reference's per-kernel timing lane
  (``repro.obs.profile.kernel_timer``): a context manager that observes one
  call's wall time into ``esam_kernel_seconds{kernel=...,lane=...}``.  The
  body must make the timed section synchronous (``torch.cuda.synchronize()``
  on the card, as the reference's body calls ``block_until_ready``).
* :func:`record_warmup_times` -- folds a ``warmup()`` result dict into
  per-shape ``esam_warmup_compile_seconds`` gauges, as the reference does.
* :func:`graph_ms` and :func:`call_ms` -- a call's device time (CUDA events
  around replays of a CUDA graph) and its time as an eager caller sees it
  (CUDA events around back-to-back calls, host work included).  The kernel
  bench and ``chip_smoke.py`` time every kernel with these two.
"""

from __future__ import annotations

import contextlib
import statistics
import time

from repro_torch.obs.metrics import Registry


def record_warmup_times(registry: Registry, times: dict,
                        prefix: str = "static") -> None:
    """Fold a ``warmup()`` result dict into per-shape compile-time gauges.

    ``{batch: seconds}`` and nested ``{"static": {batch: s}, "event_t4":
    {batch: s}, ..., "total_s": s}`` dicts are both taken; nesting is
    flattened into the ``shape`` label.
    """
    for key, val in times.items():
        if isinstance(val, dict):
            record_warmup_times(registry, val, prefix=str(key))
            continue
        shape = (f"{prefix}_b{key}" if isinstance(key, int)
                 else (str(key) if prefix == "static" else f"{prefix}_{key}"))
        registry.gauge(
            "esam_warmup_compile_seconds",
            "AOT warmup compile seconds per plan shape",
            shape=shape,
        ).set(float(val))


@contextlib.contextmanager
def kernel_timer(registry: Registry, kernel: str, *, lane: str = "default",
                 clock=time.perf_counter):
    """Time one kernel call into ``esam_kernel_seconds{kernel=,lane=}``.

    The caller makes the timed section synchronous
    (``torch.cuda.synchronize()`` inside the body): this lane measures wall
    time, like every bench in the repo.
    """
    hist = registry.histogram(
        "esam_kernel_seconds", "per-kernel wall time", kernel=kernel,
        lane=lane)
    t0 = clock()
    try:
        yield hist
    finally:
        hist.observe(clock() - t0)


def graph_ms(fn, calls: int = 20, replays: int = 7) -> float:
    """Device time of one ``fn()`` call: CUDA events around replays of a
    CUDA graph holding ``calls`` calls (host-side Python excluded); median
    over ``replays``.  Operands stay hot in L2, as in serving.  ``fn`` runs
    3 times on a side stream, then ``calls`` times under capture."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def call_ms(fn, calls: int = 50, replays: int = 7) -> float:
    """Time of one eager ``fn()`` call as a caller sees it (host-side
    wrapper work included): CUDA events around ``calls`` calls, median over
    ``replays``.  ``fn`` runs ``1 + calls * replays`` times."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)
