"""Device profiling and timing lanes: ``DeviceProfiler``, ``kernel_timer``,
``record_warmup_times`` and CUDA-event timers.

* :class:`DeviceProfiler` -- the reference's capture window around serving
  drain rounds (skip the first ``skip_rounds``, capture ``n_rounds``): the
  engine calls ``on_round_start``/``on_round_end`` a dispatch round; the
  capture starts and stops exactly once, never raises into the drain (a
  failed capture is recorded in ``error``), and books the rounds captured
  into ``esam_profile_rounds_captured``.  Its backend is any object with
  ``start_trace(logdir)`` and ``stop_trace()`` (and optionally ``prepare()``
  and ``arm(logdir)``); the default is :class:`TorchProfiler`,
  ``torch.profiler`` writing a Chrome trace into the logdir.
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
import itertools
import os
import statistics
import time
from typing import Optional

from repro_torch.obs.metrics import Registry


class TorchProfiler:
    """``start_trace(logdir)`` / ``stop_trace()`` over
    ``torch.profiler.profile``: CPU activity, and CUDA activity when a card
    is present.  A session opens with one warm-up step of the profiler's
    schedule, collected and dropped: on the card the first launches of a
    session's kernels can go unrecorded (seen: the first round's cascade
    kernel), so ``arm`` opens the session a round early and that round is
    the warm-up; ``start_trace`` then starts recording.  Without ``arm``,
    ``start_trace`` opens the session itself, its warm-up one small kernel.
    ``stop_trace`` waits for the card first (the engine ends a window right
    after an asynchronous dispatch, whose kernels would otherwise fall
    outside the capture, as ``jax.profiler.stop_trace`` waits too), then
    writes the Chrome trace to ``trace_path`` in the logdir; ``profile``
    keeps the finished ``torch.profiler.profile``.  ``prepare`` runs one
    empty capture: the process's first start sets the profiler library up
    (1.7 s on a CPU host), which would otherwise stall the first captured
    round."""

    _serial = itertools.count()

    def __init__(self):
        self.trace_path: Optional[str] = None
        self.profile = None
        self._running = None
        self._armed = False
        self._logdir: Optional[str] = None

    @staticmethod
    def _profile(schedule=None):
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        return profile(activities=activities, schedule=schedule)

    def prepare(self) -> None:
        if self._running is not None:
            raise RuntimeError("a trace is already running")
        prof = self._profile()
        prof.start()
        prof.stop()

    def arm(self, logdir: str) -> None:
        """Open the session in its warm-up step (collected, dropped)."""
        from torch.profiler import schedule

        if self._running is not None:
            raise RuntimeError("a trace is already running")
        os.makedirs(logdir, exist_ok=True)
        prof = self._profile(schedule(wait=0, warmup=1, active=1, repeat=1))
        prof.start()
        self._running, self._logdir, self._armed = prof, logdir, True

    def start_trace(self, logdir: str) -> None:
        import torch

        if not self._armed:
            self.arm(logdir)
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.ones(1, device="cuda").add_(1)
                torch.cuda.synchronize()
        self._armed = False
        self._running.step()               # recorded from here to the stop

    def stop_trace(self) -> None:
        import torch

        prof, self._running = self._running, None
        self._armed = False
        if prof is None:
            raise RuntimeError("no trace is running")
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        path = os.path.join(self._logdir, f"esam_trace_{os.getpid()}_"
                                          f"{next(self._serial)}.json")
        prof.export_chrome_trace(path)
        self.profile, self.trace_path = prof, path


class DeviceProfiler:
    """Capture a device trace around N serving drain rounds."""

    def __init__(self, logdir: str, *, skip_rounds: int = 0,
                 n_rounds: int = 1, registry: Optional[Registry] = None,
                 profiler=None):
        if n_rounds < 1:
            raise ValueError(f"n_rounds must be >= 1, got {n_rounds}")
        self.logdir = logdir
        self.skip_rounds = int(skip_rounds)
        self.n_rounds = int(n_rounds)
        self.registry = registry
        self._profiler = profiler      # injectable; None => TorchProfiler
        self.active = False
        self.done = False
        self.captured = 0
        self.error: Optional[str] = None
        self._seen = 0
        self._armed = False

    def _backend(self):
        if self._profiler is None:
            self._profiler = TorchProfiler()
        return self._profiler

    def prepare(self) -> None:
        """Set the backend up before the first round (its ``prepare``, where
        it has one), so the capture's start does not stall the drain; a
        failure is recorded in ``error`` and ends the profiler."""
        prepare = getattr(self._backend(), "prepare", None)
        if prepare is None or self.done:
            return
        try:
            prepare()
        except Exception as e:  # noqa: BLE001 -- profiling never kills serving
            self.error = f"{type(e).__name__}: {e}"
            self.done = True

    def on_round_start(self, round_idx: int) -> None:
        """Called by the engine before each dispatch round."""
        if self.done or self.active:
            return
        if self._seen < self.skip_rounds:
            self._seen += 1
            if self._seen == self.skip_rounds:
                self._arm()        # the last skipped round is the warm-up
            return
        try:
            self._backend().start_trace(self.logdir)
            self.active, self._armed = True, False
        except Exception as e:  # noqa: BLE001 -- profiling never kills serving
            self.error = f"{type(e).__name__}: {e}"
            self.done = True

    def _arm(self) -> None:
        arm = getattr(self._backend(), "arm", None)
        if arm is None:
            return
        try:
            arm(self.logdir)
            self._armed = True
        except Exception as e:  # noqa: BLE001 -- profiling never kills serving
            self.error = f"{type(e).__name__}: {e}"
            self.done = True

    def on_round_end(self, round_idx: int) -> None:
        """Called by the engine after each dispatch round."""
        if not self.active:
            return
        self.captured += 1
        if self.captured >= self.n_rounds:
            self.stop()

    def stop(self) -> None:
        """Stop a capture in flight (idempotent; also the abort path, which
        closes an armed session that never started recording)."""
        if self.active or self._armed:
            try:
                self._backend().stop_trace()
            except Exception as e:  # noqa: BLE001
                self.error = f"{type(e).__name__}: {e}"
            self.active = self._armed = False
        self.done = True
        if self.registry is not None:
            self.registry.gauge(
                "esam_profile_rounds_captured",
                "drain rounds inside the device profiler's capture window",
            ).set(self.captured)


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
