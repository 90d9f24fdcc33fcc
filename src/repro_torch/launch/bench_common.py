"""Bench helpers of the port, the twin of the reference's
``benchmarks/common.py``: timing, ``name,us_per_call,derived`` rows and the
recorder every bench twin writes its rows (and, with ``--out``, its JSON)
through.

``time_call`` is the reference's median wall clock of ``repeats`` calls
after ``warmup`` calls; a ``torch.cuda.synchronize`` on the call's device
before each clock read takes the place of ``jax.block_until_ready``.
"""

from __future__ import annotations

import collections
import json
import time
from typing import Callable

import torch


def sync(device) -> None:
    """Wait for the work queued on ``device`` when it is a CUDA device
    (``None`` or the CPU: nothing to wait for)."""
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_call(fn: Callable, *args, device=None, repeats: int = 3,
              warmup: int = 1, **kwargs) -> tuple[float, object]:
    """Median wall time (µs) of ``fn(*args, **kwargs)`` over ``repeats``
    calls, after ``warmup`` untimed calls, and the last call's result.

    ``device`` is where the call runs: on a CUDA device the clock is read
    only after ``torch.cuda.synchronize`` on it, so a time covers the
    device work and not just its launch.  ``warmup=0`` times a first,
    cold call (a kernel library's load, a plan's operand build)."""
    for _ in range(warmup):
        fn(*args, **kwargs)
    sync(device)
    out, times = None, []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        sync(device)
        times.append((time.perf_counter() - t0) * 1e6)
    times.sort()
    return times[len(times) // 2], out


def emit(name: str, us_per_call: float, derived: str) -> None:
    print(f"{name},{us_per_call:.1f},{derived}", flush=True)


def fields(row: dict) -> dict:
    """A row's ``derived`` string as a dict (``k=v;...``)."""
    return dict(kv.split("=", 1) for kv in row["derived"].split(";")
                if "=" in kv)


class Recorder:
    """Collects emitted rows (``name,us,derived`` on stdout) for the JSON,
    and the kernel launches a bench expects its calls to make on the card
    (``launched``), which a caller holds against the wrappers' counters;
    ``outputs`` keeps what a bench computed, for callers that check it."""

    def __init__(self):
        self.rows: list[dict] = []
        self.launches: collections.Counter = collections.Counter()
        self.outputs: dict = {}

    def emit(self, name: str, us: float, derived: str) -> None:
        emit(name, us, derived)
        self.rows.append({"name": name, "us_per_call": us,
                          "derived": derived})

    def launched(self, device, launches: dict, calls: int = 1) -> None:
        """Book ``calls`` calls that each launch ``launches`` (kernel ->
        count) when ``device`` is the card; the CPU launches nothing."""
        if torch.device(device).type == "cuda":
            for name, n in launches.items():
                self.launches[name] += n * calls

    def write_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"results": self.rows}, f, indent=2)
        print(f"[bench] wrote {path} ({len(self.rows)} entries)")
