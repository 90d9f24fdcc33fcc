"""Request tracing for the serving stack: Perfetto ``trace_event`` spans.

The serving plane's perf story so far lives in aggregate counters
(``SpikeEngine.stats()``) — good for gating, useless for *attribution*: when
a round stalls you want to see which phase (host pack, dispatch, device
drain, telemetry flush) ate the time, per round, on a timeline.  This module
is the zero-dependency substrate for that:

  * :class:`Tracer` — a thread-safe, bounded ring buffer of trace events
    with an injectable monotonic clock (tests drive it with a fake clock for
    deterministic timestamps).  When the buffer fills, the *oldest* events
    drop and ``dropped`` counts them — memory stays bounded no matter how
    long an engine lives.
  * Chrome/Perfetto ``trace_event`` export (:meth:`Tracer.export`): the JSON
    a drain produces opens directly in https://ui.perfetto.dev (or
    ``chrome://tracing``).  Request lifecycles are async ``"b"``/``"e"``
    span pairs keyed by request id; phases (``queue``/``pack``/``dispatch``/
    ``device_drain``/``telemetry_flush``) are complete ``"X"`` events with
    real measured durations; ladder transitions, sheds, and crashes are
    instants.
  * :func:`validate_trace` — the schema check the CI observability smoke
    (and the tests) run against an exported file: well-formed events, and
    every begun request span accounted for.

A copy of the reference's ``repro.obs.trace`` (stdlib only), so the port
writes the same ``trace_event`` JSON.  Nothing here imports the serving
stack (the engine imports *us*), and a ``Tracer`` never touches torch:
spans observe host-side control flow only, so the traced datapath stays
bit-identical to the untraced one (property-tested in
``tests/test_torch_obs_identity.py``).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Optional

#: the full request lifecycle the engine emits, in order (admit/complete are
#: the async "b"/"e" pair; the rest are "X" phase spans or instants)
REQUEST_PHASES = ("admit", "queue", "pack", "fuse", "dispatch",
                  "device_drain", "telemetry_flush", "complete")

_VALID_PH = {"X", "B", "E", "b", "e", "n", "i", "I", "C", "M"}


class Tracer:
    """Thread-safe bounded trace-event recorder.

    ``clock`` is any zero-arg callable returning seconds (monotonic);
    timestamps are microseconds relative to construction.  ``capacity``
    bounds memory: the ring holds at most that many events and evicts the
    oldest (``dropped`` counts evictions).
    """

    def __init__(self, *, clock=time.monotonic, capacity: int = 1 << 16,
                 pid: Optional[int] = None):
        assert capacity >= 1, capacity
        self._clock = clock
        self._t0 = clock()
        self._lock = threading.Lock()
        self._events: collections.deque = collections.deque(maxlen=capacity)
        self.capacity = capacity
        self.dropped = 0
        self.pid = os.getpid() if pid is None else int(pid)
        self._ids = itertools.count(1)   # thread-safe in CPython

    # ------------------------------------------------------------------ #
    # emission
    # ------------------------------------------------------------------ #
    def now_us(self) -> float:
        """Microseconds since this tracer was created (injected clock)."""
        return (self._clock() - self._t0) * 1e6

    def next_id(self) -> int:
        """A fresh id for an async (request) span."""
        return next(self._ids)

    def _push(self, ev: dict) -> None:
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self.dropped += 1
            self._events.append(ev)

    def _base(self, name: str, ph: str, cat: str, ts_us, args: dict) -> dict:
        ev = {"name": name, "ph": ph, "cat": cat,
              "ts": float(self.now_us() if ts_us is None else ts_us),
              "pid": self.pid, "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        return ev

    def complete(self, name: str, ts_us: float, dur_us: float, *,
                 cat: str = "serve", **args) -> None:
        """One complete ("X") span with an explicit start and duration."""
        ev = self._base(name, "X", cat, ts_us, args)
        ev["dur"] = max(0.0, float(dur_us))
        self._push(ev)

    def instant(self, name: str, *, cat: str = "serve", **args) -> None:
        ev = self._base(name, "i", cat, None, args)
        ev["s"] = "t"                    # thread-scoped instant
        self._push(ev)

    def begin_async(self, name: str, span_id: int, *, cat: str = "request",
                    **args) -> None:
        ev = self._base(name, "b", cat, None, args)
        ev["id"] = int(span_id)
        self._push(ev)

    def end_async(self, name: str, span_id: int, *, cat: str = "request",
                  **args) -> None:
        ev = self._base(name, "e", cat, None, args)
        ev["id"] = int(span_id)
        self._push(ev)

    @contextlib.contextmanager
    def span(self, name: str, *, cat: str = "serve", **args):
        """Context manager emitting one "X" span around the body."""
        t0 = self.now_us()
        try:
            yield
        finally:
            self.complete(name, t0, self.now_us() - t0, cat=cat, **args)

    # ------------------------------------------------------------------ #
    # inspection + export
    # ------------------------------------------------------------------ #
    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def events(self) -> list[dict]:
        """A snapshot copy of the buffered events (oldest first)."""
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    def export(self, path: Optional[str] = None, *,
               process_name: str = "esam-serve") -> dict:
        """The Chrome/Perfetto ``trace_event`` JSON document (optionally
        written to ``path``).  Open it in ui.perfetto.dev."""
        meta = [{
            "name": "process_name", "ph": "M", "pid": self.pid, "tid": 0,
            "ts": 0.0, "cat": "__metadata",
            "args": {"name": process_name},
        }]
        doc = {
            "traceEvents": meta + self.events(),
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": self.dropped,
                          "capacity": self.capacity},
        }
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f)
        return doc


def validate_trace(doc: dict) -> dict:
    """Validate a ``trace_event`` document; raises ``ValueError`` on schema
    violations.  Returns a summary the CI smoke asserts on::

        {"events", "request_begun", "request_closed", "request_close_fraction",
         "phases"}

    ``request_close_fraction`` is closed/begun async request spans — the
    acceptance criterion wants it >= 0.99 for accepted requests (every
    admitted request must reach a terminal state that closes its span).
    """
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("trace document must be a dict with 'traceEvents'")
    events = doc["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("'traceEvents' must be a list")
    begun: set = set()
    closed: set = set()
    phases: dict[str, int] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i} is not an object: {ev!r}")
        for key in ("name", "ph", "ts", "pid", "tid"):
            if key not in ev:
                raise ValueError(f"event {i} missing '{key}': {ev!r}")
        if not isinstance(ev["name"], str) or ev["ph"] not in _VALID_PH:
            raise ValueError(f"event {i} bad name/ph: {ev!r}")
        if not isinstance(ev["ts"], (int, float)) or ev["ts"] < 0:
            raise ValueError(f"event {i} bad ts: {ev!r}")
        if ev["ph"] == "X":
            if not isinstance(ev.get("dur"), (int, float)) or ev["dur"] < 0:
                raise ValueError(f"X event {i} needs dur >= 0: {ev!r}")
        if ev["ph"] in ("b", "e"):
            if "id" not in ev:
                raise ValueError(f"async event {i} needs an id: {ev!r}")
            if ev.get("cat") == "request":
                (begun if ev["ph"] == "b" else closed).add(ev["id"])
        phases[ev["name"]] = phases.get(ev["name"], 0) + 1
    unmatched = closed - begun
    if unmatched:
        raise ValueError(f"request spans closed but never begun: "
                         f"{sorted(unmatched)[:8]}")
    return {
        "events": len(events),
        "request_begun": len(begun),
        "request_closed": len(begun & closed),
        "request_close_fraction": (len(begun & closed) / len(begun)
                                   if begun else 1.0),
        "phases": phases,
    }
