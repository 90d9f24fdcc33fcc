"""Metrics registry: counters, gauges, and log-bucketed latency histograms.

A copy of the reference's ``repro.obs.metrics`` (pure Python, stdlib only),
so the port's text exposition and histogram quantiles are the reference's
exactly.  Cheap enough to leave on in a hot path: a counter increment is
one lock + one float add, a histogram observation is a bisect over the
bucket bounds -- no sample is ever stored, so p50/p95/p99/p99.9 come from
the bucket counts (log-spaced bounds, so the quantile error is bounded by
the bucket ratio) and memory stays O(buckets) for the life of the process.

Two export surfaces:

  * :meth:`Registry.prometheus_text` -- the Prometheus text exposition
    format (version 0.0.4); histograms render as cumulative
    ``_bucket{le=...}`` series plus ``_sum``/``_count``.
  * :meth:`Registry.snapshot` -- a JSON-able dict with pre-computed
    quantiles per histogram.

``REGISTRY`` is the process-global default (one scrape surface per
process); anything that wants isolation (tests, per-lane benches) builds its
own ``Registry``.
"""

from __future__ import annotations

import math
import threading
from typing import Optional

#: default histogram bounds: geometric, 1us .. ~67s in factor-of-2 steps —
#: 27 buckets (+inf) covers a pack span to a chaos-stalled drain round with
#: a bounded-by-2x quantile error, in O(1) memory per histogram
DEFAULT_BOUNDS = tuple(1e-6 * (2.0 ** i) for i in range(27))


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


def _escape(v) -> str:
    return (str(v).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _render_labels(labels: tuple, extra: tuple = ()) -> str:
    items = tuple(labels) + tuple(extra)
    if not items:
        return ""
    return "{" + ",".join(f'{k}="{_escape(v)}"' for k, v in items) + "}"


class _Instrument:
    kind = "untyped"

    def __init__(self, name: str, help_: str, labels: dict):
        self.name = name
        self.help = help_
        self.labels = _label_key(labels)
        self._lock = threading.Lock()

    @property
    def full_name(self) -> str:
        return self.name + _render_labels(self.labels)


class Counter(_Instrument):
    """Monotonically increasing float counter."""

    kind = "counter"

    def __init__(self, name, help_="", labels=()):
        super().__init__(name, help_, dict(labels))
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        assert n >= 0, f"counter {self.name} cannot decrease (inc {n})"
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge(_Instrument):
    """Set-to-current-value instrument (queue depth, ladder level, health)."""

    kind = "gauge"

    def __init__(self, name, help_="", labels=()):
        super().__init__(name, help_, dict(labels))
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram(_Instrument):
    """Log-bucketed histogram: quantiles without storing samples.

    ``bounds`` are the inclusive upper edges (ascending); one implicit +Inf
    bucket catches the tail.  ``quantile(q)`` linearly interpolates inside
    the covering bucket, so with the default factor-2 bounds the estimate is
    within 2x of the true value — the right fidelity for "did p99 blow up",
    at O(len(bounds)) memory forever.
    """

    kind = "histogram"

    def __init__(self, name, help_="", labels=(), bounds=DEFAULT_BOUNDS):
        super().__init__(name, help_, dict(labels))
        assert bounds and all(b > a for a, b in zip(bounds, bounds[1:])), \
            f"bounds must be ascending: {bounds}"
        self.bounds = tuple(float(b) for b in bounds)
        self._counts = [0] * (len(self.bounds) + 1)   # +Inf tail bucket
        self._sum = 0.0
        self._count = 0

    def _bucket_index(self, v: float) -> int:
        lo, hi = 0, len(self.bounds)
        while lo < hi:                 # first bound >= v (bisect, no import)
            mid = (lo + hi) // 2
            if self.bounds[mid] < v:
                lo = mid + 1
            else:
                hi = mid
        return lo

    def observe(self, v: float) -> None:
        v = float(v)
        i = self._bucket_index(v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def quantile(self, q: float) -> float:
        """Estimated q-quantile (0 < q <= 1) from the bucket counts."""
        assert 0.0 < q <= 1.0, q
        with self._lock:
            total = self._count
            counts = list(self._counts)
        if total == 0:
            return 0.0
        target = q * total
        cum = 0.0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo = 0.0 if i == 0 else self.bounds[i - 1]
                hi = self.bounds[i] if i < len(self.bounds) else self.bounds[-1]
                frac = (target - cum) / c
                return lo + (hi - lo) * min(1.0, max(0.0, frac))
            cum += c
        return self.bounds[-1]

    def cumulative_buckets(self) -> list[tuple[float, int]]:
        """Prometheus-style cumulative ``(le, count)`` pairs, +Inf last."""
        with self._lock:
            counts = list(self._counts)
        out, cum = [], 0
        for b, c in zip(self.bounds, counts):
            cum += c
            out.append((b, cum))
        out.append((math.inf, cum + counts[-1]))
        return out


class Registry:
    """Name-keyed instrument registry with idempotent getters.

    ``counter``/``gauge``/``histogram`` return the existing instrument when
    one was already registered under the same (name, labels) — callers can
    re-derive handles without coordination.  Re-registering a name as a
    different kind raises.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[tuple, _Instrument] = {}

    def _get(self, cls, name: str, help_: str, labels: dict, **kw):
        key = (name, _label_key(labels))
        with self._lock:
            inst = self._metrics.get(key)
            if inst is None:
                inst = cls(name, help_, labels, **kw)
                self._metrics[key] = inst
            elif not isinstance(inst, cls):
                raise ValueError(
                    f"{name} already registered as {inst.kind}")
            return inst

    def counter(self, name: str, help_: str = "", **labels) -> Counter:
        return self._get(Counter, name, help_, labels)

    def gauge(self, name: str, help_: str = "", **labels) -> Gauge:
        return self._get(Gauge, name, help_, labels)

    def histogram(self, name: str, help_: str = "",
                  bounds=DEFAULT_BOUNDS, **labels) -> Histogram:
        return self._get(Histogram, name, help_, labels, bounds=bounds)

    def instruments(self) -> list[_Instrument]:
        with self._lock:
            return list(self._metrics.values())

    def get(self, name: str, **labels) -> Optional[_Instrument]:
        with self._lock:
            return self._metrics.get((name, _label_key(labels)))

    # ------------------------------------------------------------------ #
    # export surfaces
    # ------------------------------------------------------------------ #
    def prometheus_text(self) -> str:
        """Prometheus text exposition (format version 0.0.4)."""
        by_family: dict[str, list[_Instrument]] = {}
        for inst in self.instruments():
            by_family.setdefault(inst.name, []).append(inst)
        lines = []
        for name in sorted(by_family):
            family = by_family[name]
            kind = family[0].kind
            help_ = next((i.help for i in family if i.help), "")
            if help_:
                lines.append(f"# HELP {name} {_escape(help_)}")
            lines.append(f"# TYPE {name} {kind}")
            for inst in sorted(family, key=lambda i: i.labels):
                if isinstance(inst, Histogram):
                    for le, cum in inst.cumulative_buckets():
                        le_s = "+Inf" if math.isinf(le) else repr(le)
                        lines.append(
                            f"{name}_bucket"
                            f"{_render_labels(inst.labels, (('le', le_s),))}"
                            f" {cum}")
                    lines.append(f"{name}_sum"
                                 f"{_render_labels(inst.labels)} {inst.sum}")
                    lines.append(f"{name}_count"
                                 f"{_render_labels(inst.labels)} {inst.count}")
                else:
                    lines.append(f"{name}{_render_labels(inst.labels)} "
                                 f"{inst.value}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """JSON-able snapshot: full metric name -> {type, value | quantiles}.

        Histograms carry ``count``/``sum`` plus p50/p95/p99/p99.9 — the same
        percentile ladder ``TrafficReport`` reports, so the two reconcile.
        """
        out: dict[str, dict] = {}
        for inst in self.instruments():
            if isinstance(inst, Histogram):
                out[inst.full_name] = {
                    "type": inst.kind,
                    "count": inst.count,
                    "sum": inst.sum,
                    "p50": inst.quantile(0.50),
                    "p95": inst.quantile(0.95),
                    "p99": inst.quantile(0.99),
                    "p999": inst.quantile(0.999),
                }
            else:
                out[inst.full_name] = {"type": inst.kind, "value": inst.value}
        return out


#: the process-global registry (one scrape surface per process); modules that
#: need isolation build their own Registry instead
REGISTRY = Registry()
