"""repro_torch.obs against repro.obs: the metrics registry and the kernel
timing lanes.

The port's registry is a copy of the reference's pure-Python one, so the
same operations on both give the same Prometheus text, the same snapshot
and the same histogram quantiles, exactly; ``kernel_timer`` and
``record_warmup_times`` book the same series under a deterministic clock."""

from __future__ import annotations

import math

import numpy as np
import pytest

from repro.obs import metrics as jmetrics
from repro.obs import profile as jprofile
from repro_torch.obs import metrics, profile


def _drive(mod, seed: int):
    """The same operations on a fresh registry of ``mod``."""
    rng = np.random.default_rng(seed)
    reg = mod.Registry()
    c = reg.counter("esam_requests_total", "requests served", lane="static")
    for v in rng.integers(0, 5, size=20):
        c.inc(float(v))
    reg.counter("esam_requests_total", lane="event").inc(3)
    g = reg.gauge("esam_queue_depth", "queue depth")
    g.set(7)
    g.inc(-2.5)
    h = reg.histogram("esam_round_seconds", "round wall time",
                      kernel='odd "name"\nx', lane="a\\b")
    for v in rng.lognormal(-9, 2, size=500):
        h.observe(float(v))
    h2 = reg.histogram("esam_round_seconds", kernel="tiny",
                       bounds=(0.5, 1.0, 2.0))
    for v in (0.1, 0.7, 0.7, 3.0, 1.5):
        h2.observe(v)
    reg.histogram("esam_empty_seconds")
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_text_and_snapshot_match_reference(seed):
    port, ref = _drive(metrics, seed), _drive(jmetrics, seed)
    assert port.prometheus_text() == ref.prometheus_text()
    assert port.snapshot() == ref.snapshot()
    for q in (0.01, 0.5, 0.9, 0.95, 0.99, 0.999, 1.0):
        for labels in ({"kernel": 'odd "name"\nx', "lane": "a\\b"},
                       {"kernel": "tiny"}):
            a = port.get("esam_round_seconds", **labels).quantile(q)
            b = ref.get("esam_round_seconds", **labels).quantile(q)
            assert a == b
    assert port.get("esam_empty_seconds").quantile(0.5) == 0.0
    assert metrics.DEFAULT_BOUNDS == jmetrics.DEFAULT_BOUNDS


def test_registry_rules_match_reference():
    for mod in (metrics, jmetrics):
        reg = mod.Registry()
        assert reg.counter("x", a="1") is reg.counter("x", a="1")
        with pytest.raises(ValueError):
            reg.gauge("x", a="1")
        with pytest.raises(AssertionError):
            reg.counter("y").inc(-1)
        h = reg.histogram("z", bounds=(1.0, 2.0))
        h.observe(5.0)
        assert h.cumulative_buckets()[-1] == (math.inf, 1)
        assert reg.get("missing") is None


def _clock(times):
    it = iter(times)
    return lambda: next(it)


def test_kernel_timer_and_warmup_gauges_match_reference():
    ticks = [0.0, 1e-5, 1.0, 1.00042, 2.0, 2.003, 3.0, 3.5]
    regs = []
    for met, prof in ((metrics, profile), (jmetrics, jprofile)):
        reg = met.Registry()
        clock = _clock(ticks)
        for kernel in ("cascade_packed_per_tile", "cascade_popcount_mega"):
            for _ in range(2):
                with prof.kernel_timer(reg, kernel, lane="cuda", clock=clock):
                    pass
        prof.record_warmup_times(reg, {"static": {64: 0.5, 128: 0.25},
                                       "event_t4": {64: 1.5},
                                       "telemetry_s": 0.1, "total_s": 2.35})
        prof.record_warmup_times(reg, {32: 0.125})
        regs.append(reg)
    assert regs[0].prometheus_text() == regs[1].prometheus_text()
    assert regs[0].snapshot() == regs[1].snapshot()
    h = regs[0].get("esam_kernel_seconds", kernel="cascade_popcount_mega",
                    lane="cuda")
    assert h.count == 2 and h.sum == pytest.approx(0.003 + 0.5)


def test_kernel_timer_observes_when_the_body_raises():
    reg = metrics.Registry()
    with pytest.raises(RuntimeError):
        with profile.kernel_timer(reg, "k", clock=_clock([0.0, 0.25])):
            raise RuntimeError("launch failed")
    assert reg.get("esam_kernel_seconds", kernel="k",
                   lane="default").count == 1
