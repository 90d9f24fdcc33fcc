"""repro_torch.obs against repro.obs, and the twins of tests/test_obs.py.

The port's registry is a copy of the reference's pure-Python one, so the
same operations on both give the same Prometheus text, the same snapshot
and the same histogram quantiles, exactly; ``kernel_timer`` and
``record_warmup_times`` book the same series under a deterministic clock.
Then the rest of the plane on the port: the tracer (timestamps under a
fake clock, the ring buffer, threads, export and ``validate_trace``, the
same document as the reference's tracer), the registry's rules, the
scrape server on an ephemeral port of 127.0.0.1, ``DeviceProfiler`` with
a fake backend and with ``torch.profiler`` on the CPU, the engine's
lifecycle spans and counters against ``stats()`` (rejection, shed, the
ladder, warmup, replan, the profiler's hooks), the router's counters and
spans on a crash, and the launcher's observability flags."""

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


# ----------------------------------------------------------------------- #
# the rest of the plane: the twins of tests/test_obs.py on the port
# ----------------------------------------------------------------------- #
import json  # noqa: E402
import threading  # noqa: E402
import urllib.error  # noqa: E402
import urllib.request  # noqa: E402

from repro_torch.obs import Observability  # noqa: E402
from repro_torch.obs.http import (PROMETHEUS_CONTENT_TYPE,  # noqa: E402
                                  MetricsServer)
from repro_torch.obs.metrics import DEFAULT_BOUNDS, Registry  # noqa: E402
from repro_torch.obs.profile import (DeviceProfiler,  # noqa: E402
                                     TorchProfiler, kernel_timer,
                                     record_warmup_times)
from repro_torch.obs.trace import (REQUEST_PHASES, Tracer,  # noqa: E402
                                   validate_trace)
from repro_torch.serve.engine import FaultAwareRouter, SpikeEngine  # noqa: E402
from repro_torch.serve.overload import DegradationLadder  # noqa: E402
from repro_torch.train import fault_tolerance as ft  # noqa: E402

from test_torch_async_serve import _mixed, _net, _spike_reqs  # noqa: E402


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _engine(**kw):
    kw.setdefault("max_batch", 8)
    return SpikeEngine(_net(), device="cpu", **kw)


# tracer
def test_tracer_complete_and_instant_deterministic_timestamps():
    clk = FakeClock()
    tr = Tracer(clock=clk, pid=7)
    clk.advance(0.001)
    t0 = tr.now_us()
    assert t0 == pytest.approx(1000.0)
    clk.advance(0.0005)
    tr.complete("pack", t0, tr.now_us() - t0, cat="round", bucket=8)
    tr.instant("shed", deadline_s=1.0)
    ev = tr.events()
    assert [e["ph"] for e in ev] == ["X", "i"]
    assert ev[0]["ts"] == pytest.approx(1000.0)
    assert ev[0]["dur"] == pytest.approx(500.0)
    assert ev[0]["args"] == {"bucket": 8}
    assert ev[0]["pid"] == 7
    assert ev[1]["s"] == "t"


def test_tracer_async_pair_and_span_context():
    tr = Tracer(clock=FakeClock())
    rid = tr.next_id()
    tr.begin_async("request", rid, kind="static")
    with tr.span("drain", cat="engine", round=3):
        pass
    tr.end_async("request", rid, status="done")
    ev = tr.events()
    assert [e["ph"] for e in ev] == ["b", "X", "e"]
    assert ev[0]["id"] == ev[2]["id"] == rid
    assert ev[1]["args"] == {"round": 3}


def test_tracer_ring_buffer_bounds_memory_and_counts_drops():
    tr = Tracer(clock=FakeClock(), capacity=4)
    for i in range(10):
        tr.instant(f"e{i}")
    assert len(tr) == 4
    assert tr.dropped == 6
    assert [e["name"] for e in tr.events()] == ["e6", "e7", "e8", "e9"]
    tr.clear()
    assert len(tr) == 0 and tr.dropped == 0


def test_tracer_thread_safety_under_concurrent_emission():
    tr = Tracer(clock=FakeClock(), capacity=1 << 14)

    def emit():
        for _ in range(500):
            tr.instant("tick")

    threads = [threading.Thread(target=emit) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert len(tr) == 2000


def test_tracer_export_is_valid_trace_event_json(tmp_path):
    tr = Tracer(clock=FakeClock())
    rid = tr.next_id()
    tr.begin_async("request", rid)
    tr.complete("dispatch", 0.0, 10.0)
    tr.end_async("request", rid)
    path = str(tmp_path / "trace.json")
    doc = tr.export(path)
    with open(path) as f:
        on_disk = json.load(f)
    assert on_disk == json.loads(json.dumps(doc))
    summary = validate_trace(on_disk)
    assert summary["request_begun"] == summary["request_closed"] == 1
    assert summary["request_close_fraction"] == 1.0
    assert on_disk["traceEvents"][0]["ph"] == "M"


@pytest.mark.parametrize("doc", [
    {"nope": []},
    {"traceEvents": [{"name": "a", "ph": "X", "ts": 0.0, "pid": 1,
                      "tid": 1}]},                       # missing dur
    {"traceEvents": [{"name": "a", "ph": "b", "ts": 0.0, "pid": 1,
                      "tid": 1}]},                       # missing id
    {"traceEvents": [{"name": "a", "ph": "??", "ts": 0.0, "pid": 1,
                      "tid": 1}]},
    {"traceEvents": [{"name": "a", "ph": "e", "ts": 0.0, "pid": 1,
                      "tid": 1, "id": 3, "cat": "request"}]},  # never begun
])
def test_validate_trace_rejects_malformed_events(doc):
    from repro.obs.trace import validate_trace as jvalidate

    for fn in (validate_trace, jvalidate):
        with pytest.raises(ValueError):
            fn(doc)


def test_unclosed_request_span_lowers_close_fraction():
    tr = Tracer(clock=FakeClock())
    tr.begin_async("request", tr.next_id())
    tr.begin_async("request", tr.next_id())
    tr.end_async("request", 1)
    s = validate_trace(tr.export())
    assert s["request_begun"] == 2 and s["request_closed"] == 1
    assert s["request_close_fraction"] == 0.5


def test_trace_export_matches_reference_tracer():
    """The same emissions on both tracers under one fake clock give the
    same document but for the thread and process ids."""
    from repro.obs.trace import Tracer as JTracer

    docs = []
    for cls in (Tracer, JTracer):
        clk = FakeClock()
        tr = cls(clock=clk, pid=3, capacity=5)
        for i in range(4):
            clk.advance(0.25)
            rid = tr.next_id()
            tr.begin_async("request", rid, kind="static", deadline_s=None)
            tr.complete("queue", 1.0, 2.5, cat="request", req=rid)
            tr.instant("fuse", cat="round", bucket=8)
            tr.end_async("request", rid, status="done", label=i)
        docs.append(tr.export(process_name="esam-serve"))
    for doc in docs:
        for ev in doc["traceEvents"]:
            ev.pop("tid")
    assert docs[0] == docs[1]
    assert docs[0]["otherData"] == {"dropped_events": 11, "capacity": 5}


# metrics registry
def test_counter_gauge_basics_and_idempotent_getters():
    reg = Registry()
    c = reg.counter("esam_test_total", "a counter")
    c.inc()
    c.inc(2.5)
    assert reg.counter("esam_test_total").value == 3.5
    with pytest.raises(AssertionError):
        c.inc(-1)
    g = reg.gauge("esam_depth")
    g.set(7)
    g.inc(-2)
    assert g.value == 5.0
    with pytest.raises(ValueError):
        reg.gauge("esam_test_total")


def test_labeled_series_are_independent():
    reg = Registry()
    reg.counter("esam_served_total", kind="static").inc(3)
    reg.counter("esam_served_total", kind="event").inc(4)
    assert reg.counter("esam_served_total", kind="static").value == 3
    assert reg.counter("esam_served_total", kind="event").value == 4
    assert reg.snapshot()['esam_served_total{kind="event"}']["value"] == 4


def test_histogram_quantiles_without_storing_samples():
    reg = Registry()
    h = reg.histogram("esam_lat_seconds")
    samples = np.random.default_rng(0).uniform(1e-4, 1e-1, size=2000)
    for s in samples:
        h.observe(float(s))
    assert h.count == 2000
    assert h.sum == pytest.approx(samples.sum(), rel=1e-9)
    for q in (0.5, 0.95, 0.99):
        true = np.quantile(samples, q)
        assert true / 2 <= h.quantile(q) <= true * 2


def test_histogram_cumulative_buckets_are_monotone_with_inf_tail():
    reg = Registry()
    h = reg.histogram("esam_h", bounds=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 5.0, 50.0):
        h.observe(v)
    cum = h.cumulative_buckets()
    assert [c for _, c in cum] == [1, 2, 3, 4]
    assert np.isinf(cum[-1][0])


def test_prometheus_text_exposition_format():
    reg = Registry()
    reg.counter("esam_req_total", "requests").inc(5)
    reg.gauge("esam_depth", "queue depth").set(2)
    reg.histogram("esam_lat", "latency", bounds=(1.0, 2.0)).observe(1.5)
    text = reg.prometheus_text()
    for line in ("# HELP esam_req_total requests",
                 "# TYPE esam_req_total counter", "esam_req_total 5.0",
                 "# TYPE esam_lat histogram", 'esam_lat_bucket{le="1.0"} 0',
                 'esam_lat_bucket{le="2.0"} 1',
                 'esam_lat_bucket{le="+Inf"} 1', "esam_lat_sum 1.5",
                 "esam_lat_count 1"):
        assert line in text
    assert text.endswith("\n")


def test_default_bounds_cover_microseconds_to_minutes():
    assert DEFAULT_BOUNDS[0] == pytest.approx(1e-6)
    assert DEFAULT_BOUNDS[-1] > 60.0
    assert all(b2 / b1 == pytest.approx(2.0)
               for b1, b2 in zip(DEFAULT_BOUNDS, DEFAULT_BOUNDS[1:]))


# http scrape endpoint
def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def test_metrics_server_serves_prometheus_json_trace_and_health():
    reg = Registry()
    reg.counter("esam_req_total").inc(3)
    tr = Tracer(clock=FakeClock())
    tr.instant("tick")
    with MetricsServer(reg, port=0, tracer=tr) as srv:
        port = srv.port
        status, ctype, body = _get(port, "/metrics")
        assert status == 200 and ctype == PROMETHEUS_CONTENT_TYPE
        assert b"esam_req_total 3.0" in body
        status, ctype, body = _get(port, "/metrics.json")
        assert status == 200 and ctype == "application/json"
        assert json.loads(body)["esam_req_total"]["value"] == 3.0
        status, _, body = _get(port, "/trace.json")
        assert status == 200
        validate_trace(json.loads(body))
        status, _, body = _get(port, "/healthz")
        assert status == 200 and body == b"ok\n"
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(port, "/nope")
        assert ei.value.code == 404
    assert srv.port is None


def test_metrics_server_without_tracer_has_no_trace():
    with MetricsServer(Registry(), port=0) as srv:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(srv.port, "/trace.json")
        assert ei.value.code == 404
        assert srv._httpd.server_address[0] == "127.0.0.1"


def test_metrics_server_scrape_while_writing():
    reg = Registry()
    c = reg.counter("esam_live_total")
    stop = threading.Event()

    def writer():
        while not stop.is_set():
            c.inc()

    t = threading.Thread(target=writer)
    t.start()
    try:
        with MetricsServer(reg, port=0) as srv:
            for _ in range(5):
                status, _, body = _get(srv.port, "/metrics")
                assert status == 200 and b"esam_live_total" in body
    finally:
        stop.set()
        t.join(timeout=30)
    assert not t.is_alive()


# device profiling hooks
class FakeProfiler:
    def __init__(self, fail=False, fail_stop=False):
        self.fail = fail
        self.fail_stop = fail_stop
        self.started = []
        self.stopped = 0

    def start_trace(self, logdir):
        if self.fail:
            raise RuntimeError("no backend")
        self.started.append(logdir)

    def prepare(self):
        if self.fail:
            raise RuntimeError("no backend")
        self.prepared = getattr(self, "prepared", 0) + 1

    def stop_trace(self):
        self.stopped += 1
        if self.fail_stop:
            raise RuntimeError("lost the trace")


def test_device_profiler_captures_exact_round_window():
    reg = Registry()
    fake = FakeProfiler()
    prof = DeviceProfiler("/tmp/x", skip_rounds=2, n_rounds=3,
                          registry=reg, profiler=fake)
    for i in range(10):
        prof.on_round_start(i)
        prof.on_round_end(i)
    assert fake.started == ["/tmp/x"]
    assert fake.stopped == 1
    assert prof.captured == 3 and prof.done and not prof.active
    assert reg.get("esam_profile_rounds_captured").value == 3
    prof.stop()
    assert fake.stopped == 1


def test_device_profiler_failure_never_raises_into_the_drain():
    prof = DeviceProfiler("/tmp/x", profiler=FakeProfiler(fail=True))
    prof.on_round_start(0)
    assert prof.done and prof.error is not None
    prof.on_round_end(0)
    assert prof.captured == 0
    stop_fails = DeviceProfiler("/tmp/x", profiler=FakeProfiler(
        fail_stop=True))
    stop_fails.on_round_start(0)
    stop_fails.on_round_end(0)
    assert stop_fails.done and "lost the trace" in stop_fails.error


def test_device_profiler_abort_mid_window_books_what_it_captured():
    reg = Registry()
    fake = FakeProfiler()
    prof = DeviceProfiler("/tmp/x", n_rounds=5, registry=reg, profiler=fake)
    for i in range(2):
        prof.on_round_start(i)
        prof.on_round_end(i)
    assert prof.active
    prof.stop()
    assert fake.stopped == 1 and prof.done and not prof.active
    assert reg.get("esam_profile_rounds_captured").value == 2
    with pytest.raises(ValueError):
        DeviceProfiler("/tmp/x", n_rounds=0)


def test_device_profiler_prepare_sets_the_backend_up_or_records_why_not():
    fake = FakeProfiler()
    prof = DeviceProfiler("/tmp/x", profiler=fake)
    prof.prepare()
    assert fake.prepared == 1 and not prof.done and prof.error is None
    prof.on_round_start(0)
    prof.on_round_end(0)
    assert fake.started == ["/tmp/x"] and prof.captured == 1

    class NoPrepare:
        def start_trace(self, logdir):
            pass

        def stop_trace(self):
            pass

    DeviceProfiler("/tmp/x", profiler=NoPrepare()).prepare()   # optional
    failing = DeviceProfiler("/tmp/x", profiler=FakeProfiler(fail=True))
    failing.prepare()                                          # no raise
    assert failing.done and "no backend" in failing.error
    failing.on_round_start(0)
    assert failing.captured == 0 and not failing.active


class ArmedFake(FakeProfiler):
    """A backend that also opens its session a round early."""

    def __init__(self):
        super().__init__()
        self.log = []

    def arm(self, logdir):
        self.log.append("arm")

    def start_trace(self, logdir):
        self.log.append("start")

    def stop_trace(self):
        self.log.append("stop")


def test_device_profiler_arms_the_backend_in_the_last_skipped_round():
    fake = ArmedFake()
    prof = DeviceProfiler("/tmp/x", skip_rounds=2, n_rounds=2,
                          profiler=fake)
    rounds = []
    for i in range(6):
        prof.on_round_start(i)
        rounds.append(list(fake.log))
        prof.on_round_end(i)
    # round 1 (the last skipped) runs armed; rounds 2 and 3 are captured
    assert rounds[:4] == [[], ["arm"], ["arm", "start"],
                          ["arm", "start"]]
    assert fake.log == ["arm", "start", "stop"] and prof.captured == 2
    # a drain that ends before the window opens closes the armed session
    early = ArmedFake()
    prof = DeviceProfiler("/tmp/x", skip_rounds=1, profiler=early)
    prof.on_round_start(0)
    prof.on_round_end(0)
    prof.stop()
    assert early.log == ["arm", "stop"] and prof.captured == 0
    assert prof.done and prof.error is None
    # no skipped round: nothing to arm
    direct = ArmedFake()
    prof = DeviceProfiler("/tmp/x", profiler=direct)
    prof.on_round_start(0)
    prof.on_round_end(0)
    assert direct.log == ["start", "stop"]


def test_torch_profiler_writes_a_chrome_trace_of_the_window(tmp_path):
    """The default backend on the CPU: the engine's rounds inside the
    window are in the exported Chrome trace; one file a capture."""
    prof = DeviceProfiler(str(tmp_path / "p"), skip_rounds=1, n_rounds=2)
    prof.prepare()
    eng = _engine(max_batch=4, observability=Observability(profile=prof))
    eng.serve(_spike_reqs(20))
    assert prof.error is None and prof.captured == 2 and prof.done
    backend = prof._profiler
    assert isinstance(backend, TorchProfiler)
    with open(backend.trace_path) as f:
        doc = json.load(f)
    assert backend.trace_path.startswith(str(tmp_path / "p"))
    names = {e.get("name") for e in doc["traceEvents"]}
    assert names & {"aten::add", "aten::copy_", "aten::empty"}
    with pytest.raises(RuntimeError):
        backend.stop_trace()
    # without arm(), start_trace opens its own session
    direct = DeviceProfiler(str(tmp_path / "q"), n_rounds=1)
    _engine(max_batch=4, observability=Observability(
        profile=direct)).serve(_spike_reqs(4))
    assert direct.error is None and direct.captured == 1
    assert direct._profiler.trace_path.startswith(str(tmp_path / "q"))


def test_record_warmup_times_flattens_nested_engine_shapes():
    reg = Registry()
    record_warmup_times(reg, {"static": {8: 0.5, 16: 0.25},
                              "event_t4": {8: 0.125},
                              "telemetry_s": 0.0625, "total_s": 1.0})
    assert reg.get("esam_warmup_compile_seconds",
                   shape="static_b8").value == 0.5
    assert reg.get("esam_warmup_compile_seconds",
                   shape="event_t4_b8").value == 0.125
    assert reg.get("esam_warmup_compile_seconds",
                   shape="total_s").value == 1.0


def test_kernel_timer_books_labeled_histogram():
    reg = Registry()
    clk = FakeClock()
    with kernel_timer(reg, "mega_cascade", lane="cuda", clock=clk):
        clk.advance(0.25)
    h = reg.get("esam_kernel_seconds", kernel="mega_cascade", lane="cuda")
    assert h.count == 1 and h.sum == pytest.approx(0.25)


# engine integration: spans close, counters reconcile with stats()
def _obs():
    return Observability.enabled(registry=Registry())


@pytest.mark.parametrize("overlap", [False, True])
def test_engine_trace_covers_lifecycle_and_closes_every_request(overlap):
    obs = _obs()
    eng = _engine(telemetry=True, overlap=overlap, fuse_rounds="auto",
                  observability=obs)
    eng.serve(_mixed(10, [(3, 2)]))
    eng.close()
    summary = validate_trace(obs.tracer.export())
    assert summary["request_begun"] == 13
    assert summary["request_close_fraction"] == 1.0
    for phase in ("queue", "pack", "dispatch", "device_drain",
                  "telemetry_flush"):
        assert phase in REQUEST_PHASES
        assert summary["phases"].get(phase, 0) > 0, (phase, summary)
    st = eng.stats()
    assert summary["phases"]["round"] == st["dispatch_rounds"]
    assert summary["phases"]["pack"] == st["dispatch_rounds"]
    assert summary["phases"]["device_drain"] == st["dispatch_rounds"]
    assert summary["phases"]["queue"] == 13


def test_engine_metrics_reconcile_with_stats():
    obs = _obs()
    eng = _engine(telemetry=True, observability=obs)
    eng.serve(_mixed(12, [(4, 2), (2, 4)]))
    st = eng.stats()
    snap = obs.metrics.snapshot()

    def v(name):
        return snap[name]["value"]

    assert v("esam_requests_submitted_total") == 18
    assert v('esam_requests_served_total{kind="static"}') == st["n_requests"]
    assert (v('esam_requests_served_total{kind="event"}')
            == st["n_event_requests"])
    assert v("esam_timesteps_served_total") == st["timesteps_total"]
    assert v("esam_dispatch_rounds_total") == st["dispatch_rounds"]
    assert v("esam_rows_real_total") == st["rows_real_total"]
    assert v("esam_rows_padded_total") == st["rows_padded_total"]
    assert v("esam_fused_rounds_total") == st["fused_rounds"]
    assert v("esam_rounds_saved_total") == st["rounds_saved"]
    # energy and cycles go up by exactly the float64 sums stats() folds
    assert v("esam_energy_pj_total") == (
        eng._totals["energy_pj"] + eng._event_totals["energy_pj"])
    assert v("esam_cycles_total") == (
        eng._totals["cycles"] + eng._event_totals["cycles"])
    assert v("esam_health") == st["health"]
    assert snap["esam_request_latency_seconds"]["count"] == 18
    assert snap["esam_round_pack_seconds"]["count"] == st["dispatch_rounds"]
    assert v("esam_queue_depth") == 0
    assert eng._req_spans == {}


def test_engine_registers_every_instrument_up_front():
    reg = Registry()
    eng = _engine(observability=Observability(metrics=reg))
    assert len(eng._m) == 22
    kinds = [inst.__class__.__name__ for inst in eng._m.values()]
    assert (kinds.count("Counter"), kinds.count("Gauge"),
            kinds.count("Histogram")) == (15, 3, 4)
    from repro.obs.metrics import Registry as JRegistry
    from repro.serve.engine import SpikeEngine as JEngine

    jreg = JRegistry()
    JEngine._make_instruments(jreg)
    assert reg.prometheus_text() == jreg.prometheus_text()


def test_engine_rejection_and_shed_paths_are_counted_and_closed():
    obs = _obs()
    eng = _engine(max_batch=4, queue_limit=4, observability=obs)
    reqs = _spike_reqs(8)
    eng.submit(reqs)
    assert eng.queue_depth() == 4
    for r in reqs[:4]:
        r.deadline_s = -1.0
    eng.serve()
    snap = obs.metrics.snapshot()
    assert snap["esam_requests_rejected_total"]["value"] == 4
    assert snap["esam_requests_shed_total"]["value"] == 4
    assert snap["esam_backpressure_events_total"]["value"] == 2
    summary = validate_trace(obs.tracer.export())
    assert summary["request_close_fraction"] == 1.0
    names = {e["name"] for e in obs.tracer.events()}
    assert "rejected" in names and "shed" in names


def test_engine_ladder_transitions_traced_and_counted():
    obs = _obs()
    eng = _engine(max_batch=4, telemetry=True, observability=obs,
                  queue_limit=64, high_water=8,
                  ladder=DegradationLadder.default(4))
    eng.submit(_spike_reqs(40))
    eng.serve()
    st = eng.stats()
    assert st["ladder_transitions"] > 0
    snap = obs.metrics.snapshot()
    assert (snap["esam_ladder_transitions_total"]["value"]
            == st["ladder_transitions"])
    assert (snap["esam_degradation_level"]["value"]
            == st["degradation_level"])
    got = [e["args"] for e in obs.tracer.events()
           if e["name"] == "ladder_transition"]
    assert [(a["from_level"], a["to_level"], a["reason"]) for a in got] == [
        (t["from_level"], t["to_level"], t["reason"])
        for t in st["ladder_transition_log"]]


def test_engine_profiler_hooks_called_per_round():
    fake = FakeProfiler()
    reg = Registry()
    obs = Observability(
        tracer=None, metrics=reg,
        profile=DeviceProfiler("/tmp/p", skip_rounds=0, n_rounds=2,
                               registry=reg, profiler=fake))
    eng = _engine(max_batch=4, observability=obs)
    eng.serve(_spike_reqs(12))
    assert obs.profile.captured == 2 and obs.profile.done
    assert fake.stopped == 1
    assert eng._req_spans == {}


def test_engine_warmup_books_compile_time_gauges():
    obs = _obs()
    eng = _engine(telemetry=True, observability=obs)
    eng.warmup(event_ts=(2,))
    total = obs.metrics.get("esam_warmup_compile_seconds", shape="total_s")
    assert total is not None and total.value > 0
    assert obs.metrics.get("esam_warmup_compile_seconds",
                           shape="static_b8") is not None
    assert obs.metrics.get("esam_warmup_compile_seconds",
                           shape="graphs") is None
    done = [e for e in obs.tracer.events() if e["name"] == "warmup_done"]
    assert len(done) == 1 and done[0]["args"]["shapes"] == 2


def test_engine_replan_is_traced():
    obs = _obs()
    eng = _engine(telemetry=True, observability=obs)
    eng.submit(_spike_reqs(3))
    eng.replan_degraded(1)
    ev = [e for e in obs.tracer.events() if e["name"] == "replan_degraded"]
    assert len(ev) == 1 and ev[0]["args"] == {"n_devices": 1}


# router integration
def test_router_counters_mirrored_into_registry_on_crash():
    obs = _obs()
    engines = [_engine(telemetry=True, observability=obs) for _ in range(2)]
    crashed = []

    def hook(round_idx):
        if not crashed:
            crashed.append(round_idx)
            raise RuntimeError("chaos")

    engines[0].round_hook = hook
    router = FaultAwareRouter(
        engines, health_threshold=0.0, observability=obs,
        retry=ft.RetryPolicy(base_backoff_s=1e-4), sleep=lambda s: None)
    reqs = _spike_reqs(6)
    router.serve(reqs)
    st = router.stats()
    assert st["crashes"] == 1 and st["retries"] > 0
    snap = obs.metrics.snapshot()
    assert snap["esam_router_crashes_total"]["value"] == st["crashes"]
    assert snap["esam_router_retries_total"]["value"] == st["retries"]
    assert snap["esam_router_replicas_down"]["value"] == 1
    names = {e["name"] for e in obs.tracer.events()}
    assert {"replica_crash", "reroute", "replica_drain"} <= names
    assert all(r.status == "done" for r in reqs)
    # the crashed replica's attempts are closed too: every span closes
    summary = validate_trace(obs.tracer.export())
    assert summary["request_close_fraction"] == 1.0
    crashed_ends = [e for e in obs.tracer.events()
                    if e["ph"] == "e" and e["args"]["status"] == "crashed"]
    assert len(crashed_ends) == st["retries"]
    assert engines[0]._req_spans == {}


def test_router_slow_and_degraded_routes_are_traced():
    obs = _obs()
    clock = FakeClock()
    engines = [_engine(telemetry=True, observability=obs) for _ in range(2)]
    # every replica degraded: the healthiest (replica 0, by order) serves,
    # and its drain runs past the timeout
    engines[0].round_hook = lambda _r: clock.advance(1.0)
    router = FaultAwareRouter(
        engines, health_threshold=2.0, observability=obs, clock=clock,
        retry=ft.RetryPolicy(attempt_timeout_s=0.5), sleep=lambda s: None)
    router.serve(_spike_reqs(6))
    st = router.stats()
    snap = obs.metrics.snapshot()
    assert st["degraded_route"] == 6
    assert snap["esam_router_degraded_route_total"]["value"] == 6
    names = [e["name"] for e in obs.tracer.events()]
    assert names.count("degraded_route") == 6
    assert st["timeouts"] == 1 and st["slow"] == [0]
    assert snap["esam_router_timeouts_total"]["value"] == 1
    assert snap["esam_router_replicas_slow"]["value"] == 1
    slow = [e for e in obs.tracer.events() if e["name"] == "replica_slow"]
    assert slow[0]["args"]["replica"] == 0


# the launcher's observability flags
def test_launcher_traffic_with_every_lane_reconciles_like_the_ci_smoke(
        tmp_path, capsys, monkeypatch):
    """``--traffic --replicas 2 --chaos`` with the scrape endpoint held: the
    hold's sleep scrapes /healthz, /metrics and /metrics.json, which must
    reconcile with ``--report-json`` and the trace as the reference's CI
    observability smoke asserts (a crash's victims are admitted twice)."""
    import time
    import types

    from repro_torch.launch import serve as serve_mod

    scraped = {}

    def hold(seconds):
        out = capsys.readouterr().out
        scraped["out"] = out
        port = int(out.split("METRICS port=")[1].split()[0])
        for path in ("/healthz", "/metrics", "/metrics.json"):
            scraped[path] = _get(port, path)[2]
        scraped["held"] = seconds

    monkeypatch.setattr(serve_mod, "time", types.SimpleNamespace(
        perf_counter=time.perf_counter, sleep=hold))
    trace, report = tmp_path / "trace.json", tmp_path / "report.json"
    run = serve_mod.main([
        "--traffic", "--smoke", "--replicas", "2", "--chaos", "--device",
        "cpu", "--metrics-port", "0", "--metrics-hold-s", "7",
        "--trace-out", str(trace), "--report-json", str(report),
        "--profile-rounds", "2", "--profile-dir", str(tmp_path / "prof")])
    assert scraped["held"] == 7 and scraped["/healthz"] == b"ok\n"
    text = scraped["/metrics"].decode()
    assert "# TYPE esam_requests_submitted_total counter" in text
    assert "# TYPE esam_request_latency_seconds histogram" in text
    assert 'esam_request_latency_seconds_bucket{le="+Inf"}' in text
    with open(report) as f:
        rep = json.load(f)
    with open(trace) as f:
        doc = json.load(f)
    assert rep["metrics"] == json.loads(scraped["/metrics.json"])
    assert rep["n_offered"] == run.report.n_offered == 128
    victims = sum(e["args"]["victims"] for e in doc["traceEvents"]
                  if e["name"] == "replica_crash")
    assert victims > 0 and rep["crashes"] == 1
    assert rep["metrics"]["esam_requests_submitted_total"]["value"] == (
        rep["n_offered"] - rep["n_rejected"] + victims - rep["n_failed"])
    summary = validate_trace(doc)
    assert summary["request_close_fraction"] == 1.0
    assert {"pack", "dispatch", "device_drain",
            "telemetry_flush"} <= set(summary["phases"])
    assert rep["metrics"]["esam_router_crashes_total"]["value"] == 1
    out = scraped["out"] + capsys.readouterr().out
    assert "PROFILE dir=" in out and "status=ok" in out
    assert "close_fraction=1.0000" in out and "REPORT path=" in out
    assert "METRICS holding for 7s" in out
    assert list((tmp_path / "prof").glob("esam_trace_*.json"))


@pytest.mark.parametrize("mode", ["--esam", "--events"])
def test_launcher_threads_the_handle_into_every_mode(mode, tmp_path,
                                                     capsys):
    from repro_torch.launch import serve as serve_mod

    trace = tmp_path / "trace.json"
    run = serve_mod.main([mode, "--smoke", "--device", "cpu", "--requests",
                          "24", "--trace-out", str(trace)])
    with open(trace) as f:
        summary = validate_trace(json.load(f))
    # only the timed engine is instrumented, never the warm-up engine
    assert summary["request_begun"] == len(run.requests) == 24
    assert summary["request_close_fraction"] == 1.0
    assert summary["phases"]["round"] == run.engine.stats()[
        "dispatch_rounds"]
    out = capsys.readouterr().out
    assert "TRACE path=" in out and "METRICS" not in out


def test_launcher_without_flags_builds_no_plane():
    from repro_torch.launch import serve as serve_mod

    run = serve_mod.main(["--esam", "--smoke", "--device", "cpu",
                          "--requests", "8"])
    assert run.engine._obs is None


# the versioned stats schema
def test_stats_schema_matches_stats_keys_exactly():
    from repro_torch.serve.engine import STATS_SCHEMA_VERSION, stats_schema

    documented = {k for section in stats_schema().values() for k in section}
    eng = _engine(telemetry=True)
    eng.serve(_mixed(6, [(2, 2)]))
    st = eng.stats()
    assert set(st) == documented
    assert st["stats_schema_version"] == STATS_SCHEMA_VERSION == 1


def test_stats_schema_returns_fresh_copy():
    from repro_torch.serve.engine import stats_schema

    a = stats_schema()
    a["identity"]["n_requests"] = "mutated"
    assert stats_schema()["identity"]["n_requests"] != "mutated"
