"""repro_torch's fault-aware router and open-loop traffic against the
reference's, on the CPU.

The twins of the router tests in ``tests/test_faults.py`` and
``tests/test_overload.py`` and of ``tests/test_traffic.py``: the seeded
arrivals and request blends (``build_requests``) equal the reference's bit
for bit; each router scenario runs on the port's engines and on the
reference's (interpret mode) with the same weights and a sleep that only
records, and the two routers' counters, routes and request statuses are
held equal.  ``run_open_loop`` is compared under a shared deterministic
clock that only its sleeps advance.  Last, the launcher's
``--traffic --smoke --replicas 2 --chaos --device cpu``: one crash, no
request lost, every completed logit equal to a clean replay.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.esam.faults import FaultModel as JaxFaultModel
from repro.core.esam.network import EsamNetwork as JaxNetwork
from repro.serve import engine as jengine
from repro.serve import traffic as jtraffic
from repro.train import fault_tolerance as jft
from repro_torch.core.esam.faults import FaultModel
from repro_torch.core.esam.network import EsamNetwork
from repro_torch.serve import engine, traffic
from repro_torch.serve.engine import (AllReplicasDegradedError,
                                      AllReplicasDownError, FaultAwareRouter,
                                      SpikeEngine, SpikeRequest)
from repro_torch.train import fault_tolerance as ft

N_IN = 128


def _arrays(seed=0, topo=(N_IN, 128, 10), vth_lo=0, vth_hi=1):
    rng = np.random.default_rng(seed)
    bits = [rng.integers(0, 2, size=(k, n), dtype=np.int8)
            for k, n in zip(topo[:-1], topo[1:])]
    vth = [rng.integers(vth_lo, vth_hi, size=(n,)).astype(np.int32)
           for n in topo[1:]]
    return bits, vth, np.zeros((topo[-1],), np.float32)


_NETS: dict = {}


def _nets(seed=0):
    """(reference network, port network) on the same weights, cached."""
    if seed not in _NETS:
        bits, vth, off = _arrays(seed)
        _NETS[seed] = (
            JaxNetwork([jnp.asarray(b) for b in bits],
                       [jnp.asarray(v) for v in vth], jnp.asarray(off)),
            EsamNetwork.from_numpy(bits, vth, off, device="cpu"))
    return _NETS[seed]


def _engine(net=None, **kw):
    kw.setdefault("max_batch", 8)
    return SpikeEngine(net if net is not None else _nets()[1], device="cpu",
                       **kw)


def _jengine(net=None, **kw):
    kw.setdefault("max_batch", 8)
    return jengine.SpikeEngine(net if net is not None else _nets()[0],
                               interpret=True, **kw)


def _spikes(n, seed=0):
    return [(np.random.default_rng((seed, i)).random(N_IN) < 0.3)
            .astype(np.uint8) for i in range(n)]


class Routers:
    """One router scenario on both packages: ``make(engine_factory, mod)``
    returns the engines; each router gets the same keywords and a sleep
    that records its backoffs."""

    def __init__(self, make, **router_kw):
        self.slept, self.jslept = [], []
        self.engines = make(_engine, engine)
        self.jengines = make(_jengine, jengine)
        rkw = dict(router_kw)
        jkw = dict(router_kw)
        if "retry" in router_kw:
            jkw["retry"] = jft.RetryPolicy(
                **dataclasses.asdict(router_kw["retry"]))
        self.port = FaultAwareRouter(self.engines, sleep=self.slept.append,
                                     **rkw)
        self.ref = jengine.FaultAwareRouter(self.jengines,
                                            sleep=self.jslept.append, **jkw)

    def requests(self, spikes):
        return ([SpikeRequest(spikes=s) for s in spikes],
                [jengine.SpikeRequest(spikes=s) for s in spikes])

    def assert_same(self, pair=None):
        st_, jst = self.port.stats(), self.ref.stats()
        assert set(st_) == set(jst)
        for key in st_:
            if key == "engines":
                for e, je in zip(st_[key], jst[key]):
                    assert set(e) == set(je)
                    for k in e:
                        if k == "health":
                            assert e[k] == pytest.approx(je[k], rel=1e-6)
                        else:
                            assert e[k] == je[k], k
            else:
                assert st_[key] == jst[key], key
        assert self.slept == self.jslept
        if pair is not None:
            for r, q in zip(*pair):
                assert r.status == q.status and r.attempts == q.attempts
                assert (r.logits is None) == (q.logits is None)
                if r.logits is not None:
                    np.testing.assert_array_equal(r.logits,
                                                  np.asarray(q.logits))


# ----------------------------------------------------------------------- #
# the generator: the reference's arrivals and requests
# ----------------------------------------------------------------------- #
@pytest.mark.parametrize("cfg", [
    dict(rate_hz=100.0, n_requests=500, seed=3, n_in=N_IN),
    dict(rate_hz=50.0, n_requests=200, seed=9, p_event=0.4,
         event_t_choices=(2, 4), n_in=N_IN),
    dict(rate_hz=2000.0, n_requests=64, seed=0, p_event=0.25,
         event_t_choices=(2, 4), n_in=768, deadline_s=0.25),
    dict(rate_hz=5.0, n_requests=1, seed=123, p_event=1.0,
         event_t_choices=(1, 3, 8), n_in=70, spike_p=0.6),
])
@pytest.mark.parametrize("storm", [None, (0.05, 15), (0.0, 64)])
def test_build_requests_match_reference(cfg, storm):
    chaos = jchaos = None
    if storm is not None:
        chaos = traffic.ChaosConfig(storm_at_s=storm[0], storm_size=storm[1])
        jchaos = jtraffic.ChaosConfig(storm_at_s=storm[0],
                                      storm_size=storm[1])
    c, jc = traffic.TrafficConfig(**cfg), jtraffic.TrafficConfig(**cfg)
    np.testing.assert_array_equal(traffic.arrival_times(c),
                                  jtraffic.arrival_times(jc))
    reqs, arr = traffic.build_requests(c, chaos=chaos)
    jreqs, jarr = jtraffic.build_requests(jc, chaos=jchaos)
    np.testing.assert_array_equal(arr, jarr)
    assert len(reqs) == len(jreqs)
    for r, q in zip(reqs, jreqs):
        assert type(r).__name__ == type(q).__name__
        payload = ("events" if isinstance(r, engine.EventRequest)
                   else "spikes")
        np.testing.assert_array_equal(getattr(r, payload),
                                      getattr(q, payload))
    assert (np.diff(arr) >= 0).all()


def test_arrivals_are_seeded_poisson():
    cfg = traffic.TrafficConfig(rate_hz=100.0, n_requests=500, seed=3,
                                n_in=N_IN)
    a1 = traffic.arrival_times(cfg)
    np.testing.assert_array_equal(a1, traffic.arrival_times(cfg))
    assert (np.diff(a1) >= 0).all() and a1[0] > 0
    assert np.diff(a1, prepend=0.0).mean() == pytest.approx(0.01, rel=0.2)


def test_report_and_config_fields_match_reference():
    for cls, jcls in ((traffic.TrafficConfig, jtraffic.TrafficConfig),
                      (traffic.ChaosConfig, jtraffic.ChaosConfig),
                      (traffic.TrafficReport, jtraffic.TrafficReport)):
        assert [f.name for f in dataclasses.fields(cls)] == [
            f.name for f in dataclasses.fields(jcls)]
    assert traffic.ChaosConfig(slowdown=((1, 0.2),)).stall_s(1) == 0.2


# ----------------------------------------------------------------------- #
# the chaos harness
# ----------------------------------------------------------------------- #
def test_install_chaos_crash_hook_raises_after_n_rounds():
    eng = _engine()
    traffic.install_chaos([eng], traffic.ChaosConfig(crash_replica=0,
                                                     crash_after_rounds=2))
    with pytest.raises(traffic.ReplicaCrashError):
        eng.serve([SpikeRequest(spikes=np.zeros(N_IN, np.uint8))
                   for _ in range(20)])
    assert eng.stats()["dispatch_rounds"] == 2


def test_install_chaos_slowdown_feeds_watchdog():
    slept = []
    eng = _engine()
    traffic.install_chaos([eng], traffic.ChaosConfig(slowdown=((0, 0.25),)),
                          sleep=slept.append)
    eng.serve([SpikeRequest(spikes=np.zeros(N_IN, np.uint8))
               for _ in range(20)])
    assert slept == [0.25, 0.25, 0.25]


# ----------------------------------------------------------------------- #
# the router against the reference's
# ----------------------------------------------------------------------- #
def _forced_degraded(make, mod):
    eng = make(max_batch=8)
    eng.health = lambda: 0.0
    return eng


def test_all_degraded_fallback_counts_degraded_route():
    both = Routers(lambda make, mod: [_forced_degraded(make, mod)],
                   health_threshold=0.5)
    pair = both.requests(_spikes(1))
    assert both.port.route(pair[0][0]) == both.ref.route(pair[1][0]) == 0
    assert both.port.stats()["degraded_route"] == 1
    both.assert_same()


def test_all_degraded_raise_mode():
    both = Routers(lambda make, mod: [_forced_degraded(make, mod)],
                   health_threshold=0.5, on_all_degraded="raise")
    pair = both.requests(_spikes(1))
    with pytest.raises(AllReplicasDegradedError):
        both.port.route(pair[0][0])
    with pytest.raises(jengine.AllReplicasDegradedError):
        both.ref.route(pair[1][0])
    assert both.port.routed == [0]
    both.assert_same()


def test_router_spill_to_degraded_on_full_healthy_queue_is_counted():
    both = Routers(lambda make, mod: [make(max_batch=8, queue_limit=1),
                                      _forced_degraded(make, mod)],
                   health_threshold=0.5)
    pair = both.requests(_spikes(2))
    assert both.port.route(pair[0][0]) == both.ref.route(pair[1][0]) == 0
    assert both.port.route(pair[0][1]) == both.ref.route(pair[1][1]) == 1
    assert pair[0][1].status == "pending"
    assert both.port.stats()["degraded_route"] == 1
    both.assert_same(pair)


def test_router_rejects_when_every_queue_full():
    both = Routers(lambda make, mod: [make(queue_limit=1),
                                      make(queue_limit=1)])
    pair = both.requests(_spikes(3))
    got = [both.port.route(r) for r in pair[0]]
    want = [both.ref.route(r) for r in pair[1]]
    assert got == want == [0, 1, None]
    assert pair[0][2].status == "rejected"
    assert both.port.stats()["rejected_full"] == 1
    both.assert_same(pair)


def test_router_bad_arguments():
    with pytest.raises(ValueError):
        FaultAwareRouter([])
    with pytest.raises(ValueError):
        FaultAwareRouter([_engine()], on_all_degraded="ignore")


def test_router_drains_traffic_around_degraded_engine():
    """Health from the faulted engine's telemetry routes every request to
    the clean replica; a router of the degraded one alone falls back."""
    fields = dict(seed=4, stuck1_rate=0.7)

    def make(factory, mod):
        fm = FaultModel(**fields) if mod is engine else JaxFaultModel(
            **fields)
        return [factory(telemetry=True, max_batch=16),
                factory(telemetry=True, max_batch=16, faults=fm)]

    s = _spikes(12, seed=23)
    calib = Routers(make)
    for eng in calib.engines:
        eng.serve([SpikeRequest(spikes=r) for r in s])
    for eng in calib.jengines:
        eng.serve([jengine.SpikeRequest(spikes=r) for r in s])
    thr = (calib.engines[0].health() + calib.engines[1].health()) / 2
    port = FaultAwareRouter(calib.engines, health_threshold=thr)
    ref = jengine.FaultAwareRouter(calib.jengines, health_threshold=thr)
    out = port.serve([SpikeRequest(spikes=r) for r in s])
    jout = ref.serve([jengine.SpikeRequest(spikes=r) for r in s])
    assert port.routed == ref.routed == [len(s), 0]
    for a, b in zip(out, jout):
        np.testing.assert_array_equal(a.logits, np.asarray(b.logits))
    st_ = port.stats()
    assert st_["engines"][1]["degraded"] and not st_["engines"][0]["degraded"]
    alone = FaultAwareRouter([calib.engines[1]], health_threshold=0.99)
    assert alone.serve([SpikeRequest(spikes=s[0])])[0].logits is not None
    assert alone.routed == [1] and alone.stats()["degraded_route"] == 1


@pytest.mark.parametrize("crash_after,n", [(1, 32), (0, 6), (2, 40)])
def test_crash_reroutes_exactly_once_like_reference(crash_after, n):
    """One of two replicas crashes mid-drain; its victims are re-routed
    with the reference's backoffs; every request completes once, with the
    logits of a clean replay."""
    retry = ft.RetryPolicy(max_attempts=4, base_backoff_s=1e-4, seed=7)
    both = Routers(lambda make, mod: [make(), make()], retry=retry)
    traffic.install_chaos(both.engines, traffic.ChaosConfig(
        crash_replica=0, crash_after_rounds=crash_after))
    jtraffic.install_chaos(both.jengines, jtraffic.ChaosConfig(
        crash_replica=0, crash_after_rounds=crash_after))
    pair = both.requests(_spikes(n, seed=29))
    both.port.serve(pair[0])
    both.ref.serve(pair[1])
    both.assert_same(pair)
    st_ = both.port.stats()
    assert st_["crashes"] == 1 and st_["down"] == [0] and st_["backlog"] == 0
    assert st_["retries"] > 0 and both.engines[0].queue_depth() == 0
    assert all(r.status == "done" for r in pair[0])
    clean = _engine().serve([SpikeRequest(spikes=s)
                             for s in _spikes(n, seed=29)])
    for a, b in zip(pair[0], clean):
        np.testing.assert_array_equal(a.logits, b.logits)
        assert a.label == b.label


def test_all_replicas_down_fails_remaining_requests():
    both = Routers(lambda make, mod: [make(), make()],
                   retry=ft.RetryPolicy(max_attempts=5, base_backoff_s=1e-5))
    for engines, mod in ((both.engines, traffic), (both.jengines, jtraffic)):
        mod.install_chaos(engines, mod.ChaosConfig(crash_replica=0,
                                                   crash_after_rounds=0))
        mod.install_chaos([engines[1]], mod.ChaosConfig(
            crash_replica=0, crash_after_rounds=0))
    pair = both.requests([np.zeros(N_IN, np.uint8)] * 4)
    both.port.serve(pair[0])
    both.ref.serve(pair[1])
    both.assert_same(pair)
    st_ = both.port.stats()
    assert st_["crashes"] == 2 and st_["down"] == [0, 1]
    assert st_["failed"] == 4 and all(r.status == "failed" for r in pair[0])
    with pytest.raises(AllReplicasDownError):
        both.port.route(SpikeRequest(spikes=np.zeros(N_IN, np.uint8)))


def test_retry_budget_exhaustion_marks_failed_not_lost():
    both = Routers(lambda make, mod: [make(), make()],
                   retry=ft.RetryPolicy(max_attempts=1, base_backoff_s=1e-5))
    traffic.install_chaos(both.engines, traffic.ChaosConfig(
        crash_replica=0, crash_after_rounds=0))
    jtraffic.install_chaos(both.jengines, jtraffic.ChaosConfig(
        crash_replica=0, crash_after_rounds=0))
    pair = both.requests([np.zeros(N_IN, np.uint8)] * 6)
    for r, q in zip(*pair):
        both.port.route(r)
        both.ref.route(q)
    both.port.serve()
    both.ref.serve()
    both.assert_same(pair)
    reqs = pair[0]
    assert {r.status for r in reqs} <= {"done", "failed"}
    assert sum(r.status == "failed" for r in reqs) == \
        both.port.stats()["failed"]
    assert sum(r.status == "done" for r in reqs) == sum(
        e.stats()["n_requests"] for e in both.engines)


def test_slow_replica_is_marked_and_avoided():
    """A drain past ``attempt_timeout_s`` (on a clock that each drain
    advances) counts a timeout, marks the replica slow, and round-robin
    then prefers the other."""
    t = [0.0]

    def clock():
        t[0] += 1.0
        return t[0]

    retry = ft.RetryPolicy(attempt_timeout_s=0.5)
    routers = []
    for mod, make in ((engine, _engine), (jengine, _jengine)):
        engines = [make(), make()]
        r = mod.FaultAwareRouter(
            engines, clock=clock,
            retry=retry if mod is engine else jft.RetryPolicy(
                attempt_timeout_s=0.5))
        reqs = [mod.SpikeRequest(spikes=s) for s in _spikes(4)]
        r.serve(reqs[:2])
        r.serve(reqs[2:])
        routers.append(r)
    st_, jst = (r.stats() for r in routers)
    assert st_["timeouts"] == jst["timeouts"] > 0
    assert st_["slow"] == jst["slow"] and st_["routed"] == jst["routed"]


# ----------------------------------------------------------------------- #
# run_open_loop
# ----------------------------------------------------------------------- #
class FakeClock:
    """Time that only ``run_open_loop``'s sleeps (and stalls) advance."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.t += s


#: report fields read from the clock: equal under a shared fake clock
_REPORT_KEYS = ("n_offered", "n_completed", "n_shed", "n_rejected",
                "n_failed", "n_deadline_miss", "retries", "crashes",
                "timeouts", "degraded_routes", "backpressure_events",
                "ladder_transitions", "max_degradation_level", "goodput_slo",
                "p50_ms", "p99_ms", "duration_s")


@pytest.mark.parametrize("scenario", ["router_chaos", "storm_queue",
                                      "deadline"])
def test_open_loop_report_matches_reference(scenario):
    reports = []
    for mod, tmod, make in ((engine, traffic, _engine),
                            (jengine, jtraffic, _jengine)):
        clk = FakeClock()
        cfg_kw = dict(rate_hz=5000.0, n_requests=32, seed=23, n_in=N_IN)
        chaos = None
        if scenario == "router_chaos":
            engines = [make(), make()]
            rp = (ft if mod is engine else jft).RetryPolicy(
                max_attempts=4, base_backoff_s=1e-4, seed=7)
            server = mod.FaultAwareRouter(engines, retry=rp, clock=clk,
                                          sleep=clk.sleep)
            chaos = tmod.ChaosConfig(slowdown=((1, 0.01),), crash_replica=0,
                                     crash_after_rounds=1)
        elif scenario == "storm_queue":
            server = make(queue_limit=8, clock=clk)
            cfg_kw.update(rate_hz=500.0, n_requests=8, seed=13,
                          deadline_s=5.0, p_event=0.25)
            chaos = tmod.ChaosConfig(storm_at_s=0.0, storm_size=64)
        else:
            server = make(clock=clk)
            tmod.install_chaos([server], tmod.ChaosConfig(
                slowdown=((0, 0.05),)), sleep=clk.sleep)
            cfg_kw.update(rate_hz=400.0, n_requests=40, seed=17,
                          deadline_s=0.001)
        rep = tmod.run_open_loop(server, tmod.TrafficConfig(**cfg_kw),
                                 chaos=chaos, clock=clk, sleep=clk.sleep,
                                 max_wall_s=60.0)
        reports.append(rep)
    got, want = reports
    for key in _REPORT_KEYS:
        assert getattr(got, key) == getattr(want, key), key
    assert got.metrics is None
    if scenario == "router_chaos":
        assert got.n_completed == 32 and got.crashes == 1 and got.retries > 0
    elif scenario == "storm_queue":
        assert got.n_rejected > 0 and got.backpressure_events > 0
        assert got.n_completed + got.n_shed + got.n_rejected == 72
    else:
        assert got.n_shed > 0 and got.n_completed + got.n_shed == 40


def test_open_loop_completes_everything_below_saturation():
    eng = _engine()
    cfg = traffic.TrafficConfig(rate_hz=2000.0, n_requests=24, seed=11,
                                n_in=N_IN, p_event=0.25)
    schedule = traffic.build_requests(cfg)
    rep = traffic.run_open_loop(eng, cfg, schedule=schedule,
                                max_wall_s=60.0)
    assert rep.n_offered == 24 and rep.n_completed == 24
    assert rep.n_shed == rep.n_rejected == rep.n_failed == 0
    assert 0.0 < rep.p50_ms <= rep.p99_ms <= rep.p999_ms
    assert rep.goodput_slo == 1.0 and rep.duration_s < 60.0
    assert all(r.logits is not None for r in schedule[0])
    d = rep.to_dict()
    assert d["n_completed"] == 24 and "p999_ms" in d


def test_warmup_engine_warms_every_replica():
    engines = [_engine(), _engine()]
    router = FaultAwareRouter(engines)
    cfg = traffic.TrafficConfig(rate_hz=1.0, n_requests=4, n_in=N_IN,
                                p_event=0.5, event_t_choices=(2, 3))
    got = traffic.warmup_engine(router, cfg, aot=False)
    assert sorted(got) == [0, 1]
    for times in got.values():
        assert "event_t2" in times and "event_t3" in times
        assert times["graphs"] == 0


# ----------------------------------------------------------------------- #
# the launcher's --traffic mode
# ----------------------------------------------------------------------- #
def test_launcher_traffic_chaos_on_the_cpu(capsys):
    from repro_torch.launch import serve as serve_mod

    run = serve_mod.main(["--traffic", "--smoke", "--replicas", "2",
                          "--chaos", "--device", "cpu"])
    rep = run.report
    assert rep.crashes == 1 and rep.retries > 0
    assert rep.n_offered == 64 + 2 * 32 == len(run.requests)
    assert rep.n_failed == 0
    assert rep.n_completed + rep.n_shed + rep.n_rejected == rep.n_offered
    assert all(r.status != "pending" for r in run.requests)
    assert isinstance(run.server, FaultAwareRouter)
    assert run.server.stats()["down"] == [0]
    # every completed logit equals a clean replay at the steps it was
    # served (a degraded ladder level may cut an event stream)
    replay = SpikeEngine(run.net, max_batch=32, device="cpu")
    done = [r for r in run.requests if r.logits is not None]
    clones = []
    for r in done:
        if isinstance(r, engine.EventRequest):
            clones.append(engine.EventRequest(
                events=np.asarray(r.events)[: r.served_steps]))
        else:
            clones.append(SpikeRequest(spikes=r.spikes))
    replay.serve(clones)
    for a, b in zip(done, clones):
        np.testing.assert_array_equal(a.logits, b.logits)
    out = capsys.readouterr().out
    assert "esam-traffic: offered 128 requests" in out
    assert "crashes 1" in out
