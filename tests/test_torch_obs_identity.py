"""The port's observability plane: the off path is the instrumented path
bit for bit, and the instrumented path emits what the reference's emits.

Property (hypothesis, the twin of ``tests/test_obs_identity.py``): for any
request blend and engine configuration (the fused drain, the packer thread,
telemetry on or off) an engine built with ``observability=None`` produces
exactly the outputs and ``stats()`` of one built with tracing and metrics
on.  Wall-clock stats keys are left out: they measure the host's timing.

Cross-package: the same requests and one stepping clock (every read
advances it by a fixed step) go into the reference's
``SpikeEngine(interpret=True, observability=...)`` and the port's; the
registry snapshots agree in every series (histograms of wall time by
count), and the trace events agree in order by name, phase, category, id
and args.  The same for ``train_online`` at a small size and for
``run_open_loop``'s counters under a fake clock.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.obs import Observability as JObservability
from repro.obs.metrics import Registry as JRegistry
from repro.obs.trace import Tracer as JTracer
from repro.serve import engine as jengine
from repro.serve import traffic as jtraffic
from repro.train import fault_tolerance as jft
from repro.train import online as jonline
from repro_torch.obs import Observability, Registry, Tracer
from repro_torch.obs.trace import validate_trace
from repro_torch.serve import engine, traffic
from repro_torch.serve.engine import SpikeEngine
from repro_torch.train import fault_tolerance as ft
from repro_torch.train import online

from test_torch_async_serve import (_assert_same_results, _mixed, _net,
                                    _nets)
from test_torch_online import _fixture

#: stats keys that are functions of host wall time, not of the datapath
_WALL_CLOCK_KEYS = frozenset(
    {"host_pack_s_total", "dispatch_s_total", "straggler_rounds"})


def _comparable(stats: dict) -> dict:
    return {k: v for k, v in stats.items() if k not in _WALL_CLOCK_KEYS}


def _serve(reqs, *, observability, fuse, overlap, telemetry):
    eng = SpikeEngine(_net(), device="cpu", max_batch=8, telemetry=telemetry,
                      fuse_rounds=fuse, overlap=overlap,
                      observability=observability)
    eng.serve(reqs)
    st_ = eng.stats()
    eng.close()
    return st_


@settings(max_examples=10, deadline=None)
@given(n_static=st.integers(0, 24),
       n_ev2=st.integers(0, 6),
       n_ev4=st.integers(0, 6),
       fuse=st.sampled_from([None, 2, "auto"]),
       overlap=st.booleans(),
       telemetry=st.booleans(),
       seed=st.integers(0, 3))
def test_observability_off_path_is_bit_identical(
        n_static, n_ev2, n_ev4, fuse, overlap, telemetry, seed):
    spec = [(n_ev2, 2), (n_ev4, 4)]
    base_reqs = _mixed(n_static, spec, seed=seed)
    obs_reqs = _mixed(n_static, spec, seed=seed)
    st_base = _serve(base_reqs, observability=None, fuse=fuse,
                     overlap=overlap, telemetry=telemetry)
    obs = Observability.enabled(registry=Registry())
    st_obs = _serve(obs_reqs, observability=obs, fuse=fuse,
                    overlap=overlap, telemetry=telemetry)
    _assert_same_results(obs_reqs, base_reqs)
    assert _comparable(st_obs) == _comparable(st_base)
    assert validate_trace(obs.tracer.export())[
        "request_close_fraction"] == 1.0


def test_observability_off_engine_holds_no_instruments():
    eng = SpikeEngine(_net(), device="cpu", max_batch=8)
    assert eng._obs is None and eng._tracer is None and eng._m is None
    assert eng._metrics is None and eng._profiler is None
    eng.serve(_mixed(4, [(2, 2)]))
    assert eng._req_spans == {}


def test_tracer_only_and_metrics_only_lanes_are_also_inert():
    want = _mixed(8, [(3, 2)], seed=9)
    _serve(want, observability=None, fuse="auto", overlap=True,
           telemetry=True)
    for bundle in (Observability(tracer=Tracer()),
                   Observability(metrics=Registry())):
        got = _mixed(8, [(3, 2)], seed=9)
        _serve(got, observability=bundle, fuse="auto", overlap=True,
               telemetry=True)
        _assert_same_results(got, want)


# ----------------------------------------------------------------------- #
# cross-package: the port's plane against the reference's
# ----------------------------------------------------------------------- #
class StepClock:
    """Every read returns the time and moves it on by ``dt``."""

    def __init__(self, dt: float = 1e-3):
        self.t, self.dt = 10.0, dt

    def __call__(self) -> float:
        t = self.t
        self.t += self.dt
        return t


#: the histograms whose observations are host wall time (perf_counter)
_WALL_HISTOGRAMS = ("esam_round_pack_seconds", "esam_round_dispatch_seconds",
                    "esam_train_epoch_seconds")
#: sums of float32 energies: the reference's jitted telemetry may add in
#: its own order, so the bound of the requests' energies (1e-6 relative)
_FLOAT32_SUMS = ("esam_energy_pj_total",)


def _assert_same_snapshot(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        assert g["type"] == w["type"], key
        if key in _FLOAT32_SUMS:
            assert g["value"] == pytest.approx(w["value"], rel=1e-6), key
        elif w["type"] != "histogram":
            assert g["value"] == w["value"], (key, g, w)
        elif key.split("{")[0] in _WALL_HISTOGRAMS:
            assert g["count"] == w["count"], key
        else:
            assert g == w, key


def _events(tracer) -> list[tuple]:
    return [(e["name"], e["ph"], e.get("cat"), e.get("id"), e.get("args"))
            for e in tracer.events()]


def _observed(mod):
    """A tracer on a stepping clock and a fresh registry, of ``mod``."""
    if mod is engine:
        return Observability(tracer=Tracer(clock=StepClock()),
                             metrics=Registry())
    return JObservability(tracer=JTracer(clock=StepClock()),
                          metrics=JRegistry())


@pytest.mark.parametrize("fuse,telemetry,queue_limit", [
    (None, True, None), (2, True, 12), (None, False, 6)])
def test_engine_spans_and_metrics_match_reference(fuse, telemetry,
                                                  queue_limit):
    runs = []
    jnet, net = _nets()
    for mod in (engine, jengine):
        obs = _observed(mod)
        kw = dict(max_batch=8, telemetry=telemetry, fuse_rounds=fuse,
                  queue_limit=queue_limit, observability=obs)
        eng = (mod.SpikeEngine(net, device="cpu", **kw) if mod is engine
               else mod.SpikeEngine(jnet, interpret=True, **kw))
        reqs = _mixed(14, [(3, 2), (2, 4)], seed=4, mod=mod)
        for r in reqs[:3]:
            r.deadline_s = -1.0          # expired on arrival: shed
        eng.submit(reqs)
        eng.serve()
        eng.serve(_mixed(5, [(1, 2)], seed=5, mod=mod))
        runs.append((obs, reqs, eng.stats()))
    (obs, reqs, st_), (jobs, jreqs, jst) = runs
    _assert_same_results(reqs, jreqs, exact=False)
    _assert_same_snapshot(obs.metrics.snapshot(), jobs.metrics.snapshot())
    assert _events(obs.tracer) == _events(jobs.tracer)
    assert validate_trace(obs.tracer.export()) == validate_trace(
        jobs.tracer.export())
    assert st_["shed_deadline"] == 3
    if queue_limit is not None:
        assert st_["rejected_full"] > 0


def test_engine_warmup_and_replan_instants_match_reference():
    jnet, net = _nets()
    got = []
    for mod in (engine, jengine):
        obs = _observed(mod)
        kw = dict(max_batch=8, telemetry=True, observability=obs)
        eng = (mod.SpikeEngine(net, device="cpu", **kw) if mod is engine
               else mod.SpikeEngine(jnet, interpret=True, **kw))
        eng.warmup(event_ts=(2,))
        eng.serve(_mixed(3, [], mod=mod))
        eng.replan_degraded(1)
        got.append(([(e["name"], {k: v for k, v in e.get("args", {}).items()
                                  if k != "total_s"})
                     for e in obs.tracer.events() if e["ph"] == "i"],
                    sorted(k for k in obs.metrics.snapshot()
                           if k.startswith("esam_warmup"))))
    assert got[0] == got[1]


def test_train_online_spans_and_metrics_match_reference():
    jnet, net, x, y = _fixture()
    jobs, obs = _observed(jengine), _observed(engine)
    jres = jonline.train_online(jnet, jnp.asarray(x).astype(bool),
                                jnp.asarray(y), key=jax.random.PRNGKey(5),
                                epochs=3, p_pot=0.2, p_dep=0.1, shuffle=True,
                                observability=jobs)
    from repro_torch.core import prng

    res = online.train_online(net, x, y, key=prng.PRNGKey(5), epochs=3,
                              p_pot=0.2, p_dep=0.1, shuffle=True,
                              observability=obs)
    assert res.accuracy == [float(a) for a in jres.accuracy]
    _assert_same_snapshot(obs.metrics.snapshot(), jobs.metrics.snapshot())
    assert _events(obs.tracer) == _events(jobs.tracer)
    spans = [e for e in obs.tracer.events() if e["name"] == "train_epoch"]
    assert [s["args"]["epoch"] for s in spans] == [0, 1, 2]
    assert obs.metrics.get("esam_train_epochs_total").value == 3
    assert (obs.metrics.get("esam_train_column_updates_total").value
            == sum(res.n_updates))
    # the plane is inert: the same bits as a run without it
    plain = online.train_online(net, x, y, key=prng.PRNGKey(5), epochs=3,
                                p_pot=0.2, p_dep=0.1, shuffle=True)
    assert torch.equal(plain.network.weight_bits[-1],
                       res.network.weight_bits[-1])


class FakeClock:
    """Time that only ``run_open_loop``'s sleeps (and stalls) advance."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.t += s


@pytest.mark.parametrize("scenario", ["router_chaos", "storm_queue"])
def test_open_loop_counters_match_reference(scenario):
    jnet, net = _nets()
    reports = []
    for mod, tmod, ftmod in ((engine, traffic, ft),
                             (jengine, jtraffic, jft)):
        clk = FakeClock()
        obs = (Observability(tracer=Tracer(clock=clk), metrics=Registry())
               if mod is engine else
               JObservability(tracer=JTracer(clock=clk),
                              metrics=JRegistry()))

        def make(**kw):
            kw.update(max_batch=8, observability=obs, telemetry=True)
            return (mod.SpikeEngine(net, device="cpu", **kw)
                    if mod is engine
                    else mod.SpikeEngine(jnet, interpret=True, **kw))

        cfg_kw = dict(rate_hz=5000.0, n_requests=32, seed=23, n_in=128)
        if scenario == "router_chaos":
            server = mod.FaultAwareRouter(
                [make(), make()], observability=obs, clock=clk,
                sleep=clk.sleep, health_threshold=0.0,
                retry=ftmod.RetryPolicy(max_attempts=4, base_backoff_s=1e-4,
                                        seed=7))
            chaos = tmod.ChaosConfig(slowdown=((1, 0.01),), crash_replica=0,
                                     crash_after_rounds=1)
        else:
            server = make(queue_limit=8, clock=clk)
            cfg_kw.update(rate_hz=500.0, n_requests=8, seed=13,
                          deadline_s=5.0, p_event=0.25)
            chaos = tmod.ChaosConfig(storm_at_s=0.0, storm_size=64)
        rep = tmod.run_open_loop(server, tmod.TrafficConfig(**cfg_kw),
                                 chaos=chaos, observability=obs, clock=clk,
                                 sleep=clk.sleep, max_wall_s=60.0)
        reports.append((rep, obs))
    (rep, obs), (jrep, jobs) = reports
    assert rep.metrics is not None and jrep.metrics is not None
    assert set(rep.metrics) == set(jrep.metrics)
    for key, w in jrep.metrics.items():
        if key in _FLOAT32_SUMS:
            assert rep.metrics[key]["value"] == pytest.approx(
                w["value"], rel=1e-6), key
        elif w["type"] == "counter":
            assert rep.metrics[key]["value"] == w["value"], key
    ends = [(e["name"], e["args"]) for e in obs.tracer.events()
            if e["name"].startswith("traffic_")]
    jends = [(e["name"], e["args"]) for e in jobs.tracer.events()
             if e["name"].startswith("traffic_")]
    assert ends == jends and len(ends) == 2
    sub = rep.metrics["esam_requests_submitted_total"]["value"]
    if scenario == "router_chaos":
        assert rep.crashes == 1 and rep.retries > 0
        # a crashed replica's victims are admitted twice
        assert sub == rep.n_offered - rep.n_rejected + rep.retries
        assert (rep.metrics["esam_router_retries_total"]["value"]
                == rep.retries)
        # the port closes the crashed attempts' spans; the reference
        # leaves them open
        assert validate_trace(obs.tracer.export())[
            "request_close_fraction"] == 1.0
        jsum = validate_trace(jobs.tracer.export())
        assert jsum["request_closed"] == jsum["request_begun"] - rep.retries
    else:
        assert sub == rep.n_offered - rep.n_rejected
        assert rep.n_rejected > 0


def test_traffic_report_carries_no_metrics_without_the_plane():
    eng = SpikeEngine(_net(), device="cpu", max_batch=8)
    cfg = traffic.TrafficConfig(rate_hz=2000.0, n_requests=6, seed=1,
                                n_in=128)
    rep = traffic.run_open_loop(eng, cfg, max_wall_s=60.0,
                                observability=Observability(
                                    tracer=Tracer()))
    assert rep.metrics is None and rep.n_completed == 6
