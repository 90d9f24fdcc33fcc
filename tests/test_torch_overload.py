"""repro_torch's overload plane against the reference's, on the CPU: the
twins of ``tests/test_overload.py``'s engine tests (bounded admission,
backpressure, deadlines, the degradation ladder, the per-round counters,
the zero-pressure identity and mixed serving), each scenario run on the
port's ``SpikeEngine`` and on the reference's under the same deterministic
``clock``, then held together: statuses, logits and labels bit for bit,
served steps, and every ``stats()`` key that no host wall time feeds.
Where a ladder is on, both engines get a watchdog that never flags, so
pressure is queue depth alone in both.  Also ``serve/overload.py`` and
``train/fault_tolerance.StragglerWatchdog`` against the reference's."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core.esam.network import EsamNetwork as JaxNetwork
from repro.serve import engine as jengine
from repro.serve import overload as joverload
from repro.train import fault_tolerance as jft
from repro_torch.core import packing
from repro_torch.core.esam.network import EsamNetwork
from repro_torch.serve import engine, overload
from repro_torch.train import fault_tolerance as ft

TOPO = (128, 128, 10)
#: stats keys read from host wall times: present in both, comparable in none
WALL_KEYS = {"host_pack_s_total", "dispatch_s_total", "straggler_rounds"}


def _nets(topo=TOPO, seed=0):
    rng = np.random.default_rng(seed)
    bits = [rng.integers(0, 2, size=(k, n), dtype=np.int8)
            for k, n in zip(topo[:-1], topo[1:])]
    vth = [np.zeros((n,), np.int32) for n in topo[1:]]
    off = np.zeros((topo[-1],), np.float32)
    ref = JaxNetwork([jnp.asarray(b) for b in bits],
                     [jnp.asarray(v) for v in vth], jnp.asarray(off))
    return ref, EsamNetwork.from_numpy(bits, vth, off, device="cpu")


_NETS = {}


def _pair_nets():
    if "nets" not in _NETS:
        _NETS["nets"] = _nets()
    return _NETS["nets"]


def _spikes(n, n_in=128, seed=0):
    return [(np.random.default_rng((seed, i)).random(n_in) < 0.3)
            .astype(np.uint8) for i in range(n)]


def _events(n, t, n_in=128, seed=100):
    return [(np.random.default_rng((seed, i)).random((t, n_in)) < 0.3)
            .astype(np.uint8) for i in range(n)]


class Both:
    """One scenario on both engines: ``port`` and ``ref`` share every
    keyword (the reference's in interpret mode), a clock each that reads
    the same ``t`` list."""

    def __init__(self, ladder=None, watchdog=False, **kw):
        ref_net, net = _pair_nets()
        self.t = [0.0]
        clock = lambda: self.t[0]  # noqa: E731
        pkw, rkw = dict(kw), dict(kw)
        if ladder is not None:
            pkw["ladder"] = ladder(overload)
            rkw["ladder"] = ladder(joverload)
        if watchdog:
            pkw["watchdog"] = ft.StragglerWatchdog(threshold=1e9)
            rkw["watchdog"] = jft.StragglerWatchdog(threshold=1e9)
        self.port = engine.SpikeEngine(net, clock=clock, device="cpu", **pkw)
        self.ref = jengine.SpikeEngine(ref_net, clock=clock, interpret=True,
                                       **rkw)

    def static(self, spikes):
        return ([engine.SpikeRequest(spikes=s) for s in spikes],
                [jengine.SpikeRequest(spikes=s) for s in spikes])

    def events(self, streams):
        return ([engine.EventRequest(events=e) for e in streams],
                [jengine.EventRequest(events=e) for e in streams])

    def serve(self, pair=None):
        if pair is None:
            self.port.serve()
            self.ref.serve()
            return
        self.port.serve(pair[0])
        self.ref.serve(pair[1])

    def assert_same(self, pair):
        for r, q in zip(*pair):
            assert r.status == q.status
            assert getattr(r, "served_steps", None) == getattr(
                q, "served_steps", None)
            if q.logits is None:
                assert r.logits is None
                continue
            np.testing.assert_array_equal(r.logits, np.asarray(q.logits))
            assert r.label == q.label
        self.assert_stats()

    def assert_stats(self):
        st_, ref_st = self.port.stats(), self.ref.stats()
        assert set(st_) == set(ref_st)
        for key in set(st_) - WALL_KEYS:
            if isinstance(ref_st[key], float):
                assert st_[key] == pytest.approx(ref_st[key], rel=1e-6), key
            else:
                assert st_[key] == ref_st[key], key


# ----------------------------------------------------------------------- #
# overload.py and the watchdog are copies
# ----------------------------------------------------------------------- #
@pytest.mark.parametrize("max_batch,read_ports", [(128, 4), (8, 2), (100, 1)])
def test_default_ladder_matches_reference(max_batch, read_ports):
    got = overload.DegradationLadder.default(max_batch, read_ports)
    want = joverload.DegradationLadder.default(max_batch, read_ports)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.n_levels == want.n_levels
    for i in (-1, 0, 2, 9):
        assert got.level(i).name == want.level(i).name
    assert engine.AdmissionVerdict is overload.AdmissionVerdict
    assert [f.name for f in dataclasses.fields(overload.AdmissionVerdict)] \
        == [f.name for f in dataclasses.fields(joverload.AdmissionVerdict)]


def test_watchdog_flags_the_reference_rounds():
    walls = [0.01, 0.012, 0.011, 0.01, 0.05, 0.01, 0.3, 0.009, 0.02, 0.2]
    seen, jseen = [], []
    dog = ft.StragglerWatchdog(on_straggler=lambda *a: seen.append(a))
    jdog = jft.StragglerWatchdog(on_straggler=lambda *a: jseen.append(a))
    for i, w in enumerate(walls):
        dog.record(i, w)
        jdog.record(i, w)
    assert dog.flagged == jdog.flagged and seen == jseen and dog.flagged
    assert dog._ema == jdog._ema


# ----------------------------------------------------------------------- #
# bounded admission queue + backpressure
# ----------------------------------------------------------------------- #
def test_bounded_queue_rejects_and_counts():
    b = Both(max_batch=8, queue_limit=4)
    pair = b.static(_spikes(7))
    verdicts = b.port.submit(pair[0])
    jverdicts = b.ref.submit(pair[1])
    assert [dataclasses.asdict(v) for v in verdicts] == [
        dataclasses.asdict(v) for v in jverdicts]
    assert [v.admitted for v in verdicts] == [True] * 4 + [False] * 3
    assert all(r.status == "rejected" for r in pair[0][4:])
    assert b.port.queue_depth() == b.ref.queue_depth() == 4
    b.serve()
    assert b.port.stats()["rejected_full"] == 3
    assert b.port.stats()["n_requests"] == 4
    b.assert_same(pair)


def test_backpressure_past_high_water():
    b = Both(max_batch=8, queue_limit=8, high_water=2)
    pair = b.static(_spikes(5))
    verdicts, jverdicts = b.port.submit(pair[0]), b.ref.submit(pair[1])
    assert [v.backpressure for v in verdicts] == [
        v.backpressure for v in jverdicts] == [False, False, True, True, True]
    b.assert_stats()
    assert b.port.stats()["backpressure_events"] == 3
    b2 = Both(queue_limit=8)
    assert b2.port.stats()["high_water"] == b2.ref.stats()["high_water"] == 4


def test_unbounded_queue_always_admits():
    b = Both(max_batch=8)
    pair = b.static(_spikes(40))
    verdicts = b.port.submit(pair[0])
    b.ref.submit(pair[1])
    assert all(v.admitted and not v.backpressure for v in verdicts)
    single = b.port.submit(engine.SpikeRequest(spikes=_spikes(1)[0]))
    assert isinstance(single, engine.AdmissionVerdict) and single.admitted
    b.ref.submit(jengine.SpikeRequest(spikes=_spikes(1)[0]))
    b.assert_stats()


# ----------------------------------------------------------------------- #
# per-request deadlines
# ----------------------------------------------------------------------- #
def test_deadline_shed_counted_and_terminal():
    b = Both(max_batch=8)
    pair = b.static(_spikes(6))
    for reqs in pair:
        reqs[1].deadline_s = -1.0          # already expired
        reqs[4].deadline_s = 100.0         # far future
    b.serve(pair)
    assert pair[0][1].status == "shed" and pair[0][1].logits is None
    assert pair[0][4].status == "done"
    assert b.port.stats()["shed_deadline"] == 1
    assert b.port.stats()["n_requests"] == 5
    b.assert_same(pair)


def test_deadline_expiring_mid_drain_sheds_later_round():
    """The clock advances one unit per dispatch round; a deadline of 0.5
    sheds everything not dispatched in the first round."""
    b = Both(max_batch=4)
    for eng in (b.port, b.ref):
        orig = eng._dispatch

        def advancing(reqs, orig=orig):
            orig(reqs)
            b.t[0] += 1.0

        eng._dispatch = advancing
        b.t[0] = 0.0
        reqs = (engine.SpikeRequest if eng is b.port
                else jengine.SpikeRequest)
        served = [reqs(spikes=s, deadline_s=0.5) for s in _spikes(10)]
        eng.serve(served)
        assert [r.status for r in served] == ["done"] * 4 + ["shed"] * 6
        assert eng.stats()["shed_deadline"] == 6
    b.assert_stats()


def test_event_requests_shed_on_deadline_too():
    b = Both(max_batch=8)
    pair = b.events(_events(3, t=2))
    for reqs in pair:
        reqs[0].deadline_s = -1.0
    b.serve(pair)
    assert pair[0][0].status == "shed"
    assert all(r.status == "done" for r in pair[0][1:])
    b.assert_same(pair)


# ----------------------------------------------------------------------- #
# degradation ladder
# ----------------------------------------------------------------------- #
def _pressure_ladder(**kw):
    return lambda mod: mod.DegradationLadder(levels=(
        mod.LadderLevel("full"),
        mod.LadderLevel("reduced", event_t_cap=2, read_ports=2, bucket_cap=4),
    ), **kw)


def test_ladder_steps_down_on_queue_depth_and_back_up():
    b = Both(max_batch=4, high_water=4, watchdog=True, telemetry=True,
             ladder=_pressure_ladder(step_down_after=2, step_up_after=2))
    pair = b.static(_spikes(24))
    b.serve(pair)
    st_ = b.port.stats()
    assert st_["ladder_transitions"] >= 1
    log = st_["ladder_transition_log"]
    assert log[0]["from"] == "full" and log[0]["to"] == "reduced"
    assert log[0]["reason"] == "queue_depth"
    b.assert_same(pair)
    for _ in range(3):
        quiet = b.static(_spikes(2, seed=7))
        b.serve(quiet)
        b.assert_same(quiet)
    st2 = b.port.stats()
    assert st2["degradation_level"] == 0
    assert st2["ladder_transition_log"][-1]["reason"] == "pressure_cleared"
    for r, q in zip(*pair):           # costed at each round's ports
        assert r.cycles == q.cycles
        assert r.energy_pj == pytest.approx(q.energy_pj, rel=1e-6)


def test_degraded_level_truncates_event_streams():
    b = Both(max_batch=4, high_water=1, watchdog=True,
             ladder=_pressure_ladder(step_down_after=1, step_up_after=50))
    pair = b.events(_events(10, t=4))
    b.serve(pair)
    served = [r for r in pair[0] if r.status == "done"]
    assert served
    assert b.port.stats()["degradation_level"] == 1
    assert any(r.served_steps == 2 for r in served)
    assert all(r.served_steps in (2, 4) for r in served)
    b.assert_same(pair)


def test_degraded_level_caps_round_size():
    b = Both(max_batch=16, min_bucket=4, high_water=1, watchdog=True,
             ladder=_pressure_ladder(step_down_after=1, step_up_after=50))
    pair = b.static(_spikes(32))
    b.serve(pair)
    st_ = b.port.stats()
    assert st_["degradation_level"] == 1
    assert 4 in st_["rounds_per_bucket"]
    b.assert_same(pair)


def test_no_ladder_means_pinned_full_service():
    b = Both(max_batch=4, high_water=1)
    pair = b.static(_spikes(20))
    b.serve(pair)
    st_ = b.port.stats()
    assert st_["degradation_level"] == 0 and st_["ladder_transitions"] == 0
    assert st_["degradation_level_name"] == "full"
    b.assert_same(pair)


# ----------------------------------------------------------------------- #
# per-round counters
# ----------------------------------------------------------------------- #
def test_round_counters_track_padding_and_times():
    b = Both(max_batch=8, min_bucket=8)
    pair = b.static(_spikes(11))
    b.serve(pair)
    st_ = b.port.stats()
    assert st_["rounds_static"] == 2 and st_["rounds_event"] == 0
    assert st_["rows_padded_total"] == 5
    assert st_["rounds_per_bucket"] == {8: 2}
    assert st_["host_pack_s_total"] > 0.0
    assert st_["dispatch_s_total"] > 0.0
    b.assert_same(pair)
    ev = b.events(_events(3, t=2))
    b.serve(ev)
    assert b.port.stats()["rounds_event"] == 1
    assert b.port.stats()["rows_real_total"] == 14
    b.assert_same(ev)


# ----------------------------------------------------------------------- #
# zero-pressure identity + mixed serving
# ----------------------------------------------------------------------- #
@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 2 ** 16), n=st.integers(1, 20))
def test_zero_pressure_identity_vs_raw_plan(seed, n):
    """No deadline, unbounded queue, no ladder: the engine's results are
    the raw packed plan's on the same padded bucket, and the reference
    engine's."""
    b = Both(max_batch=16)
    pair = b.static(_spikes(n, seed=seed))
    b.serve(pair)
    first = pair[0][:16]
    bucket = b.port._bucket(len(first))
    packed = packing.pack_padded_rows_np([r.spikes for r in first], bucket,
                                         128)
    want = b.port.net.plan(mode="packed")(
        packing.words_from_np(packed)).logits.numpy()
    for i, r in enumerate(first):
        np.testing.assert_array_equal(r.logits, want[i])
        assert r.status == "done"
    b.assert_same(pair)


def test_mixed_static_event_serve_preserves_order_and_results():
    b = Both(max_batch=8)
    statics, events = b.static(_spikes(3, seed=1)), b.events(
        _events(3, t=2, seed=2))
    for k in (0, 1):
        s, e = statics[k], events[k]
        mixed = [s[0], e[0], s[1], e[1], s[2], e[2]]
        eng = b.port if k == 0 else b.ref
        out = eng.serve(list(mixed))
        assert [id(r) for r in out] == [id(r) for r in mixed]
    for r in events[0]:
        assert r.served_steps == 2
        assert r.label == int(np.asarray(r.logits).argmax())
    b.assert_same(statics)
    b.assert_same(events)
