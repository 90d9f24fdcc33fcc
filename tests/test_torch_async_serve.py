"""repro_torch's fused and overlapped drain, warmup and the packer ring on
the CPU: the twins of ``tests/test_async_serve.py`` (but its dp8
subprocess: the port has no mesh yet).  The fused, overlapped drain equals
the port's synchronous one bit for bit, telemetry included, and the
reference's synchronous drain on the same network (logits, labels and
cycles exactly; energies within 1e-6 relative: the reference's jitted
float32 telemetry may sum in its own order).  Also the fused counters,
deadlines under fusion, the ladder capping fusion, the packer thread never
calling torch, ``close``, warmup's times and buckets (on the CPU it runs
every shape once and captures no graph), and the host-slot ring over
rounds of every size.  The card's graphs are held in
``tests/test_torch_serve_cuda.py``."""

from __future__ import annotations

import threading

import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core.esam.network import EsamNetwork as JaxNetwork
from repro.serve import engine as jengine
from repro_torch.core.esam.network import EsamNetwork
from repro_torch.serve import engine
from repro_torch.serve.overload import DegradationLadder

TOPO = (128, 128, 10)
_TELEMETRY_FIELDS = ("cycles", "latency_ns", "energy_pj",
                     "energy_pj_per_step")
_NETS = {}


def _nets():
    """The reference's and the port's network from the same numpy bits."""
    if "nets" not in _NETS:
        rng = np.random.default_rng(0)
        bits = [rng.integers(0, 2, size=(k, n), dtype=np.int8)
                for k, n in zip(TOPO[:-1], TOPO[1:])]
        vth = [np.zeros((n,), np.int32) for n in TOPO[1:]]
        off = np.zeros((TOPO[-1],), np.float32)
        _NETS["nets"] = (
            JaxNetwork([jnp.asarray(b) for b in bits],
                       [jnp.asarray(v) for v in vth], jnp.asarray(off)),
            EsamNetwork.from_numpy(bits, vth, off, device="cpu"))
    return _NETS["nets"]


def _net():
    return _nets()[1]


def _spike_reqs(n, n_in=128, seed=0, mod=engine):
    return [mod.SpikeRequest(spikes=(np.random.default_rng((seed, i))
                                     .random(n_in) < 0.3).astype(np.uint8))
            for i in range(n)]


def _event_reqs(n, t, n_in=128, seed=100, mod=engine):
    return [mod.EventRequest(events=(np.random.default_rng((seed, i))
                                     .random((t, n_in)) < 0.3)
                             .astype(np.uint8))
            for i in range(n)]


def _mixed(n_static, event_spec, seed=0, mod=engine):
    reqs = _spike_reqs(n_static, seed=seed, mod=mod)
    for j, (n, t) in enumerate(event_spec):
        reqs += _event_reqs(n, t, seed=seed + 1000 + j, mod=mod)
    return reqs


def _assert_same_results(got, want, exact=True):
    """``exact``: telemetry bit for bit (two port drains); else the
    reference's bound (cycles exact, the rest within 1e-6 relative)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.status == w.status, (g.status, w.status)
        assert getattr(g, "served_steps", None) == getattr(
            w, "served_steps", None)
        if w.logits is None:
            assert g.logits is None
            continue
        np.testing.assert_array_equal(g.logits, np.asarray(w.logits))
        assert g.label == w.label
        for f in _TELEMETRY_FIELDS:
            gv, wv = getattr(g, f, None), getattr(w, f, None)
            if wv is None:
                assert gv is None, f
            elif exact or f == "cycles":
                assert gv == wv, f
            else:
                assert gv == pytest.approx(wv, rel=1e-6), f


# ----------------------------------------------------------------------- #
# the zero-pressure property: fused, overlapped drain == synchronous drain
# ----------------------------------------------------------------------- #
@settings(max_examples=8, deadline=None)
@given(n_static=st.integers(0, 40),
       n_ev2=st.integers(0, 9),
       n_ev4=st.integers(0, 9),
       fuse=st.sampled_from([2, 4, "auto"]),
       overlap=st.booleans(),
       seed=st.integers(0, 3))
def test_fused_drain_bit_identical_to_sync(n_static, n_ev2, n_ev4, fuse,
                                           overlap, seed):
    """Under zero pressure the fused (+ overlapped) drain serves mixed
    static/event traffic bit-identically to the synchronous drain, logits,
    labels and per-request telemetry, and within the reference's bound of
    the reference's synchronous drain."""
    ref_net, net = _nets()
    spec = [(n_ev2, 2), (n_ev4, 4)]
    sync = engine.SpikeEngine(net, max_batch=8, telemetry=True, device="cpu")
    a = _mixed(n_static, spec, seed=seed)
    sync.serve(a)
    fused = engine.SpikeEngine(net, max_batch=8, telemetry=True,
                               fuse_rounds=fuse, overlap=overlap,
                               device="cpu")
    b = _mixed(n_static, spec, seed=seed)
    fused.serve(b)
    _assert_same_results(b, a)
    ref = jengine.SpikeEngine(ref_net, interpret=True, max_batch=8,
                              telemetry=True)
    c = _mixed(n_static, spec, seed=seed, mod=jengine)
    ref.serve(c)
    _assert_same_results(b, c, exact=False)

    ss, fs, rs = sync.stats(), fused.stats(), ref.stats()
    for key in ("n_requests", "cycles_mean", "latency_ns_mean",
                "energy_pj_per_inf", "n_event_requests", "timesteps_total",
                "event_cycles_mean", "energy_pj_per_timestep",
                "tile_health"):
        assert ss[key] == fs[key], key
        assert fs[key] == pytest.approx(rs[key], rel=1e-6), key
    fused.close()


def test_fused_overlapped_drain_matches_reference_at_the_paper_topology():
    """The port's fused, overlapped drain (the launcher's defaults) against
    the reference's synchronous drain at 768:256:256:256:10."""
    topo = (768, 256, 256, 256, 10)
    rng = np.random.default_rng(5)
    bits = [rng.integers(0, 2, size=(k, n), dtype=np.int8)
            for k, n in zip(topo[:-1], topo[1:])]
    vth = [rng.integers(-3, 4, size=(n,), dtype=np.int32) for n in topo[1:]]
    off = rng.normal(size=(topo[-1],)).astype(np.float32)
    ref_net = JaxNetwork([jnp.asarray(b) for b in bits],
                         [jnp.asarray(v) for v in vth], jnp.asarray(off))
    net = EsamNetwork.from_numpy(bits, vth, off, device="cpu")
    eng = engine.SpikeEngine(net, max_batch=32, telemetry=True,
                             fuse_rounds="auto", overlap=True, device="cpu")
    ref = jengine.SpikeEngine(ref_net, max_batch=32, telemetry=True)
    got = (_spike_reqs(70, n_in=768, seed=2)
           + _event_reqs(9, 3, n_in=768, seed=3))
    want = (_spike_reqs(70, n_in=768, seed=2, mod=jengine)
            + _event_reqs(9, 3, n_in=768, seed=3, mod=jengine))
    eng.serve(got)
    ref.serve(want)
    _assert_same_results(got, want, exact=False)
    eng.close()


def test_fused_counters_and_rounds_saved():
    eng = engine.SpikeEngine(_net(), max_batch=8, fuse_rounds=4,
                             device="cpu")
    eng.serve(_spike_reqs(32))
    st_ = eng.stats()
    assert st_["rounds_static"] == 1
    assert st_["fused_rounds"] == 1
    assert st_["rounds_saved"] == 3
    assert st_["fuse_rounds"] == 4
    assert eng._buckets[-1] == 32
    eng.close()
    sync = engine.SpikeEngine(_net(), max_batch=8, device="cpu")
    sync.serve(_spike_reqs(32))
    st_ = sync.stats()
    assert st_["fused_rounds"] == 0 and st_["rounds_saved"] == 0
    assert st_["rounds_static"] == 4
    auto = engine.SpikeEngine(_net(), max_batch=8, fuse_rounds="auto",
                              device="cpu")
    assert auto.stats()["fuse_rounds"] == 1     # one device: dp 1
    with pytest.raises(ValueError):
        engine.SpikeEngine(_net(), fuse_rounds=0, device="cpu")


def test_stats_division_guards_under_fused_rounds():
    eng = engine.SpikeEngine(_net(), max_batch=8, fuse_rounds=4,
                             telemetry=True, device="cpu")
    st_ = eng.stats()
    assert st_["pad_fraction_per_bucket"] == {}
    for key in ("cycles_mean", "latency_ns_mean", "energy_pj_per_inf"):
        assert st_[key] == 0.0
    eng.serve(_spike_reqs(9))
    st_ = eng.stats()
    for bucket, frac in st_["pad_fraction_per_bucket"].items():
        assert 0.0 <= frac < 1.0, (bucket, frac)
        real = st_["real_rows_per_bucket"][bucket]
        padded = st_["padded_rows_per_bucket"][bucket]
        assert frac == padded / (padded + real)
    assert st_["rows_real_total"] == 9
    eng.close()


# ----------------------------------------------------------------------- #
# deadline / shed interleavings
# ----------------------------------------------------------------------- #
@settings(max_examples=6, deadline=None)
@given(expired=st.lists(st.integers(0, 19), min_size=0, max_size=8),
       fuse=st.sampled_from([1, 2, 4]),
       overlap=st.booleans())
def test_expired_deadlines_shed_identically_under_fusion(expired, fuse,
                                                         overlap):
    expired = set(expired)

    def run(fuse_arg, ov, mod=engine):
        t = [0.0]
        if mod is engine:
            eng = engine.SpikeEngine(_net(), max_batch=4, telemetry=True,
                                     fuse_rounds=fuse_arg, overlap=ov,
                                     clock=lambda: t[0], device="cpu")
        else:
            eng = jengine.SpikeEngine(_nets()[0], interpret=True,
                                      max_batch=4, telemetry=True,
                                      clock=lambda: t[0])
        reqs = _mixed(14, [(6, 2)], seed=5, mod=mod)
        for i in expired:
            reqs[i].deadline_s = -1.0
        eng.serve(reqs)
        st_ = eng.stats()
        eng.close()
        return reqs, st_

    a, sa = run(None, False)
    b, sb = run(fuse, overlap)
    c, sc = run(None, False, mod=jengine)
    _assert_same_results(b, a)
    _assert_same_results(b, c, exact=False)
    assert (sa["shed_deadline"] == sb["shed_deadline"] == sc["shed_deadline"]
            == len(expired))


@pytest.mark.parametrize("overlap", [False, True])
def test_mid_drain_deadline_sweep_still_runs_between_fused_rounds(overlap):
    t = [0.0]
    eng = engine.SpikeEngine(_net(), max_batch=4, fuse_rounds=2,
                             overlap=overlap, clock=lambda: t[0],
                             device="cpu")
    orig = eng._launch_static

    def advancing(reqs, bucket, packed, pack_s, **kw):
        orig(reqs, bucket, packed, pack_s, **kw)
        t[0] += 1.0

    eng._launch_static = advancing
    reqs = _spike_reqs(20)
    for r in reqs:
        r.deadline_s = 0.5
    eng.serve(reqs)
    done = [r for r in reqs if r.status == "done"]
    shed = [r for r in reqs if r.status == "shed"]
    if overlap:
        # the packer ring forms a second round before the first launches
        assert len(done) == 16 and len(shed) == 4
    else:
        assert len(done) == 8 and len(shed) == 12
    assert eng.stats()["shed_deadline"] == len(shed)
    eng.close()


# ----------------------------------------------------------------------- #
# warmup: every shape before the first request
# ----------------------------------------------------------------------- #
def test_warmup_times_and_buckets():
    eng = engine.SpikeEngine(_net(), max_batch=8, telemetry=True,
                             fuse_rounds=2, device="cpu")
    times = eng.warmup()
    assert set(times["static"]) == set(eng._buckets) == {8, 16}
    assert all(s >= 0.0 for s in times["static"].values())
    assert times["total_s"] > 0.0 and times["telemetry_s"] >= 0.0
    # on the CPU every shape runs once; no graph is captured
    assert times["graphs"] == 0 and eng.graph_counts() == {
        "captures": 0, "replays": 0}
    plan = eng._plan
    for b in eng._buckets:
        buf = plan.input_buffer(b)
        assert buf.shape == (b, 4) and not buf.any()
        assert plan.graph(b, 4) is None
    st_ = eng.stats()
    assert st_["n_requests"] == 0 and st_["dispatch_rounds"] == 0
    reqs = _spike_reqs(13)
    eng.serve(reqs)
    assert all(r.status == "done" for r in reqs)
    eng.close()


def test_warmup_covers_event_grid_and_ladder_caps():
    ladder = DegradationLadder.default(8)
    eng = engine.SpikeEngine(_net(), max_batch=8, telemetry=True,
                             ladder=ladder, queue_limit=64, device="cpu")
    times = eng.warmup(event_ts=(9, 3))
    # the ladder's event_t_cap rungs (8, 4, 2) join the grid
    assert {k for k in times if k.startswith("event_t")} == {
        f"event_t{t}" for t in (2, 3, 4, 8, 9)}
    for t in (2, 3, 4, 8, 9):
        plan = eng._event_plan(t)
        assert set(times[f"event_t{t}"]) == set(eng._buckets)
        assert plan.input_buffer(8).shape == (t, 8, 4)
    reqs = _event_reqs(5, t=2) + _event_reqs(4, t=3)
    eng.serve(reqs)
    assert all(r.status == "done" for r in reqs)
    eng.close()


def test_warmup_aot_false_runs_each_shape_once():
    eng = engine.SpikeEngine(_net(), max_batch=8, device="cpu")
    times = eng.warmup(aot=False)
    assert times["graphs"] == 0 and "telemetry_s" not in times
    assert not eng._plan._graphs
    reqs = _spike_reqs(3)
    eng.serve(reqs)
    assert all(r.status == "done" for r in reqs)
    eng.close()


def test_plan_warmup_returns_seconds_per_batch():
    plan = _net().plan(mode="packed", telemetry=True)
    times = plan.warmup([8, 32], epilogue=engine._stats_fn(TOPO, 4, False),
                        key=4)
    assert set(times) == {8, 32} and plan.captures == 0
    with pytest.raises(ValueError):
        plan.warmup([0])


def test_warmup_shares_stats_fn_with_serve():
    net = _net()
    eng = engine.SpikeEngine(net, max_batch=8, telemetry=True, device="cpu")
    eng.warmup()
    fn = engine._stats_fn(net.topology, eng._effective_read_ports(), False)
    assert eng._epilogue(4, False) is fn
    eng.serve(_spike_reqs(3))
    assert eng.stats()["n_requests"] == 3
    eng.close()


# ----------------------------------------------------------------------- #
# overlap machinery
# ----------------------------------------------------------------------- #
def test_overlap_packer_thread_never_calls_torch():
    """The packer thread runs numpy only: a profile hook on it sees no call
    into torch, and every launch runs on the caller's thread."""
    main = threading.get_ident()
    seen, torch_calls, packer_calls = [], [], []

    def prof(frame, event, arg):
        if not threading.current_thread().name.startswith("spike-packer"):
            return
        if event == "call":
            packer_calls.append(frame.f_code.co_name)
            mod = frame.f_globals.get("__name__", "")
        elif event == "c_call":
            mod = getattr(arg, "__module__", None) or ""
        else:
            return
        if mod.startswith("torch"):
            torch_calls.append((event, mod))

    eng = engine.SpikeEngine(_net(), max_batch=4, fuse_rounds=2,
                             telemetry=True, overlap=True, device="cpu")
    orig = eng._launch_static

    def spy(reqs, bucket, packed, pack_s, **kw):
        seen.append(threading.get_ident())
        orig(reqs, bucket, packed, pack_s, **kw)

    eng._launch_static = spy
    threading.setprofile(prof)
    try:
        eng.serve(_spike_reqs(24) + _event_reqs(6, 3))
    finally:
        threading.setprofile(None)
    assert seen and all(t == main for t in seen)
    assert "_pack_static" in packer_calls and "_pack_events" in packer_calls
    assert not torch_calls, torch_calls[:5]
    eng.close()


def test_close_is_idempotent_and_shuts_down_packer():
    eng = engine.SpikeEngine(_net(), max_batch=4, overlap=True, device="cpu")
    eng.serve(_spike_reqs(9))
    assert eng._pool is not None
    eng.close()
    eng.close()
    assert eng._pool is None


def test_degradation_ladder_caps_fusion():
    ladder = DegradationLadder.default(8)
    names = [lv.name for lv in ladder.levels]
    eng = engine.SpikeEngine(_net(), max_batch=8, fuse_rounds=8,
                             ladder=ladder, queue_limit=256, device="cpu")
    assert eng._round_budget() == 8 * eng._round_limit()
    eng._ladder_level = names.index("economy")       # fuse_cap=2
    assert eng._round_budget() == 2 * eng._round_limit()
    assert eng._effective_read_ports() == 2
    eng._ladder_level = names.index("survival")      # fuse_cap=1
    assert eng._round_budget() == eng._round_limit()
    eng.close()


def test_host_slot_ring_over_rounds_of_every_size():
    """Two host slots serve rounds of growing and shrinking buckets and T
    (each slot grows to the largest round it packs); every round keeps its
    own results, equal to the synchronous drain's."""
    sizes = [3, 8, 1, 20, 5, 16]
    net = _net()
    sync = engine.SpikeEngine(net, max_batch=8, telemetry=True, device="cpu")
    ov = engine.SpikeEngine(net, max_batch=8, telemetry=True, overlap=True,
                            device="cpu")
    for k, n in enumerate(sizes):
        a = _spike_reqs(n, seed=k) + _event_reqs(k + 1, 1 + k % 3, seed=k)
        b = _spike_reqs(n, seed=k) + _event_reqs(k + 1, 1 + k % 3, seed=k)
        sync.serve(a)
        ov.serve(b)
        _assert_same_results(b, a)
    assert max(s.words.size for s in ov._slots) >= 8 * 4
    assert sync.stats()["rounds_static"] == ov.stats()["rounds_static"]
    ov.close()


def test_two_rounds_of_one_bucket_keep_their_own_results():
    eng = engine.SpikeEngine(_net(), max_batch=8, telemetry=True,
                             overlap=True, device="cpu")
    a, b = _spike_reqs(8, seed=1), _spike_reqs(8, seed=2)
    eng.serve(a + b)
    assert eng.stats()["rounds_per_bucket"] == {8: 2}
    want = _net().plan(mode="functional")(
        np.stack([r.spikes for r in a + b])).logits.numpy()
    np.testing.assert_array_equal(np.stack([r.logits for r in a + b]), want)
    eng.close()


# ----------------------------------------------------------------------- #
# the launcher's flags
# ----------------------------------------------------------------------- #
def test_launcher_serves_with_the_reference_defaults_and_warmup(capsys):
    from repro_torch.launch import serve as serve_mod

    base = ["--esam", "--smoke", "--requests", "40", "--device", "cpu"]
    run = serve_mod.main(base)
    st_ = run.engine.stats()
    assert st_["overlap"] and st_["fuse_rounds"] == 1
    assert run.warm_rounds == 1 and run.timed == 40 and run.warmup is None
    warm = serve_mod.main(base + ["--warmup"])
    out = capsys.readouterr().out
    assert "COLDSTART first_request_ms=" in out and "buckets=5" in out
    assert warm.warmup["graphs"] == 0 and warm.first_request_ms > 0.0
    assert warm.timed == 39 and warm.warm_rounds == 0
    sync = serve_mod.main(base + ["--no-overlap", "--fuse", "off"])
    assert not sync.engine.stats()["overlap"]
    fused = serve_mod.main(base + ["--fuse", "4"])
    assert fused.engine.stats()["fuse_rounds"] == 4
    for other in (warm, sync, fused):
        for r, q in zip(other.requests, run.requests):
            np.testing.assert_array_equal(r.logits, q.logits)
            assert (r.cycles, r.energy_pj) == (q.cycles, q.energy_pj)


def test_overlapped_drain_under_a_short_switch_interval():
    """The packer thread and the caller share the host slots: with the
    interpreter switching threads every microsecond, 40 overlapped rounds
    of mixed sizes still equal the synchronous drain (a slot handed back
    too early would mix two rounds' words)."""
    import sys

    net = _net()
    sync = engine.SpikeEngine(net, max_batch=4, telemetry=True, device="cpu")
    ov = engine.SpikeEngine(net, max_batch=4, telemetry=True, overlap=True,
                            device="cpu")
    a = _spike_reqs(150, seed=9) + _event_reqs(10, 3, seed=9)
    b = _spike_reqs(150, seed=9) + _event_reqs(10, 3, seed=9)
    sync.serve(a)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ov.serve(b)
    finally:
        sys.setswitchinterval(old)
    _assert_same_results(b, a)
    assert ov.stats()["rounds_static"] == 38
    ov.close()
