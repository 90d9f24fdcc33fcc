"""repro_torch's fault plane against the reference's, on the CPU.

* ``prng.normal`` and the bounded ``prng.uniform`` against ``jax.random``:
  the bounded uniform is bit for bit; ``normal`` is within 3 ulp of
  ``jax.random.normal`` (XLA's ``log1p`` is not torch's; about 1 % of the
  draws differ at all), and its rounded integer offsets (``round(z *
  sigma)`` at every sigma tried) are exact;
* ``FaultModel.build_masks`` bit for bit over many seeds, rates, ragged
  topologies, every fault class, nested upsets and spare remaps; the
  ``faulted_*`` functions, ``clamp_readout_t`` and ``faulty_cells``;
* faulted plans in all five modes against the reference's faulted plans
  (logits, planes, loads, prefix, traces and sweeps), and zero-rate
  identity;
* ``SpikeEngine(faults=)``: logits and ``stats()`` (health, tile health,
  degraded) against the reference engine, and ``replan_degraded(1)``;
* ``train_online(faults=)``: bits, accuracies and updates;
* ``train.fault_tolerance``'s retry policy and elastic replan;
* ``launch.bench_faults --smoke --device cpu``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core.esam import faults as jfaults
from repro.core.esam.network import EsamNetwork as JaxNetwork
from repro.core.esam.temporal import TemporalConfig as JaxTemporalConfig
from repro.serve import engine as jengine
from repro.train import fault_tolerance as jft
from repro.train import online as jonline
from repro_torch.core import prng
from repro_torch.core.esam import FaultModel
from repro_torch.core.esam import faults
from repro_torch.core.esam.network import EsamNetwork
from repro_torch.core.esam.temporal import TemporalConfig
from repro_torch.serve import engine
from repro_torch.train import fault_tolerance as ft
from repro_torch.train import online

TOPO = (256, 128, 128, 10)          # 128-aligned: every mode runs it
#: one model with every fault class, remapped
ALL_CLASSES = dict(seed=5, stuck0_rate=0.08, stuck1_rate=0.06,
                   dead_col_rate=0.1, vth_sigma=1.0, read_disturb=0.01,
                   spare_cols=3)


def _pair(fields: dict):
    return FaultModel(**fields), jfaults.FaultModel(**fields)


def _nets(topo, seed=0, vth_lo=-5, vth_hi=5, readout_vth=None):
    rng = np.random.default_rng(seed)
    bits = [rng.integers(0, 2, size=(k, n), dtype=np.int8)
            for k, n in zip(topo[:-1], topo[1:])]
    vth = [rng.integers(vth_lo, vth_hi, size=(n,)).astype(np.int32)
           for n in topo[1:]]
    if readout_vth is not None:
        vth[-1][:] = readout_vth
    off = rng.normal(size=(topo[-1],)).astype(np.float32)
    ref = JaxNetwork([jnp.asarray(b) for b in bits],
                     [jnp.asarray(v) for v in vth], jnp.asarray(off))
    return ref, EsamNetwork.from_numpy(bits, vth, off, device="cpu")


def _spikes(n, width, seed=1, p=0.35):
    return np.random.default_rng(seed).random((n, width)) < p


def _np(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.uint32 else x


def _assert_masks_equal(got: dict, want: dict) -> None:
    assert set(got) == set(want) == {"stuck0", "stuck1", "vth_off", "upset"}
    for k in ("stuck0", "stuck1", "vth_off"):
        assert len(got[k]) == len(want[k])
        for a, b in zip(got[k], want[k]):
            assert a.dtype == (torch.int32 if k == "vth_off" else torch.bool)
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), k)
    assert sorted(got["upset"]) == sorted(want["upset"])
    for p in want["upset"]:
        for a, b in zip(got["upset"][p], want["upset"][p]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ----------------------------------------------------------------------- #
# prng: the bounded uniform and the normal
# ----------------------------------------------------------------------- #
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-0.3, 2.7), (-1.0, 1.0),
                                   (2.0, 5.0), (1e-3, 7.77),
                                   (float(np.nextafter(np.float32(-1),
                                                       np.float32(0))), 1.0)])
def test_bounded_uniform_is_jax_bit_for_bit(lo, hi):
    for seed in (0, 7, 2**31 + 5):
        want = np.asarray(jax.random.uniform(
            jax.random.PRNGKey(seed), (4099,), minval=lo, maxval=hi))
        got = prng.uniform(prng.PRNGKey(seed), (4099,), lo, hi).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


@pytest.mark.parametrize("shape", [(20000,), (37, 11), (1,), (256,)])
def test_normal_within_3_ulp_and_rounded_offsets_exact(shape):
    """``prng.normal`` is at most 3 ulp from ``jax.random.normal``, equal
    in at least 97 % of the draws, and ``round(z * sigma)`` is the
    reference's exactly at every sigma."""
    differ, total = 0, 0
    for seed in range(25):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), 2)
        want = np.asarray(jax.random.normal(key, shape))
        got = prng.normal(prng.fold_in(prng.PRNGKey(seed), 2), shape)
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        ulp = np.abs(got.numpy().view(np.int32).astype(np.int64)
                     - want.view(np.int32))
        assert ulp.max() <= 3
        differ += int((ulp != 0).sum())
        total += ulp.size
        for sigma in (0.25, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 8.0):
            jint = np.asarray(jnp.round(jnp.asarray(want) * sigma)
                              .astype(jnp.int32))
            tint = torch.round(got * float(np.float32(sigma))).to(
                torch.int32).numpy()
            np.testing.assert_array_equal(tint, jint)
    assert differ <= 0.03 * total


def test_erf_inv_edges():
    x = torch.tensor([-1.0, 1.0, 0.0, -0.0], dtype=torch.float32)
    got = prng.erf_inv(x)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x.numpy())))
    np.testing.assert_array_equal(got.numpy(), want)


# ----------------------------------------------------------------------- #
# the fault model and its masks
# ----------------------------------------------------------------------- #
_RATES = st.sampled_from([0.0, 0.01, 0.05, 0.2, 0.5])


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2**32 - 1), s0=_RATES, s1=_RATES,
       dead=st.sampled_from([0.0, 0.1, 0.4]),
       sigma=st.sampled_from([0.0, 0.5, 1.0, 2.5]),
       disturb=st.sampled_from([0.0, 0.003, 0.05]),
       vprech=st.sampled_from([0.5, 0.35, 0.7]),
       spares=st.sampled_from([0, 1, 3, 40]),
       topo=st.sampled_from([(64, 32, 10), (70, 33, 9), (256, 128, 128, 10),
                             (40, 7), (33, 65, 31, 3)]),
       ports=st.sampled_from([(4,), (1,), (1, 4), (0, 1, 2, 3, 4), (2, 3)]))
def test_build_masks_bit_for_bit(seed, s0, s1, dead, sigma, disturb, vprech,
                                 spares, topo, ports):
    fields = dict(seed=seed, stuck0_rate=s0, stuck1_rate=s1,
                  dead_col_rate=dead, vth_sigma=sigma, read_disturb=disturb,
                  v_prech=vprech, spare_cols=spares)
    fm, jfm = _pair(fields)
    assert fm.any_faults == jfm.any_faults
    for p in (0, 1, 2, 4, 9):
        assert fm.upset_rate(p) == jfm.upset_rate(p)
    _assert_masks_equal(fm.build_masks(topo, ports),
                        jfm.build_masks(topo, ports))


@pytest.mark.parametrize("fields", [
    dict(seed=11, stuck0_rate=0.1, stuck1_rate=0.05, vth_sigma=1.5,
         read_disturb=0.02),
    dict(seed=3, dead_col_rate=0.2, stuck0_rate=0.01, spare_cols=4),
    dict(seed=0, stuck0_rate=0.2, stuck1_rate=0.2),
    dict(seed=13, dead_col_rate=0.15, spare_cols=64),
    dict(seed=1, read_disturb=0.02, v_prech=0.7),
    ALL_CLASSES,
])
def test_masks_match_reference_and_keep_its_invariants(fields):
    fm, jfm = _pair(fields)
    m = fm.build_masks(TOPO, (1, 2, 4))
    _assert_masks_equal(m, jfm.build_masks(TOPO, (1, 2, 4)))
    _assert_masks_equal(fm.build_masks(TOPO, (1, 2, 4)), m)  # deterministic
    for s0, s1 in zip(m["stuck0"], m["stuck1"]):
        assert not bool((s0 & s1).any())                       # disjoint
    for u1, u2, u4 in zip(*(m["upset"][p] for p in (1, 2, 4))):
        assert bool((~u1 | u2).all()) and bool((~u2 | u4).all())  # nested
    assert faults.faulty_cells(m) == jfaults.faulty_cells(
        jfm.build_masks(TOPO, (1, 2, 4)))
    # another seed draws another population
    raw = dataclasses.replace(fm, spare_cols=0)
    a = raw.build_masks(TOPO, (4,))
    b = dataclasses.replace(raw, seed=fm.seed + 1).build_masks(TOPO, (4,))
    leaves = ("stuck0", "stuck1", "vth_off")
    assert any(not torch.equal(u, v) for k in leaves
               for u, v in zip(a[k] + a["upset"][4], b[k] + b["upset"][4]))


def test_dead_columns_hidden_tiles_only():
    m = FaultModel(seed=2, dead_col_rate=0.5).build_masks(TOPO)
    assert not bool(m["stuck0"][-1].any())
    for s0 in m["stuck0"][:-1]:
        dead = s0.all(0)
        assert bool(dead.any()) and bool((s0.any(0) == dead).all())


@pytest.mark.parametrize("bad", [
    dict(stuck0_rate=-0.1), dict(stuck1_rate=1.5), dict(dead_col_rate=2.0),
    dict(read_disturb=-1e-3), dict(stuck0_rate=0.6, stuck1_rate=0.5),
    dict(vth_sigma=-1.0), dict(spare_cols=-1), dict(v_prech=0.0)])
def test_fault_model_checks_match_reference(bad):
    with pytest.raises(AssertionError):
        jfaults.FaultModel(**bad)
    with pytest.raises(ValueError):
        FaultModel(**bad)


def test_fault_model_is_frozen_and_hashable():
    fm = FaultModel(**ALL_CLASSES)
    assert hash(fm) == hash(FaultModel(**ALL_CLASSES))
    with pytest.raises(dataclasses.FrozenInstanceError):
        fm.seed = 3
    assert [f.name for f in dataclasses.fields(FaultModel)] == [
        f.name for f in dataclasses.fields(jfaults.FaultModel)]
    assert FaultModel() == FaultModel(seed=0) and not FaultModel().any_faults
    assert FaultModel(read_disturb=1.0).upset_rate(4) == 1.0


# ----------------------------------------------------------------------- #
# the datapath application
# ----------------------------------------------------------------------- #
@pytest.mark.parametrize("ports", [1, 2, 4])
def test_faulted_weights_vth_clamp_match_reference(ports):
    topo = (64, 32, 10)
    ref, net = _nets(topo, seed=4)
    fm, jfm = _pair(dict(seed=2, stuck0_rate=0.3, stuck1_rate=0.2,
                         read_disturb=0.05, vth_sigma=2.0))
    m, jm = fm.build_masks(topo, (1, 2, 4)), jfm.build_masks(topo, (1, 2, 4))
    got = faults.faulted_weights(net.weight_bits, m, ports)
    want = jfaults.faulted_weights(ref.weight_bits, jm, ports)
    for a, b in zip(got, want):
        assert a.dtype == torch.int8
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(faults.faulted_vth(net.vth, m),
                    jfaults.faulted_vth(ref.vth, jm)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    bits_t = net.weight_bits[-1].T.contiguous()
    eff = faults.clamp_readout_t(bits_t, m, ports)
    assert eff.is_contiguous() and eff.data_ptr() != bits_t.data_ptr()
    np.testing.assert_array_equal(
        eff.numpy(), np.asarray(jfaults.clamp_readout_t(
            jnp.asarray(bits_t.numpy()), jm, ports)))
    # writes into stuck cells do not take
    s0 = m["stuck0"][-1].T
    s1 = m["stuck1"][-1].T
    ones = faults.clamp_readout_t(torch.ones_like(bits_t), m, ports)
    assert bool((ones[s0] == 0).all()) and bool((ones[s1] == 1).all())


def test_faulted_vth_wraps_like_xla():
    """The readout threshold 2^31 - 1 (a readout that never fires) plus a
    positive offset wraps to negative in int32, in both packages."""
    vth = [np.full((10,), 2**31 - 1, np.int32),
           np.full((10,), -2**31, np.int32)]
    m = {"vth_off": (torch.arange(-4, 6, dtype=torch.int32),
                     torch.arange(-4, 6, dtype=torch.int32))}
    got = faults.faulted_vth([torch.from_numpy(v) for v in vth], m)
    want = jfaults.faulted_vth([jnp.asarray(v) for v in vth],
                               {"vth_off": tuple(jnp.asarray(o.numpy())
                                                 for o in m["vth_off"])})
    for a, b in zip(got, want):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(got[0][-1]) < 0 and int(got[1][0]) > 0


# ----------------------------------------------------------------------- #
# faulted plans, every mode, against the reference's
# ----------------------------------------------------------------------- #
_FAULT_MODELS = {
    "all": ALL_CLASSES,
    "stuck1": dict(seed=4, stuck1_rate=0.3),
    "disturb": dict(seed=1, read_disturb=0.02, v_prech=0.6),
    "vth": dict(seed=9, vth_sigma=2.0),
}


def _run_both(ref, net, mode, fm, jfm, x, *, read_ports=4, collect=True,
              temporal=None):
    jkw, kw = {}, {}
    if mode in ("packed", "prefix", "temporal"):
        jkw["interpret"] = True
    if temporal is not None:
        jkw["temporal"] = JaxTemporalConfig(**temporal)
        kw["temporal"] = TemporalConfig(**temporal)
    coll = collect and mode != "cycle"
    want = ref.plan(mode=mode, telemetry=True, collect=coll, faults=jfm,
                    read_ports=read_ports, **jkw)(jnp.asarray(x))
    got = net.plan(mode=mode, telemetry=True, collect=coll, faults=fm,
                   read_ports=read_ports, **kw)(torch.from_numpy(x))
    return got, want


def _assert_result_equal(got, want):
    for name in ("logits", "prefix"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if b is not None:
            np.testing.assert_array_equal(a.numpy(), _np(b), name)
    for name in ("planes", "loads"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if b is not None:
            assert len(a) == len(b)
            for u, v in zip(a, b):
                np.testing.assert_array_equal(u.numpy(), _np(v), name)


def _assert_traces_equal(got, want):
    assert len(got) == len(want)
    for tg, tw in zip(got, want):
        for a, b in zip(tg, tw):
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a.numpy(), _np(b))


@pytest.mark.parametrize("faults_name", sorted(_FAULT_MODELS))
@pytest.mark.parametrize("mode", ["functional", "packed", "prefix"])
def test_faulted_plan_matches_reference(mode, faults_name):
    ref, net = _nets(TOPO, seed=3)
    fm, jfm = _pair(_FAULT_MODELS[faults_name])
    x = _spikes(9, TOPO[0], seed=4)
    got, want = _run_both(ref, net, mode, fm, jfm, x)
    _assert_result_equal(got, want)
    if mode == "prefix":
        return
    clean = net.plan(mode=mode)(torch.from_numpy(x)).logits
    assert not torch.equal(got.logits, clean)


@pytest.mark.parametrize("faults_name", ["all", "disturb"])
@pytest.mark.parametrize("read_ports", [1, 2, 4, (0, 1, 2, 3, 4), (4, 1)])
def test_faulted_cycle_plan_matches_reference(read_ports, faults_name):
    """Traces, logits and loads of one cell option, and a sweep that reads
    the masks at each effective port count (telemetry from the first
    option's simulation, as the reference's)."""
    ref, net = _nets(TOPO, seed=5)
    fm, jfm = _pair(_FAULT_MODELS[faults_name])
    x = _spikes(7, TOPO[0], seed=6)
    got, want = _run_both(ref, net, "cycle", fm, jfm, x,
                          read_ports=read_ports)
    for a, b in zip(got.loads, want.loads):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if isinstance(read_ports, tuple):
        assert sorted(got.sweep) == sorted(want.sweep)
        for o in read_ports:
            np.testing.assert_array_equal(got.sweep[o]["logits"].numpy(),
                                          np.asarray(want.sweep[o]["logits"]))
            _assert_traces_equal(got.sweep[o]["traces"],
                                 want.sweep[o]["traces"])
        if faults_name == "disturb":
            assert not torch.equal(got.sweep[1]["logits"],
                                   got.sweep[4]["logits"])
    else:
        np.testing.assert_array_equal(got.logits.numpy(),
                                      np.asarray(want.logits))
        _assert_traces_equal(got.traces, want.traces)


@pytest.mark.parametrize("faults_name", ["all", "stuck1"])
@pytest.mark.parametrize("temporal", [
    dict(n_steps=2, leak=0.25), dict(n_steps=3, leak=0.0, reset="subtract",
                                     refractory=1)])
def test_faulted_temporal_plan_matches_reference(temporal, faults_name):
    ref, net = _nets(TOPO, seed=7)
    fm, jfm = _pair(_FAULT_MODELS[faults_name])
    x = np.stack([_spikes(5, TOPO[0], seed=8 + t)
                  for t in range(temporal["n_steps"])])
    got, want = _run_both(ref, net, "temporal", fm, jfm, x,
                          temporal=temporal)
    _assert_result_equal(got, want)


@pytest.mark.parametrize("mode", ["functional", "packed", "prefix", "cycle",
                                  "temporal"])
def test_zero_rate_faults_bit_identical_to_clean(mode):
    """A model with every rate 0 runs the whole mask path and lands on the
    clean plan's results; ``faults=None`` is the clean plan itself."""
    _, net = _nets(TOPO, seed=1)
    x = torch.from_numpy(_spikes(9, TOPO[0], seed=2))
    kw = {}
    if mode == "temporal":
        kw["temporal"] = TemporalConfig(n_steps=2, leak=0.25)
        x = torch.stack([x, x.flip(0)])
    fm0 = FaultModel(seed=9, spare_cols=5)
    assert not fm0.any_faults
    a = net.plan(mode=mode, telemetry=True, faults=fm0, **kw)(x)
    b = net.plan(mode=mode, telemetry=True, **kw)(x)
    assert net.plan(mode=mode, faults=None, **kw) is net.plan(mode=mode,
                                                              **kw)
    for name in ("logits", "prefix"):
        va, vb = getattr(a, name), getattr(b, name)
        assert (va is None) == (vb is None)
        if va is not None:
            assert torch.equal(va, vb)
    for la, lb in zip(a.loads, b.loads):
        assert torch.equal(la, lb)


def test_faulted_modes_agree():
    """Faulted weights are other weights: functional == packed == cycle ==
    temporal (T=1) under one model."""
    _, net = _nets(TOPO, seed=3)
    x = torch.from_numpy(_spikes(9, TOPO[0], seed=4))
    fm = FaultModel(seed=5, stuck0_rate=0.08, stuck1_rate=0.06,
                    vth_sigma=1.0, read_disturb=0.01)
    f = net.plan(mode="functional", faults=fm)(x).logits
    assert torch.equal(f, net.plan(mode="packed", faults=fm)(x).logits)
    assert torch.equal(f, net.plan(mode="cycle", faults=fm)(x).logits)
    assert torch.equal(f, net.plan(
        mode="temporal", faults=fm,
        temporal=TemporalConfig(n_steps=1))(x[None]).logits)


def test_stuck_at_extremes_and_full_remap():
    _, net = _nets((64, 32, 10), seed=6)
    x = torch.from_numpy(_spikes(5, 64, seed=7))
    for field, bit in (("stuck1_rate", 1), ("stuck0_rate", 0)):
        forced = EsamNetwork([torch.full_like(w, bit)
                              for w in net.weight_bits],
                             net.vth, net.out_offset, device="cpu")
        assert torch.equal(
            net.plan(mode="functional",
                     faults=FaultModel(**{field: 1.0}))(x).logits,
            forced.plan(mode="functional")(x).logits)
    _, net = _nets(TOPO, seed=10)
    x = torch.from_numpy(_spikes(9, TOPO[0], seed=11))
    clean = net.plan(mode="functional")(x).logits
    fm = FaultModel(seed=13, dead_col_rate=0.15)
    assert not torch.equal(net.plan(mode="functional", faults=fm)(x).logits,
                           clean)
    assert torch.equal(net.plan(
        mode="functional",
        faults=dataclasses.replace(fm, spare_cols=64))(x).logits, clean)


def test_faulted_plan_follows_a_weight_change():
    """The faulted operands are rebuilt when a parameter changes in place,
    as a clean plan's are."""
    ref, net = _nets((64, 32, 10), seed=12)
    fm = FaultModel(seed=3, stuck0_rate=0.1, vth_sigma=1.0)
    plan = net.plan(mode="packed", faults=fm)
    x = torch.from_numpy(_spikes(6, 64, seed=13))
    before = plan(x).logits
    with torch.no_grad():
        net.weight_bits[0].copy_(1 - net.weight_bits[0])
    after = plan(x).logits
    fresh = EsamNetwork([w.clone() for w in net.weight_bits],
                        [v.clone() for v in net.vth], net.out_offset.clone(),
                        device="cpu").plan(mode="packed", faults=fm)(x).logits
    assert torch.equal(after, fresh) and not torch.equal(after, before)


# ----------------------------------------------------------------------- #
# faulted serving against the reference engine
# ----------------------------------------------------------------------- #
_SERVE_TOPO = (128, 128, 10)


@pytest.mark.parametrize("fields", [dict(seed=4, stuck1_rate=0.7),
                                    dict(seed=8, dead_col_rate=0.3,
                                         read_disturb=0.02, vth_sigma=1.0)])
@pytest.mark.parametrize("read_ports", [4, 1])
def test_faulted_engine_matches_reference(fields, read_ports):
    ref, net = _nets(_SERVE_TOPO, seed=20, vth_lo=0, vth_hi=1)
    fm, jfm = _pair(fields)
    s = _spikes(16, 128, seed=21).astype(np.uint8)
    eng = engine.SpikeEngine(net, telemetry=True, max_batch=16, faults=fm,
                             read_ports=read_ports, device="cpu")
    jeng = jengine.SpikeEngine(ref, interpret=True, telemetry=True,
                               max_batch=16, faults=jfm,
                               read_ports=read_ports)
    got = eng.serve([engine.SpikeRequest(spikes=r) for r in s])
    want = jeng.serve([jengine.SpikeRequest(spikes=r) for r in s])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.logits, np.asarray(b.logits))
        assert a.label == b.label and a.cycles == b.cycles
    # the engine reads the faults at the plan's 4 ports, whatever its own
    plan = net.plan(mode="functional", faults=fm)
    np.testing.assert_array_equal(
        np.stack([r.logits for r in got]),
        plan(torch.from_numpy(s)).logits.numpy())
    st_, jst = eng.stats(), jeng.stats()
    assert st_["faulted"] is jst["faulted"] is True
    assert st_["degraded"] == jst["degraded"]
    np.testing.assert_allclose(st_["tile_health"], jst["tile_health"],
                               rtol=1e-6)
    assert st_["health"] == pytest.approx(jst["health"], rel=1e-6)


def test_faulted_engine_health_and_events():
    ref, net = _nets(_SERVE_TOPO, seed=20, vth_lo=0, vth_hi=1)
    fm, jfm = _pair(dict(seed=4, stuck1_rate=0.7))
    s = _spikes(16, 128, seed=21).astype(np.uint8)
    clean = engine.SpikeEngine(net, telemetry=True, max_batch=16,
                               device="cpu")
    bad = engine.SpikeEngine(net, telemetry=True, max_batch=16, faults=fm,
                             device="cpu")
    clean.serve([engine.SpikeRequest(spikes=r) for r in s])
    bad.serve([engine.SpikeRequest(spikes=r) for r in s])
    assert clean.health() > bad.health() and bad.health() < 0.5
    st_ = bad.stats()
    assert st_["faulted"] and st_["degraded"]
    assert not clean.stats()["faulted"]
    assert st_["tile_health"] == [float(h) for h in bad.tile_health()]
    assert engine.SpikeEngine(net, telemetry=True,
                              device="cpu").health() == 1.0
    # event streams go through the faulted temporal plan
    ev = np.stack([s[:8], s[8:]]).transpose(1, 0, 2)
    got = bad.serve([engine.EventRequest(events=e) for e in ev])
    jbad = jengine.SpikeEngine(ref, interpret=True, telemetry=True,
                               max_batch=16, faults=jfm)
    want = jbad.serve([jengine.EventRequest(events=e) for e in ev])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.logits, np.asarray(b.logits))


def test_replan_degraded_on_one_device():
    ref, net = _nets(_SERVE_TOPO, seed=22, vth_lo=0, vth_hi=1)
    fm, jfm = _pair(dict(seed=6, stuck0_rate=0.1, read_disturb=0.01))
    s = _spikes(40, 128, seed=23).astype(np.uint8)
    eng = engine.SpikeEngine(net, telemetry=True, max_batch=16, faults=fm,
                             fuse_rounds="auto", device="cpu")
    jeng = jengine.SpikeEngine(ref, interpret=True, telemetry=True,
                               max_batch=16, faults=jfm, fuse_rounds="auto")
    before = eng.serve([engine.SpikeRequest(spikes=r) for r in s])
    queued = [engine.SpikeRequest(spikes=r) for r in s[:3]]
    eng.submit(queued)               # queued across the replan
    plan = eng.replan_degraded(1)
    jplan = jeng.replan_degraded(1)
    assert plan == jplan == ((1, 1), ("data", "model"))
    assert plan.dropped_chips == jplan.dropped_chips == 0
    assert eng._buckets == jeng._buckets
    assert eng.stats()["faulted"] and eng._plan.spec.faults == fm
    after = eng.serve([engine.SpikeRequest(spikes=r) for r in s])
    for a, b in zip(before, after):
        np.testing.assert_array_equal(a.logits, b.logits)
    for a, b in zip(queued, before):
        np.testing.assert_array_equal(a.logits, b.logits)
    assert eng.stats()["n_requests"] == 83
    # a data axis above 1 needs sharded plans: raised, not served on one
    with pytest.raises(NotImplementedError, match="sharded"):
        eng.replan_degraded(3)


# ----------------------------------------------------------------------- #
# online-learning repair
# ----------------------------------------------------------------------- #
def _repair_task():
    """The reference test's separable task: 10 prototypes + flip noise."""
    rng = np.random.default_rng(50)
    protos = rng.random((10, 768)) < 0.35

    def split(seed, n):
        r = np.random.default_rng(seed)
        y = r.integers(0, 10, size=(n,)).astype(np.int32)
        return np.logical_xor(protos[y], r.random((n, 768)) < 0.03), y

    return split(60, 360), split(61, 120)


@pytest.mark.parametrize("fields,epochs,shuffle", [
    (dict(seed=7, dead_col_rate=0.3), 3, True),
    (dict(seed=2, stuck0_rate=0.2, stuck1_rate=0.1, read_disturb=0.01), 2,
     False),
])
def test_train_online_faults_matches_reference(fields, epochs, shuffle):
    (x_tr, y_tr), (x_te, y_te) = _repair_task()
    topo = (768, 64, 10)
    rng = np.random.default_rng(5)
    bits = [rng.integers(0, 2, size=(k, n), dtype=np.int8)
            for k, n in zip(topo[:-1], topo[1:])]
    vth = [rng.integers(0, 12, size=(64,)).astype(np.int32),
           np.full((10,), 2**30, np.int32)]
    off = np.zeros((10,), np.float32)
    ref = JaxNetwork([jnp.asarray(b) for b in bits],
                     [jnp.asarray(v) for v in vth], jnp.asarray(off))
    net = EsamNetwork.from_numpy(bits, vth, off, device="cpu")
    fm, jfm = _pair(fields)
    kw = dict(epochs=epochs, shuffle=shuffle, p_pot=0.12, p_dep=0.06)
    want = jonline.train_online(ref, jnp.asarray(x_tr), jnp.asarray(y_tr),
                                eval_spikes=jnp.asarray(x_te),
                                eval_labels=jnp.asarray(y_te), faults=jfm,
                                interpret=True, **kw)
    got = online.train_online(net, x_tr, y_tr, eval_spikes=x_te,
                              eval_labels=y_te, faults=fm, **kw)
    assert got.accuracy == want.accuracy
    assert got.n_updates == want.n_updates
    np.testing.assert_array_equal(got.network.weight_bits[-1].numpy(),
                                  np.asarray(want.network.weight_bits[-1]))
    # the deployed faulted plan reads the last epoch's accuracy
    logits = got.network.plan(mode="functional", faults=fm)(
        torch.from_numpy(x_te)).logits
    deployed = float((logits.argmax(-1).numpy() == y_te).mean())
    assert deployed == pytest.approx(got.accuracy[-1], abs=1e-6)
    # the prefix is untouched, and faults=None keeps the clean trainer
    for a, b in zip(got.network.weight_bits[:-1], net.weight_bits[:-1]):
        assert torch.equal(a, b)


def test_train_online_faults_none_is_the_clean_trainer():
    (x_tr, y_tr), _ = _repair_task()
    _, net = _nets((768, 64, 10), seed=9, vth_lo=0, vth_hi=12,
                   readout_vth=2**30)
    a = online.train_online(net, x_tr, y_tr, epochs=2)
    b = online.train_online(net, x_tr, y_tr, epochs=2, faults=None)
    assert a.accuracy == b.accuracy and a.n_updates == b.n_updates
    assert torch.equal(a.network.weight_bits[-1], b.network.weight_bits[-1])


# ----------------------------------------------------------------------- #
# train.fault_tolerance: the retry policy and the elastic replan
# ----------------------------------------------------------------------- #
@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2**64 - 1), counter=st.integers(0, 2**40))
def test_counter_uniform_matches_reference(seed, counter):
    u = ft.counter_uniform(seed, counter)
    assert u == jft.counter_uniform(seed, counter) and 0.0 <= u < 1.0
    assert ft._splitmix64(seed) == jft._splitmix64(seed)


@settings(max_examples=60, deadline=None)
@given(attempt=st.integers(0, 12), counter=st.integers(0, 10**6),
       base=st.sampled_from([1e-5, 1e-3, 0.01]),
       mult=st.sampled_from([1.0, 2.0, 3.5]),
       cap=st.sampled_from([0.05, 1.0]),
       jitter=st.sampled_from([0.0, 0.5, 1.0]), seed=st.integers(0, 99))
def test_retry_backoff_matches_reference(attempt, counter, base, mult, cap,
                                         jitter, seed):
    kw = dict(base_backoff_s=base, backoff_multiplier=mult,
              max_backoff_s=cap, jitter=jitter, seed=seed)
    assert ft.RetryPolicy(**kw).backoff_s(attempt, counter) == \
        jft.RetryPolicy(**kw).backoff_s(attempt, counter)


def test_retry_policy_fields_match_reference():
    assert dataclasses.asdict(ft.RetryPolicy()) == dataclasses.asdict(
        jft.RetryPolicy())


@pytest.mark.parametrize("n,mp", [(1, 1), (3, 1), (8, 1), (1000, 16),
                                  (17, 16), (40, 8), (64, 16), (7, 3)])
def test_elastic_replan_matches_reference(n, mp):
    got = ft.elastic_replan(n, model_parallel=mp)
    want = jft.elastic_replan(n, model_parallel=mp)
    assert got == want and tuple(got) == tuple(want)
    assert got.dropped_chips == want.dropped_chips


def test_elastic_replan_too_few_chips():
    for mod in (ft, jft):
        with pytest.raises(ValueError):
            mod.elastic_replan(3, model_parallel=4)


# ----------------------------------------------------------------------- #
# the fault bench twin
# ----------------------------------------------------------------------- #
def test_bench_faults_smoke_on_the_cpu(tmp_path, capsys):
    """Every assertion of the reference's bench holds on the port's smoke
    run, and the rows are the reference's rows by name."""
    import json

    from repro_torch.launch import bench_faults

    out = tmp_path / "faults.json"
    res = bench_faults.main(["--device", "cpu", "--smoke", "--out",
                             str(out)])
    assert all(held for held, _ in res.claims.values())
    names = [r["name"] for r in res.rows]
    want = [f"fault_sweep_{t}_{m}" for t in ("stuck0", "stuck1",
                                              "read_disturb")
            for m in ("functional", "packed")] + [
        "fault_mitigation_remap", "fault_repair_stdp",
        "fault_energy_vs_mitigation"]
    assert names == want
    assert [r["name"] for r in json.loads(out.read_text())["results"]] == want
    printed = capsys.readouterr().out.splitlines()
    assert printed[0] == "name,us_per_call,derived"
    assert all(any(line.startswith(n + ",") for line in printed)
               for n in want)
    assert res.repair.epochs_run == res.repair_epochs == 2
    assert res.net.device.type == "cpu"
    # the topology and the reference's fault types
    from benchmarks import bench_faults as jbench

    assert sorted(bench_faults.FAULT_TYPES) == sorted(jbench.FAULT_TYPES)
    for name in jbench.FAULT_TYPES:
        assert dataclasses.asdict(bench_faults.FAULT_TYPES[name](0.05)) == \
            dataclasses.asdict(jbench.FAULT_TYPES[name](0.05))
    assert tuple(res.net.topology) == (768, 256, 256, 256, 10)


def test_bench_repair_on_the_reference_network_is_the_reference_repair():
    """The bench's remap and repair sections, run by the port on the
    reference's own trained network (smoke size), read the reference's
    accuracies, updates and learned bits exactly: the port's fault plane
    does not move the claims, only its BNN's training does."""
    from repro.core.esam import bnn as jbnn
    from repro.core.esam import conversion as jconversion
    from repro.core.esam import cost_model as jcm
    from repro.data import digits as jdigits
    from repro_torch.launch import bench_faults

    x, y = jdigits.make_spike_dataset(512, seed=0)
    params, _ = jbnn.fit(jax.random.PRNGKey(0), jcm.PAPER_TOPOLOGY,
                         jnp.asarray(x[:384]), jnp.asarray(y[:384]),
                         steps=40, batch=128)
    ref = jconversion.bnn_to_snn(params)
    jfm = jfaults.FaultModel(seed=5, dead_col_rate=0.4)
    x_tr, y_tr = jnp.asarray(x[:384]).astype(bool), jnp.asarray(y[:384])
    x_te, y_te = jnp.asarray(x[384:]).astype(bool), jnp.asarray(y[384:])
    want = jonline.train_online(ref, x_tr, y_tr, epochs=2, shuffle=True,
                                eval_spikes=x_te, eval_labels=y_te,
                                faults=jfm, interpret=True)
    want_fault = float((np.asarray(ref.plan(mode="functional", faults=jfm)(
        x_te).logits).argmax(-1) == np.asarray(y_te)).mean())

    net = EsamNetwork.from_numpy(
        [np.asarray(w) for w in ref.weight_bits],
        [np.asarray(v) for v in ref.vth], np.asarray(ref.out_offset),
        device="cpu")
    rec = bench_faults._Rows()
    dev = torch.device("cpu")
    test = (torch.from_numpy(np.asarray(x_te)),
            torch.from_numpy(np.asarray(y_te)))
    bench_faults._remap(rec, net, *test, dev, True)
    fm, epochs, got = bench_faults._repair(
        rec, net, (torch.from_numpy(np.asarray(x_tr)),
                   torch.from_numpy(np.asarray(y_tr))), *test, dev, True)
    assert epochs == 2 and fm == FaultModel(seed=5, dead_col_rate=0.4)
    assert got.accuracy == want.accuracy
    assert got.n_updates == want.n_updates
    np.testing.assert_array_equal(got.network.weight_bits[-1].numpy(),
                                  np.asarray(want.network.weight_bits[-1]))
    assert rec.claims["repair_beats_faulted"][0] == (
        max(want.accuracy) > want_fault)
    assert sorted(rec.claims) == ["remap_recovers", "repair_beats_faulted"]
