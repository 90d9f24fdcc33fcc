"""repro_torch cycle-accurate plane and system model against repro's.

On the CPU, on parameters and spikes made with numpy from a seed and loaded
into both packages: ``simulate_tile{,_batch}`` against the port's scan
oracle and the JAX simulators, field by field with dtypes, with and without
the V_mem trace; ``plan(mode="cycle")`` at cell options 0-4, as a sweep, on
1-D and leading-shape inputs, with telemetry; ``port_sweep`` +
``measured_activity`` + ``system_stats`` and ``reference_activity`` exactly
(float64); the Table 3 and Fig 8 checks of ``tests/test_esam_system.py`` in
the port.  The cycle plan on the card against its CPU twin is marked
``cuda`` and skips here."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.esam import cost_model as jcm
from repro.core.esam import tile as jtile
from repro.core.esam.network import EsamNetwork as JaxNetwork
from repro.core.esam.network import reference_activity as jref_activity
from repro.core.esam.network import system_stats as jsystem_stats
from repro_torch.core.esam import cost_model as cm
from repro_torch.core.esam import tile
from repro_torch.core.esam.network import (
    EsamNetwork,
    reference_activity,
    system_stats,
)
from repro_torch.core.esam.plan import NOT_PORTED_MODES, PlanSpec
from repro_torch.data import digits

PAPER = cm.PAPER_TOPOLOGY


def _assert_traces_equal(got, want):
    """Every TileTrace field: shape, dtype and values."""
    assert type(got).__name__ == "TileTrace"
    for name, g, w in zip(tile.TileTrace._fields, got, want):
        w = np.asarray(w)
        g = g.cpu().numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, (
            name, g.dtype, w.dtype, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=name)


def _tile(seed, n_in, n_out):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, size=(n_in, n_out), dtype=np.int8)
    vth = rng.integers(-10, 10, size=(n_out,), dtype=np.int32)
    return bits, vth


def _spikes(seed, shape, density=0.5):
    return np.random.default_rng(seed).random(shape) < density


def _pair(topo, seed):
    rng = np.random.default_rng(seed)
    bits = [rng.integers(0, 2, size=(k, n), dtype=np.int8)
            for k, n in zip(topo[:-1], topo[1:])]
    vth = [rng.integers(-8, 9, size=(n,), dtype=np.int32) for n in topo[1:]]
    off = rng.normal(size=(topo[-1],)).astype(np.float32)
    ref = JaxNetwork([jnp.asarray(b) for b in bits],
                     [jnp.asarray(v) for v in vth], jnp.asarray(off))
    return ref, EsamNetwork.from_numpy(bits, vth, off, device="cpu")


# ----------------------------------------------------------------------- #
# one tile: rank-schedule plane, scan oracle, JAX
# ----------------------------------------------------------------------- #
@pytest.mark.parametrize("ports", [1, 2, 3, 4])
@pytest.mark.parametrize("record", [False, True])
@pytest.mark.parametrize("n_in,n_out", [(256, 40), (128, 130)])
def test_simulate_tile_batch_matches_scan_and_jax(ports, record, n_in, n_out):
    bits, vth = _tile(ports + n_out, n_in, n_out)
    x = _spikes(n_in + ports, (6, n_in), 0.4)
    x[0], x[1] = False, True                  # silent and saturated samples
    args = (torch.from_numpy(bits), torch.from_numpy(x),
            torch.from_numpy(vth), ports, record)
    got = tile.simulate_tile_batch(*args)
    scan = tile.simulate_tile_scan_batch(*args)
    want = jtile.simulate_tile_batch(jnp.asarray(bits), jnp.asarray(x),
                                     jnp.asarray(vth), ports, record)
    _assert_traces_equal(got, want)
    _assert_traces_equal(scan, want)


@pytest.mark.parametrize("ports", [1, 4])
def test_simulate_tile_single_sample_matches_jax(ports):
    bits, vth = _tile(7, 256, 33)
    x = _spikes(8, (256,), 0.6)
    args = (torch.from_numpy(bits), torch.from_numpy(x),
            torch.from_numpy(vth), ports, True)
    jargs = (jnp.asarray(bits), jnp.asarray(x), jnp.asarray(vth), ports, True)
    _assert_traces_equal(tile.simulate_tile(*args),
                         jtile.simulate_tile(*jargs))
    _assert_traces_equal(tile.simulate_tile_scan(*args),
                         jtile.simulate_tile_scan(*jargs))


def test_vmem_trace_chunks_are_exact(monkeypatch):
    """The trace is built over batch chunks; any chunking gives the same."""
    bits, vth = _tile(9, 256, 20)
    x = torch.from_numpy(_spikes(10, (5, 256), 0.5))
    args = (torch.from_numpy(bits), x, torch.from_numpy(vth), 2, True)
    whole = tile.simulate_tile_batch(*args).vmem_trace
    monkeypatch.setattr(tile, "TRACE_CHUNK_ELEMS", 1)      # one sample each
    assert torch.equal(tile.simulate_tile_batch(*args).vmem_trace, whole)
    assert torch.equal(whole[:, -1], tile.simulate_tile_batch(*args).vmem_final)


def test_max_drain_cycles_matches_jax():
    for ports in range(1, 6):
        assert tile.max_drain_cycles(768, ports) == jtile.max_drain_cycles(
            768, ports)


# ----------------------------------------------------------------------- #
# cycle plans
# ----------------------------------------------------------------------- #
def test_plan_spec_takes_cycle_sweeps():
    assert NOT_PORTED_MODES == ()
    spec = PlanSpec(mode="cycle", read_ports=(0, 1, 2, 3, 4))
    assert spec.read_ports == (0, 1, 2, 3, 4)
    for bad in ((), (1, 2.0), (True,), 4.0):
        with pytest.raises(TypeError):
            PlanSpec(mode="cycle", read_ports=bad)
    with pytest.raises(TypeError):
        PlanSpec(mode="functional", read_ports=(1, 4))


@pytest.mark.parametrize("read_ports", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("topo", [(256, 128, 10), PAPER])
def test_cycle_plan_matches_reference(read_ports, topo):
    ref, net = _pair(topo, sum(topo) + read_ports)
    x = _spikes(read_ports, (6, topo[0]), 0.4)
    want = ref.plan(mode="cycle", read_ports=read_ports, telemetry=True)(
        jnp.asarray(x))
    got = net.plan(mode="cycle", read_ports=read_ports, telemetry=True)(
        torch.from_numpy(x))
    np.testing.assert_array_equal(got.logits.numpy(), np.asarray(want.logits))
    assert len(got.traces) == len(want.traces) == len(topo) - 1
    for g, w in zip(got.traces, want.traces):
        _assert_traces_equal(g, w)
    for g, w in zip(got.loads, want.loads):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the schedule never changes the sum: logits are the functional plan's
    func = net.plan(mode="functional")(torch.from_numpy(x)).logits
    assert torch.equal(got.logits, func)


def test_cycle_sweep_plan_shares_port_counts():
    """The twin of the reference's sweep test: options 0 and 1 share the
    single-port simulation, every option's logits are the functional
    plan's, and every option equals the reference's."""
    topo = (256, 128, 10)
    ref, net = _pair(topo, 43)
    x = _spikes(9, (5, 256), 0.4)
    res = net.plan(mode="cycle", read_ports=(0, 1, 4))(torch.from_numpy(x))
    jres = ref.plan(mode="cycle", read_ports=(0, 1, 4))(jnp.asarray(x))
    assert res.logits is None and res.traces is None
    assert sorted(res.sweep) == [0, 1, 4]
    assert torch.equal(res.sweep[0]["traces"][0].cycles,
                       res.sweep[1]["traces"][0].cycles)
    func = net.plan(mode="functional")(torch.from_numpy(x)).logits
    for p in (0, 1, 4):
        assert torch.equal(res.sweep[p]["logits"], func)
        np.testing.assert_array_equal(res.sweep[p]["logits"].numpy(),
                                      np.asarray(jres.sweep[p]["logits"]))
        for g, w in zip(res.sweep[p]["traces"], jres.sweep[p]["traces"]):
            _assert_traces_equal(g, w)
    plan = net.plan(mode="cycle", read_ports=(0, 1, 4))
    assert plan._cycle_port_options() == (1, 4)


@pytest.mark.parametrize("record", [False, True])
def test_cycle_plan_input_shapes(record):
    """1-D and leading-shape inputs: every output is reshaped back, as the
    reference's plan does (``cycles`` is shape () for one sample)."""
    topo = (256, 128, 10)
    ref, net = _pair(topo, 51)
    for shape in ((256,), (2, 3, 256)):
        x = _spikes(len(shape), shape, 0.5)
        want = ref.plan(mode="cycle", read_ports=3, telemetry=True,
                        record_vmem_trace=record)(jnp.asarray(x))
        got = net.plan(mode="cycle", read_ports=3, telemetry=True,
                       record_vmem_trace=record)(torch.from_numpy(x))
        assert got.logits.shape == shape[:-1] + (10,)
        np.testing.assert_array_equal(got.logits.numpy(),
                                      np.asarray(want.logits))
        for g, w in zip(got.traces, want.traces):
            _assert_traces_equal(g, w)
        for g, w in zip(got.loads, want.loads):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    one = net.plan(mode="cycle", read_ports=3)(torch.from_numpy(x[0, 0]))
    assert one.traces[0].cycles.shape == ()


# ----------------------------------------------------------------------- #
# the port sweep and the system model
# ----------------------------------------------------------------------- #
def _digit_net_pair():
    ref, net = _pair(PAPER, 77)
    x, _ = digits.make_spike_dataset(48, seed=3)
    return ref, net, x != 0


def test_port_sweep_and_system_stats_match_reference():
    ref, net, x = _digit_net_pair()
    sweep = net.port_sweep(torch.from_numpy(x), range(5))
    jsweep = ref.port_sweep(jnp.asarray(x), range(5))
    assert sorted(sweep) == list(range(5))
    for p in range(5):
        np.testing.assert_array_equal(sweep[p][0].numpy(),
                                      np.asarray(jsweep[p][0]))
        for g, w in zip(sweep[p][1], jsweep[p][1]):
            _assert_traces_equal(g, w)
    act = net.measured_activity(x, traces=sweep[4][1])
    jact = ref.measured_activity(jnp.asarray(x), traces=jsweep[4][1])
    act_f = net.measured_activity(torch.from_numpy(x))
    for a, af, w in zip(act, act_f, jact):
        assert a.dtype == np.float64
        np.testing.assert_array_equal(a, w)
        np.testing.assert_array_equal(af, w)
    for p in range(5):
        got = dataclasses.asdict(system_stats(PAPER, act, p))
        want = dataclasses.asdict(jsystem_stats(PAPER, jact, p))
        assert got == want, p
    counts = net.spike_counts(torch.from_numpy(x))
    jcounts = ref.spike_counts(jnp.asarray(x))
    for g, w in zip(counts, jcounts):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("topo", [PAPER, (768, 256, 10), (256, 128, 64)])
def test_reference_activity_and_its_stats_match(topo):
    act, jact = reference_activity(topo), jref_activity(topo)
    for a, w in zip(act, jact):
        assert a.dtype == np.float64
        np.testing.assert_array_equal(a, w)
    for p in range(5):
        assert (dataclasses.asdict(system_stats(topo, act, p))
                == dataclasses.asdict(jsystem_stats(topo, jact, p)))


def test_area_functions_match_reference():
    for p in range(5):
        assert cm.array_area_um2(p) == jcm.array_area_um2(p)
        assert cm.array_area_um2(p, 64, 32) == jcm.array_area_um2(p, 64, 32)
        for spare in (0, 1, 4):
            assert (cm.spare_column_area_um2(PAPER, spare, p)
                    == jcm.spare_column_area_um2(PAPER, spare, p))


# Table 3 / Fig 8 (tests/test_esam_system.py) in the port
ACT = reference_activity()


def test_v1_speedup_and_energy_efficiency():
    s0, s4 = system_stats(PAPER, ACT, 0), system_stats(PAPER, ACT, 4)
    speedup = s4.throughput_inf_s / s0.throughput_inf_s
    eff = s0.energy_pj_per_inf / s4.energy_pj_per_inf
    assert speedup == pytest.approx(cm.PAPER_SPEEDUP_4R, rel=0.05)   # 3.1x
    assert eff == pytest.approx(cm.PAPER_ENERGY_EFF_4R, rel=0.05)    # 2.2x


def test_v2_system_operating_point():
    s4 = system_stats(PAPER, ACT, 4)
    assert s4.throughput_inf_s == pytest.approx(cm.PAPER_THROUGHPUT_INF_S,
                                                rel=0.05)
    assert s4.energy_pj_per_inf == pytest.approx(cm.PAPER_ENERGY_PJ_PER_INF,
                                                 rel=0.05)
    assert s4.power_mw == pytest.approx(cm.PAPER_POWER_MW, rel=0.05)


def test_v6_area():
    s4 = system_stats(PAPER, ACT, 4)
    assert s4.area_ratio_vs_1rw == pytest.approx(2.4, rel=0.01)


def test_fig8_trends():
    stats = [system_stats(PAPER, ACT, p) for p in range(5)]
    power = [s.power_mw for s in stats]
    thr = [s.throughput_inf_s for s in stats]
    energy = [s.energy_pj_per_inf for s in stats]
    assert power[0] > power[1] and power[0] > power[2]
    assert power[1] < power[2] < power[3] < power[4]
    assert thr[1] < thr[0] < thr[2] < thr[3] < thr[4]
    assert energy[0] > energy[1] > energy[2] > energy[3] > energy[4]


def test_simulated_drains_land_on_the_cost_model():
    """Every simulated drain is ceil(load / p) of its busiest row group —
    the cycle count the cost model charges (``bench_system``'s check)."""
    _, net, x = _digit_net_pair()
    sweep = net.port_sweep(torch.from_numpy(x), range(5))
    loads = net.measured_activity(x, traces=sweep[4][1])
    for p in range(5):
        for tr, ld in zip(sweep[p][1], loads):
            want = np.ceil(ld / max(1, p)).max(axis=1).astype(np.int32)
            np.testing.assert_array_equal(tr.cycles.numpy(), want)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_cycle_sweep_matches_cpu(cuda):
    from repro_torch.kernels.arbiter import ops

    _, net, x = _digit_net_pair()
    bits, vth, off = net.to_numpy()
    gpu = EsamNetwork.from_numpy(bits, vth, off, device=cuda)
    ops.reset_launch_counts()
    got = gpu.plan(mode="cycle", read_ports=(0, 1, 2, 3, 4),
                   record_vmem_trace=True)(torch.from_numpy(x).to(cuda))
    assert ops.launch_counts()["port_schedule"] == 4 * (len(PAPER) - 1)
    want = net.plan(mode="cycle", read_ports=(0, 1, 2, 3, 4),
                    record_vmem_trace=True)(torch.from_numpy(x))
    for p in range(5):
        assert torch.equal(got.sweep[p]["logits"].cpu(), want.sweep[p]["logits"])
        for g, w in zip(got.sweep[p]["traces"], want.sweep[p]["traces"]):
            for a, b in zip(g, w):
                assert a.dtype == b.dtype and torch.equal(a.cpu(), b)
