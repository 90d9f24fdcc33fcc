"""repro_torch's temporal event plane against repro's, on the CPU.

The twin of tests/test_temporal.py.  The same seeded numpy inputs go through
both packages: the LIF step (bit for bit against ``jax.jit`` of the
reference, whose compiler rounds the leak and the integrate once, as one
fused multiply-add), the temporal plan (logits, planes and loads bit for
bit), the temporal cost model, and event-stream serving through
``SpikeEngine``.  Plus a ``cuda``-marked test of the CUDA LIF step against
its plain version, which skips without a card.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as jpacking
from repro.core.esam import cost_model as jcm
from repro.core.esam import temporal as jtemporal
from repro.core.esam.network import EsamNetwork as JaxNetwork
from repro.kernels.lif_step.ref import lif_step_ref as jlif_step_ref
from repro.serve import engine as jengine
from repro_torch.core import packing
from repro_torch.core.esam import cost_model as cm
from repro_torch.core.esam.network import EsamNetwork
from repro_torch.core.esam.plan import NOT_PORTED_MODES, PlanSpec
from repro_torch.core.esam.temporal import (
    TemporalConfig,
    temporal_forward_naive,
)
from repro_torch.kernels.lif_step import ops as lif_ops
from repro_torch.kernels.lif_step.ref import lif_step_ref
from repro_torch.launch import serve as serve_mod
from repro_torch.serve import engine

#: the four configurations of the reference's scan-vs-naive test
CONFIGS = [
    dict(n_steps=6),
    dict(n_steps=5, leak=0.25),
    dict(n_steps=4, reset="subtract"),
    dict(n_steps=7, leak=0.125, reset="subtract", refractory=2),
]

_jit_lif = jax.jit(jlif_step_ref,
                   static_argnames=("leak", "reset", "refractory"))


def _configs(**kw):
    """(port config, reference config) of the same dynamics."""
    return TemporalConfig(**kw), jtemporal.TemporalConfig(**kw)


def _pair(topo, seed):
    rng = np.random.default_rng(seed)
    bits = [rng.integers(0, 2, size=(k, n), dtype=np.int8)
            for k, n in zip(topo[:-1], topo[1:])]
    vth = [rng.integers(-10, 10, size=(n,), dtype=np.int32) for n in topo[1:]]
    off = rng.normal(size=(topo[-1],)).astype(np.float32)
    ref = JaxNetwork([jnp.asarray(b) for b in bits],
                     [jnp.asarray(v) for v in vth], jnp.asarray(off))
    return ref, EsamNetwork.from_numpy(
        [np.asarray(w) for w in ref.weight_bits],
        [np.asarray(v) for v in ref.vth], np.asarray(ref.out_offset),
        device="cpu")


def _events(seed, n_steps, batch, n_in, rate=0.3):
    return (np.random.default_rng(seed).random((n_steps, batch, n_in))
            < rate).astype(np.uint8)


def _assert_planes_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(packing.words_to_np(g), np.asarray(w))


def _assert_loads_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ----------------------------------------------------------------------- #
# the LIF step
# ----------------------------------------------------------------------- #
def _lif_operands(seed, B, N, refractory, ties=True):
    rng = np.random.default_rng(seed)
    vmem = rng.uniform(-20.0, 20.0, size=(B, N)).astype(np.float32)
    contrib = rng.integers(-16, 17, size=(B, N), dtype=np.int32)
    vth = rng.integers(-5, 6, size=(N,), dtype=np.int32)
    refrac = rng.integers(0, refractory + 1, size=(B, N), dtype=np.int32)
    if ties:
        # a quarter of the membranes land exactly on the threshold
        tie = rng.random((B, N)) < 0.25
        vmem[tie] = 0.0
        contrib[tie] = np.broadcast_to(vth, (B, N))[tie]
    return vmem, contrib, vth, refrac


@pytest.mark.parametrize("leak", [0.0, 0.125, 0.25])
@pytest.mark.parametrize("reset", ["zero", "subtract"])
@pytest.mark.parametrize("refractory", [0, 2])
def test_lif_step_matches_jitted_reference(leak, reset, refractory):
    """Bit for bit against jax.jit(lif_step_ref): one rounding of the leak
    and the integrate.  The reference's eager lif_step_ref rounds twice; the
    port agrees with it only to float32 ulp, which the second half shows."""
    ops = _lif_operands(int(leak * 8) + 10 * refractory, 8, 256, refractory)
    kw = dict(leak=leak, reset=reset, refractory=refractory)
    want = [np.asarray(a) for a in _jit_lif(*map(jnp.asarray, ops), **kw)]
    got = lif_step_ref(*map(torch.from_numpy, ops), **kw)
    assert [g.dtype for g in got] == [torch.int8, torch.float32, torch.int32]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    # the eager, twice-rounded reference: within one float32 ulp
    eager = [np.asarray(a) for a in jlif_step_ref(*map(jnp.asarray, ops),
                                                  **kw)]
    agree = got[0].numpy() == eager[0]
    np.testing.assert_allclose(got[1].numpy()[agree], eager[1][agree],
                               rtol=1e-6, atol=1e-5)
    if leak == 0.0:
        for g, w in zip(got, eager):
            np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("leak", [0.1, 0.125, 0.3])
def test_lif_step_single_rounding_on_wide_membranes(leak):
    """Membranes far from the threshold, every bit of the leak-integrate
    checked: about one entry in ten rounds differently twice than once."""
    rng = np.random.default_rng(7)
    vmem = rng.uniform(-300.0, 300.0, size=(64, 256)).astype(np.float32)
    contrib = rng.integers(-300, 300, size=(64, 256), dtype=np.int32)
    vth = np.full((256,), 2**31 - 1, np.int32)      # never fires
    refrac = np.zeros((64, 256), np.int32)
    ops = (vmem, contrib, vth, refrac)
    want = np.asarray(_jit_lif(*map(jnp.asarray, ops), leak=leak)[1])
    got = lif_step_ref(*map(torch.from_numpy, ops), leak=leak)[1]
    np.testing.assert_array_equal(got.numpy(), want)
    twice = (torch.from_numpy(vmem) * float(np.float32(1.0 - leak))
             + torch.from_numpy(contrib).float()).numpy()
    assert (twice != want).mean() > 0.01


def test_lif_step_semantics_hand_example():
    """vth=2: contrib 3 fires (zero->0, subtract->1); a refractory neuron
    integrates but cannot fire until its counter drains."""
    vmem = torch.zeros((1, 2))
    vth = torch.tensor([2, 2], dtype=torch.int32)
    contrib = torch.tensor([[3, 3]], dtype=torch.int32)
    refrac = torch.tensor([[0, 2]], dtype=torch.int32)
    s, v, r = lif_ops.lif_step(vmem, contrib, vth, refrac, reset="zero",
                               refractory=2)
    assert s.tolist() == [[1, 0]] and v.tolist() == [[0.0, 3.0]]
    assert r.tolist() == [[2, 1]]
    s2, v2, _ = lif_ops.lif_step(vmem, contrib, vth, torch.zeros_like(refrac),
                                 reset="subtract")
    assert s2.tolist() == [[1, 1]] and v2.tolist() == [[1.0, 1.0]]


def test_lif_step_leak_is_exact_identity_at_zero():
    v = torch.full((1, 8), 7.0)
    z = torch.zeros((1, 8), dtype=torch.int32)
    never = torch.full((8,), 99, dtype=torch.int32)
    assert torch.equal(lif_step_ref(v, z, never, z, leak=0.0)[1], v)
    assert torch.equal(lif_step_ref(v, z, never, z, leak=0.5)[1], v * 0.5)


def test_lif_step_wrapper_checks_and_counts():
    ops = [torch.from_numpy(a) for a in _lif_operands(3, 4, 32, 0)]
    lif_ops.reset_launch_counts()
    got = lif_ops.lif_step(*ops, leak=0.25)
    for g, w in zip(got, lif_step_ref(*ops, leak=0.25)):
        assert torch.equal(g, w)
    assert lif_ops.launch_counts() == {"lif_step": 0}   # the plain path
    vmem, contrib, vth, refrac = ops
    with pytest.raises(ValueError):
        lif_ops.lif_step(vmem, contrib.float(), vth, refrac)
    with pytest.raises(ValueError):
        lif_ops.lif_step(vmem, contrib, vth[:-1], refrac)
    with pytest.raises(ValueError):
        lif_ops.lif_step(vmem, contrib, vth, refrac, reset="hold")


# ----------------------------------------------------------------------- #
# the temporal plan against the reference's
# ----------------------------------------------------------------------- #
@pytest.mark.parametrize("kw", CONFIGS, ids=lambda kw: "-".join(
    f"{k}{v}" for k, v in kw.items()))
def test_temporal_plan_matches_reference(kw):
    """Logits, collected planes and loads bit for bit against the JAX plan,
    and the logits against both naive oracles."""
    topo = (256, 128, 128, 10)
    cfg, jcfg = _configs(**kw)
    ref, net = _pair(topo, cfg.n_steps)
    ev = _events(77 + cfg.n_steps, cfg.n_steps, 9, topo[0])
    want = ref.plan(mode="temporal", temporal=jcfg, collect=True,
                    telemetry=True, interpret=True)(ev)
    got = net.plan(mode="temporal", temporal=cfg, collect=True,
                   telemetry=True)(ev)
    np.testing.assert_array_equal(got.logits.numpy(), np.asarray(want.logits))
    _assert_planes_equal(got.planes, want.planes)
    _assert_loads_equal(got.loads, want.loads)
    assert got.planes[1].shape == (9, cfg.n_steps, 4)
    np.testing.assert_array_equal(temporal_forward_naive(net, ev, cfg),
                                  got.logits.numpy())
    np.testing.assert_array_equal(
        jtemporal.temporal_forward_naive(ref, ev, jcfg), got.logits.numpy())
    # the plain plan: the same logits without collect or telemetry
    bare = net.plan(mode="temporal", temporal=cfg)(ev)
    assert bare.planes is None and bare.loads is None
    assert torch.equal(bare.logits, got.logits)


def test_temporal_accepts_wire_format_and_leading_shapes():
    topo = (256, 128, 10)
    cfg, jcfg = _configs(n_steps=3, leak=0.5)
    ref, net = _pair(topo, 3)
    ev = _events(4, 3, 5, topo[0])
    plan = net.plan(mode="temporal", temporal=cfg)
    base = plan(ev).logits
    np.testing.assert_array_equal(
        base.numpy(),
        np.asarray(ref.plan(mode="temporal", temporal=jcfg)(ev).logits))
    # wire words, as numpy uint32 and as int32 torch words
    words = packing.pack_spikes_np(ev)
    assert torch.equal(plan(words).logits, base)
    assert torch.equal(plan(packing.words_from_np(words)).logits, base)
    # one stream [T, n_in] -> unbatched logits
    one = plan(ev[:, 2]).logits
    assert one.shape == base.shape[1:]
    assert torch.equal(one, base[2])
    # extra leading dims [T, 1, 5, n_in]
    assert torch.equal(plan(ev[:, None]).logits[0], base)
    with pytest.raises(ValueError):
        plan(ev[:2])                                  # wrong T
    with pytest.raises(ValueError):
        plan(ev[..., :100])                           # wrong width


def test_temporal_non_32_multiple_input_width():
    """n_in = 100 packs with silent tail bits; the logits match the JAX plan
    and both oracles exactly (hidden widths stay 32-aligned)."""
    topo = (100, 64, 10)
    cfg, jcfg = _configs(n_steps=4, leak=0.25)
    ref, net = _pair(topo, 9)
    ev = _events(10, 4, 6, 100, rate=0.5)
    got = net.plan(mode="temporal", temporal=cfg)(ev).logits.numpy()
    np.testing.assert_array_equal(
        got, np.asarray(ref.plan(mode="temporal", temporal=jcfg)(ev).logits))
    np.testing.assert_array_equal(got, temporal_forward_naive(net, ev, cfg))
    with pytest.raises(ValueError):                   # 60 is not 32-aligned
        _pair((100, 60, 10), 1)[1].plan(mode="temporal", temporal=cfg)


@pytest.mark.parametrize("seed", range(10))
def test_temporal_t1_bit_identical_to_packed(seed):
    """T=1, zero leak, zero reset == the packed plan, on random networks and
    spike batches (the reference's property, at its ten draws)."""
    rng = np.random.default_rng(seed)
    topo = [(128, 64, 10), (256, 128, 128, 10), (96, 32, 10)][seed % 3]
    _, net = _pair(topo, seed)
    ev = _events(seed + 1, 1, int(rng.integers(1, 9)), topo[0],
                 rate=float(rng.uniform(0.1, 0.9)))
    cfg = TemporalConfig(n_steps=1, leak=0.0, reset="zero", refractory=0)
    got = net.plan(mode="temporal", temporal=cfg)(ev).logits
    assert torch.equal(got, net.plan(mode="packed")(ev[0]).logits)


def test_temporal_plan_is_cached_per_spec():
    _, net = _pair((128, 64, 10), 21)
    cfg = TemporalConfig(n_steps=4)
    assert (net.plan(mode="temporal", temporal=cfg)
            is net.plan(mode="temporal", temporal=cfg))
    assert (net.plan(mode="temporal", temporal=cfg)
            is not net.plan(mode="temporal",
                            temporal=dataclasses.replace(cfg, n_steps=8)))
    with pytest.raises(ValueError, match="TemporalConfig"):
        net.plan(mode="temporal")            # needs a TemporalConfig
    with pytest.raises(ValueError, match="TemporalConfig"):
        net.plan(mode="packed", temporal=cfg)  # only temporal mode takes one
    assert NOT_PORTED_MODES == ()
    assert PlanSpec(mode="temporal", temporal=cfg).temporal == cfg


@pytest.mark.parametrize("kw", [dict(n_steps=0), dict(n_steps=2, leak=1.0),
                                dict(n_steps=2, leak=-0.1),
                                dict(n_steps=2, reset="hold"),
                                dict(n_steps=2, refractory=-1)])
def test_temporal_config_rejects_what_the_reference_rejects(kw):
    with pytest.raises(AssertionError):
        jtemporal.TemporalConfig(**kw)
    with pytest.raises(ValueError):
        TemporalConfig(**kw)


# ----------------------------------------------------------------------- #
# telemetry and the temporal cost model
# ----------------------------------------------------------------------- #
def test_temporal_telemetry_matches_per_step_popcounts():
    topo = (256, 128, 10)
    cfg, jcfg = _configs(n_steps=5, leak=0.25)
    ref, net = _pair(topo, 31)
    ev = _events(32, 5, 7, topo[0])
    res = net.plan(mode="temporal", temporal=cfg, collect=True,
                   telemetry=True)(ev)
    assert len(res.planes) == len(res.loads) == len(topo) - 1
    for pl, ld in zip(res.planes, res.loads):
        assert pl.shape[:2] == (7, 5) and ld.shape[:2] == (7, 5)
        assert torch.equal(ld, packing.group_popcount(pl))
    # tile 0's plane is the input stream itself (batch-first)
    np.testing.assert_array_equal(packing.words_to_np(res.planes[0]),
                                  packing.pack_spikes_np(ev).swapaxes(0, 1))
    # telemetry alone gives the same loads as the reference's plan
    want = ref.plan(mode="temporal", temporal=jcfg, telemetry=True)(ev)
    got = net.plan(mode="temporal", temporal=cfg, telemetry=True)(ev)
    _assert_loads_equal(got.loads, want.loads)
    np.testing.assert_array_equal(got.logits.numpy(), np.asarray(want.logits))


def test_temporal_request_stats_match_reference():
    rng = np.random.default_rng(0)
    topo = (768, 256, 256, 10)
    loads = [rng.integers(0, 129, size=(6, 9, -(-topo[t] // 128)))
             .astype(np.int32) for t in range(len(topo) - 1)]
    for p in (0, 2, 4):
        ref = jcm.temporal_request_stats(topo, loads, p)
        host = cm.temporal_request_stats(topo, loads, p)
        assert host["n_steps"] == ref["n_steps"] == 9
        for key in ("cycles_per_tile", "cycles", "latency_ns", "energy_pj",
                    "energy_pj_per_step"):
            assert host[key].dtype == np.float64
            np.testing.assert_array_equal(host[key], ref[key])
        dev = cm.temporal_request_stats_device(
            topo, [torch.from_numpy(ld) for ld in loads], p)
        jdev = jcm.temporal_request_stats_device(
            topo, [jnp.asarray(ld) for ld in loads], p)
        assert dev["n_steps"] == 9
        for key in ("cycles", "cycles_per_tile"):
            np.testing.assert_array_equal(dev[key].numpy(), ref[key])
            np.testing.assert_array_equal(dev[key].numpy(),
                                          np.asarray(jdev[key]))
        for key in ("latency_ns", "energy_pj", "energy_pj_per_step"):
            assert dev[key].dtype == torch.float32
            np.testing.assert_allclose(dev[key].numpy(), ref[key], rtol=1e-6)
            np.testing.assert_allclose(dev[key].numpy(),
                                       np.asarray(jdev[key]), rtol=1e-6)


def test_temporal_stream_cost_is_sum_of_per_step_costs():
    rng = np.random.default_rng(1)
    topo = (256, 128, 10)
    loads = [rng.integers(0, 129, size=(3, 4, -(-topo[t] // 128)))
             .astype(np.float64) for t in range(len(topo) - 1)]
    got = cm.temporal_request_stats(topo, loads, 4)
    want = sum(cm.request_stats(topo, [ld[:, t] for ld in loads], 4).energy_pj
               for t in range(4))
    np.testing.assert_allclose(got["energy_pj"], want, rtol=1e-12)


# ----------------------------------------------------------------------- #
# event-stream serving
# ----------------------------------------------------------------------- #
def _serve_mixed(eng, ev8, ev3, sp, event_cls, spike_cls, pack):
    e8 = [event_cls(events=ev8[:, i]) for i in range(ev8.shape[1])]
    e3 = [event_cls(events=pack(ev3[:, i])) for i in range(ev3.shape[1])]
    s = [spike_cls(spikes=sp[i]) for i in range(sp.shape[0])]
    eng.submit_events(e8[:2])
    eng.submit(e3[0])                     # submit() routes EventRequests too
    out = eng.serve(s + e8[2:] + e3[1:])
    assert len(out) == len(s) + len(e8) - 2 + len(e3) - 1
    return e8, e3, s


@pytest.mark.parametrize("leak,reset,refractory,ports",
                         [(0.25, "subtract", 0, 3), (0.125, "zero", 2, 4),
                          (0.0, "zero", 0, 0)])
def test_spike_engine_serves_event_streams_mixed_T(leak, reset, refractory,
                                                   ports):
    """Mixed-T streams (spikes and wire words) beside static requests:
    per-request logits, labels, served_steps and cycles bit for bit against
    the reference engine, energies within 1e-6 relative, and the stats."""
    topo = (256, 128, 10)
    ref, net = _pair(topo, 41)
    kw = dict(leak=leak, reset=reset, refractory=refractory)
    cfg, jcfg = _configs(n_steps=1, **kw)
    eng = engine.SpikeEngine(net, max_batch=4, min_bucket=2, telemetry=True,
                             read_ports=ports, temporal=cfg, device="cpu")
    jeng = jengine.SpikeEngine(ref, max_batch=4, min_bucket=2,
                               interpret=True, telemetry=True,
                               read_ports=ports, temporal=jcfg)
    ev8, ev3 = _events(42, 8, 5, topo[0]), _events(43, 3, 3, topo[0])
    sp = _events(44, 1, 2, topo[0])[0]
    got = _serve_mixed(eng, ev8, ev3, sp, engine.EventRequest,
                       engine.SpikeRequest, packing.pack_spikes_np)
    want = _serve_mixed(jeng, ev8, ev3, sp, jengine.EventRequest,
                        jengine.SpikeRequest, jpacking.pack_spikes_np)
    assert not eng._pending and not eng._pending_events and not eng._inflight
    for rs, qs in zip(got, want):
        for r, q in zip(rs, qs):
            assert r.status == q.status == "done"
            np.testing.assert_array_equal(r.logits, q.logits)
            assert r.label == q.label and r.cycles == q.cycles
            assert r.latency_ns == pytest.approx(q.latency_ns, rel=1e-6)
            assert r.energy_pj == pytest.approx(q.energy_pj, rel=1e-6)
    for r, q in zip(got[0] + got[1], want[0] + want[1]):
        assert r.served_steps == q.served_steps == r.n_steps
        assert r.energy_pj_per_step == pytest.approx(q.energy_pj_per_step,
                                                     rel=1e-6)
    # the streams against the oracle and the float64 cost model
    want8 = temporal_forward_naive(
        net, ev8, dataclasses.replace(cfg, n_steps=8))
    res = net.plan(mode="temporal", temporal=dataclasses.replace(
        cfg, n_steps=8), telemetry=True)(ev8)
    rs = cm.temporal_request_stats(
        net.topology, [ld.numpy() for ld in res.loads], ports)
    for i, r in enumerate(got[0]):
        np.testing.assert_array_equal(r.logits, want8[i])
        assert r.cycles == int(rs["cycles"][i])
        assert r.energy_pj == pytest.approx(float(rs["energy_pj"][i]),
                                            rel=1e-6)

    st, jst = eng.stats(), jeng.stats()
    assert st["n_requests"] == 2 and st["n_event_requests"] == 8
    assert st["timesteps_total"] == 5 * 8 + 3 * 3
    assert st["rounds_event"] == jst["rounds_event"] == 3
    for key in engine.stats_schema()["events"]:
        assert st[key] == pytest.approx(jst[key], rel=1e-6), key
    for key in ("rounds_static", "rows_real_total", "rows_padded_total",
                "rounds_per_bucket", "real_rows_per_bucket",
                "padded_rows_per_bucket", "n_requests", "cycles_mean"):
        assert st[key] == jst[key], key
    assert engine.stats_schema()["events"] == jengine.stats_schema()["events"]


def test_spike_engine_event_stats_empty():
    ref, net = _pair((128, 64, 10), 51)
    st = engine.SpikeEngine(net, telemetry=True, device="cpu").stats()
    jst = jengine.SpikeEngine(ref, interpret=True, telemetry=True).stats()
    assert st["n_event_requests"] == 0 and st["timesteps_total"] == 0
    assert st["energy_pj_per_timestep"] == 0.0
    assert st["event_energy_pj_mean"] == 0.0
    for key in engine.stats_schema()["events"]:
        assert st[key] == jst[key], key


def test_submit_events_takes_event_requests_only():
    _, net = _pair((128, 64, 10), 52)
    eng = engine.SpikeEngine(net, device="cpu")
    with pytest.raises(TypeError):
        eng.submit_events([engine.SpikeRequest(spikes=np.zeros(128))])
    # one request in, a list of one verdict out, as the reference does
    (v,) = eng.submit_events(engine.EventRequest(events=np.zeros((2, 128))))
    assert v.admitted and eng.queue_depth() == 1


def test_launcher_serves_events_on_cpu(capsys):
    run = serve_mod.main(["--events", "--smoke", "--requests", "12",
                          "--device", "cpu"])
    assert run.net.topology == (768, 256, 10)
    assert len(run.requests) == len(run.warm_requests) == 12
    st = run.engine.stats()
    assert st["n_event_requests"] == 12 and st["n_requests"] == 0
    assert st["timesteps_total"] == sum(r.n_steps for r in run.requests)
    assert {r.n_steps for r in run.requests} <= {2, 4}
    for r, w in zip(run.requests, run.warm_requests):
        assert r.label is not None and r.cycles > 0
        np.testing.assert_array_equal(r.logits, w.logits)
    # each stream against the plan run on it alone
    cfg = TemporalConfig(n_steps=1, leak=0.125)
    for r in run.requests[:3]:
        plan = run.net.plan(mode="temporal", temporal=dataclasses.replace(
            cfg, n_steps=r.n_steps))
        np.testing.assert_array_equal(r.logits, plan(r.events).logits.numpy())
    out = capsys.readouterr().out
    assert "steps/s" in out and "pJ/timestep" in out


# ----------------------------------------------------------------------- #
# the CUDA LIF step against its plain version, on the card
# ----------------------------------------------------------------------- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 256), (4096, 256), (1, 1), (7, 100)])
@pytest.mark.parametrize("leak", [0.0, 0.125, 0.3])
@pytest.mark.parametrize("reset", ["zero", "subtract"])
@pytest.mark.parametrize("refractory", [0, 2])
def test_cuda_lif_step_matches_plain(cuda, shape, leak, reset, refractory):
    B, N = shape
    vmem, contrib, vth, refrac = _lif_operands(B + N, B, N, refractory)
    vth[::3] = 2**31 - 1
    ops = [torch.from_numpy(a).to(cuda) for a in (vmem, contrib, vth, refrac)]
    kw = dict(leak=leak, reset=reset, refractory=refractory)
    lif_ops.reset_launch_counts()
    got = lif_ops.lif_step(*ops, **kw)
    assert lif_ops.launch_counts() == {"lif_step": 1}
    for g, w in zip(got, lif_step_ref(*ops, **kw)):
        assert g.dtype == w.dtype and torch.equal(g, w)
