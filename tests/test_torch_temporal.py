"""repro_torch's temporal event plane against repro's, on the CPU.

The twin of tests/test_temporal.py.  The same seeded numpy inputs go through
both packages: the LIF step (bit for bit against ``jax.jit`` of the
reference, whose compiler rounds the leak and the integrate once, as one
fused multiply-add), the event round's scan (``temporal_scan_ref`` and the
CPU wrapper against the reference's ``temporal_forward`` at 0, 1 and 3
hidden tiles, every leak, reset and refractory setting, T 1 and 5, with and
without collect and telemetry; ``temporal_forward`` also at hidden widths
that are not multiples of 32 and deeper than one scan launch takes), the
temporal plan (logits, planes and loads
bit for bit), the temporal cost model, and event-stream serving through
``SpikeEngine``.  The CUDA LIF step and scan against their plain versions
are in ``test_torch_temporal_cuda.py``, which imports no JAX.
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
    init_state,
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


#: the single step's ragged shapes: N not a multiple of 4, B x N not a
#: multiple of 4 (1-3 elements past the last 16 bytes), one element
LIF_RAGGED = [(7, 99), (3, 5), (5, 6), (1, 1), (2, 3)]


@pytest.mark.parametrize("shape", LIF_RAGGED, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("reset,refractory", [("zero", 0), ("subtract", 2)])
def test_lif_step_ragged_shapes_match_jitted_reference(shape, reset,
                                                       refractory):
    """Ragged shapes, bit for bit against jax.jit(lif_step_ref) through the
    CPU wrapper."""
    B, N = shape
    ops = _lif_operands(B * N + refractory, B, N, refractory)
    kw = dict(leak=0.125, reset=reset, refractory=refractory)
    want = [np.asarray(a) for a in _jit_lif(*map(jnp.asarray, ops), **kw)]
    got = lif_ops.lif_step(*map(torch.from_numpy, ops), **kw)
    for g, w in zip(got, want):
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
    assert lif_ops.launch_counts() == {"lif_step": 0,   # the plain path
                                       "temporal_scan": 0}
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


#: (leak, reset, refractory) of the scan's cases
SCAN_DYNAMICS = [(leak, reset, refractory) for leak in (0.0, 0.125, 0.3)
                 for reset in ("zero", "subtract") for refractory in (0, 2)]
#: 0, 1 and 3 hidden tiles at n_in 100 and 768 (hidden widths in row groups
#: of 128, so telemetry applies)
SCAN_TOPOLOGIES = [(n_in,) + hidden + (10,) for n_in in (100, 768)
                   for hidden in ((), (128,), (128, 256, 128))]


def _scan_operands(net, ev):
    """(c_in, hidden planes, hidden thresholds) of a CPU network's scan:
    tile 0's exact MAC of the packed events, then the scan's operands."""
    from repro_torch.core.esam.temporal import mac_operands
    from repro_torch.kernels.cim_popcount.ref import cim_popcount_ref

    planes = mac_operands(net.weight_bits)
    words = packing.words_from_np(packing.pack_spikes_np(ev))
    t, b, _ = words.shape
    c_in = cim_popcount_ref(words.reshape(t * b, -1), planes[0]).reshape(
        t, b, -1)
    return c_in, planes[1:], tuple(net.vth[:-1])


@pytest.mark.parametrize("topo", SCAN_TOPOLOGIES,
                         ids=lambda t: ":".join(map(str, t)))
@pytest.mark.parametrize("leak,reset,refractory", SCAN_DYNAMICS)
def test_temporal_scan_matches_reference(topo, leak, reset, refractory):
    """temporal_scan_ref (fed tile 0's MAC) and temporal_forward against the
    reference's temporal_forward, bit for bit: logits, every hidden tile's
    spike words and loads, at T 1 and 5, with collect and telemetry each on
    and off."""
    from repro_torch.core.esam import temporal as ttemporal
    from repro_torch.kernels.lif_step.ref import temporal_scan_ref

    kw = dict(leak=leak, reset=reset, refractory=refractory)
    ref, net = _pair(topo, len(topo) + int(leak * 8) + refractory)
    for n_steps in (1, 5):
        cfg, jcfg = _configs(n_steps=n_steps, **kw)
        ev = _events(n_steps + topo[0], n_steps, 6, topo[0], rate=0.35)
        want = jtemporal.temporal_forward(
            ref.weight_bits, ref.vth, ref.out_offset,
            jnp.asarray(jpacking.pack_spikes_np(ev)), jcfg, collect=True,
            telemetry=True)
        want_logits = np.asarray(want["logits"])
        c_in, planes, vth = _scan_operands(net, ev)
        weights = ttemporal.mac_operands(net.weight_bits)
        words = packing.words_from_np(packing.pack_spikes_np(ev))
        for collect in (False, True):
            for telemetry in (False, True):
                flags = dict(collect=collect, telemetry=telemetry)
                out_v, w, ld = temporal_scan_ref(c_in, planes, vth, **kw,
                                                 **flags)
                got = ttemporal.temporal_forward(
                    weights, net.vth, net.out_offset, words, cfg, topo,
                    **flags)
                for logits in (out_v + net.out_offset, got["logits"]):
                    assert logits.dtype == torch.float32
                    np.testing.assert_array_equal(logits.numpy(),
                                                  want_logits)
                assert (w is None) == (not collect)
                assert (ld is None) == (not telemetry)
                if collect:
                    _assert_planes_equal([p.transpose(0, 1) for p in w],
                                         want["planes"][1:])
                    _assert_planes_equal(got["planes"], want["planes"])
                if telemetry:
                    _assert_loads_equal([x.transpose(0, 1) for x in ld],
                                        want["loads"][1:])
                    _assert_loads_equal(got["loads"], want["loads"])


def test_temporal_scan_wrapper_checks_and_counts():
    """The CPU wrapper is the plain version and launches nothing; it raises
    on bad types, shapes, widths and mixed devices."""
    from repro_torch.kernels.lif_step.ref import temporal_scan_ref

    _, net = _pair((100, 128, 256, 10), 5)
    ev = _events(6, 3, 4, 100)
    c_in, planes, vth = _scan_operands(net, ev)
    kw = dict(leak=0.125, reset="subtract", refractory=2, collect=True,
              telemetry=True)
    lif_ops.reset_launch_counts()
    got = lif_ops.temporal_scan(c_in, planes, vth, **kw)
    want = temporal_scan_ref(c_in, planes, vth, **kw)
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1] + got[2], want[1] + want[2]):
        assert torch.equal(g, w)
    assert [w.shape for w in got[1]] == [(3, 4, 4), (3, 4, 8)]
    assert [x.shape for x in got[2]] == [(3, 4, 1), (3, 4, 2)]
    assert lif_ops.launch_counts() == {"lif_step": 0, "temporal_scan": 0}
    bad = [
        (c_in[0], planes, vth, {}),                     # not [T, B, N]
        (c_in.float(), planes, vth, {}),                # not int32
        (c_in[:0], planes, vth, {}),                    # no step
        (c_in[..., :64], planes, vth, {}),              # c_in != N_1
        (c_in, planes[:1], vth, {}),                    # tiles differ
        (c_in, (planes[0][:, :2], planes[1]), vth, {}),  # plane words
        (c_in, (planes[0][:100], planes[1]), vth, {}),   # next tile rows
        (c_in, (planes[0].to(torch.int64), planes[1]), vth, {}),
        (c_in, planes, (vth[0].to(torch.int64), vth[1]), {}),
        (c_in, planes, vth, {"reset": "hold"}),
        (c_in, planes, vth, {"refractory": -1}),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            lif_ops.temporal_scan(*args[:3], **args[3])
    # any hidden width (ceil(N/32) plane words); row groups of 128 for
    # telemetry
    _, net96 = _pair((100, 96, 10), 6)
    c96, p96, v96 = _scan_operands(net96, ev)
    lif_ops.temporal_scan(c96, p96, v96, collect=True)
    with pytest.raises(ValueError, match="row groups"):
        lif_ops.temporal_scan(c96, p96, v96, telemetry=True)
    got = lif_ops.temporal_scan(c96[..., :90], (p96[0][:, :3],),
                                (v96[0][:90],), collect=True)
    want = temporal_scan_ref(c96[..., :90], (p96[0][:, :3],),
                             (v96[0][:90],), collect=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1][0], want[1][0])
    assert got[1][0].shape == (3, 4, 3)
    with pytest.raises(ValueError, match=r"planes\[0\]"):
        lif_ops.temporal_scan(c96[..., :90], (p96[0][:, :2],),
                              (v96[0][:90],))
    with pytest.raises(ValueError, match="N >= 1"):
        lif_ops.temporal_scan(c96[..., :0], (p96[0][:, :0],), (v96[0][:0],))
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="different devices"):
        lif_ops.temporal_scan(c_in, (planes[0].to(meta), planes[1]), vth)
    with pytest.raises(ValueError, match="different devices"):
        lif_ops.temporal_scan(c_in.to(meta), planes, vth)


#: the register route's edges: streams around its clusters of 8 and 16 (a
#: ragged last cluster), hidden widths around a K step of 256 bits (first
#: and second tile), 4 hidden tiles (its depth) and 5 (past it: the
#: shared-memory route)
EDGE_TOPOLOGIES = [
    ((100, 256, 256, 10), 15), ((100, 256, 256, 10), 16),
    ((100, 256, 256, 10), 17), ((100, 256, 256, 10), 33),
    ((100, 255, 10), 16), ((100, 256, 10), 16), ((100, 257, 10), 16),
    ((100, 256, 255, 10), 16), ((100, 256, 257, 10), 16),
    ((128,) * 5 + (10,), 5), ((128,) * 6 + (10,), 5),
]


@pytest.mark.parametrize("topo,batch", EDGE_TOPOLOGIES, ids=lambda x: (
    ":".join(map(str, x)) if isinstance(x, tuple) else f"B{x}"))
@pytest.mark.parametrize("reset,refractory", [("zero", 0), ("subtract", 3)])
def test_temporal_scan_register_route_edges(topo, batch, reset, refractory):
    """temporal_scan_ref (fed tile 0's MAC) and temporal_forward against the
    reference's temporal_forward, bit for bit, at the shapes where the
    card's register route changes its geometry: logits, every hidden
    tile's spike words, and their loads where the widths are row groups of
    128, at T 4, leak 0.125."""
    from repro_torch.core.esam import temporal as ttemporal
    from repro_torch.kernels.lif_step.ref import temporal_scan_ref

    cfg, jcfg = _configs(n_steps=4, leak=0.125, reset=reset,
                         refractory=refractory)
    ref, net = _pair(topo, batch + len(topo) + refractory)
    ev = _events(batch + refractory, 4, batch, topo[0], rate=0.35)
    telemetry = all(n % 128 == 0 for n in topo[1:-1])
    flags = dict(collect=True, telemetry=telemetry)
    want = jtemporal.temporal_forward(
        ref.weight_bits, ref.vth, ref.out_offset,
        jnp.asarray(jpacking.pack_spikes_np(ev)), jcfg, **flags)
    kw = dict(leak=0.125, reset=reset, refractory=refractory)
    c_in, planes, vth = _scan_operands(net, ev)
    out_v, words, loads = temporal_scan_ref(c_in, planes, vth, **kw, **flags)
    got = ttemporal.temporal_forward(
        ttemporal.mac_operands(net.weight_bits), net.vth, net.out_offset,
        packing.words_from_np(packing.pack_spikes_np(ev)), cfg, topo, **flags)
    for logits in (out_v + net.out_offset, got["logits"]):
        np.testing.assert_array_equal(logits.numpy(),
                                      np.asarray(want["logits"]))
    _assert_planes_equal([p.transpose(0, 1) for p in words],
                         want["planes"][1:])
    _assert_planes_equal(got["planes"], want["planes"])
    if telemetry:
        _assert_loads_equal([x.transpose(0, 1) for x in loads],
                            want["loads"][1:])
        _assert_loads_equal(got["loads"], want["loads"])


@pytest.mark.parametrize("hidden,n_cls,want", [
    ((256, 256, 256), 10, ("regs", 1)),     # the paper's
    ((256, 255), 10, ("regs", 1)),
    ((256, 257), 10, ("regs", 2)),          # a second K step
    ((512, 512), 10, ("regs", 2)),
    ((256,) * 4, 10, ("regs", 1)),          # the route's depth
    ((256,), 64, ("regs", 1)),              # 8 readout tiles
    ((4,), 1, ("regs", 1)),
    ((256,), 65, None),                     # readout too wide
    ((256,) * 5, 10, None),                 # too deep
    ((260, 255, 256), 10, None),            # 512 at three tiles
    ((255,), 10, None),                     # c_in rows not 16 B
    ((257, 256), 10, None),
    ((1024,), 10, None),                    # past the registers
    ((2048, 2048), 10, None),
    ((), 10, None),                         # no hidden tile
])
def test_scan_register_route_by_shape(hidden, n_cls, want):
    """Which shapes the register route takes (pure; the card's routes past
    it are held in test_torch_temporal_cuda.py): depth, widths and readout
    within what it is instantiated for."""
    route = lif_ops._regs_route(hidden, n_cls)
    if want is None:
        assert route is None
    else:
        assert (route.name, route.steps) == want


#: hidden widths that are not multiples of 32 (the reference computes them)
UNALIGNED_TOPOLOGIES = [(65, 31, 7), (100, 37, 70, 33, 10), (33, 129, 255, 3)]
#: more hidden tiles than one temporal_scan launch takes, narrow
DEEP_TOPOLOGY = (20,) + (9, 40) * 17 + (5,)


def _forward_pair(topo, cfg, jcfg, ev, collect):
    """(port, reference) temporal_forward of one CPU network pair."""
    from repro_torch.core.esam import temporal as ttemporal

    ref, net = _pair(topo, sum(topo) % 97)
    want = jtemporal.temporal_forward(
        ref.weight_bits, ref.vth, ref.out_offset,
        jnp.asarray(jpacking.pack_spikes_np(ev)), jcfg, collect=collect)
    got = ttemporal.temporal_forward(
        ttemporal.mac_operands(net.weight_bits), net.vth, net.out_offset,
        packing.words_from_np(packing.pack_spikes_np(ev)), cfg, topo,
        collect=collect)
    return got, want


@pytest.mark.parametrize("topo", UNALIGNED_TOPOLOGIES + [DEEP_TOPOLOGY],
                         ids=lambda t: ":".join(map(str, t[:5]))
                         + f"-{len(t) - 2}h")
@pytest.mark.parametrize("leak", [0.0, 0.7])
@pytest.mark.parametrize("reset", ["zero", "subtract"])
@pytest.mark.parametrize("refractory", [0, 3])
def test_temporal_forward_any_hidden_width_and_depth(topo, leak, reset,
                                                     refractory):
    """The port's temporal_forward against the reference's, bit for bit, at
    hidden widths that are not multiples of 32 (T 3) and at more hidden
    tiles than one scan launch takes (T 2): logits, and the collected
    planes with collect on (telemetry off: the reference's loads need row
    groups of 128)."""
    n_steps = 2 if topo == DEEP_TOPOLOGY else 3
    cfg, jcfg = _configs(n_steps=n_steps, leak=leak, reset=reset,
                         refractory=refractory)
    ev = _events(len(topo) + refractory, n_steps, 5, topo[0], rate=0.4)
    for collect in (False, True):
        got, want = _forward_pair(topo, cfg, jcfg, ev, collect)
        np.testing.assert_array_equal(got["logits"].numpy(),
                                      np.asarray(want["logits"]))
        assert ("planes" in got) == collect
        if collect:
            _assert_planes_equal(got["planes"], want["planes"])
            assert [p.shape[-1] for p in got["planes"]] == [
                -(-n // 32) for n in topo[:-1]]


@pytest.mark.parametrize("max_hidden", [1, 2, 4, 32])
def test_temporal_scan_in_launches_matches_one_scan(max_hidden):
    """The card's split of a deep stack into launches of at most
    ``max_hidden`` hidden tiles (run here with the plain scan per launch):
    the same readout, words and loads as one plain scan."""
    from repro_torch.kernels.lif_step.ref import temporal_scan_ref

    _, net = _pair((100, 128, 256, 128, 384, 128, 10), max_hidden)
    c_in, planes, vth = _scan_operands(net, _events(max_hidden, 4, 3, 100))
    kw = dict(leak=0.3, reset="subtract", refractory=2, collect=True,
              telemetry=True)
    got = lif_ops._scan_in_launches(c_in, planes, vth, scan=temporal_scan_ref,
                                    max_hidden=max_hidden, **kw)
    want = temporal_scan_ref(c_in, planes, vth, **kw)
    assert torch.equal(got[0], want[0])
    assert len(got[1]) == len(got[2]) == 5
    for g, w in zip(got[1] + got[2], want[1] + want[2]):
        assert torch.equal(g, w)
    bare = lif_ops._scan_in_launches(
        c_in, planes, vth, scan=temporal_scan_ref, max_hidden=max_hidden,
        leak=0.3, reset="subtract", refractory=2, collect=False,
        telemetry=False)
    assert bare[1] is None and bare[2] is None
    assert torch.equal(bare[0], want[0])


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


def test_init_state_defaults_to_the_card():
    """``init_state`` puts the state on the card unless told otherwise; with
    no GPU the default raises, as ``resolve_device`` does."""
    topo = (64, 32, 32, 10)
    if torch.cuda.is_available():
        hidden, out_v = init_state(topo, 3)
        assert out_v.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_state(topo, 3)
    hidden, out_v = init_state(topo, 3, device="cpu")
    assert [(v.shape, v.dtype, r.dtype) for v, r in hidden] == [
        ((3, 32), torch.float32, torch.int32)] * 2
    assert out_v.shape == (3, 10) and out_v.device.type == "cpu"


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
