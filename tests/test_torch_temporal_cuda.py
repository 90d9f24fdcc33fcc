"""repro_torch's CUDA LIF step and event-round scan against their plain
versions, and the temporal plan on the card against its CPU twin.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports no JAX, so it runs on the card's machine, where the
JAX package is not installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_temporal_cuda.py

``lif_step`` against ``lif_step_ref`` (ties at the threshold, thresholds at
2^31 - 1, every leak, reset and refractory setting, N and B N not
multiples of 4, operands at an offset); ``temporal_scan`` against
``temporal_scan_ref`` at the event path's rounds, ragged ones, hidden
widths that are not multiples of 32, a stack deeper than one launch takes,
the register route's edges (streams around its clusters of 8 and 16,
widths around a K step, 4 and 5 hidden tiles, c_in at an offset) and on
each route, which each shape is asserted to take; the temporal plan on the
card (one ``popcount_mac`` and one ``temporal_scan`` a call) against the
same network on the CPU, built from numpy draws.  The plain versions are
held against the reference in ``test_torch_temporal.py``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core.esam.network import EsamNetwork
from repro_torch.core.esam.temporal import TemporalConfig
from repro_torch.kernels.lif_step import ops as lif_ops
from repro_torch.kernels.lif_step.ref import lif_step_ref

#: more hidden tiles than one temporal_scan launch takes, narrow
DEEP_TOPOLOGY = (20,) + (9, 40) * 17 + (5,)


def _network(topo, seed):
    """A CPU network of random weight bits, thresholds and offsets."""
    rng = np.random.default_rng(seed)
    bits = [rng.integers(0, 2, size=(k, n), dtype=np.int8)
            for k, n in zip(topo[:-1], topo[1:])]
    vth = [rng.integers(-10, 10, size=(n,), dtype=np.int32) for n in topo[1:]]
    off = rng.normal(size=(topo[-1],)).astype(np.float32)
    return EsamNetwork.from_numpy(bits, vth, off, device="cpu")


def _events(seed, n_steps, batch, n_in, rate=0.3):
    return (np.random.default_rng(seed).random((n_steps, batch, n_in))
            < rate).astype(np.uint8)


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


# ----------------------------------------------------------------------- #
# the CUDA LIF step against its plain version, on the card
# ----------------------------------------------------------------------- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 256), (4096, 256), (1, 1), (7, 100),
                                   (7, 99), (3, 5), (5, 6), (2, 3)])
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
    assert lif_ops.launch_counts() == {"lif_step": 1, "temporal_scan": 0}
    for g, w in zip(got, lif_step_ref(*ops, **kw)):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 256), (7, 99)])
@pytest.mark.parametrize("offset", [1, 2])
def test_cuda_lif_step_at_an_offset(cuda, shape, offset):
    """Operands that are views at an offset (not 16-byte aligned), with the
    same bits."""
    B, N = shape
    arrays = _lif_operands(offset + N, B, N, 2)
    ops = []
    for a in arrays:
        flat = torch.from_numpy(np.concatenate(
            [np.zeros(offset, a.dtype), a.ravel()])).to(cuda)
        ops.append(flat[offset:].view(a.shape))
    kw = dict(leak=0.125, reset="subtract", refractory=2)
    got = lif_ops.lif_step(*ops, **kw)
    for g, w in zip(got, lif_step_ref(*ops, **kw)):
        assert g.dtype == w.dtype and torch.equal(g, w)


# ----------------------------------------------------------------------- #
# the CUDA temporal scan against its plain version, on the card
# ----------------------------------------------------------------------- #
PAPER_HIDDEN = (256, 256, 256)


def _random_scan_operands(seed, hidden, n_cls, n_steps, batch, device):
    """Scan operands of random planes: c_in in [-40, 40], full 32-bit plane
    words, thresholds in [-8, 8] (some at 2^31 - 1)."""
    rng = np.random.default_rng(seed)
    n_first = hidden[0] if hidden else n_cls
    c_in = rng.integers(-40, 41, size=(n_steps, batch, n_first),
                        dtype=np.int32)
    widths = list(hidden) + [n_cls]
    planes = [rng.integers(-2**31, 2**31, size=(widths[i + 1], -(-n // 32)),
                           dtype=np.int64).astype(np.int32)
              for i, n in enumerate(hidden)]
    vth = [rng.integers(-8, 9, size=(n,), dtype=np.int32) for n in hidden]
    for th in vth:
        th[rng.random(th.shape) < 0.1] = 2**31 - 1
    return (torch.from_numpy(c_in).to(device),
            tuple(torch.from_numpy(w).to(device) for w in planes),
            tuple(torch.from_numpy(th).to(device) for th in vth))


def _assert_scan_equal(got, want):
    assert got[0].dtype == torch.float32 and torch.equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert (g is None) == (w is None)
        if g is not None:
            assert len(g) == len(w)
            assert all(torch.equal(a, b) for a, b in zip(g, w))


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,batch,n_steps", [
    (PAPER_HIDDEN, 64, 4), (PAPER_HIDDEN, 64, 8), (PAPER_HIDDEN, 64, 16),
    (PAPER_HIDDEN, 1, 5), (PAPER_HIDDEN, 7, 5), ((), 64, 8), ((256,), 7, 8),
    ((128, 384), 33, 3), ((31,), 2, 3), ((37, 70, 33), 5, 3),
    ((129, 255), 64, 3), (DEEP_TOPOLOGY[1:-1], 3, 2)])
@pytest.mark.parametrize("leak,reset,refractory", [
    (0.125, "zero", 0), (0.125, "subtract", 2), (0.3, "zero", 2),
    (0.0, "subtract", 0), (0.7, "subtract", 3)])
def test_cuda_temporal_scan_matches_plain(cuda, hidden, batch, n_steps, leak,
                                          reset, refractory):
    """The kernel against its plain version: the paper's and ragged rounds,
    hidden widths that are not multiples of 32 (telemetry where the widths
    are row groups of 128), and a stack deeper than one launch takes (two
    launches with a popcount_mac between)."""
    from repro_torch.kernels.cim_popcount import ops as pop_ops

    ops = _random_scan_operands(batch + n_steps + len(hidden), hidden, 10,
                                n_steps, batch, cuda)
    kw = dict(leak=leak, reset=reset, refractory=refractory, collect=True,
              telemetry=all(n % 128 == 0 for n in hidden))
    want = lif_ops.temporal_scan_ref(*ops, **kw)
    lif_ops.reset_launch_counts()
    pop_ops.reset_launch_counts()
    _assert_scan_equal(lif_ops.temporal_scan(*ops, **kw), want)
    launches = -(-len(hidden) // lif_ops.SCAN_MAX_HIDDEN) if hidden else 1
    assert lif_ops.launch_counts() == {"lif_step": 0,
                                       "temporal_scan": launches}
    assert pop_ops.launch_counts()["popcount_mac"] == launches - 1
    bare = lif_ops.temporal_scan(*ops, leak=leak, reset=reset,
                                 refractory=refractory)
    assert bare[1] is None and bare[2] is None
    assert torch.equal(bare[0], want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,batch,n_steps,route", [
    ((2048, 2048), 9, 4, "planes_global"),   # planes past shared memory
    ((16384, 16384), 2, 2, "state_global"),  # state past it as well
])
def test_cuda_temporal_scan_past_shared_memory(cuda, hidden, batch, n_steps,
                                               route):
    took = lif_ops._scan_route(torch.cuda.current_device(), hidden, 10)
    assert took.name == route
    ops = _random_scan_operands(11, hidden, 10, n_steps, batch, cuda)
    kw = dict(leak=0.125, reset="zero", refractory=2, collect=True,
              telemetry=True)
    _assert_scan_equal(lif_ops.temporal_scan(*ops, **kw),
                       lif_ops.temporal_scan_ref(*ops, **kw))


#: the register route's edges, each with the route it must take: streams
#: around its clusters of 8 and 16, widths around a K step (a first width
#: that is not a multiple of 4 takes the shared-memory route), 4 and 5
#: hidden tiles
SCAN_EDGES = [
    (PAPER_HIDDEN, 15, "regs"), (PAPER_HIDDEN, 16, "regs"),
    (PAPER_HIDDEN, 17, "regs"), (PAPER_HIDDEN, 33, "regs"),
    ((255,), 16, "smem"), ((256,), 16, "regs"), ((257,), 16, "smem"),
    ((256, 255), 17, "regs"), ((256, 257), 17, "regs"),
    ((252, 129, 256), 17, "regs"), ((255, 129, 256), 17, "smem"),
    ((256, 256, 257), 17, "smem"), ((1024,), 5, "smem"), ((512, 512), 3, "regs"),
    ((256,) * 4, 17, "regs"), ((256,) * 5, 17, "smem"),
    ((128, 384), 33, "regs"), ((512, 512, 512), 3, "smem"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,batch,route", SCAN_EDGES)
@pytest.mark.parametrize("leak,reset,refractory", [
    (0.125, "zero", 0), (0.7, "subtract", 3)])
def test_cuda_temporal_scan_register_route_edges(cuda, hidden, batch, route,
                                                 leak, reset, refractory):
    """The kernel against its plain version at the register route's edges,
    and the route each shape takes."""
    took = lif_ops._scan_route(torch.cuda.current_device(), hidden, 10)
    assert took.name == route
    ops = _random_scan_operands(batch + len(hidden), hidden, 10, 5, batch,
                                cuda)
    kw = dict(leak=leak, reset=reset, refractory=refractory, collect=True,
              telemetry=all(n % 128 == 0 for n in hidden))
    lif_ops.reset_launch_counts()
    _assert_scan_equal(lif_ops.temporal_scan(*ops, **kw),
                       lif_ops.temporal_scan_ref(*ops, **kw))
    assert lif_ops.launch_counts()["temporal_scan"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,batch", [(PAPER_HIDDEN, 64),
                                          (PAPER_HIDDEN, 17), ((256,), 7)])
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_cuda_temporal_scan_c_in_at_an_offset(cuda, hidden, batch, offset):
    """c_in as a contiguous view at an offset (not 16-byte aligned) on the
    register route: the wrapper copies it to whole 16-byte rows, with the
    plain version's bits."""
    ops = _random_scan_operands(batch + offset, hidden, 10, 6, batch, cuda)
    flat = torch.zeros(offset + ops[0].numel(), dtype=torch.int32,
                       device=cuda)
    flat[offset:] = ops[0].reshape(-1)
    c_in = flat[offset:].view(ops[0].shape)
    assert c_in.is_contiguous() and c_in.data_ptr() % 16
    assert lif_ops._scan_route(torch.cuda.current_device(), hidden,
                               10).name == "regs"
    kw = dict(leak=0.125, reset="subtract", refractory=2, collect=True,
              telemetry=True)
    _assert_scan_equal(lif_ops.temporal_scan(c_in, *ops[1:], **kw),
                       lif_ops.temporal_scan_ref(c_in, *ops[1:], **kw))


@pytest.mark.cuda
def test_cuda_temporal_plan_is_one_mac_and_one_scan(cuda):
    """On the card the temporal plan is one popcount_mac (tile 0) and one
    temporal_scan a call, with the CPU plan's logits, planes and loads."""
    from repro_torch.kernels.cim_popcount import ops as pop_ops

    topo = (768,) + PAPER_HIDDEN + (10,)
    net = _network(topo, 12)
    gpu = EsamNetwork.from_numpy(*net.to_numpy(), device=cuda)
    cfg = TemporalConfig(n_steps=6, leak=0.125, reset="subtract",
                         refractory=2)
    ev = _events(13, 6, 64, topo[0])
    want = net.plan(mode="temporal", temporal=cfg, collect=True,
                    telemetry=True)(ev)
    plan = gpu.plan(mode="temporal", temporal=cfg, collect=True,
                    telemetry=True)
    lif_ops.reset_launch_counts()
    pop_ops.reset_launch_counts()
    got = plan(ev)
    assert lif_ops.launch_counts() == {"lif_step": 0, "temporal_scan": 1}
    assert pop_ops.launch_counts()["popcount_mac"] == 1
    assert torch.equal(got.logits.cpu(), want.logits)
    for g, w in zip(got.planes + got.loads, want.planes + want.loads):
        assert torch.equal(g.cpu(), w)
