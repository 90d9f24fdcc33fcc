"""repro_torch's serving plane on the card: the telemetry kernels against
their plain versions, and ``SpikeEngine``'s warmed (CUDA graph), cold and
synchronous drains against one another and against the CPU engine.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports no JAX, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_serve_cuda.py

``tile_loads`` and ``request_stats`` bit for bit at the serving paths'
shapes (paper topology, B 1-333, T 1/4/16, cell options 0-4, all-zero and
all-full loads, a plane view that is not 16-byte aligned); a warmed engine
(one graph a bucket) against a cold overlapped one and a synchronous one;
two rounds of one bucket in one drain keeping their own logits (the
graph's outputs are copied out before the next replay); a weight written
in place after warmup (the graph is captured again, never replayed
stale); a ladder level that changes the read ports after warmup; no
library build and no capture while a warmed engine serves; the pinned
host slots reused over many overlapped rounds."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core.esam import cost_model as cm
from repro_torch.core.esam.network import EsamNetwork
from repro_torch.kernels import _build
from repro_torch.kernels.telemetry import ops as tele
from repro_torch.serve import engine
from repro_torch.serve.overload import DegradationLadder, LadderLevel

PAPER = cm.PAPER_TOPOLOGY


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _bits(topo=PAPER, seed=0):
    rng = np.random.default_rng(seed)
    bits = [rng.integers(0, 2, size=(k, n), dtype=np.int8)
            for k, n in zip(topo[:-1], topo[1:])]
    vth = [rng.integers(-3, 4, size=(n,), dtype=np.int32) for n in topo[1:]]
    off = rng.normal(size=(topo[-1],)).astype(np.float32)
    return bits, vth, off


def _spikes(n, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.random(PAPER[0]) < 0.4).astype(np.uint8) for _ in range(n)]


def _streams(n, t, seed=1):
    rng = np.random.default_rng(seed)
    return [(rng.random((t, PAPER[0])) < 0.3).astype(np.uint8)
            for _ in range(n)]


def _loads(batch, dev, steps=None, fill="random", seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for k, n in zip(PAPER[:-1], PAPER[1:]):
        g = cm.tile_geometry(k, n)[0]
        shape = (batch, g) if steps is None else (steps, batch, g)
        a = rng.integers(0, 129, size=shape, dtype=np.int32)
        if fill != "random":
            a[...] = 0 if fill == "zeros" else 128
        t = torch.from_numpy(a).to(dev)
        out.append(t if steps is None else t.transpose(0, 1))
    return out


def _serve(eng, spikes=(), streams=()):
    reqs = [engine.SpikeRequest(spikes=s) for s in spikes]
    reqs += [engine.EventRequest(events=e) for e in streams]
    eng.serve(reqs)
    return reqs


def _same(got, want, exact=True):
    for g, w in zip(got, want):
        assert g.status == w.status == "done"
        np.testing.assert_array_equal(g.logits, w.logits)
        assert g.label == w.label and g.cycles == w.cycles
        for f in ("latency_ns", "energy_pj", "energy_pj_per_step"):
            if exact:
                assert getattr(g, f, None) == getattr(w, f, None), f
            elif getattr(w, f, None) is not None:
                assert getattr(g, f) == pytest.approx(getattr(w, f),
                                                      rel=1e-6), f


@pytest.mark.cuda
@pytest.mark.parametrize("fill", ["random", "zeros", "full"])
@pytest.mark.parametrize("batch", [1, 7, 128, 333])
@pytest.mark.parametrize("read_ports", range(5))
def test_cuda_request_stats_matches_plain(cuda, read_ports, batch, fill):
    loads = _loads(batch, cuda, fill=fill, seed=batch)
    logits = torch.randn(batch, PAPER[-1], device=cuda)
    got = tele.request_stats(loads, PAPER, read_ports, logits=logits)
    want = tele.stats_slab_ref(
        tele.request_stats_ref(PAPER, loads, read_ports), 4, False, logits)
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), tele.stats_slab_ref(
        tele.request_stats_ref(PAPER, [ld.cpu() for ld in loads],
                               read_ports), 4, False, logits.cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [7, 64])
@pytest.mark.parametrize("steps", [1, 4, 16])
@pytest.mark.parametrize("read_ports", [0, 2, 4])
def test_cuda_temporal_request_stats_matches_plain(cuda, read_ports, steps,
                                                   batch):
    loads = _loads(batch, cuda, steps=steps, seed=steps)
    got = tele.request_stats(loads, PAPER, read_ports, temporal=True)
    want = tele.stats_slab_ref(
        tele.temporal_request_stats_ref(PAPER, loads, read_ports), 4, True)
    assert torch.equal(got, want)
    cpu = tele.stats_slab_ref(tele.temporal_request_stats_ref(
        PAPER, [ld.cpu() for ld in loads], read_ports), 4, True)
    assert torch.equal(got.cpu(), cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(128, 24), (7, 8), (1, 24), (16, 64, 24),
                                   (333, 4)])
def test_cuda_tile_loads_matches_plain(cuda, shape):
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy(rng.integers(0, 2 ** 32, size=shape,
                                      dtype=np.uint64).astype(np.uint32)
                         .view(np.int32)).to(cuda)
    planes = (x, torch.full_like(x, -1), torch.zeros_like(x))
    got = tele.tile_loads(planes)
    for g, w in zip(got, tele.tile_loads_ref(planes)):
        assert torch.equal(g, w)
    buf = torch.from_numpy(rng.integers(0, 2 ** 31, size=(129 * 24 + 1,),
                                        dtype=np.int64).astype(np.int32))
    view = buf.to(cuda)[1:].view(129, 24)         # not 16-byte aligned
    assert torch.equal(tele.tile_loads((view,))[0],
                       tele.tile_loads_ref((view,))[0])


@pytest.mark.cuda
def test_cuda_warmed_equals_cold_equals_sync(cuda):
    bits, vth, off = _bits()
    spikes, streams = _spikes(300), _streams(70, 4)
    kw = dict(max_batch=64, telemetry=True, device=cuda)
    sync = engine.SpikeEngine(EsamNetwork.from_numpy(bits, vth, off,
                                                     device=cuda), **kw)
    cold = engine.SpikeEngine(EsamNetwork.from_numpy(bits, vth, off,
                                                     device=cuda),
                              fuse_rounds="auto", overlap=True, **kw)
    warm = engine.SpikeEngine(EsamNetwork.from_numpy(bits, vth, off,
                                                     device=cuda),
                              fuse_rounds="auto", overlap=True, **kw)
    times = warm.warmup(event_ts=(4,))
    assert times["graphs"] == 2 * len(warm._buckets)
    a = _serve(sync, spikes, streams)
    b = _serve(cold, spikes, streams)
    c = _serve(warm, spikes, streams)
    _same(b, a)
    _same(c, a)
    rounds = warm.stats()["rounds_static"] + warm.stats()["rounds_event"]
    assert warm.graph_counts() == {"captures": times["graphs"],
                                   "replays": rounds}
    assert cold.graph_counts() == {"captures": 0, "replays": 0}
    cpu = engine.SpikeEngine(EsamNetwork.from_numpy(bits, vth, off,
                                                    device="cpu"),
                             max_batch=64, telemetry=True, device="cpu")
    _same(c, _serve(cpu, spikes, streams))
    cold.close()
    warm.close()


@pytest.mark.cuda
def test_cuda_graph_outputs_do_not_alias_across_rounds(cuda):
    bits, vth, off = _bits(seed=3)
    net = EsamNetwork.from_numpy(bits, vth, off, device=cuda)
    eng = engine.SpikeEngine(net, max_batch=16, telemetry=True, device=cuda)
    eng.warmup()
    a, b = _spikes(16, seed=1), _spikes(16, seed=2)
    reqs = _serve(eng, a + b)                  # two rounds of bucket 16
    assert eng.stats()["rounds_per_bucket"] == {16: 2}
    assert eng.graph_counts()["replays"] == 2
    want = net.plan(mode="functional")(
        torch.from_numpy(np.stack(a + b)).to(cuda)).logits.cpu().numpy()
    np.testing.assert_array_equal(np.stack([r.logits for r in reqs]), want)
    assert not np.array_equal(reqs[0].logits, reqs[16].logits)


@pytest.mark.cuda
def test_cuda_weight_changed_after_warmup_is_served(cuda):
    bits, vth, off = _bits(seed=4)
    net = EsamNetwork.from_numpy(bits, vth, off, device=cuda)
    eng = engine.SpikeEngine(net, max_batch=8, telemetry=True, device=cuda)
    captured = eng.warmup()["graphs"]
    spikes = _spikes(8, seed=5)
    before = _serve(eng, spikes)
    with torch.no_grad():
        net.weight_bits[0].copy_(1 - net.weight_bits[0])   # in place
        net.vth[0].add_(1)
    after = _serve(eng, spikes)
    assert eng.graph_counts()["captures"] == captured + 1
    fresh = EsamNetwork.from_numpy(*net.to_numpy(), device="cpu")
    want = _serve(engine.SpikeEngine(fresh, max_batch=8, telemetry=True,
                                     device="cpu"), spikes)
    _same(after, want)
    assert any(not np.array_equal(p.logits, q.logits)
               for p, q in zip(before, after))


@pytest.mark.cuda
def test_cuda_ladder_read_ports_after_warmup(cuda):
    bits, vth, off = _bits(seed=6)
    net = EsamNetwork.from_numpy(bits, vth, off, device=cuda)
    ladder = DegradationLadder(levels=(
        LadderLevel("full"), LadderLevel("economy", read_ports=2)))
    eng = engine.SpikeEngine(net, max_batch=32, telemetry=True,
                             ladder=ladder, device=cuda)
    times = eng.warmup()
    assert times["graphs"] == 2 * len(eng._buckets)   # ports 4 and 2
    eng._ladder_level = 1       # no pressure: one clear round stays there
    spikes = _spikes(20, seed=7)
    got = _serve(eng, spikes)
    assert eng.graph_counts()["replays"] == 1
    cpu = EsamNetwork.from_numpy(bits, vth, off, device="cpu")
    want = _serve(engine.SpikeEngine(cpu, max_batch=32, telemetry=True,
                                     read_ports=2, device="cpu"), spikes)
    _same(got, want)


@pytest.mark.cuda
def test_cuda_warmed_serve_builds_and_captures_nothing(cuda):
    from repro_torch.kernels.cim_popcount import ops as pop_ops

    bits, vth, off = _bits(seed=8)
    net = EsamNetwork.from_numpy(bits, vth, off, device=cuda)
    eng = engine.SpikeEngine(net, max_batch=32, telemetry=True,
                             overlap=True, device=cuda)
    times = eng.warmup(event_ts=(4, 8))
    misses = _build.load_library.cache_info().misses
    captures = eng.graph_counts()["captures"]
    pop_ops.reset_launch_counts()
    tele.reset_launch_counts()
    _serve(eng, _spikes(100, seed=9), _streams(40, 4) + _streams(30, 8))
    assert _build.load_library.cache_info().misses == misses
    assert eng.graph_counts()["captures"] == captures == times["graphs"]
    assert not any(pop_ops.launch_counts().values())
    assert not any(tele.launch_counts().values())
    eng.close()


@pytest.mark.cuda
def test_cuda_pinned_slots_reused_over_overlapped_rounds(cuda):
    bits, vth, off = _bits(seed=10)
    net = EsamNetwork.from_numpy(bits, vth, off, device=cuda)
    sync = engine.SpikeEngine(net, max_batch=16, telemetry=True, device=cuda)
    ov = engine.SpikeEngine(net, max_batch=16, telemetry=True, overlap=True,
                            device=cuda)
    spikes = _spikes(16 * 7 + 5, seed=11)
    streams = _streams(40, 4, seed=12) + _streams(9, 16, seed=13)
    a = _serve(sync, spikes, streams)
    b = _serve(ov, spikes, streams)
    _same(b, a)
    assert ov.stats()["rounds_static"] == 8
    assert all(s.pinned and s.tensor.is_pinned() for s in ov._slots)
    ov.close()
