"""repro_torch.kernels.cim_popcount's CUDA kernels against their plain versions.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports no JAX, so it runs on the card's machine, where the
JAX package is not installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_popcount_cuda.py

B1 (``mega_cascade``) is held bit for bit against the plain cascade, logits
and every fired plane, on each of its launcher's routes and on both of its
MACs (the popc unit, the b1 tensor-core product) at 2, 8 and 16 rows a
slice and a partly empty last slice; B2 (``popcount_fire``) and B3
(``popcount_mac``), one tensor-core kernel, against theirs at ragged
shapes, all-zero and all-one operands, int32-extreme thresholds and
strided rows.  The plain versions are held against the reference in
``test_torch_popcount.py``.  Every assert is exact int32 / uint32
equality."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import packing
from repro_torch.kernels.cim_popcount import ops

PAPER = (768, 256, 256, 256, 10)
#: the CPU tests' MAC and fire shapes (``test_torch_popcount.py``)
MAC_SHAPES = [(8, 128, 128), (37, 100, 10), (64, 384, 256), (200, 70, 32),
              (5, 33, 64), (1, 768, 10)]
FIRE_SHAPES = [(64, 768, 256), (37, 100, 96), (129, 777, 128), (1, 33, 64),
               (200, 256, 256)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _t(words: np.ndarray) -> torch.Tensor:
    return packing.words_from_np(words)


def _cascade_operands(seed, topo, B, vth_range=(-6, 7)):
    """uint32 input words, per-tile uint32 planes and int32 thresholds."""
    rng = np.random.default_rng(seed)
    x = packing.pack_spikes_np((rng.random((B, topo[0])) < 0.5))
    planes = [packing.pack_weight_planes_np(
        rng.integers(0, 2, size=(k, n), dtype=np.int8))
        for k, n in zip(topo[:-1], topo[1:])]
    vth = [rng.integers(*vth_range, size=(n,), dtype=np.int32)
           for n in topo[1:]]
    return x, planes, vth


def _cascade_on_card(seed, topo, B, device):
    """(input words, planes, thresholds, stacks, tiles) on the card."""
    x, planes, vth = _cascade_operands(seed, topo, B)
    planes_t = tuple(_t(p).to(device) for p in planes)
    vth_t = tuple(torch.from_numpy(v).to(device) for v in vth)
    w_stack, vth_stack = ops.stack_cascade_operands(planes_t, vth_t, topo)
    tiles = ops.cascade_tiles(w_stack, vth_stack, topo)
    return _t(x).to(device), planes_t, vth_t, w_stack, vth_stack, tiles


#: (topology, batch, the launcher's route there): its cluster size, whether
#: every tile's word count is fixed at compile time, the last slice of rows
#: partly empty, fewer clusters than slices, the MAC (None: not asserted)
CUDA_CASCADE_CASES = [
    (PAPER, 1, (2, True, False, False, "popc")),
    (PAPER, 7, (2, True, False, False, "popc")),
    (PAPER, 128, (2, True, False, False, "popc")),
    (PAPER, 512, (2, True, False, False, "b1")),
    (PAPER, 515, (2, True, True, False, "b1")),
    (PAPER, 1000, (2, True, True, False, "b1")),
    (PAPER, 1024, (2, True, False, False, "b1")),
    (PAPER, 4096, (2, True, False, None, "b1")),
    (PAPER, 16384, (2, True, False, True, "b1")),
    (PAPER, 333, (2, True, True, None, "b1")),
    (PAPER, 254, (2, True, True, None, "popc")),
    (PAPER, 319, (2, True, True, None, "popc")),
    (PAPER, 320, (2, True, False, None, "b1")),
    ((768, 768, 768, 10), 1024, (2, True, False, None, "b1")),
    ((768, 256, 10), 33, (2, True, None, None, "popc")),
    ((100, 64, 96, 33), 45, (2, False, None, None, "popc")),
    ((100, 64, 96, 33), 1000, (2, False, True, None, "b1")),
    ((100, 32, 10), 3, (1, False, None, None, "popc")),
    ((1024, 4096, 10), 8, (4, False, None, None, "popc")),
    ((2048, 4096, 10), 8, (8, False, None, None, "popc")),
    ((4096, 4096, 10), 8, (16, False, None, None, "popc")),
    ((4096, 4096, 10), 600, (16, False, True, None, "b1")),
]


@pytest.mark.cuda
@pytest.mark.parametrize("topo,B,route", CUDA_CASCADE_CASES,
                         ids=lambda v: ":".join(map(str, v))
                         if isinstance(v, tuple) and len(v) > 4 else str(v))
def test_cuda_cascade_matches_plain(cuda, topo, B, route):
    """One mega_cascade launch, bit for bit the plain cascade, on each of
    the launcher's routes."""
    x, planes_t, vth_t, w_stack, vth_stack, tiles = _cascade_on_card(
        B + len(topo), topo, B, cuda)
    ops.reset_launch_counts()
    logits, fired = ops.esam_cascade_popcount(
        x, w_stack, vth_stack, topology=topo, tiles=tiles)
    assert ops.launch_counts()["mega_cascade"] == 1
    ref_logits, ref_fired = ops.esam_cascade_popcount_ref(x, planes_t, vth_t)
    assert torch.equal(logits, ref_logits)
    assert all(torch.equal(a, b) for a, b in zip(fired, ref_fired))
    took = ops._cascade_route(topo, B, torch.cuda.current_device())
    got = (took.cluster, all(took.fixed_words),
           took.slices * took.rows > B, took.clusters < took.slices,
           took.mac)
    for g, want in zip(got, route):
        assert want is None or g == want, (took, route)
    assert took.fixed_words == tuple(w in (8, 24) for w in
                                     ops.cascade_geometry(topo)["w_words"])


@pytest.mark.cuda
def test_cuda_cascade_needs_its_tiles(cuda):
    """On the card the cascade reads the regrouped operands: without them,
    or with another topology's, it raises instead of computing."""
    topo = (100, 64, 10)
    x, planes, vth = _cascade_operands(2, topo, 4)
    w_stack, vth_stack = ops.stack_cascade_operands(
        [_t(p).to(cuda) for p in planes],
        [torch.from_numpy(v).to(cuda) for v in vth], topo)
    tiles = ops.cascade_tiles(w_stack, vth_stack, topo)
    for bad in (None, tiles[:-32], tiles.cpu()):
        with pytest.raises(ValueError, match="cascade_tiles"):
            ops.esam_cascade_popcount(_t(x).to(cuda), w_stack, vth_stack,
                                      topology=topo, tiles=bad)

#: (topology, batch, rows a slice) at which both MACs run on a pinned route:
#: 2 rows (a serving round's), 8 and 16 (the b1 MAC's half and full m), a
#: partly empty last slice at each, run-time word counts, the bench's width
BOTH_MAC_CASES = [
    (PAPER, 128, 2), (PAPER, 128, 8), (PAPER, 512, 8), (PAPER, 515, 8),
    (PAPER, 1024, 16), (PAPER, 1000, 16), (PAPER, 333, 5), (PAPER, 7, 16),
    ((768, 768, 768, 10), 1024, 16), ((100, 64, 96, 33), 45, 16),
    ((100, 64, 96, 33), 45, 3), ((100, 32, 10), 40, 8),
    ((2048, 4096, 10), 40, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("mac", ["popc", "b1"])
@pytest.mark.parametrize("topo,B,rows", BOTH_MAC_CASES,
                         ids=lambda v: ":".join(map(str, v))
                         if isinstance(v, tuple) else str(v))
def test_cuda_cascade_both_macs(cuda, topo, B, rows, mac):
    """The cascade with its rows a slice and its MAC pinned, one launch,
    bit for bit the plain cascade: the b1 product (a warp a slice x group,
    rows past the slice zero) and the popc unit (a lane a neuron) alike."""
    x, planes, vth, _, _, tiles = _cascade_on_card(B + rows, topo, B, cuda)
    route = ops._cascade_route(topo, B, torch.cuda.current_device(),
                               rows=rows, mac=mac)
    assert (route.rows, route.mac) == (rows, mac)
    assert route.slices * rows >= B > (route.slices - 1) * rows
    hidden = sum(n // 32 for n in topo[1:-1])
    logits = torch.empty((B, topo[-1]), dtype=torch.int32, device=cuda)
    fired = torch.empty(B * hidden, dtype=torch.int32, device=cuda)
    ops.reset_launch_counts()
    ops._cascade_launch(x, tiles, topo, logits, fired, route)
    assert ops.launch_counts()["mega_cascade"] == 1
    ref_logits, ref_fired = ops.esam_cascade_popcount_ref(x, planes, vth)
    assert torch.equal(logits, ref_logits)
    assert torch.equal(fired, torch.cat([f.reshape(-1) for f in ref_fired]))


#: ragged tile shapes: B 1, 7, 37; N 10, 77, 96; K 100, 777, 40000 (W 4,
#: 25, 1250)
RAGGED_TILES = [(1, 100, 10), (7, 777, 77), (37, 40000, 96), (1, 777, 96),
                (7, 100, 77), (37, 40000, 10)]


def _tile_operands(seed, B, K, N, fill="random", stride_pad=0,
                   device="cpu"):
    """Spike words [B, W] (on ``device``, a view whose rows lie W +
    stride_pad words apart, the skipped words all ones) and planes [N, W],
    as int32 tensors: random, or all-zero / all-one spikes and planes."""
    rng = np.random.default_rng(seed)
    if fill == "random":
        s = rng.random((B, K)) < 0.5
        w = rng.integers(0, 2, size=(K, N), dtype=np.int8)
    else:
        s = np.full((B, K), fill == "ones")
        w = np.full((K, N), fill == "ones", np.int8)
    words = packing.packed_width(K)
    x = np.full((B, words + stride_pad), 0xFFFFFFFF, np.uint32)
    x[:, :words] = packing.pack_spikes_np(s)
    return (_t(x).to(device)[:, :words],
            _t(packing.pack_weight_planes_np(w)).to(device))


#: (B, K, N, fill, stride_pad) of the MAC on the card: the CPU shapes, the
#: ragged ones, all-zero and all-one operands, strided spike rows
CUDA_MAC_CASES = (
    [(B, K, N, "random", 0) for B, K, N in MAC_SHAPES + RAGGED_TILES]
    + [(37, 777, 96, fill, 0) for fill in ("zeros", "ones")]
    + [(256, 768, 256, "random", pad) for pad in (1, 2)]
    + [(1024, 768, 768, "random", 0), (4096, 768, 256, "random", 0)])


def _assert_route(x, planes, B, N, stride_pad):
    """The route the wrapper took: paired loads exactly where the words and
    strides are even, a grid covering the shape."""
    took = ops._route_for(x, planes)
    W = x.shape[1]
    assert took.paired == (W % 2 == 0 and stride_pad % 2 == 0)
    assert took == ops._fire_route(B, N, took.paired)


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,N,fill,stride_pad", CUDA_MAC_CASES)
def test_cuda_mac_matches_plain(cuda, B, K, N, fill, stride_pad):
    x, planes = _tile_operands(B + K + N, B, K, N, fill, stride_pad, cuda)
    ops.reset_launch_counts()
    got = ops.cim_popcount_matmul(x, planes)
    assert ops.launch_counts()["popcount_mac"] == 1
    _assert_route(x, planes, B, N, stride_pad)
    want = ops.cim_popcount_ref(x, planes)
    assert torch.equal(got, want)


_I32 = np.iinfo(np.int32)
#: (B, K, N, pack_output, fill, vth, stride_pad) of the fire on the card:
#: the CPU shapes and B2's in both output forms, the ragged ones in every
#: form their width takes, all-zero and all-one operands, thresholds at
#: the int32 extremes, strided spike rows
CUDA_FIRE_CASES = (
    [(B, K, N, pack, "random", "random", 0)
     for B, K, N in FIRE_SHAPES + [(4096, 768, 256), (1000, 777, 256),
                                   (5, 40000, 64)]
     for pack in (True, False)]
    + [(B, K, N, pack, "random", "random", 0) for B, K, N in RAGGED_TILES
       for pack in ((True, False) if N % 32 == 0 else (False,))]
    + [(37, 777, 96, pack, fill, "random", 0) for fill in ("zeros", "ones")
       for pack in (True, False)]
    + [(7, 100, 77, False, fill, "random", 0) for fill in ("zeros", "ones")]
    + [(37, 768, 96, pack, "random", vth, 0) for vth in ("min", "max")
       for pack in (True, False)]
    + [(7, 777, 77, False, "random", vth, 0) for vth in ("min", "max")]
    + [(37, 768, 96, True, "random", "random", pad) for pad in (1, 2)])


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,N,pack_output,fill,vth_fill,stride_pad",
                         CUDA_FIRE_CASES)
def test_cuda_fire_matches_plain(cuda, B, K, N, pack_output, fill, vth_fill,
                                 stride_pad):
    x, planes = _tile_operands(B + K, B, K, N, fill, stride_pad, cuda)
    if vth_fill == "random":
        vth = np.random.default_rng(N).integers(-9, 9, size=(N,),
                                                dtype=np.int32)
    else:
        vth = np.full((N,), _I32.min if vth_fill == "min" else _I32.max,
                      np.int32)
    vth = torch.from_numpy(vth).to(cuda)
    ops.reset_launch_counts()
    got = ops.esam_layer_popcount(x, planes, vth, pack_output=pack_output)
    assert ops.launch_counts()["popcount_fire"] == 1
    _assert_route(x, planes, B, N, stride_pad)
    want = ops.esam_layer_popcount_ref(x, planes, vth,
                                       pack_output=pack_output)
    assert torch.equal(got, want)
