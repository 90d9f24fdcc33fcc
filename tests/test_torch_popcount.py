"""repro_torch.kernels.cim_popcount against repro.kernels.cim_popcount.

On the CPU the port's plain versions are held bit for bit against the JAX
package's jnp reference and its Pallas kernels in interpret mode, on inputs
made with numpy from a seed; the tile kernel's route (pure geometry) and
the card's cascade operands are checked here too.  The CUDA kernels
against the plain versions are in ``test_torch_popcount_cuda.py`` (no
JAX, so they run on the card's machine).  Every assert is exact int32 /
uint32 equality."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as jpacking
from repro.kernels.cim_popcount import ops as jops
from repro.kernels.cim_popcount.kernel import VTH_NEVER_FIRE as J_NEVER
from repro_torch.core import packing
from repro_torch.kernels.cim_popcount import ops

PAPER = (768, 256, 256, 256, 10)


def _mac_operands(seed, B, K, N, p=0.4):
    rng = np.random.default_rng(seed)
    s = (rng.random((B, K)) < p).astype(np.int8)
    w = rng.integers(0, 2, size=(K, N), dtype=np.int8)
    return jpacking.pack_spikes_np(s), jpacking.pack_weight_planes_np(w)


def _cascade_operands(seed, topo, B, vth_range=(-6, 7)):
    """uint32 input words, per-tile uint32 planes and int32 thresholds."""
    rng = np.random.default_rng(seed)
    x = jpacking.pack_spikes_np((rng.random((B, topo[0])) < 0.5))
    planes = [jpacking.pack_weight_planes_np(
        rng.integers(0, 2, size=(k, n), dtype=np.int8))
        for k, n in zip(topo[:-1], topo[1:])]
    vth = [rng.integers(*vth_range, size=(n,), dtype=np.int32)
           for n in topo[1:]]
    return x, planes, vth


def _t(words: np.ndarray) -> torch.Tensor:
    return packing.words_from_np(words)


# ----------------------------------------------------------------------- #
# the MAC
# ----------------------------------------------------------------------- #
# the interpret-mode kernel needs N % min(128, N) == 0 (its block contract)
MAC_SHAPES = [(8, 128, 128), (37, 100, 10), (64, 384, 256), (200, 70, 32),
              (5, 33, 64), (1, 768, 10)]


@pytest.mark.parametrize("B,K,N", MAC_SHAPES)
def test_mac_ref_matches_jax_ref_and_interpret_kernel(B, K, N):
    p, planes = _mac_operands(B * 31 + K + N, B, K, N)
    want = np.asarray(jops.cim_popcount_matmul(
        jnp.asarray(p), jnp.asarray(planes), use_kernel=False))
    kern = np.asarray(jops.cim_popcount_matmul(
        jnp.asarray(p), jnp.asarray(planes), use_kernel=True, interpret=True))
    np.testing.assert_array_equal(kern, want)
    got = ops.cim_popcount_ref(_t(p), _t(planes))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # CPU tensors dispatch to the plain version
    np.testing.assert_array_equal(
        ops.cim_popcount_matmul(_t(p), _t(planes)).numpy(), want)


def test_layer_ref_matches_jax_ref():
    p, planes = _mac_operands(3, 21, 96, 64)
    vth = np.random.default_rng(3).integers(-9, 9, size=(64,), dtype=np.int32)
    for pack_output in (True, False):
        want = np.asarray(jops.esam_layer_popcount_ref(
            jnp.asarray(p), jnp.asarray(planes), jnp.asarray(vth),
            pack_output=pack_output))
        got = ops.esam_layer_popcount_ref(
            _t(p), _t(planes), torch.from_numpy(vth), pack_output=pack_output)
        got = packing.words_to_np(got) if pack_output else got.numpy()
        np.testing.assert_array_equal(got, want)


# the interpret-mode kernel needs N % min(128, N) == 0 (its block contract)
FIRE_SHAPES = [(64, 768, 256), (37, 100, 96), (129, 777, 128), (1, 33, 64),
               (200, 256, 256)]


@pytest.mark.parametrize("B,K,N", FIRE_SHAPES)
@pytest.mark.parametrize("pack_output", [True, False])
def test_fire_matches_jax_kernel_and_ref(B, K, N, pack_output):
    """esam_layer_popcount (popcount_fire's wrapper) on CPU tensors against
    the reference's Pallas popcount_fire_kernel in interpret mode and its
    jnp reference: odd K, ragged batches, both output forms."""
    p, planes = _mac_operands(B + K + N, B, K, N, p=0.5)
    vth = np.random.default_rng(K).integers(-9, 9, size=(N,), dtype=np.int32)
    args = (jnp.asarray(p), jnp.asarray(planes), jnp.asarray(vth))
    want = np.asarray(jops.esam_layer_popcount(
        *args, pack_output=pack_output, use_kernel=False))
    kern = np.asarray(jops.esam_layer_popcount(
        *args, pack_output=pack_output, use_kernel=True, interpret=True))
    np.testing.assert_array_equal(kern, want)
    ops.reset_launch_counts()
    got = ops.esam_layer_popcount(_t(p), _t(planes), torch.from_numpy(vth),
                                  pack_output=pack_output)
    assert ops.launch_counts()["popcount_fire"] == 0
    got = packing.words_to_np(got) if pack_output else got.numpy()
    np.testing.assert_array_equal(got, want)


def test_fire_rejects_bad_operands():
    p, planes = _mac_operands(1, 4, 64, 48)
    vth = torch.zeros(48, dtype=torch.int32)
    with pytest.raises(ValueError):   # packed output needs 32 | N
        ops.esam_layer_popcount(_t(p), _t(planes), vth)
    with pytest.raises(ValueError):
        ops.esam_layer_popcount(_t(p), _t(planes), vth[:40],
                                pack_output=False)
    with pytest.raises(ValueError):
        ops.esam_layer_popcount(_t(p)[:, :1], _t(planes), vth,
                                pack_output=False)


# ----------------------------------------------------------------------- #
# the cascade
# ----------------------------------------------------------------------- #
def _jax_cascade(x, planes, vth, topo, *, use_kernel):
    w_stack, vth_stack = jops.stack_cascade_operands(
        [jnp.asarray(p) for p in planes], [jnp.asarray(v) for v in vth], topo)
    logits, fired = jops.esam_cascade_popcount(
        jnp.asarray(x), w_stack, vth_stack, topology=topo,
        use_kernel=use_kernel, interpret=True if use_kernel else None)
    return np.asarray(logits), [np.asarray(f) for f in fired]


def _port_cascade(x, planes, vth, topo):
    w_stack, vth_stack = ops.stack_cascade_operands(
        [_t(p) for p in planes], [torch.from_numpy(v) for v in vth], topo)
    logits, fired = ops.esam_cascade_popcount(
        _t(x), w_stack, vth_stack, topology=topo)
    return logits.numpy(), [packing.words_to_np(f) for f in fired]


def _assert_cascade_equal(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    assert len(a[1]) == len(b[1])
    for fa, fb in zip(a[1], b[1]):
        np.testing.assert_array_equal(fa, fb)


CASCADE_CASES = [
    # (topology, batch, use the interpret-mode Pallas kernel too)
    (PAPER, 64, True),
    ((768, 256, 10), 7, True),
    ((100, 64, 32, 10), 1, True),          # odd n_in, batch 1
    ((70, 128, 96, 33), 45, False),        # ragged batch, odd class count
    ((768, 10), 9, True),                  # one tile: the MAC branch
]


@pytest.mark.parametrize("topo,B,interp", CASCADE_CASES)
def test_cascade_matches_jax(topo, B, interp):
    x, planes, vth = _cascade_operands(sum(topo) + B, topo, B)
    want = _jax_cascade(x, planes, vth, topo, use_kernel=False)
    if interp:
        _assert_cascade_equal(
            _jax_cascade(x, planes, vth, topo, use_kernel=True), want)
    _assert_cascade_equal(_port_cascade(x, planes, vth, topo), want)
    # the plain cascade on per-tile operands gives the same
    logits, fired = ops.esam_cascade_popcount_ref(
        _t(x), tuple(_t(p) for p in planes),
        tuple(torch.from_numpy(v) for v in vth))
    _assert_cascade_equal(
        (logits.numpy(), [packing.words_to_np(f) for f in fired]), want)


@pytest.mark.parametrize("vth_value,expect", [(10**6, 0), (-(10**6), 1)])
def test_cascade_fires_nothing_or_everything(vth_value, expect):
    """vth above n_in: nothing fires; negative beyond -n_in: every real
    neuron fires (and the padded lanes of the words stay zero)."""
    topo = (100, 64, 96, 10)
    x, planes, _ = _cascade_operands(5, topo, 13)
    vth = [np.full((n,), vth_value, np.int32) for n in topo[1:]]
    want = _jax_cascade(x, planes, vth, topo, use_kernel=False)
    got = _port_cascade(x, planes, vth, topo)
    _assert_cascade_equal(got, want)
    for f, n in zip(got[1], topo[1:-1]):
        bits = packing.unpack_spikes_np(f, n)
        assert (bits == expect).all()


def test_geometry_and_stacking_match_reference():
    for topo in (PAPER, (768, 256, 10), (100, 64, 32, 10), (768, 10)):
        assert ops.cascade_geometry(topo) == jops.cascade_geometry(topo)
        _, planes, vth = _cascade_operands(1, topo, 1)
        jw, jv = jops.stack_cascade_operands(
            [jnp.asarray(p) for p in planes],
            [jnp.asarray(v) for v in vth], topo)
        tw, tv = ops.stack_cascade_operands(
            [_t(p) for p in planes], [torch.from_numpy(v) for v in vth], topo)
        np.testing.assert_array_equal(packing.words_to_np(tw), np.asarray(jw))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert ops.VTH_NEVER_FIRE == J_NEVER
    # padded planes are zero and padded thresholds the never-fire sentinel
    topo = (100, 64, 32, 10)
    tw, tv = ops.stack_cascade_operands(
        [_t(p) for p in _cascade_operands(1, topo, 1)[1]],
        [torch.zeros(n, dtype=torch.int32) for n in topo[1:]], topo)
    assert tw.shape == (3, 128, 4) and tv.shape == (2, 128)
    for t, n in enumerate(topo[1:]):
        assert (tw[t, n:] == 0).all()
    for t, n in enumerate(topo[1:-1]):
        assert (tv[t, :n] == 0).all()
        assert (tv[t, n:] == ops.VTH_NEVER_FIRE).all()


def test_cascade_rejects_bad_operands():
    topo = (100, 64, 10)
    x, planes, vth = _cascade_operands(2, topo, 4)
    w_stack, vth_stack = ops.stack_cascade_operands(
        [_t(p) for p in planes], [torch.from_numpy(v) for v in vth], topo)
    with pytest.raises(ValueError):
        ops.esam_cascade_popcount(_t(x)[:, :3], w_stack, vth_stack,
                                  topology=topo)
    with pytest.raises(ValueError):
        ops.esam_cascade_popcount(_t(x), w_stack, vth_stack,
                                  topology=(100, 60, 10))
    with pytest.raises(TypeError):
        ops.esam_cascade_popcount(_t(x).to(torch.int64), w_stack, vth_stack,
                                  topology=topo)
    with pytest.raises(ValueError, match="w_stack"):
        ops.esam_cascade_popcount(_t(x), w_stack[:, :64], vth_stack,
                                  topology=topo)
    with pytest.raises(ValueError, match="vth_stack"):
        ops.esam_cascade_popcount(_t(x), w_stack, vth_stack.to(torch.int64),
                                  topology=topo)
    # the geometry is the launcher's, derived: no block size to pass
    with pytest.raises(TypeError):
        ops.esam_cascade_popcount(_t(x), w_stack, vth_stack, topology=topo,
                                  block_b=4)


@pytest.mark.parametrize("topo", [PAPER, (100, 64, 96, 33), (768, 10)],
                         ids=lambda t: ":".join(map(str, t)))
def test_cascade_tiles_layout(topo):
    """The card's regrouped operands: per tile, per 32-neuron group, a
    (w8 + 1) x 32 block (w8: w rounded up to 8) of the group's planes
    (word-major; in row j neuron n sits in column n ^ 8 (j // 2 % 4)), zero
    rows up to w8, and its thresholds (zero for the readout), tiles back to
    back."""
    _, planes, vth = _cascade_operands(3, topo, 1)
    w_stack, vth_stack = ops.stack_cascade_operands(
        [_t(p) for p in planes], [torch.from_numpy(v) for v in vth], topo)
    tiles = ops.cascade_tiles(w_stack, vth_stack, topo)
    assert tiles.dtype == torch.int32 and tiles.is_contiguous()
    assert tiles.numel() == ops._tiles_words(topo)
    off = 0
    for t, (n, p) in enumerate(zip(topo[1:], planes)):
        groups, w = -(-n // 32), p.shape[1]
        w8 = -(-w // 8) * 8
        blocks = tiles[off: off + groups * (w8 + 1) * 32].reshape(
            groups, w8 + 1, 32)
        off += blocks.numel()
        padded = np.zeros((groups * 32, w8), np.uint32)
        padded[:n, :w] = p
        want = padded.reshape(groups, 32, w8).transpose(0, 2, 1)
        got = packing.words_to_np(blocks[:, :w8].contiguous())
        for j in range(w8):
            cols = np.arange(32) ^ (8 * ((j >> 1) & 3))
            np.testing.assert_array_equal(got[:, j, cols], want[:, j])
        th = blocks[:, w8].reshape(-1).numpy()
        if t + 1 < len(planes):
            np.testing.assert_array_equal(th[:n], vth[t])
        else:
            assert (th == 0).all()
    assert off == tiles.numel()


def test_no_plain_fallback_off_the_cpu():
    """Only a CPU tensor takes the plain path: any other device raises
    instead of quietly computing the plain version."""
    topo = (100, 64, 10)
    x, planes, vth = _cascade_operands(2, topo, 4)
    w_stack, vth_stack = ops.stack_cascade_operands(
        [_t(p) for p in planes], [torch.from_numpy(v) for v in vth], topo)
    meta = torch.device("meta")
    ops.reset_launch_counts()
    with pytest.raises(ValueError):
        ops.esam_cascade_popcount(_t(x).to(meta), w_stack.to(meta),
                                  vth_stack.to(meta), topology=topo)
    with pytest.raises(ValueError):
        ops.cim_popcount_matmul(_t(x).to(meta), _t(planes[0]).to(meta))
    with pytest.raises(ValueError):   # mixed devices
        ops.cim_popcount_matmul(_t(x), _t(planes[0]).to(meta))
    # the plain path launches nothing
    ops.esam_cascade_popcount(_t(x), w_stack, vth_stack, topology=topo)
    ops.esam_layer_popcount(_t(x), _t(planes[0]), torch.from_numpy(vth[0]))
    assert ops.launch_counts() == {"mega_cascade": 0, "popcount_fire": 0,
                                   "popcount_mac": 0}


# ----------------------------------------------------------------------- #
# the tile kernel's route (B2 popcount_fire and B3 popcount_mac)
# ----------------------------------------------------------------------- #
ROUTE_SHAPES = [  # (B, N)
    (4096, 256), (1000, 256), (1024, 768), (128, 10), (256, 256),
    (512, 256), (1024, 256), (64, 256), (64, 10), (1, 10), (7, 77),
    (37, 96), (1, 1), (17, 65), (100_000, 4096), (16, 64), (32, 64),
    (33, 63)]


@pytest.mark.parametrize("B,N", ROUTE_SHAPES)
@pytest.mark.parametrize("paired", [True, False])
def test_fire_route_covers_the_shape(B, N, paired):
    """Every shape maps to a grid whose blocks cover B rows and N neurons
    exactly: less than one block's rows and one 64-neuron block past
    them."""
    r = ops._fire_route(B, N, paired)
    rows_a_block = 16 * ops._FIRE_WARPS
    assert r.paired is paired
    assert 0 <= r.grid[0] * rows_a_block - B < rows_a_block
    assert 0 <= r.grid[1] * 64 - N < 64


@pytest.mark.parametrize("B,K,N", [(4096, 768, 256), (1024, 768, 768),
                                   (4096, 256, 256)])
def test_fire_route_fills_the_card(B, K, N):
    """At B2's and the bench's shapes the grid gives each of an H100's 132
    SMs at least one block."""
    r = ops._fire_route(B, N, packing.packed_width(K) % 2 == 0)
    assert r.grid[0] * r.grid[1] >= 132


def test_fire_route_is_pure(monkeypatch):
    """The route needs no library and no card: it is computed from the
    shape alone, and refuses an empty one."""
    def no_library():
        raise AssertionError("the route must not load the kernel library")

    monkeypatch.setattr(ops, "_library", no_library)
    assert ops._fire_route(37, 77, False) == ops._fire_route(37, 77, False)
    for bad in ((0, 10), (1, 0)):
        with pytest.raises(ValueError):
            ops._fire_route(*bad, True)


@pytest.mark.parametrize("K,stride_pad,offset,want", [
    (768, 0, 0, True), (64, 2, 0, True), (100, 0, 0, True),
    (777, 0, 0, False), (768, 1, 0, False), (768, 0, 1, False),
    (768, 1, 1, False)])
def test_paired_loads_need_even_aligned_rows(K, stride_pad, offset, want):
    """Two words a load only where every row starts 8-byte aligned: an even
    word count and row strides, both operands on an 8-byte boundary."""
    words = packing.packed_width(K)
    full = torch.zeros((5, words + stride_pad + offset), dtype=torch.int32)
    x = full[:, offset: offset + words]
    planes = torch.zeros((32, words), dtype=torch.int32)
    assert ops._paired(x, planes) is want
