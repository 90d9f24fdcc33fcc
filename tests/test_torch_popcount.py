"""repro_torch.kernels.cim_popcount against repro.kernels.cim_popcount.

On the CPU the port's plain versions are held bit for bit against the JAX
package's jnp reference and its Pallas kernels in interpret mode, on inputs
made with numpy from a seed.  The CUDA kernels against the plain versions
run only on a card (marker ``cuda``); here they skip.  Every assert is exact
int32 / uint32 equality."""

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
    assert ops.launch_counts() == {"mega_cascade": 0, "popcount_mac": 0}


# ----------------------------------------------------------------------- #
# the CUDA kernels against the plain versions, on the card
# ----------------------------------------------------------------------- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("topo,B", [(PAPER, 1), (PAPER, 7), (PAPER, 128),
                                    (PAPER, 1000), ((768, 256, 10), 33),
                                    ((100, 64, 96, 33), 45)])
def test_cuda_cascade_matches_plain(cuda, topo, B):
    x, planes, vth = _cascade_operands(B + len(topo), topo, B)
    planes_t = tuple(_t(p).to(cuda) for p in planes)
    vth_t = tuple(torch.from_numpy(v).to(cuda) for v in vth)
    w_stack, vth_stack = ops.stack_cascade_operands(planes_t, vth_t, topo)
    ops.reset_launch_counts()
    logits, fired = ops.esam_cascade_popcount(
        _t(x).to(cuda), w_stack, vth_stack, topology=topo)
    assert ops.launch_counts()["mega_cascade"] == 1
    ref_logits, ref_fired = ops.esam_cascade_popcount_ref(
        _t(x).to(cuda), planes_t, vth_t)
    assert torch.equal(logits, ref_logits)
    assert all(torch.equal(a, b) for a, b in zip(fired, ref_fired))


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,N", MAC_SHAPES)
def test_cuda_mac_matches_plain(cuda, B, K, N):
    p, planes = _mac_operands(B + K + N, B, K, N)
    ops.reset_launch_counts()
    got = ops.cim_popcount_matmul(_t(p).to(cuda), _t(planes).to(cuda))
    assert ops.launch_counts()["popcount_mac"] == 1
    want = ops.cim_popcount_ref(_t(p).to(cuda), _t(planes).to(cuda))
    assert torch.equal(got, want)
