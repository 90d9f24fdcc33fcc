"""repro_torch.kernels.if_neuron against repro.kernels.if_neuron.

On the CPU the port's ``if_neuron`` (its plain version) is held bit for bit
against the reference's Pallas kernel in interpret mode and its jnp
oracle, on updates made with numpy from a seed: the reference's shapes,
threshold equality (which fires) and int32 wraparound (which JAX's int32
adds and the port's ``dtype=torch.int32`` sum share).  The CUDA kernel
against the plain version is in ``test_torch_if_neuron_cuda.py``, which
imports no JAX."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.if_neuron import ops as jops
from repro_torch.kernels.if_neuron import ops

#: the reference's shapes (tests/test_kernels.py)
SHAPES = [(8, 32, 128), (16, 5, 256), (8, 1, 128)]


def _operands(seed, B, T, N):
    rng = np.random.default_rng(seed)
    upd = rng.integers(-4, 5, size=(B, T, N), dtype=np.int32)
    vth = rng.integers(-20, 20, size=(N,), dtype=np.int32)
    return upd, vth


def _check(upd, vth):
    ju, jv = jnp.asarray(upd), jnp.asarray(vth)
    k_spikes, k_vmem = jops.if_neuron(ju, jv, interpret=True)
    r_spikes, r_vmem = jops.if_neuron_ref(ju, jv)
    np.testing.assert_array_equal(np.asarray(k_spikes), np.asarray(r_spikes))
    np.testing.assert_array_equal(np.asarray(k_vmem), np.asarray(r_vmem))
    ops.reset_launch_counts()
    spikes, vmem = ops.if_neuron(torch.from_numpy(upd), torch.from_numpy(vth))
    assert ops.launch_counts() == {"if_neuron": 0}
    assert spikes.dtype == torch.int8 and vmem.dtype == torch.int32
    np.testing.assert_array_equal(spikes.numpy(), np.asarray(k_spikes))
    np.testing.assert_array_equal(vmem.numpy(), np.asarray(k_vmem))
    return spikes.numpy(), vmem.numpy()


@pytest.mark.parametrize("B,T,N", SHAPES)
def test_matches_jax_kernel(B, T, N):
    spikes, _ = _check(*_operands(B * T + N, B, T, N))
    assert 0 < spikes.sum() < spikes.size


def test_threshold_equality_fires():
    """fire iff V_mem >= V_th: equality fires (Sec 2.1)."""
    spikes, vmem = _check(np.ones((8, 3, 128), np.int32),
                          np.full((128,), 3, np.int32))
    assert np.all(vmem == 3) and np.all(spikes == 1)


def test_int32_wraparound():
    """Updates near 2^30 over T = 4 overflow int32; both packages wrap."""
    rng = np.random.default_rng(7)
    upd = rng.integers(2**30, 2**31 - 1, size=(8, 4, 128)).astype(np.int32)
    upd[:, :, :64] *= -1
    vth = rng.integers(-2**31, 2**31 - 1, size=(128,)).astype(np.int32)
    _, vmem = _check(upd, vth)
    wide = upd.astype(np.int64).sum(axis=1)
    assert not np.array_equal(vmem, wide)           # it did overflow
    np.testing.assert_array_equal(vmem, wide.astype(np.uint64)
                                  .astype(np.uint32).view(np.int32))


def test_rejects_bad_operands():
    upd, vth = _operands(1, 2, 3, 16)
    tu, tv = torch.from_numpy(upd), torch.from_numpy(vth)
    with pytest.raises(ValueError):
        ops.if_neuron(tu[0], tv)
    with pytest.raises(ValueError):
        ops.if_neuron(tu, tv[:8])
    meta = torch.device("meta")
    with pytest.raises(ValueError):
        ops.if_neuron(tu.to(meta), tv.to(meta))
    assert ops.launch_counts() == {"if_neuron": 0}


def _rounds(route, y: int, T: int) -> list[int]:
    """The rounds slot ``y`` of a unit adds, as the kernel's loop walks
    them: spans y, y + slots, ... of ``ops._SPAN`` rounds, each cut at T."""
    span = ops._SPAN
    return [t0 + s for t0 in range(y * span, T, route.slots * span)
            for s in range(span) if t0 + s < T]


#: (B, N, vec): the reference's, the bench's and the chip checks' shapes
ROUTE_SHAPES = [(8, 128, True), (16, 256, True), (8, 256, True),
                (4096, 256, True), (1, 10, False), (7, 100, True),
                (8, 99, False), (3000, 256, True), (2000, 99, False)]


@pytest.mark.parametrize("T", range(71))
def test_if_route_spans_cover_every_round_once(T):
    """The span slots of a unit, walked as the kernel walks them, add every
    round of [0, T) exactly once."""
    for B, N, vec in ROUTE_SHAPES:
        r = ops._if_route(B, T, N, vec)
        rounds = sorted(t for y in range(r.slots) for t in _rounds(r, y, T))
        assert rounds == list(range(T)), (B, N, vec, r)
        span = ops._SPAN
        assert all(len(_rounds(r, y, T)) <= span * -(-T // (span * r.slots))
                   for y in range(r.slots))


@pytest.mark.parametrize("B,N,vec", ROUTE_SHAPES)
@pytest.mark.parametrize("T", [0, 1, 3, 4, 5, 32, 37, 1000])
def test_if_route_covers_the_units(B, N, vec, T):
    """The grid covers every unit (4 neurons, or one) with less than a
    block past it; a warp is 32 lanes of units x span slots, a block at most
    256 threads, and one slot takes every round where they fit one span."""
    r = ops._if_route(B, T, N, vec)
    units = B * (N // 4 if vec else N)
    per_block = r.uw * r.warps
    assert r.grid * per_block >= units > (r.grid - 1) * per_block
    assert r.uw * r.slots == 32 and r.uw & (r.uw - 1) == 0
    assert 32 * r.warps <= ops._MAX_THREADS
    assert r.vec == vec
    assert r.slots == 1 if T <= ops._SPAN else r.slots > 1


@pytest.mark.parametrize("B,T,N,grid,loads", [
    (8, 32, 256, 64, 4),        # the bench: 64 CTAs of 2 warps, 4 x 8 slots
    (4096, 32, 256, 8192, 4),   # streams: 8 warps a CTA
    (8, 1, 256, 8, 1),          # one round: 32 units a warp
    (8, 1000, 256, 256, 32),    # 32 slots, each 8 spans of 4 rounds
])
def test_if_route_spreads_over_the_card(B, T, N, grid, loads):
    """A small shape spreads over the card (64 CTAs at the bench's shape)
    with a few loads a thread; the threads of a large one stay at 256 a
    block."""
    r = ops._if_route(B, T, N, True)
    assert r.grid == grid
    assert max(len(_rounds(r, y, T)) for y in range(r.slots)) == loads
    assert r.warps == (8 if B == 4096 else 2)
    half = ops._if_route(B, T, N, True, sms=66)
    assert half.warps >= r.warps


def test_if_route_is_pure_and_matches_the_kernel(monkeypatch):
    """The route needs no library and no card, refuses an empty shape, and
    its limits are the kernel's constants."""
    import re
    from pathlib import Path

    from repro_torch.kernels import _build

    def no_library(*args, **kwargs):
        raise AssertionError("the route must not load the kernel library")

    monkeypatch.setattr(_build, "load_library", no_library)
    assert ops._if_route(8, 32, 256, True) == ops._if_route(8, 32, 256, True)
    for bad in ((0, 1, 4), (1, 1, 0), (1, -1, 4)):
        with pytest.raises(ValueError):
            ops._if_route(*bad, True)
    src = (Path(ops.__file__).parent / "csrc" / "if_neuron.cu").read_text()
    assert int(re.search(r"kMaxThreads = (\d+);", src)[1]) == ops._MAX_THREADS
    assert int(re.search(r"kSpan = (\d+);", src)[1]) == ops._SPAN
