"""repro_torch.kernels.cim_matmul against repro.kernels.cim_matmul.

On the CPU the port's ``cim_matmul`` and ``esam_layer`` (their plain
versions) are held bit for bit against the reference's Pallas kernels in
interpret mode, at the reference's test shapes and in its four spike dtypes,
on inputs made with numpy from a seed; ragged shapes, which the TPU kernel's
block contract refuses, against the reference's jnp oracle; the kernel's
route (its grid) on the shapes' arithmetic alone.  The CUDA kernels
against the plain versions are in ``test_torch_cim_matmul_cuda.py``, which
imports no JAX.  Every assert is exact."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.cim_matmul import ops as jops
from repro_torch.kernels.cim_matmul import ops

#: the reference's shapes and spike dtypes (tests/test_kernels.py)
SHAPES = [(8, 128, 128), (128, 128, 256), (64, 384, 128), (256, 256, 384)]
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16),
          (jnp.int8, torch.int8), (jnp.bool_, torch.bool)]
RAGGED = [(1, 100, 96), (7, 777, 10), (37, 33, 130)]


def _operands(seed, B, K, N, p=0.4):
    rng = np.random.default_rng(seed)
    s = rng.random((B, K)) < p
    w = rng.integers(0, 2, size=(K, N), dtype=np.int8)
    vth = rng.integers(-9, 9, size=(N,), dtype=np.int32)
    return s, w, vth


def _both(s, w, vth, jdt, tdt):
    """The same operands for the reference (jnp) and the port (torch)."""
    return ((jnp.asarray(s).astype(jdt), jnp.asarray(w), jnp.asarray(vth)),
            (torch.from_numpy(s).to(tdt), torch.from_numpy(w),
             torch.from_numpy(vth)))


@pytest.mark.parametrize("B,K,N", SHAPES)
@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=lambda d: str(d))
def test_cim_matmul_matches_jax_kernel(B, K, N, jdt, tdt):
    s, w, vth = _operands(B + K + N, B, K, N)
    (js, jw, _), (ts, tw, _) = _both(s, w, vth, jdt, tdt)
    want = np.asarray(jops.cim_matmul(js, jw, interpret=True))
    np.testing.assert_array_equal(want, np.asarray(jops.cim_matmul_ref(js, jw)))
    ops.reset_launch_counts()
    got = ops.cim_matmul(ts, tw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert ops.launch_counts() == {"cim_matmul": 0, "esam_layer": 0}


@pytest.mark.parametrize("B,K,N", SHAPES)
def test_esam_layer_matches_jax_kernel_random_vth(B, K, N):
    s, w, vth = _operands(3 * B + K, B, K, N, p=0.5)
    (js, jw, jv), (ts, tw, tv) = _both(s, w, vth, jnp.float32, torch.float32)
    want = np.asarray(jops.esam_layer(js, jw, jv, interpret=True))
    got = ops.esam_layer(ts, tw, tv)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size


@pytest.mark.parametrize("jdt,tdt", DTYPES[1:], ids=lambda d: str(d))
def test_esam_layer_spike_dtypes(jdt, tdt):
    s, w, vth = _operands(5, 8, 128, 128)
    (js, jw, jv), (ts, tw, tv) = _both(s, w, vth, jdt, tdt)
    want = np.asarray(jops.esam_layer(js, jw, jv, interpret=True))
    np.testing.assert_array_equal(ops.esam_layer(ts, tw, tv).numpy(), want)


@pytest.mark.parametrize("sval,wval", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_extreme_inputs(sval, wval):
    """All-silent or all-firing spikes against all-zero or all-one bits."""
    s = np.full((8, 128), sval, np.float32)
    w = np.full((128, 128), wval, np.int8)
    want = np.asarray(jops.cim_matmul(jnp.asarray(s), jnp.asarray(w),
                                      interpret=True))
    got = ops.cim_matmul(torch.from_numpy(s), torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.all(want == sval * (128 if wval else -128))


@pytest.mark.parametrize("B,K,N", RAGGED)
def test_ragged_shapes_match_jax_ref(B, K, N):
    s, w, vth = _operands(B * N + K, B, K, N)
    (js, jw, jv), (ts, tw, tv) = _both(s, w, vth, jnp.float32, torch.float32)
    np.testing.assert_array_equal(ops.cim_matmul(ts, tw).numpy(),
                                  np.asarray(jops.cim_matmul_ref(js, jw)))
    np.testing.assert_array_equal(ops.esam_layer(ts, tw, tv).numpy(),
                                  np.asarray(jops.esam_layer_ref(js, jw, jv)))


def test_rejects_bad_operands():
    s, w, vth = _operands(2, 4, 64, 48)
    ts, tw, tv = (torch.from_numpy(s).float(), torch.from_numpy(w),
                  torch.from_numpy(vth))
    with pytest.raises(ValueError):          # K mismatch
        ops.cim_matmul(ts, tw[:30])
    with pytest.raises(ValueError):          # not [B, K]
        ops.cim_matmul(ts[0], tw)
    with pytest.raises(ValueError):          # vth length
        ops.esam_layer(ts, tw, tv[:10])
    with pytest.raises(TypeError):           # complex spikes
        ops.cim_matmul(ts.to(torch.complex64), tw)
    meta = torch.device("meta")
    with pytest.raises(ValueError):          # neither CPU nor CUDA
        ops.cim_matmul(ts.to(meta), tw.to(meta))
    with pytest.raises(ValueError):          # mixed devices
        ops.esam_layer(ts, tw.to(meta), tv)
    assert ops.launch_counts() == {"cim_matmul": 0, "esam_layer": 0}


# ----------------------------------------------------------------------- #
# the card kernel's grid, from the shape alone
# ----------------------------------------------------------------------- #
#: (B, N): the CPU tests', the bench's, the large and ragged shapes
ROUTE_SHAPES = [(B, N) for B, _, N in SHAPES + RAGGED] + [
    (256, 256), (4096, 256), (4096, 10), (1000, 77), (33, 100), (2000, 768),
    (100_000, 10)]


@pytest.mark.parametrize("B,N", ROUTE_SHAPES)
@pytest.mark.parametrize("spike_bytes", [1, 2, 4, 8])
def test_matmul_route_covers_the_shape(B, N, spike_bytes):
    """The grid covers B rows (spans of 1, 2 or 4 row tiles of 16, a K
    step's spikes at most 16 chunks of 16 bytes a thread, less than a span
    past B) and N neurons (64 a group)."""
    r = ops._matmul_route(B, N, spike_bytes, vec=True)
    spans, groups = r.grid
    assert r.vec
    assert r.span_rows in (16, 32, 64)
    assert r.span_rows // 16 * spike_bytes <= ops._MAX_CHUNKS
    assert spans * r.span_rows >= B > (spans - 1) * r.span_rows
    assert groups == -(-N // 64)


@pytest.mark.parametrize("B,N,spike_bytes,grid,span_rows", [
    (256, 256, 4, (16, 4), 16),       # the bench: the shortest span
    (256, 256, 1, (16, 4), 16),
    (4096, 256, 4, (64, 4), 64),      # past one CTA an SM: the longest
    (4096, 256, 1, (64, 4), 64),
    (4096, 256, 8, (128, 4), 32),     # 8-byte spikes: two tiles at most
    (4096, 10, 4, (128, 1), 32),      # one group: 128 CTAs of 32 rows
    (1000, 77, 1, (63, 2), 16),
])
def test_matmul_route_fills_the_card(B, N, spike_bytes, grid, span_rows):
    """On an H100's 132 SMs the span is the shortest whose grid fits the
    card once, so each group's planes are built as few times as the card
    allows; where none fits, the longest the spike width allows.  Half as
    many SMs take longer spans."""
    r = ops._matmul_route(B, N, spike_bytes, vec=False)
    assert (r.grid, r.span_rows, r.vec) == (grid, span_rows, False)
    ctas = r.grid[0] * r.grid[1]
    longest = 64 if spike_bytes <= 4 else 32
    assert ctas <= 132 or r.span_rows == longest
    shorter = -(-B // (r.span_rows // 2)) * r.grid[1]
    assert r.span_rows == 16 or shorter > 132
    half = ops._matmul_route(B, N, spike_bytes, False, sms=66)
    assert half.span_rows >= r.span_rows


def test_matmul_route_is_pure(monkeypatch):
    """The route needs no library and no card: it is computed from the
    shape alone, and refuses an empty shape or a spike width the kernel
    has no instantiation for."""
    from repro_torch.kernels import _build

    def no_library(*args, **kwargs):
        raise AssertionError("the route must not load the kernel library")

    monkeypatch.setattr(_build, "load_library", no_library)
    assert (ops._matmul_route(37, 77, 2, True)
            == ops._matmul_route(37, 77, 2, True))
    for bad in ((0, 10, 4), (1, 0, 4), (1, 10, 3), (1, 10, 16)):
        with pytest.raises(ValueError):
            ops._matmul_route(*bad, True)
