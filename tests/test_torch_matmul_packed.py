"""repro_torch.kernels.cim_matmul_packed against repro.kernels.cim_matmul_packed.

On the CPU the port's plain versions of the packed-spike tile -- the fire
(``esam_layer_packed``) and the MAC alone (``cim_matmul_packed``) -- are
held bit for bit against the reference's Pallas ``fused_fire_packed_kernel``
and ``mac_packed_kernel`` in interpret mode and its jnp reference, on inputs
made with numpy from a seed (odd K, ragged batches, both output forms),
and the card kernel's grid (``_packed_route``, pure geometry) is checked.
The CUDA kernel against the plain versions is in
``test_torch_matmul_packed_cuda.py`` (no JAX, so it runs on the card's
machine)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as jpacking
from repro.kernels.cim_matmul_packed import ops as jops
from repro_torch.core import packing
from repro_torch.kernels.cim_matmul_packed import ops

# the interpret-mode kernel needs N % min(128, N) == 0 (its block contract)
SHAPES = [(64, 768, 256), (37, 100, 96), (129, 777, 128), (1, 33, 64),
          (200, 256, 256)]


def _operands(seed, B, K, N, p=0.5):
    rng = np.random.default_rng(seed)
    x = jpacking.pack_spikes_np(rng.random((B, K)) < p)
    w = rng.integers(0, 2, size=(K, N), dtype=np.int8)
    vth = rng.integers(-9, 9, size=(N,), dtype=np.int32)
    return x, w, vth


@pytest.mark.parametrize("B,K,N", SHAPES)
@pytest.mark.parametrize("pack_output", [True, False])
def test_fire_matches_jax_kernel_and_ref(B, K, N, pack_output):
    x, w, vth = _operands(B * K + N, B, K, N)
    args = (jnp.asarray(x), jnp.asarray(w), jnp.asarray(vth))
    kern = np.asarray(jops.esam_layer_packed(
        *args, pack_output=pack_output, interpret=True))
    want = np.asarray(jops.esam_layer_packed_ref(*args, pack_output=pack_output))
    np.testing.assert_array_equal(kern, want)
    ops.reset_launch_counts()
    got = ops.esam_layer_packed(packing.words_from_np(x), torch.from_numpy(w),
                                torch.from_numpy(vth), pack_output=pack_output)
    assert ops.launch_counts() == {"fused_fire_packed": 0,
                                   "cim_matmul_packed": 0}
    got = packing.words_to_np(got) if pack_output else got.numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("B,K,N", SHAPES)
def test_mac_matches_jax_kernel(B, K, N):
    """B9': the MAC without the fire, K = 100 and 777 included (the
    reference pads K to its block; the port masks the last word)."""
    x, w, _ = _operands(B + 2 * K + N, B, K, N)
    want = np.asarray(jops.cim_matmul_packed(jnp.asarray(x), jnp.asarray(w),
                                             interpret=True))
    ops.reset_launch_counts()
    got = ops.cim_matmul_packed(packing.words_from_np(x), torch.from_numpy(w))
    assert ops.launch_counts() == {"fused_fire_packed": 0,
                                   "cim_matmul_packed": 0}
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_mac_ref_matches_jax_ref():
    x, w, _ = _operands(4, 21, 70, 40)
    want = np.asarray(jops.cim_matmul_packed_ref(jnp.asarray(x),
                                                 jnp.asarray(w)))
    got = ops.cim_matmul_packed_ref(packing.words_from_np(x),
                                    torch.from_numpy(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_rejects_bad_operands():
    x, w, vth = _operands(2, 4, 64, 48)
    xt, wt, vt = (packing.words_from_np(x), torch.from_numpy(w),
                  torch.from_numpy(vth))
    with pytest.raises(ValueError):   # packed output needs 32 | N
        ops.esam_layer_packed(xt, wt, vt)
    with pytest.raises(ValueError):
        ops.esam_layer_packed(xt, wt[:30], vt, pack_output=False)
    with pytest.raises(TypeError):
        ops.esam_layer_packed(xt.to(torch.int64), wt, vt, pack_output=False)
    meta = torch.device("meta")
    with pytest.raises(ValueError):
        ops.esam_layer_packed(xt.to(meta), wt.to(meta), vt.to(meta),
                              pack_output=False)
    with pytest.raises(ValueError):
        ops.cim_matmul_packed(xt, wt[:30])
    with pytest.raises(TypeError):
        ops.cim_matmul_packed(xt.to(torch.int64), wt)
    with pytest.raises(ValueError):
        ops.cim_matmul_packed(xt.to(meta), wt.to(meta))


# ----------------------------------------------------------------------- #
# the card kernel's grid (B9 and B9', one kernel)
# ----------------------------------------------------------------------- #
PACKED_ROUTE_SHAPES = [  # (B, N)
    (4096, 256), (1024, 768), (1024, 10), (1000, 256), (37, 96), (1, 96),
    (7, 10), (3, 64), (300, 4096), (5000, 64), (100_000, 4096), (1, 1),
    (129, 128), (16, 8448), (33, 65), (600, 2048), (16_896, 64)]


@pytest.mark.parametrize("B,N", PACKED_ROUTE_SHAPES)
@pytest.mark.parametrize("paired", [True, False])
def test_packed_route_covers_the_shape(B, N, paired):
    """The grid covers B rows (spans of a multiple of 16 rows, at most 256,
    less than a span past B) and N neurons (64 a group)."""
    r = ops._packed_route(B, N, paired)
    spans, groups = r.grid
    assert r.paired is paired
    assert r.span_rows % 16 == 0 and 16 <= r.span_rows <= ops._MAX_SPAN
    assert spans * r.span_rows >= B > (spans - 1) * r.span_rows
    assert groups == -(-N // 64)


@pytest.mark.parametrize("B,K,N", [(4096, 768, 256), (4096, 256, 256),
                                   (1024, 768, 768), (1000, 777, 256)])
def test_packed_route_fills_the_card(B, K, N):
    """At the paths' shapes the grid fills an H100's 132 SMs about once:
    at most one CTA an SM and at least nine in ten SMs busy, so each
    group's planes are built as few times as the card allows."""
    r = ops._packed_route(B, N, packing.packed_width(K) % 2 == 0)
    ctas = r.grid[0] * r.grid[1]
    assert 0.9 * 132 <= ctas <= 132
    assert ops._packed_route(B, N, True, sms=66).grid[0] < r.grid[0]


def test_packed_route_is_pure(monkeypatch):
    """The route needs no library and no card: it is computed from the
    shape alone, and refuses an empty one."""
    from repro_torch.kernels import _build

    def no_library(*args, **kwargs):
        raise AssertionError("the route must not load the kernel library")

    monkeypatch.setattr(_build, "load_library", no_library)
    assert ops._packed_route(37, 77, False) == ops._packed_route(37, 77, False)
    for bad in ((0, 10), (1, 0)):
        with pytest.raises(ValueError):
            ops._packed_route(*bad, True)
