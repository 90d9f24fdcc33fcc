"""repro_torch.kernels.cim_matmul_packed against repro.kernels.cim_matmul_packed.

On the CPU the port's plain version of the packed-spike fire tile is held
bit for bit against the reference's Pallas ``fused_fire_packed_kernel`` in
interpret mode and its jnp reference, on inputs made with numpy from a seed
(odd K, ragged batches, both output forms).  The CUDA kernel against the
plain version runs only on a card (marker ``cuda``); here it skips."""

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
    assert ops.launch_counts() == {"fused_fire_packed": 0}
    got = packing.words_to_np(got) if pack_output else got.numpy()
    np.testing.assert_array_equal(got, want)


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


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,N", SHAPES + [(4096, 768, 256),
                                            (1000, 777, 256), (3, 3000, 64)])
@pytest.mark.parametrize("pack_output", [True, False])
def test_cuda_fire_matches_plain(cuda, B, K, N, pack_output):
    x, w, vth = _operands(B + K + N, B, K, N)
    xt, wt, vt = (packing.words_from_np(x).to(cuda),
                  torch.from_numpy(w).to(cuda), torch.from_numpy(vth).to(cuda))
    ops.reset_launch_counts()
    got = ops.esam_layer_packed(xt, wt, vt, pack_output=pack_output)
    assert ops.launch_counts() == {"fused_fire_packed": 1}
    want = ops.esam_layer_packed_ref(xt, wt, vt, pack_output=pack_output)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("width,first,N", [(80, 0, 70), (97, 1, 64),
                                           (256, 0, 256)])
def test_cuda_fire_on_weight_views(cuda, width, first, N):
    """Weights as a column slice of a wider matrix: rows strided, the first
    group aligned or not, the last group partial or not."""
    B, K = 77, 333
    x, w, vth = _operands(width + first, B, K, width)
    xt = packing.words_from_np(x).to(cuda)
    wt = torch.from_numpy(w).to(cuda)[:, first:first + N]
    vt = torch.from_numpy(vth[:N]).to(cuda)
    for pack_output in ([True, False] if N % 32 == 0 else [False]):
        got = ops.esam_layer_packed(xt, wt, vt, pack_output=pack_output)
        want = ops.esam_layer_packed_ref(xt, wt, vt, pack_output=pack_output)
        assert torch.equal(got, want)
