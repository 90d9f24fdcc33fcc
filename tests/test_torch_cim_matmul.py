"""repro_torch.kernels.cim_matmul against repro.kernels.cim_matmul.

On the CPU the port's ``cim_matmul`` and ``esam_layer`` (their plain
versions) are held bit for bit against the reference's Pallas kernels in
interpret mode, at the reference's test shapes and in its four spike dtypes,
on inputs made with numpy from a seed; ragged shapes, which the TPU kernel's
block contract refuses, against the reference's jnp oracle.  The CUDA
kernels against the plain versions run only on a card (marker ``cuda``);
here they skip.  Every assert is exact."""

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
# the CUDA kernels against the plain versions, on the card
# ----------------------------------------------------------------------- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,N", SHAPES + RAGGED + [(256, 768, 256),
                                                    (4096, 768, 256)])
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16, torch.int8,
                                 torch.bool, torch.float64])
def test_cuda_kernels_match_plain(cuda, B, K, N, tdt):
    s, w, vth = _operands(B + K + N, B, K, N)
    ts = torch.from_numpy(s).to(tdt).to(cuda)
    tw, tv = torch.from_numpy(w).to(cuda), torch.from_numpy(vth).to(cuda)
    ops.reset_launch_counts()
    got_v, got_f = ops.cim_matmul(ts, tw), ops.esam_layer(ts, tw, tv)
    assert ops.launch_counts() == {"cim_matmul": 1, "esam_layer": 1}
    assert torch.equal(got_v, ops.cim_matmul_ref(ts, tw))
    assert torch.equal(got_f, ops.esam_layer_ref(ts, tw, tv))


@pytest.mark.cuda
def test_cuda_kernel_on_views(cuda):
    """Spikes as a column slice (strided rows) and weights as one."""
    s, w, vth = _operands(9, 33, 300, 200)
    ts = torch.from_numpy(s).float().to(cuda)[:, 50:250]
    tw = torch.from_numpy(w).to(cuda)[50:250, 7:107]
    tv = torch.from_numpy(vth[:100]).to(cuda)
    assert torch.equal(ops.cim_matmul(ts, tw), ops.cim_matmul_ref(ts, tw))
    assert torch.equal(ops.esam_layer(ts, tw, tv),
                       ops.esam_layer_ref(ts, tw, tv))
