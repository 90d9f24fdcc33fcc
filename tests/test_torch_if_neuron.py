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
