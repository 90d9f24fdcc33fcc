"""repro_torch.kernels.if_neuron's CUDA kernel against its plain version.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports no JAX, so it runs on the card's machine, where the
JAX package is not installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_if_neuron_cuda.py

B11 (``if_neuron``) is held bit for bit against ``if_neuron_ref`` on
updates made with numpy from a seed, at the reference's shapes and ragged
and large ones, at threshold equality (which fires) and under int32
wraparound.  The plain version is held against the reference in
``test_torch_if_neuron.py``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels.if_neuron import ops

#: the reference's shapes (tests/test_kernels.py)
SHAPES = [(8, 32, 128), (16, 5, 256), (8, 1, 128)]


def _operands(seed, B, T, N):
    rng = np.random.default_rng(seed)
    upd = rng.integers(-4, 5, size=(B, T, N), dtype=np.int32)
    vth = rng.integers(-20, 20, size=(N,), dtype=np.int32)
    return upd, vth


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,N", SHAPES + [(8, 32, 256), (1, 5, 10),
                                            (7, 3, 100), (4096, 4, 256)])
def test_cuda_matches_plain(cuda, B, T, N):
    upd, vth = _operands(B + T + N, B, T, N)
    tu, tv = torch.from_numpy(upd).to(cuda), torch.from_numpy(vth).to(cuda)
    ops.reset_launch_counts()
    got = ops.if_neuron(tu, tv)
    assert ops.launch_counts() == {"if_neuron": 1}
    for a, b in zip(got, ops.if_neuron_ref(tu, tv)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_wraps_and_fires_at_equality(cuda):
    big = torch.full((8, 4, 128), 2**30 + 3, dtype=torch.int32, device=cuda)
    zero = torch.zeros((128,), dtype=torch.int32, device=cuda)
    for a, b in zip(ops.if_neuron(big, zero), ops.if_neuron_ref(big, zero)):
        assert torch.equal(a, b)
    ones = torch.ones((8, 3, 128), dtype=torch.int32, device=cuda)
    spikes, vmem = ops.if_neuron(ones, zero + 3)
    assert bool(spikes.all()) and bool((vmem == 3).all())
