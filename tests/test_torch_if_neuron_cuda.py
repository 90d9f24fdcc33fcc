"""repro_torch.kernels.if_neuron's CUDA kernel against its plain version.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports no JAX, so it runs on the card's machine, where the
JAX package is not installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_if_neuron_cuda.py

B11 (``if_neuron``) is held bit for bit against ``if_neuron_ref`` on
updates made with numpy from a seed, at the reference's shapes and ragged
and large ones, at threshold equality (which fires) and under int32
wraparound; on both of the kernel's paths (4 neurons a 16-byte load; one
neuron a load where N % 4 != 0 or an operand is not 16-byte aligned, as a
contiguous view at an offset may be), at T 0, 1 and past a span, and past
one wave of the card.  The plain version is held against the reference in
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


def _check(upd, vth, vec):
    """One launch, the expected path, bit for bit against the plain
    version."""
    assert ops._route_for(upd, vth).vec == vec
    ops.reset_launch_counts()
    got = ops.if_neuron(upd, vth)
    assert ops.launch_counts() == {"if_neuron": 1}
    for a, b in zip(got, ops.if_neuron_ref(upd, vth)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,N,vec", [
    (8, 32, 99, False), (5, 7, 10, False), (3, 1, 99, False),
    (8, 0, 256, True), (8, 1, 256, True), (8, 37, 256, True),
    (2, 70, 12, True), (4, 0, 10, False), (6, 37, 99, False),
    (3000, 3, 256, True), (2000, 2, 99, False), (4096, 32, 256, True)])
def test_cuda_paths_and_rounds(cuda, B, T, N, vec):
    upd, vth = _operands(7 * B + T + N, B, T, N)
    _check(torch.from_numpy(upd).to(cuda), torch.from_numpy(vth).to(cuda),
           vec)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,N,vec", [
    (8, 37, 99, False),   # T*N odd: the view starts 4 bytes past 16
    (8, 32, 99, False),   # 16-byte aligned, but N % 4 != 0
    (8, 37, 256, True),   # T*N % 4 == 0: the view stays aligned
])
def test_cuda_unaligned_views(cuda, B, T, N, vec):
    upd, vth = _operands(B * T + N, B + 1, T, N)
    big = torch.from_numpy(upd).to(cuda)
    _check(big[1:], torch.from_numpy(vth).to(cuda), vec)


@pytest.mark.cuda
def test_cuda_offset_views_take_the_scalar_path(cuda):
    upd, vth = _operands(3, 8, 32, 256)
    flat = torch.from_numpy(upd).to(cuda).reshape(-1)
    flat = torch.cat([flat[:1], flat])
    view = flat[1:].view(8, 32, 256)       # 4 bytes past an aligned start
    tv = torch.from_numpy(vth).to(cuda)
    _check(view, tv, False)
    vth_view = torch.cat([tv[:3], tv])[3:]  # 12 bytes past
    _check(torch.from_numpy(upd).to(cuda), vth_view, False)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,N,vec", [(8, 37, 256, True),
                                       (8, 37, 99, False)])
def test_cuda_wraps_on_both_paths(cuda, B, T, N, vec):
    rng = np.random.default_rng(11)
    upd = rng.integers(2**30, 2**31 - 1, size=(B, T, N)).astype(np.int32)
    upd[:, :, ::3] *= -1
    vth = rng.integers(-2**31, 2**31 - 1, size=(N,)).astype(np.int32)
    tu = torch.from_numpy(upd).to(cuda)
    _, vmem = _check(tu, torch.from_numpy(vth).to(cuda), vec)
    wide = tu.long().sum(1)
    assert not torch.equal(vmem.long(), wide)   # it did overflow
    assert torch.equal(vmem.long() & 0xFFFFFFFF, wide & 0xFFFFFFFF)
