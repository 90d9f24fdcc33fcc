"""repro_torch.kernels.cim_matmul_packed's CUDA kernel against its plain versions.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports no JAX, so it runs on the card's machine, where the
JAX package is not installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_matmul_packed_cuda.py

B9 (``esam_layer_packed``: packed and int8 out) and B9' (``cim_matmul_packed``:
int32 V) are one tensor-core kernel; each is held bit for bit against its
plain version at the CPU tests' shapes and the paths', with spike bits set
past K (the plain version drops them), on weight views whose rows start
16-byte aligned (staged by cp.async) and views whose rows do not (staged by
byte loads), on spans of one and two row tiles a warp, and on wide
inputs (K 24000 and 40000: the planes are built a step at a time).  The plain versions are held against the
reference in ``test_torch_matmul_packed.py``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import packing
from repro_torch.kernels.cim_matmul_packed import ops

#: the CPU tests' shapes (``test_torch_matmul_packed.py``)
SHAPES = [(64, 768, 256), (37, 100, 96), (129, 777, 128), (1, 33, 64),
          (200, 256, 256)]
NO_LAUNCH = {"fused_fire_packed": 0, "cim_matmul_packed": 0}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _operands(seed, B, K, N, p=0.5, *, tail=False):
    """Spike words (``tail``: every bit past K in the last word set, as no
    packer leaves it), {0,1} int8 weights and int32 thresholds."""
    rng = np.random.default_rng(seed)
    x = packing.pack_spikes_np(rng.random((B, K)) < p)
    if tail and K % 32:
        x[:, -1] |= np.uint32(~((1 << (K % 32)) - 1) & 0xFFFFFFFF)
    w = rng.integers(0, 2, size=(K, N), dtype=np.int8)
    vth = rng.integers(-9, 9, size=(N,), dtype=np.int32)
    return x, w, vth


def _on_card(device, x, w, vth):
    return (packing.words_from_np(x).to(device), torch.from_numpy(w).to(device),
            torch.from_numpy(vth).to(device))


def _check_both(xt, wt, vt, N):
    """Both epilogues of B9 and B9's MAC alone, one launch each, against
    the plain versions."""
    for pack_output in ([True, False] if N % 32 == 0 else [False]):
        ops.reset_launch_counts()
        got = ops.esam_layer_packed(xt, wt, vt, pack_output=pack_output)
        assert ops.launch_counts() == {**NO_LAUNCH, "fused_fire_packed": 1}
        assert torch.equal(got, ops.esam_layer_packed_ref(
            xt, wt, vt, pack_output=pack_output))
    ops.reset_launch_counts()
    got = ops.cim_matmul_packed(xt, wt)
    assert ops.launch_counts() == {**NO_LAUNCH, "cim_matmul_packed": 1}
    assert torch.equal(got, ops.cim_matmul_packed_ref(xt, wt))


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,N", SHAPES + [(4096, 768, 256),
                                            (1000, 777, 256), (3, 3000, 64)])
@pytest.mark.parametrize("pack_output", [True, False])
def test_cuda_fire_matches_plain(cuda, B, K, N, pack_output):
    xt, wt, vt = _on_card(cuda, *_operands(B + K + N, B, K, N))
    ops.reset_launch_counts()
    got = ops.esam_layer_packed(xt, wt, vt, pack_output=pack_output)
    assert ops.launch_counts() == {"fused_fire_packed": 1,
                                   "cim_matmul_packed": 0}
    want = ops.esam_layer_packed_ref(xt, wt, vt, pack_output=pack_output)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("width,first,N", [(80, 0, 70), (97, 1, 64),
                                           (256, 0, 256), (96, 32, 64),
                                           (77, 0, 77), (160, 16, 96)])
def test_cuda_fire_on_weight_views(cuda, width, first, N):
    """Weights as a column slice of a wider matrix: rows strided, the first
    group aligned or not, the last group partial or not; the kernel stages
    by cp.async exactly where every row starts 16-byte aligned, by byte
    loads otherwise, and both give the plain version's bits."""
    B, K = 77, 333
    x, w, vth = _operands(width + first, B, K, width, tail=True)
    xt = packing.words_from_np(x).to(cuda)
    wt = torch.from_numpy(w).to(cuda)[:, first:first + N]
    vt = torch.from_numpy(vth[:N]).to(cuda)
    aligned = wt.data_ptr() % 16 == 0 and wt.stride(0) % 16 == 0
    assert aligned == (width % 16 == 0 and first % 16 == 0)
    for pack_output in ([True, False] if N % 32 == 0 else [False]):
        got = ops.esam_layer_packed(xt, wt, vt, pack_output=pack_output)
        want = ops.esam_layer_packed_ref(xt, wt, vt, pack_output=pack_output)
        assert torch.equal(got, want)
    assert torch.equal(ops.cim_matmul_packed(xt, wt),
                       ops.cim_matmul_packed_ref(xt, wt))


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,N", SHAPES + [(1024, 768, 768),
                                            (4096, 768, 256), (7, 777, 10),
                                            (1, 100, 96), (3, 3000, 64)])
def test_cuda_mac_matches_plain(cuda, B, K, N):
    x, w, _ = _operands(2 * B + K + N, B, K, N)
    xt = packing.words_from_np(x).to(cuda)
    wt = torch.from_numpy(w).to(cuda)
    ops.reset_launch_counts()
    got = ops.cim_matmul_packed(xt, wt)
    assert ops.launch_counts() == {"fused_fire_packed": 0,
                                   "cim_matmul_packed": 1}
    assert torch.equal(got, ops.cim_matmul_packed_ref(xt, wt))


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,N", [(37, 777, 96), (64, 100, 256),
                                   (5, 33, 64), (1000, 777, 256),
                                   (9, 40001, 64)])
def test_cuda_bits_past_k_are_dropped(cuda, B, K, N):
    """Spike words with every bit past K set: the plain versions unpack K
    bits and drop the rest, and so does the kernel, in the product and in
    the spike count alike."""
    xt, wt, vt = _on_card(cuda, *_operands(B * K, B, K, N, tail=True))
    assert int(packing.words_to_np(xt.cpu())[0, -1]) >> (K % 32)
    _check_both(xt, wt, vt, N)


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,N,tiles", [
    (4096, 768, 256, 1),         # the learning prefix: 32 spans of 128
    (1024, 768, 768, 1),         # the bench's MAC: 11 spans of 96 rows
    (300, 768, 4096, 2),         # 160-row spans: two tiles a warp
    (5000, 777, 64, 1),          # 48-row spans past the card: 105 spans
    (37, 40000, 96, 1),          # 157 K steps
    (600, 24000, 2048, 2),       # both at once
    (1, 100, 96, 1), (7, 777, 10, 1)])
def test_cuda_packed_routes(cuda, B, K, N, tiles):
    """Each of the kernel's routes (one or two row tiles a warp) on paired
    and unpaired spike loads, at short and long K, bit for bit."""
    x, w, vth = _operands(B + N, B, K, N, tail=True)
    for stride_pad in (0, 1):
        full = np.zeros((B, x.shape[1] + stride_pad), np.uint32)
        full[:, :x.shape[1]] = x
        xt = packing.words_from_np(full).to(cuda)[:, :x.shape[1]]
        wt, vt = torch.from_numpy(w).to(cuda), torch.from_numpy(vth).to(cuda)
        route = ops._route_for(xt, N)
        assert -(-route.span_rows // 128) == tiles
        assert route.paired == (x.shape[1] % 2 == 0 and stride_pad == 0)
        _check_both(xt, wt, vt, N)
