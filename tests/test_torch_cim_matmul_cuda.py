"""repro_torch.kernels.cim_matmul's CUDA kernel against its plain versions.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports no JAX, so it runs on the card's machine, where the
JAX package is not installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cim_matmul_cuda.py

B10a (``cim_matmul``: int32 V) and B10b (``esam_layer``: int8 fire) are
one tensor-core kernel; each call is one launch, held bit for bit against
``cim_matmul_ref`` / ``esam_layer_ref`` in every spike width (bool, int8,
bf16, float32, float64) at the CPU tests' shapes, the kernel bench's, 4096
x 768 -> 256 and ragged ones; at N 10 and 77, K 40000, all-zero and
all-one spikes, thresholds at -2^31 and 2^31 - 1, and on spike rows and
weight rows that start 16-byte aligned (16-byte loads, cp.async staging)
and that do not (element loads, byte staging), with nonzero inputs past
the view (which the kernel must not read as spikes).  The plain versions
are held against the reference in ``test_torch_cim_matmul.py``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels.cim_matmul import ops

#: the CPU tests' shapes (``test_torch_cim_matmul.py``)
SHAPES = [(8, 128, 128), (128, 128, 256), (64, 384, 128), (256, 256, 384)]
RAGGED = [(1, 100, 96), (7, 777, 10), (37, 33, 130)]
#: every spike width the kernel takes: 1, 2, 4 and 8 bytes
DTYPES = [torch.float32, torch.bfloat16, torch.int8, torch.bool,
          torch.float64]
ONE_LAUNCH = {"cim_matmul": 1, "esam_layer": 1}


def _operands(seed, B, K, N, p=0.4):
    rng = np.random.default_rng(seed)
    s = rng.random((B, K)) < p
    w = rng.integers(0, 2, size=(K, N), dtype=np.int8)
    vth = rng.integers(-9, 9, size=(N,), dtype=np.int32)
    return s, w, vth


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _check(ts, tw, tv):
    """Both kernels, one launch each, against the plain versions."""
    ops.reset_launch_counts()
    got_v, got_f = ops.cim_matmul(ts, tw), ops.esam_layer(ts, tw, tv)
    assert ops.launch_counts() == ONE_LAUNCH
    assert got_v.dtype == torch.int32 and got_f.dtype == torch.int8
    assert torch.equal(got_v, ops.cim_matmul_ref(ts, tw))
    assert torch.equal(got_f, ops.esam_layer_ref(ts, tw, tv))
    return got_v


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,N", SHAPES + RAGGED + [(256, 768, 256),
                                                    (4096, 768, 256)])
@pytest.mark.parametrize("tdt", DTYPES)
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


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,N", [(256, 768, 10), (4096, 768, 10),
                                   (37, 777, 77), (1000, 768, 77),
                                   (5, 40000, 96), (37, 40000, 10)])
@pytest.mark.parametrize("tdt", DTYPES)
def test_cuda_narrow_groups_and_long_inputs(cuda, B, K, N, tdt):
    """N 10 and 77 (a group partly empty: warps past N idle in the product)
    and K 40000 (157 K steps, the loads of later steps in flight)."""
    s, w, vth = _operands(B * N + K, B, K, N)
    _check(torch.from_numpy(s).to(tdt).to(cuda),
           torch.from_numpy(w).to(cuda), torch.from_numpy(vth).to(cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("fill", [0, 1])
@pytest.mark.parametrize("B,K,N", [(37, 777, 96), (256, 768, 256),
                                   (7, 100, 77)])
@pytest.mark.parametrize("tdt", DTYPES)
def test_cuda_all_zero_and_all_one_spikes(cuda, fill, B, K, N, tdt):
    _, w, vth = _operands(B + fill, B, K, N)
    ts = torch.full((B, K), fill, dtype=tdt, device=cuda)
    tw = torch.from_numpy(w).to(cuda)
    got = _check(ts, tw, torch.from_numpy(vth).to(cuda))
    want = fill * (2 * tw.to(torch.int32).sum(0, dtype=torch.int32) - K)
    assert torch.equal(got, want.expand(B, N))


@pytest.mark.cuda
@pytest.mark.parametrize("vth_value", [-2**31, 2**31 - 1])
@pytest.mark.parametrize("tdt", [torch.float32, torch.bool])
def test_cuda_extreme_thresholds(cuda, vth_value, tdt):
    """Every neuron fires at -2^31 and none at 2^31 - 1 (|V| <= K)."""
    s, w, _ = _operands(3, 37, 768, 96)
    ts = torch.from_numpy(s).to(tdt).to(cuda)
    tw = torch.from_numpy(w).to(cuda)
    tv = torch.full((96,), vth_value, dtype=torch.int32, device=cuda)
    _check(ts, tw, tv)
    assert bool((ops.esam_layer(ts, tw, tv) == int(vth_value < 0)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("first", [0, 16, 3])
@pytest.mark.parametrize("w_first", [0, 16, 7])
@pytest.mark.parametrize("tdt", DTYPES)
def test_cuda_aligned_and_unaligned_rows(cuda, first, w_first, tdt):
    """Spikes as columns first.. of a wider tensor whose other columns are
    all ones, weights as columns w_first..; the route loads 16 bytes at a
    time exactly where the rows start 16-byte aligned."""
    B, K, N, width = 45, 333, 70, 400
    s, w, vth = _operands(first + w_first, B, K, N)
    full = torch.ones((B, width), dtype=tdt)
    full[:, first:first + K] = torch.from_numpy(s).to(tdt)
    ts = full.to(cuda)[:, first:first + K]
    wide = np.zeros((K, 96), np.int8)   # rows 96 bytes apart
    wide[:, w_first:w_first + N] = w
    tw = torch.from_numpy(wide).to(cuda)[:, w_first:w_first + N]
    e = ts.element_size()
    aligned = ts.data_ptr() % 16 == 0 and width * e % 16 == 0
    assert ops._route_for(ts, N).vec == aligned
    _check(ts, tw, torch.from_numpy(vth).to(cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,tdt,span_rows", [
    (256, 256, torch.float32, 16), (4096, 256, torch.float32, 64),
    (4096, 256, torch.float64, 32), (1000, 77, torch.bool, 16)])
def test_cuda_routes(cuda, B, N, tdt, span_rows):
    """The route the wrapper takes on the card, and its result."""
    s, w, vth = _operands(B + N, B, 768, N)
    ts = torch.from_numpy(s).to(tdt).to(cuda)
    route = ops._route_for(ts, N)
    assert route.span_rows == span_rows and route.vec
    assert route == ops._matmul_route(B, N, ts.element_size(), True,
                                      torch.cuda.get_device_properties(
                                          cuda).multi_processor_count)
    _check(ts, torch.from_numpy(w).to(cuda), torch.from_numpy(vth).to(cuda))
