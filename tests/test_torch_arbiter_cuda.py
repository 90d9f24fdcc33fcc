"""repro_torch.kernels.arbiter's CUDA kernels against their plain versions.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports no JAX, so it runs on the card's machine, where the
JAX package is not installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_arbiter_cuda.py

B5 (``port_schedule``) and B8 (``arbiter``) are held bit for bit against
``port_schedule_ref`` and ``arbiter_ref`` on request rows made with numpy
from a seed (all-zero and all-one densities, ports 1-4 and past the row
width, bool and uint8 requests, widths 32-256; B8 over widths 32, 128
and 1024, ports 1, 2, 4, 5 and 8, random, all-on and all-off requests and
1, 16 and 1000 groups, and on a request tensor that is not 4-byte
aligned).  The plain versions are
held against the reference in ``test_torch_arbiter.py``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels.arbiter import ops

PORTS = [1, 2, 3, 4]
#: request densities: the degenerate ends and the bulk
DENSITIES = [0.0, 0.1, 0.5, 1.0]


def _requests(seed, shape, density):
    return np.random.default_rng(seed).random(shape) < density


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 7, 1000, 8192, 24576])
@pytest.mark.parametrize("ports", PORTS + [5, 128, 200])
def test_cuda_kernels_match_plain(cuda, n, ports):
    for density in DENSITIES:
        r = torch.from_numpy(_requests(n + ports, (n, 128), density)).to(cuda)
        for dtype in (torch.bool, torch.uint8):
            ops.reset_launch_counts()
            got = ops.port_schedule(r.to(dtype), ports=ports)
            grants = ops.arbiter(r.to(dtype), ports=ports)
            assert ops.launch_counts() == {"port_schedule": int(n > 0),
                                           "arbiter": int(n > 0)}
            for g, w in zip(got + grants, ops.port_schedule_ref(r, ports)
                            + ops.arbiter_ref(r, ports)):
                assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [32, 64, 256])
def test_cuda_kernels_other_widths(cuda, width):
    r = torch.from_numpy(_requests(width, (77, width), 0.5)).to(cuda)
    for ports in (1, 3, 4):
        for g, w in zip(ops.port_schedule(r, ports=ports),
                        ops.port_schedule_ref(r, ports)):
            assert torch.equal(g, w)
        for g, w in zip(ops.arbiter(r, ports=ports), ops.arbiter_ref(r, ports)):
            assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [32, 128, 1024])
@pytest.mark.parametrize("ports", [1, 2, 4, 5, 8])
@pytest.mark.parametrize("n", [1, 16, 1000])
def test_cuda_arbiter_widths_ports_and_fills(cuda, width, ports, n):
    """B8 bit for bit (values and dtypes) at each width, port count and
    group count, on random, all-on and all-off requests."""
    for density in (0.5, 1.0, 0.0):
        r = torch.from_numpy(_requests(width + ports + n, (n, width),
                                       density)).to(cuda)
        ops.reset_launch_counts()
        got = ops.arbiter(r, ports=ports)
        assert ops.launch_counts()["arbiter"] == 1
        for g, w in zip(got, ops.arbiter_ref(r, ports)):
            assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
def test_cuda_arbiter_unaligned_requests(cuda):
    """Requests that start off a 4-byte boundary (a view into a larger
    buffer) give the same grants."""
    flat = torch.from_numpy(_requests(5, (16 * 128 + 1,), 0.5)).to(cuda)
    r = flat[1:].view(16, 128)
    assert r.data_ptr() % 4
    for g, w in zip(ops.arbiter(r, ports=4), ops.arbiter_ref(r, 4)):
        assert torch.equal(g, w)
