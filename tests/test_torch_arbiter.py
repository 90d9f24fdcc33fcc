"""repro_torch arbiter against repro's: the functional arbiter, the closed-form
schedule and the plain versions of the two arbiter kernels, bit for bit.

On the CPU the port's ``priority_grants``, ``grant_cycles``,
``port_schedule_ref`` and ``arbiter_ref`` are held against the JAX functions,
the reference's Pallas kernels in interpret mode and the pure-Python cascade
of priority encoders, on request vectors made with numpy from a seed (ports
1-4, all-zero and all-one rows).  The CUDA kernels against their plain
versions run only on a card (marker ``cuda``); here they skip."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.esam import arbiter as jarb
from repro.kernels.arbiter import kernel as jkernel
from repro.kernels.arbiter import ops as jops
from repro_torch.core.esam import arbiter as arb
from repro_torch.kernels.arbiter import ops

PORTS = [1, 2, 3, 4]
#: request densities: the degenerate ends and the bulk
DENSITIES = [0.0, 0.1, 0.5, 1.0]


def _requests(seed, shape, density):
    return np.random.default_rng(seed).random(shape) < density


@pytest.mark.parametrize("ports", PORTS)
@pytest.mark.parametrize("density", DENSITIES)
def test_priority_grants_match_jax_and_oracle(ports, density):
    for seed in range(4):
        r = _requests(seed, (128,), density)
        want = jarb.priority_grants(jnp.asarray(r), ports)
        oracle = arb.priority_grants_oracle(r, ports)
        got = arb.priority_grants(torch.from_numpy(r), ports)
        for g, w, o in zip(got, want, oracle):
            assert g.dtype == torch.bool
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            np.testing.assert_array_equal(g.numpy(), o)


def test_priority_grants_batched_is_per_arbiter():
    """Leading dims are independent arbiters: the batched call equals the
    one-vector call row by row."""
    r = _requests(5, (3, 6, 128), 0.3)
    grants, remaining, valid = arb.priority_grants(torch.from_numpy(r), 4)
    assert grants.shape == (3, 6, 4, 128) and valid.shape == (3, 6, 4)
    for i in range(3):
        for j in range(6):
            g1, r1, v1 = arb.priority_grants_oracle(r[i, j], 4)
            np.testing.assert_array_equal(grants[i, j].numpy(), g1)
            np.testing.assert_array_equal(remaining[i, j].numpy(), r1)
            np.testing.assert_array_equal(valid[i, j].numpy(), v1)


@pytest.mark.parametrize("ports", PORTS)
@pytest.mark.parametrize("density", DENSITIES)
def test_grant_cycles_match_jax(ports, density):
    r = _requests(ports, (9, 128), density)
    want = np.asarray(jarb.grant_cycles(jnp.asarray(r), ports))
    got = arb.grant_cycles(torch.from_numpy(r), ports)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("pending,ports", [(0, 4), (1, 4), (4, 4), (5, 4),
                                           (128, 1), (128, 3), (127, 2)])
def test_drain_cycles_match_jax(pending, ports):
    assert arb.drain_cycles(pending, ports) == int(
        jarb.drain_cycles(jnp.asarray(pending), ports))
    loads = np.array([pending, 0, 7, 128], np.int32)
    got = arb.layer_drain_cycles(torch.from_numpy(loads), ports)
    assert got.dtype == torch.int32
    assert int(got) == int(jarb.layer_drain_cycles(jnp.asarray(loads), ports))


def _rows(seed, n, density):
    """[n, 128] request rows; the first two rows all-zero and all-one."""
    r = _requests(seed, (n, 128), density)
    r[0], r[1] = False, True
    return r


@pytest.mark.parametrize("ports", PORTS)
@pytest.mark.parametrize("density", [0.1, 0.5, 0.9])
def test_port_schedule_matches_jax_kernel_and_ref(ports, density):
    r = _rows(ports * 10, 16, density)
    jr = jnp.asarray(r.astype(np.int8))
    kern = jops.port_schedule(jr, ports=ports, use_kernel=True,
                              interpret=True)
    want = jops.port_schedule_ref(jr, ports)
    ops.reset_launch_counts()
    got = ops.port_schedule(torch.from_numpy(r), ports=ports)
    ref = ops.port_schedule_ref(torch.from_numpy(r), ports)
    assert ops.launch_counts() == {"port_schedule": 0, "arbiter": 0}
    for g, p, k, w in zip(got, ref, kern, want):
        assert g.dtype == p.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(k), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(p.numpy(), np.asarray(w))
    n_cycles = -(-128 // ports)
    assert got[1].shape == (16, n_cycles)
    np.testing.assert_array_equal(got[1].sum(-1).numpy(), r.sum(-1))


@pytest.mark.parametrize("ports", PORTS)
def test_arbiter_matches_jax_kernel_and_ref(ports):
    r = _rows(ports, 16, 0.4)
    jr = jnp.asarray(r.astype(np.int8))
    kern = jkernel.arbiter(jr, ports=ports, interpret=True)
    want = jops.arbiter_ref(jr, ports)
    got = ops.arbiter(torch.from_numpy(r).to(torch.uint8), ports=ports)
    for g, k, w in zip(got, kern, want):
        assert g.dtype == torch.int8
        np.testing.assert_array_equal(np.asarray(k), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # one arbiter cycle is the functional arbiter, row by row
    grants, remaining, valid = arb.priority_grants(torch.from_numpy(r), ports)
    assert torch.equal(got[0], grants.to(torch.int8))
    assert torch.equal(got[1], remaining.to(torch.int8))
    assert torch.equal(got[2], valid.to(torch.int8))


def test_rejects_bad_operands():
    r = torch.zeros((4, 128), dtype=torch.bool)
    for fn in (ops.port_schedule, ops.arbiter):
        with pytest.raises(ValueError):
            fn(torch.zeros((4, 100), dtype=torch.bool), ports=4)  # W % 32
        with pytest.raises(ValueError):
            fn(torch.zeros((128,), dtype=torch.bool), ports=4)    # not 2-D
        with pytest.raises(TypeError):
            fn(r.to(torch.int32), ports=4)
        for bad in (0, True, 2.0):
            with pytest.raises(ValueError):
                fn(r, ports=bad)
        with pytest.raises(ValueError):
            fn(r.to("meta"), ports=4)


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
