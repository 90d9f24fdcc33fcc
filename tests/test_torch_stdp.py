"""repro_torch.kernels.stdp against repro.kernels.stdp.

On the CPU the port's plain versions of the column-event and full-matrix
STDP kernels are held bit for bit against the reference's Pallas kernels in
interpret mode and against its jnp oracles, on inputs made with numpy from a
seed (odd widths, the gate on and off, the wrong-winner event's p_pot = 0).
The wrapper's in-place write and its launch counts are checked too.  The
CUDA kernels against the plain versions run only on a card (marker
``cuda``); here they skip."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.stdp import ops as jops
from repro_torch.kernels.stdp import ops

PROBS = [(1.0, 1.0), (0.25, 0.1), (0.0, 0.3), (0.2, 0.0)]


def _operands(seed, n_out, n_in, u_shape):
    rng = np.random.default_rng(seed)
    bits_t = rng.integers(0, 2, size=(n_out, n_in), dtype=np.int8)
    pre = rng.random(n_in) < 0.4
    u_pot = rng.random(u_shape, dtype=np.float32)
    u_dep = rng.random(u_shape, dtype=np.float32)
    return bits_t, pre, u_pot, u_dep


@pytest.mark.parametrize("n_out,n_in", [(10, 768), (8, 100), (16, 257),
                                        (1, 33)])
@pytest.mark.parametrize("p_pot,p_dep", PROBS)
def test_column_event_matches_reference(n_out, n_in, p_pot, p_dep):
    bits_t, pre, u_pot, u_dep = _operands(n_out * n_in, n_out, n_in, (n_in,))
    col = n_out // 2
    for apply in (True, False):
        want_k = jops.stdp_column_event(
            jnp.asarray(bits_t), jnp.asarray(col, jnp.int32),
            jnp.asarray(apply), jnp.asarray(pre), jnp.asarray(u_pot),
            jnp.asarray(u_dep), p_pot=p_pot, p_dep=p_dep, interpret=True)
        want_r = jops.stdp_column_event_ref(
            jnp.asarray(bits_t), jnp.asarray(col, jnp.int32),
            jnp.asarray(apply), jnp.asarray(pre), jnp.asarray(u_pot),
            jnp.asarray(u_dep), p_pot, p_dep)
        np.testing.assert_array_equal(np.asarray(want_k), np.asarray(want_r))
        for col_t in (torch.tensor(col), torch.tensor(col, dtype=torch.int32)):
            got = ops.stdp_column_event_ref(
                torch.from_numpy(bits_t), col_t, torch.tensor(apply),
                torch.from_numpy(pre), torch.from_numpy(u_pot),
                torch.from_numpy(u_dep), p_pot, p_dep)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want_k))


def test_column_event_wrapper_writes_in_place_on_the_cpu():
    bits_t, pre, u_pot, u_dep = _operands(3, 10, 256, (256,))
    for apply in (True, False):
        t = torch.from_numpy(bits_t.copy())
        ops.reset_launch_counts()
        out = ops.stdp_column_event(
            t, torch.tensor(4), torch.tensor(apply), torch.from_numpy(~pre),
            torch.from_numpy(u_pot), torch.from_numpy(u_dep),
            p_pot=0.0, p_dep=0.5)
        assert out is t
        assert ops.launch_counts() == {"stdp_column_event": 0,
                                       "stdp_update": 0}
        want = jops.stdp_column_event_ref(
            jnp.asarray(bits_t), jnp.asarray(4), jnp.asarray(apply),
            jnp.asarray(~pre), jnp.asarray(u_pot), jnp.asarray(u_dep),
            0.0, 0.5)
        np.testing.assert_array_equal(t.numpy(), np.asarray(want))
        others = np.delete(t.numpy(), 4, axis=0)
        np.testing.assert_array_equal(others, np.delete(bits_t, 4, axis=0))
    # p_pot = 0 never potentiates: no zero bit of row 4 becomes one
    t = torch.from_numpy(bits_t.copy())
    ops.stdp_column_event(t, torch.tensor(4), torch.tensor(True),
                          torch.ones(256, dtype=torch.bool),
                          torch.zeros(256), torch.zeros(256),
                          p_pot=0.0, p_dep=1.0)
    np.testing.assert_array_equal(t.numpy(), bits_t)


@pytest.mark.parametrize("n_out,n_in", [(16, 128), (8, 64), (24, 384)])
@pytest.mark.parametrize("p_pot,p_dep", PROBS)
def test_stdp_update_matches_reference(n_out, n_in, p_pot, p_dep):
    bits_t, pre, u_pot, u_dep = _operands(n_out + n_in, n_out, n_in,
                                          (n_out, n_in))
    post = np.random.default_rng(n_in).random(n_out) < 0.3
    want = jops.stdp_update(
        jnp.asarray(bits_t), jnp.asarray(pre, jnp.int8),
        jnp.asarray(post, jnp.int8), jnp.asarray(u_pot), jnp.asarray(u_dep),
        p_pot=p_pot, p_dep=p_dep, interpret=True)
    want_r = jops.stdp_update_ref(
        jnp.asarray(bits_t), jnp.asarray(pre), jnp.asarray(post),
        jnp.asarray(u_pot), jnp.asarray(u_dep), p_pot, p_dep)
    np.testing.assert_array_equal(np.asarray(want), np.asarray(want_r))
    ops.reset_launch_counts()
    for pre_t, post_t in ((torch.from_numpy(pre), torch.from_numpy(post)),
                          (torch.from_numpy(pre.astype(np.int8)),
                           torch.from_numpy(post.astype(np.int8)))):
        got = ops.stdp_update(torch.from_numpy(bits_t), pre_t, post_t,
                              torch.from_numpy(u_pot), torch.from_numpy(u_dep),
                              p_pot=p_pot, p_dep=p_dep)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert ops.launch_counts()["stdp_update"] == 0


def test_odd_n_in_full_matrix_matches_jnp_oracle():
    """The interpret kernel needs 128 | n_in; the oracle takes any width."""
    bits_t, pre, u_pot, u_dep = _operands(5, 7, 99, (7, 99))
    post = np.array([1, 0, 1, 1, 0, 0, 1], bool)
    want = jops.stdp_update_ref(
        jnp.asarray(bits_t), jnp.asarray(pre), jnp.asarray(post),
        jnp.asarray(u_pot), jnp.asarray(u_dep), 0.3, 0.2)
    got = ops.stdp_update(torch.from_numpy(bits_t), torch.from_numpy(pre),
                          torch.from_numpy(post), torch.from_numpy(u_pot),
                          torch.from_numpy(u_dep), p_pot=0.3, p_dep=0.2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wrapper_checks_shapes_and_devices():
    bits_t, pre, u_pot, u_dep = (torch.from_numpy(a) for a in
                                 _operands(1, 4, 32, (32,)))
    with pytest.raises(ValueError):
        ops.stdp_column_event(bits_t, torch.tensor(0), torch.tensor(True),
                              pre[:31], u_pot, u_dep, p_pot=0.1, p_dep=0.1)
    with pytest.raises(TypeError):
        ops.stdp_column_event(bits_t, torch.tensor(0), torch.tensor(True),
                              pre, u_pot.double(), u_dep, p_pot=0.1, p_dep=0.1)
    with pytest.raises(TypeError):
        ops.stdp_column_event(bits_t, torch.tensor(0), torch.tensor(1),
                              pre, u_pot, u_dep, p_pot=0.1, p_dep=0.1)
    with pytest.raises(ValueError):
        ops.stdp_update(bits_t, pre, torch.ones(3), u_pot[None].expand(4, 32),
                        u_dep[None].expand(4, 32), p_pot=0.1, p_dep=0.1)
    meta = torch.device("meta")
    with pytest.raises(ValueError):
        ops.stdp_column_event(bits_t.to(meta), torch.tensor(0),
                              torch.tensor(True), pre.to(meta),
                              u_pot.to(meta), u_dep.to(meta),
                              p_pot=0.1, p_dep=0.1)


# ----------------------------------------------------------------------- #
# the CUDA kernels against the plain versions, on the card
# ----------------------------------------------------------------------- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_out,n_in", [(10, 256), (256, 768), (8, 100)])
@pytest.mark.parametrize("p_pot,p_dep", PROBS)
def test_cuda_column_event_matches_plain(cuda, n_out, n_in, p_pot, p_dep):
    bits_t, pre, u_pot, u_dep = (torch.from_numpy(a).to(cuda) for a in
                                 _operands(n_in, n_out, n_in, (n_in,)))
    for col in (torch.tensor(n_out - 1, device=cuda),
                torch.tensor(0, dtype=torch.int32, device=cuda)):
        for apply in (True, False):
            gate = torch.tensor(apply, device=cuda)
            ops.reset_launch_counts()
            got = ops.stdp_column_event(bits_t.clone(), col, gate, pre,
                                        u_pot, u_dep, p_pot=p_pot, p_dep=p_dep)
            assert ops.launch_counts()["stdp_column_event"] == 1
            want = ops.stdp_column_event_ref(bits_t, col, gate, pre, u_pot,
                                             u_dep, p_pot, p_dep)
            assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n_out,n_in", [(10, 256), (256, 768), (7, 99)])
@pytest.mark.parametrize("p_pot,p_dep", PROBS)
def test_cuda_stdp_update_matches_plain(cuda, n_out, n_in, p_pot, p_dep):
    bits_t, pre, u_pot, u_dep = (torch.from_numpy(a).to(cuda) for a in
                                 _operands(n_in, n_out, n_in, (n_out, n_in)))
    post = torch.from_numpy(np.arange(n_out) % 3 == 0).to(cuda)
    ops.reset_launch_counts()
    got = ops.stdp_update(bits_t, pre, post, u_pot, u_dep,
                          p_pot=p_pot, p_dep=p_dep)
    assert ops.launch_counts()["stdp_update"] == 1
    want = ops.stdp_update_ref(bits_t, pre, post, u_pot, u_dep, p_pot, p_dep)
    assert torch.equal(got, want)
