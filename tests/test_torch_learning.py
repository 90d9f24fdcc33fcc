"""repro_torch.core.esam.learning against repro.core.esam.learning.

The same numpy-made networks, spikes and labels, and the same PRNGKey, go
through both packages; the port draws its own uniforms (core/prng.py) and
must give the same bits.  Tolerance 0 everywhere: weight bits, spikes,
V_mem and update counts are equal.  Tests that need a card (the epoch on
the CUDA kernels against the same epoch on the CPU) carry the ``cuda``
marker and skip here."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.esam import learning as jl
from repro_torch.core import prng
from repro_torch.core.esam import cost_model as cm
from repro_torch.core.esam import learning
from repro_torch.core.esam.network import EsamNetwork


def _net(topo, seed, *, tied=False):
    """numpy bits/vth (hidden vth small ints, readout never fires)."""
    rng = np.random.default_rng(seed)
    bits = [rng.integers(0, 2, size=(k, n), dtype=np.int8)
            for k, n in zip(topo[:-1], topo[1:])]
    if tied:   # identical readout columns: every V_mem ties
        bits[-1][:] = bits[-1][:, :1]
    vth = [rng.integers(-4, 5, size=(n,), dtype=np.int32) for n in topo[1:-1]]
    vth.append(np.full((topo[-1],), 2**31 - 1, np.int32))
    return bits, vth


def _data(seed, batch, n_in, n_cls, density=0.4):
    rng = np.random.default_rng(seed)
    x = rng.random((batch, n_in)) < density
    y = rng.integers(0, n_cls, size=(batch,)).astype(np.int32)
    return x, y


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


# ----------------------------------------------------------------------- #
# the rule and its draws
# ----------------------------------------------------------------------- #
@pytest.mark.parametrize("p_pot,p_dep", [(0.0, 0.0), (1.0, 1.0), (0.3, 0.1)])
def test_rule_from_uniforms(p_pot, p_dep):
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, size=(70, 12), dtype=np.int8)
    pre, post = rng.random(70) < 0.4, rng.random(12) < 0.3
    u_pot = rng.random((70, 12), dtype=np.float32)
    u_dep = rng.random((70, 1), dtype=np.float32)     # broadcast columns
    want = jl.stdp_update_from_uniforms(
        *_j([bits, pre, post, u_pot, u_dep]), p_pot, p_dep)
    got = learning.stdp_update_from_uniforms(
        *_t([bits, pre, post, u_pot, u_dep]), p_pot, p_dep)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [3, 2**31 + 7])
def test_stdp_update_keyed(seed):
    rng = np.random.default_rng(seed % 1000)
    bits = rng.integers(0, 2, size=(128, 32), dtype=np.int8)
    pre, post = rng.random(128) < 0.5, rng.random(32) < 0.4
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    want = jl.stdp_update(*_j([bits, pre, post]), key, 0.3, 0.2)
    want_k = jl.stdp_update(*_j([bits, pre, post]), key, 0.3, 0.2,
                            use_kernel=True, interpret=True)
    np.testing.assert_array_equal(np.asarray(want_k), np.asarray(want))
    got = learning.stdp_update(*_t([bits, pre, post]),
                               prng.fold_in(prng.PRNGKey(seed), 3), 0.3, 0.2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_column_event_uniforms_vectorised():
    key = jax.random.PRNGKey(9)
    idx = torch.arange(5)
    got = learning.column_event_uniforms(prng.PRNGKey(9), idx, 37)
    for i in range(5):
        want = jl.column_event_uniforms(key, jnp.int32(i), 37)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))
    one = learning.column_event_uniforms(prng.PRNGKey(9), 3, 37)
    for g, w in zip(one, got):
        assert torch.equal(g, w[3])


def test_readout_vmem():
    rng = np.random.default_rng(2)
    bits_t = rng.integers(0, 2, size=(10, 70), dtype=np.int8)
    s = rng.random((6, 70)) < 0.5
    want = jl.readout_vmem(jnp.asarray(bits_t), jnp.asarray(s))
    got = learning.readout_vmem(torch.from_numpy(bits_t), torch.from_numpy(s))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    one = learning.readout_vmem(torch.from_numpy(bits_t), torch.from_numpy(s[0]))
    np.testing.assert_array_equal(one.numpy(), np.asarray(want)[0])


@pytest.mark.parametrize("read_ports", range(5))
def test_column_update_cost(read_ports):
    want = jl.column_update_cost(read_ports)
    got = learning.column_update_cost(read_ports)
    assert got.__dict__ == want.__dict__
    assert cm.column_update_cycles(read_ports, 64) == (
        jl.cm.column_update_cycles(read_ports, 64))


# ----------------------------------------------------------------------- #
# the prefix and the epochs
# ----------------------------------------------------------------------- #
@pytest.mark.parametrize("topo", [(70, 32, 32, 10), (70, 40, 10), (70, 10)])
def test_last_hidden_spikes(topo):
    """Packed prefix (32-aligned hidden widths), dense prefix, no prefix."""
    bits, vth = _net(topo, 4)
    x, _ = _data(5, 23, topo[0], topo[-1])
    want = jl.last_hidden_spikes(_j(bits), _j(vth), jnp.asarray(x))
    got = learning.last_hidden_spikes(_t(bits), _t(vth), torch.from_numpy(x))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("offset", [False, True])
@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("labels_dtype", [np.int32, np.int64])
def test_column_event_epoch(offset, tied, labels_dtype):
    bits, _ = _net((32, 10), 6, tied=tied)
    pre, y = _data(7, 40, 32, 10, density=0.5)
    off = (np.random.default_rng(8).normal(size=10).astype(np.float32)
           if offset else None)
    bits_t = np.ascontiguousarray(bits[0].T)
    want_b, want_n = jl.column_event_epoch(
        jnp.asarray(bits_t), jnp.asarray(pre), jnp.asarray(y),
        jax.random.PRNGKey(11), p_pot=0.3, p_dep=0.15,
        out_offset=None if off is None else jnp.asarray(off))
    t = torch.from_numpy(bits_t.copy())
    got_b, got_n = learning.column_event_epoch(
        t, torch.from_numpy(pre), torch.from_numpy(y.astype(labels_dtype)),
        prng.PRNGKey(11), p_pot=0.3, p_dep=0.15,
        out_offset=None if off is None else torch.from_numpy(off))
    assert got_b is t                                  # updated in place
    assert got_n.dtype == torch.int32
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    assert int(got_n) == int(want_n) > 0


@pytest.mark.parametrize("topo", [(70, 32, 32, 10), (70, 40, 10)])
@pytest.mark.parametrize("given_pre", [False, True])
def test_online_learning_epoch(topo, given_pre):
    bits, vth = _net(topo, 9)
    x, y = _data(10, 48, topo[0], topo[-1])
    pre_j = jl.last_hidden_spikes(_j(bits), _j(vth), jnp.asarray(x))
    want_b, want_n = jl.online_learning_epoch(
        _j(bits), _j(vth), jnp.asarray(x), jnp.asarray(y),
        jax.random.PRNGKey(9), p_pot=0.3, p_dep=0.15,
        pre_spikes=pre_j if given_pre else None)
    net_bits = _t(bits)
    got_b, got_n = learning.online_learning_epoch(
        net_bits, _t(vth), torch.from_numpy(x), torch.from_numpy(y),
        prng.PRNGKey(9), p_pot=0.3, p_dep=0.15,
        pre_spikes=torch.from_numpy(np.array(pre_j)) if given_pre else None)
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    assert int(got_n) == int(want_n)
    np.testing.assert_array_equal(net_bits[-1].numpy(), bits[-1])  # untouched


@pytest.mark.parametrize("scheme", ["matrix", "column"])
@pytest.mark.parametrize("topo", [(70, 32, 32, 10), (70, 40, 10)])
def test_online_learning_epoch_scan(scheme, topo):
    bits, vth = _net(topo, 12)
    x, y = _data(13, 16, topo[0], topo[-1])
    want_b, want_n = jl.online_learning_epoch_scan(
        _j(bits), _j(vth), jnp.asarray(x), jnp.asarray(y),
        jax.random.PRNGKey(2), p_pot=0.3, p_dep=0.15, rng_scheme=scheme)
    got_b, got_n = learning.online_learning_epoch_scan(
        _t(bits), _t(vth), torch.from_numpy(x), torch.from_numpy(y),
        prng.PRNGKey(2), p_pot=0.3, p_dep=0.15, rng_scheme=scheme)
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    assert int(got_n) == int(want_n)


def test_scan_column_scheme_equals_fused_epoch_in_the_port():
    bits, vth = _net((70, 32, 32, 10), 14)
    x, y = _data(15, 30, 70, 10)
    a, na = learning.online_learning_epoch(
        _t(bits), _t(vth), x, y, prng.PRNGKey(4), p_pot=0.25, p_dep=0.2)
    b, nb = learning.online_learning_epoch_scan(
        _t(bits), _t(vth), x, y, prng.PRNGKey(4), p_pot=0.25, p_dep=0.2,
        rng_scheme="column")
    assert torch.equal(a, b) and int(na) == int(nb)
    with pytest.raises(ValueError):
        learning.online_learning_epoch_scan(
            _t(bits), _t(vth), x, y, prng.PRNGKey(4), rng_scheme="row")


def test_network_numpy_round_trip():
    bits, vth = _net((70, 32, 10), 16)
    off = np.arange(10, dtype=np.float32)
    net = EsamNetwork.from_numpy(bits, vth, off, device="cpu")
    b2, v2, o2 = net.to_numpy()
    for a, b in zip(bits + vth + [off], b2 + v2 + [o2]):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    b2[0][0, 0] ^= 1                                  # copies, not views
    assert net.weight_bits[0][0, 0] == bits[0][0, 0]


# ----------------------------------------------------------------------- #
# on the card: the same epochs through the CUDA kernels
# ----------------------------------------------------------------------- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("topo", [(768, 256, 256, 256, 10), (70, 40, 10)])
def test_cuda_epochs_match_cpu(cuda, topo):
    from repro_torch.kernels.cim_matmul_packed import ops as packed_ops
    from repro_torch.kernels.stdp import ops as stdp_ops

    bits, vth = _net(topo, 17, tied=True)
    x, y = _data(18, 300, topo[0], topo[-1])
    out = {}
    for dev in ("cpu", cuda):
        stdp_ops.reset_launch_counts()
        packed_ops.reset_launch_counts()
        b, n = learning.online_learning_epoch(
            [t.to(dev) for t in _t(bits)], [t.to(dev) for t in _t(vth)],
            x, y, prng.PRNGKey(3), p_pot=0.2, p_dep=0.1)
        s, ns = learning.online_learning_epoch_scan(
            [t.to(dev) for t in _t(bits)], [t.to(dev) for t in _t(vth)],
            x[:20], y[:20], prng.PRNGKey(3), p_pot=0.2, p_dep=0.1)
        out[str(dev)] = (b.cpu(), int(n), s.cpu(), int(ns),
                         stdp_ops.launch_counts(),
                         packed_ops.launch_counts())
    cpu, gpu = out["cpu"], out[str(cuda)]
    assert torch.equal(cpu[0], gpu[0]) and cpu[1] == gpu[1]
    assert torch.equal(cpu[2], gpu[2]) and cpu[3] == gpu[3]
    assert gpu[4] == {"stdp_column_event": 600, "stdp_update": 40}
    hidden_packed = all(n % 32 == 0 for n in topo[1:-1])
    assert gpu[5] == {"fused_fire_packed":
                      len(topo) - 2 if hidden_packed else 0}
