"""repro_torch.core.esam.learning against repro.core.esam.learning.

The same numpy-made networks, spikes and labels, and the same PRNGKey, go
through both packages; the port draws its own uniforms (core/prng.py) and
must give the same bits.  Tolerance 0 everywhere: weight bits, spikes,
V_mem and update counts are equal, at ragged widths, p of 0 and 1 and with
a label outside [0, n_out) too.  The epoch on the CUDA kernels against the
same epoch on the CPU is in ``test_torch_learning_cuda.py``, which imports
no JAX so that it runs on the card's machine."""

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


@pytest.mark.parametrize("n_out,n_in,p_pot,p_dep,bad_label", [
    (10, 100, 1.0, 1.0, None),
    (33, 257, 0.0, 0.0, None),
    (33, 100, 1.0, 0.0, None),
    (10, 257, 0.25, 0.2, 10),
    (33, 257, 0.25, 0.2, -1),
])
def test_column_event_epoch_widths_probabilities_and_labels(
        n_out, n_in, p_pot, p_dep, bad_label):
    """Ragged widths, n_out 33, p of 0 and 1, a label outside [0, n_out)
    (always wrong; its teacher row is wrapped once and clamped)."""
    rng = np.random.default_rng(n_in + n_out)
    bits_t = rng.integers(0, 2, size=(n_out, n_in), dtype=np.int8)
    pre, y = _data(n_in, 40, n_in, n_out, density=0.45)
    if bad_label is not None:
        y[5] = bad_label
    off = rng.normal(size=n_out).astype(np.float32)
    want_b, want_n = jl.column_event_epoch(
        jnp.asarray(bits_t), jnp.asarray(pre), jnp.asarray(y),
        jax.random.PRNGKey(5), p_pot=p_pot, p_dep=p_dep,
        out_offset=jnp.asarray(off))
    t = torch.from_numpy(bits_t.copy())
    got_b, got_n = learning.column_event_epoch(
        t, torch.from_numpy(pre), torch.from_numpy(y.astype(np.int64)),
        prng.PRNGKey(5), p_pot=p_pot, p_dep=p_dep,
        out_offset=torch.from_numpy(off))
    assert got_b is t
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    assert int(got_n) == int(want_n)


@pytest.mark.parametrize("key", [(0xDEADBEEF, 0x9E3779B9), (0x80000000, 0)])
@pytest.mark.parametrize("p_pot,p_dep", [(0.0, 1.0), (1.0, 0.0), (0.25, 0.2)])
def test_column_event_epoch_keys_and_infinite_offset(key, p_pot, p_dep):
    """Keys made with numpy whose words are past 2^31, p of 0 and 1, and an
    offset holding +inf and -inf, through ``learning.column_event_epoch``."""
    rng = np.random.default_rng(21)
    bits_t = rng.integers(0, 2, size=(10, 70), dtype=np.int8)
    pre, y = _data(22, 40, 70, 10, density=0.45)
    off = rng.normal(size=10).astype(np.float32)
    off[1], off[7] = np.inf, -np.inf
    words = np.array(key, dtype=np.uint32)
    want_b, want_n = jl.column_event_epoch(
        jnp.asarray(bits_t), jnp.asarray(pre), jnp.asarray(y),
        jnp.asarray(words), p_pot=p_pot, p_dep=p_dep,
        out_offset=jnp.asarray(off))
    t = torch.from_numpy(bits_t.copy())
    got_b, got_n = learning.column_event_epoch(
        t, torch.from_numpy(pre), torch.from_numpy(y),
        torch.from_numpy(words.astype(np.int64)), p_pot=p_pot, p_dep=p_dep,
        out_offset=torch.from_numpy(off))
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


#: (readout n_in, n_out, samples, p_pot, p_dep, labels outside [0, n_out),
#: tied readout): the matrix-RNG scan's edges
SCAN_CASES = [
    (70, 10, 16, 0.3, 0.15, (-1, 10, 20), False),
    (70, 10, 16, 0.3, 0.15, (), True),
    (70, 33, 12, 0.3, 0.15, (-1, 33, 66), False),
    (70, 65, 10, 0.3, 0.15, (-1, 65, 130), True),
    (40, 10, 12, 0.3, 0.0, (-1,), False),
    (40, 10, 12, 0.0, 0.2, (10,), False),
    (40, 10, 12, 1.0, 1.0, (20,), False),
    (70, 10, 0, 0.3, 0.15, (), False),
    (70, 10, 1, 0.3, 0.15, (), False),
]


@pytest.mark.parametrize("n_in,n_out,n,p_pot,p_dep,bad,tied", SCAN_CASES)
def test_online_learning_epoch_scan_matrix_cases(n_in, n_out, n, p_pot, p_dep,
                                                 bad, tied):
    """The matrix-RNG scan (``stdp_update_epoch`` on the CPU) against the
    reference's, bits and count: labels -1, n_out and 2 n_out (no teacher
    row, always wrong, the winner still depressed), a tied readout (every
    V_mem ties: the lowest row wins), n_in not a multiple of 32, n_out
    past 32 and 64, p of 0 and 1, 0 and 1 samples."""
    bits, vth = _net((n_in, n_out), n_in + n_out, tied=tied)
    x, y = _data(n + 5, n, n_in, n_out)
    for i, label in enumerate(bad):
        y[1 + 3 * i] = label
    want_b, want_n = jl.online_learning_epoch_scan(
        _j(bits), _j(vth), jnp.asarray(x), jnp.asarray(y),
        jax.random.PRNGKey(n_out), p_pot=p_pot, p_dep=p_dep,
        rng_scheme="matrix")
    got_b, got_n = learning.online_learning_epoch_scan(
        _t(bits), _t(vth), torch.from_numpy(x), torch.from_numpy(y),
        prng.PRNGKey(n_out), p_pot=p_pot, p_dep=p_dep, rng_scheme="matrix")
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    assert int(got_n) == int(want_n)
    if n > 1 and bad:
        assert int(got_n) > 0


@pytest.mark.parametrize("n_out,n", [(10, 6), (33, 4)])
def test_update_epoch_ref_equals_unrolled_keyed_updates(n_out, n):
    """``stdp_update_epoch_ref`` is the scan written out: per sample the
    readout's first argmax, ``k, k1, k2 = split(k, 3)``, then the keyed
    ``learning.stdp_update`` for the teacher and for the wrong winner."""
    bits, _ = _net((70, n_out), n)
    x, y = _data(n, n, 70, n_out)
    y[2] = -1
    pre, labels = torch.from_numpy(x), torch.from_numpy(y)
    w = torch.from_numpy(bits[-1])
    rows = torch.arange(n_out)
    k, n_wrong = prng.PRNGKey(21), 0
    for i in range(n):
        pred = learning.readout_vmem(w.T, pre[i]).argmax()
        wrong = pred != labels[i]
        n_wrong += int(wrong)
        k, k1, k2 = prng.split(k, 3)
        w = learning.stdp_update(w, pre[i], (rows == labels[i]) & wrong, k1,
                                 0.3, 0.2)
        w = learning.stdp_update(w, ~pre[i], (rows == pred) & wrong, k2, 0.0,
                                 0.2)
    got, count = learning.stdp_ops.stdp_update_epoch_ref(
        torch.from_numpy(bits[-1]).T.contiguous(), pre, labels,
        prng.PRNGKey(21), 0.3, 0.2)
    assert torch.equal(got.T, w)
    assert int(count) == 2 * n_wrong and n_wrong > 0


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
