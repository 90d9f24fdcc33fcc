"""repro_torch.kernels.stdp against repro.kernels.stdp.

On the CPU the port's plain versions of the column-event and full-matrix
STDP kernels are held bit for bit against the reference's Pallas kernels in
interpret mode and against its jnp oracles, on inputs made with numpy from a
seed (odd widths, the gate on and off, the wrong-winner event's p_pot = 0).
The plain epoch, fed the port's column-event draws, and the key-taking
wrapper on the CPU are held bit for bit against the reference's
``column_event_epoch`` under the same key (offset or none, +-inf in it,
tied logits, int32 and int64 labels, p of 0 and 1, ragged widths, an
out-of-range label, keys with words past 2^31); the epoch's masks plain
version against the reference's draws; the kernel's integer compare of a
draw against p at its edge.  The matrix-RNG epoch's key chain and slots
(what its card kernels write) are held against the reference's own
``jax.random.split`` chain and ``[n_in, n_out]`` uniform matrices.  The
wrappers' in-place writes, launch counts and checks are tested too.  The
CUDA kernels against the plain versions are in ``test_torch_stdp_cuda.py``,
which imports no JAX so that it runs on the card's machine."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as packing_np
from repro.core.esam import learning as jl
from repro.kernels.stdp import ops as jops
from repro_torch.core import prng
from repro_torch.core.esam import learning
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
        assert ops.launch_counts() == {"stdp_epoch_masks": 0,
                                       "stdp_column_epoch": 0,
                                       "stdp_column_event": 0,
                                       "stdp_update": 0,
                                       "stdp_update_keys": 0,
                                       "stdp_update_masks": 0,
                                       "stdp_update_chain": 0}
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


def _out_of_range_cols(n_out):
    return [n_out, -1, -n_out - 1]


@pytest.mark.parametrize("n_out,n_in", [(10, 256), (7, 99)])
@pytest.mark.parametrize("where", ["n_out", "minus_1", "minus_n_out_minus_1"])
@pytest.mark.parametrize("apply", [True, False])
def test_column_event_out_of_range_row_matches_reference(n_out, n_in, where,
                                                         apply):
    """A row index outside [0, n_out): the plain version and the CPU wrapper
    write the row the reference's interpret-mode kernel writes (a negative
    index wrapped once, then clamped), or nothing when the gate is off."""
    col = dict(zip(("n_out", "minus_1", "minus_n_out_minus_1"),
                   _out_of_range_cols(n_out)))[where]
    bits_t, pre, u_pot, u_dep = _operands(n_out + n_in, n_out, n_in, (n_in,))
    want = np.asarray(jops.stdp_column_event(
        jnp.asarray(bits_t), jnp.asarray(col, jnp.int32), jnp.asarray(apply),
        jnp.asarray(pre), jnp.asarray(u_pot), jnp.asarray(u_dep),
        p_pot=0.5, p_dep=0.5, interpret=True))
    args = (torch.tensor(apply), torch.from_numpy(pre),
            torch.from_numpy(u_pot), torch.from_numpy(u_dep))
    for col_t in (torch.tensor(col), torch.tensor(col, dtype=torch.int32)):
        got = ops.stdp_column_event_ref(torch.from_numpy(bits_t), col_t,
                                        *args, 0.5, 0.5)
        np.testing.assert_array_equal(got.numpy(), want)
        t = torch.from_numpy(bits_t.copy())
        ops.reset_launch_counts()
        assert ops.stdp_column_event(t, col_t, *args, p_pot=0.5,
                                     p_dep=0.5) is t
        assert ops.launch_counts()["stdp_column_event"] == 0
        np.testing.assert_array_equal(t.numpy(), want)
    # the row written is the wrapped, clamped index (apply) or none
    changed = np.flatnonzero((want != bits_t).any(-1))
    row = min(max(col + n_out if col < 0 else col, 0), n_out - 1)
    assert set(changed) <= ({row} if apply else set())


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


def _epoch_operands(seed, n_out, n_in, n, *, tied=False, offset=False,
                    bad_label=None):
    """numpy readout, traces, labels and offset for one epoch; ``tied``
    makes every readout row the same (every V_mem ties), ``bad_label``
    puts that label (outside [0, n_out)) at sample 3."""
    rng = np.random.default_rng(seed)
    bits_t = rng.integers(0, 2, size=(n_out, n_in), dtype=np.int8)
    if tied:
        bits_t[:] = bits_t[:1]
    pre = rng.random((n, n_in)) < 0.45
    labels = rng.integers(0, n_out, size=(n,)).astype(np.int32)
    if bad_label is not None:
        labels[3] = bad_label
    off = rng.normal(size=n_out).astype(np.float32) if offset else None
    return bits_t, pre, labels, off


#: (n_out, n_in, offset, tied, labels dtype, p_pot, p_dep, bad label)
EPOCH_CASES = [
    (10, 100, False, False, np.int32, 0.3, 0.15, None),
    (10, 100, True, False, np.int64, 0.3, 0.15, None),
    (10, 257, False, True, np.int64, 0.3, 0.15, None),
    (10, 257, True, True, np.int32, 0.25, 0.2, None),
    (33, 257, False, False, np.int32, 1.0, 1.0, None),
    (33, 100, True, False, np.int64, 0.0, 0.0, None),
    (33, 257, True, True, np.int32, 0.0, 1.0, None),
    (10, 100, False, False, np.int64, 1.0, 0.0, 10),
    (33, 257, True, False, np.int32, 0.3, 0.15, -2),
]


@pytest.mark.parametrize(
    "n_out,n_in,offset,tied,labels_dtype,p_pot,p_dep,bad_label", EPOCH_CASES)
def test_column_epoch_matches_reference(n_out, n_in, offset, tied,
                                        labels_dtype, p_pot, p_dep,
                                        bad_label):
    n = 48
    bits_t, pre, labels, off = _epoch_operands(
        n_out + n_in, n_out, n_in, n, tied=tied, offset=offset,
        bad_label=bad_label)
    want_b, want_n = jl.column_event_epoch(
        jnp.asarray(bits_t), jnp.asarray(pre), jnp.asarray(labels),
        jax.random.PRNGKey(n_in), p_pot=p_pot, p_dep=p_dep,
        out_offset=None if off is None else jnp.asarray(off))
    want_b = np.asarray(want_b)
    u = learning.column_event_uniforms(prng.PRNGKey(n_in), torch.arange(n),
                                       n_in)
    y = torch.from_numpy(labels.astype(labels_dtype))
    off_t = None if off is None else torch.from_numpy(off)
    got_b, wrong = ops.stdp_column_epoch_ref(
        torch.from_numpy(bits_t), torch.from_numpy(pre), y, *u, off_t,
        p_pot, p_dep)
    np.testing.assert_array_equal(got_b.numpy(), want_b)
    assert wrong.dtype == torch.int32 and 2 * int(wrong) == int(want_n)
    # the wrapper on CPU tensors, given the key: the same draws and the plain
    # version, in place, no launch
    t = torch.from_numpy(bits_t.copy())
    ops.reset_launch_counts()
    wrong_w = ops.stdp_column_epoch(t, torch.from_numpy(pre), y,
                                    prng.PRNGKey(n_in), off_t,
                                    p_pot=p_pot, p_dep=p_dep)
    assert ops.launch_counts() == dict.fromkeys(ops.launch_counts(), 0)
    np.testing.assert_array_equal(t.numpy(), want_b)
    assert int(wrong_w) == int(wrong)
    if bad_label is not None:     # always wrong, and the teacher row clamps
        assert int(wrong) > 0


#: keys made with numpy: PRNGKey-style, both words at or past 2^31, one each
KEYS = [(0, 17), (0xDEADBEEF, 0x9E3779B9), (0x80000000, 5)]


@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("p_pot,p_dep", [(0.0, 0.0), (1.0, 1.0), (0.0, 1.0),
                                         (1.0, 0.0), (0.3, 0.15)])
@pytest.mark.parametrize("offset", ["none", "inf", "nan"])
def test_column_epoch_key_matches_reference(key, p_pot, p_dep, offset):
    """The key-taking wrapper on the CPU against the reference's epoch under
    the same key: keys whose words are past 2^31, p of 0 and 1, an offset
    with +inf and -inf (those rows always, never win), and with a NaN too
    (that row always wins)."""
    n_out, n_in, n = 10, 100, 40
    bits_t, pre, labels, off = _epoch_operands(
        7, n_out, n_in, n, offset=offset != "none", bad_label=-1)
    if offset != "none":
        off[2], off[5] = np.inf, -np.inf
    if offset == "nan":
        off[8] = np.nan
    words = np.array(key, dtype=np.uint32)
    want_b, want_n = jl.column_event_epoch(
        jnp.asarray(bits_t), jnp.asarray(pre), jnp.asarray(labels),
        jnp.asarray(words), p_pot=p_pot, p_dep=p_dep,
        out_offset=None if off is None else jnp.asarray(off))
    t = torch.from_numpy(bits_t.copy())
    wrong = ops.stdp_column_epoch(
        t, torch.from_numpy(pre), torch.from_numpy(labels),
        torch.from_numpy(words.astype(np.int64)),
        None if off is None else torch.from_numpy(off),
        p_pot=p_pot, p_dep=p_dep)
    np.testing.assert_array_equal(t.numpy(), np.asarray(want_b))
    assert 2 * int(wrong) == int(want_n) > 0


@pytest.mark.parametrize("p", [0.0, -0.0, 1.0, 0.1, 0.5, 2.0 ** -23, 2.0 ** -30,
                               float(np.nextafter(np.float32(1), 0)), 1.5,
                               -0.25, float("inf"), float("-inf"),
                               float("nan"), 0.3])
def test_uniform_threshold_is_the_float_compare(p):
    """(bits >> 9) < uniform_threshold(p) is u < p for every draw: at the
    threshold's edge, at both ends and at random 23-bit values, against the
    float32 compare of ``prng.uniform``."""
    t = ops.uniform_threshold(p)
    assert 0 <= t <= 1 << 23
    f = np.concatenate([np.arange(max(t - 3, 0), min(t + 3, 1 << 23)),
                        [0, 1, (1 << 23) - 1],
                        np.random.default_rng(0).integers(0, 1 << 23, 1000)])
    u = (f.astype(np.uint32) | np.uint32(0x3F800000)).view(np.float32) - 1
    np.testing.assert_array_equal(f < t, u < np.float32(p))


@pytest.mark.parametrize("n_out,n_in,n", [(10, 256, 33), (33, 257, 9),
                                          (4, 33, 5), (3, 1, 4)])
def test_epoch_masks_plain_matches_reference_draws(n_out, n_in, n):
    """``stdp_epoch_masks_ref`` (what the card's masks kernel writes) against
    the reference's own ``column_event_uniforms`` and rule, packed with
    numpy: header, trace, the teacher's and the winner's masks, zero past
    the trace.  The CPU wrapper returns it without a launch."""
    rng = np.random.default_rng(n_in)
    pre = rng.random((n, n_in)) < 0.45
    labels = rng.integers(0, n_out, size=(n,))
    labels[0], labels[-1] = -1, n_out
    key = jax.random.PRNGKey(n)
    got = ops.stdp_epoch_masks_ref(torch.from_numpy(pre),
                                   torch.from_numpy(labels), prng.PRNGKey(n),
                                   n_out, 0.3, 0.2)
    ops.reset_launch_counts()
    assert torch.equal(ops.stdp_epoch_masks(
        torch.from_numpy(pre), torch.from_numpy(labels.astype(np.int32)),
        prng.PRNGKey(n), n_out, p_pot=0.3, p_dep=0.2), got)
    assert ops.launch_counts()["stdp_epoch_masks"] == 0
    assert got.dtype == torch.int32
    assert got.shape == (n, ops.epoch_slot_words(n_in))
    field = (got.shape[1] - 4) // 4
    for i in range(n):
        u_pot, u_dep_t, u_dep_w = (np.asarray(u) for u in
                                   jl.column_event_uniforms(key, jnp.int32(i),
                                                            n_in))
        p = pre[i]
        masks = (p, p & (u_pot < np.float32(0.3)),
                 ~p & (u_dep_t < np.float32(0.2)),
                 p & (u_dep_w < np.float32(0.2)))
        want = []
        for m in masks:
            w = packing_np.pack_spikes_np(m[None])[0].view(np.int32)
            want.append(np.pad(w, (0, field - w.size)))
        y = int(labels[i])
        teach = min(max(y + n_out if y < 0 else y, 0), n_out - 1)
        header = [int(p.sum()), teach, y if 0 <= y < n_out else -1, 0]
        np.testing.assert_array_equal(got[i].numpy(),
                                      np.concatenate([header, *want]))


@pytest.mark.parametrize("n_out,n_in,route", [
    (10, 256, (8, 1)), (10, 257, (16, 1)), (32, 1024, (32, 1)),
    (33, 257, (16, 2)), (64, 256, (8, 2)), (1, 1, (8, 1)),
    (64, 768, (0, 0)), (65, 100, (0, 0)), (10, 1025, (0, 0)),
    (256, 768, (0, 0))])
def test_epoch_route(n_out, n_in, route):
    """The chain keeps the readout in its warp's registers, lane o rows o and
    o + 32, up to 32 words of one row or 16 words of two; in shared memory
    past that."""
    assert ops._epoch_route(n_out, n_in) == route


def test_column_epoch_wrapper_checks_shapes_and_devices():
    bits_t, pre, labels, off = (
        torch.from_numpy(a) for a in _epoch_operands(2, 4, 32, 6,
                                                     offset=True))
    key = prng.PRNGKey(1)
    kw = dict(p_pot=0.1, p_dep=0.1)
    bad = [
        ((bits_t[0], pre, labels, key), ValueError),         # 1-d readout
        ((bits_t, pre[:, :31], labels, key), ValueError),    # n_in
        ((bits_t, pre, labels[:5], key), ValueError),        # n labels
        ((bits_t, pre, labels.float(), key), TypeError),     # label dtype
        ((bits_t, pre, labels, key[None]), ValueError),      # key shape
        ((bits_t, pre, labels, key.int()), ValueError),      # key dtype
        ((bits_t, pre, labels, key, off[:3]), ValueError),   # offset
        ((bits_t, pre, labels, key, off.double()), TypeError),
    ]
    for args, err in bad:
        with pytest.raises(err):
            ops.stdp_column_epoch(*args, **kw)
    with pytest.raises(ValueError):
        ops.stdp_epoch_masks(pre, labels, key, 0, **kw)
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="different devices"):
        ops.stdp_column_epoch(bits_t.to(meta), pre, labels, key, **kw)
    with pytest.raises(ValueError, match="different devices"):
        ops.stdp_column_epoch(bits_t, pre, labels, key, off.to(meta), **kw)
    with pytest.raises(ValueError, match="different devices"):
        ops.stdp_epoch_masks(pre, labels, key.to(meta), 4, **kw)


# ----------------------------------------------------------------------- #
# the matrix-RNG epoch: its key chain and slots against the reference's
# split chain and uniform matrices
# ----------------------------------------------------------------------- #
@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("n", [0, 1, 9])
def test_update_keys_plain_matches_reference_chain(key, n):
    """``stdp_update_keys_ref`` row i is k_i of the reference's scan
    (``k, k1, k2 = jax.random.split(k, 3)`` a sample), as uint32 words; the
    CPU wrapper returns it without a launch."""
    k = jnp.asarray(np.array(key, dtype=np.uint32))
    want = []
    for _ in range(n):
        want.append(np.asarray(k))
        k = jax.random.split(k, 3)[0]
    t = torch.tensor(np.array(key, dtype=np.int64))
    ops.reset_launch_counts()
    got = ops.stdp_update_keys(t, n)
    assert ops.launch_counts()["stdp_update_keys"] == 0
    assert got.dtype == torch.int32 and got.shape == (n, 2)
    assert torch.equal(got, ops.stdp_update_keys_ref(t, n))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.array(want, np.uint32).reshape(n, 2))


@pytest.mark.parametrize("n_out,n_in,n", [(10, 256, 7), (33, 70, 4),
                                          (65, 33, 3), (3, 1, 4)])
@pytest.mark.parametrize("p_pot,p_dep", [(0.3, 0.2), (0.0, 1.0), (1.0, 0.0)])
def test_update_masks_plain_matches_reference_draws(n_out, n_in, n, p_pot,
                                                    p_dep):
    """``stdp_update_masks_ref`` (what the card's masks kernel writes)
    against the reference's draws, packed with numpy: sample i's ``k1, k2``
    from ``split(k_i, 3)``, the teacher's ``[n_in, n_out]`` uniforms under
    ``split(k1)`` and the winner's depress uniforms under ``split(k2)[1]``;
    header, trace, the teacher row's potentiate mask, a depress mask a row
    (the teacher's at the label's row), zero past the trace; labels -1 and
    n_out have no teacher row.  The CPU wrapper returns it without a
    launch."""
    rng = np.random.default_rng(n_in + n_out)
    pre = rng.random((n, n_in)) < 0.45
    labels = rng.integers(0, n_out, size=(n,))
    labels[0], labels[-1] = -1, n_out
    keys = ops.stdp_update_keys_ref(prng.PRNGKey(n_out), n)
    ops.reset_launch_counts()
    got = ops.stdp_update_masks(torch.from_numpy(pre),
                                torch.from_numpy(labels), keys, n_out,
                                p_pot=p_pot, p_dep=p_dep)
    assert ops.launch_counts()["stdp_update_masks"] == 0
    assert got.dtype == torch.int32
    assert got.shape == (n, ops.update_slot_words(n_in, n_out))
    field = (got.shape[1] - 4) // (2 + n_out)

    def packed(m):
        w = packing_np.pack_spikes_np(m[None])[0].view(np.int32)
        return np.pad(w, (0, field - w.size))

    for i in range(n):
        k_i = jnp.asarray(keys[i].numpy().view(np.uint32))
        _, k1, k2 = jax.random.split(k_i, 3)
        kp, kd = jax.random.split(k1)
        u_pot = np.asarray(jax.random.uniform(kp, (n_in, n_out)))
        u_dep = np.asarray(jax.random.uniform(kd, (n_in, n_out)))
        u_win = np.asarray(jax.random.uniform(jax.random.split(k2)[1],
                                              (n_in, n_out)))
        p, y = pre[i], int(labels[i])
        teach = 0 <= y < n_out
        pot = p & (u_pot[:, y] < np.float32(p_pot)) if teach else 0 * p
        dep = [~p & (u_dep[:, o] < np.float32(p_dep)) if o == y
               else p & (u_win[:, o] < np.float32(p_dep))
               for o in range(n_out)]
        label = y if teach else -1
        want = np.concatenate([[int(p.sum()), label, label, 0], packed(p),
                               packed(pot != 0), *map(packed, dep)])
        np.testing.assert_array_equal(got[i].numpy(), want)


def test_update_epoch_wrapper_checks_shapes_and_devices():
    bits_t, pre, labels = (
        torch.from_numpy(a) for a in _epoch_operands(3, 4, 32, 6)[:3])
    key = prng.PRNGKey(1)
    kw = dict(p_pot=0.1, p_dep=0.1)
    bad = [
        ((bits_t[0], pre, labels, key), ValueError),         # 1-d readout
        ((bits_t, pre[:, :31], labels, key), ValueError),    # n_in
        ((bits_t, pre, labels[:5], key), ValueError),        # n labels
        ((bits_t, pre, labels.float(), key), TypeError),     # label dtype
        ((bits_t, pre, labels, key[None]), ValueError),      # key shape
        ((bits_t, pre, labels, key.int()), ValueError),      # key dtype
    ]
    for args, err in bad:
        with pytest.raises(err):
            ops.stdp_update_epoch(*args, **kw)
    keys = ops.stdp_update_keys(key, 6)
    with pytest.raises(ValueError):
        ops.stdp_update_masks(pre, labels, keys, 0, **kw)
    with pytest.raises(ValueError):
        ops.stdp_update_masks(pre, labels, keys[:5], 4, **kw)
    with pytest.raises(ValueError):
        ops.stdp_update_keys(key, -1)
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="different devices"):
        ops.stdp_update_epoch(bits_t.to(meta), pre, labels, key, **kw)
    with pytest.raises(ValueError, match="different devices"):
        ops.stdp_update_masks(pre, labels, keys.to(meta), 4, **kw)
    # the CPU op runs the plain loop in place, with no launch
    ops.reset_launch_counts()
    work = bits_t.clone()
    count = ops.stdp_update_epoch(work, pre, labels, key, **kw)
    want, want_count = ops.stdp_update_epoch_ref(bits_t, pre, labels, key,
                                                 0.1, 0.1)
    assert torch.equal(work, want) and int(count) == int(want_count)
    assert count.dtype == torch.int32 and count.dim() == 0
    assert not any(ops.launch_counts().values())


@pytest.mark.parametrize("n_out,n_in", [
    (10, 256), (256, 768), (7, 99), (8, 100), (128, 256), (1, 1), (1, 40000),
    (33, 511), (64, 257)])
@pytest.mark.parametrize("vec", [True, False])
def test_event_route_covers_the_event(n_out, n_in, vec):
    """Along the event row the grid covers its groups of 4 inputs with less
    than a block past them, whatever the number of rows."""
    r = ops._event_route(n_out, n_in, vec)
    assert r.vec == vec
    groups = -(-n_in // ops._EVENT_INPUTS)
    assert (r.grid * ops._EVENT_THREADS >= groups
            > (r.grid - 1) * ops._EVENT_THREADS)


def test_event_route_is_pure_and_matches_the_kernel(monkeypatch):
    """The route needs no library and no card, refuses an empty matrix, and
    its constants are the kernel's."""
    import re
    from pathlib import Path

    from repro_torch.kernels import _build

    def no_library(*args, **kwargs):
        raise AssertionError("the route must not load the kernel library")

    monkeypatch.setattr(_build, "load_library", no_library)
    assert ops._event_route(10, 256, True) == ops._event_route(10, 256, True)
    for bad in ((0, 256), (10, 0)):
        with pytest.raises(ValueError):
            ops._event_route(*bad, True)
    src = (Path(ops.__file__).parent / "csrc" / "stdp.cu").read_text()
    consts = {name: int(re.search(rf"{name} = (\d+);", src)[1])
              for name in ("kEventThreads", "kEventInputs")}
    assert consts == {"kEventThreads": ops._EVENT_THREADS,
                      "kEventInputs": ops._EVENT_INPUTS}
