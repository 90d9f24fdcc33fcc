"""repro_torch.kernels.stdp's CUDA kernels against their plain versions.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports no JAX, so it runs on the card's machine, where the
JAX package is not installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_stdp_cuda.py

The single column event and the full-matrix rule are held bit for bit
against their plain versions, the event on each of its routes (4-input
loads or byte and float loads): row strided matrices, unaligned trace and
uniform views, and with the gate off no byte of the matrix changes; the
epoch's two kernels against theirs: the
masks kernel slot for slot against ``stdp_epoch_masks_ref`` (keys past
2^31, p of 0 and 1, p set exactly to a drawn uniform, so an off-by-one in
the kernel's integer compare shows), the whole epoch against
``stdp_column_epoch_ref`` on the same draws, on both of the chain's routes
(the readout as tensor-core fragments in registers; in shared memory).
The matrix-RNG epoch's three kernels (``stdp_update_keys``,
``stdp_update_masks``, the chain) each against its plain version, and the
whole ``stdp_update_epoch`` against ``stdp_update_epoch_ref`` (labels
outside [0, n_out), ties, ragged and wide readouts, p of 0 and 1, 0, 1 and
4096 samples), with its launch counts and its capacity error.  The plain
versions are held against the reference in ``test_torch_stdp.py`` and
``test_torch_learning.py``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import prng
from repro_torch.kernels.stdp import ops

PROBS = [(1.0, 1.0), (0.25, 0.1), (0.0, 0.3), (0.2, 0.0)]
KEYS = [(0, 17), (0xDEADBEEF, 0x9E3779B9), (0x80000000, 5)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _operands(seed, n_out, n_in, u_shape):
    rng = np.random.default_rng(seed)
    bits_t = rng.integers(0, 2, size=(n_out, n_in), dtype=np.int8)
    pre = rng.random(n_in) < 0.4
    u_pot = rng.random(u_shape, dtype=np.float32)
    u_dep = rng.random(u_shape, dtype=np.float32)
    return bits_t, pre, u_pot, u_dep


def _out_of_range_cols(n_out):
    return [n_out, -1, -n_out - 1]


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


def _key(words, device):
    return torch.tensor(np.array(words, dtype=np.int64), device=device)


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
@pytest.mark.parametrize("n_out,n_in", [(10, 256), (7, 99)])
@pytest.mark.parametrize("where", ["n_out", "minus_1", "minus_n_out_minus_1"])
@pytest.mark.parametrize("apply", [True, False])
def test_cuda_column_event_out_of_range_row_matches_plain(cuda, n_out, n_in,
                                                          where, apply):
    col = dict(zip(("n_out", "minus_1", "minus_n_out_minus_1"),
                   _out_of_range_cols(n_out)))[where]
    bits_t, pre, u_pot, u_dep = (torch.from_numpy(a).to(cuda) for a in
                                 _operands(n_out + n_in, n_out, n_in, (n_in,)))
    gate = torch.tensor(apply, device=cuda)
    for dtype in (torch.int64, torch.int32):
        c = torch.tensor(col, dtype=dtype, device=cuda)
        ops.reset_launch_counts()
        got = ops.stdp_column_event(bits_t.clone(), c, gate, pre, u_pot,
                                    u_dep, p_pot=0.5, p_dep=0.5)
        assert ops.launch_counts()["stdp_column_event"] == 1
        want = ops.stdp_column_event_ref(bits_t, c, gate, pre, u_pot, u_dep,
                                         0.5, 0.5)
        assert torch.equal(got, want)


def _event(bits_t, col, gate, pre, u_pot, u_dep, route, p_pot=0.5,
           p_dep=0.5):
    """One event on ``bits_t`` (in place) on the expected route, one launch,
    against the plain version on a copy; returns the plain version's
    bits."""
    want = ops.stdp_column_event_ref(bits_t.clone(), col, gate, pre, u_pot,
                                     u_dep, p_pot, p_dep)
    n_out, n_in = bits_t.shape
    assert ops._event_route(n_out, n_in, ops._event_vec(
        bits_t, ops._byte_mask(pre), u_pot, u_dep)) == route
    ops.reset_launch_counts()
    ops.stdp_column_event(bits_t, col, gate, pre, u_pot, u_dep, p_pot=p_pot,
                          p_dep=p_dep)
    assert ops.launch_counts()["stdp_column_event"] == 1
    assert torch.equal(bits_t, want)
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("n_out,n_in,vec", [
    (64, 256, True), (65, 256, True), (32, 511, False), (33, 511, False)])
@pytest.mark.parametrize("apply", [True, False])
def test_cuda_column_event_gate_and_rows_on_each_load_route(
        cuda, n_out, n_in, vec, apply):
    """Rows inside and outside [0, n_out) on 4-input and on byte loads;
    with the gate off no byte of the matrix changes."""
    bits_t, pre, u_pot, u_dep = (torch.from_numpy(a).to(cuda) for a in
                                 _operands(n_out * n_in, n_out, n_in, (n_in,)))
    gate = torch.tensor(apply, device=cuda)
    route = ops._event_route(n_out, n_in, vec)
    assert route.vec == vec
    for c in (0, n_out // 2, n_out - 1, n_out, -1):
        before = bits_t.clone()
        _event(bits_t, torch.tensor(c, device=cuda), gate, pre, u_pot,
               u_dep, route)
        if not apply:
            assert torch.equal(bits_t, before)


@pytest.mark.cuda
@pytest.mark.parametrize("n_out,n_in,pad,vec", [
    (10, 256, 4, True), (10, 256, 3, False), (7, 99, 5, False),
    (200, 256, 4, True), (200, 256, 1, False)])
@pytest.mark.parametrize("apply", [True, False])
def test_cuda_column_event_on_row_strided_bits(cuda, n_out, n_in, pad, vec,
                                               apply):
    """A row stride ld > n_in: the event row changes, nothing else of the
    storage (the bytes past n_in hold 7s)."""
    bits_t, pre, u_pot, u_dep = (torch.from_numpy(a).to(cuda) for a in
                                 _operands(n_in + pad, n_out, n_in, (n_in,)))
    big = torch.full((n_out, n_in + pad), 7, dtype=torch.int8, device=cuda)
    big[:, :n_in] = bits_t
    view = big[:, :n_in]
    gate = torch.tensor(apply, device=cuda)
    before = big.clone()
    route = ops._event_route(n_out, n_in, vec)
    want = _event(view, torch.tensor(n_out // 3, device=cuda), gate, pre,
                  u_pot, u_dep, route)
    assert torch.equal(big[:, n_in:], before[:, n_in:])
    assert torch.equal(big[:, :n_in], want)
    if not apply:
        assert torch.equal(big, before)


@pytest.mark.cuda
@pytest.mark.parametrize("n_out,n_in", [(10, 256), (256, 768), (7, 99)])
@pytest.mark.parametrize("which", ["pre", "u_pot", "u_dep", "all"])
def test_cuda_column_event_on_unaligned_operands(cuda, n_out, n_in, which):
    """Trace and uniform views one element past an aligned start take the
    byte and float loads."""
    bits_t, pre, u_pot, u_dep = (torch.from_numpy(a).to(cuda) for a in
                                 _operands(n_in + 1, n_out, n_in, (n_in,)))

    def shifted(t):
        return torch.cat([t[:1], t])[1:]

    ops_in = {"pre": pre.to(torch.uint8), "u_pot": u_pot, "u_dep": u_dep}
    for name in ops_in:
        if which in (name, "all"):
            ops_in[name] = shifted(ops_in[name])
    gate = torch.tensor(True, device=cuda)
    route = ops._event_route(n_out, n_in, False)
    for c in (0, n_out - 1):
        _event(bits_t, torch.tensor(c, dtype=torch.int32, device=cuda), gate,
               ops_in["pre"], ops_in["u_pot"], ops_in["u_dep"], route,
               p_pot=0.25, p_dep=0.1)


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


@pytest.mark.cuda
@pytest.mark.parametrize("n_out,n_in,n", [(10, 256, 4096), (33, 257, 300),
                                          (64, 768, 200), (256, 768, 300)])
@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("offset", ["none", "normal", "special"])
def test_cuda_column_epoch_matches_plain(cuda, n_out, n_in, n, tied, offset):
    """The two kernels of an epoch (one launch each) against the per-sample
    plain loop on the same draws; (10, 256) and (33, 257) keep the readout
    in the chain warp's registers, (64, 768) and (256, 768) in shared
    memory.  ``special``: offsets of +inf, -inf and NaN (NaN always wins)."""
    bits_t, pre, labels, off = _epoch_operands(
        n_in + n, n_out, n_in, n, tied=tied, offset=offset != "none",
        bad_label=-1)
    if offset == "special":
        off[1], off[4], off[7] = np.inf, -np.inf, np.nan
    bits_t, pre, labels = (torch.from_numpy(a).to(cuda)
                           for a in (bits_t, pre, labels))
    off = None if off is None else torch.from_numpy(off).to(cuda)
    key = prng.PRNGKey(n, device=cuda)
    ops.reset_launch_counts()
    got = bits_t.clone()
    wrong = ops.stdp_column_epoch(got, pre, labels, key, off,
                                  p_pot=0.2, p_dep=0.1)
    assert ops.launch_counts() == {"stdp_epoch_masks": 1,
                                   "stdp_column_epoch": 1,
                                   "stdp_column_event": 0, "stdp_update": 0,
                                   "stdp_update_keys": 0,
                                   "stdp_update_masks": 0,
                                   "stdp_update_chain": 0}
    u = ops.column_event_uniforms(key, torch.arange(n, device=cuda), n_in)
    want, want_wrong = ops.stdp_column_epoch_ref(bits_t, pre, labels, *u,
                                                 off, 0.2, 0.1)
    assert torch.equal(got, want) and int(wrong) == int(want_wrong) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("p_pot,p_dep", [(0.0, 0.0), (1.0, 1.0), (0.2, 0.1)])
@pytest.mark.parametrize("n_out,n_in,n", [(10, 256, 4096), (33, 257, 300),
                                          (3, 1, 5)])
def test_cuda_epoch_masks_matches_plain(cuda, key, p_pot, p_dep, n_out, n_in,
                                        n):
    _, pre, labels, _ = _epoch_operands(n, n_out, n_in, n, bad_label=-1)
    pre = torch.from_numpy(pre).to(cuda)
    labels = torch.from_numpy(labels).to(cuda)
    labels[-1] = n_out
    k = _key(key, cuda)
    ops.reset_launch_counts()
    got = ops.stdp_epoch_masks(pre, labels, k, n_out, p_pot=p_pot,
                               p_dep=p_dep)
    assert ops.launch_counts()["stdp_epoch_masks"] == 1
    want = ops.stdp_epoch_masks_ref(pre, labels, k, n_out, p_pot, p_dep)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_epoch_masks_at_a_drawn_uniform(cuda):
    """p set exactly to a drawn uniform: u < p is false for that draw and
    true one step below it, so the kernel's integer compare must give
    exactly the float compare's masks."""
    n, n_in, n_out = 64, 100, 10
    _, pre, labels, _ = _epoch_operands(5, n_out, n_in, n)
    pre = torch.from_numpy(pre).to(cuda)
    labels = torch.from_numpy(labels).to(cuda)
    key = prng.PRNGKey(11, device=cuda)
    u = ops.column_event_uniforms(key, torch.arange(n, device=cuda), n_in)
    for p in (float(u[0][0, 0]), float(u[1][5, 7]), float(u[2][9, 3])):
        for p_pot, p_dep in ((p, p), (p, 0.3), (0.3, p)):
            got = ops.stdp_epoch_masks(pre, labels, key, n_out, p_pot=p_pot,
                                       p_dep=p_dep)
            want = ops.stdp_epoch_masks_ref(pre, labels, key, n_out, p_pot,
                                            p_dep)
            assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_column_epoch_capacity(cuda):
    n_out, n_in = 2048, 1024       # 264 KiB of bit planes: past one block
    bits_t = torch.zeros((n_out, n_in), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        ops.stdp_column_epoch(
            bits_t, torch.ones((1, n_in), dtype=torch.bool, device=cuda),
            torch.zeros((1,), dtype=torch.int32, device=cuda),
            prng.PRNGKey(0, device=cuda), p_pot=0.2, p_dep=0.1)


#: (n_out, n_in, samples, p_pot, p_dep, labels outside [0, n_out), tied):
#: the matrix-RNG epoch's cases (the chain's routes: (10, 70) and (10, 256)
#: one row a lane in registers, (33, 70) two, (65, 70) and (256, 768) in
#: shared memory, the last with one slot a bulk copy)
UPDATE_CASES = [
    (10, 70, 16, 0.3, 0.15, (-1, 10, 20), False),
    (10, 70, 16, 0.3, 0.15, (), True),
    (33, 70, 12, 0.3, 0.15, (-1, 33, 66), False),
    (65, 70, 10, 0.3, 0.15, (-1, 65, 130), True),
    (10, 40, 12, 0.3, 0.0, (-1,), False),
    (10, 40, 12, 0.0, 0.2, (10,), False),
    (10, 40, 12, 1.0, 1.0, (20,), False),
    (10, 70, 0, 0.3, 0.15, (), False),
    (10, 70, 1, 0.3, 0.15, (), False),
    (10, 256, 4096, 0.2, 0.1, (-1, 10, 20), False),
    (256, 768, 40, 0.2, 0.1, (-1, 256), False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("n_out,n_in,n,p_pot,p_dep,bad,tied", UPDATE_CASES)
def test_cuda_update_epoch_matches_plain(cuda, n_out, n_in, n, p_pot, p_dep,
                                         bad, tied):
    """The matrix-RNG epoch's three launches against the per-sample plain
    loop under the same key, bits and update count; each kernel against
    its own plain version on the way (keys, then slots)."""
    bits_t, pre, labels, _ = _epoch_operands(n_in + n_out, n_out, n_in, n,
                                             tied=tied)
    for i, label in enumerate(bad):
        labels[1 + 3 * i] = label
    bits_t, pre, labels = (torch.from_numpy(a).to(cuda)
                           for a in (bits_t, pre, labels))
    key = prng.PRNGKey(n + 1, device=cuda)
    ops.reset_launch_counts()
    got = bits_t.clone()
    count = ops.stdp_update_epoch(got, pre, labels, key, p_pot=p_pot,
                                  p_dep=p_dep)
    launched = int(n > 0)
    assert ops.launch_counts() == {
        "stdp_epoch_masks": 0, "stdp_column_epoch": 0,
        "stdp_column_event": 0, "stdp_update": 0,
        "stdp_update_keys": launched, "stdp_update_masks": launched,
        "stdp_update_chain": launched}
    want, want_count = ops.stdp_update_epoch_ref(bits_t, pre, labels, key,
                                                 p_pot, p_dep)
    assert torch.equal(got, want) and int(count) == int(want_count)
    assert count.dtype == torch.int32 and count.device == got.device
    keys = ops.stdp_update_keys(key, n)
    assert torch.equal(keys, ops.stdp_update_keys_ref(key, n))
    assert torch.equal(
        ops.stdp_update_masks(pre, labels, keys, n_out, p_pot=p_pot,
                              p_dep=p_dep),
        ops.stdp_update_masks_ref(pre, labels, keys, n_out, p_pot, p_dep))


@pytest.mark.cuda
def test_cuda_update_epoch_capacity(cuda):
    """A readout whose matrix-RNG slots do not fit one block raises before
    any launch."""
    n_out, n_in = 2048, 1024
    bits_t = torch.zeros((n_out, n_in), dtype=torch.int8, device=cuda)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="shared memory"):
        ops.stdp_update_epoch(
            bits_t, torch.ones((1, n_in), dtype=torch.bool, device=cuda),
            torch.zeros((1,), dtype=torch.int32, device=cuda),
            prng.PRNGKey(0, device=cuda), p_pot=0.2, p_dep=0.1)
    assert not any(ops.launch_counts().values())
