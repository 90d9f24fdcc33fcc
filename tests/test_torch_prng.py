"""repro_torch.core.prng against jax.random, bit for bit: keys, fold_in,
split, bits, uniform, bernoulli and permutation, on 1-D and 2-D shapes,
with seeds and fold-in data at and above 2^31 and keys whose words have bit
31 set."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro_torch.core import prng

SEEDS = [0, 7, 2**31 - 1, 2**31, 2**32 - 1, 2**32 + 5, 12345678901]
#: raw keys with bit 31 set in one or both words
HIGH_KEYS = [(0x80000000, 1), (0xFFFFFFFF, 0xDEADBEEF), (3, 0x9E3779B9)]


def _jkey(words):
    return jax.random.wrap_key_data(np.asarray(words, np.uint32),
                                    impl="threefry2x32")


def _keys():
    """(jax key, port key) pairs: PRNGKey seeds and raw high-bit keys."""
    out = [(jax.random.PRNGKey(s), prng.PRNGKey(s)) for s in SEEDS]
    out += [(jax.random.key_data(_jkey(w)), torch.tensor(w, dtype=torch.int64))
            for w in HIGH_KEYS]
    return out


def _eq(t: torch.Tensor, a) -> None:
    np.testing.assert_array_equal(t.numpy(), np.asarray(a).astype(t.numpy().dtype))


@pytest.mark.parametrize("seed", SEEDS + [-1])
def test_prngkey(seed):
    _eq(prng.PRNGKey(seed), jax.random.PRNGKey(seed))


@pytest.mark.parametrize("i", range(len(SEEDS) + len(HIGH_KEYS)))
def test_fold_in_and_split(i):
    jk, tk = _keys()[i]
    for d in (0, 1, 5, 2**31 - 1, 2**31, 2**31 + 3, 2**32 - 1):
        _eq(prng.fold_in(tk, d), jax.random.fold_in(jk, d))
    for n in (2, 3):
        _eq(prng.split(tk, n), jax.random.split(jk, n))
    _eq(prng.split(tk), jax.random.split(jk))


def test_fold_in_is_vectorised_over_keys_and_data():
    jk, tk = _keys()[3]
    data = np.array([0, 9, 2**31 + 1, 77], np.int64)
    got = prng.fold_in(tk, torch.from_numpy(data))
    for row, d in zip(got, data):
        _eq(row, jax.random.fold_in(jk, int(d)))
    keys = prng.split(tk, 3)
    got = prng.fold_in(keys[:, None, :], torch.arange(2))
    for a in range(3):
        for b in range(2):
            _eq(got[a, b], jax.random.fold_in(jax.random.split(jk, 3)[a], b))


@pytest.mark.parametrize("shape", [(1,), (6,), (257,), (3, 5), (768, 10)])
def test_bits_uniform_bernoulli(shape):
    for jk, tk in _keys()[::2]:
        _eq(prng.bits(tk, shape), jax.random.bits(jk, shape))
        u = prng.uniform(tk, shape)
        assert u.dtype == torch.float32
        _eq(u, jax.random.uniform(jk, shape))
        for p in (0.0, 0.1, 0.5, 1.0):
            _eq(prng.bernoulli(tk, p, shape), jax.random.bernoulli(jk, p, shape))


def test_uniform_vectorised_over_keys():
    jk, tk = _keys()[1]
    keys = prng.split(tk, 4)
    got = prng.uniform(keys, (2, 9))
    assert got.shape == (4, 2, 9)
    for j in range(4):
        _eq(got[j], jax.random.uniform(jax.random.split(jk, 4)[j], (2, 9)))


@pytest.mark.parametrize("n", [1, 2, 10, 1000, 5000])
def test_permutation(n):
    for jk, tk in _keys()[:4]:
        _eq(prng.permutation(tk, n), jax.random.permutation(jk, n))


def test_key_checks():
    with pytest.raises(ValueError):
        prng.permutation(prng.split(prng.PRNGKey(0)), 4)


#: (minval, maxval): spans 1, 12, 2^16 + 3 (the uint32 product's
#: multiplier wraps to 0 above 2^16) and 2^31 - 1, negative bounds, the
#: full int32 range (span 2^32 - 1) and maxval <= minval (span 1: minval)
RANDINT_BOUNDS = [(0, 1), (0, 12), (0, 2**16 + 3), (0, 2**31 - 1),
                  (-5, 7), (-100, -3), (-2**31, 2**31 - 1),
                  (-2**31 + 1, 2**31 - 1), (3, 2**16), (10, 3), (4, 4),
                  (-2**31, -2**31)]


@pytest.mark.parametrize("bounds", RANDINT_BOUNDS)
@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (256,)])
def test_randint(bounds, shape):
    lo, hi = bounds
    for jk, tk in _keys()[::3]:
        got = prng.randint(tk, shape, lo, hi)
        assert got.dtype == torch.int32 and got.shape == shape
        _eq(got, jax.random.randint(jk, shape, lo, hi))


def test_randint_vectorised_over_keys_and_bounds():
    jk, tk = _keys()[2]
    keys = prng.split(tk, 3)
    got = prng.randint(keys, (4,), 0, 12)
    for j in range(3):
        _eq(got[j], jax.random.randint(jax.random.split(jk, 3)[j], (4,), 0,
                                       12))
    lo = np.array([-3, 0, 5, 9], np.int64)
    hi = np.array([4, 2**20, 5, 2**31 - 1], np.int64)
    got = prng.randint(tk, (2, 4), torch.from_numpy(lo), torch.from_numpy(hi))
    _eq(got, jax.random.randint(jk, (2, 4), lo.astype(np.int32),
                                hi.astype(np.int32)))


@pytest.mark.parametrize("bounds", [(0, 2**31), (-2**31 - 1, 0),
                                    (5, 2**33)])
def test_randint_rejects_bounds_outside_int32(bounds):
    """JAX (64-bit types off) raises OverflowError there; so does the port."""
    with pytest.raises(OverflowError):
        jax.random.randint(jax.random.PRNGKey(0), (3,), *bounds)
    with pytest.raises(OverflowError):
        prng.randint(prng.PRNGKey(0), (3,), *bounds)


def _record_fit_batches(module, monkeypatch):
    """``module.fit``'s per-step labels batches, its ``train_step``
    replaced by a recorder (the labels are the sample indices)."""
    seen = []

    def record(params, opt, x, labels, lr):
        seen.append(np.asarray(labels).astype(np.int64))
        return params, opt, 0.0, 0.0

    monkeypatch.setattr(module, "train_step", record)
    return seen


@pytest.mark.parametrize("n,batch", [(3072, 128), (97, 16), (2048, 128)])
def test_bnn_fit_draws_the_reference_batches(monkeypatch, n, batch):
    """The port's ``bnn.fit`` trains on the reference's samples under the
    same key: step by step, the indices ``jax.random.randint`` draws."""
    from repro.core.esam import bnn as ref_bnn
    from repro_torch.core.esam import bnn

    topology, steps = (16, 10), 6
    idx = np.arange(n)
    want = _record_fit_batches(ref_bnn, monkeypatch)
    ref_bnn.fit(jax.random.PRNGKey(0), topology, np.zeros((n, 16), np.float32),
                idx.astype(np.int32), steps=steps, batch=batch)
    got = _record_fit_batches(bnn, monkeypatch)
    bnn.fit(prng.PRNGKey(0), topology, torch.zeros((n, 16)),
            torch.from_numpy(idx), steps=steps, batch=batch, device="cpu")
    assert len(got) == len(want) == steps
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_sqrt32_is_correctly_rounded():
    """``prng.sqrt32`` is numpy's (IEEE, correctly rounded) float32 root
    bit for bit, as XLA's is, over many magnitudes, zero, subnormals and
    infinity; torch's own float32 CPU ``sqrt`` misses some of these by an
    ulp.  ``erf_inv``'s tail and ``bnn``'s Adam step take it."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.uniform(0.0, 30.0, 20000), 10.0 ** rng.uniform(-40, 38, 20000),
        [0.0, 1e-45, 1e-39, 1.0, 2.0, 3.4e38, np.inf]]).astype(np.float32)
    got = prng.sqrt32(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.sqrt(x).view(np.int32))
