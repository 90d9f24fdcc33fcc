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
