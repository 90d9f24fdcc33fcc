"""repro_torch.core.packing against repro.core.packing: the wire format bit
for bit, on the CPU.  Torch words are int32 holding the reference's uint32
bits, so every comparison views one as the other — exact equality."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import packing as ref
from repro_torch.core import packing

WIDTHS = [1, 31, 32, 33, 100, 768]


def _spikes(seed: int, shape, p: float = 0.5) -> np.ndarray:
    return (np.random.default_rng(seed).random(shape) < p).astype(np.int8)


def _as_u32(words: torch.Tensor) -> np.ndarray:
    return packing.words_to_np(words)


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("fill", ["random", "zeros", "ones"])
def test_pack_unpack_match_reference(n, fill):
    s = {"random": _spikes(n, (5, n)), "zeros": np.zeros((5, n), np.int8),
         "ones": np.ones((5, n), np.int8)}[fill]
    want = np.asarray(ref.pack_spikes(jnp.asarray(s)))
    got = packing.pack_spikes(torch.from_numpy(s))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_as_u32(got), want)
    np.testing.assert_array_equal(packing.pack_spikes_np(s), want)
    np.testing.assert_array_equal(ref.pack_spikes_np(s), want)
    back = packing.unpack_spikes(got, n)
    np.testing.assert_array_equal(back.numpy(), s)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(ref.unpack_spikes(jnp.asarray(want), n)))
    np.testing.assert_array_equal(packing.unpack_spikes_np(want, n), s)


def test_bit31_words_round_trip():
    """Words with the sign bit set: every extreme bit pattern survives the
    int32 carrier in both directions."""
    words = np.array([[0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0x00000001,
                       0xAAAAAAAA, 0x55555555]], np.uint32)
    t = packing.words_from_np(words)
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(packing.words_to_np(t), words)
    n = 32 * words.shape[1]
    bits = packing.unpack_spikes(t, n)
    np.testing.assert_array_equal(
        bits.numpy(), np.asarray(ref.unpack_spikes(jnp.asarray(words), n)))
    np.testing.assert_array_equal(_as_u32(packing.pack_spikes(bits)), words)


def test_popcount32_matches_bit_count():
    rng = np.random.default_rng(7)
    words = np.concatenate([
        rng.integers(0, 2**32, size=1000, dtype=np.uint64).astype(np.uint32),
        np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x7FFFFFFF], np.uint32)])
    got = packing.popcount32(packing.words_from_np(words)).numpy()
    want = np.array([bin(int(w)).count("1") for w in words])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,group", [(128, 128), (256, 128), (768, 128),
                                     (100, 128), (768, 32), (64, 64)])
def test_group_popcount_matches_reference(n, group):
    s = _spikes(n + group, (3, 4, n), 0.6)
    want = np.asarray(ref.group_popcount(
        ref.pack_spikes(jnp.asarray(s)), group))
    got = packing.group_popcount(packing.pack_spikes(torch.from_numpy(s)),
                                 group)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_group_popcount_rejects_ragged_groups():
    with pytest.raises(ValueError):
        packing.group_popcount(torch.zeros((2, 3), dtype=torch.int32), 128)


@pytest.mark.parametrize("k,n", [(768, 256), (100, 10), (33, 7), (1, 1)])
def test_weight_planes_match_reference(k, n):
    w = _spikes(k * 7 + n, (k, n))
    want = np.asarray(ref.pack_weight_planes(jnp.asarray(w)))
    got = packing.pack_weight_planes(torch.from_numpy(w))
    np.testing.assert_array_equal(_as_u32(got), want)
    np.testing.assert_array_equal(packing.pack_weight_planes_np(w), want)
    np.testing.assert_array_equal(
        packing.unpack_weight_planes(got, k).numpy(), w)
    np.testing.assert_array_equal(packing.unpack_weight_planes_np(want, k), w)


@pytest.mark.parametrize("n_rows,batch,n_in", [(0, 8, 33), (5, 8, 100),
                                               (8, 8, 768)])
def test_padded_rows_match_reference(n_rows, batch, n_in):
    rows = list(_spikes(n_rows + n_in, (n_rows, n_in)).astype(np.float32))
    np.testing.assert_array_equal(
        packing.pad_spike_rows_np(rows, batch, n_in),
        ref.pad_spike_rows_np(rows, batch, n_in))
    np.testing.assert_array_equal(
        packing.pack_padded_rows_np(rows, batch, n_in),
        ref.pack_padded_rows_np(rows, batch, n_in))


def test_padded_rows_reject_overflow():
    with pytest.raises(ValueError):
        packing.pad_spike_rows_np([np.zeros(4)] * 3, 2, 4)


@given(seed=st.integers(0, 2**16), n=st.integers(1, 300),
       p=st.floats(0.0, 1.0))
@settings(max_examples=25, deadline=None, database=None)
def test_pack_property(seed, n, p):
    s = _spikes(seed, (3, n), p)
    want = ref.pack_spikes_np(s)
    got = packing.pack_spikes(torch.from_numpy(s))
    np.testing.assert_array_equal(_as_u32(got), want)
    np.testing.assert_array_equal(packing.unpack_spikes(got, n).numpy(), s)
