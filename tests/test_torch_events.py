"""repro_torch.data.events against repro.data.events: every encoder and the
wire-format packing give the same arrays, bit for bit and dtype for dtype,
on the same seeded inputs (the twin of tests/test_events.py)."""

from __future__ import annotations

import numpy as np
import pytest

from repro.data import events as jevents
from repro_torch.core import packing
from repro_torch.data import events


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 3, 4])
@pytest.mark.parametrize("gain", [1.0, 0.7, 0.0])
def test_rate_encode_matches_reference(seed, gain):
    frames = np.random.default_rng(seed).random((5, 40))
    got = events.rate_encode(frames, 6, seed=seed, gain=gain)
    _same(got, jevents.rate_encode(frames, 6, seed=seed, gain=gain))
    assert got.shape == (6, 5, 40) and got.dtype == np.uint8
    _same(got, events.rate_encode(frames, 6, seed=seed, gain=gain))


def test_rate_encode_extremes_and_gain():
    frames = np.array([[0.0, 1.0, 2.0]])
    ev = events.rate_encode(frames, 8, seed=0)
    _same(ev, jevents.rate_encode(frames, 8, seed=0))
    np.testing.assert_array_equal(ev[:, 0, 0], 0)     # p=0 never fires
    np.testing.assert_array_equal(ev[:, 0, 1:], 1)    # p>=1 clips, always fires
    np.testing.assert_array_equal(
        events.rate_encode(frames, 8, seed=0, gain=0.0), 0)


@pytest.mark.parametrize("n_steps", [1, 5, 16])
def test_latency_encode_matches_reference(n_steps):
    frames = np.array([[1.0, 0.5, 0.0, 1e-4]])
    rnd = np.random.default_rng(n_steps).random((3, 50))
    for f in (frames, rnd):
        got = events.latency_encode(f, n_steps)
        _same(got, jevents.latency_encode(f, n_steps))
        assert (got.sum(axis=0) <= 1).all()           # <= 1 spike per wire


def test_delta_encode_matches_reference():
    seq = np.zeros((4, 1, 3), np.float64)
    seq[0] = [[0.5, 0.0, 0.05]]
    seq[1] = [[0.5, 0.3, 0.05]]
    seq[2] = [[0.1, 0.3, 0.05]]
    seq[3] = seq[2]
    ev = events.delta_encode(seq, threshold=0.1)
    _same(ev, jevents.delta_encode(seq, threshold=0.1))
    np.testing.assert_array_equal(ev[:, 0], [[1, 0, 0], [0, 1, 0],
                                             [1, 0, 0], [0, 0, 0]])
    rnd = np.random.default_rng(2).random((6, 4, 30))
    _same(events.delta_encode(rnd, threshold=0.3),
          jevents.delta_encode(rnd, threshold=0.3))


@pytest.mark.parametrize("encoder,kw", [("rate", dict(seed=7)),
                                        ("latency", {}),
                                        ("delta", dict(threshold=0.5))])
def test_encode_dispatch_matches_reference(encoder, kw):
    frames = np.random.default_rng(1).random((3, 20))
    _same(events.encode(frames, 4, encoder=encoder, **kw),
          jevents.encode(frames, 4, encoder=encoder, **kw))
    assert events.ENCODERS == jevents.ENCODERS


def test_encode_rejects_unknown_encoder():
    with pytest.raises(ValueError):
        events.encode(np.zeros((1, 4)), 4, encoder="nope")


@pytest.mark.parametrize("n_in", [50, 96, 100, 768])
def test_pack_events_arbitrary_widths_roundtrip(n_in):
    """Packing widths that are not multiples of 32 is exact: silent tail
    bits, the reference's words, and unpack restores the stream."""
    ev = events.rate_encode(
        np.random.default_rng(n_in).random((4, n_in)), 3, seed=0)
    packed = events.pack_events(ev)
    _same(packed, jevents.pack_events(ev))
    assert packed.shape == (3, 4, packing.packed_width(n_in))
    np.testing.assert_array_equal(
        packing.unpack_spikes_np(packed, n_in, np.uint8), ev)
    if n_in % 32:
        np.testing.assert_array_equal(packed[..., -1] >> (n_in % 32), 0)


@pytest.mark.parametrize("encoder", ["rate", "latency", "delta"])
@pytest.mark.parametrize("packed", [False, True])
def test_encode_digit_events_matches_reference(encoder, packed):
    kw = dict(encoder=encoder, seed=5, packed=packed)
    if encoder == "rate":
        kw["gain"] = 0.7
    ev, y = events.encode_digit_events(6, 4, **kw)
    jev, jy = jevents.encode_digit_events(6, 4, **kw)
    _same(ev, jev)
    _same(y, jy)
    assert ev.shape == ((4, 6, 24) if packed else (4, 6, 768))
