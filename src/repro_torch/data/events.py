"""Spike encoders: float frames -> [T, batch, n_in] event tensors.

The port's copy of the reference's ``repro.data.events``, function for
function and bit for bit (host numpy; tests/test_torch_events.py).

The temporal plane (``core/esam/temporal.py``) consumes *event streams*: T
timesteps of binary spike planes, one per clock tick of the SNN, with
membrane potential persisting between them.  This module turns static float
frames (the synthetic digit set, or any [batch, n] array in [0, 1]) and
frame *sequences* into such streams, with the three encodings event cameras
and SNN front-ends actually use:

``rate``     Bernoulli rate coding — pixel intensity is a firing probability,
             sampled i.i.d. per timestep.  The workhorse encoding of
             rate-coded SNN inference (more timesteps -> lower variance).
``latency``  time-to-first-spike — each pixel fires exactly once, earlier for
             stronger intensity (and never, below ``eps``).  T events carry
             the whole frame with at most one spike per wire: the
             lowest-energy encoding on the event bus.
``delta``    change detection — a spike wherever the value changed by at
             least ``threshold`` vs the previous frame (DVS-style).  Defined
             on frame sequences; static frames produce one initial burst.

All encoders are deterministic in their ``seed`` (counter-based numpy
``default_rng`` — same seed, same events, any call order), run host-side in
numpy, and emit uint8 {0,1} events; ``pack_events`` converts a stream to the
uint32 bitplane wire format (``repro_torch.core.packing``) the packed temporal
datapath moves, ``[T, batch, ceil(n/32)]``.  Widths that are not multiples
of 32 pack exactly (tail bits are silent — see packing).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import packing
from repro_torch.data import digits

ENCODERS = ("rate", "latency", "delta")


def rate_encode(
    frames: np.ndarray, n_steps: int, *, seed: int = 0, gain: float = 1.0
) -> np.ndarray:
    """Bernoulli rate coding.

    frames: float[..., n] intensities, clipped to [0, 1] after ``gain``.
    Returns uint8 {0,1}[T, ..., n]: spike_t ~ Bernoulli(clip(gain * x)),
    i.i.d. across timesteps, deterministic in ``seed``.
    """
    assert n_steps >= 1, n_steps
    p = np.clip(np.asarray(frames, np.float64) * gain, 0.0, 1.0)
    rng = np.random.default_rng(np.random.SeedSequence([seed, n_steps]))
    u = rng.random((n_steps, *p.shape))
    return (u < p[None]).astype(np.uint8)


def latency_encode(
    frames: np.ndarray, n_steps: int, *, eps: float = 1e-3
) -> np.ndarray:
    """Time-to-first-spike coding: one spike per active input, earlier for
    stronger intensity.

    frames: float[..., n] in [0, 1].  A pixel with intensity x >= ``eps``
    fires exactly once at t = round((1 - x) * (T - 1)); x = 1 fires at t = 0,
    x = eps fires last, x < eps never fires.  Deterministic (no RNG).
    Returns uint8 {0,1}[T, ..., n] with per-wire spike count <= 1.
    """
    assert n_steps >= 1, n_steps
    x = np.clip(np.asarray(frames, np.float64), 0.0, 1.0)
    t_fire = np.rint((1.0 - x) * (n_steps - 1)).astype(np.int64)
    steps = np.arange(n_steps).reshape((n_steps,) + (1,) * x.ndim)
    return ((steps == t_fire[None]) & (x[None] >= eps)).astype(np.uint8)


def delta_encode(
    frame_seq: np.ndarray, *, threshold: float = 0.1
) -> np.ndarray:
    """Change-detection (DVS-style) coding over a frame sequence.

    frame_seq: float[T, ..., n].  Emits a spike wherever
    |frame_t - frame_{t-1}| >= ``threshold``, with frame_{-1} = 0 — so the
    first event plane is the initial scene and later planes carry only
    change.  Deterministic (no RNG).  Returns uint8 {0,1}[T, ..., n].
    """
    seq = np.asarray(frame_seq, np.float64)
    assert seq.ndim >= 2, seq.shape
    prev = np.concatenate([np.zeros_like(seq[:1]), seq[:-1]], axis=0)
    return (np.abs(seq - prev) >= threshold).astype(np.uint8)


def encode(
    frames: np.ndarray,
    n_steps: int,
    *,
    encoder: str = "rate",
    seed: int = 0,
    **kw,
) -> np.ndarray:
    """Dispatch over ``ENCODERS``.  ``delta`` tiles a static frame into a
    T-long constant sequence first (one initial burst, then silence)."""
    if encoder == "rate":
        return rate_encode(frames, n_steps, seed=seed, **kw)
    if encoder == "latency":
        return latency_encode(frames, n_steps, **kw)
    if encoder == "delta":
        seq = np.broadcast_to(
            np.asarray(frames)[None], (n_steps, *np.asarray(frames).shape))
        return delta_encode(seq, **kw)
    raise ValueError(f"unknown encoder {encoder!r}; options: {ENCODERS}")


def pack_events(events: np.ndarray) -> np.ndarray:
    """{0,1}[T, ..., n] -> uint32[T, ..., ceil(n/32)] wire-format bitplanes."""
    return packing.pack_spikes_np(events)


def encode_digit_events(
    n: int,
    n_steps: int,
    *,
    encoder: str = "rate",
    seed: int = 0,
    flip_noise: float = 0.02,
    packed: bool = False,
    **kw,
) -> tuple[np.ndarray, np.ndarray]:
    """Synthetic digit set as an event stream.

    Returns (events, labels): events uint8[T, n, 768] (or uint32
    [T, n, 24] when ``packed``), labels int32[n].  Deterministic in ``seed``
    (both the digits and the encoder draw from it).
    """
    frames, labels = digits.make_spike_dataset(n, seed=seed,
                                               flip_noise=flip_noise)
    ev = encode(frames, n_steps, encoder=encoder, seed=seed, **kw)
    return (pack_events(ev) if packed else ev), labels
