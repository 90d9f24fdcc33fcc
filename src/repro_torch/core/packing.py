"""Bit-packed spike planes: 32 binary spikes per 32-bit lane word.

The wire format of the reference (``repro.core.packing``), bit for bit:

    spikes {0,1}[..., n]  <->  packed words[..., ceil(n/32)]

Bit ``b`` of word ``j`` holds spike ``j*32 + b`` (LSB-first within a word).
Positions past ``n`` in the last word are zero ("silent") — a zero spike
contributes nothing to the CIM MAC regardless of the stored weight bit, so
padding is exact, never approximate.

Torch has no usable uint32 arithmetic on the CPU (no shift, no popcount), so
the torch side keeps each word in a ``torch.int32`` tensor holding the same
32 bits.  Bit ``b`` is ``(x >> b) & 1`` — an arithmetic shift copies the sign
bit into the top positions, and the ``& 1`` discards them.  The CUDA kernels
read the same buffers as ``uint32_t``.  Numpy arrays stay ``uint32``; cross
the boundary with :func:`words_from_np` / :func:`words_to_np` (a view, never
a value conversion).
"""

from __future__ import annotations

import numpy as np
import torch

LANE_BITS = 32  # spikes per packed word

#: the torch dtype that carries packed words (same bits as uint32)
WORD_DTYPE = torch.int32


def packed_width(n: int) -> int:
    """Number of 32-bit words needed for n spikes."""
    return -(-n // LANE_BITS)


def words_from_np(words: np.ndarray) -> torch.Tensor:
    """uint32 numpy words -> int32 torch words with the same bits (CPU)."""
    words = np.ascontiguousarray(words)
    if words.dtype != np.uint32:
        raise TypeError(f"expected uint32 words, got {words.dtype}")
    return torch.from_numpy(words.view(np.int32))


def words_to_np(words: torch.Tensor) -> np.ndarray:
    """int32 torch words -> uint32 numpy words with the same bits."""
    if words.dtype != WORD_DTYPE:
        raise TypeError(f"expected int32 words, got {words.dtype}")
    return words.detach().cpu().contiguous().numpy().view(np.uint32)


def popcount32(words: torch.Tensor) -> torch.Tensor:
    """Set bits per 32-bit word -> int32, same shape (SWAR, exact).

    Widens to int64 first so every intermediate is non-negative: the words'
    sign bit becomes an ordinary bit 31 and no step can overflow.
    """
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = (x * 0x01010101) >> 24
    return (x & 0xFF).to(torch.int32)


# --------------------------------------------------------------------- #
# torch pair
# --------------------------------------------------------------------- #
def pack_spikes(spikes: torch.Tensor) -> torch.Tensor:
    """{0,1}[..., n] (any dtype) -> int32 words[..., ceil(n/32)]."""
    n = spikes.shape[-1]
    w = packed_width(n)
    bits = (spikes != 0).to(torch.int32)
    pad = w * LANE_BITS - n
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    b = bits.reshape(bits.shape[:-1] + (w, LANE_BITS))
    shifts = torch.arange(LANE_BITS, dtype=torch.int32, device=spikes.device)
    # distinct powers of two: the sum is an exact bitwise OR (bit 31 is the
    # int32 sign bit, so the int64 sum lands in int32 range)
    return (b << shifts).sum(-1, dtype=torch.int64).to(torch.int32)


def unpack_spikes(packed: torch.Tensor, n: int,
                  dtype=torch.int8) -> torch.Tensor:
    """int32 words[..., W] -> {0,1}[..., n] in ``dtype``."""
    w = packed.shape[-1]
    if w != packed_width(n):
        raise ValueError(f"{w} words cannot hold exactly {n} spikes")
    shifts = torch.arange(LANE_BITS, dtype=torch.int32, device=packed.device)
    bits = (packed.to(torch.int32)[..., None] >> shifts) & 1
    flat = bits.reshape(packed.shape[:-1] + (w * LANE_BITS,))
    return flat[..., :n].to(dtype)


def group_popcount(packed: torch.Tensor, group: int = 128) -> torch.Tensor:
    """Spike count per ``group``-bit row group, straight off the wire format.

    packed: int32 words[..., W] of a spike plane whose logical width is a
    multiple of ``group`` (tail padding past it is zero, so counts stay
    exact).  Returns int32[..., W*32/group] — the per-row-group arbiter loads
    of the reference's ``packing.group_popcount``.
    """
    if group % LANE_BITS:
        raise ValueError(f"group {group} is not a multiple of {LANE_BITS}")
    words_per_group = group // LANE_BITS
    pc = popcount32(packed)
    w = pc.shape[-1]
    if w % words_per_group:
        raise ValueError(f"{w} words do not split into {group}-bit groups")
    return pc.reshape(pc.shape[:-1] + (w // words_per_group,
                                       words_per_group)).sum(
        -1, dtype=torch.int32)


def pack_weight_planes(weight_bits: torch.Tensor) -> torch.Tensor:
    """Stored bits {0,1}[K, N] -> int32 words[N, ceil(K/32)] weight planes.

    Row ``n`` packs output neuron ``n``'s column of stored bits along the
    pre-synaptic axis, in the spike wire layout.  For ±1 weights stored as
    {0,1} bits,

        V[b, n] = 2 * sum_j popcount(spikes[b,j] & planes[n,j]) - popcount(spikes[b])

    and zero padding is exact in both terms.
    """
    return pack_spikes(weight_bits.transpose(-1, -2))


def unpack_weight_planes(planes: torch.Tensor, n_in: int,
                         dtype=torch.int8) -> torch.Tensor:
    """int32 words[N, ceil(K/32)] -> stored bits {0,1}[K, N] (round trip)."""
    return unpack_spikes(planes, n_in, dtype).transpose(-1, -2)


# --------------------------------------------------------------------- #
# numpy (host) pair — uint32, the reference's layout
# --------------------------------------------------------------------- #
def pack_spikes_np(spikes: np.ndarray) -> np.ndarray:
    n = spikes.shape[-1]
    w = packed_width(n)
    bits = (np.asarray(spikes) != 0).astype(np.uint32)
    pad = w * LANE_BITS - n
    if pad:
        widths = [(0, 0)] * (bits.ndim - 1) + [(0, pad)]
        bits = np.pad(bits, widths)
    b = bits.reshape(bits.shape[:-1] + (w, LANE_BITS))
    shifts = np.arange(LANE_BITS, dtype=np.uint32)
    return np.sum(b << shifts, axis=-1, dtype=np.uint64).astype(np.uint32)


def unpack_spikes_np(packed: np.ndarray, n: int, dtype=np.int8) -> np.ndarray:
    w = packed.shape[-1]
    if w != packed_width(n):
        raise ValueError(f"{w} words cannot hold exactly {n} spikes")
    shifts = np.arange(LANE_BITS, dtype=np.uint32)
    bits = (packed[..., None] >> shifts) & np.uint32(1)
    flat = bits.reshape(packed.shape[:-1] + (w * LANE_BITS,))
    return flat[..., :n].astype(dtype)


def pack_weight_planes_np(weight_bits: np.ndarray) -> np.ndarray:
    """Host twin of ``pack_weight_planes`` (uint32, same layout)."""
    return pack_spikes_np(np.asarray(weight_bits).swapaxes(-1, -2))


def unpack_weight_planes_np(planes: np.ndarray, n_in: int,
                            dtype=np.int8) -> np.ndarray:
    return unpack_spikes_np(planes, n_in, dtype).swapaxes(-1, -2)


def pad_spike_rows_np(rows, batch: int, n_in: int) -> np.ndarray:
    """Stack per-request spike rows into a zero-padded {0,1} uint8 batch.

    ``rows``: sequence of {0,1}[n_in] arrays (any dtype), ``len(rows) <=
    batch``.  Unused slots stay all-zero ("silent"), which is exact padding
    for the binary CIM MAC.
    """
    if len(rows) > batch:
        raise ValueError(f"{len(rows)} rows do not fit a batch of {batch}")
    out = np.zeros((batch, n_in), np.uint8)
    for i, r in enumerate(rows):
        r = np.asarray(r)
        if r.shape != (n_in,):
            raise ValueError(f"row {i} has shape {r.shape}, want ({n_in},)")
        out[i] = r != 0
    return out


def pack_padded_rows_np(rows, batch: int, n_in: int) -> np.ndarray:
    """``pad_spike_rows_np`` straight into the uint32 wire format."""
    return pack_spikes_np(pad_spike_rows_np(rows, batch, n_in))
