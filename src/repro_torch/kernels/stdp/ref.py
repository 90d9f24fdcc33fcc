"""Plain PyTorch versions of the transposed-port STDP kernels.

Torch twins of the reference's ``repro.kernels.stdp.ref``: stochastic 1-bit
STDP on the transposed ("column-resident") weight layout ``{0,1}[N_out,
N_in]``, given explicit uniform draws.  A synapse of a learning neuron
potentiates (bit -> 1) when its pre-neuron fired and ``u_pot < p_pot``, and
depresses (bit -> 0) when it was silent and ``u_dep < p_dep``; ``p_pot`` and
``p_dep`` are compared in float32, as the reference compares its float32
uniforms against them.  ``stdp_column_epoch_ref`` is a whole epoch of
column events, the reference's ``column_event_epoch`` scan body sample by
sample.  ``column_event_uniforms`` is that scan's draw (``core/prng.py``,
so the reference's bits), and ``stdp_epoch_masks_ref`` what the card's
epoch makes of it: one slot a sample of the rule's masks, packed.
``stdp_update_epoch_ref`` is the reference's matrix-RNG scan (a ``split``
chain, two full ``[N_in, N_out]`` uniform matrices a ``stdp_update``), and
``stdp_update_keys_ref`` / ``stdp_update_masks_ref`` the key chain and the
slots its card epoch makes of the same draws.  The CUDA kernels of
``csrc/stdp.cu`` are held bit for bit against these.  All return new
tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import packing, prng


def f32(p: float) -> float:
    """``p`` rounded to float32 (the precision the rule compares in)."""
    return float(np.float32(p))


def uniform_threshold(p: float) -> int:
    """The integer ``t`` with ``u < p`` exactly when ``(bits >> 9) < t``.

    A uniform is ``(bits >> 9) * 2^-23`` exactly (``prng.uniform``), so
    ``u < p`` (``p`` rounded to float32) is ``bits >> 9 < p * 2^23``, which
    for an integer is ``< ceil(p * 2^23)``; clamped to ``[0, 2^23]``, and 0
    for NaN (no uniform is below NaN).  The epoch kernel compares so."""
    p = f32(p)
    if not p > 0.0:
        return 0
    if p >= 1.0:
        return 1 << 23
    return math.ceil(p * (1 << 23))


def _rule(old, pre, u_pot, u_dep, p_pot, p_dep):
    potentiate = pre & (u_pot < f32(p_pot))
    depress = ~pre & (u_dep < f32(p_dep))
    one = torch.ones((), dtype=old.dtype, device=old.device)
    return torch.where(potentiate, one, torch.where(depress, 0 * one, old))


def stdp_update_ref(
    bits_t: torch.Tensor,   # {0,1}[N_out, N_in]
    pre: torch.Tensor,      # {0,1}[N_in]
    post: torch.Tensor,     # {0,1}[N_out] learning events
    u_pot: torch.Tensor,    # float32[N_out, N_in]
    u_dep: torch.Tensor,    # float32[N_out, N_in]
    p_pot: float,
    p_dep: float,
) -> torch.Tensor:
    """The rule on every learning neuron's row (rows where ``post`` is 0 keep
    their bits)."""
    new = _rule(bits_t, (pre != 0)[None, :], u_pot, u_dep, p_pot, p_dep)
    return torch.where((post != 0)[:, None], new, bits_t)


def stdp_column_event_ref(
    bits_t: torch.Tensor,   # {0,1}[N_out, N_in]
    col: torch.Tensor,      # integer scalar: the learning neuron
    apply: torch.Tensor,    # bool scalar: identity when False
    pre: torch.Tensor,      # {0,1}[N_in] pre-synaptic activity trace
    u_pot: torch.Tensor,    # float32[N_in]
    u_dep: torch.Tensor,    # float32[N_in]
    p_pot: float,
    p_dep: float,
) -> torch.Tensor:
    """One column event: the rule on row ``col`` only, gated by ``apply``.
    ``col`` and ``apply`` may be tensors on the device; nothing syncs.  A
    ``col`` outside ``[0, N_out)`` is wrapped once if negative and clamped,
    as the reference's interpret-mode block index is."""
    n_out = bits_t.shape[0]
    idx = torch.as_tensor(col, device=bits_t.device).reshape(1).long()
    idx = torch.where(idx < 0, idx + n_out, idx).clamp(0, n_out - 1)
    old = bits_t.index_select(0, idx)[0]
    new = _rule(old, pre != 0, u_pot, u_dep, p_pot, p_dep)
    gate = torch.as_tensor(apply, device=bits_t.device) != 0
    return bits_t.index_copy(0, idx, torch.where(gate, new, old)[None])


def column_event_uniforms(
    key: torch.Tensor, sample_index, n_in: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-sample uniforms for the <= 2 event columns of supervised STDP.

    ``fold_in(key, i)`` per sample, then phase 0 potentiates / phase 1
    depresses the teacher column, phase 2 depresses the wrong-winner column.
    ``sample_index`` is an int or an integer tensor of indices; each output
    is float32 ``[*sample_index.shape, n_in]``, all drawn in one call."""
    idx = torch.as_tensor(sample_index, device=key.device)
    ks = prng.fold_in(key, idx)
    phase = torch.arange(3, dtype=torch.int64, device=key.device)
    u = prng.uniform(prng.fold_in(ks[..., None, :], phase), (n_in,))
    return u[..., 0, :], u[..., 1, :], u[..., 2, :]


def _field_words(n_in: int) -> int:
    """Words of one packed field of a slot: ``W = ceil(n_in / 32)`` rounded
    up to 8, 16 or 32 (the epoch kernels' register routes read a whole
    field) or, past 32, to 4."""
    w = packing.packed_width(n_in)
    return next((f for f in (8, 16, 32) if w <= f), -(-w // 4) * 4)


def _fields(masks, n_in: int) -> list[torch.Tensor]:
    """Each {0,1}[..., n_in] mask packed into one zero-padded field."""
    pad = _field_words(n_in) - packing.packed_width(n_in)
    return [torch.nn.functional.pad(packing.pack_spikes(m), (0, pad))
            for m in masks]


def epoch_slot_words(n_in: int) -> int:
    """int32 words of one sample's column-event slot: a 4-word header and
    four fields (``_field_words``)."""
    return 4 + 4 * _field_words(n_in)


def update_slot_words(n_in: int, n_out: int) -> int:
    """int32 words of one sample's matrix-RNG slot: a 4-word header, the
    trace, the teacher's potentiate mask and one depress mask a row."""
    return 4 + (2 + n_out) * _field_words(n_in)


def stdp_epoch_masks_ref(
    pre: torch.Tensor,      # {0,1}[n, N_in] pre-synaptic traces
    labels: torch.Tensor,   # integer [n] teacher classes
    key: torch.Tensor,      # int64[2] the epoch's key
    n_out: int,
    p_pot: float,
    p_dep: float,
) -> torch.Tensor:
    """The epoch's slots, one a sample ``i`` (its position in the epoch):
    int32 ``[n, epoch_slot_words(N_in)]``.

    Header: the trace's popcount, the teacher row (the label wrapped once if
    negative, then clamped), the label as the argmax compares it (-1, i.e.
    ``~0u``, when outside ``[0, n_out)``), 0.  Then four packed fields,
    zero past the trace: the trace; the teacher's potentiate mask (trace 1
    and ``u_pot < p_pot``) and depress mask (trace 0 and ``u_dep_t <
    p_dep``); the winner's depress mask (trace 1 and ``u_dep_w < p_dep``;
    the winner learns on the inverted trace with ``p_pot`` 0, so it never
    potentiates).  The draws are ``column_event_uniforms(key, i)``."""
    n, n_in = pre.shape
    pre = pre != 0
    u_pot, u_dep_t, u_dep_w = column_event_uniforms(
        key, torch.arange(n, device=pre.device), n_in)
    masks = (pre, pre & (u_pot < f32(p_pot)), ~pre & (u_dep_t < f32(p_dep)),
             pre & (u_dep_w < f32(p_dep)))
    words = _fields(masks, n_in)
    y = labels.long()
    teach = torch.where(y < 0, y + n_out, y).clamp(0, n_out - 1)
    compared = torch.where((y >= 0) & (y < n_out), y, -1)
    header = torch.stack((pre.sum(-1), teach, compared, torch.zeros_like(y)),
                         -1).to(torch.int32)
    return torch.cat([header, *words], -1)


def stdp_column_epoch_ref(
    bits_t: torch.Tensor,   # {0,1}[N_out, N_in]
    pre: torch.Tensor,      # {0,1}[n, N_in] pre-synaptic traces
    labels: torch.Tensor,   # integer [n] teacher classes
    u_pot: torch.Tensor,    # float32[n, N_in] teacher potentiation draws
    u_dep_t: torch.Tensor,  # float32[n, N_in] teacher depression draws
    u_dep_w: torch.Tensor,  # float32[n, N_in] wrong-winner draws
    out_offset: torch.Tensor | None,   # float32[N_out] or None
    p_pot: float,
    p_dep: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """A supervised column-event epoch, one sample after another.

    Per sample: V_mem = 2 (pre . bits) - |pre| exactly in int32; the
    prediction is its first argmax (after one float32 add of ``out_offset``
    when given); when it is not the label, the teacher row learns the rule
    on ``pre`` and then the predicted row the rule on ``~pre`` with
    ``p_pot`` 0.  A label outside ``[0, N_out)`` is always wrong, and its
    teacher row is the label wrapped once if negative and clamped, as the
    reference's interpret-mode block index is (``stdp_column_event_ref``).
    Returns (new bits, number of wrong samples as an int32 scalar); nothing
    syncs with the host."""
    pre = pre != 0
    not_pre = ~pre
    labels = labels.long()
    n_pre = pre.sum(-1, dtype=torch.int32)
    wrong = torch.zeros(pre.shape[:1], dtype=torch.bool, device=bits_t.device)
    for i in range(pre.shape[0]):
        hits = (bits_t.to(torch.int32) * pre[i]).sum(-1, dtype=torch.int32)
        vmem = 2 * hits - n_pre[i]
        pred = (vmem.argmax() if out_offset is None
                else (vmem.to(torch.float32) + out_offset).argmax())
        wrong_i = pred != labels[i]
        bits_t = stdp_column_event_ref(bits_t, labels[i], wrong_i, pre[i],
                                       u_pot[i], u_dep_t[i], p_pot, p_dep)
        bits_t = stdp_column_event_ref(bits_t, pred, wrong_i, not_pre[i],
                                       u_dep_w[i], u_dep_w[i], 0.0, p_dep)
        wrong[i] = wrong_i
    return bits_t, wrong.sum(dtype=torch.int32)


# ----------------------------------------------------------------------- #
# The matrix-RNG epoch (the reference's online_learning_epoch_scan with
# rng_scheme="matrix")
# ----------------------------------------------------------------------- #
def _words(x: torch.Tensor) -> torch.Tensor:
    """int64 uint32 values -> int32 words with the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _keyed_update(bits_t, pre, post, key, p_pot, p_dep):
    """The reference's keyed ``stdp_update`` on the transposed layout:
    ``split(key)``, two ``[N_in, N_out]`` uniform matrices, the rule."""
    u = prng.uniform(prng.split(key), tuple(bits_t.shape[::-1]))
    return stdp_update_ref(bits_t, pre, post, u[0].T, u[1].T, p_pot, p_dep)


def stdp_update_epoch_ref(
    bits_t: torch.Tensor,   # {0,1}[N_out, N_in]
    pre: torch.Tensor,      # {0,1}[n, N_in] pre-synaptic traces
    labels: torch.Tensor,   # integer [n] teacher classes
    key: torch.Tensor,      # int64[2] the epoch's key
    p_pot: float,
    p_dep: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's matrix-RNG scan, one sample after another.

    Per sample: V_mem = 2 (pre . bits) - |pre|, the prediction its first
    argmax; ``k, k1, k2 = split(k, 3)``; the teacher row (``one_hot`` of the
    label: none when the label is outside ``[0, N_out)``) learns the rule on
    ``pre`` under ``k1``, then the predicted row the rule on ``~pre`` with
    ``p_pot`` 0 under ``k2``, both only when the prediction is wrong.
    Returns (new bits, the update count: 2 a wrong sample, int32 scalar)."""
    n_out = bits_t.shape[0]
    pre = pre != 0
    labels = labels.long()
    n_pre = pre.sum(-1, dtype=torch.int32)
    rows = torch.arange(n_out, device=bits_t.device)
    count = torch.zeros((), dtype=torch.int32, device=bits_t.device)
    k = key
    for i in range(pre.shape[0]):
        hits = (bits_t.to(torch.int32) * pre[i]).sum(-1, dtype=torch.int32)
        pred = (2 * hits - n_pre[i]).argmax()
        wrong = pred != labels[i]
        k, k1, k2 = prng.split(k, 3)
        bits_t = _keyed_update(bits_t, pre[i], (rows == labels[i]) & wrong,
                               k1, p_pot, p_dep)
        bits_t = _keyed_update(bits_t, ~pre[i], (rows == pred) & wrong, k2,
                               0.0, p_dep)
        count = count + 2 * wrong.to(torch.int32)
    return bits_t, count


def stdp_update_keys_ref(key: torch.Tensor, n: int) -> torch.Tensor:
    """The scan's key chain: int32 words ``[n, 2]``, row i ``k_i`` (``k_0``
    the key, ``k_{i+1} = split(k_i, 3)[0]``)."""
    keys, k = [], key
    for _ in range(n):
        keys.append(k)
        k = prng.split(k, 3)[0]
    if not keys:
        return torch.empty((0, 2), dtype=torch.int32, device=key.device)
    return _words(torch.stack(keys))


def stdp_update_masks_ref(
    pre: torch.Tensor,      # {0,1}[n, N_in] pre-synaptic traces
    labels: torch.Tensor,   # integer [n] teacher classes
    keys: torch.Tensor,     # int32 words [n, 2]: stdp_update_keys_ref
    n_out: int,
    p_pot: float,
    p_dep: float,
) -> torch.Tensor:
    """The matrix-RNG epoch's slots: int32 ``[n, update_slot_words(N_in,
    N_out)]``.

    From ``k_i``: ``k1, k2 = split(k_i, 3)[1:]``; the teacher's uniforms
    ``split(k1)`` and the winner's depress uniforms ``split(k2)[1]``, each
    the reference's ``[N_in, N_out]`` matrix.  Header: the trace's
    popcount, the label twice (-1 when outside ``[0, N_out)``), 0.  Fields:
    the trace; the teacher row's potentiate mask (trace 1 and ``u_pot <
    p_pot``; zero without a teacher); then row o's depress mask: the
    teacher's (trace 0 and ``u_dep < p_dep``) at the label's row, the
    winner's (trace 1 and ``u_dep_w < p_dep``) at every other."""
    n, n_in = pre.shape
    pre = (pre != 0)[:, :, None]                               # [n, N_in, 1]
    k12 = prng.split(keys.long() & prng.MASK32, 3)[:, 1:]      # [n, 2, 2]
    kt = prng.split(k12[:, 0])                                 # [n, 2, 2]
    shape = (n_in, n_out)
    u_pot = prng.uniform(kt[:, 0], shape)                      # [n, *shape]
    u_dep_t = prng.uniform(kt[:, 1], shape)
    u_dep_w = prng.uniform(prng.split(k12[:, 1])[:, 1], shape)
    y = labels.long()
    teach = (torch.arange(n_out, device=pre.device) == y[:, None])[:, None]
    pot = (teach & pre & (u_pot < f32(p_pot))).any(-1)         # [n, N_in]
    dep = torch.where(teach, ~pre & (u_dep_t < f32(p_dep)),
                      pre & (u_dep_w < f32(p_dep)))            # [n, *shape]
    trace, pot, dep = _fields((pre[..., 0], pot, dep.transpose(1, 2)), n_in)
    label = torch.where((y >= 0) & (y < n_out), y, -1)
    header = torch.stack((pre[..., 0].sum(-1), label, label,
                          torch.zeros_like(y)), -1).to(torch.int32)
    return torch.cat([header, trace, pot, dep.flatten(1)], -1)
