"""Online learning via the transposable port: stochastic 1-bit STDP.

The port of the reference's ``repro.core.esam.learning``.  ESAM's column RW
port makes "update all synapses of one post-synaptic neuron" a 2x4-cycle
access instead of 2x128 (Sec 4.4.1); the rule it serves is the stochastic
1-bit STDP of Yousefzadeh et al. [16]: on a learning event, synapses from
active pre-neurons potentiate (bit -> 1) with probability ``p_pot`` and
synapses from silent ones depress (bit -> 0) with probability ``p_dep``.

Weights live transposed-resident, ``{0,1}[n_out, n_in]``, so one learning
neuron's synapses are one contiguous row, and each supervised event is one
``kernels/stdp.stdp_column_event`` launch on the card.  Every uniform comes
from ``core/prng.py``, which reproduces ``jax.random`` bit for bit, so under
the same key this module gives the reference's weights and update counts.

The reference's epoch is one jitted ``lax.scan``; here it is a Python loop
over samples that never reads a device value on the host: the readout, the
argmax, the event gate and both column writes stay on the device.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import packing, prng
from repro_torch.core.esam import cost_model as cm
from repro_torch.core.esam import plan as plan_mod
from repro_torch.core.esam import tile as tile_mod
from repro_torch.kernels.stdp import ops as stdp_ops
from repro_torch.kernels.stdp.ref import f32

RNG_SCHEMES = ("matrix", "column")


# --------------------------------------------------------------------- #
# The update rule
# --------------------------------------------------------------------- #
def stdp_update_from_uniforms(
    weight_bits: torch.Tensor,   # {0,1}[n_in, n_out]
    pre_spikes: torch.Tensor,    # bool[n_in]
    post_events: torch.Tensor,   # bool[n_out]
    u_pot: torch.Tensor,         # float32[n_in, n_out] (or broadcastable)
    u_dep: torch.Tensor,         # float32[n_in, n_out] (or broadcastable)
    p_pot: float,
    p_dep: float,
) -> torch.Tensor:
    """The stochastic-STDP rule given explicit uniform draws (the single
    source of truth the kernels and the planes are held against)."""
    pre = (pre_spikes != 0)[:, None]
    post = (post_events != 0)[None, :]
    potentiate = post & pre & (u_pot < f32(p_pot))
    depress = post & ~pre & (u_dep < f32(p_dep))
    one = torch.ones((), dtype=weight_bits.dtype, device=weight_bits.device)
    return torch.where(potentiate, one,
                       torch.where(depress, 0 * one, weight_bits))


def stdp_update(
    weight_bits: torch.Tensor,   # {0,1}[n_in, n_out]
    pre_spikes: torch.Tensor,    # bool[n_in] — pre-synaptic activity trace
    post_events: torch.Tensor,   # bool[n_out] — which post neurons learn now
    key: torch.Tensor,
    p_pot: float = 0.1,
    p_dep: float = 0.05,
) -> torch.Tensor:
    """One stochastic-STDP event, keyed: returns updated weight bits.

    The uniforms are the reference's (``split(key)``, two ``[n_in, n_out]``
    draws); the masked rewrite runs through ``kernels/stdp.stdp_update`` on
    the transposed layout (the CUDA kernel on the card, its plain version on
    the CPU)."""
    key = key.to(weight_bits.device)
    k = prng.split(key)
    u_pot = prng.uniform(k[0], weight_bits.shape)
    u_dep = prng.uniform(k[1], weight_bits.shape)
    new_t = stdp_ops.stdp_update(
        weight_bits.T, pre_spikes, post_events, u_pot.T, u_dep.T,
        p_pot=p_pot, p_dep=p_dep)
    return new_t.T


# --------------------------------------------------------------------- #
# Column-event RNG: counter-based keys, <= 3 * n_in draws per sample
# --------------------------------------------------------------------- #
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


# --------------------------------------------------------------------- #
# Hardware cost accounting (Sec 4.4.1)
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class ColumnUpdateCost:
    cell: str
    read_cycles: int
    write_cycles: int
    read_ns: float
    write_ns: float
    energy_pj: float            # read-modify-write of one column
    speedup_read_vs_1rw: float
    speedup_write_vs_1rw: float


def column_update_cost(read_ports: int, rows: int = 128) -> ColumnUpdateCost:
    """Time/energy to read+write one weight column (one learning neuron).

    The 1RW baseline touches all ``rows`` rows through its single RW port
    (2 x 128 cycles = 257.8 ns, 157 pJ for the full array, Sec 4.4.1); the
    transposed column port takes ``COL_MUX_FACTOR`` cycles each way at the
    transposed-path clock."""
    spec = cm.cell_spec(read_ports)
    rc, wc = cm.column_update_cycles(read_ports, rows)
    if read_ports == 0:
        read_ns, write_ns = cm.T1RW_COL_READ_NS, cm.T1RW_COL_WRITE_NS
        energy = rows * (cm.E_READ_1RW_PJ + cm.E_WRITE_1RW_PJ)
    else:
        clock = cm.T4R_TRANSPOSED_CLOCK_NS
        read_ns = (cm.T4R_COL_READ_NS if read_ports == 4
                   else rc * clock + spec.sram_neuron_ns)
        write_ns = (cm.T4R_COL_WRITE_NS if read_ports == 4
                    else wc * clock + spec.sram_neuron_ns)
        energy = spec.e_tread_pj + spec.e_write_pj
    return ColumnUpdateCost(
        cell=spec.name,
        read_cycles=int(rc),
        write_cycles=int(wc),
        read_ns=float(read_ns),
        write_ns=float(write_ns),
        energy_pj=float(energy),
        speedup_read_vs_1rw=float(cm.T1RW_COL_READ_NS / read_ns),
        speedup_write_vs_1rw=float(cm.T1RW_COL_WRITE_NS / write_ns),
    )


# --------------------------------------------------------------------- #
# Frozen-prefix activations
# --------------------------------------------------------------------- #
def last_hidden_spikes(network_bits, vth, spikes) -> torch.Tensor:
    """Run the frozen prefix tiles; returns the last tile's input spikes.

    The packed plane (``plan.packed_prefix``: one ``esam_layer_packed``
    per hidden tile) when every hidden width is 32-aligned, else the dense
    functional tiles; both give the same bool spikes.
    """
    hidden = network_bits[:-1]
    spikes = torch.as_tensor(spikes).to(network_bits[0].device) != 0
    if hidden and all(w.shape[1] % packing.LANE_BITS == 0 for w in hidden):
        p = plan_mod.packed_prefix(
            network_bits, vth, packing.pack_spikes(spikes))
        return packing.unpack_spikes(p, hidden[-1].shape[1], torch.bool)
    s = spikes
    for w, th in zip(hidden, vth[:-1]):
        s, _ = tile_mod.functional_tile(w, s, th)
    return s


def readout_vmem(bits_t: torch.Tensor, spikes: torch.Tensor) -> torch.Tensor:
    """V_mem = s . (2b - 1) on the transposed ``[n_out, n_in]`` layout, int32.

    One float32 product with TF32 off (``tile.exact_matmul``), exact for
    n_in < 2^24.  Takes one sample ``[n_in]`` or a batch ``[..., n_in]``."""
    sv = spikes.to(torch.float32)
    vmem = 2 * tile_mod.exact_matmul(sv, bits_t.T) - sv.sum(-1, keepdim=True)
    return vmem.to(torch.int32)


# --------------------------------------------------------------------- #
# The column-event epoch
# --------------------------------------------------------------------- #
def column_event_epoch(
    bits_t: torch.Tensor,        # {0,1} int8 [n_out, n_in], updated in place
    pre: torch.Tensor,           # bool[batch, n_in] — last tile's input spikes
    labels: torch.Tensor,        # integer [batch]
    key: torch.Tensor,
    *,
    p_pot: float,
    p_dep: float,
    out_offset: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One supervised-STDP epoch on the transposed-resident readout.

    Per sample: the readout matvec, the argmax, the teacher / wrong-winner
    events, and two gated column writes (``stdp_column_event``).  The
    epoch's uniforms (``[batch, 3, n_in]``, a function of ``(key, i)`` only)
    are drawn up front in one call.  ``bits_t`` is updated in place (the
    counterpart of the reference's donated buffer) and returned.

    ``out_offset`` shifts the argmax that names the wrong winner, so learning
    targets the deployed readout; ``None`` is the offset-free argmax.
    Returns (bits_t, number of column updates as an int32 device scalar).
    """
    dev = bits_t.device
    n_in = bits_t.shape[1]
    pre = torch.as_tensor(pre).to(dev) != 0
    labels = torch.as_tensor(labels).to(dev)
    n = pre.shape[0]
    u_pot, u_dep_t, u_dep_w = column_event_uniforms(
        key.to(dev), torch.arange(n, device=dev), n_in)
    not_pre = ~pre
    off = None if out_offset is None else out_offset.to(dev, torch.float32)
    wrong = torch.zeros((n,), dtype=torch.bool, device=dev)
    for i in range(n):
        vmem = readout_vmem(bits_t, pre[i])
        pred = (vmem.argmax() if off is None
                else (vmem.to(torch.float32) + off).argmax())
        wrong_i = pred != labels[i]
        # teacher column: Hebbian — pull it toward the pre pattern
        stdp_ops.stdp_column_event(
            bits_t, labels[i], wrong_i, pre[i], u_pot[i], u_dep_t[i],
            p_pot=p_pot, p_dep=p_dep)
        # wrong winner: pure depression of active-pre synapses (inverted
        # trace, potentiation off)
        stdp_ops.stdp_column_event(
            bits_t, pred, wrong_i, not_pre[i], u_dep_w[i], u_dep_w[i],
            p_pot=0.0, p_dep=p_dep)
        wrong[i] = wrong_i
    return bits_t, 2 * wrong.sum(dtype=torch.int32)


def online_learning_epoch(
    network_bits,
    vth,
    spikes: torch.Tensor,        # bool[batch, n_in]
    labels: torch.Tensor,        # integer [batch] — supervised teacher events
    key: torch.Tensor,
    p_pot: float = 0.12,
    p_dep: float = 0.06,
    pre_spikes: torch.Tensor | None = None,
):
    """Supervised-STDP pass over a batch for the *last* tile.

    The correct class neuron is a potentiation event, the argmax-wrong one a
    depression event.  ``pre_spikes`` takes the last hidden layer's spikes if
    the caller has them; otherwise the frozen prefix runs once on the packed
    plane (``last_hidden_spikes``).  Returns (new last-layer bits
    ``[n_in, n_out]``, number of column updates as an int32 device scalar).
    The network's own tensors are not written.
    """
    s = pre_spikes if pre_spikes is not None else last_hidden_spikes(
        network_bits, vth, spikes)
    last = network_bits[-1]
    bits_t = last.T.to(torch.int8).clone(memory_format=torch.contiguous_format)
    bits_t, n_updates = column_event_epoch(
        bits_t, s, labels, key, p_pot=float(p_pot), p_dep=float(p_dep))
    return bits_t.T, n_updates


def online_learning_epoch_scan(
    network_bits,
    vth,
    spikes: torch.Tensor,
    labels: torch.Tensor,
    key: torch.Tensor,
    p_pot: float = 0.12,
    p_dep: float = 0.06,
    pre_spikes: torch.Tensor | None = None,
    rng_scheme: str = "matrix",
):
    """The per-sample full-matrix rewrite: the reference's baseline plane.

    * ``rng_scheme="matrix"``: two full ``[n_in, n_out]`` uniform matrices
      per sample from a ``split`` chain, through ``stdp_update`` (the
      ``stdp_update`` kernel on the card);
    * ``rng_scheme="column"``: the column scheme of ``column_event_uniforms``
      broadcast across columns — the same bits as
      :func:`online_learning_epoch` under the same key.
    """
    if rng_scheme not in RNG_SCHEMES:
        raise ValueError(f"rng_scheme {rng_scheme!r} not in {RNG_SCHEMES}")
    bits = network_bits[-1]
    dev = bits.device
    n_in, n_out = bits.shape
    if pre_spikes is not None:
        s = torch.as_tensor(pre_spikes).to(dev) != 0
    else:
        s = torch.as_tensor(spikes).to(dev) != 0
        for w, th in zip(network_bits[:-1], vth[:-1]):
            s, _ = tile_mod.functional_tile(w, s, th)
    labels = torch.as_tensor(labels).to(dev)
    key = key.to(dev)
    n = s.shape[0]
    if rng_scheme == "column":
        u_pot, u_dep_t, u_dep_w = column_event_uniforms(
            key, torch.arange(n, device=dev), n_in)
    cls = torch.arange(n_out, device=dev)
    upd = torch.zeros((), dtype=torch.int32, device=dev)
    k = key
    for i in range(n):
        s_i, y_i = s[i], labels[i]
        _, vmem = tile_mod.functional_tile(bits, s_i, vth[-1])
        pred = vmem.argmax()
        wrong = pred != y_i
        post_pot = (cls == y_i) & wrong
        post_dep = (cls == pred) & wrong
        if rng_scheme == "matrix":
            k, k1, k2 = prng.split(k, 3)
            bits = stdp_update(bits, s_i, post_pot, k1, p_pot, p_dep)
            bits = stdp_update(bits, ~s_i, post_dep, k2, 0.0, p_dep)
        else:
            bits = stdp_update_from_uniforms(
                bits, s_i, post_pot, u_pot[i][:, None], u_dep_t[i][:, None],
                p_pot, p_dep)
            bits = stdp_update_from_uniforms(
                bits, ~s_i, post_dep, u_dep_w[i][:, None],
                u_dep_w[i][:, None], 0.0, p_dep)
        upd = upd + 2 * wrong.to(torch.int32)
    return bits, upd
