"""One CIM-P tile (Fig 2): the functional MAC and the cycle-accurate drain.

A tile holds one layer's synapse matrix across a grid of <=128x128 SRAM
arrays.  Row groups (pre-synaptic, 128 rows each) each have their own p-port
arbiter; the column groups of a row group read the granted rows in the same
cycle.  Each clock cycle:

  arbiter stage:      every row group grants <= p pending spike requests
  SRAM+neuron stage:  granted rows are read on RBL0..RBL{p-1}; the neuron
                      array adds the validity-flagged {+1,-1} values to V_mem

When every row group's request queue is empty (R_empty), neurons compare
V_mem >= V_th and fire (Sec 3.4).  IF accumulation is commutative and the
compare happens only at R_empty, so the event-driven schedule and one dense
product give identical V_mem and spikes (``functional_tile``).

Two planes compute the cycle trace:

* ``simulate_tile`` / ``simulate_tile_batch`` — the **rank-schedule plane**.
  The fixed-priority cascade serves requests strictly in rank order, p per
  cycle, so every grant cycle is known in closed form (``cycle = rank // p``,
  ``arbiter.grant_cycles``): one ``port_schedule`` call (the arbiter kernel
  on the card) plus one matrix product and cycle-keyed sums.
* ``simulate_tile_scan`` / ``simulate_tile_scan_batch`` — the arbitration
  loop, one ``priority_grants`` round per clock cycle in plain torch.  The
  bit-identity oracle of the rank-schedule plane (tested field by field).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.esam import arbiter as arb
from repro_torch.core.esam import neuron as nrn
from repro_torch.kernels.arbiter import ops as arb_ops

#: elements of the per-cycle drained mask one V_mem-trace chunk may hold
#: (float32, 256 MiB): the trace is built over batch chunks of this size
TRACE_CHUNK_ELEMS = 1 << 26


class TileTrace(NamedTuple):
    """Cycle-by-cycle trace of one tile inference (leading batch dims when
    batched)."""

    out_spikes: torch.Tensor        # bool[n_out]
    vmem_final: torch.Tensor        # int32[n_out] V_mem right before the compare
    cycles: torch.Tensor            # int32 — cycles until R_empty
    grants_per_cycle: torch.Tensor  # int32[max_cycles] — total grants each cycle
    vmem_trace: torch.Tensor        # int32[max_cycles, n_out] when recorded,
    #                                 int32[0, n_out] otherwise


def max_drain_cycles(rows: int, ports: int, group: int = 128) -> int:
    """Static upper bound on cycles: a full group drains in ceil(group/p)."""
    del rows
    return -(-group // ports)


def exact_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in full float32, exact for small-integer operands.

    Integer matmul has no CUDA kernel, so integer products go through
    float32: exact while every partial sum stays an integer below 2^24.
    TF32 is turned off for this one product and the caller's setting is
    restored after it.
    """
    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.matmul(a.to(torch.float32), b.to(torch.float32))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow_tf32


def functional_tile(
    weight_bits: torch.Tensor | None,
    in_spikes: torch.Tensor,
    vth: torch.Tensor,
    *,
    w_signed: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched functional tile: one dense MAC.

    Args:
      weight_bits: {0,1}[n_in, n_out] (may be None when ``w_signed`` given)
      in_spikes: {0,1}/bool[..., n_in] (any batch shape)
      vth: int32[n_out]
      w_signed: optional pre-decoded ±1 [n_in, n_out] (any dtype) — the
        operand ``EsamPlan`` prepares once, skipping the per-call decode.
    Returns:
      (out_spikes bool[..., n_out], vmem int32[..., n_out])

    The product is ``exact_matmul``: float32 with TF32 off, exact because
    every partial sum is an integer of magnitude <= n_in, far below 2^24.
    """
    if w_signed is None:
        w_signed = nrn.decode_bitlines(weight_bits)
    vmem = exact_matmul(in_spikes, w_signed).to(torch.int32)
    return vmem >= vth, vmem


# ---------------------------------------------------------------------- #
# Rank-schedule plane (closed form, no sequential loop)
# ---------------------------------------------------------------------- #
def _vmem_trace(cycle_of: torch.Tensor, w_signed: torch.Tensor,
                n_cycles: int) -> torch.Tensor:
    """int32[B, n_cycles, n_out]: V_mem after each cycle of the drain.

    trace[b, c] sums the weight rows of the requests granted by the end of
    cycle c (``cycle_of <= c``; the sentinel of non-request lanes is past
    every cycle), one exact float32 product per batch chunk, so the
    ``[chunk, n_cycles, n_in]`` mask stays under ``TRACE_CHUNK_ELEMS``.
    """
    batch, n_in = cycle_of.shape
    steps = torch.arange(n_cycles, dtype=torch.int32, device=cycle_of.device)
    chunk = max(1, TRACE_CHUNK_ELEMS // max(1, n_cycles * n_in))
    parts = [
        exact_matmul(cycle_of[b0:b0 + chunk, None, :] <= steps[:, None],
                     w_signed).to(torch.int32)
        for b0 in range(0, batch, chunk)]
    if not parts:
        return torch.zeros((0, n_cycles, w_signed.shape[1]),
                           dtype=torch.int32, device=cycle_of.device)
    return torch.cat(parts)


def _schedule_trace(
    weight_bits: torch.Tensor | None,   # {0,1}[n_in, n_out] (or None)
    in_spikes: torch.Tensor,            # {0,1}/bool[B, n_in]
    vth: torch.Tensor,                  # int32[n_out]
    ports: int,
    record_vmem_trace: bool,
    w_signed: torch.Tensor | None = None,
) -> TileTrace:
    """Batched closed-form drain: every TileTrace field from one schedule.

    The grant cycle of request i is ``rank(i) // p``, so relative to the
    per-cycle scan:
      vmem_final        -> the functional plane's one product
      grants_per_cycle  -> grants per cycle summed over the row groups
      cycles            -> number of non-empty schedule slots
      vmem_trace        -> weight rows summed over the requests drained so far
    Every sum is an exact integer, so the result is bit-identical to
    ``simulate_tile_scan_batch`` (tested).
    """
    if w_signed is None:
        w_signed = nrn.decode_bitlines(weight_bits)
    n_in, n_out = w_signed.shape
    spikes = in_spikes != 0
    batch = spikes.shape[0]
    groups = arb.split_row_groups(spikes)                  # [B, G, 128]
    n_groups = groups.shape[1]
    max_cycles = max_drain_cycles(n_in, ports)

    cycle_of, counts = arb_ops.port_schedule(
        groups.reshape(batch * n_groups, groups.shape[-1]), ports=ports)
    counts = counts.reshape(batch, n_groups, max_cycles)
    grants_seq = counts.sum(dim=1, dtype=torch.int32)      # [B, max_cycles]
    cycles = (grants_seq > 0).sum(dim=-1, dtype=torch.int32)

    vmem = exact_matmul(spikes, w_signed).to(torch.int32)
    if record_vmem_trace:
        vmem_trace = _vmem_trace(cycle_of.reshape(batch, n_in), w_signed,
                                 max_cycles)
    else:
        vmem_trace = torch.zeros((batch, 0, n_out), dtype=torch.int32,
                                 device=spikes.device)
    return TileTrace(out_spikes=vmem >= vth, vmem_final=vmem, cycles=cycles,
                     grants_per_cycle=grants_seq, vmem_trace=vmem_trace)


def simulate_tile(weight_bits, in_spikes, vth, ports: int,
                  record_vmem_trace: bool = False,
                  w_signed: torch.Tensor | None = None) -> TileTrace:
    """Run one sample ``{0,1}[n_in]`` through a tile to R_empty on the
    rank-schedule plane (closed form).

    Bit-identical to ``simulate_tile_scan`` in every trace field;
    ``record_vmem_trace`` opts in to the full per-cycle V_mem history.
    """
    trace = _schedule_trace(weight_bits, in_spikes[None], vth, ports,
                            record_vmem_trace, w_signed)
    return TileTrace(*(f[0] for f in trace))


def simulate_tile_batch(weight_bits, in_spikes, vth, ports: int,
                        record_vmem_trace: bool = False,
                        w_signed: torch.Tensor | None = None) -> TileTrace:
    """Rank-schedule plane over a batch ``{0,1}[B, n_in]``: one product and
    one ``port_schedule`` call over the ``[B * G, 128]`` row groups.  Every
    TileTrace field gains a leading batch axis.  ``w_signed`` takes the
    pre-decoded ±1 operand (hoisted by ``EsamPlan``)."""
    return _schedule_trace(weight_bits, in_spikes, vth, ports,
                           record_vmem_trace, w_signed)


# ---------------------------------------------------------------------- #
# Scan plane (per-cycle arbitration loop) — the bit-identity oracle
# ---------------------------------------------------------------------- #
def simulate_tile_scan_batch(weight_bits, in_spikes, vth, ports: int,
                             record_vmem_trace: bool = False) -> TileTrace:
    """Run a batch ``{0,1}[B, n_in]`` to R_empty, one arbiter round per
    loop step — the literal cycle-by-cycle rendering of the hardware drain,
    batched over samples (each sample's arbiters are independent).  Plain
    torch, at most ``ceil(128 / p)`` steps; for tests."""
    w_signed = nrn.decode_bitlines(weight_bits)
    n_in, n_out = w_signed.shape
    remaining = arb.split_row_groups(in_spikes != 0)       # [B, G, 128]
    batch, n_groups = remaining.shape[:2]
    w_grouped = w_signed.reshape(n_groups, 128, n_out)
    state = nrn.NeuronState(
        vmem=torch.zeros((batch, n_out), dtype=torch.int32,
                         device=w_signed.device),
        fired=torch.zeros((batch, n_out), dtype=torch.bool,
                          device=w_signed.device))
    grants_seq, trace = [], []
    for _ in range(max_drain_cycles(n_in, ports)):
        # every row group arbitrates independently (its own 128-wide arbiter)
        grants, remaining, valid = arb.priority_grants(remaining, ports)
        # grants [B, G, p, 128]: read the granted rows in every column group
        port_vals = exact_matmul(grants, w_grouped).to(torch.int32)
        state = nrn.accumulate(
            state, port_vals.reshape(batch, n_groups * ports, n_out),
            valid.reshape(batch, n_groups * ports))
        grants_seq.append(valid.sum(dim=(1, 2), dtype=torch.int32))
        if record_vmem_trace:
            trace.append(state.vmem)
    grants_seq = torch.stack(grants_seq, dim=1)
    vmem = state.vmem
    _, out_spikes = nrn.fire(state, vth)
    vmem_trace = (torch.stack(trace, dim=1) if record_vmem_trace
                  else torch.zeros((batch, 0, n_out), dtype=torch.int32,
                                   device=w_signed.device))
    return TileTrace(out_spikes=out_spikes, vmem_final=vmem,
                     cycles=(grants_seq > 0).sum(dim=-1, dtype=torch.int32),
                     grants_per_cycle=grants_seq, vmem_trace=vmem_trace)


def simulate_tile_scan(weight_bits, in_spikes, vth, ports: int,
                       record_vmem_trace: bool = False) -> TileTrace:
    """``simulate_tile_scan_batch`` for one sample ``{0,1}[n_in]``."""
    trace = simulate_tile_scan_batch(weight_bits, in_spikes[None], vth, ports,
                                     record_vmem_trace)
    return TileTrace(*(f[0] for f in trace))
