"""Integrate-and-Fire neuron array (Sec 3.4, Fig 5).

Each neuron accumulates the validity-flagged, {+1/-1}-decoded bitline values
of the p inference ports into its V_mem register every clock cycle; the
stored weight bit '1' reads as +1 and '0' as -1.  When the tile's request
queue drains (R_empty), V_mem is compared against the per-neuron threshold
V_th; on fire the output register r is set and V_mem resets to zero.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.common import resolve_device


@dataclasses.dataclass
class NeuronState:
    """State of one tile's neuron array (leading dims: independent tiles)."""

    vmem: torch.Tensor    # int32[..., n_out] membrane potentials
    fired: torch.Tensor   # bool[..., n_out] output spike request register r

    @staticmethod
    def zeros(n_out: int, device="cuda") -> "NeuronState":
        """The reset state of ``n_out`` neurons, on the card unless
        ``device`` says otherwise (with no GPU the default raises)."""
        dev = resolve_device(device)
        return NeuronState(
            vmem=torch.zeros((n_out,), dtype=torch.int32, device=dev),
            fired=torch.zeros((n_out,), dtype=torch.bool, device=dev))


def accumulate(state: NeuronState, port_values: torch.Tensor,
               valid: torch.Tensor) -> NeuronState:
    """One SRAM-read/neuron-accumulate pipeline stage.

    Args:
      state: neuron state.
      port_values: int32[..., p, n_out] — sensed bitline values decoded to
        {+1,-1}.
      valid: bool[..., p] — per-port validity flags from the arbiter; an
        unused port must not be "erroneously read as a '1' and added"
        (Sec 3.4).
    """
    contrib = torch.where(valid[..., None], port_values,
                          0).sum(dim=-2, dtype=torch.int32)
    return NeuronState(vmem=state.vmem + contrib, fired=state.fired)


def fire(state: NeuronState, vth: torch.Tensor
         ) -> tuple[NeuronState, torch.Tensor]:
    """R_empty event: compare V_mem >= V_th, emit spikes, reset V_mem.

    The paper resets V_mem to zero on the compare event; for the
    time-static classification task every neuron is compared exactly once
    per sample, so every neuron resets.
    """
    spikes = state.vmem >= vth
    return NeuronState(vmem=torch.zeros_like(state.vmem), fired=spikes), spikes


def decode_bitlines(weight_bits: torch.Tensor) -> torch.Tensor:
    """Map stored weight bits {0,1} to synaptic values {-1,+1} (int32)."""
    return 2 * weight_bits.to(torch.int32) - 1
