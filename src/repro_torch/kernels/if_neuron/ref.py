"""Plain PyTorch version of the IF-neuron accumulation kernel.

Torch twin of the reference's ``repro.kernels.if_neuron.ref``: the T rounds
of int32 updates are summed in int32 (``dtype=torch.int32``: torch sums
int32 to int64 unless told otherwise), which wraps on overflow as JAX's
int32 sum does, then the neuron fires at ``vmem >= vth``.  The CUDA kernel
of ``csrc/if_neuron.cu`` is held bit for bit against it.
"""

from __future__ import annotations

import torch


def if_neuron_ref(updates: torch.Tensor, vth: torch.Tensor):
    """Accumulate T per-cycle contributions, then fire.

    Args:
      updates: int32[B, T, N], the summed port contributions of each of T
        arbiter rounds (cycles).
      vth: int32[N]
    Returns:
      (spikes int8[B, N], vmem int32[B, N])
    """
    vmem = updates.to(torch.int32).sum(dim=1, dtype=torch.int32)
    return (vmem >= vth[None, :].to(torch.int32)).to(torch.int8), vmem
