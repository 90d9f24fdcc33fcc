"""Plain PyTorch versions of the binary CIM MAC on unpacked spikes.

Torch twins of the reference's ``repro.kernels.cim_matmul.ref``: the spikes
are cast to int32, as the reference's ``spikes.astype(int32)`` casts them,
and multiplied by the ±1 decode of the stored bits through
``tile.functional_tile`` (an exact float32 product, TF32 off: an integer
matmul has no CUDA kernel); the IF fire compares the int32 V_mem with
``vth``.  The CUDA kernels of ``csrc/cim_matmul.cu`` are held bit for bit
against these.
"""

from __future__ import annotations

import torch

from repro_torch.core.esam import tile as tile_mod


def cim_matmul_ref(spikes: torch.Tensor,
                   weight_bits: torch.Tensor) -> torch.Tensor:
    """V_mem int32[B, N] = spikes @ (2*bits - 1), from {0,1} spikes [B, K]
    (any real or bool dtype) and {0,1} bits [K, N]."""
    _, vmem = tile_mod.functional_tile(weight_bits, spikes.to(torch.int32),
                                       torch.zeros((), dtype=torch.int32))
    return vmem


def esam_layer_ref(spikes: torch.Tensor, weight_bits: torch.Tensor,
                   vth: torch.Tensor) -> torch.Tensor:
    """Fused MAC + IF fire: int8 {0,1}[B, N] = (V_mem >= vth)."""
    fired = cim_matmul_ref(spikes, weight_bits) >= vth[None, :].to(torch.int32)
    return fired.to(torch.int8)
