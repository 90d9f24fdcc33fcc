"""Plain PyTorch versions of the packed CIM MAC: unpack, then the dense MAC.

Torch twins of the reference's ``repro.kernels.cim_matmul_packed.ref``: the
spike words are unpacked to {0,1}, multiplied by the decoded ±1 weights
(``tile.functional_tile``: an exact float32 product, TF32 off), and the IF
fire compares the int32 V_mem with ``vth``.  The CUDA kernel of
``csrc/cim_matmul_packed.cu`` is held bit for bit against these.
"""

from __future__ import annotations

import torch

from repro_torch.core import packing
from repro_torch.core.esam import tile as tile_mod


def cim_matmul_packed_ref(packed: torch.Tensor,
                          weight_bits: torch.Tensor) -> torch.Tensor:
    """V_mem int32[B, N] from int32 words [B, ceil(K/32)] and {0,1}[K, N]."""
    spikes = packing.unpack_spikes(packed, weight_bits.shape[0], torch.float32)
    _, vmem = tile_mod.functional_tile(weight_bits, spikes,
                                       torch.zeros((), dtype=torch.int32))
    return vmem


def esam_layer_packed_ref(
    packed: torch.Tensor,
    weight_bits: torch.Tensor,
    vth: torch.Tensor,
    *,
    pack_output: bool = True,
) -> torch.Tensor:
    """Fused MAC + IF fire: int32 words [B, N/32] when ``pack_output``, else
    int8 {0,1}[B, N]."""
    fired = cim_matmul_packed_ref(packed, weight_bits) >= vth[None, :].to(
        torch.int32)
    return packing.pack_spikes(fired) if pack_output else fired.to(torch.int8)
