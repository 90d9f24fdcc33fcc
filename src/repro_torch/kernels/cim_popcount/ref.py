"""Plain PyTorch versions of the popcount-domain CIM MAC kernels.

Torch twins of the reference's ``repro.kernels.cim_popcount.ref``: they
compute in the kernels' own domain — AND + popcount per 32-bit word with the
row-popcount offset — on whatever device their tensors lie on.  The CUDA
kernels are held bit for bit against these (``chip_smoke.py``, the
``cuda``-marked tests), and CPU tensors run these directly.

Identity (±1 weights stored as {0,1} bits ``w``, spikes ``s``):

    V[b, n] = sum_k s[b,k] * (2*w[k,n] - 1)
            = 2 * sum_j popcount(packed[b,j] & planes[n,j]) - popcount(packed[b])

Zero tail padding in the wire format is exact in both terms.
"""

from __future__ import annotations

import torch

from repro_torch.core import packing


def _and_popcount(packed: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """sum_j popcount(packed[b,j] & planes[n,j]) -> int32[B, N].

    Word-at-a-time accumulation keeps the intermediate at [B, N] instead of
    materializing the full [B, N, W] AND tensor.
    """
    B, W = packed.shape
    N, W2 = planes.shape
    if W != W2:
        raise ValueError(f"word counts differ: {tuple(packed.shape)} vs "
                         f"{tuple(planes.shape)}")
    acc = torch.zeros((B, N), dtype=torch.int32, device=packed.device)
    for j in range(W):
        acc += packing.popcount32(packed[:, j, None] & planes[None, :, j])
    return acc


def cim_popcount_ref(packed: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """V_mem int32[B, N] from spike words [B, W] and weight planes [N, W]."""
    spc = packing.popcount32(packed).sum(-1, dtype=torch.int32)
    return 2 * _and_popcount(packed, planes) - spc[:, None]


def esam_layer_popcount_ref(
    packed: torch.Tensor,
    planes: torch.Tensor,
    vth: torch.Tensor,
    *,
    pack_output: bool = True,
) -> torch.Tensor:
    """Fused popcount MAC + IF fire (+ re-pack)."""
    fired = cim_popcount_ref(packed, planes) >= vth[None, :].to(torch.int32)
    return packing.pack_spikes(fired) if pack_output else fired.to(torch.int8)


def esam_cascade_popcount_ref(
    packed: torch.Tensor,
    planes: tuple,   # per tile: int32 words[N_t, ceil(K_t/32)]
    vth: tuple,      # per tile: int32[N_t] (the last entry is unused)
) -> tuple[torch.Tensor, tuple]:
    """Whole cascade: hidden fires on the popcount plane, int32 logits.

    Returns (vmem int32[B, n_cls], fired hidden planes tuple) — exactly the
    mega kernel's outputs.
    """
    p = packed
    fired = []
    for w, th in zip(planes[:-1], vth[:-1]):
        p = esam_layer_popcount_ref(p, w, th, pack_output=True)
        fired.append(p)
    return cim_popcount_ref(p, planes[-1]), tuple(fired)
