"""Integrate-and-Fire neuron array (Sec 3.4, Fig 5): the bitline decode.

Each neuron accumulates the {+1/-1}-decoded bitline values of the granted
rows; the stored weight bit '1' reads as +1 and '0' as -1.
"""

from __future__ import annotations

import torch


def decode_bitlines(weight_bits: torch.Tensor) -> torch.Tensor:
    """Map stored weight bits {0,1} to synaptic values {-1,+1} (int32)."""
    return 2 * weight_bits.to(torch.int32) - 1
