"""Multiport spike arbiter: the row-group split of a layer's requests.

Each 128-row SRAM group has its own arbiter (Sec 4.4.2), so a layer's
request vector is cut into row groups before any grant is scheduled.
"""

from __future__ import annotations

import torch


def split_row_groups(requests: torch.Tensor, group: int = 128) -> torch.Tensor:
    """Reshape a layer-wide request vector into [..., n_groups, group].

    The layer width must be a multiple of ``group`` (the paper pads its first
    layer to exactly 6x128 by cropping MNIST 784 -> 768).
    """
    n = requests.shape[-1]
    if n % group:
        raise ValueError(
            f"layer width {n} not a multiple of row-group size {group}")
    return requests.reshape(*requests.shape[:-1], n // group, group)
