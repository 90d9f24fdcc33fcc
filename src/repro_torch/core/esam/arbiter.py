"""Multiport spike arbiter — functional plane.

The paper's arbiter (Sec 3.3, Fig 4) is p cascaded fixed-priority encoders:
port 0 grants the leftmost pending request, port 1 the next-leftmost, and
so on, all within one clock cycle; granted requests are masked out of the
request vector.  The cascade's *function* is prefix-sum rank selection:

    rank(i)   = (# of requests at indices <= i) - 1
    grant_k   = one-hot( request with rank == k ),  k < p

which gives the hardware cascade's grant vectors bit for bit (tested
against the pure-Python priority-encoder oracle below).  Each 128-row SRAM
group has its own arbiter (Sec 4.4.2), so a layer's request vector is cut
into row groups before any grant is scheduled.
"""

from __future__ import annotations

import numpy as np
import torch


def in_group_rank(r: torch.Tensor) -> torch.Tensor:
    """0-based in-group rank of each lane, int32 (last axis)."""
    return torch.cumsum(r, dim=-1, dtype=torch.int32) - 1


def priority_grants(requests: torch.Tensor, ports: int
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One arbiter clock cycle.

    Args:
      requests: bool/{0,1}[..., n] pending spike requests (R); leading dims
        are independent arbiters.
      ports: number of grant ports p.

    Returns:
      grants:    bool[..., p, n] — one-hot grant vector per port (all-zero
                 if noR).
      remaining: bool[..., n] — R' = R minus the granted requests.
      valid:     bool[..., p] — per-port validity flag (False == the paper's
                 noR), so unused ports are not summed by the neuron array.
    """
    req = requests != 0
    rank = in_group_rank(req.to(torch.int32))
    port_ids = torch.arange(ports, device=req.device)[:, None]   # [p, 1]
    grants = req[..., None, :] & (rank[..., None, :] == port_ids)
    remaining = req & ~grants.any(dim=-2)
    valid = grants.any(dim=-1)
    return grants, remaining, valid


def priority_grants_oracle(requests: np.ndarray, ports: int):
    """Pure-Python cascade of fixed-priority encoders (Fig 4 semantics)."""
    r = np.asarray(requests, dtype=bool).copy()
    n = r.shape[0]
    grants = np.zeros((ports, n), dtype=bool)
    valid = np.zeros((ports,), dtype=bool)
    for k in range(ports):  # cascaded 1-port arbiters
        nz = np.flatnonzero(r)
        if nz.size == 0:
            break  # noR propagates to all later ports
        grants[k, nz[0]] = True  # leftmost pending request
        valid[k] = True
        r[nz[0]] = False         # R' masks out the granted request
    return grants, r, valid


def grant_cycles(requests: torch.Tensor, ports: int) -> torch.Tensor:
    """Closed-form port schedule: the clock cycle each request is granted.

    The cascade serves requests strictly in rank order, p per cycle, so a
    request of in-group rank r is granted at cycle ``r // p``.

    Args:
      requests: bool/{0,1}[..., W] — request vector(s) of one row group.
      ports: p.
    Returns:
      int32[..., W] — grant cycle per lane; non-request lanes carry the
      sentinel ``ceil(W / p)`` (one past the last schedulable cycle).
    """
    r = requests.to(torch.int32)
    n_cycles = -(-r.shape[-1] // ports)
    rank = in_group_rank(r)
    return torch.where(r == 1, rank // ports, n_cycles).to(torch.int32)


def drain_cycles(n_pending, ports: int):
    """Clock cycles for a p-port arbiter to drain ``n_pending`` requests
    (ceil division; 0 pending -> 0 cycles)."""
    return -(-n_pending // ports)


def layer_drain_cycles(spike_counts_per_group: torch.Tensor,
                       ports: int) -> torch.Tensor:
    """Cycles until R_empty for a layer of 128-row groups, each with its own
    p-port arbiter (Sec 4.4.2: 'Each SRAM has its own 128-wide Arbiter')."""
    return torch.max(drain_cycles(spike_counts_per_group, ports))


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
