"""Plain PyTorch versions of the multiport arbiter kernels.

Torch twins of the reference's ``repro.kernels.arbiter.ref``; they run on
either device.  The CUDA kernels of ``csrc/arbiter.cu`` are held bit for bit
against these.
"""

from __future__ import annotations

import torch

from repro_torch.core.esam.arbiter import grant_cycles, in_group_rank
from repro_torch.core.esam.arbiter import (  # noqa: F401  (re-export)
    priority_grants_oracle,
)


def port_schedule_ref(requests: torch.Tensor, ports: int):
    """Closed-form drain schedule for a batch of row groups.

    A request of in-group rank r is granted at cycle ``r // p``
    (``arbiter.grant_cycles``), so the whole drain is one rank computation
    plus a cycle-keyed segment count.

    Args:
      requests: {0,1}[N, W] — one request vector per 128-row group.
      ports: p.
    Returns:
      cycle_of int32[N, W] — grant cycle per lane (sentinel ``ceil(W/p)``
        on non-request lanes).
      counts int32[N, C] — grants issued per cycle per group,
        C = ceil(W / p).  Cycle c serves ranks [c*p, (c+1)*p), so its count
        is clip(popcount - c*p, 0, p): no per-lane scatter.
    """
    n_cycles = -(-requests.shape[-1] // ports)
    cycle_of = grant_cycles(requests, ports)
    pop = requests.to(torch.int32).sum(dim=-1, dtype=torch.int32)
    c = torch.arange(n_cycles, dtype=torch.int32, device=requests.device)
    counts = torch.clamp(pop[:, None] - c[None, :] * ports, 0, ports)
    return cycle_of, counts.to(torch.int32)


def arbiter_ref(requests: torch.Tensor, ports: int):
    """Fixed-priority grants of one arbiter cycle for a batch of row groups.

    Args:
      requests: {0,1}[G, W] — one request vector per 128-row group.
      ports: p.
    Returns:
      grants int8[G, p, W], remaining int8[G, W], valid int8[G, p]
    """
    r = requests.to(torch.int32)
    rank = in_group_rank(r)                                    # [G, W]
    pid = torch.arange(ports, device=r.device)[None, :, None]  # [1, p, 1]
    grants = (r[:, None, :] == 1) & (rank[:, None, :] == pid)
    remaining = (r == 1) & ~grants.any(dim=1)
    valid = grants.any(dim=2)
    return (grants.to(torch.int8), remaining.to(torch.int8),
            valid.to(torch.int8))
