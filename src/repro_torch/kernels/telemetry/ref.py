"""Plain PyTorch versions of the round-telemetry kernels.

``tile_loads_ref`` is the plan's per-plane ``packing.group_popcount``;
``request_stats_ref`` and ``temporal_request_stats_ref`` are the cost
model's float32 device accounting (the bodies ``cost_model.
request_stats_device`` and ``temporal_request_stats_device`` had before
this module), with every float32 operation in the reference's order
(``repro.core.esam.cost_model.request_stats_device``).  Two orders are made
explicit so that ``csrc/telemetry.cu`` can repeat them bit for bit, on
either device:

* a stream's energy is the sum of its per-step energies added one step
  after another (a torch reduction's order is its own);
* the energy a step is the stream's energy times the float32 reciprocal of
  T (what torch's CUDA division by a Python scalar does; the CPU's would
  divide).

``stats_columns`` lays the results out in one float32 slab a round
(``ops.request_stats``), so the round's results leave the card in one copy.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core import packing
from repro_torch.core.esam import cost_model as cm


def tile_loads_ref(planes: Sequence[torch.Tensor]) -> tuple:
    """Per plane int32 words ``[..., W]`` (W a multiple of 4), the arbiter
    loads ``[..., W/4]``: the spike count of each 128-bit row group."""
    return tuple(packing.group_popcount(p) for p in planes)


def step_reciprocal(n_steps: int) -> float:
    """``float32(1) / float32(T)``, a float32 value: the factor of a
    stream's energy a step."""
    return float(np.float32(1.0) / np.float32(n_steps))


def tile_constants(topology: Sequence[int], read_ports: int) -> list[dict]:
    """Per tile, the geometry and the energy factors of the float32
    accounting, as Python floats (each a double product; torch rounds a
    Python scalar operand of a float32 tensor to float32, and so does the
    kernel's launcher)."""
    out = []
    for t in range(len(topology) - 1):
        n_in, n_out = topology[t], topology[t + 1]
        n_groups, n_colgroups = cm.tile_geometry(n_in, n_out)
        out.append({
            "groups": n_groups,
            "colgroups": n_colgroups,
            "arbiter": n_groups * cm.E_ARBITER_PJ_PER_CYCLE_128,
            "accum": n_out * cm.E_NEURON_ACCUM_PJ,
            "fire": n_out * cm.E_NEURON_FIRE_PJ,
            "clocktree": (n_groups * n_colgroups
                          * cm.E_TILE_CLOCKTREE_PJ_PER_CYCLE),
        })
    return out


def request_stats_ref(
    topology: Sequence[int],
    loads: Sequence[torch.Tensor],   # per tile, int32[..., n_groups]
    read_ports: int,
) -> dict:
    """``cost_model.request_stats`` in float32 torch ops on the loads'
    device.  Returns {"cycles_per_tile": f32[B, T], "cycles": f32[B],
    "latency_ns": f32[B], "energy_pj": f32[B]}."""
    spec = cm.cell_spec(read_ports)
    p = spec.ports
    n_tiles = len(topology) - 1
    if len(loads) != n_tiles:
        raise ValueError(f"{len(loads)} load tensors for {n_tiles} tiles")

    cycles_pt, energy = [], None
    for t, k in enumerate(tile_constants(topology, read_ports)):
        ld = loads[t].to(torch.float32).reshape(-1, k["groups"])
        drain = torch.ceil(ld / p)
        tile_cycles = drain.amax(dim=1) + 1.0
        cycles_pt.append(tile_cycles)

        reads = ld.sum(dim=1) * k["colgroups"]
        e = reads * spec.e_read_pj
        e += tile_cycles * k["arbiter"]
        e += tile_cycles * k["accum"]
        e += k["fire"]
        e += tile_cycles * k["clocktree"]
        energy = e if energy is None else energy + e

    cycles_per_tile = torch.stack(cycles_pt, dim=1)
    cycles = cycles_per_tile.sum(dim=1)
    return {
        "cycles_per_tile": cycles_per_tile,
        "cycles": cycles,
        "latency_ns": cycles * spec.clock_ns,
        "energy_pj": energy,
    }


def temporal_request_stats_ref(
    topology: Sequence[int],
    loads: Sequence[torch.Tensor],   # per tile, int32[B, T, n_groups]
    read_ports: int,
) -> dict:
    """:func:`request_stats_ref` on the ``[B*T, groups]`` loads, summed over
    the T steps of each stream (cycles exactly; energy one step after
    another).  Adds ``energy_pj_per_step`` and ``n_steps``."""
    b, t = loads[0].shape[:2]
    flat = [ld.reshape(b * t, -1) for ld in loads]
    rs = request_stats_ref(topology, flat, read_ports)
    n_tiles = len(topology) - 1
    cycles_per_tile = rs["cycles_per_tile"].reshape(b, t, n_tiles).sum(dim=1)
    cycles = rs["cycles"].reshape(b, t).sum(dim=1)
    steps = rs["energy_pj"].reshape(b, t)
    energy = torch.zeros((b,), dtype=torch.float32, device=steps.device)
    for s in range(t):
        energy = energy + steps[:, s]
    return {
        "cycles_per_tile": cycles_per_tile,
        "cycles": cycles,
        "latency_ns": cycles * cm.cell_spec(read_ports).clock_ns,
        "energy_pj": energy,
        "energy_pj_per_step": energy * step_reciprocal(t),
        "n_steps": t,
    }


#: the slab's per-request stats columns, after the logits (when carried)
STATS_KEYS = ("cycles", "latency_ns", "energy_pj")


def stats_columns(n_tiles: int, n_cls: int, temporal: bool) -> dict:
    """Column slices of one round's float32 slab ``[B, C]``: ``logits``
    (``n_cls`` columns; 0 when the slab carries none), ``cycles_per_tile``,
    ``cycles``, ``latency_ns``, ``energy_pj`` and, for event streams,
    ``energy_pj_per_step``."""
    cols = {"logits": slice(0, n_cls),
            "cycles_per_tile": slice(n_cls, n_cls + n_tiles)}
    c = n_cls + n_tiles
    for key in STATS_KEYS + (("energy_pj_per_step",) if temporal else ()):
        cols[key] = slice(c, c + 1)
        c += 1
    cols["width"] = c
    return cols


def stats_slab_ref(rs: dict, n_tiles: int, temporal: bool,
                   logits: torch.Tensor | None = None) -> torch.Tensor:
    """The slab of :func:`stats_columns` from a stats dict (and logits)."""
    parts = [] if logits is None else [logits.to(torch.float32)]
    parts.append(rs["cycles_per_tile"].reshape(-1, n_tiles))
    keys = STATS_KEYS + (("energy_pj_per_step",) if temporal else ())
    parts += [rs[k].reshape(-1, 1) for k in keys]
    return torch.cat(parts, dim=1)
