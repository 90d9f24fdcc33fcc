"""Multi-tile ESAM network (binary SNN) as a torch module, and the
system-level performance model (throughput / energy / power / area).

Tiles are cascaded directly; spikes travel between tiles as parallel binary
pulses (Sec 3.1), which lets the tile pipeline overlap consecutive samples:
tile t processes sample s while tile t+1 processes sample s-1.  System
throughput is therefore set by the slowest tile stage; latency is the sum of
stages (both in cycles of the cell-dependent clock, Table 2).  Inference runs
through :class:`~.plan.EsamPlan`, built and cached per network by
:meth:`EsamNetwork.plan`.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
from torch import nn

from repro_torch.core.esam import arbiter as arb
from repro_torch.core.esam import cost_model as cm
from repro_torch.core.esam import tile as tile_mod
from repro_torch.core.esam.plan import EsamPlan, PlanSpec
from repro_torch.kernels.common import resolve_device

ROW_GROUP = 128


class EsamNetwork(nn.Module):
    """A stack of CIM-P tiles.

    Buffers, per tile t:
      ``weight_bits_t``: int8 {0,1}[n_in, n_out] stored bits ('1' -> +1,
        '0' -> -1);
      ``vth_t``: int32[n_out] per-neuron thresholds (Fig 5's register);
    and ``out_offset``: float32[n_classes], the per-class readout offset
    folded from the BNN's final-layer bias during conversion.

    ``device`` defaults to ``"cuda"`` and raises when no GPU is present;
    pass ``device="cpu"`` to run the plain PyTorch datapath.
    """

    def __init__(self, weight_bits: Sequence[torch.Tensor],
                 vth: Sequence[torch.Tensor], out_offset: torch.Tensor, *,
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        if len(weight_bits) < 1 or len(vth) != len(weight_bits):
            raise ValueError(f"{len(weight_bits)} weight tiles and "
                             f"{len(vth)} threshold vectors")
        for t, (w, th) in enumerate(zip(weight_bits, vth)):
            if w.dim() != 2 or th.shape != (w.shape[1],):
                raise ValueError(f"tile {t}: weight_bits {tuple(w.shape)} and "
                                 f"vth {tuple(th.shape)} do not match")
            if t and w.shape[0] != weight_bits[t - 1].shape[1]:
                raise ValueError(f"tile {t} takes {w.shape[0]} inputs, tile "
                                 f"{t - 1} gives {weight_bits[t - 1].shape[1]}")
            self.register_buffer(f"weight_bits_{t}", w.to(dev, torch.int8))
            self.register_buffer(f"vth_{t}", th.to(dev, torch.int32))
        if out_offset.shape != (weight_bits[-1].shape[1],):
            raise ValueError(f"out_offset {tuple(out_offset.shape)} for "
                             f"{weight_bits[-1].shape[1]} classes")
        self.register_buffer("out_offset", out_offset.to(dev, torch.float32))
        self._n_tiles = len(weight_bits)
        self._plan_cache: dict[PlanSpec, EsamPlan] = {}

    @classmethod
    def from_numpy(cls, weight_bits: Sequence[np.ndarray],
                   vth: Sequence[np.ndarray], out_offset: np.ndarray, *,
                   device="cuda") -> "EsamNetwork":
        """Build from host arrays — e.g. ``np.asarray`` of a reference
        ``repro`` network's ``weight_bits``, ``vth`` and ``out_offset``.
        The buffers are copies: later writes to the arrays do not reach
        the network."""
        return cls(
            [torch.tensor(np.asarray(w, np.int8)) for w in weight_bits],
            [torch.tensor(np.asarray(v, np.int32)) for v in vth],
            torch.tensor(np.asarray(out_offset, np.float32)),
            device=device)

    def to_numpy(self) -> tuple[list[np.ndarray], list[np.ndarray], np.ndarray]:
        """The inverse of :meth:`from_numpy`: host copies of (weight_bits
        int8, vth int32, out_offset float32), ready for the reference's
        ``EsamNetwork`` or another port network."""
        return ([w.detach().cpu().numpy().copy() for w in self.weight_bits],
                [v.detach().cpu().numpy().copy() for v in self.vth],
                self.out_offset.detach().cpu().numpy().copy())

    @property
    def weight_bits(self) -> list[torch.Tensor]:
        return [getattr(self, f"weight_bits_{t}") for t in range(self._n_tiles)]

    @property
    def vth(self) -> list[torch.Tensor]:
        return [getattr(self, f"vth_{t}") for t in range(self._n_tiles)]

    @property
    def device(self) -> torch.device:
        return self.out_offset.device

    @property
    def topology(self) -> tuple[int, ...]:
        ws = self.weight_bits
        return tuple([ws[0].shape[0]] + [w.shape[1] for w in ws])

    def plan(self, *, mode: str = "packed", collect: bool = False,
             telemetry: bool = False,
             read_ports: int | tuple[int, ...] = 4,
             record_vmem_trace: bool = False, temporal=None) -> EsamPlan:
        """Build (or fetch from this network's cache) one plan.

        ``mode="temporal"`` takes a
        :class:`~repro_torch.core.esam.temporal.TemporalConfig`; each
        (T, leak, reset, refractory, collect, telemetry) is its own plan.
        """
        spec = PlanSpec(mode=mode, collect=collect, telemetry=telemetry,
                        read_ports=read_ports,
                        record_vmem_trace=record_vmem_trace,
                        temporal=temporal)
        cached = self._plan_cache.get(spec)
        if cached is None:
            cached = EsamPlan(self, spec)
            self._plan_cache[spec] = cached
        return cached

    def spike_counts(self, spikes, per_layer: Sequence[torch.Tensor] | None
                     = None) -> list[torch.Tensor]:
        """Per-layer, per-row-group spike counts for a batch (for the cost
        model): a list over tiles of int32[..., n_groups], the arbiter load
        of each 128-row group at that tile's input.

        ``per_layer`` takes hidden-layer spikes a caller already computed
        (a collecting plan, or a cycle plan's traces) — the counts are then
        pure reductions.  Without it the functional plan runs once with
        telemetry on.
        """
        n_hidden = len(self.weight_bits) - 1
        if per_layer is None:
            return list(
                self.plan(mode="functional", telemetry=True)(spikes).loads)
        if len(per_layer) < n_hidden:
            raise ValueError(f"{len(per_layer)} hidden planes for "
                             f"{n_hidden} hidden tiles")
        if not isinstance(spikes, torch.Tensor):
            spikes = torch.as_tensor(np.asarray(spikes))
        layer_inputs = [spikes.to(self.device), *per_layer[:n_hidden]]
        return [arb.split_row_groups((s != 0).to(torch.int32)).sum(
                    -1, dtype=torch.int32) for s in layer_inputs]

    def port_sweep(self, spikes, read_ports: Sequence[int] = range(5),
                   record_vmem_trace: bool = False
                   ) -> dict[int, tuple[torch.Tensor, list[tile_mod.TileTrace]]]:
        """Batched cycle-accurate design-space sweep over SRAM cell options.

        Runs the rank-schedule plane through every tile for each cell option
        in ``read_ports`` (0 = the 1RW baseline reading through its RW port)
        in one cycle plan — the Fig 8 workload.  Options sharing an
        effective port count (0 and 1) share one simulation.

        Returns {read_ports: (logits, traces)}; logits are identical across
        entries (the schedule only moves *when* contributions land), while
        the traces carry the per-option cycle counts the cost model reads.
        """
        rp = tuple(int(p) for p in read_ports)
        res = self.plan(mode="cycle", read_ports=rp,
                        record_vmem_trace=record_vmem_trace)(spikes)
        return {p: (res.sweep[p]["logits"], list(res.sweep[p]["traces"]))
                for p in rp}

    def measured_activity(
        self, spikes,
        traces: Sequence[tile_mod.TileTrace] | None = None,
    ) -> list[np.ndarray]:
        """Measured arbiter loads of a batch, ready for ``system_stats``:
        per tile float64[batch, n_groups] on the host.  Pass the traces of
        a ``port_sweep`` or cycle plan to reuse the spikes the simulator
        drained; otherwise the functional plan runs once with telemetry on.
        """
        if traces is not None:
            per_layer = [tr.out_spikes for tr in traces[:-1]]
            counts = self.spike_counts(spikes, per_layer=per_layer)
        else:
            counts = self.plan(mode="functional", telemetry=True)(
                spikes).loads
        return [c.cpu().numpy().astype(np.float64) for c in counts]


# ---------------------------------------------------------------------- #
# System-level performance model
# ---------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class SystemStats:
    cell: str
    read_ports: int
    clock_ns: float
    cycles_per_tile: tuple[float, ...]   # mean cycles until R_empty, + fire cycle
    bottleneck_tile: int
    latency_ns: float                    # single-inference latency
    throughput_inf_s: float              # pipelined
    energy_pj_per_inf: float
    dynamic_power_mw: float
    power_mw: float                      # incl. static
    area_um2: float
    area_ratio_vs_1rw: float


def system_stats(
    topology: Sequence[int],
    spikes_per_group: Sequence[np.ndarray] | Sequence[Sequence[float]],
    read_ports: int,
) -> SystemStats:
    """The full-system operating point of one cell option (float64, host).

    Batch means over ``cost_model.request_stats`` — the same per-request
    accounting the serving plane reports — so an operating point can be
    evaluated on the synthetic calibration profile (``reference_activity``)
    or on measured batch activity (``EsamNetwork.measured_activity``).

    Args:
      topology: e.g. (768, 256, 256, 256, 10).
      spikes_per_group: per tile, array[..., n_groups] of arbiter loads (a
        batch is averaged; max-over-groups is taken per sample *before*
        averaging, matching how the hardware stalls).
      read_ports: 0 (=1RW baseline) .. 4.
    """
    spec = cm.cell_spec(read_ports)
    rs = cm.request_stats(topology, spikes_per_group, read_ports)
    cycles = rs.cycles_per_tile.mean(axis=0)         # [T] mean incl. fire cycle
    energy = float(rs.energy_pj.mean())
    bottleneck = int(np.argmax(cycles))
    stage_ns = max(cycles) * spec.clock_ns
    throughput = 1e9 / stage_ns
    latency_ns = float(sum(cycles) * spec.clock_ns)
    dyn_mw = energy * 1e-12 * throughput * 1e3
    area = _system_area_um2(topology, read_ports)
    return SystemStats(
        cell=spec.name,
        read_ports=read_ports,
        clock_ns=spec.clock_ns,
        cycles_per_tile=tuple(float(c) for c in cycles),
        bottleneck_tile=bottleneck,
        latency_ns=latency_ns,
        throughput_inf_s=float(throughput),
        energy_pj_per_inf=float(energy),
        dynamic_power_mw=float(dyn_mw),
        power_mw=float(dyn_mw + cm.STATIC_POWER_MW),
        area_um2=area,
        area_ratio_vs_1rw=area / _system_area_um2(topology, 0),
    )


def _system_area_um2(topology: Sequence[int], read_ports: int) -> float:
    area = 0.0
    base = cm.CELL_AREA_6T_UM2 * ROW_GROUP * ROW_GROUP
    for t in range(len(topology) - 1):
        g, c = cm.tile_geometry(topology[t], topology[t + 1])
        area += g * c * (base * cm.CELL_AREA_RATIO[read_ports]
                         + base * cm.PERIPHERY_AREA_FRACTION)
    return area


def reference_activity(topology: Sequence[int] = cm.PAPER_TOPOLOGY
                       ) -> list[np.ndarray]:
    """The calibration activity profile (``cost_model.REF_SPIKES_PER_GROUP``)
    as per-tile float64[1, n_groups] loads."""
    out = []
    for t in range(len(topology) - 1):
        n_groups, _ = cm.tile_geometry(topology[t], topology[t + 1])
        out.append(np.full((1, n_groups), cm.REF_SPIKES_PER_GROUP[t],
                           np.float64))
    return out

