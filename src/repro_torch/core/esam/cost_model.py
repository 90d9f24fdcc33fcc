"""Calibrated timing/energy cost model for the ESAM macro (paper units).

A copy of the reference's ``repro.core.esam.cost_model`` constants and
per-request accounting, with ``request_stats_device`` evaluated in float32
on the loads' own device (``kernels/telemetry``: a kernel on the card, its
plain torch version on the CPU).  Every constant is the paper's or is
derived from a published anchor; the provenance notes are the reference's.
Nothing here is a measurement of the GPU: cycles, ns and pJ are the modeled
3nm CIM macro's.  The last section holds the MAC datapath roofline inputs
(``mac_datapath_stats``) of the kernel bench, on the H100's published rates
(``core/h100.py``).

Cell naming: port index p in {0,1,2,3,4} == number of *decoupled read ports*.
p=0 is the standard 6T single-port cell ("1RW"); p>=1 are "1RW+<p>R".
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import h100

# ----------------------------------------------------------------------------
# Verbatim paper constants
# ----------------------------------------------------------------------------

#: Table 2 — arbiter stage delay (ns) per cell option [1RW, +1R, +2R, +3R, +4R].
ARBITER_STAGE_NS = (1.01, 1.01, 1.04, 1.03, 1.01)

#: Table 2 — SRAM read + neuron accumulate stage delay (ns).
SRAM_NEURON_STAGE_NS = (0.69, 1.08, 1.18, 1.14, 1.23)

#: Sec 3.3 — 128-wide 4-port arbiter critical path: flat (>1100ps -> <800ps via
#: tree decomposition at +8.0% area).  Used by the arbiter kernel docs/tests.
ARBITER_FLAT_CRITICAL_PATH_PS = 1100.0
ARBITER_TREE_CRITICAL_PATH_PS = 800.0
ARBITER_TREE_AREA_OVERHEAD = 0.08

#: Sec 4.2 — 6T cell area (um^2, [20]) and relative areas of multiport cells.
CELL_AREA_6T_UM2 = 0.01512
CELL_AREA_RATIO = (1.0, 1.5, 1.875, 2.25, 2.625)

#: Sec 4.4.1 — transposed-port (online learning) anchors.
#: 1RW full-array (128 rows) read+write: 2*128 cycles, 257.8 ns, 157 pJ.
T1RW_ARRAY_RW_NS = 257.8
T1RW_ARRAY_RW_PJ = 157.0
#: 4R cell, transposed port: column read 9.9 ns (26.0x less), write 8.04 ns
#: (19.5x less); clock period of the transposed path 1.2 ns; 2*4 cycles due to
#: the 4-to-1 column mux.
T4R_COL_READ_NS = 9.9
T4R_COL_WRITE_NS = 8.04
T4R_TRANSPOSED_CLOCK_NS = 1.2
COL_MUX_FACTOR = 4
#: Decoded baselines behind the published "26.0x / 19.5x less" (Sec 4.4.1):
#: column read on 1RW needs precharge+read = 2 cycles per row access
#: (2*128*1.007 ns = 257.8 ns -> 257.8/9.9 = 26.0x) and column write needs one
#: write per row at the 1RW write time of 1.226 ns (Fig 6-derived;
#: 128*1.226 = 157.0 ns -> 157.0/8.04 = 19.5x).
T1RW_COL_READ_NS = 257.8
T_WRITE_1RW_NS = 1.226
T1RW_COL_WRITE_NS = 128 * T_WRITE_1RW_NS

#: Sec 4.1 / Table 1 — supply / precharge voltages (V).
VDD = 0.700
VPRECH = 0.500

#: Sec 4.2 — selecting Vprech=500mV saves >=43% read energy vs 700mV at the
#: cost of <=19% higher access time (all port counts).
VPRECH_ENERGY_SAVING = 0.43
VPRECH_TIME_PENALTY = 0.19

#: Table 3 — published system-level results for the 1RW+4R configuration.
PAPER_THROUGHPUT_INF_S = 44e6
PAPER_ENERGY_PJ_PER_INF = 607.0
PAPER_POWER_MW = 29.0
PAPER_CLOCK_MHZ = 810.0
PAPER_ACCURACY = 0.9764
PAPER_NEURONS = 778
PAPER_SYNAPSES = 330_000  # ~768*256 + 256*256*2 + 256*10 = 328,192

#: Abstract / Fig 8 — headline ratios vs the 1RW baseline (128x128 array).
PAPER_SPEEDUP_4R = 3.1
PAPER_ENERGY_EFF_4R = 2.2

#: Network topology of the paper's MNIST system (Sec 4.4.2).
PAPER_TOPOLOGY = (768, 256, 256, 256, 10)

#: SRAM array size limit (Sec 4.1, NBL-assist V_WD >= -400 mV yield rule).
MAX_ARRAY_ROWS = 128
MAX_ARRAY_COLS = 128

# ----------------------------------------------------------------------------
# Derived / calibrated constants
# ----------------------------------------------------------------------------
# Anchor: 1RW transposed-port average read+write energy per row access
#   157 pJ / 256 accesses = 0.613 pJ.  Fig 6 shows write cost > read cost; we
#   split 0.613 into read 0.48 / write 0.75 (pJ) keeping the published mean.
E_READ_1RW_PJ = 0.48
E_WRITE_1RW_PJ = 0.75

#: Decoupled single-ended read ports run at Vprech=500mV -> >=43% lower energy
#: (Sec 4.2).  Fig 7: average per-access energy is roughly flat for 1..3 ports
#: and rises at the 4th (bigger cell -> more BL parasitics).  Per-read-access
#: energy (pJ) for p = 1..4 decoupled ports:
E_READ_PORT_PJ = (0.285, 0.272, 0.268, 0.292)

#: Write energy via the transposed port grows with ports (Fig 6: parasitics +
#: lower V_WD).  pJ per cell-column write access, p = 0..4:
E_WRITE_PORT_PJ = (0.75, 0.95, 1.10, 1.22, 1.35)

#: Transposed-port read energy also grows with added ports (narrower, more
#: resistive WL; Fig 6).  pJ per row/column read access, p = 0..4:
E_TREAD_PORT_PJ = (0.48, 0.60, 0.68, 0.74, 0.80)

#: Periphery energy per *active* clock cycle, calibrated so the 4R system hits
#: the published 607 pJ/Inf & 29 mW envelope (V2) while the same constants
#: reproduce the 3.1x / 2.2x ratios (V1).  Split per subcomponent:
E_ARBITER_PJ_PER_CYCLE_128 = 0.20    # one 128-wide arbiter slice, any p (Sec 3.3)
E_NEURON_ACCUM_PJ = 0.003            # one neuron accumulating one cycle
E_NEURON_FIRE_PJ = 0.030             # threshold compare + Vmem reset + handshake
E_TILE_CLOCKTREE_PJ_PER_CYCLE = 0.25 # clock/control per 128x128 array per cycle

#: Static (leakage) power of the full MNIST system, mW.  3nm design at 700 mV;
#: calibrated to close the (power - dynamic) gap at the published operating point.
STATIC_POWER_MW = 1.5

#: Fraction of a 6T 128x128 array's area taken by periphery (arbiter incl. its
#: +8% tree overhead, sense amps, neuron array, control).  Calibrated so the
#: system-level area ratio 4R/1RW equals the published 2.4x (Sec 4.4.2) given
#: the 2.625x cell-area ratio: (2.625+q)/(1+q) = 2.4  ->  q = 0.1607.
PERIPHERY_AREA_FRACTION = 0.1607

#: Reference activity profile used for the paper-comparison benchmarks: spikes
#: per 128-row group for each tile of the 768:256:256:256:10 network.  L1 input
#: activity 53% (=68/128), hidden-layer activity 50% (=64/128) — chosen once so
#: the 1RW+4R system lands on the published V2 operating point; the SAME profile
#: must then reproduce V1's 3.1x/2.2x and the Fig-8 trends with no further
#: freedom (checked in tests/benchmarks).  Benchmarks also report the measured
#: profile from the trained BNN side by side.
REF_SPIKES_PER_GROUP = (68, 64, 64, 64)


@dataclasses.dataclass(frozen=True)
class CellSpec:
    """Electrical/timing spec of one SRAM cell option."""

    name: str
    read_ports: int            # decoupled inference read ports (0 => use RW port)
    clock_ns: float            # system clock period (max of Table 2 stages)
    arbiter_ns: float
    sram_neuron_ns: float
    area_ratio: float
    e_read_pj: float           # energy of one inference row-read access
    e_write_pj: float          # transposed-port write access energy
    e_tread_pj: float          # transposed-port read access energy

    @property
    def ports(self) -> int:
        """Usable parallel inference ports (the 1RW cell reads via its RW port)."""
        return max(1, self.read_ports)

    @property
    def clock_hz(self) -> float:
        return 1e9 / self.clock_ns


def cell_spec(read_ports: int) -> CellSpec:
    """Return the spec for the cell with ``read_ports`` decoupled ports (0..4)."""
    if not 0 <= read_ports <= 4:
        raise ValueError(f"read_ports must be in 0..4, got {read_ports}")
    p = read_ports
    return CellSpec(
        name="1RW" if p == 0 else f"1RW+{p}R",
        read_ports=p,
        clock_ns=max(ARBITER_STAGE_NS[p], SRAM_NEURON_STAGE_NS[p]),
        arbiter_ns=ARBITER_STAGE_NS[p],
        sram_neuron_ns=SRAM_NEURON_STAGE_NS[p],
        area_ratio=CELL_AREA_RATIO[p],
        e_read_pj=E_READ_1RW_PJ if p == 0 else E_READ_PORT_PJ[p - 1],
        e_write_pj=E_WRITE_PORT_PJ[p],
        e_tread_pj=E_TREAD_PORT_PJ[p],
    )


ALL_CELLS = tuple(cell_spec(p) for p in range(5))


def array_area_um2(read_ports: int, rows: int = 128, cols: int = 128) -> float:
    """Cell-array area (um^2) for one SRAM array."""
    return CELL_AREA_6T_UM2 * CELL_AREA_RATIO[read_ports] * rows * cols


def tile_geometry(n_in: int, n_out: int) -> tuple[int, int]:
    """(row groups, column groups) of 128x128 arrays for an n_in x n_out tile."""
    return -(-n_in // MAX_ARRAY_ROWS), -(-n_out // MAX_ARRAY_COLS)


def spare_column_area_um2(
    topology: Sequence[int], spare_cols: int, read_ports: int
) -> float:
    """Area overhead (um^2) of ``spare_cols`` redundant columns per tile.

    Each spare column spans every 128-row group of its tile, at the chosen
    cell option's area ratio.  Only cell area is charged — a column remap is
    a build-time address swizzle, so the arbiter/neuron periphery is
    unchanged.
    """
    area = 0.0
    per_cell = CELL_AREA_6T_UM2 * CELL_AREA_RATIO[read_ports]
    for t in range(len(topology) - 1):
        n_groups, _ = tile_geometry(topology[t], topology[t + 1])
        area += n_groups * MAX_ARRAY_ROWS * spare_cols * per_cell
    return area


def column_update_cycles(read_ports: int, rows: int = 128) -> tuple[int, int]:
    """(read_cycles, write_cycles) to read+write one weight column.

    Without transposable multiport cells (the paper's 1RW baseline) updating
    the synapses of one post-synaptic neuron touches every row: ``rows``
    reads + ``rows`` writes.  With the transposed column port the column is
    accessed through a ``COL_MUX_FACTOR``-to-1 mux: ``COL_MUX_FACTOR``
    cycles each way (Sec 4.4.1).
    """
    if read_ports == 0:
        return rows, rows
    return COL_MUX_FACTOR, COL_MUX_FACTOR


@dataclasses.dataclass(frozen=True)
class RequestStats:
    """Per-request hardware cost of a batch of inferences (paper units).

    Every field is a numpy array with leading batch axis B; the system-level
    aggregates in ``network.system_stats`` are means over these, so a serving
    plane can report the same paper-unit telemetry per request.
    """

    read_ports: int
    cycles_per_tile: np.ndarray   # float64[B, T] — drain cycles + 1 fire cycle
    cycles: np.ndarray            # float64[B] — sum over tiles (pipeline latency)
    latency_ns: np.ndarray        # float64[B]
    energy_pj: np.ndarray         # float64[B]


def request_stats(
    topology: Sequence[int],
    spikes_per_group: Sequence[np.ndarray] | Sequence[Sequence[float]],
    read_ports: int,
) -> RequestStats:
    """Per-sample hardware cost from measured arbiter loads.

    Args:
      topology: e.g. (768, 256, 256, 256, 10).
      spikes_per_group: per tile, array[..., n_groups] of arbiter loads for a
        batch of requests (the measured activity of each 128-row group).
      read_ports: 0 (=1RW baseline) .. 4.

    The float64 host form of the formulas; ``request_stats_device`` is the
    same arithmetic in float32 on the device, which ``serve.SpikeEngine``
    attaches to every served request.
    """
    spec = cell_spec(read_ports)
    p = spec.ports
    n_tiles = len(topology) - 1

    cycles_pt, energy = [], None
    for t in range(n_tiles):
        n_in, n_out = topology[t], topology[t + 1]
        n_groups, n_colgroups = tile_geometry(n_in, n_out)
        loads = np.asarray(spikes_per_group[t], dtype=np.float64)
        loads = loads.reshape(-1, n_groups)              # [B, groups]
        drain = np.ceil(loads / p)                       # cycles per group
        tile_cycles = drain.max(axis=1) + 1.0            # +1: compare/fire cycle
        cycles_pt.append(tile_cycles)

        reads = loads.sum(axis=1) * n_colgroups          # row-read accesses
        e = reads * spec.e_read_pj
        e += tile_cycles * n_groups * E_ARBITER_PJ_PER_CYCLE_128
        e += tile_cycles * n_out * E_NEURON_ACCUM_PJ
        e += n_out * E_NEURON_FIRE_PJ
        e += tile_cycles * n_groups * n_colgroups * E_TILE_CLOCKTREE_PJ_PER_CYCLE
        energy = e if energy is None else energy + e

    cycles_per_tile = np.stack(cycles_pt, axis=1)        # [B, T]
    cycles = cycles_per_tile.sum(axis=1)
    return RequestStats(
        read_ports=read_ports,
        cycles_per_tile=cycles_per_tile,
        cycles=cycles,
        latency_ns=cycles * spec.clock_ns,
        energy_pj=energy,
    )


def request_stats_device(
    topology: Sequence[int],
    loads: Sequence[torch.Tensor],   # per tile, int32[..., n_groups]
    read_ports: int,
) -> dict:
    """``request_stats`` in float32 on the loads' device.

    Same formulas and the same order of float32 operations as the
    reference's ``request_stats_device``, so a serving loop keeps its
    telemetry on the device and pays one host transfer per drain.  Cycle
    counts are small integers and stay exact; energies agree with the
    float64 numpy accounting to float32 rounding (~1e-7 relative).  CUDA
    loads go to the ``request_stats`` kernel (one launch,
    ``kernels/telemetry``), CPU loads to its plain version
    (``request_stats_ref``); the two agree bit for bit.

    Returns {"cycles_per_tile": f32[B, T], "cycles": f32[B],
    "latency_ns": f32[B], "energy_pj": f32[B]}.
    """
    from repro_torch.kernels.telemetry import ops as tele

    if all(ld.device.type == "cpu" for ld in loads):
        return tele.request_stats_ref(topology, loads, read_ports)
    slab = tele.request_stats(loads, topology, read_ports)
    return tele.split_stats(slab, len(topology) - 1, temporal=False)


def temporal_request_stats(
    topology: Sequence[int],
    loads: Sequence[np.ndarray],   # per tile, int[B, T, n_groups] per-step loads
    read_ports: int,
) -> dict:
    """Per-request hardware cost of an *event stream* (numpy, float64).

    Every timestep is one full drain of the paper's pipeline — the arbiter
    schedules that step's events, neurons accumulate, R_empty fires — so the
    per-step cost is :func:`request_stats` on that step's measured loads,
    and a stream's cost is the sum over its T steps.

    Returns {"cycles_per_tile": f64[B, n_tiles] (summed over steps),
    "cycles": f64[B], "latency_ns": f64[B], "energy_pj": f64[B],
    "energy_pj_per_step": f64[B], "n_steps": T}.
    """
    b, t = np.asarray(loads[0]).shape[:2]
    flat = [np.asarray(ld, np.float64).reshape(b * t, -1) for ld in loads]
    rs = request_stats(topology, flat, read_ports)
    n_tiles = len(topology) - 1
    cycles_per_tile = rs.cycles_per_tile.reshape(b, t, n_tiles).sum(axis=1)
    cycles = rs.cycles.reshape(b, t).sum(axis=1)
    energy = rs.energy_pj.reshape(b, t).sum(axis=1)
    return {
        "cycles_per_tile": cycles_per_tile,
        "cycles": cycles,
        "latency_ns": cycles * cell_spec(read_ports).clock_ns,
        "energy_pj": energy,
        "energy_pj_per_step": energy / t,
        "n_steps": t,
    }


def temporal_request_stats_device(
    topology: Sequence[int],
    loads: Sequence[torch.Tensor],   # per tile, int32[B, T, n_groups]
    read_ports: int,
) -> dict:
    """:func:`temporal_request_stats` in float32 on the loads' device: the
    per-step accounting of :func:`request_stats_device`, each stream's steps
    added one after another, and the energy a step as the energy times the
    float32 reciprocal of T.  Cycle counts stay exact; energies agree with
    the float64 numpy accounting to float32 rounding (the reference's jitted
    twin sums and divides in its own order, so the two packages agree to
    ~1e-7 relative, not bit for bit).  CUDA loads go to the
    ``request_stats`` kernel, CPU loads to ``temporal_request_stats_ref``;
    the two agree bit for bit."""
    from repro_torch.kernels.telemetry import ops as tele

    if all(ld.device.type == "cpu" for ld in loads):
        return tele.temporal_request_stats_ref(topology, loads, read_ports)
    slab = tele.request_stats(loads, topology, read_ports, temporal=True)
    return {**tele.split_stats(slab, len(topology) - 1, temporal=True),
            "n_steps": int(loads[0].shape[1])}


# ----------------------------------------------------------------------------
# H100 MAC datapath roofline inputs (framework plane, not paper units)
# ----------------------------------------------------------------------------
# The card's published rates live in ``core/h100.py``, which chip_smoke.py's
# kernel bounds read as well.

MAC_DATAPATHS = ("dense_mxu", "packed_mxu", "popcount_vpu")


def mac_datapath_stats(batch: int, n_in: int, n_out: int,
                       datapath: str) -> dict:
    """Compute/byte roofline inputs for one tile MAC, per datapath, on the
    H100.

    The datapath keys and every count are the reference's
    (``repro.core.esam.cost_model.mac_datapath_stats``); the units and rates
    are the card's:

    ``dense_mxu``    int8 spikes from memory and the ±1 MAC, ``2 * macs``
                     operations on the int8 tensor cores (``tensor_core``).
    ``packed_mxu``   uint32 spike words from memory, unpacked (shift, mask,
                     cast per spike bit), then the same MAC
                     (``tensor_core+unpack``).
    ``popcount_vpu`` both operands stay 32-bit words: per (sample, neuron,
                     word) an AND, a popcount and an add, plus a row
                     popcount (``compute_ops``); the popc unit bounds it, so
                     the time counts the popcounts alone (``unit_ops``)
                     against 16 a clock per SM, 4.18e12/s (``popc``).

    The bound is the larger of ``hbm_bytes`` over 3.35 TB/s and
    ``unit_ops`` over the unit's rate.
    """
    if datapath not in MAC_DATAPATHS:
        raise ValueError(f"unknown datapath {datapath!r} (one of "
                         f"{MAC_DATAPATHS})")
    macs = batch * n_in * n_out
    out_bytes = batch * n_out * 4                     # int32 V_mem
    kw = -(-n_in // 32)
    if datapath == "dense_mxu":
        spike_bytes = batch * n_in                    # int8 wire
        weight_bytes = n_in * n_out                   # int8 stored bits
        compute_ops = unit_ops = 2 * macs
        rate, unit = h100.INT8_OPS_PER_S, "tensor_core"
    elif datapath == "packed_mxu":
        spike_bytes = batch * kw * 4
        weight_bytes = n_in * n_out
        # unpack tax: shift+mask+cast per spike bit, then the MAC
        compute_ops = unit_ops = 2 * macs + 3 * batch * n_in
        rate, unit = h100.INT8_OPS_PER_S, "tensor_core+unpack"
    else:  # popcount_vpu
        spike_bytes = batch * kw * 4
        weight_bytes = n_out * kw * 4                 # uint32 weight planes
        # AND + popcount + add per (sample, neuron, lane word) + row offset
        compute_ops = 3 * batch * n_out * kw + batch * kw
        unit_ops = batch * n_out * kw + batch * kw    # the popcounts
        rate, unit = h100.popc_ops_per_s(), "popc"
    hbm_bytes = spike_bytes + weight_bytes + out_bytes
    t_compute = unit_ops / rate
    t_hbm = hbm_bytes / h100.HBM_BYTES_PER_S
    return {
        "datapath": datapath,
        "unit": unit,
        "macs": macs,
        "compute_ops": compute_ops,
        "unit_ops": unit_ops,
        "spike_bytes": spike_bytes,
        "weight_bytes": weight_bytes,
        "hbm_bytes": hbm_bytes,
        "intensity_ops_per_byte": compute_ops / hbm_bytes,
        "t_compute_us": t_compute * 1e6,
        "t_hbm_us": t_hbm * 1e6,
        "t_roofline_us": max(t_compute, t_hbm) * 1e6,
        "bound": "compute" if t_compute >= t_hbm else "hbm",
    }
