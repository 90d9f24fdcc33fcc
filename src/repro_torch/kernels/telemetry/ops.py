"""Wrappers of the round-telemetry kernels, dispatched by device.

``tile_loads`` gives every tile input plane of a round its arbiter loads
in one launch; ``request_stats`` runs the cost model of every request of a
round in one launch and writes one float32 slab a round (the logits
first, when given: ``ref.stats_columns``).  They are the port's form of
what XLA fuses in the reference (the plan's ``group_popcount`` and the
engine's ``_stats_jit``); no Pallas kernel stands behind them.

CPU tensors run the plain versions in ``ref.py``; CUDA tensors launch
``csrc/telemetry.cu`` (built by ``kernels/_build.py`` at first use) or the
call raises.  Launches are counted (:func:`launch_counts`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.esam import cost_model as cm
from repro_torch.kernels import _build
from repro_torch.kernels.common import check_cuda_operands, on_cpu, stream_ptr
from repro_torch.kernels.telemetry.ref import (  # noqa: F401  (re-export)
    request_stats_ref,
    stats_columns,
    stats_slab_ref,
    step_reciprocal,
    temporal_request_stats_ref,
    tile_constants,
    tile_loads_ref,
)

__all__ = ["tile_loads", "request_stats", "stats_columns", "launch_counts",
           "reset_launch_counts", "tile_loads_ref", "request_stats_ref",
           "temporal_request_stats_ref"]

#: kernel launches since the last reset
_LAUNCHES = {"tile_loads": 0, "request_stats": 0}

#: planes a tile_loads launch and tiles a request_stats launch take
#: (the kernel's kMaxPlanes / kMaxTiles)
MAX_PLANES = MAX_TILES = 16
#: threads a block (kThreads)
_THREADS = 256
#: shared memory a request_stats block may take without opting in
_SMEM = 48 * 1024


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_float)
    pp = ctypes.POINTER(ctypes.c_void_p)
    lib.telemetry_tile_loads.argtypes = [pp, pp, ctypes.POINTER(i64), i32, vp]
    lib.telemetry_tile_loads.restype = i32
    lib.telemetry_request_stats.argtypes = (
        [pp, ctypes.POINTER(i64), ctypes.POINTER(i64), ctypes.POINTER(i32)]
        + [ctypes.POINTER(f32)] * 5
        + [i32, vp, i64, i32, vp, i32, i32, i32, i32, f32, f32, f32, i32,
           i32, vp])
    lib.telemetry_request_stats.restype = i32


def _library() -> _build.KernelLibrary:
    return _build.load_library("telemetry", _declare)


def _check_planes(planes) -> tuple:
    planes = tuple(planes)
    for i, p in enumerate(planes):
        if p.dtype != torch.int32:
            raise TypeError(f"planes[{i}] must be int32 words, got {p.dtype}")
        if p.dim() < 1 or p.shape[-1] % 4:
            raise ValueError(f"planes[{i}] {tuple(p.shape)}: the words do "
                             "not split into 128-bit row groups")
    return planes


def tile_loads(planes: Sequence[torch.Tensor]) -> tuple:
    """Per plane int32 words ``[..., W]`` (W a multiple of 4), the int32
    arbiter loads ``[..., W/4]``: on the card one launch for up to
    ``MAX_PLANES`` planes (contiguous planes are read in place; others are
    copied first), on the CPU ``tile_loads_ref``."""
    planes = _check_planes(planes)
    if not planes:
        return ()
    if on_cpu(*planes):
        return tile_loads_ref(planes)
    dev = check_cuda_operands({f"planes[{i}]": p for i, p in enumerate(planes)})
    planes = tuple(p.contiguous() for p in planes)
    counts = [p.numel() // 4 for p in planes]
    buf = torch.empty((sum(counts),), dtype=torch.int32, device=dev)
    outs, off = [], 0
    for p, n in zip(planes, counts):
        outs.append(buf[off: off + n].view(p.shape[:-1] + (p.shape[-1] // 4,)))
        off += n
    kl = _library()
    ptrs = ctypes.c_void_p * MAX_PLANES
    with torch.cuda.device(dev):
        for c0 in range(0, len(planes), MAX_PLANES):
            chunk = range(c0, min(c0 + MAX_PLANES, len(planes)))
            if not any(counts[i] for i in chunk):
                continue
            err = kl.lib.telemetry_tile_loads(
                ptrs(*(planes[i].data_ptr() for i in chunk)),
                ptrs(*(outs[i].data_ptr() for i in chunk)),
                (ctypes.c_longlong * MAX_PLANES)(*(counts[i] for i in chunk)),
                len(chunk), stream_ptr(dev))
            _build.check(kl, err, "tile_loads launch")
            _LAUNCHES["tile_loads"] += 1
    return tuple(outs)


def _f32(x: float) -> float:
    """``x`` rounded to float32 (as torch rounds a Python scalar operand of
    a float32 tensor), as a Python float ctypes passes on exactly."""
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class _StatsOperands:
    """The launcher's per-tile constants for one (topology, cell option),
    as ctypes arrays, each float rounded to float32 (``_f32``)."""

    groups: ctypes.Array
    colgroups: ctypes.Array
    arbiter: ctypes.Array
    accum: ctypes.Array
    fire: ctypes.Array
    clocktree: ctypes.Array
    ports: int
    e_read: float
    clock_ns: float


@functools.lru_cache(maxsize=None)
def _stats_operands(topology: tuple, read_ports: int) -> _StatsOperands:
    consts = tile_constants(topology, read_ports)
    n = len(consts)
    spec = cm.cell_spec(read_ports)

    def f32(key):
        return (ctypes.c_float * n)(*(_f32(k[key]) for k in consts))

    return _StatsOperands(
        groups=(ctypes.c_int * n)(*(k["groups"] for k in consts)),
        colgroups=f32("colgroups"), arbiter=f32("arbiter"),
        accum=f32("accum"), fire=f32("fire"), clocktree=f32("clocktree"),
        ports=spec.ports, e_read=_f32(spec.e_read_pj),
        clock_ns=_f32(spec.clock_ns))


def _stats_rows(T: int, n_tiles: int) -> int:
    """Requests a request_stats block: ~one (request, step) a thread."""
    rows = max(1, _THREADS // max(T, 1))
    if 4 * (T + n_tiles) > _SMEM:
        raise ValueError(f"T={T} does not fit one block's shared memory")
    return rows


def request_stats(loads: Sequence[torch.Tensor], topology: Sequence[int],
                  read_ports: int, *, temporal: bool = False,
                  logits: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One round's cost model as a float32 slab ``[B, C]`` laid out by
    ``stats_columns(n_tiles, n_cls, temporal)``: the logits (when given),
    then each request's cycles per tile, cycles, latency and energy, and,
    for event streams (``temporal``, loads ``[B, T, groups]``), energy a
    step.  Bit for bit :func:`request_stats_ref` /
    :func:`temporal_request_stats_ref` on the same device.  On the card:
    one launch."""
    topology = tuple(topology)
    n_tiles = len(topology) - 1
    loads = tuple(loads)
    if len(loads) != n_tiles:
        raise ValueError(f"{len(loads)} load tensors for {n_tiles} tiles")
    if on_cpu(*loads, *(() if logits is None else (logits,))):
        rs = (temporal_request_stats_ref if temporal else request_stats_ref)(
            topology, loads, read_ports)
        return stats_slab_ref(rs, n_tiles, temporal, logits)
    if n_tiles > MAX_TILES:
        raise ValueError(f"{n_tiles} tiles; the card's kernel takes up to "
                         f"{MAX_TILES}")
    operands = {f"loads[{i}]": ld for i, ld in enumerate(loads)}
    if logits is not None:
        operands["logits"] = logits
    dev = check_cuda_operands(operands)
    k = _stats_operands(topology, read_ports)
    shaped = []
    for i, (ld, g) in enumerate(zip(loads, k.groups)):
        if ld.dtype != torch.int32:
            raise TypeError(f"loads[{i}] must be int32 on the card, got "
                            f"{ld.dtype}")
        ld = ld.reshape(ld.shape[0], -1, g) if temporal else (
            ld.reshape(-1, 1, g))
        if ld.stride(-1) != 1:
            ld = ld.contiguous()
        shaped.append(ld)
    B, T = shaped[0].shape[:2]
    for i, ld in enumerate(shaped):
        if tuple(ld.shape[:2]) != (B, T):
            raise ValueError(f"loads[{i}] {tuple(loads[i].shape)} for "
                             f"{B} requests of {T} steps")
    n_cls = 0
    if logits is not None:
        if (logits.dtype != torch.float32 or logits.dim() != 2
                or logits.shape[0] != B or logits.stride(1) != 1):
            raise ValueError(f"logits must be float32 [{B}, n_cls] with "
                             f"contiguous rows, got {logits.dtype}"
                             f"{list(logits.shape)}")
        n_cls = logits.shape[1]
    cols = stats_columns(n_tiles, n_cls, temporal)
    out = torch.empty((B, cols["width"]), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    rows = _stats_rows(T, n_tiles)
    i64s = ctypes.c_longlong * n_tiles
    kl = _library()
    with torch.cuda.device(dev):
        err = kl.lib.telemetry_request_stats(
            (ctypes.c_void_p * n_tiles)(*(ld.data_ptr() for ld in shaped)),
            i64s(*(ld.stride(0) for ld in shaped)),
            i64s(*(ld.stride(1) for ld in shaped)), k.groups, k.colgroups,
            k.arbiter, k.accum, k.fire, k.clocktree, n_tiles,
            None if logits is None else logits.data_ptr(),
            0 if logits is None else logits.stride(0), n_cls,
            out.data_ptr(), cols["width"], B, T, k.ports, k.e_read,
            k.clock_ns, step_reciprocal(T) if T else 0.0, int(temporal),
            rows, stream_ptr(dev))
    _build.check(kl, err, "request_stats launch")
    _LAUNCHES["request_stats"] += 1
    return out


def split_stats(slab: torch.Tensor, n_tiles: int, temporal: bool,
                n_cls: int = 0) -> dict:
    """The cost model's dict (``cost_model.request_stats_device``'s keys)
    as views of a slab."""
    cols = stats_columns(n_tiles, n_cls, temporal)
    out = {"cycles_per_tile": slab[:, cols["cycles_per_tile"]]}
    for key in ("cycles", "latency_ns", "energy_pj") + (
            ("energy_pj_per_step",) if temporal else ()):
        out[key] = slab[:, cols[key].start]
    return out
