"""Wrappers of the LIF-step kernels, dispatched by device.

``temporal_scan`` is what the temporal plane (``core.esam.temporal``)
calls once per event round: every hidden tile's LIF step, spike re-pack and
next-tile MAC, and the readout's leak, for all T steps, at any hidden width
and depth.  ``lif_step`` is one step of one tile, the counterpart of the
reference's ``lif_step`` op.  CPU tensors run the plain versions in
``ref.py``; CUDA tensors launch ``csrc/lif_step.cu`` (built by
``kernels/_build.py`` at first use) or the call raises.  Launches are
counted (:func:`launch_counts`).

The scan takes one of four routes, picked by shape (:func:`_scan_route`),
never on a failure: ``regs`` (``scan_regs_kernel``: a cluster of one CTA a
hidden tile, and one for the readout, pipelines ``SCAN_ROWS`` streams on
the b1 tensor-core product, membranes and planes in registers, up to 4
hidden tiles of up to 256 neurons or 2 of up to 512, ``_REG_ROUTES``),
then the one-block-a-stream kernel with planes and state in shared memory
(``smem``), planes read from device memory (``planes_global``) or the
state in a device scratch too (``state_global``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.core.packing import packed_width
from repro_torch.kernels import _build
from repro_torch.kernels.cim_popcount.ops import cim_popcount_matmul
from repro_torch.kernels.common import (
    check_cuda_operands,
    on_cpu,
    sm_count,
    stream_ptr,
)
from repro_torch.kernels.lif_step.ref import (  # noqa: F401  (re-export)
    RESET_MODES,
    decay_of,
    lif_step_ref,
    temporal_scan_ref,
)

__all__ = [
    "RESET_MODES",
    "lif_step",
    "lif_step_ref",
    "temporal_scan",
    "temporal_scan_ref",
    "launch_counts",
    "reset_launch_counts",
]

#: kernel launches since the last reset
_LAUNCHES = {"lif_step": 0, "temporal_scan": 0}

#: hidden tiles one ``temporal_scan`` launch takes (``kMaxHidden``); a
#: deeper stack runs as consecutive launches
SCAN_MAX_HIDDEN = 32
#: spikes per row group of the arbiter loads (``packing.group_popcount``)
_ROW_GROUP = 128

#: resident blocks per SM the grid-stride launch asks for at most
_BLOCKS_PER_SM = 8
#: the register route's geometry (``kScanWarps``, ``kScanRows``): compute
#: warps a CTA (a tile) and streams a cluster, the rows 8-15 of the b1
#: product zero: twice the clusters of 16 streams, and faster than 16
#: streams or 4 warps at every event-path T (PERF.md,
#: probes/scan_link_probe.py)
SCAN_WARPS = 8
SCAN_ROWS = 8
#: (hidden tiles, K steps of 256 bits) the register route is instantiated
#: for (``dispatch_regs``): widths up to 256 at any depth, 512 at up to two
#: tiles; past that a thread's membranes, refractory counters, thresholds
#: and planes no longer fit its registers (a tile of 1024 spills)
_REG_ROUTES = frozenset({(1, 1), (2, 1), (3, 1), (4, 1), (1, 2), (2, 2)})


class ScanRoute(NamedTuple):
    """How one ``temporal_scan`` launch runs: ``name`` (``regs``, ``smem``,
    ``planes_global``, ``state_global``), the shared-memory route's flags
    and bytes a block, and the register route's K steps a MAC (0 on the
    other routes)."""
    name: str
    planes_smem: int = 0
    state_smem: int = 0
    smem_bytes: int = 0
    steps: int = 0


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.lif_step.argtypes = [vp, vp, vp, vp, vp, vp, vp, i32, i32, f, i32,
                             i32, i32, vp]
    lib.lif_step.restype = i32
    ip = ctypes.POINTER(ctypes.c_int)
    lib.temporal_scan.argtypes = [vp, i32, i32, i32, ip, i32, vp, vp, vp, vp,
                                  vp, vp, f, i32, i32, i32, i32, vp]
    lib.temporal_scan.restype = i32
    lib.temporal_scan_regs.argtypes = [vp, i32, i32, i32, ip, i32, vp, vp,
                                       vp, vp, vp, f, i32, i32, i32, vp]
    lib.temporal_scan_regs.restype = i32
    lib.temporal_scan_smem_bytes.argtypes = [i32, ip, i32, i32, i32]
    lib.temporal_scan_smem_bytes.restype = ctypes.c_longlong
    lib.temporal_scan_smem_optin.argtypes = [i32]
    lib.temporal_scan_smem_optin.restype = i32


def _library() -> _build.KernelLibrary:
    return _build.load_library("lif_step", _declare)


def _check(vmem, contrib, vth, refrac) -> tuple[int, int]:
    if vmem.dim() != 2:
        raise ValueError(f"vmem must be [B, N], got {tuple(vmem.shape)}")
    B, N = vmem.shape
    for name, t, shape, dtype in (
            ("vmem", vmem, (B, N), torch.float32),
            ("contrib", contrib, (B, N), torch.int32),
            ("vth", vth, (N,), torch.int32),
            ("refrac", refrac, (B, N), torch.int32)):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}{list(shape)}, got "
                             f"{t.dtype}{list(t.shape)}")
    return B, N


def lif_step(
    vmem: torch.Tensor,       # float32[B, N]
    contrib: torch.Tensor,    # int32[B, N]
    vth: torch.Tensor,        # int32[N]
    refrac: torch.Tensor,     # int32[B, N]
    *,
    leak: float = 0.0,
    reset: str = "zero",
    refractory: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One leak-integrate-fire-reset step (see ``ref.lif_step_ref``).

    Returns (spikes int8[B, N], vmem' float32[B, N], refrac' int32[B, N]),
    new tensors on the operands' device.
    """
    if reset not in RESET_MODES:
        raise ValueError(f"reset {reset!r} not in {RESET_MODES}")
    if refractory < 0:
        raise ValueError(f"refractory must be >= 0, got {refractory}")
    B, N = _check(vmem, contrib, vth, refrac)
    if on_cpu(vmem, contrib, vth, refrac):
        return lif_step_ref(vmem, contrib, vth, refrac, leak=leak,
                            reset=reset, refractory=refractory)
    dev = check_cuda_operands({"vmem": vmem, "contrib": contrib, "vth": vth,
                               "refrac": refrac})
    vmem, contrib, vth, refrac = (
        t.contiguous() for t in (vmem, contrib, vth, refrac))
    spikes = torch.empty((B, N), dtype=torch.int8, device=dev)
    vmem_out = torch.empty((B, N), dtype=torch.float32, device=dev)
    refrac_out = torch.empty((B, N), dtype=torch.int32, device=dev)
    if B == 0 or N == 0:
        return spikes, vmem_out, refrac_out
    kl = _library()
    with torch.cuda.device(dev):
        err = kl.lib.lif_step(
            vmem.data_ptr(), contrib.data_ptr(), vth.data_ptr(),
            refrac.data_ptr(), spikes.data_ptr(), vmem_out.data_ptr(),
            refrac_out.data_ptr(), B, N, decay_of(leak),
            int(reset == "subtract"), refractory,
            _BLOCKS_PER_SM * sm_count(dev.index), stream_ptr(dev))
    _build.check(kl, err, "lif_step launch")
    _LAUNCHES["lif_step"] += 1
    return spikes, vmem_out, refrac_out


def _check_scan(c_in, planes, vth, telemetry) -> None:
    """Raises on a type, shape or width the scan does not take."""
    if c_in.dim() != 3 or c_in.dtype != torch.int32:
        raise ValueError(f"c_in must be int32[T, B, N], got "
                         f"{c_in.dtype}{list(c_in.shape)}")
    if c_in.shape[0] < 1:
        raise ValueError("c_in holds no step")
    if len(planes) != len(vth):
        raise ValueError(f"{len(planes)} plane tensors for {len(vth)} "
                         "hidden thresholds")
    for i, th in enumerate(vth):
        if th.dim() != 1 or th.dtype != torch.int32 or not th.shape[0]:
            raise ValueError(f"vth[{i}] must be int32[N] with N >= 1, got "
                             f"{th.dtype}{list(th.shape)}")
    hidden = [int(th.shape[0]) for th in vth]
    n_cls = int(planes[-1].shape[0]) if planes else int(c_in.shape[-1])
    if hidden and c_in.shape[-1] != hidden[0]:
        raise ValueError(f"c_in holds {c_in.shape[-1]} neurons, the first "
                         f"hidden tile {hidden[0]}")
    for i, w in enumerate(planes):
        n = hidden[i]
        n_next = hidden[i + 1] if i + 1 < len(hidden) else n_cls
        want = (n_next, packed_width(n))
        if tuple(w.shape) != want or w.dtype != torch.int32:
            raise ValueError(f"planes[{i}] must be int32{list(want)}, got "
                             f"{w.dtype}{list(w.shape)}")
        if telemetry and n % _ROW_GROUP:
            raise ValueError(f"telemetry needs hidden widths in "
                             f"{_ROW_GROUP}-spike row groups, got {n}")


def _regs_route(hidden: tuple, n_cls: int) -> ScanRoute | None:
    """The register route, or None where the depth, the widths or the
    readout are past what it is instantiated for, or the first width is
    not a multiple of 4 (pure)."""
    steps = -(-max(hidden, default=0) // 256)   # K steps of 256 bits
    # tile 0's c_in rows come in one bulk copy a step: whole 16-byte rows
    if (not hidden or (len(hidden), steps) not in _REG_ROUTES
            or hidden[0] % 4 or not 1 <= n_cls <= 8 * SCAN_WARPS):
        return None
    return ScanRoute("regs", steps=steps)


@functools.lru_cache(maxsize=None)
def _scan_route(device_index: int, hidden: tuple, n_cls: int) -> ScanRoute:
    """The route one launch takes: the register route where it is
    instantiated for the shape, else the first of the shared-memory
    kernel's routes whose block fits the card's opt-in shared memory (the
    planes leave it first, then the state)."""
    regs = _regs_route(hidden, n_cls)
    if regs is not None:
        return regs
    kl = _library()
    arr = (ctypes.c_int * max(1, len(hidden)))(*hidden)
    limit = kl.lib.temporal_scan_smem_optin(device_index)
    for name, planes_smem, state_smem in (("smem", 1, 1),
                                          ("planes_global", 0, 1),
                                          ("state_global", 0, 0)):
        need = kl.lib.temporal_scan_smem_bytes(len(hidden), arr, n_cls,
                                               planes_smem, state_smem)
        if 0 <= need <= limit:
            return ScanRoute(name, planes_smem, state_smem, need)
    raise ValueError(f"temporal_scan: no route fits {limit} B of shared "
                     f"memory at hidden widths {hidden}")


def temporal_scan(
    c_in: torch.Tensor,       # int32[T, B, N_1]: tile 0's MAC, per step
    planes,                   # per hidden tile i: int32[N_{i+1}, ceil(N_i/32)]
    vth,                      # per hidden tile i: int32[N_i]
    *,
    leak: float = 0.0,
    reset: str = "zero",
    refractory: int = 0,
    collect: bool = False,
    telemetry: bool = False,
) -> tuple[torch.Tensor, tuple | None, tuple | None]:
    """The event round's T steps after tile 0's MAC (see
    ``ref.temporal_scan_ref``): returns (out_v float32[B, n_cls], words,
    loads), new tensors on the operands' device, time-first.  Hidden widths
    are any N >= 1 (``ceil(N/32)`` words a tile, zero tail bits); telemetry
    needs them in row groups of 128.

    On the card it is one launch for every ``SCAN_MAX_HIDDEN`` hidden
    tiles (see ``_scan_in_launches``), on the route ``_scan_route`` picks.
    """
    if reset not in RESET_MODES:
        raise ValueError(f"reset {reset!r} not in {RESET_MODES}")
    if refractory < 0:
        raise ValueError(f"refractory must be >= 0, got {refractory}")
    planes, vth = tuple(planes), tuple(vth)
    _check_scan(c_in, planes, vth, telemetry)
    kw = dict(leak=leak, reset=reset, refractory=refractory, collect=collect,
              telemetry=telemetry)
    if on_cpu(c_in, *planes, *vth):
        return temporal_scan_ref(c_in, planes, vth, **kw)
    dev = check_cuda_operands(
        {"c_in": c_in, **{f"planes[{i}]": w for i, w in enumerate(planes)},
         **{f"vth[{i}]": th for i, th in enumerate(vth)}})
    return _scan_in_launches(c_in, planes, vth, dev=dev, **kw)


def _scan_in_launches(c_in, planes, vth, *, scan=None,
                      max_hidden: int = SCAN_MAX_HIDDEN, collect: bool,
                      telemetry: bool, **kw):
    """A stack of any depth as consecutive scans of at most ``max_hidden``
    hidden tiles (``scan``: one launch each, or the plain version).  The
    network is feed-forward, so a later scan's ``c_in`` is the exact MAC
    (``cim_popcount_matmul``) of the last scan's last-tile words with the
    planes behind them, over all T steps; the earlier scans' readouts are
    dropped, and their words and loads joined."""
    scan = scan or _scan_launch
    k = len(vth)
    words, loads = [], []
    for h0 in range(0, max(k, 1), max_hidden):
        h1 = min(h0 + max_hidden, k)
        more = h1 < k
        out_v, w, ld = scan(c_in, planes[h0:h1], vth[h0:h1],
                            collect=collect or more, telemetry=telemetry,
                            **kw)
        words += w or ()
        loads += ld or ()
        if more:
            t, b, _ = c_in.shape
            c_in = cim_popcount_matmul(
                w[-1].reshape(t * b, -1), planes[h1 - 1]).reshape(t, b, -1)
    return (out_v, tuple(words) if collect else None,
            tuple(loads) if telemetry else None)


def _scan_launch(c_in, planes, vth, *, dev, leak: float, reset: str,
                 refractory: int, collect: bool, telemetry: bool,
                 route: ScanRoute | None = None):
    """One ``temporal_scan`` launch over at most ``SCAN_MAX_HIDDEN`` hidden
    tiles of any width, on ``route`` (default: ``_scan_route``'s)."""
    hidden = [int(th.shape[0]) for th in vth]
    n_cls = int(planes[-1].shape[0]) if planes else int(c_in.shape[-1])
    T, B, _ = c_in.shape
    c_in = c_in.contiguous()
    planes = tuple(w.contiguous() for w in planes)
    vth = tuple(th.contiguous() for th in vth)
    out_v = torch.empty((B, n_cls), dtype=torch.float32, device=dev)
    words = tuple(torch.empty((T, B, packed_width(n)), dtype=torch.int32,
                              device=dev) for n in hidden) if collect else None
    loads = tuple(torch.empty((T, B, n // _ROW_GROUP), dtype=torch.int32,
                              device=dev) for n in hidden) if telemetry else None
    if B == 0:
        return out_v, words, loads
    k = len(hidden)
    ptrs = ctypes.c_void_p * max(1, k)
    kl = _library()
    with torch.cuda.device(dev):
        route = route or _scan_route(dev.index, tuple(hidden), n_cls)
        if route.name == "regs" and c_in.data_ptr() % 16:
            # a view at an offset: the register route's bulk copies take
            # 16-byte aligned rows
            c_in = c_in.clone()
        common = (
            c_in.data_ptr(), T, B, k, (ctypes.c_int * max(1, k))(*hidden),
            n_cls, ptrs(*(w.data_ptr() for w in planes)),
            ptrs(*(th.data_ptr() for th in vth)),
            None if words is None else ptrs(*(w.data_ptr() for w in words)),
            None if loads is None else ptrs(*(ld.data_ptr() for ld in loads)),
            out_v.data_ptr())
        dyn = (decay_of(leak), int(reset == "subtract"), refractory)
        if route.name == "regs":
            err = kl.lib.temporal_scan_regs(*common, *dyn, route.steps,
                                            stream_ptr(dev))
        else:
            scratch = None if route.state_smem else torch.empty(
                (B, 2 * sum(hidden) + n_cls), dtype=torch.float32, device=dev)
            err = kl.lib.temporal_scan(
                *common, None if scratch is None else scratch.data_ptr(),
                *dyn, route.planes_smem, route.state_smem, stream_ptr(dev))
    _build.check(kl, err, "temporal_scan launch")
    _LAUNCHES["temporal_scan"] += 1
    return out_v, words, loads
