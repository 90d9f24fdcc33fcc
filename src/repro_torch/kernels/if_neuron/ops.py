"""Wrapper of the IF-neuron kernel, dispatched by device.

``if_neuron`` adds T rounds of int32 updates ``[B, T, N]`` in order and
fires at ``V_mem >= vth``; the port's kernel bench
(``launch/bench_kernels.py``) is its path.  CPU tensors run the plain
version in ``ref.py``; CUDA tensors launch ``csrc/if_neuron.cu`` (built by
``kernels/_build.py`` at first use) or the call raises.  Any B and N run:
the reference's block multiples are a TPU tiling rule.  The kernel splits
the rounds across threads (:func:`_if_route`, pure, picks the geometry).
Launches are counted (:func:`launch_counts`).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.core.h100 import H100_SMS
from repro_torch.kernels import _build
from repro_torch.kernels.common import (
    cdiv,
    check_cuda_operands,
    on_cpu,
    sm_count,
    stream_ptr,
)
from repro_torch.kernels.if_neuron.ref import if_neuron_ref  # noqa: F401

__all__ = ["if_neuron", "if_neuron_ref", "launch_counts",
           "reset_launch_counts"]

#: kernel launches since the last reset
_LAUNCHES = {"if_neuron": 0}

#: threads a block at most (the kernel's kMaxThreads)
_MAX_THREADS = 256
#: rounds a thread loads at once (the kernel's kSpan)
_SPAN = 4
#: warps a block at least
_MIN_WARPS = 2


@dataclasses.dataclass(frozen=True)
class IfRoute:
    """The kernel's geometry: a unit is 4 neurons (``vec``) or one; a warp
    is ``uw`` units x ``32 // uw`` span slots; slot y adds the rounds of
    spans y, y + 32 // uw, ... of ``_SPAN`` rounds each; ``warps`` a block;
    ``grid`` blocks cover the units."""

    uw: int
    warps: int
    grid: int
    vec: bool

    @property
    def slots(self) -> int:
        return 32 // self.uw


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.if_neuron.argtypes = [vp, vp, vp, vp] + [i32] * 7 + [vp]
    lib.if_neuron.restype = i32


def _if_route(B: int, T: int, N: int, vec: bool,
              sms: int = H100_SMS) -> IfRoute:
    """The kernel's geometry for updates ``[B, T, N]`` on a card of ``sms``
    SMs.  Span slots are the power of two that holds every span of
    ``_SPAN`` rounds, up to 32 (one slot, no shuffles, when T <= 4), and a
    warp's units the rest of its 32 lanes; warps a block halved from 8
    while the grid is under two blocks an SM, down to 2.  So a small shape
    spreads over the card with a few loads a thread and a large one streams
    in blocks of 256 threads.  Pure: no library call."""
    if min(B, N) < 1 or T < 0:
        raise ValueError(f"no route for B={B} T={T} N={N}")
    spans = cdiv(T, _SPAN)
    slots = min(1 << max(spans - 1, 0).bit_length(), 32)
    units = B * (N // 4 if vec else N)
    uw = 32 // slots
    warps = _MAX_THREADS // 32
    while warps > _MIN_WARPS and cdiv(units, uw * warps) < 2 * sms:
        warps //= 2
    return IfRoute(uw=uw, warps=warps, grid=cdiv(units, uw * warps), vec=vec)


def _route_for(updates: torch.Tensor, vth: torch.Tensor) -> IfRoute:
    """The route ``if_neuron`` takes for these CUDA operands: 4 neurons a
    unit where N % 4 == 0 and both operands start 16-byte aligned."""
    B, T, N = updates.shape
    vec = (N % 4 == 0 and updates.data_ptr() % 16 == 0
           and vth.data_ptr() % 16 == 0)
    return _if_route(B, T, N, vec, sm_count(updates.device.index))


def if_neuron(updates: torch.Tensor, vth: torch.Tensor):
    """Returns (spikes int8[B, N], vmem int32[B, N]) from int32 updates
    ``[B, T, N]`` and int32 ``vth [N]``; V_mem wraps as int32 adds do."""
    if updates.dim() != 3:
        raise ValueError(f"updates must be [B, T, N], got "
                         f"{tuple(updates.shape)}")
    B, T, N = updates.shape
    if tuple(vth.shape) != (N,):
        raise ValueError(f"vth {tuple(vth.shape)} for {N} neurons")
    if on_cpu(updates, vth):
        return if_neuron_ref(updates, vth)
    dev = check_cuda_operands({"updates": updates, "vth": vth})
    if updates.dtype != torch.int32:
        raise TypeError(f"updates must be int32 on the card, got "
                        f"{updates.dtype}")
    if not updates.is_contiguous():
        raise ValueError("updates must be contiguous")
    vth = vth.to(torch.int32).contiguous()
    spikes = torch.empty((B, N), dtype=torch.int8, device=dev)
    vmem = torch.empty((B, N), dtype=torch.int32, device=dev)
    if B == 0 or N == 0:
        return spikes, vmem
    route = _route_for(updates, vth)
    kl = _build.load_library("if_neuron", _declare)
    with torch.cuda.device(dev):
        err = kl.lib.if_neuron(
            updates.data_ptr(), vth.data_ptr(), spikes.data_ptr(),
            vmem.data_ptr(), B, T, N, route.uw, route.warps, route.grid,
            int(route.vec), stream_ptr(dev))
    _build.check(kl, err, "if_neuron launch")
    _LAUNCHES["if_neuron"] += 1
    return spikes, vmem
