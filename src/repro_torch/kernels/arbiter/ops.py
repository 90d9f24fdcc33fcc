"""Wrappers of the multiport arbiter kernels, dispatched by device.

``port_schedule`` is what the cycle-accurate plane (``core.esam.tile``)
calls: the whole drain of every row group in one launch.  ``arbiter`` is one
arbitration cycle (grants, remaining requests, per-port valid flags).

CPU tensors run the plain versions in ``ref.py``; CUDA tensors launch
``csrc/arbiter.cu`` (built by ``kernels/_build.py`` at first use) or the
call raises.  Launches are counted (:func:`launch_counts`).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import check_cuda_operands, on_cpu, stream_ptr
from repro_torch.kernels.arbiter.ref import (  # noqa: F401  (re-export)
    arbiter_ref,
    port_schedule_ref,
    priority_grants_oracle,
)

__all__ = [
    "port_schedule",
    "arbiter",
    "port_schedule_ref",
    "arbiter_ref",
    "priority_grants_oracle",
    "launch_counts",
    "reset_launch_counts",
]

#: kernel launches since the last reset, per kernel
_LAUNCHES = {"port_schedule": 0, "arbiter": 0}

#: the request dtypes the kernels read as {0, nonzero} bytes
_REQUEST_TYPES = (torch.bool, torch.uint8)

#: lanes of one base priority encoder; a row group is a whole number of them
_SUBBLOCK = 32


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.arbiter_port_schedule.argtypes = [vp, vp, vp, i32, i32, i32, vp]
    lib.arbiter_port_schedule.restype = i32
    lib.arbiter_grants.argtypes = [vp, vp, vp, vp, i32, i32, i32, vp]
    lib.arbiter_grants.restype = i32


def _check(requests: torch.Tensor, ports: int) -> None:
    if requests.dim() != 2:
        raise ValueError(f"requests must be [groups, W], got "
                         f"{tuple(requests.shape)}")
    if requests.shape[1] < 1 or requests.shape[1] % _SUBBLOCK:
        raise ValueError(f"row-group width {requests.shape[1]} must be a "
                         f"positive multiple of {_SUBBLOCK}")
    if requests.dtype not in _REQUEST_TYPES:
        raise TypeError(f"requests must be bool or uint8, got "
                        f"{requests.dtype}")
    if isinstance(ports, bool) or not isinstance(ports, int) or ports < 1:
        raise ValueError(f"ports must be an int >= 1, got {ports!r}")


def port_schedule(requests: torch.Tensor, *, ports: int):
    """Closed-form drain schedule of N row groups (see ``port_schedule_ref``).

    Returns (cycle_of int32[N, W], counts int32[N, ceil(W/p)]).
    """
    _check(requests, ports)
    if on_cpu(requests):
        return port_schedule_ref(requests, ports)
    dev = check_cuda_operands({"requests": requests})
    n, w = requests.shape
    cycle_of = torch.empty((n, w), dtype=torch.int32, device=dev)
    counts = torch.empty((n, -(-w // ports)), dtype=torch.int32, device=dev)
    if n == 0:
        return cycle_of, counts
    requests = requests.contiguous()
    kl = _build.load_library("arbiter", _declare)
    with torch.cuda.device(dev):
        err = kl.lib.arbiter_port_schedule(
            requests.data_ptr(), cycle_of.data_ptr(), counts.data_ptr(), n, w,
            ports, stream_ptr(dev))
    _build.check(kl, err, "port_schedule launch")
    _LAUNCHES["port_schedule"] += 1
    return cycle_of, counts


def arbiter(requests: torch.Tensor, *, ports: int):
    """One arbiter cycle for G row groups (see ``arbiter_ref``).

    Returns (grants int8[G, p, W], remaining int8[G, W], valid int8[G, p]).
    Any G runs (the reference's ``G % block_g`` rule is a TPU tiling rule).
    """
    _check(requests, ports)
    if on_cpu(requests):
        return arbiter_ref(requests, ports)
    dev = check_cuda_operands({"requests": requests})
    g, w = requests.shape
    grants = torch.empty((g, ports, w), dtype=torch.int8, device=dev)
    remaining = torch.empty((g, w), dtype=torch.int8, device=dev)
    valid = torch.empty((g, ports), dtype=torch.int8, device=dev)
    if g == 0:
        return grants, remaining, valid
    requests = requests.contiguous()
    kl = _build.load_library("arbiter", _declare)
    with torch.cuda.device(dev):
        err = kl.lib.arbiter_grants(
            requests.data_ptr(), grants.data_ptr(), remaining.data_ptr(),
            valid.data_ptr(), g, w, ports, stream_ptr(dev))
    _build.check(kl, err, "arbiter launch")
    _LAUNCHES["arbiter"] += 1
    return grants, remaining, valid
