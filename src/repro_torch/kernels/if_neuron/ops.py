"""Wrapper of the IF-neuron kernel, dispatched by device.

``if_neuron`` adds T rounds of int32 updates ``[B, T, N]`` in order and
fires at ``V_mem >= vth``; the port's kernel bench
(``launch/bench_kernels.py``) is its path.  CPU tensors run the plain
version in ``ref.py``; CUDA tensors launch ``csrc/if_neuron.cu`` (built by
``kernels/_build.py`` at first use) or the call raises.  Any B and N run:
the reference's block multiples are a TPU tiling rule.  Launches are
counted (:func:`launch_counts`).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (
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

#: resident blocks per SM the grid-stride launch asks for at most
_BLOCKS_PER_SM = 8


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.if_neuron.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, vp]
    lib.if_neuron.restype = i32


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
    kl = _build.load_library("if_neuron", _declare)
    with torch.cuda.device(dev):
        err = kl.lib.if_neuron(
            updates.data_ptr(), vth.data_ptr(), spikes.data_ptr(),
            vmem.data_ptr(), B, T, N, _BLOCKS_PER_SM * sm_count(dev.index),
            stream_ptr(dev))
    _build.check(kl, err, "if_neuron launch")
    _LAUNCHES["if_neuron"] += 1
    return spikes, vmem
