"""Shared helpers for the port's kernels and their wrappers."""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


def pad_dim_to(x: torch.Tensor, size: int, axis: int) -> torch.Tensor:
    """Zero-pad ``axis`` of x up to ``size`` (no-op if already there).

    Zero spike bits / zero weight rows are exact padding for the binary CIM
    MAC: a silent spike contributes nothing regardless of the stored bit.
    """
    axis = axis % x.dim()
    cur = x.shape[axis]
    if cur == size:
        return x
    if cur > size:
        raise ValueError(f"cannot pad axis {axis} of size {cur} down to {size}")
    # F.pad lists (left, right) pairs from the last axis backwards
    widths = [0, 0] * (x.dim() - axis)
    widths[-1] = size - cur
    return F.pad(x, widths)


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; the card unless asked otherwise.

    ``"cuda"`` (the default everywhere in the port) raises when no GPU is
    visible: the port never drops to the CPU on its own.  Pass
    ``device="cpu"`` to run the plain PyTorch datapath on purpose.  A bare
    ``"cuda"`` resolves to the current card's index, so resolved devices
    compare equal to the devices of tensors placed with them.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r} (cuda or cpu)")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def check_cuda_operands(tensors: dict) -> torch.device:
    """All operands on one CUDA device; returns it (raises otherwise)."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"operands on different devices: "
                         f"{ {k: str(t.device) for k, t in tensors.items()} }")
    dev = devices.pop()
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    return dev


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every operand lies on the CPU (the plain path)."""
    return all(t.device.type == "cpu" for t in tensors)


def stream_ptr(dev: torch.device) -> ctypes.c_void_p:
    """The current stream of ``dev``, as a launcher argument."""
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count
