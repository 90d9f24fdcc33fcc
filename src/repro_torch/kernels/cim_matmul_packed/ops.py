"""Wrapper of the packed-spike CIM tile kernel, dispatched by device.

``esam_layer_packed`` is the learning prefix's tile (``plan.packed_prefix``,
the reference's ``plan._packed_cascade``): spikes arrive as wire words, weights as {0,1}
int8 ``[K, N]``, and the fired spikes leave re-packed.  CPU tensors run the
plain version in ``ref.py``; CUDA tensors launch
``csrc/cim_matmul_packed.cu`` (built by ``kernels/_build.py`` at first use)
or the call raises.  Launches are counted (:func:`launch_counts`).

The reference's ``cim_matmul_packed`` (the MAC without the fire) is not on
the port's path yet and has no wrapper here.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import packing
from repro_torch.core.packing import LANE_BITS, WORD_DTYPE
from repro_torch.kernels import _build
from repro_torch.kernels.common import check_cuda_operands, on_cpu, stream_ptr
from repro_torch.kernels.cim_matmul_packed.ref import (  # noqa: F401  (re-export)
    cim_matmul_packed_ref,
    esam_layer_packed_ref,
)

__all__ = [
    "esam_layer_packed",
    "esam_layer_packed_ref",
    "cim_matmul_packed_ref",
    "launch_counts",
    "reset_launch_counts",
]

#: kernel launches since the last reset, per kernel
_LAUNCHES = {"fused_fire_packed": 0}


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.cim_matmul_packed_fire.argtypes = [
        vp, i64, vp, i64, vp, vp, i32, i32, i32, i32, vp]
    lib.cim_matmul_packed_fire.restype = i32


def esam_layer_packed(
    packed: torch.Tensor,        # int32 words [B, ceil(K/32)]
    weight_bits: torch.Tensor,   # {0,1} int8 [K, N]
    vth: torch.Tensor,           # int32 [N]
    *,
    pack_output: bool = True,
) -> torch.Tensor:
    """Fused packed tile: MAC + IF fire (+ output re-pack).

    Returns int32 words [B, N/32] when ``pack_output`` (N must be a multiple
    of 32), else int8 {0,1}[B, N]; V_mem never leaves the kernel.
    """
    if packed.dtype != WORD_DTYPE or packed.dim() != 2:
        raise TypeError(f"packed: expected int32 words [B, W], got "
                        f"{packed.dtype}{list(packed.shape)}")
    if weight_bits.dim() != 2:
        raise ValueError(f"weight_bits must be [K, N], got "
                         f"{tuple(weight_bits.shape)}")
    B, W = packed.shape
    K, N = weight_bits.shape
    if W != packing.packed_width(K):
        raise ValueError(f"{W} words for {K} inputs")
    if tuple(vth.shape) != (N,):
        raise ValueError(f"vth {tuple(vth.shape)} for {N} neurons")
    if pack_output and N % LANE_BITS:
        raise ValueError(f"packed output needs N % 32 == 0, got N={N}")
    if on_cpu(packed, weight_bits, vth):
        return esam_layer_packed_ref(packed, weight_bits, vth,
                                     pack_output=pack_output)
    dev = check_cuda_operands(
        {"packed": packed, "weight_bits": weight_bits, "vth": vth})
    if weight_bits.dtype != torch.int8:
        raise TypeError(f"weight_bits must be int8, got {weight_bits.dtype}")
    if packed.stride(1) != 1 or weight_bits.stride(1) != 1:
        raise ValueError("packed and weight_bits need contiguous rows")
    vth = vth.to(torch.int32).contiguous()
    out = (torch.empty((B, N // LANE_BITS), dtype=WORD_DTYPE, device=dev)
           if pack_output else torch.empty((B, N), dtype=torch.int8, device=dev))
    if B == 0:
        return out
    kl = _build.load_library("cim_matmul_packed", _declare)
    with torch.cuda.device(dev):
        err = kl.lib.cim_matmul_packed_fire(
            packed.data_ptr(), packed.stride(0), weight_bits.data_ptr(),
            weight_bits.stride(0), vth.data_ptr(), out.data_ptr(), B, K, N,
            int(pack_output), stream_ptr(dev))
    _build.check(kl, err, "fused_fire_packed launch")
    _LAUNCHES["fused_fire_packed"] += 1
    return out
