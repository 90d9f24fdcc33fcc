"""Wrappers of the unpacked-spike CIM MAC kernels, dispatched by device.

``cim_matmul`` (V_mem) and ``esam_layer`` (MAC + IF fire) take {0,1} spikes
``[B, K]`` of any real or bool dtype and {0,1} weight bits ``[K, N]`` (int8
on the card), as the reference's ``repro.kernels.cim_matmul.ops`` does; the
port's kernel bench (``launch/bench_kernels.py``) is their path.  CPU
tensors run the plain versions in ``ref.py``; CUDA tensors launch
``csrc/cim_matmul.cu`` (built by ``kernels/_build.py`` at first use) or the
call raises.  On the card a spike
is "nonzero" on its raw bits: the contract for {0,1} spikes, and nothing is
promised for other values.  Any B, K and N run: the reference's block
multiples are a TPU tiling rule.  Launches are counted
(:func:`launch_counts`).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.cim_matmul.ref import (  # noqa: F401  (re-export)
    cim_matmul_ref,
    esam_layer_ref,
)
from repro_torch.kernels.common import (
    check_cuda_operands,
    on_cpu,
    sm_count,
    stream_ptr,
)

__all__ = [
    "cim_matmul",
    "esam_layer",
    "cim_matmul_ref",
    "esam_layer_ref",
    "launch_counts",
    "reset_launch_counts",
]

#: kernel launches since the last reset, per kernel
_LAUNCHES = {"cim_matmul": 0, "esam_layer": 0}

def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.cim_matmul_mac.argtypes = [vp, i64, i32, vp, i64, vp, i32, i32, i32,
                                   i32, vp]
    lib.cim_matmul_mac.restype = i32
    lib.cim_matmul_fire.argtypes = [vp, i64, i32, vp, i64, vp, vp, i32, i32,
                                    i32, i32, vp]
    lib.cim_matmul_fire.restype = i32


def _check(spikes: torch.Tensor, weight_bits: torch.Tensor) -> tuple:
    if spikes.dim() != 2 or weight_bits.dim() != 2:
        raise ValueError(f"spikes [B, K] and weight_bits [K, N], got "
                         f"{tuple(spikes.shape)} and "
                         f"{tuple(weight_bits.shape)}")
    B, K = spikes.shape
    K2, N = weight_bits.shape
    if K != K2 or K < 1:
        raise ValueError(f"spikes have {K} inputs, weight_bits {K2}")
    if spikes.is_complex():
        raise TypeError(f"spikes must be real or bool, got {spikes.dtype}")
    return B, K, N


def _launch(kernel: str, fn: str, spikes, weight_bits, vth,
            out_dtype) -> torch.Tensor:
    """One launch of ``fn`` (``cim_matmul_mac`` or ``cim_matmul_fire``) on
    the card, counted under ``kernel``."""
    B, K, N = _check(spikes, weight_bits)
    ops = {"spikes": spikes, "weight_bits": weight_bits}
    if vth is not None:
        ops["vth"] = vth
    dev = check_cuda_operands(ops)
    if weight_bits.dtype != torch.int8:
        raise TypeError(f"weight_bits must be int8 on the card, got "
                        f"{weight_bits.dtype}")
    if spikes.stride(1) != 1 or weight_bits.stride(1) != 1:
        raise ValueError("spikes and weight_bits need contiguous rows")
    out = torch.empty((B, N), dtype=out_dtype, device=dev)
    if B == 0 or N == 0:
        return out
    args = [spikes.data_ptr(), spikes.stride(0), spikes.element_size(),
            weight_bits.data_ptr(), weight_bits.stride(0)]
    if vth is not None:
        vth = vth.to(torch.int32).contiguous()
        args.append(vth.data_ptr())
    kl = _build.load_library("cim_matmul", _declare)
    with torch.cuda.device(dev):
        err = getattr(kl.lib, fn)(*args, out.data_ptr(), B, K, N,
                                  sm_count(dev.index), stream_ptr(dev))
    _build.check(kl, err, f"{kernel} launch")
    _LAUNCHES[kernel] += 1
    return out


def cim_matmul(spikes: torch.Tensor,
               weight_bits: torch.Tensor) -> torch.Tensor:
    """V_mem int32[B, N] = spikes @ (2*bits - 1)."""
    _check(spikes, weight_bits)
    if on_cpu(spikes, weight_bits):
        return cim_matmul_ref(spikes, weight_bits)
    return _launch("cim_matmul", "cim_matmul_mac", spikes, weight_bits, None,
                   torch.int32)


def esam_layer(spikes: torch.Tensor, weight_bits: torch.Tensor,
               vth: torch.Tensor) -> torch.Tensor:
    """Fused tile inference: int8 {0,1}[B, N] = (V_mem >= vth); on the card
    V_mem never leaves the kernel."""
    _, _, N = _check(spikes, weight_bits)
    if tuple(vth.shape) != (N,):
        raise ValueError(f"vth {tuple(vth.shape)} for {N} neurons")
    if on_cpu(spikes, weight_bits, vth):
        return esam_layer_ref(spikes, weight_bits, vth)
    return _launch("esam_layer", "cim_matmul_fire", spikes, weight_bits, vth,
                   torch.int8)
