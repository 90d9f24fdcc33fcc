"""Wrappers of the unpacked-spike CIM MAC kernels, dispatched by device.

``cim_matmul`` (V_mem) and ``esam_layer`` (MAC + IF fire) take {0,1} spikes
``[B, K]`` of any real or bool dtype and {0,1} weight bits ``[K, N]`` (int8
on the card), as the reference's ``repro.kernels.cim_matmul.ops`` does; the
port's kernel bench (``launch/bench_kernels.py``) is their path.  CPU
tensors run the plain versions in ``ref.py``; CUDA tensors launch
``csrc/cim_matmul.cu`` (built by ``kernels/_build.py`` at first use) or the
call raises: one tensor-core kernel with an epilogue per output, each CTA
packing a span of spike rows into words and building one 64-neuron
group's weight planes from the int8 weights (:func:`_matmul_route`).  On
the card a spike is "nonzero" on its raw bits: the contract for {0,1}
spikes, and nothing is promised for other values.  Any B, K and N run: the
reference's block multiples are a TPU tiling rule.  Launches are counted
(:func:`launch_counts`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core.h100 import H100_SMS
from repro_torch.kernels import _build
from repro_torch.kernels.cim_matmul.ref import (  # noqa: F401  (re-export)
    cim_matmul_ref,
    esam_layer_ref,
)
from repro_torch.kernels.common import (
    cdiv,
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

#: neurons of a CTA (8 mma n-tiles) and rows of a row tile (the mma's m)
_GROUP, _TILE_ROWS = 64, 16
#: 16-byte spike chunks a thread of a CTA stages a K step, at most: a span
#: of t row tiles of e-byte spikes takes t * e (``kMaxChunks`` in the source)
_MAX_CHUNKS = 16
#: row tiles of a span: the kernel's instantiations
_SPAN_TILES = (1, 2, 4)

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
                                   i32, i32, i32, vp]
    lib.cim_matmul_mac.restype = i32
    lib.cim_matmul_fire.argtypes = [vp, i64, i32, vp, i64, vp, vp, i32, i32,
                                    i32, i32, i32, i32, vp]
    lib.cim_matmul_fire.restype = i32


class MatmulRoute(NamedTuple):
    """How the unpacked-spike kernel runs one shape: its grid and what each
    CTA takes on."""

    #: (spans, groups): a CTA a span of rows and a 64-neuron group
    grid: tuple
    #: rows of a span: 16, 32 or 64 (one, two or four row tiles)
    span_rows: int
    #: spike rows staged 16 bytes at a time (else an element at a time)
    vec: bool


def _matmul_route(B: int, N: int, spike_bytes: int, vec: bool,
                  sms: int = H100_SMS) -> MatmulRoute:
    """The grid of B rows and N neurons of ``spike_bytes``-wide spikes on a
    card of ``sms`` SMs: ceil(N / 64) groups, and the shortest span of 1,
    2 or 4 row tiles whose grid fits the card once (each CTA builds its
    group's planes once, so fewer, longer spans build them fewer times); at
    most 4 tiles, and at most 16 / ``spike_bytes`` (a K step of the span's
    spikes in 64 KB of shared memory), so a large batch runs more CTAs than
    SMs.  Any K runs on any route.  Pure: no library call, so it can be
    checked anywhere."""
    if min(B, N) < 1 or spike_bytes not in (1, 2, 4, 8):
        raise ValueError(f"no route for B={B} N={N} "
                         f"spike_bytes={spike_bytes}")
    groups = cdiv(N, _GROUP)
    want = max(1, sms // groups)
    tiles = [t for t in _SPAN_TILES if t * spike_bytes <= _MAX_CHUNKS]
    fit = [t for t in tiles if t * _TILE_ROWS * want >= B]
    rows = _TILE_ROWS * (fit[0] if fit else tiles[-1])
    return MatmulRoute(grid=(cdiv(B, rows), groups), span_rows=rows,
                       vec=vec)


def _route_for(spikes: torch.Tensor, N: int) -> MatmulRoute:
    """The route for these CUDA spikes: ``_matmul_route`` on their shape,
    with 16-byte copies where the spikes and their row stride are 16-byte
    aligned."""
    B = spikes.shape[0]
    e = spikes.element_size()
    vec = spikes.data_ptr() % 16 == 0 and (spikes.stride(0) * e) % 16 == 0
    return _matmul_route(B, N, e, vec, sm_count(spikes.device.index))


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
    route = _route_for(spikes, N)
    with torch.cuda.device(dev):
        err = getattr(kl.lib, fn)(*args, out.data_ptr(), B, K, N,
                                  route.span_rows, route.grid[0],
                                  int(route.vec), stream_ptr(dev))
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
