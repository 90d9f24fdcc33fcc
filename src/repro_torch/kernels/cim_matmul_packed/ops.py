"""Wrappers of the packed-spike CIM tile kernels, dispatched by device.

Spikes arrive as wire words, weights as {0,1} int8 ``[K, N]``.
``esam_layer_packed`` is the learning prefix's tile (``plan.packed_prefix``,
the reference's ``plan._packed_cascade``): the fired spikes leave re-packed.
``cim_matmul_packed`` is the MAC without the fire (int32 V_mem), which the
kernel bench (``launch/bench_kernels.py``) runs alone and as the readout of
the per-tile cascade.  CPU tensors run the plain versions in ``ref.py``;
CUDA tensors launch ``csrc/cim_matmul_packed.cu`` (built by
``kernels/_build.py`` at first use) or the call raises: one tensor-core
kernel with an epilogue per output, each CTA building one 64-neuron group's
weight planes from the int8 weights and multiplying a span of rows
(:func:`_packed_route`).  Any K runs: bits past K in the last word are
masked, which gives the reference's zero-padded result.  Launches are
counted (:func:`launch_counts`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core import packing
from repro_torch.core.h100 import H100_SMS
from repro_torch.core.packing import LANE_BITS, WORD_DTYPE
from repro_torch.kernels import _build
from repro_torch.kernels.common import (
    cdiv,
    check_cuda_operands,
    on_cpu,
    round_up,
    sm_count,
    stream_ptr,
)
from repro_torch.kernels.cim_matmul_packed.ref import (  # noqa: F401  (re-export)
    cim_matmul_packed_ref,
    esam_layer_packed_ref,
)

__all__ = [
    "cim_matmul_packed",
    "esam_layer_packed",
    "esam_layer_packed_ref",
    "cim_matmul_packed_ref",
    "launch_counts",
    "reset_launch_counts",
]

#: neurons of a CTA (8 mma n-tiles) and rows of a warp's tile (the mma's m)
_GROUP, _TILE_ROWS = 64, 16
#: rows of a CTA's span, at most: 16 rows x 8 warps x 2 tiles a warp
_MAX_SPAN = 256

#: kernel launches since the last reset, per kernel
_LAUNCHES = {"fused_fire_packed": 0, "cim_matmul_packed": 0}


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.cim_matmul_packed_fire.argtypes = [
        vp, i64, vp, i64, vp, vp, i32, i32, i32, i32, i32, i32, i32, vp]
    lib.cim_matmul_packed_fire.restype = i32
    lib.cim_matmul_packed_mac.argtypes = [
        vp, i64, vp, i64, vp, i32, i32, i32, i32, i32, i32, vp]
    lib.cim_matmul_packed_mac.restype = i32


class PackedRoute(NamedTuple):
    """How the packed tile kernel runs one shape: its grid and what each
    CTA takes on."""

    #: (spans, groups): a CTA a span of rows and a 64-neuron group
    grid: tuple
    #: rows of a span: a multiple of 16, at most ``_MAX_SPAN``
    span_rows: int
    #: spike words loaded two (8 bytes) at a time
    paired: bool


def _packed_route(B: int, N: int, paired: bool,
                  sms: int = H100_SMS) -> PackedRoute:
    """The grid of B rows and N neurons on a card of ``sms`` SMs: ceil(N /
    64) groups, and spans of rows sized so that groups x spans fills the
    card about once (each CTA builds its group's planes once, so fewer,
    longer spans read the weights fewer times); at least 16 rows a span and
    at most ``_MAX_SPAN``, so a large batch runs more CTAs than SMs.  Any K
    runs on any route.  Pure: no library call, so it can be checked
    anywhere."""
    if min(B, N) < 1:
        raise ValueError(f"no route for B={B} N={N}")
    groups = cdiv(N, _GROUP)
    want = max(1, sms // groups)
    rows = min(_MAX_SPAN, round_up(cdiv(B, want), _TILE_ROWS))
    return PackedRoute(grid=(cdiv(B, rows), groups), span_rows=rows,
                       paired=paired)


def _route_for(packed: torch.Tensor, N: int) -> PackedRoute:
    """The route for these CUDA spike words: ``_packed_route`` on their
    shape, with 8-byte loads where the word count and row stride are even
    and the words 8-byte aligned."""
    B, W = packed.shape
    paired = (W % 2 == 0 and packed.stride(0) % 2 == 0
              and packed.data_ptr() % 8 == 0)
    return _packed_route(B, N, paired, sm_count(packed.device.index))


def _check(packed: torch.Tensor, weight_bits: torch.Tensor) -> tuple:
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
    return B, K, N


def _check_card(packed: torch.Tensor, weight_bits: torch.Tensor) -> None:
    if weight_bits.dtype != torch.int8:
        raise TypeError(f"weight_bits must be int8, got {weight_bits.dtype}")
    if packed.stride(1) != 1 or weight_bits.stride(1) != 1:
        raise ValueError("packed and weight_bits need contiguous rows")


def cim_matmul_packed(
    packed: torch.Tensor,        # int32 words [B, ceil(K/32)]
    weight_bits: torch.Tensor,   # {0,1} int8 [K, N]
) -> torch.Tensor:
    """V_mem int32[B, N] = unpack(packed) @ (2*bits - 1); on the card the
    spikes are never unpacked."""
    B, K, N = _check(packed, weight_bits)
    if on_cpu(packed, weight_bits):
        return cim_matmul_packed_ref(packed, weight_bits)
    dev = check_cuda_operands({"packed": packed, "weight_bits": weight_bits})
    _check_card(packed, weight_bits)
    out = torch.empty((B, N), dtype=torch.int32, device=dev)
    if B == 0:
        return out
    kl = _build.load_library("cim_matmul_packed", _declare)
    route = _route_for(packed, N)
    with torch.cuda.device(dev):
        err = kl.lib.cim_matmul_packed_mac(
            packed.data_ptr(), packed.stride(0), weight_bits.data_ptr(),
            weight_bits.stride(0), out.data_ptr(), B, K, N, route.span_rows,
            route.grid[0], int(route.paired), stream_ptr(dev))
    _build.check(kl, err, "cim_matmul_packed launch")
    _LAUNCHES["cim_matmul_packed"] += 1
    return out


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
    B, K, N = _check(packed, weight_bits)
    if tuple(vth.shape) != (N,):
        raise ValueError(f"vth {tuple(vth.shape)} for {N} neurons")
    if pack_output and N % LANE_BITS:
        raise ValueError(f"packed output needs N % 32 == 0, got N={N}")
    if on_cpu(packed, weight_bits, vth):
        return esam_layer_packed_ref(packed, weight_bits, vth,
                                     pack_output=pack_output)
    dev = check_cuda_operands(
        {"packed": packed, "weight_bits": weight_bits, "vth": vth})
    _check_card(packed, weight_bits)
    vth = vth.to(torch.int32).contiguous()
    out = (torch.empty((B, N // LANE_BITS), dtype=WORD_DTYPE, device=dev)
           if pack_output else torch.empty((B, N), dtype=torch.int8, device=dev))
    if B == 0:
        return out
    kl = _build.load_library("cim_matmul_packed", _declare)
    route = _route_for(packed, N)
    with torch.cuda.device(dev):
        err = kl.lib.cim_matmul_packed_fire(
            packed.data_ptr(), packed.stride(0), weight_bits.data_ptr(),
            weight_bits.stride(0), vth.data_ptr(), out.data_ptr(), B, K, N,
            route.span_rows, route.grid[0], int(route.paired),
            int(pack_output), stream_ptr(dev))
    _build.check(kl, err, "fused_fire_packed launch")
    _LAUNCHES["fused_fire_packed"] += 1
    return out
