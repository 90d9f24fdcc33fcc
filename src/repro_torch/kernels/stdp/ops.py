"""Wrappers of the transposed-port STDP kernels, dispatched by device.

``stdp_column_event`` is what the online-learning epoch issues: one
learning neuron's row of the transposed layout, written in place, with the
row index and the gate in device memory (no host sync per sample).
``stdp_update`` is the full-matrix rule behind ``learning.stdp_update``.

CPU tensors run the plain versions in ``ref.py``; CUDA tensors launch
``csrc/stdp.cu`` (built by ``kernels/_build.py`` at first use) or the call
raises.  Launches are counted (:func:`launch_counts`).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import check_cuda_operands, on_cpu, stream_ptr
from repro_torch.kernels.stdp.ref import (  # noqa: F401  (re-export)
    f32,
    stdp_column_event_ref,
    stdp_update_ref,
)

__all__ = [
    "stdp_column_event",
    "stdp_update",
    "stdp_column_event_ref",
    "stdp_update_ref",
    "launch_counts",
    "reset_launch_counts",
]

#: kernel launches since the last reset, per kernel
_LAUNCHES = {"stdp_column_event": 0, "stdp_update": 0}

_BYTE_TYPES = (torch.bool, torch.int8, torch.uint8)


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32, i64, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.stdp_column_event.argtypes = [
        vp, i32, i32, i64, vp, i32, vp, vp, vp, vp, f, f, vp]
    lib.stdp_column_event.restype = i32
    lib.stdp_update.argtypes = [vp, vp, i32, i32, vp, vp, vp, vp, f, f, vp]
    lib.stdp_update.restype = i32


def _library() -> _build.KernelLibrary:
    return _build.load_library("stdp", _declare)


def _byte_mask(t: torch.Tensor) -> torch.Tensor:
    """A {0, nonzero} byte vector the kernels read as uint8."""
    if t.dtype not in _BYTE_TYPES:
        t = t != 0
    return t.contiguous()


def _check_vec(name: str, t: torch.Tensor, n: int, dtype=None) -> None:
    if tuple(t.shape) != (n,):
        raise ValueError(f"{name} must be [{n}], got {tuple(t.shape)}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")


def stdp_column_event(
    bits_t: torch.Tensor,   # {0,1} int8 [N_out, N_in], updated in place
    col: torch.Tensor,      # int32/int64 scalar: the learning neuron
    apply: torch.Tensor,    # bool scalar: the write happens only when true
    pre: torch.Tensor,      # {0,1}[N_in] pre-synaptic activity trace
    u_pot: torch.Tensor,    # float32[N_in]
    u_dep: torch.Tensor,    # float32[N_in]
    *,
    p_pot: float,
    p_dep: float,
) -> torch.Tensor:
    """Column event: rewrite row ``col`` of ``bits_t`` in place when
    ``apply``; returns ``bits_t``.  On the card ``col`` and ``apply`` stay in
    device memory and the kernel reads them (a ``col`` outside
    ``[0, N_out)`` writes nothing there)."""
    if bits_t.dim() != 2:
        raise ValueError(f"bits_t must be [N_out, N_in], got "
                         f"{tuple(bits_t.shape)}")
    n_out, n_in = bits_t.shape
    _check_vec("pre", pre, n_in)
    _check_vec("u_pot", u_pot, n_in, torch.float32)
    _check_vec("u_dep", u_dep, n_in, torch.float32)
    col = torch.as_tensor(col, device=bits_t.device)
    apply = torch.as_tensor(apply, device=bits_t.device)
    if col.dim() or apply.dim():
        raise ValueError("col and apply must be scalars")
    if apply.dtype != torch.bool:
        raise TypeError(f"apply must be bool, got {apply.dtype}")
    if on_cpu(bits_t, pre, u_pot, u_dep):
        return bits_t.copy_(stdp_column_event_ref(
            bits_t, col, apply, pre, u_pot, u_dep, p_pot, p_dep))
    dev = check_cuda_operands({"bits_t": bits_t, "col": col, "apply": apply,
                               "pre": pre, "u_pot": u_pot, "u_dep": u_dep})
    if bits_t.dtype != torch.int8 or bits_t.stride(1) != 1:
        raise ValueError("bits_t must be int8 with contiguous rows")
    if col.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"col must be int32 or int64, got {col.dtype}")
    pre = _byte_mask(pre)
    u_pot, u_dep = u_pot.contiguous(), u_dep.contiguous()
    kl = _library()
    with torch.cuda.device(dev):
        err = kl.lib.stdp_column_event(
            bits_t.data_ptr(), n_out, n_in, bits_t.stride(0), col.data_ptr(),
            col.element_size(), apply.data_ptr(), pre.data_ptr(),
            u_pot.data_ptr(), u_dep.data_ptr(), f32(p_pot), f32(p_dep),
            stream_ptr(dev))
    _build.check(kl, err, "stdp_column_event launch")
    _LAUNCHES["stdp_column_event"] += 1
    return bits_t


def stdp_update(
    bits_t: torch.Tensor,   # {0,1} int8 [N_out, N_in]
    pre: torch.Tensor,      # {0,1}[N_in]
    post: torch.Tensor,     # {0,1}[N_out]
    u_pot: torch.Tensor,    # float32[N_out, N_in]
    u_dep: torch.Tensor,    # float32[N_out, N_in]
    *,
    p_pot: float,
    p_dep: float,
) -> torch.Tensor:
    """The full-matrix rule masked by ``post``; returns new bits."""
    if bits_t.dim() != 2:
        raise ValueError(f"bits_t must be [N_out, N_in], got "
                         f"{tuple(bits_t.shape)}")
    n_out, n_in = bits_t.shape
    _check_vec("pre", pre, n_in)
    _check_vec("post", post, n_out)
    for name, u in (("u_pot", u_pot), ("u_dep", u_dep)):
        if tuple(u.shape) != (n_out, n_in) or u.dtype != torch.float32:
            raise ValueError(f"{name} must be float32[{n_out}, {n_in}], got "
                             f"{u.dtype}{list(u.shape)}")
    if on_cpu(bits_t, pre, post, u_pot, u_dep):
        return stdp_update_ref(bits_t, pre, post, u_pot, u_dep, p_pot, p_dep)
    dev = check_cuda_operands({"bits_t": bits_t, "pre": pre, "post": post,
                               "u_pot": u_pot, "u_dep": u_dep})
    if bits_t.dtype != torch.int8:
        raise TypeError(f"bits_t must be int8, got {bits_t.dtype}")
    bits_t, u_pot, u_dep = (t.contiguous() for t in (bits_t, u_pot, u_dep))
    pre, post = _byte_mask(pre), _byte_mask(post)
    out = torch.empty_like(bits_t)
    kl = _library()
    with torch.cuda.device(dev):
        err = kl.lib.stdp_update(
            bits_t.data_ptr(), out.data_ptr(), n_out, n_in, pre.data_ptr(),
            post.data_ptr(), u_pot.data_ptr(), u_dep.data_ptr(), f32(p_pot),
            f32(p_dep), stream_ptr(dev))
    _build.check(kl, err, "stdp_update launch")
    _LAUNCHES["stdp_update"] += 1
    return out
