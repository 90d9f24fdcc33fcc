"""Wrappers of the transposed-port STDP kernels, dispatched by device.

``stdp_column_epoch`` is what the online-learning epoch issues: a whole
epoch of column events in one launch, the readout resident on the chip.
``stdp_column_event`` is one learning neuron's row of the transposed
layout, written in place, with the row index and the gate in device memory.
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
    stdp_column_epoch_ref,
    stdp_column_event_ref,
    stdp_update_ref,
)

__all__ = [
    "stdp_column_epoch",
    "stdp_column_event",
    "stdp_update",
    "stdp_column_epoch_ref",
    "stdp_column_event_ref",
    "stdp_update_ref",
    "launch_counts",
    "reset_launch_counts",
]

#: kernel launches since the last reset, per kernel
_LAUNCHES = {"stdp_column_epoch": 0, "stdp_column_event": 0,
             "stdp_update": 0}

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
    lib.stdp_column_epoch.argtypes = [
        vp, i32, i32, i64, vp, vp, i32, vp, vp, vp, i64, vp, i32, f, f, vp, vp]
    lib.stdp_column_epoch.restype = i32
    lib.stdp_column_epoch_smem_bytes.argtypes = [i32, i32]
    lib.stdp_column_epoch_smem_bytes.restype = i64
    lib.stdp_max_shared_optin.argtypes = [i32]
    lib.stdp_max_shared_optin.restype = i64


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


def stdp_column_epoch(
    bits_t: torch.Tensor,   # {0,1} int8 [N_out, N_in], updated in place
    pre: torch.Tensor,      # {0,1}[n, N_in] pre-synaptic traces
    labels: torch.Tensor,   # int32/int64 [n] teacher classes
    u_pot: torch.Tensor,    # float32[n, N_in]
    u_dep_t: torch.Tensor,  # float32[n, N_in]
    u_dep_w: torch.Tensor,  # float32[n, N_in]
    out_offset: torch.Tensor | None = None,   # float32[N_out]
    *,
    p_pot: float,
    p_dep: float,
) -> torch.Tensor:
    """A whole supervised column-event epoch on ``bits_t``, in place (see
    ``stdp_column_epoch_ref``); returns the number of wrong samples as an
    int32 scalar on the device.  On the card it is one launch of one block
    that keeps the readout in shared memory; a readout too large for that
    raises ``ValueError``."""
    if bits_t.dim() != 2:
        raise ValueError(f"bits_t must be [N_out, N_in], got "
                         f"{tuple(bits_t.shape)}")
    n_out, n_in = bits_t.shape
    if pre.dim() != 2 or pre.shape[1] != n_in:
        raise ValueError(f"pre must be [n, {n_in}], got {tuple(pre.shape)}")
    n = pre.shape[0]
    _check_vec("labels", labels, n)
    if labels.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"labels must be int32 or int64, got {labels.dtype}")
    for name, u in (("u_pot", u_pot), ("u_dep_t", u_dep_t),
                    ("u_dep_w", u_dep_w)):
        if tuple(u.shape) != (n, n_in) or u.dtype != torch.float32:
            raise ValueError(f"{name} must be float32[{n}, {n_in}], got "
                             f"{u.dtype}{list(u.shape)}")
    operands = {"bits_t": bits_t, "pre": pre, "labels": labels,
                "u_pot": u_pot, "u_dep_t": u_dep_t, "u_dep_w": u_dep_w}
    if out_offset is not None:
        _check_vec("out_offset", out_offset, n_out, torch.float32)
        operands["out_offset"] = out_offset
    if on_cpu(*operands.values()):
        new, wrong = stdp_column_epoch_ref(bits_t, pre, labels, u_pot,
                                           u_dep_t, u_dep_w, out_offset,
                                           p_pot, p_dep)
        bits_t.copy_(new)
        return wrong
    dev = check_cuda_operands(operands)
    if bits_t.dtype != torch.int8 or bits_t.stride(1) != 1:
        raise ValueError("bits_t must be int8 with contiguous rows")
    kl = _library()
    smem = kl.lib.stdp_column_epoch_smem_bytes(n_out, n_in)
    limit = kl.lib.stdp_max_shared_optin(dev.index)
    if limit < 0 or smem > limit:
        raise ValueError(
            f"a [{n_out}, {n_in}] readout needs {smem} B of shared memory in "
            f"the epoch kernel's one block; the card allows {limit} B per "
            "block (cudaDevAttrMaxSharedMemoryPerBlockOptin)")
    pre, labels = _byte_mask(pre), labels.contiguous()
    # the three draws share one row stride (the slices of one [n, 3, N_in]
    # draw do) or are made contiguous
    us = [u if u.stride(1) == 1 else u.contiguous()
          for u in (u_pot, u_dep_t, u_dep_w)]
    if len({u.stride(0) for u in us}) != 1:
        us = [u.contiguous() for u in us]
    off = None if out_offset is None else out_offset.contiguous()
    wrong = torch.empty((), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = kl.lib.stdp_column_epoch(
            bits_t.data_ptr(), n_out, n_in, bits_t.stride(0), pre.data_ptr(),
            labels.data_ptr(), labels.element_size(), us[0].data_ptr(),
            us[1].data_ptr(), us[2].data_ptr(), us[0].stride(0),
            None if off is None else off.data_ptr(), n, f32(p_pot),
            f32(p_dep), wrong.data_ptr(), stream_ptr(dev))
    _build.check(kl, err, "stdp_column_epoch launch")
    _LAUNCHES["stdp_column_epoch"] += 1
    return wrong


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
    ``[0, N_out)`` is wrapped once if negative and clamped, as the
    reference's interpret-mode block index is)."""
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
