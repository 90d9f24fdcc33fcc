"""Wrappers of the transposed-port STDP kernels, dispatched by device.

``stdp_column_epoch`` is what the online-learning epoch issues: a whole
epoch of column events from a key, in two launches on the card:
``stdp_epoch_masks`` draws the epoch's uniforms itself (the reference's
threefry bits) and packs the rule's masks, then one warp runs the chain with
the readout in its registers.
``stdp_update_epoch`` is the reference's matrix-RNG scan (every sample's
``stdp_update`` pair under a ``split`` chain) as one epoch from a key, in
three launches on the card: ``stdp_update_keys`` walks the key chain,
``stdp_update_masks`` draws every uniform the rule can read, and the same
one-warp chain runs the samples.
``stdp_column_event`` is one learning neuron's row of the transposed
layout, written in place, with the row index and the gate in device memory.
``stdp_update`` is the full-matrix rule behind ``learning.stdp_update``.

CPU tensors run the plain versions in ``ref.py``; CUDA tensors launch
``csrc/stdp.cu`` (built by ``kernels/_build.py`` at first use) or the call
raises.  Launches are counted (:func:`launch_counts`).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.core import packing
from repro_torch.kernels import _build
from repro_torch.kernels.common import (
    cdiv,
    check_cuda_operands,
    on_cpu,
    stream_ptr,
)
from repro_torch.kernels.stdp.ref import (  # noqa: F401  (re-export)
    column_event_uniforms,
    epoch_slot_words,
    f32,
    stdp_column_epoch_ref,
    stdp_column_event_ref,
    stdp_epoch_masks_ref,
    stdp_update_epoch_ref,
    stdp_update_keys_ref,
    stdp_update_masks_ref,
    stdp_update_ref,
    uniform_threshold,
    update_slot_words,
)

__all__ = [
    "stdp_column_epoch",
    "stdp_epoch_masks",
    "stdp_column_event",
    "stdp_update",
    "stdp_update_epoch",
    "stdp_update_keys",
    "stdp_update_masks",
    "stdp_column_epoch_ref",
    "stdp_epoch_masks_ref",
    "stdp_column_event_ref",
    "stdp_update_ref",
    "stdp_update_epoch_ref",
    "stdp_update_keys_ref",
    "stdp_update_masks_ref",
    "launch_counts",
    "reset_launch_counts",
]

#: kernel launches since the last reset, per kernel
_LAUNCHES = {"stdp_epoch_masks": 0, "stdp_column_epoch": 0,
             "stdp_column_event": 0, "stdp_update": 0,
             "stdp_update_keys": 0, "stdp_update_masks": 0,
             "stdp_update_chain": 0}

_BYTE_TYPES = (torch.bool, torch.int8, torch.uint8)

#: the single event's threads a block and inputs a thread (the kernel's
#: kEventThreads, kEventInputs)
_EVENT_THREADS = 64
_EVENT_INPUTS = 4


@dataclasses.dataclass(frozen=True)
class EventRoute:
    """The single event's geometry: ``vec`` (4-input loads) or byte and
    float loads; ``grid`` blocks of ``_EVENT_THREADS`` along a row's groups
    of 4 inputs."""

    vec: bool
    grid: int


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32, i64, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.stdp_column_event.argtypes = [
        vp, i32, i32, i64, vp, i32, vp, vp, vp, vp, f, f, i32, i32, vp]
    lib.stdp_column_event.restype = i32
    lib.stdp_update.argtypes = [vp, vp, i32, i32, vp, vp, vp, vp, f, f, vp]
    lib.stdp_update.restype = i32
    lib.stdp_epoch_masks.argtypes = [
        vp, vp, i64, i32, i32, i32, vp, i32, vp, ctypes.c_uint,
        ctypes.c_uint, vp]
    lib.stdp_epoch_masks.restype = i32
    lib.stdp_column_epoch.argtypes = [
        vp, i32, i32, i64, vp, i32, vp, i32, i32, vp, vp, vp]
    lib.stdp_column_epoch.restype = i32
    lib.stdp_column_epoch_smem_bytes.argtypes = [i32, i32]
    lib.stdp_column_epoch_smem_bytes.restype = i64
    lib.stdp_max_shared_optin.argtypes = [i32]
    lib.stdp_max_shared_optin.restype = i64
    lib.stdp_update_keys.argtypes = [vp, i32, vp, vp, vp]
    lib.stdp_update_keys.restype = i32
    lib.stdp_update_masks.argtypes = [
        vp, vp, i64, i32, i32, i32, vp, i32, vp, ctypes.c_uint,
        ctypes.c_uint, vp]
    lib.stdp_update_masks.restype = i32
    lib.stdp_update_chain.argtypes = [
        vp, i32, i32, i64, vp, i32, i32, i32, i32, vp, vp, vp]
    lib.stdp_update_chain.restype = i32
    lib.stdp_update_chain_smem_bytes.argtypes = [i32, i32, i32]
    lib.stdp_update_chain_smem_bytes.restype = i64


def _library() -> _build.KernelLibrary:
    return _build.load_library("stdp", _declare)


def _event_route(n_out: int, n_in: int, vec: bool) -> EventRoute:
    """The single event's route for an ``[n_out, n_in]`` matrix: a thread
    a group of 4 inputs of the event row, loaded after its index.  Pure: no
    library call."""
    if min(n_out, n_in) < 1:
        raise ValueError(f"no route for [{n_out}, {n_in}]")
    return EventRoute(
        vec=vec, grid=cdiv(cdiv(n_in, _EVENT_INPUTS), _EVENT_THREADS))


def _event_vec(bits_t, pre, u_pot, u_dep) -> bool:
    """Whether the event's operands take 4-input loads: n_in % 4 == 0, row
    bytes (every row start) and the trace 4-byte aligned, the uniforms
    16-byte aligned."""
    return (bits_t.shape[1] % 4 == 0
            and (bits_t.shape[0] == 1 or bits_t.stride(0) % 4 == 0)
            and bits_t.data_ptr() % 4 == 0 and pre.data_ptr() % 4 == 0
            and u_pot.data_ptr() % 16 == 0 and u_dep.data_ptr() % 16 == 0)


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


def _check_epoch_operands(pre, labels, key, n_in=None) -> None:
    if pre.dim() != 2 or (n_in is not None and pre.shape[1] != n_in):
        raise ValueError(f"pre must be [n, {n_in or 'N_in'}], got "
                         f"{tuple(pre.shape)}")
    _check_vec("labels", labels, pre.shape[0])
    if labels.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"labels must be int32 or int64, got {labels.dtype}")
    if tuple(key.shape) != (2,) or key.dtype != torch.int64:
        raise ValueError(f"key must be an int64[2] key, got "
                         f"{key.dtype}{list(key.shape)}")


def _epoch_route(n_out: int, n_in: int) -> tuple[int, int]:
    """Where the epoch kernel keeps the readout: (words a row, rows a lane)
    in the chain warp's registers, or (0, 0) in shared memory.  Lane o holds
    rows o and o + 32: 8, 16 or 32 words of one row, or 8 or 16 words of
    two.  Wider or taller readouts stay in shared memory."""
    w, rows = packing.packed_width(n_in), -(-n_out // 32)
    for wmax in (8, 16, 32):
        if w <= wmax and (rows == 1 or (rows == 2 and wmax <= 16)):
            return wmax, rows
    return 0, 0


def stdp_epoch_masks(
    pre: torch.Tensor,      # {0,1}[n, N_in] pre-synaptic traces
    labels: torch.Tensor,   # int32/int64 [n] teacher classes
    key: torch.Tensor,      # int64[2] the epoch's key
    n_out: int,
    *,
    p_pot: float,
    p_dep: float,
) -> torch.Tensor:
    """The epoch's draws and rule masks, one slot a sample (see
    ``stdp_epoch_masks_ref``): int32 ``[n, epoch_slot_words(N_in)]``.  On
    the card one launch, one warp a sample, that draws the reference's
    threefry bits itself; the key stays in device memory."""
    _check_epoch_operands(pre, labels, key)
    if n_out < 1:
        raise ValueError(f"n_out must be positive, got {n_out}")
    if on_cpu(pre, labels, key):
        return stdp_epoch_masks_ref(pre, labels, key, n_out, p_pot, p_dep)
    dev = check_cuda_operands({"pre": pre, "labels": labels, "key": key})
    n, n_in = pre.shape
    pre, labels, key = _byte_mask(pre), labels.contiguous(), key.contiguous()
    slots = torch.empty((n, epoch_slot_words(n_in)), dtype=torch.int32,
                        device=dev)
    if n == 0:
        return slots
    kl = _library()
    with torch.cuda.device(dev):
        err = kl.lib.stdp_epoch_masks(
            slots.data_ptr(), pre.data_ptr(), pre.stride(0), n, n_in, n_out,
            labels.data_ptr(), labels.element_size(), key.data_ptr(),
            uniform_threshold(p_pot), uniform_threshold(p_dep),
            stream_ptr(dev))
    _build.check(kl, err, "stdp_epoch_masks launch")
    _LAUNCHES["stdp_epoch_masks"] += 1
    return slots


def _epoch_chain(bits_t: torch.Tensor, slots: torch.Tensor,
                 out_offset: torch.Tensor | None,
                 stamps: torch.Tensor | None = None) -> torch.Tensor:
    """The epoch's chain on the card over ``stdp_epoch_masks``' slots, in
    place; returns the wrong count (int32 device scalar).  ``stamps``
    (int64[4], or None) gets the kernel's clock64 at its start, the chain's
    start and end, and after the write-back."""
    n_out, n_in = bits_t.shape
    dev = bits_t.device
    kl = _library()
    wmax, rows = _epoch_route(n_out, n_in)
    wrong = torch.empty((), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = kl.lib.stdp_column_epoch(
            bits_t.data_ptr(), n_out, n_in, bits_t.stride(0),
            slots.data_ptr(), slots.shape[0],
            None if out_offset is None else out_offset.data_ptr(), wmax,
            rows, wrong.data_ptr(),
            None if stamps is None else stamps.data_ptr(), stream_ptr(dev))
    _build.check(kl, err, "stdp_column_epoch launch")
    _LAUNCHES["stdp_column_epoch"] += 1
    return wrong


def stdp_column_epoch(
    bits_t: torch.Tensor,   # {0,1} int8 [N_out, N_in], updated in place
    pre: torch.Tensor,      # {0,1}[n, N_in] pre-synaptic traces
    labels: torch.Tensor,   # int32/int64 [n] teacher classes
    key: torch.Tensor,      # int64[2] the epoch's key
    out_offset: torch.Tensor | None = None,   # float32[N_out]
    *,
    p_pot: float,
    p_dep: float,
) -> torch.Tensor:
    """A whole supervised column-event epoch on ``bits_t``, in place, with
    sample i's draws ``column_event_uniforms(key, i)``; returns the number of
    wrong samples as an int32 scalar on the device.  On the CPU: the draws
    through ``core/prng.py``, then ``stdp_column_epoch_ref``.  On the card
    two launches and no host sync: ``stdp_epoch_masks`` draws and packs over
    the whole card, then one block's warp runs the chain with the readout
    in its registers (``_epoch_route``) or in shared memory; a readout too
    large for one block raises ``ValueError``."""
    if bits_t.dim() != 2:
        raise ValueError(f"bits_t must be [N_out, N_in], got "
                         f"{tuple(bits_t.shape)}")
    n_out, n_in = bits_t.shape
    _check_epoch_operands(pre, labels, key, n_in)
    operands = {"bits_t": bits_t, "pre": pre, "labels": labels, "key": key}
    if out_offset is not None:
        _check_vec("out_offset", out_offset, n_out, torch.float32)
        operands["out_offset"] = out_offset
    if on_cpu(*operands.values()):
        u = column_event_uniforms(key, torch.arange(pre.shape[0]), n_in)
        new, wrong = stdp_column_epoch_ref(bits_t, pre, labels, *u,
                                           out_offset, p_pot, p_dep)
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
    slots = stdp_epoch_masks(pre, labels, key, n_out, p_pot=p_pot,
                             p_dep=p_dep)
    off = None if out_offset is None else out_offset.contiguous()
    return _epoch_chain(bits_t, slots, off)


def stdp_update_keys(key: torch.Tensor, n: int,
                     stamps: torch.Tensor | None = None) -> torch.Tensor:
    """The matrix-RNG scan's key chain (see ``stdp_update_keys_ref``):
    int32 words ``[n, 2]``.  On the card one launch of one thread, the key
    read in device memory; ``stamps`` (int64[2], or None) gets its clock64
    at the start and the end."""
    if tuple(key.shape) != (2,) or key.dtype != torch.int64:
        raise ValueError(f"key must be an int64[2] key, got "
                         f"{key.dtype}{list(key.shape)}")
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    if on_cpu(key):
        return stdp_update_keys_ref(key, n)
    dev = check_cuda_operands({"key": key})
    keys = torch.empty((n, 2), dtype=torch.int32, device=dev)
    if n == 0:
        return keys
    key = key.contiguous()
    kl = _library()
    with torch.cuda.device(dev):
        err = kl.lib.stdp_update_keys(
            keys.data_ptr(), n, key.data_ptr(),
            None if stamps is None else stamps.data_ptr(), stream_ptr(dev))
    _build.check(kl, err, "stdp_update_keys launch")
    _LAUNCHES["stdp_update_keys"] += 1
    return keys


def stdp_update_masks(
    pre: torch.Tensor,      # {0,1}[n, N_in] pre-synaptic traces
    labels: torch.Tensor,   # int32/int64 [n] teacher classes
    keys: torch.Tensor,     # int32 words [n, 2]: stdp_update_keys
    n_out: int,
    *,
    p_pot: float,
    p_dep: float,
) -> torch.Tensor:
    """The matrix-RNG epoch's draws and rule masks, one slot a sample (see
    ``stdp_update_masks_ref``): int32 ``[n, update_slot_words(N_in,
    N_out)]``.  On the card one launch, one warp a (sample, row) pair, that
    derives the row's keys and draws the reference's threefry bits itself."""
    if pre.dim() != 2:
        raise ValueError(f"pre must be [n, N_in], got {tuple(pre.shape)}")
    n, n_in = pre.shape
    _check_vec("labels", labels, n)
    if labels.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"labels must be int32 or int64, got {labels.dtype}")
    if tuple(keys.shape) != (n, 2) or keys.dtype != torch.int32:
        raise ValueError(f"keys must be int32[{n}, 2], got "
                         f"{keys.dtype}{list(keys.shape)}")
    if n_out < 1:
        raise ValueError(f"n_out must be positive, got {n_out}")
    if on_cpu(pre, labels, keys):
        return stdp_update_masks_ref(pre, labels, keys, n_out, p_pot, p_dep)
    dev = check_cuda_operands({"pre": pre, "labels": labels, "keys": keys})
    pre, labels, keys = _byte_mask(pre), labels.contiguous(), keys.contiguous()
    slots = torch.empty((n, update_slot_words(n_in, n_out)),
                        dtype=torch.int32, device=dev)
    if n == 0:
        return slots
    kl = _library()
    with torch.cuda.device(dev):
        err = kl.lib.stdp_update_masks(
            slots.data_ptr(), pre.data_ptr(), pre.stride(0), n, n_in, n_out,
            labels.data_ptr(), labels.element_size(), keys.data_ptr(),
            uniform_threshold(p_pot), uniform_threshold(p_dep),
            stream_ptr(dev))
    _build.check(kl, err, "stdp_update_masks launch")
    _LAUNCHES["stdp_update_masks"] += 1
    return slots


def _update_shift(kl: _build.KernelLibrary, n_out: int, n_in: int,
                  dev: torch.device) -> int:
    """log2 of the slots one bulk copy of the matrix-RNG chain fetches: 16
    where the ring fits the block's shared memory, fewer for wide slots;
    raises ``ValueError`` when not even one a copy fits."""
    limit = kl.lib.stdp_max_shared_optin(dev.index)
    for shift in range(4, -1, -1):
        smem = kl.lib.stdp_update_chain_smem_bytes(n_out, n_in, shift)
        if 0 <= limit and smem <= limit:
            return shift
    raise ValueError(
        f"a [{n_out}, {n_in}] readout and its matrix-RNG slots need {smem} B "
        f"of shared memory in the epoch kernel's one block; the card allows "
        f"{limit} B per block (cudaDevAttrMaxSharedMemoryPerBlockOptin)")


def _update_chain(bits_t: torch.Tensor, slots: torch.Tensor, shift: int,
                  stamps: torch.Tensor | None = None) -> torch.Tensor:
    """The matrix-RNG epoch's chain on the card over ``stdp_update_masks``'
    slots, in place; returns the update count (int32 device scalar).
    ``stamps`` as for ``_epoch_chain``."""
    n_out, n_in = bits_t.shape
    dev = bits_t.device
    kl = _library()
    wmax, rows = _epoch_route(n_out, n_in)
    count = torch.empty((), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = kl.lib.stdp_update_chain(
            bits_t.data_ptr(), n_out, n_in, bits_t.stride(0),
            slots.data_ptr(), slots.shape[0], shift, wmax, rows,
            count.data_ptr(), None if stamps is None else stamps.data_ptr(),
            stream_ptr(dev))
    _build.check(kl, err, "stdp_update_chain launch")
    _LAUNCHES["stdp_update_chain"] += 1
    return count


def stdp_update_epoch(
    bits_t: torch.Tensor,   # {0,1} int8 [N_out, N_in], updated in place
    pre: torch.Tensor,      # {0,1}[n, N_in] pre-synaptic traces
    labels: torch.Tensor,   # int32/int64 [n] teacher classes
    key: torch.Tensor,      # int64[2] the epoch's key
    *,
    p_pot: float,
    p_dep: float,
) -> torch.Tensor:
    """The reference's matrix-RNG scan over ``n`` samples on ``bits_t``, in
    place, with its draws (see ``stdp_update_epoch_ref``); returns the
    update count (2 a wrong sample) as an int32 scalar on the device.  On
    the CPU: ``stdp_update_epoch_ref``.  On the card three launches and no
    host sync (none when n is 0): ``stdp_update_keys``,
    ``stdp_update_masks``, then the chain on one warp with the readout in
    its registers (``_epoch_route``) or in shared memory; a readout too
    large for one block raises ``ValueError`` before any launch."""
    if bits_t.dim() != 2:
        raise ValueError(f"bits_t must be [N_out, N_in], got "
                         f"{tuple(bits_t.shape)}")
    n_out, n_in = bits_t.shape
    _check_epoch_operands(pre, labels, key, n_in)
    operands = {"bits_t": bits_t, "pre": pre, "labels": labels, "key": key}
    if on_cpu(*operands.values()):
        new, count = stdp_update_epoch_ref(bits_t, pre, labels, key, p_pot,
                                           p_dep)
        bits_t.copy_(new)
        return count
    dev = check_cuda_operands(operands)
    if bits_t.dtype != torch.int8 or bits_t.stride(1) != 1:
        raise ValueError("bits_t must be int8 with contiguous rows")
    shift = _update_shift(_library(), n_out, n_in, dev)
    n = pre.shape[0]
    if n == 0:
        return torch.zeros((), dtype=torch.int32, device=dev)
    keys = stdp_update_keys(key, n)
    slots = stdp_update_masks(pre, labels, keys, n_out, p_pot=p_pot,
                              p_dep=p_dep)
    return _update_chain(bits_t, slots, shift)


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
    route = _event_route(n_out, n_in, _event_vec(bits_t, pre, u_pot, u_dep))
    kl = _library()
    with torch.cuda.device(dev):
        err = kl.lib.stdp_column_event(
            bits_t.data_ptr(), n_out, n_in, bits_t.stride(0), col.data_ptr(),
            col.element_size(), apply.data_ptr(), pre.data_ptr(),
            u_pot.data_ptr(), u_dep.data_ptr(), f32(p_pot), f32(p_dep),
            int(route.vec), route.grid, stream_ptr(dev))
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
