"""Wrappers of the popcount-domain CIM MAC kernels, dispatched by device.

The tensor's device picks the datapath, and nothing else does:

* CPU tensors run the plain PyTorch versions in ``ref.py`` (public, and
  re-exported here);
* CUDA tensors launch the hand-written kernels of
  ``csrc/cim_popcount.cu`` (built by ``_build.py`` at first use) — a build
  or launch failure raises, it never falls back to the plain version.

Each wrapper checks dtype, shape, contiguity and device, allocates its
outputs with ``torch.empty`` on the current stream's device, and counts its
kernel launches (:func:`launch_counts`), so a run can show that its main path
went through the kernels.

``esam_cascade_popcount`` is the single-launch cascade: the caller stacks
every tile's weight planes and thresholds once (``stack_cascade_operands``,
done at plan-build time by ``EsamPlan``) and each call runs MAC, IF fire,
re-pack and the next tile in one launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import packing
from repro_torch.core.packing import LANE_BITS, WORD_DTYPE
from repro_torch.kernels.common import pad_dim_to, round_up
from repro_torch.kernels.cim_popcount import _build
from repro_torch.kernels.cim_popcount.ref import (  # noqa: F401  (re-export)
    cim_popcount_ref,
    esam_cascade_popcount_ref,
    esam_layer_popcount_ref,
)

__all__ = [
    "cim_popcount_matmul",
    "esam_cascade_popcount",
    "stack_cascade_operands",
    "cascade_geometry",
    "launch_counts",
    "reset_launch_counts",
    "cim_popcount_ref",
    "esam_layer_popcount_ref",
    "esam_cascade_popcount_ref",
    "VTH_NEVER_FIRE",
]

#: vth padding for columns past a tile's real width — no spike plane can
#: reach it (V <= n_in < 2^30), so padded neurons provably never fire.
VTH_NEVER_FIRE = 1 << 30

#: lane alignment of per-tile output widths in the stacked slabs (the
#: reference's layout, kept so the operands are the same arrays)
_COL_PAD = 128

#: most batch rows one block of the mega cascade carries through every tile
#: by default (see ``_default_block_b``)
CASCADE_MAX_BLOCK_B = 8

#: kernel launches since the last reset, per kernel
_LAUNCHES = {"mega_cascade": 0, "popcount_mac": 0}


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def _check_words(x: torch.Tensor, name: str) -> None:
    if x.dtype != WORD_DTYPE:
        raise TypeError(f"{name}: expected int32 packed words, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"{name}: expected 2-D words, got {tuple(x.shape)}")


def _check_cuda(tensors: dict[str, torch.Tensor]) -> torch.device:
    """All operands on one CUDA device; returns it."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"operands on different devices: "
                         f"{ {k: str(t.device) for k, t in tensors.items()} }")
    dev = devices.pop()
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    return dev


def _stream(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _int_array(values) -> ctypes.Array:
    return (ctypes.c_int * len(values))(*values)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _default_block_b(batch: int, device_index: int) -> int:
    """Rows per block: spread the batch over the card's SMs — one row per
    block while the batch is no larger than the SM count — up to
    ``CASCADE_MAX_BLOCK_B`` rows.  Each block stages every tile's weights
    once, so more rows per block amortise that, while fewer rows put more
    blocks (and warps) in flight.  On an NVIDIA H100 80GB HBM3 (700 W
    limit) a 128-row batch ran fastest at 1 row per block and a 4096-row
    batch at 8 (chip_smoke.py's ``block_sweep`` lines)."""
    rows = -(-batch // _sm_count(device_index))
    return max(1, min(CASCADE_MAX_BLOCK_B, rows))


@functools.lru_cache(maxsize=None)
def _cascade_launch_args(topology: tuple[int, ...], device_index: int,
                         block_b: int):
    """The cascade's ctypes geometry arrays, once per launch configuration;
    raises if a block would need more shared memory than the card allows."""
    lib = _build.load_library().lib
    g = cascade_geometry(topology)
    n_out = _int_array(topology[1:])
    w_words = _int_array(g["w_words"])
    smem = lib.cim_mega_cascade_smem_bytes(
        g["n_tiles"], n_out, w_words, block_b)
    limit = lib.cim_max_shared_optin(device_index)
    if smem < 0 or limit < 0 or smem > limit:
        raise ValueError(
            f"topology {topology} needs {smem} B of shared memory per block; "
            f"the card allows {limit} B")
    return n_out, w_words


def cim_popcount_matmul(packed: torch.Tensor,
                        planes: torch.Tensor) -> torch.Tensor:
    """V_mem int32[B, N] = 2*popcount(s & w) - popcount(s); nothing unpacks.

    packed: int32 words [B, W] (rows may be strided, words contiguous);
    planes: int32 words [N, W], likewise.
    """
    _check_words(packed, "packed")
    _check_words(planes, "planes")
    B, W = packed.shape
    N, W2 = planes.shape
    if W != W2:
        raise ValueError(f"word counts differ: {tuple(packed.shape)} vs "
                         f"{tuple(planes.shape)}")
    if packed.device.type == "cpu" and planes.device.type == "cpu":
        return cim_popcount_ref(packed, planes)
    dev = _check_cuda({"packed": packed, "planes": planes})
    if packed.stride(1) != 1 or planes.stride(1) != 1:
        raise ValueError("packed and planes need contiguous words (stride 1)")
    out = torch.empty((B, N), dtype=torch.int32, device=dev)
    if B == 0:
        return out
    kl = _build.load_library()
    with torch.cuda.device(dev):
        err = kl.lib.cim_popcount_mac(
            packed.data_ptr(), packed.stride(0), planes.data_ptr(),
            planes.stride(0), out.data_ptr(), B, N, W, _stream(dev))
    _build.check(kl.lib, err, "popcount_mac launch")
    _LAUNCHES["popcount_mac"] += 1
    return out


# --------------------------------------------------------------------- #
# single-launch cascade
# --------------------------------------------------------------------- #
def cascade_geometry(topology: tuple[int, ...]) -> dict:
    """Static padding geometry shared by the stacker and the cascade.

    Per tile t (K_t = topology[t] -> N_t = topology[t+1]):
      n_pad[t]    output width padded to the 128-lane grid
      w_words[t]  real input words ceil(K_t/32)
    """
    n_tiles = len(topology) - 1
    if n_tiles < 1:
        raise ValueError(f"topology {topology} has no tile")
    n_pad = tuple(round_up(n, _COL_PAD) for n in topology[1:])
    w_words = tuple(packing.packed_width(k) for k in topology[:-1])
    return {
        "n_tiles": n_tiles,
        "n_pad": n_pad,
        "w_words": w_words,
        "n_max_pad": max(n_pad),
        "w_max": max(w_words),
    }


def stack_cascade_operands(weight_planes, vth, topology):
    """Stack per-tile planes/thresholds into the cascade's slabs.

    weight_planes: per tile int32 words[N_t, ceil(K_t/32)]; vth: per tile
    int32[N_t].  Returns (w_stack int32 words[n_tiles, n_max_pad, w_max],
    vth_stack int32[max(n_tiles-1, 1), n_max_pad]) — the reference's arrays.
    Plane padding is zero (AND-dead); vth padding is ``VTH_NEVER_FIRE`` so
    padded neurons stay silent.  Built once per parameter set.
    """
    g = cascade_geometry(tuple(topology))
    n_tiles, n_max_pad, w_max = g["n_tiles"], g["n_max_pad"], g["w_max"]
    if len(weight_planes) != n_tiles:
        raise ValueError(f"{len(weight_planes)} planes for {n_tiles} tiles")
    w_stack = torch.stack([
        pad_dim_to(pad_dim_to(p, n_max_pad, 0), w_max, 1)
        for p in weight_planes
    ])
    vth_stack = torch.full((max(n_tiles - 1, 1), n_max_pad), VTH_NEVER_FIRE,
                           dtype=torch.int32, device=w_stack.device)
    for t, th in enumerate(vth[: n_tiles - 1]):
        vth_stack[t, : th.shape[0]] = th.to(torch.int32)
    return w_stack, vth_stack


def esam_cascade_popcount(
    packed: torch.Tensor,      # int32 words[B, ceil(n_in/32)]
    w_stack: torch.Tensor,     # int32 words[n_tiles, n_max_pad, w_max]
    vth_stack: torch.Tensor,   # int32[n_hidden, n_max_pad]
    *,
    topology: tuple[int, ...],
    block_b: int | None = None,
) -> tuple[torch.Tensor, tuple]:
    """The whole tile cascade: on the card, in ONE kernel launch.

    ``block_b`` is the batch rows one thread block carries through every
    tile (the grid is ``ceil(B / block_b)`` blocks); ``None`` picks it from
    the batch and the card (``_default_block_b``).  Returns (logits
    int32[B, n_cls], fired hidden planes tuple of int32 words[B, N_t/32]).
    A one-tile network has no cascade and goes to
    :func:`cim_popcount_matmul`, as in the reference.
    """
    topology = tuple(topology)
    g = cascade_geometry(topology)
    n_tiles = g["n_tiles"]
    for n in topology[1:-1]:
        if n % LANE_BITS:
            raise ValueError(f"hidden widths must be 32-aligned: {topology}")
    _check_words(packed, "packed")
    B = packed.shape[0]
    if packed.shape[1] != g["w_words"][0]:
        raise ValueError(f"packed has {packed.shape[1]} words, topology "
                         f"{topology} needs {g['w_words'][0]}")
    want = (n_tiles, g["n_max_pad"], g["w_max"])
    if tuple(w_stack.shape) != want or w_stack.dtype != WORD_DTYPE:
        raise ValueError(f"w_stack must be int32{list(want)}, got "
                         f"{w_stack.dtype}{list(w_stack.shape)}")
    want_v = (max(n_tiles - 1, 1), g["n_max_pad"])
    if tuple(vth_stack.shape) != want_v or vth_stack.dtype != torch.int32:
        raise ValueError(f"vth_stack must be int32{list(want_v)}, got "
                         f"{vth_stack.dtype}{list(vth_stack.shape)}")
    on_cpu = {t.device.type for t in (packed, w_stack, vth_stack)} == {"cpu"}
    if on_cpu:
        planes = tuple(
            w_stack[t, : topology[t + 1], : g["w_words"][t]]
            for t in range(n_tiles))
        vth = tuple(
            vth_stack[t, : topology[t + 1]] for t in range(n_tiles - 1)
        ) + (None,)
        return esam_cascade_popcount_ref(packed, planes, vth)
    dev = _check_cuda(
        {"packed": packed, "w_stack": w_stack, "vth_stack": vth_stack})
    if n_tiles == 1:
        return (cim_popcount_matmul(
            packed, w_stack[0, : topology[1], : g["w_words"][0]]), ())
    for name, t in (("packed", packed), ("w_stack", w_stack),
                    ("vth_stack", vth_stack)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    hidden_words = [n // LANE_BITS for n in topology[1:-1]]
    logits = torch.empty((B, topology[-1]), dtype=torch.int32, device=dev)
    fired_buf = torch.empty((B * sum(hidden_words),), dtype=WORD_DTYPE,
                            device=dev)
    fired, off = [], 0
    for w in hidden_words:
        fired.append(fired_buf[off: off + B * w].view(B, w))
        off += B * w
    if B == 0:
        return logits, tuple(fired)
    kl = _build.load_library()
    if block_b is None:
        block_b = _default_block_b(B, dev.index)
    if block_b < 1:
        raise ValueError(f"block_b must be >= 1, got {block_b}")
    n_out, w_words = _cascade_launch_args(topology, dev.index, block_b)
    with torch.cuda.device(dev):
        err = kl.lib.cim_mega_cascade(
            packed.data_ptr(), B, w_stack.data_ptr(), vth_stack.data_ptr(),
            logits.data_ptr(), fired_buf.data_ptr(), n_tiles, n_out, w_words,
            g["n_max_pad"], g["w_max"], block_b, _stream(dev))
    _build.check(kl.lib, err, "mega_cascade launch")
    _LAUNCHES["mega_cascade"] += 1
    return logits, tuple(fired)
