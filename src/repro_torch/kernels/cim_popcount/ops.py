"""Wrappers of the popcount-domain CIM MAC kernels, dispatched by device.

The tensor's device picks the datapath, and nothing else does:

* CPU tensors run the plain PyTorch versions in ``ref.py`` (public, and
  re-exported here);
* CUDA tensors launch the hand-written kernels of
  ``csrc/cim_popcount.cu`` (built by ``kernels/_build.py`` at first use) — a
  build or launch failure raises, it never falls back to the plain version.

Each wrapper checks dtype, shape, contiguity and device, allocates its
outputs with ``torch.empty`` on the current stream's device, and counts its
kernel launches (:func:`launch_counts`), so a run can show that its main path
went through the kernels.

``esam_cascade_popcount`` is the single-launch cascade: the caller stacks
every tile's weight planes and thresholds once (``stack_cascade_operands``)
and regroups them for the card (``cascade_tiles``), both at plan-build time
in ``EsamPlan``, and each call runs MAC, IF fire, re-pack and the next tile
in one launch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.core import packing
from repro_torch.core.packing import LANE_BITS, WORD_DTYPE
from repro_torch.kernels import _build
from repro_torch.kernels.common import (
    cdiv,
    check_cuda_operands,
    on_cpu,
    pad_dim_to,
    round_up,
    stream_ptr,
)
from repro_torch.kernels.cim_popcount.ref import (  # noqa: F401  (re-export)
    cim_popcount_ref,
    esam_cascade_popcount_ref,
    esam_layer_popcount_ref,
)

__all__ = [
    "cim_popcount_matmul",
    "esam_layer_popcount",
    "esam_cascade_popcount",
    "stack_cascade_operands",
    "cascade_tiles",
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

#: tiles the card's cascade takes (``kMaxTiles``)
_MAX_TILES = 16

#: CTAs of a mega cascade cluster, unless a tile has one group (then 1) or
#: a CTA's share does not fit shared memory (then doubled, up to 16)
_CLUSTER = 2
#: batch rows a slice: batch // _ROW_BATCH, from 1 to _MAX_ROWS (a geometry
#: sweep on an NVIDIA H100 80GB HBM3 picked 64; the b1 MAC takes up to the
#: mma's 16 rows a task: PERF.md)
_ROW_BATCH, _MAX_ROWS = 64, 16
#: rows a slice from which the cascade's MAC runs on the b1 tensor-core
#: product (a warp a slice x 32-neuron group); below, on the popc unit (a
#: lane a neuron, a warp a row x group).  At the paper topology on an NVIDIA
#: H100 80GB HBM3 the popc unit wins at a serving round's 2 rows and at 4,
#: and loses from 5 (chip_smoke.py's mega_geometry lines at B 128, 256 and
#: 320; PERF.md)
_B1_MIN_ROWS = 5

#: rows and neurons of one warp's tile in ``popcount_fire``'s tensor-core
#: kernel (one b1 mma's m, and 8 mma n-tiles)
_FIRE_TILE_ROWS, _FIRE_TILE_NEURONS = 16, 64
#: warps a block of ``popcount_fire`` (``kFireWarps`` in the kernel): 1, 2
#: and 4 came out within the spread of each other at every path's shape on
#: an NVIDIA H100 80GB HBM3, 8 slower (PERF.md)
_FIRE_WARPS = 2

#: kernel launches since the last reset, per kernel
_LAUNCHES = {"mega_cascade": 0, "popcount_fire": 0, "popcount_mac": 0}


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


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    ip = ctypes.POINTER(ctypes.c_int)
    lib.cim_mega_cascade.argtypes = [
        vp, i32, vp, i64, vp, vp, i32, ip, ip, i32, i32, i32, i32, vp]
    lib.cim_mega_cascade.restype = i32
    lib.cim_mega_cascade_smem_bytes.argtypes = [i32, ip, ip, i32, i32]
    lib.cim_mega_cascade_smem_bytes.restype = i64
    lib.cim_mega_cascade_max_clusters.argtypes = [i32, ip, ip, i32, i32, i32]
    lib.cim_mega_cascade_max_clusters.restype = i32
    lib.cim_mega_cascade_fixed_words.argtypes = [i32]
    lib.cim_mega_cascade_fixed_words.restype = i32
    lib.cim_popcount_fire.argtypes = [
        vp, i64, vp, i64, vp, vp, i32, i32, i32, i32, i32, i32, i32, vp]
    lib.cim_popcount_fire.restype = i32
    lib.cim_popcount_mac.argtypes = [vp, i64, vp, i64, vp, i32, i32, i32,
                                     i32, i32, i32, vp]
    lib.cim_popcount_mac.restype = i32
    lib.cim_max_shared_optin.argtypes = [i32]
    lib.cim_max_shared_optin.restype = i64


def _library() -> _build.KernelLibrary:
    return _build.load_library("cim_popcount", _declare)


def _int_array(values) -> ctypes.Array:
    return (ctypes.c_int * len(values))(*values)


@functools.lru_cache(maxsize=None)
def _cascade_arrays(topology: tuple[int, ...]) -> tuple:
    """(n_out, w_words) of a topology as the launcher's ctypes arrays."""
    return (_int_array(topology[1:]),
            _int_array(cascade_geometry(topology)["w_words"]))


class CascadeRoute(NamedTuple):
    """How ``mega_cascade`` runs one topology and batch on one card."""

    #: CTAs of a cluster; each owns ceil(groups / cluster) of every tile's
    #: 32-neuron groups
    cluster: int
    #: batch rows a cluster carries through every tile at a time (a slice)
    rows: int
    #: slices of the batch, ceil(B / rows); the last one is partly empty
    #: when rows does not divide B
    slices: int
    #: clusters launched; each walks slices/clusters slices in turn
    clusters: int
    #: dynamic shared memory of one CTA, bytes
    smem: int
    #: per tile, whether its popc MAC's word count is fixed at compile time
    fixed_words: tuple
    #: the MAC: "b1" (the tensor-core product, a warp a slice x 32-neuron
    #: group) from ``_B1_MIN_ROWS`` rows a slice, else "popc" (a lane a
    #: neuron)
    mac: str


@functools.lru_cache(maxsize=None)
def _cascade_route(topology: tuple[int, ...], batch: int,
                   device_index: int, *, rows: int | None = None,
                   mac: str | None = None) -> CascadeRoute:
    """The mega cascade's geometry, derived from the topology, the batch and
    the card: clusters of ``_CLUSTER`` CTAs (1 where every hidden tile is
    one 32-neuron group), doubled up to 16 while a CTA's share of the tiles
    does not fit shared memory; one row a slice for every ``_ROW_BATCH``
    rows of the batch, at most ``_MAX_ROWS``; the MAC by the rows a slice
    (:func:`_cascade_mac`); as many clusters as slices, at most as many as
    the card holds at once.  ``rows`` and ``mac`` pin those two instead
    (to time or check a route the launcher does not pick).  Raises when the
    topology fits no cluster."""
    lib = _library().lib
    g = cascade_geometry(topology)
    n_tiles = g["n_tiles"]
    if n_tiles > _MAX_TILES:
        raise ValueError(f"the card's cascade takes at most {_MAX_TILES} "
                         f"tiles, got {n_tiles}")
    n_out, w_words = _cascade_arrays(topology)
    limit = lib.cim_max_shared_optin(device_index)

    def smem(cluster: int, rows: int) -> int:
        return lib.cim_mega_cascade_smem_bytes(n_tiles, n_out, w_words,
                                               cluster, rows)

    cluster = 1 if max(topology[1:-1]) <= LANE_BITS else _CLUSTER
    while cluster < 16 and not 0 <= smem(cluster, 1) <= limit:
        cluster *= 2
    if limit < 0 or not 0 <= smem(cluster, 1) <= limit:
        raise ValueError(
            f"topology {topology} needs {smem(cluster, 1)} B of shared memory "
            f"per CTA in clusters of {cluster}; the card allows {limit} B")
    if rows is None:
        rows = max(1, min(_MAX_ROWS, batch // _ROW_BATCH))
        while rows > 1 and smem(cluster, rows) > limit:
            rows -= 1
    slices = cdiv(batch, rows)
    mac = mac or _cascade_mac(rows)
    active = lib.cim_mega_cascade_max_clusters(n_tiles, n_out, w_words,
                                               cluster, rows, _MAC_CODE[mac])
    if active < 1:
        raise ValueError(f"no cluster of {cluster} CTAs for topology "
                         f"{topology} fits the card (code {active})")
    return CascadeRoute(
        cluster=cluster, rows=rows, slices=slices,
        clusters=min(slices, active), smem=smem(cluster, rows),
        fixed_words=tuple(bool(lib.cim_mega_cascade_fixed_words(w))
                          for w in g["w_words"]),
        mac=mac)


def _cascade_mac(rows: int) -> str:
    """The cascade's MAC at ``rows`` rows a slice: the b1 product from
    ``_B1_MIN_ROWS`` rows, the popc unit below (PERF.md has both times at
    B 128 and 1024)."""
    return "b1" if rows >= _B1_MIN_ROWS else "popc"


#: the launcher's code of each MAC (``CascadeMac`` in the kernel)
_MAC_CODE = {"popc": 0, "b1": 1}


class FireRoute(NamedTuple):
    """How ``popcount_fire`` and ``popcount_mac`` (one tensor-core kernel,
    two epilogues) run one tile's shape: the launch grid."""

    #: the grid: blocks along the rows (``_FIRE_WARPS`` warps of 16 rows
    #: each), blocks along the neurons (64 each); rows and neurons past B
    #: and N load as zero and are not stored
    grid: tuple
    #: operands loaded two words (8 bytes) at a time
    paired: bool


def _fire_route(B: int, N: int, paired: bool) -> FireRoute:
    """The tile kernel's grid for B rows and N neurons: one warp a 16 x 64
    tile, ``_FIRE_WARPS`` warps a block.  Pure: no library call, so it can
    be checked anywhere."""
    if min(B, N) < 1:
        raise ValueError(f"no route for B={B} N={N}")
    return FireRoute(
        grid=(cdiv(B, _FIRE_WARPS * _FIRE_TILE_ROWS),
              cdiv(N, _FIRE_TILE_NEURONS)),
        paired=paired)


def _paired(packed: torch.Tensor, planes: torch.Tensor) -> bool:
    """Whether the kernel may load both operands two words at a time: an
    even word count and row strides, both operands 8-byte aligned (3-5 %
    faster than one word a load at the paths' shapes on an NVIDIA H100
    80GB HBM3; PERF.md)."""
    return (packed.shape[1] % 2 == 0 and packed.stride(0) % 2 == 0
            and planes.stride(0) % 2 == 0 and packed.data_ptr() % 8 == 0
            and planes.data_ptr() % 8 == 0)


def _route_for(packed: torch.Tensor, planes: torch.Tensor) -> FireRoute:
    """The route ``popcount_fire`` / ``popcount_mac`` take for these CUDA
    operands (``_fire_route`` on their shape and layout)."""
    return _fire_route(packed.shape[0], planes.shape[0],
                       _paired(packed, planes))


def _check_tile_operands(packed: torch.Tensor,
                         planes: torch.Tensor) -> tuple[int, int, int]:
    """(B, N, W) of one tile's int32 words, or raises."""
    _check_words(packed, "packed")
    _check_words(planes, "planes")
    B, W = packed.shape
    N, W2 = planes.shape
    if W != W2:
        raise ValueError(f"word counts differ: {tuple(packed.shape)} vs "
                         f"{tuple(planes.shape)}")
    return B, N, W


def cim_popcount_matmul(packed: torch.Tensor,
                        planes: torch.Tensor) -> torch.Tensor:
    """V_mem int32[B, N] = 2*popcount(s & w) - popcount(s); nothing unpacks.

    packed: int32 words [B, W] (rows may be strided, words contiguous);
    planes: int32 words [N, W], likewise.
    """
    B, N, W = _check_tile_operands(packed, planes)
    if on_cpu(packed, planes):
        return cim_popcount_ref(packed, planes)
    dev = check_cuda_operands({"packed": packed, "planes": planes})
    if packed.stride(1) != 1 or planes.stride(1) != 1:
        raise ValueError("packed and planes need contiguous words (stride 1)")
    out = torch.empty((B, N), dtype=torch.int32, device=dev)
    if B == 0:
        return out
    kl = _library()
    route = _route_for(packed, planes)
    with torch.cuda.device(dev):
        err = kl.lib.cim_popcount_mac(
            packed.data_ptr(), packed.stride(0), planes.data_ptr(),
            planes.stride(0), out.data_ptr(), B, N, W, *route.grid,
            int(route.paired), stream_ptr(dev))
    _build.check(kl, err, "popcount_mac launch")
    _LAUNCHES["popcount_mac"] += 1
    return out


def esam_layer_popcount(
    packed: torch.Tensor,
    planes: torch.Tensor,
    vth: torch.Tensor,
    *,
    pack_output: bool = True,
) -> torch.Tensor:
    """One tile's fire on the popcount plane: MAC, IF compare, re-pack.

    packed: int32 words [B, W]; planes: int32 words [N, W]; vth: int32[N].
    Returns int32 words [B, N/32] when ``pack_output`` (N must be a multiple
    of 32), else int8 {0,1}[B, N]; V_mem never leaves the kernel.
    """
    B, N, W = _check_tile_operands(packed, planes)
    if tuple(vth.shape) != (N,):
        raise ValueError(f"vth {tuple(vth.shape)} for {N} neurons")
    if pack_output and N % LANE_BITS:
        raise ValueError(f"packed output needs N % 32 == 0, got N={N}")
    if on_cpu(packed, planes, vth):
        return esam_layer_popcount_ref(packed, planes, vth,
                                       pack_output=pack_output)
    dev = check_cuda_operands({"packed": packed, "planes": planes, "vth": vth})
    if packed.stride(1) != 1 or planes.stride(1) != 1:
        raise ValueError("packed and planes need contiguous words (stride 1)")
    vth = vth.to(torch.int32).contiguous()
    out = (torch.empty((B, N // LANE_BITS), dtype=WORD_DTYPE, device=dev)
           if pack_output else torch.empty((B, N), dtype=torch.int8, device=dev))
    if B == 0:
        return out
    kl = _library()
    route = _route_for(packed, planes)
    with torch.cuda.device(dev):
        err = kl.lib.cim_popcount_fire(
            packed.data_ptr(), packed.stride(0), planes.data_ptr(),
            planes.stride(0), vth.data_ptr(), out.data_ptr(), B, N, W,
            *route.grid, int(route.paired), int(pack_output),
            stream_ptr(dev))
    _build.check(kl, err, "popcount_fire launch")
    _LAUNCHES["popcount_fire"] += 1
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


def cascade_tiles(w_stack: torch.Tensor, vth_stack: torch.Tensor,
                  topology) -> torch.Tensor:
    """The stacked operands regrouped for the card's cascade: per tile t,
    per 32-neuron group g, a block of ``(w8 + 1) x 32`` words (w8 = w_t
    rounded up to 8, the b1 product's 256-bit steps) whose row j < w_t
    holds word j of neurons 32g..32g+31's planes, neuron n in column
    ``n ^ 8 (j // 2 % 4)`` (:func:`_block_columns`), whose rows w_t..w8-1
    are zero and whose last row holds their thresholds (zero for the
    readout).  A CTA's share of a tile is then one contiguous run of
    blocks, one bulk copy; the rotation lets both MACs read their words
    from 32 banks.  Built once per parameter set, beside
    :func:`stack_cascade_operands`."""
    g = cascade_geometry(tuple(topology))
    blocks = []
    for t, (n, w) in enumerate(zip(topology[1:], g["w_words"])):
        groups, w8 = cdiv(n, LANE_BITS), round_up(w, 8)
        planes = pad_dim_to(w_stack[t, : groups * LANE_BITS, :w], w8, 1)
        rows = planes.reshape(groups, LANE_BITS, w8).transpose(1, 2)
        cols = _block_columns(w8, rows.device).expand(groups, w8, LANE_BITS)
        th = (vth_stack[t, : groups * LANE_BITS]
              if t + 1 < g["n_tiles"] else torch.zeros_like(planes[:, 0]))
        blocks.append(torch.cat([
            torch.gather(rows, 2, cols),
            th.to(WORD_DTYPE).reshape(groups, 1, LANE_BITS)], 1).reshape(-1))
    return torch.cat(blocks).contiguous()


def _block_columns(w8: int, device) -> torch.Tensor:
    """int64[w8, 32]: row j's column c holds neuron ``c ^ 8 (j // 2 % 4)``
    (the rotation is its own inverse)."""
    j = torch.arange(w8, device=device)
    return (torch.arange(LANE_BITS, device=device)[None, :]
            ^ (8 * ((j >> 1) & 3))[:, None])


def _tiles_words(topology: tuple[int, ...]) -> int:
    """Words of :func:`cascade_tiles` for a topology."""
    g = cascade_geometry(topology)
    return sum(cdiv(n, LANE_BITS) * (round_up(w, 8) + 1) * LANE_BITS
               for n, w in zip(topology[1:], g["w_words"]))


def esam_cascade_popcount(
    packed: torch.Tensor,      # int32 words[B, ceil(n_in/32)]
    w_stack: torch.Tensor,     # int32 words[n_tiles, n_max_pad, w_max]
    vth_stack: torch.Tensor,   # int32[n_hidden, n_max_pad]
    *,
    topology: tuple[int, ...],
    tiles: torch.Tensor | None = None,   # cascade_tiles(w_stack, ...)
) -> tuple[torch.Tensor, tuple]:
    """The whole tile cascade: on the card, in ONE kernel launch.

    Returns (logits int32[B, n_cls], fired hidden planes tuple of int32
    words[B, N_t/32]).  On the card, clusters of CTAs split every tile's
    neurons and carry slices of the batch through all tiles; the geometry
    comes from the topology, the batch and the card (``_cascade_route``).
    The kernel reads its weights and thresholds from ``tiles``, the stacks
    regrouped once by :func:`cascade_tiles`; the card needs it, the CPU
    (the plain version, on the stacks) does not read it.  A one-tile
    network has no cascade and goes to :func:`cim_popcount_matmul`, as in
    the reference.
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
    if on_cpu(packed, w_stack, vth_stack):
        planes = tuple(
            w_stack[t, : topology[t + 1], : g["w_words"][t]]
            for t in range(n_tiles))
        vth = tuple(
            vth_stack[t, : topology[t + 1]] for t in range(n_tiles - 1)
        ) + (None,)
        return esam_cascade_popcount_ref(packed, planes, vth)
    dev = check_cuda_operands(
        {"packed": packed, "w_stack": w_stack, "vth_stack": vth_stack})
    if n_tiles == 1:
        return (cim_popcount_matmul(
            packed, w_stack[0, : topology[1], : g["w_words"][0]]), ())
    n_words = _tiles_words(topology)
    if (tiles is None or tuple(tiles.shape) != (n_words,)
            or tiles.dtype != WORD_DTYPE or tiles.device != dev):
        raise ValueError(
            f"the card's cascade needs tiles = cascade_tiles(w_stack, "
            f"vth_stack, topology): int32[{n_words}] on {dev}, got "
            + ("None" if tiles is None else
               f"{tiles.dtype}{list(tiles.shape)} on {tiles.device}"))
    if not (packed.is_contiguous() and tiles.is_contiguous()):
        raise ValueError("packed and tiles must be contiguous")
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
    with torch.cuda.device(dev):
        _cascade_launch(packed, tiles, topology, logits, fired_buf,
                        _cascade_route(topology, B, dev.index))
    return logits, tuple(fired)


def _cascade_launch(packed: torch.Tensor, tiles: torch.Tensor,
                    topology: tuple[int, ...], logits: torch.Tensor,
                    fired_buf: torch.Tensor, route: CascadeRoute) -> None:
    """One ``mega_cascade`` launch on ``route`` into ``logits`` and the
    hidden planes' buffer, on checked CUDA operands of a batch of at least
    one row; counted."""
    kl = _library()
    n_out, w_words = _cascade_arrays(topology)
    err = kl.lib.cim_mega_cascade(
        packed.data_ptr(), packed.shape[0], tiles.data_ptr(), tiles.numel(),
        logits.data_ptr(), fired_buf.data_ptr(), len(topology) - 1, n_out,
        w_words, route.cluster, route.rows, route.clusters,
        _MAC_CODE[route.mac], stream_ptr(packed.device))
    _build.check(kl, err, "mega_cascade launch")
    _LAUNCHES["mega_cascade"] += 1
