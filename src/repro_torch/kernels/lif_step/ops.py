"""Wrapper of the LIF-step kernel, dispatched by device.

``lif_step`` is what the temporal plane (``core.esam.temporal``) issues once
per hidden tile and timestep, and once per timestep for the leaking readout
(with a threshold no membrane can reach).  CPU tensors run the plain version
in ``ref.py``; CUDA tensors launch ``csrc/lif_step.cu`` (built by
``kernels/_build.py`` at first use) or the call raises.  Launches are
counted (:func:`launch_counts`).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (
    check_cuda_operands,
    on_cpu,
    sm_count,
    stream_ptr,
)
from repro_torch.kernels.lif_step.ref import (  # noqa: F401  (re-export)
    RESET_MODES,
    decay_of,
    lif_step_ref,
)

__all__ = [
    "RESET_MODES",
    "lif_step",
    "lif_step_ref",
    "launch_counts",
    "reset_launch_counts",
]

#: kernel launches since the last reset
_LAUNCHES = {"lif_step": 0}

#: resident blocks per SM the grid-stride launch asks for at most
_BLOCKS_PER_SM = 8


def launch_counts() -> dict[str, int]:
    """Kernel launches per kernel since the last :func:`reset_launch_counts`."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def _declare(lib: ctypes.CDLL) -> None:
    vp, i32, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.lif_step.argtypes = [vp, vp, vp, vp, vp, vp, vp, i32, i32, f, i32,
                             i32, i32, vp]
    lib.lif_step.restype = i32


def _library() -> _build.KernelLibrary:
    return _build.load_library("lif_step", _declare)


def _check(vmem, contrib, vth, refrac) -> tuple[int, int]:
    if vmem.dim() != 2:
        raise ValueError(f"vmem must be [B, N], got {tuple(vmem.shape)}")
    B, N = vmem.shape
    for name, t, shape, dtype in (
            ("vmem", vmem, (B, N), torch.float32),
            ("contrib", contrib, (B, N), torch.int32),
            ("vth", vth, (N,), torch.int32),
            ("refrac", refrac, (B, N), torch.int32)):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}{list(shape)}, got "
                             f"{t.dtype}{list(t.shape)}")
    return B, N


def lif_step(
    vmem: torch.Tensor,       # float32[B, N]
    contrib: torch.Tensor,    # int32[B, N]
    vth: torch.Tensor,        # int32[N]
    refrac: torch.Tensor,     # int32[B, N]
    *,
    leak: float = 0.0,
    reset: str = "zero",
    refractory: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One leak-integrate-fire-reset step (see ``ref.lif_step_ref``).

    Returns (spikes int8[B, N], vmem' float32[B, N], refrac' int32[B, N]),
    new tensors on the operands' device.
    """
    if reset not in RESET_MODES:
        raise ValueError(f"reset {reset!r} not in {RESET_MODES}")
    if refractory < 0:
        raise ValueError(f"refractory must be >= 0, got {refractory}")
    B, N = _check(vmem, contrib, vth, refrac)
    if on_cpu(vmem, contrib, vth, refrac):
        return lif_step_ref(vmem, contrib, vth, refrac, leak=leak,
                            reset=reset, refractory=refractory)
    dev = check_cuda_operands({"vmem": vmem, "contrib": contrib, "vth": vth,
                               "refrac": refrac})
    vmem, contrib, vth, refrac = (
        t.contiguous() for t in (vmem, contrib, vth, refrac))
    spikes = torch.empty((B, N), dtype=torch.int8, device=dev)
    vmem_out = torch.empty((B, N), dtype=torch.float32, device=dev)
    refrac_out = torch.empty((B, N), dtype=torch.int32, device=dev)
    if B == 0 or N == 0:
        return spikes, vmem_out, refrac_out
    kl = _library()
    with torch.cuda.device(dev):
        err = kl.lib.lif_step(
            vmem.data_ptr(), contrib.data_ptr(), vth.data_ptr(),
            refrac.data_ptr(), spikes.data_ptr(), vmem_out.data_ptr(),
            refrac_out.data_ptr(), B, N, decay_of(leak),
            int(reset == "subtract"), refractory,
            _BLOCKS_PER_SM * sm_count(dev.index), stream_ptr(dev))
    _build.check(kl, err, "lif_step launch")
    _LAUNCHES["lif_step"] += 1
    return spikes, vmem_out, refrac_out
