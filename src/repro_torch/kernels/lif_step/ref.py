"""Plain PyTorch versions of the LIF-step kernels: one leak-integrate-fire-
reset step on resident membrane state (``lif_step_ref``), and the event
round's whole T-step loop after tile 0's MAC (``temporal_scan_ref``), for
any device.

Semantics (one SNN timestep for one tile's neuron array), the reference's
``repro.kernels.lif_step.ref.lif_step_ref``:

    v      = vmem * decay + contrib               # leak, then integrate
    fired  = (v >= vth) & (refrac == 0)           # refractory gates the fire
    v'     = 0            where fired (reset="zero")
             v - vth      where fired (reset="subtract")
             v            elsewhere
    refrac'= refractory   where fired, else max(refrac - 1, 0)

with ``decay = float32(1.0 - leak)`` (the difference taken in double, then
rounded to float32, as the reference's ``jnp.float32(1.0 - leak)``) and the
threshold compared in float32 (``vth.float()``: a never-fire threshold of
2^31 - 1 becomes 2^31).

Rounding.  The reference's temporal plan is jitted, and XLA contracts
``vmem * decay + contrib`` into one fused multiply-add: the leak and the
integrate round ONCE.  Eager torch would round the product and then the sum
(twice), and differ in the last bit for about one entry in ten at a leak of
0.1-0.3.  So this version computes the fused multiply-add exactly:

* the float32 product ``vmem * decay`` is exact in float64 (24 + 24 bits of
  significand fit in 53);
* ``s = p + c`` in float64 and its rounding error ``e`` by TwoSum (exact);
* round to odd: when ``e != 0`` and the last significand bit of ``s`` is 0,
  step ``s`` one ulp toward ``e`` (``torch.nextafter``) — ``s`` is then the
  exact sum truncated toward zero with its last bit set as a sticky bit;
* cast to float32 (round to nearest even).

Rounding to odd at 53 bits and then to nearest at 24 equals one rounding to
nearest of the exact value, because 53 >= 24 + 2: the odd last bit records
that the sum was inexact, 29 bits below float32's last place, so the second
rounding can neither see a false tie nor lose a carry (Boldo and Melquiond,
"Emulation of FMA and correctly rounded sums: proved algorithms using
rounding to odd", IEEE TC 2008).  The CUDA kernel (``__fmaf_rn``) is held bit
for bit against this version, and this version bit for bit against
``jax.jit`` of the reference (tests/test_torch_temporal.py); against the
reference's eager, twice-rounded ``lif_step_ref`` it agrees only to float32
ulp.  With ``leak = 0`` every value is an integer and all of them agree.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import packing, prng
from repro_torch.kernels.cim_popcount.ref import cim_popcount_ref

RESET_MODES = ("zero", "subtract")


def decay_of(leak: float) -> float:
    """``float32(1.0 - leak)``: the difference in double, rounded once."""
    return float(np.float32(1.0 - leak))


def leak_integrate(vmem: torch.Tensor, decay: float,
                   contrib: torch.Tensor) -> torch.Tensor:
    """``fma(vmem, decay, float32(contrib))`` in float32, rounded once."""
    return prng.fma32(vmem.to(torch.float32), decay,
                      contrib.to(torch.float32))


def lif_step_ref(
    vmem: torch.Tensor,       # float32[B, N] resident membrane state
    contrib: torch.Tensor,    # int32[B, N] this step's CIM MAC contribution
    vth: torch.Tensor,        # int32[N] per-neuron thresholds
    refrac: torch.Tensor,     # int32[B, N] remaining refractory steps
    *,
    leak: float = 0.0,
    reset: str = "zero",
    refractory: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (spikes int8[B, N], vmem' float32[B, N], refrac' int32[B, N])."""
    if reset not in RESET_MODES:
        raise ValueError(f"reset {reset!r} not in {RESET_MODES}")
    th = vth[None, :].to(torch.float32)
    v = leak_integrate(vmem, decay_of(leak), contrib)
    fired = (v >= th) & (refrac == 0)
    if reset == "zero":
        v_next = torch.where(fired, torch.zeros_like(v), v)
    else:
        v_next = torch.where(fired, v - th, v)
    refrac_next = torch.where(
        fired, torch.full_like(refrac, refractory), (refrac - 1).clamp_min(0))
    return fired.to(torch.int8), v_next, refrac_next.to(torch.int32)


def temporal_scan_ref(
    c_in: torch.Tensor,       # int32[T, B, N_1]: tile 0's MAC, per step
    planes,                   # per hidden tile i: int32[N_{i+1}, ceil(N_i/32)]
    vth,                      # per hidden tile i: int32[N_i]
    *,
    leak: float = 0.0,
    reset: str = "zero",
    refractory: int = 0,
    collect: bool = False,
    telemetry: bool = False,
) -> tuple[torch.Tensor, tuple | None, tuple | None]:
    """Every step of an event round after tile 0's lifted MAC.

    From zero state, per step ``t``: the LIF step of each hidden tile on
    its contribution (``c_in[t]`` for the first), its fired spikes packed
    into wire words, and the exact popcount MAC of those words with the next
    tile's planes; the last planes feed the readout, which leaks and
    integrates with one rounding and never fires.  With no hidden tile the
    readout integrates ``c_in`` itself.

    Returns (out_v float32[B, n_cls], words, loads): ``words`` (with
    ``collect``) and ``loads`` (with ``telemetry``) are tuples over hidden
    tiles of int32 ``[T, B, ceil(N_i / 32)]`` and ``[T, B, N_i / 128]``, else
    None.  The caller adds the readout's offset.
    """
    t, batch, _ = c_in.shape
    n_cls = planes[-1].shape[0] if len(planes) else c_in.shape[-1]
    decay = decay_of(leak)
    state = [(torch.zeros((batch, th.shape[0]), dtype=torch.float32,
                          device=c_in.device),
              torch.zeros((batch, th.shape[0]), dtype=torch.int32,
                          device=c_in.device)) for th in vth]
    out_v = torch.zeros((batch, n_cls), dtype=torch.float32,
                        device=c_in.device)
    words = [[] for _ in vth]
    for step in range(t):
        contrib = c_in[step]
        for i, (v, r) in enumerate(state):
            spikes, v, r = lif_step_ref(v, contrib, vth[i], r, leak=leak,
                                        reset=reset, refractory=refractory)
            state[i] = (v, r)
            w = packing.pack_spikes(spikes)
            words[i].append(w)
            contrib = cim_popcount_ref(w, planes[i])
        out_v = leak_integrate(out_v, decay, contrib)
    stacked = tuple(torch.stack(w) for w in words)
    return (out_v, stacked if collect else None,
            tuple(packing.group_popcount(w) for w in stacked)
            if telemetry else None)
