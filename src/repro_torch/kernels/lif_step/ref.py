"""Plain PyTorch version of the LIF-step kernel: leak-integrate-fire-reset
on resident membrane state, for any device.

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

RESET_MODES = ("zero", "subtract")


def decay_of(leak: float) -> float:
    """``float32(1.0 - leak)``: the difference in double, rounded once."""
    return float(np.float32(1.0 - leak))


def leak_integrate(vmem: torch.Tensor, decay: float,
                   contrib: torch.Tensor) -> torch.Tensor:
    """``fma(vmem, decay, float32(contrib))`` in float32, rounded once."""
    p = vmem.to(torch.float32).to(torch.float64) * decay   # exact
    c = contrib.to(torch.float32).to(torch.float64)
    s = p + c
    b = s - p
    err = (p - (s - b)) + (c - b)                          # TwoSum: exact
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(torch.float64)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


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
