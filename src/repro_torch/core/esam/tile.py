"""One CIM tile, functional plane: the dense ±1 MAC oracle.

IF accumulation is commutative and the compare happens only when the
arbiter drains (R_empty), so the event-driven multiport schedule and one
dense product give identical V_mem and spikes.
"""

from __future__ import annotations

import torch

from repro_torch.core.esam import neuron as nrn


def functional_tile(
    weight_bits: torch.Tensor | None,
    in_spikes: torch.Tensor,
    vth: torch.Tensor,
    *,
    w_signed: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched functional tile: one dense MAC.

    Args:
      weight_bits: {0,1}[n_in, n_out] (may be None when ``w_signed`` given)
      in_spikes: {0,1}/bool[..., n_in] (any batch shape)
      vth: int32[n_out]
      w_signed: optional pre-decoded ±1 [n_in, n_out] (any dtype) — the
        operand ``EsamPlan`` prepares once, skipping the per-call decode.
    Returns:
      (out_spikes bool[..., n_out], vmem int32[..., n_out])

    The product runs in float32 because integer matmul has no CUDA kernel.
    It is exact: every partial sum is an integer of magnitude <= n_in, far
    below 2^24.  TF32 would keep only 10 mantissa bits of each ±1/{0,1}
    operand — still exact for these values, but the oracle must not depend
    on that, so full float32 is pinned for this one product and the
    caller's setting is restored after it.
    """
    if w_signed is None:
        w_signed = nrn.decode_bitlines(weight_bits)
    vmem = exact_matmul(in_spikes, w_signed).to(torch.int32)
    return vmem >= vth, vmem


def exact_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in full float32, exact for small-integer operands.

    Integer matmul has no CUDA kernel, so integer products go through
    float32: exact while every partial sum stays an integer below 2^24.
    TF32 is turned off for this one product and the caller's setting is
    restored after it.
    """
    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.matmul(a.to(torch.float32), b.to(torch.float32))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow_tf32
