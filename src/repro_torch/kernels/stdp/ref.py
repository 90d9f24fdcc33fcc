"""Plain PyTorch versions of the transposed-port STDP kernels.

Torch twins of the reference's ``repro.kernels.stdp.ref``: stochastic 1-bit
STDP on the transposed ("column-resident") weight layout ``{0,1}[N_out,
N_in]``, given explicit uniform draws.  A synapse of a learning neuron
potentiates (bit -> 1) when its pre-neuron fired and ``u_pot < p_pot``, and
depresses (bit -> 0) when it was silent and ``u_dep < p_dep``; ``p_pot`` and
``p_dep`` are compared in float32, as the reference compares its float32
uniforms against them.  The CUDA kernels of ``csrc/stdp.cu`` are held bit
for bit against these.  Both return new tensors.
"""

from __future__ import annotations

import numpy as np
import torch


def f32(p: float) -> float:
    """``p`` rounded to float32 (the precision the rule compares in)."""
    return float(np.float32(p))


def _rule(old, pre, u_pot, u_dep, p_pot, p_dep):
    potentiate = pre & (u_pot < f32(p_pot))
    depress = ~pre & (u_dep < f32(p_dep))
    one = torch.ones((), dtype=old.dtype, device=old.device)
    return torch.where(potentiate, one, torch.where(depress, 0 * one, old))


def stdp_update_ref(
    bits_t: torch.Tensor,   # {0,1}[N_out, N_in]
    pre: torch.Tensor,      # {0,1}[N_in]
    post: torch.Tensor,     # {0,1}[N_out] learning events
    u_pot: torch.Tensor,    # float32[N_out, N_in]
    u_dep: torch.Tensor,    # float32[N_out, N_in]
    p_pot: float,
    p_dep: float,
) -> torch.Tensor:
    """The rule on every learning neuron's row (rows where ``post`` is 0 keep
    their bits)."""
    new = _rule(bits_t, (pre != 0)[None, :], u_pot, u_dep, p_pot, p_dep)
    return torch.where((post != 0)[:, None], new, bits_t)


def stdp_column_event_ref(
    bits_t: torch.Tensor,   # {0,1}[N_out, N_in]
    col: torch.Tensor,      # integer scalar: the learning neuron
    apply: torch.Tensor,    # bool scalar: identity when False
    pre: torch.Tensor,      # {0,1}[N_in] pre-synaptic activity trace
    u_pot: torch.Tensor,    # float32[N_in]
    u_dep: torch.Tensor,    # float32[N_in]
    p_pot: float,
    p_dep: float,
) -> torch.Tensor:
    """One column event: the rule on row ``col`` only, gated by ``apply``.
    ``col`` and ``apply`` may be tensors on the device; nothing syncs."""
    idx = torch.as_tensor(col, device=bits_t.device).reshape(1).long()
    old = bits_t.index_select(0, idx)[0]
    new = _rule(old, pre != 0, u_pot, u_dep, p_pot, p_dep)
    gate = torch.as_tensor(apply, device=bits_t.device) != 0
    return bits_t.index_copy(0, idx, torch.where(gate, new, old)[None])
