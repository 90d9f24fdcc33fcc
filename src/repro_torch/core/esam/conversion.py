"""BNN -> binary-SNN conversion with per-neuron thresholds (Sec 4.4.2, [15]).

The conversion is *exact*: the SNN's spike pattern equals the BNN's binary
activation pattern layer by layer, and the SNN readout is an
argmax-preserving affine transform of the BNN logits.  Derivation (all
integer arithmetic):

First tile (inputs are {0,1} spikes s):
    BNN fires:   W.s + b >= 0   <=>   W.s >= -b          => V_th = ceil(-b)

Hidden tiles (BNN activation a = 2s - 1 in {-1,+1}):
    W.a + b = 2 W.s - colsum(W) + b >= 0
                               <=>  W.s >= (colsum - b)/2 => V_th = ceil((colsum-b)/2)

Output tile (real logits, no threshold):
    logits = W.a + b = 2 (V_mem + (b - colsum)/2)
    => per-neuron readout offset (b - colsum)/2; argmax unchanged.

V_mem is integer because spikes are {0,1} and weights {-1,+1}; "k >= x  <=>
k >= ceil(x)" for integer k makes ceil the exact threshold.  Every quantity
is computed in float32, as the reference computes it.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core.esam import bnn as bnn_mod
from repro_torch.core.esam.network import EsamNetwork

#: the readout tile's threshold: it never fires (V_th = inf in the derivation)
NEVER_FIRES = torch.iinfo(torch.int32).max


def bnn_to_snn(params: Sequence[dict], device=None) -> EsamNetwork:
    """The SNN of a BNN's params, on ``device`` (default: the params')."""
    weight_bits, vth = [], []
    offset = None
    for i, layer in enumerate(params):
        wb = bnn_mod.sign_pm1(layer["w"].detach().to(torch.float32))
        b = layer["b"].detach().to(torch.float32)
        bits = torch.div(wb + 1, 2, rounding_mode="floor").to(torch.int8)
        if i == len(params) - 1:
            # Output tile: readout only.  Its inputs are {0,1} spikes for a
            # single-layer network (logits = W.s + b, so the offset is b)
            # and {-1,+1} activations otherwise (the (b - colsum)/2 fold).
            th = torch.full((wb.shape[1],), NEVER_FIRES, dtype=torch.int32,
                            device=wb.device)
            offset = b if i == 0 else (b - wb.sum(dim=0)) / 2.0
        else:
            theta = (torch.ceil(-b) if i == 0
                     else torch.ceil((wb.sum(dim=0) - b) / 2.0))
            th = theta.to(torch.int32)
        weight_bits.append(bits)
        vth.append(th)
    return EsamNetwork(weight_bits, vth, offset,
                       device=offset.device if device is None else device)
