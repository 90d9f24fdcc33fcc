"""Multi-tile ESAM network (binary SNN) as a torch module.

Tiles are cascaded directly; spikes travel between tiles as parallel binary
pulses (Sec 3.1).  Inference runs through :class:`~.plan.EsamPlan`, built and
cached per network by :meth:`EsamNetwork.plan`.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from repro_torch.core.esam.plan import EsamPlan, PlanSpec
from repro_torch.kernels.common import resolve_device


class EsamNetwork(nn.Module):
    """A stack of CIM-P tiles.

    Buffers, per tile t:
      ``weight_bits_t``: int8 {0,1}[n_in, n_out] stored bits ('1' -> +1,
        '0' -> -1);
      ``vth_t``: int32[n_out] per-neuron thresholds (Fig 5's register);
    and ``out_offset``: float32[n_classes], the per-class readout offset
    folded from the BNN's final-layer bias during conversion.

    ``device`` defaults to ``"cuda"`` and raises when no GPU is present;
    pass ``device="cpu"`` to run the plain PyTorch datapath.
    """

    def __init__(self, weight_bits: Sequence[torch.Tensor],
                 vth: Sequence[torch.Tensor], out_offset: torch.Tensor, *,
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        if len(weight_bits) < 1 or len(vth) != len(weight_bits):
            raise ValueError(f"{len(weight_bits)} weight tiles and "
                             f"{len(vth)} threshold vectors")
        for t, (w, th) in enumerate(zip(weight_bits, vth)):
            if w.dim() != 2 or th.shape != (w.shape[1],):
                raise ValueError(f"tile {t}: weight_bits {tuple(w.shape)} and "
                                 f"vth {tuple(th.shape)} do not match")
            if t and w.shape[0] != weight_bits[t - 1].shape[1]:
                raise ValueError(f"tile {t} takes {w.shape[0]} inputs, tile "
                                 f"{t - 1} gives {weight_bits[t - 1].shape[1]}")
            self.register_buffer(f"weight_bits_{t}", w.to(dev, torch.int8))
            self.register_buffer(f"vth_{t}", th.to(dev, torch.int32))
        if out_offset.shape != (weight_bits[-1].shape[1],):
            raise ValueError(f"out_offset {tuple(out_offset.shape)} for "
                             f"{weight_bits[-1].shape[1]} classes")
        self.register_buffer("out_offset", out_offset.to(dev, torch.float32))
        self._n_tiles = len(weight_bits)
        self._plan_cache: dict[PlanSpec, EsamPlan] = {}

    @classmethod
    def from_numpy(cls, weight_bits: Sequence[np.ndarray],
                   vth: Sequence[np.ndarray], out_offset: np.ndarray, *,
                   device="cuda") -> "EsamNetwork":
        """Build from host arrays — e.g. ``np.asarray`` of a reference
        ``repro`` network's ``weight_bits``, ``vth`` and ``out_offset``.
        The buffers are copies: later writes to the arrays do not reach
        the network."""
        return cls(
            [torch.tensor(np.asarray(w, np.int8)) for w in weight_bits],
            [torch.tensor(np.asarray(v, np.int32)) for v in vth],
            torch.tensor(np.asarray(out_offset, np.float32)),
            device=device)

    @property
    def weight_bits(self) -> list[torch.Tensor]:
        return [getattr(self, f"weight_bits_{t}") for t in range(self._n_tiles)]

    @property
    def vth(self) -> list[torch.Tensor]:
        return [getattr(self, f"vth_{t}") for t in range(self._n_tiles)]

    @property
    def device(self) -> torch.device:
        return self.out_offset.device

    @property
    def topology(self) -> tuple[int, ...]:
        ws = self.weight_bits
        return tuple([ws[0].shape[0]] + [w.shape[1] for w in ws])

    def plan(self, *, mode: str = "packed", collect: bool = False,
             telemetry: bool = False, read_ports: int = 4) -> EsamPlan:
        """Build (or fetch from this network's cache) one plan."""
        spec = PlanSpec(mode=mode, collect=collect, telemetry=telemetry,
                        read_ports=read_ports)
        cached = self._plan_cache.get(spec)
        if cached is None:
            cached = EsamPlan(self, spec)
            self._plan_cache[spec] = cached
        return cached
