"""Temporal event plane: multi-timestep LIF simulation with the membrane
state resident on the device.

The static planes run one spike plane per request.  The temporal plane runs
*event streams* — T timesteps of binary spike planes (``data/events.py``) —
through the same tile cascade, with every hidden tile's membrane potential
and refractory counter persisting from one step to the next, IMPULSE-style
(the weights and the membrane state live in one CIM macro).  The readout
tile integrates with the same leak and never fires: the logits are its
membrane after T steps plus the per-class offset.

``temporal_forward`` is the port of the reference's fused scan
(``repro.core.esam.temporal.temporal_forward``).  Torch runs eagerly, so the
scan is a kernel, not a Python loop over timesteps:

* tile 0's MAC depends only on the events, so it leaves the time loop as
  ONE ``[T*B, n_in]`` popcount MAC (``cim_popcount_matmul``: on the card one
  ``popcount_mac`` launch);
* every later step is ONE ``temporal_scan`` (``kernels/lif_step``): per
  step and hidden tile the LIF step, the fired spikes packed into wire
  words, and the next tile's MAC on those words; the readout leaks and
  integrates with one rounding (a fused multiply-add) and never fires.  On
  the card the whole loop is one launch that keeps every stream's
  membranes on the SM; an eager ``out_v * decay + contrib`` would round
  twice and miss the reference at every nonzero leak.

On the CPU both are their plain versions, the reference's bit for bit: the
MACs are exact integer arithmetic, and the LIF step rounds as the
reference's jitted plan does (``kernels/lif_step/ref.py``).

``temporal_forward_naive`` is the per-step oracle: dense tiles and the plain
LIF step on unpacked spikes, one step at a time.

With ``n_steps=1``, ``leak=0`` and ``reset="zero"`` the temporal plane is
the static packed plane bit for bit: one leak-free LIF step from zero state
is the IF fire of the cascade.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import packing
from repro_torch.core.esam import neuron as nrn
from repro_torch.core.esam import tile as tile_mod
from repro_torch.kernels.cim_popcount import ops as pop_ops
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.lif_step import ops as lif_ops
from repro_torch.kernels.telemetry import ops as tele_ops
from repro_torch.kernels.lif_step.ref import (
    RESET_MODES,
    decay_of,
    leak_integrate,
    lif_step_ref,
)


@dataclasses.dataclass(frozen=True)
class TemporalConfig:
    """Static dynamics of one temporal execution (part of the plan's key).

    n_steps:    T, the number of timesteps in the event stream.
    leak:       fraction of V_mem lost per step (V *= 1 - leak); 0 disables
                the leak exactly (a multiply by 1.0 is the identity).
    reset:      "zero" (V_mem := 0 on fire, the paper's Sec 3.4 behaviour)
                or "subtract" (V_mem -= V_th, carrying the residual).
    refractory: steps a neuron stays silent after firing (0 disables).
    """

    n_steps: int
    leak: float = 0.0
    reset: str = "zero"
    refractory: int = 0

    def __post_init__(self):
        if self.n_steps < 1:
            raise ValueError(f"n_steps must be >= 1, got {self.n_steps}")
        if not 0.0 <= self.leak < 1.0:
            raise ValueError(f"leak must be in [0, 1), got {self.leak}")
        if self.reset not in RESET_MODES:
            raise ValueError(f"reset {self.reset!r} not in {RESET_MODES}")
        if self.refractory < 0:
            raise ValueError(f"refractory must be >= 0, got {self.refractory}")


def init_state(topology, batch: int, device="cuda"):
    """Zero membrane state for one event stream: per hidden tile a
    (vmem float32[B, n], refrac int32[B, n]) pair, plus the readout's
    float32[B, n_cls] membrane.  On the card unless ``device`` says
    otherwise: with no GPU the default raises (``resolve_device``)."""
    device = resolve_device(device)
    hidden = tuple(
        (torch.zeros((batch, n), dtype=torch.float32, device=device),
         torch.zeros((batch, n), dtype=torch.int32, device=device))
        for n in topology[1:-1])
    return hidden, torch.zeros((batch, topology[-1]), dtype=torch.float32,
                               device=device)


def mac_operands(weight_bits) -> tuple:
    """Per tile, the int32 weight planes ``[N, ceil(K/32)]`` of the temporal
    plane's popcount MACs, on the weights' device.  ``EsamPlan`` builds them
    once per parameter set."""
    return tuple(packing.pack_weight_planes(w) for w in weight_bits)


def temporal_forward(
    weights,                  # per tile: mac_operands(weight_bits)
    vth,
    out_offset: torch.Tensor,
    events: torch.Tensor,     # int32 wire words [T, B, ceil(n_in/32)]
    cfg: TemporalConfig,
    topology: tuple[int, ...],
    *,
    collect: bool = False,
    telemetry: bool = False,
) -> dict:
    """All T timesteps of one batch of event streams.

    Returns ``{"logits": float32[B, n_cls]}``, plus ``"planes"`` (with
    ``collect``) and ``"loads"`` (with ``telemetry``): tuples over tiles of
    the tile-input words ``[B, T, W]`` and arbiter loads ``[B, T, groups]``,
    batch-first; tile 0's entry is the input stream itself.  The events'
    device picks the datapath: CUDA kernels on the card (one
    ``popcount_mac`` and one ``temporal_scan`` launch), plain versions on
    the CPU.
    """
    t, batch, _ = events.shape
    if t != cfg.n_steps:
        raise ValueError(f"events hold {t} steps, the config {cfg.n_steps}")
    if len(weights) != len(topology) - 1:
        raise ValueError(f"{len(weights)} weight tiles for topology "
                         f"{topology}")
    # tile 0 sees only the events: one [T*B, n_in] MAC before the scan
    c_in = pop_ops.cim_popcount_matmul(
        events.reshape(t * batch, -1), weights[0]).reshape(
            t, batch, topology[1])
    out_v, words, loads = lif_ops.temporal_scan(
        c_in, weights[1:], vth[:-1], leak=cfg.leak, reset=cfg.reset,
        refractory=cfg.refractory, collect=collect, telemetry=telemetry)
    out: dict = {"logits": out_v + out_offset}
    # time-first from the scan, handed out batch-first
    if collect:
        out["planes"] = tuple(w.transpose(0, 1) for w in (events, *words))
    if telemetry:
        out["loads"] = tuple(ld.transpose(0, 1) for ld in (
            *tele_ops.tile_loads((events,)), *loads))
    return out


def temporal_forward_naive(network, events: np.ndarray,
                           cfg: TemporalConfig) -> np.ndarray:
    """The per-step oracle: a Python loop over timesteps on unpacked spikes.

    ``events``: {0,1}[T, B, n_in].  Each step runs the dense tiles
    (``tile.exact_matmul`` on the ±1 decode) and the plain LIF step on the
    network's device, with no packing and no kernel; the readout leaks and
    integrates with the same single rounding.  Returns float32 logits
    ``[B, n_cls]`` as numpy — bit for bit the fused plan's.
    """
    events = np.asarray(events)
    if events.ndim != 3 or events.shape[0] != cfg.n_steps:
        raise ValueError(f"expected events[{cfg.n_steps}, B, n_in], got "
                         f"{events.shape}")
    dev = network.device
    ws = [nrn.decode_bitlines(w).to(torch.float32)
          for w in network.weight_bits]
    vth = network.vth
    hidden, out_v = init_state(network.topology, events.shape[1], dev)
    hidden = list(hidden)
    decay = decay_of(cfg.leak)
    for step in range(cfg.n_steps):
        s = torch.from_numpy(events[step] != 0).to(dev)
        for i, (v, r) in enumerate(hidden):
            contrib = tile_mod.exact_matmul(s, ws[i]).to(torch.int32)
            s, v, r = lif_step_ref(v, contrib, vth[i], r, leak=cfg.leak,
                                   reset=cfg.reset,
                                   refractory=cfg.refractory)
            hidden[i] = (v, r)
        contrib = tile_mod.exact_matmul(s, ws[-1]).to(torch.int32)
        out_v = leak_integrate(out_v, decay, contrib)
    return (out_v + network.out_offset).cpu().numpy()
