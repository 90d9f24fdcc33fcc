"""Fault injection and mitigation for the ESAM CIM macro.

The port of the reference's ``repro.core.esam.faults``.  A
:class:`FaultModel` describes a seeded fault population; the plan layer
(``core/esam/plan.py``) applies it to the operands of every plan mode when
the plan is built, so every kernel runs unchanged on faulted weights and
thresholds, and ``faults=None`` is the clean plan bit for bit.

Fault classes (masks drawn once, at plan build, on the network's device,
through ``core/prng.py``: the reference's ``jax.random`` draws under the same
keys):

``stuck0_rate`` / ``stuck1_rate``
    i.i.d. stuck-at cells: the stored bit reads 0 / 1 whatever was written.
    Both are carved out of one uniform draw a tile, so they are disjoint.
``dead_col_rate``
    whole columns that read 0; hidden tiles only.
``vth_sigma``
    per-column threshold offsets of ``round(N(0, vth_sigma))`` LSBs, added to
    V_th in int32 (wrapping, as XLA adds).
``read_disturb``
    a per-read upset probability that grows linearly with the read ports and
    quadratically with the precharge voltage
    (``upset_rate(p) = read_disturb * p * (v_prech / VPRECH)^2``).  The
    upset masks of all port counts come from one shared draw, so they nest.

Mitigation 1, column remapping (``spare_cols``): the worst faulty columns
of each tile are remapped onto spares at build time by clearing their
masks.  Mitigation 2, online-learning repair, is ``train/online.py``'s
``faults=`` with :func:`clamp_readout_t`.  Mitigation 3, fault-aware
serving, is ``serve/engine.py``'s tile health and ``FaultAwareRouter``.

A key is drawn as in the reference: ``kt = fold_in(PRNGKey(seed), t)`` for
tile t, then ``fold_in(kt, 0)`` the stuck draw, ``1`` the dead columns, ``2``
the threshold offsets and ``3`` the upsets.  Every draw but the threshold
offsets' normal is the reference's bit for bit; the normal is within a few
ulp (``prng.normal``), and its rounded offsets are the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.esam import cost_model as cm


def _below(u: torch.Tensor, rate: float) -> torch.Tensor:
    """``u < rate`` with the rate rounded to float32, as JAX compares a
    float32 draw with a Python float."""
    return u < float(np.float32(rate))


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """A seeded fault population (frozen and hashable: it lives in
    ``PlanSpec``).  Rates are per-cell (or per-column) probabilities in
    [0, 1]; two models with equal fields inject identical faults."""

    seed: int = 0
    stuck0_rate: float = 0.0
    stuck1_rate: float = 0.0
    dead_col_rate: float = 0.0          # hidden tiles only
    vth_sigma: float = 0.0              # per-column V_th offset, LSBs
    read_disturb: float = 0.0           # per-read upset prob at 1 port, VPRECH
    v_prech: float = cm.VPRECH          # precharge voltage (V)
    spare_cols: int = 0                 # remap budget per tile (mitigation 1)

    def __post_init__(self):
        for f in ("stuck0_rate", "stuck1_rate", "dead_col_rate",
                  "read_disturb"):
            v = getattr(self, f)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{f} must be in [0, 1], got {v}")
        if self.stuck0_rate + self.stuck1_rate > 1.0:
            raise ValueError("stuck0_rate + stuck1_rate cannot exceed 1")
        if self.vth_sigma < 0.0 or self.spare_cols < 0:
            raise ValueError("vth_sigma and spare_cols must be >= 0")
        if self.v_prech <= 0.0:
            raise ValueError("v_prech must be positive")

    @property
    def any_faults(self) -> bool:
        return any((self.stuck0_rate, self.stuck1_rate, self.dead_col_rate,
                    self.vth_sigma, self.read_disturb))

    def upset_rate(self, ports: int) -> float:
        """Per-read upset probability at ``ports`` effective read ports:
        linear in the ports, quadratic in V_prech, clipped to 1."""
        r = self.read_disturb * max(1, int(ports)) * (
            self.v_prech / cm.VPRECH) ** 2
        return float(min(r, 1.0))

    def build_masks(self, topology: Sequence[int],
                    ports_options: Sequence[int] = (4,),
                    device=None) -> dict:
        """Draw every tile's fault masks on ``device`` (default the CPU)::

            {"stuck0":  (bool[n_in, n_out] per tile),
             "stuck1":  (bool[n_in, n_out] per tile),
             "vth_off": (int32[n_out]      per tile),
             "upset":   {ports: (bool[n_in, n_out] per tile), ...}}

        one ``upset`` entry per effective port count in ``ports_options``
        (nested sets).  With ``spare_cols > 0`` the remap is applied."""
        key = prng.PRNGKey(int(self.seed), device=device)
        ports_options = tuple(sorted({max(1, int(p)) for p in ports_options}))
        n_tiles = len(topology) - 1
        s0r, s1r = float(self.stuck0_rate), float(self.stuck1_rate)
        masks: dict = {"stuck0": [], "stuck1": [], "vth_off": [],
                       "upset": {p: [] for p in ports_options}}
        for t in range(n_tiles):
            shape = (int(topology[t]), int(topology[t + 1]))
            kt = prng.fold_in(key, t)
            u = prng.uniform(prng.fold_in(kt, 0), shape)
            stuck0 = _below(u, s0r)
            stuck1 = ~stuck0 & _below(u, s0r + s1r)
            if self.dead_col_rate and t < n_tiles - 1:
                dead = _below(prng.uniform(prng.fold_in(kt, 1), (shape[1],)),
                              self.dead_col_rate)
                stuck0 = stuck0 | dead[None, :]
                stuck1 = stuck1 & ~dead[None, :]
            if self.vth_sigma:
                z = prng.normal(prng.fold_in(kt, 2), (shape[1],))
                vth_off = torch.round(
                    z * float(np.float32(self.vth_sigma))).to(torch.int32)
            else:
                vth_off = torch.zeros((shape[1],), dtype=torch.int32,
                                      device=u.device)
            # one shared draw: nested upset sets across port counts
            uu = prng.uniform(prng.fold_in(kt, 3), shape)
            ups = {p: _below(uu, self.upset_rate(p)) for p in ports_options}
            if self.spare_cols:
                stuck0, stuck1, vth_off, ups = _remap_columns(
                    stuck0, stuck1, vth_off, ups, int(self.spare_cols))
            masks["stuck0"].append(stuck0)
            masks["stuck1"].append(stuck1)
            masks["vth_off"].append(vth_off)
            for p in ports_options:
                masks["upset"][p].append(ups[p])
        return {
            "stuck0": tuple(masks["stuck0"]),
            "stuck1": tuple(masks["stuck1"]),
            "vth_off": tuple(masks["vth_off"]),
            "upset": {p: tuple(v) for p, v in masks["upset"].items()},
        }


def _remap_columns(stuck0, stuck1, vth_off, ups: dict, spare_cols: int):
    """Mitigation 1: clear the worst ``spare_cols`` faulty columns of a tile.

    A column's score is its stuck cells, its upset cells at the largest port
    count (the superset) and ``|vth offset|``; the first ``spare_cols`` of
    a stable descending sort whose score is positive are cleared."""
    p_max = max(ups)
    score = sum(m.sum(0, dtype=torch.int32)
                for m in (stuck0, stuck1, ups[p_max])) + vth_off.abs()
    sel = torch.argsort(-score, stable=True)[:spare_cols]
    clear = torch.zeros(score.shape, dtype=torch.bool, device=score.device)
    clear[sel] = score[sel] > 0
    keep = ~clear[None, :]
    return (stuck0 & keep, stuck1 & keep,
            torch.where(clear, 0, vth_off),
            {p: m & keep for p, m in ups.items()})


# ---------------------------------------------------------------------- #
# datapath application (when a plan builds its operands)
# ---------------------------------------------------------------------- #
def faulted_bits(w: torch.Tensor, stuck0, stuck1, upset) -> torch.Tensor:
    """Effective stored bits of one tile: read-disturb flips first, then the
    stuck clamp wins.  All-False masks leave the bits as they are."""
    w_eff = torch.where(upset, 1 - w, w)
    w_eff = torch.where(stuck1, 1, torch.where(stuck0, 0, w_eff))
    return w_eff.to(w.dtype)


def faulted_weights(weight_bits, masks: dict, ports: int) -> list:
    """The masks at ``ports`` effective read ports applied to every tile."""
    return [faulted_bits(w, s0, s1, u)
            for w, s0, s1, u in zip(weight_bits, masks["stuck0"],
                                    masks["stuck1"], masks["upset"][ports])]


def faulted_vth(vth, masks: dict) -> list:
    """Per-column threshold variation: int32 LSB offsets on V_th (a sum past
    int32 wraps, as XLA's does)."""
    return [v + off for v, off in zip(vth, masks["vth_off"])]


# ---------------------------------------------------------------------- #
# online-learning repair support (mitigation 2)
# ---------------------------------------------------------------------- #
def clamp_readout_t(bits_t: torch.Tensor, masks: dict,
                    ports: int = 4) -> torch.Tensor:
    """The transposed-resident readout bits ``[n_out, n_in]`` as the faulted
    array reads them back: writes into stuck cells do not take, reads see
    the disturb flips.  A new tensor with contiguous rows."""
    s0 = masks["stuck0"][-1].T
    s1 = masks["stuck1"][-1].T
    up = masks["upset"][ports][-1].T
    return faulted_bits(bits_t, s0, s1, up).contiguous()


def faulty_cells(masks: dict) -> list[int]:
    """Per-tile count of cells touched by any fault class (reporting)."""
    p_max = max(masks["upset"])
    return [int((s0 | s1 | u).sum())
            for s0, s1, u in zip(masks["stuck0"], masks["stuck1"],
                                 masks["upset"][p_max])]
