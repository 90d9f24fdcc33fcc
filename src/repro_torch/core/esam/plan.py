"""Execution plans: one entry point per ESAM forward variant.

An :class:`EsamPlan` is built once from ``(EsamNetwork, PlanSpec)`` and
called per batch.  It hoists every operand transform out of the call — the
±1 decode, the weight bit planes, the cascade's stacked slabs — into a prep
cache that is rebuilt only when a parameter tensor changes.

Modes (this port carries the reference's serving modes):

``functional``  dense ±1 MAC cascade (bool spikes between tiles) — the oracle.
``packed``      the bit-packed cascade: 32-bit words on the wire, and on the
                card the whole cascade in one CUDA launch
                (``kernels/cim_popcount``).

Orthogonal flags: ``collect`` returns the inter-tile planes, ``telemetry``
returns the per-tile arbiter loads (group popcounts straight off the wire).
``read_ports`` is the cell option of the reference's spec (0..4); neither mode
here depends on it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import packing
from repro_torch.core.esam import arbiter as arb
from repro_torch.core.esam import neuron as nrn
from repro_torch.core.esam import tile as tile_mod
from repro_torch.kernels.cim_popcount import ops as pop_ops

MODES = ("functional", "packed")
#: reference modes that later slices of the port carry
NOT_PORTED_MODES = ("prefix", "cycle", "temporal")


@dataclasses.dataclass(frozen=True)
class PlanSpec:
    """Static description of one plan."""

    mode: str = "packed"
    collect: bool = False
    telemetry: bool = False
    read_ports: int = 4

    def __post_init__(self):
        if self.mode in NOT_PORTED_MODES:
            raise NotImplementedError(
                f"mode={self.mode!r} is not ported to repro_torch yet")
        if self.mode not in MODES:
            raise ValueError(f"mode {self.mode!r} not in {MODES}")
        if not isinstance(self.read_ports, int) or isinstance(
                self.read_ports, bool):
            raise TypeError("read_ports must be an int (port sweeps need "
                            "cycle mode, which is not ported yet)")


@dataclasses.dataclass
class PlanResult:
    """Outputs of one plan execution (fields populated per spec).

    ``planes`` carries what travels the inter-tile wire in that mode: the
    hidden layers' output spikes (``functional``) or the tile-input packed
    words including the network input (``packed``).  ``loads`` are int32
    arbiter loads per tile input, ``[..., n_groups]``.
    """

    logits: Optional[torch.Tensor] = None
    planes: Optional[tuple] = None
    loads: Optional[tuple] = None


class EsamPlan:
    """One plan, built once and reused for every batch.

    Call it with spikes ``{0,1}[..., n_in]`` (any dtype, torch or numpy) or,
    in packed mode, with wire-format words: int32 torch words or uint32
    numpy words ``[..., ceil(n_in/32)]``.  Inputs are moved to the network's
    device, leading dims are flattened into one batch axis, and every output
    is reshaped back.  Returns a :class:`PlanResult`.
    """

    def __init__(self, network, spec: PlanSpec):
        self.spec = spec
        self.network = network
        self.topology = network.topology
        if spec.mode == "packed" and any(
                n % packing.LANE_BITS for n in self.topology[1:-1]):
            raise ValueError(
                f"packed plans need 32-aligned hidden widths: {self.topology}")
        self._n_in = self.topology[0]
        self._in_width = (packing.packed_width(self._n_in)
                          if spec.mode == "packed" else self._n_in)
        self._prep_key = None
        self._prep_params = None

    # ------------------------------------------------------------------ #
    # operand prep: decode / bit-slice once, serve every batch
    # ------------------------------------------------------------------ #
    def _build_params(self, wb, vth, off) -> dict[str, Any]:
        params: dict[str, Any] = {"vth": vth, "out_offset": off}
        if self.spec.mode == "functional":
            # float32 ±1: the dense oracle's matmul operand, decoded once
            params["w_signed"] = tuple(
                nrn.decode_bitlines(w).to(torch.float32) for w in wb)
        else:
            planes = tuple(packing.pack_weight_planes(w) for w in wb)
            params["w_stack"], params["vth_stack"] = (
                pop_ops.stack_cascade_operands(planes, vth, self.topology))
        return params

    def _prepare(self) -> dict[str, Any]:
        """Cached prep, rebuilt whenever a parameter tensor changes.

        Torch buffers are mutable: an in-place write keeps the tensor's id
        and storage but bumps its ``_version``, and ``.to()`` or a swapped
        buffer changes its id or storage.  Keying on all three means a cached
        plan never serves stale operands.
        """
        net = self.network
        src = (*net.weight_bits, *net.vth, net.out_offset)
        key = tuple((id(t), t.data_ptr(), t._version) for t in src)
        if key != self._prep_key:
            self._prep_params = self._build_params(
                tuple(net.weight_bits), tuple(net.vth), net.out_offset)
            self._prep_key = key
        return self._prep_params

    # ------------------------------------------------------------------ #
    # execution
    # ------------------------------------------------------------------ #
    def _normalize(self, x) -> tuple[torch.Tensor, tuple[int, ...]]:
        """Coerce input to a flat 2-D batch on the network's device;
        returns (x2d, leading shape)."""
        if isinstance(x, np.ndarray):
            x = (packing.words_from_np(x) if x.dtype == np.uint32
                 else torch.from_numpy(np.ascontiguousarray(x)))
        elif not isinstance(x, torch.Tensor):
            x = torch.as_tensor(x)
        x = x.to(self.network.device)
        lead = tuple(x.shape[:-1])
        if self.spec.mode == "packed":
            if (x.dtype == packing.WORD_DTYPE
                    and x.shape[-1] == self._in_width
                    and self._in_width != self._n_in):
                pass                                   # already wire format
            elif x.shape[-1] == self._n_in:
                x = packing.pack_spikes(x != 0)        # spikes -> wire format
            else:
                raise ValueError(
                    f"expected spikes[..., {self._n_in}] or int32 words"
                    f"[..., {self._in_width}], got {tuple(x.shape)} {x.dtype}")
        else:
            if x.shape[-1] != self._n_in:
                raise ValueError(
                    f"expected spikes[..., {self._n_in}], got {tuple(x.shape)}")
            x = x != 0
        return x.reshape(-1, x.shape[-1]).contiguous(), lead

    def _run(self, params: dict[str, Any], x: torch.Tensor) -> dict:
        spec = self.spec
        vth, off = params["vth"], params["out_offset"]
        out: dict[str, Any] = {}
        if spec.mode == "functional":
            ws = params["w_signed"]
            s, hidden = x, []
            for w, th in zip(ws[:-1], vth[:-1]):
                s, _ = tile_mod.functional_tile(None, s, th, w_signed=w)
                hidden.append(s)
            _, vmem = tile_mod.functional_tile(None, s, vth[-1],
                                               w_signed=ws[-1])
            out["logits"] = vmem.to(torch.float32) + off
            if spec.collect:
                out["planes"] = tuple(hidden)
            if spec.telemetry:
                out["loads"] = tuple(
                    arb.split_row_groups(si.to(torch.int32)).sum(
                        -1, dtype=torch.int32)
                    for si in [x, *hidden])
        else:
            vmem, fired = pop_ops.esam_cascade_popcount(
                x, params["w_stack"], params["vth_stack"],
                topology=self.topology)
            planes = (x,) + tuple(fired)
            out["logits"] = vmem.to(torch.float32) + off
            if spec.collect:
                out["planes"] = planes
            if spec.telemetry:
                out["loads"] = tuple(packing.group_popcount(p) for p in planes)
        return out

    def __call__(self, x) -> PlanResult:
        x, lead = self._normalize(x)
        out = self._run(self._prepare(), x)
        return PlanResult(**{
            k: (v.reshape(lead + v.shape[1:]) if isinstance(v, torch.Tensor)
                else tuple(a.reshape(lead + a.shape[1:]) for a in v))
            for k, v in out.items()})
