"""Execution plans: one entry point per ESAM forward variant.

An :class:`EsamPlan` is built once from ``(EsamNetwork, PlanSpec)`` and
called per batch.  It hoists every operand transform out of the call — the
±1 decode, the weight bit planes, the cascade's stacked slabs — into a prep
cache that is rebuilt only when a parameter tensor changes.

Modes (every mode of the reference):

``functional``  dense ±1 MAC cascade (bool spikes between tiles) — the oracle.
``packed``      the bit-packed cascade: 32-bit words on the wire, and on the
                card the whole cascade in one CUDA launch
                (``kernels/cim_popcount``).
``prefix``      hidden tiles only; returns the last tile's *input* plane —
                words from one ``popcount_fire`` launch per hidden tile when
                every hidden width is 32-aligned, else bool spikes from the
                dense tiles.  What the online-learning plane reuses across
                epochs.
``cycle``       the rank-schedule cycle-accurate plane: per tile one
                ``port_schedule`` launch on the card (``kernels/arbiter``)
                and a ``TileTrace``; with a tuple of cell options in
                ``read_ports`` it is the full Fig 8 port sweep, options that
                share an effective port count (0 and 1) sharing one
                simulation.
``temporal``    the multi-timestep LIF plane (``core/esam/temporal.py``) over
                a time-first ``[T, ..., n_in]`` event stream; needs a
                :class:`~repro_torch.core.esam.temporal.TemporalConfig`.  On
                the card: one ``popcount_mac`` for tile 0, then one
                ``temporal_scan`` for every step's LIF steps, re-packs,
                hidden-tile MACs and readout leak.  With T=1, zero leak and
                zero reset it is ``packed`` bit for bit.

Orthogonal flags: ``collect`` returns the inter-tile planes (cycle plans
ignore it: their traces hold every tile's spikes), ``telemetry`` returns
the per-tile arbiter loads (group popcounts straight off the wire).
``read_ports`` is the cell option (0..4); the ``cycle`` mode's schedule
depends on it, and a faulted plan reads its upset masks at it.
``faults`` (a :class:`~repro_torch.core.esam.faults.FaultModel`) draws the
fault masks once, when the plan is built, on the network's device, and
applies them to the operands when they are built: every kernel runs as it
is on faulted weights and thresholds, and ``faults=None`` is the clean plan.
``record_vmem_trace`` adds the per-cycle V_mem history to cycle traces.
In temporal mode ``planes`` and ``loads`` gain a timestep axis after the
batch: ``[..., T, words]`` and ``[..., T, groups]``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import packing
from repro_torch.core.esam import arbiter as arb
from repro_torch.core.esam import faults as faults_mod
from repro_torch.core.esam import neuron as nrn
from repro_torch.core.esam import temporal as temporal_mod
from repro_torch.core.esam import tile as tile_mod
from repro_torch.kernels.cim_matmul_packed import ops as packed_ops
from repro_torch.kernels.cim_popcount import ops as pop_ops
from repro_torch.kernels.telemetry import ops as tele_ops

MODES = ("functional", "packed", "prefix", "cycle", "temporal")
#: reference modes the port does not carry yet (none: temporal was the last)
NOT_PORTED_MODES = ()


@dataclasses.dataclass(frozen=True)
class PlanSpec:
    """Static description of one plan."""

    mode: str = "packed"
    collect: bool = False
    telemetry: bool = False
    #: cell option(s).  An int for a single plan; a tuple of cell options
    #: turns ``cycle`` mode into the port sweep.
    read_ports: int | tuple[int, ...] = 4
    record_vmem_trace: bool = False
    #: temporal mode only: the LIF dynamics (T, leak, reset, refractory)
    temporal: Optional[temporal_mod.TemporalConfig] = None
    #: the fault population injected into the operands (frozen and
    #: hashable, so each model is its own plan); None is the clean plan
    faults: Optional[faults_mod.FaultModel] = None

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode {self.mode!r} not in {MODES}")
        if (self.mode == "temporal") != (self.temporal is not None):
            raise ValueError("mode='temporal' needs a TemporalConfig, and "
                             f"only it takes one (mode={self.mode!r}, "
                             f"temporal={self.temporal!r})")
        options = self.read_ports
        if isinstance(options, tuple):
            if self.mode != "cycle":
                raise TypeError("a tuple of read_ports (a port sweep) needs "
                                "mode='cycle'")
        else:
            options = (options,)
        if not options or any(not isinstance(o, int) or isinstance(o, bool)
                              for o in options):
            raise TypeError(f"read_ports must be an int or a non-empty tuple "
                            f"of ints, got {self.read_ports!r}")


@dataclasses.dataclass
class PlanResult:
    """Outputs of one plan execution (fields populated per spec).

    ``planes`` carries what travels the inter-tile wire in that mode: the
    hidden layers' output spikes (``functional``), the tile-input packed
    words including the network input (``packed``), or the tile inputs of
    the hidden tiles and the prefix itself (``prefix``).  ``loads`` are int32
    arbiter loads per tile input, ``[..., n_groups]``.  ``prefix`` is the
    last tile's input plane (``prefix`` mode only).  ``traces`` holds one
    ``TileTrace`` per tile (``cycle`` mode, one cell option); ``sweep`` maps
    each cell option of a sweep to ``{"logits", "traces"}``.
    """

    logits: Optional[torch.Tensor] = None
    planes: Optional[tuple] = None
    loads: Optional[tuple] = None
    traces: Optional[tuple] = None
    prefix: Optional[torch.Tensor] = None
    sweep: Optional[dict] = None


def packed_prefix(weight_bits, vth, packed: torch.Tensor) -> torch.Tensor:
    """Cascade the hidden tiles (all but the last) on the packed plane.

    The learning plane's frozen prefix (``learning.last_hidden_spikes``):
    one ``esam_layer_packed`` launch per hidden tile on the card, spike
    words in, re-packed fired words out.  Hidden widths must be multiples
    of 32.  Returns the last tile's input words.
    """
    for w in weight_bits[:-1]:
        if w.shape[1] % packing.LANE_BITS:
            raise ValueError("hidden width must be 32-aligned for the packed "
                             f"plane, got {tuple(w.shape)}")
    p = packed
    for w, th in zip(weight_bits[:-1], vth[:-1]):
        p = packed_ops.esam_layer_packed(p, w, th)
    return p


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
        hidden_ok = not any(n % packing.LANE_BITS for n in self.topology[1:-1])
        if spec.mode in ("packed", "temporal") and not hidden_ok:
            raise ValueError(f"{spec.mode} plans need 32-aligned hidden "
                             f"widths: {self.topology}")
        #: prefix mode runs packed when the hidden widths allow it, else the
        #: dense functional tiles — both bit-identical
        self.prefix_packed = spec.mode == "prefix" and hidden_ok
        self._packed_input = (spec.mode in ("packed", "temporal")
                              or self.prefix_packed)
        self._n_in = self.topology[0]
        self._in_width = (packing.packed_width(self._n_in)
                          if self._packed_input else self._n_in)
        # fault masks, drawn once: a cycle sweep reads them at every
        # effective port count it simulates, every other plan at its one
        if spec.faults is not None:
            ports = (self._cycle_port_options() if spec.mode == "cycle"
                     else (max(1, int(spec.read_ports)),))
            self._fault_masks = spec.faults.build_masks(
                self.topology, ports, device=network.device)
        else:
            self._fault_masks = None
        self._prep_key = None
        self._prep_params = None
        # cold start (``warmup``): a static input buffer a batch size, and
        # on the card one captured CUDA graph a (batch, key)
        self._inputs: dict[int, torch.Tensor] = {}
        self._graphs: dict[tuple, PlanGraph] = {}
        #: CUDA graphs this plan has captured (re-captures included)
        self.captures = 0

    # ------------------------------------------------------------------ #
    # operand prep: decode / bit-slice once, serve every batch
    # ------------------------------------------------------------------ #
    def _cycle_port_options(self) -> tuple[int, ...]:
        """The effective port counts a cycle plan simulates (the 1RW cell,
        option 0, reads through its one RW port like option 1)."""
        rp = self.spec.read_ports
        options = rp if isinstance(rp, tuple) else (rp,)
        return tuple(sorted({max(1, int(o)) for o in options}))

    def _build_params(self, wb, vth, off) -> dict[str, Any]:
        fmk = self._fault_masks
        if fmk is not None:
            vth = tuple(faults_mod.faulted_vth(vth, fmk))
            if self.spec.mode != "cycle":
                wb = tuple(faults_mod.faulted_weights(
                    wb, fmk, max(1, int(self.spec.read_ports))))
        params: dict[str, Any] = {"vth": vth, "out_offset": off}
        if self.spec.mode == "cycle":
            # float32 ±1, decoded once an effective port count: read-disturb
            # upsets scale with the ports, so a faulted sweep reads another
            # array at each; a clean one shares one decode
            def decode(ws):
                return tuple(nrn.decode_bitlines(w).to(torch.float32)
                             for w in ws)

            options = self._cycle_port_options()
            if fmk is None:
                params["cycle_w_signed"] = dict.fromkeys(options, decode(wb))
            else:
                params["cycle_w_signed"] = {
                    p: decode(faults_mod.faulted_weights(wb, fmk, p))
                    for p in options}
        elif self.spec.mode == "functional" or (
                self.spec.mode == "prefix" and not self.prefix_packed):
            # float32 ±1: the dense matmul operand, decoded once
            params["w_signed"] = tuple(
                nrn.decode_bitlines(w).to(torch.float32) for w in wb)
        elif self.spec.mode == "prefix":
            params["w_planes"] = tuple(
                packing.pack_weight_planes(w) for w in wb)
        elif self.spec.mode == "temporal":
            params["w_mac"] = temporal_mod.mac_operands(wb)
        else:
            planes = tuple(packing.pack_weight_planes(w) for w in wb)
            params["w_stack"], params["vth_stack"] = (
                pop_ops.stack_cascade_operands(planes, vth, self.topology))
            params["cascade_tiles"] = pop_ops.cascade_tiles(
                params["w_stack"], params["vth_stack"], self.topology)
        return params

    def _prepare(self) -> dict[str, Any]:
        """Cached prep, rebuilt whenever a parameter tensor changes.

        Torch buffers are mutable: an in-place write keeps the tensor's id
        and storage but bumps its ``_version``, and ``.to()`` or a swapped
        buffer changes its id or storage.  Keying on all three means a cached
        plan never serves stale operands.
        """
        net = self.network
        key = self._param_key()
        if key != self._prep_key:
            self._prep_params = self._build_params(
                tuple(net.weight_bits), tuple(net.vth), net.out_offset)
            self._prep_key = key
        return self._prep_params

    def _param_key(self) -> tuple:
        net = self.network
        src = (*net.weight_bits, *net.vth, net.out_offset)
        return tuple((id(t), t.data_ptr(), t._version) for t in src)

    # ------------------------------------------------------------------ #
    # cold start: every shape run once, and on the card one CUDA graph each
    # ------------------------------------------------------------------ #
    def input_buffer(self, batch: int) -> torch.Tensor:
        """The static input of one padded batch of ``batch`` (zeros until a
        caller writes it): int32 words ``[batch, W]``, ``[T, batch, W]`` in
        temporal mode, bool spikes in the unpacked modes.  A captured graph
        reads it; the counterpart of the reference's donated input
        (``PlanSpec.donate``)."""
        buf = self._inputs.get(batch)
        if buf is None:
            shape = (batch, self._in_width)
            if self.spec.mode == "temporal":
                shape = (self.spec.temporal.n_steps,) + shape
            dtype = packing.WORD_DTYPE if self._packed_input else torch.bool
            buf = torch.zeros(shape, dtype=dtype, device=self.network.device)
            self._inputs[batch] = buf
        return buf

    def _traced(self, x: torch.Tensor, epilogue):
        res = self(x)
        return res if epilogue is None else epilogue(res)

    def warmup(self, batch_sizes: Sequence[int], *, aot: bool = True,
               epilogue=None, key=None) -> dict[int, float]:
        """Run every shape the caller will serve before the first request,
        one per (padded) batch size, typically an engine's bucket ladder.

        Each batch runs once on its static input (:meth:`input_buffer`):
        that builds every kernel library and loads every module.  On the
        card with ``aot=True`` the whole call (the plan, then
        ``epilogue(result)`` when given) is then captured into one CUDA
        graph a batch size under ``key`` (:meth:`graph`), on a side stream;
        a replay launches nothing from Python.  ``aot=False``, and the CPU,
        capture nothing.  Returns ``{batch: seconds}``.
        """
        self._prepare()
        dev = self.network.device
        capture = aot and dev.type == "cuda"
        times: dict[int, float] = {}
        for b in batch_sizes:
            b = int(b)
            if b < 1:
                raise ValueError(f"batch sizes must be >= 1, got {b}")
            t0 = time.perf_counter()
            self._traced(self.input_buffer(b), epilogue)
            if capture:
                torch.cuda.synchronize(dev)
                self._capture(b, key, epilogue)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            times[b] = time.perf_counter() - t0
        return times

    def _capture(self, batch: int, key, epilogue) -> None:
        self._prepare()            # operands rebuilt outside the capture
        x = self.input_buffer(batch)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = self._traced(x, epilogue)
        self._graphs[(batch, key)] = PlanGraph(
            graph=graph, static_in=x, out=out, prep_key=self._prep_key,
            epilogue=epilogue)
        self.captures += 1

    def graph(self, batch: int, key=None) -> Optional["PlanGraph"]:
        """The CUDA graph :meth:`warmup` captured for ``batch`` under
        ``key``, or None.  A graph holds the operands' addresses: when a
        parameter tensor changed since the capture, it is captured again
        first, so a replay never serves stale weights."""
        g = self._graphs.get((batch, key))
        if g is not None and self._param_key() != g.prep_key:
            self._capture(batch, key, g.epilogue)
            g = self._graphs[(batch, key)]
        return g

    # ------------------------------------------------------------------ #
    # execution
    # ------------------------------------------------------------------ #
    def _normalize(self, x) -> tuple[torch.Tensor, tuple[int, ...]]:
        """Coerce input to a flat 2-D batch on the network's device;
        returns (x2d, leading shape).

        Temporal plans instead take a time-first event stream
        ``[T, ..., n_in]`` (spikes or wire words) and return it as
        ``[T, B, words]`` for ``temporal_forward`` — time is never a batch
        axis.
        """
        if isinstance(x, np.ndarray):
            x = (packing.words_from_np(x) if x.dtype == np.uint32
                 else torch.from_numpy(np.ascontiguousarray(x)))
        elif not isinstance(x, torch.Tensor):
            x = torch.as_tensor(x)
        x = x.to(self.network.device)
        if self.spec.mode == "temporal":
            t = self.spec.temporal.n_steps
            if x.dim() < 2 or x.shape[0] != t:
                raise ValueError(f"temporal plan expects events[{t}, ..., n],"
                                 f" got {tuple(x.shape)}")
            lead = tuple(x.shape[1:-1])
            x = self._wire(x)
            return x.reshape(t, -1, x.shape[-1]), lead
        lead = tuple(x.shape[:-1])
        if self._packed_input:
            x = self._wire(x)
        else:
            if x.shape[-1] != self._n_in:
                raise ValueError(
                    f"expected spikes[..., {self._n_in}], got {tuple(x.shape)}")
            x = x != 0
        return x.reshape(-1, x.shape[-1]).contiguous(), lead

    def _wire(self, x: torch.Tensor) -> torch.Tensor:
        """Spikes or wire words ``[..., n]`` -> wire words ``[..., W]``."""
        if (x.dtype == packing.WORD_DTYPE and x.shape[-1] == self._in_width
                and self._in_width != self._n_in):
            return x                                   # already wire format
        if x.shape[-1] == self._n_in:
            return packing.pack_spikes(x != 0)         # spikes -> wire format
        raise ValueError(
            f"expected spikes[..., {self._n_in}] or int32 words"
            f"[..., {self._in_width}], got {tuple(x.shape)} {x.dtype}")

    @staticmethod
    def _dense_prefix(ws, vth, s):
        hidden = []
        for w, th in zip(ws[:-1], vth[:-1]):
            s, _ = tile_mod.functional_tile(None, s, th, w_signed=w)
            hidden.append(s)
        return s, hidden

    @staticmethod
    def _popcount_prefix(planes, vth, p):
        """Per-tile popcount cascade: one ``popcount_fire`` per hidden tile."""
        collected = [p]
        for w, th in zip(planes[:-1], vth[:-1]):
            p = pop_ops.esam_layer_popcount(p, w, th)
            collected.append(p)
        return p, collected

    def _run(self, params: dict[str, Any], x: torch.Tensor) -> dict:
        spec = self.spec
        vth, off = params["vth"], params["out_offset"]
        out: dict[str, Any] = {}
        if spec.mode == "prefix":
            if self.prefix_packed:
                p, planes = self._popcount_prefix(params["w_planes"], vth, x)
            else:
                p, hidden = self._dense_prefix(params["w_signed"], vth, x)
                planes = [x, *hidden]
            out["prefix"] = p
            if spec.collect:
                out["planes"] = tuple(planes)
            if spec.telemetry:
                out["loads"] = tuple(
                    packing.group_popcount(pl) if self.prefix_packed
                    else arb.split_row_groups(pl.to(torch.int32)).sum(
                        -1, dtype=torch.int32)
                    for pl in planes)
        elif spec.mode == "functional":
            ws = params["w_signed"]
            s, hidden = self._dense_prefix(ws, vth, x)
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
        elif spec.mode == "packed":
            vmem, fired = pop_ops.esam_cascade_popcount(
                x, params["w_stack"], params["vth_stack"],
                topology=self.topology, tiles=params["cascade_tiles"])
            planes = (x,) + tuple(fired)
            # int32 + float32 promotes to float32 in one op: the same bits
            # as a cast and an add, one launch fewer
            out["logits"] = vmem + off
            if spec.collect:
                out["planes"] = planes
            if spec.telemetry:
                # every plane's loads in one tile_loads launch on the card
                out["loads"] = tele_ops.tile_loads(planes)
        elif spec.mode == "temporal":
            out.update(temporal_mod.temporal_forward(
                params["w_mac"], vth, off, x, spec.temporal,
                self.topology, collect=spec.collect,
                telemetry=spec.telemetry))
        else:  # cycle: one simulation per effective port count
            rp = spec.read_ports
            options = rp if isinstance(rp, tuple) else (rp,)
            by_ports: dict[int, dict] = {}
            for opt in options:
                ports = max(1, int(opt))
                if ports in by_ports:
                    continue
                traces, s = [], x
                for w, th in zip(params["cycle_w_signed"][ports], vth):
                    tr = tile_mod.simulate_tile_batch(
                        None, s, th, ports, spec.record_vmem_trace,
                        w_signed=w)
                    traces.append(tr)
                    s = tr.out_spikes
                by_ports[ports] = {
                    "logits": traces[-1].vmem_final.to(torch.float32) + off,
                    "traces": tuple(traces)}
            if isinstance(rp, tuple):
                out["sweep"] = {int(o): by_ports[max(1, o)] for o in rp}
            else:
                out.update(by_ports[max(1, rp)])
            if spec.telemetry:
                # the loads of the first option's simulation (a faulted
                # sweep's port counts drain different spikes)
                traces = next(iter(by_ports.values()))["traces"]
                out["loads"] = tuple(
                    arb.split_row_groups(si.to(torch.int32)).sum(
                        -1, dtype=torch.int32)
                    for si in [x, *(tr.out_spikes for tr in traces[:-1])])
        return out

    def __call__(self, x) -> PlanResult:
        x, lead = self._normalize(x)
        out = self._run(self._prepare(), x)
        return PlanResult(**{k: _with_lead(v, lead) for k, v in out.items()})


@dataclasses.dataclass
class PlanGraph:
    """One captured call of a plan: its graph, the static input it reads
    and the outputs it writes (the graph's own memory: every replay
    overwrites them, so a caller copies them out before the next)."""

    graph: Any
    static_in: torch.Tensor
    out: Any
    prep_key: tuple
    epilogue: Any = None

    def replay(self, src: Optional[torch.Tensor] = None):
        """Copy ``src`` (any device; pinned host memory copies
        asynchronously) into the static input, replay, return the
        outputs."""
        if src is not None:
            self.static_in.copy_(src, non_blocking=True)
        self.graph.replay()
        return self.out


def _with_lead(v, lead: tuple[int, ...]):
    """Reshape the flat batch axis of every tensor in ``v`` back to the
    caller's leading dims (tensors, tuples, TileTraces, sweep dicts)."""
    if isinstance(v, torch.Tensor):
        return v.reshape(lead + v.shape[1:])
    if isinstance(v, dict):
        return {k: _with_lead(a, lead) for k, a in v.items()}
    if isinstance(v, tile_mod.TileTrace):
        return tile_mod.TileTrace(*(_with_lead(a, lead) for a in v))
    return tuple(_with_lead(a, lead) for a in v)
