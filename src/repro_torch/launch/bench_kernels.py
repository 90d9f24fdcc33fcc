"""Kernel bench of the port: every kernel lane of the reference's
``benchmarks/bench_kernels.py``, on the card and against the plain versions.

    python -m repro_torch.launch.bench_kernels                 # on the card
    python -m repro_torch.launch.bench_kernels --device cpu --smoke
    python -m repro_torch.launch.bench_kernels --out bench.json

Each lane is recorded twice: ``_plain`` times the plain PyTorch version
(the ``*_ref`` functions, called by name) and ``_cuda`` the hand-written
kernel (the reference's ``_interpret`` and ``_compiled`` lanes; CUDA has no
interpret mode).  A ``_cuda`` row's ``us`` is one eager call as a caller
sees it (host work included, the reference's wall-clock ``time_call``);
its ``graph_us`` is the device time, from CUDA-graph replays.  On the CPU the
``_cuda`` rows are recorded as ``lane=cuda_skipped`` with no time.

Headline section: the popcount-domain MAC and the single-launch mega
cascade (``kernels/cim_popcount``) against the packed plane
(``kernels/cim_matmul_packed``) at the serving shape 1024 x 768 -> 768.
Bit identity of every kernel against its plain version, and of the
popcount lanes against the packed oracle, is asserted before anything is
timed, and the popcount lanes must clear ``SPEEDUP_FLOOR`` over the packed
lanes in device time on the ``_cuda`` lane (asserted; the ``_plain`` lane's
ratios are recorded, not asserted: they time PyTorch's elementwise kernels,
not a kernel body).  Each row carries its roofline inputs from
``cost_model.mac_datapath_stats`` and the card's rates.

Operands are drawn with ``core/prng.py`` under the reference's keys, so the
port's bench and the reference's see the same spikes and bits;
``if_neuron``'s updates come from numpy (no timing depends on them).
``--smoke`` shrinks the comparison's batch to 64, never a width.  Rows go to
stdout as ``name,us,derived``; ``--out`` writes ``{"results": [...]}``.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import statistics
import time

import numpy as np
import torch

from repro_torch.core import packing, prng
from repro_torch.core.esam import cost_model
from repro_torch.core.esam import plan as plan_mod
from repro_torch.kernels.arbiter import ops as arb_ops
from repro_torch.kernels.cim_matmul import ops as cim_ops
from repro_torch.kernels.cim_matmul_packed import ops as pk_ops
from repro_torch.kernels.cim_popcount import ops as pop_ops
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.if_neuron import ops as if_ops
from repro_torch.kernels.stdp import ops as stdp_ops
from repro_torch.launch.bench_common import Recorder
from repro_torch.obs.metrics import Registry
from repro_torch.obs.profile import call_ms, graph_ms, kernel_timer

#: popcount lanes must be at least this much faster than the packed lanes
#: (device time on the ``_cuda`` lane)
SPEEDUP_FLOOR = 1.0
#: the comparison's shape (``--smoke`` cuts the batch only)
COMPARE_B, SMOKE_B, COMPARE_K, COMPARE_N = 1024, 64, 768, 768
#: hidden threshold of the comparison's cascade, as in the reference
CASCADE_VTH = 96
#: the STDP lanes' probabilities, as in the reference
P_POT, P_DEP = 0.2, 0.1
#: timed kernel calls: graph captures and eager calls per replay
GRAPH_CALLS, GRAPH_REPLAYS = 20, 7
CALL_CALLS, CALL_REPLAYS = 20, 5
#: eager calls of a plain version per replay on the card, and its repeats
#: on the CPU (wall clock, after one warm-up)
PLAIN_CALLS, PLAIN_REPLAYS, CPU_REPEATS = 5, 3, 3
#: timed calls per kernel on the obs lane
OBS_REPEATS = 3


@dataclasses.dataclass
class Lane:
    """One kernel lane: its plain version, its kernel wrapper, and the
    kernel launches one call of the wrapper makes."""

    name: str
    plain: object                   # () -> tensor or tuple of tensors
    kernel: object                  # () -> the same, through the wrapper
    launches: dict
    derived: str


@dataclasses.dataclass
class BenchRun:
    """What one bench run recorded, for callers that check it."""

    rows: list                      # {"name", "us_per_call", "derived"}
    launches: dict                  # kernel launches made, by counter name
    speedups: dict                  # the floor's ratios, per lane and timing


def _roofline(datapath: str, B: int, K: int, N: int) -> str:
    r = cost_model.mac_datapath_stats(B, K, N, datapath)
    return (f"hbm_bytes={r['hbm_bytes']};compute_ops={r['compute_ops']};"
            f"unit={r['unit']};t_roofline_us={r['t_roofline_us']:.3f};"
            f"bound={r['bound']}")


def _equal(a, b) -> bool:
    """Tensors (or tuples of them) equal in dtype, shape and value."""
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and torch.equal(a, b)


class _Bench:
    def __init__(self, device: torch.device):
        self.device = device
        self.on_card = device.type == "cuda"
        self.rec = Recorder()
        self.launches: collections.Counter = collections.Counter()

    def counted(self, fn, launches: dict):
        """``fn`` that adds its kernel launches to the run's tally on the
        card (where the wrappers launch; on the CPU they launch nothing)."""
        if not self.on_card:
            return fn

        def run():
            self.launches.update(launches)
            return fn()
        return run

    def sync(self) -> None:
        if self.on_card:
            torch.cuda.synchronize(self.device)

    def time_plain(self, fn) -> float:
        """Microseconds of one plain call: eager CUDA-event time on the
        card, the wall-clock median on the CPU."""
        if self.on_card:
            return call_ms(fn, PLAIN_CALLS, PLAIN_REPLAYS) * 1e3
        fn()
        times = []
        for _ in range(CPU_REPEATS):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e6)
        return statistics.median(times)

    def gate(self, lane: Lane) -> None:
        """Bit identity of the kernel against its plain version."""
        if not self.on_card:
            return
        got = self.counted(lane.kernel, lane.launches)()
        if not _equal(got, lane.plain()):
            raise AssertionError(f"{lane.name}: kernel != plain version")

    def record(self, lane: Lane) -> dict:
        """Both lanes of one kernel; returns the times in microseconds
        (``plain``, and on the card ``graph`` and ``call``)."""
        out = {"plain": self.time_plain(lane.plain)}
        self.rec.emit(f"{lane.name}_plain", out["plain"],
                      f"lane=plain;device={self.device.type};{lane.derived}")
        if not self.on_card:
            self.rec.emit(f"{lane.name}_cuda", 0.0,
                          f"lane=cuda_skipped;device=cpu;{lane.derived}")
            return out
        fn = self.counted(lane.kernel, lane.launches)
        out["graph"] = graph_ms(fn, GRAPH_CALLS, GRAPH_REPLAYS) * 1e3
        out["call"] = call_ms(fn, CALL_CALLS, CALL_REPLAYS) * 1e3
        self.rec.emit(f"{lane.name}_cuda", out["call"],
                      f"lane=cuda;graph_us={out['graph']:.3f};"
                      f"{lane.derived}")
        return out


def _single_lanes(dev: torch.device) -> list[Lane]:
    """The reference's ``run()`` lanes before the comparison."""
    key = prng.PRNGKey(0, device=dev)
    s = prng.bernoulli(key, 0.4, (256, 768)).to(torch.float32)
    w = prng.bernoulli(prng.fold_in(key, 1), 0.5, (768, 256)).to(torch.int8)
    vth = torch.zeros((256,), dtype=torch.int32, device=dev)
    req = prng.bernoulli(key, 0.4, (16, 128))
    upd = torch.from_numpy(np.random.default_rng(0).integers(
        -3, 4, size=(8, 32, 256), dtype=np.int32)).to(dev)
    vth_if = torch.zeros((256,), dtype=torch.int32, device=dev)
    bits = prng.bernoulli(key, 0.5, (128, 256)).to(torch.int8)
    pre = prng.bernoulli(prng.fold_in(key, 2), 0.5, (256,)).to(torch.int8)
    post = prng.bernoulli(prng.fold_in(key, 3), 0.2, (128,)).to(torch.int8)
    u1 = prng.uniform(prng.fold_in(key, 4), (128, 256))
    u2 = prng.uniform(prng.fold_in(key, 5), (128, 256))
    uv1 = prng.uniform(prng.fold_in(key, 6), (256,))
    uv2 = prng.uniform(prng.fold_in(key, 7), (256,))
    col = torch.tensor(5, dtype=torch.int32, device=dev)
    apply = torch.tensor(True, device=dev)
    pre_b = pre.to(torch.bool)
    work = bits.clone()   # the column event writes in place (gate first)
    flops = 2 * 256 * 768 * 256
    return [
        Lane("kernel_cim_matmul_256x768x256",
             lambda: cim_ops.cim_matmul_ref(s, w),
             lambda: cim_ops.cim_matmul(s, w), {"cim_matmul": 1},
             f"flops={flops};spikes=float32;mac=b1_mma_and_popc;"
             f"{_roofline('dense_mxu', 256, 768, 256)}"),
        Lane("kernel_esam_layer_fused",
             lambda: cim_ops.esam_layer_ref(s, w, vth),
             lambda: cim_ops.esam_layer(s, w, vth), {"esam_layer": 1},
             "fused=mac+if_fire;vmem=registers"),
        Lane("kernel_arbiter_16x128_p4",
             lambda: arb_ops.arbiter_ref(req, 4),
             lambda: arb_ops.arbiter(req, ports=4), {"arbiter": 1},
             "prefix=ballot_popc_rank"),
        Lane("kernel_if_neuron_8x32x256",
             lambda: if_ops.if_neuron_ref(upd, vth_if),
             lambda: if_ops.if_neuron(upd, vth_if), {"if_neuron": 1},
             "vmem=register;rounds=split_uint32_shfl_sum"),
        Lane("kernel_stdp_128x256",
             lambda: stdp_ops.stdp_update_ref(bits, pre, post, u1, u2,
                                              P_POT, P_DEP),
             lambda: stdp_ops.stdp_update(bits, pre, post, u1, u2,
                                          p_pot=P_POT, p_dep=P_DEP),
             {"stdp_update": 1}, "layout=column_major_transposed_port"),
        Lane("kernel_stdp_column_event_128x256",
             lambda: stdp_ops.stdp_column_event_ref(
                 bits, col, apply, pre_b, uv1, uv2, P_POT, P_DEP),
             lambda: stdp_ops.stdp_column_event(
                 work, col, apply, pre_b, uv1, uv2, p_pot=P_POT,
                 p_dep=P_DEP),
             {"stdp_column_event": 1},
             "route=event_row_after_index;write=in_place;"
             "rng_draws_per_event=n_in_not_n_in_x_n_out"),
    ]


class _Comparison:
    """The popcount plane against the packed plane at B x 768 -> 768 and the
    cascade (768, 768, 768, 10): operands, lanes and the identity gates."""

    def __init__(self, dev: torch.device, batch: int):
        key = prng.fold_in(prng.PRNGKey(0, device=dev), 9)
        B, K, N = self.shape = (batch, COMPARE_K, COMPARE_N)
        s = prng.bernoulli(key, 0.4, (B, K))
        w = prng.bernoulli(prng.fold_in(key, 1), 0.5, (K, N)).to(torch.int8)
        vth = torch.zeros((N,), dtype=torch.int32, device=dev)
        packed = packing.pack_spikes(s)
        planes = packing.pack_weight_planes(w)
        self.topo = topo = (K, N, N, 10)
        wb = [prng.bernoulli(prng.fold_in(key, 10 + i), 0.5,
                             (topo[i], topo[i + 1])).to(torch.int8)
              for i in range(3)]
        vths = [torch.full((topo[i + 1],), CASCADE_VTH, dtype=torch.int32,
                           device=dev) for i in range(3)]
        tile_planes = [packing.pack_weight_planes(x) for x in wb]
        w_stack, vth_stack = pop_ops.stack_cascade_operands(
            tile_planes, vths, topo)
        tiles = pop_ops.cascade_tiles(w_stack, vth_stack, topo)
        self.packed, self.w, self.planes = packed, w, planes

        def cascade_plain():
            p = packed
            for x, th in zip(wb[:-1], vths[:-1]):
                p = pk_ops.esam_layer_packed_ref(p, x, th)
            return pk_ops.cim_matmul_packed_ref(p, wb[-1])

        def cascade_kernel():
            return pk_ops.cim_matmul_packed(
                plan_mod.packed_prefix(wb, vths, packed), wb[-1])

        cascade = "x".join(map(str, topo))
        bytes_packed = B * packing.packed_nbytes(K)
        self.matmul_packed = Lane(
            f"kernel_cim_matmul_packed_{B}x{K}x{N}",
            lambda: pk_ops.cim_matmul_packed_ref(packed, w),
            lambda: pk_ops.cim_matmul_packed(packed, w),
            {"cim_matmul_packed": 1},
            f"spike_bytes_moved={bytes_packed};wire=uint32_bitplane;"
            f"unpack=none_ballot_planes;{_roofline('packed_mxu', B, K, N)}")
        self.popcount = Lane(
            f"kernel_cim_popcount_{B}x{K}x{N}",
            lambda: pop_ops.cim_popcount_ref(packed, planes),
            lambda: pop_ops.cim_popcount_matmul(packed, planes),
            {"popcount_mac": 1},
            f"spike_bytes_moved={bytes_packed};wire=uint32_bitplane;"
            f"mac=and_popcount;unpack=none;"
            f"{_roofline('popcount_vpu', B, K, N)}")
        self.popcount_fused = Lane(
            f"kernel_esam_layer_popcount_fused_{B}x{K}x{N}",
            lambda: pop_ops.esam_layer_popcount_ref(packed, planes, vth),
            lambda: pop_ops.esam_layer_popcount(packed, planes, vth),
            {"popcount_fire": 1},
            f"fused=popcount_mac+if_fire+repack;out_bytes={B * N // 8};"
            f"inter_tile_wire=uint32_bitplane")
        self.per_tile = Lane(
            f"cascade_packed_per_tile_{B}x{cascade}", cascade_plain,
            cascade_kernel, {"fused_fire_packed": 2, "cim_matmul_packed": 1},
            f"launches={len(topo) - 1};datapath=packed_mxu")
        self.mega = Lane(
            f"cascade_popcount_mega_{B}x{cascade}",
            lambda: pop_ops.esam_cascade_popcount_ref(
                packed, tuple(tile_planes), tuple(vths))[0],
            lambda: pop_ops.esam_cascade_popcount(
                packed, w_stack, vth_stack, topology=topo, tiles=tiles)[0],
            {"mega_cascade": 1},
            "launches=1;datapath=popcount;weights=cluster_split_bulk_staged;"
            "fired_planes=distributed_shared")

    def lanes(self) -> list[Lane]:
        return [self.matmul_packed, self.popcount, self.popcount_fused,
                self.per_tile, self.mega]

    def gate(self, bench: _Bench) -> None:
        """The reference's gates: the popcount MAC (plain and kernel) equals
        the packed oracle, and the mega cascade's logits the per-tile
        cascade's, on the run's device."""
        want = bench.counted(self.matmul_packed.kernel,
                             self.matmul_packed.launches)()
        if not _equal(want, self.popcount.plain()):
            raise AssertionError("popcount ref != packed oracle")
        got = bench.counted(self.popcount.kernel, self.popcount.launches)()
        if not _equal(want, got):
            raise AssertionError("popcount kernel != packed oracle")
        per_tile = bench.counted(self.per_tile.kernel,
                                 self.per_tile.launches)()
        mega = bench.counted(self.mega.kernel, self.mega.launches)()
        if not _equal(per_tile, mega):
            raise AssertionError(
                "mega cascade logits != per-tile packed cascade")


def run(device="cuda", smoke: bool = False) -> BenchRun:
    """Every lane of the reference's kernel bench on ``device`` (the card
    unless asked otherwise; with no GPU the default raises)."""
    dev = resolve_device(device)
    bench = _Bench(dev)
    single = _single_lanes(dev)
    cmp = _Comparison(dev, SMOKE_B if smoke else COMPARE_B)
    B, K, N = cmp.shape

    # ---- bit identity before anything is timed ------------------------- #
    for lane in single + cmp.lanes():
        bench.gate(lane)
    cmp.gate(bench)
    bench.sync()

    for lane in single:
        bench.record(lane)
    t = {}
    for lane in cmp.lanes():
        t[lane.name] = bench.record(lane)
        if lane is cmp.popcount:     # the reference's jnp_ref row
            bench.rec.emit(f"kernel_cim_popcount_ref_{B}x{K}x{N}",
                           bench.time_plain(cmp.popcount.plain),
                           f"lane=plain_ref;device={dev.type};"
                           "dispatch=cpu_tensors;mac=and_popcount")

    # ---- the floor, recorded next to the measurement ------------------- #
    def ratio(a: Lane, b: Lane, timing: str) -> float:
        return t[a.name][timing] / t[b.name][timing]

    speedups = {
        "plain_matmul": ratio(cmp.matmul_packed, cmp.popcount, "plain"),
        "plain_cascade": ratio(cmp.per_tile, cmp.mega, "plain")}
    cuda = ""
    if bench.on_card:
        for timing in ("graph", "call"):
            speedups[f"cuda_{timing}_matmul"] = ratio(
                cmp.matmul_packed, cmp.popcount, timing)
            speedups[f"cuda_{timing}_cascade"] = ratio(
                cmp.per_tile, cmp.mega, timing)
        cuda = "".join(f";speedup_cuda_{k}={speedups[f'cuda_{k}']:.2f}x"
                       for k in ("graph_matmul", "graph_cascade",
                                 "call_matmul", "call_cascade"))
    bench.rec.emit(
        "kernel_popcount_speedup_vs_packed", 0.0,
        f"floor={SPEEDUP_FLOOR:.1f}x;"
        f"asserted={'cuda_graph' if bench.on_card else 'no_cuda_lane'};"
        f"bit_identity=checked;"
        f"speedup_plain_matmul={speedups['plain_matmul']:.2f}x;"
        f"speedup_plain_cascade={speedups['plain_cascade']:.2f}x{cuda}")
    if bench.on_card:
        for what in ("matmul", "cascade"):
            sp = speedups[f"cuda_graph_{what}"]
            if not sp >= SPEEDUP_FLOOR:
                raise AssertionError(
                    f"popcount {what} below the floor on the cuda lane: "
                    f"{sp:.2f}x < {SPEEDUP_FLOOR:.1f}x")

    # ---- per-kernel timing through the observability registry ---------- #
    lane_name = "cuda" if bench.on_card else "plain"
    reg = Registry()
    for kname, lane in (("cascade_packed_per_tile", cmp.per_tile),
                        ("cascade_popcount_mega", cmp.mega)):
        fn = (bench.counted(lane.kernel, lane.launches) if bench.on_card
              else lane.plain)
        for _ in range(OBS_REPEATS):
            with kernel_timer(reg, kname, lane=lane_name):
                fn()
                bench.sync()
    h_pk = reg.get("esam_kernel_seconds", kernel="cascade_packed_per_tile",
                   lane=lane_name)
    h_mg = reg.get("esam_kernel_seconds", kernel="cascade_popcount_mega",
                   lane=lane_name)
    bench.rec.emit(
        "kernel_obs_timing_lane", h_mg.sum / h_mg.count * 1e6,
        f"lane={lane_name};registry=esam_kernel_seconds;"
        f"observations={h_pk.count + h_mg.count};"
        f"packed_p50_us={h_pk.quantile(0.5) * 1e6:.0f};"
        f"mega_p50_us={h_mg.quantile(0.5) * 1e6:.0f};"
        f"quantile_source=log_bucketed_histogram")
    return BenchRun(rows=bench.rec.rows, launches=dict(bench.launches),
                    speedups=speedups)


def main(argv=None) -> BenchRun:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises with no GPU) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help=f"comparison batch {SMOKE_B} instead of {COMPARE_B}")
    ap.add_argument("--out", default=None,
                    help="write {\"results\": [...]} to this JSON file")
    args = ap.parse_args(argv)
    res = run(args.device, smoke=args.smoke)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"results": res.rows}, f, indent=2)
        print(f"[bench] wrote {args.out} ({len(res.rows)} entries)")
    return res


if __name__ == "__main__":
    main()
