#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any failure raises, so the exit code is non-zero:

1. the card's name and power limit (``nvidia-smi``), torch and CUDA versions;
2. build the CUDA kernels from ``src/repro_torch/kernels/*/csrc`` (one
   ``nvcc`` per library, and one each for ``probes/rate_probe.cu`` and
   ``probes/launch_floor.cu``, all started together); then the issue rates
   of the b1 and int8 tensor-core products and the popc unit, with the SM
   clock (``rate_probe``; the b1 reading is the rate of the b1 kernels'
   bounds), what one launch of an empty kernel and of a one-load kernel
   costs in a CUDA graph (``launch_floor``), and the tensor-core
   instruction (BMMA) in every kernel on the b1 product: B2/B3's, B1's b1
   instantiation, B9/B9''s and B10's (``cuobjdump``, ``sass``);
3. each kernel against its plain PyTorch version on the card, bit for bit,
   at the paths' shapes and more (B2 and B3 at ragged shapes in every
   output mode, on all-zero and all-one operands, at thresholds of -2^31
   and 2^31 - 1 and on strided spike rows, each with its route, the
   CUDA-core kernel's time before it and three bounds (b1, int8, popc);
   B9 and B9' at the paths' and the bench's shapes, ragged ones, on spike
   bits set past K, at K 40000, on weight views whose rows are 16-byte
   aligned or not, each with its route and three bounds; B10 and B11 at
   the bench's shapes, ragged ones and 4096 x 768 -> 256; B10 in four
   spike dtypes at both, at N 10 and 77, K 40000, on spike rows that
   start 16-byte aligned or not, on all-zero and all-one spikes and at
   thresholds of -2^31 and 2^31 - 1, each with its route and three
   bounds; B11 with its route (4 neurons a 16-byte load, or one) at N
   % 4 != 0, T 0, 1 and 37, past one wave of the card, on update views
   at an offset and a threshold view, at threshold equality and under int32
   wraparound on both loads, with ``sum_ms`` (the rounds' sum alone as one
   PyTorch call); B1 at
   the bench's (768, 768, 768, 10) and on each route of its launcher:
   clusters of 1, 2, 4, 8 and 16 CTAs, word counts fixed at compile time
   and not, a partly empty last slice, more slices than clusters, the
   popc and the b1 MAC, each asserted, and under three geometries its
   launcher does not pick at B 128, 256 and 1024 (``mega_geometry``
   lines: the other MAC, clusters of 8, a CTA an SM);
   the single column event at rows inside and
   outside [0, n_out), gated on and off, on each of its routes (4-input
   or byte and float loads), on row strided matrices and on trace and
   uniform views at an offset; the epoch's two kernels (``stdp_epoch_masks``, which
   draws the uniforms itself, and the chain) at 4096 x 256 -> 10 and ragged
   and wide readouts, with ties, offsets, an out-of-range label and a key
   past 2^31, on every route of the chain (``epoch_sass``: its ptxas
   registers and spills and its REDUX and POPC a route); the matrix-RNG
   epoch's three kernels (``stdp_update_keys``, ``stdp_update_masks`` and
   the chain) each against its plain version at the scan path's 64 and 4096
   x 256 -> 10 (timed: the key walk's serial floor, clocks a chain step, the
   epoch against its bound) and at labels outside [0, n_out), a tied
   readout, p of 0 and 1, 0 and 1 samples and every route of the chain; B8
   bit for bit at W 32, 128 and 1024, ports 1, 2, 4, 5 and 8, random,
   all-on and all-off requests and G 1, 16 and 1000; the
   event round's ``temporal_scan`` at the event path's T 4, 8 and 16 and
   B 64 on its register route (a cluster pipelining 8 streams through
   the tiles on the b1 product; ``scan_sass``: its ptxas registers and
   spills, none at the paper shape), at B 1, 7, 15, 16, 17 and 33, with 0,
   1 and 4 hidden tiles, widths 255, 256 and 257 (first widths 255 and
   257 on the shared-memory route), per reset mode with
   refractory 2, and on each of the shared-memory kernel's three routes:
   planes and state in shared memory (5 tiles), planes past it, state past
   it too; at hidden widths that are not multiples of 32, and at 34 hidden
   tiles, two launches), timed against its bounds and, on the register
   route, beside the shared-memory kernel on the same operands;
   The round telemetry's two kernels (port-only, ``kernels/telemetry``):
   ``tile_loads`` on a static round's four planes at B 8-128 and ragged B,
   on an event round's tile 0 at T 4/8/16 x B 64, on all-zero and all-one
   words and on a view that is not 16-byte aligned; ``request_stats`` at
   B 1-333 and every cell option, with and without the logits, on
   all-zero and all-full loads, and on event rounds at T 1/4/16, each bit
   for bit and timed against its bytes bound;
4. the serving path: ``repro_torch.launch.serve --esam`` at the paper
   topology 768:256:256:256:10, max_batch 128, telemetry on, 4096 digit
   requests, as the reference's launcher serves (overlapped packer, fuse
   auto), with the launch counters set to 0 just before and read just
   after (one ``mega_cascade``, one ``tile_loads`` and one
   ``request_stats`` a round); the served logits are held against the
   port's functional plan on the card and the per-request cycles and
   energy against the float64 cost model; then ``--warmup`` (its
   ``COLDSTART`` line; graphs captured = buckets, replays = rounds, no
   kernel launched while serving) and ``--no-overlap --fuse off``, all
   three bit for bit alike; each drain's req/s with its spread (5 drains
   each, in turns; a warmed synchronous engine beside them), and the
   synchronous and warmed drains profiled
   (device operations, copies and host launches a round: at most 6
   device operations a synchronous round; a warmed round is one graph
   replay, the input copy and one copy out); one more drain of each
   split on the caller's thread (``main path host split``: the pack, or
   the wait on the packer thread, the dispatch, and the rest, which must
   not be negative; the packer's own pack time beside);
5. the one-tile path: a 768:10 network served through ``SpikeEngine``
   (``popcount_mac``), counted and checked the same way;
6. the learning path: ``repro_torch.train.online.train_online`` on the paper
   topology (4096 training and 1024 eval digits, 6 shuffled epochs,
   checkpoints), counted the same way (``popcount_fire`` per hidden tile and
   split, ``stdp_epoch_masks`` and ``stdp_column_epoch`` once per epoch;
   the torch draw ``column_event_uniforms`` forbidden) and held bit for bit
   against the same call on the CPU (the plain versions); each epoch's
   shuffle, two kernels and readout timed apart on the same inputs; then
   ``learning.online_learning_epoch`` through the packed prefix
   (``fused_fire_packed``, one ``stdp_epoch_masks`` and one
   ``stdp_column_epoch``) and
   ``online_learning_epoch_scan`` with the matrix RNG (one
   ``stdp_update_epoch``: ``stdp_update_keys``, ``stdp_update_masks`` and
   ``stdp_update_chain``, no ``stdp_update``) at 64 and 4096 samples, each
   against its CPU twin (``scan_epoch`` lines: wall, device time,
   launches); the epoch profiled (``learning_profile``: it must hold every
   launch of both epoch kernels that their counters count);
7. the cycle plane: the quickstart twin (``repro_torch.launch.quickstart``:
   BNN -> SNN -> packed plan -> cycle plan at 4 ports -> Fig 8) at the paper
   topology, one ``port_schedule`` launch per tile; the measured Fig 8 sweep
   (``port_sweep`` over cell options 0-4 on 4096 digits, 16 launches), its
   traces and system stats held against its CPU twin; the per-cycle V_mem
   trace at 1 and 4 ports on 256 digits against its CPU twin;
8. the event path: ``repro_torch.launch.serve --events`` (256 rate-encoded
   digit streams of T 4, 8 or 16, leak 0.125, max_batch 64, the paper
   topology, through ``SpikeEngine.submit_events`` and the temporal plan),
   counted the same way (one ``popcount_mac`` for tile 0 and one
   ``temporal_scan`` for all T steps a round, no ``lif_step``); every
   stream's logits held bit for bit against the same streams served on the
   CPU, against the plain per-step oracle on the card
   (``temporal_forward_naive``: dense tiles, ``lif_step_ref``, no kernel),
   cycles and energy against
   the float64 cost model, and a T=1, zero-leak round against the packed
   plan; the same streams through a fused, overlapped engine and a warmed
   one (``warmup(event_ts=(4, 8, 16))``: a graph a (bucket, T)), bit for
   bit alike, with steps/s and its spread; the synchronous and warmed
   drains profiled (at most 8 device operations a synchronous round),
   each round's launches split into the scan, tile 0's MAC and the rest;
9. the kernel bench path: ``repro_torch.launch.bench_kernels.run`` (every
   lane of the reference's ``benchmarks/bench_kernels.py``: B10
   ``cim_matmul`` and ``esam_layer`` at 256 x 768 -> 256, B8 ``arbiter``,
   B11 ``if_neuron``, B7, B6, then B9' ``cim_matmul_packed``, B3, B2, the
   per-tile cascade (B9 x 2 + B9') and B1 at 1024 x 768 -> 768 and
   (768, 768, 768, 10)), its identity gates and its speedup floor; every
   launch counter is set to 0 just before and held to the calls the bench
   reports just after (the bench times the plain versions by name, so none
   is forbidden here; every other phase forbids them all);
10. the fault plane at the paper topology (``faults`` lines): six
    ``FaultModel``s' masks drawn on the card and on the CPU, bit for bit
    (stuck-at, dead columns with and without spares, threshold variation,
    read-disturb at ports 1-4); faulted plans of all five modes on the 4096
    digits (B1, B2 a hidden tile, B3 and the scan, B5 16 times, counted)
    against their CPU twins, functional == packed; 4096 requests through
    ``SpikeEngine(faults=, telemetry=True)``, synchronous and warmed, equal
    to the faulted functional plan, then ``replan_degraded(1)`` and again,
    with faulted and clean req/s in turns; ``launch.bench_faults`` at the
    reference's sizes (its exact assertions and its remap claim held, its
    repair claim reported; B1, B2 and the B6 epoch with faulted operands),
    its repair replayed on the CPU (bits, per-epoch accuracy, updates
    equal) and its epochs timed beside a clean run's; ``launch.serve
    --esam --traffic --replicas 2 --chaos``:
    one crash, no request failed or left pending, every completed logit
    equal to a clean replay;
11. the observability plane at the paper topology (``obs`` lines): 4096
    requests through ``SpikeEngine`` with and without
    ``Observability.enabled(registry=Registry())``, synchronous and warmed,
    equal bit for bit (results, stats() less its wall-clock keys), every
    request span closed, the counters equal to stats(), and each drain's
    req/s with the plane on and off in turns; ``DeviceProfiler`` with the
    ``torch.profiler`` backend around 4 rounds of the synchronous drain (4
    launches of each round kernel in its Chrome trace) and of a warmed one
    (4 graph replays); ``launch.serve --traffic --replicas 2 --chaos`` with
    every observability flag in a subprocess, its endpoint scraped over
    127.0.0.1 while held and reconciled with its ``--report-json`` and
    trace (``PROFILE ... status=ok``); ``train_online(observability=)``
    for 2 epochs equal to a run without it, a span and the counters an
    epoch; ``launch.bench_serving`` at the reference's sizes with the
    reference CI's assertions on its rows (``overhead_pct`` reported);
12. the paper benches (``paper_bench`` lines): ``launch.bench_run``'s
    twins at the reference's sizes, in its order, each with its
    ``phase_wall`` and under ``PlainForbidden``, its launches held to the
    ones it books (B8's 4 calls in ``bench_timing``; B5's 88 in
    ``bench_system``: 20 simulated drains, 4 sweeps of 16, 4 plane calls;
    the learning epochs' 3 and 2 launches and B9 a hidden tile; B3 and the
    scan a temporal call, ``tile_loads`` and ``request_stats`` in the
    stream lanes) and its assertions raising: Fig 8's headline and the
    plane's >= 10x floor over the scan oracle, the temporal plan at T 32,
    B 256 and thresholds 0-11 bit for bit the per-step loop with the >= 5x
    floor, the learning epoch bit for bit the column-scheme loop, the
    conversion exact; then the temporal twin's stream lanes (T 4-32, B
    256: logits, every tile's loads, the request stats) and encoder lanes
    (T 8, B 4096: logits) run again through the same plans on the CPU, the
    kernels' plain versions, and held equal bit for bit at the bench's own
    sizes; kernels and faults are phases 9 and 10;
    ``launch.online_learning`` (6 epochs, 2 launches each) against the
    same call on the CPU (``paper_learning``); the launcher twice in
    subprocesses with ``--esam --smoke --warmup --compile-cache`` on a
    fresh directory, the first building every library, the second none
    (``BUILD ... built=0``), both ``cache=on`` (``compile_cache``);
13. one JSON line of the kernels (21: the 13 Pallas kernels' ports, the
    column-event epoch's two kernels, the matrix-RNG epoch's three, the
    event round's scan, and the round telemetry's two), then the result
    line.

It needs a CUDA device and exits non-zero without one.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from contextlib import contextmanager, nullcontext
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the card's published rates (one place: the kernel bench's roofline reads
# them too) and the CUDA-event timers the kernel bench shares
from repro_torch.core.h100 import (  # noqa: E402
    F32_OPS_PER_S,
    HBM_BYTES_PER_S,
    INT8_OPS_PER_S,
    int32_ops_per_s,
    popc_ops_per_s,
)
from repro_torch.obs.profile import call_ms, graph_ms  # noqa: E402

PAPER_TOPOLOGY = (768, 256, 256, 256, 10)
SERVE_REQUESTS = 4096
BUCKET = 128                   # the engine's max_batch: one round's batch

#: the learning path: the port's twin of examples/online_learning.py
LEARN_TRAIN, LEARN_EVAL, LEARN_EPOCHS = 4096, 1024, 6
LEARN_P_POT, LEARN_P_DEP = 0.2, 0.1
#: samples of the matrix-RNG scan path's short run (its long run takes
#: LEARN_TRAIN); each run is one stdp_update_epoch, three launches
SCAN_SAMPLES = 64

#: the event path: round size (the launcher's max_batch), leak and the LIF
#: step's checked shapes (the event round's, a large one, ragged ones: N
#: and B N not multiples of 4)
EVENT_BATCH, EVENT_LEAK = 64, 0.125
LIF_SHAPES = ((EVENT_BATCH, 256), (4096, 256), (1, 1), (7, 100), (7, 99))
#: the event streams' lengths, and the paper topology's hidden widths
EVENT_STEPS = (4, 8, 16)
PAPER_HIDDEN = PAPER_TOPOLOGY[1:-1]

#: the kernel bench's comparison shape and cascade
#: (``launch.bench_kernels``), and the ragged shapes its kernels are checked
#: at besides (B 1 and 7, K 100 and 777, N 96 and 10)
BENCH_B, BENCH_K, BENCH_N = 1024, 768, 768
BENCH_CASCADE = (768, 768, 768, 10)
RAGGED_SHAPES = ((1, 100, 96), (7, 777, 10), (7, 100, 10), (1, 777, 96))

#: the cycle plane: digits of the measured Fig 8 sweep (the twin of
#: benchmarks/bench_system.py's measured sweep) and of the V_mem trace
SWEEP_DIGITS, TRACE_DIGITS = 4096, 256
#: cell options of the sweep and the port counts they simulate (0 and 1 share)
SWEEP_OPTIONS = tuple(range(5))
SWEEP_PORT_COUNTS = (1, 2, 3, 4)
ROW_GROUP = 128


def nvidia_smi(query: str, units: bool = True) -> str:
    fmt = "csv,noheader" if units else "csv,noheader,nounits"
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Card:
    """The card's rates the bounds are computed from."""

    def __init__(self):
        import torch

        props = torch.cuda.get_device_properties(0)
        self.sms = props.multi_processor_count
        self.max_sm_mhz = float(nvidia_smi("clocks.max.sm", units=False))
        self.popc_per_s = popc_ops_per_s(self.sms, self.max_sm_mhz)
        self.int32_per_s = int32_ops_per_s(self.sms, self.max_sm_mhz)
        #: the b1 tensor-core product's AND+popc operations a second (two
        #: a bit pair), set by ``probe_rates`` from this run's reading
        self.b1_ops_per_s = None

    def bound(self, n_bytes: float, n_ops: float,
              ops_per_s: float | None = None) -> tuple[float, str]:
        """(ms, what bounds it): the larger of bytes over the memory rate
        and operations over their rate (popc by default)."""
        t_bytes = n_bytes / HBM_BYTES_PER_S
        t_ops = n_ops / (ops_per_s or self.popc_per_s)
        return (max(t_bytes, t_ops) * 1e3,
                "bytes" if t_bytes >= t_ops else "operations")


#: the rate probe (``probes/rate_probe.cu``): its index, name, and the
#: AND+popc products one instruction computes (a warp's mma, a thread's popc)
RATE_PROBES = ((0, "mma_b1_m16n8k256_and_popc", 16 * 8 * 256),
               (1, "mma_s8_m16n8k32", 16 * 8 * 32),
               (2, "popc_b32", 32))
PROBE_ITERS = 4096
PROBE_SOURCE = ROOT / "probes" / "rate_probe.cu"
#: the launch floor's probe: an empty kernel and a one-load kernel
FLOOR_SOURCE = ROOT / "probes" / "launch_floor.cu"


def start_probe_build(source=PROBE_SOURCE):
    """Start nvcc on a probe under ``probes/``, which is no part of the
    port's kernel libraries; returns (process, library path, source) for
    ``probe_library``."""
    from repro_torch.kernels import _build

    out = _build.build_dir() / f"lib{source.stem}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.SHARED_INCLUDE}",
         "-o", str(out),
         str(source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, out, source


def probe_library(build):
    """Wait for a probe's nvcc; its library, loaded (raises if it failed)."""
    import ctypes

    proc, path, source = build
    text, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name}:\n{text}")
    return ctypes.CDLL(str(path))


def launch_floor(build) -> dict:
    """What one launch costs on this card, whatever the kernel
    (``probes/launch_floor.cu``): an empty kernel and one that loads one
    word and stores it, each timed in a CUDA graph (``graph_ms``, as every
    kernel here is) and from Python (``call_ms``).  Printed as a
    ``launch_floor`` line."""
    import ctypes

    import torch

    from repro_torch.kernels.common import stream_ptr

    lib = probe_library(build)
    vp = ctypes.c_void_p
    lib.launch_floor.argtypes = [ctypes.c_int, vp, vp, vp]
    lib.launch_floor.restype = ctypes.c_int
    dev = torch.device("cuda", torch.cuda.current_device())
    x = torch.full((1,), 41, dtype=torch.int32, device=dev)
    y = torch.zeros_like(x)

    def run(which):
        err = lib.launch_floor(which, x.data_ptr(), y.data_ptr(),
                               stream_ptr(dev))
        if err:
            raise RuntimeError(f"launch_floor {which} failed: {err}")

    run(1)
    if int(y) != 42:
        raise AssertionError(f"launch_floor's load kernel stored {int(y)}")
    out = {"empty_ms": graph_ms(lambda: run(0)),
           "one_load_ms": graph_ms(lambda: run(1)),
           "empty_call_ms": call_ms(lambda: run(0)),
           "one_load_call_ms": call_ms(lambda: run(1))}
    print("launch_floor " + json.dumps(out), flush=True)
    return out


def probe_rates(card, build) -> dict:
    """The rate probe on one SM and on every SM: instructions and AND+popc
    products per clock per SM of the b1 and int8 tensor-core products and
    of the 32-bit popc, and the SM clock (the kernel's own clock64 cycles
    over its CUDA-event time).  Printed as a ``rate_probe`` line.  Sets
    ``card.b1_ops_per_s`` from the b1 product's higher reading at the
    card's maximum SM clock: a measured rate is a floor on the peak."""
    import ctypes

    import torch

    from repro_torch.kernels.common import stream_ptr

    lib = probe_library(build)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.cim_popcount_rate_probe.argtypes = [i32, i32, i32, vp, vp, vp]
    lib.cim_popcount_rate_probe.restype = i32
    threads = lib.cim_popcount_probe_threads()
    chains = lib.cim_popcount_probe_chains()
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {}
    for which, name, per_instr in RATE_PROBES:
        for label, blocks in (("one_sm", 1), ("all_sms", card.sms)):
            sink = torch.empty(blocks * threads, dtype=torch.int32,
                               device=dev)
            cycles = torch.empty(blocks, dtype=torch.int64, device=dev)

            def launch():
                err = lib.cim_popcount_rate_probe(
                    which, blocks, PROBE_ITERS, sink.data_ptr(),
                    cycles.data_ptr(), stream_ptr(dev))
                if err:
                    raise RuntimeError(f"rate probe {name} failed: {err}")

            launch()   # warm-up
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            launch()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
            cyc = int(cycles.max())
            per_thread = chains * PROBE_ITERS
            instrs = blocks * per_thread * (threads if which == 2
                                            else threads // 32)
            out[f"{name}/{label}"] = {
                "ms": ms, "sm_mhz": cyc / (ms * 1e3),
                "instr_per_clk_sm": instrs / cyc / blocks,
                "products_per_clk_sm": instrs * per_instr / cyc / blocks,
                "products_per_s": instrs * per_instr / (ms * 1e-3)}
    b1 = max(out[f"{RATE_PROBES[0][1]}/{label}"]["products_per_clk_sm"]
             for label in ("one_sm", "all_sms"))
    card.b1_ops_per_s = 2 * b1 * card.sms * card.max_sm_mhz * 1e6
    out["b1_bound_ops_per_s"] = card.b1_ops_per_s
    print("rate_probe " + json.dumps(out), flush=True)
    return out


#: the kernels on the b1 tensor-core product, by library: each
#: instantiation's SASS must hold BMMA, but the cascade's popc-MAC one
#: (``mega_cascade_kernel<false>``), reported beside them
B1_KERNELS = {"cim_popcount": ("popcount_fire_kernel", "mega_cascade_kernel"),
              "cim_matmul_packed": ("fused_fire_packed_kernel",),
              "cim_matmul": ("cim_matmul_kernel",)}
POPC_CASCADE = "mega_cascade_kernelILb0E"


def tile_sass(reports) -> dict:
    """Tensor-core instructions in the SASS of each instantiation of the
    kernels that run their MAC on the b1 product (``B1_KERNELS``: B2/B3's
    ``popcount_fire_kernel``, B1's ``mega_cascade_kernel``, B9/B9''s
    ``fused_fire_packed_kernel``, B10's ``cim_matmul_kernel`` in every
    spike width and span), from ``cuobjdump -sass`` of the built
    libraries; raises unless each holds the b1 product (BMMA), the
    cascade's popc instantiation excepted."""
    import re

    from repro_torch.kernels import _build

    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    found = {}
    for rep in reports:
        if rep.name not in B1_KERNELS:
            continue
        sass = subprocess.run([str(cuobjdump), "-sass", str(rep.path)],
                              capture_output=True, text=True, check=True,
                              timeout=120).stdout
        for section in sass.split("Function : ")[1:]:
            name = section.split(maxsplit=1)[0]
            if any(k in name for k in B1_KERNELS[rep.name]):
                ops = re.findall(r"\b((?:BMMA|IMMA|HMMA)[.A-Z0-9_]*)",
                                 section)
                found[name] = {op: ops.count(op) for op in sorted(set(ops))}
    missing = [k for ks in B1_KERNELS.values() for k in ks
               if not any(k in name for name in found)]
    if missing or not all(any(op.startswith("BMMA") for op in v)
                          for name, v in found.items()
                          if POPC_CASCADE not in name):
        raise AssertionError(f"b1 kernels' SASS without BMMA: {found}, "
                             f"not found: {missing}")
    print("sass " + json.dumps(found), flush=True)
    return found


def random_words(rng, batch: int, n: int, tail: bool = False):
    """int32 wire words of random spikes at p=0.5 (bit 31 set in about half
    of the full words); the bits past ``n`` in the last word are zero, or
    all set with ``tail`` (which every consumer must drop)."""
    from repro_torch.core import packing

    words = packing.pack_spikes_np(rng.integers(0, 2, size=(batch, n)))
    if tail and n % 32:
        words[:, -1] |= np.uint32(~((1 << (n % 32)) - 1) & 0xFFFFFFFF)
    return packing.words_from_np(words)


#: B1's device time in a CUDA graph before its redesign (PR 20's run, NVIDIA
#: H100 80GB HBM3, 700 W), printed beside the new time
MEGA_BEFORE_MS = {("768:256:256:256:10", 128): 0.0110,
                  ("768:768:768:10", 1024): 0.0442}


def check_mega(card, rng, topology, batch, kernels, **route):
    """mega_cascade vs the plain cascade on the card at one shape, bit for
    bit, timed against its bound.  ``route`` holds what the launcher's
    geometry must be there: ``cluster`` (CTAs a cluster), ``fixed`` (per
    tile, the MAC's word count fixed at compile time), ``partial`` (the
    last slice of rows partly empty), ``persistent`` (fewer clusters than
    slices)."""
    import torch

    from repro_torch.core import packing
    from repro_torch.kernels.cim_popcount import ops

    planes = tuple(
        packing.pack_weight_planes(torch.from_numpy(
            rng.integers(0, 2, size=(k, n), dtype=np.int8)).cuda())
        for k, n in zip(topology[:-1], topology[1:]))
    vth = tuple(torch.from_numpy(rng.integers(-8, 9, size=(n,),
                                              dtype=np.int32)).cuda()
                for n in topology[1:])
    w_stack, vth_stack = ops.stack_cascade_operands(planes, vth, topology)
    tiles = ops.cascade_tiles(w_stack, vth_stack, topology)
    x = random_words(rng, batch, topology[0]).cuda()

    def run():
        return ops.esam_cascade_popcount(x, w_stack, vth_stack,
                                         topology=topology, tiles=tiles)

    logits, fired = run()
    ref_logits, ref_fired = ops.esam_cascade_popcount_ref(x, planes, vth)
    torch.cuda.synchronize()
    err = int((logits.long() - ref_logits.long()).abs().max()) if batch else 0
    fired_equal = all(torch.equal(a, b) for a, b in zip(fired, ref_fired))
    if err or not fired_equal or not torch.equal(logits, ref_logits):
        raise AssertionError(
            f"mega_cascade != plain at {topology} B={batch}: logits "
            f"max_abs_err={err}, fired planes equal={fired_equal}")
    took = ops._cascade_route(tuple(topology), batch,
                              torch.cuda.current_device())
    got = {"cluster": took.cluster, "fixed": took.fixed_words,
           "partial": took.slices * took.rows > batch,
           "persistent": took.clusters < took.slices, "mac": took.mac}
    if any(got[k] != v for k, v in route.items()):
        raise AssertionError(f"mega_cascade at {topology} B={batch}: route "
                             f"{took}, want {route}")
    g = ops.cascade_geometry(topology)
    hidden = topology[1:-1]
    n_bytes = 4 * (batch * g["w_words"][0]
                   + sum(n * w for n, w in zip(topology[1:], g["w_words"]))
                   + sum(hidden)
                   + batch * topology[-1] + batch * sum(h // 32 for h in hidden))
    n_popc = batch * (sum(n * w for n, w in zip(topology[1:], g["w_words"]))
                      + g["w_words"][0] + sum(h // 32 for h in hidden))
    n_ops = 2 * batch * sum(k * n for k, n in zip(topology, topology[1:]))
    shape = ":".join(map(str, topology))
    row = {
        "kernel": "mega_cascade", "topology": shape, "batch": batch,
        "route": took._asdict(), "max_abs_err": err,
        "fired_equal": fired_equal, "ms": graph_ms(run),
        "call_ms": call_ms(run),
        "before_ms": MEGA_BEFORE_MS.get((shape, batch)),
        # the plain version is three launches a word: wide rows capture
        # two calls a graph
        "plain_ms": graph_ms(lambda: ops.esam_cascade_popcount_ref(
            x, planes, vth), **({"calls": 2, "replays": 3}
                                if sum(g["w_words"]) > 64 else {})),
        **_b1_bounds(card, n_bytes, n_ops, n_popc), "library_ms": None,
    }
    print("kernel_check " + json.dumps(row), flush=True)
    kernels.append(row)


def mega_geometries(rng, topology, batch) -> None:
    """The cascade kernel under the launcher's geometry and three it does
    not pick, called through its C interface, each held bit for bit
    against the plain cascade (logits and every fired plane) and timed in a
    CUDA graph: the launcher's with the other MAC (the popc unit for the
    b1 product or back), clusters of 8 with the same rows a slice, and one
    CTA an SM walking the slices (clusters of 1)."""
    import torch

    from repro_torch.core import packing
    from repro_torch.kernels.cim_popcount import ops
    from repro_torch.kernels.common import stream_ptr

    planes = tuple(
        packing.pack_weight_planes(torch.from_numpy(
            rng.integers(0, 2, size=(k, n), dtype=np.int8)).cuda())
        for k, n in zip(topology[:-1], topology[1:]))
    vth = tuple(torch.from_numpy(rng.integers(-8, 9, size=(n,),
                                              dtype=np.int32)).cuda()
                for n in topology[1:])
    tiles = ops.cascade_tiles(*ops.stack_cascade_operands(planes, vth,
                                                          topology), topology)
    x = random_words(rng, batch, topology[0]).cuda()
    want_logits, want_fired = ops.esam_cascade_popcount_ref(x, planes, vth)
    want = torch.cat([want_logits.reshape(-1)]
                     + [f.reshape(-1) for f in want_fired])
    dev = torch.device("cuda", torch.cuda.current_device())
    lib = ops._library().lib
    n_out, w_words = ops._cascade_arrays(tuple(topology))
    logits = torch.empty_like(want_logits)
    fired = torch.empty(sum(f.numel() for f in want_fired),
                        dtype=torch.int32, device=dev)
    route = ops._cascade_route(tuple(topology), batch, dev.index)
    other = "popc" if route.mac == "b1" else "b1"
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    row = {"topology": ":".join(map(str, topology)), "batch": batch}
    for name, cluster, rows, clusters, mac in (
            ("launcher", route.cluster, route.rows, route.clusters,
             route.mac),
            (f"mac_{other}", route.cluster, route.rows, route.clusters,
             other),
            ("cluster_8", 8, route.rows, None, route.mac),
            ("cta_per_sm", 1, route.rows, sms, route.mac)):
        slices = -(-batch // rows)
        fits = lib.cim_mega_cascade_max_clusters(
            len(topology) - 1, n_out, w_words, cluster, rows,
            ops._MAC_CODE[mac])
        clusters = min(slices, fits, clusters or slices)

        def run():
            err = lib.cim_mega_cascade(
                x.data_ptr(), batch, tiles.data_ptr(), tiles.numel(),
                logits.data_ptr(), fired.data_ptr(), len(topology) - 1,
                n_out, w_words, cluster, rows, clusters, ops._MAC_CODE[mac],
                stream_ptr(dev))
            if err:
                raise RuntimeError(f"mega_cascade launch failed: {err}")

        logits.fill_(-1)
        fired.fill_(-1)
        run()
        torch.cuda.synchronize()
        if not torch.equal(torch.cat([logits.reshape(-1), fired]), want):
            raise AssertionError(f"mega_cascade {name} geometry != plain at "
                                 f"{topology} B={batch}")
        row[name] = {"cluster": cluster, "rows": rows, "clusters": clusters,
                     "mac": mac, "ms": graph_ms(run)}
    print("mega_geometry " + json.dumps(row), flush=True)


#: B2's and B3's device time in a CUDA graph before their redesign (the
#: CUDA-core MAC on staged planes, timed by its own commit's check_mac /
#: check_fire on NVIDIA H100 80GB HBM3, 700 W; PERF.md), printed
#: beside the tensor-core kernel's on random, contiguous operands; keyed
#: (kernel, shape, pack_output)
POP_BEFORE_MS = {
    ("popcount_mac", "128x768->10", None): 0.003414,
    ("popcount_mac", "37x100->77", None): 0.003093,
    ("popcount_mac", "256x768->256", None): 0.006328,
    ("popcount_mac", "512x768->256", None): 0.007354,
    ("popcount_mac", "1024x768->256", None): 0.009843,
    ("popcount_mac", "64x256->256", None): 0.003416,
    ("popcount_mac", "64x256->10", None): 0.003219,
    ("popcount_mac", "1024x768->768", None): 0.015410,
    ("popcount_mac", "1x100->10", None): 0.002840,
    ("popcount_mac", "7x777->77", None): 0.004227,
    ("popcount_mac", "37x40000->96", None): 0.045997,
    ("popcount_mac", "1x777->96", None): 0.004360,
    ("popcount_mac", "7x100->77", None): 0.003075,
    ("popcount_mac", "37x40000->10", None): 0.043963,
    ("popcount_fire", "4096x768->256", True): 0.027627,
    ("popcount_fire", "4096x256->256", True): 0.017584,
    ("popcount_fire", "1000x777->256", True): 0.011723,
    ("popcount_fire", "37x100->96", False): 0.003050,
    ("popcount_fire", "1024x768->768", True): 0.016354,
    ("popcount_fire", "1x100->10", False): 0.003078,
    ("popcount_fire", "7x777->77", False): 0.004622,
    ("popcount_fire", "37x40000->96", True): 0.046251,
    ("popcount_fire", "1x777->96", True): 0.004419,
    ("popcount_fire", "7x100->77", False): 0.003165,
    ("popcount_fire", "37x40000->10", False): 0.044373,
    ("popcount_fire", "37x40000->96", False): 0.045982,
}

#: the ragged tile shapes B2 and B3 are checked at besides the paths':
#: B 1, 7, 37; N 10, 77, 96; K 100, 777, 40000 (W 4, 25, 1250)
POP_RAGGED = ((1, 100, 10), (7, 777, 77), (37, 40000, 96), (1, 777, 96),
              (7, 100, 77), (37, 40000, 10))


def _tile_operands(rng, batch, n_in, n_out, fill, stride_pad):
    """Weight bits [n_in, n_out] and their planes, spike words [batch, W]
    (rows ``stride_pad`` words apart beyond W: a strided view), by ``fill``:
    random, or all-zero / all-one spikes and planes."""
    import torch

    from repro_torch.core import packing

    if fill == "random":
        bits = rng.integers(0, 2, size=(n_in, n_out), dtype=np.int8)
        spikes = rng.integers(0, 2, size=(batch, n_in + 32 * stride_pad))
    else:
        value = 1 if fill == "ones" else 0
        bits = np.full((n_in, n_out), value, np.int8)
        spikes = np.full((batch, n_in + 32 * stride_pad), value)
    # zero tail bits in the last real word (the wire format); the words a
    # strided row skips are all ones, so reading one would show
    words = packing.packed_width(n_in)
    spikes[:, n_in: 32 * words] = 0
    spikes[:, 32 * words:] = 1
    bits = torch.from_numpy(bits).cuda()
    planes = packing.pack_weight_planes(bits)
    x = packing.words_from_np(packing.pack_spikes_np(spikes)).cuda()
    return bits, planes, x[:, :words]


def _tile_route(x, planes, route):
    """The route B2/B3 took for these operands, checked against what the
    caller expects of it (``route``: FireRoute fields) and against the
    shape: the grid covers B rows and N neurons, with less than one block
    past each."""
    from repro_torch.kernels.cim_popcount import ops

    took = ops._route_for(x, planes)
    B, N = x.shape[0], planes.shape[0]
    rows = ops._FIRE_WARPS * ops._FIRE_TILE_ROWS
    if (not 0 <= took.grid[0] * rows - B < rows
            or not 0 <= took.grid[1] * ops._FIRE_TILE_NEURONS - N
            < ops._FIRE_TILE_NEURONS
            or any(getattr(took, k) != v for k, v in route.items())):
        raise AssertionError(f"B2/B3 route {took} at B={B} N={N}, "
                             f"want {route}")
    return took._asdict()


def _b1_bounds(card, n_bytes, n_ops, n_popc) -> dict:
    """The bounds of a kernel whose MAC runs on the b1 product, each against
    its bytes: the b1 product's, the datapath it runs (``n_ops`` AND+popc
    operations, two a bit pair, at this run's probed b1 rate,
    ``probe_rates``), and beside it the int8 product's (the same
    operations at the int8 data-sheet rate) and the popc unit's (``n_popc``
    AND+popc word pairs and spike-word popcs), so that earlier rows stay
    comparable."""
    if card.b1_ops_per_s is None:
        raise RuntimeError("b1 bounds need the b1 rate: run probe_rates")
    b1_ms, b1_by = card.bound(n_bytes, n_ops, card.b1_ops_per_s)
    int8_ms, int8_by = card.bound(n_bytes, n_ops, INT8_OPS_PER_S)
    popc_ms, popc_by = card.bound(n_bytes, n_popc)
    return {"bound_ms": b1_ms, "bound_by": b1_by,
            "int8_bound_ms": int8_ms, "int8_bound_by": int8_by,
            "popc_bound_ms": popc_ms, "popc_bound_by": popc_by}


def _tile_bounds(card, batch, n_in, n_out, n_bytes) -> dict:
    """One tile's bounds (B2, B3, B9, B9'): 2 B N K operations, B N W + B W
    popcs (``_b1_bounds``)."""
    from repro_torch.core import packing

    words = packing.packed_width(n_in)
    return _b1_bounds(card, n_bytes, 2 * batch * n_out * n_in,
                      batch * n_out * words + batch * words)


def _plain_ms(fn, n_in) -> float:
    """The plain version's device time (three launches a word: wide inputs
    capture two calls a graph)."""
    return graph_ms(fn, **({"calls": 2, "replays": 3} if n_in > 2048
                           else {}))


def check_mac(card, rng, batch, n_in, n_out, kernels, *, fill="random",
              stride_pad=0, **route):
    """popcount_mac vs the plain MAC on the card at one shape, bit for bit,
    with the route it took (``route``: what it must be); the library
    yardstick is torch.matmul on the unpacked ±1 float32 operands."""
    import torch

    from repro_torch.core import packing
    from repro_torch.kernels.cim_popcount import ops

    bits, planes, x = _tile_operands(rng, batch, n_in, n_out, fill,
                                     stride_pad)
    ops.reset_launch_counts()
    out = ops.cim_popcount_matmul(x, planes)
    if ops.launch_counts()["popcount_mac"] != 1:
        raise AssertionError(f"popcount_mac launches {ops.launch_counts()}")
    ref = ops.cim_popcount_ref(x, planes)
    s = packing.unpack_spikes(x, n_in, torch.float32)
    w = 2.0 * bits.to(torch.float32) - 1.0
    with tf32_off():
        lib = torch.matmul(s, w)
    torch.cuda.synchronize()
    err = _word_err(out, ref)
    if err or not torch.equal(out, ref) or not torch.equal(
            out, lib.to(torch.int32)):
        raise AssertionError(
            f"popcount_mac != plain at B={batch} {n_in}->{n_out} {fill} "
            f"stride_pad={stride_pad}: max_abs_err={err}")
    words = packing.packed_width(n_in)
    n_bytes = 4 * (batch * words + n_out * words + batch * n_out)
    shape = f"{batch}x{n_in}->{n_out}"
    row = {
        "kernel": "popcount_mac", "shape": shape, "batch": batch,
        "fill": fill, "stride_pad": stride_pad,
        "route": _tile_route(x, planes, route), "max_abs_err": err,
        "ms": graph_ms(lambda: ops.cim_popcount_matmul(x, planes)),
        "call_ms": call_ms(lambda: ops.cim_popcount_matmul(x, planes)),
        "before_ms": POP_BEFORE_MS.get(("popcount_mac", shape, None))
        if (fill, stride_pad) == ("random", 0) else None,
        "plain_ms": _plain_ms(lambda: ops.cim_popcount_ref(x, planes), n_in),
        **_tile_bounds(card, batch, n_in, n_out, n_bytes),
        "library_ms": _matmul_yardstick(x, bits, n_in),
    }
    print("kernel_check " + json.dumps(row), flush=True)
    kernels.append(row)


@contextmanager
def tf32_off():
    """TF32 off for the float32 products inside, the caller's setting
    restored after them (cuBLAS picks its kernel when a graph is captured,
    so a captured product keeps the exact float32 path on replay)."""
    import torch

    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow_tf32


def _matmul_yardstick(x, bits, n_in):
    """torch.matmul on the unpacked ±1 float32 operands, TF32 off: the
    library call that computes the tile's V_mem."""
    import torch

    from repro_torch.core import packing

    s = packing.unpack_spikes(x, n_in, torch.float32)
    w = 2.0 * bits.to(torch.float32) - 1.0
    with tf32_off():
        return graph_ms(lambda: torch.matmul(s, w))


def _word_err(out, ref) -> int:
    """Largest absolute difference of two integer outputs (words as int)."""
    return int((out.long() - ref.long()).abs().max()) if out.numel() else 0


def check_fire(card, rng, batch, n_in, n_out, kernels, pack_output=True, *,
               fill="random", stride_pad=0, vth_fill="random", **route):
    """popcount_fire (one tile's MAC, fire, re-pack) vs its plain version,
    bit for bit, with the route it took; ``vth_fill`` "min" / "max" puts
    every threshold at -2^31 / 2^31 - 1."""
    import torch

    from repro_torch.core import packing
    from repro_torch.kernels.cim_popcount import ops

    bits, planes, x = _tile_operands(rng, batch, n_in, n_out, fill,
                                     stride_pad)
    if vth_fill == "random":
        vth = rng.integers(-8, 9, size=(n_out,), dtype=np.int32)
    else:
        info = np.iinfo(np.int32)
        vth = np.full((n_out,), info.min if vth_fill == "min" else info.max,
                      np.int32)
    vth = torch.from_numpy(vth).cuda()

    def run():
        return ops.esam_layer_popcount(x, planes, vth, pack_output=pack_output)

    ops.reset_launch_counts()
    out = run()
    if ops.launch_counts()["popcount_fire"] != 1:
        raise AssertionError(f"popcount_fire launches {ops.launch_counts()}")
    ref = ops.esam_layer_popcount_ref(x, planes, vth, pack_output=pack_output)
    torch.cuda.synchronize()
    err = _word_err(out, ref)
    if err or not torch.equal(out, ref):
        raise AssertionError(f"popcount_fire != plain at B={batch} "
                             f"{n_in}->{n_out} pack={pack_output} {fill} "
                             f"stride_pad={stride_pad} vth={vth_fill}: "
                             f"err={err}")
    words = packing.packed_width(n_in)
    out_bytes = batch * (n_out // 8 if pack_output else n_out)
    n_bytes = 4 * (batch * words + n_out * words + n_out) + out_bytes
    shape = f"{batch}x{n_in}->{n_out}"
    row = {
        "kernel": "popcount_fire", "shape": shape,
        "pack_output": pack_output, "batch": batch, "fill": fill,
        "stride_pad": stride_pad, "vth_fill": vth_fill,
        "route": _tile_route(x, planes, route), "max_abs_err": err,
        "ms": graph_ms(run), "call_ms": call_ms(run),
        "before_ms": POP_BEFORE_MS.get(("popcount_fire", shape, pack_output))
        if (fill, stride_pad, vth_fill) == ("random", 0, "random") else None,
        "plain_ms": _plain_ms(lambda: ops.esam_layer_popcount_ref(
            x, planes, vth, pack_output=pack_output), n_in),
        **_tile_bounds(card, batch, n_in, n_out, n_bytes),
        "library_ms": _matmul_yardstick(x, bits, n_in),
    }
    print("kernel_check " + json.dumps(row), flush=True)
    kernels.append(row)


#: B9's and B9''s device time in a CUDA graph before their move onto the
#: b1 product (the CUDA-core kernel of PR 14 / 17, timed by PR 20's run 2 on
#: NVIDIA H100 80GB HBM3, 700 W; PERF.md), printed beside the new time
PACKED_BEFORE_MS = {("fused_fire_packed", "4096x768->256"): 0.0333,
                    ("cim_matmul_packed", "1024x768->768"): 0.0244}


def _packed_row(ops, x, n_out) -> dict:
    """The route B9/B9' took for these spike words, checked against the
    shape: the spans cover B, the groups N."""
    took = ops._route_for(x, n_out)
    B = x.shape[0]
    spans, groups = took.grid
    if (not spans * took.span_rows >= B > (spans - 1) * took.span_rows
            or not 0 <= groups * 64 - n_out < 64):
        raise AssertionError(f"B9 route {took} at B={B} N={n_out}")
    return took._asdict()


def check_packed_fire(card, rng, batch, n_in, n_out, kernels,
                      pack_output=True, tail=False, view=None):
    """fused_fire_packed (spike words x {0,1} int8 weights, fire, re-pack)
    vs its plain version; ``tail`` sets every spike bit past n_in, which
    both must drop; ``view`` (width, first) takes the weights as columns
    first.. of a wider matrix (rows 16-byte aligned or not)."""
    import torch

    from repro_torch.core import packing
    from repro_torch.kernels.cim_matmul_packed import ops

    width, first = view or (n_out, 0)
    bits = torch.from_numpy(
        rng.integers(0, 2, size=(n_in, width), dtype=np.int8)).cuda()
    bits = bits[:, first:first + n_out]
    vth = torch.from_numpy(
        rng.integers(-8, 9, size=(n_out,), dtype=np.int32)).cuda()
    x = random_words(rng, batch, n_in, tail).cuda()

    def run():
        return ops.esam_layer_packed(x, bits, vth, pack_output=pack_output)

    ops.reset_launch_counts()
    out = run()
    if ops.launch_counts()["fused_fire_packed"] != 1:
        raise AssertionError(f"fused_fire_packed launches "
                             f"{ops.launch_counts()}")
    ref = ops.esam_layer_packed_ref(x, bits, vth, pack_output=pack_output)
    torch.cuda.synchronize()
    err = _word_err(out, ref)
    if err or not torch.equal(out, ref):
        raise AssertionError(f"fused_fire_packed != plain at B={batch} "
                             f"{n_in}->{n_out} pack={pack_output} "
                             f"tail={tail} view={view}: err={err}")
    words = packing.packed_width(n_in)
    out_bytes = batch * (n_out // 8 if pack_output else n_out)
    # the int8 weights, not planes: the kernel builds those
    n_bytes = 4 * batch * words + n_in * n_out + 4 * n_out + out_bytes
    shape = f"{batch}x{n_in}->{n_out}"
    row = {
        "kernel": "fused_fire_packed", "shape": shape,
        "pack_output": pack_output, "batch": batch, "tail": tail,
        "view": view, "route": _packed_row(ops, x, n_out),
        "max_abs_err": err, "ms": graph_ms(run), "call_ms": call_ms(run),
        "before_ms": None if tail or view else PACKED_BEFORE_MS.get(
            ("fused_fire_packed", shape)),
        "plain_ms": graph_ms(lambda: ops.esam_layer_packed_ref(
            x, bits, vth, pack_output=pack_output)),
        **_tile_bounds(card, batch, n_in, n_out, n_bytes),
        "library_ms": _matmul_yardstick(x, bits, n_in),
    }
    print("kernel_check " + json.dumps(row), flush=True)
    kernels.append(row)


def _stdp_operands(rng, n_out, n_in, u_shape):
    import torch

    bits_t = torch.from_numpy(
        rng.integers(0, 2, size=(n_out, n_in), dtype=np.int8)).cuda()
    pre = torch.from_numpy(rng.random(n_in) < 0.4).cuda()
    u_pot = torch.from_numpy(rng.random(u_shape, dtype=np.float32)).cuda()
    u_dep = torch.from_numpy(rng.random(u_shape, dtype=np.float32)).cuda()
    return bits_t, pre, u_pot, u_dep


def check_column_event(card, rng, n_out, n_in, kernels, *, pad=0,
                       shift=False):
    """stdp_column_event (one row, in place, index and gate on the device)
    vs its plain version: the teacher event and the wrong-winner event
    (p_pot 0, inverted trace), gated on and off, at a row inside and at the
    rows n_out, -1 and -n_out-1 (wrapped once if negative, then clamped),
    int64 and int32 indices, with the route it took (4-input loads or
    byte and float loads).  ``pad``: the matrix is a
    view of rows ``pad`` bytes longer (row stride past n_in), whose bytes
    past n_in must not change; ``shift``: trace and uniforms are views one
    element past an aligned start (byte and float loads).  With the gate
    off no byte of the storage may change."""
    import torch

    from repro_torch.kernels.stdp import ops

    bits_t, pre, u_pot, u_dep = _stdp_operands(rng, n_out, n_in, (n_in,))
    store = torch.full((n_out, n_in + pad), 7, dtype=torch.int8,
                       device="cuda")
    store[:, :n_in] = bits_t
    if shift:
        pre, u_pot, u_dep = (torch.cat([t[:1], t])[1:]
                             for t in (pre.to(torch.uint8), u_pot, u_dep))
    route = ops._event_route(n_out, n_in, ops._event_vec(
        store[:, :n_in], ops._byte_mask(pre), u_pot, u_dep))
    err = 0
    for c, dtype in [(c, d) for c in (n_out // 2, n_out, -1, -n_out - 1)
                     for d in (torch.int64, torch.int32)]:
        idx = torch.tensor(c, dtype=dtype, device="cuda")
        for apply in (True, False):
            gate = torch.tensor(apply, device="cuda")
            for trace, p_pot in ((pre, LEARN_P_POT), (pre == 0, 0.0)):
                work = store.clone()
                got = ops.stdp_column_event(
                    work[:, :n_in], idx, gate, trace, u_pot, u_dep,
                    p_pot=p_pot, p_dep=LEARN_P_DEP)
                want = ops.stdp_column_event_ref(
                    bits_t, idx, gate, trace, u_pot, u_dep, p_pot,
                    LEARN_P_DEP)
                err = max(err, _word_err(got, want))
                if (not torch.equal(got, want)
                        or not torch.equal(work[:, n_in:], store[:, n_in:])
                        or not (apply or torch.equal(work, store))):
                    raise AssertionError(
                        f"stdp_column_event != plain at [{n_out}, {n_in}] "
                        f"pad={pad} shift={shift} row={c} {dtype} "
                        f"apply={apply} p_pot={p_pot} route={route}")
    col = torch.tensor(n_out // 2, device="cuda")
    gate = torch.tensor(True, device="cuda")
    work = store.clone()[:, :n_in]

    def run():
        return ops.stdp_column_event(work, col, gate, pre, u_pot, u_dep,
                                     p_pot=LEARN_P_POT, p_dep=LEARN_P_DEP)

    # one row read and written, the trace, two uniforms, index and gate
    n_bytes = n_in * (1 + 1 + 4 + 4 + 1) + 8 + 1
    bound_ms, bound_by = card.bound(n_bytes, 4 * n_in, F32_OPS_PER_S)
    row = {
        "kernel": "stdp_column_event", "shape": f"{n_out}x{n_in}",
        "pad": pad, "shift": shift, "vec": route.vec, "grid": route.grid,
        "max_abs_err": err, "ms": graph_ms(run), "call_ms": call_ms(run),
        "plain_ms": graph_ms(lambda: ops.stdp_column_event_ref(
            bits_t, col, gate, pre, u_pot, u_dep, LEARN_P_POT, LEARN_P_DEP)),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }
    print("kernel_check " + json.dumps(row), flush=True)
    kernels.append(row)


#: int32 operations of one column-event draw in the epoch's masks kernel:
#: threefry2x32's 2 key adds, 20 rounds of add / rotate / xor, 5 key
#: injections of 2 adds (the round constant folded into a three-input add),
#: the output xor; then the shift and the compare with the threshold
DRAW_INT32_OPS = 2 + 20 * 3 + 5 * 2 + 1 + 2
#: B6 epoch's device time in a CUDA graph before its redesign (PR 20's run,
#: NVIDIA H100 80GB HBM3, 700 W), printed beside the new time
EPOCH_BEFORE_MS = {(10, 256, LEARN_TRAIN): 2.792}


def check_column_epoch(card, rng, n_out, n_in, n, masks_rows, chain_rows, *,
                       route, tied=False, offset=False, special=False,
                       key_words=None):
    """The epoch's two kernels against their plain versions on the card:
    ``stdp_epoch_masks`` slot for slot against ``stdp_epoch_masks_ref`` and
    the whole ``stdp_column_epoch`` (bits and wrong count) against
    ``stdp_column_epoch_ref`` on the same draws, under ``PRNGKey(n)`` or
    the key of ``key_words``; sample 3's label is -1 (out of range: always
    wrong, its teacher row wrapped).  ``tied``: every readout row the same,
    so every V_mem ties; ``special``: offsets of +inf, -inf and NaN.  Rows:
    the masks kernel, and the chain kernel with the pair (``epoch_ms``),
    the clock64 count of a chain step and the route asserted against
    ``ops._epoch_route``."""
    import torch

    from repro_torch.core import prng
    from repro_torch.kernels.stdp import ops

    bits_t = rng.integers(0, 2, size=(n_out, n_in), dtype=np.int8)
    if tied:
        bits_t[:] = bits_t[:1]
    bits_t = torch.from_numpy(bits_t).cuda()
    pre = torch.from_numpy(rng.random((n, n_in)) < 0.45).cuda()
    labels = torch.from_numpy(rng.integers(0, n_out, size=(n,))).cuda()
    labels[3] = -1
    off = (torch.from_numpy(rng.normal(size=n_out).astype(np.float32)).cuda()
           if offset else None)
    if special:
        off[1], off[4], off[7] = float("inf"), float("-inf"), float("nan")
    key = (prng.PRNGKey(n) if key_words is None else
           torch.tensor(np.array(key_words, dtype=np.int64))).cuda()
    p = dict(p_pot=LEARN_P_POT, p_dep=LEARN_P_DEP)
    slots = ops.stdp_epoch_masks(pre, labels, key, n_out, **p)
    want_slots = ops.stdp_epoch_masks_ref(pre, labels, key, n_out,
                                          LEARN_P_POT, LEARN_P_DEP)
    if not torch.equal(slots, want_slots):
        raise AssertionError(f"stdp_epoch_masks != plain at {n}x{n_in} "
                             f"key={key.tolist()}")
    u = ops.column_event_uniforms(key, torch.arange(n, device="cuda"), n_in)
    got = bits_t.clone()
    wrong = ops.stdp_column_epoch(got, pre, labels, key, off, **p)
    want, want_wrong = ops.stdp_column_epoch_ref(
        bits_t, pre, labels, *u, off, LEARN_P_POT, LEARN_P_DEP)
    err = _word_err(got, want)
    if not torch.equal(got, want) or int(wrong) != int(want_wrong):
        raise AssertionError(
            f"stdp_column_epoch != plain at [{n_out}, {n_in}] x {n} "
            f"tied={tied} offset={offset}: {int(wrong)} vs "
            f"{int(want_wrong)} wrong")
    n_wrong = int(want_wrong)
    shape = f"{n}x{n_in}->{n_out}"
    if ops._epoch_route(n_out, n_in) != route:
        raise AssertionError(f"epoch route {ops._epoch_route(n_out, n_in)} "
                             f"at [{n_out}, {n_in}], want {route}")

    # the masks kernel: traces, labels and the key read, the slots written;
    # every sample's draws (4 key derivations, one draw an input and one
    # more where the trace is 1) at the int32 rate
    draws = 4 * n + n * n_in + int(pre.sum())
    m_bytes = (n * n_in + n * labels.element_size() + 16
               + slots.numel() * 4)
    m_bound, m_by = card.bound(m_bytes, draws * DRAW_INT32_OPS,
                               card.int32_per_s)
    m_row = {
        "kernel": "stdp_epoch_masks", "shape": shape, "max_abs_err":
        int((slots != want_slots).sum()),
        "ms": graph_ms(lambda: ops.stdp_epoch_masks(pre, labels, key, n_out,
                                                    **p)),
        "call_ms": call_ms(lambda: ops.stdp_epoch_masks(pre, labels, key,
                                                        n_out, **p)),
        "plain_ms": graph_ms(lambda: ops.stdp_epoch_masks_ref(
            pre, labels, key, n_out, LEARN_P_POT, LEARN_P_DEP),
            calls=3, replays=3),
        "bound_ms": m_bound, "bound_by": m_by, "draws": draws,
        "library_ms": None,
    }
    print("kernel_check " + json.dumps(m_row), flush=True)
    masks_rows.append(m_row)

    # the chain: slots read, the readout read and written, the offset, the
    # count; an AND+popc pair a readout bit a sample at the b1 rate.  Its
    # time is the samples' chain of latencies, not this bound
    work = bits_t.clone()
    stamps = torch.zeros(4, dtype=torch.int64, device="cuda")
    ops._epoch_chain(bits_t.clone(), slots, off, stamps)
    s = stamps.tolist()
    c_bytes = (slots.numel() * 4 + 2 * n_out * n_in + 4 * n_out * offset + 4)
    c_bound, c_by = card.bound(c_bytes, 2 * n * n_out * n_in,
                               card.b1_ops_per_s)
    # the pair as one function: trace, labels, key, the slots written and
    # read, the readout, the offset, the count; the draws of the wrong
    # samples only (a right sample learns nothing)
    e_bytes = m_bytes + c_bytes
    e_bound, e_by = card.bound(
        e_bytes, n_wrong / max(n, 1) * draws * DRAW_INT32_OPS,
        card.int32_per_s)
    epoch_ms = graph_ms(lambda: ops.stdp_column_epoch(work, pre, labels, key,
                                                      off, **p),
                        calls=3, replays=5)
    c_row = {
        "kernel": "stdp_column_epoch", "shape": shape, "tied": tied,
        "offset": offset, "special": special, "route": route,
        "key": key.tolist(),
        "max_abs_err": err,
        "ms": graph_ms(lambda: ops._epoch_chain(work, slots, off),
                       calls=3, replays=5),
        "epoch_ms": epoch_ms,
        "epoch_call_ms": call_ms(lambda: ops.stdp_column_epoch(
            work, pre, labels, key, off, **p), calls=5),
        "before_ms": EPOCH_BEFORE_MS.get((n_out, n_in, n)),
        "us_per_sample": epoch_ms * 1e3 / n,
        "clocks_per_step": (s[2] - s[1]) / max(n, 1),
        "setup_clocks": s[1] - s[0], "writeback_clocks": s[3] - s[2],
        "wrong": n_wrong,
        "plain_ms": graph_ms(lambda: ops.stdp_column_epoch_ref(
            bits_t, pre, labels, *u, off, LEARN_P_POT, LEARN_P_DEP),
            calls=1, replays=3),
        "bound_ms": c_bound, "bound_by": c_by,
        "epoch_bound_ms": e_bound, "epoch_bound_by": e_by,
        "library_ms": None,
    }
    print("kernel_check " + json.dumps(c_row), flush=True)
    chain_rows.append(c_row)


def epoch_sass(report) -> dict:
    """Per instantiation of the chain kernel (``column_epoch_kernel<WMAX,
    R, PerRow>``: the column events' chain, and with ``/row`` the
    matrix-RNG epoch's): ``ptxas`` registers and spill bytes, and the SASS
    count of REDUX and POPC (``cuobjdump``).  Raises unless each register
    route holds exactly one REDUX (the argmax's max) and none spills."""
    import re

    from repro_torch.kernels import _build

    regs, name = {}, None
    for line in report.ptxas.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and "column_epoch_kernel" in name:
            if "registers" in line:
                regs.setdefault(name, {})["registers"] = int(
                    re.search(r"Used (\d+) registers", line).group(1))
            if "spill" in line:
                regs.setdefault(name, {})["spill_bytes"] = sum(
                    int(x) for x in re.findall(r"(\d+) bytes spill", line))
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(report.path)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    found = {}
    for section in sass.split("Function : ")[1:]:
        fn = section.split(maxsplit=1)[0]
        if "column_epoch_kernel" not in fn:
            continue
        m = re.search(r"column_epoch_kernelILi(\d+)ELi(\d+)ELb(\d)E", fn)
        wmax, rows, per_row = (int(g) for g in m.groups())
        ops_ = re.findall(r"\b((?:REDUX|POPC)[.A-Z0-9_]*)", section)
        row = {op: ops_.count(op) for op in sorted(set(ops_))}
        row.update(regs.get(fn, {}))
        found[f"{wmax}x{rows}" + ("/row" if per_row else "")] = row
        redux = sum(v for k, v in row.items() if k.startswith("REDUX"))
        if wmax and (redux != 1 or row.get("spill_bytes")):
            raise AssertionError(f"column_epoch_kernel<{wmax},{rows},"
                                 f"{per_row}>: {row}")
    if len(found) != 12:
        raise AssertionError(f"column_epoch_kernel instantiations: {found}")
    print("epoch_sass " + json.dumps(found), flush=True)
    return found


def check_stdp_update(card, rng, n_out, n_in, kernels):
    """stdp_update (the full-matrix rule masked by post) vs its plain
    version."""
    import torch

    from repro_torch.kernels.stdp import ops

    bits_t, pre, u_pot, u_dep = _stdp_operands(
        rng, n_out, n_in, (n_out, n_in))
    post = torch.from_numpy(rng.random(n_out) < 0.3).cuda()

    def run():
        return ops.stdp_update(bits_t, pre, post, u_pot, u_dep,
                               p_pot=LEARN_P_POT, p_dep=LEARN_P_DEP)

    got = run()
    want = ops.stdp_update_ref(bits_t, pre, post, u_pot, u_dep,
                               LEARN_P_POT, LEARN_P_DEP)
    err = _word_err(got, want)
    if not torch.equal(got, want):
        raise AssertionError(f"stdp_update != plain at [{n_out}, {n_in}]")
    n_bytes = n_out * n_in * (1 + 4 + 4 + 1) + n_in + n_out
    bound_ms, bound_by = card.bound(n_bytes, 4 * n_out * n_in, F32_OPS_PER_S)
    row = {
        "kernel": "stdp_update", "shape": f"{n_out}x{n_in}",
        "max_abs_err": err, "ms": graph_ms(run), "call_ms": call_ms(run),
        "plain_ms": graph_ms(lambda: ops.stdp_update_ref(
            bits_t, pre, post, u_pot, u_dep, LEARN_P_POT, LEARN_P_DEP)),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }
    print("kernel_check " + json.dumps(row), flush=True)
    kernels.append(row)


def _once_ms(fn):
    """(wall ms, result) of one synchronised ``fn()`` on the card, for plain
    versions too long to capture in a graph."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, result


def _update_draws(pre, labels, n_out) -> tuple[int, int]:
    """(draws the matrix-RNG masks kernel makes, those a wrong sample's
    updates read): every sample's 5 key derivations, the teacher row at
    every input and each other row where the trace is 1; a sample's updates
    read the teacher row's and the winner row's (2 keys, the teacher's
    inputs, the trace's ones)."""
    valid = ((labels >= 0) & (labels < n_out)).long()
    npre = pre.sum(-1).long()
    n_in = pre.shape[1]
    masks = 5 * len(labels) + int((valid * n_in
                                   + (n_out - valid) * npre).sum())
    rule = int((2 + valid * n_in + npre).sum())
    return masks, rule


def check_update_epoch(card, rng, n_out, n_in, n, rows, *, route,
                       tied=False, bad=(-1,), probs=(LEARN_P_POT, LEARN_P_DEP),
                       timed=False):
    """The matrix-RNG epoch's three kernels against their plain versions on
    the card: ``stdp_update_keys`` against ``stdp_update_keys_ref``,
    ``stdp_update_masks`` slot for slot against ``stdp_update_masks_ref``,
    and the whole ``stdp_update_epoch`` (bits and update count) against
    ``stdp_update_epoch_ref`` (the per-sample loop, on the card too) under
    ``PRNGKey(n + n_out)``; labels outside [0, n_out) (``bad``) at samples
    1, 4, 7, ...; ``tied``: every readout row the same.  The route is
    asserted against ``ops._epoch_route``.  ``timed``: rows for the key
    walk (its serial floor, clocks a step), the masks and the chain (clocks
    a step), and the epoch's three launches together against its bound."""
    import torch

    from repro_torch.core import prng
    from repro_torch.kernels.stdp import ops

    bits = rng.integers(0, 2, size=(n_out, n_in), dtype=np.int8)
    if tied:
        bits[:] = bits[:1]
    bits_t = torch.from_numpy(bits).cuda()
    pre = torch.from_numpy(rng.random((n, n_in)) < 0.45).cuda()
    labels = rng.integers(0, n_out, size=(n,))
    for i, label in enumerate(bad):
        if 1 + 3 * i < n:
            labels[1 + 3 * i] = label
    labels = torch.from_numpy(labels).cuda()
    key = prng.PRNGKey(n + n_out).cuda()
    p_pot, p_dep = probs
    p = dict(p_pot=p_pot, p_dep=p_dep)
    shape = f"{n}x{n_in}->{n_out}"
    if ops._epoch_route(n_out, n_in) != route:
        raise AssertionError(f"epoch route {ops._epoch_route(n_out, n_in)} "
                             f"at [{n_out}, {n_in}], want {route}")
    keys = ops.stdp_update_keys(key, n)
    want_keys = ops.stdp_update_keys_ref(key, n)
    slots = ops.stdp_update_masks(pre, labels, keys, n_out, **p)
    want_slots = ops.stdp_update_masks_ref(pre, labels, want_keys, n_out,
                                           p_pot, p_dep)
    if not torch.equal(keys, want_keys):
        raise AssertionError(f"stdp_update_keys != plain at n={n}")
    if not torch.equal(slots, want_slots):
        raise AssertionError(f"stdp_update_masks != plain at {shape} "
                             f"p={probs}")
    got = bits_t.clone()
    count = ops.stdp_update_epoch(got, pre, labels, key, **p)
    plain_ms, (want, want_count) = _once_ms(
        lambda: ops.stdp_update_epoch_ref(bits_t, pre, labels, key, p_pot,
                                          p_dep))
    err = _word_err(got, want)
    if not torch.equal(got, want) or int(count) != int(want_count):
        raise AssertionError(
            f"stdp_update_epoch != plain at {shape} tied={tied} bad={bad} "
            f"p={probs}: {int(count)} vs {int(want_count)} updates")
    if not timed:
        return
    n_wrong = int(want_count) // 2
    masks_draws, rule_draws = _update_draws(pre, labels, n_out)
    shift = ops._update_shift(ops._library(), n_out, n_in, bits_t.device)
    work = bits_t.clone()

    # the key walk: the key read, the keys written; a threefry a step at the
    # int32 rate; its time is samples x one threefry's latency (the floor)
    k_stamps = torch.zeros(2, dtype=torch.int64, device="cuda")
    ops.stdp_update_keys(key, n, k_stamps)
    ks = k_stamps.tolist()
    k_bound, k_by = card.bound(16 + 8 * n, n * DRAW_INT32_OPS,
                               card.int32_per_s)
    k_row = {
        "kernel": "stdp_update_keys", "shape": shape, "max_abs_err":
        int((keys != want_keys).sum()),
        "ms": graph_ms(lambda: ops.stdp_update_keys(key, n), calls=3,
                       replays=5),
        "call_ms": call_ms(lambda: ops.stdp_update_keys(key, n), calls=5),
        "clocks_per_step": (ks[1] - ks[0]) / max(n, 1),
        "plain_ms": _once_ms(lambda: ops.stdp_update_keys_ref(key, n))[0],
        "bound_ms": k_bound, "bound_by": k_by, "library_ms": None,
    }
    # the masks: traces, labels and keys read, the slots written; every
    # draw the kernel makes at the int32 rate
    m_bytes = n * n_in + n * labels.element_size() + 8 * n + slots.numel() * 4
    m_bound, m_by = card.bound(m_bytes, masks_draws * DRAW_INT32_OPS,
                               card.int32_per_s)
    m_row = {
        "kernel": "stdp_update_masks", "shape": shape, "max_abs_err":
        int((slots != want_slots).sum()), "draws": masks_draws,
        "ms": graph_ms(lambda: ops.stdp_update_masks(pre, labels, keys,
                                                     n_out, **p)),
        "call_ms": call_ms(lambda: ops.stdp_update_masks(pre, labels, keys,
                                                         n_out, **p)),
        "plain_ms": graph_ms(lambda: ops.stdp_update_masks_ref(
            pre, labels, keys, n_out, p_pot, p_dep), calls=3, replays=3),
        "bound_ms": m_bound, "bound_by": m_by, "library_ms": None,
    }
    # the chain: slots read, the readout read and written, the count; an
    # AND+popc pair a readout bit a sample at the b1 rate
    c_stamps = torch.zeros(4, dtype=torch.int64, device="cuda")
    ops._update_chain(bits_t.clone(), slots, shift, c_stamps)
    cs = c_stamps.tolist()
    c_bytes = slots.numel() * 4 + 2 * n_out * n_in + 4
    c_bound, c_by = card.bound(c_bytes, 2 * n * n_out * n_in,
                               card.b1_ops_per_s)
    # the epoch as one function: the masks' draws at the int32 rate or the
    # chain's bytes, whichever is larger; and, beside it, the draws a wrong
    # sample's updates read, with the key walk
    e_bound, e_by = card.bound(c_bytes, masks_draws * DRAW_INT32_OPS,
                               card.int32_per_s)
    rule_bound, rule_by = card.bound(
        n * n_in + n * labels.element_size() + 16 + 2 * n_out * n_in + 4,
        (n + n_wrong / max(n, 1) * rule_draws) * DRAW_INT32_OPS,
        card.int32_per_s)
    epoch_ms = graph_ms(lambda: ops.stdp_update_epoch(work, pre, labels, key,
                                                      **p),
                        calls=3, replays=5)
    c_row = {
        "kernel": "stdp_update_chain", "shape": shape, "tied": tied,
        "route": route, "shift": shift, "max_abs_err": err,
        "ms": graph_ms(lambda: ops._update_chain(work, slots, shift),
                       calls=3, replays=5),
        "epoch_ms": epoch_ms,
        "epoch_call_ms": call_ms(lambda: ops.stdp_update_epoch(
            work, pre, labels, key, **p), calls=5),
        "key_floor_ms": k_row["ms"],
        "key_clocks_per_step": k_row["clocks_per_step"],
        "us_per_sample": epoch_ms * 1e3 / n,
        "clocks_per_step": (cs[2] - cs[1]) / max(n, 1),
        "setup_clocks": cs[1] - cs[0], "writeback_clocks": cs[3] - cs[2],
        "wrong": n_wrong, "plain_ms": plain_ms,
        "bound_ms": c_bound, "bound_by": c_by,
        "epoch_bound_ms": e_bound, "epoch_bound_by": e_by,
        "rule_bound_ms": rule_bound, "rule_bound_by": rule_by,
        "library_ms": None,
    }
    for row in (k_row, m_row, c_row):
        print("kernel_check " + json.dumps(row), flush=True)
        rows.append(row)


def _requests(rng, n: int, fill: str, width: int = ROW_GROUP):
    """{0,1} request rows [n, width] on the card: random at p=0.5, or all
    zeros, or all ones."""
    import torch

    if fill == "zeros":
        return torch.zeros((n, width), dtype=torch.bool, device="cuda")
    if fill == "ones":
        return torch.ones((n, width), dtype=torch.bool, device="cuda")
    return torch.from_numpy(rng.random((n, width)) < 0.5).cuda()


def check_arbiter(card, rng, name, n, ports, kernels, fill="random",
                  width=ROW_GROUP, timed=True):
    """port_schedule or arbiter vs its plain version on the card, bit for
    bit (values and dtypes), timed against its bound (``timed``)."""
    import torch

    from repro_torch.kernels.arbiter import ops

    fn, ref = ((ops.port_schedule, ops.port_schedule_ref)
               if name == "port_schedule" else (ops.arbiter, ops.arbiter_ref))
    r = _requests(rng, n, fill, width)

    def run():
        return fn(r, ports=ports)

    got, want = run(), ref(r, ports)
    torch.cuda.synchronize()
    err = max(_word_err(a, b) for a, b in zip(got, want))
    if err or not all(a.dtype == b.dtype and torch.equal(a, b)
                      for a, b in zip(got, want)):
        raise AssertionError(f"{name} != plain at [{n}, {width}] "
                             f"p={ports} {fill}: max_abs_err={err}")
    if not timed:
        return
    # each request byte read once, each output written once; two popcs a
    # lane and 32-lane sub-block (its rank and its sub-block's total)
    lanes = n * width
    if name == "port_schedule":
        n_bytes = lanes + 4 * lanes + 4 * n * -(-width // ports)
    else:
        n_bytes = lanes + ports * lanes + lanes + n * ports
    bound_ms, bound_by = card.bound(n_bytes, 2 * lanes)
    row = {
        "kernel": name, "shape": f"{n}x{width}", "ports": ports,
        "fill": fill, "max_abs_err": err,
        "ms": graph_ms(run), "call_ms": call_ms(run),
        "plain_ms": graph_ms(lambda: ref(r, ports)),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }
    print("kernel_check " + json.dumps(row), flush=True)
    kernels.append(row)


def _lif_operands(rng, batch, n, refractory):
    """LIF-step operands with ties: thresholds negative, zero, positive and
    2^31 - 1; a sixth of the membranes at exactly +vth or -vth (contribution
    0) and a sixth at 0 with a contribution of exactly vth."""
    import torch

    vth = rng.integers(-40, 41, size=(n,)).astype(np.int32)
    vth[rng.random(n) < 0.2] = 0
    vth[rng.random(n) < 0.2] = 2**31 - 1
    vmem = rng.uniform(-60.0, 60.0, size=(batch, n)).astype(np.float32)
    contrib = rng.integers(-40, 41, size=(batch, n)).astype(np.int32)
    pick = rng.random((batch, n))
    full = np.broadcast_to(vth, (batch, n))
    at_vth = pick < 1 / 6
    sign = np.where(rng.random((batch, n)) < 0.5, 1.0, -1.0)
    vmem[at_vth] = (sign * full.astype(np.float32))[at_vth]
    contrib[at_vth] = 0
    hit = (pick >= 1 / 6) & (pick < 1 / 3) & (np.abs(full) < 2**24)
    vmem[hit] = 0.0
    contrib[hit] = full[hit]
    refrac = rng.integers(0, refractory + 1, size=(batch, n)).astype(np.int32)
    return [torch.from_numpy(a).cuda() for a in (vmem, contrib, vth, refrac)]


def check_lif(card, rng, batch, n, leak, reset, refractory, kernels):
    """lif_step vs its plain version on the card, bit for bit (spikes,
    membranes, refractory counters and their dtypes)."""
    import torch

    from repro_torch.kernels.lif_step import ops

    args = _lif_operands(rng, batch, n, refractory)
    kw = dict(leak=leak, reset=reset, refractory=refractory)

    def run():
        return ops.lif_step(*args, **kw)

    got, want = run(), ops.lif_step_ref(*args, **kw)
    torch.cuda.synchronize()
    err = max(float((g.double() - w.double()).abs().max())
              for g, w in zip(got, want))
    if err or not all(g.dtype == w.dtype and torch.equal(g, w)
                      for g, w in zip(got, want)):
        raise AssertionError(f"lif_step != plain at [{batch}, {n}] {kw}: "
                             f"max_abs_err={err}")
    # vmem, contrib and refrac read, spikes, vmem' and refrac' written, and
    # the thresholds; a multiply-add, a compare and two selects an element
    elems = batch * n
    bound_ms, bound_by = card.bound(21 * elems + 4 * n, 4 * elems,
                                    F32_OPS_PER_S)
    row = {
        "kernel": "lif_step", "shape": f"{batch}x{n}", "leak": leak,
        "reset": reset, "refractory": refractory, "max_abs_err": err,
        "fired": int(got[0].sum()),
        "ms": graph_ms(run), "call_ms": call_ms(run),
        "plain_ms": graph_ms(lambda: ops.lif_step_ref(*args, **kw)),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }
    print("kernel_check " + json.dumps(row), flush=True)
    kernels.append(row)


def _scan_operands(rng, hidden, n_cls, n_steps, batch):
    """temporal_scan operands on the card: c_in in [-40, 40] (tile 0's MAC
    range at a few dozen input spikes), full 32-bit plane words, thresholds
    in [-8, 8] with a tenth at 2^31 - 1."""
    import torch

    n_first = hidden[0] if hidden else n_cls
    c_in = rng.integers(-40, 41, size=(n_steps, batch, n_first),
                        dtype=np.int32)
    widths = list(hidden) + [n_cls]
    planes = [rng.integers(-2**31, 2**31, size=(widths[i + 1], -(-n // 32)),
                           dtype=np.int64).astype(np.int32)
              for i, n in enumerate(hidden)]
    vth = [rng.integers(-8, 9, size=(n,)).astype(np.int32) for n in hidden]
    for th in vth:
        th[rng.random(th.shape) < 0.1] = 2**31 - 1
    return (torch.from_numpy(c_in).cuda(),
            tuple(torch.from_numpy(w).cuda() for w in planes),
            tuple(torch.from_numpy(th).cuda() for th in vth))


def scan_bound(card, hidden, n_cls, n_steps, batch, collect, telemetry):
    """The bounds of one temporal_scan (``_b1_bounds``): c_in, the planes and
    thresholds read once, the readout's membranes (and the collected words
    and loads) written once; per stream and step 2 n_next n AND+popc
    operations a hidden tile (the b1 product's), or for the popc unit one
    popc per plane word pair and spike word."""
    n_first = hidden[0] if hidden else n_cls
    widths = list(hidden) + [n_cls]
    w = [-(-n // 32) for n in hidden]
    pairs = sum(widths[i + 1] * w[i] + w[i] for i in range(len(hidden)))
    bits = sum(widths[i + 1] * n for i, n in enumerate(hidden))
    words = sum(w)
    n_bytes = 4 * (n_steps * batch * n_first + sum(
        widths[i + 1] * w[i] + n for i, n in enumerate(hidden))
        + batch * n_cls + n_steps * batch * (
            words * collect + words // 4 * telemetry))
    return _b1_bounds(card, n_bytes, 2 * n_steps * batch * bits,
                      n_steps * batch * pairs)


def check_scan(card, rng, hidden, batch, n_steps, kernels, leak=EVENT_LEAK,
               reset="zero", refractory=0, n_cls=10, route="regs"):
    """temporal_scan vs its plain version on the card, bit for bit (the
    readout's membranes, every hidden tile's spike words, and their loads
    where the widths are row groups of 128), timed in a CUDA graph and
    eagerly against its bounds, with clocks a chain link (at the card's
    maximum SM clock).  ``route`` is the route (``ops._scan_route``) the
    widths must take; on the register route the same operands also run
    on the shared-memory kernel (``before_ms``, the parent's kernel).  A
    stack deeper than one launch takes runs as consecutive launches with a
    popcount_mac between, and the launches are counted."""
    import torch

    from repro_torch.kernels.cim_popcount import ops as pop_ops
    from repro_torch.kernels.lif_step import ops

    args = _scan_operands(rng, hidden, n_cls, n_steps, batch)
    telemetry = all(n % ROW_GROUP == 0 for n in hidden)
    kw = dict(leak=leak, reset=reset, refractory=refractory, collect=True,
              telemetry=telemetry)

    def run():
        return ops.temporal_scan(*args, **kw)

    ops.reset_launch_counts()
    pop_ops.reset_launch_counts()
    got, want = run(), ops.temporal_scan_ref(*args, **kw)
    torch.cuda.synchronize()
    launches = -(-len(hidden) // ops.SCAN_MAX_HIDDEN) if hidden else 1
    counts = (ops.launch_counts()["temporal_scan"],
              pop_ops.launch_counts()["popcount_mac"])
    if counts != (launches, launches - 1):
        raise AssertionError(f"temporal_scan at {len(hidden)} hidden tiles: "
                             f"(scan, mac) launches {counts}, want "
                             f"{(launches, launches - 1)}")

    def same(a, b):
        return torch.equal(a[0], b[0]) and all(
            torch.equal(g, w) for g, w in zip(a[1] + (a[2] or ()),
                                              b[1] + (b[2] or ())))

    err = float((got[0].double() - want[0].double()).abs().max())
    if err or not same(got, want):
        raise AssertionError(
            f"temporal_scan != plain at T={n_steps} B={batch} {hidden} "
            f"{kw}: max_abs_err={err}")
    took = ops._scan_route(torch.cuda.current_device(), tuple(hidden),
                           n_cls) if launches == 1 and hidden else None
    if launches == 1 and hidden and took.name != route:
        raise AssertionError(f"temporal_scan at {hidden}: route {took}, "
                             f"want {route}")
    before = None
    if took is not None and took.name == "regs":   # the parent's kernel
        dev = args[0].device
        smem = ops.ScanRoute("smem", 1, 1)

        def run_smem():
            return ops._scan_launch(*args, dev=dev, route=smem, **kw)

        if not same(run_smem(), want):
            raise AssertionError(f"the shared-memory scan != plain at "
                                 f"T={n_steps} B={batch} {hidden}")
        before = graph_ms(run_smem)
    ms = graph_ms(run)
    links = n_steps * (len(hidden) + 1)
    row = {
        "kernel": "temporal_scan",
        "shape": f"{n_steps}x{batch}x" + ":".join(map(str, (*hidden, n_cls))),
        "leak": leak, "reset": reset, "refractory": refractory,
        "route": took.name if took else None,
        "geometry": ({"steps": took.steps, "warps": ops.SCAN_WARPS,
                      "rows": ops.SCAN_ROWS} if took and took.name == "regs"
                     else None),
        "launches": launches, "max_abs_err": err, "chain_links": links,
        "fired": int(sum(int(w.sum()) for w in got[2])) if telemetry else None,
        "ms": ms, "call_ms": call_ms(run), "before_ms": before,
        "clocks_per_link": ms * 1e-3 * card.max_sm_mhz * 1e6 / links,
        # the plain version is ~100 launches a step: two calls a graph
        "plain_ms": graph_ms(lambda: ops.temporal_scan_ref(*args, **kw),
                             calls=2, replays=3),
        **scan_bound(card, hidden, n_cls, n_steps, batch, True, telemetry),
        "library_ms": None,
    }
    print("kernel_check " + json.dumps(row), flush=True)
    kernels.append(row)


def scan_sass(report) -> dict:
    """Per instantiation of the register route's kernel
    (``scan_regs_kernel<tiles, K steps, warps, streams, refractory,
    subtract>``): ``ptxas`` registers, stack and spill bytes.  Raises
    unless the paper shape's (3 tiles, 1 K step, at ``ops.SCAN_WARPS``
    warps and ``ops.SCAN_ROWS`` streams) has neither stack nor spills."""
    import re

    from repro_torch.kernels.lif_step import ops

    found, name = {}, None
    for line in report.ptxas.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            continue
        m = name and re.search(
            r"scan_regs_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELb(\d)ELb(\d)E",
            name)
        if not m:
            continue
        key = "x".join(m.groups()[:4]) + ("/refr" if m.group(5) == "1"
                                          else "") + (
            "/sub" if m.group(6) == "1" else "")
        row = found.setdefault(key, {})
        if "registers" in line:
            row["registers"] = int(re.search(r"Used (\d+) registers",
                                             line).group(1))
        if "spill" in line:
            row["stack_bytes"] = int(re.search(r"(\d+) bytes stack frame",
                                               line).group(1))
            row["spill_bytes"] = sum(
                int(x) for x in re.findall(r"(\d+) bytes spill", line))
    paper = f"3x1x{ops.SCAN_WARPS}x{ops.SCAN_ROWS}"
    bad = {k: v for k, v in found.items() if k.split("/")[0] == paper
           and (v.get("spill_bytes") or v.get("stack_bytes"))}
    if bad or not any(k.split("/")[0] == paper for k in found):
        raise AssertionError(f"scan_regs_kernel at the paper shape: {bad}, "
                             f"instantiations {sorted(found)}")
    print("scan_sass " + json.dumps(found), flush=True)
    return found


def _spike_rows(rng, batch: int, n: int, dtype):
    """{0,1} spikes [batch, n] at p=0.4 in ``dtype``, on the card."""
    import torch

    return torch.from_numpy(rng.random((batch, n)) < 0.4).to(dtype).cuda()


def check_cim_matmul(card, rng, batch, n_in, n_out, kernels, fire=False,
                     dtype_name="float32", *, view=None, fill="random",
                     vth_fill="random"):
    """cim_matmul (int32 V) or esam_layer (int8 fire) on unpacked spikes of
    one dtype vs its plain version, bit for bit, in one launch, with the
    route it took; ``view`` (width, first) takes the spikes as columns
    first.. of a wider tensor whose other columns are all ones (rows
    16-byte aligned or not: 16-byte or element loads); ``fill`` "zeros" /
    "ones" sets every spike; ``vth_fill`` "min" / "max" every threshold at
    -2^31 / 2^31 - 1.  Bounds as B9's (the b1 product's 2 B N K operations;
    int8 and popc bounds beside); the library yardstick is torch.matmul on
    the ±1 float32 operands, TF32 off."""
    import torch

    from repro_torch.kernels.cim_matmul import ops

    width, first = view or (n_in, 0)
    if fill == "random":
        spikes = rng.random((batch, width)) < 0.4
    else:
        spikes = np.full((batch, width), fill == "ones")
    spikes[:, :first] = True
    spikes[:, first + n_in:] = True
    s = torch.from_numpy(spikes).to(getattr(torch, dtype_name)).cuda()
    s = s[:, first:first + n_in]
    bits = torch.from_numpy(
        rng.integers(0, 2, size=(n_in, n_out), dtype=np.int8)).cuda()
    if vth_fill == "random":
        vth = rng.integers(-8, 9, size=(n_out,), dtype=np.int32)
    else:
        info = np.iinfo(np.int32)
        vth = np.full((n_out,), info.min if vth_fill == "min" else info.max,
                      np.int32)
    vth = torch.from_numpy(vth).cuda()
    name = "esam_layer" if fire else "cim_matmul"

    def run():
        return ops.esam_layer(s, bits, vth) if fire else ops.cim_matmul(s, bits)

    def plain():
        return (ops.esam_layer_ref(s, bits, vth) if fire
                else ops.cim_matmul_ref(s, bits))

    ops.reset_launch_counts()
    out = run()
    if ops.launch_counts()[name] != 1:
        raise AssertionError(f"{name} launches {ops.launch_counts()}")
    ref = plain()
    torch.cuda.synchronize()
    err = _word_err(out, ref)
    if err or out.dtype != ref.dtype or not torch.equal(out, ref):
        raise AssertionError(f"{name} != plain at {batch}x{n_in}->{n_out} "
                             f"{dtype_name} view={view} {fill} "
                             f"vth={vth_fill}: max_abs_err={err}")
    took = ops._route_for(s, n_out)
    spans, groups = took.grid
    if (not spans * took.span_rows >= batch > (spans - 1) * took.span_rows
            or not 0 <= groups * 64 - n_out < 64
            or took.vec != (s.data_ptr() % 16 == 0
                            and s.stride(0) * s.element_size() % 16 == 0)):
        raise AssertionError(f"B10 route {took} at B={batch} N={n_out}")
    # spikes in their dtype, the int8 weights (the kernel builds the planes
    # from them), V int32 or the int8 fire (+ vth)
    n_bytes = (s.element_size() * batch * n_in + n_in * n_out
               + (batch * n_out + 4 * n_out if fire else 4 * batch * n_out))
    sf, wf = s.to(torch.float32), 2.0 * bits.to(torch.float32) - 1.0
    with tf32_off():
        library_ms = graph_ms(lambda: torch.matmul(sf, wf))
    row = {
        "kernel": name, "shape": f"{batch}x{n_in}->{n_out}",
        "dtype": dtype_name, "batch": batch, "view": view, "fill": fill,
        "vth_fill": vth_fill, "route": took._asdict(), "max_abs_err": err,
        "ms": graph_ms(run), "call_ms": call_ms(run),
        "plain_ms": _plain_ms(plain, n_in),
        **_tile_bounds(card, batch, n_in, n_out, n_bytes),
        "library_ms": library_ms,
    }
    print("kernel_check " + json.dumps(row), flush=True)
    kernels.append(row)


def check_packed_mac(card, rng, batch, n_in, n_out, kernels, tail=False):
    """cim_matmul_packed (spike words x {0,1} int8 weights -> int32 V) vs
    its plain version; ``tail`` as in ``check_packed_fire``."""
    import torch

    from repro_torch.core import packing
    from repro_torch.kernels.cim_matmul_packed import ops

    bits = torch.from_numpy(
        rng.integers(0, 2, size=(n_in, n_out), dtype=np.int8)).cuda()
    x = random_words(rng, batch, n_in, tail).cuda()

    def run():
        return ops.cim_matmul_packed(x, bits)

    ops.reset_launch_counts()
    out = run()
    if ops.launch_counts()["cim_matmul_packed"] != 1:
        raise AssertionError(f"cim_matmul_packed launches "
                             f"{ops.launch_counts()}")
    ref = ops.cim_matmul_packed_ref(x, bits)
    torch.cuda.synchronize()
    err = _word_err(out, ref)
    if err or not torch.equal(out, ref):
        raise AssertionError(f"cim_matmul_packed != plain at B={batch} "
                             f"{n_in}->{n_out} tail={tail}: err={err}")
    words = packing.packed_width(n_in)
    n_bytes = 4 * batch * words + n_in * n_out + 4 * batch * n_out
    shape = f"{batch}x{n_in}->{n_out}"
    row = {
        "kernel": "cim_matmul_packed", "shape": shape, "batch": batch,
        "tail": tail, "route": _packed_row(ops, x, n_out),
        "max_abs_err": err, "ms": graph_ms(run), "call_ms": call_ms(run),
        "before_ms": None if tail else PACKED_BEFORE_MS.get(
            ("cim_matmul_packed", shape)),
        "plain_ms": graph_ms(lambda: ops.cim_matmul_packed_ref(x, bits)),
        **_tile_bounds(card, batch, n_in, n_out, n_bytes),
        "library_ms": _matmul_yardstick(x, bits, n_in),
    }
    print("kernel_check " + json.dumps(row), flush=True)
    kernels.append(row)


def check_if_neuron(card, rng, batch, rounds, n, kernels, fill="random",
                    view=None):
    """if_neuron vs its plain version, with the route it took: random
    updates, every membrane exactly at its threshold (equality fires), or
    updates near 2^30 whose int32 sum wraps.  ``view`` "row": the updates
    are ``big[1:]`` of one more row (16-byte aligned only where T * N % 4
    == 0); "word": a view 4 bytes past an aligned start; "vth": the
    thresholds 12 bytes past one (both take the one-neuron loads)."""
    import torch

    from repro_torch.kernels.if_neuron import ops

    if fill == "random":
        upd = rng.integers(-3, 4, size=(batch, rounds, n), dtype=np.int32)
        vth = rng.integers(-6, 7, size=(n,), dtype=np.int32)
    elif fill == "equal":
        upd = np.ones((batch, rounds, n), dtype=np.int32)
        vth = np.full((n,), rounds, dtype=np.int32)
    else:  # wrap
        upd = rng.integers(2**30, 2**31 - 1, size=(batch, rounds, n),
                           dtype=np.int64).astype(np.int32)
        vth = rng.integers(-2**31, 2**31 - 1, size=(n,),
                           dtype=np.int64).astype(np.int32)
    upd, vth = torch.from_numpy(upd).cuda(), torch.from_numpy(vth).cuda()
    if view == "row":
        upd = torch.cat([upd[:1], upd])[1:]
    elif view == "word":
        flat = upd.reshape(-1)
        upd = torch.cat([flat[:1], flat])[1:].view(batch, rounds, n)
    elif view == "vth":
        vth = torch.cat([vth[:3], vth])[3:]
    route = ops._route_for(upd, vth)

    def run():
        return ops.if_neuron(upd, vth)

    got, want = run(), ops.if_neuron_ref(upd, vth)
    torch.cuda.synchronize()
    err = max(_word_err(a, b) for a, b in zip(got, want))
    if err or not all(a.dtype == b.dtype and torch.equal(a, b)
                      for a, b in zip(got, want)):
        raise AssertionError(f"if_neuron != plain at [{batch}, {rounds}, "
                             f"{n}] {fill} view={view} {route}: "
                             f"max_abs_err={err}")
    if fill == "equal" and not bool(got[0].all()):
        raise AssertionError("if_neuron: V_mem == vth did not fire")
    if fill == "wrap":
        wide = upd.long().sum(1)
        if torch.equal(wide, got[1].long()):
            raise AssertionError("if_neuron wrap case did not overflow")
        if not torch.equal((wide & 0xFFFFFFFF).to(torch.int64),
                           got[1].long() & 0xFFFFFFFF):
            raise AssertionError("if_neuron: V_mem is not the sum mod 2^32")
    # updates read once, vth, int8 spikes and int32 V_mem written; an add
    # per update and a compare per neuron
    elems = batch * n
    bound_ms, bound_by = card.bound(4 * elems * rounds + 4 * n + 5 * elems,
                                    elems * rounds + elems, F32_OPS_PER_S)
    row = {
        "kernel": "if_neuron", "shape": f"{batch}x{rounds}x{n}",
        "fill": fill, "view": view, "route": dataclasses.asdict(route),
        "max_abs_err": err, "fired": int(got[0].sum()),
        "ms": graph_ms(run), "call_ms": call_ms(run),
        "plain_ms": graph_ms(lambda: ops.if_neuron_ref(upd, vth)),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        # the rounds' sum alone is one PyTorch call (the fire is another)
        "sum_ms": graph_ms(lambda: upd.sum(1, dtype=torch.int32)),
    }
    print("kernel_check " + json.dumps(row), flush=True)
    kernels.append(row)


#: tile input widths (words) of a paper-topology round: 768, 256, 256, 256
PAPER_WORDS = tuple(n // 32 for n in PAPER_TOPOLOGY[:-1])


def check_tile_loads(card, rng, shapes, kernels, fill="random",
                     shift=False):
    """tile_loads (every plane of a round in one launch) vs its plain
    version: planes of int32 words of the given shapes, random, all zero
    or all one; ``shift``: the first plane a view 4 bytes past an aligned
    start (word loads)."""
    import torch

    from repro_torch.kernels.telemetry import ops

    planes = []
    for shape in shapes:
        words = rng.integers(0, 2**32, size=shape, dtype=np.uint64)
        if fill != "random":
            words[...] = 0 if fill == "zeros" else 2**32 - 1
        planes.append(torch.from_numpy(
            words.astype(np.uint32).view(np.int32)).cuda())
    if shift:
        flat = planes[0].reshape(-1)
        planes[0] = torch.cat([flat[:1], flat])[1:].view(shapes[0])
    planes = tuple(planes)

    def run():
        return ops.tile_loads(planes)

    ops.reset_launch_counts()
    got = run()
    if ops.launch_counts()["tile_loads"] != 1:
        raise AssertionError(f"tile_loads launches {ops.launch_counts()}")
    want = ops.tile_loads_ref(planes)
    torch.cuda.synchronize()
    err = max(_word_err(g, w) for g, w in zip(got, want))
    if err or not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"tile_loads != plain at {shapes} {fill} "
                             f"shift={shift}: err={err}")
    words = sum(int(np.prod(sh)) for sh in shapes)
    # every word read once, a load a row group written; a popc a word
    bound_ms, bound_by = card.bound(4 * words + words, words)
    row = {
        "kernel": "tile_loads", "shape": "+".join(
            "x".join(map(str, sh)) for sh in shapes),
        "fill": fill, "shift": shift, "max_abs_err": err,
        "ms": graph_ms(run), "call_ms": call_ms(run),
        "plain_ms": graph_ms(lambda: ops.tile_loads_ref(planes)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        # no PyTorch call counts set bits (torch has no popcount)
        "library_ms": None,
    }
    print("kernel_check " + json.dumps(row), flush=True)
    kernels.append(row)


def check_request_stats(card, rng, batch, kernels, read_ports=4, steps=None,
                        fill="random", logits=True):
    """request_stats (the cost model of a round in one launch) vs its
    plain version, bit for bit: paper-topology loads of ``batch`` requests
    (``steps``: event streams, time-first loads handed in batch-first as
    the temporal plan does), random, all zero or all full (128 a group),
    with the logits carried into the slab or not."""
    import torch

    from repro_torch.core.esam import cost_model as cm
    from repro_torch.kernels.telemetry import ops

    loads = []
    for k, n in zip(PAPER_TOPOLOGY[:-1], PAPER_TOPOLOGY[1:]):
        g = cm.tile_geometry(k, n)[0]
        shape = (batch, g) if steps is None else (steps, batch, g)
        a = rng.integers(0, 129, size=shape, dtype=np.int32)
        if fill != "random":
            a[...] = 0 if fill == "zeros" else 128
        t = torch.from_numpy(a).cuda()
        loads.append(t if steps is None else t.transpose(0, 1))
    lg = (torch.from_numpy(rng.normal(size=(batch, PAPER_TOPOLOGY[-1]))
                           .astype(np.float32)).cuda() if logits else None)
    temporal = steps is not None
    n_tiles = len(PAPER_TOPOLOGY) - 1

    def run():
        return ops.request_stats(loads, PAPER_TOPOLOGY, read_ports,
                                 temporal=temporal, logits=lg)

    def plain():
        fn = (ops.temporal_request_stats_ref if temporal
              else ops.request_stats_ref)
        return ops.stats_slab_ref(fn(PAPER_TOPOLOGY, loads, read_ports),
                                  n_tiles, temporal, lg)

    ops.reset_launch_counts()
    got = run()
    if ops.launch_counts()["request_stats"] != 1:
        raise AssertionError(f"request_stats launches {ops.launch_counts()}")
    want = plain()
    torch.cuda.synchronize()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not torch.equal(got, want):
        raise AssertionError(f"request_stats != plain at B={batch} "
                             f"T={steps} ports={read_ports} {fill}: "
                             f"max_abs_err={err}")
    n_loads = sum(int(ld.numel()) for ld in loads)
    # loads and logits read once, the slab written; ~10 float32 operations
    # a (request, step, tile) and 2 integer ones a load
    n_bytes = 4 * n_loads + (lg.numel() * 4 if logits else 0) + 4 * got.numel()
    n_rows = batch * (steps or 1)
    bound_ms, bound_by = card.bound(n_bytes, 10 * n_rows * n_tiles
                                    + 2 * n_loads, F32_OPS_PER_S)
    row = {
        "kernel": "request_stats",
        "shape": f"{batch}" + ("" if steps is None else f"x{steps}"),
        "ports": read_ports, "fill": fill, "logits": logits,
        "max_abs_err": err, "ms": graph_ms(run), "call_ms": call_ms(run),
        "plain_ms": graph_ms(plain), "bound_ms": bound_ms,
        "bound_by": bound_by,
        # no single PyTorch call computes the cost model
        "library_ms": None,
    }
    print("kernel_check " + json.dumps(row), flush=True)
    kernels.append(row)


#: the CUDA runtime calls that start work on the card, as the profiler's
#: host-side events name them
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                     "cuLaunchKernel", "cuLaunchKernelEx")


def profile_drain(eng, reqs, what: str, rounds_key: str) -> dict:
    """Where a drain's time goes on the device: ``reqs`` served by ``eng``
    under torch.profiler; device time per kernel name, the device's busy
    share of that same profiled drain's wall time (profiler overhead
    included), device operations (kernels and copies) a round, and the
    host's launches a round: graph replays, kernel launches, copies."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    rounds0 = eng.stats()[rounds_key]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.serve(reqs)
        profiled_wall_s = time.perf_counter() - t0
    events = prof.key_averages()
    on_device = [e for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    host = {e.key: e.count for e in events
            if e.device_type == torch.autograd.DeviceType.CPU}
    device_s = sum(e.self_device_time_total for e in on_device) / 1e6
    rounds = eng.stats()[rounds_key] - rounds0
    copies = sum(e.count for e in on_device if e.key.startswith("Memcpy"))
    ops = sum(e.count for e in on_device)
    top = sorted(on_device, key=lambda e: -e.self_device_time_total)[:10]
    row = {
        "drain": what, "requests": len(reqs), "rounds": rounds,
        "device_s": device_s, "profiled_wall_s": profiled_wall_s,
        "device_busy_share": device_s / profiled_wall_s,
        "device_kernels": len(on_device), "device_launches": ops,
        "device_ops_per_round": ops / rounds,
        "device_copies_per_round": copies / rounds,
        "host_graph_launches_per_round":
            host.get("cudaGraphLaunch", 0) / rounds,
        "host_kernel_launches_per_round":
            sum(host.get(k, 0) for k in HOST_LAUNCH_CALLS) / rounds,
        "host_copies_per_round": host.get("cudaMemcpyAsync", 0) / rounds,
        "graph_counts": eng.graph_counts(),
        "top": [{"name": e.key[:60], "count": e.count,
                 "device_ms": e.self_device_time_total / 1e3} for e in top],
    }
    return row


def check_round_launches(what: str, sync_prof: dict, warm_prof: dict,
                         most: int) -> None:
    """From the host's CUDA calls a round (the profiler's host events,
    exact where its device records may drop a round's): a synchronous
    round launches at most ``most`` kernels and copies, the input copy
    included; a warmed round is one graph replay, the input copy and one
    copy out, and no kernel launch."""
    eager = (sync_prof["host_kernel_launches_per_round"]
             + sync_prof["host_copies_per_round"])
    if eager > most:
        raise AssertionError(f"{what} round: {eager} launches and copies, "
                             f"want at most {most}")
    warm = (warm_prof["host_graph_launches_per_round"],
            warm_prof["host_kernel_launches_per_round"],
            warm_prof["host_copies_per_round"])
    if warm != (1.0, 0.0, 2.0):
        raise AssertionError(f"warmed {what} round: (graph replays, kernel "
                             f"launches, copies) {warm}, want (1, 0, 2)")


def profile_serve(net, spikes, warm: bool = False) -> dict:
    """The main path's traffic served once more under the profiler, by the
    synchronous drain or (``warm``) a warmed, overlapped engine; prints a
    ``profile`` line."""
    from repro_torch.serve.engine import SpikeEngine, SpikeRequest

    kw = dict(fuse_rounds="auto", overlap=True) if warm else {}
    eng = SpikeEngine(net, max_batch=BUCKET, telemetry=True, device="cuda",
                      **kw)
    if warm:
        eng.warmup()
    row = profile_drain(eng, [SpikeRequest(spikes=s) for s in spikes],
                        "warmed" if warm else "sync", "rounds_static")
    eng.close()
    print("profile " + json.dumps(row), flush=True)
    return row


def _spread(values) -> dict:
    return {"min": min(values), "median": float(np.median(values)),
            "max": max(values), "n": len(values)}


def drain_walls(engines: dict, make, rate, repeats: int = 5) -> dict:
    """Wall seconds of ``repeats`` drains of each engine, in turns (ABC,
    CBA, ...), each ending with its results on the host; ``make()`` gives
    fresh requests, ``rate(reqs, wall)`` the rate a drain reports.  One
    drain of each first, untimed.  Returns each engine's rates with their
    spread."""
    import torch

    names = list(engines)
    for name in names:
        engines[name].serve(make())
    out = {name: [] for name in names}
    for k in range(repeats):
        for name in (names if k % 2 == 0 else names[::-1]):
            reqs = make()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engines[name].serve(reqs)
            out[name].append(rate(reqs, time.perf_counter() - t0))
    return {name: _spread(v) for name, v in out.items()}


def same_served(got, want, what: str) -> None:
    """Two drains' results bit for bit: logits, labels, cycles, latency,
    energy (and energy a step)."""
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} results, want {len(want)}")
    for r, q in zip(got, want):
        if not (r.status == q.status == "done"
                and np.array_equal(r.logits, q.logits) and r.label == q.label
                and r.cycles == q.cycles and r.latency_ns == q.latency_ns
                and r.energy_pj == q.energy_pj
                and getattr(r, "energy_pj_per_step", None)
                == getattr(q, "energy_pj_per_step", None)):
            raise AssertionError(f"{what}: results differ")


class PlainForbidden:
    """Within the block, every wrapper's plain version raises: the path
    being driven must go through the kernels.  Every launch count is set to
    0 on entry; ``counts`` holds them all on exit."""

    #: (kernel module, its plain versions that the wrappers dispatch to)
    PLAIN = (
        ("repro_torch.kernels.lif_step.ops",
         ("lif_step_ref", "temporal_scan_ref")),
        ("repro_torch.kernels.cim_popcount.ops",
         ("esam_cascade_popcount_ref", "cim_popcount_ref",
          "esam_layer_popcount_ref")),
        ("repro_torch.kernels.cim_matmul_packed.ops",
         ("esam_layer_packed_ref", "cim_matmul_packed_ref")),
        ("repro_torch.kernels.cim_matmul.ops",
         ("cim_matmul_ref", "esam_layer_ref")),
        ("repro_torch.kernels.if_neuron.ops", ("if_neuron_ref",)),
        ("repro_torch.kernels.stdp.ops",
         ("stdp_column_epoch_ref", "stdp_epoch_masks_ref",
          "column_event_uniforms", "stdp_column_event_ref",
          "stdp_update_ref", "stdp_update_epoch_ref", "stdp_update_keys_ref",
          "stdp_update_masks_ref")),
        ("repro_torch.kernels.arbiter.ops",
         ("port_schedule_ref", "arbiter_ref")),
        ("repro_torch.kernels.telemetry.ops",
         ("tile_loads_ref", "request_stats_ref",
          "temporal_request_stats_ref", "stats_slab_ref")),
    )

    def __enter__(self):
        def forbid(*_a, **_k):
            raise AssertionError("a plain version ran on a CUDA path")

        self.mods = kernel_modules()
        self.saved = []
        for mod, (_, names) in zip(self.mods, self.PLAIN):
            for name in names:
                self.saved.append((mod, name, getattr(mod, name)))
                setattr(mod, name, forbid)
            mod.reset_launch_counts()
        return self

    def __exit__(self, *exc):
        self.counts = {}
        for mod in self.mods:
            self.counts.update(mod.launch_counts())
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return False

    def expect(self, what: str, want: dict) -> None:
        """Raise unless the counts are ``want`` (kernels not named: 0)."""
        full = {k: want.get(k, 0) for k in self.counts}
        if self.counts != full:
            raise AssertionError(f"{what}: launches {self.counts}, want {full}")


def check_served(net, spikes, requests, read_ports: int) -> None:
    """Served logits == the functional plan's on the card; per-request
    cycles == the float64 cost model's on the functional loads, energy and
    latency within 1e-6 relative (float32 device telemetry)."""
    import torch

    from repro_torch.core.esam import cost_model as cm

    res = net.plan(mode="functional", telemetry=True)(
        torch.from_numpy(spikes).cuda())
    want = res.logits.cpu().numpy()
    got = np.stack([r.logits for r in requests])
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"served logits {got.shape}, want {want.shape}")
    if not np.array_equal(got, want):
        raise AssertionError("served logits differ from the functional plan")
    labels = np.array([r.label for r in requests])
    if not np.array_equal(labels, want.argmax(-1)):
        raise AssertionError("served labels differ from the functional plan")
    rs = cm.request_stats(net.topology, [ld.cpu().numpy() for ld in res.loads],
                          read_ports)
    cycles = np.array([r.cycles for r in requests])
    if not np.array_equal(cycles, rs.cycles.astype(np.int64)):
        raise AssertionError("served cycles differ from the cost model")
    for key, ref in (("energy_pj", rs.energy_pj), ("latency_ns", rs.latency_ns)):
        got_v = np.array([getattr(r, key) for r in requests])
        rel = float(np.max(np.abs(got_v - ref) / np.abs(ref)))
        if rel > 1e-6:
            raise AssertionError(f"served {key} off by {rel:.3g} relative")


def paper_network(device, seed: int = 0, readout_vth: int = 2**31 - 1):
    """The paper topology with the reference's random test weights:
    ``bernoulli(fold_in(PRNGKey(seed), t), 0.5)`` per tile (the port's
    prng), hidden vth 0, the readout's ``readout_vth``, no offset.  Seed 0
    and a readout that never fires are the learning example's network;
    seed 1 and readout vth 0 are ``bench_system``'s measured sweep's."""
    import torch

    from repro_torch.core import prng
    from repro_torch.core.esam.network import EsamNetwork

    topo = PAPER_TOPOLOGY
    key = prng.PRNGKey(seed)
    bits = [prng.bernoulli(prng.fold_in(key, t), 0.5,
                           (topo[t], topo[t + 1])).to(torch.int8)
            for t in range(len(topo) - 1)]
    vth = [torch.zeros((n,), dtype=torch.int32) for n in topo[1:-1]]
    vth.append(torch.full((topo[-1],), readout_vth, dtype=torch.int32))
    return EsamNetwork(bits, vth, torch.zeros((topo[-1],)), device=device)


def train_twice(x, y, xe, ye):
    """train_online on the card (plain versions forbidden, launches counted)
    and on the CPU; raises unless weights, accuracies and update counts are
    the same.  Returns (card result, CPU result, card launch counts)."""
    import tempfile

    import torch

    from repro_torch.checkpoint import io as ckpt_io
    from repro_torch.core import prng
    from repro_torch.train.online import train_online

    results = {}
    for device in ("cuda", "cpu"):
        net = paper_network(device)
        with tempfile.TemporaryDirectory() as ckpt:
            kw = dict(epochs=LEARN_EPOCHS, key=prng.PRNGKey(10),
                      p_pot=LEARN_P_POT, p_dep=LEARN_P_DEP, eval_spikes=xe,
                      eval_labels=ye, shuffle=True, checkpoint_dir=ckpt)
            if device == "cuda":
                with PlainForbidden() as guard:
                    res = train_online(net, x, y, **kw)
                    torch.cuda.synchronize()
            else:
                res = train_online(net, x, y, **kw)
            step = ckpt_io.latest_step(ckpt)
            saved, manifest = ckpt_io.restore(
                {"weight_bits": res.network.weight_bits}, ckpt, step)
        if step != LEARN_EPOCHS or not torch.equal(
                saved["weight_bits"][-1], res.network.weight_bits[-1]):
            raise AssertionError(f"{device}: checkpoint step {step} does not "
                                 "hold the final readout")
        results[device] = res
    gpu, cpu = results["cuda"], results["cpu"]
    if not torch.equal(gpu.network.weight_bits[-1].cpu(),
                       cpu.network.weight_bits[-1]):
        raise AssertionError("learned readout differs between card and CPU")
    if gpu.accuracy != cpu.accuracy or gpu.n_updates != cpu.n_updates:
        raise AssertionError(f"card {gpu.accuracy} {gpu.n_updates} != CPU "
                             f"{cpu.accuracy} {cpu.n_updates}")
    hidden = len(PAPER_TOPOLOGY) - 2
    guard.expect("learning path", {
        "popcount_fire": 2 * hidden, "stdp_epoch_masks": LEARN_EPOCHS,
        "stdp_column_epoch": LEARN_EPOCHS})
    return gpu, cpu, guard.counts


def time_epochs(x, y, xe, ye, learned) -> list[dict]:
    """``train_online``'s epochs replayed on the card with their parts timed
    apart: host clock (synchronised) around the shuffle and the accuracy
    readout, CUDA events around the epoch's two launches (the masks kernel,
    which draws the uniforms, and the chain).  Raises unless the replay
    ends on ``learned`` (``[n_in, n_out]``).  Returns one dict of seconds an
    epoch."""
    import torch

    from repro_torch.core import prng
    from repro_torch.core.esam import learning
    from repro_torch.kernels.stdp import ops

    net = paper_network("cuda")
    pre = learning.last_hidden_spikes(net.weight_bits, net.vth, x)
    eval_pre = learning.last_hidden_spikes(net.weight_bits, net.vth, xe)
    dev = pre.device
    labels = torch.as_tensor(y).to(dev).long()
    eval_labels = torch.as_tensor(ye).to(dev)
    key = prng.PRNGKey(10).to(dev)
    bits_t = net.weight_bits[-1].T.contiguous()
    n_out, n = bits_t.shape[0], pre.shape[0]
    times = []
    for epoch in range(LEARN_EPOCHS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ep_key = prng.fold_in(key, epoch)
        perm = prng.permutation(prng.fold_in(ep_key, n), n)
        pre_e, y_e = pre[perm], labels[perm]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        slots = ops.stdp_epoch_masks(pre_e, y_e, ep_key, n_out,
                                     p_pot=LEARN_P_POT, p_dep=LEARN_P_DEP)
        ev[1].record()
        ops._epoch_chain(bits_t, slots, net.out_offset)
        ev[2].record()
        ev[2].synchronize()
        t2 = time.perf_counter()
        logits = learning.readout_vmem(bits_t, eval_pre).float()
        int(((logits + net.out_offset).argmax(-1) == eval_labels).sum())
        times.append({"shuffle_s": t1 - t0,
                      "kernel_s": ev[0].elapsed_time(ev[2]) / 1e3,
                      "masks_s": ev[0].elapsed_time(ev[1]) / 1e3,
                      "chain_s": ev[1].elapsed_time(ev[2]) / 1e3,
                      "readout_s": time.perf_counter() - t2})
    if not torch.equal(bits_t.T, learned):
        raise AssertionError("replayed epochs end on another readout")
    return times


def profiled(fn) -> dict:
    """``fn()`` once more under torch.profiler: the device time of every
    kernel it launched, their number and the busy share of that wall
    (profiler overhead included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    on_device = [e for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    device_s = sum(e.self_device_time_total for e in on_device) / 1e6
    top = sorted(on_device, key=lambda e: -e.self_device_time_total)[:6]
    return {"device_s": device_s, "profiled_wall_s": wall_s,
            "device_busy_share": device_s / wall_s,
            "device_launches": sum(e.count for e in on_device),
            "top": [{"name": e.key[:60], "count": e.count,
                     "device_ms": e.self_device_time_total / 1e3}
                    for e in top]}


#: the profiled learning epochs, and the profiles tried before failing
PROFILE_EPOCHS, PROFILE_ATTEMPTS = 3, 3
#: each learning-epoch kernel's wrapper and a fragment of its kernel name
EPOCH_KERNELS = {"stdp_epoch_masks": "epoch_masks_kernel",
                 "stdp_column_epoch": "column_epoch_kernel"}


def profile_learning(net, pre, y, n: int = LEARN_TRAIN) -> None:
    """Where a learning epoch's time goes: ``column_event_epoch`` on ``n``
    samples, ``PROFILE_EPOCHS`` times, under torch.profiler after one
    warm-up step of its schedule (one epoch, discarded); device time, busy
    share, launches.  The profile must hold every launch of the epoch's two
    kernels that their launch counters count: a profile that lost some is
    taken again, and after ``PROFILE_ATTEMPTS`` the phase fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.core import prng
    from repro_torch.core.esam import learning
    from repro_torch.kernels.stdp import ops as stdp_ops

    bits_t = net.weight_bits[-1].T.contiguous()
    key = prng.PRNGKey(10).cuda()

    def epoch():
        learning.column_event_epoch(bits_t, pre[:n], y[:n], key,
                                    p_pot=LEARN_P_POT, p_dep=LEARN_P_DEP,
                                    out_offset=net.out_offset)

    epoch()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            epoch()
            torch.cuda.synchronize()
            prof.step()
            stdp_ops.reset_launch_counts()
            t0 = time.perf_counter()
            for _ in range(PROFILE_EPOCHS):
                epoch()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            launched = stdp_ops.launch_counts()
            prof.step()
        # the schedule's step annotation carries its children's device time
        on_device = [e for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and not e.key.startswith("ProfilerStep")]
        seen = {k: sum(e.count for e in on_device if frag in e.key)
                for k, frag in EPOCH_KERNELS.items()}
        if all(seen[k] >= launched[k] > 0 for k in EPOCH_KERNELS):
            break
    else:
        raise AssertionError(f"learning profile: kernels {seen} in the "
                             f"profile, {launched} launched, after "
                             f"{PROFILE_ATTEMPTS} profiles")
    device_s = sum(e.self_device_time_total for e in on_device) / 1e6
    launches = sum(e.count for e in on_device)
    top = sorted(on_device, key=lambda e: -e.self_device_time_total)[:8]
    print("learning_profile " + json.dumps({
        "samples": n, "epochs": PROFILE_EPOCHS, "attempts": attempt,
        "device_s": device_s, "profiled_wall_s": wall_s,
        "device_busy_share": device_s / wall_s,
        "device_launches": launches,
        "epoch_kernels_seen": seen, "epoch_kernels_launched": {
            k: launched[k] for k in EPOCH_KERNELS},
        "launches_per_epoch": launches / PROFILE_EPOCHS,
        "top": [{"name": e.key[:60], "count": e.count,
                 "device_ms": e.self_device_time_total / 1e3} for e in top],
    }), flush=True)


def learning_phase() -> dict:
    """Phase 6; returns the launch counts of each learning path."""
    import torch

    from repro_torch.core import prng
    from repro_torch.core.esam import learning
    from repro_torch.data import digits

    x, y = digits.make_spike_dataset(LEARN_TRAIN, seed=3)
    xe, ye = digits.make_spike_dataset(LEARN_EVAL, seed=4)
    gpu, cpu, counts_train = train_twice(x, y, xe, ye)
    split = time_epochs(x, y, xe, ye, gpu.network.weight_bits[-1])
    c4, c0 = learning.column_update_cost(4), learning.column_update_cost(0)
    for epoch, (acc, n, sec, sec_cpu, parts) in enumerate(zip(
            gpu.accuracy, gpu.n_updates, gpu.epoch_s, cpu.epoch_s, split)):
        print("learning_epoch " + json.dumps({
            "epoch": epoch, "accuracy": acc, "column_updates": n,
            "wall_s": sec, "samples_per_s": LEARN_TRAIN / sec, **parts,
            "cpu_twin_wall_s": sec_cpu,
            "t_4r_us": n * (c4.read_ns + c4.write_ns) * 1e-3,
            "t_1rw_us": n * (c0.read_ns + c0.write_ns) * 1e-3,
            "e_4r_nj": n * c4.energy_pj * 1e-3,
            "e_1rw_nj": n * c0.energy_pj * 1e-3}), flush=True)
    print(f"learning path: {LEARN_TRAIN} samples x {LEARN_EPOCHS} epochs, "
          f"launches {counts_train}, accuracy {gpu.accuracy}, updates "
          f"{gpu.n_updates}, identical to the CPU twin; column update "
          f"1RW {c0.read_ns:.1f}/{c0.write_ns:.1f} ns, 1RW+4R "
          f"{c4.read_ns}/{c4.write_ns} ns ({c4.speedup_read_vs_1rw:.1f}x / "
          f"{c4.speedup_write_vs_1rw:.1f}x)", flush=True)

    # online_learning_epoch through the packed prefix (fused_fire_packed)
    out = {}
    for device in ("cuda", "cpu"):
        net = paper_network(device)
        with PlainForbidden() if device == "cuda" else nullcontext() as guard:
            t0 = time.perf_counter()
            bits, n = learning.online_learning_epoch(
                net.weight_bits, net.vth, x, y, prng.PRNGKey(10),
                p_pot=LEARN_P_POT, p_dep=LEARN_P_DEP)
            n = int(n)
            wall = time.perf_counter() - t0
        out[device] = (bits.cpu(), n, wall, guard)
    if not torch.equal(out["cuda"][0], out["cpu"][0]) or (
            out["cuda"][1] != out["cpu"][1]):
        raise AssertionError("online_learning_epoch differs card vs CPU")
    hidden = len(PAPER_TOPOLOGY) - 2
    guard = out["cuda"][3]
    guard.expect("online_learning_epoch", {
        "fused_fire_packed": hidden, "stdp_epoch_masks": 1,
        "stdp_column_epoch": 1})
    counts_epoch = guard.counts
    print(f"online_learning_epoch: {LEARN_TRAIN} samples, "
          f"{out['cuda'][1]} column updates, wall {out['cuda'][2]:.3f} s "
          f"(CPU twin {out['cpu'][2]:.3f} s), launches {counts_epoch}, "
          "identical to the CPU twin", flush=True)

    # the full-matrix plane with the matrix RNG: one stdp_update_epoch, at
    # SCAN_SAMPLES and LEARN_TRAIN samples, each against its CPU twin
    counts_scan = {}
    for n in (SCAN_SAMPLES, LEARN_TRAIN):
        for device in ("cuda", "cpu"):
            net = paper_network(device)
            pre = learning.last_hidden_spikes(net.weight_bits, net.vth, x[:n])

            def scan():
                bits, upd = learning.online_learning_epoch_scan(
                    net.weight_bits, net.vth, None, y[:n], prng.PRNGKey(11),
                    p_pot=LEARN_P_POT, p_dep=LEARN_P_DEP, pre_spikes=pre,
                    rng_scheme="matrix")
                return bits, int(upd)

            with (PlainForbidden() if device == "cuda"
                  else nullcontext()) as guard:
                t0 = time.perf_counter()
                bits, upd = scan()
                wall = time.perf_counter() - t0
            walls = [wall]
            if device == "cuda":
                for _ in range(3):
                    t0 = time.perf_counter()
                    scan()
                    walls.append(time.perf_counter() - t0)
                prof = profiled(scan)
            out[device] = (bits.cpu(), upd, walls, guard)
        if not torch.equal(out["cuda"][0], out["cpu"][0]) or (
                out["cuda"][1] != out["cpu"][1]):
            raise AssertionError(f"online_learning_epoch_scan differs card "
                                 f"vs CPU at {n} samples")
        guard = out["cuda"][3]
        guard.expect("scan path", {"stdp_update_keys": 1,
                                   "stdp_update_masks": 1,
                                   "stdp_update_chain": 1})
        for k, v in guard.counts.items():
            counts_scan[k] = counts_scan.get(k, 0) + v
        print("scan_epoch " + json.dumps({
            "samples": n, "column_updates": out["cuda"][1],
            "wall_s": out["cuda"][2], "cpu_twin_wall_s": out["cpu"][2][0],
            "launches": {k: v for k, v in guard.counts.items() if v},
            **prof}), flush=True)
    print(f"scan path (matrix RNG): {SCAN_SAMPLES} and {LEARN_TRAIN} samples, "
          f"launches {counts_scan}, identical to the CPU twin", flush=True)

    net = paper_network("cuda")
    pre = learning.last_hidden_spikes(net.weight_bits, net.vth, x)
    profile_learning(net, pre, torch.as_tensor(y).cuda())
    return {"train": counts_train, "epoch": counts_epoch, "scan": counts_scan}


def _traces_equal(got, want) -> bool:
    """TileTraces on the card against their CPU twins, every field: dtype,
    shape and values."""
    import torch

    return len(got) == len(want) and all(
        a.dtype == b.dtype and torch.equal(a.cpu(), b)
        for g, w in zip(got, want) for a, b in zip(g, w))


def quickstart_phase() -> dict:
    """The quickstart twin on the card: its launches, its cycle plan against
    the functional plan and the cost model's drain, and the whole network
    against its CPU twin."""
    import torch

    from repro_torch.core.esam.network import EsamNetwork
    from repro_torch.launch import quickstart

    with PlainForbidden() as guard:
        t0 = time.perf_counter()
        run = quickstart.main(["--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    guard.expect("quickstart", {"port_schedule": len(PAPER_TOPOLOGY) - 1,
                                "mega_cascade": 1})
    if run.net.topology != PAPER_TOPOLOGY or not run.packed_equal:
        raise AssertionError(f"quickstart: topology {run.net.topology}, "
                             f"packed == functional {run.packed_equal}")
    if not torch.equal(run.sample_logits, run.logits[0]):
        raise AssertionError("cycle plan logits differ from the functional "
                             "plan's")
    drains = [int(np.ceil(ld[0].cpu().numpy() / 4).max()) for ld in run.loads]
    if run.cycles != drains:
        raise AssertionError(f"cycles per tile {run.cycles} != max "
                             f"ceil(load / 4) {drains}")
    if not run.snn_accuracy > 0.8:
        raise AssertionError(f"SNN accuracy {run.snn_accuracy} <= 0.8")
    # the converted network on the CPU: same logits, loads and traces
    cpu = EsamNetwork.from_numpy(*run.net.to_numpy(), device="cpu")
    res = cpu.plan(mode="functional", telemetry=True)(
        torch.from_numpy(run.spikes != 0))
    one = cpu.plan(mode="cycle", read_ports=4)(
        torch.from_numpy(run.spikes[0] != 0))
    if not (torch.equal(res.logits, run.logits.cpu())
            and all(torch.equal(a, b.cpu())
                    for a, b in zip(res.loads, run.loads))
            and _traces_equal(run.traces, one.traces)):
        raise AssertionError("quickstart network differs card vs CPU")
    print("quickstart " + json.dumps({
        "bnn_accuracy": run.bnn_accuracy, "snn_accuracy": run.snn_accuracy,
        "cycles_per_tile": run.cycles, "wall_s": wall,
        "speedup_ref": run.speedup, "energy_eff_ref": run.energy_eff,
        "fig8_measured": [{"cell": st.cell,
                           "minf_s": st.throughput_inf_s / 1e6,
                           "pj_per_inf": st.energy_pj_per_inf,
                           "mw": st.power_mw} for st in run.fig8],
        "launches": guard.counts}), flush=True)
    return guard.counts


def profile_sweep(net, spikes) -> None:
    """Where the sweep's time goes: one more ``port_sweep`` under
    torch.profiler; device time per kernel and the device's busy share of
    that same profiled call's wall time (profiler overhead included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        net.port_sweep(spikes, SWEEP_OPTIONS)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    on_device = [e for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    device_s = sum(e.self_device_time_total for e in on_device) / 1e6
    top = sorted(on_device, key=lambda e: -e.self_device_time_total)[:10]
    print("sweep_profile " + json.dumps({
        "digits": int(spikes.shape[0]), "device_s": device_s,
        "profiled_wall_s": wall_s, "device_busy_share": device_s / wall_s,
        "device_launches": sum(e.count for e in on_device),
        "top": [{"name": e.key[:60], "count": e.count,
                 "device_ms": e.self_device_time_total / 1e3} for e in top],
    }), flush=True)


def cycle_phase() -> dict:
    """Phase 7; returns the launch counts of each cycle-plane path."""
    import dataclasses

    import torch

    from repro_torch.core.esam.network import system_stats
    from repro_torch.data import digits

    counts = {"quickstart": quickstart_phase()}

    # the measured Fig 8 sweep, on the card and on the CPU
    x, _ = digits.make_spike_dataset(SWEEP_DIGITS, seed=3)
    spikes = torch.from_numpy(x != 0)
    out = {}
    for device in ("cuda", "cpu"):
        net = paper_network(device, seed=1, readout_vth=0)
        s = spikes.to(device)
        with PlainForbidden() if device == "cuda" else nullcontext() as guard:
            t0 = time.perf_counter()
            sweep = net.port_sweep(s, SWEEP_OPTIONS)
            if device == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        net.port_sweep(s, SWEEP_OPTIONS)
        if device == "cuda":
            torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        func = net.plan(mode="functional")(s).logits
        for p in SWEEP_OPTIONS:
            if not torch.equal(sweep[p][0], func):
                raise AssertionError(f"{device} sweep option {p}: logits "
                                     "differ from the functional plan's")
        act = net.measured_activity(x, traces=sweep[4][1])
        stats = [system_stats(PAPER_TOPOLOGY, act, p) for p in SWEEP_OPTIONS]
        out[device] = (net, sweep, stats, wall, warm, guard)
    gpu, cpu = out["cuda"], out["cpu"]
    gpu[5].expect("sweep", {
        "port_schedule": len(SWEEP_PORT_COUNTS) * (len(PAPER_TOPOLOGY) - 1)})
    counts["sweep"] = gpu[5].counts
    for p in SWEEP_OPTIONS:
        if not (torch.equal(gpu[1][p][0].cpu(), cpu[1][p][0])
                and _traces_equal(gpu[1][p][1], cpu[1][p][1])):
            raise AssertionError(f"sweep option {p} differs card vs CPU")
    if [dataclasses.asdict(a) for a in gpu[2]] != [
            dataclasses.asdict(b) for b in cpu[2]]:
        raise AssertionError("system stats differ card vs CPU")
    print("sweep " + json.dumps({
        "digits": SWEEP_DIGITS, "options": list(SWEEP_OPTIONS),
        "wall_s": gpu[3], "warm_wall_s": gpu[4], "cpu_twin_wall_s": cpu[3],
        "cpu_twin_warm_wall_s": cpu[4], "launches": counts["sweep"],
        "fig8_measured": [{"cell": st.cell,
                           "cycles_per_tile": st.cycles_per_tile,
                           "minf_s": st.throughput_inf_s / 1e6,
                           "pj_per_inf": st.energy_pj_per_inf,
                           "mw": st.power_mw} for st in gpu[2]],
        "speedup_4r": gpu[2][4].throughput_inf_s / gpu[2][0].throughput_inf_s,
        "energy_eff_4r": gpu[2][0].energy_pj_per_inf
        / gpu[2][4].energy_pj_per_inf}), flush=True)
    profile_sweep(gpu[0], spikes.cuda())

    # the per-cycle V_mem trace at 1 and 4 ports, against the CPU twin
    sub = spikes[:TRACE_DIGITS]
    with PlainForbidden() as guard:
        got = {p: gpu[0].plan(mode="cycle", read_ports=p,
                              record_vmem_trace=True)(sub.cuda())
               for p in (1, 4)}
        torch.cuda.synchronize()
    guard.expect("trace", {"port_schedule": 2 * (len(PAPER_TOPOLOGY) - 1)})
    counts["trace"] = guard.counts
    for p in (1, 4):
        want = cpu[0].plan(mode="cycle", read_ports=p,
                           record_vmem_trace=True)(sub)
        if not (torch.equal(got[p].logits.cpu(), want.logits)
                and _traces_equal(got[p].traces, want.traces)):
            raise AssertionError(f"V_mem trace at p={p} differs card vs CPU")
    print(f"trace: {TRACE_DIGITS} digits at 1 and 4 ports, per-cycle V_mem "
          f"{tuple(got[1].traces[0].vmem_trace.shape)} and "
          f"{tuple(got[4].traces[0].vmem_trace.shape)} on tile 0, "
          f"launches {counts['trace']}, identical to the CPU twin",
          flush=True)
    return counts


def _event_rounds(requests, max_batch: int) -> int:
    """Rounds of one event drain: streams that share T go out in rounds of
    at most ``max_batch``."""
    by_t: dict[int, int] = {}
    for r in requests:
        by_t[r.n_steps] = by_t.get(r.n_steps, 0) + 1
    return sum(-(-n // max_batch) for n in by_t.values())


def profile_events(net, requests, temporal, warm: bool = False) -> dict:
    """Where an event drain's time goes: the timed streams served once more
    under torch.profiler, by the synchronous drain or (``warm``) a warmed,
    overlapped engine (``profile_drain``), with each round's device
    operations split into the scan, tile 0's MAC and the rest; prints an
    ``events_profile`` line."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import EventRequest, SpikeEngine

    kw = dict(fuse_rounds="auto", overlap=True) if warm else {}
    eng = SpikeEngine(net, max_batch=EVENT_BATCH, telemetry=True,
                      temporal=temporal, device="cuda", **kw)
    if warm:
        eng.warmup(event_ts=EVENT_STEPS)
    reqs = [EventRequest(events=r.events) for r in requests]
    rounds = _event_rounds(reqs, EVENT_BATCH)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.serve([EventRequest(events=r.events) for r in requests])
        torch.cuda.synchronize()
    # a round's device work: the scan (either of temporal_scan's kernels),
    # tile 0's MAC (popcount_mac runs the popcount_fire kernel), and the
    # rest (tile 0's loads, the offset add, the cost model, copies)
    split = {"scan": 0, "tile0": 0, "rest": 0}
    split_ms = dict.fromkeys(split, 0.0)
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        part = ("scan" if "temporal_scan" in e.key
                or "scan_regs_kernel" in e.key else
                "tile0" if "popcount_fire" in e.key else "rest")
        split[part] += e.count
        split_ms[part] += e.self_device_time_total / 1e3
    row = profile_drain(eng, reqs, "warmed" if warm else "sync",
                        "rounds_event")
    eng.close()
    if row["rounds"] != rounds:
        raise AssertionError(f"profiled event drain: {row['rounds']} rounds,"
                             f" want {rounds}")
    row.update({
        "streams": len(reqs), "timesteps": sum(r.n_steps for r in reqs),
        "launches_per_round_split": {k: v / rounds for k, v in split.items()},
        "device_ms_split": split_ms})
    print("events_profile " + json.dumps(row), flush=True)
    return row


def events_phase() -> dict:
    """Phase 8: the event path on the card, its launches, its streams
    against the CPU twin and the float64 cost model, the T=1 identity."""
    import dataclasses

    import torch

    from repro_torch.core import packing
    from repro_torch.core.esam import cost_model as cm
    from repro_torch.core.esam.network import EsamNetwork
    from repro_torch.core.esam.temporal import temporal_forward_naive
    from repro_torch.launch import serve as serve_mod
    from repro_torch.serve.engine import EventRequest, SpikeEngine

    with PlainForbidden() as guard:
        run = serve_mod.main(["--events", "--device", "cuda"])
        torch.cuda.synchronize()
    eng, st = run.engine, run.engine.stats()
    warm_rounds = _event_rounds(run.warm_requests, eng.max_batch)
    rounds = _event_rounds(run.requests, eng.max_batch)
    if (run.net.topology != PAPER_TOPOLOGY or eng.max_batch != EVENT_BATCH
            or eng._temporal.leak != EVENT_LEAK or st["rounds_event"] != rounds
            or run.warm_engine.stats()["rounds_event"] != warm_rounds):
        raise AssertionError(f"event path: topology {run.net.topology}, "
                             f"max_batch {eng.max_batch}, {eng._temporal}, "
                             f"rounds {st['rounds_event']} != {rounds}")
    # one tile-0 MAC, one scan, tile 0's loads and the cost model a round;
    # no single LIF step
    all_rounds = warm_rounds + rounds
    guard.expect("event path", {"temporal_scan": all_rounds,
                                "popcount_mac": all_rounds,
                                "tile_loads": all_rounds,
                                "request_stats": all_rounds})

    # the same streams on the CPU (the plain versions)
    cpu_net = EsamNetwork.from_numpy(*run.net.to_numpy(), device="cpu")
    cpu_eng = SpikeEngine(cpu_net, max_batch=EVENT_BATCH, telemetry=True,
                          temporal=eng._temporal, device="cpu")
    cpu_reqs = [EventRequest(events=r.events) for r in run.requests]
    t0 = time.perf_counter()
    cpu_eng.serve(cpu_reqs)
    cpu_wall = time.perf_counter() - t0
    for r, q in zip(run.requests, cpu_reqs):
        if not (np.isfinite(r.logits).all() and r.logits.shape == (10,)
                and np.array_equal(r.logits, q.logits) and r.label == q.label
                and r.served_steps == q.served_steps == r.n_steps
                and r.cycles == q.cycles):
            raise AssertionError("event stream differs card vs CPU")
    # cycles and energy against the float64 model of the plan's loads
    by_t: dict[int, list] = {}
    for r in run.requests:
        by_t.setdefault(r.n_steps, []).append(r)
    worst = 0.0
    for t, reqs in by_t.items():
        cfg = dataclasses.replace(eng._temporal, n_steps=t)
        words = np.stack([r.events for r in reqs], axis=1)
        res = run.net.plan(mode="temporal", temporal=cfg, telemetry=True)(
            packing.words_from_np(words).cuda())
        rs = cm.temporal_request_stats(
            PAPER_TOPOLOGY, [ld.cpu().numpy() for ld in res.loads], 4)
        if not np.array_equal([r.cycles for r in reqs], rs["cycles"]):
            raise AssertionError(f"T={t}: served cycles differ from the model")
        for key in ("energy_pj", "latency_ns", "energy_pj_per_step"):
            got = np.array([getattr(r, key) for r in reqs])
            worst = max(worst, float(np.max(np.abs(got - rs[key])
                                            / np.abs(rs[key]))))
        if not np.array_equal(np.stack([r.logits for r in reqs]),
                              res.logits.cpu().numpy()):
            raise AssertionError(f"T={t}: served logits differ from the plan")
    if worst > 1e-6:
        raise AssertionError(f"event energy off by {worst:.3g} relative")

    # the plain per-step oracle on the card (temporal_forward_naive: dense
    # tiles and lif_step_ref, no kernel) on each T's streams
    t0 = time.perf_counter()
    for t, reqs in by_t.items():
        cfg = dataclasses.replace(eng._temporal, n_steps=t)
        spikes = packing.unpack_spikes_np(
            np.stack([r.events for r in reqs], axis=1), PAPER_TOPOLOGY[0])
        naive = temporal_forward_naive(run.net, spikes, cfg)
        if not np.array_equal(np.stack([r.logits for r in reqs]), naive):
            raise AssertionError(f"T={t}: served logits differ from the "
                                 "per-step oracle")
    torch.cuda.synchronize()
    oracle_wall = time.perf_counter() - t0

    # T=1, no leak, reset to zero: the packed plan's logits
    first = [EventRequest(events=r.events[:1]) for r in
             run.requests[:EVENT_BATCH]]
    with PlainForbidden() as guard1:
        SpikeEngine(run.net, max_batch=EVENT_BATCH, device="cuda").serve(first)
        torch.cuda.synchronize()
    guard1.expect("T=1 round", {"temporal_scan": 1, "popcount_mac": 1})
    packed = run.net.plan(mode="packed")(packing.words_from_np(
        np.stack([r.events[0] for r in first])).cuda()).logits.cpu().numpy()
    if not np.array_equal(np.stack([r.logits for r in first]), packed):
        raise AssertionError("T=1 event round differs from the packed plan")

    # the same streams through the reference launcher's serving defaults
    # (fused, overlapped), cold and warmed (one CUDA graph a (bucket, T)),
    # each on its own copy of the network (graphs live on its plans)
    kw = dict(max_batch=EVENT_BATCH, telemetry=True, temporal=eng._temporal,
              device="cuda", fuse_rounds="auto", overlap=True)
    bits = run.net.to_numpy()
    cold = SpikeEngine(EsamNetwork.from_numpy(*bits, device="cuda"), **kw)
    warm = SpikeEngine(EsamNetwork.from_numpy(*bits, device="cuda"), **kw)
    with PlainForbidden() as cold_guard:
        cold_reqs = [EventRequest(events=r.events) for r in run.requests]
        cold.serve(cold_reqs)
        torch.cuda.synchronize()
    cold_guard.expect("overlapped event path", {
        k: rounds for k in ("temporal_scan", "popcount_mac", "tile_loads",
                            "request_stats")})
    with PlainForbidden() as warm_guard:
        wt = warm.warmup(event_ts=EVENT_STEPS)
        replays0 = warm.graph_counts()["replays"]
        warm_reqs = [EventRequest(events=r.events) for r in run.requests]
        warm.serve(warm_reqs)
        torch.cuda.synchronize()
    n_b = len(warm._buckets)
    gc = warm.graph_counts()
    if (wt["graphs"] != n_b * (1 + len(EVENT_STEPS))
            or gc["captures"] != wt["graphs"]
            or gc["replays"] - replays0 != rounds):
        raise AssertionError(f"warmed event path: warmup {wt['graphs']} "
                             f"graphs, counts {gc}, {rounds} rounds")
    same_served(cold_reqs, run.requests, "overlapped event drain")
    same_served(warm_reqs, run.requests, "warmed event drain")

    def make():
        return [EventRequest(events=r.events) for r in run.requests]

    warm_sync = SpikeEngine(EsamNetwork.from_numpy(*bits, device="cuda"),
                            max_batch=EVENT_BATCH, telemetry=True,
                            temporal=eng._temporal, device="cuda")
    warm_sync.warmup(event_ts=EVENT_STEPS)
    walls = drain_walls(
        {"sync": run.engine, "overlapped": cold, "warmed": warm,
         "warmed_sync": warm_sync}, make,
        lambda reqs, wall: sum(r.n_steps for r in reqs) / wall)
    same_served(warm_sync.serve(make()), run.requests, "warmed sync drain")
    cold.close()
    warm.close()
    rest = run.wall_s - st["host_pack_s_total"] - st["dispatch_s_total"]
    print("events_drains " + json.dumps({
        "steps_per_s": walls, "warmup_s": wt["total_s"],
        "graphs": wt["graphs"], "graph_counts": gc,
        "warm_launches": warm_guard.counts}), flush=True)
    print("events " + json.dumps({
        "streams": len(run.requests), "rounds": st["rounds_event"],
        "timesteps": st["timesteps_total"], "wall_s": run.wall_s,
        "steps_per_s": st["timesteps_total"] / run.wall_s,
        "input_spikes_per_s": run.input_spikes / run.wall_s,
        "pj_per_timestep": st["energy_pj_per_timestep"],
        "pj_per_stream": st["event_energy_pj_mean"],
        "host_pack_s": st["host_pack_s_total"],
        "dispatch_s": st["dispatch_s_total"], "flush_and_rest_s": rest,
        "cpu_twin_wall_s": cpu_wall, "energy_max_rel_err": worst,
        "per_step_oracle_wall_s": oracle_wall,
        "launches": guard.counts}), flush=True)
    sync_prof = profile_events(run.net, run.requests, eng._temporal)
    warm_prof = profile_events(EsamNetwork.from_numpy(*bits, device="cuda"),
                               run.requests, eng._temporal, warm=True)
    check_round_launches("event", sync_prof, warm_prof, 8)
    return guard.counts


class PackerWait:
    """Within the block, the caller's waits on every engine's packer thread
    (the overlapped drain's ``fut.result()``) are timed into
    ``waits[id(engine)]``.  ``stats()`` keeps the reference's definitions
    (``host_pack_s_total`` is time on the packer thread, in parallel with
    the caller's dispatch); this wait is what the caller lost to it."""

    def __enter__(self):
        from repro_torch.serve import engine as engine_mod

        self.cls = engine_mod.SpikeEngine
        self.orig = orig = self.cls._packer_pool
        waits = self.waits = {}

        class Timed:
            def __init__(self, fut, key):
                self.fut, self.key = fut, key

            def result(self):
                t0 = time.perf_counter()
                try:
                    return self.fut.result()
                finally:
                    waits[self.key] = (waits.get(self.key, 0.0)
                                       + time.perf_counter() - t0)

            def cancel(self):
                return self.fut.cancel()

        class Pool:
            def __init__(self, pool, key):
                self.pool, self.key = pool, key

            def submit(self, fn, *args, **kwargs):
                return Timed(self.pool.submit(fn, *args, **kwargs), self.key)

        self.cls._packer_pool = lambda eng: Pool(orig(eng), id(eng))
        return self

    def __exit__(self, *exc):
        self.cls._packer_pool = self.orig
        return False


def host_split(engines: dict, make) -> dict:
    """One more drain of each engine, its wall split on the caller's
    thread: the pack (synchronous drains) or the wait on the packer
    (overlapped drains; the pack itself runs on the packer thread and is
    reported beside), the dispatch, and the flush and the rest.  The parts
    on the caller's thread add up to the wall; raises if the rest is
    negative."""
    import torch

    out = {}
    with PackerWait() as pw:
        for name, eng in engines.items():
            reqs = make()
            st0 = eng.stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.serve(reqs)
            wall = time.perf_counter() - t0
            st1 = eng.stats()
            pack = st1["host_pack_s_total"] - st0["host_pack_s_total"]
            dispatch = st1["dispatch_s_total"] - st0["dispatch_s_total"]
            wait = pw.waits.get(id(eng), 0.0)
            on_caller = wait if st1["overlap"] else pack
            rest = wall - on_caller - dispatch
            if rest < 0:
                raise AssertionError(f"{name} drain: wall {wall} < its parts "
                                     f"{on_caller} + {dispatch}")
            out[name] = {
                "wall_s": wall, "host_pack_s": pack,
                "pack_on": "packer" if st1["overlap"] else "caller",
                "packer_wait_s": wait, "dispatch_s": dispatch,
                "flush_and_rest_s": rest,
                "rounds": st1["rounds_static"] - st0["rounds_static"]}
    return out


def serving_phase() -> dict:
    """Phase 4: the main path as the reference's launcher serves it
    (overlapped packer, fuse auto), then the same requests warmed (one CUDA
    graph a bucket) and through the synchronous drain, all against one
    another and the functional plan; req/s with its spread; the
    synchronous and warmed drains profiled.  Returns the main path's
    launch counts."""
    import torch  # noqa: F401

    from repro_torch.core.esam.network import EsamNetwork
    from repro_torch.launch import serve as serve_mod
    from repro_torch.serve.engine import SpikeEngine, SpikeRequest

    esam = ["--esam", "--requests", str(SERVE_REQUESTS), "--device", "cuda"]
    telemetry_kernels = ("mega_cascade", "tile_loads", "request_stats")
    with PlainForbidden() as guard:
        run = serve_mod.main(esam)
    st = run.engine.stats()
    rounds = run.warm_rounds + st["rounds_static"]
    guard.expect("serving path", dict.fromkeys(telemetry_kernels, rounds))
    if (run.net.topology != PAPER_TOPOLOGY or not st["overlap"]
            or st["fuse_rounds"] != 1):
        raise AssertionError(f"served topology {run.net.topology}, "
                             f"overlap {st['overlap']}, fuse "
                             f"{st['fuse_rounds']}")
    check_served(run.net, run.spikes, run.requests, 4)
    main_counts = dict(guard.counts)
    print(f"main path: {len(run.requests)} requests, {rounds} rounds, "
          f"launches {guard.counts}, "
          f"{len(run.requests) / run.wall_s:.1f} req/s wall, "
          f"model {st['throughput_pipelined_inf_s'] / 1e6:.3f} MInf/s, "
          f"{st['energy_pj_per_inf']:.3f} pJ/Inf", flush=True)
    with PlainForbidden() as warm_guard:
        warm_run = serve_mod.main(esam + ["--warmup"])
    wst, weng = warm_run.engine.stats(), warm_run.engine
    n_b = len(weng._buckets)
    # warmup: each bucket once eagerly, its capture, the cost model's eager
    # pass; the served rounds are replays only
    warm_guard.expect("warmed serving path",
                      dict.fromkeys(telemetry_kernels, 3 * n_b))
    if (warm_run.warmup["graphs"] != n_b
            or weng.graph_counts() != {"captures": n_b,
                                       "replays": wst["rounds_static"]}):
        raise AssertionError(f"warmed path: {warm_run.warmup['graphs']} "
                             f"graphs for {n_b} buckets, counts "
                             f"{weng.graph_counts()}, "
                             f"{wst['rounds_static']} rounds")
    with PlainForbidden() as sync_guard:
        sync_run = serve_mod.main(esam + ["--no-overlap", "--fuse", "off"])
    sync_rounds = sync_run.warm_rounds + sync_run.engine.stats()[
        "rounds_static"]
    sync_guard.expect("synchronous serving path",
                      dict.fromkeys(telemetry_kernels, sync_rounds))
    same_served(warm_run.requests, run.requests, "warmed drain")
    same_served(sync_run.requests, run.requests, "synchronous drain")
    check_served(warm_run.net, warm_run.spikes, warm_run.requests, 4)
    bits = run.net.to_numpy()
    cold_net = EsamNetwork.from_numpy(*bits, device="cuda")
    engines = {
        "sync": SpikeEngine(cold_net, max_batch=BUCKET, telemetry=True,
                            device="cuda"),
        "overlapped": SpikeEngine(cold_net, max_batch=BUCKET,
                                  telemetry=True, device="cuda",
                                  fuse_rounds="auto", overlap=True),
        "warmed": SpikeEngine(EsamNetwork.from_numpy(*bits, device="cuda"),
                              max_batch=BUCKET, telemetry=True,
                              device="cuda", fuse_rounds="auto",
                              overlap=True)}
    # the graphs without the packer thread: a warmed synchronous drain
    engines["warmed_sync"] = SpikeEngine(
        EsamNetwork.from_numpy(*bits, device="cuda"), max_batch=BUCKET,
        telemetry=True, device="cuda")
    engines["warmed"].warmup()
    engines["warmed_sync"].warmup()
    walls = drain_walls(
        engines, lambda: [SpikeRequest(spikes=x) for x in run.spikes],
        lambda reqs, wall: len(reqs) / wall)
    same_served(engines["warmed_sync"].serve(
        [SpikeRequest(spikes=x) for x in run.spikes]), run.requests,
        "warmed synchronous drain")
    sync_prof = profile_serve(run.net, run.spikes)
    warm_prof = profile_serve(
        EsamNetwork.from_numpy(*bits, device="cuda"), run.spikes, warm=True)
    check_round_launches("static", sync_prof, warm_prof, 6)
    print("main path drains " + json.dumps({
        "req_per_s": walls,
        "launcher_req_per_s": {
            "overlapped": run.timed / run.wall_s,
            "warmed": warm_run.timed / warm_run.wall_s,
            "sync": sync_run.timed / sync_run.wall_s},
        "first_request_ms": warm_run.first_request_ms,
        "warmup_s": warm_run.warmup["total_s"], "graphs": n_b,
        "warm_launches": warm_guard.counts,
        "sync_launches": sync_guard.counts}), flush=True)
    print("main path host split: " + json.dumps(host_split(
        engines, lambda: [SpikeRequest(spikes=x) for x in run.spikes])),
        flush=True)
    for eng in engines.values():
        eng.close()

    return main_counts


def serving_spikes() -> np.ndarray:
    """The main path's digit traffic (the launcher's, at its seed)."""
    from repro_torch.data import digits

    return digits.make_spike_dataset(SERVE_REQUESTS, seed=0)[0]


def phase_timer():
    """A function that prints, at each call, the wall seconds since the
    last call (or since this one) as a ``phase_wall`` line."""
    last = [time.perf_counter()]

    def lap(phase: str) -> None:
        now = time.perf_counter()
        print("phase_wall " + json.dumps({"phase": phase,
                                          "s": now - last[0]}), flush=True)
        last[0] = now

    return lap


def kernel_modules() -> list:
    """Every kernel wrapper module (each keeps its launch counters)."""
    import importlib

    return [importlib.import_module(m) for m, _ in PlainForbidden.PLAIN]


def bench_phase() -> dict:
    """Phase 9: the kernel bench path (``launch.bench_kernels.run``) on the
    card, every launch counter held to the calls the bench reports.  The
    bench times the plain versions by name on its ``_plain`` lane, so no
    plain version is forbidden here."""
    import torch

    from repro_torch.launch import bench_kernels

    mods = kernel_modules()
    for mod in mods:
        mod.reset_launch_counts()
    t0 = time.perf_counter()
    res = bench_kernels.run(device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {}
    for mod in mods:
        counts.update(mod.launch_counts())
    want = {k: res.launches.get(k, 0) for k in counts}
    if counts != want or set(res.launches) - set(counts):
        raise AssertionError(f"bench path: launches {counts}, the bench "
                             f"reports {res.launches}")
    floor = next(r for r in res.rows
                 if r["name"] == "kernel_popcount_speedup_vs_packed")
    print("bench " + json.dumps({
        "rows": len(res.rows), "wall_s": wall, "launches": counts,
        "speedups": res.speedups, "floor": bench_kernels.SPEEDUP_FLOOR,
        "floor_row": floor["derived"]}), flush=True)
    return counts


# ------------------------------------------------------------------ #
# the fault plane (phase 10)
# ------------------------------------------------------------------ #
#: the fault populations the phase draws (the reference's tests' and
#: bench's seeds and rates): every class, stuck-at, dead columns with and
#: without spares, threshold variation, read-disturb at a raised V_prech
FAULT_MODELS = {
    "all": dict(seed=5, stuck0_rate=0.08, stuck1_rate=0.06,
                dead_col_rate=0.1, vth_sigma=1.0, read_disturb=0.01,
                spare_cols=3),
    "stuck": dict(seed=11, stuck0_rate=0.05, stuck1_rate=0.05),
    "dead": dict(seed=5, dead_col_rate=0.4),
    "remap": dict(seed=5, dead_col_rate=0.4, spare_cols=96),
    "vth": dict(seed=9, vth_sigma=2.5),
    "disturb": dict(seed=11, read_disturb=0.01, v_prech=0.6),
}
#: the models whose plans run in all five modes, and the served one
FAULT_PLAN_MODELS = ("all", "disturb")
FAULT_SERVE_MODEL = "all"
#: the faulted temporal plan's steps
FAULT_EVENT_STEPS = 4
#: launches of one call of each faulted plan mode on the card (telemetry
#: on; the cycle plan is the Fig 8 sweep: 4 port counts x 4 tiles)
FAULT_PLAN_LAUNCHES = {
    "functional": {},
    "packed": {"mega_cascade": 1, "tile_loads": 1},
    "prefix": {"popcount_fire": len(PAPER_TOPOLOGY) - 2},
    "cycle": {"port_schedule": len(SWEEP_PORT_COUNTS)
              * (len(PAPER_TOPOLOGY) - 1)},
    "temporal": {"popcount_mac": 1, "temporal_scan": 1, "tile_loads": 1},
}


def _same(got, want) -> bool:
    """A plan result's field on the card against its CPU twin: tensors
    (dtype and values), tuples, TileTraces, sweep dicts, None."""
    import torch

    if isinstance(want, torch.Tensor):
        return (isinstance(got, torch.Tensor) and got.dtype == want.dtype
                and torch.equal(got.cpu(), want))
    if isinstance(want, dict):
        return got.keys() == want.keys() and all(
            _same(got[k], want[k]) for k in want)
    if want is None:
        return got is None
    return len(got) == len(want) and all(
        _same(a, b) for a, b in zip(got, want))


def fault_masks_check() -> None:
    """Every model's masks drawn on the card and on the CPU, at the sweep's
    four port counts, bit for bit; the normal draw's ulp card vs CPU."""
    import torch

    from repro_torch.core import prng
    from repro_torch.core.esam import faults
    from repro_torch.core.esam.faults import FaultModel

    cells = {}
    for name, fields in FAULT_MODELS.items():
        fm = FaultModel(**fields)
        t0 = time.perf_counter()
        gpu = fm.build_masks(PAPER_TOPOLOGY, SWEEP_PORT_COUNTS, device="cuda")
        torch.cuda.synchronize()
        draw_s = time.perf_counter() - t0
        cpu = fm.build_masks(PAPER_TOPOLOGY, SWEEP_PORT_COUNTS)
        if not _same(gpu, cpu):
            raise AssertionError(f"fault masks {name}: card != CPU")
        cells[name] = {"faulty_cells": faults.faulty_cells(cpu),
                       "draw_s": draw_s}
    z = prng.normal(prng.PRNGKey(3, device="cuda"), (65536,)).cpu()
    zc = prng.normal(prng.PRNGKey(3), (65536,))
    ulp = (z.view(torch.int32).long() - zc.view(torch.int32).long()).abs()
    if int(ulp.max()) > 3:
        raise AssertionError(f"normal draws {int(ulp.max())} ulp card vs CPU")
    print("faults masks " + json.dumps({
        "models": cells, "ports": list(SWEEP_PORT_COUNTS),
        "normal_max_ulp_card_vs_cpu": int(ulp.max()),
        "normal_differ_share": float((ulp != 0).float().mean())}),
        flush=True)


def fault_plans_check(net, net_cpu, x) -> dict:
    """Faulted plans of all five modes on ``x`` (the main path's 4096
    digits; T shifted copies for the temporal plan), on the card (plain
    versions forbidden, launches counted) against their CPU twins, every
    field; functional == packed on the card.  Returns the launches a mode
    summed over the models."""
    import torch

    from repro_torch.core.esam.faults import FaultModel
    from repro_torch.core.esam.temporal import TemporalConfig

    counts: dict = {}
    rows = []
    for name in FAULT_PLAN_MODELS:
        fm = FaultModel(**FAULT_MODELS[name])
        logits = {}
        for mode, want_launches in FAULT_PLAN_LAUNCHES.items():
            kw = dict(mode=mode, telemetry=True, faults=fm)
            inp = x
            if mode == "cycle":
                kw["read_ports"] = SWEEP_OPTIONS
            elif mode == "temporal":
                kw["temporal"] = TemporalConfig(n_steps=FAULT_EVENT_STEPS,
                                                leak=EVENT_LEAK)
                inp = torch.stack([x.roll(t, 0)
                                   for t in range(FAULT_EVENT_STEPS)])
            else:
                kw["collect"] = True
            walls = []
            with PlainForbidden() as guard:
                for _ in range(2):       # the first call builds the plan
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    got = net.plan(**kw)(inp.cuda())
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t0)
            guard.expect(f"faulted {mode} plan ({name})", {
                k: 2 * v for k, v in want_launches.items()})
            for k, v in guard.counts.items():
                counts[k] = counts.get(k, 0) + v
            t0 = time.perf_counter()
            want = net_cpu.plan(**kw)(inp)
            cpu_s = time.perf_counter() - t0
            for field in ("logits", "planes", "loads", "prefix", "traces",
                          "sweep"):
                if not _same(getattr(got, field), getattr(want, field)):
                    raise AssertionError(f"faulted {mode} plan ({name}): "
                                         f"{field} card != CPU")
            logits[mode] = got.logits
            rows.append({"model": name, "mode": mode, "build_and_run_s":
                         walls[0], "run_s": walls[1], "cpu_twin_s": cpu_s,
                         "launches": {k: v for k, v in guard.counts.items()
                                      if v}})
        if not torch.equal(logits["functional"], logits["packed"]):
            raise AssertionError(f"faulted functional != packed ({name})")
        if torch.equal(logits["functional"],
                       net.plan(mode="functional")(x.cuda()).logits):
            raise AssertionError(f"{name} faults left the logits unchanged")
    for row in rows:
        print("faults plan " + json.dumps(row), flush=True)
    return counts


def fault_serving_check(net, spikes) -> dict:
    """4096 requests through ``SpikeEngine(faults=, telemetry=True)``,
    synchronous and warmed, each equal to the faulted functional plan;
    then ``replan_degraded(1)`` and the same requests again; the faulted
    and the clean drains' req/s in turns.  Returns the launches of the
    served path."""
    import torch

    from repro_torch.core.esam.faults import FaultModel
    from repro_torch.serve.engine import SpikeEngine, SpikeRequest

    fm = FaultModel(**FAULT_MODELS[FAULT_SERVE_MODEL])
    want = net.plan(mode="functional", faults=fm)(
        torch.from_numpy(spikes).cuda()).logits.cpu().numpy()

    def make():
        return [SpikeRequest(spikes=s) for s in spikes]

    def check(reqs, what):
        got = np.stack([r.logits for r in reqs])
        if not np.array_equal(got, want):
            raise AssertionError(f"{what}: faulted logits differ from the "
                                 "faulted functional plan")

    kernels = ("mega_cascade", "tile_loads", "request_stats")
    with PlainForbidden() as guard:
        sync = SpikeEngine(net, max_batch=BUCKET, telemetry=True, faults=fm,
                           device="cuda")
        check(sync.serve(make()), "faulted synchronous drain")
    rounds = sync.stats()["rounds_static"]
    guard.expect("faulted serving", dict.fromkeys(kernels, rounds))
    counts = dict(guard.counts)
    with PlainForbidden() as warm_guard:
        warm = SpikeEngine(net, max_batch=BUCKET, telemetry=True, faults=fm,
                           device="cuda", fuse_rounds="auto", overlap=True)
        wt = warm.warmup()
        check(warm.serve(make()), "faulted warmed drain")
    n_b = len(warm._buckets)
    warm_guard.expect("faulted warmed serving",
                      dict.fromkeys(kernels, 3 * n_b))
    if wt["graphs"] != n_b or warm.graph_counts()["replays"] != (
            warm.stats()["rounds_static"]):
        raise AssertionError(f"faulted warmed drain: {wt['graphs']} graphs, "
                             f"{warm.graph_counts()}")
    st = sync.stats()
    if not (st["faulted"] and warm.stats()["faulted"]):
        raise AssertionError("a faulted engine reports faulted=False")
    replan = sync.replan_degraded(1)
    if replan != ((1, 1), ("data", "model")) or replan.dropped_chips:
        raise AssertionError(f"replan_degraded(1) gave {replan}")
    check(sync.serve(make()), "faulted drain after replan_degraded(1)")
    clean = {"clean_sync": SpikeEngine(net, max_batch=BUCKET, telemetry=True,
                                       device="cuda"),
             "clean_warmed": SpikeEngine(net, max_batch=BUCKET,
                                         telemetry=True, device="cuda",
                                         fuse_rounds="auto", overlap=True)}
    clean["clean_warmed"].warmup()
    walls = drain_walls({"faulted_sync": sync, **clean,
                         "faulted_warmed": warm}, make,
                        lambda reqs, wall: len(reqs) / wall)
    for eng in (sync, warm, *clean.values()):
        eng.close()
    print("faults serving " + json.dumps({
        "requests": len(spikes), "rounds": rounds, "launches": counts,
        "warm_launches": warm_guard.counts, "graphs": n_b,
        "faulted": st["faulted"], "health": st["health"],
        "tile_health": st["tile_health"], "degraded": st["degraded"],
        "clean_tile_health": clean["clean_sync"].stats()["tile_health"],
        "replan": [list(replan[0]), list(replan[1])],
        "req_per_s": walls}), flush=True)
    return counts


def fault_bench_check() -> dict:
    """``launch.bench_faults`` at the reference's sizes on the card, then
    its repair on the CPU from the same network and data: bits, per-epoch
    accuracy and updates equal; the repair's epochs timed beside a clean
    run's.  The bench's exact assertions raise inside it; of its two
    claims on the trained network's accuracies, the remap's is held here
    and the repair's is reported: the port's BNN is held to accuracy, not
    bits, and that claim belongs to the network (the reference's own bench
    fails it at BNN seeds 2, 3 and 5; the port's repair on the reference's
    network reads the reference's numbers exactly,
    ``tests/test_torch_faults.py``)."""
    import torch

    from repro_torch.core.esam import faults as faults_mod
    from repro_torch.core.esam.network import EsamNetwork
    from repro_torch.launch import bench_faults
    from repro_torch.train.online import train_online

    with PlainForbidden() as guard:
        t0 = time.perf_counter()
        bench = bench_faults.run(device="cuda", check=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    held, what = bench.claims["remap_recovers"]
    if not held:
        raise AssertionError(what)
    for kernel in ("mega_cascade", "popcount_fire", "stdp_epoch_masks",
                   "stdp_column_epoch"):
        if not guard.counts[kernel]:
            raise AssertionError(f"bench_faults launched no {kernel}")
    (x_tr, y_tr), (x_te, y_te) = bench.train, bench.test
    kw = dict(epochs=bench.repair_epochs, shuffle=True, eval_spikes=x_te,
              eval_labels=y_te)
    # the clean trainer on the same data, for the epoch walls
    clean = train_online(bench.net, x_tr, y_tr, **kw)
    cpu_net = EsamNetwork.from_numpy(*bench.net.to_numpy(), device="cpu")
    t0 = time.perf_counter()
    twin = train_online(cpu_net, x_tr.cpu(), y_tr.cpu(),
                        eval_spikes=x_te.cpu(), eval_labels=y_te.cpu(),
                        faults=bench.repair_faults,
                        epochs=bench.repair_epochs, shuffle=True)
    cpu_s = time.perf_counter() - t0
    # what the repair adds to an epoch: the readout clamped through the
    # last tile's masks (three times an epoch), timed alone
    masks = bench.repair_faults.build_masks(PAPER_TOPOLOGY, (4,),
                                            device="cuda")
    bits_t = bench.net.weight_bits[-1].T.contiguous()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        faults_mod.clamp_readout_t(bits_t, masks, 4)
    torch.cuda.synchronize()
    clamp_s = (time.perf_counter() - t0) / 20
    got = bench.repair
    if (got.accuracy != twin.accuracy or got.n_updates != twin.n_updates
            or not torch.equal(got.network.weight_bits[-1].cpu(),
                               twin.network.weight_bits[-1])):
        raise AssertionError(f"fault repair: card {got.accuracy} "
                             f"{got.n_updates} != CPU {twin.accuracy} "
                             f"{twin.n_updates}")
    print("faults bench " + json.dumps({
        "wall_s": wall, "launches": {k: v for k, v in guard.counts.items()
                                     if v},
        "rows": {r["name"]: r["derived"] for r in bench.rows},
        "claims": {k: {"holds": h, "what": w}
                   for k, (h, w) in bench.claims.items()},
        "repair_accuracy": got.accuracy, "repair_updates": got.n_updates,
        "repair_epoch_s": got.epoch_s, "clean_epoch_s": clean.epoch_s,
        "clamp_s": clamp_s, "cpu_twin_s": cpu_s}), flush=True)
    return dict(guard.counts)


def fault_traffic_check() -> dict:
    """``launch.serve --esam --traffic --replicas 2 --chaos`` on the card (the
    paper topology, 256 requests and a storm of 64): one crash, every
    request terminal and none failed, and every completed logit equal to a
    clean replay of the request at the steps it was served."""
    import torch  # noqa: F401

    from repro_torch.launch import serve as serve_mod
    from repro_torch.serve.engine import (EventRequest, SpikeEngine,
                                          SpikeRequest)

    with PlainForbidden() as guard:
        run = serve_mod.main(["--esam", "--traffic", "--replicas", "2",
                              "--chaos", "--device", "cuda"])
    rep = run.report
    lost = [r for r in run.requests if r.status == "pending"]
    if (rep.crashes != 1 or rep.n_failed or lost
            or rep.n_completed + rep.n_shed + rep.n_rejected
            != rep.n_offered):
        raise AssertionError(f"chaos traffic: {rep.to_dict()}, "
                             f"{len(lost)} requests still pending")
    done = [r for r in run.requests if r.logits is not None]
    clones = [EventRequest(events=np.asarray(r.events)[: r.served_steps])
              if isinstance(r, EventRequest) else SpikeRequest(spikes=r.spikes)
              for r in done]
    replay = SpikeEngine(run.net, max_batch=32, device="cuda")
    replay.serve(clones)
    for a, b in zip(done, clones):
        if not np.array_equal(a.logits, b.logits):
            raise AssertionError("a chaos-served logit differs from its "
                                 "clean replay")
    print("faults traffic " + json.dumps({
        "report": rep.to_dict(), "rate_sustainable": run.rate_sustainable,
        "router": {k: v for k, v in run.server.stats().items()
                   if k != "engines"},
        "replayed": len(done),
        "launches": {k: v for k, v in guard.counts.items() if v}}),
        flush=True)
    return dict(guard.counts)


def faults_phase() -> dict:
    """Phase 10: the fault plane at the paper topology.  Returns the
    launches of each part."""
    import torch

    from repro_torch.core.esam.network import EsamNetwork
    from repro_torch.launch import serve as serve_mod

    lap = phase_timer()
    fault_masks_check()
    lap("10a fault masks")
    spikes = serving_spikes()
    net = serve_mod.random_esam_network(PAPER_TOPOLOGY, 0, "cuda")
    net_cpu = EsamNetwork.from_numpy(*net.to_numpy(), device="cpu")
    counts = {"plans": fault_plans_check(net, net_cpu,
                                         torch.from_numpy(spikes) != 0)}
    lap("10b faulted plans")
    counts["serving"] = fault_serving_check(net, spikes)
    lap("10c faulted serving")
    counts["bench"] = fault_bench_check()
    lap("10d fault bench")
    counts["traffic"] = fault_traffic_check()
    lap("10e chaos traffic")
    print("faults launches " + json.dumps(
        {part: {k: v for k, v in c.items() if v}
         for part, c in counts.items()}), flush=True)
    return counts


# ------------------------------------------------------------------ #
# the observability plane (phase 11)
# ------------------------------------------------------------------ #
#: the kernels of an eager static round, as the profiler names them
ROUND_KERNELS = ("mega_cascade_kernel", "tile_loads_kernel",
                 "request_stats_kernel")
#: stats() keys that measure the host's wall time, not the datapath
WALL_CLOCK_KEYS = ("host_pack_s_total", "dispatch_s_total",
                   "straggler_rounds")
#: where phase 11 writes its traces (git-ignored, not brought back)
OBS_DIR = ROOT / "build" / "obs"


def obs_counters_reconcile(what: str, eng, snap: dict) -> dict:
    """The engine's counters against its stats() and float64 totals."""
    st = eng.stats()
    want = {
        "esam_requests_served_total{kind=\"static\"}": st["n_requests"],
        "esam_dispatch_rounds_total": st["dispatch_rounds"],
        "esam_rows_real_total": st["rows_real_total"],
        "esam_rows_padded_total": st["rows_padded_total"],
        "esam_cycles_total": eng._totals["cycles"],
        "esam_energy_pj_total": eng._totals["energy_pj"],
        "esam_health": st["health"],
        "esam_queue_depth": 0,
    }
    got = {k: snap[k]["value"] for k in want}
    if got != want:
        raise AssertionError(f"{what}: counters {got} != stats {want}")
    return got


def obs_identity_check(bits, spikes) -> dict:
    """4096 requests through engines with and without
    ``Observability.enabled(registry=Registry())``, synchronous and warmed:
    results and stats() (less its wall-clock keys) equal bit for bit, every
    request span closed, counters equal to stats(); then each drain's
    req/s with the plane on and off, 5 drains each in turns.  Each mode has
    a network of its own: a plan's graphs serve every engine on it."""
    from repro_torch.core.esam.network import EsamNetwork
    from repro_torch.obs import Observability, Registry
    from repro_torch.obs.trace import validate_trace
    from repro_torch.serve.engine import SpikeEngine, SpikeRequest

    def make():
        return [SpikeRequest(spikes=s) for s in spikes]

    modes = {"sync": {}, "warmed": dict(fuse_rounds="auto", overlap=True)}
    engines, rows = {}, {}
    for mode, kw in modes.items():
        net = EsamNetwork.from_numpy(*bits, device="cuda")
        obs = Observability.enabled(registry=Registry())
        plain = SpikeEngine(net, max_batch=BUCKET, telemetry=True,
                            device="cuda", **kw)
        inst = SpikeEngine(net, max_batch=BUCKET, telemetry=True,
                           device="cuda", observability=obs, **kw)
        if mode == "warmed":
            plain.warmup()
            inst.warmup()
        with PlainForbidden() as guard:
            want = plain.serve(make())
            got = inst.serve(make())
        rounds = plain.stats()["rounds_static"]
        guard.expect(f"{mode} drains, plane off and on", dict.fromkeys(
            ("mega_cascade", "tile_loads", "request_stats"),
            0 if mode == "warmed" else 2 * rounds))
        same_served(got, want, f"{mode} drain with the plane on")
        st_plain, st_inst = plain.stats(), inst.stats()
        for key in WALL_CLOCK_KEYS:
            st_plain.pop(key)
            st_inst.pop(key)
        if st_inst != st_plain:
            raise AssertionError(f"{mode}: stats() differ with the plane on")
        summary = validate_trace(obs.tracer.export())
        if (summary["request_begun"] != len(spikes)
                or summary["request_close_fraction"] != 1.0
                or summary["phases"]["round"] != rounds
                or obs.tracer.dropped):
            raise AssertionError(f"{mode}: trace {summary}")
        snap = obs.metrics.snapshot()
        if snap["esam_requests_submitted_total"]["value"] != len(spikes):
            raise AssertionError(f"{mode}: submitted "
                                 f"{snap['esam_requests_submitted_total']}")
        rows[mode] = {
            "rounds": rounds, "events": summary["events"],
            "phases": summary["phases"],
            "counters": obs_counters_reconcile(mode, inst, snap),
            "latency_p99_s": snap["esam_request_latency_seconds"]["p99"]}
        engines[f"{mode}_off"], engines[f"{mode}_on"] = plain, inst
    walls = drain_walls(engines, make, lambda reqs, wall: len(reqs) / wall)
    for mode in modes:
        off = walls[f"{mode}_off"]["median"]
        on = walls[f"{mode}_on"]["median"]
        rows[mode]["overhead_pct"] = 100.0 * (off - on) / on
    for eng in engines.values():
        eng.close()
    print("obs identity " + json.dumps({"requests": len(spikes), **rows,
                                        "req_per_s": walls}), flush=True)
    return rows


def obs_profiler_check(bits, spikes) -> dict:
    """``DeviceProfiler(skip_rounds=1, n_rounds=4)`` with the
    ``torch.profiler`` backend around the eager synchronous drain (its
    Chrome trace holds 4 launches of each of the round's kernels and no
    graph replay) and a warmed drain (4 graph replays; the kernel records
    CUPTI gives for a replay's nodes are reported, not held), each on a
    network of its own.  The skipped round runs in the backend's warm-up
    step: a session that recorded from its first launch lost the first
    round's cascade record.  A capture that lost records is taken
    again, as the learning profile is, and after ``PROFILE_ATTEMPTS`` the
    phase fails; every attempt is reported."""
    from repro_torch.core.esam.network import EsamNetwork
    from repro_torch.obs import DeviceProfiler, Observability, TorchProfiler
    from repro_torch.serve.engine import SpikeEngine, SpikeRequest

    out = {}
    for mode, kw in (("sync", {}),
                     ("warmed", dict(fuse_rounds="auto", overlap=True))):
        seen = []
        for attempt in range(1, PROFILE_ATTEMPTS + 1):
            backend = TorchProfiler()
            prof = DeviceProfiler(str(OBS_DIR / f"profile_{mode}"),
                                  skip_rounds=1, n_rounds=4,
                                  profiler=backend)
            prof.prepare()
            net = EsamNetwork.from_numpy(*bits, device="cuda")
            eng = SpikeEngine(net, max_batch=BUCKET, telemetry=True,
                              device="cuda", observability=Observability(
                                  profile=prof), **kw)
            if mode == "warmed":
                eng.warmup()
            t0 = time.perf_counter()
            eng.serve([SpikeRequest(spikes=s) for s in spikes])
            wall = time.perf_counter() - t0
            eng.close()
            if prof.error is not None or prof.captured != 4 or not prof.done:
                raise AssertionError(f"{mode} profile: error {prof.error}, "
                                     f"captured {prof.captured}")
            with open(backend.trace_path) as f:
                events = json.load(f)["traceEvents"]
            kernels = trace_names(events, "kernel")
            runtime = trace_names(events, "cuda_runtime", "runtime")
            counts = {k: sum(k in name for name in kernels)
                      for k in ROUND_KERNELS}
            replays = runtime.count("cudaGraphLaunch")
            seen.append({"kernels": counts, "graph_replays": replays})
            if (replays == 4 if mode == "warmed" else (
                    replays == 0
                    and counts == dict.fromkeys(ROUND_KERNELS, 4))):
                break
        else:
            print("obs profiler " + json.dumps({mode: seen}), flush=True)
            raise AssertionError(f"{mode} profile: {seen} after "
                                 f"{PROFILE_ATTEMPTS} captures")
        out[mode] = {"captured": prof.captured, "attempts": seen,
                     "device_events": len(kernels),
                     "trace_bytes": Path(backend.trace_path).stat().st_size,
                     "drain_wall_s": wall}
    print("obs profiler " + json.dumps(out), flush=True)
    return out


def trace_names(events, *cats) -> list[str]:
    """Names of a Chrome trace's events of these categories (any case)."""
    return [e["name"] for e in events
            if str(e.get("cat", "")).lower() in cats]


def _scrape(port: int, path: str) -> bytes:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        if r.status != 200:
            raise AssertionError(f"GET {path}: {r.status}")
        return r.read()


def obs_launcher_check(hold_s: float = 3.0, timeout_s: float = 240.0):
    """``launch.serve --traffic --replicas 2 --chaos`` with every lane on, in
    a subprocess: /healthz, /metrics and /metrics.json scraped over
    127.0.0.1 while the endpoint is held, then the reference's CI
    observability smoke asserted (typed families; submitted reconciles
    with the report and equals its snapshot; close fraction; phases), and
    ``PROFILE ... status=ok``."""
    import os
    import threading

    from repro_torch.obs.trace import validate_trace

    OBS_DIR.mkdir(parents=True, exist_ok=True)
    trace_path = OBS_DIR / "launcher_trace.json"
    report_path = OBS_DIR / "launcher_report.json"
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--traffic",
           "--replicas", "2", "--chaos", "--device", "cuda",
           "--metrics-port", "0", "--metrics-hold-s", str(hold_s),
           "--trace-out", str(trace_path), "--report-json", str(report_path),
           "--profile-rounds", "2",
           "--profile-dir", str(OBS_DIR / "launcher_profile")]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    # a launcher that hangs is killed, which ends the read below
    killer = threading.Timer(timeout_s, proc.kill)
    killer.start()
    lines, scraped, port = [], None, None
    try:
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))
            if line.startswith("METRICS port="):
                port = int(line.split()[1].split("=")[1])
            if line.startswith("METRICS holding") and scraped is None:
                scraped = {p: _scrape(port, p) for p in
                           ("/healthz", "/metrics", "/metrics.json")}
        rc = proc.wait(timeout=60)
    finally:
        killer.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    wall = time.perf_counter() - t0
    if rc != 0 or scraped is None:
        raise AssertionError(f"launcher rc {rc}, scraped {scraped is not None}"
                             ":\n" + "\n".join(lines[-30:]))
    if scraped["/healthz"] != b"ok\n":
        raise AssertionError(f"/healthz: {scraped['/healthz']!r}")
    text = scraped["/metrics"].decode()
    for want in ("# TYPE esam_requests_submitted_total counter",
                 "# TYPE esam_request_latency_seconds histogram",
                 'esam_request_latency_seconds_bucket{le="+Inf"}',
                 "# TYPE esam_router_crashes_total counter"):
        if want not in text:
            raise AssertionError(f"/metrics lacks {want!r}")
    values = {}
    for line in text.splitlines():
        if line.startswith("#") or "{" in line:
            continue
        name, _, val = line.partition(" ")
        values[name] = float(val)
    with open(report_path) as f:
        report = json.load(f)
    with open(trace_path) as f:
        doc = json.load(f)
    summary = validate_trace(doc)
    snap = report["metrics"]
    scraped_snap = json.loads(scraped["/metrics.json"])
    profile_key = "esam_profile_rounds_captured"
    if ({k: v for k, v in scraped_snap.items() if k != profile_key}
            != {k: v for k, v in snap.items() if k != profile_key}):
        raise AssertionError("/metrics.json differs from the report's "
                             "snapshot")
    submitted = values["esam_requests_submitted_total"]
    # the CI's identity (one replica): submitted = offered - rejected; with
    # the crash, the crashed replica's victims are admitted once more
    # where they are re-routed (or fail)
    victims = sum(e["args"]["victims"] for e in doc["traceEvents"]
                  if e["name"] == "replica_crash")
    if (submitted != snap["esam_requests_submitted_total"]["value"]
            or submitted != report["n_offered"] - report["n_rejected"]
            + victims - report["n_failed"]):
        raise AssertionError(f"submitted {submitted}: offered "
                             f"{report['n_offered']}, rejected "
                             f"{report['n_rejected']}, victims {victims}, "
                             f"failed {report['n_failed']}")
    if (summary["request_begun"] == 0
            or summary["request_close_fraction"] < 0.99
            or not {"pack", "dispatch", "device_drain",
                    "telemetry_flush"} <= set(summary["phases"])):
        raise AssertionError(f"launcher trace: {summary}")
    profile = [line for line in lines if line.startswith("PROFILE ")]
    if len(profile) != 1 or not profile[0].endswith("status=ok"):
        raise AssertionError(f"launcher profile: {profile}")
    if report["crashes"] != 1 or report["n_offered"] != (
            report["n_completed"] + report["n_shed"] + report["n_rejected"]
            + report["n_failed"]):
        raise AssertionError(f"launcher report: {report}")
    print("obs launcher " + json.dumps({
        "wall_s": wall, "submitted": submitted, "victims": victims,
        "ci_identity_offered_minus_rejected":
            report["n_offered"] - report["n_rejected"],
        "report": {k: v for k, v in report.items() if k != "metrics"},
        "trace": {k: v for k, v in summary.items() if k != "phases"},
        "phases": summary["phases"], "scalar_series": len(values),
        "lines": [line for line in lines
                  if line.split(" ")[0] in ("METRICS", "PROFILE", "TRACE",
                                            "REPORT")]}), flush=True)


def obs_learning_check() -> dict:
    """``train_online(observability=)`` on the paper-learn network and data
    for 2 epochs: the learned bits, accuracies and updates of a run
    without the plane; one ``train_epoch`` span and the counters an
    epoch."""
    import torch

    from repro_torch.core import prng
    from repro_torch.data import digits
    from repro_torch.obs import Observability, Registry
    from repro_torch.obs.trace import validate_trace
    from repro_torch.train.online import train_online

    x, y = digits.make_spike_dataset(LEARN_TRAIN, seed=3)
    xe, ye = digits.make_spike_dataset(LEARN_EVAL, seed=4)
    kw = dict(epochs=2, key=prng.PRNGKey(10), p_pot=LEARN_P_POT,
              p_dep=LEARN_P_DEP, eval_spikes=xe, eval_labels=ye,
              shuffle=True)
    obs = Observability.enabled(registry=Registry())
    with PlainForbidden() as guard:
        plain = train_online(paper_network("cuda"), x, y, **kw)
        got = train_online(paper_network("cuda"), x, y, observability=obs,
                           **kw)
        torch.cuda.synchronize()
    if not (torch.equal(plain.network.weight_bits[-1],
                        got.network.weight_bits[-1])
            and plain.accuracy == got.accuracy
            and plain.n_updates == got.n_updates):
        raise AssertionError("train_online differs with the plane on")
    guard.expect("learning with the plane off and on", {
        "popcount_fire": 4 * (len(PAPER_TOPOLOGY) - 2),
        "stdp_epoch_masks": 4, "stdp_column_epoch": 4})
    spans = [e for e in obs.tracer.events() if e["name"] == "train_epoch"]
    reg = obs.metrics
    if ([s["args"] for s in spans] != [
            {"epoch": i, "accuracy": a, "n_updates": n}
            for i, (a, n) in enumerate(zip(got.accuracy, got.n_updates))]
            or reg.get("esam_train_epochs_total").value != 2
            or reg.get("esam_train_column_updates_total").value
            != sum(got.n_updates)
            or reg.get("esam_train_accuracy").value != got.accuracy[-1]
            or reg.get("esam_train_epoch_seconds").count != 2):
        raise AssertionError("train_online's spans or counters miss an "
                             "epoch")
    validate_trace(obs.tracer.export())
    row = {"accuracy": got.accuracy, "n_updates": got.n_updates,
           "epoch_s": got.epoch_s, "plain_epoch_s": plain.epoch_s,
           "span_us": [s["dur"] for s in spans]}
    print("obs learning " + json.dumps(row), flush=True)
    return row


def obs_bench_check() -> list:
    """``launch.bench_serving`` at the reference's sizes: every row, and
    what the reference's CI asserts of them (the warm first request faster
    than the cold one; the over lane sheds, has a p99 and a goodput; the
    chaos lane loses nothing, which the bench itself raises on).
    ``overhead_pct`` and the chaos lane's crash count are reported."""
    from repro_torch.launch import bench_serving

    with PlainForbidden() as guard:
        t0 = time.perf_counter()
        rows = bench_serving.run(device="cuda")
        wall = time.perf_counter() - t0
    f = {r["name"]: bench_serving.fields(r) for r in rows}
    cold = f["serving_cold_start"]
    over = f["serving_openloop_over"]
    if not (float(cold["warm_first_request_ms"])
            < float(cold["cold_first_request_ms"])
            and int(over["shed_total"]) > 0 and float(over["p99_ms"]) > 0
            and "goodput_slo" in over
            and "p99_ms" in f["serving_openloop_under"]
            and int(f["serving_chaos"]["lost"]) == 0):
        raise AssertionError(f"bench_serving rows: {f}")
    for kernel in ("mega_cascade", "tile_loads", "request_stats"):
        if not guard.counts[kernel]:
            raise AssertionError(f"bench_serving launched no {kernel}")
    print("obs bench " + json.dumps({
        "wall_s": wall,
        "launches": {k: v for k, v in guard.counts.items() if v},
        "overhead_pct": f["serving_obs_overhead"]["overhead_pct"],
        "chaos_crashes": int(f["serving_chaos"]["crashes"]),
        "rows": {r["name"]: r["derived"] for r in rows}}), flush=True)
    return rows


def obs_phase() -> None:
    """Phase 11: the observability plane at the paper topology."""
    from repro_torch.launch import serve as serve_mod

    lap = phase_timer()
    spikes = serving_spikes()
    bits = serve_mod.random_esam_network(PAPER_TOPOLOGY, 0, "cpu").to_numpy()
    obs_identity_check(bits, spikes)
    lap("11a plane on vs off")
    obs_profiler_check(bits, spikes)
    lap("11b device profiler")
    obs_launcher_check()
    lap("11c launcher scrape")
    obs_learning_check()
    lap("11d train_online")
    obs_bench_check()
    lap("11e bench_serving")


# ------------------------------------------------------------------ #
# the paper benches (phase 12)
# ------------------------------------------------------------------ #
#: bench_run's twins that phases 9 and 10 already run uncut on the card
PAPER_SKIPPED_TWINS = ("kernels", "faults")
#: each --compile-cache launcher subprocess's time limit
COMPILE_CACHE_TIMEOUT_S = 300.0


def paper_twins_check() -> dict:
    """``launch.bench_run``'s twins at the reference's sizes, in its order
    (kernels and faults are phases 9 and 10), each under ``PlainForbidden``
    with its launches held to the ones it books.  ``PlainForbidden``
    replaces the plain versions the wrappers dispatch to, by their names
    in the kernel ops modules.  The oracles the reference's benches run
    are allowed and not seen by it: the per-step loop and the scan plane's
    arbiter rounds call no wrapper, and the learning bench's column-scheme
    loop draws through ``stdp.ref.column_event_uniforms``, which
    ``core/esam/learning.py`` imports directly.  After the temporal twin,
    :func:`bench_temporal.replay_on_cpu` holds its stream and encoder
    lanes against the same plans on the CPU, bit for bit."""
    from repro_torch.launch import bench_run, bench_temporal

    lap = phase_timer()
    out = {}
    for name, module in bench_run.TWINS:
        if name in PAPER_SKIPPED_TWINS:
            continue
        with PlainForbidden() as guard:
            t0 = time.perf_counter()
            rec = bench_run.run_twin(name, module, "cuda")
            wall = time.perf_counter() - t0
        guard.expect(f"paper bench {name}", dict(rec.launches))
        out[name] = {"wall_s": wall, "launches": dict(rec.launches),
                     "rows": {r["name"]: (r["us_per_call"], r["derived"])
                              for r in rec.rows}}
        if name == "temporal":
            t0 = time.perf_counter()
            out[name]["cpu_replay_values"] = bench_temporal.replay_on_cpu(rec)
            out[name]["cpu_replay_s"] = time.perf_counter() - t0
        print("paper_bench " + json.dumps({"twin": name, **out[name]}),
              flush=True)
        lap(f"12 {name}")
    return out


def paper_learning_check() -> dict:
    """``launch.online_learning`` (the example's twin) on the card, 2
    launches an epoch, against the same call on the CPU: accuracy before
    and after each epoch, column updates and learned bits equal."""
    import torch

    from repro_torch.launch import online_learning

    with PlainForbidden() as guard:
        t0 = time.perf_counter()
        acc0, res = online_learning.run(device="cuda")
        wall = time.perf_counter() - t0
    epochs = online_learning.EPOCHS
    guard.expect("online_learning example", {"stdp_epoch_masks": epochs,
                                             "stdp_column_epoch": epochs})
    want0, want = online_learning.run(device="cpu")
    if not (acc0 == want0 and res.accuracy == want.accuracy
            and res.n_updates == want.n_updates
            and torch.equal(res.network.weight_bits[0].cpu(),
                            want.network.weight_bits[0])):
        raise AssertionError("launch.online_learning on the card differs "
                             "from its CPU twin")
    row = {"wall_s": wall, "accuracy_before": acc0,
           "accuracy": res.accuracy, "n_updates": res.n_updates,
           "epoch_s": res.epoch_s}
    print("paper_learning " + json.dumps(row), flush=True)
    return row


def _launcher_run(cache_dir: str) -> dict:
    """One ``launch.serve --esam --smoke --warmup --compile-cache DIR`` in a
    subprocess: its wall, and its BUILD and COLDSTART lines parsed."""
    import os

    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--esam",
           "--smoke", "--warmup", "--device", "cuda", "--compile-cache",
           cache_dir]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=COMPILE_CACHE_TIMEOUT_S)
    wall = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    if proc.returncode != 0:
        raise AssertionError(f"launcher rc {proc.returncode}:\n"
                             + "\n".join((lines + proc.stderr.splitlines())
                                          [-30:]))

    def parsed(prefix):
        line = next((ln for ln in lines if ln.startswith(prefix)), None)
        if line is None:
            raise AssertionError(f"launcher printed no {prefix} line:\n"
                                 + "\n".join(lines[-30:]))
        return line, dict(kv.split("=", 1) for kv in line.split()[1:])

    build_line, build = parsed("BUILD ")
    cold_line, cold = parsed("COLDSTART ")
    print(build_line, flush=True)
    print(cold_line, flush=True)
    return {"wall_s": wall, "build": build, "coldstart": cold}


def compile_cache_check() -> dict:
    """The launcher twice with ``--compile-cache`` on a fresh directory:
    the first run builds every kernel library, the second builds none
    (every ``build_s`` 0.0: ``built=0``, ``nvcc_s=0.00``); both print
    ``cache=on``."""
    import tempfile

    from repro_torch.kernels import _build

    with tempfile.TemporaryDirectory(prefix="repro-torch-cache-") as d:
        first = _launcher_run(d)
        second = _launcher_run(d)
    n_libs = str(len(_build.LIBRARIES))
    if not (first["build"]["libraries"] == n_libs
            and first["build"]["built"] == n_libs
            and float(first["build"]["nvcc_s"]) > 0.0):
        raise AssertionError(f"the first --compile-cache run: {first}")
    if not (second["build"]["built"] == "0"
            and second["build"]["nvcc_s"] == "0.00"):
        raise AssertionError(f"the second --compile-cache run built: "
                             f"{second}")
    for run in (first, second):
        if run["coldstart"].get("cache") != "on":
            raise AssertionError(f"COLDSTART without cache=on: {run}")
    row = {"first": first, "second": second}
    print("compile_cache " + json.dumps(row), flush=True)
    return row


def paper_benches_phase() -> dict:
    """Phase 12: the paper bench twins, the online-learning example and
    the launcher's compile cache."""
    lap = phase_timer()
    twins = paper_twins_check()
    lap("12 twins")
    learning = paper_learning_check()
    lap("12 online_learning")
    cache = compile_cache_check()
    lap("12 compile cache")
    return {"twins": twins, "learning": learning, "cache": cache}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script needs one",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    # 1. the card
    print(nvidia_smi("name,power.limit"), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    card = Card()
    print(f"card: {card.sms} SMs, max SM clock {card.max_sm_mhz:.0f} MHz, "
          f"popc bound rate {card.popc_per_s:.4g}/s, "
          f"memory bound rate {HBM_BYTES_PER_S:.4g} B/s", flush=True)

    # 2. build: one nvcc per library, and one for each probe, all started
    # together
    t0 = time.perf_counter()
    probe_build = start_probe_build()
    floor_build = start_probe_build(FLOOR_SOURCE)
    reports = _build.build_all()
    print(f"build: {len(reports)} libraries in "
          f"{time.perf_counter() - t0:.2f} s wall", flush=True)
    for rep in reports:
        print(f"build: {rep.path.name} nvcc {rep.build_s:.2f} s", flush=True)
        for line in rep.ptxas.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("ptxas: " + line.strip(), flush=True)

    # the exact MAC datapaths' issue rates (probes/rate_probe.cu), and the
    # one B2/B3 uses in the built kernel
    probe_rates(card, probe_build)
    launch_floor(floor_build)
    tile_sass(reports)
    epoch_sass(next(r for r in reports if r.name == "stdp"))
    scan_sass(next(r for r in reports if r.name == "lif_step"))

    # 3. kernels vs plain, on the card
    from repro_torch.core import packing

    lap = phase_timer()
    rng = np.random.default_rng(2024)
    # B1 at the serving path's and the bench's shapes, then on each of its
    # routes: every cluster size the launcher picks (1 for one group a
    # tile; 2; 4, 8 and 16 where a CTA's share of 2 does not fit), MACs at
    # run-time word counts, a partly empty last slice, more slices than
    # clusters
    mega_rows, mac_rows = [], []
    paper_fixed = (True,) * (len(PAPER_TOPOLOGY) - 1)
    # (the MAC runs on the b1 product from 5 rows a slice, B 320; 1000 is
    # 15 rows a slice, its last slice partly empty)
    # (whether 4096 rows need more slices than the card holds clusters
    # depends on the occupancy the compiler's registers allow: 16384 do)
    for batch in (1, 7, BUCKET, 512, 1000, BENCH_B, SERVE_REQUESTS,
                  4 * SERVE_REQUESTS):
        route = {} if batch == SERVE_REQUESTS else {
            "persistent": batch > SERVE_REQUESTS}
        check_mega(card, rng, PAPER_TOPOLOGY, batch, mega_rows, cluster=2,
                   fixed=paper_fixed, partial=batch == 1000,
                   mac="b1" if batch >= 320 else "popc", **route)
    check_mega(card, rng, PAPER_TOPOLOGY, 333, mega_rows, partial=True,
               mac="b1")
    check_mega(card, rng, PAPER_TOPOLOGY, 254, mega_rows, partial=True,
               mac="popc")
    check_mega(card, rng, (768, 256, 10), BUCKET, mega_rows, cluster=2)
    check_mega(card, rng, (100, 64, 96, 33), 45, mega_rows, cluster=2,
               fixed=(False, False, False))
    check_mega(card, rng, (100, 64, 96, 33), 1000, mega_rows, cluster=2,
               fixed=(False, False, False), partial=True, mac="b1")
    for topology, cluster in (((100, 32, 10), 1), ((1024, 4096, 10), 4),
                              ((2048, 4096, 10), 8), ((4096, 4096, 10), 16)):
        check_mega(card, rng, topology, 8, mega_rows, cluster=cluster)
    check_mega(card, rng, (4096, 4096, 10), 600, mega_rows, cluster=16,
               partial=True, mac="b1")
    # why those geometries: the same kernel under three the launcher does
    # not pick (the other MAC; clusters of 8; a CTA an SM), bit for bit and
    # timed, at a serving round's B 128 (2 rows a slice: the popc MAC), at
    # 256 and 320 (4 and 5 rows: the last popc and the first b1 route) and
    # the bench's 1024
    for topology, batch in ((PAPER_TOPOLOGY, BUCKET),
                            (PAPER_TOPOLOGY, 2 * BUCKET),
                            (PAPER_TOPOLOGY, 5 * 64),
                            (PAPER_TOPOLOGY, BENCH_B),
                            (PAPER_TOPOLOGY, SERVE_REQUESTS),
                            (BENCH_CASCADE, BUCKET),
                            (BENCH_CASCADE, BENCH_B)):
        mega_geometries(rng, topology, batch)
    check_mac(card, rng, BUCKET, 768, 10, mac_rows, paired=True)
    check_mac(card, rng, 37, 100, 77, mac_rows)
    fire_rows, packed_rows, event_rows, single_rows = [], [], [], []
    for check, rows in ((check_fire, fire_rows),
                        (check_packed_fire, packed_rows)):
        check(card, rng, LEARN_TRAIN, 768, 256, rows)
        check(card, rng, LEARN_TRAIN, 256, 256, rows)
        check(card, rng, 1000, 777, 256, rows)
        check(card, rng, 37, 100, 96, rows, pack_output=False)
    # B2 and B3 at ragged shapes in every output mode (contiguous operands
    # load two words at a time exactly when W is even), then at the edges:
    # all-zero and all-one spikes and planes, thresholds at the int32
    # extremes, strided spike rows (an odd stride loads one word at a time)
    for batch, n_in, n_out in POP_RAGGED:
        paired = packing.packed_width(n_in) % 2 == 0
        check_mac(card, rng, batch, n_in, n_out, mac_rows, paired=paired)
        for pack in (False, True) if n_out % 32 == 0 else (False,):
            check_fire(card, rng, batch, n_in, n_out, fire_rows,
                       pack_output=pack, paired=paired)
    for fill in ("zeros", "ones"):
        check_mac(card, rng, 37, 777, 96, mac_rows, fill=fill)
        check_fire(card, rng, 37, 777, 96, fire_rows, fill=fill)
        check_fire(card, rng, 7, 100, 77, fire_rows, pack_output=False,
                   fill=fill)
    for vth_fill in ("min", "max"):
        check_fire(card, rng, 37, 768, 96, fire_rows, vth_fill=vth_fill)
        check_fire(card, rng, 7, 777, 77, fire_rows, pack_output=False,
                   vth_fill=vth_fill)
    for stride_pad in (1, 2):
        check_mac(card, rng, 4 * EVENT_BATCH, 768, 256, mac_rows,
                  stride_pad=stride_pad, paired=stride_pad == 2)
        check_fire(card, rng, 37, 768, 96, fire_rows, stride_pad=stride_pad,
                   paired=stride_pad == 2)
    for n_out, n_in in ((10, 256), (256, 768)):
        check_column_event(card, rng, n_out, n_in, event_rows)
        check_stdp_update(card, rng, n_out, n_in, single_rows)
    # the single event's routes: the bench's 128 x 256, byte loads at
    # n_in 511 and 99; row strides past n_in (ld % 4 == 0 keeps the 4-input
    # loads); trace and uniforms one element past an aligned start
    for n_out, n_in in ((128, 256), (33, 511), (7, 99)):
        check_column_event(card, rng, n_out, n_in, event_rows)
    for n_out, n_in, pad in ((10, 256, 4), (10, 256, 3), (200, 256, 4),
                             (200, 256, 1)):
        check_column_event(card, rng, n_out, n_in, event_rows, pad=pad)
    for n_out, n_in in ((10, 256), (256, 768)):
        check_column_event(card, rng, n_out, n_in, event_rows, shift=True)
    # the epoch's two kernels: the learning path's shape and ragged and
    # wide readouts, tied and offset, then a key past 2^31 and every other
    # route of the chain ((words a row, rows a lane) in registers; (0, 0):
    # planes in shared memory)
    masks_rows, epoch_rows = [], []
    for n_out, n_in, n, route in ((10, 256, LEARN_TRAIN, (8, 1)),
                                  (33, 257, 300, (16, 2)),
                                  (64, 768, 200, (0, 0)),
                                  (256, 768, 300, (0, 0))):
        for tied in (False, True):
            for offset in (False, True):
                check_column_epoch(card, rng, n_out, n_in, n, masks_rows,
                                   epoch_rows, route=route, tied=tied,
                                   offset=offset)
    check_column_epoch(card, rng, 10, 256, LEARN_TRAIN, masks_rows,
                       epoch_rows, route=(8, 1), offset=True,
                       key_words=(0xDEADBEEF, 0x9E3779B9))
    check_column_epoch(card, rng, 10, 256, 300, masks_rows, epoch_rows,
                       route=(8, 1), offset=True, special=True)
    for n_out, n_in, route in ((10, 300, (16, 1)), (10, 768, (32, 1)),
                               (40, 256, (8, 2)), (65, 100, (0, 0))):
        check_column_epoch(card, rng, n_out, n_in, 300, masks_rows,
                           epoch_rows, route=route, offset=True)
    # the matrix-RNG epoch's three kernels: the scan path's shapes (timed),
    # then labels outside [0, n_out), a tied readout, p of 0 and 1, 0 and 1
    # samples, and every route of the chain, the ring at 16, 4 and 1 slots
    # a copy ((256, 768): one wide slot a copy)
    update_rows = []
    for n in (SCAN_SAMPLES, LEARN_TRAIN):
        check_update_epoch(card, rng, 10, 256, n, update_rows, route=(8, 1),
                           bad=(-1, 10, 20), timed=True)
    check_update_epoch(card, rng, 10, 256, 300, update_rows, route=(8, 1),
                       tied=True)
    for probs in ((LEARN_P_POT, 0.0), (0.0, LEARN_P_DEP), (1.0, 1.0)):
        check_update_epoch(card, rng, 10, 256, 100, update_rows, route=(8, 1),
                           probs=probs)
    for n in (0, 1):
        check_update_epoch(card, rng, 10, 256, n, update_rows, route=(8, 1))
    for n_out, n_in, n, route in ((33, 70, 200, (8, 2)),
                                  (65, 70, 100, (0, 0)),
                                  (10, 300, 100, (16, 1)),
                                  (10, 768, 100, (32, 1)),
                                  (40, 256, 100, (8, 2)),
                                  (64, 768, 50, (0, 0)),
                                  (256, 768, 40, (0, 0))):
        check_update_epoch(card, rng, n_out, n_in, n, update_rows,
                           route=route, bad=(-1, n_out, 2 * n_out))
    arbiter_rows = []
    for name in ("port_schedule", "arbiter"):
        for n in (SWEEP_DIGITS * 6, 8192):
            for ports in (1, 2, 3, 4):
                check_arbiter(card, rng, name, n, ports, arbiter_rows)
        for n in (1, 7, 1000):
            check_arbiter(card, rng, name, n, 4, arbiter_rows)
        for fill in ("zeros", "ones"):
            for ports in (3, 4):
                check_arbiter(card, rng, name, 8192, ports, arbiter_rows,
                              fill=fill)
    lif_rows = []
    for batch, n in LIF_SHAPES:
        for leak in (0.0, EVENT_LEAK, 0.3):
            for reset in ("zero", "subtract"):
                for refractory in (0, 2):
                    check_lif(card, rng, batch, n, leak, reset, refractory,
                              lif_rows)
    # the event round's scan: the event path's shapes (T 4, 8 and 16 at
    # B 64) on the register route, ragged rounds, 0 and 1 hidden tiles,
    # each reset mode with refractory 2, the register route's edges
    # (streams around its clusters of 8 and 16, widths around a K step of
    # 256, 4 hidden tiles and 5, past it), and the shared-memory kernel's
    # three routes: planes and state in shared memory, planes past it
    # (read from device memory), state past it too (a device scratch)
    scan_rows = []
    for n_steps in EVENT_STEPS:
        check_scan(card, rng, PAPER_HIDDEN, EVENT_BATCH, n_steps, scan_rows)
    for batch in (1, 7):
        check_scan(card, rng, PAPER_HIDDEN, batch, 8, scan_rows)
    check_scan(card, rng, (), EVENT_BATCH, 8, scan_rows)
    check_scan(card, rng, (256,), EVENT_BATCH, 8, scan_rows)
    for batch in (15, 16, 17, 33):
        check_scan(card, rng, PAPER_HIDDEN, batch, 8, scan_rows,
                   refractory=3, reset="subtract")
    for hidden in ((256, 255), (256,), (256, 257), (256,) * 4):
        check_scan(card, rng, hidden, EVENT_BATCH, 8, scan_rows)
    for hidden in ((255,), (257,), (256,) * 5):
        check_scan(card, rng, hidden, EVENT_BATCH, 8, scan_rows,
                   route="smem")
    check_scan(card, rng, (2048, 2048), 9, 4, scan_rows,
               route="planes_global")
    check_scan(card, rng, (16384, 16384), 2, 2, scan_rows,
               route="state_global")
    for reset in ("zero", "subtract"):
        check_scan(card, rng, PAPER_HIDDEN, EVENT_BATCH, 16, scan_rows,
                   reset=reset, refractory=2)
    # hidden widths that are not multiples of 32 (a first width that is not
    # a multiple of 4 takes the shared-memory route), and a stack deeper
    # than one launch takes (two launches and a popcount_mac)
    for hidden, batch, route in (((31,), 2, "smem"), ((36, 70, 33), 5, "regs"),
                                 ((37, 70, 33), 5, "smem"),
                                 ((129, 255), 64, "smem")):
        check_scan(card, rng, hidden, batch, 3, scan_rows, leak=0.7,
                   reset="subtract", refractory=3, route=route)
    check_scan(card, rng, (9, 40) * 17, 3, 2, scan_rows, n_cls=5)
    # popcount_mac at the event path's shapes: tile 0 over a round of T 4,
    # 8 and 16 (the scan's first operand); and the per-step shapes of the
    # route before the scan, a hidden tile and the readout over one step
    for batch, n_in, n_out in ((4 * EVENT_BATCH, 768, 256),
                               (8 * EVENT_BATCH, 768, 256),
                               (16 * EVENT_BATCH, 768, 256),
                               (EVENT_BATCH, 256, 256),
                               (EVENT_BATCH, 256, 10)):
        check_mac(card, rng, batch, n_in, n_out, mac_rows)
    # the kernel bench's shapes (its B3 and B2 lanes, its mega cascade at
    # (768, 768, 768, 10) with the block sweep, its B8 lane), and the
    # kernels only the bench runs at its shapes, ragged ones and a large one
    check_mac(card, rng, BENCH_B, BENCH_K, BENCH_N, mac_rows)
    check_fire(card, rng, BENCH_B, BENCH_K, BENCH_N, fire_rows)
    check_mega(card, rng, BENCH_CASCADE, BENCH_B, mega_rows, cluster=2,
               fixed=(True, True, True))
    check_arbiter(card, rng, "arbiter", 16, 4, arbiter_rows)
    # B8 bit for bit over widths, ports, fills and group counts; the bench's
    # shape is timed above
    grid = [(w, ports, fill, n) for w in (32, 128, 1024)
            for ports in (1, 2, 4, 5, 8)
            for fill in ("random", "ones", "zeros") for n in (1, 16, 1000)]
    for width, ports, fill, n in grid:
        check_arbiter(card, rng, "arbiter", n, ports, arbiter_rows,
                      fill=fill, width=width, timed=False)
    print(f"arbiter: {len(grid)} cases (W 32/128/1024, ports 1/2/4/5/8, "
          "random/ones/zeros, G 1/16/1000) bit for bit", flush=True)
    matmul_rows, packed_mac_rows, if_rows = [], [], []
    # B10a and B10b: the bench's shape and 4096 x 768 -> 256 in four spike
    # widths, ragged shapes, N 10 and 77, K 40000, spike rows that start
    # 16-byte aligned and that do not (float32 and int8 views), all-zero
    # and all-one spikes, thresholds at the int32 extremes
    for fire in (False, True):
        for dtype_name in ("float32", "bfloat16", "int8", "bool"):
            for batch in (256, 4096):
                check_cim_matmul(card, rng, batch, 768, 256, matmul_rows,
                                 fire=fire, dtype_name=dtype_name)
        for batch, n_in, n_out in RAGGED_SHAPES + (
                (256, 768, 10), (1000, 768, 77), (37, 40000, 96)):
            check_cim_matmul(card, rng, batch, n_in, n_out, matmul_rows,
                             fire=fire)
        check_cim_matmul(card, rng, 37, 40000, 77, matmul_rows, fire=fire,
                         dtype_name="bool")
        for dtype_name, view in (("float32", (320, 50)),
                                 ("float32", (320, 64)),
                                 ("int8", (800, 3)), ("int8", (800, 16))):
            check_cim_matmul(card, rng, 45, 256, 96, matmul_rows, fire=fire,
                             dtype_name=dtype_name, view=view)
        for fill in ("zeros", "ones"):
            check_cim_matmul(card, rng, 37, 777, 96, matmul_rows, fire=fire,
                             fill=fill)
    for vth_fill in ("min", "max"):
        check_cim_matmul(card, rng, 37, 768, 96, matmul_rows, fire=True,
                         vth_fill=vth_fill)
    for batch, n_in, n_out in (((BENCH_B, BENCH_K, BENCH_N),) + RAGGED_SHAPES
                               + ((4096, 768, 256), (300, 768, 4096))):
        check_packed_mac(card, rng, batch, n_in, n_out, packed_mac_rows)
    # B9 and B9' on spike bits set past K (K 777 and 100: both must drop
    # them), on long inputs (K 40000, 157 K steps), and B9 on
    # weight views whose rows start 16-byte aligned (cp.async staging) or
    # not (byte loads)
    for batch, n_in, n_out in ((BENCH_B, 777, BENCH_N), (7, 100, 10),
                               (37, 40000, 96)):
        check_packed_mac(card, rng, batch, n_in, n_out, packed_mac_rows,
                         tail=True)
    for batch, n_in, n_out, pack in ((1000, 777, 256, True),
                                     (37, 100, 96, False),
                                     (37, 100, 96, True),
                                     (37, 40000, 96, True)):
        check_packed_fire(card, rng, batch, n_in, n_out, packed_rows,
                          pack_output=pack, tail=True)
    for n_out, view, pack in ((70, (80, 0), False), (64, (97, 1), True),
                              (64, (96, 32), True), (77, (77, 0), False)):
        check_packed_fire(card, rng, 77, 333, n_out, packed_rows,
                          pack_output=pack, tail=True, view=view)
    # B11 at the bench's and a streaming shape, then on both paths (4
    # neurons a load; one where N % 4 != 0 or an operand is not 16-byte
    # aligned), at T 0, 1 and past a span, past one wave of the card, on
    # views at an offset, at equality and under wraparound
    for batch, rounds, n in ((8, 32, 256), (1, 5, 10), (7, 3, 100),
                             (4096, 32, 256), (8, 32, 99), (8, 0, 256),
                             (8, 1, 256), (8, 37, 256), (6, 37, 99),
                             (3000, 3, 256), (2000, 2, 99)):
        check_if_neuron(card, rng, batch, rounds, n, if_rows)
    for batch, rounds, n, view in ((8, 37, 99, "row"), (8, 32, 99, "row"),
                                   (8, 37, 256, "row"), (8, 32, 256, "word"),
                                   (8, 32, 256, "vth")):
        check_if_neuron(card, rng, batch, rounds, n, if_rows, view=view)
    check_if_neuron(card, rng, 8, 3, 128, if_rows, fill="equal")
    check_if_neuron(card, rng, 8, 4, 128, if_rows, fill="wrap")
    check_if_neuron(card, rng, 8, 37, 256, if_rows, fill="wrap")
    check_if_neuron(card, rng, 8, 37, 99, if_rows, fill="wrap")

    # the round telemetry: tile_loads on a static round's four planes (B 8
    # to 128 and ragged), on an event round's tile 0 (T 4/8/16 x B 64), on
    # all-zero and all-one words and on a view that is not 16-byte
    # aligned; request_stats at the same rounds, every cell option, ragged
    # B, all-zero and all-full loads, with and without the logits
    tele_rows = []
    for batch in (8, 16, 32, 64, BUCKET, 7, 100, 333):
        check_tile_loads(card, rng, [(batch, w) for w in PAPER_WORDS],
                         tele_rows)
    for steps in EVENT_STEPS:
        check_tile_loads(card, rng, [(steps, EVENT_BATCH, PAPER_WORDS[0])],
                         tele_rows)
    for fill in ("zeros", "ones"):
        check_tile_loads(card, rng, [(BUCKET, w) for w in PAPER_WORDS],
                         tele_rows, fill=fill)
    check_tile_loads(card, rng, [(BUCKET + 1, w) for w in PAPER_WORDS],
                     tele_rows, shift=True)
    for batch in (8, 16, 32, 64, BUCKET, 1, 7, 100, 333):
        for ports in range(5):
            check_request_stats(card, rng, batch, tele_rows,
                                read_ports=ports)
    check_request_stats(card, rng, BUCKET, tele_rows, logits=False)
    for fill in ("zeros", "full"):
        for ports in (0, 4):
            check_request_stats(card, rng, BUCKET, tele_rows,
                                read_ports=ports, fill=fill)
    for steps in EVENT_STEPS:
        for batch in (EVENT_BATCH, 7):
            for ports in (0, 4):
                check_request_stats(card, rng, batch, tele_rows,
                                    read_ports=ports, steps=steps,
                                    logits=False)
    check_request_stats(card, rng, EVENT_BATCH, tele_rows, steps=1,
                        logits=False, fill="full")
    print(f"telemetry: {len(tele_rows)} cases bit for bit", flush=True)

    lap("3 kernels vs plain")

    # 4. the main path
    main_counts = serving_phase()
    from repro_torch.launch import serve as serve_mod
    from repro_torch.serve.engine import SpikeEngine, SpikeRequest

    spikes = serving_spikes()
    lap("4 serving")

    # 5. the one-tile path
    net1 = serve_mod.random_esam_network((768, 10), seed=1, device="cuda")
    reqs1 = [SpikeRequest(spikes=s) for s in spikes[:1000]]
    with PlainForbidden() as guard:
        eng1 = SpikeEngine(net1, max_batch=BUCKET, telemetry=True,
                           device="cuda")
        eng1.serve(reqs1)
    rounds1 = eng1.stats()["rounds_static"]
    guard.expect("one-tile path", {"popcount_mac": rounds1,
                                   "tile_loads": rounds1,
                                   "request_stats": rounds1})
    check_served(net1, spikes[:1000], reqs1, 4)
    mac_launches = guard.counts["popcount_mac"]
    print(f"one-tile path: {len(reqs1)} requests, {rounds1} rounds, "
          f"launches {guard.counts}", flush=True)

    lap("5 one-tile")

    # 6. the learning paths
    learn = learning_phase()
    lap("6 learning")

    # 7. the cycle plane
    cyc = cycle_phase()
    lap("7 cycle plane")

    # 8. the event path
    events_counts = events_phase()
    lap("8 events")

    # 9. the kernel bench path
    bench = bench_phase()
    lap("9 kernel bench")

    # 10. the fault plane
    faults_phase()
    lap("10 faults")

    # 11. the observability plane
    obs_phase()
    lap("11 observability")

    # 12. the paper benches, the online-learning example, the compile cache
    paper_benches_phase()
    lap("12 paper benches")

    # 13. each kernel at its path's shape, then the result
    def line(name, source, replaces, row, launches):
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/{source}",
                "replaces": f"src/repro/kernels/{replaces}",
                "launches": launches,
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"]}

    def pick(rows, shape, **match):
        return next(r for r in rows if r["shape"] == shape
                    and all(r.get(k) == v for k, v in match.items()))

    def pick_arbiter(name):
        """The sweep's first tile: 4096 digits x 6 row groups, 4 ports."""
        return next(r for r in arbiter_rows if r["kernel"] == name
                    and r["shape"] == f"{SWEEP_DIGITS * 6}x{ROW_GROUP}"
                    and r["ports"] == 4 and r["fill"] == "random")

    mega_row = next(r for r in mega_rows if r["batch"] == BUCKET
                    and r["topology"] == ":".join(map(str, PAPER_TOPOLOGY)))
    pop_src = "cim_popcount/csrc/cim_popcount.cu"
    stdp_src = "stdp/csrc/stdp.cu"
    packed_src = "cim_matmul_packed/csrc/cim_matmul_packed.cu"
    matmul_src = "cim_matmul/csrc/cim_matmul.cu"
    prefix_shape = f"{LEARN_TRAIN}x768->256"
    bench_shape = f"{BENCH_B}x{BENCH_K}->{BENCH_N}"
    print(json.dumps({"kernels": [
        line("mega_cascade", pop_src, "cim_popcount/ops.py:287",
             mega_row, main_counts["mega_cascade"]),
        line("popcount_fire", pop_src, "cim_popcount/ops.py:161",
             pick(fire_rows, prefix_shape, fill="random", stride_pad=0),
             learn["train"]["popcount_fire"]),
        line("popcount_mac", pop_src, "cim_popcount/ops.py:106",
             pick(mac_rows, f"{BUCKET}x768->10", fill="random",
                  stride_pad=0), mac_launches),
        line("stdp_epoch_masks", stdp_src, "stdp/kernel.py:117",
             pick(masks_rows, f"{LEARN_TRAIN}x256->10"),
             learn["train"]["stdp_epoch_masks"]),
        line("stdp_column_epoch", stdp_src, "stdp/kernel.py:117",
             pick(epoch_rows, f"{LEARN_TRAIN}x256->10", tied=False,
                  offset=True, special=False, key=[0, LEARN_TRAIN]),
             learn["train"]["stdp_column_epoch"]),
        line("stdp_column_event", stdp_src, "stdp/kernel.py:117",
             pick(event_rows, "10x256", pad=0, shift=False),
             bench["stdp_column_event"]),
        line("stdp_update", stdp_src, "stdp/kernel.py:59",
             pick(single_rows, "10x256"), bench["stdp_update"]),
        line("stdp_update_keys", stdp_src, "stdp/kernel.py:59",
             pick(update_rows, f"{LEARN_TRAIN}x256->10",
                  kernel="stdp_update_keys"),
             learn["scan"]["stdp_update_keys"]),
        line("stdp_update_masks", stdp_src, "stdp/kernel.py:59",
             pick(update_rows, f"{LEARN_TRAIN}x256->10",
                  kernel="stdp_update_masks"),
             learn["scan"]["stdp_update_masks"]),
        line("stdp_update_chain", stdp_src, "stdp/kernel.py:59",
             pick(update_rows, f"{LEARN_TRAIN}x256->10",
                  kernel="stdp_update_chain"),
             learn["scan"]["stdp_update_chain"]),
        line("fused_fire_packed", packed_src,
             "cim_matmul_packed/ops.py:131", pick(packed_rows, prefix_shape),
             learn["epoch"]["fused_fire_packed"]),
        line("port_schedule", "arbiter/csrc/arbiter.cu", "arbiter/kernel.py:100",
             pick_arbiter("port_schedule"), cyc["sweep"]["port_schedule"]),
        line("arbiter", "arbiter/csrc/arbiter.cu", "arbiter/kernel.py:135",
             next(r for r in arbiter_rows if r["kernel"] == "arbiter"
                  and r["shape"] == f"16x{ROW_GROUP}" and r["ports"] == 4),
             bench["arbiter"]),
        # no path runs the single step since the event round became one
        # scan: its count is the event path's, 0; check_lif holds its bits
        line("lif_step", "lif_step/csrc/lif_step.cu", "lif_step/kernel.py:85",
             next(r for r in lif_rows
                  if r["shape"] == f"{EVENT_BATCH}x256"
                  and r["leak"] == EVENT_LEAK and r["reset"] == "zero"
                  and r["refractory"] == 0),
             events_counts["lif_step"]),
        line("temporal_scan", "lif_step/csrc/lif_step.cu",
             "lif_step/kernel.py:85",
             next(r for r in scan_rows
                  if r["shape"] == f"16x{EVENT_BATCH}x256:256:256:10"
                  and r["reset"] == "zero" and r["refractory"] == 0),
             events_counts["temporal_scan"]),
        line("cim_matmul_packed", packed_src,
             "cim_matmul_packed/ops.py:77",
             pick(packed_mac_rows, bench_shape), bench["cim_matmul_packed"]),
        line("cim_matmul", matmul_src, "cim_matmul/kernel.py:90",
             pick(matmul_rows, "256x768->256", kernel="cim_matmul",
                  dtype="float32", view=None), bench["cim_matmul"]),
        line("esam_layer", matmul_src, "cim_matmul/kernel.py:129",
             pick(matmul_rows, "256x768->256", kernel="esam_layer",
                  dtype="float32", view=None), bench["esam_layer"]),
        line("if_neuron", "if_neuron/csrc/if_neuron.cu",
             "if_neuron/kernel.py:52",
             pick(if_rows, "8x32x256", fill="random", view=None),
             bench["if_neuron"]),
        # port-only kernels: no Pallas kernel stands behind them; they do
        # what XLA fused in the reference (the plan's group_popcount and
        # the engine's _stats_jit)
        {**line("tile_loads", "telemetry/csrc/telemetry.cu", "",
                pick(tele_rows, "+".join(f"{BUCKET}x{w}"
                                         for w in PAPER_WORDS),
                     fill="random", shift=False),
                main_counts["tile_loads"]),
         "replaces": "src/repro/core/packing.py:59 (group_popcount, fused "
                     "by XLA; no Pallas kernel)"},
        {**line("request_stats", "telemetry/csrc/telemetry.cu", "",
                pick(tele_rows, f"{BUCKET}", kernel="request_stats",
                     ports=4, fill="random", logits=True),
                main_counts["request_stats"]),
         "replaces": "src/repro/serve/engine.py:170 (_stats_jit, fused by "
                     "XLA; no Pallas kernel)"},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
