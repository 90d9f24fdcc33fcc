#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any failure raises, so the exit code is non-zero:

1. the card's name and power limit (``nvidia-smi``), torch and CUDA versions;
2. build the CUDA kernels from ``src/repro_torch/kernels/*/csrc`` (one
   ``nvcc`` per library, all started together);
3. each kernel against its plain PyTorch version on the card, bit for bit,
   at the paths' shapes and more, timed against its bound;
4. the serving path: ``repro_torch.launch.serve --esam`` at the paper
   topology 768:256:256:256:10, max_batch 128, telemetry on, 4096 digit
   requests, with the launch counters set to 0 just before and read just
   after; the served logits are held against the port's functional plan on
   the card and the per-request cycles and energy against the float64 cost
   model;
5. the one-tile path: a 768:10 network served through ``SpikeEngine``
   (``popcount_mac``), counted and checked the same way;
6. the learning path: ``repro_torch.train.online.train_online`` on the paper
   topology (4096 training and 1024 eval digits, 3 shuffled epochs,
   checkpoints), counted the same way (``popcount_fire`` per hidden tile and
   split, ``stdp_column_event`` twice per sample) and held bit for bit
   against the same call on the CPU (the plain versions); then
   ``learning.online_learning_epoch`` through the packed prefix
   (``fused_fire_packed``) and ``online_learning_epoch_scan`` with the matrix
   RNG (``stdp_update``), each against its CPU twin;
7. the cycle plane: the quickstart twin (``repro_torch.launch.quickstart``:
   BNN -> SNN -> packed plan -> cycle plan at 4 ports -> Fig 8) at the paper
   topology, one ``port_schedule`` launch per tile; the measured Fig 8 sweep
   (``port_sweep`` over cell options 0-4 on 4096 digits, 16 launches), its
   traces and system stats held against its CPU twin; the per-cycle V_mem
   trace at 1 and 4 ports on 256 digits against its CPU twin;
8. the event path: ``repro_torch.launch.serve --events`` (256 rate-encoded
   digit streams of T 4, 8 or 16, leak 0.125, max_batch 64, the paper
   topology, through ``SpikeEngine.submit_events`` and the temporal plan),
   counted the same way (``lif_step`` per hidden tile and step plus the
   readout's, ``popcount_mac`` once per round for tile 0 and per hidden tile
   and step); every stream's logits held bit for bit against the same
   streams served on the CPU, cycles and energy against the float64 cost
   model, and a T=1, zero-leak round against the packed plan;
9. one JSON line of the kernels, then the result line.

It needs a CUDA device and exits non-zero without one.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager, nullcontext
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

PAPER_TOPOLOGY = (768, 256, 256, 256, 10)
SERVE_REQUESTS = 4096
BUCKET = 128                   # the engine's max_batch: one round's batch
#: the 32-bit popc unit's issue rate per SM per clock on compute capability
#: 9.0 (CUDA C Programming Guide, arithmetic instruction throughput table)
POPC_PER_CLOCK_PER_SM = 16
#: device memory rate of an H100 SXM (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
#: dense int8 tensor-core rate of an H100 SXM (NVIDIA data sheet)
INT8_OPS_PER_S = 1979e12
#: float32 rate outside the tensor cores of an H100 SXM (NVIDIA data sheet)
F32_OPS_PER_S = 67e12

#: the learning path: the port's twin of examples/online_learning.py
LEARN_TRAIN, LEARN_EVAL, LEARN_EPOCHS = 4096, 1024, 3
LEARN_P_POT, LEARN_P_DEP = 0.2, 0.1
#: samples of the matrix-RNG scan path (two stdp_update launches each)
SCAN_SAMPLES = 64

#: the event path: round size (the launcher's max_batch), leak and the LIF
#: step's checked shapes (the event round's, a large one, ragged ones)
EVENT_BATCH, EVENT_LEAK = 64, 0.125
LIF_SHAPES = ((EVENT_BATCH, 256), (4096, 256), (1, 1), (7, 100))

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


def graph_ms(fn, calls: int = 20, replays: int = 7) -> float:
    """Device time of one ``fn()`` call: CUDA events around replays of a
    CUDA graph holding ``calls`` calls (host-side Python excluded); median
    over ``replays``.  Operands stay hot in L2, as in serving."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def call_ms(fn, calls: int = 50, replays: int = 7) -> float:
    """Time of one eager ``fn()`` call as a caller sees it (host-side
    wrapper work included): CUDA events around ``calls`` calls, median."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


class Card:
    """The card's rates the bounds are computed from."""

    def __init__(self):
        import torch

        props = torch.cuda.get_device_properties(0)
        self.sms = props.multi_processor_count
        self.max_sm_mhz = float(nvidia_smi("clocks.max.sm", units=False))
        self.popc_per_s = POPC_PER_CLOCK_PER_SM * self.sms * self.max_sm_mhz * 1e6

    def bound(self, n_bytes: float, n_ops: float,
              ops_per_s: float | None = None) -> tuple[float, str]:
        """(ms, what bounds it): the larger of bytes over the memory rate
        and operations over their rate (popc by default)."""
        t_bytes = n_bytes / HBM_BYTES_PER_S
        t_ops = n_ops / (ops_per_s or self.popc_per_s)
        return (max(t_bytes, t_ops) * 1e3,
                "bytes" if t_bytes >= t_ops else "operations")


def random_words(rng, batch: int, n: int):
    """int32 wire words of random spikes at p=0.5 (bit 31 set in about half
    of the full words); the tail past ``n`` is zero."""
    from repro_torch.core import packing

    return packing.words_from_np(
        packing.pack_spikes_np(rng.integers(0, 2, size=(batch, n))))


def check_mega(card, rng, topology, batch, kernels, sweep=()):
    """mega_cascade vs the plain cascade on the card at one shape; each
    ``block_b`` in ``sweep`` is checked and timed as well."""
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
    x = random_words(rng, batch, topology[0]).cuda()
    logits, fired = ops.esam_cascade_popcount(
        x, w_stack, vth_stack, topology=topology)
    ref_logits, ref_fired = ops.esam_cascade_popcount_ref(x, planes, vth)
    torch.cuda.synchronize()
    err = int((logits.long() - ref_logits.long()).abs().max()) if batch else 0
    fired_equal = all(torch.equal(a, b) for a, b in zip(fired, ref_fired))
    if err or not fired_equal or not torch.equal(logits, ref_logits):
        raise AssertionError(
            f"mega_cascade != plain at {topology} B={batch}: logits "
            f"max_abs_err={err}, fired planes equal={fired_equal}")
    g = ops.cascade_geometry(topology)
    hidden = topology[1:-1]
    n_bytes = 4 * (batch * g["w_words"][0]
                   + sum(n * w for n, w in zip(topology[1:], g["w_words"]))
                   + sum(hidden)
                   + batch * topology[-1] + batch * sum(h // 32 for h in hidden))
    n_popc = batch * (sum(n * w for n, w in zip(topology[1:], g["w_words"]))
                      + g["w_words"][0] + sum(h // 32 for h in hidden))
    bound_ms, bound_by = card.bound(n_bytes, n_popc)
    row = {
        "kernel": "mega_cascade", "topology": ":".join(map(str, topology)),
        "batch": batch, "max_abs_err": err, "fired_equal": fired_equal,
        "ms": graph_ms(lambda: ops.esam_cascade_popcount(
            x, w_stack, vth_stack, topology=topology)),
        "call_ms": call_ms(lambda: ops.esam_cascade_popcount(
            x, w_stack, vth_stack, topology=topology)),
        "plain_ms": graph_ms(lambda: ops.esam_cascade_popcount_ref(
            x, planes, vth)),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }
    print("kernel_check " + json.dumps(row), flush=True)
    kernels.append(row)
    for block_b in sweep:
        out = ops.esam_cascade_popcount(
            x, w_stack, vth_stack, topology=topology, block_b=block_b)
        if not (torch.equal(out[0], ref_logits) and all(
                torch.equal(a, b) for a, b in zip(out[1], ref_fired))):
            raise AssertionError(f"mega_cascade block_b={block_b} != plain")
        print("block_sweep " + json.dumps({
            "kernel": "mega_cascade", "batch": batch, "block_b": block_b,
            "ms": graph_ms(lambda: ops.esam_cascade_popcount(
                x, w_stack, vth_stack, topology=topology, block_b=block_b)),
        }), flush=True)


def check_mac(card, rng, batch, n_in, n_out, kernels):
    """popcount_mac vs the plain MAC on the card at one shape; the library
    yardstick is torch.matmul on the unpacked ±1 float32 operands."""
    import torch

    from repro_torch.core import packing
    from repro_torch.kernels.cim_popcount import ops

    bits = torch.from_numpy(
        rng.integers(0, 2, size=(n_in, n_out), dtype=np.int8)).cuda()
    planes = packing.pack_weight_planes(bits)
    x = random_words(rng, batch, n_in).cuda()
    out = ops.cim_popcount_matmul(x, planes)
    ref = ops.cim_popcount_ref(x, planes)
    s = packing.unpack_spikes(x, n_in, torch.float32)
    w = 2.0 * bits.to(torch.float32) - 1.0
    with tf32_off():
        lib = torch.matmul(s, w)
    torch.cuda.synchronize()
    err = int((out.long() - ref.long()).abs().max())
    if err or not torch.equal(out, ref) or not torch.equal(
            out, lib.to(torch.int32)):
        raise AssertionError(
            f"popcount_mac != plain at B={batch} {n_in}->{n_out}: "
            f"max_abs_err={err}")
    words = packing.packed_width(n_in)
    n_bytes = 4 * (batch * words + n_out * words + batch * n_out)
    n_popc = batch * n_out * words + batch * words
    bound_ms, bound_by = card.bound(n_bytes, n_popc)
    row = {
        "kernel": "popcount_mac", "shape": f"{batch}x{n_in}->{n_out}",
        "batch": batch, "max_abs_err": err,
        "ms": graph_ms(lambda: ops.cim_popcount_matmul(x, planes)),
        "call_ms": call_ms(lambda: ops.cim_popcount_matmul(x, planes)),
        "plain_ms": graph_ms(lambda: ops.cim_popcount_ref(x, planes)),
        "bound_ms": bound_ms, "bound_by": bound_by,
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


def check_fire(card, rng, batch, n_in, n_out, kernels, pack_output=True):
    """popcount_fire (one tile's MAC, fire, re-pack) vs its plain version."""
    import torch

    from repro_torch.core import packing
    from repro_torch.kernels.cim_popcount import ops

    bits = torch.from_numpy(
        rng.integers(0, 2, size=(n_in, n_out), dtype=np.int8)).cuda()
    planes = packing.pack_weight_planes(bits)
    vth = torch.from_numpy(
        rng.integers(-8, 9, size=(n_out,), dtype=np.int32)).cuda()
    x = random_words(rng, batch, n_in).cuda()

    def run():
        return ops.esam_layer_popcount(x, planes, vth, pack_output=pack_output)

    out = run()
    ref = ops.esam_layer_popcount_ref(x, planes, vth, pack_output=pack_output)
    torch.cuda.synchronize()
    err = _word_err(out, ref)
    if err or not torch.equal(out, ref):
        raise AssertionError(f"popcount_fire != plain at B={batch} "
                             f"{n_in}->{n_out} pack={pack_output}: err={err}")
    words = packing.packed_width(n_in)
    out_bytes = batch * (n_out // 8 if pack_output else n_out)
    n_bytes = 4 * (batch * words + n_out * words + n_out) + out_bytes
    bound_ms, bound_by = card.bound(n_bytes, batch * n_out * words + batch * words)
    row = {
        "kernel": "popcount_fire", "shape": f"{batch}x{n_in}->{n_out}",
        "pack_output": pack_output, "batch": batch, "max_abs_err": err,
        "ms": graph_ms(run), "call_ms": call_ms(run),
        "plain_ms": graph_ms(lambda: ops.esam_layer_popcount_ref(
            x, planes, vth, pack_output=pack_output)),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": _matmul_yardstick(x, bits, n_in),
    }
    print("kernel_check " + json.dumps(row), flush=True)
    kernels.append(row)


def check_packed_fire(card, rng, batch, n_in, n_out, kernels,
                      pack_output=True):
    """fused_fire_packed (spike words x {0,1} int8 weights, fire, re-pack)
    vs its plain version."""
    import torch

    from repro_torch.core import packing
    from repro_torch.kernels.cim_matmul_packed import ops

    bits = torch.from_numpy(
        rng.integers(0, 2, size=(n_in, n_out), dtype=np.int8)).cuda()
    vth = torch.from_numpy(
        rng.integers(-8, 9, size=(n_out,), dtype=np.int32)).cuda()
    x = random_words(rng, batch, n_in).cuda()

    def run():
        return ops.esam_layer_packed(x, bits, vth, pack_output=pack_output)

    out = run()
    ref = ops.esam_layer_packed_ref(x, bits, vth, pack_output=pack_output)
    torch.cuda.synchronize()
    err = _word_err(out, ref)
    if err or not torch.equal(out, ref):
        raise AssertionError(f"fused_fire_packed != plain at B={batch} "
                             f"{n_in}->{n_out} pack={pack_output}: err={err}")
    words = packing.packed_width(n_in)
    out_bytes = batch * (n_out // 8 if pack_output else n_out)
    n_bytes = 4 * batch * words + n_in * n_out + 4 * n_out + out_bytes
    # the data's work: one multiply-add per active synapse
    active = int(packing.popcount32(x).sum())
    bound_ms, bound_by = card.bound(n_bytes, 2 * active * n_out,
                                    INT8_OPS_PER_S)
    row = {
        "kernel": "fused_fire_packed", "shape": f"{batch}x{n_in}->{n_out}",
        "pack_output": pack_output, "batch": batch, "max_abs_err": err,
        "ms": graph_ms(run), "call_ms": call_ms(run),
        "plain_ms": graph_ms(lambda: ops.esam_layer_packed_ref(
            x, bits, vth, pack_output=pack_output)),
        "bound_ms": bound_ms, "bound_by": bound_by,
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


def check_column_event(card, rng, n_out, n_in, kernels):
    """stdp_column_event (one row, in place, index and gate on the device)
    vs its plain version: the teacher event and the wrong-winner event
    (p_pot 0, inverted trace), gated on and off."""
    import torch

    from repro_torch.kernels.stdp import ops

    bits_t, pre, u_pot, u_dep = _stdp_operands(rng, n_out, n_in, (n_in,))
    col = torch.tensor(n_out // 2, device="cuda")
    err = 0
    for apply in (True, False):
        gate = torch.tensor(apply, device="cuda")
        for trace, p_pot in ((pre, LEARN_P_POT), (~pre, 0.0)):
            got = ops.stdp_column_event(
                bits_t.clone(), col, gate, trace, u_pot, u_dep,
                p_pot=p_pot, p_dep=LEARN_P_DEP)
            want = ops.stdp_column_event_ref(
                bits_t, col, gate, trace, u_pot, u_dep, p_pot, LEARN_P_DEP)
            err = max(err, _word_err(got, want))
            if not torch.equal(got, want):
                raise AssertionError(
                    f"stdp_column_event != plain at [{n_out}, {n_in}] "
                    f"apply={apply} p_pot={p_pot}")
    gate = torch.tensor(True, device="cuda")
    work = bits_t.clone()

    def run():
        return ops.stdp_column_event(work, col, gate, pre, u_pot, u_dep,
                                     p_pot=LEARN_P_POT, p_dep=LEARN_P_DEP)

    # one row read and written, the trace, two uniforms, index and gate
    n_bytes = n_in * (1 + 1 + 4 + 4 + 1) + 8 + 1
    bound_ms, bound_by = card.bound(n_bytes, 4 * n_in, F32_OPS_PER_S)
    row = {
        "kernel": "stdp_column_event", "shape": f"{n_out}x{n_in}",
        "max_abs_err": err, "ms": graph_ms(run), "call_ms": call_ms(run),
        "plain_ms": graph_ms(lambda: ops.stdp_column_event_ref(
            bits_t, col, gate, pre, u_pot, u_dep, LEARN_P_POT, LEARN_P_DEP)),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }
    print("kernel_check " + json.dumps(row), flush=True)
    kernels.append(row)


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


def _requests(rng, n: int, fill: str):
    """{0,1} request rows [n, 128] on the card: random at p=0.5, or all
    zeros, or all ones."""
    import torch

    if fill == "zeros":
        return torch.zeros((n, ROW_GROUP), dtype=torch.bool, device="cuda")
    if fill == "ones":
        return torch.ones((n, ROW_GROUP), dtype=torch.bool, device="cuda")
    return torch.from_numpy(rng.random((n, ROW_GROUP)) < 0.5).cuda()


def check_arbiter(card, rng, name, n, ports, kernels, fill="random"):
    """port_schedule or arbiter vs its plain version on the card, bit for
    bit (values and dtypes), timed against its bound."""
    import torch

    from repro_torch.kernels.arbiter import ops

    fn, ref = ((ops.port_schedule, ops.port_schedule_ref)
               if name == "port_schedule" else (ops.arbiter, ops.arbiter_ref))
    r = _requests(rng, n, fill)

    def run():
        return fn(r, ports=ports)

    got, want = run(), ref(r, ports)
    torch.cuda.synchronize()
    err = max(_word_err(a, b) for a, b in zip(got, want))
    if err or not all(a.dtype == b.dtype and torch.equal(a, b)
                      for a, b in zip(got, want)):
        raise AssertionError(f"{name} != plain at [{n}, {ROW_GROUP}] "
                             f"p={ports} {fill}: max_abs_err={err}")
    # each request byte read once, each output written once; two popcs a
    # lane and 32-lane sub-block (its rank and its sub-block's total)
    lanes = n * ROW_GROUP
    if name == "port_schedule":
        n_bytes = lanes + 4 * lanes + 4 * n * -(-ROW_GROUP // ports)
    else:
        n_bytes = lanes + ports * lanes + lanes + n * ports
    bound_ms, bound_by = card.bound(n_bytes, 2 * lanes)
    row = {
        "kernel": name, "shape": f"{n}x{ROW_GROUP}", "ports": ports,
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


def profile_serve(net, spikes) -> None:
    """Where a drain's time goes on the device: the main path's traffic
    served once more under torch.profiler; prints device time per kernel
    name and the device's busy share of that same profiled drain's wall
    time (profiler overhead included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import SpikeEngine, SpikeRequest

    eng = SpikeEngine(net, max_batch=BUCKET, telemetry=True, device="cuda")
    reqs = [SpikeRequest(spikes=s) for s in spikes]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.serve(reqs)
        profiled_wall_s = time.perf_counter() - t0
    on_device = [e for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    device_s = sum(e.self_device_time_total for e in on_device) / 1e6
    top = sorted(on_device, key=lambda e: -e.self_device_time_total)[:10]
    print("profile " + json.dumps({
        "requests": len(reqs), "rounds": eng.stats()["rounds_static"],
        "device_s": device_s, "profiled_wall_s": profiled_wall_s,
        "device_busy_share": device_s / profiled_wall_s,
        "device_kernels": len(on_device),
        "device_launches": sum(e.count for e in on_device),
        "top": [{"name": e.key[:60], "count": e.count,
                 "device_ms": e.self_device_time_total / 1e3} for e in top],
    }), flush=True)


class PlainForbidden:
    """Within the block, every wrapper's plain version raises: the path
    being driven must go through the kernels.  Every launch count is set to
    0 on entry; ``counts`` holds them all on exit."""

    #: (kernel module, its plain versions that the wrappers dispatch to)
    PLAIN = (
        ("repro_torch.kernels.lif_step.ops", ("lif_step_ref",)),
        ("repro_torch.kernels.cim_popcount.ops",
         ("esam_cascade_popcount_ref", "cim_popcount_ref",
          "esam_layer_popcount_ref")),
        ("repro_torch.kernels.cim_matmul_packed.ops",
         ("esam_layer_packed_ref",)),
        ("repro_torch.kernels.stdp.ops",
         ("stdp_column_event_ref", "stdp_update_ref")),
        ("repro_torch.kernels.arbiter.ops",
         ("port_schedule_ref", "arbiter_ref")),
    )

    def __enter__(self):
        import importlib

        def forbid(*_a, **_k):
            raise AssertionError("a plain version ran on a CUDA path")

        self.mods = [importlib.import_module(m) for m, _ in self.PLAIN]
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
        "popcount_fire": 2 * hidden,
        "stdp_column_event": 2 * len(y) * LEARN_EPOCHS})
    return gpu, cpu, guard.counts


def profile_learning(net, pre, y, n: int = 512) -> None:
    """Where a learning epoch's time goes: ``column_event_epoch`` on ``n``
    samples under torch.profiler; device time, busy share of the same wall,
    launches per sample."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import prng
    from repro_torch.core.esam import learning

    bits_t = net.weight_bits[-1].T.contiguous()
    key = prng.PRNGKey(10).cuda()
    learning.column_event_epoch(bits_t.clone(), pre[:8], y[:8], key,
                                p_pot=LEARN_P_POT, p_dep=LEARN_P_DEP)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        learning.column_event_epoch(bits_t, pre[:n], y[:n], key,
                                    p_pot=LEARN_P_POT, p_dep=LEARN_P_DEP,
                                    out_offset=net.out_offset)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    on_device = [e for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    device_s = sum(e.self_device_time_total for e in on_device) / 1e6
    launches = sum(e.count for e in on_device)
    top = sorted(on_device, key=lambda e: -e.self_device_time_total)[:8]
    print("learning_profile " + json.dumps({
        "samples": n, "device_s": device_s, "profiled_wall_s": wall_s,
        "device_busy_share": device_s / wall_s,
        "device_launches": launches, "launches_per_sample": launches / n,
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
    c4, c0 = learning.column_update_cost(4), learning.column_update_cost(0)
    for epoch, (acc, n, sec, sec_cpu) in enumerate(zip(
            gpu.accuracy, gpu.n_updates, gpu.epoch_s, cpu.epoch_s)):
        print("learning_epoch " + json.dumps({
            "epoch": epoch, "accuracy": acc, "column_updates": n,
            "wall_s": sec, "samples_per_s": LEARN_TRAIN / sec,
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
        "fused_fire_packed": hidden, "stdp_column_event": 2 * LEARN_TRAIN})
    counts_epoch = guard.counts
    print(f"online_learning_epoch: {LEARN_TRAIN} samples, "
          f"{out['cuda'][1]} column updates, wall {out['cuda'][2]:.3f} s "
          f"(CPU twin {out['cpu'][2]:.3f} s), launches {counts_epoch}, "
          "identical to the CPU twin", flush=True)

    # the full-matrix plane with the matrix RNG (stdp_update)
    for device in ("cuda", "cpu"):
        net = paper_network(device)
        pre = learning.last_hidden_spikes(net.weight_bits, net.vth,
                                          x[:SCAN_SAMPLES])
        with PlainForbidden() if device == "cuda" else nullcontext() as guard:
            bits, n = learning.online_learning_epoch_scan(
                net.weight_bits, net.vth, None, y[:SCAN_SAMPLES],
                prng.PRNGKey(11), p_pot=LEARN_P_POT, p_dep=LEARN_P_DEP,
                pre_spikes=pre, rng_scheme="matrix")
            n = int(n)
        out[device] = (bits.cpu(), n, 0.0, guard)
    if not torch.equal(out["cuda"][0], out["cpu"][0]) or (
            out["cuda"][1] != out["cpu"][1]):
        raise AssertionError("online_learning_epoch_scan differs card vs CPU")
    guard = out["cuda"][3]
    guard.expect("scan path", {"stdp_update": 2 * SCAN_SAMPLES})
    counts_scan = guard.counts
    print(f"scan path (matrix RNG): {SCAN_SAMPLES} samples, {out['cuda'][1]} "
          f"column updates, launches {counts_scan}, identical to the CPU twin",
          flush=True)

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


def _rounds_and_steps(requests, max_batch: int) -> tuple[int, int]:
    """(rounds, sum over rounds of T) of one event drain: streams that share
    T go out in rounds of at most ``max_batch``."""
    by_t: dict[int, int] = {}
    for r in requests:
        by_t[r.n_steps] = by_t.get(r.n_steps, 0) + 1
    rounds = {t: -(-n // max_batch) for t, n in by_t.items()}
    return sum(rounds.values()), sum(t * k for t, k in rounds.items())


def profile_events(net, requests, temporal) -> dict:
    """Where an event drain's time goes: the timed streams served once more
    under torch.profiler; device time per kernel, busy share of the same
    profiled wall, launches per round."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve.engine import EventRequest, SpikeEngine

    eng = SpikeEngine(net, max_batch=EVENT_BATCH, telemetry=True,
                      temporal=temporal, device="cuda")
    reqs = [EventRequest(events=r.events) for r in requests]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.serve(reqs)
        wall_s = time.perf_counter() - t0
    on_device = [e for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    device_s = sum(e.self_device_time_total for e in on_device) / 1e6
    launches = sum(e.count for e in on_device)
    rounds = eng.stats()["rounds_event"]
    top = sorted(on_device, key=lambda e: -e.self_device_time_total)[:10]
    row = {
        "streams": len(reqs), "rounds": rounds,
        "timesteps": eng.stats()["timesteps_total"], "device_s": device_s,
        "profiled_wall_s": wall_s, "device_busy_share": device_s / wall_s,
        "device_launches": launches, "launches_per_round": launches / rounds,
        "top": [{"name": e.key[:60], "count": e.count,
                 "device_ms": e.self_device_time_total / 1e3} for e in top],
    }
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
    from repro_torch.launch import serve as serve_mod
    from repro_torch.serve.engine import EventRequest, SpikeEngine

    with PlainForbidden() as guard:
        run = serve_mod.main(["--events", "--device", "cuda"])
        torch.cuda.synchronize()
    eng, st = run.engine, run.engine.stats()
    hidden = len(PAPER_TOPOLOGY) - 2
    warm_rounds, warm_steps = _rounds_and_steps(run.warm_requests,
                                                eng.max_batch)
    rounds, steps = _rounds_and_steps(run.requests, eng.max_batch)
    if (run.net.topology != PAPER_TOPOLOGY or eng.max_batch != EVENT_BATCH
            or eng._temporal.leak != EVENT_LEAK or st["rounds_event"] != rounds
            or run.warm_engine.stats()["rounds_event"] != warm_rounds):
        raise AssertionError(f"event path: topology {run.net.topology}, "
                             f"max_batch {eng.max_batch}, {eng._temporal}, "
                             f"rounds {st['rounds_event']} != {rounds}")
    guard.expect("event path", {
        "lif_step": (hidden + 1) * (warm_steps + steps),
        "popcount_mac": warm_rounds + rounds + hidden * (warm_steps + steps)})

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

    # T=1, no leak, reset to zero: the packed plan's logits
    first = [EventRequest(events=r.events[:1]) for r in
             run.requests[:EVENT_BATCH]]
    with PlainForbidden() as guard1:
        SpikeEngine(run.net, max_batch=EVENT_BATCH, device="cuda").serve(first)
        torch.cuda.synchronize()
    guard1.expect("T=1 round", {"lif_step": hidden + 1,
                                "popcount_mac": 1 + hidden})
    packed = run.net.plan(mode="packed")(packing.words_from_np(
        np.stack([r.events[0] for r in first])).cuda()).logits.cpu().numpy()
    if not np.array_equal(np.stack([r.logits for r in first]), packed):
        raise AssertionError("T=1 event round differs from the packed plan")

    rest = run.wall_s - st["host_pack_s_total"] - st["dispatch_s_total"]
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
        "launches": guard.counts}), flush=True)
    profile_events(run.net, run.requests, eng._temporal)
    return guard.counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script needs one",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    # 1. the card
    print(nvidia_smi("name,power.limit"), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    card = Card()
    print(f"card: {card.sms} SMs, max SM clock {card.max_sm_mhz:.0f} MHz, "
          f"popc bound rate {card.popc_per_s:.4g}/s, "
          f"memory bound rate {HBM_BYTES_PER_S:.4g} B/s", flush=True)

    # 2. build: one nvcc per library, all started together
    t0 = time.perf_counter()
    reports = _build.build_all()
    print(f"build: {len(reports)} libraries in "
          f"{time.perf_counter() - t0:.2f} s wall", flush=True)
    for rep in reports:
        print(f"build: {rep.path.name} nvcc {rep.build_s:.2f} s", flush=True)
        for line in rep.ptxas.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("ptxas: " + line.strip(), flush=True)

    # 3. kernels vs plain, on the card
    rng = np.random.default_rng(2024)
    mega_rows, mac_rows = [], []
    for batch in (1, 7, BUCKET, 1000, SERVE_REQUESTS):
        check_mega(card, rng, PAPER_TOPOLOGY, batch, mega_rows,
                   sweep=(1, 2, 4, 8, 16, 32)
                   if batch in (BUCKET, SERVE_REQUESTS) else ())
    check_mega(card, rng, (768, 256, 10), BUCKET, mega_rows)
    check_mac(card, rng, BUCKET, 768, 10, mac_rows)
    check_mac(card, rng, 37, 100, 77, mac_rows)
    fire_rows, packed_rows, event_rows, update_rows = [], [], [], []
    for check, rows in ((check_fire, fire_rows),
                        (check_packed_fire, packed_rows)):
        check(card, rng, LEARN_TRAIN, 768, 256, rows)
        check(card, rng, LEARN_TRAIN, 256, 256, rows)
        check(card, rng, 1000, 777, 256, rows)
        check(card, rng, 37, 100, 96, rows, pack_output=False)
    for n_out, n_in in ((10, 256), (256, 768)):
        check_column_event(card, rng, n_out, n_in, event_rows)
        check_stdp_update(card, rng, n_out, n_in, update_rows)
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
    # popcount_mac at the event path's shapes: tile 0 over a T=16 round,
    # a hidden tile and the readout over one step
    for batch, n_in, n_out in ((16 * EVENT_BATCH, 768, 256),
                               (EVENT_BATCH, 256, 256),
                               (EVENT_BATCH, 256, 10)):
        check_mac(card, rng, batch, n_in, n_out, mac_rows)

    # 4. the main path
    from repro_torch.launch import serve as serve_mod
    from repro_torch.serve.engine import SpikeEngine, SpikeRequest

    with PlainForbidden() as guard:
        run = serve_mod.main(["--esam", "--requests", str(SERVE_REQUESTS),
                              "--device", "cuda"])
    st = run.engine.stats()
    rounds = run.warm_rounds + st["rounds_static"]
    guard.expect("serving path", {"mega_cascade": rounds})
    if run.net.topology != PAPER_TOPOLOGY:
        raise AssertionError(f"served topology {run.net.topology}")
    check_served(run.net, run.spikes, run.requests, 4)
    mega_launches = guard.counts["mega_cascade"]
    print(f"main path: {len(run.requests)} requests, {rounds} rounds, "
          f"launches {guard.counts}, "
          f"{len(run.requests) / run.wall_s:.1f} req/s wall, "
          f"model {st['throughput_pipelined_inf_s'] / 1e6:.3f} MInf/s, "
          f"{st['energy_pj_per_inf']:.3f} pJ/Inf", flush=True)
    profile_serve(run.net, run.spikes)
    print("main path host split: " + json.dumps({
        "wall_s": run.wall_s, "host_pack_s": st["host_pack_s_total"],
        "dispatch_s": st["dispatch_s_total"],
        "flush_and_rest_s": run.wall_s - st["host_pack_s_total"]
        - st["dispatch_s_total"],
        "rounds": st["rounds_static"]}), flush=True)

    # 5. the one-tile path
    net1 = serve_mod.random_esam_network((768, 10), seed=1, device="cuda")
    reqs1 = [SpikeRequest(spikes=s) for s in run.spikes[:1000]]
    with PlainForbidden() as guard:
        eng1 = SpikeEngine(net1, max_batch=BUCKET, telemetry=True,
                           device="cuda")
        eng1.serve(reqs1)
    rounds1 = eng1.stats()["rounds_static"]
    guard.expect("one-tile path", {"popcount_mac": rounds1})
    check_served(net1, run.spikes[:1000], reqs1, 4)
    mac_launches = guard.counts["popcount_mac"]
    print(f"one-tile path: {len(reqs1)} requests, {rounds1} rounds, "
          f"launches {guard.counts}", flush=True)

    # 6. the learning paths
    learn = learning_phase()

    # 7. the cycle plane
    cyc = cycle_phase()

    # 8. the event path
    events_counts = events_phase()

    # 9. each kernel at its path's shape, then the result
    def line(name, source, replaces, row, launches):
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/{source}",
                "replaces": f"src/repro/kernels/{replaces}",
                "launches": launches,
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"]}

    def pick(rows, shape):
        return next(r for r in rows if r["shape"] == shape)

    def pick_arbiter(name):
        """The sweep's first tile: 4096 digits x 6 row groups, 4 ports."""
        return next(r for r in arbiter_rows if r["kernel"] == name
                    and r["shape"] == f"{SWEEP_DIGITS * 6}x{ROW_GROUP}"
                    and r["ports"] == 4 and r["fill"] == "random")

    mega_row = next(r for r in mega_rows if r["batch"] == BUCKET
                    and r["topology"] == ":".join(map(str, PAPER_TOPOLOGY)))
    pop_src = "cim_popcount/csrc/cim_popcount.cu"
    stdp_src = "stdp/csrc/stdp.cu"
    prefix_shape = f"{LEARN_TRAIN}x768->256"
    print(json.dumps({"kernels": [
        line("mega_cascade", pop_src, "cim_popcount/kernel.py:98",
             mega_row, mega_launches),
        line("popcount_fire", pop_src, "cim_popcount/kernel.py:74",
             pick(fire_rows, prefix_shape),
             learn["train"]["popcount_fire"]),
        line("popcount_mac", pop_src, "cim_popcount/kernel.py:54",
             pick(mac_rows, f"{BUCKET}x768->10"), mac_launches),
        line("stdp_column_event", stdp_src, "stdp/kernel.py:75",
             pick(event_rows, "10x256"),
             learn["train"]["stdp_column_event"]),
        line("stdp_update", stdp_src, "stdp/kernel.py:26",
             pick(update_rows, "10x256"), learn["scan"]["stdp_update"]),
        line("fused_fire_packed", "cim_matmul_packed/csrc/cim_matmul_packed.cu",
             "cim_matmul_packed/kernel.py:66", pick(packed_rows, prefix_shape),
             learn["epoch"]["fused_fire_packed"]),
        line("port_schedule", "arbiter/csrc/arbiter.cu", "arbiter/kernel.py:51",
             pick_arbiter("port_schedule"), cyc["sweep"]["port_schedule"]),
        line("arbiter", "arbiter/csrc/arbiter.cu", "arbiter/kernel.py:33",
             pick_arbiter("arbiter"), cyc["sweep"]["arbiter"]),
        line("lif_step", "lif_step/csrc/lif_step.cu", "lif_step/kernel.py:38",
             next(r for r in lif_rows
                  if r["shape"] == f"{EVENT_BATCH}x256"
                  and r["leak"] == EVENT_LEAK and r["reset"] == "zero"
                  and r["refractory"] == 0),
             events_counts["lif_step"]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
