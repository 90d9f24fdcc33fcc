#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any failure raises, so the exit code is non-zero:

1. the card's name and power limit (``nvidia-smi``), torch and CUDA versions;
2. build the CUDA kernels from ``src/repro_torch/kernels/cim_popcount/csrc``;
3. each kernel against its plain PyTorch version on the card, bit for bit,
   at the main path's shapes and more, timed against its bound;
4. the main path: ``repro_torch.launch.serve --esam`` at the paper topology
   768:256:256:256:10, max_batch 128, telemetry on, 4096 digit requests,
   with the launch counters set to 0 just before and read just after; the
   served logits are held against the port's functional plan on the card and
   the per-request cycles and energy against the float64 cost model;
5. the one-tile path: a 768:10 network served through ``SpikeEngine``
   (``popcount_mac``), counted and checked the same way;
6. one JSON line of the kernels, then the result line.

It needs a CUDA device and exits non-zero without one.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
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

    def bound(self, n_bytes: float, n_popc: float) -> tuple[float, str]:
        t_bytes = n_bytes / HBM_BYTES_PER_S
        t_ops = n_popc / self.popc_per_s
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
    torch.backends.cuda.matmul.allow_tf32 = False
    s = packing.unpack_spikes(x, n_in, torch.float32)
    w = 2.0 * bits.to(torch.float32) - 1.0
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
        "library_ms": graph_ms(lambda: torch.matmul(s, w)),
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
    """Within the block, the wrappers' plain versions raise: the path being
    driven must go through the kernels."""

    def __enter__(self):
        from repro_torch.kernels.cim_popcount import ops

        self.ops = ops
        self.saved = (ops.esam_cascade_popcount_ref, ops.cim_popcount_ref)

        def forbid(*_a, **_k):
            raise AssertionError("a plain version ran on a CUDA path")

        ops.esam_cascade_popcount_ref = forbid
        ops.cim_popcount_ref = forbid
        ops.reset_launch_counts()
        return self

    def __exit__(self, *exc):
        self.counts = self.ops.launch_counts()
        self.ops.esam_cascade_popcount_ref, self.ops.cim_popcount_ref = (
            self.saved)
        return False


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script needs one",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.cim_popcount import _build

    # 1. the card
    print(nvidia_smi("name,power.limit"), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    card = Card()
    print(f"card: {card.sms} SMs, max SM clock {card.max_sm_mhz:.0f} MHz, "
          f"popc bound rate {card.popc_per_s:.4g}/s, "
          f"memory bound rate {HBM_BYTES_PER_S:.4g} B/s", flush=True)

    # 2. build
    t0 = time.perf_counter()
    kl = _build.load_library()
    print(f"build: {kl.path.name} nvcc {kl.build_s:.2f} s, loaded in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for line in kl.ptxas.splitlines():
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

    # 4. the main path
    from repro_torch.launch import serve as serve_mod
    from repro_torch.serve.engine import SpikeEngine, SpikeRequest

    with PlainForbidden() as guard:
        run = serve_mod.main(["--esam", "--requests", str(SERVE_REQUESTS),
                              "--device", "cuda"])
    st = run.engine.stats()
    rounds = run.warm_rounds + st["rounds_static"]
    if guard.counts["mega_cascade"] != rounds or guard.counts["popcount_mac"]:
        raise AssertionError(f"main path launches {guard.counts}, "
                             f"{rounds} rounds")
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
    if guard.counts["popcount_mac"] != rounds1 or guard.counts["mega_cascade"]:
        raise AssertionError(f"one-tile path launches {guard.counts}, "
                             f"{rounds1} rounds")
    check_served(net1, run.spikes[:1000], reqs1, 4)
    mac_launches = guard.counts["popcount_mac"]
    print(f"one-tile path: {len(reqs1)} requests, {rounds1} rounds, "
          f"launches {guard.counts}", flush=True)

    # 6. the kernels at the main path's round shape, then the result
    def line(name, replaces, row, launches):
        return {"name": name, "route": "cuda",
                "source": "src/repro_torch/kernels/cim_popcount/csrc/cim_popcount.cu",
                "replaces": replaces, "launches": launches,
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"]}

    mega_row = next(r for r in mega_rows if r["batch"] == BUCKET
                    and r["topology"] == ":".join(map(str, PAPER_TOPOLOGY)))
    mac_row = next(r for r in mac_rows if r["shape"] == f"{BUCKET}x768->10")
    print(json.dumps({"kernels": [
        line("mega_cascade", "src/repro/kernels/cim_popcount/kernel.py:98",
             mega_row, mega_launches),
        line("popcount_mac", "src/repro/kernels/cim_popcount/kernel.py:54",
             mac_row, mac_launches),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
