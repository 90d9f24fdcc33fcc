"""Paper Fig 8 of the port: system-level power, throughput, energy and area
across the five SRAM cell options, driven by the rank-schedule cycle plane;
the twin of the reference's ``benchmarks/bench_system.py``.

    python -m repro_torch.launch.bench_system                 # on the card
    python -m repro_torch.launch.bench_system --device cpu

Four parts, at the reference's batch of 256:

``fig8_ref_*``       the cost model on the calibration activity profile.
``fig8_sim_*``       ``simulate_tile_batch`` on B5 ``port_schedule`` (one
    launch a tile and cell option: 20) over a batch pinned to the same
    profile (``bernoulli(fold_in(PRNGKey(0), t), 0.5)`` bits); every
    simulated drain is asserted equal to max ⌈load / p⌉, and the sweep of
    the drained loads reproduces the 3.1x / 2.2x headline.
``fig8_measured_*``  ``port_sweep`` (cell options 0-4: 16 ``port_schedule``
    launches a call, timed by ``time_call``: 4 calls) on 256 digits
    (``seed=3``) through the ``fold_in(PRNGKey(1), i)`` paper network,
    its 4-port logits asserted equal to the functional plan's, and the
    sweep of its measured loads (``port_sweep_batched`` times the call).
``plane_speedup_batch256``  the B5 plane (4 calls) against the plain
    ``simulate_tile_scan_batch``, one arbiter round a cycle in PyTorch,
    on tile 0 at 4 ports: bit for bit (V_mem and grants a cycle), and the
    wall-clock ratio.  The scan oracle runs on the card because the
    reference's bench times that oracle.

The reference's four acceptance assertions are kept and raise, naming
every one that failed: the simulated sweep's speedup and energy
efficiency within 5 % of the paper's, equal to the calibration sweep's,
and the plane at least ``PLANE_FLOOR`` (10x) faster than the scan.
Rows go to stdout as ``name,us_per_call,derived``; ``--out`` writes
``{"results": [...]}`` (before the assertions, as the reference does).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.esam import cost_model as cm
from repro_torch.core.esam import tile as tile_mod
from repro_torch.core.esam.network import (EsamNetwork, reference_activity,
                                           system_stats)
from repro_torch.data import digits
from repro_torch.kernels.common import resolve_device
from repro_torch.launch.bench_common import Recorder, time_call

BATCH = 256
#: the rank-schedule plane must beat the scan oracle by this much
PLANE_FLOOR = 10.0
#: the port counts a five-option sweep simulates (0 and 1 share one)
SWEEP_PORT_COUNTS = 4


def _emit_sweep(rec: Recorder, tag: str, activity) -> tuple[float, float]:
    """The five cell options and the headline ratios of one profile."""
    stats = [system_stats(cm.PAPER_TOPOLOGY, activity, p) for p in range(5)]
    for s in stats:
        rec.emit(
            f"fig8_{tag}_{s.cell}", 0.0,
            f"throughput_minf_s={s.throughput_inf_s / 1e6:.2f};"
            f"energy_pj_inf={s.energy_pj_per_inf:.0f};"
            f"power_mw={s.power_mw:.1f};area_ratio={s.area_ratio_vs_1rw:.2f};"
            f"latency_ns={s.latency_ns:.1f};"
            f"bottleneck_tile={s.bottleneck_tile}")
    speedup = stats[4].throughput_inf_s / stats[0].throughput_inf_s
    eff = stats[0].energy_pj_per_inf / stats[4].energy_pj_per_inf
    rec.emit(
        f"fig8_{tag}_headline", 0.0,
        f"speedup_4r={speedup:.2f}x(paper {cm.PAPER_SPEEDUP_4R}x);"
        f"energy_eff_4r={eff:.2f}x(paper {cm.PAPER_ENERGY_EFF_4R}x)")
    return speedup, eff


def reference_profile_spikes(n_in: int, per_group: int,
                             batch: int) -> np.ndarray:
    """bool[batch, n_in] with exactly ``per_group`` spikes a 128-row group,
    rolled by the sample index (the arbiters see varied requests at a
    pinned load)."""
    n_groups = n_in // 128
    base = np.zeros((n_groups, 128), bool)
    base[:, :per_group] = True
    out = np.stack([np.roll(base, i, axis=1) for i in range(batch)])
    return out.reshape(batch, n_in)


def _simulated_reference_sweep(rec: Recorder, dev, batch: int):
    """The rank-schedule plane at the calibration loads, tile by tile, and
    the Fig 8 sweep of the loads it drained."""
    key = prng.PRNGKey(0, dev)
    topo = cm.PAPER_TOPOLOGY
    measured = []
    for t in range(len(topo) - 1):
        n_in, n_out = topo[t], topo[t + 1]
        bits = prng.bernoulli(prng.fold_in(key, t), 0.5,
                              (n_in, n_out)).to(torch.int8)
        vth = torch.zeros((n_out,), dtype=torch.int32, device=dev)
        spikes_np = reference_profile_spikes(
            n_in, cm.REF_SPIKES_PER_GROUP[t], batch)
        spikes = torch.from_numpy(spikes_np).to(dev)
        loads = spikes_np.astype(np.int32).reshape(batch, -1, 128).sum(-1)
        for p in range(5):
            ports = max(1, p)
            tr = tile_mod.simulate_tile_batch(bits, spikes, vth, ports)
            rec.launched(dev, {"port_schedule": 1})
            # every simulated drain lands on the cost model's cycle count
            want = np.ceil(loads / ports).max(axis=1).astype(np.int32)
            np.testing.assert_array_equal(tr.cycles.cpu().numpy(), want)
        measured.append(loads.astype(np.float64))
    return _emit_sweep(rec, "sim", measured)


def _measured_network_sweep(rec: Recorder, dev, batch: int):
    """Fig 8 on measured activity: one ``port_sweep`` through the paper
    network on the digits, loads from its traces."""
    key = prng.PRNGKey(1, dev)
    topo = cm.PAPER_TOPOLOGY
    bits = [prng.bernoulli(prng.fold_in(key, i), 0.5,
                           (topo[i], topo[i + 1])).to(torch.int8)
            for i in range(len(topo) - 1)]
    vth = [torch.zeros((n,), dtype=torch.int32) for n in topo[1:]]
    net = EsamNetwork(bits, vth, torch.zeros((topo[-1],)), device=dev)
    x, _ = digits.make_spike_dataset(batch, seed=3)
    spikes = torch.from_numpy(x != 0).to(dev)

    us, sweep = time_call(net.port_sweep, spikes, range(5), device=dev)
    rec.launched(dev, {"port_schedule": SWEEP_PORT_COUNTS * (len(topo) - 1)},
                 calls=4)
    logits4 = sweep[4][0]
    if not torch.equal(logits4, net.plan(mode="functional")(spikes).logits):
        raise AssertionError("the sweep's 4-port logits differ from the "
                             "functional plan's")
    activity = net.measured_activity(spikes, traces=sweep[4][1])
    rec.outputs["measured"] = {"logits": logits4, "activity": activity}
    speedup, eff = _emit_sweep(rec, "measured", activity)
    rec.emit("port_sweep_batched", us,
             f"batch={batch};cells=5;plane=rank_schedule;"
             f"one_jitted_call=True;"
             f"input_activity={activity[0].mean() / 128:.2f}")
    return speedup, eff


def _plane_speedup(rec: Recorder, dev, batch: int) -> float:
    """Wall clock: the rank-schedule plane against the scan oracle."""
    key = prng.PRNGKey(2, dev)
    n_in, n_out = cm.PAPER_TOPOLOGY[0], cm.PAPER_TOPOLOGY[1]
    bits = prng.bernoulli(key, 0.5, (n_in, n_out)).to(torch.int8)
    vth = torch.zeros((n_out,), dtype=torch.int32, device=dev)
    x, _ = digits.make_spike_dataset(batch, seed=5)
    spikes = torch.from_numpy(x != 0).to(dev)

    us_sched, tr_sched = time_call(tile_mod.simulate_tile_batch, bits,
                                   spikes, vth, 4, device=dev)
    rec.launched(dev, {"port_schedule": 1}, calls=4)
    us_scan, tr_scan = time_call(tile_mod.simulate_tile_scan_batch, bits,
                                 spikes, vth, 4, device=dev)
    if not (torch.equal(tr_sched.vmem_final, tr_scan.vmem_final)
            and torch.equal(tr_sched.grants_per_cycle,
                            tr_scan.grants_per_cycle)):
        raise AssertionError("the rank-schedule plane differs from the scan")
    speedup = us_scan / us_sched
    rec.emit("plane_speedup_batch256", us_sched,
             f"us_scan={us_scan:.1f};speedup={speedup:.1f}x;batch={batch};"
             f"tile={n_in}x{n_out};ports=4;bit_identical=True")
    return speedup


def run(*, device="cuda", batch: int = BATCH,
        out: str | None = None) -> Recorder:
    """Every part at ``batch`` samples (the reference's 256 by default; the
    tests cut it).  ``out`` writes the JSON before the assertions;
    ``outputs["claims"]`` holds each assertion's (held, what was
    compared)."""
    dev = resolve_device(device)
    rec = Recorder()
    ref_speed, ref_eff = _emit_sweep(rec, "ref", reference_activity())
    sim_speed, sim_eff = _simulated_reference_sweep(rec, dev, batch)
    _measured_network_sweep(rec, dev, batch)
    plane_speedup = _plane_speedup(rec, dev, batch)
    # the report before the acceptance checks: a failing run still leaves
    # its rows behind
    if out:
        rec.write_json(out)
    claims = {
        "sim_speedup": (
            abs(sim_speed - cm.PAPER_SPEEDUP_4R) / cm.PAPER_SPEEDUP_4R < 0.05,
            f"simulated 4R speedup {sim_speed:.4f} (paper "
            f"{cm.PAPER_SPEEDUP_4R})"),
        "sim_energy_eff": (
            abs(sim_eff - cm.PAPER_ENERGY_EFF_4R) / cm.PAPER_ENERGY_EFF_4R
            < 0.05,
            f"simulated 4R energy efficiency {sim_eff:.4f} (paper "
            f"{cm.PAPER_ENERGY_EFF_4R})"),
        "sim_equals_ref": (
            abs(sim_speed - ref_speed) < 1e-9 and abs(sim_eff - ref_eff)
            < 1e-9,
            f"simulated ({sim_speed}, {sim_eff}) vs calibration "
            f"({ref_speed}, {ref_eff})"),
        "plane_floor": (
            plane_speedup >= PLANE_FLOOR,
            f"plane speedup {plane_speedup:.1f}x (floor {PLANE_FLOOR:.0f}x)"),
    }
    rec.outputs["claims"] = claims
    failed = [what for held, what in claims.values() if not held]
    if failed:
        raise AssertionError("; ".join(failed))
    return rec


def main(argv=None) -> Recorder:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--out", default=None,
                    help="write the rows as JSON to this path")
    args = ap.parse_args(argv)
    print("name,us_per_call,derived", flush=True)
    return run(device=args.device, out=args.out)


if __name__ == "__main__":
    main()
