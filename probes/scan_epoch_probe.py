#!/usr/bin/env python3
"""Time the matrix-RNG scan path of a checkout of the port on the card.

    python3 probes/scan_epoch_probe.py [--src DIR] [--samples 64 4096]

Runs ``repro_torch.core.esam.learning.online_learning_epoch_scan`` with
``rng_scheme="matrix"`` on the paper topology's readout (768:256:256:256:10
random weights from ``PRNGKey(0)``, its 256 -> 10 readout learning from the
frozen prefix's spikes of synthetic digits, ``PRNGKey(11)``, p_pot 0.2,
p_dep 0.1), as ``chip_smoke.py``'s scan path does, at each sample count:
one warm-up call, then ``--repeats`` timed calls (host clock, ending in a
synchronise), the kernel launches the port's counters saw in one call and,
where a call takes under a second, the device time and launches under
``torch.profiler``.  Prints one ``scan_probe`` JSON line a sample count.

``--src`` picks the ``src`` directory whose ``repro_torch`` is imported
(default: this checkout's), so that two commits are timed in one call on
one card, in turns.  It is no part of the port and needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path,
                    default=Path(__file__).resolve().parents[1] / "src")
    ap.add_argument("--samples", type=int, nargs="+", default=[64, 4096])
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, str(args.src.resolve()))

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("scan_epoch_probe: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core import prng
    from repro_torch.core.esam import learning
    from repro_torch.core.esam.network import EsamNetwork
    from repro_torch.data import digits
    from repro_torch.kernels.stdp import ops as stdp_ops

    topo = (768, 256, 256, 256, 10)
    key = prng.PRNGKey(0)
    bits = [prng.bernoulli(prng.fold_in(key, t), 0.5,
                           (topo[t], topo[t + 1])).to(torch.int8)
            for t in range(len(topo) - 1)]
    vth = [torch.zeros((n,), dtype=torch.int32) for n in topo[1:-1]]
    vth.append(torch.full((topo[-1],), 2**31 - 1, dtype=torch.int32))
    net = EsamNetwork(bits, vth, torch.zeros((topo[-1],)), device="cuda")
    x, y = digits.make_spike_dataset(max(args.samples), seed=3)
    pre = learning.last_hidden_spikes(net.weight_bits, net.vth, x)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    def scan(n):
        out, upd = learning.online_learning_epoch_scan(
            net.weight_bits, net.vth, None, y[:n], prng.PRNGKey(11),
            p_pot=0.2, p_dep=0.1, pre_spikes=pre[:n], rng_scheme="matrix")
        return out, int(upd)

    scan(8)   # warm-up: the kernel library built and loaded
    for n in args.samples:
        stdp_ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, upd = scan(n)
        walls = [time.perf_counter() - t0]
        launches = {k: v for k, v in stdp_ops.launch_counts().items() if v}
        for _ in range(args.repeats - 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scan(n)
            walls.append(time.perf_counter() - t0)
        row = {"src": str(args.src), "card": card, "samples": n,
               "updates": upd, "bits_sum": int(out.sum()), "walls_s": walls,
               "launches": launches, "device_s": None,
               "device_launches": None}
        if min(walls) < 1.0:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                scan(n)
                torch.cuda.synchronize()
            on_device = [e for e in prof.key_averages()
                         if e.device_type == torch.autograd.DeviceType.CUDA]
            row["device_s"] = sum(e.self_device_time_total
                                  for e in on_device) / 1e6
            row["device_launches"] = sum(e.count for e in on_device)
        print("scan_probe " + json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
