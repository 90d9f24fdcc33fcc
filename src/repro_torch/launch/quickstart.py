"""Quickstart of the port: the whole paper in one run.

1. Train the 768:256:256:256:10 BNN (sign activations, per-neuron biases).
2. Convert it losslessly to a binary-SNN with per-neuron thresholds ([15]);
   2b. run the packed plan (one cascade launch on the card) against the
   functional plan.
3. Run event-driven cycle-accurate inference through the multiport arbiter
   (the cycle plan at 4 ports: one ``port_schedule`` launch per tile).
4. Report the system-level operating point for every SRAM cell option
   (Fig 8) and the headline against the paper's 3.1x speed / 2.2x energy.

    python -m repro_torch.launch.quickstart              # on the card
    python -m repro_torch.launch.quickstart --device cpu --smoke

``--smoke`` cuts the BNN's training steps (never the topology).  The
synthetic digits stand in for MNIST, as in the reference's
``examples/quickstart.py``; the BNN's init and batch draws come from
``core/prng.py``, so its accuracy is close to, not equal to, the
reference's at the same seed.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.esam import bnn, conversion
from repro_torch.core.esam import cost_model as cm
from repro_torch.core.esam.network import (
    EsamNetwork,
    SystemStats,
    reference_activity,
    system_stats,
)
from repro_torch.core.esam.tile import TileTrace
from repro_torch.data import digits
from repro_torch.kernels.common import resolve_device

TRAIN_SAMPLES = 2048
STEPS, SMOKE_STEPS = 200, 20
BATCH = 128
#: samples of the packed-vs-functional check and of the measured activity
CHECK_SAMPLES = 256


@dataclasses.dataclass
class QuickstartRun:
    """What one quickstart run computed, for callers that check it."""

    net: EsamNetwork
    spikes: np.ndarray               # {0,1}[2048, 768] digit spikes
    labels: np.ndarray               # int32[2048]
    bnn_accuracy: float              # last training batch
    snn_accuracy: float              # functional plan, all samples
    logits: torch.Tensor             # functional plan, float32[2048, 10]
    loads: tuple                     # functional telemetry, int32[2048, g]
    packed_equal: bool               # packed == functional on 256 samples
    sample_logits: torch.Tensor      # cycle plan on sample 0, float32[10]
    traces: tuple[TileTrace, ...]    # cycle plan on sample 0, per tile
    cycles: list[int]                # cycles per tile until R_empty
    fig8: list[SystemStats]          # cell options 0..4, measured activity
    speedup: float                   # 1RW+4R vs 1RW, reference profile
    energy_eff: float


def main(argv=None) -> QuickstartRun:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help=f"{SMOKE_STEPS} BNN training steps instead of "
                         f"{STEPS}; the topology stays the paper's")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    topo = cm.PAPER_TOPOLOGY
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

    print(f"== 1. train BNN {':'.join(map(str, topo))} on {where} "
          "(synthetic digits; MNIST is offline-unavailable) ==")
    x, y = digits.make_spike_dataset(TRAIN_SAMPLES, seed=0)
    params, bnn_acc = bnn.fit(prng.PRNGKey(0), topo, x, y,
                              steps=SMOKE_STEPS if args.smoke else STEPS,
                              batch=BATCH, device=dev)
    print(f"   BNN train accuracy: {bnn_acc * 100:.1f}%")

    print("== 2. lossless BNN -> binary-SNN conversion ==")
    net = conversion.bnn_to_snn(params)
    spikes = torch.from_numpy(x != 0).to(dev)
    # one functional plan: logits and arbiter loads in a single pass
    res = net.plan(mode="functional", telemetry=True)(spikes)
    y_dev = torch.from_numpy(y).to(dev)
    snn_acc = float((res.logits.argmax(-1) == y_dev).to(torch.float32).mean())
    print(f"   SNN accuracy: {snn_acc * 100:.1f}%  topology={net.topology}")

    print("== 2b. packed plan (32-spike words between tiles) ==")
    packed = net.plan()(spikes[:CHECK_SAMPLES]).logits
    same = bool(torch.equal(packed, res.logits[:CHECK_SAMPLES]))
    print(f"   packed plan == functional plan on {CHECK_SAMPLES} samples: "
          f"{same}")

    print("== 3. event-driven (cycle-accurate) plan, 4 ports ==")
    sample = net.plan(mode="cycle", read_ports=4)(spikes[0])
    cycles = [int(t.cycles) for t in sample.traces]
    print(f"   predicted class: {int(sample.logits.argmax())} "
          f"(label {int(y[0])})")
    print(f"   cycles per tile until R_empty: {cycles}")

    print("== 4. system-level operating points (Fig 8 / Table 3) ==")
    # the telemetry loads of step 2 are the measured activity: no tile
    # product is run again
    counts = [c[:CHECK_SAMPLES].cpu().numpy().astype(np.float64)
              for c in res.loads]
    fig8 = [system_stats(topo, counts, p) for p in range(5)]
    for s in fig8:
        print(f"   {s.cell:7s}: {s.throughput_inf_s / 1e6:6.2f} MInf/s  "
              f"{s.energy_pj_per_inf:7.1f} pJ/Inf  {s.power_mw:5.1f} mW")
    ref = reference_activity()
    s0, s4 = system_stats(topo, ref, 0), system_stats(topo, ref, 4)
    speedup = s4.throughput_inf_s / s0.throughput_inf_s
    eff = s0.energy_pj_per_inf / s4.energy_pj_per_inf
    print(f"   headline (ref profile): speedup {speedup:.2f}x "
          f"(paper {cm.PAPER_SPEEDUP_4R}x), energy-eff {eff:.2f}x "
          f"(paper {cm.PAPER_ENERGY_EFF_4R}x)")
    return QuickstartRun(
        net=net, spikes=x, labels=y, bnn_accuracy=bnn_acc,
        snn_accuracy=snn_acc, logits=res.logits, loads=res.loads,
        packed_equal=same, sample_logits=sample.logits,
        traces=sample.traces, cycles=cycles, fig8=fig8, speedup=speedup,
        energy_eff=eff)


if __name__ == "__main__":
    main()
