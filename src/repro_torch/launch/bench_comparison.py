"""Paper Table 3 of the port: the 1RW+4R system against published work, on
the calibration activity profile and on the measured profile of a freshly
trained BNN; the twin of the reference's ``benchmarks/bench_comparison.py``.

    python -m repro_torch.launch.bench_comparison             # on the card
    python -m repro_torch.launch.bench_comparison --device cpu

``table3_<work>``             the published rows (``PAPER_ROWS``).
``table3_thiswork_ref_profile`` ``system_stats`` at 4 ports on the
    calibration profile: 44 MInf/s, 607 pJ/Inf and 29 mW in the paper.
``table3_thiswork_measured``  a BNN fitted on the device for 150 steps on
    2048 synthetic digits (``seed=0``, ``PRNGKey(0)``), converted, and
    ``plan(mode="functional", telemetry=True)`` timed on all 2048
    (``time_call``): its accuracy, and its first 512 samples' loads
    through ``system_stats`` at 4 and at 0 ports.

The BNN's draws come from ``core/prng.py`` (its init within 3 ulp of the
reference's), so the measured row is close to, not equal to, the
reference's; the other rows are the cost model's and equal it.  Rows go
to stdout as ``name,us_per_call,derived``; ``--out`` writes
``{"results": [...]}``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.esam import bnn, conversion
from repro_torch.core.esam import cost_model as cm
from repro_torch.core.esam.network import reference_activity, system_stats
from repro_torch.data import digits
from repro_torch.kernels.common import resolve_device
from repro_torch.launch.bench_common import Recorder, time_call

PAPER_ROWS = {
    "wang_assc20[6]": "tech=65nm;power=305nW;acc=97.6;thr=2inf/s;energy=195nJ",
    "chen_jssc19[9]": "tech=10nm;power=196mW;acc=97.9;thr=6250inf/s;energy=1000nJ",
    "kim_fns18[10]": "tech=65nm;power=53mW;acc=97.2;thr=20inf/s;transposable=yes",
}
N_DIGITS, FIT_STEPS, FIT_BATCH, LOAD_SAMPLES = 2048, 150, 128, 512


def run(*, device="cuda", n: int = N_DIGITS, steps: int = FIT_STEPS
        ) -> Recorder:
    """Every row (``n`` digits and ``steps`` BNN steps: the reference's
    2048 and 150 by default; the tests cut them)."""
    dev = resolve_device(device)
    rec = Recorder()
    for name, row in PAPER_ROWS.items():
        rec.emit(f"table3_{name}", 0.0, row)

    # the reference profile (the paper's operating point)
    s4 = system_stats(cm.PAPER_TOPOLOGY, reference_activity(), 4)
    rec.emit("table3_thiswork_ref_profile", 0.0,
             f"tech=3nm;clock_mhz={cm.cell_spec(4).clock_hz / 1e6:.0f};"
             f"throughput_minf_s={s4.throughput_inf_s / 1e6:.1f}(paper 44);"
             f"energy_pj_inf={s4.energy_pj_per_inf:.0f}(paper 607);"
             f"power_mw={s4.power_mw:.1f}(paper 29.0);"
             f"neurons={cm.PAPER_NEURONS};synapses~{cm.PAPER_SYNAPSES}")

    # the measured profile of a trained binary SNN
    xn, yn = digits.make_spike_dataset(n, seed=0)
    x = torch.from_numpy(xn).to(dev)
    y = torch.from_numpy(np.asarray(yn)).to(dev)
    params, _ = bnn.fit(prng.PRNGKey(0), cm.PAPER_TOPOLOGY, x, y,
                        steps=steps, batch=FIT_BATCH, device=dev)
    net = conversion.bnn_to_snn(params)
    # one plan gives the accuracy and the cost model's activity: the
    # telemetry loads are reductions on the same pass
    plan = net.plan(mode="functional", telemetry=True)
    spikes = x != 0

    def measured():
        res = plan(spikes)
        return res.logits, [c[:LOAD_SAMPLES] for c in res.loads]

    us, (logits, counts) = time_call(measured, device=dev)
    counts_np = [c.cpu().numpy().astype(np.float64) for c in counts]
    s4m = system_stats(cm.PAPER_TOPOLOGY, counts_np, 4)
    s0m = system_stats(cm.PAPER_TOPOLOGY, counts_np, 0)
    acc = float((logits.argmax(-1) == y).to(torch.float32).mean())
    rec.outputs["loads"] = counts_np
    rec.emit("table3_thiswork_measured", us,
             f"timed=plan_functional_telemetry_{n};"
             f"accuracy={acc * 100:.2f}(paper 97.64 on MNIST);"
             f"throughput_minf_s={s4m.throughput_inf_s / 1e6:.1f};"
             f"energy_pj_inf={s4m.energy_pj_per_inf:.0f};"
             f"power_mw={s4m.power_mw:.1f};"
             f"speedup_vs_1rw="
             f"{s4m.throughput_inf_s / s0m.throughput_inf_s:.2f}x;"
             f"energy_eff_vs_1rw="
             f"{s0m.energy_pj_per_inf / s4m.energy_pj_per_inf:.2f}x")
    return rec


def main(argv=None) -> Recorder:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--out", default=None,
                    help="write the rows as JSON to this path")
    args = ap.parse_args(argv)
    print("name,us_per_call,derived", flush=True)
    rec = run(device=args.device)
    if args.out:
        rec.write_json(args.out)
    return rec


if __name__ == "__main__":
    main()
