"""Paper Table 2 of the port: pipeline stage durations and the clock per
cell option, and the arbiter lane, the twin of the reference's
``benchmarks/bench_timing.py``.

    python -m repro_torch.launch.bench_timing             # on the card
    python -m repro_torch.launch.bench_timing --device cpu --out timing.json

``table2_<cell>`` and ``table2_clock_check`` are the cost model's (the 4R
clock against the published 810 MHz).  ``arbiter_kernel_128x4`` runs B8
``arbiter`` (``kernels/arbiter``) on the reference's requests,
``bernoulli(PRNGKey(0), 0.4, (8, 128))`` drawn through ``core/prng.py``,
at 4 ports: one untimed call and the median of 3 timed ones, 4 launches
on the card.  The reference times this lane in Pallas interpret mode,
functional only; the port's time is the CUDA kernel's, one eager call
with the device synchronised, and on the CPU the plain version's.  The
row keeps the reference's keys (the tree and flat arbiters' critical
paths and the tree's area overhead, from the cost model).  Rows go to
stdout as ``name,us_per_call,derived``; ``--out`` writes
``{"results": [...]}``.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.core import prng
from repro_torch.core.esam import cost_model as cm
from repro_torch.kernels.arbiter import ops as arb_ops
from repro_torch.kernels.common import resolve_device
from repro_torch.launch.bench_common import Recorder, time_call

#: the arbiter lane's request batch (row groups x rows) and ports
ARB_GROUPS, ARB_WIDTH, ARB_PORTS = 8, 128, 4


def arbiter_requests(device) -> torch.Tensor:
    """The reference's ``bernoulli(PRNGKey(0), 0.4, (8, 128))``, as the
    uint8 the wrapper takes (the reference casts to int8)."""
    return prng.bernoulli(prng.PRNGKey(0, device), 0.4,
                          (ARB_GROUPS, ARB_WIDTH)).to(torch.uint8)


def run(*, device="cuda") -> Recorder:
    """Every row.  Returns the recorder (its ``launches``: B8's 4 calls)."""
    dev = resolve_device(device)
    rec = Recorder()
    for p in range(5):
        spec = cm.cell_spec(p)
        bottleneck = ("arbiter" if spec.arbiter_ns >= spec.sram_neuron_ns
                      else "sram+neuron")
        rec.emit(
            f"table2_{spec.name}", 0.0,
            f"arbiter_ns={spec.arbiter_ns};sram_neuron_ns="
            f"{spec.sram_neuron_ns};clock_ns={spec.clock_ns};"
            f"bottleneck={bottleneck}")
    # 4R system clock ~ the published 810 MHz
    rec.emit("table2_clock_check", 0.0,
             f"clock_mhz={cm.cell_spec(4).clock_hz / 1e6:.0f};paper=810")
    req = arbiter_requests(dev)
    us, _ = time_call(lambda r: arb_ops.arbiter(r, ports=ARB_PORTS), req,
                      device=dev)
    rec.launched(dev, {"arbiter": 1}, calls=4)
    rec.emit(f"arbiter_kernel_{ARB_WIDTH}x{ARB_PORTS}", us,
             f"tree_path_ps={cm.ARBITER_TREE_CRITICAL_PATH_PS};"
             f"flat_path_ps={cm.ARBITER_FLAT_CRITICAL_PATH_PS};"
             f"area_overhead={cm.ARBITER_TREE_AREA_OVERHEAD}")
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
