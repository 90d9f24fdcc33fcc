"""Paper Fig 6 + Fig 7 of the port: circuit-level access time and energy
per cell option, the twin of the reference's ``benchmarks/bench_circuit.py``.

    python -m repro_torch.launch.bench_circuit            # needs a GPU
    python -m repro_torch.launch.bench_circuit --device cpu --out circuit.json

The calibrated-constants plane only: the rows are the cost model's tables
(``core/esam/cost_model.py``), and the paper's stated circuit-level
relationships are asserted as the reference asserts them (the Vprech
saving of at least 43 %, the read energy turning upward at the 4th port,
write costs growing with the ports).  Nothing runs on the device; like
every entry point of the port it takes ``--device`` and raises without a
GPU unless given ``cpu``.  Rows go to stdout as ``name,us_per_call,
derived``; ``--out`` writes ``{"results": [...]}``.
"""

from __future__ import annotations

import argparse

from repro_torch.core.esam import cost_model as cm
from repro_torch.kernels.common import resolve_device
from repro_torch.launch.bench_common import Recorder


def run(*, device="cuda") -> Recorder:
    """Every row, the reference's assertions held.  Returns the recorder."""
    resolve_device(device)
    rec = Recorder()
    # Fig 6 analogue: transposed-port write/read energy and time per cell
    for p in range(5):
        spec = cm.cell_spec(p)
        rec.emit(
            f"fig6_cell_{spec.name}", 0.0,
            f"tread_pj={spec.e_tread_pj:.3f};twrite_pj={spec.e_write_pj:.3f};"
            f"clock_ns={spec.clock_ns:.2f}")
    # Fig 7 analogue: per-port inference read energy at Vprech = 500 mV
    for p in range(1, 5):
        spec = cm.cell_spec(p)
        drain = -(-128 // spec.ports)
        rec.emit(
            f"fig7_ports_{p}", 0.0,
            f"read_pj_per_access={spec.e_read_pj:.3f};"
            f"array_drain_ns={drain * spec.clock_ns:.1f}")
    # the paper's stated relationships
    if not (cm.E_READ_PORT_PJ[0]
            < cm.E_READ_1RW_PJ * (1 - cm.VPRECH_ENERGY_SAVING) + 0.02):
        raise AssertionError("the Vprech read saving is below 43 %")
    if not cm.E_READ_PORT_PJ[3] > cm.E_READ_PORT_PJ[2]:
        raise AssertionError("the 4th port's read energy does not turn up")
    if not all(a < b for a, b in zip(cm.E_WRITE_PORT_PJ,
                                     cm.E_WRITE_PORT_PJ[1:])):
        raise AssertionError("write energy does not grow with the ports")
    rec.emit("fig7_vprech_saving", 0.0,
             f"saving>=43%:ok;time_penalty<=19%:"
             f"{cm.VPRECH_TIME_PENALTY <= 0.19}")
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
