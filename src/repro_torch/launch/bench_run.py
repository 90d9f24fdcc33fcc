"""The port's bench harness: one section per paper table or figure, the
twin of the reference's ``benchmarks/run.py``.

    python -m repro_torch.launch.bench_run                    # on the card
    python -m repro_torch.launch.bench_run --device cpu --smoke

Runs the ported twins in the reference's order and prints their
``name,us_per_call,derived`` rows:

  circuit          Fig 6 + Fig 7   (``launch.bench_circuit``)
  timing           Table 2         (``launch.bench_timing``, B8)
  online_learning  Sec 4.4.1       (``launch.bench_online_learning``)
  system           Fig 8           (``launch.bench_system``, B5)
  comparison       Table 3         (``launch.bench_comparison``)
  accuracy         Sec 4.4.2       (``launch.bench_accuracy``)
  kernels          the kernel plane (``launch.bench_kernels``)
  temporal         the temporal plane (``launch.bench_temporal``)
  faults           robustness      (``launch.bench_faults``)

``--smoke`` goes to the twins that have one (kernels, temporal, faults).
The reference's ``bench_spiking_lm`` and ``bench_roofline`` belong to the
seed LM stack, not ported yet (ROADMAP.md §A.6): each gets one line on
stderr.  A twin that raises is reported on stderr with its traceback and
counted; the harness exits 1 if any did, as the reference's does.
"""

from __future__ import annotations

import argparse
import sys
import traceback

from repro_torch.kernels.common import resolve_device
from repro_torch.launch import (bench_accuracy, bench_circuit,
                                bench_comparison, bench_faults,
                                bench_kernels, bench_online_learning,
                                bench_system, bench_temporal, bench_timing)

#: (name, module) of every ported twin, in the reference's order
TWINS = (("circuit", bench_circuit), ("timing", bench_timing),
         ("online_learning", bench_online_learning),
         ("system", bench_system), ("comparison", bench_comparison),
         ("accuracy", bench_accuracy), ("kernels", bench_kernels),
         ("temporal", bench_temporal), ("faults", bench_faults))
#: twins that take ``smoke``
SMOKE_TWINS = ("kernels", "temporal", "faults")
#: the reference's benches that wait for the seed LM stack
NOT_PORTED = ("bench_spiking_lm", "bench_roofline")


def run_twin(name: str, module, device="cuda", smoke: bool = False):
    """One twin's ``run`` on ``device``; returns what it returns."""
    kw = {"smoke": smoke} if name in SMOKE_TWINS else {}
    return module.run(device=device, **kw)


def run(*, device="cuda", smoke: bool = False) -> int:
    """Every twin of ``TWINS`` in order; returns the number that raised.
    Raises at once when ``device`` is not there (no GPU and no
    ``device="cpu"``)."""
    resolve_device(device)
    failures = 0
    for name, module in TWINS:
        try:
            run_twin(name, module, device, smoke)
        except Exception:  # noqa: BLE001  (reported and counted)
            failures += 1
            print(f"{module.__name__},0.0,FAILED", file=sys.stderr)
            traceback.print_exc()
    for name in NOT_PORTED:
        print(f"benchmarks.{name},0.0,NOT_PORTED(the seed LM stack: "
              "ROADMAP.md §A.6)", file=sys.stderr)
    return failures


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke sizes of the twins that have them")
    args = ap.parse_args(argv)
    print("name,us_per_call,derived", flush=True)
    if run(device=args.device, smoke=args.smoke):
        sys.exit(1)


if __name__ == "__main__":
    main()
