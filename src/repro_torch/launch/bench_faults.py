"""Fault bench of the port: the four sections of the reference's
``benchmarks/bench_faults.py``, on the card and at the reference's sizes.

    python -m repro_torch.launch.bench_faults                  # on the card
    python -m repro_torch.launch.bench_faults --device cpu --smoke
    python -m repro_torch.launch.bench_faults --out faults.json

A BNN is trained on 4096 synthetic digits (250 steps; ``--smoke``: 512 and
40, the reference's ``BENCH_FAULTS_SMOKE``), converted to the SNN, and:

``fault_sweep_<type>_<mode>``  accuracy vs fault rate for stuck0 / stuck1 /
    read_disturb through the functional and the packed plan; the two plans'
    logits are asserted equal at every rate, and the zero rate equal to
    the clean plan.
``fault_mitigation_remap``     dead hidden columns (40 %) remapped onto 0 /
    32 / 96 spare columns (``--smoke``: 0 / 96), with the spares' area; the
    largest budget must recover more than 0.02 of accuracy.
``fault_repair_stdp``          ``train_online(faults=)`` around the dead
    columns, 4 shuffled epochs (``--smoke``: 2); it must beat the faulted
    accuracy, and the deployed faulted plan must read the last epoch's
    accuracy.
``fault_energy_vs_mitigation`` modeled pJ/inference from the packed plan's
    measured loads, clean, faulted and remapped.

The rates, seeds and spare budgets are the reference's.  Rows go to stdout
as ``name,us_per_call,derived`` (one timed call each, after one untimed
call; the repair is timed once, cold); ``--out`` writes
``{"results": [...]}``.  The BNN's init and batch draws come from
``core/prng.py``, so its accuracy is close to, not equal to, the
reference's at the same seed, and so are the rows' accuracies.

Every assertion of the reference's bench is kept.  Those that hold for
any network (the two plans' logits, the zero rate, the deployed accuracy)
raise where they fail.  The two that compare the trained network's
accuracies, the remap's recovery and the repair's, are recorded as
``claims`` (held or not, and the numbers), and ``run`` raises naming every
failed claim after the last section (the reference raises at the first).
The repair's margin belongs to the trained network: the reference's own
bench passes it at BNN seed 0 by 1.7 points and fails it at BNN seeds 2, 3
and 5 (PERF.md, the fault plane); ``run(check=False)`` returns the claims
unraised for a caller that reports them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.esam import bnn, conversion
from repro_torch.core.esam import cost_model as cm
from repro_torch.core.esam import learning
from repro_torch.core.esam.faults import FaultModel
from repro_torch.data import digits
from repro_torch.kernels.common import resolve_device
from repro_torch.launch.bench_common import sync
from repro_torch.train import online as online_train

READ_PORTS = 4

#: rate -> FaultModel per injected fault population
FAULT_TYPES = {
    "stuck0": lambda r: FaultModel(seed=11, stuck0_rate=r),
    "stuck1": lambda r: FaultModel(seed=11, stuck1_rate=r),
    "read_disturb": lambda r: FaultModel(seed=11, read_disturb=r),
}
#: the remap, repair and energy sections' dead-column rate
DEAD_COL_RATE = 0.4


@dataclasses.dataclass
class FaultBench:
    """One run: its rows, and what the repair section learned on (for
    callers that replay it)."""

    rows: list[dict]
    net: object                     # the converted SNN
    train: tuple                    # (spikes bool, labels) of the repair
    test: tuple                     # (spikes bool, labels) of every section
    repair_faults: FaultModel
    repair_epochs: int
    repair: online_train.OnlineTrainResult
    #: the reference's assertions: name -> (holds, what was compared)
    claims: dict[str, tuple[bool, str]]


def _timed(fn, dev: torch.device, warmup: int = 1):
    """Wall microseconds of one call of ``fn`` (after ``warmup`` untimed
    calls), its result on the device synchronised."""
    for _ in range(warmup):
        fn()
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return (time.perf_counter() - t0) * 1e6, out


def _acc(logits: torch.Tensor, y: torch.Tensor) -> float:
    return float((logits.argmax(-1) == y).cpu().numpy().mean())


class _Rows:
    def __init__(self):
        self.rows: list[dict] = []
        self.claims: dict[str, tuple[bool, str]] = {}

    def emit(self, name: str, us: float, derived: str) -> None:
        print(f"{name},{us:.1f},{derived}", flush=True)
        self.rows.append({"name": name, "us_per_call": round(us, 1),
                          "derived": derived})


def _data_and_net(dev: torch.device, smoke: bool):
    n, steps = (512, 40) if smoke else (4096, 250)
    x, y = digits.make_spike_dataset(n, seed=0)
    split = (3 * n) // 4
    x_t = torch.from_numpy(x).to(dev)
    y_t = torch.from_numpy(np.asarray(y)).to(dev)
    params, _ = bnn.fit(prng.PRNGKey(0), cm.PAPER_TOPOLOGY, x_t[:split],
                        y_t[:split], steps=steps, batch=128, device=dev)
    net = conversion.bnn_to_snn(params)
    return (net, (x_t[:split] != 0, y_t[:split]),
            (x_t[split:] != 0, y_t[split:]))


def _fault_sweep(rec: _Rows, net, x_te, y_te, dev, smoke: bool) -> None:
    rates = {
        "stuck0": (0.0, 0.05) if smoke else (0.0, 0.01, 0.02, 0.05, 0.1),
        "stuck1": (0.0, 0.05) if smoke else (0.0, 0.01, 0.02, 0.05, 0.1),
        "read_disturb": (0.0, 5e-3) if smoke else (0.0, 1e-3, 3e-3, 1e-2),
    }
    clean = net.plan(mode="functional")(x_te).logits
    for ftype, make in FAULT_TYPES.items():
        accs: dict[str, list[float]] = {"functional": [], "packed": []}
        us = {}
        for r in rates[ftype]:
            fm = make(r) if r else None
            logits = {}
            for mode in ("functional", "packed"):
                plan = net.plan(mode=mode, faults=fm)
                us[mode], logits[mode] = _timed(
                    lambda p=plan: p(x_te).logits, dev)
                accs[mode].append(_acc(logits[mode], y_te))
            # the faults live in the plan's operands, not its mode: both
            # datapaths compute the same faulted function
            if not torch.equal(logits["functional"], logits["packed"]):
                raise AssertionError(f"{ftype} at {r}: functional and "
                                     "packed logits differ")
            if r == 0.0 and not torch.equal(logits["functional"], clean):
                raise AssertionError(f"{ftype} at rate 0 differs from the "
                                     "clean plan")
        for mode in ("functional", "packed"):
            rec.emit(
                f"fault_sweep_{ftype}_{mode}", us[mode],
                f"rates={list(rates[ftype])};"
                f"acc_pct={[round(a * 100, 2) for a in accs[mode]]};"
                f"modes_bit_identical=yes")


def _remap(rec: _Rows, net, x_te, y_te, dev, smoke: bool) -> None:
    spares = (0, 96) if smoke else (0, 32, 96)
    accs, areas = [], []
    for k in spares:
        fm = FaultModel(seed=5, dead_col_rate=DEAD_COL_RATE, spare_cols=k)
        plan = net.plan(mode="functional", faults=fm)
        us, logits = _timed(lambda p=plan: p(x_te).logits, dev)
        accs.append(_acc(logits, y_te))
        areas.append(cm.spare_column_area_um2(net.topology, k, READ_PORTS))
    clean_acc = _acc(net.plan(mode="functional")(x_te).logits, y_te)
    rec.emit(
        "fault_mitigation_remap", us,
        f"dead_col_rate={DEAD_COL_RATE};spare_cols={list(spares)};"
        f"acc_pct={[round(a * 100, 2) for a in accs]};"
        f"clean_acc_pct={clean_acc * 100:.2f};"
        f"spare_area_um2={[round(a, 1) for a in areas]}")
    rec.claims["remap_recovers"] = (
        accs[-1] > accs[0] + 0.02,
        f"remap recovered {accs[-1] - accs[0]:+.3f} accuracy (want > 0.02)")


def _repair(rec: _Rows, net, train, x_te, y_te, dev, smoke: bool):
    x_tr, y_tr = train
    epochs = 2 if smoke else 4
    fm = FaultModel(seed=5, dead_col_rate=DEAD_COL_RATE)
    acc_fault = _acc(net.plan(mode="functional", faults=fm)(x_te).logits,
                     y_te)
    us, res = _timed(
        lambda: online_train.train_online(
            net, x_tr, y_tr, epochs=epochs, shuffle=True,
            eval_spikes=x_te, eval_labels=y_te, faults=fm),
        dev, warmup=0)
    cost = learning.column_update_cost(READ_PORTS)
    repair_pj = cost.energy_pj * sum(res.n_updates)
    deployed = _acc(
        res.network.plan(mode="functional", faults=fm)(x_te).logits, y_te)
    if abs(deployed - res.accuracy[-1]) >= 1e-6:
        raise AssertionError(f"deployed faulted accuracy {deployed} != the "
                             f"last epoch's {res.accuracy[-1]}")
    rec.emit(
        "fault_repair_stdp", us,
        f"dead_col_rate={fm.dead_col_rate};epochs={epochs};"
        f"acc_faulted_pct={acc_fault * 100:.2f};"
        f"acc_per_epoch_pct={[round(a * 100, 2) for a in res.accuracy]};"
        f"n_updates={res.n_updates};repair_energy_pj={repair_pj:.0f}")
    rec.claims["repair_beats_faulted"] = (
        max(res.accuracy) > acc_fault,
        f"STDP repair's best epoch {max(res.accuracy):.4f} vs faulted "
        f"{acc_fault:.4f}")
    return fm, epochs, res


def _energy(rec: _Rows, net, x_te, dev) -> None:
    configs = {
        "clean": None,
        "faulted": FaultModel(seed=5, dead_col_rate=DEAD_COL_RATE),
        "remapped": FaultModel(seed=5, dead_col_rate=DEAD_COL_RATE,
                               spare_cols=96),
    }
    energy = {}
    for name, fm in configs.items():
        plan = net.plan(mode="packed", telemetry=True, faults=fm)
        us, loads = _timed(lambda p=plan: p(x_te).loads, dev)
        rs = cm.request_stats(net.topology, [ld.cpu().numpy() for ld in loads],
                              READ_PORTS)
        energy[name] = float(rs.energy_pj.mean())
    rec.emit(
        "fault_energy_vs_mitigation", us,
        f"dead_col_rate={DEAD_COL_RATE};"
        + ";".join(f"pj_per_inf_{k}={v:.1f}" for k, v in energy.items()))


def run(*, device="cuda", smoke: bool = False,
        check: bool = True) -> FaultBench:
    """All four sections on ``device`` (``"cuda"`` by default; raises
    without a GPU).  With ``check`` a failed claim raises after the last
    section; the exact assertions raise where they fail either way."""
    dev = resolve_device(device)
    rec = _Rows()
    net, train, (x_te, y_te) = _data_and_net(dev, smoke)
    _fault_sweep(rec, net, x_te, y_te, dev, smoke)
    _remap(rec, net, x_te, y_te, dev, smoke)
    fm, epochs, res = _repair(rec, net, train, x_te, y_te, dev, smoke)
    _energy(rec, net, x_te, dev)
    failed = [what for held, what in rec.claims.values() if not held]
    if check and failed:
        raise AssertionError("; ".join(failed))
    return FaultBench(rows=rec.rows, net=net, train=train, test=(x_te, y_te),
                      repair_faults=fm, repair_epochs=epochs, repair=res,
                      claims=dict(rec.claims))


def main(argv=None) -> FaultBench:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="512 digits and 40 BNN steps, fewer rates and "
                         "spare budgets, 2 repair epochs")
    ap.add_argument("--out", default=None,
                    help="write the rows as JSON to this path")
    args = ap.parse_args(argv)
    print("name,us_per_call,derived", flush=True)
    res = run(device=args.device, smoke=args.smoke)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"results": res.rows}, f, indent=2)
        print(f"[bench] wrote {args.out} ({len(res.rows)} entries)")
    return res


if __name__ == "__main__":
    main()
