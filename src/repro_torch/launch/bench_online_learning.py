"""Paper Sec 4.4.1 of the port: transposable-port online learning, the twin
of the reference's ``benchmarks/bench_online_learning.py``.

    python -m repro_torch.launch.bench_online_learning          # on the card
    python -m repro_torch.launch.bench_online_learning --device cpu

The 26.0x / 19.5x column read and write speedups of the cost model, then
one STDP epoch over the reference's 512 digits (``seed=7``,
``PRNGKey(1)``) on two topologies, each lane timed by ``time_call`` (one
untimed call, the median of 3):

``learning_epoch_scan_<tag>``           the baseline plane,
    ``online_learning_epoch_scan`` with the matrix RNG: one
    ``stdp_update_epoch``, 3 launches on the card (the key chain, the
    draws, the chain of samples); its frozen prefix runs the dense
    functional tiles, as the reference's scan does.
``learning_epoch_column_event_<tag>``   the fused plane,
    ``online_learning_epoch``: the frozen prefix on B9 (one
    ``fused_fire_packed`` a hidden tile), then ``stdp_epoch_masks`` and
    ``stdp_column_epoch``, 2 launches.

``<tag>`` is ``768x10`` (the readout alone, ``bernoulli(PRNGKey(0), 0.5)``
bits) and ``768x256x256x256x10`` (``fold_in(PRNGKey(2), i)`` bits, zero
hidden thresholds), each with the hardware cost of its updates.
``learning_bit_identity`` holds the fused epoch on 768x10 against the
reference rule under the shared RNG: ``online_learning_epoch_scan(
rng_scheme="column")``, the port's plain per-sample loop, which runs on
the card because the reference's bench runs that oracle (bits and update
count equal, asserted).  Rows go to stdout as ``name,us_per_call,
derived``; ``--out`` writes ``{"results": [...]}``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.esam import learning
from repro_torch.data import digits
from repro_torch.kernels.common import resolve_device
from repro_torch.launch.bench_common import Recorder, time_call

BATCH = 512
P_POT, P_DEP = 0.2, 0.1
PAPER_TOPOLOGY = (768, 256, 256, 256, 10)
READOUT_VTH = 2**31 - 1
#: kernel launches of one epoch on the card, per plane
SCAN_LAUNCHES = {"stdp_update_keys": 1, "stdp_update_masks": 1,
                 "stdp_update_chain": 1}
FUSED_LAUNCHES = {"stdp_epoch_masks": 1, "stdp_column_epoch": 1}


def _hw_cost(n_updates: int) -> str:
    """Hardware time and energy of ``n_updates`` column accesses."""
    c4 = learning.column_update_cost(4)
    c0 = learning.column_update_cost(0)
    t4 = n_updates * (c4.read_ns + c4.write_ns) * 1e-3
    t0 = n_updates * (c0.read_ns + c0.write_ns) * 1e-3
    e4 = n_updates * c4.energy_pj * 1e-3
    e0 = n_updates * c0.energy_pj * 1e-3
    # a per-update constant: defined for a zero-update epoch too
    speedup = (c0.read_ns + c0.write_ns) / (c4.read_ns + c4.write_ns)
    return (f"column_updates={n_updates};hw_time_4r_us={t4:.1f};"
            f"hw_time_1rw_us={t0:.1f};hw_energy_4r_nj={e4:.1f};"
            f"hw_energy_1rw_nj={e0:.1f};hw_speedup={speedup:.1f}x")


def _bench_pair(rec: Recorder, tag: str, bits, vth, x, y, key, dev,
                batch: int) -> dict:
    """The scan plane against the fused plane on one topology; returns each
    plane's (bits, update count)."""
    def scan_epoch(b):
        return learning.online_learning_epoch_scan(
            [*bits[:-1], b], vth, x, y, key, p_pot=P_POT, p_dep=P_DEP)

    def fused_epoch(b):
        return learning.online_learning_epoch(
            [*bits[:-1], b], vth, x, y, key, p_pot=P_POT, p_dep=P_DEP)

    hidden = len(bits) - 1
    us_scan, (b_scan, n_scan) = time_call(scan_epoch, bits[-1], device=dev)
    rec.launched(dev, SCAN_LAUNCHES, calls=4)
    us_fused, (b_fused, n_fused) = time_call(fused_epoch, bits[-1],
                                             device=dev)
    rec.launched(dev, {**FUSED_LAUNCHES, "fused_fire_packed": hidden},
                 calls=4)
    n_scan, n_fused = int(n_scan), int(n_fused)
    rec.emit(f"learning_epoch_scan_{tag}", us_scan,
             f"plane=pr1_scan;rng=full_matrix_uniforms;batch={batch};"
             f"updates_per_s={n_scan / (us_scan * 1e-6):.0f};"
             f"{_hw_cost(n_scan)}")
    rec.emit(f"learning_epoch_column_event_{tag}", us_fused,
             f"plane=fused_column_event;rng=fold_in_per_column;"
             f"batch={batch};speedup_vs_scan={us_scan / us_fused:.1f}x;"
             f"updates_per_s={n_fused / (us_fused * 1e-6):.0f};"
             f"{_hw_cost(n_fused)}")
    return {"scan": (b_scan, n_scan), "fused": (b_fused, n_fused)}


def run(*, device="cuda", batch: int = BATCH) -> Recorder:
    """Every row at ``batch`` samples (the reference's 512 by default; the
    tests cut it).  Returns the recorder; ``outputs[tag]`` holds each
    plane's learned bits and update count."""
    dev = resolve_device(device)
    rec = Recorder()
    base = learning.column_update_cost(0)
    c4 = learning.column_update_cost(4)
    rec.emit("learning_1rw_baseline", 0.0,
             f"col_read_ns={base.read_ns:.1f};col_write_ns="
             f"{base.write_ns:.1f};energy_pj={base.energy_pj:.1f}")
    rec.emit("learning_4r_transposed", 0.0,
             f"col_read_ns={c4.read_ns};col_write_ns={c4.write_ns};"
             f"read_speedup={c4.speedup_read_vs_1rw:.1f}x(paper 26.0x);"
             f"write_speedup={c4.speedup_write_vs_1rw:.1f}x(paper 19.5x)")

    xn, yn = digits.make_spike_dataset(batch, seed=7)
    x = torch.from_numpy(xn != 0).to(dev)
    y = torch.from_numpy(np.asarray(yn)).to(dev)
    key = prng.PRNGKey(1, dev)

    # the readout alone: 768 -> 10 (the paper's readout adaptation shape)
    bits = [prng.bernoulli(prng.PRNGKey(0, dev), 0.5, (768, 10)).to(
        torch.int8)]
    vth = [torch.full((10,), READOUT_VTH, dtype=torch.int32, device=dev)]
    rec.outputs["768x10"] = _bench_pair(rec, "768x10", bits, vth, x, y, key,
                                        dev, batch)

    # the paper topology, frozen prefix: the packed plane feeds the epoch
    topo = PAPER_TOPOLOGY
    kw = prng.PRNGKey(2, dev)
    bits_full = [prng.bernoulli(prng.fold_in(kw, i), 0.5,
                                (topo[i], topo[i + 1])).to(torch.int8)
                 for i in range(len(topo) - 1)]
    vth_full = [torch.zeros((n,), dtype=torch.int32, device=dev)
                for n in topo[1:-1]]
    vth_full.append(torch.full((topo[-1],), READOUT_VTH, dtype=torch.int32,
                               device=dev))
    tag = "x".join(map(str, topo))
    rec.outputs[tag] = _bench_pair(rec, tag, bits_full, vth_full, x, y, key,
                                   dev, batch)

    # the fused plane against the reference rule under the shared RNG
    b_fused, n_f = learning.online_learning_epoch(
        bits, vth, x, y, key, p_pot=P_POT, p_dep=P_DEP)
    rec.launched(dev, FUSED_LAUNCHES)
    b_ref, n_r = learning.online_learning_epoch_scan(
        bits, vth, x, y, key, p_pot=P_POT, p_dep=P_DEP, rng_scheme="column")
    identical = bool(torch.equal(b_fused.to(b_ref.dtype), b_ref)
                     and int(n_f) == int(n_r))
    rec.emit("learning_bit_identity", 0.0,
             f"fused_vs_reference_rule_shared_rng={identical};batch={batch}")
    if not identical:
        raise AssertionError(
            "column-event epoch diverged from the reference rule")
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
