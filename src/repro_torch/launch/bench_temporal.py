"""The temporal event plane of the port: the fused scan against the naive
per-step loop, event-stream rates and encoder accuracy; the twin of the
reference's ``benchmarks/bench_temporal.py``.

    python -m repro_torch.launch.bench_temporal               # on the card
    python -m repro_torch.launch.bench_temporal --device cpu --smoke

``--smoke`` stands in for the reference's ``BENCH_TEMPORAL_SMOKE`` and
shrinks every knob as it does (topology 768:256:10, T 4 and B 32, stream T
2 and 4, 512 digits and 40 BNN steps at T 4).  Three sections:

``temporal_fused_vs_naive``  at T 32, B 256, the paper topology, leak
    0.125, on ``_rand_net`` (``bernoulli(fold_in(PRNGKey(0), i), 0.5)``
    bits, thresholds ``randint(fold_in(key, 100 + i), (n,), 0, 12)``,
    through ``core/prng.py``) and rate-encoded digits (gain 0.7).  The
    fused side is the temporal plan: B3 ``popcount_mac`` for tile 0, then
    one ``temporal_scan`` (``time_call``: 4 calls, 2 launches each).  The
    naive side is ``temporal_forward_naive``, the per-step loop on the
    card (dense tiles, the plain LIF step, no kernel): the port's one
    naive loop is bit for bit the scan's, so it stands for both of the
    reference's, its jitted oracle and its eager baseline.
    ``naive_one_shot_us`` is its first, cold run; its warm run (median of
    2; ``--smoke``: 1) is timed once and written under both
    ``jitted_loop_us`` and ``warm_eager_us``.  The logits are asserted bit
    for bit against the loop, and (not with ``--smoke``) the one-shot
    ratio against the >= 5x floor.  The loop runs on the card because the
    reference's bench runs both oracles.
``temporal_stream_T{4,8,16,32}``  B 256 streams a T through the temporal
    plan with telemetry (B3, the scan, ``tile_loads``) and
    ``temporal_request_stats_device`` (``request_stats``): steps/s, input
    spikes/s, modeled pJ a timestep and a stream.
``temporal_encoder_{rate,latency}``  a BNN fitted on the device for 250
    steps on 4096 digits, converted, through the temporal plan at T 8
    (zero leak) on rate and latency encodings, beside the static plan's
    accuracy.

The stream and encoder lanes keep their network, inputs and outputs in
``Recorder.outputs["lanes"]``; :func:`replay_on_cpu` runs each again
through the same plan on the CPU (the kernels' plain versions) and holds
the logits, loads and request stats equal bit for bit, at the bench's own
sizes.

Rows go to stdout as ``name,us_per_call,derived``; ``--out`` writes
``{"results": [...]}``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import packing, prng
from repro_torch.core.esam import bnn, conversion
from repro_torch.core.esam import cost_model as cm
from repro_torch.core.esam import temporal
from repro_torch.core.esam.network import EsamNetwork
from repro_torch.data import digits, events
from repro_torch.kernels.common import resolve_device
from repro_torch.launch.bench_common import Recorder, time_call

READ_PORTS = 4
LEAK = 0.125
SPEEDUP_FLOOR = 5.0
SMOKE_TOPOLOGY = (768, 256, 10)
#: kernel launches of one temporal plan call on the card
PLAN_LAUNCHES = {"popcount_mac": 1, "temporal_scan": 1}
#: the request stats a stream lane holds against the CPU
STATS_KEYS = ("cycles_per_tile", "cycles", "latency_ns", "energy_pj",
              "energy_pj_per_step")


def rand_net(topology, seed: int = 0, device="cuda") -> EsamNetwork:
    """The reference bench's ``_rand_net``: ``bernoulli(fold_in(key, i),
    0.5)`` bits and mildly positive thresholds ``randint(fold_in(key,
    100 + i), (n,), 0, 12)`` (hidden activity ~30-50 % a step instead of
    the all-fire regime of zero thresholds)."""
    dev = resolve_device(device)
    key = prng.PRNGKey(seed, dev)
    bits = [prng.bernoulli(prng.fold_in(key, i), 0.5,
                           (topology[i], topology[i + 1])).to(torch.int8)
            for i in range(len(topology) - 1)]
    vth = [prng.randint(prng.fold_in(key, 100 + i), (n,), 0, 12)
           for i, n in enumerate(topology[1:])]
    return EsamNetwork(bits, vth, torch.zeros((topology[-1],)), device=dev)


def event_stream(n: int, n_steps: int, seed: int = 0) -> np.ndarray:
    """uint8[T, n, 768] rate-encoded digits (gain 0.7)."""
    ev, _ = events.encode_digit_events(n, n_steps, encoder="rate", seed=seed,
                                       gain=0.7)
    return ev


def _fused_vs_naive(rec: Recorder, dev, smoke: bool) -> None:
    n_steps, batch = (4, 32) if smoke else (32, 256)
    net = rand_net(SMOKE_TOPOLOGY if smoke else cm.PAPER_TOPOLOGY,
                   device=dev)
    cfg = temporal.TemporalConfig(n_steps=n_steps, leak=LEAK)
    ev = event_stream(batch, n_steps)
    packed = packing.words_from_np(packing.pack_spikes_np(ev)).to(dev)
    plan = net.plan(mode="temporal", temporal=cfg)

    # the one naive loop, first cold, then warm: the reference's eager
    # one-shot baseline, its jitted oracle and its warm eager loop
    naive_us, naive = time_call(
        lambda: temporal.temporal_forward_naive(net, ev, cfg), device=dev,
        warmup=0, repeats=1)
    fused_us, res = time_call(lambda: plan(packed).logits, device=dev)
    rec.launched(dev, PLAN_LAUNCHES, calls=4)
    logits = res.cpu().numpy()
    rec.outputs["fused_vs_naive"] = {"logits": logits, "naive": naive,
                                     "events": ev}
    if not np.array_equal(logits, naive):
        raise AssertionError("the temporal plan's logits differ from the "
                             "per-step loop's")
    # one warm figure for both of the reference's warm keys
    warm_us, _ = time_call(
        lambda: temporal.temporal_forward_naive(net, ev, cfg), device=dev,
        warmup=0, repeats=1 if smoke else 2)
    speedup = naive_us / fused_us
    rec.emit(
        "temporal_fused_vs_naive", fused_us,
        f"T={n_steps};batch={batch};naive_one_shot_us={naive_us:.1f};"
        f"speedup={speedup:.1f}x;warm_eager_us={warm_us:.1f};"
        f"speedup_warm_eager={warm_us / fused_us:.1f}x;"
        f"jitted_loop_us={warm_us:.1f};"
        f"speedup_vs_jitted_loop={warm_us / fused_us:.1f}x;"
        f"bit_identical_to_jitted_loop=yes;floor=5x")
    if not smoke and speedup < SPEEDUP_FLOOR:
        raise AssertionError(f"fused temporal scan only {speedup:.1f}x over "
                             "the naive loop")


def _stream_rates(rec: Recorder, dev, smoke: bool) -> None:
    steps_list = (2, 4) if smoke else (4, 8, 16, 32)
    batch = 32 if smoke else 256
    net = rand_net(SMOKE_TOPOLOGY if smoke else cm.PAPER_TOPOLOGY,
                   device=dev)
    for n_steps in steps_list:
        cfg = temporal.TemporalConfig(n_steps=n_steps, leak=LEAK)
        ev = event_stream(batch, n_steps, seed=n_steps)
        packed = packing.words_from_np(packing.pack_spikes_np(ev)).to(dev)
        plan = net.plan(mode="temporal", temporal=cfg, telemetry=True)

        def _run():
            r = plan(packed)
            return r.logits, r.loads

        us, (logits, loads) = time_call(_run, device=dev)
        rec.launched(dev, {**PLAN_LAUNCHES, "tile_loads": 1}, calls=4)
        wall_s = us / 1e6
        rs = cm.temporal_request_stats_device(net.topology, loads,
                                              READ_PORTS)
        rec.launched(dev, {"request_stats": 1})
        _keep_lane(rec, f"stream_T{n_steps}", net, cfg, packed, logits,
                   loads, rs)
        pj_step = float(rs["energy_pj_per_step"].mean())
        in_spikes = int(ev.sum())
        rec.emit(
            f"temporal_stream_T{n_steps}", us,
            f"batch={batch};steps_per_s={batch * n_steps / wall_s:,.0f};"
            f"spikes_per_s={in_spikes / wall_s:,.0f};"
            f"pj_per_timestep={pj_step:.1f};"
            f"pj_per_stream={float(rs['energy_pj'].mean()):.1f}")


def _keep_lane(rec: Recorder, lane: str, net, cfg, inputs, logits,
               loads=None, stats=None) -> None:
    """Keep what :func:`replay_on_cpu` needs to run a lane again."""
    rec.outputs.setdefault("lanes", {})[lane] = {
        "network": net, "config": cfg, "inputs": inputs, "logits": logits,
        "loads": loads, "stats": stats}


def replay_on_cpu(rec: Recorder) -> dict:
    """Each stream and encoder lane of a run again, through the same plan
    on the CPU (the kernels' plain versions) on the same inputs: the
    logits and, for the stream lanes, every tile's loads and the request
    stats must be equal bit for bit.  Returns the number of values held a
    lane; raises ``AssertionError`` on a difference."""
    cpu_nets, held = {}, {}
    for lane, out in rec.outputs["lanes"].items():
        net = out["network"]
        if id(net) not in cpu_nets:
            cpu_nets[id(net)] = EsamNetwork.from_numpy(*net.to_numpy(),
                                                       device="cpu")
        cpu_net = cpu_nets[id(net)]
        telemetry = out["loads"] is not None
        inputs = out["inputs"]
        res = cpu_net.plan(mode="temporal", temporal=out["config"],
                           telemetry=telemetry)(
            inputs.cpu() if torch.is_tensor(inputs) else inputs)
        pairs = [("logits", out["logits"], res.logits)]
        if telemetry:
            pairs += [(f"loads[{t}]", g, w)
                      for t, (g, w) in enumerate(zip(out["loads"],
                                                     res.loads))]
            rs = cm.temporal_request_stats_device(cpu_net.topology,
                                                  res.loads, READ_PORTS)
            pairs += [(k, out["stats"][k], rs[k]) for k in STATS_KEYS]
        for what, got, want in pairs:
            if not torch.equal(got.cpu(), want):
                raise AssertionError(f"{lane}: {what} differs from the same "
                                     "plan's on the CPU")
        held[lane] = sum(int(want.numel()) for _, _, want in pairs)
    return held


def _encoder_accuracy(rec: Recorder, dev, smoke: bool) -> None:
    n, steps = (512, 40) if smoke else (4096, 250)
    n_steps = 4 if smoke else 8
    x, y = digits.make_spike_dataset(n, seed=0)
    params, _ = bnn.fit(prng.PRNGKey(0), cm.PAPER_TOPOLOGY,
                        torch.from_numpy(x).to(dev),
                        torch.from_numpy(np.asarray(y)).to(dev),
                        steps=steps, device=dev)
    net = conversion.bnn_to_snn(params)
    cfg = temporal.TemporalConfig(n_steps=n_steps)
    plan = net.plan(mode="temporal", temporal=cfg)
    static = net.plan(mode="functional")(torch.from_numpy(x != 0).to(dev))
    static_acc = float((static.logits.argmax(-1).cpu().numpy() == y).mean())
    for enc in ("rate", "latency"):
        ev = events.encode(x, n_steps, encoder=enc, seed=1, **(
            {"gain": 0.7} if enc == "rate" else {}))
        packed = packing.pack_spikes_np(ev)
        us, res = time_call(lambda: plan(packing.pack_spikes_np(ev)).logits,
                            device=dev)
        rec.launched(dev, PLAN_LAUNCHES, calls=4)
        _keep_lane(rec, f"encoder_{enc}", net, cfg, packed, res)
        acc = float((res.argmax(-1).cpu().numpy() == y).mean())
        rec.emit(
            f"temporal_encoder_{enc}", us,
            f"T={n_steps};n={n};acc={acc * 100:.2f};"
            f"static_acc={static_acc * 100:.2f}")


def run(*, device="cuda", smoke: bool = False) -> Recorder:
    """The three sections on ``device`` (``"cuda"`` by default; raises
    without a GPU).  Returns the recorder."""
    dev = resolve_device(device)
    rec = Recorder()
    _fused_vs_naive(rec, dev, smoke)
    _stream_rates(rec, dev, smoke)
    _encoder_accuracy(rec, dev, smoke)
    return rec


def main(argv=None) -> Recorder:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's BENCH_TEMPORAL_SMOKE sizes")
    ap.add_argument("--out", default=None,
                    help="write the rows as JSON to this path")
    args = ap.parse_args(argv)
    print("name,us_per_call,derived", flush=True)
    rec = run(device=args.device, smoke=args.smoke)
    if args.out:
        rec.write_json(args.out)
    return rec


if __name__ == "__main__":
    main()
