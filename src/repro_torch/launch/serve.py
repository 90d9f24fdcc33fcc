"""Serving launcher of the port: ESAM spike serving on one GPU.

Synthetic digit traffic is served end to end through ``SpikeEngine``: the
admission queue, power-of-two buckets, and the packed plan, whose cascade is
one CUDA launch per round on the card.  Prints the wall-clock serving rate
next to the modeled paper-unit operating point (MInf/s and pJ/Inf of the
3nm CIM macro, from the measured arbiter loads).

    python -m repro_torch.launch.serve --esam            # 768:256:256:256:10
    python -m repro_torch.launch.serve --esam --smoke    # 768:256:10

Event mode (``--events``): rate-encoded digit streams of mixed length T
(4, 8, 16; with ``--smoke`` 2, 4) through ``SpikeEngine.submit_events`` and
the temporal plan, with a leak of 0.125 a step by default.  Prints steps/s
and input spikes/s next to the modeled pJ per timestep.

    python -m repro_torch.launch.serve --events --device cpu --smoke

The network is random, drawn with ``numpy.random.default_rng(seed)``:
jax.random's bits cannot be reproduced in torch, so the same seed gives a
different network than ``python -m repro.launch.serve --esam``.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.esam import cost_model as cm
from repro_torch.core.esam.network import EsamNetwork
from repro_torch.core.esam.temporal import TemporalConfig
from repro_torch.data import digits
from repro_torch.data import events as events_mod
from repro_torch.kernels.common import resolve_device
from repro_torch.serve.engine import EventRequest, SpikeEngine, SpikeRequest


@dataclasses.dataclass
class EsamServeRun:
    """What one ``--esam`` run served, for callers that check it."""

    net: EsamNetwork
    engine: SpikeEngine            # the timed engine
    requests: list[SpikeRequest]   # served by the timed engine
    spikes: np.ndarray             # {0,1}[n_requests, 768] digit traffic
    warm_rounds: int               # rounds of the untimed warm-up engine
    wall_s: float                  # timed serve(), results on the host


@dataclasses.dataclass
class EventServeRun:
    """What one ``--events`` run served, for callers that check it."""

    net: EsamNetwork
    engine: SpikeEngine              # the timed engine
    requests: list[EventRequest]     # served by the timed engine
    warm_engine: SpikeEngine         # the untimed warm-up engine
    warm_requests: list[EventRequest]
    input_spikes: int                # spikes in the timed streams
    wall_s: float                    # timed serve(), results on the host


def random_esam_network(topology, seed: int, device="cuda") -> EsamNetwork:
    """Random ±1 weights (bits 0/1 at p=0.5), zero thresholds and offsets."""
    rng = np.random.default_rng(seed)
    bits = [rng.integers(0, 2, size=(topology[i], topology[i + 1]),
                         dtype=np.int8)
            for i in range(len(topology) - 1)]
    vth = [np.zeros((n,), np.int32) for n in topology[1:]]
    return EsamNetwork.from_numpy(
        bits, vth, np.zeros((topology[-1],), np.float32), device=device)


def esam_main(args) -> EsamServeRun:
    dev = resolve_device(args.device)
    topology = (768, 256, 10) if args.smoke else cm.PAPER_TOPOLOGY
    n_requests = args.requests if args.requests is not None else (
        64 if args.smoke else 512)
    max_batch = 128 if args.batch_size is None else args.batch_size
    net = random_esam_network(topology, args.seed, dev)
    engine_kw = dict(max_batch=max_batch, telemetry=True,
                     read_ports=args.read_ports, device=dev)

    x, _ = digits.make_spike_dataset(n_requests, seed=args.seed)
    # warm on a throwaway engine serving the same workload shape (the plan
    # is cached per network, and the card builds its kernels at first use)
    # so the timed engine's stats() see only the timed requests
    warm = SpikeEngine(net, **engine_kw)
    warm.serve([SpikeRequest(spikes=r) for r in x])
    reqs = [SpikeRequest(spikes=x[i]) for i in range(n_requests)]
    eng = SpikeEngine(net, **engine_kw)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    eng.serve(reqs)           # ends in the flush's device-to-host copies
    wall_s = time.perf_counter() - t0

    st = eng.stats()
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"esam-serve: {st['n_requests']} requests on {where} "
          f"(topology={':'.join(map(str, topology))}, cell={st['cell']}, "
          f"buckets={eng._buckets}, rounds={st['rounds_static']})")
    print(f"  wall-clock        : {wall_s*1e3:8.1f} ms  "
          f"({len(reqs)/wall_s:,.0f} req/s)")
    print(f"  model throughput  : "
          f"{st['throughput_pipelined_inf_s']/1e6:8.2f} MInf/s "
          f"(pipelined; paper {cm.PAPER_THROUGHPUT_INF_S/1e6:.0f})")
    print(f"  model energy      : {st['energy_pj_per_inf']:8.1f} pJ/Inf "
          f"(paper {cm.PAPER_ENERGY_PJ_PER_INF:.0f})")
    print(f"  model latency     : {st['latency_ns_mean']:8.1f} ns/inf "
          f"({st['cycles_mean']:.1f} cycles)")
    missing = sum(r.label is None for r in reqs)
    if missing:
        raise RuntimeError(f"{missing} of {len(reqs)} requests got no label")
    return EsamServeRun(net=net, engine=eng, requests=reqs, spikes=x,
                        warm_rounds=warm.stats()["rounds_static"],
                        wall_s=wall_s)


def events_main(args) -> EventServeRun:
    """Mixed-T rate-encoded digit streams through ``submit_events``."""
    dev = resolve_device(args.device)
    topology = (768, 256, 10) if args.smoke else cm.PAPER_TOPOLOGY
    t_mix = (2, 4) if args.smoke else (4, 8, 16)
    n_requests = args.requests if args.requests is not None else (
        32 if args.smoke else 256)
    max_batch = 64 if args.batch_size is None else args.batch_size
    net = random_esam_network(topology, args.seed, dev)
    engine_kw = dict(max_batch=max_batch, telemetry=True,
                     read_ports=args.read_ports, device=dev,
                     temporal=TemporalConfig(n_steps=1, leak=args.leak))

    def make_requests():
        reqs, rng = [], np.random.default_rng(args.seed)
        for i, t in enumerate(rng.choice(t_mix, size=n_requests)):
            ev, _ = events_mod.encode_digit_events(
                1, int(t), encoder="rate", seed=args.seed + i, gain=0.7,
                packed=True)
            reqs.append(EventRequest(events=ev[:, 0]))
        return reqs

    # warm a throwaway engine on the same workload shape (plans are cached
    # per network) so the timed engine's stats() see only the timed streams
    warm = SpikeEngine(net, **engine_kw)
    warm_reqs = warm.serve(make_requests())
    eng = SpikeEngine(net, **engine_kw)
    reqs = make_requests()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    eng.serve(reqs)           # ends in the flush's device-to-host copies
    wall_s = time.perf_counter() - t0

    st = eng.stats()
    n_spikes = int(sum(np.unpackbits(np.asarray(r.events).view(np.uint8)).sum()
                       for r in reqs))
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"esam-events: {st['n_event_requests']} streams, "
          f"{st['timesteps_total']} timesteps on {where} "
          f"(topology={':'.join(map(str, topology))}, T mix {tuple(t_mix)}, "
          f"leak={args.leak}, cell={st['cell']}, "
          f"rounds={st['rounds_event']})")
    print(f"  wall-clock        : {wall_s*1e3:8.1f} ms  "
          f"({st['timesteps_total']/wall_s:,.0f} steps/s, "
          f"{n_spikes/wall_s:,.0f} spikes/s)")
    print(f"  model energy      : {st['energy_pj_per_timestep']:8.1f} "
          f"pJ/timestep ({st['event_energy_pj_mean']:.1f} pJ/stream)")
    print(f"  model latency     : {st['event_latency_ns_mean']:8.1f} "
          f"ns/stream ({st['event_cycles_mean']:.1f} cycles)")
    missing = sum(r.label is None for r in reqs)
    if missing:
        raise RuntimeError(f"{missing} of {len(reqs)} streams got no label")
    return EventServeRun(net=net, engine=eng, requests=reqs, warm_engine=warm,
                         warm_requests=warm_reqs, input_spikes=n_spikes,
                         wall_s=wall_s)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--esam", action="store_true",
                    help="serve synthetic digit traffic through SpikeEngine")
    ap.add_argument("--events", action="store_true",
                    help="serve event streams through the temporal plan")
    ap.add_argument("--smoke", action="store_true",
                    help="topology 768:256:10 instead of the paper's "
                         "768:256:256:256:10")
    ap.add_argument("--requests", type=int, default=None,
                    help="default: 64 (--esam --smoke), 512 (--esam), "
                         "32 (--events --smoke), 256 (--events)")
    ap.add_argument("--batch-size", type=int, default=None,
                    help="the engine's max_batch (default 128 with --esam, "
                         "64 with --events)")
    ap.add_argument("--read-ports", type=int, default=4,
                    help="cell option 0..4 of the cost model")
    ap.add_argument("--leak", type=float, default=0.125,
                    help="--events: LIF leak per timestep")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds numpy.random.default_rng for the random "
                         "network and the digit traffic (jax.random's bits "
                         "cannot be reproduced, so the network differs from "
                         "the JAX launcher's at the same seed)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    if args.events:
        return events_main(args)
    if not args.esam:
        ap.error("only --esam and --events serving are ported to "
                 "repro_torch; the LM and --traffic modes are not")
    return esam_main(args)


if __name__ == "__main__":
    main()
