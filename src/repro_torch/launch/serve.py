"""Serving launcher of the port: ESAM spike serving on one GPU.

Synthetic digit traffic is served end to end through ``SpikeEngine``: the
admission queue, power-of-two buckets, and the packed plan, whose cascade is
one CUDA launch per round on the card.  Prints the wall-clock serving rate
next to the modeled paper-unit operating point (MInf/s and pJ/Inf of the
3nm CIM macro, from the measured arbiter loads).

    python -m repro_torch.launch.serve --esam            # 768:256:256:256:10
    python -m repro_torch.launch.serve --esam --smoke    # 768:256:10

``--esam`` serves as the reference's launcher does: round fusion
``--fuse auto`` (the data-parallel degree: 1 on one device) and the
overlapped host packer on (``--no-overlap`` for the synchronous drain).
``--warmup`` runs the engine's whole bucket ladder first (on the card, one
CUDA graph a bucket), then times the first request alone and prints the
reference's ``COLDSTART first_request_ms=... warmup_s=... buckets=...
cache=on|off`` line before serving the rest.

``--compile-cache [DIR]`` keeps the kernel libraries in a persistent cache
(``launch/env.py``; default ``~/.cache/repro-torch-kernels``), so a restart
runs no ``nvcc``.  On the card every mode first builds, or loads from the
cache, all kernel libraries at once and prints ``BUILD dir=...
libraries=... built=... nvcc_s=...`` (this process's compiles; ``built=0``
on a warm cache).  CUDA graphs do not persist: ``--warmup`` captures them
at every start.

``COLDSTART``'s ``cache=`` is the reference's: ``on`` where
``--compile-cache`` was given.  Unlike JAX without its cache, ``off`` does
not mean that every start compiles anew: the libraries are then kept,
hash-keyed, in the repo's own build directory (``<repo>/build/repro_torch``)
and loaded from there at a restart.  ``cache_dir=`` beside it names the
directory the libraries came from, and the ``BUILD`` line's ``built=`` what
this process compiled.

    python -m repro_torch.launch.serve --esam --smoke --warmup --compile-cache

Event mode (``--events``): rate-encoded digit streams of mixed length T
(4, 8, 16; with ``--smoke`` 2, 4) through ``SpikeEngine.submit_events`` and
the temporal plan, with a leak of 0.125 a step by default.  Prints steps/s
and input spikes/s next to the modeled pJ per timestep.

    python -m repro_torch.launch.serve --events --device cpu --smoke

Traffic mode (``--traffic``): open-loop Poisson traffic (seeded arrivals, a
blend of static requests and event streams of T 2 or 4) through the
overload plane (bounded admission, deadlines, the degradation ladder) and,
with ``--replicas N``, the retrying ``FaultAwareRouter`` over N engines on
the one device; ``--chaos`` arms the reference's chaos plan (replica 0
crashes mid-drain, replica 1 stalls 5 ms a round, a storm of 2 x max_batch
requests at t=0).  Prints p50/p99/p99.9 latency, shed/rejected/retry counts
and goodput under the SLO.

    python -m repro_torch.launch.serve --traffic --smoke --replicas 2 \
        --chaos --device cpu

Observability (every mode): ``--metrics-port PORT`` serves the registry
over HTTP on 127.0.0.1 (``/metrics``, ``/metrics.json``, ``/trace.json``,
``/healthz``; 0 picks a free port, printed as ``METRICS port=...``) and
``--metrics-hold-s S`` keeps it up S seconds after the run;
``--trace-out PATH`` writes the run's Perfetto ``trace_event`` JSON
(``TRACE path=... events=... requests=... close_fraction=...``);
``--profile-rounds N`` captures N drain rounds (after ``--profile-skip``)
with ``torch.profiler`` into ``--profile-dir`` (``PROFILE dir=...
rounds=... status=...``); ``--report-json PATH`` (``--traffic``) writes
the ``TrafficReport`` with the metrics snapshot.

    python -m repro_torch.launch.serve --traffic --smoke --device cpu \
        --metrics-port 0 --trace-out trace.json --report-json report.json

The network is random, drawn with ``numpy.random.default_rng(seed)``:
jax.random's bits cannot be reproduced in torch, so the same seed gives a
different network than ``python -m repro.launch.serve --esam``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.esam import cost_model as cm
from repro_torch.core.esam.network import EsamNetwork
from repro_torch.core.esam.temporal import TemporalConfig
from repro_torch.data import digits
from repro_torch.data import events as events_mod
from repro_torch.kernels import _build
from repro_torch.kernels.common import resolve_device
from repro_torch.launch import env as env_mod
from repro_torch.obs import DeviceProfiler, Observability, Registry, Tracer
from repro_torch.obs.http import MetricsServer
from repro_torch.obs.trace import validate_trace
from repro_torch.serve import traffic as traffic_mod
from repro_torch.serve.engine import (EventRequest, FaultAwareRouter,
                                      SpikeEngine, SpikeRequest)
from repro_torch.serve.overload import DegradationLadder
from repro_torch.train.fault_tolerance import RetryPolicy


@dataclasses.dataclass
class EsamServeRun:
    """What one ``--esam`` run served, for callers that check it."""

    net: EsamNetwork
    engine: SpikeEngine            # the timed engine
    requests: list[SpikeRequest]   # served by the timed engine
    spikes: np.ndarray             # {0,1}[n_requests, 768] digit traffic
    warm_rounds: int               # rounds of the untimed warm-up engine
    wall_s: float                  # timed serve(), results on the host
    timed: int                     # requests in the timed serve()
    warmup: Optional[dict] = None  # engine.warmup()'s times (--warmup)
    first_request_ms: Optional[float] = None  # the first request (--warmup)


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


@dataclasses.dataclass
class TrafficRun:
    """What one ``--traffic`` run served, for callers that check it."""

    net: EsamNetwork
    engines: list[SpikeEngine]       # the replicas of the measured run
    server: object                   # engines[0], or the router over them
    config: traffic_mod.TrafficConfig
    chaos: Optional[traffic_mod.ChaosConfig]
    requests: list                   # the offered requests, arrival order
    report: traffic_mod.TrafficReport
    rate_sustainable: float          # req/s of the closed-loop warm-up


def random_esam_network(topology, seed: int, device="cuda") -> EsamNetwork:
    """Random ±1 weights (bits 0/1 at p=0.5), zero thresholds and offsets."""
    rng = np.random.default_rng(seed)
    bits = [rng.integers(0, 2, size=(topology[i], topology[i + 1]),
                         dtype=np.int8)
            for i in range(len(topology) - 1)]
    vth = [np.zeros((n,), np.int32) for n in topology[1:]]
    return EsamNetwork.from_numpy(
        bits, vth, np.zeros((topology[-1],), np.float32), device=device)


# ------------------------------------------------------------------ #
# observability plane: --metrics-port / --trace-out / --profile-rounds
# ------------------------------------------------------------------ #
def _build_observability(args):
    """The launcher's ``Observability`` handle (None when every lane is
    off) and the scrape server when ``--metrics-port`` was given.  Returns
    ``(obs, metrics_server)``; the caller threads ``obs`` into the engines
    and finishes with :func:`_finish_observability`."""
    want_trace = args.trace_out is not None
    want_metrics = args.metrics_port is not None or args.report_json
    want_profile = args.profile_rounds > 0
    if not (want_trace or want_metrics or want_profile):
        return None, None
    registry = Registry() if (want_metrics or want_profile) else None
    tracer = Tracer() if want_trace else None
    profiler = None
    if want_profile:
        profiler = DeviceProfiler(
            args.profile_dir, skip_rounds=args.profile_skip,
            n_rounds=args.profile_rounds, registry=registry)
        # the profiler library's one-time set-up, before any traffic
        profiler.prepare()
    obs = Observability(tracer=tracer, metrics=registry, profile=profiler)
    server = None
    if args.metrics_port is not None:
        server = MetricsServer(registry, port=args.metrics_port,
                               tracer=tracer)
        port = server.start()
        print(f"METRICS port={port} url=http://127.0.0.1:{port}/metrics",
              flush=True)
    return obs, server


def _finish_observability(args, obs, server) -> None:
    """Export the trace, print the summary lines, then hold the scrape
    endpoint open for ``--metrics-hold-s`` (a scraper reads it then)."""
    if obs is None:
        return
    if obs.profile is not None:
        obs.profile.stop()
        status = obs.profile.error or "ok"
        print(f"PROFILE dir={obs.profile.logdir} "
              f"rounds={obs.profile.captured} status={status}")
    if obs.tracer is not None and args.trace_out is not None:
        doc = obs.tracer.export(args.trace_out)
        summary = validate_trace(doc)
        print(f"TRACE path={args.trace_out} events={summary['events']} "
              f"requests={summary['request_begun']} "
              f"close_fraction={summary['request_close_fraction']:.4f}")
    if server is not None:
        if args.metrics_hold_s > 0:
            print(f"METRICS holding for {args.metrics_hold_s:.0f}s",
                  flush=True)
            time.sleep(args.metrics_hold_s)
        server.stop()


def esam_main(args, obs=None) -> EsamServeRun:
    dev = resolve_device(args.device)
    topology = (768, 256, 10) if args.smoke else cm.PAPER_TOPOLOGY
    n_requests = args.requests if args.requests is not None else (
        64 if args.smoke else 512)
    max_batch = 128 if args.batch_size is None else args.batch_size
    net = random_esam_network(topology, args.seed, dev)
    engine_kw = dict(max_batch=max_batch, telemetry=True,
                     read_ports=args.read_ports, device=dev,
                     fuse_rounds=_fuse_arg(args),
                     overlap=not args.no_overlap)

    x, _ = digits.make_spike_dataset(n_requests, seed=args.seed)
    reqs = [SpikeRequest(spikes=x[i]) for i in range(n_requests)]
    eng = SpikeEngine(net, observability=obs, **engine_kw)
    wt, first_ms, warm_rounds = None, None, 0
    if args.warmup:
        # the whole bucket ladder up front, then the very first request the
        # warmed engine serves, timed alone: the cold-start headline
        wt = eng.warmup()
        t0 = time.perf_counter()
        eng.serve([reqs[0]])
        first_ms = (time.perf_counter() - t0) * 1e3
        print(f"COLDSTART first_request_ms={first_ms:.2f} "
              f"warmup_s={wt['total_s']:.2f} "
              f"buckets={len(eng._buckets)} graphs={wt['graphs']} "
              f"cache={'on' if args.compile_cache is not None else 'off'} "
              f"cache_dir={_build.build_dir()}")
        reqs_timed = reqs[1:]
    else:
        # warm on a throwaway engine serving the same workload shape (the
        # plan is cached per network, and the card builds its kernels at
        # first use) so the timed engine's stats() see only the timed
        # requests
        warm = SpikeEngine(net, **engine_kw)
        warm.serve([SpikeRequest(spikes=r) for r in x])
        warm.close()
        warm_rounds = warm.stats()["rounds_static"]
        reqs_timed = reqs
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    eng.serve(reqs_timed)     # ends in the flush, after the copies out
    wall_s = time.perf_counter() - t0
    eng.close()

    st = eng.stats()
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"esam-serve: {st['n_requests']} requests on {where} "
          f"(topology={':'.join(map(str, topology))}, cell={st['cell']}, "
          f"buckets={eng._buckets}, rounds={st['rounds_static']}, "
          f"fuse={st['fuse_rounds']}, overlap={st['overlap']}, "
          f"rounds_saved={st['rounds_saved']})")
    print(f"  wall-clock        : {wall_s*1e3:8.1f} ms  "
          f"({len(reqs_timed)/wall_s:,.0f} req/s)")
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
                        warm_rounds=warm_rounds, wall_s=wall_s,
                        timed=len(reqs_timed), warmup=wt,
                        first_request_ms=first_ms)


def events_main(args, obs=None) -> EventServeRun:
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
    eng = SpikeEngine(net, observability=obs, **engine_kw)
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


def traffic_main(args, obs=None) -> TrafficRun:
    """Open-loop Poisson traffic (optionally chaos-injected) through the
    overload plane, printing the SLO-facing numbers (the reference
    launcher's ``_traffic_main``)."""
    dev = resolve_device(args.device)
    topology = (768, 256, 10) if args.smoke else cm.PAPER_TOPOLOGY
    n_requests = args.requests if args.requests is not None else (
        64 if args.smoke else 256)
    max_batch = 32 if args.batch_size is None else args.batch_size
    net = random_esam_network(topology, args.seed, dev)

    def make_engine(engine_obs=None):
        # the warm-up engine stays uninstrumented, so the scrape and the
        # trace carry only the measured open-loop run
        return SpikeEngine(
            net, max_batch=max_batch, telemetry=True,
            read_ports=args.read_ports, queue_limit=4 * max_batch,
            fuse_rounds=_fuse_arg(args), overlap=not args.no_overlap,
            ladder=DegradationLadder.default(max_batch, args.read_ports),
            observability=engine_obs, device=dev)

    # closed-loop warm-up on the same request blend: the first pass builds
    # every (bucket, T) the traffic can hit, the second measures the
    # sustainable rate, so the default --rate lands relative to saturation
    warm = make_engine()
    blend = dict(rate_hz=1.0, n_requests=n_requests, p_event=args.p_event,
                 event_t_choices=(2, 4), n_in=topology[0])
    warm.serve(traffic_mod.build_requests(
        traffic_mod.TrafficConfig(seed=args.seed, **blend))[0])
    timed = traffic_mod.build_requests(
        traffic_mod.TrafficConfig(seed=args.seed + 1, **blend))[0]
    t0 = time.perf_counter()
    warm.serve(timed)
    rate_sust = len(timed) / (time.perf_counter() - t0)
    warm.close()
    rate = args.rate if args.rate is not None else 2.0 * rate_sust

    engines = [make_engine(obs) for _ in range(max(1, args.replicas))]
    # health_threshold=0: a random network's telemetry deviates from the
    # reference calibration, so health routing would mark every replica
    # degraded; this mode exercises crash/retry/deadlines, not health
    server = engines[0] if len(engines) == 1 else FaultAwareRouter(
        engines, health_threshold=0.0, observability=obs,
        retry=RetryPolicy(base_backoff_s=1e-3, attempt_timeout_s=2.0))
    chaos = None
    if args.chaos:
        chaos = traffic_mod.ChaosConfig(
            slowdown=((1, 5e-3),) if len(engines) > 1 else (),
            crash_replica=0 if len(engines) > 1 else None,
            crash_after_rounds=2,
            storm_at_s=0.0, storm_size=2 * max_batch)
    deadline_s = args.deadline_ms / 1e3 if args.deadline_ms else None
    slo_s = args.slo_ms / 1e3 if args.slo_ms else deadline_s
    cfg = traffic_mod.TrafficConfig(
        rate_hz=rate, n_requests=n_requests, seed=args.seed,
        p_event=args.p_event, event_t_choices=(2, 4),
        n_in=topology[0], deadline_s=deadline_s)
    if args.warmup:
        traffic_mod.warmup_engine(server, cfg)
    schedule = traffic_mod.build_requests(cfg, chaos=chaos)
    rep = traffic_mod.run_open_loop(server, cfg, slo_s=slo_s, chaos=chaos,
                                    schedule=schedule, observability=obs)
    for eng in engines:
        eng.close()
    if args.report_json:
        with open(args.report_json, "w") as f:
            json.dump(rep.to_dict(), f, indent=2, default=str)
        print(f"REPORT path={args.report_json}")

    print(f"esam-traffic: offered {rep.n_offered} requests @ {rate:,.0f}/s "
          f"(sustainable ~{rate_sust:,.0f}/s, replicas={len(engines)}, "
          f"chaos={'on' if chaos else 'off'})")
    print(f"  completed         : {rep.n_completed}  "
          f"(shed {rep.n_shed}, rejected {rep.n_rejected}, "
          f"failed {rep.n_failed}, deadline-miss {rep.n_deadline_miss})")
    print(f"  latency           : p50 {rep.p50_ms:8.1f} ms   "
          f"p99 {rep.p99_ms:8.1f} ms   p99.9 {rep.p999_ms:8.1f} ms")
    print(f"  goodput under SLO : {100 * rep.goodput_slo:6.1f} %  "
          f"(SLO {1e3 * rep.slo_s:.0f} ms)" if rep.slo_s else
          f"  goodput           : {100 * rep.goodput_slo:6.1f} %")
    print(f"  resilience        : retries {rep.retries}, "
          f"crashes {rep.crashes}, timeouts {rep.timeouts}, "
          f"degraded routes {rep.degraded_routes}")
    print(f"  degradation       : {rep.ladder_transitions} transitions, "
          f"deepest level {rep.max_degradation_level}; "
          f"backpressure events {rep.backpressure_events}")
    return TrafficRun(net=net, engines=engines, server=server, config=cfg,
                      chaos=chaos, requests=schedule[0], report=rep,
                      rate_sustainable=rate_sust)


def build_kernels(device) -> list:
    """On the card, build every kernel library this process lacks (one
    ``nvcc`` each, all at once; a library in the cache is loaded as it is)
    and print the ``BUILD`` line: this process's nvcc seconds, summed over
    the libraries it compiled.  Returns the build reports (none on the
    CPU, which runs the plain versions)."""
    if resolve_device(device).type != "cuda":
        return []
    t0 = time.perf_counter()
    reports = _build.build_all()
    built = [r for r in reports if r.build_s > 0.0]
    print(f"BUILD dir={_build.build_dir()} libraries={len(reports)} "
          f"built={len(built)} "
          f"nvcc_s={sum(r.build_s for r in reports):.2f} "
          f"wall_s={time.perf_counter() - t0:.2f}", flush=True)
    return reports


def _fuse_arg(args):
    """Resolve --fuse: "auto" (default) | "off" | an integer factor."""
    if args.fuse in ("off", "none", "0"):
        return None
    if args.fuse == "auto":
        return "auto"
    return int(args.fuse)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--esam", action="store_true",
                    help="serve synthetic digit traffic through SpikeEngine")
    ap.add_argument("--events", action="store_true",
                    help="serve event streams through the temporal plan")
    ap.add_argument("--traffic", action="store_true",
                    help="open-loop Poisson traffic through the overload "
                         "plane (deadlines, ladder, retries); see also "
                         "--chaos/--replicas")
    ap.add_argument("--rate", type=float, default=None,
                    help="--traffic: offered arrival rate in req/s "
                         "(default: 2x the measured sustainable rate)")
    ap.add_argument("--deadline-ms", type=float, default=250.0,
                    help="--traffic: per-request deadline (0 disables)")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="--traffic: goodput SLO (default: the deadline)")
    ap.add_argument("--p-event", type=float, default=0.25,
                    help="--traffic: fraction of event-stream requests")
    ap.add_argument("--replicas", type=int, default=1,
                    help="--traffic: engine replicas behind the router")
    ap.add_argument("--chaos", action="store_true",
                    help="--traffic: crash replica 0 mid-drain, slow "
                         "replica 1, and inject a request storm")
    ap.add_argument("--smoke", action="store_true",
                    help="topology 768:256:10 instead of the paper's "
                         "768:256:256:256:10")
    ap.add_argument("--requests", type=int, default=None,
                    help="default: 64 (--esam --smoke), 512 (--esam), "
                         "32 (--events --smoke), 256 (--events), "
                         "64 (--traffic --smoke), 256 (--traffic)")
    ap.add_argument("--batch-size", type=int, default=None,
                    help="the engine's max_batch (default 128 with --esam, "
                         "64 with --events, 32 with --traffic)")
    ap.add_argument("--read-ports", type=int, default=4,
                    help="cell option 0..4 of the cost model")
    ap.add_argument("--leak", type=float, default=0.125,
                    help="--events: LIF leak per timestep")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds numpy.random.default_rng for the random "
                         "network and the digit traffic (jax.random's bits "
                         "cannot be reproduced, so the network differs from "
                         "the JAX launcher's at the same seed)")
    ap.add_argument("--fuse", default="auto",
                    help="--esam: round fusion factor: 'auto' (= the "
                         "data-parallel degree, 1 here), 'off', or an "
                         "integer")
    ap.add_argument("--no-overlap", action="store_true",
                    help="--esam: no background host packer (the "
                         "synchronous drain)")
    ap.add_argument("--warmup", action="store_true",
                    help="--esam: run the bucket ladder before serving (on "
                         "the card, one CUDA graph a bucket) and print the "
                         "COLDSTART first-request line; --traffic: warm "
                         "every replica's (bucket, T) shapes first")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--compile-cache", nargs="?", const="", default=None,
                    metavar="DIR",
                    help="keep the CUDA kernel libraries in a persistent "
                         "cache (optional directory; default "
                         "~/.cache/repro-torch-kernels)")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                    help="serve Prometheus /metrics on 127.0.0.1 at this "
                         "port (0 = a free one; prints 'METRICS port=...')")
    ap.add_argument("--metrics-hold-s", type=float, default=0.0,
                    help="keep the /metrics endpoint up this long after the "
                         "run finishes (lets a scraper read it before exit)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="export a Perfetto trace_event JSON of the run "
                         "(open at ui.perfetto.dev)")
    ap.add_argument("--profile-rounds", type=int, default=0, metavar="N",
                    help="capture a torch.profiler trace around N drain "
                         "rounds (see --profile-dir/--profile-skip)")
    ap.add_argument("--profile-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "esam-profile"),
                    help="directory of the torch.profiler Chrome trace "
                         "(default: esam-profile in the temp directory, "
                         "/tmp/esam-profile as the reference's)")
    ap.add_argument("--profile-skip", type=int, default=1,
                    help="drain rounds to skip before the profiler arms "
                         "(skips the first round's kernel loads; default 1)")
    ap.add_argument("--report-json", default=None, metavar="PATH",
                    help="--traffic: write the TrafficReport (with the "
                         "metrics snapshot) as JSON")
    args = ap.parse_args(argv)
    if not (args.traffic or args.events or args.esam):
        ap.error("only --esam, --events and --traffic serving are ported "
                 "to repro_torch; the LM mode is not")
    if args.compile_cache is not None:
        env_mod.enable_compilation_cache(args.compile_cache or None)
    build_kernels(args.device)
    obs, metrics_server = _build_observability(args)
    try:
        if args.traffic:
            return traffic_main(args, obs)
        if args.events:
            return events_main(args, obs)
        return esam_main(args, obs)
    finally:
        _finish_observability(args, obs, metrics_server)


if __name__ == "__main__":
    main()
