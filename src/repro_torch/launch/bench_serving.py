"""Serving bench of the port: the lanes of the reference's
``benchmarks/bench_serving.py``, on the card and at the reference's sizes.

    python -m repro_torch.launch.bench_serving                 # on the card
    python -m repro_torch.launch.bench_serving --device cpu --smoke
    python -m repro_torch.launch.bench_serving --out serving.json

``SpikeEngine`` (admission queue -> power-of-two buckets -> the packed
plan, fused dispatch and the overlapped packer) serves synthetic digit
traffic through the paper network (768:256:256:256:10, the reference's
``_paper_net``: ``bernoulli(fold_in(PRNGKey(seed), t), 0.5)`` a tile through
``core/prng.py``, zero thresholds and offset), one row a lane:

``serving_single_device``  2048 requests (``--requests``), ``max_batch``
    128, warmed, ``fuse_rounds="auto"``, ``overlap=True``: req/s, rounds,
    and the modeled MInf/s and pJ/Inf beside the paper's 44 and 607.
``serving_sharded_skipped`` the data-parallel lanes need sharded serving
    plans (ROADMAP.md, multi-device), as the reference reports one device.
``serving_cold_start``     the first request of a cold engine and of a
    warmed one, each on a fresh network (seeds 101 and 102);
    ``compilation_cache=on`` where ``$REPRO_TORCH_CACHE_DIR`` names the
    port's persistent kernel library cache (``launch/env.py``), as the
    reference reads ``JAX_COMPILATION_CACHE_DIR``.  ``off`` is not the
    reference's compile at every start: the libraries are then kept in
    the repo's own build directory (``<repo>/build/repro_torch``), which
    persists across processes as well.
``serving_obs_overhead``   1024 requests (``--smoke``: 256) drained warmed
    with the tracing and metrics plane off and on, best of 3 each side;
    ``overhead_pct`` is reported beside the reference's ``gate=5%``, which
    this bench does not assert.
``serving_openloop_under`` / ``serving_openloop_over``  seeded Poisson
    traffic at 0.5x and 2x the sustainable rate the lane measures itself
    (160 requests; ``--smoke``: 48), bounded queue, deadline, degradation
    ladder; the over lane adds a storm: p50/p99/p99.9, goodput under the
    SLO, shed and rejected counts.
``serving_chaos``          two replicas behind the retrying
    ``FaultAwareRouter``: replica 0 crashes after 1 round, replica 1 is
    slowed 2 ms a round; no request may be lost (asserted, as the
    reference asserts it).

Rows go to stdout as ``name,us_per_call,derived``; ``--out`` writes
``{"results": [...]}``.  ``--smoke`` stands in for the reference's
``BENCH_SERVING_SMOKE`` and ``--requests`` for ``BENCH_SERVING_REQUESTS``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.esam import cost_model as cm
from repro_torch.core.esam.network import EsamNetwork
from repro_torch.data import digits
from repro_torch.kernels import _build
from repro_torch.kernels.common import resolve_device
from repro_torch.launch.bench_common import Recorder, fields, sync
from repro_torch.obs import Observability, Registry
from repro_torch.serve import traffic as traffic_mod
from repro_torch.serve.engine import (FaultAwareRouter, SpikeEngine,
                                      SpikeRequest)
from repro_torch.serve.overload import DegradationLadder
from repro_torch.train.fault_tolerance import RetryPolicy

N_REQUESTS = 2048
MAX_BATCH = 128


def paper_net(seed: int = 0, device="cuda") -> EsamNetwork:
    """The reference bench's ``_paper_net(seed)`` bit for bit."""
    key = prng.PRNGKey(seed)
    topo = cm.PAPER_TOPOLOGY
    bits = [prng.bernoulli(prng.fold_in(key, i), 0.5,
                           (topo[i], topo[i + 1])).to(torch.int8)
            for i in range(len(topo) - 1)]
    vth = [torch.zeros((n,), dtype=torch.int32) for n in topo[1:]]
    return EsamNetwork(bits, vth, torch.zeros((topo[-1],)), device=device)


def _serve_once(rec: Recorder, tag: str, net, reqs_np,
                dev: torch.device) -> float:
    """One throughput lane on the fused, overlapped engine, warmed first,
    so the timed run is steady-state serving and its stats() see only the
    timed requests.  Returns req/s."""
    eng = SpikeEngine(net, max_batch=MAX_BATCH, telemetry=True, read_ports=4,
                      fuse_rounds="auto", overlap=True, device=dev)
    eng.warmup()
    reqs = [SpikeRequest(spikes=r) for r in reqs_np]
    sync(dev)
    t0 = time.perf_counter()
    eng.serve(reqs)           # ends in the flush, after the copies out
    wall_s = time.perf_counter() - t0
    st = eng.stats()
    req_s = len(reqs) / wall_s
    rec.emit(
        f"serving_{tag}", wall_s * 1e6 / len(reqs),
        f"requests={len(reqs)};requests_per_s={req_s:,.0f};"
        f"data_parallel={st['data_parallel']};buckets={eng._buckets};"
        f"fuse={st['fuse_rounds']};overlap={st['overlap']};"
        f"rounds_static={st['rounds_static']};"
        f"fused_rounds={st['fused_rounds']};"
        f"rounds_saved={st['rounds_saved']};"
        f"model_minf_s={st['throughput_pipelined_inf_s']/1e6:.2f}"
        f"(paper {cm.PAPER_THROUGHPUT_INF_S/1e6:.0f});"
        f"model_energy_pj_inf={st['energy_pj_per_inf']:.0f}"
        f"(paper {cm.PAPER_ENERGY_PJ_PER_INF:.0f});"
        f"cell={st['cell']}",
    )
    eng.close()
    return req_s


def _overload_lanes(rec: Recorder, net, dev: torch.device,
                    smoke: bool) -> None:
    """Open-loop Poisson lanes below and above saturation, and the chaos
    lane.  The over lane's storm against a bounded queue makes sheds and
    rejections certain; the deadline turns queue growth into sheds."""
    n = 48 if smoke else 160
    max_batch = 32
    queue_limit = 2 * max_batch
    n_in = net.topology[0]

    def mk(queue_limit=queue_limit):
        return SpikeEngine(net, max_batch=max_batch, telemetry=True,
                           queue_limit=queue_limit,
                           ladder=DegradationLadder.default(max_batch),
                           device=dev)

    # every bucket warm, then the sustainable rate on an unbounded engine,
    # so the lanes' rates are anchored at this host's saturation point
    blend = dict(n_requests=n, p_event=0.0, n_in=n_in)
    warm = mk(queue_limit=None)
    traffic_mod.warmup_engine(warm, traffic_mod.TrafficConfig(rate_hz=1.0,
                                                              **blend))
    timed = traffic_mod.build_requests(
        traffic_mod.TrafficConfig(rate_hz=1.0, seed=22, **blend))[0]
    sync(dev)
    t0 = time.perf_counter()
    warm.serve(timed)
    rate_sust = len(timed) / (time.perf_counter() - t0)
    warm.close()
    # ~48 requests' worth of service: above one open-loop drain's latency
    # floor, so goodput separates the lanes
    deadline_s = 48.0 / rate_sust
    slo_s = deadline_s

    lanes = [
        ("under", 0.5 * rate_sust, None),
        ("over", 2.0 * rate_sust,
         traffic_mod.ChaosConfig(storm_at_s=0.0, storm_size=3 * queue_limit)),
    ]
    for tag, rate, chaos in lanes:
        eng = mk()
        cfg = traffic_mod.TrafficConfig(rate_hz=rate, seed=23,
                                        deadline_s=deadline_s, **blend)
        rep = traffic_mod.run_open_loop(eng, cfg, slo_s=slo_s, chaos=chaos)
        eng.close()
        shed_total = rep.n_shed + rep.n_rejected
        rec.emit(
            f"serving_openloop_{tag}", rep.p99_ms * 1e3,
            f"rate_hz={rate:.0f};sustainable_hz={rate_sust:.0f};"
            f"offered={rep.n_offered};completed={rep.n_completed};"
            f"p50_ms={rep.p50_ms:.2f};p99_ms={rep.p99_ms:.2f};"
            f"p999_ms={rep.p999_ms:.2f};goodput_slo={rep.goodput_slo:.3f};"
            f"slo_ms={1e3 * slo_s:.1f};deadline_ms={1e3 * deadline_s:.1f};"
            f"shed={rep.n_shed};rejected={rep.n_rejected};"
            f"shed_total={shed_total};"
            f"backpressure={rep.backpressure_events};"
            f"ladder_transitions={rep.ladder_transitions};"
            f"max_degradation_level={rep.max_degradation_level}",
        )

    # chaos: replica 0 crashes mid-drain, replica 1 is slowed; the router's
    # retry path must complete every admitted request
    engines = [mk(queue_limit=None), mk(queue_limit=None)]
    router = FaultAwareRouter(
        engines, retry=RetryPolicy(max_attempts=4, base_backoff_s=1e-4,
                                   seed=5))
    chaos = traffic_mod.ChaosConfig(slowdown=((1, 2e-3),), crash_replica=0,
                                    crash_after_rounds=1)
    cfg = traffic_mod.TrafficConfig(rate_hz=2.0 * rate_sust, seed=29, **blend)
    rep = traffic_mod.run_open_loop(router, cfg, chaos=chaos)
    for eng in engines:
        eng.close()
    lost = rep.n_offered - (rep.n_completed + rep.n_shed + rep.n_rejected
                            + rep.n_failed)
    if lost:
        raise AssertionError(f"chaos lane lost {lost} requests")
    rec.emit(
        "serving_chaos", rep.p99_ms * 1e3,
        f"offered={rep.n_offered};completed={rep.n_completed};"
        f"retries={rep.retries};crashes={rep.crashes};"
        f"timeouts={rep.timeouts};failed={rep.n_failed};lost={lost};"
        f"p99_ms={rep.p99_ms:.2f}",
    )


def _obs_overhead_lane(rec: Recorder, net, dev: torch.device,
                       smoke: bool) -> None:
    """Tracing and metrics on against off: the same warmed closed-loop
    drain, best of 3 each side, the plane's spans and histogram observes
    into a fresh registry each repeat."""
    n = 256 if smoke else 1024
    x, _ = digits.make_spike_dataset(n, seed=31)

    def drain_s(obs) -> float:
        eng = SpikeEngine(net, max_batch=MAX_BATCH, telemetry=True,
                          fuse_rounds="auto", overlap=True,
                          observability=obs, device=dev)
        eng.warmup()
        reqs = [SpikeRequest(spikes=r) for r in x]
        sync(dev)
        t0 = time.perf_counter()
        eng.serve(reqs)
        wall = time.perf_counter() - t0
        eng.close()
        return wall

    off_s = min(drain_s(None) for _ in range(3))
    on_s = min(drain_s(Observability.enabled(registry=Registry()))
               for _ in range(3))
    overhead_pct = 100.0 * (on_s - off_s) / off_s
    rec.emit(
        "serving_obs_overhead", on_s * 1e6 / n,
        f"requests={n};tracer_off_ms={off_s * 1e3:.1f};"
        f"tracer_on_ms={on_s * 1e3:.1f};"
        f"overhead_pct={overhead_pct:.2f}%;gate=5%;repeats=3",
    )


def _cold_start_lane(rec: Recorder, dev: torch.device) -> None:
    """First-request latency, cold against warmed, each on a fresh network
    (a fresh plan): the cold engine builds its plan in the serve path, the
    warm one in ``warmup()`` (on the card, one CUDA graph a bucket)."""
    def first_request_ms(warm: bool, seed: int):
        net = paper_net(seed, dev)
        eng = SpikeEngine(net, max_batch=32, telemetry=True, device=dev)
        warmup_s = 0.0
        if warm:
            t0 = time.perf_counter()
            eng.warmup()
            warmup_s = time.perf_counter() - t0
        spikes = (np.random.default_rng(seed).random(net.topology[0])
                  < 0.3).astype(np.uint8)
        sync(dev)
        t0 = time.perf_counter()
        eng.serve([SpikeRequest(spikes=spikes)])
        return (time.perf_counter() - t0) * 1e3, warmup_s

    cold_ms, _ = first_request_ms(False, seed=101)
    warm_ms, warmup_s = first_request_ms(True, seed=102)
    rec.emit(
        "serving_cold_start", warm_ms * 1e3,
        f"cold_first_request_ms={cold_ms:.1f};"
        f"warm_first_request_ms={warm_ms:.1f};"
        f"warmup_s={warmup_s:.2f};"
        f"speedup={cold_ms / max(warm_ms, 1e-9):.1f}x;"
        f"compilation_cache="
        f"{'on' if os.environ.get(_build.CACHE_ENV) else 'off'}",
    )


def run(*, device="cuda", smoke: bool = False,
        requests: int = N_REQUESTS) -> list[dict]:
    """Every lane on ``device`` (``"cuda"`` by default; raises without a
    GPU).  Returns the rows."""
    dev = resolve_device(device)
    rec = Recorder()
    net = paper_net(0, dev)
    x, _ = digits.make_spike_dataset(requests, seed=7)
    _serve_once(rec, "single_device", net, x, dev)
    rec.emit("serving_sharded_skipped", 0.0,
             "devices=1(the data-parallel lanes need sharded serving "
             "plans: ROADMAP.md, multi-device)")
    _cold_start_lane(rec, dev)
    _obs_overhead_lane(rec, net, dev, smoke)
    _overload_lanes(rec, net, dev, smoke)
    return rec.rows


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's BENCH_SERVING_SMOKE sizes: 256 "
                         "requests a side in the overhead lane, 48 in the "
                         "open-loop and chaos lanes")
    ap.add_argument("--requests", type=int, default=N_REQUESTS,
                    help="requests of the single-device lane (the "
                         "reference's BENCH_SERVING_REQUESTS)")
    ap.add_argument("--out", default=None,
                    help="write the rows as JSON to this path")
    args = ap.parse_args(argv)
    print("name,us_per_call,derived", flush=True)
    rows = run(device=args.device, smoke=args.smoke, requests=args.requests)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"results": rows}, f, indent=2)
        print(f"[bench] wrote {args.out} ({len(rows)} entries)")
    return rows


if __name__ == "__main__":
    main()
