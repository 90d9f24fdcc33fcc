"""The temporal-plane bench twin's fused side and stream lanes
(``launch.bench_temporal``) on the CPU against the reference's
``benchmarks/bench_temporal.py`` at the ``--smoke`` sizes: the temporal
plan's logits equal the reference's plan on the same streams and the
per-step loop's, and the stream rows' modeled energies equal the
reference's.  Each section runs alone here (the whole smoke run, with its
BNN fit, is ``test_torch_bench_temporal.py``'s)."""

from __future__ import annotations

import io
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch
from torch_bench_rows import (fields, parse_rows,
                              one_torch_thread,  # noqa: F401
                              time_call_once)

from repro_torch.launch import bench_temporal
from repro_torch.launch.bench_common import Recorder

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _section(fn) -> Recorder:
    """One section of the smoke run on the CPU, each timed call made
    once."""
    rec = Recorder()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench_temporal, "time_call", time_call_once)
        fn(rec, torch.device("cpu"), True)
    return rec


@pytest.fixture(scope="module")
def fused_vs_naive():
    return _section(bench_temporal._fused_vs_naive).outputs["fused_vs_naive"]


@pytest.fixture(scope="module")
def stream_rows():
    rows = _section(bench_temporal._stream_rates).rows
    assert [r["name"] for r in rows] == ["temporal_stream_T2",
                                         "temporal_stream_T4"]
    return rows


def test_smoke_plan_logits_equal_the_references_plan(fused_vs_naive):
    """The fused side at ``--smoke`` sizes: the same events and network
    give the reference's jitted temporal plan's logits, bit for bit, and
    the per-step loop's."""
    from benchmarks import bench_temporal as ref
    from repro.core import packing as ref_packing
    from repro.core.esam import temporal as ref_temporal

    out = fused_vs_naive
    ev = ref._event_stream(32, 4)
    np.testing.assert_array_equal(out["events"], ev)
    net = ref._rand_net((768, 256, 10))
    cfg = ref_temporal.TemporalConfig(n_steps=4, leak=0.125)
    plan = net.plan(mode="temporal", temporal=cfg)
    want = np.asarray(plan(jax.numpy.asarray(
        ref_packing.pack_spikes_np(ev))).logits)
    np.testing.assert_array_equal(out["logits"], want)
    np.testing.assert_array_equal(out["naive"], want)


def test_smoke_stream_energy_equals_the_references(stream_rows):
    """pJ a timestep and a stream (float32 telemetry, the reference's sum
    order differs): equal to the printed digit, 0.1 pJ."""
    from benchmarks import bench_temporal as ref
    from benchmarks.common import Recorder

    mp = pytest.MonkeyPatch()
    mp.setattr(ref, "SMOKE", True)
    try:
        buf = io.StringIO()
        with redirect_stdout(buf):
            ref._bench_stream_rates(Recorder())
    finally:
        mp.undo()
    want = parse_rows(buf.getvalue())
    got = stream_rows
    assert [r["name"] for r in got] == [r["name"] for r in want]
    for g, w in zip(got, want):
        fg, fw = fields(g["derived"]), fields(w["derived"])
        assert set(fg) == set(fw) and fg["batch"] == fw["batch"]
        for k in ("pj_per_timestep", "pj_per_stream"):
            assert abs(float(fg[k]) - float(fw[k])) <= 0.1 + 1e-9, (
                g["name"], k)
