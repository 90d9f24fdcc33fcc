"""The temporal-plane bench twin (``launch.bench_temporal``) on the CPU
against the reference's ``benchmarks/bench_temporal.py``: ``rand_net``'s
bits and thresholds (``prng.randint``) equal the reference's ``_rand_net``;
at the ``--smoke`` sizes every row's name and keys are the reference's,
and ``replay_on_cpu`` holds every stream and encoder lane and catches a
changed value.  The plan's logits and the stream rows' energies against
the reference's plan are in ``test_torch_bench_temporal_plan.py``.  The
card's floors (the fused scan >= 5x the one-shot loop) are not held here:
a CPU time says nothing of the card."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch_bench_rows import (assert_reference_rows, fields,
                              one_torch_thread,  # noqa: F401
                              time_call_once)

from repro_torch.core.esam import cost_model as cm
from repro_torch.launch import bench_temporal

#: the reference's smoke rows, in order
SMOKE_ROWS = ("temporal_fused_vs_naive", "temporal_stream_T2",
              "temporal_stream_T4", "temporal_encoder_rate",
              "temporal_encoder_latency")

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("topology,seed", [((768, 256, 10), 0),
                                           (cm.PAPER_TOPOLOGY, 0),
                                           ((100, 40, 7), 5)])
def test_rand_net_is_the_references(topology, seed):
    from benchmarks import bench_temporal as ref

    got = bench_temporal.rand_net(topology, seed, device="cpu")
    want = ref._rand_net(topology, seed)
    for g, w in zip(got.weight_bits, want.weight_bits):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(got.vth, want.vth):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert 0 <= int(g.min()) and int(g.max()) < 12
    assert not torch.any(got.out_offset)


@pytest.fixture(scope="module")
def smoke_run():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench_temporal, "time_call", time_call_once)
        return bench_temporal.run(device="cpu", smoke=True)


def test_smoke_rows_are_the_references(smoke_run):
    rec = smoke_run
    assert tuple(r["name"] for r in rec.rows) == SMOKE_ROWS
    assert_reference_rows(rec.rows, "bench_temporal")
    f = fields(rec.rows[0]["derived"])
    assert set(f) == {"T", "batch", "naive_one_shot_us", "speedup",
                      "warm_eager_us", "speedup_warm_eager",
                      "jitted_loop_us", "speedup_vs_jitted_loop",
                      "bit_identical_to_jitted_loop", "floor"}
    assert (f["T"], f["batch"], f["floor"]) == ("4", "32", "5x")
    assert f["bit_identical_to_jitted_loop"] == "yes"
    assert not rec.launches          # the CPU launches nothing


def test_replay_on_cpu_holds_every_lane(smoke_run):
    """``replay_on_cpu`` runs each stream and encoder lane again and holds
    logits, loads and request stats bit for bit; a value off by one ulp
    in any of them raises."""
    lanes = smoke_run.outputs["lanes"]
    assert set(lanes) == {"stream_T2", "stream_T4", "encoder_rate",
                          "encoder_latency"}
    held = bench_temporal.replay_on_cpu(smoke_run)
    assert held["encoder_rate"] == 512 * 10
    # logits, every tile's loads, and of 32 streams the cycles of each
    # tile and 4 more stats
    t4 = lanes["stream_T4"]
    n_tiles = len(t4["loads"])
    assert held["stream_T4"] == 32 * 10 + sum(
        ld.numel() for ld in t4["loads"]) + 32 * (n_tiles + 4)
    for key in ("logits", "stats", "loads"):
        saved = t4[key]
        bad = (dict(saved) if key == "stats" else
               list(saved) if key == "loads" else saved)
        if key == "logits":
            bad = torch.nextafter(saved, saved + 1)
        elif key == "stats":
            bad["energy_pj"] = torch.nextafter(saved["energy_pj"],
                                               saved["energy_pj"] + 1)
        else:
            bad[1] = saved[1] + 1
        t4[key] = bad
        try:
            with pytest.raises(AssertionError, match="stream_T4"):
                bench_temporal.replay_on_cpu(smoke_run)
        finally:
            t4[key] = saved


def test_smoke_encoders_beside_the_static_plan(smoke_run):
    rows = {r["name"]: fields(r["derived"]) for r in smoke_run.rows}
    for enc in ("rate", "latency"):
        f = rows[f"temporal_encoder_{enc}"]
        assert (f["T"], f["n"]) == ("4", "512")
        assert 0.0 <= float(f["acc"]) <= 100.0
        assert float(f["static_acc"]) > 50.0


def test_temporal_bench_needs_a_gpu_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        bench_temporal.run()
    with pytest.raises(RuntimeError):
        bench_temporal.rand_net((768, 10))


def test_main_smoke_writes_json_only_when_asked(tmp_path, monkeypatch,
                                                capsys):
    import json

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(bench_temporal, "run",
                        lambda **kw: _FakeRec(kw))
    bench_temporal.main(["--device", "cpu", "--smoke"])
    assert list(tmp_path.iterdir()) == []
    rec = bench_temporal.main(["--device", "cpu", "--smoke", "--out",
                               str(tmp_path / "t.json")])
    assert rec.kw == {"device": "cpu", "smoke": True}
    assert json.loads((tmp_path / "t.json").read_text()) == {"results": []}


class _FakeRec:
    def __init__(self, kw):
        self.kw, self.rows = kw, []

    def write_json(self, path):
        from repro_torch.launch.bench_common import Recorder

        Recorder.write_json(self, path)
