"""The port's kernel bench (``repro_torch.launch.bench_kernels``) against
the reference's ``benchmarks/bench_kernels.py``.

``mac_datapath_stats`` keeps the reference's datapath keys and every count
it returns, with the H100's units and rates in place of the TPU's.  The
bench runs on the CPU (``--device cpu --smoke``) in a subprocess, passes its
identity gates, and emits the reference's row names in the reference's
order, with ``_plain`` for ``_interpret`` and ``_cuda`` for ``_compiled``;
without ``--device`` and with no GPU it raises."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.core.esam import cost_model as jcm
from repro_torch.core import h100, packing
from repro_torch.core.esam import cost_model as cm
from repro_torch.launch import bench_kernels

ROOT = Path(__file__).resolve().parents[1]
REF_BENCH = ROOT / "benchmarks" / "bench_kernels.py"
COUNTS = ("datapath", "macs", "compute_ops", "spike_bytes", "weight_bytes",
          "hbm_bytes", "intensity_ops_per_byte")


@pytest.mark.parametrize("datapath", cm.MAC_DATAPATHS)
@pytest.mark.parametrize("B,K,N", [(1024, 768, 768), (256, 768, 256),
                                   (7, 100, 10), (1, 33, 130)])
def test_mac_datapath_counts_match_reference(datapath, B, K, N):
    got = cm.mac_datapath_stats(B, K, N, datapath)
    want = jcm.mac_datapath_stats(B, K, N, datapath)
    assert {k: got[k] for k in COUNTS} == {k: want[k] for k in COUNTS}
    unit = {"dense_mxu": "tensor_core", "packed_mxu": "tensor_core+unpack",
            "popcount_vpu": "popc"}[datapath]
    assert got["unit"] == unit
    rate = h100.popc_ops_per_s() if unit == "popc" else h100.INT8_OPS_PER_S
    t_c, t_h = got["unit_ops"] / rate, got["hbm_bytes"] / h100.HBM_BYTES_PER_S
    assert got["t_roofline_us"] == pytest.approx(max(t_c, t_h) * 1e6)
    assert got["bound"] == ("compute" if t_c >= t_h else "hbm")


def test_card_rates_and_no_tpu_anchors():
    assert h100.popc_ops_per_s() == pytest.approx(4.18176e12)
    assert (h100.HBM_BYTES_PER_S, h100.INT8_OPS_PER_S) == (3.35e12, 1979e12)
    for name in ("TPU_PEAK_FLOPS", "TPU_HBM_BW", "TPU_PEAK_VPU_OPS"):
        assert not hasattr(cm, name)
    with pytest.raises(ValueError):
        cm.mac_datapath_stats(1, 32, 32, "mxu")
    # the bench's popcount row at 1024 x 768 -> 768: 18.9 M popcounts
    r = cm.mac_datapath_stats(1024, 768, 768, "popcount_vpu")
    assert r["unit_ops"] == 1024 * 768 * 24 + 1024 * 24
    assert packing.packed_nbytes(768) == 96 and packing.packed_nbytes(33) == 8


def _reference_row_names(B: int) -> list[str]:
    """Row names of the reference's bench, read from its source: the names
    it hands ``_lanes`` (one row per lane) and ``rec.emit``, in the order
    ``run()`` and then ``_popcount_comparison`` record them."""
    tree = ast.parse(REF_BENCH.read_text())
    funcs = {f.name: f for f in tree.body if isinstance(f, ast.FunctionDef)}
    env = {"B": B, "K": 768, "N": 768, "topo": (768, 768, 768, 10)}
    names = []
    for fname in ("run", "_popcount_comparison"):
        calls = sorted((n for n in ast.walk(funcs[fname])
                        if isinstance(n, ast.Call)),
                       key=lambda n: (n.lineno, n.col_offset))
        for call in calls:
            fn = call.func
            if isinstance(fn, ast.Name) and fn.id == "_lanes":
                name = eval(compile(ast.Expression(call.args[1]), "<ref>",
                                    "eval"), {}, env)
                names += [f"{name}_plain", f"{name}_cuda"]
            elif (isinstance(fn, ast.Attribute) and fn.attr == "emit"
                  and isinstance(fn.value, ast.Name)
                  and fn.value.id == "rec"):
                names.append(eval(compile(ast.Expression(call.args[0]),
                                          "<ref>", "eval"), {}, env))
    return names


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["CUDA_VISIBLE_DEVICES"] = ""
    # one CPU thread: beside a parallel test run, torch's default of one
    # thread per core oversubscribes the host and the small plain ops crawl
    # (on an 8-core host six such runs at once took over 300 s at the
    # default, 4 s at one thread each)
    env["OMP_NUM_THREADS"] = "1"
    return env


def test_cpu_smoke_run_matches_reference_rows(tmp_path):
    out = tmp_path / "bench.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.bench_kernels",
         "--device", "cpu", "--smoke", "--out", str(out)],
        capture_output=True, text=True, env=_env(), cwd=tmp_path, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rows = json.loads(out.read_text())["results"]
    names = [r["name"] for r in rows]
    want = _reference_row_names(bench_kernels.SMOKE_B)
    assert len(want) == 25 and names == want
    printed = [line.split(",", 1)[0] for line in proc.stdout.splitlines()
               if "," in line]
    assert printed == names
    for r in rows:
        if r["name"].endswith("_cuda"):
            assert "lane=cuda_skipped" in r["derived"] and r["us_per_call"] == 0
        elif r["name"].endswith("_plain"):
            assert "lane=plain;device=cpu" in r["derived"]
            assert r["us_per_call"] > 0
    floor = next(r for r in rows
                 if r["name"] == "kernel_popcount_speedup_vs_packed")
    assert "bit_identity=checked" in floor["derived"]
    assert "floor=1.0x" in floor["derived"]


def test_default_device_raises_without_a_gpu(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.bench_kernels", "--smoke"],
        capture_output=True, text=True, env=_env(), cwd=tmp_path, timeout=300)
    assert proc.returncode != 0
    assert "no CUDA device is available" in proc.stderr
    assert not list(tmp_path.iterdir())      # no --out: nothing written
