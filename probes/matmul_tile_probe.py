#!/usr/bin/env python3
"""Where B10's time goes: clock stamps of the unpacked-spike tile kernel's
phases, on one NVIDIA GPU.

    python3 probes/matmul_tile_probe.py

No part of the port: it builds a copy of
``src/repro_torch/kernels/cim_matmul/csrc/cim_matmul.cu`` with ``clock64``
stamps written by thread 0 of every CTA at the phase boundaries of the
first K phase (the bench's K = 768 is one phase), checks the copy's V
against the plain version, and prints the card's name and power limit,
then one ``matmul_tile_probe`` JSON line a shape and spike dtype: the
median over CTAs of the clocks since kernel entry at which thread 0 has

* ``issued``: issued the phase's copies (weight rows and spikes by
  cp.async) and loaded its thresholds;
* ``landed``: seen every copy of the phase land (the block barrier after
  the wait);
* ``transposed``: built the phase's planes;
* ``packed``: packed the span's spike words;
* ``end``: finished every phase's product;

and the kernel's device time in a CUDA graph (microseconds).
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
SOURCE = ROOT / "src/repro_torch/kernels/cim_matmul/csrc/cim_matmul.cu"
SHAPES = ((256, 768, 256), (4096, 768, 256))
DTYPES = ("float32", "bool")
STAMPS = ("issued", "landed", "transposed", "packed", "end")

#: (text in the kernel, stamp index written right after it)
HOOKS = (
    ("  int pc[kT][2] = {};   // popc(s) of rows g and g + 8 of each tile\n",
     0),
    ("                           // is done with planes and aw\n", 1),
    ("        transpose_word(wst[j], planes[j], warp, lane, upper);\n", 2),
    ("      if (p0 + j < steps) pack_step<kE, kT>(sst[j], aw[j], p0 + j, "
     "lane);\n", 3),
)
ENTRY = "  const long long row0 = (long long)blockIdx.x * kRows;\n"
EXIT = "  if (!has) return;\n"


def stamped(source: str) -> str:
    """The kernel with thread 0's stamps of the first phase."""
    for text in (ENTRY, EXIT) + tuple(h for h, _ in HOOKS):
        if text not in source:
            raise RuntimeError("the kernel source no longer has the probe's "
                               "hooks")
    source = source.replace(
        "namespace {\n",
        "__device__ long long g_stamps[16384][5];\n"
        "#define STAMP(i) if (threadIdx.x == 0) g_stamps[blockIdx.x * "
        "gridDim.y + blockIdx.y][i] = clock64() - t_entry;\n"
        "namespace {\n", 1)
    source = source.replace(ENTRY, ENTRY + "  const long long t_entry = "
                            "clock64();\n", 1)
    for text, i in HOOKS:
        guard = "" if i == 0 else "if (p0 == 0) "
        source = source.replace(text, text + f"    {guard}STAMP({i})\n", 1)
    source = source.replace(EXIT, "  STAMP(4)\n" + EXIT, 1)
    return source + ('\nextern "C" int matmul_tile_stamps(void* dst) {\n'
                     '  return (int)cudaMemcpyFromSymbol(dst, g_stamps, '
                     'sizeof(g_stamps));\n}\n')


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("matmul_tile_probe: no CUDA device visible", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels.cim_matmul import ops
    from repro_torch.kernels.common import stream_ptr
    from repro_torch.obs.profile import graph_ms

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    out_dir = _build.build_dir() / "matmul_tile_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib_path = out_dir / "kernel.cu", out_dir / "libprobe.so"
    src.write_text(stamped(SOURCE.read_text()))
    built = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.SHARED_INCLUDE}",
         "-o", str(lib_path), str(src)], capture_output=True, text=True)
    if built.returncode:
        raise RuntimeError(f"nvcc failed:\n{built.stdout}{built.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    ops._declare(lib)
    lib.matmul_tile_stamps.argtypes = [ctypes.c_void_p]
    rng = np.random.default_rng(26)
    for B, K, N in SHAPES:
        for dtype in DTYPES:
            s = torch.from_numpy(rng.random((B, K)) < 0.4).to(
                getattr(torch, dtype)).cuda()
            w = torch.from_numpy(
                rng.integers(0, 2, size=(K, N), dtype=np.int8)).cuda()
            out = torch.empty((B, N), dtype=torch.int32, device="cuda")
            route = ops._route_for(s, N)

            def run():
                err = lib.cim_matmul_mac(
                    s.data_ptr(), s.stride(0), s.element_size(), w.data_ptr(),
                    w.stride(0), out.data_ptr(), B, K, N, route.span_rows,
                    route.grid[0], int(route.vec), stream_ptr(s.device))
                if err:
                    raise RuntimeError(f"probe launch failed: {err}")

            run()
            torch.cuda.synchronize()
            if not torch.equal(out, ops.cim_matmul_ref(s, w)):
                raise AssertionError(f"stamped copy != plain at {B}x{K}->{N}")
            stamps = np.zeros((16384, 5), np.int64)
            lib.matmul_tile_stamps(stamps.ctypes.data)
            ctas = route.grid[0] * route.grid[1]
            med = np.median(stamps[:ctas], axis=0)
            row = {"shape": f"{B}x{K}->{N}", "dtype": dtype,
                   "route": route._asdict(), "ctas": ctas,
                   **{f"{k}_clk": float(v) for k, v in zip(STAMPS, med)},
                   "us": 1e3 * graph_ms(run)}
            print("matmul_tile_probe " + json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
