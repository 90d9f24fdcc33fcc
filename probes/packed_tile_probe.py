#!/usr/bin/env python3
"""Time variants of the packed tile kernel (B9/B9') on one NVIDIA GPU.

    python3 probes/packed_tile_probe.py

No part of the port: it builds copies of
``src/repro_torch/kernels/cim_matmul_packed/csrc/cim_matmul_packed.cu`` and
of the plane build it includes (``src/repro_torch/kernels/csrc/planes.cuh``),
each with one design choice changed by text substitution, and times the
fire (packed words out) through the library's C interface at the learning
prefix's and the kernel bench's shapes, in a CUDA graph:

* ``kernel``: the source as it is (planes by a movemask and a shuffle
  transpose);
* ``ballot``: each plane word by one ``__ballot_sync`` a neuron;
* ``no_transpose`` and ``no_mac``: the kernel without its transposes or
  without its product (diagnostics: their outputs are wrong and are not
  checked), which splits the kernel's time into build and product.

``popcount_fire`` (B2: the same product on planes built beforehand) is
timed beside them.  Prints the card's name and power limit, then one
``packed_tile_probe`` JSON line a shape (microseconds; each checked
variant's bit identity with the plain version).
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
SOURCE = ROOT / "src/repro_torch/kernels/cim_matmul_packed/csrc/cim_matmul_packed.cu"
HEADER = ROOT / "src/repro_torch/kernels/csrc/planes.cuh"
SHAPES = ((4096, 768, 256), (4096, 256, 256), (1024, 768, 768), (1024, 768, 10))

#: one plane word a ballot a neuron (the design the shuffle transpose
#: replaced), as a drop-in transpose_word
BALLOT = '''
__device__ __forceinline__ void transpose_word(const uint8_t* stage,
                                               uint32_t* planes, int warp,
                                               int lane, bool upper) {
  const int r = 32 * warp + lane;
  uint32_t x[16];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint4 v = *reinterpret_cast<const uint4*>(stage + stage_offset(r, q));
    x[4 * q] = v.x; x[4 * q + 1] = v.y; x[4 * q + 2] = v.z; x[4 * q + 3] = v.w;
  }
  uint32_t lo = 0u, hi = 0u;
#pragma unroll
  for (int n = 0; n < 64; ++n) {
    if (n >= 32 && !upper) break;
    const uint32_t word =
        __ballot_sync(0xffffffffu, (x[n >> 2] >> (8 * (n & 3))) & 0xffu);
    if (n < 32) lo = lane == n ? word : lo;
    else hi = lane == n - 32 ? word : hi;
  }
  planes[lane * kStepWords + warp] = lo;
  planes[(lane + 32) * kStepWords + warp] = hi;
}
'''


def variants(source: str, header: str) -> dict:
    """name -> (source text, plane header text, whether its output is
    checked)."""
    call = "      transpose_word(stage, planes, warp, lane, upper);\n"
    skip = "        if (!busy[i]) continue;   // the whole warp\n"
    mark = "// Bit i of the result: byte i of y is nonzero"
    if call not in source or skip not in source or mark not in header:
        raise RuntimeError("the kernel source no longer has the probe's hooks")
    return {
        "kernel": (source, header, True),
        "ballot": (source, header[:header.index(mark)] + BALLOT, True),
        "no_transpose": (source.replace(call, ""), header, False),
        "no_mac": (source.replace(skip, "        continue;\n"), header,
                   False),
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("packed_tile_probe: no CUDA device visible", file=sys.stderr)
        return 1
    from repro_torch.core import packing
    from repro_torch.kernels import _build
    from repro_torch.kernels.cim_matmul_packed import ops
    from repro_torch.kernels.cim_popcount import ops as pop_ops
    from repro_torch.kernels.common import stream_ptr
    from repro_torch.obs.profile import graph_ms

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    out_dir = _build.build_dir() / "packed_tile_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    builds = {}
    for name, (text, header, checked) in variants(
            SOURCE.read_text(), HEADER.read_text()).items():
        # the copy's own planes.cuh, beside it, comes before the shared one
        (out_dir / name).mkdir(exist_ok=True)
        src, lib = out_dir / name / "kernel.cu", out_dir / f"lib{name}.so"
        src.write_text(text)
        (out_dir / name / HEADER.name).write_text(header)
        builds[name] = (lib, checked, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.SHARED_INCLUDE}",
             "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, checked, proc) in builds.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{text}")
        lib = ctypes.CDLL(str(path))
        ops._declare(lib)
        libs[name] = (lib, checked)
    rng = np.random.default_rng(25)
    for B, K, N in SHAPES:
        x = packing.words_from_np(packing.pack_spikes_np(
            rng.integers(0, 2, size=(B, K)))).cuda()
        w = torch.from_numpy(
            rng.integers(0, 2, size=(K, N), dtype=np.int8)).cuda()
        vth = torch.from_numpy(
            rng.integers(-8, 9, size=(N,), dtype=np.int32)).cuda()
        pack = N % 32 == 0
        out = (torch.empty((B, N // 32), dtype=torch.int32, device="cuda")
               if pack else torch.empty((B, N), dtype=torch.int8,
                                        device="cuda"))
        want = ops.esam_layer_packed_ref(x, w, vth, pack_output=pack)
        route = ops._route_for(x, N)
        planes = packing.pack_weight_planes(w)
        row = {"shape": f"{B}x{K}->{N}", "popcount_fire_us": 1e3 * graph_ms(
            lambda: pop_ops.esam_layer_popcount(x, planes, vth,
                                                pack_output=pack))}
        for name, (lib, checked) in libs.items():
            def run(lib=lib, name=name):
                err = lib.cim_matmul_packed_fire(
                    x.data_ptr(), x.stride(0), w.data_ptr(), w.stride(0),
                    vth.data_ptr(), out.data_ptr(), B, K, N, route.span_rows,
                    route.grid[0], int(route.paired), int(pack),
                    stream_ptr(x.device))
                if err:
                    raise RuntimeError(f"{name} launch failed: {err}")

            run()
            torch.cuda.synchronize()
            if checked and not torch.equal(out, want):
                raise AssertionError(f"{name} != plain at {row['shape']}")
            row[f"{name}_us"] = 1e3 * graph_ms(run)
        print("packed_tile_probe " + json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
