#!/usr/bin/env python3
"""Where the IF neuron kernel's (B11) time goes on one NVIDIA GPU.

    python3 probes/if_neuron_probe.py

No part of the port.  At the kernel bench's 8 x 32 x 256 (and at 4096 x 32
x 256, where the kernel streams) it times, each in a CUDA graph
(``obs.profile.graph_ms``, microseconds):

* ``empty`` and ``one_load``: ``probes/launch_floor.cu``, one block;
* ``spread``: ``probes/read_floor.cu``'s kernel of 64 blocks of 64
  threads, each loading one word and storing it (the floor of a launch
  spread as B11's is);
* ``read``: the same geometry loading B11's bytes (4 int4 a thread, 262 KB
  at 8 x 32 x 256) and storing one word a thread;
* ``kernel``: ``if_neuron`` as it is, on the route ``ops._if_route``
  picks, and on every other route of units a warp and warps a block that
  covers the rounds (each checked bit for bit against the plain version
  first);
* ``no_sum``: a copy of ``csrc/if_neuron.cu`` without the slots' shuffle
  sum (a diagnostic: its output is wrong and is not checked).

Prints the card's name and power limit, then one ``if_neuron_probe`` JSON
line a shape.
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
SOURCE = ROOT / "src/repro_torch/kernels/if_neuron/csrc/if_neuron.cu"
SHAPES = ((8, 32, 256), (4096, 32, 256))


def _nvcc(src: Path, lib: Path) -> subprocess.Popen:
    from repro_torch.kernels import _build

    return subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _wait(proc: subprocess.Popen, lib: Path) -> ctypes.CDLL:
    text, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {lib.name}:\n{text}")
    return ctypes.CDLL(str(lib))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("if_neuron_probe: no CUDA device visible", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels.common import stream_ptr
    from repro_torch.kernels.if_neuron import ops
    from repro_torch.obs.profile import graph_ms

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    out_dir = _build.build_dir() / "if_neuron_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    sum_loop = "  for (int off = uw; off < 32; off <<= 1) {"
    text = SOURCE.read_text()
    if sum_loop not in text:
        raise RuntimeError("the kernel source no longer has the probe's hook")
    (out_dir / "no_sum.cu").write_text(
        text.replace(sum_loop, "  for (int off = 32; off < 32; off <<= 1) {"))
    procs = {name: (_nvcc(src, out_dir / f"lib{name}.so"),
                    out_dir / f"lib{name}.so")
             for name, src in (("floor", ROOT / "probes/launch_floor.cu"),
                               ("read", ROOT / "probes/read_floor.cu"),
                               ("no_sum", out_dir / "no_sum.cu"))}
    kernel = _build.load_library("if_neuron", ops._declare).lib
    libs = {name: _wait(*pair) for name, pair in procs.items()}
    ops._declare(libs["no_sum"])
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    libs["floor"].launch_floor.argtypes = [i32, vp, vp, vp]
    libs["read"].read_floor.argtypes = [i32, vp, vp, i32, i32, vp]
    dev = torch.device("cuda", torch.cuda.current_device())

    def checked(fn):
        err = fn()
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    rng = np.random.default_rng(28)
    for B, T, N in SHAPES:
        upd = torch.from_numpy(
            rng.integers(-3, 4, size=(B, T, N), dtype=np.int32)).to(dev)
        vth = torch.from_numpy(
            rng.integers(-6, 7, size=(N,), dtype=np.int32)).to(dev)
        spikes = torch.empty((B, N), dtype=torch.int8, device=dev)
        vmem = torch.empty((B, N), dtype=torch.int32, device=dev)
        want = ops.if_neuron_ref(upd, vth)
        route = ops._route_for(upd, vth)
        threads = 32 * route.warps
        words = torch.zeros(route.grid * threads, dtype=torch.int32,
                            device=dev)
        row = {"shape": f"{B}x{T}x{N}",
               "route": [route.uw, route.warps, route.grid]}

        def launch(lib, uw, warps, grid):
            return lambda: checked(lambda: lib.if_neuron(
                upd.data_ptr(), vth.data_ptr(), spikes.data_ptr(),
                vmem.data_ptr(), B, T, N, uw, warps, grid, int(route.vec),
                stream_ptr(dev)))

        fl, rd = libs["floor"], libs["read"]
        x, y = words[:1], words[1:2]
        row["empty_us"] = 1e3 * graph_ms(lambda: checked(
            lambda: fl.launch_floor(0, x.data_ptr(), y.data_ptr(),
                                    stream_ptr(dev))))
        row["one_load_us"] = 1e3 * graph_ms(lambda: checked(
            lambda: fl.launch_floor(1, x.data_ptr(), y.data_ptr(),
                                    stream_ptr(dev))))
        row["spread_us"] = 1e3 * graph_ms(lambda: checked(
            lambda: rd.read_floor(0, upd.data_ptr(), words.data_ptr(),
                                  route.grid, threads, stream_ptr(dev))))
        if upd.numel() >= 16 * route.grid * threads:
            row["read_us"] = 1e3 * graph_ms(lambda: checked(
                lambda: rd.read_floor(1, upd.data_ptr(), words.data_ptr(),
                                      route.grid, threads, stream_ptr(dev))))
        units = B * (N // 4 if route.vec else N)
        scan = {}
        slots = route.slots
        for uw in {32 // slots, max(1, 16 // slots), min(32, 64 // slots)}:
            for warps in (1, 2, 4, 8):
                grid = -(-units // (uw * warps))
                run = launch(kernel, uw, warps, grid)
                run()
                torch.cuda.synchronize()
                if not (torch.equal(spikes, want[0])
                        and torch.equal(vmem, want[1])):
                    raise AssertionError(
                        f"if_neuron != plain at {row['shape']} on "
                        f"{(uw, warps)}")
                scan[f"{uw}/{warps}"] = 1e3 * graph_ms(run)
        row["kernel_us"] = 1e3 * graph_ms(launch(
            kernel, route.uw, route.warps, route.grid))
        row["no_sum_us"] = 1e3 * graph_ms(launch(
            libs["no_sum"], route.uw, route.warps, route.grid))
        row["routes_us"] = dict(sorted(scan.items(), key=lambda kv: kv[1]))
        print("if_neuron_probe " + json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
