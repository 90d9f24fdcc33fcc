#!/usr/bin/env python3
"""Build and run ``probes/epoch_chain_probe.cu`` on one NVIDIA GPU.

    python3 probes/epoch_chain_probe.py

No part of the port: it times one-warp copies of the learning epoch's
chain (``stdp_column_epoch``), each a variant of one design choice, at the
paper's readout (4096 samples of 256 inputs -> 10 classes, a random
offset), in clock64 cycles a sample over the slots ``stdp_epoch_masks``
writes, and raises unless every variant's wrong count is the kernel's.
Prints the card's name and power limit, then one ``epoch_chain_probe``
JSON line a variant (twice over) and the kernel's own clocks a step.
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

#: in the order of the C function's ``which``
VARIANTS = (
    "issue_design",                     # a cp.async a sample, lane per row
    "issue_design_stamped",             # the same with phase stamps
    "tensor_fragments",                 # the b1 product, on the TMA ring
    "ring",                             # lane per row on the TMA ring
    "ring_two_lanes_a_row",
    "ring_key2",                        # the 2-op key
    "ring_key2_teacher_lane",           # the teacher's masks by its lane
    "ring_key2_late_masks",             # masks after the REDUX
    "ring_key2_late_next",              # next sample's loads after it
    "ring_key2_late_masks_branch_free",
    "ring_key2_late_masks_magic",       # int -> float by a magic add
    "kernel_chain_32",                  # chain_registers<8, 1>, 32 threads
    "kernel_chain_256",                 # the same, 256 threads
)
SAMPLES, N_IN, N_OUT = 4096, 256, 10


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("epoch_chain_probe: no CUDA device visible", file=sys.stderr)
        return 1
    from repro_torch.core import packing, prng
    from repro_torch.kernels import _build
    from repro_torch.kernels.common import stream_ptr
    from repro_torch.kernels.stdp import ops

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    lib_path = _build.build_dir() / "libepoch_chain_probe.so"
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    kernels = ROOT / "src/repro_torch/kernels"
    build = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{kernels / 'stdp/csrc'}",
         f"-I{kernels / 'csrc'}", "-o", str(lib_path),
         str(ROOT / "probes/epoch_chain_probe.cu")],
        capture_output=True, text=True)
    if build.returncode:
        raise RuntimeError(f"nvcc failed:\n{build.stdout}{build.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.epoch_chain_probe.argtypes = [i32, vp, vp, i32, i32, vp, vp, vp, vp]
    lib.epoch_chain_probe.restype = i32

    rng = np.random.default_rng(5)
    bits = torch.from_numpy(
        rng.integers(0, 2, size=(N_OUT, N_IN), dtype=np.int8)).cuda()
    pre = torch.from_numpy(rng.random((SAMPLES, N_IN)) < 0.45).cuda()
    labels = torch.from_numpy(rng.integers(0, N_OUT, size=SAMPLES)).cuda()
    off = torch.from_numpy(rng.normal(size=N_OUT).astype(np.float32)).cuda()
    slots = ops.stdp_epoch_masks(pre, labels, prng.PRNGKey(1).cuda(), N_OUT,
                                 p_pot=0.2, p_dep=0.1)
    planes = packing.pack_spikes(bits).contiguous()
    stamps = torch.zeros(4, dtype=torch.int64, device="cuda")
    want = int(ops._epoch_chain(bits.clone(), slots, off, stamps))
    dev = bits.device
    for _ in range(2):
        for which, name in enumerate(VARIANTS):
            wrong = torch.zeros((), dtype=torch.int32, device=dev)
            res = torch.zeros(6, dtype=torch.int64, device=dev)
            err = lib.epoch_chain_probe(
                which, slots.data_ptr(), planes.data_ptr(), N_OUT, SAMPLES,
                off.data_ptr(), wrong.data_ptr(), res.data_ptr(),
                stream_ptr(dev))
            torch.cuda.synchronize()
            if err:
                raise RuntimeError(f"{name}: launch error {err}")
            if int(wrong) != want:
                raise AssertionError(f"{name}: {int(wrong)} wrong, the "
                                     f"kernel {want}")
            c = res.tolist()
            row = {"variant": name, "clocks_per_sample": c[0] / SAMPLES}
            if name == "issue_design_stamped":
                row["stamps_per_sample"] = [x / SAMPLES for x in c[1:]]
            print("epoch_chain_probe " + json.dumps(row), flush=True)
    s = stamps.tolist()
    print("epoch_chain_probe " + json.dumps({
        "variant": "stdp_column_epoch", "wrong": want,
        "clocks_per_sample": (s[2] - s[1]) / SAMPLES}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
