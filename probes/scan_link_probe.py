#!/usr/bin/env python3
"""Where B4 ``temporal_scan``'s time goes: clock stamps at every link of
both of its kernels, and the register route timed against the designs it
was chosen over, on one NVIDIA GPU.

    python3 probes/scan_link_probe.py

No part of the port.  At the paper topology's hidden tiles (256:256:256
-> 10) and B 64 it builds four copies of
``src/repro_torch/kernels/lif_step/csrc/lif_step.cu`` beside the port's
library: one in which one thread writes ``clock64`` stamps; one with more
instantiations of the register kernel (4 compute warps a CTA or 16
streams a cluster) and the single-CTA design (``probes/scan_cta_kernel.cuh``:
one block of 16 or 8 streams and 8 or 16 warps runs every tile as a
wavefront, one block barrier an iteration), picked by
``scan_probe_variant``; and two with another slot hand-off (``HANDOFFS``):
the relaxed arrive and wait without the ``__syncwarp`` that the port had
before it ordered a slot's reads before its refill, and the arrive with
release semantics at cluster scope instead of CTA scope.  Every kernel is
checked against the plain version, bit for bit, before it is timed.  It
prints the card's name and power limit, then:

* one ``scan_link_probe`` JSON line for the shared-memory kernel (route
  ``smem``, the parent's kernel: one block a stream, one link a tile and
  step; thread 0 of block 0): the median over links of the clocks of
  ``mac`` (link start to the thread's MAC result), ``lif`` (to its fire
  flag), ``handoff`` (the ballot and the word's store) and ``barrier``
  (the block barrier), and ``readout``, the readout and telemetry between
  a step's last hidden link and the next step's first;
* one line for each CTA (``tile``; the last is the readout's) of the
  register kernel, at T 16, stamped by thread 0 of that CTA in every
  cluster, the median over the steps in which every tile runs of
  ``wait_in`` (the wait for its input: c_in or the last tile's words),
  ``mac`` (the A fragments' load, the slot's release, the products and
  the conversions), ``lif`` (the LIF step and the quad ORs), ``send_rest``
  (the back-pressure wait, the words' send and the step's end),
  ``period_alone`` (one stamp a step, the step's period) and ``sm_mhz``
  (the SM clock over the launch, from ``%globaltimer``);
* one ``scan_geometry`` line a T (4, 8, 16) and kernel: the device time in
  a CUDA graph of the shared-memory kernel (``smem``), the register kernel
  as the port builds it (``regs``), with each other hand-off
  (``regs_relaxed``, ``regs_release_cluster``), at the other geometries
  (``cluster_w{warps}_r{streams}``) and the single-CTA design
  (``cta_w{warps}_r{streams}``), and clocks a chain link (time x the card's
  maximum SM clock / (T x (hidden tiles + 1))).

A stamp costs ~50 clocks and orders the memory accesses around it, so the
parts add up to a little more than ``period_alone``.
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
SOURCE = ROOT / "src/repro_torch/kernels/lif_step/csrc/lif_step.cu"
CTA_SOURCE = ROOT / "probes/scan_cta_kernel.cuh"
HIDDEN, N_CLS, BATCH, LEAK = (256, 256, 256), 10, 64, 0.125
STEPS = (4, 8, 16)
OLD_PARTS = ("mac", "lif", "handoff", "barrier")
NEW_PARTS = ("wait_in", "mac", "lif", "send_rest")
MAX_LINKS = 64
MAX_BLOCKS = 64

#: (text in the kernel, text put before (-1) or after (+1) it)
HOOKS = (
    ("      for (int base = warp * 32; base < L.n; base += tps) {\n", -1,
     "      OLD_STAMP(0, 0)\n"),
    ("                  : (kStateSmem ? cur[n] : __ldg(cg + n));\n", 1,
     "          OLD_STAMP(1, c)\n"),
    ("        const uint32_t word = __ballot_sync(0xffffffffu, fired);\n", -1,
     "        OLD_STAMP(2, fired)\n"),
    ("        if (lane == 0) wout[base >> 5] = word;\n", 1,
     "        OLD_STAMP(3, word)\n"),
    ("      __syncthreads();     // this tile's words are complete\n", 1,
     "      OLD_STAMP(4, 0)\n"),
    ("  const bool first = h == 0, ro = h == kK;   // ro: the readout's CTA\n",
     1, "  const int stamp_on = h == g_rank && threadIdx.x == 0 ? g_mask : 0;\n"
        "  if (threadIdx.x == 0 && blockIdx.x == 0) {\n"
        "    g_clock[0] = clock64();\n"
        "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g_clock[1]));\n"
        "  }\n"),
    ("  // no CTA leaves while another may still write its shared memory\n",
     -1, "  if (threadIdx.x == 0 && blockIdx.x == 0) {\n"
         "    g_clock[2] = clock64();\n"
         "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g_clock[3]));\n"
         "  }\n"),
    ("      float in[kCT][kH][2];\n", 1, "      NEW_STAMP(0, 0)\n"),
    ("        mbar_wait<false>(&cfull[cs], (i / kRing) & 1);\n", 1,
     "        NEW_STAMP(1, 0)\n"),
    ("        mbar_wait<false>(&full[slot], (i / kLink) & 1);\n"
     "        const uint32_t* src = inbuf[slot] + g * kRow + 4 * t;\n"
     "        uint32_t af[kS][4];\n", -1, "        NEW_STAMP(1, 0)\n"),
    ("      // the LIF step, the fired bits of each group at 8 q + e (shifted "
     "to\n", -1, "      NEW_STAMP(2, in[kCT - 1][0][0])\n"),
    ("      // steps i .. i + 3 refill the slots of steps i - kLink .. + 3: one\n",
     -1, "      NEW_STAMP(3, mine[0])\n"),
    ("      // off the chain: this step's c_in slot is free (every lane has read\n",
     -1,
     "      NEW_STAMP(4, 0)\n"),
)
MACROS = """
__device__ long long g_stamps[%(b)d][%(n)d][7];
__device__ int g_rank, g_mask;
__device__ long long g_clock[4];   // clock64, globaltimer at entry, exit
#define STAMP_AT(cond, blk, link, idx, v)                          \\
  if ((cond) && (blk) < %(b)d && (link) < %(n)d) {                 \\
    asm volatile("" ::"r"((int)(v)) : "memory");                  \\
    g_stamps[blk][link][idx] = clock64();                         \\
  }
#define OLD_STAMP(idx, v) \\
  STAMP_AT(threadIdx.x == 0, blockIdx.x, t * (k + 1) + h, idx, v)
#define NEW_STAMP(idx, v) \\
  STAMP_AT(stamp_on >> (idx) & 1, blockIdx.x / (kK + 1), i, idx, v)
""" % {"n": MAX_LINKS, "b": MAX_BLOCKS}


def stamped(source: str) -> str:
    """The kernel file with thread 0's stamps in both scan kernels."""
    for text, where, hook in HOOKS:
        if source.count(text) != 1:
            raise RuntimeError("the kernel source no longer has the probe's "
                               f"hook {text.strip()!r}")
        source = source.replace(
            text, hook + text if where < 0 else text + hook, 1)
    source = source.replace("namespace {\n", MACROS + "namespace {\n", 1)
    return source + (
        '\nextern "C" int scan_link_stamps(void* dst, int reset) {\n'
        '  static long long zero[%d][%d][7] = {};\n'
        '  if (reset) {\n'
        '    const int rank = (reset - 1) & 255, mask = reset >> 8;\n'
        '    cudaMemcpyToSymbol(g_rank, &rank, sizeof(rank));\n'
        '    cudaMemcpyToSymbol(g_mask, &mask, sizeof(mask));\n'
        '    return (int)cudaMemcpyToSymbol(g_stamps, zero, sizeof(zero));\n'
        '  }\n'
        '  return (int)cudaMemcpyFromSymbol(dst, g_stamps, sizeof(zero));\n'
        '}\n'
        'extern "C" int scan_link_clock(void* dst) {\n'
        '  return (int)cudaMemcpyFromSymbol(dst, g_clock, sizeof(g_clock));\n'
        '}\n' % (MAX_BLOCKS, MAX_LINKS))


#: (name, variant) of the variants copy: the register kernel at other
#: (warps a CTA, streams a cluster), and the single-CTA design at (warps,
#: streams a block); all at 3 hidden tiles of one K step
VARIANTS = (("cluster_w8_r16", "launch_regs<3, 1, 8, 16>"),
            ("cluster_w4_r8", "launch_regs<3, 1, 4, 8>"),
            ("cluster_w4_r16", "launch_regs<3, 1, 4, 16>"),
            ("cta_w8_r16", "launch_cta<3, 8, 16>"),
            ("cta_w16_r16", "launch_cta<3, 16, 16>"),
            ("cta_w8_r8", "launch_cta<3, 8, 8>"),
            ("cta_w16_r8", "launch_cta<3, 16, 8>"))
DISPATCH = ("int dispatch_regs(const RegArgs& a, int k, int steps, bool refrac,\n"
            "                  bool subtract, cudaStream_t s) {\n")
GEOMETRY = "// The register route's geometry (ops.SCAN_WARPS, ops.SCAN_ROWS)"
#: the other slot hand-offs: (the port's text, the copy's) pairs
HANDOFFS = {
    "regs_relaxed": (
        ("    const int slot = i % kLink;\n    __syncwarp();\n",
         "    const int slot = i % kLink;\n"),
        ("mbarrier.arrive.shared::cluster.b64",
         "mbarrier.arrive.relaxed.cluster.shared::cluster.b64"),
        ("mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64",
         "mbarrier.try_wait.parity.relaxed.cluster.shared::cta.b64")),
    "regs_release_cluster": (
        ("mbarrier.arrive.shared::cluster.b64",
         "mbarrier.arrive.release.cluster.shared::cluster.b64"),),
}


def _replace(source: str, text: str, new: str) -> str:
    if source.count(text) != 1:
        raise RuntimeError(f"the kernel source no longer has {text!r}")
    return source.replace(text, new, 1)


def variants(source: str) -> str:
    """The kernel file with the single-CTA design and the register kernel's
    other geometries, launched in place of the port's at 3 tiles of one K
    step while ``scan_probe_variant`` is set (1-based, ``VARIANTS``)."""
    source = _replace(source, GEOMETRY,
                      CTA_SOURCE.read_text() + "\n" + GEOMETRY)
    cases = "".join(f"    case {i}: return {call}(a, refrac, subtract, s);\n"
                    for i, (_, call) in enumerate(VARIANTS, 1))
    source = _replace(source, DISPATCH, DISPATCH + (
        "  if (k == 3 && steps == 1) switch (g_probe_variant) {\n"
        + cases + "    default: break;\n  }\n"))
    source = source.replace("namespace {\n",
                            "namespace {\nint g_probe_variant = 0;\n", 1)
    return source + ('\nextern "C" void scan_probe_variant(int v) '
                     '{ g_probe_variant = v; }\n')


def handoff(source: str, name: str) -> str:
    """The kernel file with the slot hand-off ``HANDOFFS[name]``."""
    for text, new in HANDOFFS[name]:
        source = _replace(source, text, new)
    return source


def split(stamps: np.ndarray, rows, parts, readout=()) -> dict:
    """Median clocks of each part over block 0's stamped links ``rows``
    (a stamp not taken on this CTA's path counts as the one before it),
    the median gap over the (from, to) link pairs of ``readout``, and each
    block's clocks from its first stamp to its last."""
    s = stamps[0].astype(np.float64)[:, :len(parts) + 1]
    for i in range(1, s.shape[1]):
        s[:, i] = np.where(s[:, i] > 0, s[:, i], s[:, i - 1])
    diffs = np.diff(s[list(rows)], axis=1)
    out = {p: float(np.median(diffs[:, i])) for i, p in enumerate(parts)}
    out["link"] = float(np.median(diffs.sum(axis=1)))
    if readout:
        out["readout"] = float(np.median([s[b, 0] - s[a, -1]
                                          for a, b in readout]))
    spans = []
    for blk in stamps.astype(np.float64):
        used = blk[blk[:, 0] > 0]
        if len(used):
            spans.append(float(used[:, :len(parts) + 1].max()
                               - used[0, 0]))
    out["total_blocks"] = {"min": min(spans), "median": float(
        np.median(spans)), "max": max(spans), "blocks": len(spans)}
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("scan_link_probe: no CUDA device visible", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels.lif_step import ops
    from repro_torch.obs.profile import graph_ms

    smi = ["nvidia-smi", "--format=csv,noheader"]
    print(subprocess.run(smi[:1] + ["--query-gpu=name,power.limit"] + smi[1:],
                         capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    max_mhz = float(subprocess.run(
        smi[:1] + ["--query-gpu=clocks.max.sm", "--format=csv,noheader,"
                   "nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    out_dir = _build.build_dir() / "scan_link_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = SOURCE.read_text()
    # the three copies and the port's library, built side by side
    builds = {}
    for name, text in (("stamped", stamped(source)),
                       ("variants", variants(source)),
                       *((h, handoff(source, h)) for h in HANDOFFS)):
        src, lib_path = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
        src.write_text(text)
        builds[name] = (lib_path, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS,
             f"-I{_build.SHARED_INCLUDE}", "-o", str(lib_path), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    _build.build_all(("lif_step",))
    libs = {}
    for name, (lib_path, built) in builds.items():
        text, _ = built.communicate()
        if built.returncode:
            raise RuntimeError(f"nvcc failed on the {name} copy:\n{text}")
        lib = ctypes.CDLL(str(lib_path))
        ops._declare(lib)
        libs[name] = _build.KernelLibrary("lif_step", lib, lib_path, "")
    lib = libs["stamped"].lib
    lib.scan_link_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.scan_link_clock.argtypes = [ctypes.c_void_p]
    libs["variants"].lib.scan_probe_variant.argtypes = [ctypes.c_int]
    probe_kl = libs["stamped"]

    rng = np.random.default_rng(29)
    dev = torch.device("cuda", torch.cuda.current_device())

    def operands(n_steps):
        c_in = rng.integers(-40, 41, size=(n_steps, BATCH, HIDDEN[0]),
                            dtype=np.int32)
        widths = list(HIDDEN) + [N_CLS]
        planes = [rng.integers(-2**31, 2**31, size=(widths[i + 1], n // 32),
                               dtype=np.int64).astype(np.int32)
                  for i, n in enumerate(HIDDEN)]
        vth = [rng.integers(-8, 9, size=(n,)).astype(np.int32)
               for n in HIDDEN]
        return (torch.from_numpy(c_in).to(dev),
                tuple(torch.from_numpy(w).to(dev) for w in planes),
                tuple(torch.from_numpy(th).to(dev) for th in vth))

    kw = dict(leak=LEAK, reset="zero", refractory=0, collect=True,
              telemetry=True)
    smem = ops.ScanRoute("smem", 1, 1)
    regs_route = ops._regs_route(HIDDEN, N_CLS)
    k = len(HIDDEN)

    # the stamps, at T 16
    args = operands(STEPS[-1])
    want = ops.temporal_scan_ref(*args, **kw)
    real_library = ops._library
    ops._library = lambda: probe_kl
    try:
        T = STEPS[-1]
        old_rows = [t * (k + 1) + h for t in range(T) for h in range(k)]
        old_readout = [(t * (k + 1) + k - 1, (t + 1) * (k + 1))
                       for t in range(T - 1)]
        # the smem kernel stamps its block 0; the register kernel one CTA
        # (a tile) of each cluster, each rank in turn
        stamped_routes = [("smem", smem, old_rows, old_readout, 0)] + [
            ("regs", regs_route, range(k, T), (), rank)
            for rank in range(k + 1)]
        for name, route, rows, readout, rank in stamped_routes:
            lib.scan_link_stamps(None, rank + 1 + (0x7f << 8))
            got = ops._scan_launch(*args, dev=dev, route=route, **kw)
            torch.cuda.synchronize()
            if not (torch.equal(got[0], want[0]) and all(
                    torch.equal(g, w) for g, w in zip(got[1] + got[2],
                                                      want[1] + want[2]))):
                raise AssertionError(f"stamped {name} kernel != plain")
            stamps = np.zeros((MAX_BLOCKS, MAX_LINKS, 7), np.int64)
            lib.scan_link_stamps(stamps.ctypes.data, 0)
            regs = route.name == "regs"
            row = {"kernel": name, "T": T, "batch": BATCH,
                   **({"tile": rank} if regs else {}),
                   "links_stamped": len(rows),
                   **split(stamps, rows, NEW_PARTS if regs else OLD_PARTS,
                           readout)}
            if regs:   # the period alone: one stamp a step
                lib.scan_link_stamps(None, rank + 1 + (1 << 8))
                ops._scan_launch(*args, dev=dev, route=route, **kw)
                torch.cuda.synchronize()
                lib.scan_link_stamps(stamps.ctypes.data, 0)
                s0 = stamps[0, list(rows), 0].astype(np.float64)
                row["period_alone"] = float(np.median(np.diff(s0)))
                clk = np.zeros(4, np.int64)
                lib.scan_link_clock(clk.ctypes.data)
                row["sm_mhz"] = float((clk[2] - clk[0]) * 1e3
                                      / max(clk[3] - clk[1], 1))
            print("scan_link_probe " + json.dumps(row), flush=True)
    finally:
        ops._library = real_library

    # the kernels, timed: the port's library, then the copies
    kernels = [("smem", None, smem, 0), ("regs", None, regs_route, 0)] + [
        (h, libs[h], regs_route, 0) for h in HANDOFFS] + [
        (name, libs["variants"], regs_route, i)
        for i, (name, _) in enumerate(VARIANTS, 1)]
    for n_steps in STEPS:
        args = operands(n_steps)
        want = ops.temporal_scan_ref(*args, **kw)
        for name, kl, route, variant in kernels:
            libs["variants"].lib.scan_probe_variant(variant)
            ops._library = (lambda kl=kl: kl) if kl else real_library
            try:
                def run(route=route):
                    return ops._scan_launch(*args, dev=dev, route=route,
                                            **kw)

                got = run()
                torch.cuda.synchronize()
                if not (torch.equal(got[0], want[0]) and all(
                        torch.equal(g, w) for g, w in zip(
                            got[1] + got[2], want[1] + want[2]))):
                    raise AssertionError(f"{name} != plain at T {n_steps}")
                ms = graph_ms(run)
            finally:
                ops._library = real_library
                libs["variants"].lib.scan_probe_variant(0)
            row = {"route": name, "T": n_steps, "batch": BATCH,
                   "us": 1e3 * ms, "clocks_per_link":
                   ms * 1e-3 * max_mhz * 1e6 / (n_steps * (k + 1))}
            print("scan_geometry " + json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
