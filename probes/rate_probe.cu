// Issue-rate probe of the three exact datapaths for the popcount MAC on
// Hopper: the b1 tensor-core product (mma m16n8k256 .and.popc), the int8
// one (mma m16n8k32 .s8, for bits unpacked to bytes) and the 32-bit popc
// of the CUDA cores.  It is no part of the port: it replaces no TPU kernel
// and no path runs it.  chip_smoke.py builds it on its own (nvcc, beside
// the kernel libraries, with -I src/repro_torch/kernels/csrc for
// mma.cuh), launches it once on one SM and once on all of them, and
// prints each datapath's instructions and AND+popc products per clock per
// SM with the SM clock, because NVIDIA publishes no b1 rate for the H100.
// The b1 reading is the rate B2's and B3's bound is computed from.
//
// Every thread keeps kChains independent accumulators so that the unit, not
// an instruction's latency, sets the rate; thread 0 of each block records
// the block's clock64 cycles across the loop.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

// d += A B over one 16 x 8 x 32 int8 tile (the exact alternative for
// {0,1} operands unpacked to bytes), the fragment roles of mma_and_popc
// with 4 bytes a word.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

constexpr int kChains = 8;
constexpr int kProbeThreads = 1024;

enum Probe : int { kProbeAndPopc = 0, kProbeS8 = 1, kProbePopc = 2 };

template <int kWhich>
__global__ void __launch_bounds__(kProbeThreads)
rate_probe_kernel(int iters, int* __restrict__ sink,
                  long long* __restrict__ cycles) {
  const uint32_t seed = 0x9e3779b9u * (threadIdx.x + 1) ^ blockIdx.x;
  const uint32_t a[4] = {seed, seed * 3u, seed * 5u, seed * 7u};
  const uint32_t b[2] = {seed ^ 0x5555u, seed ^ 0xaaaau};
  int acc[kChains][4] = {};
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      if (kWhich == kProbeAndPopc)
        mma_and_popc(acc[c], a, b);
      else if (kWhich == kProbeS8)
        mma_s8(acc[c], a, b);
      else
        acc[c][0] += __popc(a[c & 3] ^ (uint32_t)(it + c));
    }
  }
  __syncthreads();
  const long long t1 = clock64();
  int s = 0;
#pragma unroll
  for (int c = 0; c < kChains; ++c)
    s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  sink[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
}

}  // namespace

extern "C" {

// Instructions each thread issues per iteration of the probe's loop (a
// warp's for the two mma, a thread's own for popc).
int cim_popcount_probe_chains() { return kChains; }

int cim_popcount_probe_threads() { return kProbeThreads; }

// One launch of probe `which` (0 b1 mma, 1 int8 mma, 2 popc): `blocks`
// blocks of cim_popcount_probe_threads() threads, `iters` iterations each;
// sink int32[blocks * threads], cycles int64[blocks].  Returns
// cudaGetLastError().
int cim_popcount_rate_probe(int which, int blocks, int iters, void* sink,
                            void* cycles, void* stream) {
  if (blocks < 1 || iters < 1) return (int)cudaErrorInvalidValue;
  auto* s = static_cast<int*>(sink);
  auto* c = static_cast<long long*>(cycles);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (which) {
    case kProbeAndPopc:
      rate_probe_kernel<kProbeAndPopc><<<blocks, kProbeThreads, 0, st>>>(
          iters, s, c);
      break;
    case kProbeS8:
      rate_probe_kernel<kProbeS8><<<blocks, kProbeThreads, 0, st>>>(iters, s,
                                                                    c);
      break;
    case kProbePopc:
      rate_probe_kernel<kProbePopc><<<blocks, kProbeThreads, 0, st>>>(
          iters, s, c);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
