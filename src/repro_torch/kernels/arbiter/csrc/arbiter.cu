// Multiport spike arbiter for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of the JAX reference
//   port_schedule <- src/repro/kernels/arbiter/kernel.py:51
//                    _port_schedule_kernel
//   arbiter       <- src/repro/kernels/arbiter/kernel.py:33 _arbiter_kernel
// The paper's p-port arbiter (Sec 3.3, Fig 4) is p cascaded fixed-priority
// encoders over one 128-row group.  Its function is rank selection: a
// request of in-group rank r (the requests at lanes <= it, minus one) is
// granted by port r in the first cycle, and over the whole drain at cycle
// r / p.  The reference computes the rank as a blocked prefix sum (32-wide
// base encoders plus a higher-level tree, the paper's critical-path fix);
// here a 32-wide base encoder is one __ballot_sync and a masked __popc, and
// the tree is a running sum of the sub-blocks' popcounts.
//
//   port_schedule: cycle_of[g, w] = rank / p for a request, else ceil(W/p);
//                  counts[g, c]   = clamp(pop - c p, 0, p), c < ceil(W/p).
//   arbiter:       grants[g, k, w] = req & (rank == k), k < p;
//                  remaining[g, w] = req & (rank >= p); valid[g, k] = pop > k.
//
// What bounds it on an H100: bytes.  A row group is W request bytes in and
// 4 W bytes of cycle_of out (plus 4 ceil(W/p) of counts) for about W/32
// ballots and popcounts; at the sweep's first tile (24,576 groups of 128)
// that is ~16-19 MB, ~5-6 us at 3.35 TB/s.
//
// Design: one warp owns one row group, a block holds kWarps groups; lane l
// reads requests l, 32 + l, 64 + l, ... (32 consecutive bytes a warp) and
// writes its cycle_of words coalesced; any W that is a multiple of 32 and
// any p >= 1 run.  Left for later: 16-byte request loads, wider stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// Bits of the lanes at or below this one.
__device__ __forceinline__ unsigned lanemask_le(int lane) {
  return 0xffffffffu >> (31 - lane);
}

__global__ void __launch_bounds__(kThreads)
port_schedule_kernel(const uint8_t* __restrict__ req,
                     int32_t* __restrict__ cycle_of,
                     int32_t* __restrict__ counts, int N, int W, int ports,
                     int n_cycles) {
  const int lane = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (g >= N) return;  // the whole warp leaves together
  const uint8_t* r = req + g * W;
  int32_t* out = cycle_of + g * W;
  const unsigned le = lanemask_le(lane);
  int base = 0;  // requests in the earlier sub-blocks
  for (int j = 0; j < W; j += 32) {
    const bool on = __ldg(r + j + lane) != 0;
    const unsigned mask = __ballot_sync(0xffffffffu, on);
    const int rank = base + __popc(mask & le) - 1;
    out[j + lane] = on ? rank / ports : n_cycles;
    base += __popc(mask);
  }
  int32_t* cnt = counts + g * n_cycles;
  for (int c = lane; c < n_cycles; c += 32) {
    const long long left = (long long)base - (long long)c * ports;
    cnt[c] = left <= 0 ? 0 : (left >= ports ? ports : (int)left);
  }
}

__global__ void __launch_bounds__(kThreads)
arbiter_kernel(const uint8_t* __restrict__ req, int8_t* __restrict__ grants,
               int8_t* __restrict__ remaining, int8_t* __restrict__ valid,
               int G, int W, int ports) {
  const int lane = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (g >= G) return;
  const uint8_t* r = req + g * W;
  int8_t* gr = grants + g * ports * (long long)W;
  int8_t* rem = remaining + g * W;
  const unsigned le = lanemask_le(lane);
  int base = 0;
  for (int j = 0; j < W; j += 32) {
    const bool on = __ldg(r + j + lane) != 0;
    const unsigned mask = __ballot_sync(0xffffffffu, on);
    const int rank = base + __popc(mask & le) - 1;
    for (int k = 0; k < ports; ++k)
      gr[(long long)k * W + j + lane] = (on && rank == k) ? 1 : 0;
    rem[j + lane] = (on && rank >= ports) ? 1 : 0;
    base += __popc(mask);
  }
  for (int k = lane; k < ports; k += 32)
    valid[g * ports + k] = base > k ? 1 : 0;
}

int blocks_for(int groups) { return (groups + kWarps - 1) / kWarps; }

}  // namespace

extern "C" {

// Drain schedule of N row groups of W lanes (W % 32 == 0) under p ports:
// cycle_of int32[N, W] and counts int32[N, ceil(W/p)] from {0, nonzero}
// request bytes [N, W] (contiguous).  Returns cudaGetLastError().
int arbiter_port_schedule(const void* req, void* cycle_of, void* counts,
                          int N, int W, int ports, void* stream) {
  if (N < 1 || W < 32 || W % 32 || ports < 1)
    return (int)cudaErrorInvalidValue;
  const int n_cycles = (W - 1) / ports + 1;
  port_schedule_kernel<<<blocks_for(N), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)req, (int32_t*)cycle_of, (int32_t*)counts, N, W, ports,
      n_cycles);
  return (int)cudaGetLastError();
}

// One arbiter cycle of G row groups: grants int8[G, p, W], remaining
// int8[G, W] and valid int8[G, p] from request bytes [G, W] (contiguous).
// Returns cudaGetLastError().
int arbiter_grants(const void* req, void* grants, void* remaining,
                   void* valid, int G, int W, int ports, void* stream) {
  if (G < 1 || W < 32 || W % 32 || ports < 1)
    return (int)cudaErrorInvalidValue;
  arbiter_kernel<<<blocks_for(G), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)req, (int8_t*)grants, (int8_t*)remaining,
      (int8_t*)valid, G, W, ports);
  return (int)cudaGetLastError();
}

const char* arbiter_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
