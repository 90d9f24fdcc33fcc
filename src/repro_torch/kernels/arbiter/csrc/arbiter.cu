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
// port_schedule's design: one warp owns one row group, a block holds
// kWarps groups; lane l reads requests l, 32 + l, 64 + l, ... (32
// consecutive bytes a warp) and writes its cycle_of words coalesced; any W
// that is a multiple of 32 and any p >= 1 run.
//
// arbiter's design: what bounds it at the bench's 16 groups of 128 is
// latency, not bytes (0.0037 us of them): one warp a group, and the block
// as small as keeps the card busy (one warp a block for a few hundred
// groups, so 16 groups are 16 CTAs).  Lane l loads the group's request
// bytes 4l .. 4l + 3 of each 128-lane chunk as one 4-byte word, every load
// of a chunk of up to 1024 lanes issued before the first ballot.  A byte
// position's ballot over the warp and a masked popc give the requests in
// the lanes below; the ranks come from those and the lane's own bytes,
// the chunks' totals summed in registers.  Each port's grants, the
// remaining requests and the valid flags go out as 4-byte stores, a warp's
// 128 bytes of a row coalesced (valid in bytes only where its [G, p] span
// is not 4-byte aligned).

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

//: request words (4 bytes) a lane holds at once: 32 per lane at most
constexpr int kArbWords = 8;

// The request bytes of a word as 4 bits (byte k nonzero -> bit k).
__device__ __forceinline__ uint32_t byte_bits(uint32_t x) {
  const uint32_t v = __vcmpne4(x, 0u) & 0x01010101u;   // 1 in each live byte
  return (v | (v >> 7) | (v >> 14) | (v >> 21)) & 0xfu;
}

// 4 grant bytes of a word: byte k is 1 where bit k of `bits` is a request
// whose rank (rank0 + the requests in bits below k) equals `rank`.
__device__ __forceinline__ uint32_t rank_bytes(uint32_t bits, int rank0,
                                               int rank) {
  uint32_t out = 0u;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool on = (bits >> k) & 1u;
    out |= (on && rank0 == rank ? 1u : 0u) << (8 * k);
    rank0 += on;
  }
  return out;
}

// 4 remaining bytes: requests of rank >= ports.
__device__ __forceinline__ uint32_t left_bytes(uint32_t bits, int rank0,
                                               int ports) {
  uint32_t out = 0u;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool on = (bits >> k) & 1u;
    out |= (on && rank0 >= ports ? 1u : 0u) << (8 * k);
    rank0 += on;
  }
  return out;
}

// One warp a row group g; NQ words a lane a chunk (W <= 128 NQ: one chunk).
template <int NQ>
__global__ void __launch_bounds__(kThreads)
arbiter_kernel(const uint32_t* __restrict__ req, uint32_t* __restrict__ grants,
               uint32_t* __restrict__ remaining, int8_t* __restrict__ valid,
               int G, int W, int ports) {
  const int lane = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * (blockDim.x >> 5) +
                      (threadIdx.x >> 5);
  if (g >= G) return;   // the whole warp
  const int nw = W >> 2;   // request words of a group
  const uint32_t* r = req + g * nw;
  uint32_t* gr = grants + g * ports * (long long)nw;
  uint32_t* rem = remaining + g * nw;
  const unsigned lt = (1u << lane) - 1u;   // the lanes below this one
  int base = 0;   // requests in the chunks before
  for (int c0 = 0; c0 < nw; c0 += 32 * NQ) {
    uint32_t x[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int w = c0 + 32 * q + lane;
      x[q] = w < nw ? __ldg(r + w) : 0u;
    }
    uint32_t bits[NQ];
    int below[NQ], total[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      bits[q] = byte_bits(x[q]);
      below[q] = 0;
      total[q] = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const unsigned m = __ballot_sync(~0u, (bits[q] >> k) & 1u);
        below[q] += __popc(m & lt);
        total[q] += __popc(m);
      }
    }
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int w = c0 + 32 * q + lane;
      const int rank0 = base + below[q];
      base += total[q];
      if (w >= nw) continue;
      for (int k = 0; k < ports; ++k)
        gr[(long long)k * nw + w] = rank_bytes(bits[q], rank0, k);
      rem[w] = left_bytes(bits[q], rank0, ports);
    }
  }
  // valid[g, k] = pop > k: 4-byte stores over the word-aligned part of the
  // group's p bytes, single bytes at its unaligned ends
  const long long v0 = g * ports, v1 = v0 + ports;
  const long long a0 = (v0 + 3) & ~3ll, a1 = v1 & ~3ll;
  if (a0 < a1) {
    for (long long a = a0 + 4ll * lane; a < a1; a += 128) {
      uint32_t word = 0u;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        word |= (base > (int)(a + k - v0) ? 1u : 0u) << (8 * k);
      *reinterpret_cast<uint32_t*>(valid + a) = word;
    }
    if (lane < a0 - v0) valid[v0 + lane] = base > lane ? 1 : 0;
    if (lane < v1 - a1) valid[a1 + lane] = base > (int)(a1 - v0) + lane;
  } else {
    for (int k = lane; k < ports; k += 32) valid[v0 + k] = base > k ? 1 : 0;
  }
}

// Warps a block of arbiter_kernel: one while there are no more than
// 4 groups an SM, then more, up to kWarps.
int arbiter_warps(int groups) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int warps = 1;
  while (warps < kWarps && (long long)groups > 4ll * sms * warps) warps *= 2;
  return warps;
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
// int8[G, W] and valid int8[G, p] from request bytes [G, W] (contiguous;
// requests, grants and remaining 4-byte aligned).  Returns
// cudaGetLastError().
int arbiter_grants(const void* req, void* grants, void* remaining,
                   void* valid, int G, int W, int ports, void* stream) {
  if (G < 1 || W < 32 || W % 32 || ports < 1)
    return (int)cudaErrorInvalidValue;
  const int warps = arbiter_warps(G), nq = (W + 127) / 128;
  const int grid = (G + warps - 1) / warps;
  const cudaStream_t st = (cudaStream_t)stream;
  auto* r = (const uint32_t*)req;
  auto* gr = (uint32_t*)grants;
  auto* rem = (uint32_t*)remaining;
  auto* v = (int8_t*)valid;
  if (nq <= 1)
    arbiter_kernel<1><<<grid, 32 * warps, 0, st>>>(r, gr, rem, v, G, W, ports);
  else if (nq <= 2)
    arbiter_kernel<2><<<grid, 32 * warps, 0, st>>>(r, gr, rem, v, G, W, ports);
  else if (nq <= 4)
    arbiter_kernel<4><<<grid, 32 * warps, 0, st>>>(r, gr, rem, v, G, W, ports);
  else
    arbiter_kernel<kArbWords><<<grid, 32 * warps, 0, st>>>(r, gr, rem, v, G,
                                                           W, ports);
  return (int)cudaGetLastError();
}

const char* arbiter_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
