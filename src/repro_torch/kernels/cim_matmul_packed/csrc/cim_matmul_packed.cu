// Packed-spike CIM tile (MAC, and the MAC with fused IF fire), for NVIDIA
// Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of the JAX reference
//   fused_fire_packed  <- src/repro/kernels/cim_matmul_packed/kernel.py:66
//                         fused_fire_packed_kernel
//   cim_matmul_packed  <- src/repro/kernels/cim_matmul_packed/kernel.py:47
//                         mac_packed_kernel
// which unpack the spike words in VMEM and run the +-1 MAC on the MXU
// (bf16 x bf16 -> f32) against {0,1} int8 weights [K, N]; the first fires
// at V >= vth and re-packs the fired bits, the second stores V as int32.
// The reference's product is exact (|V| <= K < 2^24), so this kernel gives
// the same words and V from the popcount identity
//
//     V[b, n] = 2 * sum_j popc(s[b, j] & plane[n, j]) - sum_j popc(s[b, j]),
//
// where plane[n, j] bit i is w[32 j + i, n] != 0 and bits past K in the
// last spike word are masked (the reference's unpack drops them).
//
// What bounds it on an H100: the MAC term is the b1 tensor-core product
// mma.sync m16n8k256 .and.popc (BMMA in SASS), 21,744 bit pairs a clock an
// SM (probes/rate_probe.cu), so 2 B N K operations take 0.14 us at the
// learning prefix's 4096 x 768 -> 256 and the kernel is bound by its bytes
// (spike words, int8 weights, outputs).  The planes are not an operand: the
// kernel builds them from the int8 weights, and that build, not the
// product, is the work to hide.
//
// Design (one launch a tile; ops._packed_route picks the grid):
//   * a CTA owns one 64-neuron group (8 mma n-tiles) and a span of rows (a
//     multiple of 16, up to 16 x 8 warps x kMaxTilesPerWarp), the span sized
//     so that the grid fills the card about once; it builds its group's
//     planes once, so each group's weights are read once a span, not once
//     every 64 rows;
//   * the build (kernels/csrc/planes.cuh, shared with cim_matmul): the CTA
//     stages its [K, 64] int8 slab into shared memory by
//     cp.async, 256 K rows (one 256-bit K step: a word a warp) a stage, a
//     ring of two stages in flight, 16-byte chunks swizzled against bank
//     conflicts; zero-filled past K and N.  Where the weights' base or row
//     stride is not 16-byte aligned (column views; N = 10 or 77
//     contiguous) the same stage fills by predicated byte loads, a thread
//     a row (`vec`, decided per launch).  Each warp then turns its 32
//     staged rows into that step's plane words: each lane's 64 bytes into
//     64 bits (__vcmpne4, a nonzero byte is a 1), then a 32 x 32 bit
//     transpose across the warp (five __shfl_xor_sync butterflies a half),
//     which leaves neuron l's word in lane l (one __ballot_sync a neuron
//     is slower: probes/packed_tile_probe.py times both; PERF.md);
//   * the MAC, one K step at a time behind the build: each warp walks
//     16-row tiles of the span (tile i of warp w is rows 16 (w + 8 i)..), A
//     fragments straight from the spike words in device memory (as
//     popcount_fire loads them, kInFlight steps in flight from kernel
//     start), B fragments from the step's planes in shared memory (a
//     neuron's 8 words contiguous: conflict-free 8-byte loads), one
//     mma.sync a n-tile.  So the planes are never held whole: any K runs
//     in 34 KB of static shared memory, and the next stage's copy overlaps
//     this step's transpose and product;
//   * a row's spike count from the A words the quad holds and two quad
//     shuffles, once a row, after the tail bits past K are masked (in the
//     product and the count alike);
//   * the epilogue (tile_epilogue, shared with popcount_fire): kVmem int32
//     V, kFireInt8 one byte a neuron, kFirePacked each quad's bits ORed into
//     the row's 32-neuron words.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "planes.cuh"

namespace {

constexpr int kNTiles = kGroup / 8;        // mma n-tiles of a CTA
constexpr int kTileRows = 16;              // rows of a warp's tile
constexpr int kMaxTilesPerWarp = 2;        // row tiles a warp walks, at most
constexpr int kInFlight = 3;               // K steps whose loads are in flight

// One K step's A fragment (a[0] / a[2]: row g's words 2t / 2t + 1; a[1] /
// a[3]: row g + 8's), bits past K masked.
struct RowOperands {
  const uint32_t* s0;   // row g
  const uint32_t* s1;   // row g + 8
  bool real0, real1;
  int W;                // input words
  uint32_t tail;        // the real bits of word W - 1
};

template <bool kPaired>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const RowOperands& o,
                                       int j) {
  uint2 x0 = load_pair<kPaired>(o.s0, j, o.W, o.real0);
  uint2 x1 = load_pair<kPaired>(o.s1, j, o.W, o.real1);
  if (j == o.W - 1) {
    x0.x &= o.tail;
    x1.x &= o.tail;
  } else if (j + 1 == o.W - 1) {
    x0.y &= o.tail;
    x1.y &= o.tail;
  }
  a[0] = x0.x;
  a[2] = x0.y;
  a[1] = x1.x;
  a[3] = x1.y;
}

// grid (spans, ceil(N / 64)), kThreads threads: CTA (x, y) computes rows
// [x * span_rows, (x + 1) * span_rows) of neurons [64 y, 64 y + 64).
// kTiles row tiles a warp (span_rows <= 16 * kWarps * kTiles).
template <bool kPaired, int kTiles>
__global__ void __launch_bounds__(kThreads)
fused_fire_packed_kernel(const uint32_t* __restrict__ packed, long long lds,
                         const int8_t* __restrict__ w, long long ldw,
                         const int32_t* __restrict__ vth,
                         void* __restrict__ out, int B, int K, int N,
                         int span_rows, int out_mode, int vec) {
  __shared__ __align__(16) uint8_t stages[kStages][kStageBytes];
  __shared__ __align__(16) uint32_t planes[kGroup * kStepWords];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.y * kGroup;
  const int nt = min(kNTiles, (N - n0 + 7) >> 3);   // n-tiles with neurons
  const bool upper = N - n0 > 32;
  const int W = (K + 31) >> 5;
  const int steps = (W + kStepWords - 1) / kStepWords;
  const long long span0 = (long long)blockIdx.x * span_rows;

  // this warp's row tiles: tile i is rows span0 + 16 (warp + kWarps i)..
  RowOperands o[kTiles];
  bool busy[kTiles];
#pragma unroll
  for (int i = 0; i < kTiles; ++i) {
    const int tile_row = kTileRows * (warp + kWarps * i);
    const long long r0 = span0 + tile_row + g;
    busy[i] = tile_row < span_rows && span0 + tile_row < B;
    o[i].real0 = busy[i] && r0 < B;
    o[i].real1 = busy[i] && r0 + 8 < B;
    o[i].s0 = packed + r0 * lds;
    o[i].s1 = packed + (r0 + 8) * lds;
    o[i].W = W;
    o[i].tail = (K & 31) ? (1u << (K & 31)) - 1u : 0xffffffffu;
  }
  // the first steps' spike words and the stages' weights, all in flight at
  // once; then the thresholds
  uint32_t a[kTiles][kInFlight][4];
#pragma unroll
  for (int i = 0; i < kTiles; ++i)
#pragma unroll
    for (int s = 0; s < kInFlight; ++s)
      if (busy[i] && s < steps)
        load_a<kPaired>(a[i][s], o[i], s * kStepWords + 2 * t);
#pragma unroll 1
  for (int s = 0; s < kStages; ++s) {
    if (s < steps)
      stage_rows(stages[s], w, ldw, s * kStageRows, K, n0, N, vec != 0);
    cp_async_commit();
  }
  int th[kNTiles][2] = {};
  if (out_mode != kVmem) {
#pragma unroll
    for (int q = 0; q < kNTiles; ++q) {
      const int n = n0 + 8 * q + 2 * t;
      if (q < nt && n < N) th[q][0] = __ldg(vth + n);
      if (q < nt && n + 1 < N) th[q][1] = __ldg(vth + n + 1);
    }
  }
  int acc[kTiles][kNTiles][4] = {};
  int pc[kTiles][2] = {};   // popc(s) of rows g and g + 8 of each tile
  const uint32_t* b_row = planes + g * kStepWords + 2 * t;   // neuron g
  for (int base = 0; base < steps; base += kInFlight) {
#pragma unroll
    for (int s = 0; s < kInFlight; ++s) {
      const int step = base + s;
      if (step >= steps) break;
      uint8_t* stage = stages[step % kStages];
      cp_async_wait_ring();   // the step's stage has landed (these copies)
      __syncthreads();        // ... every thread's; the last step's
                              // product is done with the planes
      transpose_word(stage, planes, warp, lane, upper);
      __syncthreads();        // the step's planes are whole; the stage free
      if (step + kStages < steps)
        stage_rows(stage, w, ldw, (step + kStages) * kStageRows, K, n0, N,
                   vec != 0);
      cp_async_commit();
#pragma unroll
      for (int i = 0; i < kTiles; ++i) {
        if (!busy[i]) continue;   // the whole warp
        pc[i][0] += __popc(a[i][s][0]) + __popc(a[i][s][2]);
        pc[i][1] += __popc(a[i][s][1]) + __popc(a[i][s][3]);
#pragma unroll
        for (int q = 0; q < kNTiles; ++q) {
          if (q < nt) {
            const uint2 bv = *reinterpret_cast<const uint2*>(
                b_row + q * 8 * kStepWords);
            const uint32_t b[2] = {bv.x, bv.y};
            mma_and_popc(acc[i][q], a[i][s], b);
          }
        }
        if (step + kInFlight < steps)
          load_a<kPaired>(a[i][s], o[i],
                          (step + kInFlight) * kStepWords + 2 * t);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kTiles; ++i) {
    if (!busy[i]) continue;
    int pc0 = pc[i][0], pc1 = pc[i][1];
    pc0 += __shfl_xor_sync(0xffffffffu, pc0, 1);
    pc0 += __shfl_xor_sync(0xffffffffu, pc0, 2);
    pc1 += __shfl_xor_sync(0xffffffffu, pc1, 1);
    pc1 += __shfl_xor_sync(0xffffffffu, pc1, 2);
    const long long r0 = span0 + kTileRows * (warp + kWarps * i) + g;
    tile_epilogue<kNTiles>(acc[i], pc0, pc1, th, out, out_mode, r0,
                           o[i].real0, o[i].real1, n0, nt, N, t);
  }
}

int launch(const void* packed, long long lds, const void* w, long long ldw,
           const void* vth, void* out, int B, int K, int N, int span_rows,
           int spans, int paired, int out_mode, void* stream) {
  const int W = (K + 31) / 32;
  if (B < 1 || K < 1 || N < 1 || lds < 0 || ldw < 0 ||
      (out_mode == kFirePacked && N % 32) || span_rows < kTileRows ||
      span_rows % kTileRows ||
      span_rows > kTileRows * kWarps * kMaxTilesPerWarp || spans < 1 ||
      (long long)spans * span_rows < B ||
      (long long)(spans - 1) * span_rows >= B)
    return (int)cudaErrorInvalidValue;
  if (paired && (((lds | W) & 1) || reinterpret_cast<uintptr_t>(packed) & 7))
    return (int)cudaErrorInvalidValue;
  // cp.async of whole 16-byte chunks where every row of every group starts
  // 16-byte aligned
  const int vec = reinterpret_cast<uintptr_t>(w) % 16 == 0 && ldw % 16 == 0;
  const dim3 grid((unsigned)spans, (unsigned)((N + kGroup - 1) / kGroup));
  const bool two = span_rows > kTileRows * kWarps;
  const auto kernel =
      paired ? (two ? fused_fire_packed_kernel<true, 2>
                    : fused_fire_packed_kernel<true, 1>)
             : (two ? fused_fire_packed_kernel<false, 2>
                    : fused_fire_packed_kernel<false, 1>);
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)packed, lds, (const int8_t*)w, ldw,
      (const int32_t*)vth, out, B, K, N, span_rows, out_mode, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Fired spikes of one tile: uint32[B, N/32] when pack_out (N % 32 == 0) else
// int8[B, N], from packed uint32[B, ceil(K/32)] (row stride lds words),
// weight bits int8[K, N] (row stride ldw bytes) and vth int32[N], on the
// grid of ops._packed_route: `spans` spans of `span_rows` rows (a multiple
// of 16, at most 256, the spans covering B) by ceil(N / 64) groups;
// `paired` for 8-byte spike loads (W and lds even, packed 8-byte aligned).
// Returns cudaGetLastError().
int cim_matmul_packed_fire(const void* packed, long long lds, const void* w,
                           long long ldw, const void* vth, void* out, int B,
                           int K, int N, int span_rows, int spans, int paired,
                           int pack_out, void* stream) {
  return launch(packed, lds, w, ldw, vth, out, B, K, N, span_rows, spans,
                paired, pack_out ? kFirePacked : kFireInt8, stream);
}

// V int32[B, N] of one tile, from the same operands and grid (no
// threshold).  Returns cudaGetLastError().
int cim_matmul_packed_mac(const void* packed, long long lds, const void* w,
                          long long ldw, void* out, int B, int K, int N,
                          int span_rows, int spans, int paired, void* stream) {
  return launch(packed, lds, w, ldw, nullptr, out, B, K, N, span_rows, spans,
                paired, kVmem, stream);
}

const char* cim_matmul_packed_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
