// Weight planes built inside a tile kernel from {0,1} int8 weights [K, N],
// one 256-bit K step at a time (used by fused_fire_packed_kernel in
// kernels/cim_matmul_packed and cim_matmul_kernel in kernels/cim_matmul).
// A CTA of kThreads threads owns one kGroup-neuron group, and each warp
// turns 32 of a step's K rows of the group into one plane word a neuron
// (transpose_word), so that plane word w bit l of neuron n is staged row
// 32 w + l's byte n, nonzero; the step's kStageRows rows are staged into
// shared memory by cp.async first (stage_rows), 16 bytes a thread, so a
// warp's copy covers 8 rows.  Which K row a staged row holds is the
// caller's (stage_rows' `row_of`): a kernel whose spike words hold their K
// positions in another order stages the rows in that order, and the
// permutation cancels in the product.
#pragma once

#include <stdint.h>

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kGroup = 64;                 // neurons of a CTA
constexpr int kStepWords = 8;              // input words of a K step
constexpr int kStageRows = 32 * kStepWords;   // K rows of a stage: one step
constexpr int kStageBytes = kStageRows * kGroup;
constexpr int kStages = 2;                 // stages in flight
static_assert(kWarps == kStepWords, "a warp transposes a word of a step");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes into shared memory, of which the first `src_bytes` (0..16) come
// from `src` and the rest are zero.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most the newest kStages - 1 groups are in flight.
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
}

// Byte offset of 16-neuron chunk q of staged row r: the rows are 64 bytes,
// the chunks of each pair of rows rotated, so the 8 lanes of a quarter warp
// reading chunk q of 8 consecutive rows hit 32 different banks.
__device__ __forceinline__ int stage_offset(int r, int q) {
  return r * kGroup + 16 * (q ^ ((r >> 1) & 3));
}

// Staged row r holds K row k0 + r.
struct StepRows {
  __device__ __forceinline__ int operator()(int r) const { return r; }
};

// Stages K rows k0 + row_of(r), r in [0, kStageRows), of neurons [n0,
// n0 + 64) of the int8 weights, zero past K and N.  Where every row starts
// 16-byte aligned (`vec`): a cp.async a 16-byte chunk, four a thread.
// Otherwise a thread a row, by predicated byte loads, 16 neurons at a time
// and only as many chunks as the group has neurons (one for N = 10).
template <class RowOf = StepRows>
__device__ __forceinline__ void stage_rows(uint8_t* stage,
                                           const int8_t* __restrict__ w,
                                           long long ldw, int k0, int K,
                                           int n0, int N, bool vec,
                                           RowOf row_of = RowOf()) {
  if (vec) {
#pragma unroll
    for (int m = 0; m < kStageRows * 4 / kThreads; ++m) {
      const int i = threadIdx.x + m * kThreads;
      const int r = i >> 2, q = i & 3;
      const int k = k0 + row_of(r), c = n0 + 16 * q;
      const int valid = k < K ? min(16, max(0, N - c)) : 0;
      cp_async16(stage + stage_offset(r, q),
                 valid ? w + (long long)k * ldw + c : w, valid);
    }
    return;
  }
  static_assert(kStageRows == kThreads, "a thread a staged row");
  const int r = threadIdx.x, k = k0 + row_of(r);
  const int8_t* src = w + (long long)k * ldw + n0;
  const int cols = k < K ? min(kGroup, N - n0) : 0;
#pragma unroll 1
  for (int q = 0; q < 4; ++q) {
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    if (16 * q < cols) {
#pragma unroll
      for (int b = 0; b < 16; ++b)
        if (16 * q + b < cols)
          v[b >> 2] |= (uint32_t)(uint8_t)__ldg(src + 16 * q + b)
                       << (8 * (b & 3));
    }
    *reinterpret_cast<uint4*>(stage + stage_offset(r, q)) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// Bit i of the result: byte i of y is nonzero (i < 4): the bytes' top bits
// after __vcmpne4, gathered by one multiply into bits 28..31.
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t y) {
  return ((__vcmpne4(y, 0u) & 0x80808080u) * 0x00204081u) >> 28;
}

// A 32 x 32 bit matrix held a row a lane (bit c of lane r), transposed
// across the warp: bit r of lane c on return.  Five butterflies, each
// swapping the off-diagonal j x j blocks of every 2j x 2j block.
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
  const uint32_t masks[5] = {0x0000ffffu, 0x00ff00ffu, 0x0f0f0f0fu,
                             0x33333333u, 0x55555555u};
#pragma unroll
  for (int i = 0, j = 16; i < 5; ++i, j >>= 1) {
    const uint32_t m = masks[i];
    const uint32_t y = __shfl_xor_sync(0xffffffffu, x, j);
    x = (lane & j) ? ((y >> j) & m) | (x & ~m) : (x & m) | ((y & m) << j);
  }
  return x;
}

// Word `warp` of the step's planes from this warp's 32 staged rows (lane l:
// row l's 64 bytes, as 64 bits): lane l stores neurons l and l + 32, a
// neuron's 8 words of the step contiguous in `planes`; the upper half only
// where the group has neurons there.
__device__ __forceinline__ void transpose_word(const uint8_t* stage,
                                               uint32_t* planes, int warp,
                                               int lane, bool upper) {
  const int r = 32 * warp + lane;
  uint32_t lo = 0u, hi = 0u;   // neurons 0..31 and 32..63 of row r
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint4 v =
        *reinterpret_cast<const uint4*>(stage + stage_offset(r, q));
    const uint32_t bits = nonzero_bytes(v.x) | nonzero_bytes(v.y) << 4 |
                          nonzero_bytes(v.z) << 8 | nonzero_bytes(v.w) << 12;
    if (q < 2)
      lo |= bits << (16 * q);
    else
      hi |= bits << (16 * (q - 2));
  }
  planes[lane * kStepWords + warp] = transpose32(lo, lane);
  planes[(lane + 32) * kStepWords + warp] = upper ? transpose32(hi, lane) : 0u;
}
