// The warp-level tensor-core product (mma.sync, PTX ISA; sm_80 and later)
// that computes the popcount MAC exactly (used by popcount_fire_kernel and
// mega_cascade_kernel in kernels/cim_popcount and fused_fire_packed_kernel
// in kernels/cim_matmul_packed), and the pieces of a 16-row warp tile
// around it that the two tile kernels share.  One include directory for
// every library: kernels/_build.py passes it with -I and hashes it into
// each library's cache key.
#pragma once

#include <stdint.h>

// d += sum_k popc(A[m, k] & B[k, n]) over one 16 x 8 x 256-bit tile, in
// lane (g, t) = (lane / 4, lane % 4): A row major (a[0], a[1]: 32-bit word t
// of rows g, g + 8; a[2], a[3]: their word t + 4), B column major (b[0],
// b[1]: words t and t + 4 of column g), d[0], d[1]: row g, columns 2t and
// 2t + 1; d[2], d[3]: row g + 8, the same columns (PTX ISA, the fragments of
// mma.m16n8k256).
__device__ __forceinline__ void mma_and_popc(int (&d)[4],
                                             const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// What a tile kernel's epilogue writes.
enum TileOut : int { kFireInt8 = 0, kFirePacked = 1, kVmem = 2 };

// Words j and j + 1 of a row in device memory, zero past w or for a row
// that is not real.  The tile kernels feed thread (g, t) words 2t and
// 2t + 1 of a 256-bit K step as the K positions t and t + 4, the same in A
// and B, so the permutation cancels in the sum.
template <bool kPaired>
__device__ __forceinline__ uint2 load_pair(const uint32_t* row, int j, int w,
                                           bool real) {
  uint2 v = make_uint2(0u, 0u);
  if (kPaired) {   // w even, row 8-byte aligned: j < w covers j + 1
    if (real && j < w) v = __ldg(reinterpret_cast<const uint2*>(row + j));
  } else {
    if (real && j < w) v.x = __ldg(row + j);
    if (real && j + 1 < w) v.y = __ldg(row + j + 1);
  }
  return v;
}

// Stores a thread's two neighbouring outputs (n, n + 1) of row r of a
// [B, N] output; `even` (N even) makes them one aligned store.
template <typename T, typename T2>
__device__ __forceinline__ void store_two(T* out, long long r, int n, int N,
                                          bool real, bool even, T v0, T v1) {
  if (!real || n >= N) return;
  T* p = out + r * N + n;
  if (even) {
    T2 v;
    v.x = v0;
    v.y = v1;
    *reinterpret_cast<T2*>(p) = v;
  } else {
    p[0] = v0;
    if (n + 1 < N) p[1] = v1;
  }
}

// The epilogue of one warp's 16-row tile of kNT mma n-tiles (8 neurons
// each) at neurons n0.., after the product: acc[q][i] of n-tile q is row r0
// (i 0, 1) or r1 = r0 + 8 (i 2, 3), neuron n0 + 8 q + 2 t + (i & 1); pc0 /
// pc1 are the rows' spike counts, th[q] the thresholds of the thread's two
// neurons of n-tile q (unread for kVmem).  kVmem writes V = 2 acc - popc(s)
// as int32; kFireInt8 one byte a neuron (V >= vth); kFirePacked sets each
// thread's bits of a row's LSB-first 32-neuron word (n0 must be a multiple
// of 32 and N of 32), ORs them over the quad and lets each lane of the quad
// store one of its four words.  Neurons past N and rows that are not real
// are not stored; only n-tiles q < nt hold neurons.
template <int kNT>
__device__ __forceinline__ void tile_epilogue(
    const int (&acc)[kNT][4], int pc0, int pc1, const int (&th)[kNT][2],
    void* __restrict__ out, int out_mode, long long r0, bool real0,
    bool real1, int n0, int nt, int N, int t) {
  static_assert(kNT <= 8, "a packed row word pair covers 8 n-tiles");
  const long long r1 = r0 + 8;
  const bool even = !(N & 1);
  if (out_mode == kVmem) {
    int32_t* o32 = static_cast<int32_t*>(out);
#pragma unroll
    for (int q = 0; q < kNT; ++q) {
      if (q >= nt) continue;
      const int n = n0 + 8 * q + 2 * t;
      store_two<int32_t, int2>(o32, r0, n, N, real0, even,
                               2 * acc[q][0] - pc0, 2 * acc[q][1] - pc0);
      store_two<int32_t, int2>(o32, r1, n, N, real1, even,
                               2 * acc[q][2] - pc1, 2 * acc[q][3] - pc1);
    }
    return;
  }
  uint32_t w00 = 0, w01 = 0, w10 = 0, w11 = 0;   // [row g / g+8][word 0 / 1]
#pragma unroll
  for (int q = 0; q < kNT; ++q) {
    if (q >= nt) continue;
    const int n = n0 + 8 * q + 2 * t;
    const bool f00 = 2 * acc[q][0] - pc0 >= th[q][0];
    const bool f01 = 2 * acc[q][1] - pc0 >= th[q][1];
    const bool f10 = 2 * acc[q][2] - pc1 >= th[q][0];
    const bool f11 = 2 * acc[q][3] - pc1 >= th[q][1];
    if (out_mode == kFireInt8) {
      int8_t* o8 = static_cast<int8_t*>(out);
      store_two<int8_t, char2>(o8, r0, n, N, real0, even, f00, f01);
      store_two<int8_t, char2>(o8, r1, n, N, real1, even, f10, f11);
      continue;
    }
    const int sh = 8 * (q & 3) + 2 * t;   // LSB-first within the word
    const uint32_t b0 = (uint32_t)f00 << sh | (uint32_t)f01 << (sh + 1);
    const uint32_t b1 = (uint32_t)f10 << sh | (uint32_t)f11 << (sh + 1);
    if (q < 4) {
      w00 |= b0;
      w10 |= b1;
    } else {
      w01 |= b0;
      w11 |= b1;
    }
  }
  if (out_mode != kFirePacked) return;
#pragma unroll
  for (int m = 1; m <= 2; m <<= 1) {
    w00 |= __shfl_xor_sync(0xffffffffu, w00, m);
    w01 |= __shfl_xor_sync(0xffffffffu, w01, m);
    w10 |= __shfl_xor_sync(0xffffffffu, w10, m);
    w11 |= __shfl_xor_sync(0xffffffffu, w11, m);
  }
  // lane t of the quad stores word t & 1 of row g (t < 2) or g + 8
  const uint32_t word = t == 0 ? w00 : t == 1 ? w01 : t == 2 ? w10 : w11;
  const int wi = (n0 >> 5) + (t & 1);
  if ((t < 2 ? real0 : real1) && wi < (N >> 5))
    static_cast<uint32_t*>(out)[(t < 2 ? r0 : r1) * (N >> 5) + wi] = word;
}
