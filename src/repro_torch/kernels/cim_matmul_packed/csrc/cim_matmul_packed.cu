// Packed-spike CIM tile with fused IF fire, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX reference
//   fused_fire_packed  <- src/repro/kernels/cim_matmul_packed/kernel.py:66
//                         fused_fire_packed_kernel
// which unpacks the spike words in VMEM, runs the +-1 MAC on the MXU
// (bf16 x bf16 -> f32) against {0,1} int8 weights [K, N], fires at
// V >= vth and re-packs the fired bits.  The reference's product is exact
// (|V| <= K < 2^24), so this kernel sums the same terms in int32 and gives
// the same fired words:
//
//     V[b, n] = sum_{k : s[b, k] = 1} (2 * w[k, n] - 1).
//
// What bounds it on an H100: for the learning prefix (4096 x 768 -> 256 at
// spike density ~0.5) about 0.7 MB of operands against ~0.8 G adds, so the
// bound is the arithmetic (int8 tensor-core rate, 1,979 TOP/s) at well
// under a microsecond; this version is far from it.
//
// Design: the weights become bit planes in shared memory, and the MAC is
// the popcount identity of the cim_popcount kernels,
//
//     V[b, n] = 2 * sum_j popc(s[b, j] & plane[n, j]) - sum_j popc(s[b, j]),
//
// so a lane spends one AND and one popcount per 32 synapses.
//   * a block owns 32 output neurons (one lane each) and kRows batch rows
//     (kRowsPerWarp per warp, accumulators in registers);
//   * per pass of kChunkWords input words, each warp builds planes for some
//     words: lane b reads the 32 weight bytes of input row 32 j + b for the
//     block's 32 neurons (two 16-byte loads when aligned), and one
//     __ballot_sync per neuron turns the 32 lanes' bytes into that neuron's
//     plane word (bit b = w[32 j + b, n]); a nonzero byte is a '1';
//   * each spike word is read once per row as a warp-wide broadcast; bits
//     past K in the last word are masked, as the reference's unpack drops
//     them, and plane bits past K or N are zero;
//   * the fire predicates of the 32 lanes go through __ballot_sync, which is
//     exactly the LSB-first wire word (lane i -> bit i).
// Left for later: the int8 tensor-core (mma, int32 accumulate) datapath,
// cp.async staging.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 8;
constexpr int kRows = kWarps * kRowsPerWarp;
constexpr int kChunkWords = 64;             // input words per pass

// The 32 weight bytes w[k, n0 .. n0 + 31] as 8 little-endian words; bytes
// past N, and every byte of a row k >= K, are zero.
__device__ __forceinline__ void load_row32(const int8_t* __restrict__ w,
                                           long long ldw, int k, int K,
                                           int n0, int N, bool vec,
                                           uint32_t (&r)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) r[i] = 0u;
  if (k >= K) return;
  const int8_t* p = w + (long long)k * ldw + n0;
  if (vec && n0 + 32 <= N) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(p) + 1);
    r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
    r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
    return;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i)
    if (n0 + i < N)
      r[i >> 2] |= (uint32_t)(uint8_t)__ldg(p + i) << (8 * (i & 3));
}

__global__ void __launch_bounds__(kThreads)
fused_fire_packed_kernel(const uint32_t* __restrict__ packed, long long lds,
                         const int8_t* __restrict__ w, long long ldw,
                         const int32_t* __restrict__ vth,
                         void* __restrict__ out, int B, int K, int N,
                         int pack_out, int vec) {
  __shared__ uint32_t wp[kChunkWords][33];  // [word][lane], padded

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = blockIdx.y * 32;
  const int n = n0 + lane;
  const long long row0 = (long long)blockIdx.x * kRows;
  const int W = (K + 31) >> 5;

  int acc[kRowsPerWarp], cnt[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) acc[r] = cnt[r] = 0;

  for (int j0 = 0; j0 < W; j0 += kChunkWords) {
    const int jc = min(kChunkWords, W - j0);
    __syncthreads();  // the previous pass is done with wp
    for (int jj = warp; jj < jc; jj += kWarps) {
      uint32_t r8[8];
      load_row32(w, ldw, (j0 + jj) * 32 + lane, K, n0, N, vec != 0, r8);
      uint32_t mine = 0u;
#pragma unroll
      for (int l = 0; l < 32; ++l) {
        const uint32_t word =
            __ballot_sync(0xffffffffu, (r8[l >> 2] >> (8 * (l & 3))) & 0xffu);
        if (lane == l) mine = word;
      }
      wp[jj][lane] = mine;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const long long row = row0 + warp + r * kWarps;
      if (row >= B) continue;
      const uint32_t* s = packed + row * lds + j0;
      for (int jj = 0; jj < jc; ++jj) {
        uint32_t word = __ldg(s + jj);
        const int valid = K - (j0 + jj) * 32;
        if (valid < 32) word &= (1u << valid) - 1u;
        acc[r] += __popc(word & wp[jj][lane]);
        cnt[r] += __popc(word);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const long long row = row0 + warp + r * kWarps;
    if (row >= B) continue;
    const bool fire = n < N && 2 * acc[r] - cnt[r] >= __ldg(vth + n);
    if (pack_out) {
      const uint32_t word = __ballot_sync(0xffffffffu, fire);
      if (lane == 0)
        static_cast<uint32_t*>(out)[row * (N >> 5) + blockIdx.y] = word;
    } else if (n < N) {
      static_cast<int8_t*>(out)[row * N + n] = fire ? 1 : 0;
    }
  }
}

}  // namespace

extern "C" {

// Fired spikes of one tile: uint32[B, N/32] when pack_out (N % 32 == 0) else
// int8[B, N], from packed uint32[B, ceil(K/32)] (row stride lds words),
// weight bits int8[K, N] (row stride ldw bytes) and vth int32[N].
// Returns cudaGetLastError().
int cim_matmul_packed_fire(const void* packed, long long lds, const void* w,
                           long long ldw, const void* vth, void* out, int B,
                           int K, int N, int pack_out, void* stream) {
  if (B < 1 || K < 1 || N < 1 || (pack_out && N % 32))
    return (int)cudaErrorInvalidValue;
  // 16-byte weight loads when every 32-neuron group starts 16-byte aligned
  const int vec = (uintptr_t)w % 16 == 0 && ldw % 16 == 0;
  const dim3 grid((B + kRows - 1) / kRows, (N + 31) / 32);
  fused_fire_packed_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)packed, lds, (const int8_t*)w, ldw,
      (const int32_t*)vth, out, B, K, N, pack_out, vec);
  return (int)cudaGetLastError();
}

const char* cim_matmul_packed_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
