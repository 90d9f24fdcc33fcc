// Binary CIM MAC on unpacked spikes (and the MAC with fused IF fire), for
// NVIDIA Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of the JAX reference
//   cim_matmul  <- src/repro/kernels/cim_matmul/kernel.py:27 _mac_kernel
//   esam_layer  <- src/repro/kernels/cim_matmul/kernel.py:47 _fused_fire_kernel
// which take {0,1} spikes [B, K] of any dtype (cast to bf16) and {0,1} int8
// weight bits [K, N] decoded to +-1, accumulate the product in float32 on
// the MXU (exact: |V| <= K < 2^24), and either store V as int32 or fire at
// V >= vth and store the int8 spikes, V never leaving VMEM.  This kernel
// sums the same terms in int32:
//
//     V[b, n] = sum_{k : s[b, k] != 0} (2 * w[k, n] - 1).
//
// A spike is read as "nonzero" on its raw bits, whatever its width (1, 2, 4
// or 8 bytes: bool, int8, bf16, float32, ...).  That is the contract for
// {0,1} inputs, the reference's domain; nothing is promised for other
// values (the reference's kernel and its ref already disagree there).
//
// What bounds it on an H100: at the kernel bench's 256 x 768 -> 256 with
// float32 spikes it reads 0.79 MB of spikes and 0.2 MB of weights and writes
// 0.26 MB of int32 V (0.07 MB of int8 spikes fused), about 0.37 us (0.31 us)
// at 3.35 TB/s, against 1e8 multiply-adds that the int8 tensor cores would
// take 0.05 us for: bytes bound it.
//
// Design: the popcount identity of the packed kernels,
//
//     V[b, n] = 2 * sum_j popc(s[b, j] & plane[n, j]) - sum_j popc(s[b, j]),
//
// with both operands packed on the fly, so a lane spends one AND and two
// popcounts per 32 synapses and no spike or weight is expanded to a float:
//   * a block owns 32 output neurons (one lane each) and 8 or 64 batch rows
//     (1 or 8 per warp, accumulators in registers): 8 per warp while that
//     still gives every SM two blocks, else 1, so a small batch spreads its
//     latency-bound chains over more blocks;
//   * per pass of kChunkWords words of 32 inputs, each warp builds weight
//     planes in shared memory exactly as cim_matmul_packed.cu does: lane b
//     reads the 32 weight bytes of input row 32 j + b for the block's 32
//     neurons, and one __ballot_sync per neuron gives that neuron's plane
//     word; a nonzero byte is a '1', and bits past K or N are zero;
//   * a spike word is __ballot_sync(s != 0) over 32 consecutive spikes of a
//     row, one coalesced load per lane; spikes past K read as 0.  A warp
//     issues the loads of all its rows for one word before the first
//     ballot, so kRowsPerWarp loads are in flight instead of one;
//   * the epilogue stores each lane's int32 V, or compares it with vth and
//     stores the int8 fire, so V never reaches memory in the fused form.
// Left for later: the int8 tensor-core (mma, int32 accumulate) datapath,
// cp.async staging, planes built once per call instead of once per block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunkWords = 64;             // input words (of 32) per pass
// Batch rows per warp: kWideRows while the grid still has kBlocksPerSm
// blocks for every SM, else one (more blocks, each a shorter chain).
constexpr int kWideRows = 8;
constexpr int kBlocksPerSm = 2;

// The 32 weight bytes w[k, n0 .. n0 + 31] as 8 little-endian words; bytes
// past N, and every byte of a row k >= K, are zero.
__device__ __forceinline__ void load_row32(const int8_t* __restrict__ w,
                                           long long ldw, long long k, int K,
                                           int n0, int N, bool vec,
                                           uint32_t (&r)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) r[i] = 0u;
  if (k >= K) return;
  const int8_t* p = w + k * ldw + n0;
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

// T: an unsigned integer as wide as one spike element.  kFire: compare with
// vth and store int8 spikes, else store int32 V.  kRowsPerWarp batch rows
// per warp, kWarps * kRowsPerWarp per block.
template <typename T, bool kFire, int kRowsPerWarp>
__global__ void __launch_bounds__(kThreads)
cim_matmul_kernel(const T* __restrict__ s, long long lds,
                  const int8_t* __restrict__ w, long long ldw,
                  const int32_t* __restrict__ vth, void* __restrict__ out,
                  int B, int K, int N, int vec) {
  __shared__ uint32_t wp[kChunkWords][33];  // [word][lane], padded

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = blockIdx.y * 32;
  const int n = n0 + lane;
  const long long row0 = (long long)blockIdx.x * kWarps * kRowsPerWarp;
  const int W = (K + 31) >> 5;

  int acc[kRowsPerWarp], cnt[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) acc[r] = cnt[r] = 0;

  for (int j0 = 0; j0 < W; j0 += kChunkWords) {
    const int jc = min(kChunkWords, W - j0);
    __syncthreads();  // the previous pass is done with wp
    for (int jj = warp; jj < jc; jj += kWarps) {
      uint32_t r8[8];
      load_row32(w, ldw, (long long)(j0 + jj) * 32 + lane, K, n0, N,
                 vec != 0, r8);
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
#pragma unroll 2
    for (int jj = 0; jj < jc; ++jj) {
      // the warp's rows' 32 spikes of word j0 + jj, all loads issued first
      const int k = (j0 + jj) * 32 + lane;
      T x[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const long long row = row0 + warp + r * kWarps;
        x[r] = row < B && k < K ? __ldg(s + row * lds + k) : T(0);
      }
      const uint32_t plane = wp[jj][lane];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const uint32_t word = __ballot_sync(0xffffffffu, x[r] != T(0));
        acc[r] += __popc(word & plane);
        cnt[r] += __popc(word);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const long long row = row0 + warp + r * kWarps;
    if (row >= B || n >= N) continue;
    const int v = 2 * acc[r] - cnt[r];
    if (kFire)
      static_cast<int8_t*>(out)[row * N + n] = v >= __ldg(vth + n) ? 1 : 0;
    else
      static_cast<int32_t*>(out)[row * N + n] = v;
  }
}

template <typename T, bool kFire>
int launch_typed(const void* s, long long lds, const void* w, long long ldw,
                 const void* vth, void* out, int B, int K, int N, int sms,
                 cudaStream_t st) {
  // 16-byte weight loads when every 32-neuron group starts 16-byte aligned
  const int vec = (uintptr_t)w % 16 == 0 && ldw % 16 == 0;
  const int col_blocks = (N + 31) / 32;
  const long long wide =
      (long long)((B + kWarps * kWideRows - 1) / (kWarps * kWideRows)) *
      col_blocks;
  if (wide >= (long long)kBlocksPerSm * sms) {
    const dim3 grid((B + kWarps * kWideRows - 1) / (kWarps * kWideRows),
                    col_blocks);
    cim_matmul_kernel<T, kFire, kWideRows><<<grid, kThreads, 0, st>>>(
        (const T*)s, lds, (const int8_t*)w, ldw, (const int32_t*)vth, out, B,
        K, N, vec);
  } else {
    const dim3 grid((B + kWarps - 1) / kWarps, col_blocks);
    cim_matmul_kernel<T, kFire, 1><<<grid, kThreads, 0, st>>>(
        (const T*)s, lds, (const int8_t*)w, ldw, (const int32_t*)vth, out, B,
        K, N, vec);
  }
  return (int)cudaGetLastError();
}

template <bool kFire>
int launch(const void* s, long long lds, int spike_bytes, const void* w,
           long long ldw, const void* vth, void* out, int B, int K, int N,
           int sms, void* stream) {
  if (B < 1 || K < 1 || N < 1 || sms < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (spike_bytes) {
    case 1:
      return launch_typed<uint8_t, kFire>(s, lds, w, ldw, vth, out, B, K, N,
                                          sms, st);
    case 2:
      return launch_typed<uint16_t, kFire>(s, lds, w, ldw, vth, out, B, K, N,
                                           sms, st);
    case 4:
      return launch_typed<uint32_t, kFire>(s, lds, w, ldw, vth, out, B, K, N,
                                           sms, st);
    case 8:
      return launch_typed<unsigned long long, kFire>(s, lds, w, ldw, vth, out,
                                                     B, K, N, sms, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// V int32[B, N] from spikes [B, K] of spike_bytes-wide elements (row stride
// lds elements, rows contiguous) and weight bits int8[K, N] (row stride ldw
// bytes); `sms` is the card's SM count.  Returns cudaGetLastError().
int cim_matmul_mac(const void* s, long long lds, int spike_bytes,
                   const void* w, long long ldw, void* out, int B, int K,
                   int N, int sms, void* stream) {
  return launch<false>(s, lds, spike_bytes, w, ldw, nullptr, out, B, K, N,
                       sms, stream);
}

// Fired spikes int8[B, N] = (V >= vth) from the same operands and vth
// int32[N].  Returns cudaGetLastError().
int cim_matmul_fire(const void* s, long long lds, int spike_bytes,
                    const void* w, long long ldw, const void* vth, void* out,
                    int B, int K, int N, int sms, void* stream) {
  return launch<true>(s, lds, spike_bytes, w, ldw, vth, out, B, K, N, sms,
                      stream);
}

const char* cim_matmul_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
