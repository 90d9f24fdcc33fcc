// Popcount-domain CIM MAC kernels for NVIDIA Hopper (sm_90a).
//
// Replaces three Pallas TPU kernels of the JAX reference:
//   mega_cascade   <- src/repro/kernels/cim_popcount/kernel.py:98 mega_cascade_kernel
//   popcount_fire  <- src/repro/kernels/cim_popcount/kernel.py:74 popcount_fire_kernel
//   popcount_mac   <- src/repro/kernels/cim_popcount/kernel.py:54 popcount_mac_kernel
//
// All three keep spikes and weights in the 32-bit wire format (bit b of word j is
// neuron j*32+b) and compute, for +-1 weights stored as {0,1} bits,
//
//     V[b, n] = 2 * sum_j popc(s[b, j] & w[n, j]) - sum_j popc(s[b, j]).
//
// What bounds them on an H100: integer work, not bytes.  One paper-topology
// inference (768:256:256:256:10) is 10,320 AND+popc word pairs against the
// 10,320 real weight words (~41 KB) that every block reuses, plus 96 B of
// input.  The popc unit issues 16 results per clock per SM on compute
// capability 9.0 (CUDA C Programming Guide, arithmetic instruction
// throughput), a quarter of the AND/ADD rate, so popc throughput is the
// roofline: 0.32 us for a 128-row round on an NVIDIA H100 80GB HBM3 at its
// 1980 MHz maximum SM clock (700 W limit).  Measured on that card by
// chip_smoke.py, this kernel takes 10.9 us for 128 rows and 41 us for 4096:
// it is bound by latency inside each block (a dependent chain of shared
// loads per word), not by popc throughput.
//
// What the design does about it:
//   * the whole cascade is one launch (the TPU kernel's single pallas_call):
//     MAC -> IF fire -> re-pack -> next tile, with the fired planes resident
//     in shared memory and never written back between tiles, except once
//     each as the collected output the telemetry needs;
//   * one warp computes 32 neighbouring neurons of one row: each lane owns a
//     neuron, and __ballot_sync of the fire predicates is exactly the
//     LSB-first packed word (lane i -> bit i), so the re-pack costs one
//     instruction;
//   * each tile's real weight words are staged in shared memory transposed
//     (word-major, neuron-minor, one word of padding per word row), so the
//     32 lanes of a warp read 32 consecutive words: conflict-free, while the
//     row's spike word is a broadcast;
//   * geometry (tile count, widths, word counts) is a run-time argument, so
//     one build serves every topology with 32-aligned hidden widths.
// popcount_fire is one tile of the same datapath as its own launch (the
// reference's `prefix` plan runs one per hidden tile): the same staging and
// per-lane MAC, a block per (batch rows, 256 neurons) so a 4096-row batch
// spreads over the SMs.  popcount_mac is that kernel with an int32 V
// epilogue: one thread per output, reading both operands from global
// memory, was slower than cim_matmul_packed.cu's MAC, which the popcount
// plane must beat (the kernel bench's floor).  Weight staging keeps
// kStageLoads loads in flight per thread: one load at a time left the
// cascade waiting on memory for each staged word.
// Left for later: persistent blocks, cp.async/TMA staging of the next tile
// under the current one, an int8 tensor-core datapath.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTiles = 16;
constexpr int kThreads = 256;
constexpr int kStageLoads = 8;    // weight loads in flight per thread

// What popcount_fire_kernel's epilogue writes.
enum OutMode : int { kFireInt8 = 0, kFirePacked = 1, kVmem = 2 };

struct CascadeGeometry {
  int n_tiles;
  int n_out[kMaxTiles];          // real output width of tile t
  int w_words[kMaxTiles];        // real input words of tile t = ceil(K_t/32)
  long long fired_off[kMaxTiles];  // word offset of hidden tile t's plane in `fired`
  int n_max_pad;                 // rows of each w_stack / vth_stack slab
  int w_max;                     // words of each w_stack row
  int plane_words;               // shared words per batch row of a resident plane
  int wt_words;                  // shared words of the staged weight tile
};

__host__ __device__ inline int round32(int n) { return (n + 31) & ~31; }

// One lane's MAC term sum_j popc(s[j] & wt[j * ld + n]): the row's spike
// words `s` are a broadcast, the staged weights `wt` are word-major and
// neuron-minor, so the 32 lanes of a warp read 32 consecutive words.
__device__ __forceinline__ int and_popc(const uint32_t* s, const uint32_t* wt,
                                        int ld, int n, int w) {
  int acc = 0;
#pragma unroll 4
  for (int j = 0; j < w; ++j) acc += __popc(s[j] & wt[j * ld + n]);
  return acc;
}

// Stage planes rows [n0, n0 + n_rows) (row stride ldw words, `w` words each)
// transposed into wt[j * ld + n]; rows past n_real are zero.  Each thread
// issues kStageLoads loads before it stores any, so a block keeps that many
// reads in flight per thread instead of waiting out each one.
__device__ __forceinline__ void stage_planes(uint32_t* wt, int ld,
                                             const uint32_t* __restrict__ planes,
                                             long long ldw, int n0, int n_rows,
                                             int n_real, int w) {
  const int total = n_rows * w;
  for (int base = threadIdx.x; base < total;
       base += blockDim.x * kStageLoads) {
    uint32_t v[kStageLoads];
#pragma unroll
    for (int u = 0; u < kStageLoads; ++u) {
      const int i = base + u * blockDim.x;
      const int n = i / w, j = i - n * w;
      v[u] = i < total && n0 + n < n_real
                 ? __ldg(planes + (long long)(n0 + n) * ldw + j)
                 : 0u;
    }
#pragma unroll
    for (int u = 0; u < kStageLoads; ++u) {
      const int i = base + u * blockDim.x;
      const int n = i / w, j = i - n * w;
      if (i < total) wt[j * ld + n] = v[u];
    }
  }
}

CascadeGeometry make_geometry(int B, int n_tiles, const int* n_out,
                              const int* w_words, int n_max_pad, int w_max) {
  CascadeGeometry g{};
  g.n_tiles = n_tiles;
  g.n_max_pad = n_max_pad;
  g.w_max = w_max;
  long long off = 0;
  for (int t = 0; t < n_tiles; ++t) {
    g.n_out[t] = n_out[t];
    g.w_words[t] = w_words[t];
    g.fired_off[t] = off;
    if (t + 1 < n_tiles) off += (long long)B * (n_out[t] / 32);
    if (w_words[t] > g.plane_words) g.plane_words = w_words[t];
    const int wt = w_words[t] * (round32(n_out[t]) + 1);
    if (wt > g.wt_words) g.wt_words = wt;
  }
  return g;
}

size_t smem_bytes(const CascadeGeometry& g, int block_b) {
  return sizeof(uint32_t) *
         ((size_t)g.wt_words + 2 * (size_t)block_b * g.plane_words + block_b);
}

// grid = ceil(B / block_b); each block carries block_b batch rows through
// every tile.  Rows past B are zero on input and never written.
__global__ void __launch_bounds__(kThreads)
mega_cascade_kernel(const uint32_t* __restrict__ packed, int B,
                    const uint32_t* __restrict__ w_stack,
                    const int32_t* __restrict__ vth_stack,
                    int32_t* __restrict__ logits,
                    uint32_t* __restrict__ fired,
                    const CascadeGeometry g, int block_b) {
  extern __shared__ uint32_t smem[];
  uint32_t* wt = smem;                              // [w][n32 + 1]
  uint32_t* cur = wt + g.wt_words;                  // [block_b][plane_words]
  uint32_t* nxt = cur + block_b * g.plane_words;    // [block_b][plane_words]
  int* spc = reinterpret_cast<int*>(nxt + block_b * g.plane_words);  // [block_b]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const long long row0 = (long long)blockIdx.x * block_b;
  const int rows = (int)min((long long)block_b, (long long)B - row0);

  // the block's input words, and each row's spike count popc(s)
  const int w0 = g.w_words[0];
  for (int i = tid; i < block_b * w0; i += blockDim.x) {
    const int r = i / w0, j = i - r * w0;
    const long long row = row0 + r;
    cur[r * g.plane_words + j] = row < B ? packed[row * w0 + j] : 0u;
  }
  __syncthreads();
  for (int r = tid; r < rows; r += blockDim.x) {
    int c = 0;
    for (int j = 0; j < w0; ++j) c += __popc(cur[r * g.plane_words + j]);
    spc[r] = c;
  }

  for (int t = 0; t < g.n_tiles; ++t) {
    const int n_out = g.n_out[t];
    const int w = g.w_words[t];
    const int ld = round32(n_out) + 1;
    const int groups = round32(n_out) >> 5;
    const bool last = t == g.n_tiles - 1;
    const uint32_t* wsrc = w_stack + (long long)t * g.n_max_pad * g.w_max;

    __syncthreads();  // the previous tile is done with wt; spc/cur are final
    stage_planes(wt, ld, wsrc, g.w_max, 0, ld - 1, n_out, w);
    __syncthreads();

    const int32_t* vth = vth_stack + (long long)t * g.n_max_pad;
    for (int task = warp; task < rows * groups; task += n_warps) {
      const int r = task / groups;
      const int grp = task - r * groups;
      const int n = (grp << 5) + lane;
      const int v = 2 * and_popc(cur + r * g.plane_words, wt, ld, n, w) - spc[r];
      const long long row = row0 + r;
      if (last) {
        if (n < n_out) logits[row * n_out + n] = v;
      } else {
        const bool fire = n < n_out && v >= __ldg(vth + n);
        const uint32_t word = __ballot_sync(0xffffffffu, fire);
        if (lane == 0) {
          nxt[r * g.plane_words + grp] = word;
          fired[g.fired_off[t] + row * groups + grp] = word;
        }
      }
    }
    if (!last) {
      __syncthreads();
      for (int r = tid; r < rows; r += blockDim.x) {
        int c = 0;
        for (int q = 0; q < groups; ++q) c += __popc(nxt[r * g.plane_words + q]);
        spc[r] = c;
      }
      uint32_t* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
  }
}

// One tile's fire (or MAC): grid (ceil(B / rows), ceil(N / (32 * gpb))).  A
// block stages its gpb * 32 neurons' planes (transposed, as the cascade does)
// and its rows' spike words in shared memory; each warp task is one (row,
// 32-neuron group): the cascade's MAC, then by out_mode the IF compare and
// either the __ballot_sync re-pack (kFirePacked) or one int8 spike per lane
// (kFireInt8), or the int32 V per lane (kVmem: the popcount_mac kernel).
// Planes words are ANDed in full, as the reference does, so nothing relies
// on their tail bits being zero; spike tails are zero by the wire format.
__global__ void __launch_bounds__(kThreads)
popcount_fire_kernel(const uint32_t* __restrict__ packed, long long lds,
                     const uint32_t* __restrict__ planes, long long ldw,
                     const int32_t* __restrict__ vth, void* __restrict__ out,
                     int B, int N, int W, int rows, int gpb, int out_mode) {
  extern __shared__ uint32_t smem[];
  const int ld = gpb * 32 + 1;
  uint32_t* wt = smem;                         // [W][gpb * 32 + 1]
  uint32_t* srow = wt + W * ld;                // [rows][W]
  int* spc = reinterpret_cast<int*>(srow + rows * W);  // [rows]

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const long long row0 = (long long)blockIdx.x * rows;
  const int n_rows = (int)min((long long)rows, (long long)B - row0);
  const int n0 = blockIdx.y * gpb * 32;
  const int groups = min(gpb, (N - n0 + 31) >> 5);

  stage_planes(wt, ld, planes, ldw, n0, gpb * 32, N, W);
  for (int i = threadIdx.x; i < n_rows * W; i += blockDim.x) {
    const int r = i / W, j = i - r * W;
    srow[r * W + j] = __ldg(packed + (row0 + r) * lds + j);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < n_rows; r += blockDim.x) {
    int c = 0;
    for (int j = 0; j < W; ++j) c += __popc(srow[r * W + j]);
    spc[r] = c;
  }
  __syncthreads();

  for (int task = warp; task < n_rows * groups; task += n_warps) {
    const int r = task / groups;
    const int grp = task - r * groups;
    const int n_local = (grp << 5) + lane;
    const int n = n0 + n_local;
    const int v = 2 * and_popc(srow + r * W, wt, ld, n_local, W) - spc[r];
    const long long row = row0 + r;
    if (out_mode == kVmem) {
      if (n < N) static_cast<int32_t*>(out)[row * N + n] = v;
      continue;
    }
    const bool fire = n < N && v >= __ldg(vth + n);
    if (out_mode == kFirePacked) {
      const uint32_t word = __ballot_sync(0xffffffffu, fire);
      if (lane == 0)
        static_cast<uint32_t*>(out)[row * (N >> 5) + (n >> 5)] = word;
    } else if (n < N) {
      static_cast<int8_t*>(out)[row * N + n] = fire ? 1 : 0;
    }
  }
}

size_t fire_smem_bytes(int W, int rows, int gpb) {
  return sizeof(uint32_t) *
         ((size_t)W * (gpb * 32 + 1) + (size_t)rows * W + rows);
}

// One launch of popcount_fire_kernel; returns cudaGetLastError().
int launch_tile(const void* packed, long long lds, const void* planes,
                long long ldw, const void* vth, void* out, int B, int N, int W,
                int rows, int gpb, int out_mode, void* stream) {
  if (B < 1 || N < 1 || W < 1 || rows < 1 || gpb < 1 ||
      (out_mode == kFirePacked && N % 32))
    return (int)cudaErrorInvalidValue;
  const size_t smem = fire_smem_bytes(W, rows, gpb);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        popcount_fire_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((B + rows - 1) / rows, (N + 32 * gpb - 1) / (32 * gpb));
  popcount_fire_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)packed, lds, (const uint32_t*)planes, ldw,
      (const int32_t*)vth, out, B, N, W, rows, gpb, out_mode);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of popcount_fire needs.
long long cim_popcount_fire_smem_bytes(int W, int rows, int gpb) {
  return (long long)fire_smem_bytes(W, rows, gpb);
}

// Fired spikes of one tile: uint32[B, N/32] words when pack_out (N % 32 == 0)
// else int8[B, N], from packed uint32[B, W] (row stride lds words), planes
// uint32[N, W] (row stride ldw words) and vth int32[N].  `rows` batch rows and
// `gpb` 32-neuron groups per block.  Returns cudaGetLastError().
int cim_popcount_fire(const void* packed, long long lds, const void* planes,
                      long long ldw, const void* vth, void* out, int B, int N,
                      int W, int rows, int gpb, int pack_out, void* stream) {
  return launch_tile(packed, lds, planes, ldw, vth, out, B, N, W, rows, gpb,
                     pack_out ? kFirePacked : kFireInt8, stream);
}

// V int32[B, N] from packed uint32[B, W] (row stride lds words) and planes
// uint32[N, W] (row stride ldw words): popcount_fire's kernel with the V
// epilogue, `rows` and `gpb` as there.  Returns cudaGetLastError().
int cim_popcount_mac(const void* packed, long long lds, const void* planes,
                     long long ldw, void* out, int B, int N, int W, int rows,
                     int gpb, void* stream) {
  return launch_tile(packed, lds, planes, ldw, nullptr, out, B, N, W, rows,
                     gpb, kVmem, stream);
}


// Dynamic shared memory one block of the mega cascade needs.
long long cim_mega_cascade_smem_bytes(int n_tiles, const int* n_out,
                                      const int* w_words, int block_b) {
  if (n_tiles < 1 || n_tiles > kMaxTiles) return -1;
  const CascadeGeometry g = make_geometry(0, n_tiles, n_out, w_words, 0, 0);
  return (long long)smem_bytes(g, block_b);
}

// Whole cascade in one launch.  packed: uint32[B, w_words[0]];
// w_stack: uint32[n_tiles, n_max_pad, w_max]; vth_stack: int32[n_tiles-1,
// n_max_pad]; logits: int32[B, n_out[last]]; fired: the hidden planes
// uint32[B, n_out[t]/32] back to back.  Returns cudaGetLastError().
int cim_mega_cascade(const void* packed, int B, const void* w_stack,
                     const void* vth_stack, void* logits, void* fired,
                     int n_tiles, const int* n_out, const int* w_words,
                     int n_max_pad, int w_max, int block_b, void* stream) {
  if (n_tiles < 2 || n_tiles > kMaxTiles || block_b < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  const CascadeGeometry g =
      make_geometry(B, n_tiles, n_out, w_words, n_max_pad, w_max);
  const size_t smem = smem_bytes(g, block_b);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mega_cascade_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = (B + block_b - 1) / block_b;
  mega_cascade_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)packed, B, (const uint32_t*)w_stack,
      (const int32_t*)vth_stack, (int32_t*)logits, (uint32_t*)fired, g,
      block_b);
  return (int)cudaGetLastError();
}

// Largest dynamic shared memory a block may opt in to on `device`, or -1.
long long cim_max_shared_optin(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

const char* cim_popcount_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
