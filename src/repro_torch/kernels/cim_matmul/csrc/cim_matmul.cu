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
// gives the same V through the popcount identity of the packed kernels,
//
//     V[b, n] = 2 * sum_j popc(s[b, j] & plane[n, j]) - sum_j popc(s[b, j]),
//
// with the spike words s and the weight planes both built inside the
// kernel.  A spike is read as "nonzero" on its raw bits, whatever its width
// (1, 2, 4 or 8 bytes: bool, int8, bf16, float32, ...).  That is the
// contract for {0,1} inputs, the reference's domain; nothing is promised
// for other values (the reference's kernel and its ref already disagree
// there).
//
// What bounds it on an H100: at the kernel bench's 256 x 768 -> 256 with
// float32 spikes it reads 0.79 MB of spikes and 0.2 MB of weights and writes
// 0.26 MB of int32 V (0.07 MB of int8 spikes fused): 0.372 us (0.313 us) at
// 3.35 TB/s.  The MAC's 2 B N K AND+popc operations take 0.009 us on the b1
// tensor-core product (mma.sync m16n8k256 .and.popc, BMMA; its rate is
// probed by probes/rate_probe.cu): bytes bound it.  What kept PR 17's
// kernel (a ballot a neuron and a popc a word on the CUDA cores, one row a
// warp, serial 4-byte spike loads) at 21x that bound was latency: every
// CTA rebuilt its planes over all of K and walked K one word at a time.
//
// Design (one launch; ops._matmul_route picks the grid):
//   * a CTA owns one 64-neuron group (8 mma n-tiles, a warp each) and a
//     span of 16, 32 or 64 rows (kT row tiles), the spans sized so that
//     the grid fills the card about once; it builds its group's planes
//     once a K step, so the weights are read once a span;
//   * K runs in phases of kS steps (all of K = 768 in one at the bench's
//     shape), each phase's copies all in flight before its first
//     transpose or ballot: the step's int8 weight rows and the span's
//     spikes land in shared memory by cp.async, 16 bytes a thread (the
//     memory time is the SM's cp.async line rate, so nothing waits on a
//     register);
//   * the planes: kernels/csrc/planes.cuh, fused_fire_packed's build
//     (stage_rows, then a 32 x 32 bit shuffle transpose a warp), with the
//     weight rows staged in the spike words' K order (PackedOrder);
//   * the spike words: all 8 warps pack the span's staged rows, a 16-byte
//     chunk a thread at a time: its elements become bits (nonzero on
//     their raw bits) and one __ballot_sync a bit position makes a word of
//     32 chunks.  That puts the K positions of a step in an order of their
//     own (PackedOrder, per width), which the staged weight rows share, so
//     it cancels in the sum.  Inputs past K and rows past B stage as zero;
//   * spike rows whose start or stride is not 16-byte aligned (column
//     views; K 33, 100 or 777 in a 1-byte dtype) stage element by element
//     into the same chunks (`vec`, chosen per launch); weight rows that are
//     not aligned stage by byte loads (planes.cuh);
//   * the product, a phase at a time: warp w multiplies every row tile of
//     the span by n-tile w, A and B fragments from shared memory
//     (conflict-free 8-byte loads); a row's spike count from the A words
//     and two quad shuffles;
//   * the epilogue (tile_epilogue, mma.cuh): int32 V, or one int8 a neuron
//     at V >= vth, so V never reaches memory in the fused form.
// What the card showed (PERF.md, PR 26): the time at the bench's shape is
// the SM's copy line rate (the weights' 64-byte rows cost a line each) and
// the planes' transposes, each about as long as the other; a ring of
// single-step stages, clusters sharing the planes, and TMA bulk copies of
// the spike rows were each slower.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "planes.cuh"

namespace {

constexpr int kTileRows = 16;              // rows of an mma tile
// 16-byte spike chunks a thread stages a K step, at most (a span's K step
// of spikes in 64 KB)
constexpr int kMaxChunks = 16;
// shared memory of a phase, at most (kS steps; one at least)
constexpr int kSmemBudget = 110 * 1024;

// The unsigned integer as wide as one spike element.
template <int kE> struct Elem;
template <> struct Elem<1> { using T = unsigned char; };
template <> struct Elem<2> { using T = unsigned short; };
template <> struct Elem<4> { using T = unsigned int; };
template <> struct Elem<8> { using T = unsigned long long; };

// Staged weight row r of a K step (plane word r / 32, bit r % 32) holds the
// K position that bit of the packed spike words holds (pack_step): with E =
// 16 / kE elements a chunk, bit b of word w is element w % E of chunk 32
// (w / E) + b; for 1-byte spikes (E = 16, two rows a warp) the low half of
// word w is element w of chunks 0..15, the high half element w + 8.
template <int kE>
struct PackedOrder {
  __device__ __forceinline__ int operator()(int r) const {
    const int w = r >> 5, b = r & 31;
    constexpr int E = 16 / kE;
    if constexpr (kE == 1)
      return 16 * (b & 15) + w + 8 * (b >> 4);
    else
      return 32 * E * (w / E) + E * b + (w % E);
  }
};

// Bit j: element j of the 16-byte chunk v is nonzero.
template <int kE>
__device__ __forceinline__ uint32_t nonzero_elems(uint4 v) {
  if constexpr (kE == 1) {
    return nonzero_bytes(v.x) | nonzero_bytes(v.y) << 4 |
           nonzero_bytes(v.z) << 8 | nonzero_bytes(v.w) << 12;
  } else if constexpr (kE == 2) {
    const uint32_t x[4] = {v.x, v.y, v.z, v.w};
    uint32_t bits = 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      bits |= (uint32_t)((x[i] & 0xffffu) != 0u) << (2 * i) |
              (uint32_t)((x[i] >> 16) != 0u) << (2 * i + 1);
    return bits;
  } else if constexpr (kE == 4) {
    return (uint32_t)(v.x != 0u) | (uint32_t)(v.y != 0u) << 1 |
           (uint32_t)(v.z != 0u) << 2 | (uint32_t)(v.w != 0u) << 3;
  } else {
    return (uint32_t)((v.x | v.y) != 0u) |
           (uint32_t)((v.z | v.w) != 0u) << 1;
  }
}

// Chunk m of this thread in a K step of the span: row c / R of the span,
// chunk c % R of the row's 256 inputs (R = 16 kE chunks of E = 16 / kE).
template <int kE>
struct Chunk {
  static constexpr int E = 16 / kE;
  static constexpr int R = 16 * kE;
  int r, k;   // span row, first K position
  __device__ __forceinline__ Chunk(int m, int step) {
    const int c = threadIdx.x + m * kThreads;
    r = c / R;
    k = step * kStageRows + (c % R) * E;
  }
};

// Stages this thread's kT * kE chunks of K step `step` (rows row0.. of the
// spikes, row stride lds bytes) into `stage` ([16 kT rows][256 kE bytes]),
// zero past B and past K: one cp.async a chunk where rows are 16-byte
// aligned (`vec`; a chunk that holds an input < K lies in the row's aligned
// 16 bytes, the rest zero-filled), else element loads and one store.
template <int kE, int kT>
__device__ __forceinline__ void stage_spikes(uint8_t* stage,
                                             const uint8_t* __restrict__ s,
                                             long long lds, int B, int K,
                                             long long row0, int step,
                                             bool vec) {
  using T = typename Elem<kE>::T;
  constexpr int E = Chunk<kE>::E;
#pragma unroll
  for (int m = 0; m < kT * kE; ++m) {
    const Chunk<kE> c(m, step);
    const long long row = row0 + c.r;
    const int valid = row < B ? min(E, max(0, K - c.k)) : 0;
    const uint8_t* p = s + row * lds + (long long)c.k * kE;
    uint8_t* dst = stage + c.r * (kStageRows * kE) + (c.k % kStageRows) * kE;
    if (vec) {
      cp_async16(dst, valid ? p : s, valid * kE);
    } else {
      union {
        uint4 v;
        T e[E];
      } u;
      u.v = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int j = 0; j < E; ++j)
        if (j < valid) u.e[j] = __ldg(reinterpret_cast<const T*>(p) + j);
      *reinterpret_cast<uint4*>(dst) = u.v;
    }
  }
}

// The span's spike words of K step `step` from this thread's staged chunks
// (zero past B and K), into aw[row][word] (PackedOrder): one __ballot_sync
// a bit position a chunk.
template <int kE, int kT>
__device__ __forceinline__ void pack_step(const uint8_t* stage,
                                          uint32_t (*aw)[kStepWords],
                                          int step, int lane) {
  constexpr int E = Chunk<kE>::E;
#pragma unroll
  for (int m = 0; m < kT * kE; ++m) {
    const Chunk<kE> c(m, step);
    const uint32_t bits = nonzero_elems<kE>(*reinterpret_cast<const uint4*>(
        stage + c.r * (kStageRows * kE) + (c.k % kStageRows) * kE));
    if constexpr (kE == 1) {
      // lanes 0..15: row c.r, lanes 16..31: row c.r + 1
      uint32_t lo = 0u, hi = 0u;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const uint32_t word = __ballot_sync(0xffffffffu, (bits >> j) & 1u);
        if ((lane & 7) == (j & 7)) {
          if (j < 8)
            lo = word;
          else
            hi = word;
        }
      }
      if (lane < 8)
        aw[c.r][lane] = (lo & 0xffffu) | (hi << 16);
      else if (lane < 16)
        aw[c.r + 1][lane - 8] = (lo >> 16) | (hi & 0xffff0000u);
    } else {
      uint32_t mine = 0u;
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const uint32_t word = __ballot_sync(0xffffffffu, (bits >> j) & 1u);
        if (lane == j) mine = word;
      }
      // word E h + j of the row: chunks 32 h.. of the step, element j
      if (lane < E) aw[c.r][E * ((c.k % kStageRows) / (32 * E)) + lane] = mine;
    }
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Shared memory of one K step: the weight stage, the span's staged spikes,
// the planes and the span's spike words.
__host__ __device__ constexpr int step_bytes(int kE, int kT) {
  return kStageBytes + kT * kTileRows * kStageRows * kE +
         kGroup * kStepWords * 4 + kT * kTileRows * kStepWords * 4;
}

// K steps a phase: as many as kSmemBudget holds, 4 at most.
__host__ __device__ constexpr int phase_steps(int kE, int kT) {
  return kSmemBudget / step_bytes(kE, kT) < 1   ? 1
         : kSmemBudget / step_bytes(kE, kT) > 4 ? 4
                                                : kSmemBudget /
                                                      step_bytes(kE, kT);
}

// grid (spans, ceil(N / 64)), kThreads threads: CTA (x, y) computes rows
// [16 kT x, 16 kT (x + 1)) of neurons [64 y, 64 y + 64), from kE-byte
// spikes (row stride lds bytes) and int8 weights (row stride ldw bytes),
// kS K steps a phase: a phase's weight rows and spike chunks are all in
// flight (cp.async) before its first transpose or ballot, the next phase's
// are issued as soon as this phase's stages are consumed, and the steps of
// a phase are independent, so their transposes, ballots and products
// overlap.
template <int kE, int kT>
__global__ void __launch_bounds__(kThreads)
cim_matmul_kernel(const uint8_t* __restrict__ s, long long lds,
                  const int8_t* __restrict__ w, long long ldw,
                  const int32_t* __restrict__ vth, void* __restrict__ out,
                  int B, int K, int N, int out_mode, int vec_s, int vec_w) {
  static_assert(kT * kE <= kMaxChunks, "a K step's chunks fit a stage");
  constexpr int kS = phase_steps(kE, kT);
  constexpr int kRows = kT * kTileRows;
  extern __shared__ __align__(16) uint8_t smem[];
  auto wst = reinterpret_cast<uint8_t(*)[kStageBytes]>(smem);
  auto sst = reinterpret_cast<uint8_t(*)[kRows * kStageRows * kE]>(
      smem + kS * kStageBytes);
  auto planes = reinterpret_cast<uint32_t(*)[kGroup * kStepWords]>(
      smem + kS * (kStageBytes + kRows * kStageRows * kE));
  auto aw = reinterpret_cast<uint32_t(*)[kRows][kStepWords]>(
      smem + kS * (kStageBytes + kRows * kStageRows * kE +
                   kGroup * kStepWords * 4));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.y * kGroup;
  const int nq = n0 + 8 * warp;            // this warp's n-tile
  const bool has = nq < N;
  const bool upper = N - n0 > 32;
  const int steps = (K + kStageRows - 1) / kStageRows;
  const long long row0 = (long long)blockIdx.x * kRows;

  auto load_phase = [&](int p0) {
#pragma unroll
    for (int j = 0; j < kS; ++j) {
      if (p0 + j >= steps) break;
      stage_rows(wst[j], w, ldw, (p0 + j) * kStageRows, K, n0, N,
                 vec_w != 0, PackedOrder<kE>());
      stage_spikes<kE, kT>(sst[j], s, lds, B, K, row0, p0 + j, vec_s != 0);
    }
    cp_async_commit();
  };
  load_phase(0);
  int th[1][2] = {};
  if (out_mode != kVmem && has) {
    const int n = nq + 2 * t;
    if (n < N) th[0][0] = __ldg(vth + n);
    if (n + 1 < N) th[0][1] = __ldg(vth + n + 1);
  }
  int acc[kT][1][4] = {};
  int pc[kT][2] = {};   // popc(s) of rows g and g + 8 of each tile
  for (int p0 = 0; p0 < steps; p0 += kS) {
    cp_async_wait_all();   // the phase's stages have landed (these copies)
    __syncthreads();       // ... every thread's; the last phase's product
                           // is done with planes and aw
#pragma unroll
    for (int j = 0; j < kS; ++j)
      if (p0 + j < steps)
        transpose_word(wst[j], planes[j], warp, lane, upper);
#pragma unroll
    for (int j = 0; j < kS; ++j)
      if (p0 + j < steps) pack_step<kE, kT>(sst[j], aw[j], p0 + j, lane);
    __syncthreads();       // planes and spike words whole; the stages free
    if (p0 + kS < steps) load_phase(p0 + kS);
    // every warp multiplies, a warp past N on planes no output reads: no
    // branch on the warp, so the shuffles and ballots of the next phase
    // stay in converged code
#pragma unroll
    for (int j = 0; j < kS; ++j) {
      if (p0 + j >= steps) break;
      const uint2 bv = *reinterpret_cast<const uint2*>(
          planes[j] + (8 * warp + g) * kStepWords + 2 * t);
      const uint32_t b[2] = {bv.x, bv.y};
#pragma unroll
      for (int i = 0; i < kT; ++i) {
        if (row0 + kTileRows * i >= B) continue;   // the whole warp
        const uint2 x0 = *reinterpret_cast<const uint2*>(
            &aw[j][kTileRows * i + g][2 * t]);
        const uint2 x1 = *reinterpret_cast<const uint2*>(
            &aw[j][kTileRows * i + g + 8][2 * t]);
        const uint32_t av[4] = {x0.x, x1.x, x0.y, x1.y};
        pc[i][0] += __popc(x0.x) + __popc(x0.y);
        pc[i][1] += __popc(x1.x) + __popc(x1.y);
        mma_and_popc(acc[i][0], av, b);
      }
    }
  }

  if (!has) return;
#pragma unroll
  for (int i = 0; i < kT; ++i) {
    if (row0 + kTileRows * i >= B) continue;
    int pc0 = pc[i][0], pc1 = pc[i][1];
    pc0 += __shfl_xor_sync(0xffffffffu, pc0, 1);
    pc0 += __shfl_xor_sync(0xffffffffu, pc0, 2);
    pc1 += __shfl_xor_sync(0xffffffffu, pc1, 1);
    pc1 += __shfl_xor_sync(0xffffffffu, pc1, 2);
    const long long r0 = row0 + kTileRows * i + g;
    tile_epilogue<1>(acc[i], pc0, pc1, th, out, out_mode, r0, r0 < B,
                     r0 + 8 < B, nq, 1, N, t);
  }
}

template <int kE, int kT>
void launch_kernel(dim3 grid, cudaStream_t st, const void* s, long long lds,
                   const void* w, long long ldw, const void* vth, void* out,
                   int B, int K, int N, int out_mode, int vec_s, int vec_w) {
  constexpr int bytes = phase_steps(kE, kT) * step_bytes(kE, kT);
  // past 48 KB a kernel asks for its shared memory (a refusal is the
  // launch's error: cudaGetLastError returns it)
  cudaFuncSetAttribute(cim_matmul_kernel<kE, kT>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  cim_matmul_kernel<kE, kT><<<grid, kThreads, bytes, st>>>(
      (const uint8_t*)s, lds, (const int8_t*)w, ldw, (const int32_t*)vth,
      out, B, K, N, out_mode, vec_s, vec_w);
}

template <int kE>
int launch_width(int tiles, dim3 grid, cudaStream_t st, const void* s,
                 long long lds, const void* w, long long ldw, const void* vth,
                 void* out, int B, int K, int N, int out_mode, int vec_s,
                 int vec_w) {
  switch (tiles) {
    case 1:
      launch_kernel<kE, 1>(grid, st, s, lds, w, ldw, vth, out, B, K, N,
                           out_mode, vec_s, vec_w);
      break;
    case 2:
      launch_kernel<kE, 2>(grid, st, s, lds, w, ldw, vth, out, B, K, N,
                           out_mode, vec_s, vec_w);
      break;
    case 4:
      if constexpr (4 * kE <= kMaxChunks)
        launch_kernel<kE, 4>(grid, st, s, lds, w, ldw, vth, out, B, K, N,
                             out_mode, vec_s, vec_w);
      else
        return (int)cudaErrorInvalidValue;
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int launch(const void* s, long long lds, int spike_bytes, const void* w,
           long long ldw, const void* vth, void* out, int B, int K, int N,
           int span_rows, int spans, int vec, int out_mode, void* stream) {
  const int tiles = span_rows / kTileRows;
  if (B < 1 || K < 1 || N < 1 || lds < 0 || ldw < 0 ||
      span_rows % kTileRows || spans < 1 ||
      (long long)spans * span_rows < B ||
      (long long)(spans - 1) * span_rows >= B)
    return (int)cudaErrorInvalidValue;
  const long long lds_bytes = lds * spike_bytes;
  // 16-byte spike loads only where every row starts 16-byte aligned
  if (vec && (reinterpret_cast<uintptr_t>(s) % 16 || lds_bytes % 16))
    return (int)cudaErrorInvalidValue;
  // cp.async of whole 16-byte weight chunks where every row of every group
  // starts 16-byte aligned
  const int vec_w = reinterpret_cast<uintptr_t>(w) % 16 == 0 && ldw % 16 == 0;
  const dim3 grid((unsigned)spans, (unsigned)((N + kGroup - 1) / kGroup));
  const cudaStream_t st = (cudaStream_t)stream;
  switch (spike_bytes) {
    case 1:
      return launch_width<1>(tiles, grid, st, s, lds_bytes, w, ldw, vth, out,
                             B, K, N, out_mode, vec, vec_w);
    case 2:
      return launch_width<2>(tiles, grid, st, s, lds_bytes, w, ldw, vth, out,
                             B, K, N, out_mode, vec, vec_w);
    case 4:
      return launch_width<4>(tiles, grid, st, s, lds_bytes, w, ldw, vth, out,
                             B, K, N, out_mode, vec, vec_w);
    case 8:
      return launch_width<8>(tiles, grid, st, s, lds_bytes, w, ldw, vth, out,
                             B, K, N, out_mode, vec, vec_w);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// V int32[B, N] from spikes [B, K] of spike_bytes-wide elements (row stride
// lds elements, rows contiguous) and weight bits int8[K, N] (row stride ldw
// bytes), on the grid of ops._matmul_route: `spans` spans of `span_rows`
// rows (16, 32 or 64; at most 32 for 8-byte spikes; the spans covering B)
// by ceil(N / 64) groups; `vec` for 16-byte spike loads (the spikes and
// their row stride 16-byte aligned).  Returns cudaGetLastError().
int cim_matmul_mac(const void* s, long long lds, int spike_bytes,
                   const void* w, long long ldw, void* out, int B, int K,
                   int N, int span_rows, int spans, int vec, void* stream) {
  return launch(s, lds, spike_bytes, w, ldw, nullptr, out, B, K, N,
                span_rows, spans, vec, kVmem, stream);
}

// Fired spikes int8[B, N] = (V >= vth) from the same operands and grid and
// vth int32[N].  Returns cudaGetLastError().
int cim_matmul_fire(const void* s, long long lds, int spike_bytes,
                    const void* w, long long ldw, const void* vth, void* out,
                    int B, int K, int N, int span_rows, int spans, int vec,
                    void* stream) {
  return launch(s, lds, spike_bytes, w, ldw, vth, out, B, K, N, span_rows,
                spans, vec, kFireInt8, stream);
}

const char* cim_matmul_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
