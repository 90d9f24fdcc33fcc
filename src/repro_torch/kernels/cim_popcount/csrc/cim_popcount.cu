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
// 10,320 real weight words (~41 KB), plus 96 B of input.  On the CUDA cores
// the popc unit issues 16 results per clock per SM on compute capability
// 9.0 (CUDA C Programming Guide, arithmetic instruction throughput), a
// quarter of the AND/ADD rate: 0.32 us for a 128-row round on an NVIDIA
// H100 80GB HBM3 at its 1980 MHz maximum SM clock (700 W limit).  The b1
// tensor-core product does 39x the popc unit's pairs a second on that card
// (probes/rate_probe.cu), so popcount_fire and popcount_mac use it.  At a
// serving round's 128 rows the cascade is a chain instead: four tiles, each
// needing the last one's fired words, so latency sets its time (PERF.md
// has the measurements).
//
// mega_cascade: the whole cascade in one launch (the TPU kernel's single
// pallas_call): MAC -> IF fire -> re-pack -> next tile.  Its design:
//   * a thread-block cluster of C CTAs splits every tile's neurons: CTA c
//     owns 32-neuron groups [c * gpc, (c + 1) * gpc) of tile t, gpc =
//     ceil(groups_t / C), so no CTA stages the whole network.  A cluster
//     carries a slice of `rows` batch rows through every tile and walks
//     slices until the batch is done;
//   * the planes and thresholds are staged once, at kernel start and off
//     the chain: one thread issues a TMA bulk copy of the CTA's share of
//     every tile at once, each tile completing on its own mbarrier, so tile
//     t waits for its own words only and tiles 1.. land while tile 0
//     computes.  The plan regroups the operands once (ops.cascade_tiles)
//     so that a share is contiguous: per 32-neuron group, (w + 1) x 32
//     words, the group's planes transposed (the 32 lanes of a warp read 32
//     consecutive words) and its thresholds;
//   * one warp computes 32 neighbouring neurons of one row: each lane owns a
//     neuron, and __ballot_sync of the fire predicates is exactly the
//     LSB-first packed word (lane i -> bit i).  Lanes 0..C-1 push it into
//     the next tile's row buffer of every CTA of the cluster (distributed
//     shared memory, st.async), each store completing 4 bytes on that
//     buffer's mbarrier there; lane 31 writes the collected fired plane.  A
//     tile waits for exactly its input words, not for a cluster barrier;
//   * a row's spike count popc(s) is one popc a lane and a warp reduction,
//     inside the warp that needs it: no serial per-row loop;
//   * the common word counts (8 and 24, the paper topology's) run a MAC
//     unrolled at compile time with 128-bit loads of the row's words; the
//     others a run-time loop.  One kernel, a switch per tile.
// The launcher (ops._cascade_route) picks C = 2, or 1 for one group a tile,
// doubled while a CTA's share does not fit shared memory, and rows from the
// batch.  PERF.md has the measurements behind that, and behind what was
// left out: clusters of 8 (slower at every batch but 1: every CTA of a
// cluster loads the rows and counts their spikes), a cluster barrier a tile
// (~1,000 cycles), cp.async staging (~3,000 cycles to issue), and each CTA
// holding every tile with the planes multicast over the cluster by TMA
// (no faster at the paper topology, slower at 768 wide).
//
// popcount_fire and popcount_mac (one kernel, popcount_fire_kernel, with
// an epilogue per output mode) run one tile on the tensor cores instead:
// the MAC term sum_j popc(s[b, j] & w[n, j]) is exactly what the b1
// product mma.sync m16n8k256 .and.popc computes (BMMA in SASS), 16 rows x 8
// neurons x 256 bits an instruction with an exact int32 sum.  The operands
// already lie in its fragment layouts: spikes [B, W] with a row's words
// contiguous are its row-major A, planes [N, W] with a neuron's words
// contiguous its column-major B, so nothing is staged, transposed or
// unpacked.  Its design:
//   * a warp owns 16 rows x 64 neurons (8 mma n-tiles); a block is
//     kFireWarps (2) warps stacked along the rows, the grid (row blocks,
//     64-neuron blocks; ops._fire_route), so every block reads only its
//     own rows and neurons.  1, 2 and 4 warps time the same, 8 slower;
//   * the K loop takes 8 words (256 bits, one mma a n-tile) a step.  Thread
//     (g, t) = (lane / 4, lane % 4) loads words 2t and 2t + 1 of the step
//     straight from device memory into its fragments (one 8-byte load each
//     when the layout allows: kPaired, 3-5 % faster than two 4-byte loads
//     at the paths' shapes), for rows g and g + 8 and for neuron
//     g of every n-tile; the step's K positions t and t + 4 take them, the
//     same in A and B, so the permutation cancels in the sum.  kInFlight
//     steps' loads are in flight at once;
//   * rows past B, neurons past N and words past W load as zero
//     (predicated), which adds nothing to an AND+popc sum; plane words are
//     ANDed in full, so nothing relies on their tail bits;
//   * a row's spike count popc(s) comes from the A words the quad already
//     holds (two popc a thread a step) and two quad shuffles, once per
//     warp tile, next to the product;
//   * the epilogue works on the accumulator fragments: kVmem writes V =
//     2 acc - popc(s); kFireInt8 one byte a neuron (V >= vth); kFirePacked
//     sets each thread's two neurons' bits of a row's LSB-first 32-neuron
//     word, ORs them over the quad (__shfl_xor_sync) and lets each lane of
//     the quad store one of its four words.
// On an H100 the b1 product issues 0.66 times a clock per SM, 21,744 bit
// pairs a clock per SM (probes/rate_probe.cu; PERF.md), so these tiles are
// bound by latency and launch, not by the MAC.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kMaxTiles = 16;
constexpr int kThreads = 256;
constexpr int kMaxCluster = 16;   // CTAs of a cascade cluster (8 portable)

// What popcount_fire_kernel's epilogue writes.
enum OutMode : int { kFireInt8 = 0, kFirePacked = 1, kVmem = 2 };

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

// ---- popcount_fire / popcount_mac ----------------------------------- //

constexpr int kTileRows = 16;       // rows of a warp's tile (the mma's m)
constexpr int kNTiles = 8;          // mma n-tiles (8 neurons) of a warp
constexpr int kTileNeurons = 8 * kNTiles;
constexpr int kStepWords = 8;       // input words of a K step (256 bits)
constexpr int kInFlight = 3;        // K steps whose loads are in flight
constexpr int kFireWarps = 2;       // warps of a block (ops._FIRE_WARPS)

// One K step's operands in one thread: A (a[0] / a[2]: row g's words 2t /
// 2t + 1; a[1] / a[3]: row g + 8's) and, per n-tile, B (neuron g's words).
struct StepFrag {
  uint32_t a[4];
  uint32_t b[kNTiles][2];
};

// Words j and j + 1 of a row, zero past w or for a row that is not real.
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

// Everything one thread reads: its two rows, its neuron of each n-tile.
struct TileOperands {
  const uint32_t* s0;   // row g
  const uint32_t* s1;   // row g + 8
  bool real0, real1;
  const uint32_t* w;    // neuron g of n-tile 0; of n-tile q: q wstep on
  long long wstep;      // 8 * ldw
  int n_real;           // N - (neuron g of n-tile 0): n-tile q's is real
                        // while 8 q < n_real
  int W;
};

template <bool kPaired>
__device__ __forceinline__ void load_step(StepFrag& f, const TileOperands& o,
                                          int step, int t, int nt) {
  const int j = step * kStepWords + 2 * t;
  const uint2 x0 = load_pair<kPaired>(o.s0, j, o.W, o.real0);
  const uint2 x1 = load_pair<kPaired>(o.s1, j, o.W, o.real1);
  f.a[0] = x0.x;
  f.a[2] = x0.y;
  f.a[1] = x1.x;
  f.a[3] = x1.y;
#pragma unroll
  for (int q = 0; q < kNTiles; ++q) {
    if (q < nt) {
      const uint2 y = load_pair<kPaired>(o.w + q * o.wstep, j, o.W,
                                         8 * q < o.n_real);
      f.b[q][0] = y.x;
      f.b[q][1] = y.y;
    }
  }
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

// One tile's MAC, then by out_mode the IF compare and the packed words
// (kFirePacked) or one int8 spike a neuron (kFireInt8), or the int32 V
// (kVmem: popcount_mac).  grid (row blocks, neuron blocks) covering
// (ceil(B / (16 kFireWarps)), ceil(N / 64)), blockDim kFireWarps * 32.
template <bool kPaired>
__global__ void __launch_bounds__(kFireWarps * 32)
popcount_fire_kernel(const uint32_t* __restrict__ packed, long long lds,
                     const uint32_t* __restrict__ planes, long long ldw,
                     const int32_t* __restrict__ vth, void* __restrict__ out,
                     int B, int N, int W, int out_mode) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long row0 =
      ((long long)blockIdx.x * kFireWarps + (threadIdx.x >> 5)) *
      kTileRows;
  if (row0 >= B) return;   // the whole warp: no real row
  const int n0 = blockIdx.y * kTileNeurons;
  const int nt = min(kNTiles, (N - n0 + 7) >> 3);   // n-tiles with neurons
  const long long r0 = row0 + g, r1 = r0 + 8;
  TileOperands o;
  o.real0 = r0 < B;
  o.real1 = r1 < B;
  o.s0 = packed + r0 * lds;
  o.s1 = packed + r1 * lds;
  o.w = planes + (long long)(n0 + g) * ldw;
  o.wstep = 8 * ldw;
  o.n_real = N - n0 - g;
  o.W = W;
  const int steps = (W + kStepWords - 1) / kStepWords;

  // the thresholds of the thread's neurons, loaded with the first steps so
  // that their latency does not follow the K loop
  int th[kNTiles][2] = {};
  if (out_mode != kVmem) {
#pragma unroll
    for (int q = 0; q < kNTiles; ++q) {
      const int n = n0 + 8 * q + 2 * t;
      if (q < nt && n < N) th[q][0] = __ldg(vth + n);
      if (q < nt && n + 1 < N) th[q][1] = __ldg(vth + n + 1);
    }
  }
  int acc[kNTiles][4] = {};
  int pc0 = 0, pc1 = 0;   // popc(s) of rows g and g + 8
  StepFrag f[kInFlight];
#pragma unroll
  for (int i = 0; i < kInFlight; ++i)
    if (i < steps) load_step<kPaired>(f[i], o, i, t, nt);
  for (int base = 0; base < steps; base += kInFlight) {
#pragma unroll
    for (int i = 0; i < kInFlight; ++i) {
      const int step = base + i;
      if (step < steps) {
        pc0 += __popc(f[i].a[0]) + __popc(f[i].a[2]);
        pc1 += __popc(f[i].a[1]) + __popc(f[i].a[3]);
#pragma unroll
        for (int q = 0; q < kNTiles; ++q)
          if (q < nt) mma_and_popc(acc[q], f[i].a, f[i].b[q]);
        if (step + kInFlight < steps)
          load_step<kPaired>(f[i], o, step + kInFlight, t, nt);
      }
    }
  }
  pc0 += __shfl_xor_sync(0xffffffffu, pc0, 1);
  pc0 += __shfl_xor_sync(0xffffffffu, pc0, 2);
  pc1 += __shfl_xor_sync(0xffffffffu, pc1, 1);
  pc1 += __shfl_xor_sync(0xffffffffu, pc1, 2);

  // acc[q][i] of n-tile q: row g (i 0, 1) or g + 8 (i 2, 3), neuron
  // n0 + 8 q + 2 t + (i & 1)
  const bool even = !(N & 1);
  if (out_mode == kVmem) {
    int32_t* o32 = static_cast<int32_t*>(out);
#pragma unroll
    for (int q = 0; q < kNTiles; ++q) {
      if (q >= nt) continue;
      const int n = n0 + 8 * q + 2 * t;
      store_two<int32_t, int2>(o32, r0, n, N, o.real0, even,
                               2 * acc[q][0] - pc0, 2 * acc[q][1] - pc0);
      store_two<int32_t, int2>(o32, r1, n, N, o.real1, even,
                               2 * acc[q][2] - pc1, 2 * acc[q][3] - pc1);
    }
    return;
  }
  uint32_t w00 = 0, w01 = 0, w10 = 0, w11 = 0;   // [row g / g+8][word 0 / 1]
#pragma unroll
  for (int q = 0; q < kNTiles; ++q) {
    if (q >= nt) continue;
    const int n = n0 + 8 * q + 2 * t;
    const bool f00 = 2 * acc[q][0] - pc0 >= th[q][0];
    const bool f01 = 2 * acc[q][1] - pc0 >= th[q][1];
    const bool f10 = 2 * acc[q][2] - pc1 >= th[q][0];
    const bool f11 = 2 * acc[q][3] - pc1 >= th[q][1];
    if (out_mode == kFireInt8) {
      int8_t* o8 = static_cast<int8_t*>(out);
      store_two<int8_t, char2>(o8, r0, n, N, o.real0, even, f00, f01);
      store_two<int8_t, char2>(o8, r1, n, N, o.real1, even, f10, f11);
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
  if ((t < 2 ? o.real0 : o.real1) && wi < (N >> 5))
    static_cast<uint32_t*>(out)[(t < 2 ? r0 : r1) * (N >> 5) + wi] = word;
}

// One launch of popcount_fire_kernel on a grid of (row_blocks,
// neuron_blocks) blocks, which must cover B rows and N neurons; returns
// cudaGetLastError().
int launch_tile(const void* packed, long long lds, const void* planes,
                long long ldw, const void* vth, void* out, int B, int N, int W,
                int row_blocks, int neuron_blocks, int paired, int out_mode,
                void* stream) {
  if (B < 1 || N < 1 || W < 1 || lds < 0 || ldw < 0 ||
      (long long)row_blocks * kFireWarps * kTileRows < B ||
      (long long)neuron_blocks * kTileNeurons < N ||
      (out_mode == kFirePacked && N % 32))
    return (int)cudaErrorInvalidValue;
  if (paired && (((lds | ldw | W) & 1) ||
                 ((reinterpret_cast<uintptr_t>(packed) |
                   reinterpret_cast<uintptr_t>(planes)) & 7)))
    return (int)cudaErrorInvalidValue;
  const auto kernel = paired ? popcount_fire_kernel<true>
                             : popcount_fire_kernel<false>;
  kernel<<<dim3((unsigned)row_blocks, (unsigned)neuron_blocks),
           kFireWarps * 32, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)packed, lds, (const uint32_t*)planes, ldw,
      (const int32_t*)vth, out, B, N, W, out_mode);
  return (int)cudaGetLastError();
}

// ---- mega_cascade ---------------------------------------------------- //

// One tile of the cascade, and the slice of it one CTA of a cluster owns.
// The tiles operand holds, per tile, per 32-neuron group, a block of
// (w + 1) x 32 words: row j < w is word j of the group's 32 weight planes
// (lane l: neuron 32 g + l), row w their thresholds.
struct CascadeTile {
  int n_out;             // real output width
  int w;                 // input words ceil(K / 32)
  int groups;            // 32-neuron groups, ceil(n_out / 32)
  int gpc;               // groups a CTA owns, ceil(groups / cluster)
  int blk;               // words of a group's block, (w + 1) * 32
  int wt_off;            // shared words before the CTA's blocks
  long long tiles_off;   // words before the tile's blocks in `tiles`
  long long fired_off;   // words before the tile's plane in `fired`
};

struct CascadeArgs {
  const uint32_t* packed;     // [B, tile[0].w]
  const uint32_t* tiles;      // the blocks of every tile, back to back
  int32_t* logits;            // [B, tile[n_tiles - 1].n_out]
  uint32_t* fired;            // hidden planes [B, n_out / 32], back to back
  int B, n_tiles;
  int cluster;                // CTAs of a cluster
  int rows;                   // batch rows of a slice
  int slices;                 // ceil(B / rows)
  int pw;                     // words of a row buffer (a multiple of 4)
  int row_off;                // shared words before the two row buffers
  int bar_off;                // shared words before the mbarriers (even)
  int smem_words;             // shared words of a CTA
  long long tiles_words;      // words of `tiles`
  CascadeTile tile[kMaxTiles];
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes the mbarrier inits visible to the cluster (before a cluster barrier).
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// This thread's arrival on `bar`, expecting `bytes` more of transactions.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device memory into this CTA's shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ unsigned cluster_ctarank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_id() {
  unsigned r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_count() {
  unsigned r;
  asm volatile("mov.u32 %0, %%nclusterid.x;\n" : "=r"(r));
  return r;
}

// barrier.cluster: arrive, relaxed (it orders no memory: the mbarrier inits
// before it are published by fence_mbar_init, a slice's reads by the block
// barrier before it), and wait (acquire, the default).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Store v at `local`'s offset in the shared memory of CTA `rank` of this
// cluster (distributed shared memory), completing 4 bytes of transactions
// on that CTA's mbarrier at `bar`'s offset.
__device__ __forceinline__ void st_async(uint32_t* local, uint64_t* bar,
                                         unsigned rank, uint32_t v) {
  unsigned addr, rbar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(addr)
               : "r"(smem_addr(local)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(rbar)
               : "r"(smem_addr(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "r"(v), "r"(rbar)
      : "memory");
}

// and_popc with the word count W fixed at compile time: the row's words `s`
// (16-byte aligned, a broadcast) in 128-bit loads, four partial sums.
template <int W>
__device__ __forceinline__ int and_popc_fixed(const uint32_t* s,
                                              const uint32_t* wt, int ld,
                                              int n) {
  static_assert(W % 4 == 0, "W must be a multiple of 4");
  int a0 = 0, a1 = 0, a2 = 0, a3 = 0;
#pragma unroll
  for (int j = 0; j < W; j += 4) {
    const uint4 sv = *reinterpret_cast<const uint4*>(s + j);
    a0 += __popc(sv.x & wt[(j + 0) * ld + n]);
    a1 += __popc(sv.y & wt[(j + 1) * ld + n]);
    a2 += __popc(sv.z & wt[(j + 2) * ld + n]);
    a3 += __popc(sv.w & wt[(j + 3) * ld + n]);
  }
  return (a0 + a1) + (a2 + a3);
}

// Whether the cascade's MAC takes a compile-time path at w words.
__host__ __device__ inline bool fixed_words(int w) { return w == 8 || w == 24; }

// One lane's MAC term over a group block's column `col` (stride 32).
__device__ __forceinline__ int cascade_mac(const uint32_t* s,
                                           const uint32_t* col, int w) {
  switch (w) {
    case 8:
      return and_popc_fixed<8>(s, col, 32, 0);
    case 24:
      return and_popc_fixed<24>(s, col, 32, 0);
    default:
      return and_popc(s, col, 32, 0, w);
  }
}

// sum_j popc(s[j]) over w words, in every lane; the whole warp calls it.
__device__ __forceinline__ int row_spikes(const uint32_t* s, int w, int lane) {
  int c = 0;
  for (int j = lane; j < w; j += 32) c += __popc(s[j]);
  return __reduce_add_sync(0xffffffffu, c);
}

// grid = clusters * cluster CTAs, clusters of `cluster` along x.  Cluster k
// carries slices k, k + clusters, ... (rows [slice * rows, ...)) through
// every tile; CTA c of it computes its groups of every tile for all the
// slice's rows and pushes the fired words to every CTA of the cluster.
//
// Row buffer b (tile t reads buffer t & 1) has an mbarrier that counts the
// bytes of fired words the cluster pushes into it (st.async), armed with
// the count two tiles ahead; so a tile waits for exactly its input words,
// and nothing else of the cluster.  No buffer is overwritten while read: a
// word for tile t + 1 needs every word of tile t, and each of those is
// pushed after its task read its row.  Slices part with a cluster barrier
// (the last tile pushes nothing, so nothing else orders them).
__global__ void __launch_bounds__(kThreads)
mega_cascade_kernel(const __grid_constant__ CascadeArgs a) {
  extern __shared__ __align__(16) uint32_t cascade_smem[];
  uint32_t* smem = cascade_smem;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int rank = (int)cluster_ctarank();
  const int n_clusters = (int)cluster_count();
  const int buf_words = a.rows * a.pw;
  uint32_t* bufs = smem + a.row_off;     // two [rows][pw] row buffers
  uint64_t* planes_bar = reinterpret_cast<uint64_t*>(smem + a.bar_off);
  uint64_t* full = planes_bar + a.n_tiles;   // [2], one a row buffer
  const int w0 = a.tile[0].w;

  if (tid == 0) {
    for (int t = 0; t < a.n_tiles + 2; ++t) mbar_init(planes_bar + t, 1);
    fence_mbar_init();
    // every tile's blocks at once, each tile on its own mbarrier: tile t
    // waits for its own words only
    for (int t = 0; t < a.n_tiles; ++t) {
      const CascadeTile& T = a.tile[t];
      const int g0 = rank * T.gpc;
      const int ng = max(0, min(T.gpc, T.groups - g0));
      const unsigned bytes = 4u * (unsigned)(ng * T.blk);
      mbar_expect(planes_bar + t, bytes);
      if (bytes)
        bulk_load(smem + T.wt_off,
                  a.tiles + T.tiles_off + (long long)g0 * T.blk, bytes,
                  planes_bar + t);
    }
  }
  __syncthreads();
  cluster_arrive_relaxed();   // this CTA runs and its mbarriers are set

  unsigned phase = 0;   // bit b: the parity row buffer b waits for next
  for (int slice = (int)cluster_id(); slice < a.slices;
       slice += n_clusters) {
    const long long row0 = (long long)slice * a.rows;
    const int rows = (int)min((long long)a.rows, (long long)a.B - row0);
    for (int i = tid; i < rows * w0; i += blockDim.x) {
      const int r = i / w0, j = i - r * w0;
      bufs[r * a.pw + j] = __ldg(a.packed + (row0 + r) * w0 + j);
    }
    __syncthreads();
    cluster_wait();   // every CTA of the cluster runs this slice now
    if (tid == 0)     // tiles 1 and 2 read words pushed by the cluster
      for (int t = 1; t < min(3, a.n_tiles); ++t)
        mbar_expect(full + (t & 1), 4u * rows * a.tile[t - 1].groups);
    for (int t = 0; t < a.n_tiles; ++t) {
      const CascadeTile& T = a.tile[t];
      const bool last = t + 1 == a.n_tiles;
      const int b = t & 1;
      const uint32_t* cur = bufs + b * buf_words;
      uint32_t* nxt = bufs + (b ^ 1) * buf_words;
      mbar_wait(planes_bar + t, 0);
      if (t > 0) {
        mbar_wait(full + b, (phase >> b) & 1);
        phase ^= 1u << b;
        if (tid == 0 && t + 2 < a.n_tiles)
          mbar_expect(full + b, 4u * rows * a.tile[t + 1].groups);
      }
      const int g0 = rank * T.gpc;
      const int ng = min(T.gpc, T.groups - g0);
      const uint32_t* wt = smem + T.wt_off;
      for (int task = warp; task < rows * ng; task += n_warps) {
        const int q = task / rows;
        const int r = task - q * rows;
        const uint32_t* s = cur + r * a.pw;
        const uint32_t* col = wt + q * T.blk + lane;
        const int grp = g0 + q;
        const int v = 2 * cascade_mac(s, col, T.w) - row_spikes(s, T.w, lane);
        const long long row = row0 + r;
        if (last) {
          const int n = (grp << 5) + lane;
          if (n < T.n_out) a.logits[row * T.n_out + n] = v;
        } else {
          const uint32_t word =
              __ballot_sync(0xffffffffu, v >= (int32_t)col[T.w * 32]);
          if (lane < a.cluster)
            st_async(nxt + r * a.pw + grp, full + (b ^ 1), lane, word);
          if (lane == 31) a.fired[T.fired_off + row * T.groups + grp] = word;
        }
      }
    }
    if (slice + n_clusters < a.slices) {   // done reading this slice
      __syncthreads();
      cluster_arrive_relaxed();
    }
  }
}

// Fills the cascade's layout; false on a shape the kernel cannot take.
bool cascade_layout(CascadeArgs& a, int B, int n_tiles, const int* n_out,
                    const int* w_words, int cluster, int rows) {
  if (n_tiles < 2 || n_tiles > kMaxTiles || cluster < 1 ||
      cluster > kMaxCluster || rows < 1 || B < 0)
    return false;
  a = CascadeArgs{};
  a.B = B;
  a.n_tiles = n_tiles;
  a.cluster = cluster;
  a.rows = rows;
  a.slices = (B + rows - 1) / rows;
  int off = 0, pw = 0;
  long long tiles = 0, fired = 0;
  for (int t = 0; t < n_tiles; ++t) {
    CascadeTile& T = a.tile[t];
    const bool hidden = t + 1 < n_tiles;
    if (n_out[t] < 1 || w_words[t] < 1 || (hidden && n_out[t] % 32) ||
        (t > 0 && w_words[t] != n_out[t - 1] / 32))
      return false;
    T.n_out = n_out[t];
    T.w = w_words[t];
    T.groups = (n_out[t] + 31) / 32;
    T.gpc = (T.groups + cluster - 1) / cluster;
    T.blk = (T.w + 1) * 32;
    T.wt_off = off;
    off += T.gpc * T.blk;
    T.tiles_off = tiles;
    tiles += (long long)T.groups * T.blk;
    T.fired_off = fired;
    if (hidden) fired += (long long)B * T.groups;
    if (T.w > pw) pw = T.w;
  }
  a.tiles_words = tiles;
  a.pw = (pw + 3) & ~3;
  a.row_off = off;   // a multiple of 32: every block is
  a.bar_off = a.row_off + 2 * rows * a.pw;
  a.smem_words = a.bar_off + 2 * (n_tiles + 2);
  return true;
}

// The kernel's attributes for a CTA of the layout's shared memory in
// clusters of `cluster`; then the launch configuration (attr must outlive
// cfg).
cudaError_t cascade_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr,
                           const CascadeArgs& a, int clusters,
                           cudaStream_t stream) {
  const size_t smem = 4 * (size_t)a.smem_words;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(mega_cascade_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err == cudaSuccess && a.cluster > 8)
    err = cudaFuncSetAttribute(mega_cascade_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3((unsigned)(clusters * a.cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)a.cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return err;
}

}  // namespace

extern "C" {

// Fired spikes of one tile: uint32[B, N/32] words when pack_out (N % 32 == 0)
// else int8[B, N], from packed uint32[B, W] (row stride lds words), planes
// uint32[N, W] (row stride ldw words) and vth int32[N], on a grid of
// (row_blocks, neuron_blocks) blocks of 16 kFireWarps rows x 64 neurons
// (ops._fire_route); `paired` for 8-byte operand loads (W, lds and ldw
// even, both operands 8-byte aligned).  Returns cudaGetLastError().
int cim_popcount_fire(const void* packed, long long lds, const void* planes,
                      long long ldw, const void* vth, void* out, int B, int N,
                      int W, int row_blocks, int neuron_blocks, int paired,
                      int pack_out, void* stream) {
  return launch_tile(packed, lds, planes, ldw, vth, out, B, N, W, row_blocks,
                     neuron_blocks, paired,
                     pack_out ? kFirePacked : kFireInt8, stream);
}

// V int32[B, N] from packed uint32[B, W] (row stride lds words) and planes
// uint32[N, W] (row stride ldw words): popcount_fire's kernel with the V
// epilogue, the grid and `paired` as there.  Returns cudaGetLastError().
int cim_popcount_mac(const void* packed, long long lds, const void* planes,
                     long long ldw, void* out, int B, int N, int W,
                     int row_blocks, int neuron_blocks, int paired,
                     void* stream) {
  return launch_tile(packed, lds, planes, ldw, nullptr, out, B, N, W,
                     row_blocks, neuron_blocks, paired, kVmem, stream);
}

// Dynamic shared memory one CTA of the mega cascade needs in clusters of
// `cluster` CTAs carrying `rows` batch rows; -1 on a shape it cannot take.
long long cim_mega_cascade_smem_bytes(int n_tiles, const int* n_out,
                                      const int* w_words, int cluster,
                                      int rows) {
  CascadeArgs a;
  if (!cascade_layout(a, 0, n_tiles, n_out, w_words, cluster, rows))
    return -1;
  return 4LL * a.smem_words;
}

// Clusters of the mega cascade that can be resident on the current device
// at once (cudaOccupancyMaxActiveClusters), or minus a CUDA error code.
int cim_mega_cascade_max_clusters(int n_tiles, const int* n_out,
                                  const int* w_words, int cluster, int rows) {
  CascadeArgs a;
  if (!cascade_layout(a, 0, n_tiles, n_out, w_words, cluster, rows))
    return -(int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cascade_config(cfg, attr, a, 1, 0);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&n, mega_cascade_kernel, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

// 1 where the cascade's MAC over w words is unrolled at compile time.
int cim_mega_cascade_fixed_words(int w) { return fixed_words(w) ? 1 : 0; }

// Whole cascade in one launch.  packed: uint32[B, w_words[0]]; tiles: per
// tile t, per 32-neuron group, (w_words[t] + 1) x 32 words (the group's
// weight planes transposed, then its thresholds), tiles_words in all;
// logits: int32[B, n_out[last]]; fired: the hidden planes uint32[B,
// n_out[t]/32] back to back.  `clusters` clusters of `cluster` CTAs walk
// the batch in slices of `rows` rows.  Returns the launch's error
// (cudaGetLastError()).
int cim_mega_cascade(const void* packed, int B, const void* tiles,
                     long long tiles_words, void* logits, void* fired,
                     int n_tiles, const int* n_out, const int* w_words,
                     int cluster, int rows, int clusters, void* stream) {
  CascadeArgs a;
  if (B < 1 || clusters < 1 ||
      !cascade_layout(a, B, n_tiles, n_out, w_words, cluster, rows) ||
      clusters > a.slices || tiles_words != a.tiles_words ||
      reinterpret_cast<uintptr_t>(tiles) % 16)
    return (int)cudaErrorInvalidValue;
  a.packed = static_cast<const uint32_t*>(packed);
  a.tiles = static_cast<const uint32_t*>(tiles);
  a.logits = static_cast<int32_t*>(logits);
  a.fired = static_cast<uint32_t*>(fired);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err =
      cascade_config(cfg, attr, a, clusters, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, mega_cascade_kernel, a);
  if (err != cudaSuccess) return (int)err;
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
