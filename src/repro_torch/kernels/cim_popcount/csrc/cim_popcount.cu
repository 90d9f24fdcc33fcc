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
// (probes/rate_probe.cu), so popcount_fire and popcount_mac use it, and the
// cascade from 5 rows a slice.  At a serving round's 128 rows the cascade
// is a chain instead: four tiles, each needing the last one's fired words,
// so latency sets its time (PERF.md has the measurements).
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
//     so that a share is contiguous: per 32-neuron group, (w8 + 1) x 32
//     words (w8: w rounded up to 8), the group's planes transposed (row j:
//     word j of the 32 neurons, rotated by 8 (j / 2 mod 4) words so that
//     both MACs below read 32 banks), zero rows to w8, its thresholds;
//   * the MAC of a tile runs one of two ways, by the rows a slice:
//     - from 5 rows (ops._B1_MIN_ROWS) on the b1 tensor-core product: a
//       warp takes the slice's rows (up to 16, the mma's m; A fragments
//       from the row buffer, rows past the slice zero) x one group (4
//       n-tiles; B fragments from the staged block), one mma.sync a n-tile
//       and 256-bit step.  The fire bits of rows g and g + 8 come from the
//       accumulator fragments and two quad OR shuffles; lane t of quad g
//       pushes both rows' words to CTAs t, t + 4, .. of the cluster;
//     - below, on the popc unit: a warp computes 32 neighbouring neurons of
//       one row, each lane a neuron, and __ballot_sync of the fire
//       predicates is exactly the LSB-first packed word (lane i -> bit i);
//       lanes 0..C-1 push it to the CTAs of the cluster, lane 31 writes the
//       fired plane.  The common word counts (8 and 24, the paper
//       topology's) run unrolled at compile time with 128-bit loads of the
//       row's words; the others a run-time loop.  A row's spike count is
//       one popc a lane and a warp reduction;
//     each push goes into the next tile's row buffer of a CTA of the
//     cluster (distributed shared memory, st.async), completing 4 bytes on
//     that buffer's mbarrier there.  A tile waits for exactly its input
//     words, not for a cluster barrier.
// The launcher (ops._cascade_route) picks C = 2, or 1 for one group a tile,
// doubled while a CTA's share does not fit shared memory, rows from the
// batch (up to 16) and the MAC from the rows.  PERF.md has the measurements
// behind that (the popc unit wins at a serving round's 2 rows a slice and
// at 4, the b1 product from 5), and behind what was
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
//   * the epilogue (tile_epilogue in mma.cuh, shared with the packed tile
//     of kernels/cim_matmul_packed) works on the accumulator fragments:
//     kVmem writes V = 2 acc - popc(s); kFireInt8 one byte a neuron (V >=
//     vth); kFirePacked sets each thread's two neurons' bits of a row's
//     LSB-first 32-neuron word, ORs them over the quad (__shfl_xor_sync)
//     and lets each lane of the quad store one of its four words.
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
// The cascade's MAC: a lane a neuron on the popc unit, or a warp a task on
// the b1 tensor-core product (ops._cascade_route picks it from the rows).
enum CascadeMac : int { kMacPopc = 0, kMacB1 = 1 };
constexpr int kB1MaxRows = 16;    // rows of a b1 task: the mma's m

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

  tile_epilogue<kNTiles>(acc, pc0, pc1, th, out, out_mode, r0, o.real0,
                         o.real1, n0, nt, N, t);
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
// (w8 + 1) x 32 words, w8 = w rounded up to 8: row j < w is word j of the
// group's 32 weight planes, neuron n in column block_col(j, n); rows w..w8-1
// are zero; row w8 holds the thresholds (lane l: neuron 32 g + l).
struct CascadeTile {
  int n_out;             // real output width
  int w;                 // input words ceil(K / 32)
  int w8;                // w rounded up to 8 (256-bit product steps)
  int groups;            // 32-neuron groups, ceil(n_out / 32)
  int gpc;               // groups a CTA owns, ceil(groups / cluster)
  int blk;               // words of a group's block, (w8 + 1) * 32
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
  int mac;                    // kMacPopc or kMacB1
  int pw;                     // words of a buffer row: 8 or 24 mod 32
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

// Column of neuron n in row j of a group block: the rows' 32 words are
// rotated by 8 (j / 2 mod 4), so that a lane a neuron (the popc MAC) and the
// b1 product's B fragments (rows 2t, 2t + 1 of a step in quad lane t) both
// read 32 different banks.
__device__ __forceinline__ int block_col(int j, int n) {
  return n ^ (8 * ((j >> 1) & 3));
}

// One lane's MAC term sum_j popc(s[j] & plane_n[j]) over a group block
// `blk`, with the word count W fixed at compile time: the row's words `s`
// (16-byte aligned, a broadcast) in 128-bit loads, four partial sums.
template <int W>
__device__ __forceinline__ int and_popc_fixed(const uint32_t* s,
                                              const uint32_t* blk, int n) {
  static_assert(W % 4 == 0, "W must be a multiple of 4");
  const uint32_t* col[4] = {blk + n, blk + (n ^ 8), blk + (n ^ 16),
                            blk + (n ^ 24)};
  int a0 = 0, a1 = 0, a2 = 0, a3 = 0;
#pragma unroll
  for (int j = 0; j < W; j += 4) {
    const uint4 sv = *reinterpret_cast<const uint4*>(s + j);
    a0 += __popc(sv.x & col[(j >> 1) & 3][(j + 0) * 32]);
    a1 += __popc(sv.y & col[(j >> 1) & 3][(j + 1) * 32]);
    a2 += __popc(sv.z & col[((j + 2) >> 1) & 3][(j + 2) * 32]);
    a3 += __popc(sv.w & col[((j + 2) >> 1) & 3][(j + 3) * 32]);
  }
  return (a0 + a1) + (a2 + a3);
}

// Whether the cascade's popc MAC takes a compile-time path at w words.
__host__ __device__ inline bool fixed_words(int w) { return w == 8 || w == 24; }

// One lane's popc MAC term for neuron n of a group block over w words.
__device__ __forceinline__ int cascade_mac(const uint32_t* s,
                                           const uint32_t* blk, int n,
                                           int w) {
  switch (w) {
    case 8:
      return and_popc_fixed<8>(s, blk, n);
    case 24:
      return and_popc_fixed<24>(s, blk, n);
    default: {
      int acc = 0;
#pragma unroll 4
      for (int j = 0; j < w; ++j)
        acc += __popc(s[j] & blk[j * 32 + block_col(j, n)]);
      return acc;
    }
  }
}

// sum_j popc(s[j]) over w words, in every lane; the whole warp calls it.
__device__ __forceinline__ int row_spikes(const uint32_t* s, int w, int lane) {
  int c = 0;
  for (int j = lane; j < w; j += 32) c += __popc(s[j]);
  return __reduce_add_sync(0xffffffffu, c);
}

// Words j and j + 1 of a row buffer row, zero past w or for a row that is
// not in the slice (rows are 8-byte aligned, j even).
__device__ __forceinline__ uint2 row_pair(const uint32_t* s, int j, int w,
                                          bool real) {
  uint2 v = make_uint2(0u, 0u);
  if (real && j < w) {
    if (j + 1 < w)
      v = *reinterpret_cast<const uint2*>(s + j);
    else
      v.x = s[j];
  }
  return v;
}

// The b1 MAC of one task: the slice's rows (at most 16; A from the row
// buffer `cur`, row stride pw) x one group block (4 mma n-tiles of B from
// the staged planes), in thread (g, t).  acc[q][i]: n-tile q, row g (i 0, 1)
// or g + 8 (i 2, 3), neuron 8 q + 2 t + (i & 1) of the group; pc0 / pc1 the
// two rows' spike counts, summed over the quad.
__device__ __forceinline__ void cascade_b1(const uint32_t* cur, int pw,
                                           int rows, const uint32_t* blk,
                                           int w, int w8, int g, int t,
                                           int (&acc)[4][4], int& pc0,
                                           int& pc1) {
  const bool real0 = g < rows, real1 = g + 8 < rows;
  const uint32_t* s0 = cur + g * pw;
  const uint32_t* s1 = cur + (g + 8) * pw;
  // rows 2t and 2t + 1 of a step are rotated by 8 t: neuron 8 q + g of them
  // sits in column 8 (q ^ t) + g
  const uint32_t* b = blk + 64 * t + g;
  pc0 = pc1 = 0;
#pragma unroll 3
  for (int j0 = 0; j0 < w8; j0 += 8) {
    const int j = j0 + 2 * t;
    const uint2 x0 = row_pair(s0, j, w, real0);
    const uint2 x1 = row_pair(s1, j, w, real1);
    const uint32_t a[4] = {x0.x, x1.x, x0.y, x1.y};
    pc0 += __popc(x0.x) + __popc(x0.y);
    pc1 += __popc(x1.x) + __popc(x1.y);
    const uint32_t* bs = b + 32 * j0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = 8 * (q ^ t);
      const uint32_t bq[2] = {bs[c], bs[32 + c]};
      mma_and_popc(acc[q], a, bq);
    }
  }
  pc0 += __shfl_xor_sync(0xffffffffu, pc0, 1);
  pc0 += __shfl_xor_sync(0xffffffffu, pc0, 2);
  pc1 += __shfl_xor_sync(0xffffffffu, pc1, 1);
  pc1 += __shfl_xor_sync(0xffffffffu, pc1, 2);
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
// kB1: the MAC on the b1 product (a.mac == kMacB1), else on the popc unit;
// two instantiations, so that the popc one keeps its own small register
// footprint.
template <bool kB1>
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
      if (kB1) {
        // a task: the slice's rows x one group, on the tensor cores
        const int g = lane >> 2, lt = lane & 3;   // quad g, lane lt
        for (int q = warp; q < ng; q += n_warps) {
          const uint32_t* blk = wt + q * T.blk;
          const int grp = g0 + q;
          int acc[4][4] = {};
          int pc0, pc1;
          cascade_b1(cur, a.pw, rows, blk, T.w, T.w8, g, lt, acc, pc0, pc1);
          const bool real0 = g < rows, real1 = g + 8 < rows;
          if (last) {
#pragma unroll
            for (int qq = 0; qq < 4; ++qq) {
              const int n = (grp << 5) + 8 * qq + 2 * lt;
              int32_t* l0 = a.logits + (row0 + g) * T.n_out + n;
              int32_t* l1 = l0 + 8LL * T.n_out;
              if (real0 && n < T.n_out) l0[0] = 2 * acc[qq][0] - pc0;
              if (real0 && n + 1 < T.n_out) l0[1] = 2 * acc[qq][1] - pc0;
              if (real1 && n < T.n_out) l1[0] = 2 * acc[qq][2] - pc1;
              if (real1 && n + 1 < T.n_out) l1[1] = 2 * acc[qq][3] - pc1;
            }
            continue;
          }
          // the fired bits of rows g and g + 8, LSB-first, ORed over the
          // quad: then every lane of quad g holds both rows' words
          const uint32_t* th = blk + T.w8 * 32;
          uint32_t w0 = 0u, w1 = 0u;
#pragma unroll
          for (int qq = 0; qq < 4; ++qq) {
            const int p = 8 * qq + 2 * lt;
            const int th0 = (int32_t)th[p], th1 = (int32_t)th[p + 1];
            w0 |= (uint32_t)(2 * acc[qq][0] - pc0 >= th0) << p |
                  (uint32_t)(2 * acc[qq][1] - pc0 >= th1) << (p + 1);
            w1 |= (uint32_t)(2 * acc[qq][2] - pc1 >= th0) << p |
                  (uint32_t)(2 * acc[qq][3] - pc1 >= th1) << (p + 1);
          }
#pragma unroll
          for (int m = 1; m <= 2; m <<= 1) {
            w0 |= __shfl_xor_sync(0xffffffffu, w0, m);
            w1 |= __shfl_xor_sync(0xffffffffu, w1, m);
          }
          // lane lt of the quad pushes both rows' words to CTAs lt, lt + 4, ..
          for (int c = lt; c < a.cluster; c += 4) {
            if (real0)
              st_async(nxt + g * a.pw + grp, full + (b ^ 1), c, w0);
            if (real1)
              st_async(nxt + (g + 8) * a.pw + grp, full + (b ^ 1), c, w1);
          }
          uint32_t* fired = a.fired + T.fired_off + grp;
          if (lt == 0 && real0) fired[(row0 + g) * T.groups] = w0;
          if (lt == 1 && real1) fired[(row0 + g + 8) * T.groups] = w1;
        }
        continue;
      }
      for (int task = warp; task < rows * ng; task += n_warps) {
        const int q = task / rows;
        const int r = task - q * rows;
        const uint32_t* s = cur + r * a.pw;
        const uint32_t* blk = wt + q * T.blk;
        const int grp = g0 + q;
        const int v = 2 * cascade_mac(s, blk, lane, T.w) -
                      row_spikes(s, T.w, lane);
        const long long row = row0 + r;
        if (last) {
          const int n = (grp << 5) + lane;
          if (n < T.n_out) a.logits[row * T.n_out + n] = v;
        } else {
          const uint32_t word = __ballot_sync(
              0xffffffffu, v >= (int32_t)blk[T.w8 * 32 + lane]);
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
                    const int* w_words, int cluster, int rows, int mac) {
  if (n_tiles < 2 || n_tiles > kMaxTiles || cluster < 1 ||
      cluster > kMaxCluster || rows < 1 || B < 0 ||
      (mac != kMacPopc && mac != kMacB1) ||
      (mac == kMacB1 && rows > kB1MaxRows))
    return false;
  a = CascadeArgs{};
  a.B = B;
  a.n_tiles = n_tiles;
  a.cluster = cluster;
  a.rows = rows;
  a.mac = mac;
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
    T.w8 = (T.w + 7) & ~7;
    T.groups = (n_out[t] + 31) / 32;
    T.gpc = (T.groups + cluster - 1) / cluster;
    T.blk = (T.w8 + 1) * 32;
    T.wt_off = off;
    off += T.gpc * T.blk;
    T.tiles_off = tiles;
    tiles += (long long)T.groups * T.blk;
    T.fired_off = fired;
    if (hidden) fired += (long long)B * T.groups;
    if (T.w > pw) pw = T.w;
  }
  a.tiles_words = tiles;
  // 8 or 24 mod 32: the b1 MAC's half warps (rows g 0..3, words 2t, 2t + 1)
  // read 32 banks; a multiple of 4 for the popc MAC's 128-bit loads
  a.pw = (pw + 7) & ~7;
  if (a.pw % 16 == 0) a.pw += 8;
  a.row_off = off;   // a multiple of 32: every block is
  a.bar_off = a.row_off + 2 * rows * a.pw;
  a.smem_words = a.bar_off + 2 * (n_tiles + 2);
  return true;
}

// The instantiation of the layout's MAC.
void (*cascade_kernel(const CascadeArgs& a))(CascadeArgs) {
  return a.mac == kMacB1 ? mega_cascade_kernel<true>
                         : mega_cascade_kernel<false>;
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
    err = cudaFuncSetAttribute(cascade_kernel(a),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err == cudaSuccess && a.cluster > 8)
    err = cudaFuncSetAttribute(cascade_kernel(a),
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
  if (!cascade_layout(a, 0, n_tiles, n_out, w_words, cluster, rows, kMacPopc))
    return -1;
  return 4LL * a.smem_words;
}

// Clusters of the mega cascade that can be resident on the current device
// at once (cudaOccupancyMaxActiveClusters) with the MAC `mac`, or minus a
// CUDA error code.
int cim_mega_cascade_max_clusters(int n_tiles, const int* n_out,
                                  const int* w_words, int cluster, int rows,
                                  int mac) {
  CascadeArgs a;
  if (!cascade_layout(a, 0, n_tiles, n_out, w_words, cluster, rows, mac))
    return -(int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cascade_config(cfg, attr, a, 1, 0);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&n, cascade_kernel(a), &cfg);
  return err == cudaSuccess ? n : -(int)err;
}

// 1 where the cascade's popc MAC over w words is unrolled at compile time.
int cim_mega_cascade_fixed_words(int w) { return fixed_words(w) ? 1 : 0; }

// Whole cascade in one launch.  packed: uint32[B, w_words[0]]; tiles: per
// tile t, per 32-neuron group, (w8 + 1) x 32 words (w8 = w_words[t] rounded
// up to 8: the group's weight planes transposed and rotated, zero rows,
// then its thresholds; ops.cascade_tiles), tiles_words in all; logits:
// int32[B, n_out[last]]; fired: the hidden planes uint32[B, n_out[t]/32]
// back to back.  `clusters` clusters of `cluster` CTAs walk the batch in
// slices of `rows` rows; `mac` 0 runs the MAC on the popc unit, 1 on the
// b1 tensor-core product (rows <= 16).  Returns the launch's error
// (cudaGetLastError()).
int cim_mega_cascade(const void* packed, int B, const void* tiles,
                     long long tiles_words, void* logits, void* fired,
                     int n_tiles, const int* n_out, const int* w_words,
                     int cluster, int rows, int clusters, int mac,
                     void* stream) {
  CascadeArgs a;
  if (B < 1 || clusters < 1 ||
      !cascade_layout(a, B, n_tiles, n_out, w_words, cluster, rows, mac) ||
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
  err = cudaLaunchKernelEx(&cfg, cascade_kernel(a), a);
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
