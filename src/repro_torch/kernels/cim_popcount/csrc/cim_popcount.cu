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
// 10,320 real weight words (~41 KB), plus 96 B of input.  The popc unit
// issues 16 results per clock per SM on compute capability 9.0 (CUDA C
// Programming Guide, arithmetic instruction throughput), a quarter of the
// AND/ADD rate, so popc throughput is the roofline: 0.32 us for a 128-row
// round on an NVIDIA H100 80GB HBM3 at its 1980 MHz maximum SM clock (700 W
// limit).  At a serving round's 128 rows the cascade is a chain instead:
// four tiles, each needing the last one's fired words, so latency sets its
// time (PERF.md has the measurements).
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
// popcount_fire is one tile of the same datapath as its own launch (the
// reference's `prefix` plan runs one per hidden tile): its planes staged
// transposed by every thread (stage_planes) and the same per-lane MAC, a
// block per (batch rows, 256 neurons) so a 4096-row batch spreads over the
// SMs.  popcount_mac is that kernel with an int32 V
// epilogue: one thread per output, reading both operands from global
// memory, was slower than cim_matmul_packed.cu's MAC, which the popcount
// plane must beat (the kernel bench's floor).  Weight staging keeps
// kStageLoads loads in flight per thread: one load at a time left the
// kernel waiting on memory for each staged word.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTiles = 16;
constexpr int kThreads = 256;
constexpr int kStageLoads = 8;    // weight loads in flight per thread
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
