// The LIF step (leak, integrate, fire, reset, refractory) for NVIDIA Hopper
// (sm_90a), as one step (lif_step) and as the event round's whole T-step
// loop (temporal_scan).
//
// Replaces the Pallas TPU kernels of the JAX reference
//   lif_step       <- src/repro/kernels/lif_step/kernel.py:38 _lif_kernel
//   temporal_scan  <- the same kernel inside the jitted lax.scan of
//                     src/repro/core/esam/temporal.py:170-208, with the
//                     per-step hidden-tile MACs of
//                     src/repro/kernels/cim_popcount/kernel.py:54
//                     popcount_mac_kernel
//
// Per element of a tile's [B, N] membrane array, with decay =
// float32(1 - leak) rounded on the host:
//
//     v       = fma(vmem, decay, (float)contrib)      one rounding
//     fired   = v >= (float)vth[n] && refrac == 0
//     vmem'   = fired ? (subtract ? v - th : 0) : v
//     refrac' = fired ? refractory : max(refrac - 1, 0)
//
// The multiply-add is written as __fmaf_rn on purpose: the reference's
// jitted temporal plan contracts `vmem * (1 - leak) + contrib` into one FMA,
// and the intrinsic makes that single rounding explicit instead of leaving
// it to nvcc's default contraction (-fmad=true), which a flag or a code
// change could silently turn into two roundings.  Threshold and contribution
// convert to float with round-to-nearest, as `astype(float32)` does.
//
// lif_step bound: elementwise, 3 reads and 3 writes per element (vmem,
// contrib, refrac in; spikes, vmem', refrac' out; 21 bytes) plus the [N]
// thresholds.  At the event path's round of [64, 256] that is 0.34 MB,
// about 0.1 us at the card's memory rate, so the kernel is launch-bound by
// nature; it is one grid-stride pass with coalesced 4-byte accesses.
//
// temporal_scan runs every step after tile 0's MAC (which depends on the
// events alone and stays one popcount_mac launch before it):
//
//   for t in 0..T-1:
//     contrib = c_in[t]
//     for each hidden tile i:  the LIF step above on its membranes;
//                              words = pack(fired), LSB-first, 32 a word;
//                              contrib = 2 sum_j popc(words[j] & plane[n][j])
//                                        - sum_j popc(words[j])
//     out_v = fma(out_v, decay, (float)contrib)   the readout never fires
//
// Bound: a strict chain per stream (step t+1 needs step t's membranes, tile
// i+1 needs tile i's spikes), and no stream waits on another.  The work is
// small: at the paper topology (768:256:256:256:10), T = 16 and B = 64,
// 16 x 64 x 4,176 AND+popc word pairs (~4.3 M popc, ~1 us at the card's
// popc rate, ~0.02 us at the b1 tensor-core product's) and 1 MB of c_in
// (~0.3 us).  The time is the chain's: a step of a tile is ~25 dependent
// operations of 30-45 clocks each (a shared load, a product, a shuffle,
// an mbarrier test; probes/scan_link_probe.py), so the design shortens the
// chain and runs the tiles side by side.
//
// The register route (scan_regs_kernel; up to kRegMaxHidden hidden tiles
// of up to 256 kS neurons, kS fixed at compile time: 1, or 2 at up to two
// tiles):
//
// * A thread-block cluster pipelines a group of kR streams (kScanRows, 8;
//   the template takes 16 too) through the network: CTA h runs hidden
//   tile h for every step, CTA k the readout, so the tiles of different
//   steps run at once on k + 1 SMs, and a launch takes T + k step times,
//   not T (k + 1) links.  The
//   streams are the M rows of the b1 tensor-core product
//   mma.sync.m16n8k256.and.popc (mma.cuh), 16 streams x 8 neurons an
//   instruction; with 8 streams rows 8-15 are zero rows, and rows past B
//   are zero rows too and are never stored.
// * The hand-off between tiles is distributed shared memory: a step's
//   words go into the next CTA's slot by st.async, completing bytes on
//   its `full` mbarrier; once a warp's lanes have read the slot
//   (__syncwarp), lane 0 frees it with a remote release arrive (CUTLASS's
//   ClusterBarrier consumer release) on the producer's `empty` mbarrier,
//   and the producer waits for that (acquire, cluster scope; once every
//   four steps, for the last of the next four slots) before refilling
//   one: kLink slots a link, no block or cluster barrier a step.  A slot
//   interleaves rows g and g + 8, so one 16-byte load is a thread's A
//   fragment of a K step.
// * Each of a CTA's kWT compute warps owns 8 kS / kWT groups of 32 neurons
//   of its tile.  The LIF step runs on the accumulator fragment where the
//   product leaves it: thread (g, t) owns streams g (and g + 8) and
//   neurons 2t and 2t + 1 of each of its column tiles, and holds their
//   membranes, refractory counters (dropped at compile time when
//   refractory is 0), thresholds (as float; +inf past the width, so
//   padded neurons never fire) and the B fragments of their planes in
//   registers for all T steps.  Nothing of the state touches memory.
// * V = 2 acc - popc(s) stays exact: popc(s) is one more product, against
//   all-ones planes, which leaves each stream's spike count in every lane
//   (no shuffles); V, at most 2^11 in magnitude, converts to float by the
//   exact 1.5 * 2^23 bias.  The fire is an all-ones mask (set.ge) that
//   resets the membrane and sets the bit without a branch; two xor
//   shuffles OR a word over the quad.  Words past a tile's width are zero,
//   as the wire format has them; the planes' words past it load as zero.
// * Tile 0's c_in: CTA 0's spare warp copies each step's rows of the
//   cluster into a ring of kRing steps, one bulk (TMA) copy completing on
//   an mbarrier, as far ahead as the ring allows; c_in comes 16-byte
//   aligned with rows of whole 16-byte chunks (the wrapper sees to it).
// * Telemetry off the chain: the spare warp of the CTA that consumes tile
//   h's words stores them and their row-group loads from its slot; the
//   readout's CTA does the last tile's.
// * A protocol fault traps (after ~2^33 clocks in one wait) instead of
//   hanging the card.

// The shared-memory route (temporal_scan_kernel; any width and up to
// kMaxHidden hidden tiles; the wrapper takes it past the register route):
//
// * One block per stream, one thread per neuron of the widest tile (256 at
//   the paper topology, at most 1024; past that a thread takes every
//   1024th neuron).  Thread j owns neurons j, j + tps, ... of every tile,
//   so a tile's MAC output n and the LIF step of neuron n run in one thread
//   and nothing but spikes crosses threads.
// * The membranes and refractory counters of every hidden tile and the
//   readout's membrane live in shared memory for all T steps, zeroed in the
//   kernel; they never touch device memory.
// * Any hidden width: a tile's words are ceil(n / 32), and the lanes of its
//   last warp past n are neurons that never fire and hold no state, so the
//   tail bits of its words are zero, as the wire format has them.  At most
//   kMaxHidden hidden tiles a launch; the wrapper runs a deeper stack as
//   consecutive launches.
// * __ballot_sync of the fired flags IS the packed wire word: bit l of the
//   ballot of the warp holding neurons 32m..32m+31 is neuron 32m + l, the
//   LSB-first layout.  Lane 0 stores it to a word ring in shared memory
//   (two slots, by step parity, so one barrier per tile suffices), and the
//   block barrier hands the words to the next tile's MAC.
// * A link's spike count (the MAC's "- sum_j popc(words[j])") is one popc
//   a lane and one __reduce_add_sync a warp, so nearly all the popcs a link
//   issues (16 a clock per SM) are the MAC's own n_next x w_in.
// * The collected words and the loads (__popc sums of 4 words) are written
//   from the ring after the readout, one (tile, kind) job a warp from warp
//   1 on, beside the readout on warp 0.
// * The weight planes of tiles 1..k are staged into shared memory with
//   cp.async, rows at an odd stride so that the 32 lanes of a
//   warp, reading rows n..n+31 at one word, hit 32 banks.  Planes past the
//   opt-in shared memory are read from device memory through the read-only
//   path (kPlanesSmem = false); state past it lives in a device-memory
//   scratch (kStateSmem = false).  No shape is refused for its size.
// * c_in[t + 1] is copied (cp.async) into the other of two shared slots
//   while step t computes; each thread copies and reads only its own
//   neurons, so its own wait_group orders them.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kThreads = 256;

template <bool kSubtract>
__global__ void __launch_bounds__(kThreads)
lif_step_kernel(const float* __restrict__ vmem,
                const int32_t* __restrict__ contrib,
                const int32_t* __restrict__ vth,
                const int32_t* __restrict__ refrac,
                int8_t* __restrict__ spikes, float* __restrict__ vmem_out,
                int32_t* __restrict__ refrac_out, long long total, int n,
                float decay, int refractory) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const float th = __int2float_rn(__ldg(vth + (int)(i % n)));
    const float v = __fmaf_rn(vmem[i], decay, __int2float_rn(contrib[i]));
    const int32_t r = refrac[i];
    const bool fired = (v >= th) && (r == 0);
    float v_next = v;
    if (fired) v_next = kSubtract ? __fsub_rn(v, th) : 0.0f;
    spikes[i] = fired ? 1 : 0;
    vmem_out[i] = v_next;
    refrac_out[i] = fired ? refractory : (r > 0 ? r - 1 : 0);
  }
}


// ---- temporal_scan -------------------------------------------------- //

constexpr int kMaxHidden = 32;        // hidden tiles a scan takes
constexpr int kScanMaxThreads = 1024;

// One hidden tile and the planes of the tile it feeds.
struct ScanLayer {
  const uint32_t* plane;   // [n_next, w] weight planes (device memory)
  const int32_t* vth;      // [n] thresholds
  int32_t* words;          // [T, B, w] collected spike words, or null
  int32_t* loads;          // [T, B, w / 4] row-group loads, or null
  int n, w, n_next;        // width, words ceil(n / 32), the next width
  int stride;              // row stride of the staged planes (odd)
  int plane_off;           // words before these planes in shared memory
  int state_off;           // neurons before this tile in the state arrays
  int words_off;           // words before this tile in a word-ring slot
};

struct ScanArgs {
  const int32_t* c_in;     // [T, B, n_first]: tile 0's MAC, per step
  float* out_v;            // [B, n_cls]
  float* scratch;          // [B, 2 sum_n + n_cls] when !kStateSmem
  int T, B, k, n_first, n_cls;
  int sum_n, sum_w;        // hidden neurons and words of one stream
  int plane_words;         // shared words the staged planes take
  float decay;
  int refractory;
  ScanLayer layer[kMaxHidden];
};

// 32-bit words of shared memory a stream's state and words take.
__host__ __device__ inline int scan_stream_words(int sum_n, int n_cls,
                                                 int n_first, int sum_w,
                                                 bool state_smem) {
  return state_smem ? 2 * sum_n + n_cls + 2 * n_first + 2 * sum_w
                    : 2 * sum_w;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// 2 sum_j popc(words[j] & row[j]) - tot: one output of the exact MAC.
template <bool kPlanesSmem>
__device__ __forceinline__ int row_mac(const uint32_t* words,
                                       const uint32_t* row, int w, int tot) {
  int acc = 0;
#pragma unroll 8
  for (int j = 0; j < w; ++j)
    acc += __popc(words[j] & (kPlanesSmem ? row[j] : __ldg(row + j)));
  return 2 * acc - tot;
}

// sum_j popc(words[j]) over w words, in every lane; the whole warp calls it.
__device__ __forceinline__ int spike_count(const uint32_t* words, int w,
                                           int lane) {
  int c = 0;
  for (int j = lane; j < w; j += 32) c += __popc(words[j]);
  return __reduce_add_sync(0xffffffffu, c);
}

template <bool kSubtract, bool kPlanesSmem, bool kStateSmem>
__global__ void __launch_bounds__(kScanMaxThreads)
temporal_scan_kernel(const __grid_constant__ ScanArgs a) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int k = a.k;
  const int tps = blockDim.x;      // threads of this block's stream
  const int tid = threadIdx.x;
  const int b = blockIdx.x;        // the stream

  // every plane, once
  if (kPlanesSmem) {
    for (int h = 0; h < k; ++h) {
      const ScanLayer& L = a.layer[h];
      const int total = L.n_next * L.w;
      for (int e = tid; e < total; e += tps) {
        const int row = e / L.w;
        cp_async4(smem + L.plane_off + row * L.stride + (e - row * L.w),
                  L.plane + e);
      }
    }
  }
  uint32_t* mine = smem + a.plane_words;
  float* vm;
  int32_t* rf;
  float* ov;
  int32_t* cb = nullptr;   // two slots of c_in rows (kStateSmem)
  uint32_t* wd;            // two slots of every hidden tile's words
  if (kStateSmem) {
    vm = reinterpret_cast<float*>(mine);
    rf = reinterpret_cast<int32_t*>(mine + a.sum_n);
    ov = reinterpret_cast<float*>(mine + 2 * a.sum_n);
    cb = reinterpret_cast<int32_t*>(mine + 2 * a.sum_n + a.n_cls);
    wd = mine + 2 * a.sum_n + a.n_cls + 2 * a.n_first;
  } else {
    float* st = a.scratch + (size_t)b * (2 * a.sum_n + a.n_cls);
    vm = st;
    rf = reinterpret_cast<int32_t*>(st + a.sum_n);
    ov = st + 2 * a.sum_n;
    wd = mine;
  }
  const size_t step_stride = (size_t)a.B * a.n_first;
  const int32_t* crow = a.c_in + (size_t)b * a.n_first;
  for (int n = tid; n < a.sum_n; n += tps) {
    vm[n] = 0.0f;
    rf[n] = 0;
  }
  for (int n = tid; n < a.n_cls; n += tps) ov[n] = 0.0f;
  if (kStateSmem)
    for (int n = tid; n < a.n_first; n += tps) cp_async4(cb + n, crow + n);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();         // the planes are in, the state is zero

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = tps >> 5;
  for (int t = 0; t < a.T; ++t) {
    const int slot = t & 1;
    const int32_t* cur = kStateSmem ? cb + slot * a.n_first : nullptr;
    const int32_t* cg = crow + (size_t)t * step_stride;
    if (kStateSmem) {
      if (t + 1 < a.T) {
        int32_t* nxt = cb + (slot ^ 1) * a.n_first;
        for (int n = tid; n < a.n_first; n += tps)
          cp_async4(nxt + n, cg + step_stride + n);
      }
      cp_async_commit();
      cp_async_wait<1>();  // this step's row is in (this thread's part)
    }
    if (k == 0) {          // a one-tile network: the readout alone
      for (int n = tid; n < a.n_cls; n += tps) {
        const int32_t c = kStateSmem ? cur[n] : __ldg(cg + n);
        ov[n] = __fmaf_rn(ov[n], a.decay, __int2float_rn(c));
      }
      continue;
    }
    uint32_t* ring = wd + slot * a.sum_w;
    for (int h = 0; h < k; ++h) {
      const ScanLayer& L = a.layer[h];
      const uint32_t* win = nullptr;
      const uint32_t* pl = nullptr;
      int w_in = 0, s_in = 0, tot = 0;
      if (h > 0) {
        const ScanLayer& P = a.layer[h - 1];
        win = ring + P.words_off;
        w_in = P.w;
        pl = kPlanesSmem ? smem + P.plane_off : P.plane;
        s_in = kPlanesSmem ? P.stride : P.w;
        tot = spike_count(win, w_in, lane);
      }
      float* v_h = vm + L.state_off;
      int32_t* r_h = rf + L.state_off;
      uint32_t* wout = ring + L.words_off;
      // warp-uniform: base is 32-aligned, so every lane of a warp takes
      // part; lanes past the tile's width are neurons that never fire
      for (int base = warp * 32; base < L.n; base += tps) {
        const int n = base + lane;
        bool fired = false;
        if (n < L.n) {
          // the state and threshold first: their loads run under the MAC
          const float vmem = v_h[n];
          const int32_t r = r_h[n];
          const float th = __int2float_rn(__ldg(L.vth + n));
          const int32_t c =
              h > 0
                  ? row_mac<kPlanesSmem>(win, pl + (size_t)n * s_in, w_in, tot)
                  : (kStateSmem ? cur[n] : __ldg(cg + n));
          const float v = __fmaf_rn(vmem, a.decay, __int2float_rn(c));
          fired = (v >= th) && (r == 0);
          v_h[n] = fired ? (kSubtract ? __fsub_rn(v, th) : 0.0f) : v;
          r_h[n] = fired ? a.refractory : (r > 0 ? r - 1 : 0);
        }
        const uint32_t word = __ballot_sync(0xffffffffu, fired);
        if (lane == 0) wout[base >> 5] = word;
      }
      __syncthreads();     // this tile's words are complete
    }
    const ScanLayer& P = a.layer[k - 1];   // the readout: leaks, never fires
    const uint32_t* win = ring + P.words_off;
    const uint32_t* pl = kPlanesSmem ? smem + P.plane_off : P.plane;
    const int s_in = kPlanesSmem ? P.stride : P.w;
    const int tot = spike_count(win, P.w, lane);
    for (int n = tid; n < a.n_cls; n += tps) {
      const float o = ov[n];
      ov[n] = __fmaf_rn(o, a.decay, __int2float_rn(row_mac<kPlanesSmem>(
                                        win, pl + (size_t)n * s_in, P.w, tot)));
    }
    // this step's words and loads, one (tile, kind) job a warp from warp 1
    // on, warp 0 (the readout's) last, so the jobs run beside the readout;
    // the ring slot is next written at step t + 2, after barriers these
    // warps pass
    const size_t at = (size_t)t * a.B + b;
    for (int job = (warp + nwarps - 1) % nwarps; job < 2 * k; job += nwarps) {
      const ScanLayer& L = a.layer[job >> 1];
      const uint32_t* q = ring + L.words_off;
      if (!(job & 1) && L.words) {
        for (int j = lane; j < L.w; j += 32)
          L.words[at * L.w + j] = (int32_t)q[j];
      } else if ((job & 1) && L.loads) {
        const int groups = L.w >> 2;
        for (int g = lane; g < groups; g += 32)
          L.loads[at * groups + g] =
              __popc(q[4 * g]) + __popc(q[4 * g + 1]) +
              __popc(q[4 * g + 2]) + __popc(q[4 * g + 3]);
      }
    }
  }
  for (int n = tid; n < a.n_cls; n += tps)
    a.out_v[(size_t)b * a.n_cls + n] = ov[n];
}

// Fills the layer table; returns false on a shape the kernel cannot take.
bool scan_layout(ScanArgs& a, int k, const int* hidden, int n_cls,
                 bool planes_smem) {
  if (k < 0 || k > kMaxHidden || n_cls < 1) return false;
  a.k = k;
  a.n_cls = n_cls;
  a.n_first = k ? hidden[0] : n_cls;
  a.sum_n = a.sum_w = a.plane_words = 0;
  for (int h = 0; h < k; ++h) {
    if (hidden[h] < 1) return false;
    ScanLayer& L = a.layer[h];
    L.n = hidden[h];
    L.w = (hidden[h] + 31) / 32;
    L.n_next = h + 1 < k ? hidden[h + 1] : n_cls;
    L.stride = L.w | 1;
    L.plane_off = a.plane_words;
    L.state_off = a.sum_n;
    L.words_off = a.sum_w;
    if (planes_smem) a.plane_words += L.n_next * L.stride;
    a.sum_n += L.n;
    a.sum_w += L.w;
  }
  return true;
}

long long scan_smem_bytes(const ScanArgs& a, bool state_smem) {
  return 4LL * (a.plane_words + scan_stream_words(a.sum_n, a.n_cls, a.n_first,
                                                  a.sum_w, state_smem));
}

template <bool kSubtract, bool kPlanesSmem, bool kStateSmem>
int launch_scan(const ScanArgs& a, int tps, long long smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        temporal_scan_kernel<kSubtract, kPlanesSmem, kStateSmem>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  temporal_scan_kernel<kSubtract, kPlanesSmem, kStateSmem>
      <<<a.B, tps, (size_t)smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <bool kSubtract>
int launch_scan_route(const ScanArgs& a, int tps, long long smem,
                      bool planes_smem, bool state_smem, cudaStream_t s) {
  if (planes_smem) return launch_scan<kSubtract, true, true>(a, tps, smem, s);
  if (state_smem) return launch_scan<kSubtract, false, true>(a, tps, smem, s);
  return launch_scan<kSubtract, false, false>(a, tps, smem, s);
}



// ---- temporal_scan, the register route ------------------------------ //

constexpr int kRegMaxHidden = 4;   // hidden tiles the register route takes
constexpr int kLink = 8;           // steps in flight between two tiles
constexpr uint32_t kFull = 0xffffffffu;

struct RegArgs {
  const int32_t* c_in;                   // [T, B, n[0]]
  float* out_v;                          // [B, n[k]]
  const uint32_t* plane[kRegMaxHidden];  // [n[h + 1], w[h]]
  const int32_t* vth[kRegMaxHidden];     // [n[h]]
  int32_t* words[kRegMaxHidden];         // [T, B, w[h]] or null
  int32_t* loads[kRegMaxHidden];         // [T, B, w[h] / 4] or null
  int n[kRegMaxHidden + 1];              // hidden widths, then n_cls
  int w[kRegMaxHidden];                  // ceil(n[h] / 32)
  int T, B;
  float decay;
  int refractory;
};

// (float)v, exact for |v| < 2^22: the bits of 1.5 * 2^23 + v, less the bias.
__device__ __forceinline__ float small_to_float(int biased) {
  return __fsub_rn(__int_as_float(biased), 12582912.0f);
}
constexpr int kBias = 0x4B400000;   // the bits of 1.5 * 2^23

constexpr int kRing = 4;           // c_in steps in tile 0's ring

// arr[h] for a CTA-uniform h < kK, by selects: indexing the parameter
// space at run time would copy it to local memory.
template <int kK, class P, int kN>
__device__ __forceinline__ P pick(const P (&arr)[kN], int h) {
  P v = arr[0];
#pragma unroll
  for (int m = 1; m < kK && m < kN; ++m) v = h == m ? arr[m] : v;
  return v;
}

// The LIF step of one element where the product leaves it: membrane,
// refractory counter (unread without kRefrac), threshold, contribution;
// ORs `bit` into `bits` where it fires.  The fire is an all-ones mask,
// which resets the membrane and sets the bit without a branch.
template <bool kRefrac, bool kSubtract>
__device__ __forceinline__ void lif_fire(float& vm, int& rf, float th,
                                         float in, float decay,
                                         int refractory, uint32_t bit,
                                         uint32_t& bits) {
  const float v = __fmaf_rn(vm, decay, in);
  uint32_t m;
  asm("set.ge.u32.f32 %0, %1, %2;" : "=r"(m) : "f"(v), "f"(th));
  if constexpr (kRefrac) {
    m &= rf == 0 ? kFull : 0u;
    rf = m ? refractory : (rf > 0 ? rf - 1 : 0);
  }
  vm = kSubtract ? __fsub_rn(v, __uint_as_float(__float_as_uint(th) & m))
                 : __uint_as_float(__float_as_uint(v) & ~m);
  bits |= bit & m;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ unsigned cta_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The address of `local`'s offset in CTA `rank`'s shared memory.
__device__ __forceinline__ unsigned map_rank(const void* local,
                                             unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(smem_u32(local)), "r"(rank));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Waits for the phase of `bar` of this parity, with acquire semantics: at
// CTA scope where this CTA's threads or a copy complete it (as a TMA
// load's consumer waits), at cluster scope (kCluster) where another CTA's
// release arrives do, so that what that CTA read before them is ordered
// before what this one writes after.  A protocol fault traps after ~2^33
// clocks instead of hanging the card.
template <bool kCluster>
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  long long t0 = -1;
  for (;;) {
    unsigned done;
    if (kCluster)
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1],"
          " %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(smem_u32(bar)), "r"(parity)
          : "memory");
    else
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(smem_u32(bar)), "r"(parity)
          : "memory");
    if (done) return;
    if (t0 < 0)
      t0 = clock64();
    else if (clock64() - t0 > (1LL << 33))
      __trap();
  }
}

// v at the shared::cluster address `addr` of another CTA, completing 4
// bytes of transactions on its mbarrier at `rbar`.
__device__ __forceinline__ void st_async(unsigned addr, unsigned rbar,
                                         uint32_t v) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "r"(v), "r"(rbar)
      : "memory");
}

// kK hidden tiles, one CTA of a cluster each (tile h on CTA rank h), and
// the readout on CTA rank kK; kS K steps of 256 bits a MAC (widths up to
// 256 kS); kWT compute warps a CTA, each owning 8 kS / kWT groups of 32
// neurons of its tile, and a spare warp (CTA 0's copies c_in, the others'
// store the telemetry of the tile they consume); kR streams a cluster (16,
// or 8 with zero rows 8-15); kRefrac keeps refractory counters; kSubtract
// the reset.  c_in is 16-byte aligned and n[0] % 4 == 0, so a step's rows
// of the cluster come in one bulk copy.
template <int kK, int kS, int kWT, int kR, bool kRefrac, bool kSubtract>
__global__ void __launch_bounds__((kWT + 1) * 32, 1)
scan_regs_kernel(const __grid_constant__ RegArgs a) {
  constexpr int kT = kWT * 32;            // compute threads
  constexpr int kGPW = 8 * kS / kWT;      // groups of 32 neurons a warp
  constexpr int kCT = 4 * kGPW;           // column tiles a warp
  constexpr int kH = kR / 8;              // row halves a thread holds
  constexpr int kRow = 16 * kS + (kS > 1 ? 16 : 0);   // words of rows g
                                          // and g + 8 (interleaved)
  constexpr int kSlot = 8 * kRow;         // words of a step's slot
  constexpr unsigned kBytes = 4u * kR * 8 * kS;   // a step's words, sent
  constexpr int kN = 256 * kS;            // c_in neurons a ring row holds
  static_assert(kR == 8 || kR == 16, "8 or 16 streams a cluster");
  static_assert(kK >= 1 && kK <= kRegMaxHidden, "1 to 4 hidden tiles");
  static_assert(kLink % 4 == 0, "slots are refilled four steps a wait");
  static_assert(kGPW >= 1 && kGPW * kWT == 8 * kS, "whole groups a warp");
  // a slot: [g][word][row half]: word k of row g + 8 x at g * kRow + 2 k +
  // x, so the 16 bytes at g * kRow + 16 s + 4 t are the A fragment of K
  // step s (rows g, g + 8; words 2t, 2t + 1)
  __shared__ __align__(16) uint32_t inbuf[kLink][kSlot];   // tile h - 1's
  __shared__ __align__(8) uint64_t full[kLink];       // inbuf's slot is in
  __shared__ __align__(8) uint64_t empty[kLink];      // tile h + 1 read it
  __shared__ __align__(8) uint64_t cfull[kRing];      // tile 0: c_in is in
  __shared__ __align__(8) uint64_t cempty[kRing];     // tile 0 read it
  extern __shared__ __align__(16) int32_t ring[];   // [kRing][kR][n[0]]

  const int tid = threadIdx.x, lane = tid & 31, u = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int h = (int)cta_rank();          // this CTA's tile
  const bool first = h == 0, ro = h == kK;   // ro: the readout's CTA
  const bool compute = u < kWT;           // else the spare warp
  const int b0 = blockIdx.x / (kK + 1) * kR;
  const int T = a.T, B = a.B;
  const float decay = a.decay;
  const int n_cls = a.n[kK];
  const bool readout = ro && 8 * u < n_cls;   // readout column tile u
  // column tile j of this warp
  auto col = [&](int j) { return 4 * (u * kGPW + j / 4) + j % 4; };

  for (int e = tid; e < kLink * kSlot; e += kT + 32) (&inbuf[0][0])[e] = 0u;
  if (first)   // rows past B stay zero: a step's copy covers B's rows
    for (int e = tid; e < kRing * kR * kN; e += kT + 32) ring[e] = 0;
  if (tid == 0) {
    for (int s = 0; s < kLink; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_u32(&full[s]))
                   : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                       smem_u32(&empty[s])),
                   "r"(kWT + 1)
                   : "memory");
    }
    for (int s = 0; s < kRing; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_u32(&cfull[s]))
                   : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                       smem_u32(&cempty[s])),
                   "r"(kWT)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (!first)   // the first kLink steps' words are expected
      for (int s = 0; s < kLink && s < T; ++s)
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                smem_u32(&full[s])),
            "r"(kBytes)
            : "memory");
  }

  // thresholds (+inf past the width), planes (B fragments: column 8 c + g,
  // words 8 s + 2 t and + 1: the K positions t and t + 4, as in A; the
  // readout's in bp[0]), state
  const int n_h = pick<kK>(a.n, h);
  float th[kCT][2];
  uint32_t bp[kCT][kS][2];
  float vm[kCT][kH][2];
  int rf[kRefrac ? kCT : 1][kH][2];
  float ov[kH][2] = {};
  {
    const int m = first ? 0 : h - 1;   // the planes into this CTA's tile
    const uint32_t* plane = pick<kK>(a.plane, m);
    const int w_in = pick<kK>(a.w, m), n_out = ro ? n_cls : n_h;
    const int32_t* vth = pick<kK>(a.vth, ro ? 0 : h);
#pragma unroll
    for (int j = 0; j < kCT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = 8 * col(j) + 2 * t + e;
        th[j][e] = !ro && n < n_h ? __int2float_rn(__ldg(vth + n)) : INFINITY;
#pragma unroll
        for (int x = 0; x < kH; ++x) {
          vm[j][x][e] = 0.0f;
          if constexpr (kRefrac) rf[j][x][e] = 0;
        }
      }
      const int row = (ro ? 8 * u : 8 * col(j)) + g;
      const bool real =
          compute && !first && (!ro || (readout && j == 0)) && row < n_out;
      const uint32_t* pr = plane + (size_t)(real ? row : 0) * w_in;
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        const int k0 = 8 * s + 2 * t;
        bp[j][s][0] = real && k0 < w_in ? __ldg(pr + k0) : 0u;
        bp[j][s][1] = real && k0 + 1 < w_in ? __ldg(pr + k0 + 1) : 0u;
      }
    }
  }

  // tile 0's c_in: step s into ring slot s % kRing as [kR][n[0]], by CTA
  // 0's spare warp: one bulk copy of the cluster's rows (rows past B stay
  // zero); cfull says a slot is in, cempty that tile 0 has read it
  const int n_first = a.n[0];
  const int rows = B - b0 < kR ? B - b0 : kR;

  // tile m's words and loads of step `step` from `slot`, by the telemetry
  // warp: lane (g, q) loads the 16 bytes of rows g, g + 8, words 8 s + 2 q
  // and + 1 of each K step, stores them and, with lane q ^ 1, the load of
  // words 8 s + 4 (q / 2) .. + 3
  auto telemetry = [&](int m, int step, const uint32_t* slot) {
    int32_t* wd = pick<kK>(a.words, m);
    int32_t* ld = pick<kK>(a.loads, m);
    const int w = pick<kK>(a.w, m);
    if (!wd && !ld) return;
    const int q = lane & 3;
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      const uint4 v =
          *reinterpret_cast<const uint4*>(slot + g * kRow + 16 * s + 4 * q);
      const int k0 = 8 * s + 2 * q;
      int p = 0;
#pragma unroll
      for (int x = 0; x < kH; ++x) {
        const uint32_t w0 = x ? v.y : v.x, w1 = x ? v.w : v.z;
        const int row = b0 + g + 8 * x;
        if (wd && row < B && k0 < w) {
          int32_t* out = wd + ((size_t)step * B + row) * w + k0;
          if (!(w & 1)) {
            *reinterpret_cast<int2*>(out) = make_int2(w0, w1);
          } else {
            out[0] = (int32_t)w0;
            if (k0 + 1 < w) out[1] = (int32_t)w1;
          }
        }
        p |= (__popc(w0) + __popc(w1)) << (16 * x);
      }
      if (ld) {   // w % 4 == 0
        p += __shfl_xor_sync(kFull, p, 1);
#pragma unroll
        for (int x = 0; x < kH; ++x) {
          const int row = b0 + g + 8 * x;
          if (!(q & 1) && row < B && k0 < w)
            ld[((size_t)step * B + row) * (w >> 2) + (k0 >> 2)] =
                (p >> (16 * x)) & 0xffff;
        }
      }
    }
  };

  // every CTA's barriers are initialised, inbuf is zero
  __syncthreads();
  cluster_sync();
  const unsigned next_buf = ro ? 0u : map_rank(&inbuf[0][0], h + 1);
  const unsigned next_full = ro ? 0u : map_rank(&full[0], h + 1);
  const unsigned prev_empty = first ? 0u : map_rank(&empty[0], h - 1);
  // this warp is done reading step i's slot: the next step's words there
  // are expected (warp 0), and tile h - 1 may refill it.  Every lane's
  // reads come before lane 0's arrive (__syncwarp), whose release
  // semantics order them before it: the arrive is CUTLASS's ClusterBarrier
  // consumer release (the default semantics, release at CTA scope), and
  // tile h - 1 waits for it with acquire at cluster scope before its next
  // st.async into the slot.  A release at cluster scope makes the scan
  // ~1.6x slower at T 16 (probes/scan_link_probe.py).
  auto release = [&](int i) {
    const int slot = i % kLink;
    __syncwarp();
    if (lane == 0) {
      if (u == 0 && i + kLink < T)
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                smem_u32(&full[slot])),
            "r"(kBytes)
            : "memory");
      asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(
                       prev_empty + 8u * slot)
                   : "memory");
    }
  };

  if (!compute && first) {   // the copier: c_in, up to kRing steps ahead
    for (int s = 0; s < T; ++s) {
      const int cs = s % kRing;
      if (s >= kRing) mbar_wait<false>(&cempty[cs], ((s / kRing) + 1) & 1);
      int32_t* dst = ring + cs * kR * n_first;
      const int32_t* src = a.c_in + ((size_t)s * B + b0) * n_first;
      if (lane == 0) {
        const unsigned bytes = 4u * rows * n_first;
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                smem_u32(&cfull[cs])),
            "r"(bytes)
            : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
            "bytes [%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
            "l"(src), "r"(bytes), "r"(smem_u32(&cfull[cs]))
            : "memory");
      }
    }
  } else if (!compute) {   // the telemetry warp: tile h - 1's words
    for (int i = 0; i < T; ++i) {
      mbar_wait<false>(&full[i % kLink], (i / kLink) & 1);
      telemetry(h - 1, i, inbuf[i % kLink]);
      release(i);   // off the chain, after the stores
    }
  } else {
    for (int i = 0; i < T; ++i) {
      const int slot = i % kLink;
      float in[kCT][kH][2];
      if (first) {   // this step's c_in is in: read, then free the slot
        const int cs = i % kRing;
        mbar_wait<false>(&cfull[cs], (i / kRing) & 1);
        const int32_t* cin = ring + (cs * kR + g) * n_first;
#pragma unroll
        for (int j = 0; j < kCT; ++j)
#pragma unroll
          for (int x = 0; x < kH; ++x) {
            const int n = 8 * col(j) + 2 * t;   // past n[0]: never fires
            const int32_t* p = cin + 8 * x * n_first + n;
            const bool in0 = n < n_first, in1 = n + 1 < n_first;
            in[j][x][0] = __int2float_rn(in0 ? p[0] : 0);
            in[j][x][1] = __int2float_rn(in1 ? p[1] : 0);
          }
      } else if (ro) {   // tile kK - 1's words of step i: the readout
        mbar_wait<false>(&full[slot], (i / kLink) & 1);
        if (readout) {   // leaks and integrates, never fires
          const uint32_t* src = inbuf[slot] + g * kRow + 4 * t;
          const uint32_t ones[2] = {kFull, kFull};
          int pc[4] = {0, 0, 0, 0}, d[4] = {0, 0, 0, 0};
#pragma unroll
          for (int s = 0; s < kS; ++s) {
            const uint4 v = *reinterpret_cast<const uint4*>(src + 16 * s);
            const uint32_t af[4] = {v.x, v.y, v.z, v.w};
            mma_and_popc(pc, af, ones);
            mma_and_popc(d, af, bp[0][s]);
          }
#pragma unroll
          for (int x = 0; x < kH; ++x)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              in[0][x][e] =
                  small_to_float(2 * d[2 * x + e] + kBias - pc[2 * x]);
              ov[x][e] = __fmaf_rn(ov[x][e], decay, in[0][x][e]);
            }
        }
        release(i);
        continue;
      } else {   // tile h - 1's words of step i are in
        mbar_wait<false>(&full[slot], (i / kLink) & 1);
        const uint32_t* src = inbuf[slot] + g * kRow + 4 * t;
        uint32_t af[kS][4];
#pragma unroll
        for (int s = 0; s < kS; ++s) {
          const uint4 v = *reinterpret_cast<const uint4*>(src + 16 * s);
          af[s][0] = v.x;
          af[s][1] = v.y;
          af[s][2] = v.z;
          af[s][3] = v.w;
        }
        release(i);   // the slot is read: free it at once
        // each stream's spike count: the product against all-ones planes
        // gives it in every column, so in every lane; V = 2 acc - count,
        // as a float through the exact bias
        const uint32_t ones[2] = {kFull, kFull};
        int pc[4] = {0, 0, 0, 0};
        int d[kCT][4];
#pragma unroll
        for (int s = 0; s < kS; ++s) mma_and_popc(pc, af[s], ones);
#pragma unroll
        for (int j = 0; j < kCT; ++j) {
          d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0;
#pragma unroll
          for (int s = 0; s < kS; ++s) mma_and_popc(d[j], af[s], bp[j][s]);
        }
        const int bias[2] = {kBias - pc[0], kBias - pc[2]};
#pragma unroll
        for (int j = 0; j < kCT; ++j)
#pragma unroll
          for (int x = 0; x < kH; ++x)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              in[j][x][e] = small_to_float(2 * d[j][2 * x + e] + bias[x]);
      }
      // the LIF step, the fired bits of each group at 8 q + e (shifted to
      // 8 q + 2 t + e below); the quad ORs them, and lane t < kH sends row
      // g + 8 t's word to tile h + 1 (or to the readout) once that CTA has
      // read step i - kLink from the slot
      uint32_t mine[kGPW];
#pragma unroll
      for (int jj = 0; jj < kGPW; ++jj) {
        uint32_t bits[kH] = {};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = 4 * jj + q;
#pragma unroll
          for (int x = 0; x < kH; ++x)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              lif_fire<kRefrac, kSubtract>(
                  vm[j][x][e], rf[kRefrac ? j : 0][x][e], th[j][e],
                  in[j][x][e], decay, a.refractory, 1u << (8 * q + e),
                  bits[x]);
        }
        if constexpr (kH == 2) {
          const uint32_t lo = bits[0] << (2 * t), hi = bits[1] << (2 * t);
          mine[jj] = ((t & 1) ? hi : lo) |
                     __shfl_xor_sync(kFull, (t & 1) ? lo : hi, 1);
        } else {
          const uint32_t lo = bits[0] << (2 * t);
          mine[jj] = lo | __shfl_xor_sync(kFull, lo, 1);
        }
        mine[jj] |= __shfl_xor_sync(kFull, mine[jj], 2);
      }
      // steps i .. i + 3 refill the slots of steps i - kLink .. + 3: one
      // wait, every fourth step, for the last of those (tile h + 1's warps
      // free steps in order)
      if (i >= kLink && !(i & 3)) {
        const int j = i - kLink + 3;
        mbar_wait<true>(&empty[j % kLink], (j / kLink) & 1);
      }
      if (t < kH)
#pragma unroll
        for (int jj = 0; jj < kGPW; ++jj)
          st_async(next_buf + 4u * (slot * kSlot + g * kRow +
                                    2 * (u * kGPW + jj) + t),
                   next_full + 8u * slot, mine[jj]);
      // off the chain: this step's c_in slot is free (every lane has read
      // it; the arrive releases at CTA scope to the copier's wait)
      if (first) {
        __syncwarp();
        if (lane == 0)
          asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                           smem_u32(&cempty[i % kRing]))
                       : "memory");
      }
    }
  }
  if (readout) {
#pragma unroll
    for (int x = 0; x < kH; ++x) {
      const int row = b0 + g + 8 * x;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = 8 * u + 2 * t + e;
        if (row < B && n < n_cls) a.out_v[(size_t)row * n_cls + n] = ov[x][e];
      }
    }
  }
  // no CTA leaves while another may still write its shared memory
  cluster_sync();
}

// Dynamic shared memory of tile 0's c_in ring.
template <int kS, int kR>
constexpr int regs_ring_bytes() {
  return kRing * kR * 256 * kS * 4;
}

template <int kK, int kS, int kWT, int kR, bool kRefrac, bool kSubtract>
int launch_regs_kernel(const RegArgs& a, cudaStream_t s) {
  auto kernel = scan_regs_kernel<kK, kS, kWT, kR, kRefrac, kSubtract>;
  constexpr int smem = regs_ring_bytes<kS, kR>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((a.B + kR - 1) / kR * (kK + 1)));
  cfg.blockDim = dim3((kWT + 1) * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kK + 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int kK, int kS, int kWT, int kR>
int launch_regs(const RegArgs& a, bool refrac, bool subtract,
                cudaStream_t s) {
  if (refrac)
    return subtract ? launch_regs_kernel<kK, kS, kWT, kR, true, true>(a, s)
                    : launch_regs_kernel<kK, kS, kWT, kR, true, false>(a, s);
  return subtract ? launch_regs_kernel<kK, kS, kWT, kR, false, true>(a, s)
                  : launch_regs_kernel<kK, kS, kWT, kR, false, false>(a, s);
}

// The register route's geometry (ops.SCAN_WARPS, ops.SCAN_ROWS): 8
// compute warps a CTA and 8 streams a cluster, the fastest at every
// event-path T (PERF.md; probes/scan_link_probe.py times the others).
constexpr int kScanWarps = 8;
constexpr int kScanRows = 8;

// The register route's instantiations (ops._REG_ROUTES): hidden tiles and
// K steps.
int dispatch_regs(const RegArgs& a, int k, int steps, bool refrac,
                  bool subtract, cudaStream_t s) {
#define REG_ROUTE(K, S)                                                   \
  if (k == K && steps == S)                                               \
    return launch_regs<K, S, kScanWarps, kScanRows>(a, refrac, subtract, s);
  REG_ROUTE(1, 1)
  REG_ROUTE(2, 1)
  REG_ROUTE(3, 1)
  REG_ROUTE(4, 1)
  REG_ROUTE(1, 2)
  REG_ROUTE(2, 2)
#undef REG_ROUTE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// spikes int8[b, n], vmem_out float32[b, n], refrac_out int32[b, n] from
// vmem float32[b, n], contrib int32[b, n], vth int32[n], refrac int32[b, n]
// (all contiguous).  subtract: 0 resets to zero, 1 subtracts the threshold.
// At most max_blocks blocks of 256 threads walk the elements.
// Returns cudaGetLastError().
int lif_step(const void* vmem, const void* contrib, const void* vth,
             const void* refrac, void* spikes, void* vmem_out,
             void* refrac_out, int b, int n, float decay, int subtract,
             int refractory, int max_blocks, void* stream) {
  if (b < 1 || n < 1 || max_blocks < 1 || refractory < 0)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)b * n;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > max_blocks) blocks = max_blocks;
  const dim3 grid((unsigned)blocks);
  cudaStream_t s = (cudaStream_t)stream;
  if (subtract)
    lif_step_kernel<true><<<grid, kThreads, 0, s>>>(
        (const float*)vmem, (const int32_t*)contrib, (const int32_t*)vth,
        (const int32_t*)refrac, (int8_t*)spikes, (float*)vmem_out,
        (int32_t*)refrac_out, total, n, decay, refractory);
  else
    lif_step_kernel<false><<<grid, kThreads, 0, s>>>(
        (const float*)vmem, (const int32_t*)contrib, (const int32_t*)vth,
        (const int32_t*)refrac, (int8_t*)spikes, (float*)vmem_out,
        (int32_t*)refrac_out, total, n, decay, refractory);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of one temporal_scan block (one stream): k hidden
// widths, n_cls readout neurons; planes_smem stages the weight
// planes, state_smem keeps the state there.  -1 on a shape the kernel
// cannot take.
long long temporal_scan_smem_bytes(int k, const int* hidden, int n_cls,
                                   int planes_smem, int state_smem) {
  ScanArgs a;
  if (!scan_layout(a, k, hidden, n_cls, planes_smem != 0)) return -1;
  return scan_smem_bytes(a, state_smem != 0);
}

// The opt-in shared memory a block of `device` may use.
int temporal_scan_smem_optin(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return bytes;
}

// The event round's T steps after tile 0's MAC, in one launch:
// c_in int32[T, b, n_first] (n_first = hidden[0], or n_cls when k = 0);
// per hidden tile h < k (any width; w_h = ceil(hidden[h] / 32)): planes[h]
// int32[n_next, w_h] (n_next the next hidden width, n_cls for the last),
// vth[h] int32[hidden[h]], words[h] int32[T, b, w_h] or null, loads[h]
// int32[T, b, w_h / 4] or null (words and loads may be null arrays, and
// their entries null); out_v float32[b, n_cls].  scratch float32[b,
// 2 sum(hidden) + n_cls] when !state_smem.  One block serves each stream,
// one thread per neuron of the widest tile (at most kScanMaxThreads).
// Returns cudaGetLastError().
int temporal_scan(const void* c_in, int T, int b, int k, const int* hidden,
                  int n_cls, const void* const* planes,
                  const void* const* vth, void* const* words,
                  void* const* loads, void* out_v, void* scratch, float decay,
                  int subtract, int refractory, int planes_smem,
                  int state_smem, void* stream) {
  ScanArgs a;
  if (T < 1 || b < 1 || refractory < 0 || (planes_smem && !state_smem) ||
      (!state_smem && scratch == nullptr) ||
      !scan_layout(a, k, hidden, n_cls, planes_smem != 0))
    return (int)cudaErrorInvalidValue;
  for (int h = 0; h < k; ++h) {
    ScanLayer& L = a.layer[h];
    L.plane = static_cast<const uint32_t*>(planes[h]);
    L.vth = static_cast<const int32_t*>(vth[h]);
    L.words = words ? static_cast<int32_t*>(words[h]) : nullptr;
    L.loads = loads ? static_cast<int32_t*>(loads[h]) : nullptr;
    if (L.loads && L.w % 4) return (int)cudaErrorInvalidValue;
  }
  a.c_in = static_cast<const int32_t*>(c_in);
  a.out_v = static_cast<float*>(out_v);
  a.scratch = static_cast<float*>(scratch);
  a.T = T;
  a.B = b;
  a.decay = decay;
  a.refractory = refractory;
  int widest = a.n_cls;
  for (int h = 0; h < k; ++h) widest = widest > hidden[h] ? widest : hidden[h];
  const int tps = widest < kScanMaxThreads ? (widest + 31) / 32 * 32
                                           : kScanMaxThreads;
  const long long smem = scan_smem_bytes(a, state_smem != 0);
  int device = 0;
  cudaGetDevice(&device);
  if (smem > temporal_scan_smem_optin(device))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return subtract ? launch_scan_route<true>(a, tps, smem, planes_smem != 0,
                                            state_smem != 0, s)
                  : launch_scan_route<false>(a, tps, smem, planes_smem != 0,
                                             state_smem != 0, s);
}

// The register route (scan_regs_kernel): the arguments of temporal_scan
// above for 1 <= k <= 4 hidden tiles of at most 256 * steps neurons,
// hidden[0] % 4 == 0, c_in 16-byte aligned and n_cls <= 8 * kScanWarps,
// at `steps` (1 or 2) K steps a MAC, as instantiated (ops._scan_route);
// cudaErrorInvalidValue for any other.  Returns cudaGetLastError().
int temporal_scan_regs(const void* c_in, int T, int b, int k,
                       const int* hidden, int n_cls,
                       const void* const* planes, const void* const* vth,
                       void* const* words, void* const* loads, void* out_v,
                       float decay, int subtract, int refractory, int steps,
                       void* stream) {
  if (T < 1 || b < 1 || refractory < 0 || k < 1 || k > kRegMaxHidden ||
      n_cls < 1 || n_cls > 8 * kScanWarps || hidden[0] % 4 ||
      ((uintptr_t)c_in & 15))
    return (int)cudaErrorInvalidValue;
  RegArgs a = {};
  for (int h = 0; h < k; ++h) {
    if (hidden[h] < 1 || hidden[h] > 256 * steps)
      return (int)cudaErrorInvalidValue;
    a.n[h] = hidden[h];
    a.w[h] = (hidden[h] + 31) / 32;
    a.plane[h] = static_cast<const uint32_t*>(planes[h]);
    a.vth[h] = static_cast<const int32_t*>(vth[h]);
    a.words[h] = words ? static_cast<int32_t*>(words[h]) : nullptr;
    a.loads[h] = loads ? static_cast<int32_t*>(loads[h]) : nullptr;
    if (a.loads[h] && a.w[h] % 4) return (int)cudaErrorInvalidValue;
  }
  a.n[k] = n_cls;
  a.c_in = static_cast<const int32_t*>(c_in);
  a.out_v = static_cast<float*>(out_v);
  a.T = T;
  a.B = b;
  a.decay = decay;
  a.refractory = refractory;
  return dispatch_regs(a, k, steps, refractory > 0, subtract != 0,
                       (cudaStream_t)stream);
}

const char* lif_step_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
