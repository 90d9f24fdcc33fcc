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
// popc rate) and 1 MB of c_in (~0.3 us); the chain, T x (hidden tiles + 1)
// dependent links, sets the time.  So the design keeps everything a step
// touches on the SM and spends the launch on the chain alone:
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
#include <stdint.h>

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

const char* lif_step_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
