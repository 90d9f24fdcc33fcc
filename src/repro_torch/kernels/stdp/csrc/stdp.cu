// Transposed-port stochastic 1-bit STDP for NVIDIA Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of the JAX reference:
//   stdp_column_event  <- src/repro/kernels/stdp/kernel.py:75 _column_event_kernel
//   stdp_update        <- src/repro/kernels/stdp/kernel.py:26 _stdp_kernel
// and, as stdp_column_epoch, the reference's whole epoch of column events:
//   src/repro/core/esam/learning.py:223 column_event_epoch (one lax.scan
//   whose body is the readout matvec, the argmax and two
//   _column_event_kernel calls).
//
// Weights live transposed, {0,1} int8 [N_out, N_in]: all synapses of one
// learning neuron are one contiguous row (the transposable column port of
// Sec 4.4.1).  The rule, with float32 uniforms and float32 probabilities:
//
//     new = pre && u_pot < p_pot ? 1 : (!pre && u_dep < p_dep ? 0 : old)
//
// p_pot = 0 never potentiates: no uniform in [0, 1) is below 0.
//
// stdp_column_event rewrites ONE row, in place, selected by a column index
// and gated by an `apply` flag that both live in device memory and are read
// inside the kernel: the counterpart of the reference's scalar-prefetched
// row index and aliased output buffer.  Its bound is a few ns (one row of
// N_in * 10 bytes).  On an NVIDIA H100 80GB HBM3 (700 W; chip_smoke.py) an
// empty kernel takes 1.17-1.24 us in a CUDA graph and one that loads a word
// and stores it 1.51-1.55 (probes/launch_floor.cu; PERF.md, section 6); the
// one-block kernel that loaded `apply`, then `col`, then the row, each load
// waiting on the one before, took 1.84-1.88 at [10, 256]: ~0.3 us above the
// one-load kernel.  This design took 1.77-1.78 at [256, 768] and 1.69-1.74
// at the kernel bench's [128, 256] in runs whose one-load kernel took
// 1.46-1.55 (same card and limit; PERF.md, section 6): ~0.2 of its own,
// one dependent round trip.
// Design: a thread takes 4 inputs; every load that does not depend on
// another (apply, col, the trace, both uniforms as 16-byte loads where
// aligned) is issued at once, and the masks are computed while they land.
// The event row's bytes are the one load that waits (on col, and only
// where apply holds): two round trips, one fewer than before.  The index is
// a volatile load: the compiler sank a plain one past the exit that
// precedes its only use, a round trip more.
//
// stdp_update is the same rule over the full matrix, masked by `post` per
// row: elementwise, one thread per synapse, bound by its ~10 bytes per
// synapse of traffic.
//
// The epoch is two launches.  stdp_epoch_masks draws and packs, over the
// whole card, one warp a sample: the reference's column-event draws
// (threefry2x32 of fold_in(fold_in(key, i), phase) at each input, bit for
// bit core/prng.py and jax.random), only those the rule reads, compared and
// ballotted into one slot a sample in device memory.  Its bound is the
// int32 threefry work (~2 draws an input) or the trace bytes.
// stdp_column_epoch then runs the strict chain (sample i+1 reads the bits
// sample i wrote) on ONE warp: its time is samples x the latency of one
// step, not bytes or operations, and the design shortens that step.  The
// readout lives in the warp's registers (lane o holds row o's words, and
// row o + 32 when n_out > 32); readouts past the register budget (more
// than 64 rows, 1024 inputs, or 512 inputs at 33-64 rows) keep bit planes
// in shared memory (row stride odd: 32 rows are 32 banks), a template
// parameter of the same kernel.  The warp fetches its own slots, 16 at
// a time by TMA bulk copies on mbarriers, and loads the next sample's trace
// while this sample's readout runs.  One step: popc of trace & row words,
// one rounded offset add (__fadd_rn), the argmax as one __reduce_max_sync
// over an order-preserving key and __ballot_sync / __ffs for the lowest
// row holding it, and, when wrong, the owners of the teacher and the
// winner rows apply (old & ~dep) | pot in registers.  A label outside
// [0, N_out) is wrapped once if negative and clamped for the teacher row,
// as the reference's interpret-mode block index is, and always counts as
// wrong.  The bits and the count go back once at the end.
//
// The matrix-RNG epoch (stdp_update's path: the reference's
// online_learning_epoch_scan(rng_scheme="matrix"), one lax.scan at
// src/repro/core/esam/learning.py:312 whose body draws two full
// [n_in, n_out] uniform matrices for each of its two stdp_update calls) is
// three launches.  stdp_update_keys walks the split chain on one thread:
// k_{i+1} = threefry(k_i, (0, 0)) is strictly serial, so its time is
// samples x the latency of one threefry, a floor no design of the later
// launches moves.  stdp_update_masks draws, one warp a (sample, row) pair
// over the whole card, every uniform the rule can read: the teacher row y at every input
// (potentiate where the trace is 1, depress where it is 0) and, for every
// other row o, the winner's depress draw where the trace is 1 (the winner is
// known only in the chain), at the reference's flat index a * n_out + o of
// its [n_in, n_out] matrices.  The chain is column_epoch_kernel with
// PerRow: each lane owns its rows' depress masks, a label outside
// [0, n_out) has no teacher row (one_hot gives none) and is always wrong,
// there is no offset, and the count is the reference's 2 a wrong sample.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int8_t rule(int8_t old, bool pre, float u_pot,
                                       float u_dep, float p_pot, float p_dep) {
  if (pre && u_pot < p_pot) return 1;
  if (!pre && u_dep < p_dep) return 0;
  return old;
}

// ---- the single column event ------------------------------------------- //

constexpr int kEventThreads = 64;
constexpr int kEventInputs = 4;          // inputs a thread

// The rule on 4 inputs as byte masks: `set` where the byte becomes
// pot ? 1 : 0, `one` the bytes that become 1.
struct EventMasks {
  uint32_t set, one;
};

__device__ __forceinline__ EventMasks event_masks(const uint8_t (&pre)[4],
                                                  const float (&up)[4],
                                                  const float (&ud)[4],
                                                  float p_pot, float p_dep) {
  EventMasks m{0u, 0u};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool pot = pre[j] != 0 && up[j] < p_pot;
    const bool dep = pre[j] == 0 && ud[j] < p_dep;
    m.set |= (pot || dep ? 0xFFu : 0u) << (8 * j);
    m.one |= (pot ? 1u : 0u) << (8 * j);
  }
  return m;
}

// A row index out of [0, n_out) is wrapped once if negative and clamped, as
// the reference's interpret-mode block index is.
__device__ __forceinline__ long long event_row(long long c, int n_out) {
  if (c < 0) c += n_out;
  return c < 0 ? 0 : (c >= n_out ? n_out - 1 : c);
}

// A volatile global load: issued where it stands, so the compiler cannot
// sink the row index past the gate's exit into the branch that uses it.
__device__ __forceinline__ uint32_t load_now_u32(const void* p) {
  uint32_t v;
  asm volatile("ld.volatile.global.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ long long load_now_s64(const void* p) {
  long long v;
  asm volatile("ld.volatile.global.s64 %0, [%1];" : "=l"(v) : "l"(p));
  return v;
}

// Block (kEventThreads); blockIdx.x * blockDim.x + threadIdx.x is the
// thread's group of 4 inputs.  kVec: n_in % 4 == 0, the row bytes and the
// trace 4-byte aligned, the uniforms 16-byte aligned (one load each); else
// byte and float loads at addresses clamped into the row.  kCol64: col is
// int64, else int32 (a template parameter, so its load is not predicated
// apart from the others).  No branch stands between the loads.
template <bool kVec, bool kCol64>
__global__ void __launch_bounds__(kEventThreads)
column_event_kernel(int8_t* __restrict__ bits, int n_out, int n_in,
                    long long ld, const void* col,
                    const bool* apply, const uint8_t* __restrict__ pre,
                    const float* __restrict__ u_pot,
                    const float* __restrict__ u_dep, float p_pot,
                    float p_dep) {
  const int i0 = (blockIdx.x * blockDim.x + threadIdx.x) * kEventInputs;
  if (i0 >= n_in) return;

  // every load that waits on no other, at once
  const long long c_raw = kCol64 ? load_now_s64(col)
                                 : (int32_t)load_now_u32(col);
  const bool on = *apply;
  uint8_t tr[4];
  float up[4], ud[4];
  if (kVec) {
    const uint32_t t4 = *reinterpret_cast<const uint32_t*>(pre + i0);
    const float4 p4 = __ldg(reinterpret_cast<const float4*>(u_pot + i0));
    const float4 d4 = __ldg(reinterpret_cast<const float4*>(u_dep + i0));
#pragma unroll
    for (int j = 0; j < 4; ++j) tr[j] = (uint8_t)(t4 >> (8 * j));
    up[0] = p4.x; up[1] = p4.y; up[2] = p4.z; up[3] = p4.w;
    ud[0] = d4.x; ud[1] = d4.y; ud[2] = d4.z; ud[3] = d4.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = min(i0 + j, n_in - 1);
      tr[j] = pre[i];
      up[j] = __ldg(u_pot + i);
      ud[j] = __ldg(u_dep + i);
    }
  }
  const EventMasks m = event_masks(tr, up, ud, p_pot, p_dep);
  if (!on) return;
  // the one load that waits: the event row's bytes, after col
  int8_t* row = bits + event_row(c_raw, n_out) * ld + i0;
  if (kVec) {
    const uint32_t old = *reinterpret_cast<const uint32_t*>(row);
    *reinterpret_cast<uint32_t*>(row) = (old & ~m.set) | m.one;
    return;
  }
  uint32_t old = 0u;  // every byte loaded before the first store
#pragma unroll
  for (int j = 0; j < 4; ++j)
    old |= (uint32_t)(uint8_t)row[min(j, n_in - 1 - i0)] << (8 * j);
  const uint32_t now = (old & ~m.set) | m.one;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (i0 + j < n_in) row[j] = (int8_t)(now >> (8 * j));
}

__global__ void __launch_bounds__(kThreads)
stdp_update_kernel(const int8_t* __restrict__ bits, int8_t* __restrict__ out,
                   int n_out, int n_in, const uint8_t* __restrict__ pre,
                   const uint8_t* __restrict__ post,
                   const float* __restrict__ u_pot,
                   const float* __restrict__ u_dep, float p_pot, float p_dep) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)n_out * n_in) return;
  const int o = (int)(idx / n_in);
  const int i = (int)(idx - (long long)o * n_in);
  const int8_t old = bits[idx];
  out[idx] = post[o] ? rule(old, pre[i] != 0, u_pot[idx], u_dep[idx], p_pot,
                            p_dep)
                     : old;
}

// ---- the epoch: stdp_epoch_masks, then stdp_column_epoch --------------- //

constexpr int kMaskWarps = 8;        // samples a block of stdp_epoch_masks
constexpr int kEpochThreads = 256;   // stage and write back; warp 0: the chain
constexpr int kEpochWarps = kEpochThreads / 32;
constexpr int kBatchShift = 4;      // 16 slots one bulk copy fetches
constexpr int kBufs = 4;             // batches the chain's ring holds

// One slot, in words: a header (the trace's popcount, the teacher row as
// clamped, the label as the argmax compares it: ~0u when out of range, 0),
// then four fields of F words (zero past W): the trace, the teacher's
// potentiate and depress masks, the winner's depress mask.  The winner
// never potentiates (p_pot 0), so it has no potentiate mask.  F is the
// register chain's words a row (8, 16 or 32) up to 32 words, so its loads
// need no bound; W rounded up to 4 past that.
__host__ __device__ inline int epoch_words(int n_in) { return (n_in + 31) / 32; }
__host__ __device__ inline int field_words(int W) {
  return W <= 8 ? 8 : W <= 16 ? 16 : W <= 32 ? 32 : (W + 3) & ~3;
}
__host__ __device__ inline int slot_words(int W) { return 4 + 4 * field_words(W); }

// The matrix-RNG epoch's slot: the header (the trace's popcount, then the
// label twice, ~0u when out of range: no teacher row, always wrong, 0), the
// trace, the teacher's potentiate mask, then a depress mask a row: the
// teacher's (trace 0) at row y, the winner's (trace 1) at every other row.
__host__ __device__ inline int update_slot_words(int W, int n_out) {
  return 4 + (2 + n_out) * field_words(W);
}

// The chain block's shared memory: the ring of slots (kBufs batches of
// 2^shift), one mbarrier a batch, the readout's planes [n_out][W | 1], the
// offsets.
__host__ __device__ inline size_t ring_words(int SW, int shift) {
  return ((size_t)kBufs << shift) * SW;
}
size_t chain_smem_bytes(int n_out, int n_in, int SW, int shift) {
  const int W = epoch_words(n_in);
  return 4 * (ring_words(SW, shift) + 2 * kBufs + (size_t)n_out * (W | 1) +
              n_out);
}

__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1, int r) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, r) ^ x0;   // rotate left by r
}

// Threefry-2x32, 20 rounds, under key (k0, k1): core/prng.py's threefry2x32
// (rotations 13, 15, 26, 6 / 17, 29, 16, 24, a key injection every 4).
__device__ __forceinline__ uint2 threefry2x32(uint32_t k0, uint32_t k1,
                                              uint32_t x0, uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0; x1 += k1;
  mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  x0 += k1; x1 += k2 + 1u;
  mix(x0, x1, 17); mix(x0, x1, 29); mix(x0, x1, 16); mix(x0, x1, 24);
  x0 += k2; x1 += k0 + 2u;
  mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  x0 += k0; x1 += k1 + 3u;
  mix(x0, x1, 17); mix(x0, x1, 29); mix(x0, x1, 16); mix(x0, x1, 24);
  x0 += k1; x1 += k2 + 4u;
  mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  x0 += k2; x1 += k0 + 5u;
  return make_uint2(x0, x1);
}

// The 23 bits of input j's uniform under phase key (kx, ky): the uniform is
// exactly (bits >> 9) * 2^-23 (core/prng.py's uniform), so u < p is
// (bits >> 9) < t with t = ceil(p * 2^23) clamped to [0, 2^23], which the
// wrapper computes (ref.uniform_threshold).
__device__ __forceinline__ uint32_t draw23(uint32_t kx, uint32_t ky, int j) {
  const uint2 b = threefry2x32(kx, ky, 0u, (uint32_t)j);
  return (b.x ^ b.y) >> 9;
}

constexpr int kMaskChunk = 4;   // words a lane draws at once (independent)

// One warp a sample i (its position in the epoch): k_i = fold_in(key, i),
// phase keys fold_in(k_i, 0 | 1 | 2); where the trace is 1 the teacher reads
// phase 0 (potentiate) and the winner phase 2 (depress); where it is 0 the
// teacher reads phase 1 (depress) and the winner nothing.
__global__ void __launch_bounds__(kMaskWarps * 32)
epoch_masks_kernel(uint32_t* __restrict__ slots,
                   const uint8_t* __restrict__ pre, long long ldp, int n, int n_in, int n_out,
                   const void* labels, int label_bytes,
                   const long long* __restrict__ key, uint32_t t_pot,
                   uint32_t t_dep) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kMaskWarps + (threadIdx.x >> 5);
  if (i >= n) return;   // the whole warp
  const int W = epoch_words(n_in), F = field_words(W);
  uint32_t* sl = slots + (size_t)i * slot_words(W);
  const uint8_t* row = pre + (long long)i * ldp;
  const uint2 ki = threefry2x32((uint32_t)key[0], (uint32_t)key[1], 0u,
                                (uint32_t)i);
  const uint2 kp = threefry2x32(ki.x, ki.y, 0u, (uint32_t)(lane & 3));
  const uint32_t p0x = __shfl_sync(~0u, kp.x, 0);
  const uint32_t p0y = __shfl_sync(~0u, kp.y, 0);
  const uint32_t p1x = __shfl_sync(~0u, kp.x, 1);
  const uint32_t p1y = __shfl_sync(~0u, kp.y, 1);
  const uint32_t p2x = __shfl_sync(~0u, kp.x, 2);
  const uint32_t p2y = __shfl_sync(~0u, kp.y, 2);
  int npre = 0;
  for (int w0 = 0; w0 < F; w0 += kMaskChunk) {   // F is a multiple of 4
    bool t[kMaskChunk], c[kMaskChunk], cw[kMaskChunk];
#pragma unroll
    for (int k = 0; k < kMaskChunk; ++k) {
      const int j = 32 * (w0 + k) + lane;
      t[k] = j < n_in && row[j] != 0;
    }
#pragma unroll
    for (int k = 0; k < kMaskChunk; ++k) {
      const int j = 32 * (w0 + k) + lane;
      const uint32_t f = draw23(t[k] ? p0x : p1x, t[k] ? p0y : p1y, j);
      c[k] = j < n_in && f < (t[k] ? t_pot : t_dep);
    }
#pragma unroll
    for (int k = 0; k < kMaskChunk; ++k) {
      cw[k] = false;
      if (t[k]) cw[k] = draw23(p2x, p2y, 32 * (w0 + k) + lane) < t_dep;
    }
#pragma unroll
    for (int k = 0; k < kMaskChunk; ++k) {
      const uint32_t tr = __ballot_sync(~0u, t[k]);
      const uint32_t cm = __ballot_sync(~0u, c[k]);
      const uint32_t wd = __ballot_sync(~0u, cw[k]);
      npre += __popc(tr);
      if (lane < 4)   // lanes 0-3: the trace, the teacher's masks, the winner's
        sl[4 + lane * F + w0 + k] = lane == 0   ? tr
                                    : lane == 1 ? (tr & cm)
                                    : lane == 2 ? (~tr & cm)
                                                : wd;
    }
  }
  if (lane == 0) {
    const long long y = label_bytes == 8
                            ? static_cast<const long long*>(labels)[i]
                            : static_cast<const int32_t*>(labels)[i];
    long long r = y < 0 ? y + n_out : y;
    r = r < 0 ? 0 : (r >= n_out ? n_out - 1 : r);
    *reinterpret_cast<uint4*>(sl) = make_uint4(
        (uint32_t)npre, (uint32_t)r,
        (y >= 0 && y < n_out) ? (uint32_t)y : ~0u, 0u);
  }
}

// ---- the matrix-RNG epoch: stdp_update_keys, stdp_update_masks ------- //

// The scan's key chain on one thread: keys[i] = k_i with k_0 = key and
// k_{i+1} = split(k_i, 3)[0] = threefry(k_i, (0, 0)).  Strictly serial:
// samples x the latency of one threefry.  stamps (or null): clock64 at its
// start and end.
__global__ void update_keys_kernel(uint2* __restrict__ keys, int n,
                                   const long long* __restrict__ key,
                                   long long* stamps) {
  if (threadIdx.x) return;
  const long long t0 = clock64();
  uint2 k = make_uint2((uint32_t)key[0], (uint32_t)key[1]);
  for (int i = 0; i < n; ++i) {
    keys[i] = k;
    k = threefry2x32(k.x, k.y, 0u, 0u);
  }
  if (stamps) {
    stamps[0] = t0;
    stamps[1] = clock64();
  }
}

// A lane's four words' values as lane l < 4 stores them (word w0 + l).
__device__ __forceinline__ uint32_t pick4(const uint32_t (&v)[4], int l) {
  return l == 0 ? v[0] : l == 1 ? v[1] : l == 2 ? v[2] : v[3];
}

// One warp a (sample i, row o) pair, so that a short epoch still spreads
// over the card: from k_i, the teacher row derives k1 = split(k_i, 3)[1]
// and its potentiate and depress keys split(k1)[0] and [1]; any other row
// k2 = split(k_i, 3)[2] and the winner's depress key split(k2)[1] (its
// potentiate draw is never read: p_pot 0).  Row o's draw at input j reads
// counter (0, j * n_out + o), the flat index of the reference's
// [n_in, n_out] uniform matrix: the teacher row at every input, another
// row where the trace is 1 (and not at all in a chunk of four trace words
// that are all empty); the draws of a chunk are independent.  Row 0's warp
// also writes the header and the trace, and the potentiate field where
// there is no teacher (zero).
__global__ void __launch_bounds__(kMaskWarps * 32)
update_masks_kernel(uint32_t* __restrict__ slots,
                    const uint8_t* __restrict__ pre, long long ldp, int n,
                    int n_in, int n_out, const void* labels, int label_bytes,
                    const uint2* __restrict__ keys, uint32_t t_pot,
                    uint32_t t_dep) {
  const int lane = threadIdx.x & 31;
  const long long pair = (long long)blockIdx.x * kMaskWarps + (threadIdx.x >> 5);
  if (pair >= (long long)n * n_out) return;   // the whole warp
  const int i = (int)(pair / n_out), o = (int)(pair - (long long)i * n_out);
  const int W = epoch_words(n_in), F = field_words(W);
  uint32_t* sl = slots + (size_t)i * update_slot_words(W, n_out);
  const uint8_t* row = pre + (long long)i * ldp;
  const long long y = label_bytes == 8 ? static_cast<const long long*>(labels)[i]
                                       : static_cast<const int32_t*>(labels)[i];
  const bool teacher = y == o;
  // the row's keys: lane 0 the potentiate key (teacher only), lane 1 the
  // depress key
  const uint2 ki = keys[i];
  const uint2 kr = threefry2x32(ki.x, ki.y, 0u, teacher ? 1u : 2u);
  const uint2 kq = threefry2x32(kr.x, kr.y, 0u, lane == 0 && teacher ? 0u : 1u);
  const uint32_t ppx = __shfl_sync(~0u, kq.x, 0), ppy = __shfl_sync(~0u, kq.y, 0);
  const uint32_t pdx = __shfl_sync(~0u, kq.x, 1), pdy = __shfl_sync(~0u, kq.y, 1);
  int npre = 0;
  for (int w0 = 0; w0 < F; w0 += kMaskChunk) {   // F is a multiple of 4
    bool t[kMaskChunk];
    uint32_t tr[kMaskChunk], dep[kMaskChunk], pot[kMaskChunk];
#pragma unroll
    for (int k = 0; k < kMaskChunk; ++k) {
      const int j = 32 * (w0 + k) + lane;
      t[k] = j < n_in && row[j] != 0;
      tr[k] = __ballot_sync(~0u, t[k]);
      npre += __popc(tr[k]);
    }
    bool c[kMaskChunk] = {false, false, false, false};
    if (teacher || (tr[0] | tr[1] | tr[2] | tr[3])) {
#pragma unroll
      for (int k = 0; k < kMaskChunk; ++k) {
        const uint32_t j = 32u * (uint32_t)(w0 + k) + (uint32_t)lane;
        const bool up = teacher && t[k];
        const uint32_t f = draw23(up ? ppx : pdx, up ? ppy : pdy,
                                  (int)(j * (uint32_t)n_out + (uint32_t)o));
        c[k] = (int)j < n_in && f < (up ? t_pot : t_dep);
      }
    }
#pragma unroll
    for (int k = 0; k < kMaskChunk; ++k) {
      dep[k] = __ballot_sync(~0u, c[k] && teacher != t[k]);
      pot[k] = __ballot_sync(~0u, c[k] && teacher && t[k]);
    }
    if (lane < kMaskChunk) {
      sl[4 + (2 + o) * F + w0 + lane] = pick4(dep, lane);
      if (teacher || (o == 0 && (y < 0 || y >= n_out)))
        sl[4 + F + w0 + lane] = pick4(pot, lane);
      if (o == 0) sl[4 + w0 + lane] = pick4(tr, lane);
    }
  }
  if (o == 0 && lane == 0) {
    const uint32_t label = (y < 0 || y >= n_out) ? ~0u : (uint32_t)y;
    *reinterpret_cast<uint4*>(sl) =
        make_uint4((uint32_t)npre, label, label, 0u);
  }
}

// ---- the chain's fetch: a ring of kBufs batches of slots -------------- //

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
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

// The slots of the epoch, fetched by the chain warp itself: batch b
// (samples 2^shift b, ...) goes to buffer b % kBufs as one bulk copy issued
// by lane 0 and completing on that buffer's mbarrier; a buffer is refilled
// once the warp has read its batch.  One wait and one copy every batch
// (16 slots, fewer where the slots are wide): a cp.async a sample cost
// ~170 clocks a step on the card.
struct Ring {
  uint32_t* buf;         // [kBufs << shift][SW]
  uint64_t* bars;        // [kBufs]
  const uint32_t* src;   // the slots in device memory
  int SW, n, shift;      // words a slot, samples, log2 of slots a batch

  __device__ const uint32_t* slot(int i) const {
    return buf + (size_t)(i & ((kBufs << shift) - 1)) * SW;
  }
  __device__ void issue(int b) const {   // one lane
    const int s0 = b << shift;
    if (s0 >= n) return;
    const unsigned bytes = 4u * (unsigned)(min(1 << shift, n - s0) * SW);
    uint64_t* bar = bars + b % kBufs;
    mbar_expect(bar, bytes);
    bulk_load(buf + ((size_t)(b % kBufs) << shift) * SW,
              src + (size_t)s0 * SW, bytes, bar);
  }
  __device__ void start() const {   // one lane: the first kBufs batches
    for (int b = 0; b < kBufs; ++b) mbar_init(bars + b, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int b = 0; b < kBufs; ++b) issue(b);
  }
  // Wait for the batch holding sample i when i starts one.
  __device__ void wait_for(int i) const {
    if (i & ((1 << shift) - 1)) return;
    const int b = i >> shift;
    mbar_wait(bars + b % kBufs, (unsigned)(b / kBufs) & 1u);
  }
  // After sample i is read: when it ends a batch, refill that buffer (the
  // warp's reads ordered before the copy's writes).
  __device__ void release(int i, int lane) const {
    if ((i + 1) & ((1 << shift) - 1)) return;
    __syncwarp();
    if (lane == 0) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(((i + 1) >> shift) - 1 + kBufs);
    }
  }
};

// argmax order as one uint32 (larger value, larger key; ties go to the
// lower row), with NaN above every number, as in jnp.argmax and
// torch.argmax.  v is an integer plus an offset, so it is never -0.0.
__device__ __forceinline__ uint32_t order_key(float v) {
  const uint32_t b = __float_as_uint(v);
  return v != v ? ~0u : b ^ ((uint32_t)((int32_t)b >> 31) | 0x80000000u);
}

// A field of WMAX words (its whole width on the register routes) into
// registers.
template <int WMAX>
__device__ __forceinline__ void load_field(const uint32_t* p,
                                           uint32_t (&out)[WMAX]) {
#pragma unroll
  for (int q = 0; q < WMAX / 4; ++q) {
    const uint4 v = reinterpret_cast<const uint4*>(p)[q];
    out[4 * q] = v.x; out[4 * q + 1] = v.y;
    out[4 * q + 2] = v.z; out[4 * q + 3] = v.w;
  }
}

// The chain with the readout in registers: lane o holds rows o + 32 k,
// k < R, words [0, WMAX) each (zero past W); a row past n_out has offset
// -inf, below every real row.  Per step: the next sample's header and
// trace, loaded off the chain; popc of trace & row words, the offset add,
// the key, one __reduce_max_sync of the keys, the sample's masks while it is
// in flight, __ballot_sync / __ffs for the lowest row holding the max, and
// the owners' writes (old & ~dep) | pot.  PerRow (the matrix-RNG epoch):
// each lane loads its own rows' depress masks and the teacher's potentiate
// mask; else (the column events) every lane loads the teacher's two masks
// and the winner's one, broadcast.
// Clocks a step on an H100 at 256 -> 10 (probes/epoch_chain_probe.py,
// one-warp copies of this loop): 536 with a cp.async a sample, 417 with
// batched bulk copies, 362 with the 2-op key; this kernel 381.  Slower:
// the b1 tensor-core product in the popc's place (487), two lanes a row
// (563).  Where the loads sit moves a step by +-40 clocks between builds.
template <int WMAX, int R, bool PerRow>
__device__ int chain_registers(const Ring& ring, uint32_t* planes,
                               const float* off, int n_out, int W, int n) {
  const int lane = threadIdx.x & 31, S = W | 1;
  constexpr int F = WMAX;   // field_words(W) on this route
  uint32_t pl[R][WMAX];
  float of[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int row = lane + 32 * k;
    of[k] = row < n_out ? off[row] : __int_as_float((int)0xff800000u);
#pragma unroll
    for (int w = 0; w < WMAX; ++w)
      pl[k][w] = row < n_out && w < W ? planes[row * S + w] : 0u;
  }
  if (lane == 0) ring.start();
  __syncwarp();
  if (n > 0) ring.wait_for(0);
  uint4 hdr = *reinterpret_cast<const uint4*>(ring.slot(0));
  uint32_t tr[WMAX];
  load_field<WMAX>(ring.slot(0) + 4, tr);
  int wrong = 0;
  for (int i = 0; i < n; ++i) {
    const uint32_t* sl = ring.slot(i);
    // the next sample's header and trace (stale past n)
    const int i1 = i + 1;
    if (i1 < n) ring.wait_for(i1);
    const uint4 nhdr = *reinterpret_cast<const uint4*>(ring.slot(i1));
    uint32_t ntr[WMAX];
    load_field<WMAX>(ring.slot(i1) + 4, ntr);
    // readout and argmax
    uint32_t key[R], best = 0u;
#pragma unroll
    for (int k = 0; k < R; ++k) {
      int c = 0;
#pragma unroll
      for (int w = 0; w < WMAX; ++w) c += __popc(tr[w] & pl[k][w]);
      key[k] = order_key(__fadd_rn((float)(2 * c - (int)hdr.x), of[k]));
      best = max(best, key[k]);
    }
    const uint32_t top = __reduce_max_sync(~0u, best);
    // this sample's masks, issued while the reduction is in flight (the
    // compiler would hoist them above the readout)
    asm volatile("" ::: "memory");
    uint32_t tpot[WMAX], tdep[WMAX], dep[PerRow ? R : 1][WMAX];
    load_field<WMAX>(sl + 4 + F, tpot);
    if constexpr (PerRow) {
#pragma unroll
      for (int k = 0; k < R; ++k)
        load_field<WMAX>(sl + 4 + (2 + min(lane + 32 * k, n_out - 1)) * F,
                         dep[k]);
    } else {
      load_field<WMAX>(sl + 4 + 2 * F, tdep);
      load_field<WMAX>(sl + 4 + 3 * F, dep[0]);
    }
    int arg = -1;   // rows 32 k, ... in order
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const unsigned m = __ballot_sync(~0u, key[k] == top);
      if (arg < 0 && m) arg = 32 * k + __ffs(m) - 1;
    }
    if ((uint32_t)arg != hdr.z) {   // wrong: the teacher row, then the winner
      ++wrong;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int row = lane + 32 * k;
        const uint32_t* wdep = dep[PerRow ? k : 0];
        if (row == (int)hdr.y) {
#pragma unroll
          for (int w = 0; w < WMAX; ++w)
            pl[k][w] = (pl[k][w] & ~(PerRow ? wdep[w] : tdep[w])) | tpot[w];
        }
        if (row == arg) {
#pragma unroll
          for (int w = 0; w < WMAX; ++w) pl[k][w] &= ~wdep[w];
        }
      }
    }
    ring.release(i, lane);
    hdr = nhdr;
#pragma unroll
    for (int w = 0; w < WMAX; ++w) tr[w] = ntr[w];
  }
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int row = lane + 32 * k;
#pragma unroll
    for (int w = 0; w < WMAX; ++w)
      if (row < n_out && w < W) planes[row * S + w] = pl[k][w];
  }
  return wrong;
}

// The chain with the readout as bit planes in shared memory (any width that
// fits): lane o's rows o, o + 32, ..., popc of trace & row words.  A teacher
// row outside [0, n_out) (the matrix-RNG epoch's bad label) is not written.
template <bool PerRow>
__device__ int chain_shared(const Ring& ring, uint32_t* planes,
                            const float* off, int n_out, int W, int n) {
  const int lane = threadIdx.x & 31, S = W | 1, F = field_words(W);
  if (lane == 0) ring.start();
  __syncwarp();
  int wrong = 0;
  for (int i = 0; i < n; ++i) {
    ring.wait_for(i);
    const uint32_t* sl = ring.slot(i);
    const uint32_t* tr = sl + 4;
    uint32_t best = 0u, brow = ~0u;
    for (int o = lane; o < n_out; o += 32) {
      const uint32_t* row = planes + (size_t)o * S;
      int c = 0;
      for (int w = 0; w < W; ++w) c += __popc(tr[w] & row[w]);
      const uint32_t key =
          order_key(__fadd_rn((float)(2 * c - (int)sl[0]), off[o]));
      if (key > best) {
        best = key;
        brow = o;
      }
    }
    const uint32_t top = __reduce_max_sync(~0u, best);
    const int arg = (int)__reduce_min_sync(~0u, best == top ? brow : ~0u);
    if ((uint32_t)arg != sl[2]) {   // wrong: the teacher row, then the winner
      const uint32_t y = sl[1];
      const bool teach = y < (uint32_t)n_out;
      const uint32_t* pot = sl + 4 + F;
      const uint32_t* tdep = sl + 4 + (PerRow ? (2 + (teach ? y : 0)) : 2) * F;
      const uint32_t* wdep = sl + 4 + (PerRow ? 2 + arg : 3) * F;
      uint32_t* trow = planes + (size_t)(teach ? y : 0) * S;
      uint32_t* win = planes + (size_t)arg * S;
      for (int w = lane; w < W; w += 32) {
        if (teach) trow[w] = (trow[w] & ~tdep[w]) | pot[w];
        win[w] &= ~wdep[w];
      }
      ++wrong;
    }
    __syncwarp();   // the rows written before the next sample reads them
    ring.release(i, lane);
  }
  return wrong;
}

// WMAX > 0: the readout in registers, WMAX words a row and R rows a lane;
// WMAX == 0: in shared memory.  PerRow: the matrix-RNG epoch's slots
// (update_slot_words), and *wrong_out gets the reference's update count, 2
// a wrong sample; else the column events' (slot_words), and the wrong
// samples.  SW: words a slot; shift: log2 of slots a bulk copy.  stamps (or
// null): clock64 at the start, at the chain's start and end, after the
// write-back.
template <int WMAX, int R, bool PerRow>
__global__ void __launch_bounds__(kEpochThreads, 1)
column_epoch_kernel(int8_t* __restrict__ bits, int n_out, int n_in,
                    long long ld, const uint32_t* __restrict__ slots, int n,
                    int SW, int shift, const float* __restrict__ offset,
                    int32_t* __restrict__ wrong_out, long long* stamps) {
  extern __shared__ __align__(16) uint32_t smem[];
  const long long t0 = clock64();
  const int W = epoch_words(n_in), S = W | 1;
  const Ring ring{smem,
                  reinterpret_cast<uint64_t*>(smem + ring_words(SW, shift)),
                  slots, SW, n, shift};
  uint32_t* planes = smem + ring_words(SW, shift) + 2 * kBufs;   // [n_out][S]
  float* off = reinterpret_cast<float*>(planes + (size_t)n_out * S);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // stage the readout as planes: 4 words a warp at once
  const int tasks = n_out * W;
  for (int t4 = 4 * warp; t4 < tasks; t4 += 4 * kEpochWarps) {
    bool b[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int t = t4 + k, o = t / W, j = 32 * (t - o * W) + lane;
      b[k] = t < tasks && j < n_in && bits[o * ld + j] != 0;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const unsigned m = __ballot_sync(~0u, b[k]);
      const int t = t4 + k, o = t / W;
      if (lane == 0 && t < tasks) planes[(size_t)o * S + (t - o * W)] = m;
    }
  }
  for (int o = threadIdx.x; o < n_out; o += blockDim.x)
    off[o] = offset ? offset[o] : 0.f;
  __syncthreads();

  if (warp == 0) {
    const long long t1 = clock64();
    int wrong;
    if constexpr (WMAX > 0)
      wrong = chain_registers<WMAX, R, PerRow>(ring, planes, off, n_out, W, n);
    else
      wrong = chain_shared<PerRow>(ring, planes, off, n_out, W, n);
    const long long t2 = clock64();
    if (lane == 0) {
      *wrong_out = PerRow ? 2 * wrong : wrong;
      if (stamps) {
        stamps[0] = t0;
        stamps[1] = t1;
        stamps[2] = t2;
      }
    }
  }
  __syncthreads();
  for (long long t = threadIdx.x; t < (long long)n_out * n_in; t += blockDim.x) {
    const int o = (int)(t / n_in), j = (int)(t - (long long)o * n_in);
    bits[o * ld + j] = (int8_t)((planes[(size_t)o * S + (j >> 5)] >> (j & 31)) & 1u);
  }
  __syncthreads();
  if (stamps && threadIdx.x == 0) stamps[3] = clock64();
}

template <int WMAX, int R, bool PerRow>
int launch_chain(size_t smem, cudaStream_t stream, int8_t* bits, int n_out,
                 int n_in, long long ld, const uint32_t* slots, int n, int SW,
                 int shift, const float* offset, int32_t* wrong,
                 long long* stamps) {
  auto kernel = column_epoch_kernel<WMAX, R, PerRow>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<1, kEpochThreads, smem, stream>>>(bits, n_out, n_in, ld, slots, n,
                                             SW, shift, offset, wrong, stamps);
  return (int)cudaGetLastError();
}

// The chain on one of its routes: (wmax, rows) in registers, (0, 0) in
// shared memory.
template <bool PerRow>
int launch_chain_route(int wmax, int rows, cudaStream_t st, int8_t* b,
                       int n_out, int n_in, long long ld,
                       const uint32_t* sl, int n, int SW, int shift,
                       const float* off, int32_t* wr, long long* ts) {
  if (n_out < 1 || n_in < 1 || n < 0 || shift < 0 || shift > kBatchShift)
    return (int)cudaErrorInvalidValue;
  if (wmax != 0 && (field_words(epoch_words(n_in)) != wmax ||
                    (n_out + 31) / 32 != rows))
    return (int)cudaErrorInvalidValue;
  const size_t smem = chain_smem_bytes(n_out, n_in, SW, shift);
#define STDP_CHAIN_ROUTE(WM, R)                                           \
  if (wmax == WM && rows == R)                                            \
    return launch_chain<WM, R, PerRow>(smem, st, b, n_out, n_in, ld, sl, n, \
                                       SW, shift, off, wr, ts);
  STDP_CHAIN_ROUTE(8, 1)
  STDP_CHAIN_ROUTE(16, 1)
  STDP_CHAIN_ROUTE(32, 1)
  STDP_CHAIN_ROUTE(8, 2)
  STDP_CHAIN_ROUTE(16, 2)
  STDP_CHAIN_ROUTE(0, 0)
#undef STDP_CHAIN_ROUTE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// In-place event on row *col of bits int8[n_out, n_in] (row stride ld),
// when *apply.  col: int32 or int64 (col_bytes 4 or 8); apply: bool;
// pre: uint8[n_in]; u_pot, u_dep: float32[n_in].  The route ops._event_route
// gives: vec (4-input loads) and `grid` blocks of kEventThreads along the
// row's groups of 4 inputs.
// Returns cudaGetLastError().
int stdp_column_event(void* bits, int n_out, int n_in, long long ld,
                      const void* col, int col_bytes, const void* apply,
                      const void* pre, const void* u_pot,
                      const void* u_dep, float p_pot, float p_dep,
                      int vec, int grid, void* stream) {
  if (n_out < 1 || n_in < 1 || (col_bytes != 4 && col_bytes != 8))
    return (int)cudaErrorInvalidValue;
  if (vec && (n_in % 4 || (n_out > 1 && ld % 4) || (uintptr_t)bits % 4 ||
              (uintptr_t)pre % 4 || (uintptr_t)u_pot % 16 ||
              (uintptr_t)u_dep % 16))
    return (int)cudaErrorMisalignedAddress;
  const long long chunks = (n_in + kEventInputs - 1) / kEventInputs;
  if ((long long)grid * kEventThreads < chunks)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define STDP_EVENT_ROUTE(V, C)                                              \
  if ((vec != 0) == V && (col_bytes == 8) == C)                             \
    column_event_kernel<V, C><<<grid, kEventThreads, 0, st>>>(              \
        (int8_t*)bits, n_out, n_in, ld, col, (const bool*)apply,            \
        (const uint8_t*)pre, (const float*)u_pot, (const float*)u_dep,     \
        p_pot, p_dep);                                                      \
  else
  STDP_EVENT_ROUTE(true, true)
  STDP_EVENT_ROUTE(true, false)
  STDP_EVENT_ROUTE(false, true)
  STDP_EVENT_ROUTE(false, false)
  return (int)cudaErrorInvalidValue;
#undef STDP_EVENT_ROUTE
  return (int)cudaGetLastError();
}

// out int8[n_out, n_in] = the rule on the rows of bits where post != 0
// (all arrays contiguous; pre uint8[n_in], post uint8[n_out], u_pot/u_dep
// float32[n_out, n_in]).  Returns cudaGetLastError().
int stdp_update(const void* bits, void* out, int n_out, int n_in,
                const void* pre, const void* post, const void* u_pot,
                const void* u_dep, float p_pot, float p_dep, void* stream) {
  if (n_out < 1 || n_in < 1) return (int)cudaErrorInvalidValue;
  const long long total = (long long)n_out * n_in;
  const int grid = (int)((total + kThreads - 1) / kThreads);
  stdp_update_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)bits, (int8_t*)out, n_out, n_in, (const uint8_t*)pre,
      (const uint8_t*)post, (const float*)u_pot, (const float*)u_dep, p_pot,
      p_dep);
  return (int)cudaGetLastError();
}

// Dynamic shared memory the one block of stdp_column_epoch needs.
long long stdp_column_epoch_smem_bytes(int n_out, int n_in) {
  return (long long)chain_smem_bytes(n_out, n_in,
                                     slot_words(epoch_words(n_in)),
                                     kBatchShift);
}

// Dynamic shared memory the one block of stdp_update_chain needs when a bulk
// copy fetches 2^shift slots.
long long stdp_update_chain_smem_bytes(int n_out, int n_in, int shift) {
  return (long long)chain_smem_bytes(
      n_out, n_in, update_slot_words(epoch_words(n_in), n_out), shift);
}

// Largest dynamic shared memory a block may opt in to on `device`, or -1.
long long stdp_max_shared_optin(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

// The epoch's slots, one a sample: slots uint32[n, 4 + 4 F] with F =
// field_words(ceil(n_in / 32)) (16-byte aligned; ref.epoch_slot_words);
// pre uint8[n, n_in] with row stride ldp; labels int32 or int64
// (label_bytes 4 or 8) [n]; key int64[2] (two uint32 words); t_pot, t_dep:
// uniform_threshold(p_pot), uniform_threshold(p_dep).  Returns
// cudaGetLastError() (0 without a launch when n is 0).
int stdp_epoch_masks(void* slots, const void* pre, long long ldp, int n,
                     int n_in, int n_out, const void* labels, int label_bytes,
                     const void* key, unsigned t_pot, unsigned t_dep,
                     void* stream) {
  if (n_out < 1 || n_in < 1 || n < 0 || (label_bytes != 4 && label_bytes != 8))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int grid = (n + kMaskWarps - 1) / kMaskWarps;
  epoch_masks_kernel<<<grid, kMaskWarps * 32, 0, (cudaStream_t)stream>>>(
      (uint32_t*)slots, (const uint8_t*)pre, ldp, n, n_in, n_out, labels,
      label_bytes, (const long long*)key, t_pot, t_dep);
  return (int)cudaGetLastError();
}

// One epoch of n samples on bits int8[n_out, n_in] (row stride ld), in
// place, in ONE block, from the slots stdp_epoch_masks wrote; offset
// float32[n_out] or null (no offset).  (wmax, rows): the readout in
// registers, wmax words a row (8, 16 or 32) and rows a lane (1, or 2 with
// wmax <= 16), or (0, 0): in shared memory.  *wrong gets the number of wrong
// samples; stamps int64[4] or null.  Returns cudaGetLastError().
int stdp_column_epoch(void* bits, int n_out, int n_in, long long ld,
                      const void* slots, int n, const void* offset, int wmax,
                      int rows, void* wrong, void* stamps, void* stream) {
  return launch_chain_route<false>(
      wmax, rows, (cudaStream_t)stream, (int8_t*)bits, n_out, n_in, ld,
      (const uint32_t*)slots, n, slot_words(epoch_words(n_in)), kBatchShift,
      (const float*)offset, (int32_t*)wrong, (long long*)stamps);
}

// The matrix-RNG epoch's key chain: keys uint32[n, 2] = k_0 .. k_{n-1} from
// key int64[2]; stamps int64[2] or null.  One thread.  Returns
// cudaGetLastError() (0 without a launch when n is 0).
int stdp_update_keys(void* keys, int n, const void* key, void* stamps,
                     void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  update_keys_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (uint2*)keys, n, (const long long*)key, (long long*)stamps);
  return (int)cudaGetLastError();
}

// The matrix-RNG epoch's slots, one a sample: slots uint32[n, 4 + (2 +
// n_out) F] (ref.update_slot_words); pre, labels, t_pot and t_dep as for
// stdp_epoch_masks; keys uint32[n, 2] from stdp_update_keys.  Returns
// cudaGetLastError() (0 without a launch when n is 0).
int stdp_update_masks(void* slots, const void* pre, long long ldp, int n,
                      int n_in, int n_out, const void* labels,
                      int label_bytes, const void* keys, unsigned t_pot,
                      unsigned t_dep, void* stream) {
  if (n_out < 1 || n_in < 1 || n < 0 || (label_bytes != 4 && label_bytes != 8))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const long long pairs = (long long)n * n_out;
  if ((pairs + kMaskWarps - 1) / kMaskWarps > 0x7fffffffll)
    return (int)cudaErrorInvalidValue;
  const int grid = (int)((pairs + kMaskWarps - 1) / kMaskWarps);
  update_masks_kernel<<<grid, kMaskWarps * 32, 0, (cudaStream_t)stream>>>(
      (uint32_t*)slots, (const uint8_t*)pre, ldp, n, n_in, n_out, labels,
      label_bytes, (const uint2*)keys, t_pot, t_dep);
  return (int)cudaGetLastError();
}

// The matrix-RNG epoch's chain over stdp_update_masks' slots, in place, in
// ONE block, 2^shift slots a bulk copy (0 <= shift <= 4); routes as for
// stdp_column_epoch; no offset.  *count gets the reference's update count
// (2 a wrong sample).  Returns cudaGetLastError().
int stdp_update_chain(void* bits, int n_out, int n_in, long long ld,
                      const void* slots, int n, int shift, int wmax, int rows,
                      void* count, void* stamps, void* stream) {
  return launch_chain_route<true>(
      wmax, rows, (cudaStream_t)stream, (int8_t*)bits, n_out, n_in, ld,
      (const uint32_t*)slots, n, update_slot_words(epoch_words(n_in), n_out),
      shift, nullptr, (int32_t*)count, (long long*)stamps);
}

const char* stdp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
