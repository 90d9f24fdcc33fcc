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
// N_in * 10 bytes); it is launch-bound by nature.
//
// stdp_update is the same rule over the full matrix, masked by `post` per
// row: elementwise, one thread per synapse, bound by its ~10 bytes per
// synapse of traffic.
//
// stdp_column_epoch runs a whole epoch in one launch of ONE block.  The
// epoch is a strict chain (sample i+1 reads the bits sample i wrote), so
// its time is samples x the latency of one step, not bytes or operations:
// the design shortens that step.  The readout stays resident in shared
// memory as bit planes (uint32 words, row stride odd so that 32 rows are 32
// banks), warp 0 runs the chain alone (no block barrier per sample), and
// the other warps pack the samples ahead into a ring of shared slots: per
// 32 inputs one ballot each of the pre trace and of the four rule compares,
// so the chain reads ready-made masks.  One step of warp 0: a popcount
// matvec (lane o owns output o), one rounded offset add, a five-shuffle
// first-index argmax, and two masked row writes, (old & ~dep) | pot.  A
// label outside [0, N_out) is wrapped once if negative and clamped for the
// teacher row, as the reference's interpret-mode block index is, and
// always counts as wrong.  The bits and the count go back once at the end.

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

__device__ __forceinline__ long long load_index(const void* p, int bytes) {
  return bytes == 8 ? *static_cast<const long long*>(p)
                    : (long long)*static_cast<const int32_t*>(p);
}

// One block of kThreads walks the event row; a row index out of [0, n_out)
// is wrapped once if negative and clamped, as the reference's
// interpret-mode block index is.
__global__ void __launch_bounds__(kThreads)
column_event_kernel(int8_t* __restrict__ bits, int n_out, int n_in,
                    long long ld, const void* col, int col_bytes,
                    const bool* apply, const uint8_t* __restrict__ pre,
                    const float* __restrict__ u_pot,
                    const float* __restrict__ u_dep, float p_pot,
                    float p_dep) {
  if (!*apply) return;
  long long c = load_index(col, col_bytes);
  if (c < 0) c += n_out;
  c = c < 0 ? 0 : (c >= n_out ? n_out - 1 : c);
  int8_t* row = bits + c * ld;
  for (int i = threadIdx.x; i < n_in; i += blockDim.x)
    row[i] = rule(row[i], pre[i] != 0, __ldg(u_pot + i), __ldg(u_dep + i),
                  p_pot, p_dep);
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

// ---- stdp_column_epoch ------------------------------------------------ //

constexpr int kEpochThreads = 512;   // warp 0: the chain; warps 1..15: packing
constexpr int kEpochWarps = kEpochThreads / 32;
constexpr int kPackers = kEpochWarps - 1;
constexpr int kRing = 32;            // packed samples the ring holds
constexpr int kChunk = 8;            // input words a packing lane loads at once
// Spins a wait may take before the kernel traps: a broken handoff faults
// (an error at the caller's next synchronisation) instead of hanging the
// card.
constexpr long long kSpinLimit = 1ll << 32;   // tens of seconds

// One ring slot, in words: the pre trace, the teacher's potentiate and
// depress masks, the wrong winner's, then the trace's popcount, the teacher
// row and the label as the argmax compares it (~0u when out of range).
__host__ __device__ inline int epoch_words(int n_in) { return (n_in + 31) / 32; }
__host__ __device__ inline int slot_words(int W) { return 5 * W + 3; }

size_t epoch_smem_bytes(int n_out, int n_in) {
  const int W = epoch_words(n_in);
  const size_t words = (size_t)n_out * (W | 1) + (size_t)kRing * slot_words(W)
                       + kRing + 1 + n_out;
  return 4 * words;
}

// Does (b, ib) come first in argmax order: the larger value, NaN above
// every number, ties to the lower index (jnp.argmax and torch.argmax).
__device__ __forceinline__ bool beats(float b, int ib, float a, int ia) {
  const bool bn = b != b, an = a != a;
  if (bn || an) return bn && (!an || ib < ia);
  return b > a || (b == a && ib < ia);
}

__global__ void __launch_bounds__(kEpochThreads, 1)
column_epoch_kernel(int8_t* __restrict__ bits, int n_out, int n_in,
                    long long ld, const uint8_t* __restrict__ pre,
                    const void* labels, int label_bytes,
                    const float* __restrict__ u_pot,
                    const float* __restrict__ u_dep_t,
                    const float* __restrict__ u_dep_w, long long ldu,
                    const float* __restrict__ offset, int n, float p_pot,
                    float p_dep, int32_t* __restrict__ wrong_out) {
  extern __shared__ uint32_t smem[];
  const int W = epoch_words(n_in), S = W | 1, SW = slot_words(W);
  uint32_t* planes = smem;                               // [n_out][S]
  uint32_t* ring = planes + (size_t)n_out * S;           // [kRing][SW]
  volatile int* ready = (volatile int*)(ring + (size_t)kRing * SW);
  volatile int* consumed = ready + kRing;                // samples done
  float* off = (float*)(consumed + 1);                   // [n_out]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int t = warp; t < n_out * W; t += kEpochWarps) {
    const int o = t / W, w = t - o * W, j = 32 * w + lane;
    const unsigned m = __ballot_sync(~0u, j < n_in && bits[o * ld + j] != 0);
    if (lane == 0) planes[(size_t)o * S + w] = m;
  }
  for (int o = threadIdx.x; o < n_out; o += blockDim.x)
    off[o] = offset ? offset[o] : 0.f;
  for (int s = threadIdx.x; s < kRing; s += blockDim.x) ready[s] = 0;
  if (threadIdx.x == 0) *consumed = 0;
  __syncthreads();

  if (warp == 0) {
    // the chain: one sample after another, this warp alone
    int wrong_total = 0;
    for (int i = 0; i < n; ++i) {
      const int slot = i % kRing;
      for (long long spin = 0; ready[slot] != i + 1;)
        if (++spin > kSpinLimit) __trap();
      __threadfence_block();
      const uint32_t* sl = ring + (size_t)slot * SW;
      const int npre = (int)sl[5 * W];
      float best = __int_as_float((int)0xff800000u);   // -inf
      int arg = 0x7fffffff;
      for (int o = lane; o < n_out; o += 32) {
        const uint32_t* row = planes + (size_t)o * S;
        int c = 0;
        for (int w = 0; w < W; ++w) c += __popc(sl[w] & row[w]);
        const float v = __fadd_rn((float)(2 * c - npre), off[o]);
        if (beats(v, o, best, arg)) {
          best = v;
          arg = o;
        }
      }
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) {
        const float v = __shfl_xor_sync(~0u, best, d);
        const int o = __shfl_xor_sync(~0u, arg, d);
        if (beats(v, o, best, arg)) {
          best = v;
          arg = o;
        }
      }
      if ((uint32_t)arg != sl[5 * W + 2]) {   // wrong: both rows learn
        uint32_t* teach = planes + (size_t)sl[5 * W + 1] * S;
        uint32_t* win = planes + (size_t)arg * S;
        for (int w = lane; w < W; w += 32) {
          teach[w] = (teach[w] & ~sl[2 * W + w]) | sl[W + w];
          win[w] = (win[w] & ~sl[4 * W + w]) | sl[3 * W + w];
        }
        ++wrong_total;
      }
      __syncwarp();
      if (lane == 0) {
        __threadfence_block();
        *consumed = i + 1;
      }
    }
    if (lane == 0) *wrong_out = wrong_total;
  } else {
    // packing: warp p takes samples p-1, p-1+kPackers, ... into the ring
    for (int i = warp - 1; i < n; i += kPackers) {
      const size_t base = (size_t)i * n_in, ubase = (size_t)i * ldu;
      if (lane == 0)
        for (long long spin = 0; *consumed <= i - kRing; __nanosleep(64))
          if (++spin > kSpinLimit >> 6) __trap();
      __syncwarp();
      __threadfence_block();
      uint32_t* sl = ring + (size_t)(i % kRing) * SW;
      int npre = 0;
      for (int w0 = 0; w0 < W; w0 += kChunk) {
        uint8_t pv[kChunk];
        float up[kChunk], ut[kChunk], uw[kChunk];
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          const int j = 32 * (w0 + k) + lane;
          const bool in = j < n_in;
          pv[k] = in ? __ldg(pre + base + j) : 0;
          up[k] = in ? __ldg(u_pot + ubase + j) : 0.f;
          ut[k] = in ? __ldg(u_dep_t + ubase + j) : 0.f;
          uw[k] = in ? __ldg(u_dep_w + ubase + j) : 0.f;
        }
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
          const int w = w0 + k;
          const bool in = 32 * w + lane < n_in;
          const unsigned tr = __ballot_sync(~0u, in && pv[k] != 0);
          const unsigned cp = __ballot_sync(~0u, in && up[k] < p_pot);
          const unsigned ct = __ballot_sync(~0u, in && ut[k] < p_dep);
          const unsigned c0 = __ballot_sync(~0u, in && uw[k] < 0.f);
          const unsigned cw = __ballot_sync(~0u, in && uw[k] < p_dep);
          npre += __popc(tr);
          if (lane == 0 && w < W) {
            sl[w] = tr;
            sl[W + w] = tr & cp;          // teacher: potentiate where pre
            sl[2 * W + w] = ~tr & ct;     // teacher: depress where silent
            sl[3 * W + w] = ~tr & c0;     // winner (trace !pre, p_pot 0)
            sl[4 * W + w] = tr & cw;      // winner: depress where pre
          }
        }
      }
      if (lane == 0) {
        const long long y = label_bytes == 8
                                ? static_cast<const long long*>(labels)[i]
                                : static_cast<const int32_t*>(labels)[i];
        long long r = y < 0 ? y + n_out : y;
        r = r < 0 ? 0 : (r >= n_out ? n_out - 1 : r);
        sl[5 * W] = (uint32_t)npre;
        sl[5 * W + 1] = (uint32_t)r;
        sl[5 * W + 2] = (y >= 0 && y < n_out) ? (uint32_t)y : ~0u;
        __threadfence_block();
        ready[i % kRing] = i + 1;
      }
    }
  }
  __syncthreads();
  for (long long t = threadIdx.x; t < (long long)n_out * n_in; t += blockDim.x) {
    const int o = (int)(t / n_in), j = (int)(t - (long long)o * n_in);
    bits[o * ld + j] = (int8_t)((planes[(size_t)o * S + (j >> 5)] >> (j & 31)) & 1u);
  }
}

}  // namespace

extern "C" {

// In-place event on row *col of bits int8[n_out, n_in] (row stride ld),
// when *apply.  col: int32 or int64 (col_bytes 4 or 8); apply: bool;
// pre: uint8[n_in]; u_pot, u_dep: float32[n_in].
// Returns cudaGetLastError().
int stdp_column_event(void* bits, int n_out, int n_in, long long ld,
                      const void* col, int col_bytes, const void* apply,
                      const void* pre, const void* u_pot,
                      const void* u_dep, float p_pot, float p_dep,
                      void* stream) {
  if (n_out < 1 || n_in < 1 || (col_bytes != 4 && col_bytes != 8))
    return (int)cudaErrorInvalidValue;
  column_event_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      (int8_t*)bits, n_out, n_in, ld, col, col_bytes, (const bool*)apply,
      (const uint8_t*)pre, (const float*)u_pot, (const float*)u_dep, p_pot,
      p_dep);
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
  return (long long)epoch_smem_bytes(n_out, n_in);
}

// Largest dynamic shared memory a block may opt in to on `device`, or -1.
long long stdp_max_shared_optin(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

// One epoch of n column-event samples on bits int8[n_out, n_in] (row stride
// ld), in place, in ONE block: pre uint8[n, n_in]; labels int32 or int64
// (label_bytes 4 or 8) [n]; u_pot, u_dep_t, u_dep_w float32[n, n_in] with
// row stride ldu; offset float32[n_out] or null (no offset).  *wrong gets
// the number of wrong samples.  Returns cudaGetLastError().
int stdp_column_epoch(void* bits, int n_out, int n_in, long long ld,
                      const void* pre, const void* labels, int label_bytes,
                      const void* u_pot, const void* u_dep_t,
                      const void* u_dep_w, long long ldu, const void* offset,
                      int n, float p_pot, float p_dep, void* wrong,
                      void* stream) {
  if (n_out < 1 || n_in < 1 || n < 0 || (label_bytes != 4 && label_bytes != 8))
    return (int)cudaErrorInvalidValue;
  const size_t smem = epoch_smem_bytes(n_out, n_in);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        column_epoch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  column_epoch_kernel<<<1, kEpochThreads, smem, (cudaStream_t)stream>>>(
      (int8_t*)bits, n_out, n_in, ld, (const uint8_t*)pre, labels,
      label_bytes, (const float*)u_pot, (const float*)u_dep_t,
      (const float*)u_dep_w, ldu, (const float*)offset, n, p_pot, p_dep,
      (int32_t*)wrong);
  return (int)cudaGetLastError();
}

const char* stdp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
