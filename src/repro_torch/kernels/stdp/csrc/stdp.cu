// Transposed-port stochastic 1-bit STDP for NVIDIA Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of the JAX reference:
//   stdp_column_event  <- src/repro/kernels/stdp/kernel.py:75 _column_event_kernel
//   stdp_update        <- src/repro/kernels/stdp/kernel.py:26 _stdp_kernel
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
// row index and aliased output buffer, so the online-learning loop never
// syncs with the host per sample.  Its bound is a few ns (one row of
// N_in * 10 bytes); it is launch-bound by nature, and the learning epoch's
// time is its launches per sample times the host's cost of one.
//
// stdp_update is the same rule over the full matrix, masked by `post` per
// row: elementwise, one thread per synapse, bound by its ~10 bytes per
// synapse of traffic.

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
// writes nothing.
__global__ void __launch_bounds__(kThreads)
column_event_kernel(int8_t* __restrict__ bits, int n_out, int n_in,
                    long long ld, const void* col, int col_bytes,
                    const bool* apply, const uint8_t* __restrict__ pre,
                    const float* __restrict__ u_pot,
                    const float* __restrict__ u_dep, float p_pot,
                    float p_dep) {
  if (!*apply) return;
  const long long c = load_index(col, col_bytes);
  if (c < 0 || c >= n_out) return;
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

const char* stdp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
