// IF neuron array over T rounds (accumulate in order, then fire), for NVIDIA
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX reference
//   if_neuron  <- src/repro/kernels/if_neuron/kernel.py:23 _if_kernel
// which keeps each neuron's V_mem in VMEM across the T rounds of int32
// updates [B, T, N], adds them in order (a fori_loop of int32 adds, which
// XLA wraps on overflow), and fires at V >= vth:
//
//     vmem[b, n]   = sum_t updates[b, t, n]      (int32, wrapping)
//     spikes[b, n] = vmem[b, n] >= vth[n]        (equality fires)
//
// Signed overflow is undefined in C++, so the sum runs in uint32_t and is
// reinterpreted as int32 at the end: the same bits as the wrapping adds.
//
// What bounds it on an H100: bytes.  Each update is read once (4 B) and each
// neuron writes 5 B; at the kernel bench's 8 x 32 x 256 that is 0.27 MB,
// about 0.08 us at 3.35 TB/s, well under a launch, so the kernel is
// launch-bound by nature.  Design: one thread per (b, n) in a grid-stride
// loop, looping over T; neighbouring threads take neighbouring n, so every
// round's load is coalesced and V_mem stays in a register.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
if_neuron_kernel(const int32_t* __restrict__ updates,
                 const int32_t* __restrict__ vth,
                 int8_t* __restrict__ spikes, int32_t* __restrict__ vmem,
                 long long total, int T, int N) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const long long b = i / N;
    const int n = (int)(i - b * N);
    const int32_t* u = updates + b * T * N + n;
    uint32_t v = 0u;
    for (int t = 0; t < T; ++t) v += (uint32_t)__ldg(u + (long long)t * N);
    const int32_t vi = (int32_t)v;
    vmem[i] = vi;
    spikes[i] = vi >= __ldg(vth + n) ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// (spikes int8[B, N], vmem int32[B, N]) from contiguous updates
// int32[B, T, N] and vth int32[N]; `blocks` caps the grid.  Returns
// cudaGetLastError().
int if_neuron(const void* updates, const void* vth, void* spikes, void* vmem,
              int B, int T, int N, int blocks, void* stream) {
  if (B < 1 || T < 0 || N < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  const long long total = (long long)B * N;
  const long long want = (total + kThreads - 1) / kThreads;
  const int grid = (int)(want < blocks ? want : blocks);
  if_neuron_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)updates, (const int32_t*)vth, (int8_t*)spikes,
      (int32_t*)vmem, total, T, N);
  return (int)cudaGetLastError();
}

const char* if_neuron_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
