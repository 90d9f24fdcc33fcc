// What a small kernel that touches memory costs on an NVIDIA Hopper card,
// beside the IF neuron kernel (B11) at the kernel bench's 8 x 32 x 256.  It
// is no part of the port: it replaces no TPU kernel and no path runs it.
// probes/if_neuron_probe.py builds it and times each kernel in a CUDA graph:
//   spread_kernel: every thread of `grid` blocks loads one word and stores
//     it + 1 (one load and one store, spread over the card);
//   read_kernel: every thread loads 4 int4 (all threads' first int4, then
//     their second, ...: coalesced) and stores their sum as one word: B11's
//     reads at B11's geometry, without its shuffles, fire or V_mem store.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void spread_kernel(const int32_t* __restrict__ in,
                              int32_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  out[i] = in[i] + 1;
}

__global__ void read_kernel(const int4* __restrict__ in,
                            int32_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = gridDim.x * blockDim.x;
  int4 v[4];
#pragma unroll
  for (int l = 0; l < 4; ++l) v[l] = __ldg(in + i + l * n);
  int acc = 0;
#pragma unroll
  for (int l = 0; l < 4; ++l) acc += v[l].x + v[l].y + v[l].z + v[l].w;
  out[i] = acc;
}

}  // namespace

extern "C" {

// which 0: spread_kernel; 1: read_kernel (in: grid * threads * 4 int4).
// Returns cudaGetLastError().
int read_floor(int which, const void* in, void* out, int grid, int threads,
               void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (which == 0)
    spread_kernel<<<grid, threads, 0, st>>>((const int32_t*)in,
                                            (int32_t*)out);
  else if (which == 1)
    read_kernel<<<grid, threads, 0, st>>>((const int4*)in, (int32_t*)out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
