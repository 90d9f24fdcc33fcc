// The launch floor of one small kernel on an NVIDIA Hopper card: an empty
// kernel, and one whose single thread makes one global load and stores
// what it read (the least work a kernel with an input can do).  It is no
// part of the port: it replaces no TPU kernel and no path runs it.
// chip_smoke.py builds it on its own (nvcc, beside the kernel libraries),
// times each in a CUDA graph and prints both on its launch_floor line, so
// that a kernel's time at a small shape reads against what any launch
// costs: the part of a gap a kernel design can close, and the part only
// fewer launches can.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void empty_kernel() {}

__global__ void one_load_kernel(const int32_t* __restrict__ in,
                                int32_t* __restrict__ out) {
  if (threadIdx.x == 0) *out = *in + 1;
}

}  // namespace

extern "C" {

// which 0: the empty kernel (in, out unused); 1: one dependent load and
// store.  One block of 32 threads.  Returns cudaGetLastError().
int launch_floor(int which, const void* in, void* out, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (which == 0)
    empty_kernel<<<1, 32, 0, st>>>();
  else if (which == 1)
    one_load_kernel<<<1, 32, 0, st>>>((const int32_t*)in, (int32_t*)out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
