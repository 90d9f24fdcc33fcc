// One LIF timestep (leak, integrate, fire, reset, refractory) for NVIDIA
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX reference
//   lif_step  <- src/repro/kernels/lif_step/kernel.py:38 _lif_kernel
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
// Bound: elementwise, 3 reads and 3 writes per element (vmem, contrib,
// refrac in; spikes, vmem', refrac' out; 21 bytes) plus the [N] thresholds.
// At the event path's round of [64, 256] that is 0.34 MB, about 0.1 us at
// the card's memory rate, so the kernel is launch-bound by nature; it is one
// grid-stride pass with coalesced 4-byte accesses, and nothing more.

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

const char* lif_step_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
