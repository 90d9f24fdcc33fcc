// IF neuron array over T rounds (accumulate, then fire), for NVIDIA Hopper
// (sm_90a).
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
// reinterpreted as int32 at the end.  Wrapping uint32 addition is
// associative and commutative, so any order of adds gives the reference's
// bits: the rounds can be split across threads.
//
// What bounds it on an H100: bytes.  Each update is read once (4 B) and each
// neuron writes 5 B: at the kernel bench's 8 x 32 x 256 that is 0.27 MB,
// 0.082 us at 3.35 TB/s, far under a launch; at 4096 x 32 x 256, 139 MB,
// 41.6 us.  The earlier kernel (one thread a neuron looping over T, 8 CTAs
// whose threads each waited on one load after another) took 2.54-2.57 us
// in a CUDA graph at the bench's shape on an NVIDIA H100 80GB HBM3 (700 W;
// chip_smoke.py), ~1.0 us above a one-load kernel.  This design, on the
// same card and limit (probes/if_neuron_probe.py; PERF.md, section 6):
// 1.91 us, of which the launch floor is 1.20 (an empty kernel; 1.28 one
// that loads a word and stores it), and a kernel of the same 64 CTAs that
// only loads the same 262 KB and stores a word a thread takes 1.67; the
// slots' shuffle sum costs ~0.05 (1.87 without it).  At 4096 x 32 x 256 it
// streams at 48.38 us, as fast as that read alone (48.35) and 1.16x the
// bound.
//
// Design: every load of a thread is in flight before its first add, and the
// launch spreads over the card.
//   * A unit is 4 neighbouring neurons of one row b (one 16-byte int4 load a
//     round) when N % 4 == 0 and the operands are 16-byte aligned (kVec),
//     else one neuron (4-byte loads): the scalar path of the same kernel,
//     for any N and for contiguous views at any offset.
//   * A warp is uw units x 32 / uw span slots.  A span is kSpan = 4
//     neighbouring rounds; slot y takes spans y, y + 32 / uw, ...  Each
//     span's 4 loads and the threshold's load are issued together
//     (inline-PTX loads at addresses clamped into the tensors, so no branch
//     splits them, and registers for all of them), then added.  A slot's
//     units are neighbours, so each round's loads are coalesced.
//   * The slots' partial sums meet by xor shuffles (no shared memory, no
//     barrier); slot 0 stores V_mem (an int4 store on the vector path) and
//     the unit's spike bytes (one 4-byte store).
//   * ops._if_route picks uw, the warps a block and the grid (pure
//     Python, tested on the CPU): a small shape spreads over the card with
//     a few loads a thread, a large one streams in blocks of 256 threads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
// Rounds a thread loads at once (ops._SPAN mirrors it); a span past T
// loads clamped addresses and adds nothing, so one span serves every T.
constexpr int kSpan = 4;
// Blocks an SM the registers are sized for: 64 a thread, so a span's loads
// (4 x int4), the threshold and the sums are in registers at once (at 32,
// the compiler's choice without it, it split a span's loads around adds).
constexpr int kMinBlocks = 4;

template <bool kVec>
struct Unit;

template <>
struct Unit<true> {  // 4 neurons, one int4 a round
  static constexpr int kWidth = 4;
  using Word = int4;
  __device__ static void add(uint32_t (&acc)[4], const int4& v) {
    acc[0] += (uint32_t)v.x;
    acc[1] += (uint32_t)v.y;
    acc[2] += (uint32_t)v.z;
    acc[3] += (uint32_t)v.w;
  }
  __device__ static void store(int32_t* vmem, int8_t* spikes,
                               const uint32_t (&acc)[4], const int4& th) {
    const int4 v = make_int4((int32_t)acc[0], (int32_t)acc[1],
                             (int32_t)acc[2], (int32_t)acc[3]);
    *reinterpret_cast<int4*>(vmem) = v;
    const uint32_t fire = (uint32_t)(v.x >= th.x) |
                          (uint32_t)(v.y >= th.y) << 8 |
                          (uint32_t)(v.z >= th.z) << 16 |
                          (uint32_t)(v.w >= th.w) << 24;
    *reinterpret_cast<uint32_t*>(spikes) = fire;
  }
};

template <>
struct Unit<false> {  // one neuron, one int32 a round
  static constexpr int kWidth = 1;
  using Word = int32_t;
  __device__ static void add(uint32_t (&acc)[1], int32_t v) {
    acc[0] += (uint32_t)v;
  }
  __device__ static void store(int32_t* vmem, int8_t* spikes,
                               const uint32_t (&acc)[1], int32_t th) {
    const int32_t v = (int32_t)acc[0];
    *vmem = v;
    *spikes = v >= th ? 1 : 0;
  }
};

// A global load issued where it stands: the compiler may neither sink it
// into the branch that uses it nor split a span's loads around their adds.
__device__ __forceinline__ int4 load_now(const int4* p) {
  int4 v;
  asm volatile("ld.global.nc.v4.s32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ int32_t load_now(const int32_t* p) {
  int32_t v;
  asm volatile("ld.global.nc.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

// units: B * N / width; q_per_row: N / width, divided by as
// (umulhi(u, magic) + u) >> shift where the units fit 31 bits.  A warp
// takes 2^uw_log2 units x 32 / 2^uw_log2 span slots (lane = slot * units +
// unit); a block, blockDim.x / 32 warps.  Every load's address is clamped
// into the tensors (a unit past the last, a round past T), so no branch
// stands between the loads.
template <bool kVec>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
if_neuron_kernel(const int32_t* __restrict__ updates,
                 const int32_t* __restrict__ vth,
                 int8_t* __restrict__ spikes, int32_t* __restrict__ vmem,
                 long long units, int T, int N, int q_per_row,
                 uint32_t magic, int shift, int uw_log2) {
  using U = Unit<kVec>;
  using W = typename U::Word;
  constexpr int kW = U::kWidth;

  const int lane = threadIdx.x & 31;
  const int uw = 1 << uw_log2, slot = lane >> uw_log2, slots = 32 >> uw_log2;
  const long long u =
      ((long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) * uw +
      (lane & (uw - 1));
  const bool live = u < units;
  const long long uc = live ? u : 0;
  const long long b =
      units <= INT32_MAX
          ? (long long)((__umulhi((uint32_t)uc, magic) + (uint32_t)uc) >>
                        shift)
          : uc / q_per_row;
  const int q = (int)(uc - b * q_per_row);
  const W* col = reinterpret_cast<const W*>(updates + b * T * N) + q;

  const W th = load_now(reinterpret_cast<const W*>(vth) + q);
  uint32_t acc[kW] = {};
  for (int t0 = slot * kSpan; t0 < T; t0 += slots * kSpan) {
    W v[kSpan];
#pragma unroll
    for (int s = 0; s < kSpan; ++s)
      v[s] = load_now(col + (long long)min(t0 + s, T - 1) * q_per_row);
#pragma unroll
    for (int s = 0; s < kSpan; ++s)
      if (t0 + s < T) U::add(acc, v[s]);
  }
  // the slots' partial sums meet in lane `unit` (slot 0)
  for (int off = uw; off < 32; off <<= 1) {
#pragma unroll
    for (int w = 0; w < kW; ++w)
      acc[w] += __shfl_xor_sync(0xffffffffu, acc[w], off);
  }
  if (slot == 0 && live) {
    const long long n0 = b * N + (long long)q * kW;
    U::store(vmem + n0, spikes + n0, acc, th);
  }
}

template <bool kVec>
void launch(const void* updates, const void* vth, void* spikes, void* vmem,
            long long units, int T, int N, int q_per_row, uint32_t magic,
            int shift, int uw_log2, int grid, int threads, cudaStream_t st) {
  if_neuron_kernel<kVec><<<grid, threads, 0, st>>>(
      (const int32_t*)updates, (const int32_t*)vth, (int8_t*)spikes,
      (int32_t*)vmem, units, T, N, q_per_row, magic, shift, uw_log2);
}

}  // namespace

extern "C" {

// (spikes int8[B, N], vmem int32[B, N]) from contiguous updates
// int32[B, T, N] and vth int32[N], on the route ops._if_route gives: `uw`
// units a warp (a power of two up to 32: 32 / uw span slots); `warps` a
// block; `grid` blocks covering the units; vec 1 takes 4 neurons a unit
// (N % 4 == 0, updates and vth 16-byte aligned), 0 one.  Returns
// cudaGetLastError().
int if_neuron(const void* updates, const void* vth, void* spikes, void* vmem,
              int B, int T, int N, int uw, int warps, int grid, int vec,
              void* stream) {
  if (B < 1 || T < 0 || N < 1 || uw < 1 || uw > 32 || (uw & (uw - 1)) ||
      warps < 1 || 32 * warps > kMaxThreads || grid < 1)
    return (int)cudaErrorInvalidValue;
  if (vec && (N % 4 || (uintptr_t)updates % 16 || (uintptr_t)vth % 16))
    return (int)cudaErrorMisalignedAddress;
  const int q_per_row = vec ? N / 4 : N;
  const long long units = (long long)B * q_per_row;
  if ((long long)grid * warps * uw < units) return (int)cudaErrorInvalidValue;
  // q_per_row's divider: 2^shift >= q_per_row, magic = 2^32 (2^shift -
  // q_per_row) / q_per_row + 1
  int shift = 0;
  while ((1LL << shift) < q_per_row) ++shift;
  const uint32_t magic = (uint32_t)(
      ((1ULL << 32) * ((1ULL << shift) - q_per_row)) / q_per_row + 1);
  int uw_log2 = 0;
  while ((1 << uw_log2) < uw) ++uw_log2;
  const cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    launch<true>(updates, vth, spikes, vmem, units, T, N, q_per_row, magic,
                 shift, uw_log2, grid, 32 * warps, st);
  else
    launch<false>(updates, vth, spikes, vmem, units, T, N, q_per_row, magic,
                  shift, uw_log2, grid, 32 * warps, st);
  return (int)cudaGetLastError();
}

const char* if_neuron_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
