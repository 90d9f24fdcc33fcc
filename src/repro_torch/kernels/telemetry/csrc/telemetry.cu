// A serving round's telemetry, for NVIDIA Hopper (sm_90a): the arbiter loads
// of every tile input and the paper-unit cost model of every request.
//
// Replaces no Pallas kernel.  In the JAX reference this work is XLA's: the
// plan's in-graph `packing.group_popcount` (src/repro/core/esam/plan.py) and
// the engine's one jitted cost call a round (`_stats_jit`,
// src/repro/serve/engine.py:170), which XLA fuses.  Run eagerly in torch it
// was ~14 ops a plane and ~20 a tile, ~100-140 launches a round; here it is
// two launches, or two nodes of the round's CUDA graph.
//
//   tile_loads     loads[p][r, g] = popcount of 128-bit row group g of row r
//                  of plane p (four __popc and a sum), for every plane of a
//                  round in one launch: a thread an output, a 16-byte load
//                  where the plane is 16-byte aligned.
//   request_stats  the float32 accounting of
//                  src/repro_torch/kernels/telemetry/ref.py, bit for bit:
//                  per (request, step) and tile, drain = ceil(load / ports),
//                  cycles = max drain + 1, then the energy terms in the
//                  plain version's order with __fmul_rn / __fadd_rn (no FMA
//                  contraction; the library is built without fast math),
//                  tiles added in order, steps added in order, the step
//                  energy times float32(1/T).  The constants arrive rounded
//                  to float32 as torch rounds a Python scalar operand.
//                  Writes one float32 slab row a request: logits (copied
//                  when given), cycles per tile, cycles, latency, energy
//                  (and energy a step).  A thread a (request, step) runs
//                  the tiles in order, each tile's group loads in flight
//                  together; the block sums each request's steps in shared
//                  memory, and a thread a request writes its row.
//
// What bounds them: bytes, a few KB a round (the paper round: 128 x 36 words
// in, 128 x 12 loads out; the stats read those loads and write 128 x 17
// floats), under 0.01 us at 3.35 TB/s.  Both are launch-bound: the design
// keeps each thread's loads in flight together (tile_loads: one 16-byte
// load; request_stats: a tile's group loads at once), and one block covers
// a paper round.  Two designs that put more loads in flight at once (every
// tile's groups from a table of addresses in shared memory; the logits'
// copy spread over the block) measured slower on an H100 and were dropped
// (PERF.md, PR 30).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPlanes = 16;
constexpr int kMaxTiles = 16;
constexpr int kThreads = 256;
// Group loads of a tile a thread keeps in flight at once (request_stats).
constexpr int kBatch = 8;

struct LoadsArgs {
  const uint32_t* in[kMaxPlanes];
  int32_t* out[kMaxPlanes];
  long long start[kMaxPlanes + 1];  // prefix of outputs over the planes
  int n;
};

__global__ void tile_loads_kernel(const __grid_constant__ LoadsArgs a) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= a.start[a.n]) return;
  int p = 0;
  while (i >= a.start[p + 1]) ++p;
  const long long j = i - a.start[p];
  // W is a multiple of 4, so output j of a contiguous plane is words
  // 4j .. 4j + 3 whatever its row
  const uint32_t* src = a.in[p] + 4 * j;
  int c;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
    c = __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
  } else {
    const uint32_t w0 = __ldg(src), w1 = __ldg(src + 1), w2 = __ldg(src + 2),
                   w3 = __ldg(src + 3);
    c = __popc(w0) + __popc(w1) + __popc(w2) + __popc(w3);
  }
  a.out[p][j] = c;
}

struct StatsArgs {
  const int32_t* loads[kMaxTiles];
  long long stride_b[kMaxTiles];  // elements between requests
  long long stride_t[kMaxTiles];  // elements between steps
  int groups[kMaxTiles];
  float colgroups[kMaxTiles];
  float arbiter[kMaxTiles];
  float accum[kMaxTiles];
  float fire[kMaxTiles];
  float clocktree[kMaxTiles];
  const float* logits;            // [B, n_cls] rows of logits_stride, or null
  long long logits_stride;
  float* out;                     // [B, width]
  float e_read;
  float clock_ns;
  float recip_t;
  int ports;
  int n_tiles;
  int n_cls;                      // logit columns of the slab (0: none)
  int width;
  int B;
  int T;
  int rows;                       // requests a block
  int temporal;                   // write energy a step
};

__global__ void request_stats_kernel(const __grid_constant__ StatsArgs a) {
  extern __shared__ float smem[];
  const int rows = a.rows, T = a.T;
  float* e_step = smem;                                        // [rows, T]
  int* cyc = reinterpret_cast<int*>(smem + rows * T);          // [rows, tiles]
  const int b0 = blockIdx.x * rows;
  for (int k = threadIdx.x; k < rows * a.n_tiles; k += blockDim.x) cyc[k] = 0;
  __syncthreads();

  // a thread a (request, step): each tile's group loads in flight together
  for (int k = threadIdx.x; k < rows * T; k += blockDim.x) {
    const int r = k / T, s = k - r * T;
    const int b = b0 + r;
    if (b >= a.B) continue;
    float e = 0.f;
    for (int i = 0; i < a.n_tiles; ++i) {
      const int32_t* ld =
          a.loads[i] + b * a.stride_b[i] + (long long)s * a.stride_t[i];
      const int G = a.groups[i];
      int mx = 0, sum = 0;
      for (int g0 = 0; g0 < G; g0 += kBatch) {
        int v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          v[u] = g0 + u < G ? __ldg(ld + g0 + u) : 0;
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          mx = max(mx, (v[u] + a.ports - 1) / a.ports);
          sum += v[u];
        }
      }
      const float tile_cycles = (float)mx + 1.0f;
      const float reads = __fmul_rn((float)sum, a.colgroups[i]);
      float et = __fmul_rn(reads, a.e_read);
      et = __fadd_rn(et, __fmul_rn(tile_cycles, a.arbiter[i]));
      et = __fadd_rn(et, __fmul_rn(tile_cycles, a.accum[i]));
      et = __fadd_rn(et, a.fire[i]);
      et = __fadd_rn(et, __fmul_rn(tile_cycles, a.clocktree[i]));
      e = i == 0 ? et : __fadd_rn(e, et);
      atomicAdd(&cyc[r * a.n_tiles + i], mx + 1);
    }
    e_step[k] = e;
  }
  __syncthreads();

  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const int b = b0 + r;
    if (b >= a.B) continue;
    float* row = a.out + (long long)b * a.width;
    for (int c = 0; c < a.n_cls; ++c)
      row[c] = a.logits[b * a.logits_stride + c];
    int cycles = 0;
    for (int i = 0; i < a.n_tiles; ++i) {
      const int c = cyc[r * a.n_tiles + i];
      row[a.n_cls + i] = (float)c;
      cycles += c;
    }
    float energy = 0.f;
    for (int s = 0; s < T; ++s) energy = __fadd_rn(energy, e_step[r * T + s]);
    const int base = a.n_cls + a.n_tiles;
    row[base] = (float)cycles;
    row[base + 1] = __fmul_rn((float)cycles, a.clock_ns);
    row[base + 2] = energy;
    if (a.temporal) row[base + 3] = __fmul_rn(energy, a.recip_t);
  }
}

}  // namespace

extern "C" {

const char* telemetry_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int telemetry_tile_loads(const void* const* in, void* const* out,
                         const long long* outputs, int n,
                         cudaStream_t stream) {
  LoadsArgs a{};
  a.n = n;
  a.start[0] = 0;
  for (int p = 0; p < n; ++p) {
    a.in[p] = static_cast<const uint32_t*>(in[p]);
    a.out[p] = static_cast<int32_t*>(out[p]);
    a.start[p + 1] = a.start[p] + outputs[p];
  }
  for (int p = n; p < kMaxPlanes; ++p) a.start[p + 1] = a.start[n];
  const long long total = a.start[n];
  if (total == 0) return 0;
  const int grid = static_cast<int>((total + kThreads - 1) / kThreads);
  tile_loads_kernel<<<grid, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int telemetry_request_stats(
    const void* const* loads, const long long* stride_b,
    const long long* stride_t, const int* groups, const float* colgroups,
    const float* arbiter, const float* accum, const float* fire,
    const float* clocktree, int n_tiles, const void* logits,
    long long logits_stride, int n_cls, void* out, int width, int B, int T,
    int ports, float e_read, float clock_ns, float recip_t, int temporal,
    int rows, cudaStream_t stream) {
  StatsArgs a{};
  for (int i = 0; i < n_tiles; ++i) {
    a.loads[i] = static_cast<const int32_t*>(loads[i]);
    a.stride_b[i] = stride_b[i];
    a.stride_t[i] = stride_t[i];
    a.groups[i] = groups[i];
    a.colgroups[i] = colgroups[i];
    a.arbiter[i] = arbiter[i];
    a.accum[i] = accum[i];
    a.fire[i] = fire[i];
    a.clocktree[i] = clocktree[i];
  }
  a.logits = static_cast<const float*>(logits);
  a.logits_stride = logits_stride;
  a.out = static_cast<float*>(out);
  a.e_read = e_read;
  a.clock_ns = clock_ns;
  a.recip_t = recip_t;
  a.ports = ports;
  a.n_tiles = n_tiles;
  a.n_cls = n_cls;
  a.width = width;
  a.B = B;
  a.T = T;
  a.rows = rows;
  a.temporal = temporal;
  const int grid = (B + rows - 1) / rows;
  const int threads = rows * T < kThreads ? ((rows * T + 31) / 32) * 32
                                          : kThreads;
  const size_t smem = sizeof(float) * (size_t)rows * T +
                      sizeof(int) * (size_t)rows * n_tiles;
  request_stats_kernel<<<grid, threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
