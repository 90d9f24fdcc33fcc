// Probe of the learning epoch's chain step (stdp_column_epoch in
// src/repro_torch/kernels/stdp/csrc/stdp.cu) at the paper's readout, 256
// inputs -> 10 classes: one-warp copies of the chain, each a variant of one
// design choice, timed in clock64 cycles a sample over the same slots.  It
// is no part of the port: no path runs it.  probes/epoch_chain_probe.py
// builds it (nvcc, -I the stdp and cim_popcount csrc), feeds it the slots
// stdp_epoch_masks writes and checks each variant's wrong count against the
// kernel's.  The variants:
//   * issue_design: a cp.async a sample into an 8-slot ring, lane o holds
//     row o's 8 words, the argmax key with NaN, -0 and sign tests, every
//     mask loaded at the top of the step (optionally with phase stamps);
//   * the same readout on the kernel's ring of TMA bulk copies (Ring), then
//     one change each: the b1 tensor-core product in place of the popc, two
//     lanes a row, the 2-op key, the teacher's masks loaded by its lane
//     alone, the masks or the next sample's loads after the REDUX, a
//     branch-free row write, int -> float by a magic add;
//   * the kernel's own chain_registers<8, 1> from a 32- and a 256-thread
//     block.

#include "stdp.cu"   // Ring, kBatch, kBufs, slot_words, ring_words, order_key,
                     // chain_registers
#include "mma.cuh"   // mma_and_popc (the b1 product)

namespace probe {

constexpr int kW = 8;                    // words a row at 256 inputs
constexpr int kF = kW;                   // field_words(8)
constexpr int kSW = 4 + 4 * kF;          // slot_words(8)
constexpr int kAsyncRing = 8;            // slots of the cp.async ring

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The first design's key: a missing row 0, NaN above all, -0 as +0.
__device__ __forceinline__ uint32_t key3(float v, bool real) {
  if (!real) return 0u;
  if (v != v) return ~0u;
  uint32_t b = __float_as_uint(v);
  if ((b << 1) == 0u) b = 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ void load8(const uint32_t* p, uint32_t (&o)[kW]) {
#pragma unroll
  for (int q = 0; q < kW / 4; ++q) {
    const uint4 v = reinterpret_cast<const uint4*>(p)[q];
    o[4 * q] = v.x; o[4 * q + 1] = v.y; o[4 * q + 2] = v.z; o[4 * q + 3] = v.w;
  }
}

#define STAMP(k)                                 \
  do {                                           \
    if (kStamps) {                               \
      const unsigned c_ = clock();               \
      acc[k] += c_ - last;                       \
      last = c_;                                 \
    }                                            \
  } while (0)

// The issue's design: a cp.async a sample kRing ahead.  Stamps (kStamps):
// [0] the step's top to the slot's wait, [1] the readout and the REDUX,
// [2] the ballot, [3] the writes, [4] the next cp.async.
template <bool kStamps>
__global__ void __launch_bounds__(32, 1)
issue_design(const uint32_t* __restrict__ slots, const uint32_t* planes_in,
             int n_out, int n, const float* off_in, int* wrong_out,
             long long* out) {
  extern __shared__ __align__(16) uint32_t ring[];
  const int lane = threadIdx.x;
  uint32_t pl[kW];
  const float of = lane < n_out ? off_in[lane] : 0.f;
#pragma unroll
  for (int w = 0; w < kW; ++w) pl[w] = lane < n_out ? planes_in[lane * kW + w] : 0u;
  auto fetch = [&](int s) {
    for (int q = lane; q < kSW / 4; q += 32)
      cp_async16(ring + (s % kAsyncRing) * kSW + 4 * q, slots + (size_t)s * kSW + 4 * q);
  };
  for (int s = 0; s < kAsyncRing; ++s) {
    if (s < n) fetch(s);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncwarp();
  uint4 hdr = *reinterpret_cast<const uint4*>(ring);
  uint32_t tr[kW];
  load8(ring + 4, tr);
  int wrong = 0;
  unsigned acc[5] = {0, 0, 0, 0, 0};
  unsigned last = clock();
  const long long t1 = clock64();
  for (int i = 0; i < n; ++i) {
    const uint32_t* sl = ring + (i % kAsyncRing) * kSW;
    uint32_t tpot[kW], tdep[kW], wdep[kW];
    load8(sl + 4 + kF, tpot);
    load8(sl + 4 + 2 * kF, tdep);
    load8(sl + 4 + 3 * kF, wdep);
    cp_async_wait<kAsyncRing - 2>();
    __syncwarp();
    STAMP(0);
    const uint32_t* nx = ring + ((i + 1) % kAsyncRing) * kSW;
    const uint4 nhdr = *reinterpret_cast<const uint4*>(nx);
    uint32_t ntr[kW];
    load8(nx + 4, ntr);
    int c = 0;
#pragma unroll
    for (int w = 0; w < kW; ++w) c += __popc(tr[w] & pl[w]);
    const uint32_t key =
        key3(__fadd_rn((float)(2 * c - (int)hdr.x), of), lane < n_out);
    const uint32_t top = __reduce_max_sync(~0u, key);
    STAMP(1);
    const int arg = __ffs(__ballot_sync(~0u, key == top)) - 1;
    STAMP(2);
    if ((uint32_t)arg != hdr.z) {
      ++wrong;
      if (lane == (int)hdr.y) {
#pragma unroll
        for (int w = 0; w < kW; ++w) pl[w] = (pl[w] & ~tdep[w]) | tpot[w];
      }
      if (lane == arg) {
#pragma unroll
        for (int w = 0; w < kW; ++w) pl[w] &= ~wdep[w];
      }
    }
    STAMP(3);
    __syncwarp();
    if (i + kAsyncRing < n) fetch(i + kAsyncRing);
    cp_async_commit();
    STAMP(4);
    hdr = nhdr;
#pragma unroll
    for (int w = 0; w < kW; ++w) tr[w] = ntr[w];
  }
  const long long t2 = clock64();
  if (lane == 0) {
    *wrong_out = wrong;
    out[0] = t2 - t1;
    for (int k = 0; k < 5; ++k) out[1 + k] = acc[k];
  }
}

// On the kernel's Ring: kLanes lanes a row (1 or 2), kKey2 the 2-op key
// (and -inf offsets for missing rows), kGuard the teacher's masks loaded by
// its lane alone, kLateMasks / kLateNext those loads after the REDUX,
// kBranchFree one masked write for every lane, kMagic int -> float by
// adding and subtracting 1.5 * 2^23.
template <int kLanes, bool kKey2, bool kGuard, bool kLateMasks,
          bool kLateNext, bool kBranchFree, bool kMagic>
__global__ void __launch_bounds__(32, 1)
ring_variant(const uint32_t* __restrict__ slots, const uint32_t* planes_in,
             int n_out, int n, const float* off_in, int* wrong_out,
             long long* out) {
  constexpr int kWL = kW / kLanes;
  extern __shared__ __align__(16) uint32_t sm[];
  const int lane = threadIdx.x, row = lane / kLanes, part = lane % kLanes;
  const Ring ring{sm, reinterpret_cast<uint64_t*>(sm + ring_words(kW)), slots,
                  kSW, n};
  const bool real = row < n_out;
  const float of = real ? off_in[row]
                        : (kKey2 ? __int_as_float((int)0xff800000u) : 0.f);
  uint32_t pl[kWL];
#pragma unroll
  for (int w = 0; w < kWL; ++w)
    pl[w] = real ? planes_in[row * kW + part * kWL + w] : 0u;
  if (lane == 0) ring.start();
  __syncwarp();
  ring.wait(0);
  uint4 hdr = *reinterpret_cast<const uint4*>(ring.slot(0));
  uint32_t tr[kW];
  load8(ring.slot(0) + 4, tr);
  int wrong = 0;
  const long long t1 = clock64();
  for (int i = 0; i < n; ++i) {
    const uint32_t* sl = ring.slot(i);
    uint32_t tpot[kW], tdep[kW], wdep[kW], ntr[kW];
    uint4 nhdr;
    const int i1 = i + 1;
    auto masks = [&]() {
      if (!kGuard || lane == (int)(hdr.y & 31u)) {
        load8(sl + 4 + kF, tpot);
        load8(sl + 4 + 2 * kF, tdep);
      }
      load8(sl + 4 + 3 * kF, wdep);
    };
    auto next = [&]() {
      if (i1 % kBatch == 0 && i1 < n) ring.wait(i1 / kBatch);
      nhdr = *reinterpret_cast<const uint4*>(ring.slot(i1));
      load8(ring.slot(i1) + 4, ntr);
    };
    if (!kLateMasks) masks();
    if (!kLateNext) next();
    int c = 0;
#pragma unroll
    for (int w = 0; w < kWL; ++w) c += __popc(tr[part * kWL + w] & pl[w]);
    if (kLanes == 2) c += __shfl_xor_sync(~0u, c, 1);
    const int x = 2 * c - (int)hdr.x;
    const float xf = kMagic ? __fsub_rn(__int_as_float(0x4B400000 + x), 12582912.0f)
                            : (float)x;
    const float v = __fadd_rn(xf, of);
    const uint32_t key = kKey2 ? order_key(v) : key3(v, real);
    const uint32_t top = __reduce_max_sync(~0u, key);
    if (kLateMasks || kLateNext) asm volatile("" ::: "memory");
    if (kLateMasks) masks();
    if (kLateNext) next();
    const int arg = (__ffs(__ballot_sync(~0u, key == top)) - 1) / kLanes;
    const bool wr = (uint32_t)arg != hdr.z;
    if (kBranchFree) {
      wrong += wr;
      const uint32_t mt = wr && row == (int)hdr.y ? ~0u : 0u;
      const uint32_t mw = wr && row == arg ? ~0u : 0u;
#pragma unroll
      for (int w = 0; w < kWL; ++w) {
        const int j = part * kWL + w;
        pl[w] = ((pl[w] & ~(tdep[j] & mt)) | (tpot[j] & mt)) & ~(wdep[j] & mw);
      }
    } else if (wr) {
      ++wrong;
      if (row == (int)hdr.y) {
#pragma unroll
        for (int w = 0; w < kWL; ++w)
          pl[w] = (pl[w] & ~tdep[part * kWL + w]) | tpot[part * kWL + w];
      }
      if (row == arg) {
#pragma unroll
        for (int w = 0; w < kWL; ++w) pl[w] &= ~wdep[part * kWL + w];
      }
    }
    ring.release(i, lane);
    hdr = nhdr;
#pragma unroll
    for (int w = 0; w < kW; ++w) tr[w] = ntr[w];
  }
  const long long t2 = clock64();
  if (lane == 0) {
    *wrong_out = wrong;
    out[0] = t2 - t1;
  }
}

// The readout as the A fragments of the b1 product on the kernel's Ring:
// lane (g, t) holds words 2t, 2t + 1 of rows g and g + 8 (n_out <= 16); B
// is the trace in every column, so D's column 2t is each row's count.
__global__ void __launch_bounds__(32, 1)
tensor_variant(const uint32_t* __restrict__ slots, const uint32_t* planes_in,
               int n_out, int n, const float* off_in, int* wrong_out,
               long long* out) {
  extern __shared__ __align__(16) uint32_t sm[];
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  const Ring ring{sm, reinterpret_cast<uint64_t*>(sm + ring_words(kW)), slots,
                  kSW, n};
  uint32_t a[4];
  float of[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = g + 8 * h;
    of[h] = row < n_out ? off_in[row] : 0.f;
    a[h] = row < n_out ? planes_in[row * kW + 2 * t] : 0u;
    a[2 + h] = row < n_out ? planes_in[row * kW + 2 * t + 1] : 0u;
  }
  auto pair = [&](const uint32_t* p, uint32_t (&o)[2]) {
    const uint2 v = *reinterpret_cast<const uint2*>(p + 2 * t);
    o[0] = v.x;
    o[1] = v.y;
  };
  if (lane == 0) ring.start();
  __syncwarp();
  ring.wait(0);
  uint4 hdr = *reinterpret_cast<const uint4*>(ring.slot(0));
  uint32_t b[2];
  pair(ring.slot(0) + 4, b);
  int wrong = 0;
  const long long t1 = clock64();
  for (int i = 0; i < n; ++i) {
    const uint32_t* sl = ring.slot(i);
    uint32_t tpot[2], tdep[2], wdep[2], nb[2];
    pair(sl + 4 + kF, tpot);
    pair(sl + 4 + 2 * kF, tdep);
    pair(sl + 4 + 3 * kF, wdep);
    const int i1 = i + 1;
    if (i1 % kBatch == 0 && i1 < n) ring.wait(i1 / kBatch);
    const uint4 nhdr = *reinterpret_cast<const uint4*>(ring.slot(i1));
    pair(ring.slot(i1) + 4, nb);
    int acc[4] = {0, 0, 0, 0};
    mma_and_popc(acc, a, b);
    uint32_t key[2], best = 0u;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      key[h] = key3(__fadd_rn((float)(2 * acc[2 * h] - (int)hdr.x), of[h]),
                    g + 8 * h < n_out);
      best = max(best, key[h]);
    }
    const uint32_t top = __reduce_max_sync(~0u, best);
    int arg = -1;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const unsigned m = __ballot_sync(~0u, key[h] == top);
      if (arg < 0 && m) arg = 8 * h + ((__ffs(m) - 1) >> 2);
    }
    if ((uint32_t)arg != hdr.z) {
      ++wrong;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = g + 8 * h;
        if (row == (int)hdr.y) {
          a[h] = (a[h] & ~tdep[0]) | tpot[0];
          a[2 + h] = (a[2 + h] & ~tdep[1]) | tpot[1];
        }
        if (row == arg) {
          a[h] &= ~wdep[0];
          a[2 + h] &= ~wdep[1];
        }
      }
    }
    ring.release(i, lane);
    hdr = nhdr;
    b[0] = nb[0];
    b[1] = nb[1];
  }
  const long long t2 = clock64();
  if (lane == 0) {
    *wrong_out = wrong;
    out[0] = t2 - t1;
  }
}

// The kernel's own chain_registers<8, 1> from a block of kThreads.
template <int kThreads>
__global__ void __launch_bounds__(kThreads, 1)
kernel_chain(const uint32_t* __restrict__ slots, const uint32_t* planes_in,
             int n_out, int n, const float* off_in, int* wrong_out,
             long long* out) {
  extern __shared__ __align__(16) uint32_t sm[];
  const Ring ring{sm, reinterpret_cast<uint64_t*>(sm + ring_words(kW)), slots,
                  kSW, n};
  uint32_t* planes = sm + ring_words(kW) + 2 * kBufs;   // [n_out][kW | 1]
  float* off = reinterpret_cast<float*>(planes + (size_t)n_out * (kW | 1));
  for (int t = threadIdx.x; t < n_out * kW; t += blockDim.x)
    planes[(t / kW) * (kW | 1) + t % kW] = planes_in[t];
  for (int o = threadIdx.x; o < n_out; o += blockDim.x) off[o] = off_in[o];
  __syncthreads();
  if (threadIdx.x < 32) {
    const long long t1 = clock64();
    const int wrong = chain_registers<kW, 1>(ring, planes, off, n_out, kW, n);
    const long long t2 = clock64();
    if (threadIdx.x == 0) {
      *wrong_out = wrong;
      out[0] = t2 - t1;
    }
  }
  __syncthreads();
}

}  // namespace probe

extern "C" {

// Variant `which` (epoch_chain_probe.py's VARIANTS, in order) over n slots
// of 256 -> n_out (<= 16) with planes uint32[n_out][8] and offsets
// float32[n_out]: *wrong gets the wrong count, out[0] the chain's clock64
// cycles (out[1..5]: the stamps of issue_design<true>).
int epoch_chain_probe(int which, const void* slots, const void* planes,
                      int n_out, int n, const void* off, void* wrong,
                      void* out, void* stream) {
  using namespace probe;
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t ring = 4 * (ring_words(kW) + 2 * kBufs);
  const size_t with_planes = ring + 4 * ((size_t)n_out * (kW | 1) + n_out);
  const uint32_t* s = (const uint32_t*)slots;
  const uint32_t* p = (const uint32_t*)planes;
  const float* o = (const float*)off;
  int* w = (int*)wrong;
  long long* c = (long long*)out;
  if (n_out < 1 || n_out > 16 || n < 1) return (int)cudaErrorInvalidValue;
  switch (which) {
    case 0: issue_design<false><<<1, 32, 4 * kAsyncRing * kSW, st>>>(s, p, n_out, n, o, w, c); break;
    case 1: issue_design<true><<<1, 32, 4 * kAsyncRing * kSW, st>>>(s, p, n_out, n, o, w, c); break;
    case 2: tensor_variant<<<1, 32, ring, st>>>(s, p, n_out, n, o, w, c); break;
    case 3: ring_variant<1, false, false, false, false, false, false><<<1, 32, ring, st>>>(s, p, n_out, n, o, w, c); break;
    case 4: ring_variant<2, false, false, false, false, false, false><<<1, 32, ring, st>>>(s, p, n_out, n, o, w, c); break;
    case 5: ring_variant<1, true, false, false, false, false, false><<<1, 32, ring, st>>>(s, p, n_out, n, o, w, c); break;
    case 6: ring_variant<1, true, true, false, false, false, false><<<1, 32, ring, st>>>(s, p, n_out, n, o, w, c); break;
    case 7: ring_variant<1, true, false, true, false, false, false><<<1, 32, ring, st>>>(s, p, n_out, n, o, w, c); break;
    case 8: ring_variant<1, true, false, false, true, false, false><<<1, 32, ring, st>>>(s, p, n_out, n, o, w, c); break;
    case 9: ring_variant<1, true, false, true, false, true, false><<<1, 32, ring, st>>>(s, p, n_out, n, o, w, c); break;
    case 10: ring_variant<1, true, false, true, false, false, true><<<1, 32, ring, st>>>(s, p, n_out, n, o, w, c); break;
    case 11: kernel_chain<32><<<1, 32, with_planes, st>>>(s, p, n_out, n, o, w, c); break;
    case 12: kernel_chain<256><<<1, 256, with_planes, st>>>(s, p, n_out, n, o, w, c); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
