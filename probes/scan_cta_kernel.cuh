// The single-CTA design of B4 temporal_scan's register route, which
// probes/scan_link_probe.py times beside the port's cluster kernel
// (scan_regs_kernel).  No part of the port: the probe splices this text into
// its copy of src/repro_torch/kernels/lif_step/csrc/lif_step.cu, inside the
// file's namespace, and uses its RegArgs, kFull, kBias, small_to_float,
// smem_u32 and mma_and_popc.
//
// One block serves kR streams (16, or 8 with rows 8-15 of the b1 product
// zero) and runs every hidden tile and the readout as a wavefront: in
// iteration i tile h takes step i - h and the readout step i - kK, so a
// launch is T + kK iterations with one block barrier each.  Each of the kW
// warps owns 256 / kW neurons of every tile and holds their membranes,
// thresholds and plane fragments in registers; a tile's words go to the
// next through a shared buffer of two slots (by iteration parity).  Tile
// 0's c_in comes by cp.async, kCtaDepth - 1 steps ahead.
//
// Takes only what the probe runs: hidden widths of at most 256, c_in
// 16-byte aligned with n[0] % 4 == 0, the zero reset and no refractory
// period (cudaErrorInvalidValue otherwise).

template <bool kB>
struct CtaFlag {
  static constexpr bool value = kB;
};

constexpr int kCtaDepth = 4;     // c_in steps in the ring
constexpr int kCtaPad = 264;     // ring row stride, words (bank spread)

__device__ __forceinline__ void cta_cp16(void* dst, const void* src,
                                         int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

template <int kK, int kW, int kR>
__global__ void __launch_bounds__(kW * 32, 1)
scan_cta_kernel(const __grid_constant__ RegArgs a) {
  constexpr int kT = kW * 32;
  constexpr int kG = kW >= 16 ? 2 : 4;    // column tiles a warp, a tile
  constexpr int kH = kR / 8;              // row halves a thread holds
  constexpr int kStride = 8;              // buffer words a row
  static_assert(kR == 8 || kR == 16, "8 or 16 streams a block");
  static_assert(kW == 8 || kW == 16, "8 or 16 warps a block");
  __shared__ __align__(16) uint32_t buf[2][kK][kR][kStride];
  extern __shared__ __align__(16) int32_t ring[];   // [depth][kR][kCtaPad]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b0 = blockIdx.x * kR;
  const int T = a.T, B = a.B;
  const float decay = a.decay;
  const int n_first = a.n[0], n_cls = a.n[kK];
  // column tile j of this warp (the same in every tile)
  auto col = [&](int j) { return warp * kG + j; };

  for (int e = tid; e < 2 * kK * kR * kStride; e += kT)
    (&buf[0][0][0][0])[e] = 0u;

  // thresholds (+inf past the width), planes (B fragments: column 8 c + g,
  // words 2 t and 2 t + 1), membranes; bp[h] is the MAC into tile h + 1
  // (the readout's for h = kK - 1: column tile `warp`, j = 0)
  float th[kK][kG][2];
  uint32_t bp[kK][kG][2];
  float vm[kK][kG][kH][2];
  float ov[kH][2];
#pragma unroll
  for (int h = 0; h < kK; ++h) {
#pragma unroll
    for (int j = 0; j < kG; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = 8 * col(j) + 2 * t + e;
        th[h][j][e] =
            n < a.n[h] ? __int2float_rn(__ldg(a.vth[h] + n)) : INFINITY;
#pragma unroll
        for (int x = 0; x < kH; ++x) vm[h][j][x][e] = 0.0f;
      }
      const bool readout = h == kK - 1;
      const int row = (readout ? 8 * warp : 8 * col(j)) + g;
      const bool real = (!readout || j == 0) && row < a.n[h + 1];
      const int w_in = a.w[h];
      const uint32_t* pr = a.plane[h] + (size_t)(real ? row : 0) * w_in;
      bp[h][j][0] = real && 2 * t < w_in ? __ldg(pr + 2 * t) : 0u;
      bp[h][j][1] = real && 2 * t + 1 < w_in ? __ldg(pr + 2 * t + 1) : 0u;
    }
  }
#pragma unroll
  for (int x = 0; x < kH; ++x) ov[x][0] = ov[x][1] = 0.0f;

  // step s of c_in into ring slot s % kCtaDepth, the block's kR rows (zero
  // past B and past n[0]); a thread waits for its own copies of step i + 1
  // before the barrier of iteration i, which shows everyone's
  auto copy_step = [&](int s) {
    if (s < T) {
      const int32_t* src = a.c_in + ((size_t)s * B + b0) * n_first;
      int32_t* dst = ring + s % kCtaDepth * kR * kCtaPad;
      for (int e = tid; e < kR * 64; e += kT) {
        const int row = e / 64, n = 4 * (e % 64);
        const bool real = b0 + row < B && n < n_first;
        cta_cp16(dst + row * kCtaPad + n,
                 real ? src + (size_t)row * n_first + n : a.c_in,
                 real ? 16 : 0);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
#pragma unroll
  for (int s = 0; s < kCtaDepth - 1; ++s) copy_step(s);
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kCtaDepth - 2) : "memory");
  __syncthreads();   // the word buffer is zero, step 0 is in

  auto iteration = [&](int i, auto check) {
    constexpr bool kCheck = decltype(check)::value;
    auto runs = [&](int h) { return !kCheck || (i - h >= 0 && i - h < T); };
    const int slot = i & 1;
    copy_step(i + kCtaDepth - 1);

    // 1. the A fragments of the words tile m wrote last iteration (which
    // feed tile m + 1), and each stream's spike count as a float bias
    uint32_t af[kK][4];
    int bias[kK][kH];
#pragma unroll
    for (int m = 0; m < kK; ++m) {
      if (!runs(m + 1)) continue;
      const uint32_t* src = &buf[slot ^ 1][m][0][0];
      int pc = 0;
#pragma unroll
      for (int x = 0; x < kH; ++x) {
        const uint2 v = *reinterpret_cast<const uint2*>(
            src + (g + 8 * x) * kStride + 2 * t);
        af[m][x] = v.x;
        af[m][x + 2] = v.y;
        pc += (__popc(v.x) + __popc(v.y)) << (16 * x);
      }
      if constexpr (kH == 1) af[m][1] = af[m][3] = 0u;
      pc += __shfl_xor_sync(kFull, pc, 1);
      pc += __shfl_xor_sync(kFull, pc, 2);
#pragma unroll
      for (int x = 0; x < kH; ++x)
        bias[m][x] = kBias - ((pc >> (16 * x)) & 0xffff);
    }

    // 2. the products into tile m + 1 (the readout's: one column tile)
    int acc[kK][kG][4];
#pragma unroll
    for (int m = 0; m < kK; ++m) {
      if (!runs(m + 1)) continue;
#pragma unroll
      for (int j = 0; j < (m == kK - 1 ? 1 : kG); ++j) {
        acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0;
        mma_and_popc(acc[m][j], af[m], bp[m][j]);
      }
    }

    // 3. the LIF step of every running tile, its fired bits at 8 q + e
    // (shifted to 8 q + 2 t + e below)
    uint32_t bits[kK][kH];
    const int32_t* cin = ring + (i % kCtaDepth * kR + g) * kCtaPad + 2 * t;
#pragma unroll
    for (int h = 0; h < kK; ++h) {
      if (!runs(h)) continue;
#pragma unroll
      for (int x = 0; x < kH; ++x) bits[h][x] = 0u;
#pragma unroll
      for (int j = 0; j < kG; ++j) {
#pragma unroll
        for (int x = 0; x < kH; ++x) {
          float in[2];
          if (h == 0) {
            const int2 c = *reinterpret_cast<const int2*>(
                cin + 8 * kCtaPad * x + 8 * col(j));
            in[0] = __int2float_rn(c.x);
            in[1] = __int2float_rn(c.y);
          } else {
            in[0] = small_to_float(2 * acc[h - 1][j][2 * x] + bias[h - 1][x]);
            in[1] =
                small_to_float(2 * acc[h - 1][j][2 * x + 1] + bias[h - 1][x]);
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float v = __fmaf_rn(vm[h][j][x][e], decay, in[e]);
            const bool fired = v >= th[h][j][e];
            vm[h][j][x][e] = fired ? 0.0f : v;
            bits[h][x] |= fired ? 1u << (8 * j + e) : 0u;
          }
        }
      }
    }
    if (runs(kK)) {   // the readout: leaks and integrates, never fires
#pragma unroll
      for (int x = 0; x < kH; ++x)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          ov[x][e] = __fmaf_rn(ov[x][e], decay,
                               small_to_float(2 * acc[kK - 1][0][2 * x + e] +
                                              bias[kK - 1][x]));
    }

    // 4. the hand-off: OR the quad's bits; lane t < kH stores row g + 8 t's
    // word (or half word, at 16 warps)
#pragma unroll
    for (int h = 0; h < kK; ++h) {
      if (!runs(h)) continue;
      uint32_t mine;
      if constexpr (kH == 2) {
        const uint32_t lo = bits[h][0] << (2 * t), hi = bits[h][1] << (2 * t);
        mine = ((t & 1) ? hi : lo) |
               __shfl_xor_sync(kFull, (t & 1) ? lo : hi, 1);
      } else {
        const uint32_t lo = bits[h][0] << (2 * t);
        mine = lo | __shfl_xor_sync(kFull, lo, 1);
      }
      mine |= __shfl_xor_sync(kFull, mine, 2);
      if (t < kH) {
        uint32_t* row = &buf[slot][h][g + 8 * t][0];
        if constexpr (kG == 4)
          row[warp] = mine;
        else
          reinterpret_cast<uint16_t*>(row)[warp] = (uint16_t)mine;
      }
    }

    // 5. telemetry of the words written in iteration i - 1: warp
    // kW - 1 - h stores tile h's (lane: row lane / 2, words 4 (lane & 1)
    // ..), off the chain: nothing waits on the stores
#pragma unroll
    for (int h = 0; h < kK; ++h) {
      const int step = i - 1 - h;
      if (warp != kW - 1 - h || step < 0 || step >= T) continue;
      int32_t* wd = a.words[h];
      int32_t* ld = a.loads[h];
      const int w = a.w[h];
      const int r = lane >> 1, k0 = 4 * (lane & 1);
      if ((!wd && !ld) || r >= kR || b0 + r >= B || k0 >= w) continue;
      const uint32_t* src = &buf[slot ^ 1][h][r][0];
      const size_t at = (size_t)step * B + b0 + r;
      if (!(w & 3)) {
        const uint4 v = *reinterpret_cast<const uint4*>(src + k0);
        if (wd) *reinterpret_cast<uint4*>(wd + at * w + k0) = v;
        if (ld)
          ld[at * (w >> 2) + (k0 >> 2)] =
              __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
      } else if (wd) {
        for (int e = 0; e < 4 && k0 + e < w; ++e)
          wd[at * w + k0 + e] = (int32_t)src[k0 + e];
      }
    }
    // 6. this thread's copies of step i + 1 are in
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kCtaDepth - 2) : "memory");
  };

  for (int i = 0; i < T + kK; ++i) {
    if (i >= kK && i < T)
      iteration(i, CtaFlag<false>());
    else
      iteration(i, CtaFlag<true>());
    __syncthreads();
  }
  if (8 * warp < n_cls) {
#pragma unroll
    for (int x = 0; x < kH; ++x) {
      const int row = b0 + g + 8 * x;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = 8 * warp + 2 * t + e;
        if (row < B && n < n_cls) a.out_v[(size_t)row * n_cls + n] = ov[x][e];
      }
    }
  }
}

template <int kK, int kW, int kR>
int launch_cta(const RegArgs& a, bool refrac, bool subtract, cudaStream_t s) {
  if (refrac || subtract || ((uintptr_t)a.c_in & 15) || a.n[0] % 4)
    return (int)cudaErrorInvalidValue;
  for (int h = 0; h < kK; ++h)
    if (a.n[h] > 256) return (int)cudaErrorInvalidValue;
  auto kernel = scan_cta_kernel<kK, kW, kR>;
  constexpr int smem = kCtaDepth * kR * kCtaPad * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(a.B + kR - 1) / kR, kW * 32, smem, s>>>(a);
  return (int)cudaGetLastError();
}
