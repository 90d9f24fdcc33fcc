// The warp-level tensor-core product (mma.sync, PTX ISA; sm_80 and later)
// that computes the popcount MAC exactly.
#pragma once

#include <stdint.h>

// d += sum_k popc(A[m, k] & B[k, n]) over one 16 x 8 x 256-bit tile, in
// lane (g, t) = (lane / 4, lane % 4): A row major (a[0], a[1]: 32-bit word t
// of rows g, g + 8; a[2], a[3]: their word t + 4), B column major (b[0],
// b[1]: words t and t + 4 of column g), d[0], d[1]: row g, columns 2t and
// 2t + 1; d[2], d[3]: row g + 8, the same columns (PTX ISA, the fragments of
// mma.m16n8k256).
__device__ __forceinline__ void mma_and_popc(int (&d)[4],
                                             const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
