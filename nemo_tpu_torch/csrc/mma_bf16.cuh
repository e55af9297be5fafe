// Warp-level bf16 tensor-core product (mma.sync m16n8k16, fp32 accumulators).
//
// D[16x8] += A[16x16] * B[16x8]. With g = lane / 4 and t = lane % 4, a lane
// holds (each uint32_t is two bf16, the lower index in the low half):
//
//   a[0] = A[g][2t, 2t+1]      a[1] = A[g+8][2t, 2t+1]
//   a[2] = A[g][2t+8, 2t+9]    a[3] = A[g+8][2t+8, 2t+9]
//   b[0] = B[2t, 2t+1][g]      b[1] = B[2t+8, 2t+9][g]
//   d[0], d[1] = D[g][2t, 2t+1]          d[2], d[3] = D[g+8][2t, 2t+1]
//
// So a row-major A tile and a B tile stored as [n][k] (k contiguous) are both
// read as 32-bit pairs, and the accumulator of one product (D) is laid out as
// the A operand of the next (the probabilities of a flash-attention tile).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ void mma_bf16_16816(float d[4], const uint32_t a[4],
                                               const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two floats → one bf16 pair (round to nearest even), `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two consecutive bf16 (4-byte aligned) as one 32-bit word
__device__ __forceinline__ uint32_t ld_bf16x2(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
