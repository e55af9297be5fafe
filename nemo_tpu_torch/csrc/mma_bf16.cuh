// bf16 register fragments, in the layout of a warp's share of an m16 x k16
// tile that mma.sync m16n8k16 defines and wgmma's register A operand takes
// (hopper.cuh). With g = lane / 4 and t = lane % 4, a lane holds (each
// uint32_t is two bf16, the lower index in the low half):
//
//   a[0] = A[g][2t, 2t+1]      a[1] = A[g+8][2t, 2t+1]
//   a[2] = A[g][2t+8, 2t+9]    a[3] = A[g+8][2t+8, 2t+9]
//
// and an fp32 accumulator d[0], d[1] = D[g][2t, 2t+1], d[2], d[3] =
// D[g+8][2t, 2t+1], so the accumulator of one product is laid out as the A
// operand of the next (the probabilities of a flash-attention tile). No
// kernel of the port issues mma.sync any more: every bf16 product is wgmma.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

// two floats → one bf16 pair (round to nearest even), `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two consecutive bf16 (4-byte aligned) as one 32-bit word
__device__ __forceinline__ uint32_t ld_bf16x2(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
