// The rel-pos band ring of the bf16 kernels K1 (relpos_flash.cu) and K3
// (relpos_flash_bwd.cu): their scores need the term qv_i . p_{T-1-i+j},
// which runs along diagonals of p that no wgmma layout reads.
//
// A consumer warpgroup owns 64 query rows from i0' and walks key tiles of 64.
// Chunk m of its band is the 64 x 64 product qv p^T over the p rows T - 64 -
// i0' + 64 m ..; its element (i, q) is the term of row i and key J = 64 m + q
// + i - 63. Key tile kt needs chunks kt (keys c <= i) and kt + 1 (keys c >
// i), and tile kt + 1 chunk kt + 1 again, so each chunk is computed once and
// scattered into G [64 i][128] at column J mod 128, xor 8 (i % 8) against bank
// conflicts; tile kt then reads its keys 64 kt + c as plain rows (`band_row`,
// at column c ^ 8 (i % 8)). A row of G is written and read only by the quad
// of threads that holds it in the accumulator layout, so __syncwarp orders
// them.

#pragma once

namespace relpos {

// chunk m (a 64 x 64 accumulator: this thread's rows rl, rl + 8, with g = rl
// % 8 and t = lane % 4) into the warpgroup's G ring
__device__ __forceinline__ void scatter_band(float* G, const float (&bd)[8][4], int m, int rl,
                                             int g, int t) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = rl + 8 * (e >> 1), key = 64 * m + 8 * nt + 2 * t + (e & 1) + i - 63;
      G[i * 128 + ((key & 127) ^ (8 * g))] = bd[nt][e];
    }
}

// row i's terms of key tile kt, to be read at column c ^ (8 g)
__device__ __forceinline__ const float* band_row(const float* G, int i, int kt) {
  return G + i * 128 + 64 * (kt & 1);
}

}  // namespace relpos
