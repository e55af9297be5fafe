// Unit check of csrc/hopper.cuh on the card, before any attention code: one
// warpgroup loads a bf16 tile a [64][64] and a tile b by TMA (rank-4 maps,
// 128-byte swizzle, one mbarrier) and computes c [64][N] = a b' in fp32 with
// four wgmma m64nNk16 steps, N = 32, 64, 96, 128 or 256:
//
//   tb = 0: b [N][64], K-major (as k for s = q k^T): c = a b^T
//   tb = 1: b [64][N], MN-major (as v for o += p v, w2 in fused_subsampling.cu):
//           c = a b, ceil(N / 64) boxes (N = 96: the second box zero past
//           column 96, as v of a dh-96 head in flash_fwd.cu)
//   tb = 2: b [N][64], K-major, written by the threads with no swizzle
//           (hopper.cuh:desc_plain, as w1 in fused_subsampling.cu): c = a b^T
//
// with a from shared memory (areg = 0, as q), as register A fragments read
// from device memory (areg = 1, as the probabilities), from shared memory
// that the threads wrote in the 128-byte swizzle (areg = 2, as the dS band
// of relpos_flash_bwd.cu, made visible to wgmma by fence.proxy.async), or
// with no swizzle (areg = 3, as the h1 patch and the x patches of
// fused_subsampling.cu). chip_smoke.py holds c against torch.matmul.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "hopper.cuh"
#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;
using hopper::ATOM;
using hopper::desc_sw128;

constexpr uint32_t ABYTES = 64 * hopper::BOX_ROW_BYTES;  // one box of 64 rows

// b's bytes in shared memory: N rows of a box, or (MN-major) whole boxes of 64 rows
template <int N, int TB>
__host__ __device__ constexpr uint32_t b_bytes() {
  return TB == 1 ? (N + 63) / 64 * ABYTES : N * hopper::BOX_ROW_BYTES;
}

template <int N, int TB, int AREG>
__global__ void __launch_bounds__(128) check_kernel(const __grid_constant__ CUtensorMap ta,
                                                    const __grid_constant__ CUtensorMap tb,
                                                    const bf16* __restrict__ a,
                                                    const bf16* __restrict__ b,
                                                    float* __restrict__ c) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t sa = (raw + ATOM - 1) & ~(ATOM - 1), sb = sa + ABYTES;
  const uint32_t bar = sb + b_bytes<N, TB>();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  if (tid == 0) {
    hopper::mbar_init(bar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  constexpr bool A_TMA = AREG < 2, B_TMA = TB < 2;
  if (tid == 0) {
    hopper::mbar_arrive_tx(bar, (A_TMA ? ABYTES : 0) + (B_TMA ? b_bytes<N, TB>() : 0));
    if (A_TMA) hopper::tma_load_4d(sa, &ta, bar, 0, 0, 0, 0);
    if (TB == 0) {
      hopper::tma_load_4d(sb, &tb, bar, 0, 0, 0, 0);  // N rows of 64
    } else if (TB == 1) {
      for (int j = 0; j < (N + 63) / 64; ++j)  // 64 rows of N: ceil(N / 64) boxes
        hopper::tma_load_4d(sb + j * ABYTES, &tb, bar, 64 * j, 0, 0, 0);
    }
  }
  hopper::mbar_wait(bar, 0);
  if (!A_TMA || !B_TMA) {  // the threads write a (swizzled, or [8][64][8]) or b ([8][N][8])
    uint8_t* sa_ptr = smem_raw + (sa - raw);
    uint8_t* sb_ptr = smem_raw + (sb - raw);
    if (AREG == 2)
      for (int idx = tid; idx < 64 * 64; idx += 128)
        *reinterpret_cast<bf16*>(sa_ptr + hopper::sw128(idx / 64, idx % 64)) = a[idx];
    if (AREG == 3)
      for (int idx = tid; idx < 64 * 64; idx += 128)
        *reinterpret_cast<bf16*>(sa_ptr + ((idx % 64 / 8 * 64 + idx / 64) * 8 + idx % 8) * 2) =
            a[idx];
    if (TB == 2)
      for (int idx = tid; idx < N * 64; idx += 128)
        *reinterpret_cast<bf16*>(sb_ptr + ((idx % 64 / 8 * N + idx / 64) * 8 + idx % 8) * 2) =
            b[idx];
    hopper::fence_proxy_async();
    __syncthreads();
  }

  uint32_t fa[4][4];  // a's rows 16 warp + g (+ 8) as A fragments, read by AREG = 1
  if (AREG == 1) {
    const int ra = 16 * warp + g, rb = ra + 8;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        fa[ks][e] = ld_bf16x2(a + ((e & 1) ? rb : ra) * 64 + 16 * ks + 2 * t + 8 * (e >> 1));
  }
  float d[N / 8][4];
  hopper::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const uint64_t db = TB == 0   ? desc_sw128(sb + ks * 32, 0)
                        : TB == 1 ? desc_sw128(sb + ks * 2 * ATOM, ABYTES)
                                  : hopper::desc_plain(sb + ks * 2 * N * 16, N * 16, 128);
    constexpr int TRANS = TB == 1;
    if constexpr (AREG == 1)
      hopper::wgmma_rs<N, TRANS>(d, fa[ks], db, ks);
    else if constexpr (AREG == 3)
      hopper::wgmma_ss<N, TRANS>(d, hopper::desc_plain(sa + ks * 2 * 64 * 16, 64 * 16, 128), db,
                                 ks);
    else
      hopper::wgmma_ss<N, TRANS>(d, desc_sw128(sa + ks * 32, 0), db, ks);
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(d);
#pragma unroll
  for (int i = 0; i < N / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      c[(16 * warp + g + 8 * (e >> 1)) * N + 8 * i + 2 * t + (e & 1)] = d[i][e];
}

template <int N, int TB, int AREG>
int run(const void* a, const void* b, void* c, cudaStream_t s) {
  CUtensorMap ma, mb;
  int err = hopper::encode_bthd(&ma, a, 1, 64, 1, 64, 64);
  if (err == 0)
    err = TB != 1 ? hopper::encode_bthd(&mb, b, 1, N, 1, 64, N < 256 ? N : 256)
                  : hopper::encode_bthd(&mb, b, 1, 64, 1, N, 64);
  if (err != 0) return err;
  const size_t smem = ABYTES + b_bytes<N, TB>() + 8 + ATOM;
  auto kernel = check_kernel<N, TB, AREG>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<1, 128, smem, s>>>(ma, mb, static_cast<const bf16*>(a), static_cast<const bf16*>(b),
                              static_cast<float*>(c));
  return (int)cudaGetLastError();
}

}  // namespace

// a [64][64] bf16; b [n][64] (tb 0, 2) or [64][n] (tb 1) bf16; c [64][n]
// fp32; every pointer 16-byte aligned. n 64 or 128 with tb 0 or 1 and areg 0
// (a by TMA), 1 (a in registers) or 2 (a written by the threads, swizzled);
// and the forms of fused_subsampling.cu, a written by the threads with no
// swizzle (areg 3): n 128 or 256 with tb 1, n 32 with tb 2; n 256, tb 1,
// areg 0; and the dh-96 flash kernels' products into dh, n 96, tb 1, areg 1.
// Returns a cudaError_t.
extern "C" int hopper_check(int n, int tb, int areg, const void* a, const void* b, void* c,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((n == 64 || n == 128) && (tb == 0 || tb == 1) && areg >= 0 && areg <= 2) {
    switch ((n == 128) * 6 + tb * 3 + areg) {
      case 0: return run<64, 0, 0>(a, b, c, s);
      case 1: return run<64, 0, 1>(a, b, c, s);
      case 2: return run<64, 0, 2>(a, b, c, s);
      case 3: return run<64, 1, 0>(a, b, c, s);
      case 4: return run<64, 1, 1>(a, b, c, s);
      case 5: return run<64, 1, 2>(a, b, c, s);
      case 6: return run<128, 0, 0>(a, b, c, s);
      case 7: return run<128, 0, 1>(a, b, c, s);
      case 8: return run<128, 0, 2>(a, b, c, s);
      case 9: return run<128, 1, 0>(a, b, c, s);
      case 10: return run<128, 1, 1>(a, b, c, s);
      default: return run<128, 1, 2>(a, b, c, s);
    }
  }
  if (n == 256 && tb == 1 && areg == 0) return run<256, 1, 0>(a, b, c, s);
  if (n == 256 && tb == 1 && areg == 3) return run<256, 1, 3>(a, b, c, s);
  if (n == 128 && tb == 1 && areg == 3) return run<128, 1, 3>(a, b, c, s);
  if (n == 32 && tb == 2 && areg == 3) return run<32, 2, 3>(a, b, c, s);
  if (n == 96 && tb == 1 && areg == 1) return run<96, 1, 1>(a, b, c, s);
  return (int)cudaErrorInvalidValue;
}
