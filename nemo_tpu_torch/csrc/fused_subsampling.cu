// Fused conv-ReLU-conv-ReLU subsampling (x4) for Hopper (sm_90a), fp32 or bf16.
//
// Replaces the TPU kernel nemo_tpu/ops/subsampling_kernel.py:_kernel
// (fused_subsampling_x4). It computes the two 3x3 stride-2 convolutions of
// the Conformer's striding ConvSubsampling:
//
//   h1[t1,f1,c]  = relu(b1[c] + sum_{di,df} x[2t1+di-1, 2f1+df-1] w1[di,df,c])
//                  for t1 < T2, f1 < F2, and 0 outside (conv2's zero padding)
//   out[t4,f4,o] = relu(b2[o] + sum_{di,df,c} h1[2t4+di-1, 2f4+df-1, c] w2[di,df,c,o])
//
// written as [B, T4, F4*C], flattened (f, c) like the JAX reshape. h1 is
// rounded to the input type (bf16 or fp32) before conv2, as the plain version
// does; every sum is accumulated in fp32.
//
// conv2 is an implicit GEMM of M = T4*F4 output positions (per batch row) by
// N = C output channels over K = 9*C. A block owns (b, a tile of consecutive
// positions m = t4*F4 + f4, a tile of output channels) and loops over chunks
// of 16 input channels: for each chunk it computes the conv1 patch that its
// positions read (h1 rows 2*t4_lo-1 .. 2*t4_hi+1, all F2 columns plus the
// padding column) into shared memory, 9 MACs an element, and stages the chunk
// of w2; then it accumulates the chunk's 9 taps. h1 never touches device
// memory; it is recomputed once per tile of output channels.
//
// Bound on the H100: 2 * B * T4 * F4 * 9 * C * C operations for conv2
// (2.3e12 at B=32, 30 s, C=512) against ~0.5 GB of bf16 output, so the
// operations bound it (2.3 ms at the bf16 tensor-core peak).
//
// - bf16 (the main path): tensor cores through mma.sync m16n8k16 (fp32
//   accumulators), 64 positions x 256 channels a block (128 where C is not a
//   multiple of 256), 8 warps of 32 x 64 (32 x 32). The A fragments are gathered
//   straight from the h1 patch (one 32-bit load per pair of channels), so no
//   im2col copy is made; the B fragments come from the w2 chunk, staged by
//   cp.async while conv1 runs, through ldmatrix.trans. The input rows the
//   block needs are staged once, in fp32; each thread computes conv1 for 4
//   channels of a cell, so each input value read serves 4 MACs.
// - fp32 (the exactness check): scalar fp32 FMAs, 64 positions x 128
//   channels a block, each thread an 8 x 4 tile.
// wgmma and TMA pipelining come later.
//
// Layouts: x [B, T, F]; w1 [3, 3, C] (HWIO with I = 1); b1 [C];
// w2 [3, 3, C, C] (HWIO); b2 [C]; out [B, T4, F4 * C]. C % 128 == 0.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "mma_bf16.cuh"

namespace {

constexpr int CK = 16;  // input channels per chunk

// rows of the h1 patch that `tm` consecutive positions can need
__host__ __device__ inline int patch_rows(int tm, int F4) {
  return 2 * ((tm - 1 + F4 - 1) / F4) + 3;
}

// ---------------------------------------------------------------- fp32 path

namespace f32 {

constexpr int TM = 64;   // output positions per block
constexpr int TN = 128;  // output channels per block
constexpr int NT = 256;  // 8 x 32 threads: 8 positions x 4 channels each

__host__ inline size_t smem_bytes(int F4) {
  return (size_t)(CK * patch_rows(TM, F4) * (2 * F4 + 1) + 9 * CK * TN) * sizeof(float);
}

__global__ void __launch_bounds__(NT, 2) kernel(
    const float* __restrict__ x, const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2, float* __restrict__ out, int Tn,
    int F, int C, int T2, int F2, int T4, int F4) {
  extern __shared__ float4 smem4[];
  float* sH = reinterpret_cast<float*>(smem4);  // [CK][R][W] h1 patch
  const int R = patch_rows(TM, F4), W = 2 * F4 + 1;
  float* sW = sH + CK * R * W;                    // [9][CK][TN] w2 chunk

  const int m0 = blockIdx.x * TM, n0 = blockIdx.y * TN, b = blockIdx.z;
  const int M = T4 * F4;
  const int tid = threadIdx.x, tm = tid >> 5, tn = tid & 31;
  const int t4_lo = m0 / F4;
  const int t1_lo = 2 * t4_lo - 1;

  // patch offset of each of this thread's positions at (di, df) = (0, 0):
  // row 2*(t4 - t4_lo) + di, column 2*f4 + df (column c holds f1 = c - 1)
  int off[8];
#pragma unroll
  for (int mi = 0; mi < 8; ++mi) {
    const int mm = min(m0 + 8 * tm + mi, M - 1);
    const int t4 = mm / F4, f4 = mm - (mm / F4) * F4;
    off[mi] = 2 * (t4 - t4_lo) * W + 2 * f4;
  }
  float acc[8][4];
#pragma unroll
  for (int mi = 0; mi < 8; ++mi)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[mi][q] = 0.f;

  const float* xb = x + (long long)b * Tn * F;
  for (int c0 = 0; c0 < C; c0 += CK) {
    __syncthreads();  // the previous chunk is no longer read
    for (int idx = tid; idx < CK * R * W; idx += NT) {
      const int ck = idx / (R * W), rem = idx - ck * (R * W);
      const int r = rem / W, col = rem - r * W;
      const int t1 = t1_lo + r, f1 = col - 1, c = c0 + ck;
      float val = 0.f;
      if (t1 >= 0 && t1 < T2 && f1 >= 0 && f1 < F2) {
        float a = 0.f;
#pragma unroll
        for (int di = 0; di < 3; ++di) {
          const int tx = 2 * t1 + di - 1;
          if (tx < 0 || tx >= Tn) continue;
#pragma unroll
          for (int df = 0; df < 3; ++df) {
            const int fx = 2 * f1 + df - 1;
            if (fx < 0 || fx >= F) continue;
            a = fmaf(xb[(long long)tx * F + fx], w1[(di * 3 + df) * C + c], a);
          }
        }
        val = fmaxf(a + b1[c], 0.f);
      }
      sH[idx] = val;
    }
    for (int idx = tid; idx < 9 * CK * TN; idx += NT) {
      const int k9 = idx / (CK * TN), rem = idx - k9 * (CK * TN);
      const int ck = rem / TN, n = rem - ck * TN;
      sW[idx] = w2[((long long)k9 * C + c0 + ck) * C + n0 + n];
    }
    __syncthreads();

    for (int ck = 0; ck < CK; ++ck) {
      const float* hc = sH + ck * R * W;
#pragma unroll
      for (int k9 = 0; k9 < 9; ++k9) {
        const int koff = (k9 / 3) * W + (k9 % 3);
        const float4 w = *reinterpret_cast<const float4*>(&sW[(k9 * CK + ck) * TN + 4 * tn]);
#pragma unroll
        for (int mi = 0; mi < 8; ++mi) {
          const float a = hc[off[mi] + koff];
          acc[mi][0] = fmaf(a, w.x, acc[mi][0]);
          acc[mi][1] = fmaf(a, w.y, acc[mi][1]);
          acc[mi][2] = fmaf(a, w.z, acc[mi][2]);
          acc[mi][3] = fmaf(a, w.w, acc[mi][3]);
        }
      }
    }
  }

  float bias[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) bias[q] = b2[n0 + 4 * tn + q];
#pragma unroll
  for (int mi = 0; mi < 8; ++mi) {
    const int m = m0 + 8 * tm + mi;
    if (m >= M) continue;
    const long long o = ((long long)b * M + m) * C + n0 + 4 * tn;
#pragma unroll
    for (int q = 0; q < 4; ++q) out[o + q] = fmaxf(acc[mi][q] + bias[q], 0.f);
  }
}

}  // namespace f32

// ------------------------------------------------------- bf16 tensor-core path

namespace tc {

constexpr int TM = 64;   // output positions per block
constexpr int NT = 256;  // 8 warps: 2 along positions x 4 along channels
constexpr int HP = 20;   // bf16 stride of a patch cell: 16 channels + pad (conflict-free)

// shared memory: the w2 chunk [9*CK][TN+8] bf16, the h1 patch [R*W cells][HP]
// bf16, the input rows [2R+1][F+2] fp32 (a zero column each side)
__host__ inline size_t smem_bytes(int TN, int F, int F4) {
  const int R = patch_rows(TM, F4);
  return (size_t)(9 * CK * (TN + 8) + R * (2 * F4 + 1) * HP) * sizeof(__nv_bfloat16) +
         (size_t)(2 * R + 1) * (F + 2) * sizeof(float);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int TN>
__global__ void __launch_bounds__(NT, 2) kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w1,
    const __nv_bfloat16* __restrict__ b1, const __nv_bfloat16* __restrict__ w2,
    const __nv_bfloat16* __restrict__ b2, __nv_bfloat16* __restrict__ out, int Tn, int F, int C,
    int T2, int F2, int T4, int F4) {
  constexpr int WS = TN + 8;    // bf16 stride of a staged w2 row (conflict-free ldmatrix)
  constexpr int NTW = TN / 32;  // n-tiles of 8 per warp: the warp tile is 32 x TN/4
  extern __shared__ float4 smem4[];
  const int R = patch_rows(TM, F4), W = 2 * F4 + 1, cells = R * W, XW = F + 2;
  __nv_bfloat16* sW = reinterpret_cast<__nv_bfloat16*>(smem4);  // [9*CK][WS]: rows (tap, k)
  __nv_bfloat16* sH = sW + 9 * CK * WS;                            // [cells][HP]
  float* sX = reinterpret_cast<float*>(sH + cells * HP);           // [2R+1][XW]

  const int m0 = blockIdx.x * TM, n0 = blockIdx.y * TN, b = blockIdx.z;
  const int M = T4 * F4;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;  // the warp's positions wm*32.., channels wn*TN/4..
  const int t4_lo = m0 / F4;
  const int t1_lo = 2 * t4_lo - 1;
  const int tx_lo = 2 * t1_lo - 1;

  // the input rows tx_lo .. tx_lo + 2R, zero outside [0, Tn) x [0, F)
  const __nv_bfloat16* xb = x + (long long)b * Tn * F;
  for (int idx = tid; idx < (2 * R + 1) * XW; idx += NT) {
    const int r = idx / XW, col = idx - r * XW;
    const int tx = tx_lo + r, fx = col - 1;
    sX[idx] = (tx >= 0 && tx < Tn && fx >= 0 && fx < F)
                  ? __bfloat162float(xb[(long long)tx * F + fx]) : 0.f;
  }

  // patch cell of each of this lane's 4 rows (2 m-tiles x rows g, g+8) at
  // tap (0, 0): row 2*(t4 - t4_lo), column 2*f4 (column j holds f1 = j - 1)
  int cell[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int mm = min(m0 + wm * 32 + mt * 16 + g + 8 * h, M - 1);
      const int t4 = mm / F4, f4 = mm - t4 * F4;
      cell[mt][h] = 2 * (t4 - t4_lo) * W + 2 * f4;
    }
  float acc[2][NTW][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;

  // B fragments by ldmatrix.x4.trans: lane L addresses w2 row k = L % 8 + 8 (L / 8 % 2)
  // at channel + 8 (L / 16), giving two n-tiles of 8 (B[k][n] stored n-contiguous)
  const uint32_t sw_lane =
      smem_u32(sW + ((lane & 7) + 8 * ((lane >> 3) & 1)) * WS + wn * (TN / 4) + 8 * (lane >> 4));
  const int cq = tid & 3;  // conv1: this thread computes channels 4cq .. 4cq+3 of the chunk

  for (int c0 = 0; c0 < C; c0 += CK) {
    __syncthreads();  // the previous chunk is no longer read (and sX is written)
    // w2 rows (tap, c0 + k), channels n0 .. n0 + TN: copied asynchronously
    // while conv1 runs
    for (int idx = tid; idx < 9 * CK * (TN / 8); idx += NT) {
      const int row = idx / (TN / 8), c8 = idx % (TN / 8);
      const int tap = row / CK, k = row % CK;
      const __nv_bfloat16* src = w2 + ((long long)tap * C + c0 + k) * C + n0 + 8 * c8;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       smem_u32(sW + row * WS + 8 * c8)),
                   "l"(src));
    }
    asm volatile("cp.async.commit_group;\n" ::);

    float wc[9][4], bc[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      bc[q] = __bfloat162float(b1[c0 + 4 * cq + q]);
#pragma unroll
      for (int k9 = 0; k9 < 9; ++k9) wc[k9][q] = __bfloat162float(w1[k9 * C + c0 + 4 * cq + q]);
    }
    for (int cl = tid >> 2; cl < cells; cl += NT / 4) {
      const int r = cl / W, col = cl - r * W;
      const int t1 = t1_lo + r, f1 = col - 1;
      float a[4] = {0.f, 0.f, 0.f, 0.f};
      if (t1 >= 0 && t1 < T2 && f1 >= 0 && f1 < F2) {
        // input row tx - tx_lo = 2r + di, column fx + 1 = 2 col + df - 2
        const float* xr = sX + 2 * r * XW + 2 * col - 2;
#pragma unroll
        for (int di = 0; di < 3; ++di)
#pragma unroll
          for (int df = 0; df < 3; ++df) {
            const float xv = xr[di * XW + df];
#pragma unroll
            for (int q = 0; q < 4; ++q) a[q] = fmaf(xv, wc[di * 3 + df][q], a[q]);
          }
#pragma unroll
        for (int q = 0; q < 4; ++q) a[q] = fmaxf(a[q] + bc[q], 0.f);
      }
      *reinterpret_cast<uint2*>(sH + cl * HP + 4 * cq) =
          make_uint2(pack_bf16x2(a[0], a[1]), pack_bf16x2(a[2], a[3]));
    }
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int toff = (tap / 3) * W + (tap % 3);
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const __nv_bfloat16* r0 = sH + (cell[mt][0] + toff) * HP + 2 * t;
        const __nv_bfloat16* r1 = sH + (cell[mt][1] + toff) * HP + 2 * t;
        a[mt][0] = ld_bf16x2(r0);
        a[mt][1] = ld_bf16x2(r1);
        a[mt][2] = ld_bf16x2(r0 + 8);
        a[mt][3] = ld_bf16x2(r1 + 8);
      }
#pragma unroll
      for (int np = 0; np < NTW / 2; ++np) {
        uint32_t bq[4];
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
            : "=r"(bq[0]), "=r"(bq[1]), "=r"(bq[2]), "=r"(bq[3])
            : "r"(sw_lane + 2 * (tap * CK * WS + 16 * np)));
        const uint32_t lo[2] = {bq[0], bq[1]}, hi[2] = {bq[2], bq[3]};
        mma_bf16_16816(acc[0][2 * np], a[0], lo);
        mma_bf16_16816(acc[1][2 * np], a[1], lo);
        mma_bf16_16816(acc[0][2 * np + 1], a[0], hi);
        mma_bf16_16816(acc[1][2 * np + 1], a[1], hi);
      }
    }
  }

#pragma unroll
  for (int nt = 0; nt < NTW; ++nt) {
    const int n = n0 + wn * (TN / 4) + nt * 8 + 2 * t;
    const float bias0 = __bfloat162float(b2[n]), bias1 = __bfloat162float(b2[n + 1]);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * 32 + mt * 16 + g + 8 * h;
        if (m >= M) continue;
        *reinterpret_cast<uint32_t*>(out + ((long long)b * M + m) * C + n) =
            pack_bf16x2(fmaxf(acc[mt][nt][2 * h] + bias0, 0.f),
                        fmaxf(acc[mt][nt][2 * h + 1] + bias1, 0.f));
      }
  }
}

}  // namespace tc

template <typename T>
int launch(void (*kernel)(const T*, const T*, const T*, const T*, const T*, T*, int, int, int,
                          int, int, int, int),
           size_t smem, int tm, int tn, int threads, const void* x, const void* w1, const void* b1,
           const void* w2, const void* b2, void* out, int B, int Tn, int F, int C,
           cudaStream_t stream) {
  const int T2 = (Tn - 1) / 2 + 1, T4 = (T2 - 1) / 2 + 1;
  const int F2 = (F - 1) / 2 + 1, F4 = (F2 - 1) / 2 + 1;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T4 * F4 + tm - 1) / tm, C / tn, B);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<const T*>(b2), static_cast<T*>(out), Tn, F, C, T2,
      F2, T4, F4);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t.
extern "C" int fused_subsampling_x4(int dtype, const void* x, const void* w1, const void* b1,
                                    const void* w2, const void* b2, void* out, int B, int Tn,
                                    int F, int C, void* stream) {
  if (B <= 0 || Tn <= 0 || F <= 0 || C <= 0 || C % 128 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int F4 = ((F - 1) / 2) / 2 + 1;
  if (dtype == 0)
    return launch<float>(f32::kernel, f32::smem_bytes(F4), f32::TM, f32::TN, f32::NT, x, w1,
                         b1, w2, b2, out, B, Tn, F, C, s);
  if (dtype == 1) {
    if (reinterpret_cast<uintptr_t>(out) % 4 != 0 || reinterpret_cast<uintptr_t>(w2) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
    // 256 output channels a block where C allows, so conv1 is recomputed C/256 times
    if (C % 256 == 0)
      return launch<__nv_bfloat16>(tc::kernel<256>, tc::smem_bytes(256, F, F4), tc::TM, 256,
                                   tc::NT, x, w1, b1, w2, b2, out, B, Tn, F, C, s);
    return launch<__nv_bfloat16>(tc::kernel<128>, tc::smem_bytes(128, F, F4), tc::TM, 128,
                                 tc::NT, x, w1, b1, w2, b2, out, B, Tn, F, C, s);
  }
  return (int)cudaErrorInvalidValue;
}
