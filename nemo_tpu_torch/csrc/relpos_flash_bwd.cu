// Rel-pos flash attention backward for Hopper (sm_90a), fp32 or bf16 inputs:
// K3 (dq side) and K4 (dk/dv side, and the rel-pos table's gradient dp).
//
// Replace the TPU kernels nemo_tpu/ops/flash_attention.py:_dq_kernel and
// _dkv_kernel in the non-causal form that nemo_tpu/ops/attention.py:
// _relpos_flash differentiates (G = H). The forward (relpos_flash.cu) is
//
//   s[i,j] = scale * (qu_i . k_j + qv_i . p_{(T-1)-i+j})  for j < len_b, else -inf
//
// and with P = exp(s - lse), delta_i = rowsum(dO_i * O_i) (a torch reduction
// before the launch, as JAX computes it outside its kernels) and
// dS = P * (dO v^T - delta) * scale, the kernels compute
//
//   K3: dqu_i = sum_j dS_ij k_j          dqv_i = sum_j dS_ij p_{T-1-i+j}
//   K4: dk_j  = sum_i dS_ij qu_i         dv_j  = sum_i P_ij dO_i
//       dp_r  = sum_{b, i, j: T-1-i+j = r} dS_ij qv_i
//
// Both recompute s exactly as K1 does, per 64 x 64 tile pair: qu.k^T plus the
// rel-pos term, from the BQ + BKV - 1 = 127 rows p[r0 .. r0+126] the pair
// reaches (r0 = T - 64 - i0 + j0, local row q = j - i + 63), staged in
// shared memory.
//
// - K3: one block per (b, h, 64 query rows), looping over the key tiles up to
//   the last valid key. dqv is the transpose of K1's band read: a warp writes
//   dS of its 16 rows into a [16][80] band at each score's diagonal column
//   (j - i + 15; the rest of the band stays 0) and multiplies it by the 80
//   rows of p its rows reach.
// - K4: one block per (b, h, 64 keys), looping over every query tile (every
//   row is a query, padded rows included). Each warp owns 16 keys and works
//   on transposed scores (keys x queries); the rel-pos term of a score is
//   read from the block's [64 queries][80] qv.p^T band, which the 4 warps
//   compute first. dp spans the 127 rows of the tile pair and is summed over
//   the batch and over every pair on a diagonal, so no block owns it: dS is
//   written to a [128 rows of p][64 queries] band in shared memory, one
//   product band . qv gives the pair's 127 x 64 contribution, and it is
//   added to a global fp32 dp with atomics (run-to-run order varies).
//
// bf16 (the main path): tensor cores through mma.sync m16n8k16 with fp32
// accumulators; P and dS are rounded to bf16 before each product, as the JAX
// kernels round them to the input dtype (flash_attention.py:248,291,299).
// fp32 (the exactness check): scalar fp32 FMAs from shared-memory tiles.
//
// Bound on the H100: per tile pair K3 does 5 products of 64 x 64 x 64 (q.k,
// q.p band, dO.v, dS.k, band.p) and K4 about 7 (with the 128-row dp product),
// against ~6 x 2 B x T x H x 64 bytes of inputs and outputs, so operations
// bound both at the main path's shapes. wgmma, TMA and pipelining come later.
//
// Layouts: qu, qv, k, v, dO and dqu, dqv, dk, dv are [B, T, H, 64]; p is
// [2T-1, H, 64], dp [2T-1, H, 64] fp32 (zeroed by the caller); lse and delta
// are [B, H, T] fp32; lengths [B] int32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int D = 64;
constexpr int NP = BQ + BKV - 1;  // rel-pos rows one tile pair reaches
constexpr int NPR = 128;          // rel-pos rows staged per tile pair

// ---------------------------------------------------------------- fp32 path

namespace f32 {

constexpr int NT = 256;       // 16 x 16 threads
constexpr int LD = D + 1;     // stride of the [rows][64] tiles
constexpr int LDT = BKV + 1;  // stride of the [64][64] score tiles

// shared memory, floats. K3: Qu, Qv, dO [BQ][LD]; K, V [BKV][LD]; p [NPR][LD]; dS [BQ][LDT]
constexpr size_t SMEM_DQ = (3 * BQ * LD + 2 * BKV * LD + NPR * LD + BQ * LDT) * sizeof(float);
// K4: K, V [BKV][LD]; Qu, Qv, dO [BQ][LD]; p [NPR][LD]; dS, P [BQ][LDT]; lse, delta [BQ]
constexpr size_t SMEM_DKV =
    (2 * BKV * LD + 3 * BQ * LD + NPR * LD + 2 * BQ * LDT + 2 * BQ) * sizeof(float);

// rows [row0, row0 + n) of a [rows, H, 64] tensor at head offset hoff into
// shared memory [n][LD]; rows outside [0, rows) are 0
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int row0, int n,
                                      int rows, long long rs, long long hoff) {
  for (int idx = threadIdx.x; idx < n * D; idx += NT) {
    const int r = idx / D, d = idx % D, t = row0 + r;
    dst[r * LD + d] = (t >= 0 && t < rows) ? src[t * rs + hoff + d] : 0.f;
  }
}

// s, P and dS of scores (il = ty + 16a, jl = tx + 16c) of a tile pair:
// returns the P of each into `pr` and dS into `ds` (both [BQ][LDT])
__device__ __forceinline__ void scores(const float* sQu, const float* sQv, const float* sO,
                                       const float* sK, const float* sV, const float* sP,
                                       const float* lse, const float* del, int j0, int i0,
                                       int len, int Tn, float scale, float* pr, float* ds) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  for (int a = 0; a < 4; ++a) {
    const int il = ty + 16 * a;
    for (int c = 0; c < 4; ++c) {
      const int jl = tx + 16 * c;
      const float* prow = sP + (jl - il + 63) * LD;
      float s = 0.f, dp = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        s = fmaf(sQu[il * LD + d], sK[jl * LD + d], s);
        s = fmaf(sQv[il * LD + d], prow[d], s);
        dp = fmaf(sO[il * LD + d], sV[jl * LD + d], dp);
      }
      const bool valid = j0 + jl < len && i0 + il < Tn;
      const float P = valid ? expf(s * scale - lse[il]) : 0.f;
      if (pr) pr[il * LDT + jl] = P;
      ds[il * LDT + jl] = P * (dp - del[il]) * scale;
    }
  }
}

__global__ void __launch_bounds__(NT) dq_kernel(
    const float* __restrict__ qu, const float* __restrict__ qv, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ p, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ lengths, float* __restrict__ dqu, float* __restrict__ dqv, int H,
    int Tn, float scale) {
  extern __shared__ float4 smem4[];
  float* sQu = reinterpret_cast<float*>(smem4);
  float* sQv = sQu + BQ * LD;
  float* sO = sQv + BQ * LD;
  float* sK = sO + BQ * LD;
  float* sV = sK + BKV * LD;
  float* sP = sV + BKV * LD;
  float* sDS = sP + NPR * LD;
  __shared__ float sL[BQ], sDl[BQ];

  const int i0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int len = min(max(lengths[b], 0), Tn);
  const long long rs = (long long)H * D;
  const long long bbase = (long long)b * Tn * rs, hoff = (long long)h * D;
  const long long lrow = ((long long)b * H + h) * Tn;

  stage(sQu, qu + bbase, i0, BQ, Tn, rs, hoff);
  stage(sQv, qv + bbase, i0, BQ, Tn, rs, hoff);
  stage(sO, dout + bbase, i0, BQ, Tn, rs, hoff);
  for (int idx = tid; idx < BQ; idx += NT) {
    const int i = i0 + idx;
    sL[idx] = i < Tn ? lse[lrow + i] : 0.f;
    sDl[idx] = i < Tn ? delta[lrow + i] : 0.f;
  }

  float aq[4][4], av[4][4];  // rows ty + 16a, columns tx + 16c
  for (int a = 0; a < 4; ++a)
    for (int c = 0; c < 4; ++c) aq[a][c] = av[a][c] = 0.f;

  const int n_kv = (len + BKV - 1) / BKV;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int j0 = kt * BKV;
    __syncthreads();  // the previous tile is no longer read
    stage(sK, k + bbase, j0, BKV, Tn, rs, hoff);
    stage(sV, v + bbase, j0, BKV, Tn, rs, hoff);
    stage(sP, p, Tn - BQ - i0 + j0, NPR, 2 * Tn - 1, rs, hoff);
    __syncthreads();
    scores(sQu, sQv, sO, sK, sV, sP, sL, sDl, j0, i0, len, Tn, scale, nullptr, sDS);
    __syncthreads();
    for (int a = 0; a < 4; ++a) {
      const int il = ty + 16 * a;
      for (int jl = 0; jl < BKV; ++jl) {
        const float ds = sDS[il * LDT + jl];
        const float* prow = sP + (jl - il + 63) * LD;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          aq[a][c] = fmaf(ds, sK[jl * LD + tx + 16 * c], aq[a][c]);
          av[a][c] = fmaf(ds, prow[tx + 16 * c], av[a][c]);
        }
      }
    }
  }
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty + 16 * a;
    if (i >= Tn) continue;
    for (int c = 0; c < 4; ++c) {
      dqu[bbase + i * rs + hoff + tx + 16 * c] = aq[a][c];
      dqv[bbase + i * rs + hoff + tx + 16 * c] = av[a][c];
    }
  }
}

__global__ void __launch_bounds__(NT) dkv_kernel(
    const float* __restrict__ qu, const float* __restrict__ qv, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ p, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ lengths, float* __restrict__ dk, float* __restrict__ dv,
    float* __restrict__ dp, int H, int Tn, float scale) {
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + BKV * LD;
  float* sQu = sV + BKV * LD;
  float* sQv = sQu + BQ * LD;
  float* sO = sQv + BQ * LD;
  float* sP = sO + BQ * LD;
  float* sDS = sP + NPR * LD;
  float* sPr = sDS + BQ * LDT;
  float* sL = sPr + BQ * LDT;
  float* sDl = sL + BQ;

  const int j0 = blockIdx.x * BKV, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int len = min(max(lengths[b], 0), Tn);
  const long long rs = (long long)H * D;
  const long long bbase = (long long)b * Tn * rs, hoff = (long long)h * D;
  const long long lrow = ((long long)b * H + h) * Tn;

  float ak[4][4], avv[4][4];  // keys ty + 16a, columns tx + 16c
  for (int a = 0; a < 4; ++a)
    for (int c = 0; c < 4; ++c) ak[a][c] = avv[a][c] = 0.f;

  if (j0 < len) {  // a tile of masked keys has zero gradients
    stage(sK, k + bbase, j0, BKV, Tn, rs, hoff);
    stage(sV, v + bbase, j0, BKV, Tn, rs, hoff);
    const int n_q = (Tn + BQ - 1) / BQ;
    for (int qt = 0; qt < n_q; ++qt) {
      const int i0 = qt * BQ;
      const int r0 = Tn - BQ - i0 + j0;
      __syncthreads();  // the previous tile is no longer read
      stage(sQu, qu + bbase, i0, BQ, Tn, rs, hoff);
      stage(sQv, qv + bbase, i0, BQ, Tn, rs, hoff);
      stage(sO, dout + bbase, i0, BQ, Tn, rs, hoff);
      stage(sP, p, r0, NPR, 2 * Tn - 1, rs, hoff);
      for (int idx = tid; idx < BQ; idx += NT) {
        const int i = i0 + idx;
        sL[idx] = i < Tn ? lse[lrow + i] : 0.f;
        sDl[idx] = i < Tn ? delta[lrow + i] : 0.f;
      }
      __syncthreads();
      scores(sQu, sQv, sO, sK, sV, sP, sL, sDl, j0, i0, len, Tn, scale, sPr, sDS);
      __syncthreads();
      for (int a = 0; a < 4; ++a) {
        const int jl = ty + 16 * a;
        for (int il = 0; il < BQ; ++il) {
          const float ds = sDS[il * LDT + jl], pp = sPr[il * LDT + jl];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            ak[a][c] = fmaf(ds, sQu[il * LD + tx + 16 * c], ak[a][c]);
            avv[a][c] = fmaf(pp, sO[il * LD + tx + 16 * c], avv[a][c]);
          }
        }
      }
      // dp rows r0 + q (q = ty + 16a): the pairs (il, jl = q + il - 63) of the tile
      for (int a = 0; a < 8; ++a) {
        const int q = ty + 16 * a, r = r0 + q;
        if (q >= NP || r < 0 || r >= 2 * Tn - 1) continue;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        const int il_lo = max(0, 63 - q), il_hi = min(BQ - 1, NP - 1 - q);
        for (int il = il_lo; il <= il_hi; ++il) {
          const float ds = sDS[il * LDT + q + il - 63];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[c] = fmaf(ds, sQv[il * LD + tx + 16 * c], acc[c]);
        }
        float* dst = dp + ((long long)r * H + h) * D + tx;
#pragma unroll
        for (int c = 0; c < 4; ++c) atomicAdd(dst + 16 * c, acc[c]);
      }
    }
  }
  for (int a = 0; a < 4; ++a) {
    const int j = j0 + ty + 16 * a;
    if (j >= Tn) continue;
    for (int c = 0; c < 4; ++c) {
      dk[bbase + j * rs + hoff + tx + 16 * c] = ak[a][c];
      dv[bbase + j * rs + hoff + tx + 16 * c] = avv[a][c];
    }
  }
}

}  // namespace f32

// ------------------------------------------------------- bf16 tensor-core path

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int NT = 128;        // 4 warps x 16 rows
constexpr int LDS = D + 8;     // bf16 stride of the staged [rows][64] tiles
constexpr int NBD = 80;        // p rows the 16 query rows of a warp reach
constexpr int LDB = NBD + 4;   // fp32 stride of the qv.p^T band
constexpr int LDH = NBD + 8;   // bf16 stride of K3's dS band [16][80]
constexpr int LDD = BQ + 8;    // bf16 stride of K4's dS band [128][64]

// K3: K, V [BKV][LDS], p [NPR][LDS]; per warp a [16][LDB] fp32 band and a [16][LDH] bf16 band
constexpr size_t SMEM_DQ = (2 * BKV + NPR) * LDS * sizeof(bf16) +
                           (NT / 32) * 16 * (LDB * sizeof(float) + LDH * sizeof(bf16));
// K4: Qu, Qv, dO [BQ][LDS], p [NPR][LDS]; the [BQ][LDB] fp32 band; the
// [NPR][LDD] bf16 dS band; lse, delta [BQ]
constexpr size_t SMEM_DKV = (3 * BQ + NPR) * LDS * sizeof(bf16) + BQ * LDB * sizeof(float) +
                            NPR * LDD * sizeof(bf16) + 2 * BQ * sizeof(float);

// rows [row0, row0 + n) of a [rows, H, 64] tensor at head offset hoff into
// shared memory [n][LDS]; rows outside [0, rows) are 0
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* __restrict__ src, int row0,
                                           int n, int rows, long long rs, long long hoff) {
  for (int idx = threadIdx.x; idx < n * (D / 8); idx += NT) {
    const int r = idx / (D / 8), c = idx % (D / 8), t = row0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (t >= 0 && t < rows) val = *reinterpret_cast<const uint4*>(src + t * rs + hoff + 8 * c);
    *reinterpret_cast<uint4*>(dst + r * LDS + 8 * c) = val;
  }
}

// A fragments (4 k-steps of 16) of rows ra, rb of a [T, H, 64] tensor in device memory
__device__ __forceinline__ void load_rows_a(uint32_t f[4][4], const bf16* __restrict__ src,
                                            int ra, int rb, int Tn, long long rs,
                                            long long hoff, int t) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = (e & 1) ? rb : ra;
      const int d = 16 * ks + 2 * t + 8 * (e >> 1);
      f[ks][e] = (r < Tn) ? ld_bf16x2(src + r * rs + hoff + d) : 0u;
    }
}

// A fragment of k-step ks of a row-major bf16 [16][ld] tile in shared memory
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* m, int ld, int ks, int g,
                                       int t) {
  const bf16* r0 = m + g * ld + 16 * ks + 2 * t;
  const bf16* r1 = r0 + 8 * ld;
  a[0] = ld_bf16x2(r0);
  a[1] = ld_bf16x2(r1);
  a[2] = ld_bf16x2(r0 + 8);
  a[3] = ld_bf16x2(r1 + 8);
}

// the 16 x 64 accumulator tile (8 n-tiles) as bf16 A fragments of 4 k-steps
__device__ __forceinline__ void pack_a(uint32_t a[4][4], const float s[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
    a[kk][1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
    a[kk][2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    a[kk][3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
}

// acc[16 x 8 NTL] += A[16 x 64] . M^T for M [n][LDS] (k = d contiguous) in shared memory
template <int NTL>
__device__ __forceinline__ void mma_nt(float acc[][4], const uint32_t a[4][4], const bf16* m,
                                       int g, int t) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt) {
      const bf16* r = m + (8 * nt + g) * LDS + 16 * ks + 2 * t;
      const uint32_t bb[2] = {ld_bf16x2(r), ld_bf16x2(r + 8)};
      mma_bf16_16816(acc[nt], a[ks], bb);
    }
}

// acc[16 x 64] += A[16 x 16 KS] . M for M [16 KS][LDS] row-major in shared
// memory; B fragments by ldmatrix.x4.trans (lane L addresses row L % 8 +
// 8 (L / 8 % 2) at column 8 (L / 16): two n-tiles of 8 per load)
template <int KS>
__device__ __forceinline__ void mma_nn(float acc[8][4], const uint32_t a[KS][4], const bf16* m,
                                       int lane) {
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(
      m + ((lane & 7) + 8 * ((lane >> 3) & 1)) * LDS + 8 * (lane >> 4)));
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int dp = 0; dp < 4; ++dp) {
      uint32_t bq[4];
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
          : "=r"(bq[0]), "=r"(bq[1]), "=r"(bq[2]), "=r"(bq[3])
          : "r"(base + 2 * (16 * kk * LDS + 16 * dp)));
      const uint32_t lo[2] = {bq[0], bq[1]}, hi[2] = {bq[2], bq[3]};
      mma_bf16_16816(acc[2 * dp], a[kk], lo);
      mma_bf16_16816(acc[2 * dp + 1], a[kk], hi);
    }
}

__device__ __forceinline__ void zero(float acc[][4], int n) {
  for (int i = 0; i < n; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
}

// rows ra, rb of a 16 x 64 accumulator into a [T, H, 64] bf16 tensor
__device__ __forceinline__ void store_rows(bf16* dst, const float acc[8][4], int ra, int rb,
                                           int Tn, long long rs, long long hoff, int t) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = hh ? rb : ra;
    if (r >= Tn) continue;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt)
      *reinterpret_cast<uint32_t*>(dst + r * rs + hoff + 8 * dt + 2 * t) =
          pack_bf16x2(acc[dt][2 * hh], acc[dt][2 * hh + 1]);
  }
}

__global__ void __launch_bounds__(NT, 2) dq_kernel(
    const bf16* __restrict__ qu, const bf16* __restrict__ qv, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ p, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ lengths, bf16* __restrict__ dqu, bf16* __restrict__ dqv, int H,
    int Tn, float scale) {
  extern __shared__ float4 smem4[];
  bf16* sK = reinterpret_cast<bf16*>(smem4);  // [BKV][LDS]: k_j
  bf16* sV = sK + BKV * LDS;                  // [BKV][LDS]: v_j
  bf16* sP = sV + BKV * LDS;                  // [NPR][LDS]: p rows r0 + q

  const int i0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float* sB = reinterpret_cast<float*>(sP + NPR * LDS) + warp * 16 * LDB;  // qv.p^T [16][LDB]
  bf16* sD = reinterpret_cast<bf16*>(reinterpret_cast<float*>(sP + NPR * LDS) +
                                     (NT / 32) * 16 * LDB) + warp * 16 * LDH;  // dS [16][LDH]
  const int len = min(max(lengths[b], 0), Tn);
  const long long rs = (long long)H * D;
  const long long bbase = (long long)b * Tn * rs, hoff = (long long)h * D;
  const long long lrow = ((long long)b * H + h) * Tn;

  // this warp's query rows ia, ib as A fragments
  const int ia = i0 + 16 * warp + g, ib = ia + 8;
  uint32_t fu[4][4], fv[4][4], fo[4][4];
  load_rows_a(fu, qu + bbase, ia, ib, Tn, rs, hoff, t);
  load_rows_a(fv, qv + bbase, ia, ib, Tn, rs, hoff, t);
  load_rows_a(fo, dout + bbase, ia, ib, Tn, rs, hoff, t);
  const float lse_r[2] = {ia < Tn ? lse[lrow + ia] : 0.f, ib < Tn ? lse[lrow + ib] : 0.f};
  const float del_r[2] = {ia < Tn ? delta[lrow + ia] : 0.f, ib < Tn ? delta[lrow + ib] : 0.f};

  // the dS band: columns outside each row's 64 diagonals stay 0 for good
  for (int idx = lane; idx < 16 * LDH / 2; idx += 32) reinterpret_cast<uint32_t*>(sD)[idx] = 0u;

  float aq[8][4], av[8][4];
  zero(aq, 8);
  zero(av, 8);
  const int q_lo = BQ - 16 - 16 * warp;  // first p row (local) this warp reads
  const int n_kv = (len + BKV - 1) / BKV;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int j0 = kt * BKV;
    __syncthreads();  // the previous tile is no longer read
    stage_rows(sK, k + bbase, j0, BKV, Tn, rs, hoff);
    stage_rows(sV, v + bbase, j0, BKV, Tn, rs, hoff);
    stage_rows(sP, p, Tn - BQ - i0 + j0, NPR, 2 * Tn - 1, rs, hoff);
    __syncthreads();

    // s = qu k^T and the band qv p^T over this warp's 80 p rows, as in K1
    float s[8][4];
    zero(s, 8);
    {
      float bd[10][4];
      zero(bd, 10);
      mma_nt<8>(s, fu, sK, g, t);
      mma_nt<10>(bd, fv, sP + q_lo * LDS, g, t);
#pragma unroll
      for (int nt = 0; nt < 10; ++nt) {
        *reinterpret_cast<float2*>(sB + g * LDB + 8 * nt + 2 * t) =
            make_float2(bd[nt][0], bd[nt][1]);
        *reinterpret_cast<float2*>(sB + (g + 8) * LDB + 8 * nt + 2 * t) =
            make_float2(bd[nt][2], bd[nt][3]);
      }
    }
    __syncwarp();
    // P: row r of the warp, key jl reads its rel-pos term at column jl - r + 15
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = g + 8 * (e >> 1), jl = 8 * nt + 2 * t + (e & 1);
        const float val = (s[nt][e] + sB[r * LDB + jl - r + 15]) * scale;
        s[nt][e] = (j0 + jl < len) ? __expf(val - lse_r[e >> 1]) : 0.f;
      }

    // dS = P (dO v^T - delta) scale
    {
      float dpr[8][4];
      zero(dpr, 8);
      mma_nt<8>(dpr, fo, sV, g, t);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[nt][e] = s[nt][e] * (dpr[nt][e] - del_r[e >> 1]) * scale;
    }
    uint32_t a[4][4];
    pack_a(a, s);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = g + 8 * (e >> 1), jl = 8 * nt + 2 * t + (e & 1);
        sD[r * LDH + jl - r + 15] = __float2bfloat16_rn(s[nt][e]);
      }
    __syncwarp();

    mma_nn<4>(aq, a, sK, lane);  // dqu += dS k
    {
      uint32_t ab[5][4];  // dqv += band . p rows q_lo .. q_lo + 79
#pragma unroll
      for (int ks = 0; ks < 5; ++ks) load_a(ab[ks], sD, LDH, ks, g, t);
      mma_nn<5>(av, ab, sP + q_lo * LDS, lane);
    }
  }
  store_rows(dqu + bbase, aq, ia, ib, Tn, rs, hoff, t);
  store_rows(dqv + bbase, av, ia, ib, Tn, rs, hoff, t);
}

__global__ void __launch_bounds__(NT, 2) dkv_kernel(
    const bf16* __restrict__ qu, const bf16* __restrict__ qv, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ p, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ lengths, bf16* __restrict__ dk, bf16* __restrict__ dv,
    float* __restrict__ dp, int H, int Tn, float scale) {
  extern __shared__ float4 smem4[];
  bf16* sQu = reinterpret_cast<bf16*>(smem4);  // [BQ][LDS]
  bf16* sQv = sQu + BQ * LDS;                  // [BQ][LDS]
  bf16* sO = sQv + BQ * LDS;                   // [BQ][LDS]: dO
  bf16* sP = sO + BQ * LDS;                    // [NPR][LDS]: p rows r0 + q
  float* sBd = reinterpret_cast<float*>(sP + NPR * LDS);  // [BQ][LDB]: qv.p^T band
  bf16* sS = reinterpret_cast<bf16*>(sBd + BQ * LDB);     // [NPR][LDD]: dS at (q, il)
  float* sL = reinterpret_cast<float*>(sS + NPR * LDD);   // [BQ] lse
  float* sDl = sL + BQ;                                   // [BQ] delta

  const int j0 = blockIdx.x * BKV, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int len = min(max(lengths[b], 0), Tn);
  const long long rs = (long long)H * D;
  const long long bbase = (long long)b * Tn * rs, hoff = (long long)h * D;
  const long long lrow = ((long long)b * H + h) * Tn;

  // this warp's keys ja, jb (local 16 warp + g, + 8)
  const int ja = j0 + 16 * warp + g, jb = ja + 8;
  float ak[8][4], avv[8][4];
  zero(ak, 8);
  zero(avv, 8);
  if (j0 < len) {  // a tile of masked keys has zero gradients
    uint32_t fk[4][4], fvv[4][4];
    load_rows_a(fk, k + bbase, ja, jb, Tn, rs, hoff, t);
    load_rows_a(fvv, v + bbase, ja, jb, Tn, rs, hoff, t);
    // the dS band: cells (q, il) off the tile's diagonals stay 0 for good
    for (int idx = threadIdx.x; idx < NPR * LDD / 2; idx += NT)
      reinterpret_cast<uint32_t*>(sS)[idx] = 0u;
    const int q_lo = BQ - 16 - 16 * warp;  // band rows for query rows 16 warp ..
    const int n_q = (Tn + BQ - 1) / BQ;
    for (int qt = 0; qt < n_q; ++qt) {
      const int i0 = qt * BQ;
      const int r0 = Tn - BQ - i0 + j0;
      __syncthreads();  // the previous tile is no longer read
      stage_rows(sQu, qu + bbase, i0, BQ, Tn, rs, hoff);
      stage_rows(sQv, qv + bbase, i0, BQ, Tn, rs, hoff);
      stage_rows(sO, dout + bbase, i0, BQ, Tn, rs, hoff);
      stage_rows(sP, p, r0, NPR, 2 * Tn - 1, rs, hoff);
      for (int idx = threadIdx.x; idx < BQ; idx += NT) {
        const int i = i0 + idx;
        sL[idx] = i < Tn ? lse[lrow + i] : 0.f;
        sDl[idx] = i < Tn ? delta[lrow + i] : 0.f;
      }
      __syncthreads();

      // the band qv.p^T of query rows 16 warp .. 16 warp + 15, as in K1
      {
        float bd[10][4];
        zero(bd, 10);
        uint32_t fq[4][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) load_a(fq[ks], sQv + 16 * warp * LDS, LDS, ks, g, t);
        mma_nt<10>(bd, fq, sP + q_lo * LDS, g, t);
        float* dst = sBd + 16 * warp * LDB;
#pragma unroll
        for (int nt = 0; nt < 10; ++nt) {
          *reinterpret_cast<float2*>(dst + g * LDB + 8 * nt + 2 * t) =
              make_float2(bd[nt][0], bd[nt][1]);
          *reinterpret_cast<float2*>(dst + (g + 8) * LDB + 8 * nt + 2 * t) =
              make_float2(bd[nt][2], bd[nt][3]);
        }
      }
      __syncthreads();

      // transposed scores: key row r (jl = 16 warp + r) x query il; the
      // rel-pos term of (il, jl) sits in row il of the band at column
      // jl - (il % 16) + 15
      float s[8][4];
      zero(s, 8);
      mma_nt<8>(s, fk, sQu, g, t);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jl = 16 * warp + g + 8 * (e >> 1), il = 8 * nt + 2 * t + (e & 1);
          const float val = (s[nt][e] + sBd[il * LDB + jl - (il & 15) + 15]) * scale;
          s[nt][e] = (j0 + jl < len && i0 + il < Tn) ? __expf(val - sL[il]) : 0.f;
        }
      uint32_t a[4][4];
      pack_a(a, s);
      mma_nn<4>(avv, a, sO, lane);  // dv += P^T dO
      {
        float dpt[8][4];
        zero(dpt, 8);
        mma_nt<8>(dpt, fvv, sO, g, t);  // (dO v^T)^T
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int il = 8 * nt + 2 * t + (e & 1);
            s[nt][e] = s[nt][e] * (dpt[nt][e] - sDl[il]) * scale;
          }
      }
      pack_a(a, s);
      mma_nn<4>(ak, a, sQu, lane);  // dk += dS^T qu
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jl = 16 * warp + g + 8 * (e >> 1), il = 8 * nt + 2 * t + (e & 1);
          sS[(jl - il + 63) * LDD + il] = __float2bfloat16_rn(s[nt][e]);
        }
      __syncthreads();

      // dp rows r0 + q for this warp's q in [32 warp, 32 warp + 32): dS band . qv
#pragma unroll 1
      for (int mt = 0; mt < 2; ++mt) {
        const int qb = 32 * warp + 16 * mt;
        float acc[8][4];
        zero(acc, 8);
        uint32_t fa[4][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) load_a(fa[ks], sS + qb * LDD, LDD, ks, g, t);
        mma_nn<4>(acc, fa, sQv, lane);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int q = qb + g + 8 * hh, r = r0 + q;
          if (q >= NP || r < 0 || r >= 2 * Tn - 1) continue;
          float* dst = dp + ((long long)r * H + h) * D + 2 * t;
#pragma unroll
          for (int dt = 0; dt < 8; ++dt) {
            atomicAdd(dst + 8 * dt, acc[dt][2 * hh]);
            atomicAdd(dst + 8 * dt + 1, acc[dt][2 * hh + 1]);
          }
        }
      }
    }
  }
  store_rows(dk + bbase, ak, ja, jb, Tn, rs, hoff, t);
  store_rows(dv + bbase, avv, ja, jb, Tn, rs, hoff, t);
}

}  // namespace tc

template <typename K>
int launch(K kernel, size_t smem, int threads, int grid_x, int B, int H, cudaStream_t stream,
           void** args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernel(reinterpret_cast<const void*>(kernel), dim3(grid_x, H, B),
                         dim3(threads), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

bool aligned16(const void* const* ptrs, int n) {
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return false;
  return true;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (every bf16 tensor 16-byte aligned).
// head_dim must be 64. Each returns a cudaError_t.

// K3: dqu, dqv [B, T, H, 64] in the input dtype.
extern "C" int relpos_flash_bwd_dq(int dtype, void* qu, void* qv, void* k, void* v, void* p,
                                   void* dout, void* lse, void* delta, void* lengths, void* dqu,
                                   void* dqv, int B, int H, int Tn, int head_dim, float scale,
                                   void* stream) {
  if (head_dim != D || B <= 0 || H <= 0 || Tn <= 0) return (int)cudaErrorInvalidValue;
  void* args[] = {&qu, &qv, &k, &v, &p, &dout, &lse, &delta, &lengths, &dqu, &dqv, &H, &Tn,
                  &scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid_x = (Tn + BQ - 1) / BQ;
  if (dtype == 0) return launch(f32::dq_kernel, f32::SMEM_DQ, f32::NT, grid_x, B, H, s, args);
  if (dtype == 1) {
    const void* bf[] = {qu, qv, k, v, p, dout, dqu, dqv};
    if (!aligned16(bf, 8)) return (int)cudaErrorMisalignedAddress;
    return launch(tc::dq_kernel, tc::SMEM_DQ, tc::NT, grid_x, B, H, s, args);
  }
  return (int)cudaErrorInvalidValue;
}

// K4: dk, dv [B, T, H, 64] in the input dtype; dp [2T-1, H, 64] fp32, added to.
extern "C" int relpos_flash_bwd_dkv(int dtype, void* qu, void* qv, void* k, void* v, void* p,
                                    void* dout, void* lse, void* delta, void* lengths, void* dk,
                                    void* dv, void* dp, int B, int H, int Tn, int head_dim,
                                    float scale, void* stream) {
  if (head_dim != D || B <= 0 || H <= 0 || Tn <= 0) return (int)cudaErrorInvalidValue;
  void* args[] = {&qu, &qv, &k, &v, &p, &dout, &lse, &delta, &lengths, &dk, &dv, &dp, &H, &Tn,
                  &scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid_x = (Tn + BKV - 1) / BKV;
  if (dtype == 0) return launch(f32::dkv_kernel, f32::SMEM_DKV, f32::NT, grid_x, B, H, s, args);
  if (dtype == 1) {
    const void* bf[] = {qu, qv, k, v, p, dout, dk, dv};
    if (!aligned16(bf, 8)) return (int)cudaErrorMisalignedAddress;
    return launch(tc::dkv_kernel, tc::SMEM_DKV, tc::NT, grid_x, B, H, s, args);
  }
  return (int)cudaErrorInvalidValue;
}
