// Rel-pos flash attention forward for Hopper (sm_90a), fp32 or bf16 inputs.
//
// Replaces the TPU kernel nemo_tpu/ops/flash_attention.py:_fwd_kernel as
// nemo_tpu/ops/attention.py:_relpos_flash calls it (non-causal, G = H, with
// the Transformer-XL rel-pos term and the key padding folded into a 640-wide
// augmented contraction). Here the rel-pos term is computed per tile from the
// projected table p instead, at head width dh = 64:
//
//   s[i,j] = scale * (qu_i . k_j + qv_i . p_{(T-1)-i+j})   for j < len_b
//   s[i,j] = -1e30                                          otherwise
//   o_i    = softmax_j(s[i,:]) v ;  lse_i = log sum_j exp s[i,j]
//
// One block owns (b, h, a tile of BQ = 64 query rows) and loops over tiles of
// BKV = 64 keys with an online softmax; the loop stops at the last tile that
// holds a valid key (ceil(len_b / 64) tiles). The rows of p that a (query
// tile, key tile) pair needs are the BQ + BKV - 1 = 127 consecutive rows
// r0 .. r0+126, r0 = T - BQ - i0 + j0 (local row q = j - i + 63): they are
// staged in shared memory beside the key tile.
//
// Bound on the H100: 6 * B * H * T * len * dh operations (q.k, q.p, p.v) over
// ~125 MB of q/k/v/o traffic at the main-path shape, so the operations bound
// it (0.056 ms at the bf16 tensor-core peak).
//
// - bf16 (the main path): tensor cores through mma.sync m16n8k16 (fp32
//   accumulators), 4 warps of 16 query rows. Per key tile a warp computes
//   qu.k^T (16 x 64) and qv.p^T over the 80 rows of p its 16 rows reach
//   (16 x 80), writes the latter to shared memory and reads each score's
//   rel-pos term back at its diagonal (column j - i + 15), then p.v with the
//   probabilities rounded to bf16 straight from the score registers and v's
//   fragments read by ldmatrix.trans from its row-major tile.
// - fp32 (the exactness check): scalar fp32 FMAs from shared-memory tiles,
//   16 x 16 threads with 4 x 4 scores each.
// wgmma, TMA and double buffering come later.
//
// Layouts: qu, qv, k, v and o are [B, T, H, 64] (the Linear outputs viewed
// per head); p is [2T-1, H, 64]; lengths is [B] int32; lse is [B, H, T] fp32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "mma_bf16.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int D = 64;
constexpr float NEG = -1e30f;

// ---------------------------------------------------------------- fp32 path

namespace f32 {

constexpr int NT = 256;            // 16 x 16 threads, 4 x 4 scores each
constexpr int LDT = BQ + 4;        // stride of the transposed [D][rows] tiles
constexpr int NP = BQ + BKV - 1;   // rel-pos rows one tile pair needs
constexpr int LDP = 128 + 4;       // stride of the transposed p tile

// shared memory, in floats: Qu^T, Qv^T, K^T (reused for the probabilities), V, P^T
constexpr size_t SMEM = (3 * D * LDT + BKV * D + D * LDP) * sizeof(float);

__global__ void __launch_bounds__(NT, 2) kernel(
    const float* __restrict__ qu, const float* __restrict__ qv, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ p, const int* __restrict__ lengths,
    float* __restrict__ o, float* __restrict__ lse, int H, int Tn, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sQu = smem;               // [D][LDT]
  float* sQv = sQu + D * LDT;      // [D][LDT]
  float* sK = sQv + D * LDT;       // [D][LDT]; then probabilities [BKV][LDT]
  float* sV = sK + D * LDT;        // [BKV][D]
  float* sP = sV + BKV * D;        // [D][LDP]

  const int i0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int len = min(max(lengths[b], 0), Tn);
  const long long rs = (long long)H * D;                 // stride of t
  const long long base = (long long)b * Tn * rs + (long long)h * D;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D, d = idx % D, t = i0 + r;
    float a = 0.f, c = 0.f;
    if (t < Tn) {
      a = qu[base + t * rs + d];
      c = qv[base + t * rs + d];
    }
    sQu[d * LDT + r] = a;
    sQv[d * LDT + r] = c;
  }

  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    m[ii] = NEG;
    l[ii] = 0.f;
#pragma unroll
    for (int dd = 0; dd < 4; ++dd) acc[ii][dd] = 0.f;
  }

  // local p row of score (ii, jj) of this thread is pb + 3 + jj - ii
  const int pb = BQ - 4 - 4 * ty + 4 * tx;
  const int n_kv = (len + BKV - 1) / BKV;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int j0 = kt * BKV;
    __syncthreads();  // the previous tile is no longer read
    for (int idx = tid; idx < BKV * D; idx += NT) {
      const int r = idx / D, d = idx % D, t = j0 + r;
      float a = 0.f, c = 0.f;
      if (t < Tn) {
        a = k[base + t * rs + d];
        c = v[base + t * rs + d];
      }
      sK[d * LDT + r] = a;
      sV[r * D + d] = c;
    }
    const int r0 = Tn - BQ - i0 + j0;
    for (int idx = tid; idx < NP * D; idx += NT) {
      const int q = idx / D, d = idx % D, r = r0 + q;
      sP[d * LDP + q] = (r >= 0 && r < 2 * Tn - 1) ? p[((long long)r * H + h) * D + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[ii][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&sQu[d * LDT + 4 * ty]);
      const float4 c = *reinterpret_cast<const float4*>(&sQv[d * LDT + 4 * ty]);
      const float4 kk = *reinterpret_cast<const float4*>(&sK[d * LDT + 4 * tx]);
      const float4 p0 = *reinterpret_cast<const float4*>(&sP[d * LDP + pb]);
      const float4 p1 = *reinterpret_cast<const float4*>(&sP[d * LDP + pb + 4]);
      const float qa[4] = {a.x, a.y, a.z, a.w};
      const float qc[4] = {c.x, c.y, c.z, c.w};
      const float kr[4] = {kk.x, kk.y, kk.z, kk.w};
      const float pr[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          s[ii][jj] = fmaf(qa[ii], kr[jj], fmaf(qc[ii], pr[3 + jj - ii], s[ii][jj]));
    }

    // online softmax; the 16 threads of a row group are 16 lanes of one warp
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      float mx = NEG;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = j0 + 4 * tx + jj;
        s[ii][jj] = (j < len) ? s[ii][jj] * scale : NEG;
        mx = fmaxf(mx, s[ii][jj]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[ii], mx);
      const float alpha = expf(m[ii] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        s[ii][jj] = expf(s[ii][jj] - m_new);
        ps += s[ii][jj];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[ii] = l[ii] * alpha + ps;
      m[ii] = m_new;
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) acc[ii][dd] *= alpha;
    }
    __syncthreads();  // every thread is done reading K^T: reuse it for probabilities
    float* sS = sK;   // [BKV][LDT], sS[j][i]
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) sS[(4 * tx + jj) * LDT + 4 * ty + ii] = s[ii][jj];
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BKV; ++j) {
      const float4 pp = *reinterpret_cast<const float4*>(&sS[j * LDT + 4 * ty]);
      const float4 vv = *reinterpret_cast<const float4*>(&sV[j * D + 4 * tx]);
      const float pa[4] = {pp.x, pp.y, pp.z, pp.w};
      const float va[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int dd = 0; dd < 4; ++dd) acc[ii][dd] = fmaf(pa[ii], va[dd], acc[ii][dd]);
    }
  }

#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int i = i0 + 4 * ty + ii;
    if (i >= Tn) continue;
    const float lv = fmaxf(l[ii], 1e-30f);
    const float inv = 1.f / lv;
#pragma unroll
    for (int dd = 0; dd < 4; ++dd) o[base + i * rs + 4 * tx + dd] = acc[ii][dd] * inv;
    if (tx == 0) lse[((long long)b * H + h) * Tn + i] = m[ii] + logf(lv);
  }
}

}  // namespace f32

// ------------------------------------------------------- bf16 tensor-core path

namespace tc {

constexpr int NT = 128;       // 4 warps x 16 query rows
constexpr int LDS = D + 8;    // bf16 stride of the K, V and p tiles (conflict-free fragments)
constexpr int NP = 128;       // p rows staged per tile pair (BQ + BKV - 1 of them are read)
constexpr int NBD = 80;       // p rows a warp reads: 16 rows x 64 keys span 79 distances
constexpr int LDB = NBD + 4;  // fp32 stride of a warp's rel-pos tile

// shared memory: K [BKV][LDS], V [BKV][LDS], p [NP][LDS] in bf16; one
// [16][LDB] fp32 rel-pos tile per warp
constexpr size_t SMEM = (2 * BKV + NP) * LDS * sizeof(__nv_bfloat16) +
                        (NT / 32) * 16 * LDB * sizeof(float);

using bf16 = __nv_bfloat16;

// rows [row0, row0 + n) of a [rows, H, 64] bf16 tensor (row stride rs) at
// head offset `hoff` into shared memory [n][LDS]; rows outside [0, rows) are 0
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* __restrict__ src, int row0,
                                           int n, int rows, long long rs, long long hoff) {
  for (int idx = threadIdx.x; idx < n * (D / 8); idx += NT) {
    const int r = idx / (D / 8), c = idx % (D / 8), t = row0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (t >= 0 && t < rows) val = *reinterpret_cast<const uint4*>(src + t * rs + hoff + 8 * c);
    *reinterpret_cast<uint4*>(dst + r * LDS + 8 * c) = val;
  }
}

__global__ void __launch_bounds__(NT, 3) kernel(
    const bf16* __restrict__ qu, const bf16* __restrict__ qv, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ p, const int* __restrict__ lengths,
    bf16* __restrict__ o, float* __restrict__ lse, int H, int Tn, float scale) {
  extern __shared__ float4 smem4[];
  bf16* sK = reinterpret_cast<bf16*>(smem4);  // [BKV][LDS]: k_j, d contiguous
  bf16* sV = sK + BKV * LDS;                  // [BKV][LDS]: v_j, d contiguous
  bf16* sP = sV + BKV * LDS;                  // [NP][LDS]: p rows r0 + q, d contiguous

  const int i0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float* sB = reinterpret_cast<float*>(sP + NP * LDS) + warp * 16 * LDB;  // [16][LDB]
  const int len = min(max(lengths[b], 0), Tn);
  const long long rs = (long long)H * D;  // stride of t
  const long long bbase = (long long)b * Tn * rs;
  const long long hoff = (long long)h * D;

  // this warp's query rows i0 + 16 warp + (g, g+8), as A fragments for the 4 k-steps
  uint32_t fu[4][4], fv[4][4];
  {
    const int ia = i0 + 16 * warp + g, ib = ia + 8;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = (e & 1) ? ib : ia;
        const int d = 16 * ks + 2 * t + 8 * (e >> 1);
        const long long off = bbase + i * rs + hoff + d;
        fu[ks][e] = (i < Tn) ? ld_bf16x2(qu + off) : 0u;
        fv[ks][e] = (i < Tn) ? ld_bf16x2(qv + off) : 0u;
      }
  }

  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, acc[8][4];
#pragma unroll
  for (int dt = 0; dt < 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  const int q_lo = BQ - 16 - 16 * warp;  // first p row (local) this warp reads
  // v's B fragments by ldmatrix.x4.trans: lane L addresses key row L % 8 + 8 (L / 8 % 2)
  // at column 8 (L / 16), giving two d-tiles of 8 (B[j][d] stored d-contiguous)
  const uint32_t sv_lane = static_cast<uint32_t>(__cvta_generic_to_shared(
      sV + ((lane & 7) + 8 * ((lane >> 3) & 1)) * LDS + 8 * (lane >> 4)));
  const int n_kv = (len + BKV - 1) / BKV;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int j0 = kt * BKV;
    __syncthreads();  // the previous tile is no longer read
    stage_rows(sK, k + bbase, j0, BKV, Tn, rs, hoff);
    stage_rows(sV, v + bbase, j0, BKV, Tn, rs, hoff);
    stage_rows(sP, p, Tn - BQ - i0 + j0, NP, 2 * Tn - 1, rs, hoff);
    __syncthreads();

    // s = qu k^T (16 x 64) and bd = qv p^T over this warp's 80 p rows
    float s[8][4], bd[10][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int nt = 0; nt < 10; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) bd[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const bf16* kr = sK + (8 * nt + g) * LDS + 16 * ks + 2 * t;
        const uint32_t bb[2] = {ld_bf16x2(kr), ld_bf16x2(kr + 8)};
        mma_bf16_16816(s[nt], fu[ks], bb);
      }
#pragma unroll
      for (int nt = 0; nt < 10; ++nt) {
        const bf16* pr = sP + (q_lo + 8 * nt + g) * LDS + 16 * ks + 2 * t;
        const uint32_t bb[2] = {ld_bf16x2(pr), ld_bf16x2(pr + 8)};
        mma_bf16_16816(bd[nt], fv[ks], bb);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 10; ++nt) {
      *reinterpret_cast<float2*>(sB + g * LDB + 8 * nt + 2 * t) =
          make_float2(bd[nt][0], bd[nt][1]);
      *reinterpret_cast<float2*>(sB + (g + 8) * LDB + 8 * nt + 2 * t) =
          make_float2(bd[nt][2], bd[nt][3]);
    }
    __syncwarp();

    // scores: row r of the warp, key jl of the tile reads its rel-pos term at
    // p row q = jl - (16 warp + r) + 63, i.e. column jl - r + 15 of sB
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = g + 8 * (e >> 1), jl = 8 * nt + 2 * t + (e & 1);
        const float val = (s[nt][e] + sB[r * LDB + jl - r + 15]) * scale;
        s[nt][e] = (j0 + jl < len) ? val : NEG;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    __syncwarp();  // sB is read; the next tile's writes come after __syncthreads

    // online softmax over the 4 lanes that share a row
    float alpha[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m[hh], mx[hh]);
      alpha[hh] = __expf(m[hh] - m_new);
      m[hh] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = __expf(s[nt][e] - m[e >> 1]);
        ps[e >> 1] += s[nt][e];
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * alpha[hh] + ps[hh];  // this lane's share
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }

    // acc += probabilities (bf16, from the score registers) x v
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        uint32_t bq[4];
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
            : "=r"(bq[0]), "=r"(bq[1]), "=r"(bq[2]), "=r"(bq[3])
            : "r"(sv_lane + 2 * (16 * kk * LDS + 16 * dp)));
        const uint32_t lo[2] = {bq[0], bq[1]}, hi[2] = {bq[2], bq[3]};
        mma_bf16_16816(acc[2 * dp], a, lo);
        mma_bf16_16816(acc[2 * dp + 1], a, hi);
      }
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float lt = l[hh];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int i = i0 + 16 * warp + g + 8 * hh;
    if (i >= Tn) continue;
    const float lv = fmaxf(lt, 1e-30f), inv = 1.f / lv;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt)
      *reinterpret_cast<uint32_t*>(o + bbase + i * rs + hoff + 8 * dt + 2 * t) =
          pack_bf16x2(acc[dt][2 * hh] * inv, acc[dt][2 * hh + 1] * inv);
    if (t == 0) lse[((long long)b * H + h) * Tn + i] = m[hh] + logf(lv);
  }
}

}  // namespace tc

template <typename T>
int launch(void (*kernel)(const T*, const T*, const T*, const T*, const T*, const int*, T*,
                          float*, int, int, float),
           size_t smem, int threads, const void* qu, const void* qv, const void* k,
           const void* v, const void* p, const int* lengths, void* o, float* lse, int B, int H,
           int Tn, float scale, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tn + BQ - 1) / BQ, H, B);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(qu), static_cast<const T*>(qv), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(p), lengths, static_cast<T*>(o), lse, H,
      Tn, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (every tensor 16-byte aligned). head_dim
// must be 64. Returns a cudaError_t.
extern "C" int relpos_flash_fwd(int dtype, const void* qu, const void* qv, const void* k,
                                const void* v, const void* p, const void* lengths, void* o,
                                void* lse, int B, int H, int Tn, int head_dim, float scale,
                                void* stream) {
  if (head_dim != D || B <= 0 || H <= 0 || Tn <= 0) return (int)cudaErrorInvalidValue;
  const int* len = static_cast<const int*>(lengths);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(f32::kernel, f32::SMEM, f32::NT, qu, qv, k, v, p, len, o, l, B, H, Tn,
                         scale, s);
  if (dtype == 1) {
    const void* tensors[] = {qu, qv, k, v, p, o};
    for (const void* ptr : tensors)
      if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return (int)cudaErrorMisalignedAddress;
    return launch<__nv_bfloat16>(tc::kernel, tc::SMEM, tc::NT, qu, qv, k, v, p, len, o, l, B, H,
                                 Tn, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
