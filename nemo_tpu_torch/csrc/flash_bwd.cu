// Causal / sliding-window GQA flash attention backward for Hopper (sm_90a),
// fp32 or bf16 inputs, head width D in {64, 128}: K6 (dq) and K7 (dk, dv
// summed over the query heads of each kv group), K9 and K10, their forms
// over packed rows with segment ids, and K12 and K13, their forms with
// explicit positions.
//
// Replace the TPU kernels nemo_tpu/ops/flash_attention.py:_dq_kernel
// (pallas_call at 326) and _dkv_kernel (pallas_call at 370) in the form that
// nemo_tpu/models/llm/gpt.py:642 differentiates. With the forward (flash_fwd.cu)
//
//   s[i,j] = scale * q_i . k_j   for unmasked (i, j) (causal, window), else -inf
//
// P = exp(s - lse), delta_i = rowsum(dO_i * O_i) (a torch reduction before
// the launch, as JAX computes it outside its kernels) and
// dS = P * (dO v^T - delta) * scale:
//
//   K6: dq_i = sum_j dS_ij k_j
//   K7: dk_j = sum_{h in g} sum_i dS_ij q_i     dv_j = sum_{h in g} sum_i P_ij dO_i
//
// Both recompute s per 64 x 64 tile pair and visit only the pairs with an
// unmasked element (_block_active); boundary tiles are masked element-wise.
//
// - K6: one block per (b, h, 64 query rows), looping over the key tiles from
//   the window's first to the diagonal; later query tiles (more work) launch
//   first.
// - K7: one block per (b, kv head g, 64 keys), looping over the H/G query
//   heads of the group (the JAX grid's `rep` axis) times the query tiles from
//   the diagonal to the window's last. Each warp owns 16 keys and works on
//   transposed scores (keys x queries); dk and dv stay in registers across
//   the whole loop, so each tile of dk and dv is written once, with no
//   atomics: K7 is deterministic.
//
// bf16 (the main path): tensor cores through mma.sync m16n8k16 with fp32
// accumulators; P and dS are rounded to bf16 before each product, as the JAX
// kernels round them to the input dtype (flash_attention.py:248,291,299).
// fp32 (the exactness check): scalar FMAs from shared-memory tiles.
//
// K9 and K10 replace nemo_tpu/ops/flash_attention.py:_dq_seg_kernel
// (pallas_call at 1044) and _dkv_seg_kernel (pallas_call at 1090), the
// backward of flash_attention_packed: the same kernels with segments on
// (flash_tiles.cuh:Pairs<SEG>). A tile pair is visited only where the [min,
// max] segment ids of its two tiles overlap; on pairs that mix segments,
// P = 0 on pairs of unequal or zero ids. The kernels set P = 0 on every
// masked pair directly, never as exp(s - lse): a padding row (lse = -1e30)
// keeps no pair, so the guard P = where(lse > -5e29, exp(s - lse), 0) of
// flash_attention.py:899,945 holds by construction, and padding rows get
// dq = 0 and padding keys dk = dv = 0 exactly. Every output tile is written,
// with zeros where nothing was visited (a key tile no query of its segment
// reaches). With one segment per row they take K6's and K7's steps and give
// their bits.
//
// K12 and K13 replace nemo_tpu/ops/flash_attention.py:_dq_pos_kernel
// (pallas_call at 679) and _dkv_pos_kernel (pallas_call at 701), the
// backward of flash_attention_positions: the same kernels with positions on
// (flash_tiles.cuh:Pairs<POS>), Tq rows against Tkv keys, tile pairs skipped
// by position range. P = 0 on every masked pair, so a row that keeps no key
// (lse = -1e30) gets dq = 0 and adds nothing to dk and dv: JAX's guard
// P = where(lse > -5e29, exp(s - lse), 0) (flash_attention.py:555,595)
// holds by construction. The lse cotangent of flash_attention_positions
// enters through delta' = rowsum(dO * O) - g_lse, formed by the wrapper
// (_flash_backward_pos, flash_attention.py:672-675).
//
// Bound on the H100: per valid (query, key) pair K6 does 3 products of 2 D
// operations (q.k, dO.v, dS.k) and K7 4 (q.k, dO.v, P.dO, dS.q), against ~5
// (K6) and ~7 (K7) x B T H D x 2 bytes of inputs and outputs, so operations
// bound both at the training shape. wgmma, TMA and pipelining come later.
//
// Layouts: q, dO, dq [B, Tq, H, D]; k, v, dk, dv [B, Tkv, G, D]; lse and
// delta [B, H, Tq] fp32; segment ids [B, T] int32 and their tile ranges
// [B, ceil(T / 64), 2] int32; positions [Tq], [Tkv] int32 and their tile
// ranges [ceil(T / 64), 2].

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "flash_tiles.cuh"

namespace {

using flash::BKV;
using flash::BQ;
using flash::Mask;
using flash::Pairs;
using flash::PLAIN;

// ---------------------------------------------------------------- fp32 path

namespace f32 {

constexpr int NT = 256;       // 16 x 16 threads
constexpr int LDT = BKV + 1;  // stride of the [64][64] score tiles

// rows [row0, row0 + n) of a [rows, heads, D] tensor (src at the head) into
// shared memory [n][D + 1]; rows outside [0, rows) are 0
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int row0, int n,
                                      int rows, long long rs) {
  constexpr int LD = D + 1;
  for (int idx = threadIdx.x; idx < n * D; idx += NT) {
    const int r = idx / D, d = idx % D, t = row0 + r;
    dst[r * LD + d] = (t >= 0 && t < rows) ? src[t * rs + d] : 0.f;
  }
}

// P and dS of the scores (il = ty + 16a, jl = tx + 16c) of the tile pair at
// (i0, j0): P into `pp` (if given) and dS into `ds`, both [BQ][LDT]; qs, ks
// the policy's values of the tile's rows and keys (unread without one)
template <int D, int M>
__device__ __forceinline__ void scores(const float* sQ, const float* sO, const float* sK,
                                       const float* sV, const float* lse, const float* del,
                                       const int* qs, const int* ks, int i0, int j0,
                                       const Mask& mask, const Pairs<M>& pr, float scale,
                                       float* pp, float* ds) {
  constexpr int LD = D + 1;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const bool edge = mask.edge(i0, j0) || !pr.uniform(i0, j0);
  for (int a = 0; a < 4; ++a) {
    const int il = ty + 16 * a;
    for (int c = 0; c < 4; ++c) {
      const int jl = tx + 16 * c;
      float s = 0.f, dp = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        s = fmaf(sQ[il * LD + d], sK[jl * LD + d], s);
        dp = fmaf(sO[il * LD + d], sV[jl * LD + d], dp);
      }
      const bool ok = !edge || (mask.allowed(i0 + il, j0 + jl) &&
                                pr.same(M != PLAIN ? qs[il] : 1, M != PLAIN ? ks[jl] : 1));
      const float P = ok ? expf(s * scale - lse[il]) : 0.f;
      if (pp) pp[il * LDT + jl] = P;
      ds[il * LDT + jl] = P * (dp - del[il]) * scale;
    }
  }
}

// K6 shared memory, floats: Q, dO [BQ][D+1]; K, V [BKV][D+1]; dS [BQ][LDT]
template <int D>
constexpr size_t smem_dq() { return (2 * BQ * (D + 1) + 2 * BKV * (D + 1) + BQ * LDT) * 4; }
// K7: K, V [BKV][D+1]; Q, dO [BQ][D+1]; dS, P [BQ][LDT]; lse, delta [BQ]
template <int D>
constexpr size_t smem_dkv() {
  return (2 * BKV * (D + 1) + 2 * BQ * (D + 1) + 2 * BQ * LDT + 2 * BQ) * 4;
}

template <int D, int M>
__global__ void __launch_bounds__(NT) dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ qv, const int* __restrict__ kv,
    const int* __restrict__ qr, const int* __restrict__ kr, float* __restrict__ dq, int H, int G,
    int Tq, int Tkv, float scale, int causal, int window) {
  constexpr int LD = D + 1, NC = D / 16;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sO = sQ + BQ * LD;
  float* sK = sO + BQ * LD;
  float* sV = sK + BKV * LD;
  float* sDS = sV + BKV * LD;
  __shared__ float sL[BQ], sDl[BQ];
  __shared__ int sQs[M != PLAIN ? BQ : 1], sKs[M != PLAIN ? BKV : 1];  // rows', keys' values

  const Mask mask = flash::mask_of<M>(Tq, Tkv, causal, window);
  const int i0 = (gridDim.x - 1 - blockIdx.x) * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long rq = (long long)H * D, rk = (long long)G * D;
  const long long qoff = (long long)b * Tq * rq + (long long)h * D;
  const long long koff = (long long)b * Tkv * rk + (long long)(h * G / H) * D;
  const long long lrow = ((long long)b * H + h) * Tq;

  const Pairs<M> pr = flash::pairs_of<M>(qv, kv, qr, kr, b, Tq, Tkv, causal, window);
  stage<D>(sQ, q + qoff, i0, BQ, Tq, rq);
  stage<D>(sO, dout + qoff, i0, BQ, Tq, rq);
  for (int idx = tid; idx < BQ; idx += NT) {
    const int i = i0 + idx;
    sL[idx] = i < Tq ? lse[lrow + i] : 0.f;
    sDl[idx] = i < Tq ? delta[lrow + i] : 0.f;
  }
  flash::stage_qids<M>(sQs, pr, i0);

  float aq[4][NC];  // rows ty + 16a, columns tx + 16c
  for (int a = 0; a < 4; ++a)
    for (int c = 0; c < NC; ++c) aq[a][c] = 0.f;

  int lo, hi;
  mask.kv_range(i0, lo, hi);
  for (int kt = lo; kt <= hi; ++kt) {
    const int j0 = kt * BKV;
    if (!pr.active(i0, j0)) continue;  // the same for the whole block
    __syncthreads();  // the previous tile is no longer read
    stage<D>(sK, k + koff, j0, BKV, Tkv, rk);
    stage<D>(sV, v + koff, j0, BKV, Tkv, rk);
    flash::stage_kids<M>(sKs, pr, j0);
    __syncthreads();
    scores<D, M>(sQ, sO, sK, sV, sL, sDl, sQs, sKs, i0, j0, mask, pr, scale, nullptr, sDS);
    __syncthreads();
    for (int a = 0; a < 4; ++a) {
      const int il = ty + 16 * a;
      for (int jl = 0; jl < BKV; ++jl) {
        const float ds = sDS[il * LDT + jl];
#pragma unroll
        for (int c = 0; c < NC; ++c) aq[a][c] = fmaf(ds, sK[jl * LD + tx + 16 * c], aq[a][c]);
      }
    }
  }
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty + 16 * a;
    if (i >= Tq) continue;
    for (int c = 0; c < NC; ++c) dq[qoff + i * rq + tx + 16 * c] = aq[a][c];
  }
}

template <int D, int M>
__global__ void __launch_bounds__(NT) dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ qv, const int* __restrict__ kv,
    const int* __restrict__ qr, const int* __restrict__ kr, float* __restrict__ dk,
    float* __restrict__ dv, int H, int G, int Tq, int Tkv, float scale, int causal,
    int window) {
  constexpr int LD = D + 1, NC = D / 16;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + BKV * LD;
  float* sQ = sV + BKV * LD;
  float* sO = sQ + BQ * LD;
  float* sDS = sO + BQ * LD;
  float* sPr = sDS + BQ * LDT;
  float* sL = sPr + BQ * LDT;
  float* sDl = sL + BQ;
  __shared__ int sQs[M != PLAIN ? BQ : 1], sKs[M != PLAIN ? BKV : 1];  // rows', keys' values

  const Mask mask = flash::mask_of<M>(Tq, Tkv, causal, window);
  const int j0 = blockIdx.x * BKV, gk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const Pairs<M> pr = flash::pairs_of<M>(qv, kv, qr, kr, b, Tq, Tkv, causal, window);
  const int rep = H / G;
  const long long rq = (long long)H * D, rk = (long long)G * D;
  const long long koff = (long long)b * Tkv * rk + (long long)gk * D;

  float ak[4][NC], avv[4][NC];  // keys ty + 16a, columns tx + 16c
  for (int a = 0; a < 4; ++a)
    for (int c = 0; c < NC; ++c) ak[a][c] = avv[a][c] = 0.f;

  stage<D>(sK, k + koff, j0, BKV, Tkv, rk);
  stage<D>(sV, v + koff, j0, BKV, Tkv, rk);
  flash::stage_kids<M>(sKs, pr, j0);
  int lo, hi;
  mask.q_range(j0, lo, hi);
  for (int r = 0; r < rep; ++r) {
    const int h = gk * rep + r;
    const long long qoff = (long long)b * Tq * rq + (long long)h * D;
    const long long lrow = ((long long)b * H + h) * Tq;
    for (int qt = lo; qt <= hi; ++qt) {
      const int i0 = qt * BQ;
      if (!pr.active(i0, j0)) continue;  // the same for the whole block
      __syncthreads();  // the previous tile is no longer read
      stage<D>(sQ, q + qoff, i0, BQ, Tq, rq);
      stage<D>(sO, dout + qoff, i0, BQ, Tq, rq);
      for (int idx = tid; idx < BQ; idx += NT) {
        const int i = i0 + idx;
        sL[idx] = i < Tq ? lse[lrow + i] : 0.f;
        sDl[idx] = i < Tq ? delta[lrow + i] : 0.f;
      }
      flash::stage_qids<M>(sQs, pr, i0);
      __syncthreads();
      scores<D, M>(sQ, sO, sK, sV, sL, sDl, sQs, sKs, i0, j0, mask, pr, scale, sPr, sDS);
      __syncthreads();
      for (int a = 0; a < 4; ++a) {
        const int jl = ty + 16 * a;
        for (int il = 0; il < BQ; ++il) {
          const float ds = sDS[il * LDT + jl], pp = sPr[il * LDT + jl];
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            ak[a][c] = fmaf(ds, sQ[il * LD + tx + 16 * c], ak[a][c]);
            avv[a][c] = fmaf(pp, sO[il * LD + tx + 16 * c], avv[a][c]);
          }
        }
      }
    }
  }
  for (int a = 0; a < 4; ++a) {
    const int j = j0 + ty + 16 * a;
    if (j >= Tkv) continue;
    for (int c = 0; c < NC; ++c) {
      dk[koff + j * rk + tx + 16 * c] = ak[a][c];
      dv[koff + j * rk + tx + 16 * c] = avv[a][c];
    }
  }
}

}  // namespace f32

// ------------------------------------------------------- bf16 tensor-core path

namespace tc {

using namespace flash::tc;

// K6: K, V [BKV][D+8] bf16
template <int D>
constexpr size_t smem_dq() { return 2 * BKV * (D + 8) * sizeof(bf16); }
// K7: K, V [BKV][D+8], Q, dO [BQ][D+8] bf16; lse, delta [BQ] fp32
template <int D>
constexpr size_t smem_dkv() { return 4 * BQ * (D + 8) * sizeof(bf16) + 2 * BQ * sizeof(float); }

template <int D, int M>
__global__ void __launch_bounds__(NT, 2) dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ qv, const int* __restrict__ kv,
    const int* __restrict__ qr, const int* __restrict__ kr, bf16* __restrict__ dq, int H, int G,
    int Tq, int Tkv, float scale, int causal, int window) {
  constexpr int LDS = D + 8, KS = D / 16, NDT = D / 8;
  extern __shared__ float4 smem4[];
  bf16* sK = reinterpret_cast<bf16*>(smem4);  // [BKV][LDS]: k_j
  bf16* sV = sK + BKV * LDS;                  // [BKV][LDS]: v_j
  __shared__ int sKs[M != PLAIN ? BKV : 1];   // the key tile's ids or positions

  const Mask mask = flash::mask_of<M>(Tq, Tkv, causal, window);
  const int i0 = (gridDim.x - 1 - blockIdx.x) * BQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long rq = (long long)H * D, rk = (long long)G * D;
  const long long qoff = (long long)b * Tq * rq + (long long)h * D;
  const long long koff = (long long)b * Tkv * rk + (long long)(h * G / H) * D;
  const long long lrow = ((long long)b * H + h) * Tq;

  // this warp's query rows ia, ib as A fragments of q and dO
  const int ia = i0 + 16 * warp + g, ib = ia + 8;
  uint32_t fq[KS][4], fo[KS][4];
  load_rows_a<KS>(fq, q + qoff, ia, ib, Tq, rq, t);
  load_rows_a<KS>(fo, dout + qoff, ia, ib, Tq, rq, t);
  const float lse_r[2] = {ia < Tq ? lse[lrow + ia] : 0.f, ib < Tq ? lse[lrow + ib] : 0.f};
  const float del_r[2] = {ia < Tq ? delta[lrow + ia] : 0.f, ib < Tq ? delta[lrow + ib] : 0.f};
  const Pairs<M> pr = flash::pairs_of<M>(qv, kv, qr, kr, b, Tq, Tkv, causal, window);
  const int qs[2] = {pr.qid(ia), pr.qid(ib)};

  float aq[NDT][4];
  zero<NDT>(aq);
  int lo, hi;
  mask.kv_range(i0, lo, hi);
  for (int kt = lo; kt <= hi; ++kt) {
    const int j0 = kt * BKV;
    if (!pr.active(i0, j0)) continue;  // the same for the whole block
    __syncthreads();  // the previous tile is no longer read
    stage_rows<D>(sK, k + koff, j0, BKV, Tkv, rk);
    stage_rows<D>(sV, v + koff, j0, BKV, Tkv, rk);
    flash::stage_kids<M>(sKs, pr, j0);
    __syncthreads();

    // P = exp(s scale - lse), 0 where masked
    float s[8][4];
    zero<8>(s);
    mma_nt<8, KS, LDS>(s, fq, sK, g, t);
    const bool edge = mask.edge(i0, j0) || !pr.uniform(i0, j0);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = g + 8 * (e >> 1), jl = 8 * nt + 2 * t + (e & 1);
        const bool ok = !edge || (mask.allowed(i0 + 16 * warp + r, j0 + jl) &&
                                  pr.same(qs[e >> 1], M != PLAIN ? sKs[jl] : 1));
        s[nt][e] = ok ? __expf(s[nt][e] * scale - lse_r[e >> 1]) : 0.f;
      }

    // dS = P (dO v^T - delta) scale
    {
      float dpr[8][4];
      zero<8>(dpr);
      mma_nt<8, KS, LDS>(dpr, fo, sV, g, t);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = s[nt][e] * (dpr[nt][e] - del_r[e >> 1]) * scale;
    }
    uint32_t a[4][4];
    pack_a(a, s);
    mma_nn<4, NDT, LDS>(aq, a, sK, lane);  // dq += dS k
  }
  const float one[2] = {1.f, 1.f};
  store_rows<NDT>(dq + qoff, aq, ia, ib, Tq, rq, t, one);
}

template <int D, int M>
__global__ void __launch_bounds__(NT, 2) dkv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ qv, const int* __restrict__ kv,
    const int* __restrict__ qr, const int* __restrict__ kr, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int H, int G, int Tq, int Tkv, float scale, int causal,
    int window) {
  constexpr int LDS = D + 8, KS = D / 16, NDT = D / 8;
  extern __shared__ float4 smem4[];
  bf16* sK = reinterpret_cast<bf16*>(smem4);  // [BKV][LDS]: k_j
  bf16* sV = sK + BKV * LDS;                  // [BKV][LDS]: v_j
  bf16* sQ = sV + BKV * LDS;                  // [BQ][LDS]: q_i of the current head
  bf16* sO = sQ + BQ * LDS;                   // [BQ][LDS]: dO_i
  float* sL = reinterpret_cast<float*>(sO + BQ * LDS);  // [BQ] lse
  float* sDl = sL + BQ;                                 // [BQ] delta
  __shared__ int sQs[M != PLAIN ? BQ : 1], sKs[M != PLAIN ? BKV : 1];  // rows', keys' values

  const Mask mask = flash::mask_of<M>(Tq, Tkv, causal, window);
  const int j0 = blockIdx.x * BKV, gk = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rep = H / G;
  const long long rq = (long long)H * D, rk = (long long)G * D;
  const long long koff = (long long)b * Tkv * rk + (long long)gk * D;

  // this warp's keys ja, jb (local 16 warp + g, + 8); their k and v rows are
  // the A operands of the transposed products, read from shared memory
  const int ja = j0 + 16 * warp + g, jb = ja + 8;
  const bf16* sKw = sK + 16 * warp * LDS;
  const bf16* sVw = sV + 16 * warp * LDS;
  float ak[NDT][4], avv[NDT][4];
  zero<NDT>(ak);
  zero<NDT>(avv);

  const Pairs<M> pr = flash::pairs_of<M>(qv, kv, qr, kr, b, Tq, Tkv, causal, window);
  stage_rows<D>(sK, k + koff, j0, BKV, Tkv, rk);
  stage_rows<D>(sV, v + koff, j0, BKV, Tkv, rk);
  flash::stage_kids<M>(sKs, pr, j0);
  int lo, hi;
  mask.q_range(j0, lo, hi);
  for (int r = 0; r < rep; ++r) {
    const int h = gk * rep + r;
    const long long qoff = (long long)b * Tq * rq + (long long)h * D;
    const long long lrow = ((long long)b * H + h) * Tq;
    for (int qt = lo; qt <= hi; ++qt) {
      const int i0 = qt * BQ;
      if (!pr.active(i0, j0)) continue;  // the same for the whole block
      __syncthreads();  // the previous tile is no longer read
      stage_rows<D>(sQ, q + qoff, i0, BQ, Tq, rq);
      stage_rows<D>(sO, dout + qoff, i0, BQ, Tq, rq);
      for (int idx = threadIdx.x; idx < BQ; idx += NT) {
        const int i = i0 + idx;
        sL[idx] = i < Tq ? lse[lrow + i] : 0.f;
        sDl[idx] = i < Tq ? delta[lrow + i] : 0.f;
      }
      flash::stage_qids<M>(sQs, pr, i0);
      __syncthreads();

      // transposed scores: key row jl = 16 warp + (g, g + 8) x query il
      float s[8][4];
      zero<8>(s);
      mma_nt_s<8, KS, LDS>(s, sKw, sQ, g, t);
      const bool edge = mask.edge(i0, j0) || !pr.uniform(i0, j0);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jl = 16 * warp + g + 8 * (e >> 1), il = 8 * nt + 2 * t + (e & 1);
          const bool ok = !edge || (mask.allowed(i0 + il, j0 + jl) &&
                                    pr.same(M != PLAIN ? sQs[il] : 1, M != PLAIN ? sKs[jl] : 1));
          s[nt][e] = ok ? __expf(s[nt][e] * scale - sL[il]) : 0.f;
        }
      uint32_t a[4][4];
      pack_a(a, s);
      mma_nn<4, NDT, LDS>(avv, a, sO, lane);  // dv += P^T dO
      {
        float dpt[8][4];
        zero<8>(dpt);
        mma_nt_s<8, KS, LDS>(dpt, sVw, sO, g, t);  // (dO v^T)^T
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int il = 8 * nt + 2 * t + (e & 1);
            s[nt][e] = s[nt][e] * (dpt[nt][e] - sDl[il]) * scale;
          }
      }
      pack_a(a, s);
      mma_nn<4, NDT, LDS>(ak, a, sQ, lane);  // dk += dS^T q
    }
  }
  const float one[2] = {1.f, 1.f};
  store_rows<NDT>(dk + koff, ak, ja, jb, Tkv, rk, t, one);
  store_rows<NDT>(dv + koff, avv, ja, jb, Tkv, rk, t, one);
}

}  // namespace tc

template <int D, int M>
int dq(int dtype, void** args, int n_q, int H, int B, cudaStream_t s) {
  if (dtype == 0)
    return flash::launch(f32::dq_kernel<D, M>, f32::smem_dq<D>(), f32::NT, n_q, H, B, s, args);
  return flash::launch(tc::dq_kernel<D, M>, tc::smem_dq<D>(), tc::NT, n_q, H, B, s, args);
}

template <int D, int M>
int dkv(int dtype, void** args, int n_kv, int G, int B, cudaStream_t s) {
  if (dtype == 0)
    return flash::launch(f32::dkv_kernel<D, M>, f32::smem_dkv<D>(), f32::NT, n_kv, G, B, s,
                         args);
  return flash::launch(tc::dkv_kernel<D, M>, tc::smem_dkv<D>(), tc::NT, n_kv, G, B, s, args);
}

template <int M>
int dq_entry(int dtype, void* q, void* k, void* v, void* dout, void* lse, void* delta, void* qv,
             void* kv, void* qr, void* kr, void* dq_out, int B, int H, int G, int Tq, int Tkv,
             int head_dim, float scale, int causal, int window, void* stream) {
  if (!flash::valid_shape(B, H, G, Tq, Tkv, head_dim, window) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    const void* bf[] = {q, k, v, dout, dq_out};
    if (!flash::aligned16(bf, 5)) return (int)cudaErrorMisalignedAddress;
  }
  void* args[] = {&q,      &k, &v, &dout, &lse, &delta, &qv,     &kv,    &qr, &kr,
                  &dq_out, &H, &G, &Tq,   &Tkv, &scale, &causal, &window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_q = (Tq + BQ - 1) / BQ;
  return head_dim == 64 ? dq<64, M>(dtype, args, n_q, H, B, s)
                        : dq<128, M>(dtype, args, n_q, H, B, s);
}

template <int M>
int dkv_entry(int dtype, void* q, void* k, void* v, void* dout, void* lse, void* delta, void* qv,
              void* kv, void* qr, void* kr, void* dk, void* dv, int B, int H, int G, int Tq,
              int Tkv, int head_dim, float scale, int causal, int window, void* stream) {
  if (!flash::valid_shape(B, H, G, Tq, Tkv, head_dim, window) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    const void* bf[] = {q, k, v, dout, dk, dv};
    if (!flash::aligned16(bf, 6)) return (int)cudaErrorMisalignedAddress;
  }
  void* args[] = {&q,  &k,  &v, &dout, &lse, &delta, &qv,    &kv,     &qr,    &kr,
                  &dk, &dv, &H, &G,    &Tq,  &Tkv,   &scale, &causal, &window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_kv = (Tkv + BKV - 1) / BKV;
  return head_dim == 64 ? dkv<64, M>(dtype, args, n_kv, G, B, s)
                        : dkv<128, M>(dtype, args, n_kv, G, B, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (every tensor 16-byte aligned). head_dim
// 64 or 128; causal 0/1; window 0 = none. Each returns a cudaError_t.

// K6: dq [B, T, H, D] in the input dtype.
extern "C" int flash_bwd_dq(int dtype, void* q, void* k, void* v, void* dout, void* lse,
                            void* delta, void* dq_out, int B, int H, int G, int Tn, int head_dim,
                            float scale, int causal, int window, void* stream) {
  return dq_entry<PLAIN>(dtype, q, k, v, dout, lse, delta, nullptr, nullptr, nullptr, nullptr,
                         dq_out, B, H, G, Tn, Tn, head_dim, scale, causal, window, stream);
}

// K7: dk, dv [B, T, G, D] in the input dtype.
extern "C" int flash_bwd_dkv(int dtype, void* q, void* k, void* v, void* dout, void* lse,
                             void* delta, void* dk, void* dv, int B, int H, int G, int Tn,
                             int head_dim, float scale, int causal, int window, void* stream) {
  return dkv_entry<PLAIN>(dtype, q, k, v, dout, lse, delta, nullptr, nullptr, nullptr, nullptr,
                          dk, dv, B, H, G, Tn, Tn, head_dim, scale, causal, window, stream);
}

// K9 and K10: K6 and K7 over packed rows. seg [B, T] int32 segment ids (0 =
// padding) and seg_range [B, ceil(T / 64), 2] int32, the [min, max] id of
// each 64-row tile; lse as K8 writes it (-1e30 on padding rows).
extern "C" int flash_seg_bwd_dq(int dtype, void* q, void* k, void* v, void* dout, void* lse,
                                void* delta, void* seg, void* seg_range, void* dq_out, int B,
                                int H, int G, int Tn, int head_dim, float scale, int causal,
                                int window, void* stream) {
  if (seg == nullptr || seg_range == nullptr) return (int)cudaErrorInvalidValue;
  return dq_entry<flash::SEG>(dtype, q, k, v, dout, lse, delta, seg, seg, seg_range, seg_range,
                              dq_out, B, H, G, Tn, Tn, head_dim, scale, causal, window, stream);
}

extern "C" int flash_seg_bwd_dkv(int dtype, void* q, void* k, void* v, void* dout, void* lse,
                                 void* delta, void* seg, void* seg_range, void* dk, void* dv,
                                 int B, int H, int G, int Tn, int head_dim, float scale,
                                 int causal, int window, void* stream) {
  if (seg == nullptr || seg_range == nullptr) return (int)cudaErrorInvalidValue;
  return dkv_entry<flash::SEG>(dtype, q, k, v, dout, lse, delta, seg, seg, seg_range, seg_range,
                               dk, dv, B, H, G, Tn, Tn, head_dim, scale, causal, window, stream);
}

// K12 and K13: K6 and K7 with explicit positions. q, dO [B, Tq, H, D], k, v
// [B, Tkv, G, D] with Tq and Tkv multiples of 64; qpos [Tq], kpos [Tkv] int32
// and their tile ranges [Tq / 64, 2], [Tkv / 64, 2]; lse as K11 writes it
// and delta = rowsum(dO * O) - g_lse, [B, H, Tq] fp32. dq [B, Tq, H, D];
// dk, dv [B, Tkv, G, D].
extern "C" int flash_pos_bwd_dq(int dtype, void* q, void* k, void* v, void* dout, void* lse,
                                void* delta, void* qpos, void* kpos, void* qrange, void* krange,
                                void* dq_out, int B, int H, int G, int Tq, int Tkv, int head_dim,
                                float scale, int causal, int window, void* stream) {
  if (!qpos || !kpos || !qrange || !krange || Tq % BQ || Tkv % BKV)
    return (int)cudaErrorInvalidValue;
  return dq_entry<flash::POS>(dtype, q, k, v, dout, lse, delta, qpos, kpos, qrange, krange,
                              dq_out, B, H, G, Tq, Tkv, head_dim, scale, causal, window, stream);
}

extern "C" int flash_pos_bwd_dkv(int dtype, void* q, void* k, void* v, void* dout, void* lse,
                                 void* delta, void* qpos, void* kpos, void* qrange,
                                 void* krange, void* dk, void* dv, int B, int H, int G, int Tq,
                                 int Tkv, int head_dim, float scale, int causal, int window,
                                 void* stream) {
  if (!qpos || !kpos || !qrange || !krange || Tq % BQ || Tkv % BKV)
    return (int)cudaErrorInvalidValue;
  return dkv_entry<flash::POS>(dtype, q, k, v, dout, lse, delta, qpos, kpos, qrange, krange, dk,
                               dv, B, H, G, Tq, Tkv, head_dim, scale, causal, window, stream);
}
