// Causal / sliding-window GQA flash attention backward for Hopper (sm_90a),
// fp32 or bf16 inputs, head width D in {64, 96, 128}: K6 (dq) and K7 (dk, dv
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
// Both recompute s per tile pair and visit only the pairs with an unmasked
// element (_block_active); boundary tiles are masked element-wise. They are
// two kernels with no atomics, as the JAX package has them: a fused kernel
// that adds dq by fp32 atomics would not be deterministic.
//
// bf16 (the main path; csrc/hopper.cuh, TMA and wgmma, no mma.sync): a block
// of 384 threads, a producer warpgroup that hands its registers to two
// consumer warpgroups (setmaxnreg 56 / 224) and works in one warp, which
// decides the tiles 32 at a time by ballot and loads them by TMA into a
// ring of shared-memory stages in the 128-byte swizzle, each completed on an
// mbarrier, with the tile's index and per-warpgroup mask flags beside it.
// - K6: a block owns 128 query rows of one (b, h), a consumer 64 of them; q
//   and dO are loaded once an item (double-buffered), k and v of each key
//   tile (128 keys at D = 64, 64 at D = 96 and 128) into 3 stages. Products: s = q
//   k^T and dP = dO v^T from shared memory (K-major), dq += dS k with dS as
//   register A fragments and k MN-major (the transposed-B bit).
// - K7: a block owns 128 keys of one (b, kv head g), a consumer 64 of them;
//   k and v are loaded once an item, q and dO of each (query head of the
//   group, 64-row query tile) pair into 4 stages, with the rows' lse and
//   delta (plain loads by the producer warp: their rows need not be 16-byte
//   aligned for a bulk copy). Transposed scores, keys by queries: s^T = k
//   q^T and dP^T = v dO^T (k, v as A, q, dO as B, K-major), dv += P^T dO
//   and dk += dS^T q (register A fragments, q and dO MN-major). dk and dv
//   stay in fp32 registers over all the group's heads and are written once:
//   K7 is deterministic. 64-row query tiles: at D = 128, 128 would spill.
// K6, K9 and K7 take a persistent grid (a block a multiprocessor, items in
// a snake order); K12, K10 and K13 one block an item (their items' work
// varies with the positions or segments). A warpgroup issues K6's products
// one after another (the two warpgroups overlap each other), and K7's dk
// product of a tile after the next tile's s^T and dP^T (one tile behind:
// 2-3 % faster at D = 64 on the H100; it spills at D = 128, 0.53 ms there
// where the plain order took 0.44, not the main path; K6 measured 5 %
// slower so). Edge tiles are masked from each row's kept key range
// (Mask::row_keys, Pairs::kept) in K6 and each key's kept row range
// (Mask::key_rows, Pairs::kept_by) in K7, in a branch of their own. P and dS
// are rounded to bf16 before their products, as the JAX kernels round them
// to the input dtype (flash_attention.py:248,291,299); dS takes P in fp32.
// D = 96 (Phi-3-mini) takes D = 128's tiles and layouts
// (flash_tiles.cuh:padded): every tile comes as two boxes of 64 columns, the
// second zero past column 96; the products over D (s, dP; s^T, dP^T) take
// their 6 nonzero steps of 16 columns, and those into D (dq, dk, dv) are
// m64n96k16 products (hopper.cuh:wgmma_rs_n96) into 96 columns of
// accumulators.
// fp32 (the exactness check): scalar FMAs from shared-memory tiles, 64 x 64.
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
// bound both at the training shape (B=8, H=32, G=8, T=2048, D=64: 0.21 and
// 0.28 ms at the bf16 peak).
//
// Layouts: q, dO, dq [B, Tq, H, D]; k, v, dk, dv [B, Tkv, G, D]; lse and
// delta [B, H, Tq] fp32; segment ids [B, T] int32 and their tile ranges
// [B, ceil(T / 64), 2] int32; positions [Tq], [Tkv] int32 and their tile
// ranges [ceil(T / 64), 2].

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "flash_tiles.cuh"
#include "hopper.cuh"

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

// ------------------------------------------------ bf16 path: TMA and wgmma

namespace wg {

using bf16 = __nv_bfloat16;
using flash::tc::ex2;
using flash::tc::pack_p;
using hopper::ATOM;
using hopper::product_rs;
using hopper::product_ss;

constexpr int WGS = 2;               // consumer warpgroups, 64 rows or keys each
constexpr int NT = 128 * (WGS + 1);  // and a producer warpgroup, one warp of it at work
constexpr int PRODUCER_REGS = 56;    // registers a thread, after the split (setmaxnreg):
constexpr int CONSUMER_REGS = 224;   // 128 x 56 + 256 x 224 <= 384 x 168 at launch
constexpr float LOG2E = 1.4426950408889634f;
constexpr uint32_t BOX64 = 64 * hopper::BOX_ROW_BYTES;  // a box of 64 rows

// this warp is done with what `bar` guards
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) hopper::mbar_arrive(bar);
}

// P = 2^(s scale2 - lse2) of a score tile in registers (rows 0, 1 as e / 2,
// column 8 nt + 2 t + e % 2 of the tile), lse2 = lse log2(e) of the pair's
// query (lse2(hh, c), c = 8 nt + e % 2). Where `edge`, P = 0 directly (never
// an exponential) on masked pairs: where the column is outside its row's
// kept range (klo, khi: offsets from the tile's column 2 t) or, under a
// policy, the column's value (cid, from column 2 t) is outside the row's
// kept values [vlo, vhi]. Both branches take the same arithmetic, so a kept
// pair gets the same bits in either.
template <int NC, int M, typename Lse>
__device__ __forceinline__ void probs(float (&sc)[NC / 8][4], bool edge, const int (&klo)[2],
                                      const int (&khi)[2], const int* cid, const int (&vlo)[2],
                                      const int (&vhi)[2], float scale2, Lse lse2) {
  if (__builtin_expect(edge, 0)) {
#pragma unroll
    for (int nt = 0; nt < NC / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * nt + (e & 1), hh = e >> 1;
        bool keep = c >= klo[hh] && c <= khi[hh];
        if constexpr (M != PLAIN) keep = keep && cid[c] >= vlo[hh] && cid[c] <= vhi[hh];
        sc[nt][e] = keep ? ex2(fmaf(sc[nt][e], scale2, -lse2(hh, c))) : 0.f;
      }
  } else {
#pragma unroll
    for (int nt = 0; nt < NC / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[nt][e] = ex2(fmaf(sc[nt][e], scale2, -lse2(e >> 1, 8 * nt + (e & 1))));
  }
}

// dS = P (dP - delta) scale in dp's registers, then as bf16 A fragments
// (delta(hh, c) as lse2 above)
template <int NC, typename Del>
__device__ __forceinline__ void dscores(uint32_t (&a)[NC / 16][4], float (&dp)[NC / 8][4],
                                        const float (&p)[NC / 8][4], float scale, Del del) {
#pragma unroll
  for (int nt = 0; nt < NC / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dp[nt][e] = p[nt][e] * (dp[nt][e] - del(e >> 1, 8 * nt + (e & 1))) * scale;
  pack_p<NC>(a, dp);
}

// ---- K6, K9, K12: dq. A block of 384 threads: a producer warpgroup and two
// consumer warpgroups of 64 query rows, as the forward (flash_fwd.cu:
// fwd_kernel): the producer's first warp walks the key tiles 32 at a time,
// loads q and dO once an item (double-buffered) and k and v of each visited
// tile by TMA into a ring of stages; a consumer computes s = q k^T and dP =
// dO v^T from shared memory, P and dS in registers, and dq += dS k with dS
// as register A fragments and k MN-major, dq held in fp32 registers for the
// item and written once.

constexpr int TQ = 64 * WGS;  // query rows a block

// Shared memory, in bytes from a 1024-aligned base: two buffers of q and dO
// (a box of 64 rows x 64 columns per warpgroup and 64 columns of D: q's
// boxes, then dO's), so that the next work item's rows load while this
// one's are read; STAGES stages of k and v (DP / 64 boxes of TK keys each);
// the mbarriers (q loaded[2], q free[2], full[STAGES], empty[STAGES]); the
// keys' ids or positions of each stage; and each stage's tile: its index
// (-1: the item has no more tiles) and which warpgroups need the element
// mask there (bit w).
template <int D>
struct DqLayout {
  static constexpr int DP = flash::padded(D);     // columns of a row in shared memory
  static constexpr int TK = DP == 64 ? 128 : 64;  // keys a tile, as the registers allow
  static constexpr int NB = DP / 64;              // boxes a row
  static constexpr int STAGES = 3;
  static constexpr uint32_t KBOX = TK * hopper::BOX_ROW_BYTES;
  static constexpr uint32_t QBUF = 2 * WGS * NB * BOX64;
  static constexpr uint32_t KV = 2 * QBUF;
  static constexpr uint32_t STAGE = 2 * NB * KBOX;  // k boxes, then v boxes
  static constexpr uint32_t BARS = KV + STAGES * STAGE;
  static constexpr uint32_t IDS = BARS + 8 * (4 + 2 * STAGES);
  static constexpr uint32_t INFO = IDS + STAGES * TK * 4;
  static constexpr uint32_t BYTES = INFO + STAGES * 8 + ATOM;  // + the alignment slack
};

template <int D, int M>
__global__ void __launch_bounds__(NT, 1) dq_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const float* __restrict__ lse, const float* __restrict__ delta, const int* __restrict__ qv,
    const int* __restrict__ kv, const int* __restrict__ qr, const int* __restrict__ kr,
    bf16* __restrict__ dq, int B, int H, int G, int Tq, int Tkv, float scale, int causal,
    int window) {
  using L = DqLayout<D>;
  constexpr int TK = L::TK, NB = L::NB, STAGES = L::STAGES;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = (raw + ATOM - 1) & ~(ATOM - 1);
  int* ids = reinterpret_cast<int*>(smem_raw + (base - raw) + L::IDS);
  int2* info = reinterpret_cast<int2*>(smem_raw + (base - raw) + L::INFO);
  auto q_loaded = [&](int qb) { return base + L::BARS + 8 * qb; };
  auto q_free = [&](int qb) { return base + L::BARS + 8 * (2 + qb); };
  auto full = [&](int s) { return base + L::BARS + 8 * (4 + s); };
  auto empty = [&](int s) { return base + L::BARS + 8 * (4 + STAGES + s); };

  // work item it: 128 query rows from i0 of head h, batch row b, the last
  // query tiles (the most key tiles) first over every (b, h); a persistent
  // grid takes them in a snake (one block an item under positions)
  const int n_q = (Tq + TQ - 1) / TQ, n_items = n_q * H * B;
  auto item_of = [&](int it, int& i0, int& h, int& b) {
    const int rem = it % (H * B);
    i0 = (n_q - 1 - it / (H * B)) * TQ;
    h = rem % H;
    b = rem / H;
  };
  const Mask mask = flash::mask_of<M>(Tq, Tkv, causal, window);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int qb = 0; qb < 2; ++qb) {
      hopper::mbar_init(q_loaded(qb), 1);
      hopper::mbar_init(q_free(qb), 4 * WGS);  // every consumer warp
    }
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full(s), 1 + (M != PLAIN ? 32 : 0));  // the TMA bytes (and the ids)
      hopper::mbar_init(empty(s), 4 * WGS);                   // every consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp < 4) {
    // the producer: the forward's walk (flash_fwd.cu), q and dO for q
    hopper::reg_dealloc<PRODUCER_REGS>();
    if (warp != 0) return;
    int n = 0, k = 0;  // stages filled, items taken
    for (int r = 0; r * (int)gridDim.x < n_items; ++r) {
      const int it = flash::tc::snake_item(r);
      if (it >= n_items) continue;
      int i0, h, b;
      item_of(it, i0, h, b);
      const int hk = h * G / H, qb = k & 1;
      const Pairs<M> pr = flash::pairs_of<M>(qv, kv, qr, kr, b, Tq, Tkv, causal, window);
      auto meets = [&](int r0, int kt) {
        if (r0 >= Tq) return false;
        int lo, hi;
        mask.kv_range<64, TK>(r0, lo, hi);
        return kt >= lo && kt <= hi && pr.template active<TK>(r0, kt * TK);
      };
      if (lane == 0) {  // q and dO into buffer qb, once the item before last is done with it
        if (k >= 2) hopper::mbar_wait(q_free(qb), ((k >> 1) - 1) & 1);
        hopper::mbar_arrive_tx(q_loaded(qb), L::QBUF);
        const uint32_t at = base + qb * L::QBUF;
        for (int w = 0; w < WGS; ++w)
          for (int c = 0; c < NB; ++c) {
            hopper::tma_load_4d(at + (w * NB + c) * BOX64, &tq, q_loaded(qb), 64 * c, h,
                                i0 + 64 * w, b);
            hopper::tma_load_4d(at + ((WGS + w) * NB + c) * BOX64, &tdo, q_loaded(qb), 64 * c,
                                h, i0 + 64 * w, b);
          }
      }
      // the next stage: tile kt (-1: the end of the item) and its mask flags
      auto fill = [&](int kt, int edges) {
        const int s = n % STAGES, use = n / STAGES;
        ++n;
        if (use > 0) hopper::mbar_wait(empty(s), (use - 1) & 1);  // the stage is read out
        if constexpr (M != PLAIN) {  // only a tile that a warpgroup masks reads them
          if (edges)
            for (int idx = lane; idx < TK; idx += 32) ids[s * TK + idx] = pr.kid(kt * TK + idx);
        }
        if (lane == 0) {
          info[s] = make_int2(kt, edges);
          if (kt < 0) {
            hopper::mbar_arrive(full(s));
          } else {
            const uint32_t st = base + L::KV + s * L::STAGE;
            hopper::mbar_arrive_tx(full(s), L::STAGE);
            for (int c = 0; c < NB; ++c) {
              hopper::tma_load_4d(st + c * L::KBOX, &tk, full(s), 64 * c, hk, kt * TK, b);
              hopper::tma_load_4d(st + (NB + c) * L::KBOX, &tv, full(s), 64 * c, hk, kt * TK,
                                  b);
            }
          }
        }
        if constexpr (M != PLAIN) hopper::mbar_arrive(full(s));
      };
      int lo, hi;
      mask.kv_range<TQ, TK>(i0, lo, hi);
      for (int kt0 = lo; kt0 <= hi; kt0 += 32) {
        const int kt = kt0 + lane;
        bool any = false;
        int edges = 0;
        if (kt <= hi) {
#pragma unroll
          for (int w = 0; w < WGS; ++w) {
            const int r0 = i0 + 64 * w;
            any = any || meets(r0, kt);
            if (mask.edge<64, TK>(r0, kt * TK) || !pr.template uniform<TK>(r0, kt * TK))
              edges |= 1 << w;
          }
        }
        for (unsigned vis = __ballot_sync(0xffffffffu, any); vis; vis &= vis - 1) {
          const int l = __ffs(vis) - 1;
          fill(kt0 + l, __shfl_sync(0xffffffffu, edges, l));
        }
      }
      fill(-1, 0);
      ++k;
    }
    return;
  }

  // consumer warpgroup w: query rows r0 .. r0 + 63 of each item; this
  // thread's rows ia, ib
  hopper::reg_alloc<CONSUMER_REGS>();
  const int w = (warp >> 2) - 1, g = lane >> 2, t = lane & 3;
  const float scale2 = scale * LOG2E;  // P = 2^(s scale2 - lse log2(e))
  const long long rq = (long long)H * D;
  int n = 0, k = 0;  // stages consumed, items taken
  for (int r = 0; r * (int)gridDim.x < n_items; ++r) {
    const int it = flash::tc::snake_item(r);
    if (it >= n_items) continue;
    int i0, h, b;
    item_of(it, i0, h, b);
    const Pairs<M> pr = flash::pairs_of<M>(qv, kv, qr, kr, b, Tq, Tkv, causal, window);
    const int r0 = i0 + 64 * w, ia = r0 + 16 * (warp & 3) + g, ib = ia + 8, qb = k & 1;
    int rlo[2], rhi[2], vlo[2], vhi[2];  // the keys and key values that rows ia, ib keep
    mask.row_keys(ia, rlo[0], rhi[0]);
    mask.row_keys(ib, rlo[1], rhi[1]);
    pr.kept(pr.qid(ia), vlo[0], vhi[0]);
    pr.kept(pr.qid(ib), vlo[1], vhi[1]);
    const long long lrow = ((long long)b * H + h) * Tq;
    float l2[2], dl[2];  // lse log2(e) and delta of rows ia, ib
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = hh ? ib : ia;
      l2[hh] = i < Tq ? lse[lrow + i] * LOG2E : 0.f;
      dl[hh] = i < Tq ? delta[lrow + i] : 0.f;
    }
    const uint32_t q_at = base + qb * L::QBUF + w * NB * BOX64;
    const uint32_t do_at = q_at + WGS * NB * BOX64;
    float acc[D / 8][4], sc[TK / 8][4], dp[TK / 8][4];
    uint32_t pa[TK / 16][4];  // dS as A fragments
    flash::tc::zero<D / 8>(acc);

    hopper::mbar_wait(q_loaded(qb), (k >> 1) & 1);
    int s;
    for (;;) {
      s = n % STAGES;
      hopper::mbar_wait(full(s), (n / STAGES) & 1);
      const int2 in = info[s];
      if (in.x < 0) break;
      const bool edge = (in.y >> w) & 1;
      int klo[2], khi[2];  // rows ia, ib's kept keys as offsets from the tile's key 2 t
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        klo[hh] = rlo[hh] - in.x * TK - 2 * t;
        khi[hh] = rhi[hh] - in.x * TK - 2 * t;
      }
      const uint32_t k_at = base + L::KV + s * L::STAGE, v_at = k_at + NB * L::KBOX;
      hopper::wgmma_fence();
      product_ss<TK, D>(sc, q_at, k_at);   // s = q k^T
      product_ss<TK, D>(dp, do_at, v_at);  // dP = dO v^T
      hopper::wgmma_wait<1>();
      hopper::fence_regs(sc);
      probs<TK, M>(sc, edge, klo, khi, ids + s * TK + 2 * t, vlo, vhi, scale2,
                   [&](int hh, int) { return l2[hh]; });
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dp);
      dscores<TK>(pa, dp, sc, scale, [&](int hh, int) { return dl[hh]; });
      hopper::wgmma_fence();
      product_rs<D, TK>(acc, pa, k_at);  // dq += dS k, k MN-major
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      hopper::fence_regs(pa);
      release(empty(s), lane);
      ++n;
    }
    release(q_free(qb), lane);  // every product of the item that reads q and dO is done
    release(empty(s), lane);    // the stage that ended the item
    ++n;
    const float one[2] = {1.f, 1.f};
    flash::tc::store_rows<D / 8>(dq + (long long)b * Tq * rq + (long long)h * D, acc, ia, ib, Tq,
                                 rq, t, one);
    ++k;
  }
}

// ---- K7, K10, K13: dk and dv. A block of 384 threads owns 128 keys of one
// kv head g (two consumer warpgroups of 64 keys) and walks the pairs (query
// head of the group, 64-row query tile) that may keep a pair with them: the
// producer's first warp decides them 32 tiles at a time by ballot, as the
// dq producer walks key tiles, and loads each visited tile's q and dO by TMA
// into a ring of stages, with its rows' lse log2(e) and delta (plain loads
// by the warp's lanes: lse and delta rows need not be 16-byte aligned for a
// bulk copy) and, where a warpgroup masks the tile under a policy, its rows'
// ids or positions. k and v of the block are loaded once an item (double-
// buffered at D = 64, for the persistent grid of K7). A consumer works on transposed scores, keys by
// queries: s^T = k q^T and dP^T = v dO^T with k, v as A and q, dO as B from
// shared memory (K-major), P^T and dS^T in registers, then dv += P^T dO and
// dk += dS^T q with the scores as register A fragments and q, dO MN-major.
// dk and dv stay in fp32 registers over all the group's heads and are
// written once: no atomics, K7 is deterministic.

constexpr int TKB = 64 * WGS;  // keys a block
constexpr int TQT = 64;        // query rows a tile (128 would spill dk and dv at D = 128)

// Shared memory, in bytes from a 1024-aligned base: KVB buffers of k and v
// (a box of 64 keys x 64 columns per warpgroup and 64 columns of DP: k's
// boxes, then v's); STAGES stages of q and dO (DP / 64 boxes of 64 rows
// each); the mbarriers (kv loaded[KVB], kv free[KVB], full[STAGES],
// empty[STAGES]); each stage's rows' lse log2(e) and delta [2][64] and ids
// or positions [64]; and its tile: query tile index (-1: no more) and mask
// flags (bit w).
template <int D>
struct DkvLayout {
  static constexpr int DP = flash::padded(D);  // columns of a row in shared memory
  static constexpr int NB = DP / 64;
  static constexpr int KVB = DP == 64 ? 2 : 1;
  static constexpr int STAGES = 4;
  static constexpr uint32_t KVBUF = 2 * WGS * NB * BOX64;
  static constexpr uint32_t ST = KVB * KVBUF;
  static constexpr uint32_t STAGE = 2 * NB * BOX64;  // q boxes, then dO boxes
  static constexpr uint32_t BARS = ST + STAGES * STAGE;
  static constexpr uint32_t ROWS = BARS + 8 * (2 * KVB + 2 * STAGES);
  static constexpr uint32_t IDS = ROWS + STAGES * 2 * TQT * 4;
  static constexpr uint32_t INFO = IDS + STAGES * TQT * 4;
  static constexpr uint32_t BYTES = INFO + STAGES * 8 + ATOM;  // + the alignment slack
};

template <int D, int M>
__global__ void __launch_bounds__(NT, 1) dkv_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const float* __restrict__ lse, const float* __restrict__ delta, const int* __restrict__ qv,
    const int* __restrict__ kv, const int* __restrict__ qr, const int* __restrict__ kr,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int B, int H, int G, int Tq, int Tkv,
    float scale, int causal, int window) {
  using L = DkvLayout<D>;
  constexpr int NB = L::NB, KVB = L::KVB, STAGES = L::STAGES;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = (raw + ATOM - 1) & ~(ATOM - 1);
  float* rows = reinterpret_cast<float*>(smem_raw + (base - raw) + L::ROWS);
  int* ids = reinterpret_cast<int*>(smem_raw + (base - raw) + L::IDS);
  int2* info = reinterpret_cast<int2*>(smem_raw + (base - raw) + L::INFO);
  auto kv_loaded = [&](int kb) { return base + L::BARS + 8 * kb; };
  auto kv_free = [&](int kb) { return base + L::BARS + 8 * (KVB + kb); };
  auto full = [&](int s) { return base + L::BARS + 8 * (2 * KVB + s); };
  auto empty = [&](int s) { return base + L::BARS + 8 * (2 * KVB + STAGES + s); };

  // work item it: 128 keys from j0 of kv head g, batch row b, the first key
  // blocks (the most query tiles, causal) first over every (b, g)
  const int n_k = (Tkv + TKB - 1) / TKB, n_items = n_k * G * B, rep = H / G;
  auto item_of = [&](int it, int& j0, int& gk, int& b) {
    const int rem = it % (G * B);
    j0 = it / (G * B) * TKB;
    gk = rem % G;
    b = rem / G;
  };
  const Mask mask = flash::mask_of<M>(Tq, Tkv, causal, window);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int kb = 0; kb < KVB; ++kb) {
      hopper::mbar_init(kv_loaded(kb), 1);
      hopper::mbar_init(kv_free(kb), 4 * WGS);  // every consumer warp
    }
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full(s), 1 + 32);    // the TMA bytes, and each lane's rows
      hopper::mbar_init(empty(s), 4 * WGS);  // every consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp < 4) {
    hopper::reg_dealloc<PRODUCER_REGS>();
    if (warp != 0) return;
    int n = 0, k = 0;  // stages filled, items taken
    for (int r = 0; r * (int)gridDim.x < n_items; ++r) {
      const int it = flash::tc::snake_item(r);
      if (it >= n_items) continue;
      int j0, gk, b;
      item_of(it, j0, gk, b);
      const int kb = k % KVB, use = k / KVB;
      const Pairs<M> pr = flash::pairs_of<M>(qv, kv, qr, kr, b, Tq, Tkv, causal, window);
      auto meets = [&](int c0, int qt) {  // the 64 keys at c0 and query tile qt
        if (c0 >= Tkv) return false;
        int lo, hi;
        mask.q_range<TQT, 64>(c0, lo, hi);
        return qt >= lo && qt <= hi && pr.template active<64>(qt * TQT, c0);
      };
      if (lane == 0) {  // k and v into buffer kb, once the item that used it is done
        if (use > 0) hopper::mbar_wait(kv_free(kb), (use - 1) & 1);
        hopper::mbar_arrive_tx(kv_loaded(kb), L::KVBUF);
        const uint32_t at = base + kb * L::KVBUF;
        for (int w = 0; w < WGS; ++w)
          for (int c = 0; c < NB; ++c) {
            hopper::tma_load_4d(at + (w * NB + c) * BOX64, &tk, kv_loaded(kb), 64 * c, gk,
                                j0 + 64 * w, b);
            hopper::tma_load_4d(at + ((WGS + w) * NB + c) * BOX64, &tv, kv_loaded(kb), 64 * c,
                                gk, j0 + 64 * w, b);
          }
      }
      // the next stage: query tile qt of head h (qt -1: the end of the item)
      auto fill = [&](int qt, int h, int edges) {
        const int s = n % STAGES, su = n / STAGES;
        ++n;
        const long long lrow = ((long long)b * H + h) * Tq;
        float lv[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};  // this lane's rows, loaded first
        if (qt >= 0)
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int i = qt * TQT + lane + 32 * x;
            if (i < Tq) {
              lv[x] = lse[lrow + i] * LOG2E;
              dl[x] = delta[lrow + i];
            }
          }
        if (su > 0) hopper::mbar_wait(empty(s), (su - 1) & 1);  // the stage is read out
        if (qt >= 0) {
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            rows[s * 2 * TQT + lane + 32 * x] = lv[x];
            rows[s * 2 * TQT + TQT + lane + 32 * x] = dl[x];
          }
          if constexpr (M != PLAIN) {  // only a tile that a warpgroup masks reads them
            if (edges)
              for (int x = 0; x < 2; ++x)
                ids[s * TQT + lane + 32 * x] = pr.qid(qt * TQT + lane + 32 * x);
          }
        }
        if (lane == 0) {
          info[s] = make_int2(qt, edges);
          if (qt < 0) {
            hopper::mbar_arrive(full(s));
          } else {
            const uint32_t st = base + L::ST + s * L::STAGE;
            hopper::mbar_arrive_tx(full(s), L::STAGE);
            for (int c = 0; c < NB; ++c) {
              hopper::tma_load_4d(st + c * BOX64, &tq, full(s), 64 * c, h, qt * TQT, b);
              hopper::tma_load_4d(st + (NB + c) * BOX64, &tdo, full(s), 64 * c, h, qt * TQT,
                                  b);
            }
          }
        }
        hopper::mbar_arrive(full(s));
      };
      // the walk: each head of the group, its query tiles 32 at a time
      int lo, hi;
      mask.q_range<TQT, TKB>(j0, lo, hi);
      for (int rr = 0; rr < rep; ++rr) {
        const int h = gk * rep + rr;
        for (int qt0 = lo; qt0 <= hi; qt0 += 32) {
          const int qt = qt0 + lane;
          bool any = false;
          int edges = 0;
          if (qt <= hi) {
#pragma unroll
            for (int w = 0; w < WGS; ++w) {
              const int c0 = j0 + 64 * w;
              any = any || meets(c0, qt);
              if (mask.edge<TQT, 64>(qt * TQT, c0) || !pr.template uniform<64>(qt * TQT, c0))
                edges |= 1 << w;
            }
          }
          for (unsigned vis = __ballot_sync(0xffffffffu, any); vis; vis &= vis - 1) {
            const int l = __ffs(vis) - 1;
            fill(qt0 + l, h, __shfl_sync(0xffffffffu, edges, l));
          }
        }
      }
      fill(-1, 0, 0);
      ++k;
    }
    return;
  }

  // consumer warpgroup w: keys c0 .. c0 + 63 of each item; this thread's
  // keys ja, jb (rows of the transposed scores)
  hopper::reg_alloc<CONSUMER_REGS>();
  const int w = (warp >> 2) - 1, g = lane >> 2, t = lane & 3;
  const float scale2 = scale * LOG2E;
  const long long rk = (long long)G * D;
  int n = 0, k = 0;  // stages consumed, items taken
  for (int r = 0; r * (int)gridDim.x < n_items; ++r) {
    const int it = flash::tc::snake_item(r);
    if (it >= n_items) continue;
    int j0, gk, b;
    item_of(it, j0, gk, b);
    const int kb = k % KVB;
    const Pairs<M> pr = flash::pairs_of<M>(qv, kv, qr, kr, b, Tq, Tkv, causal, window);
    const int ja = j0 + 64 * w + 16 * (warp & 3) + g, jb = ja + 8;
    int rlo[2], rhi[2], vlo[2], vhi[2];  // the rows and row values that keys ja, jb are kept by
    mask.key_rows(ja, rlo[0], rhi[0]);
    mask.key_rows(jb, rlo[1], rhi[1]);
    pr.kept_by(pr.kid(ja), vlo[0], vhi[0]);
    pr.kept_by(pr.kid(jb), vlo[1], vhi[1]);
    const uint32_t k_at = base + kb * L::KVBUF + w * NB * BOX64;
    const uint32_t v_at = k_at + WGS * NB * BOX64;
    float dka[D / 8][4], dva[D / 8][4], sc[TQT / 8][4], dp[TQT / 8][4];
    uint32_t pa[TQT / 16][4], pd[TQT / 16][4];  // P^T and dS^T as A fragments
    flash::tc::zero<D / 8>(dka);
    flash::tc::zero<D / 8>(dva);

    // stage s's tile (-1: no more), whether this warpgroup masks it, and
    // keys ja, jb's kept rows as offsets from the tile's row 2 t
    bool edge;
    int klo[2], khi[2];
    auto tile = [&](int s) {
      const int2 in = info[s];
      edge = (in.y >> w) & 1;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        klo[hh] = rlo[hh] - in.x * TQT - 2 * t;
        khi[hh] = rhi[hh] - in.x * TQT - 2 * t;
      }
      return in.x;
    };
    auto q_of = [&](int s) { return base + L::ST + s * L::STAGE; };  // then dO's boxes
    // s^T = k q^T and dP^T = v dO^T of stage s: two commit groups
    auto scores = [&](int s) {
      product_ss<TQT, D>(sc, k_at, q_of(s));
      product_ss<TQT, D>(dp, v_at, q_of(s) + NB * BOX64);
    };
    // once s^T is in: P^T, dv += P^T dO (dO MN-major), then dS^T into pd
    auto tile_body = [&](int s, uint32_t (&pd)[TQT / 16][4]) {
      const float* l2 = rows + s * 2 * TQT + 2 * t;  // lse log2(e), then delta, from row 2 t
      probs<TQT, M>(sc, edge, klo, khi, ids + s * TQT + 2 * t, vlo, vhi, scale2,
                    [&](int, int c) { return l2[c]; });
      pack_p<TQT>(pa, sc);
      hopper::wgmma_fence();
      product_rs<D, TQT>(dva, pa, q_of(s) + NB * BOX64);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dp);
      hopper::fence_regs(dva);
      hopper::fence_regs(pa);
      dscores<TQT>(pd, dp, sc, scale, [&](int, int c) { return l2[TQT + c]; });
    };

    // One tile behind: dk += dS^T q (q MN-major) of a tile is waited for
    // only after the next tile's s^T and dP^T are issued, and its stage goes
    // back then. The first tile is peeled.
    hopper::mbar_wait(kv_loaded(kb), (k / KVB) & 1);
    int s = n % STAGES;
    hopper::mbar_wait(full(s), (n / STAGES) & 1);
    if (tile(s) >= 0) {
      hopper::wgmma_fence();
      scores(s);
      hopper::wgmma_wait<1>();
      hopper::fence_regs(sc);
      tile_body(s, pd);
      hopper::wgmma_fence();
      product_rs<D, TQT>(dka, pd, q_of(s));
      int held = s;
      for (;;) {
        s = ++n % STAGES;
        hopper::mbar_wait(full(s), (n / STAGES) & 1);
        if (tile(s) < 0) break;
        hopper::wgmma_fence();
        scores(s);
        hopper::wgmma_wait<1>();  // the held tile's dk product, and s^T
        hopper::fence_regs(sc);
        hopper::fence_regs(dka);
        hopper::fence_regs(pd);
        release(empty(held), lane);
        tile_body(s, pd);
        hopper::wgmma_fence();
        product_rs<D, TQT>(dka, pd, q_of(s));
        held = s;
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dka);
      hopper::fence_regs(pd);
      release(empty(held), lane);
    }
    release(kv_free(kb), lane);  // every product of the item that reads k and v is done
    release(empty(s), lane);     // the stage that ended the item
    ++n;
    const float one[2] = {1.f, 1.f};
    const long long koff = (long long)b * Tkv * rk + (long long)gk * D;
    flash::tc::store_rows<D / 8>(dk + koff, dka, ja, jb, Tkv, rk, t, one);
    flash::tc::store_rows<D / 8>(dv + koff, dva, ja, jb, Tkv, rk, t, one);
    ++k;
  }
}

// One block a multiprocessor (or an item, where there are fewer items) if
// `persistent`, else one block an item
inline int grid_of(int n_items, bool persistent, int& grid) {
  grid = n_items;
  if (!persistent) return 0;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  grid = n_items < sms ? n_items : sms;
  return (int)e;
}

// the four tensor maps (q and dO by 64 rows; k and v by the tile's keys)
// and the launch; out != nullptr: K6 (dq into out), else K7 (dk, dv). The
// grid is persistent for K6 and K9 (under positions, K12, one block an
// item: as the forward) and for K7; K10 and K13 take one block an item,
// since their items' work varies with the segments or positions (a
// persistent grid measured 21 % slower for K10 at the SFT layout on the
// H100, and 0.5 % faster for K7).
template <int D, int M>
int launch(void* q, void* k, void* v, void* dout, void* lse, void* delta, void* qv, void* kv,
           void* qr, void* kr, void* out, void* dk, void* dv, int B, int H, int G, int Tq,
           int Tkv, float scale, int causal, int window, cudaStream_t stream) {
  const bool dq_side = out != nullptr;
  const int krows = dq_side ? DqLayout<D>::TK : 64;
  CUtensorMap mq, mdo, mk, mv;
  int err = hopper::encode_bthd(&mq, q, B, Tq, H, D, 64);
  if (err == 0) err = hopper::encode_bthd(&mdo, dout, B, Tq, H, D, 64);
  if (err == 0) err = hopper::encode_bthd(&mk, k, B, Tkv, G, D, krows);
  if (err == 0) err = hopper::encode_bthd(&mv, v, B, Tkv, G, D, krows);
  int grid = 0;
  if (err == 0)
    err = dq_side ? grid_of((Tq + TQ - 1) / TQ * H * B, M != flash::POS, grid)
                  : grid_of((Tkv + TKB - 1) / TKB * G * B, M == PLAIN, grid);
  if (err != 0) return err;
  if (dq_side) {
    void* args[] = {&mq, &mdo, &mk, &mv, &lse, &delta, &qv,     &kv,     &qr,    &kr,
                    &out, &B,  &H,  &G,  &Tq,  &Tkv,   &scale, &causal, &window};
    return flash::launch(dq_kernel<D, M>, DqLayout<D>::BYTES, NT, grid, 1, 1, stream, args);
  }
  void* args[] = {&mq, &mdo, &mk, &mv, &lse, &delta, &qv,    &kv,     &qr,     &kr,
                  &dk, &dv,  &B,  &H,  &G,   &Tq,    &Tkv,   &scale, &causal, &window};
  return flash::launch(dkv_kernel<D, M>, DkvLayout<D>::BYTES, NT, grid, 1, 1, stream, args);
}

}  // namespace wg

template <int M>
int dq_entry(int dtype, void* q, void* k, void* v, void* dout, void* lse, void* delta, void* qv,
             void* kv, void* qr, void* kr, void* dq_out, int B, int H, int G, int Tq, int Tkv,
             int head_dim, float scale, int causal, int window, void* stream) {
  if (!flash::valid_shape(B, H, G, Tq, Tkv, head_dim, window) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* bf[] = {q, k, v, dout, dq_out};
  if (dtype == 1 && !flash::aligned16(bf, 5)) return (int)cudaErrorMisalignedAddress;
  void* args[] = {&q,      &k, &v, &dout, &lse, &delta, &qv,     &kv,    &qr, &kr,
                  &dq_out, &H, &G, &Tq,   &Tkv, &scale, &causal, &window};
  const int n_q = (Tq + BQ - 1) / BQ;
  return flash::with_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    if (dtype == 1)
      return wg::launch<D, M>(q, k, v, dout, lse, delta, qv, kv, qr, kr, dq_out, nullptr, nullptr,
                              B, H, G, Tq, Tkv, scale, causal, window, s);
    return flash::launch(f32::dq_kernel<D, M>, f32::smem_dq<D>(), f32::NT, n_q, H, B, s, args);
  });
}

template <int M>
int dkv_entry(int dtype, void* q, void* k, void* v, void* dout, void* lse, void* delta, void* qv,
              void* kv, void* qr, void* kr, void* dk, void* dv, int B, int H, int G, int Tq,
              int Tkv, int head_dim, float scale, int causal, int window, void* stream) {
  if (!flash::valid_shape(B, H, G, Tq, Tkv, head_dim, window) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* bf[] = {q, k, v, dout, dk, dv};
  if (dtype == 1 && !flash::aligned16(bf, 6)) return (int)cudaErrorMisalignedAddress;
  void* args[] = {&q,  &k,  &v, &dout, &lse, &delta, &qv,    &kv,     &qr,    &kr,
                  &dk, &dv, &H, &G,    &Tq,  &Tkv,   &scale, &causal, &window};
  const int n_kv = (Tkv + BKV - 1) / BKV;
  return flash::with_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    if (dtype == 1)
      return wg::launch<D, M>(q, k, v, dout, lse, delta, qv, kv, qr, kr, nullptr, dk, dv, B, H,
                              G, Tq, Tkv, scale, causal, window, s);
    return flash::launch(f32::dkv_kernel<D, M>, f32::smem_dkv<D>(), f32::NT, n_kv, G, B, s,
                         args);
  });
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (every tensor 16-byte aligned). head_dim
// 64, 96 or 128; causal 0/1; window 0 = none. Each returns a cudaError_t.

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
