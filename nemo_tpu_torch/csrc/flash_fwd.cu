// Causal / sliding-window GQA flash attention forward for Hopper (sm_90a),
// fp32 or bf16 inputs, head width D in {64, 128}: K5, K8, its form over
// packed rows with segment ids, and K11, its form with explicit positions.
//
// Replaces the TPU kernel nemo_tpu/ops/flash_attention.py:_fwd_kernel
// (pallas_call in _flash_forward) as nemo_tpu/models/llm/gpt.py:642 calls
// it: causal, an optional sliding window, G kv heads under H query heads
// (head h reads kv head h*G/H, as _kv_index_map does):
//
//   s[i,j] = scale * q_i . k_j   for j <= i (causal) and j > i - window, else -1e30
//   o_i    = softmax_j(s[i,:]) v ;  lse_i = log sum_j exp s[i,j]
//
// One block owns (b, h, 64 query rows) and loops over the 64-key tiles that
// hold an unmasked pair (_block_active: from the window's first tile to the
// diagonal), with an online softmax; only boundary tiles (_needs_mask) are
// masked element by element. Causal, that is half the tiles at T = 2048.
// Blocks of later query tiles have more tiles to visit and are launched
// first.
//
// K8 replaces nemo_tpu/ops/flash_attention.py:_fwd_seg_kernel (pallas_call in
// _flash_forward_seg) as gpt.py:648 calls it for packed SFT batches: the same
// function restricted to pairs whose segment ids are equal and nonzero. It
// is the same kernel with segments on (flash_tiles.cuh:Pairs<SEG>): a key tile
// is visited only where the [min, max] ids of the two tiles overlap, and the
// segment test joins the element mask on tiles that are not one nonzero
// segment on both sides. A row of padding (id 0) keeps no key: o = 0, lse =
// -1e30; a row whose segment starts mid-tile meets a tile with no kept key.
// The running max is therefore floored at -5e29 where it enters exp (m_safe,
// flash_attention.py:849-867), so that a row with nothing kept yet adds
// exp(-1e30 + 5e29) = 0 and not exp(0) = 1. With one segment per row K8
// takes K5's arithmetic step for step and gives K5's bits.
//
// K11 replaces nemo_tpu/ops/flash_attention.py:_fwd_pos_kernel (pallas_call
// in _flash_forward_pos), the inner step of ring attention
// (ops/ring_attention.py:ring_flash_attention): Tq rows against Tkv keys,
// pair (i, j) kept where kpos[j] <= qpos[i] and kpos[j] > qpos[i] - window
// (_pos_mask), with qpos [Tq] and kpos [Tkv] shared by the batch. It is the
// same kernel with positions on (flash_tiles.cuh:Pairs<POS>): it walks every
// key tile and skips those whose position range holds no kept pair
// (_pos_active), from the per-64-row [min, max] positions of a pre-pass; a
// tile pair that keeps every pair takes no element mask. In a ring's
// off-diagonal step whole rows keep no key; they end with o = 0 and lse =
// -1e30 (_finish, flash_attention.py:522-529) through the same m_safe floor.
// With qpos = kpos = 0 .. T-1 it visits K5's tiles in K5's order and gives
// K5's bits.
//
// Bound on the H100: 4 * B * H * D * (valid pairs) operations against ~4 x
// B T H D x 2 bytes of q, k, v and o, so the operations bound it at the
// training shape (B=8, H=32, G=8, T=2048, D=64: 0.14 ms at the bf16 peak).
//
// - bf16 (the main path): tensor cores through mma.sync m16n8k16 (fp32
//   accumulators), 4 warps of 16 query rows holding q in registers; per key
//   tile s = q k^T from the staged k tile, then o += P v with P rounded to
//   bf16 straight from the score registers (as flash_attention.py:131 rounds
//   p to v's dtype) and v's fragments read by ldmatrix.trans.
// - fp32 (the exactness check): scalar FMAs from shared-memory tiles, 16 x 16
//   threads with 4 x 4 scores each.
// wgmma, TMA and double buffering come later.
//
// Layouts: q, o [B, Tq, H, D]; k, v [B, Tkv, G, D]; lse [B, H, Tq] fp32;
// segment ids [B, T] int32 and their tile ranges [B, ceil(T / 64), 2] int32;
// positions [Tq], [Tkv] int32 and their tile ranges [ceil(T / 64), 2].

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "flash_tiles.cuh"

namespace {

using flash::BKV;
using flash::BQ;
using flash::Mask;
using flash::NEG;
using flash::NEG_HALF;
using flash::Pairs;
using flash::PLAIN;

// ---------------------------------------------------------------- fp32 path

namespace f32 {

constexpr int NT = 256;      // 16 x 16 threads, 4 x 4 scores each
constexpr int LDT = BQ + 4;  // stride of the transposed [D][rows] tiles

// shared memory, floats: Q^T, K^T (reused for the probabilities), V
template <int D>
constexpr size_t smem() { return (2 * D * LDT + BKV * D) * sizeof(float); }

template <int D, int M>
__global__ void __launch_bounds__(NT) fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const int* __restrict__ qv, const int* __restrict__ kv, const int* __restrict__ qr,
    const int* __restrict__ kr, float* __restrict__ o, float* __restrict__ lse, int H, int G,
    int Tq, int Tkv, float scale, int causal, int window) {
  constexpr int NC = D / 64;  // column groups of 64 per thread
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // [D][LDT]
  float* sK = sQ + D * LDT;                      // [D][LDT]; then probabilities [BKV][LDT]
  float* sV = sK + D * LDT;                      // [BKV][D]
  __shared__ int sKs[M != PLAIN ? BKV : 1];      // the key tile's ids or positions

  const Mask mask = flash::mask_of<M>(Tq, Tkv, causal, window);
  const int i0 = (gridDim.x - 1 - blockIdx.x) * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const Pairs<M> pr = flash::pairs_of<M>(qv, kv, qr, kr, b, Tq, Tkv, causal, window);
  int qs[4];  // the ids or positions of this thread's rows
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) qs[ii] = pr.qid(i0 + 4 * ty + ii);
  const long long rq = (long long)H * D, rk = (long long)G * D;
  const long long qoff = (long long)b * Tq * rq + (long long)h * D;
  const long long koff = (long long)b * Tkv * rk + (long long)(h * G / H) * D;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D, d = idx % D, i = i0 + r;
    sQ[d * LDT + r] = (i < Tq) ? q[qoff + i * rq + d] : 0.f;
  }

  float m[4], l[4], acc[4][4 * NC];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    m[ii] = NEG;
    l[ii] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[ii][c] = 0.f;
  }

  int lo, hi;
  mask.kv_range(i0, lo, hi);
  for (int kt = lo; kt <= hi; ++kt) {
    const int j0 = kt * BKV;
    if (!pr.active(i0, j0)) continue;  // the same for the whole block
    __syncthreads();  // the previous tile is no longer read
    for (int idx = tid; idx < BKV * D; idx += NT) {
      const int r = idx / D, d = idx % D, j = j0 + r;
      float a = 0.f, c = 0.f;
      if (j < Tkv) {
        a = k[koff + j * rk + d];
        c = v[koff + j * rk + d];
      }
      sK[d * LDT + r] = a;
      sV[r * D + d] = c;
    }
    flash::stage_kids<M>(sKs, pr, j0);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[ii][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&sQ[d * LDT + 4 * ty]);
      const float4 kk = *reinterpret_cast<const float4*>(&sK[d * LDT + 4 * tx]);
      const float qa[4] = {a.x, a.y, a.z, a.w};
      const float kr[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[ii][jj] = fmaf(qa[ii], kr[jj], s[ii][jj]);
    }

    // online softmax; the 16 threads of a row group are 16 lanes of one warp
    const bool edge = mask.edge(i0, j0) || !pr.uniform(i0, j0);
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      float mx = NEG;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int jl = 4 * tx + jj;
        float val = s[ii][jj] * scale;
        if (edge && !(mask.allowed(i0 + 4 * ty + ii, j0 + jl) &&
                      pr.same(qs[ii], M != PLAIN ? sKs[jl] : 1)))
          val = NEG;
        s[ii][jj] = val;
        mx = fmaxf(mx, val);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[ii], mx);
      const float m_safe = fmaxf(m_new, NEG_HALF);
      const float alpha = expf(fmaxf(m[ii], NEG_HALF) - m_safe);
      float ps = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        s[ii][jj] = expf(s[ii][jj] - m_safe);
        ps += s[ii][jj];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[ii] = l[ii] * alpha + ps;
      m[ii] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) acc[ii][c] *= alpha;
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
      const float pa[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(&sV[j * D + 64 * c + 4 * tx]);
        const float va[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int dd = 0; dd < 4; ++dd)
            acc[ii][4 * c + dd] = fmaf(pa[ii], va[dd], acc[ii][4 * c + dd]);
      }
    }
  }

  // a row that kept no key (padding, or no key in range): o = 0 and lse = -1e30
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int i = i0 + 4 * ty + ii;
    if (i >= Tq) continue;
    const bool dead = m[ii] <= NEG_HALF;
    const float lv = fmaxf(l[ii], 1e-30f);
    const float inv = dead ? 0.f : 1.f / lv;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int dd = 0; dd < 4; ++dd)
        o[qoff + i * rq + 64 * c + 4 * tx + dd] = acc[ii][4 * c + dd] * inv;
    if (tx == 0) lse[((long long)b * H + h) * Tq + i] = dead ? NEG : m[ii] + logf(lv);
  }
}

}  // namespace f32

// ------------------------------------------------------- bf16 tensor-core path

namespace tc {

using namespace flash::tc;

// shared memory: K, V [BKV][D + 8] bf16
template <int D>
constexpr size_t smem() { return 2 * BKV * (D + 8) * sizeof(bf16); }

template <int D, int M>
__global__ void __launch_bounds__(NT, 2) fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const int* __restrict__ qv, const int* __restrict__ kv, const int* __restrict__ qr,
    const int* __restrict__ kr, bf16* __restrict__ o, float* __restrict__ lse, int H, int G,
    int Tq, int Tkv, float scale, int causal, int window) {
  constexpr int LDS = D + 8, KS = D / 16, NDT = D / 8;
  extern __shared__ float4 smem4[];
  bf16* sK = reinterpret_cast<bf16*>(smem4);  // [BKV][LDS]: k_j, d contiguous
  bf16* sV = sK + BKV * LDS;                  // [BKV][LDS]: v_j, d contiguous
  __shared__ int sKs[M != PLAIN ? BKV : 1];   // the key tile's ids or positions

  const Mask mask = flash::mask_of<M>(Tq, Tkv, causal, window);
  const int i0 = (gridDim.x - 1 - blockIdx.x) * BQ, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long rq = (long long)H * D, rk = (long long)G * D;
  const long long qoff = (long long)b * Tq * rq + (long long)h * D;
  const long long koff = (long long)b * Tkv * rk + (long long)(h * G / H) * D;

  // this warp's query rows ia, ib as A fragments, and their ids or positions
  const int ia = i0 + 16 * warp + g, ib = ia + 8;
  uint32_t fq[KS][4];
  load_rows_a<KS>(fq, q + qoff, ia, ib, Tq, rq, t);
  const Pairs<M> pr = flash::pairs_of<M>(qv, kv, qr, kr, b, Tq, Tkv, causal, window);
  const int qs[2] = {pr.qid(ia), pr.qid(ib)};

  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, acc[NDT][4];
  zero<NDT>(acc);

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

    float s[8][4];
    zero<8>(s);
    mma_nt<8, KS, LDS>(s, fq, sK, g, t);

    // scaled scores, masked on a boundary tile or one the policy does not keep whole;
    // row r of the warp, key jl of the tile
    const bool edge = mask.edge(i0, j0) || !pr.uniform(i0, j0);
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = g + 8 * (e >> 1), jl = 8 * nt + 2 * t + (e & 1);
        float val = s[nt][e] * scale;
        if (edge && !(mask.allowed(i0 + 16 * warp + r, j0 + jl) &&
                      pr.same(qs[e >> 1], M != PLAIN ? sKs[jl] : 1)))
          val = NEG;
        s[nt][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }

    // online softmax over the 4 lanes that share a row; m_safe keeps a row
    // with no kept key yet at p = 0
    float alpha[2], m_safe[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m[hh], mx[hh]);
      m_safe[hh] = fmaxf(m_new, NEG_HALF);
      alpha[hh] = __expf(fmaxf(m[hh], NEG_HALF) - m_safe[hh]);
      m[hh] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = __expf(s[nt][e] - m_safe[e >> 1]);
        ps[e >> 1] += s[nt][e];
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * alpha[hh] + ps[hh];  // this lane's share
#pragma unroll
    for (int dt = 0; dt < NDT; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }

    // acc += probabilities (bf16, from the score registers) x v
    uint32_t a[4][4];
    pack_a(a, s);
    mma_nn<4, NDT, LDS>(acc, a, sV, lane);
  }

  // a row that kept no key (padding, or no key in range): o = 0 and lse = -1e30
  float inv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float lt = l[hh];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const bool dead = m[hh] <= NEG_HALF;
    const float lv = fmaxf(lt, 1e-30f);
    inv[hh] = dead ? 0.f : 1.f / lv;
    const int i = hh ? ib : ia;
    if (t == 0 && i < Tq) lse[((long long)b * H + h) * Tq + i] = dead ? NEG : m[hh] + logf(lv);
  }
  store_rows<NDT>(o + qoff, acc, ia, ib, Tq, rq, t, inv);
}

}  // namespace tc

template <int D, int M>
int fwd(int dtype, void** args, int n_q, int H, int B, cudaStream_t s) {
  if (dtype == 0)
    return flash::launch(f32::fwd_kernel<D, M>, f32::smem<D>(), f32::NT, n_q, H, B, s, args);
  return flash::launch(tc::fwd_kernel<D, M>, tc::smem<D>(), tc::NT, n_q, H, B, s, args);
}

template <int M>
int fwd_entry(int dtype, void* q, void* k, void* v, void* qv, void* kv, void* qr, void* kr,
              void* o, void* lse, int B, int H, int G, int Tq, int Tkv, int head_dim,
              float scale, int causal, int window, void* stream) {
  if (!flash::valid_shape(B, H, G, Tq, Tkv, head_dim, window) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    const void* bf[] = {q, k, v, o};
    if (!flash::aligned16(bf, 4)) return (int)cudaErrorMisalignedAddress;
  }
  void* args[] = {&q,  &k, &v,  &qv,  &kv,    &qr,     &kr,    &o,
                  &lse, &H, &G, &Tq, &Tkv, &scale, &causal, &window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_q = (Tq + BQ - 1) / BQ;
  return head_dim == 64 ? fwd<64, M>(dtype, args, n_q, H, B, s)
                        : fwd<128, M>(dtype, args, n_q, H, B, s);
}

}  // namespace

// K5. dtype: 0 = float32, 1 = bfloat16 (every tensor 16-byte aligned).
// head_dim 64 or 128; causal 0/1; window 0 = none. o [B, T, H, D] in the
// input dtype, lse [B, H, T] fp32. Returns a cudaError_t.
extern "C" int flash_fwd(int dtype, void* q, void* k, void* v, void* o, void* lse, int B, int H,
                         int G, int Tn, int head_dim, float scale, int causal, int window,
                         void* stream) {
  return fwd_entry<PLAIN>(dtype, q, k, v, nullptr, nullptr, nullptr, nullptr, o, lse, B, H, G,
                          Tn, Tn, head_dim, scale, causal, window, stream);
}

// K8: K5 over packed rows. seg [B, T] int32 segment ids (0 = padding) and
// seg_range [B, ceil(T / 64), 2] int32, the [min, max] id of each 64-row
// tile. A padding row gets o = 0 and lse = -1e30.
extern "C" int flash_seg_fwd(int dtype, void* q, void* k, void* v, void* seg, void* seg_range,
                             void* o, void* lse, int B, int H, int G, int Tn, int head_dim,
                             float scale, int causal, int window, void* stream) {
  if (seg == nullptr || seg_range == nullptr) return (int)cudaErrorInvalidValue;
  return fwd_entry<flash::SEG>(dtype, q, k, v, seg, seg, seg_range, seg_range, o, lse, B, H, G,
                               Tn, Tn, head_dim, scale, causal, window, stream);
}

// K11: K5 with explicit positions. q [B, Tq, H, D], k, v [B, Tkv, G, D] with
// Tq and Tkv multiples of 64; qpos [Tq], kpos [Tkv] int32 and their tile
// ranges qrange [Tq / 64, 2], krange [Tkv / 64, 2] int32 ([min, max] of each
// 64 positions). o [B, Tq, H, D], lse [B, H, Tq]; a row that keeps no key
// gets o = 0 and lse = -1e30.
extern "C" int flash_pos_fwd(int dtype, void* q, void* k, void* v, void* qpos, void* kpos,
                             void* qrange, void* krange, void* o, void* lse, int B, int H, int G,
                             int Tq, int Tkv, int head_dim, float scale, int causal, int window,
                             void* stream) {
  if (!qpos || !kpos || !qrange || !krange || Tq % BQ || Tkv % BKV)
    return (int)cudaErrorInvalidValue;
  return fwd_entry<flash::POS>(dtype, q, k, v, qpos, kpos, qrange, krange, o, lse, B, H, G, Tq,
                               Tkv, head_dim, scale, causal, window, stream);
}
