// Rel-pos flash attention forward for Hopper (sm_90a), fp32 or bf16 inputs:
// K1.
//
// Replaces the TPU kernel nemo_tpu/ops/flash_attention.py:_fwd_kernel as
// nemo_tpu/ops/attention.py:_relpos_flash calls it (non-causal, G = H, with
// the Transformer-XL rel-pos term and the key padding folded into a 640-wide
// augmented contraction). Here the rel-pos term is computed per tile from the
// projected table p instead, at head width dh = D, 64 (Conformer-Large) or
// 128 (FastConformer-XL):
//
//   s[i,j] = scale * (qu_i . k_j + qv_i . p_{(T-1)-i+j})   for j < len_b
//   s[i,j] = -1e30                                          otherwise
//   o_i    = softmax_j(s[i,:]) v ;  lse_i = log sum_j exp s[i,j]
//
// Key tiles stop at the last one that holds a valid key (ceil(len_b / 64)).
// The term of (i, j) runs along diagonals of p, which no matrix layout reads:
// the rows of p that a 64 x 64 tile pair needs are the 127 consecutive rows
// r0 .. r0+126, r0 = T - 64 - i0 + j0 (local row q = j - i + 63).
//
// Bound on the H100: 6 * B * H * T * len * dh operations (q.k, q.p, p.v)
// against ~125 MB of q/k/v/o traffic at the main path's shape (B=32, H=8,
// T=751, dh 64), so the operations bound it: 0.056 ms at the bf16
// tensor-core peak. At FastConformer-XL's (B=32, H=8, T=376, dh 128) the
// same ~125 MB bounds it: 0.037 ms against 0.028 ms of products.
//
// - bf16 (the main path; csrc/hopper.cuh, TMA and wgmma, no mma.sync): the
//   causal forward's shape (flash_fwd.cu) with K3's band (relpos_flash_bwd.cu).
//   A block of 384 threads: a producer warpgroup that hands its registers to
//   two consumer warpgroups of 64 query rows (setmaxnreg 40 / 232) and loads
//   qu, qv once an item and k, v and the 192 rows of p of each key tile by
//   TMA into a ring of 3 stages; a persistent grid over the (query tile of
//   128, h, b) items. s = qu k^T and one new 64 x 64 chunk of qv p^T a tile
//   by wgmma SS (consecutive key tiles reach overlapping chunks, so each
//   chunk is computed once, not 1.25 times as over 80 rows of p a warp),
//   the chunk skewed into a ring of scores in shared memory at each score's
//   diagonal and read back as plain rows; the online softmax in registers;
//   o += P v by wgmma RS (P rounded to bf16 in registers, v MN-major), one
//   tile behind, so that it runs back to back with the next tile's two
//   products. See wg:: below. At dh 128 a 64-row tile of q, k, v or p is two
//   128-byte swizzle boxes, and the dh-64 block does not fit in 227 KB of
//   shared memory (q 64 KB, 3 stages of 80 KB, the G rings 64 KB). There
//   (wg::fwd128_kernel) the block keeps the dh-64 shape, two consumer
//   warpgroups of 64 query rows (setmaxnreg 24 / 240), but holds qu and qv
//   as register fragments loaded from device memory, not in shared memory
//   (s and the band chunk are wgmma RS), and k, p and v come in two rings of
//   2 stages, so that a tile's k and p go back before its P v: 225 KB. What
//   bounds it on the H100 is the tile traffic into shared memory, 10 bytes a
//   score (16 in a block of one warpgroup of 64 rows, whose loads alone take
//   0.105 ms of its 0.163), and the latency of each tile's products, scatter and
//   softmax, which the second warpgroup's work covers.
// - fp32 (the exactness check): scalar fp32 FMAs from shared-memory tiles,
//   16 x 16 threads with 4 x 4 scores each (4 x 8 outputs at dh 128, whose
//   200 KB of tiles fit one block an SM).
//
// Layouts: qu, qv, k, v and o are [B, T, H, D] (the Linear outputs viewed
// per head); p is [2T-1, H, D]; lengths is [B] int32; lse is [B, H, T] fp32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "flash_tiles.cuh"
#include "hopper.cuh"
#include "relpos_band.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr float NEG = -1e30f;

// ---------------------------------------------------------------- fp32 path

namespace f32 {

constexpr int NT = 256;            // 16 x 16 threads, 4 x 4 scores each
constexpr int LDT = BQ + 4;        // stride of the transposed [D][rows] tiles
constexpr int NP = BQ + BKV - 1;   // rel-pos rows one tile pair needs
constexpr int LDP = 128 + 4;       // stride of the transposed p tile

// shared memory, in floats: Qu^T, Qv^T, K^T (reused for the probabilities), V, P^T
template <int D>
constexpr size_t smem() { return (3 * D * LDT + BKV * D + D * LDP) * sizeof(float); }

// two blocks an SM at dh 64 (100 KB each); one at dh 128 (200 KB)
template <int D>
__global__ void __launch_bounds__(NT, D == 64 ? 2 : 1) kernel(
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
  constexpr int NC = D / 64;       // output column groups of 64 a thread

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

  float m[4], l[4], acc[4][4 * NC];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    m[ii] = NEG;
    l[ii] = 0.f;
#pragma unroll
    for (int dd = 0; dd < 4 * NC; ++dd) acc[ii][dd] = 0.f;
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
      for (int dd = 0; dd < 4 * NC; ++dd) acc[ii][dd] *= alpha;
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

#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int i = i0 + 4 * ty + ii;
    if (i >= Tn) continue;
    const float lv = fmaxf(l[ii], 1e-30f);
    const float inv = 1.f / lv;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int dd = 0; dd < 4; ++dd)
        o[base + i * rs + 64 * c + 4 * tx + dd] = acc[ii][4 * c + dd] * inv;
    if (tx == 0) lse[((long long)b * H + h) * Tn + i] = m[ii] + logf(lv);
  }
}

}  // namespace f32

// ------------------------------------------------ bf16 path: TMA and wgmma

namespace wg {

using bf16 = __nv_bfloat16;
using flash::tc::ex2;
using flash::tc::fresh;
using flash::tc::pack_p;
using hopper::product_rs;
using hopper::product_ss;

constexpr int PRODUCER_REGS = 40;    // registers a thread, after the split (setmaxnreg) at
constexpr int CONSUMER_REGS = 232;   // dh 64: 128 x 40 + 256 x 232 = 384 x 168 at launch
constexpr float LOG2E = 1.4426950408889634f;
constexpr uint32_t BOX64 = 64 * hopper::BOX_ROW_BYTES;  // a bf16 box of 64 rows, 8 KB

// dh 64 (dh 128 is fwd128_kernel below). A block owns TQ = 128 query rows
// of one (b, h), a consumer warpgroup 64 of them (rows i0 + 64 w), in a
// persistent grid over the (query tile, h, b) items. The producer's first
// thread loads qu and qv once an item and, per key tile kt of 64 keys up to
// the last valid key, k, v and the 192 rows of p from T - TQ - i0 + 64 kt
// (the warpgroups' band chunks kt and kt + 1, which overlap) by TMA into a
// ring of stages; rows before p's first or past its last read as zeros.
//
// The band (relpos_band.cuh, shared with K3): warpgroup w's chunk kt of qv
// p^T reads the stage's p rows from box 1 - w, chunk kt + 1 the next
// 64; a tile computes the new chunk kt + 1 (tile 0 chunk 0 first) and
// scatters it into its G ring, from which the tile's scores take their
// rel-pos terms.
//
// A tile: s = qu k^T and the new band chunk by wgmma SS, then the online
// softmax in registers (2^x, the running max in raw units), then o += P v by
// wgmma RS (P rounded to bf16 in registers, v MN-major). P v of a tile is
// issued with the next tile's two products, so the tensor cores run them
// back to back; the stage goes back once its P v is done.
//
// Two consumer warpgroups (384 threads, setmaxnreg), 3 stages (~217 KB).
template <int D>
struct Layout {
  static_assert(D == 64, "K1 at dh 128 is fwd128_kernel");
  static constexpr int WGS = 2;                 // consumer warpgroups, 64 query rows each
  static constexpr int NT = 128 * (WGS + 1);    // and a producer warpgroup, one thread at work
  static constexpr int TQ = 64 * WGS;           // query rows an item
  static constexpr int STAGES = 3;
  static constexpr uint32_t TILE = BOX64;       // 64 rows of 64 columns
  static constexpr uint32_t Q = 2 * WGS * TILE;  // qu, qv: a tile a warpgroup each
  static constexpr uint32_t STAGE = (WGS + 3) * TILE;  // k, v, then 64 (WGS + 1) rows of p
  static constexpr uint32_t G = Q + STAGES * STAGE;
  static constexpr uint32_t GBYTES = 64 * 128 * 4;  // a warpgroup's G ring
  static constexpr uint32_t BARS = G + WGS * GBYTES;  // q loaded, q free, full, empty
  static constexpr uint32_t BYTES = BARS + 8 * (2 + 2 * STAGES) + hopper::ATOM;  // + alignment
  static_assert(BYTES <= 232448, "K1: more shared memory than a block can have");
};

template <int D>
__global__ void __launch_bounds__(Layout<D>::NT, 1) fwd_kernel(
    const __grid_constant__ CUtensorMap tqu, const __grid_constant__ CUtensorMap tqv,
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tp, const int* __restrict__ lengths,
    bf16* __restrict__ o, float* __restrict__ lse, int B, int H, int Tn, float scale) {
  using L = Layout<D>;
  constexpr int STAGES = L::STAGES, WGS = L::WGS, TQ = L::TQ;
  constexpr uint32_t TILE = L::TILE;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = (raw + hopper::ATOM - 1) & ~(hopper::ATOM - 1);
  uint8_t* const sm = smem_raw + (base - raw);
  const uint32_t q_loaded = base + L::BARS, q_free = q_loaded + 8;
  auto full = [&](int s) { return base + L::BARS + 8 * (2 + s); };
  auto empty = [&](int s) { return base + L::BARS + 8 * (2 + STAGES + s); };

  // work item it: TQ query rows from i0 of head h, batch row b
  const int n_q = (Tn + TQ - 1) / TQ, n_items = n_q * H * B;
  auto item_of = [&](int it, int& i0, int& h, int& b) {
    const int rem = it % (H * B);
    i0 = it / (H * B) * TQ;
    h = rem % H;
    b = rem / H;
  };
  auto length = [&](int b) { return min(max(lengths[b], 0), Tn); };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    hopper::mbar_init(q_loaded, 1);
    hopper::mbar_init(q_free, 4 * WGS);  // every consumer warp
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full(s), 1);         // the TMA bytes
      hopper::mbar_init(empty(s), 4 * WGS);  // every consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp < 4) {
    hopper::reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x != 0) return;
    int n = 0, k = 0;  // stages filled, items taken
    for (int r = 0; r * (int)gridDim.x < n_items; ++r) {
      const int it = flash::tc::snake_item(r);
      if (it >= n_items) continue;
      int i0, h, b;
      item_of(it, i0, h, b);
      if (k > 0) hopper::mbar_wait(q_free, (k - 1) & 1);  // the last item is done with q
      hopper::mbar_arrive_tx(q_loaded, L::Q);
      for (int w = 0; w < WGS; ++w) {
        hopper::tma_load_4d(base + w * TILE, &tqu, q_loaded, 0, h, i0 + 64 * w, b);
        hopper::tma_load_4d(base + (WGS + w) * TILE, &tqv, q_loaded, 0, h, i0 + 64 * w, b);
      }
      const int nk = (length(b) + 63) / 64;
      for (int kt = 0; kt < nk; ++kt, ++n) {
        const int s = n % STAGES, use = n / STAGES;
        if (use > 0) hopper::mbar_wait(empty(s), (use - 1) & 1);  // the stage is read out
        const uint32_t st = base + L::Q + s * L::STAGE;
        hopper::mbar_arrive_tx(full(s), L::STAGE);
        hopper::tma_load_4d(st, &tk, full(s), 0, h, 64 * kt, b);
        hopper::tma_load_4d(st + TILE, &tv, full(s), 0, h, 64 * kt, b);
        for (int x = 0; x <= WGS; ++x)  // rows past either end of p read as zeros
          hopper::tma_load_4d(st + (2 + x) * TILE, &tp, full(s), 0, h,
                              Tn - TQ - i0 + 64 * kt + 64 * x, 0);
      }
      ++k;
    }
    return;
  }

  // consumer warpgroup w: query rows i0 + 64 w .. + 63 of each item; this
  // thread's local rows rl and rl + 8 (global ia, ib)
  hopper::reg_alloc<CONSUMER_REGS>();
  const int w = (warp >> 2) - 1, g = lane >> 2, t = lane & 3, rl = 16 * (warp & 3) + g;
  const float scale2 = scale * LOG2E;  // P = 2^((s - m) scale2), s and m in raw units
  const long long rs = (long long)H * D;
  float* const G = reinterpret_cast<float*>(sm + L::G + w * L::GBYTES);
  const uint32_t qu_at = base + w * TILE, qv_at = base + (WGS + w) * TILE;
  auto release = [&](uint32_t bar) {  // this warp is done with what `bar` guards
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(bar);
  };
  // band chunk m (64 x 64 accumulator) into the G ring
  auto scatter = [&](const float (&bd)[8][4], int m) { relpos::scatter_band(G, bd, m, rl, g, t); };

  // Tile kt's scores: sc (qu k^T) plus the band terms from G, -1e30 on keys
  // past the length; then the online softmax in registers: sc becomes P =
  // 2^((s - m) scale2), m (raw units) and this lane's share of l are
  // updated, and alpha is the factor the rows' accumulators take
  auto softmax_tile = [&](float (&sc)[8][4], int kt, int len, float (&m)[2], float (&l)[2],
                          float (&alpha)[2]) {
    const float* grow[2] = {relpos::band_row(G, rl, kt), relpos::band_row(G, rl + 8, kt)};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float2 gv = *reinterpret_cast<const float2*>(grow[hh] + ((8 * nt + 2 * t) ^ (8 * g)));
        sc[nt][2 * hh] += gv.x;
        sc[nt][2 * hh + 1] += gv.y;
      }
    const int kmax = len - 64 * kt;  // keys c < kmax are valid
    if (__builtin_expect(kmax < 64, 0)) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = 8 * nt + 2 * t + (e & 1) < kmax ? sc[nt][e] : NEG;
    }
    float mx[2][2] = {{NEG, NEG}, {NEG, NEG}};  // [row][even, odd block]: two chains
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1][nt & 1] = fmaxf(mx[e >> 1][nt & 1], sc[nt][e]);
    float ms2[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {  // over the 4 lanes that share a row
      float x = fmaxf(mx[hh][0], mx[hh][1]);
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      const float m_new = fmaxf(m[hh], x);
      alpha[hh] = ex2((m[hh] - m_new) * scale2);
      ms2[hh] = m_new * scale2;
      m[hh] = m_new;
    }
    float ps[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[nt][e] = ex2(fmaf(sc[nt][e], scale2, -ms2[e >> 1]));
        ps[e >> 1][nt & 1] += sc[nt][e];
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * alpha[hh] + (ps[hh][0] + ps[hh][1]);
  };

  int n = 0, k = 0;  // stages consumed, items taken
  for (int r = 0; r * (int)gridDim.x < n_items; ++r) {
    const int it = flash::tc::snake_item(r);
    if (it >= n_items) continue;
    int i0, h, b;
    item_of(it, i0, h, b);
    const int len = length(b), nk = (len + 63) / 64;
    const int ia = i0 + 64 * w + rl, ib = ia + 8;
    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, acc[D / 8][4], sc[8][4], bd[8][4], alpha[2];
    uint32_t pa[4][4];  // the held tile's probabilities as A fragments
    flash::tc::zero<D / 8>(acc);
    hopper::mbar_wait(q_loaded, k & 1);
    if (nk > 0) {
      // One tile behind, as flash_fwd.cu's: P v of a tile is issued with the
      // next tile's s and band chunk; the first tile is peeled (band chunks
      // 0 and 1, scores, no P v yet).
      int s = n % STAGES;
      hopper::mbar_wait(full(s), (n / STAGES) & 1);
      uint32_t k_at = base + L::Q + s * L::STAGE;
      // chunk kt of this warpgroup; chunk kt + 1 follows
      uint32_t old_at = k_at + (WGS + 1 - w) * TILE;
      hopper::wgmma_fence();
      product_ss<64, D>(bd, qv_at, old_at);  // chunk 0
      hopper::wgmma_wait<0>();
      hopper::fence_regs(bd);
      scatter(bd, 0);
      hopper::wgmma_fence();
      product_ss<64, D>(sc, qu_at, k_at);            // s = qu k^T
      product_ss<64, D>(bd, qv_at, old_at + TILE);  // chunk 1 of qv p^T
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      hopper::fence_regs(bd);
      scatter(bd, 1);
      __syncwarp();
      softmax_tile(sc, 0, len, m, l, alpha);  // acc is 0: nothing to rescale
      pack_p<64>(pa, sc);
      int held = s;
      for (int kt = 1; kt < nk; ++kt) {
        s = ++n % STAGES;
        hopper::mbar_wait(full(s), (n / STAGES) & 1);
        k_at = base + L::Q + s * L::STAGE;
        old_at = k_at + (WGS + 1 - w) * TILE;
        hopper::wgmma_fence();
        product_ss<64, D>(sc, qu_at, k_at);
        product_ss<64, D>(bd, qv_at, old_at + TILE);  // chunk kt + 1
        product_rs<D, 64>(acc, pa, base + L::Q + held * L::STAGE + TILE);  // o += P v
        hopper::wgmma_wait<1>();  // the scores and the band chunk are in
        hopper::fence_regs(sc);
        hopper::fence_regs(bd);
        scatter(bd, kt + 1);
        __syncwarp();
        softmax_tile(sc, kt, len, m, l, alpha);
        hopper::wgmma_wait<0>();  // the held tile's P v is in
        hopper::fence_regs(acc);
        hopper::fence_regs(pa);
        release(empty(held));
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt) {
          acc[dt][0] *= alpha[0];
          acc[dt][1] *= alpha[0];
          acc[dt][2] *= alpha[1];
          acc[dt][3] *= alpha[1];
        }
        pack_p<64>(pa, sc);
        held = s;
      }
      ++n;
      release(q_free);  // every product of the item that reads qu and qv is done
      hopper::wgmma_fence();
      product_rs<D, 64>(acc, pa, base + L::Q + held * L::STAGE + TILE);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      release(empty(held));
    } else {
      release(q_free);
    }

    // o = acc / l; lse = m scale + log l (a row with no valid key: o = 0,
    // lse = -1e30, as the fp32 path gives)
    float inv[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float lt = l[hh];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const float lv = fmaxf(lt, 1e-30f);
      inv[hh] = 1.f / lv;
      const int i = hh ? ib : ia;
      if (t == 0 && i < Tn)
        lse[((long long)b * H + h) * Tn + i] = (nk > 0 ? m[hh] * scale : NEG) + logf(lv);
    }
    flash::tc::store_rows<D / 8>(o + (long long)b * Tn * rs + (long long)h * D, acc, ia, ib, Tn,
                                 rs, t, inv);
    ++k;
  }
}

// ---- dh 128 (FastConformer-XL): fwd128_kernel.
//
// Why this shape: a block of one consumer warpgroup of 64 query rows (all
// that the dh-64 block's layout leaves room for at dh 128, with 2 stages of
// k, v and 128 rows of p) reads 64 KB into shared memory per key tile for 64
// x 64 scores, 16 bytes a score (~650 MB a launch at B=32, T'=376). On the
// H100 such a block took 0.163 ms, 0.105 of it in its loads alone (PERF.md
// §6), and its one math warpgroup left the tensor cores idle through each
// scatter and softmax.
//
// This kernel is the dh-64 block's shape: 384 threads, a producer warpgroup
// (24 registers after setmaxnreg, one thread at work) and two consumer
// warpgroups of 64 query rows (240 registers), an item 128 query rows of one
// (b, h), so k, v and the 192 rows of p of a key tile serve 128 rows (10
// bytes a score) and one warpgroup's products run under the other's softmax.
// At dh 128 the dh-64 block's q tiles (64 KB) do not fit beside two stages of
// 80 KB and the two G rings (64 KB): so qu and qv are never in shared memory.
// Each consumer thread loads its rows of qu and qv from device memory as the
// register A fragments of the products (flash_tiles.cuh:load_a; 64
// registers), and s = qu k^T and the band chunk qv p^T are wgmma RS with k and
// p K-major (hopper.cuh:product_rs_k). The next item's q is loaded as soon as
// the item's last s and band chunk are in, so its latency runs under the
// last tile's softmax, P v and the stores of o. Only two stages fit, and P v runs
// one tile behind, so a stage of k, v and p would go back one tile late and
// its next load would wait in the open: k and p (64 KB a key tile) and v (16
// KB) are two rings of 2 stages, and a key tile's k and p go back as soon as
// s and the band chunk are in, its v once P v is. Budget: shared memory the
// two rings (160 KB) and the two G rings (64 KB), 225 KB of 227; registers
// (consumers) q 64, o 64, scores 32, band chunk 32, P 16, no spill once the
// lane indices are laundered (tc::fresh). What bounds it now: not the loads
// (a loads-only copy takes under half its time) nor the tensor cores (they
// run ~30 % of the time), but each warpgroup's chain a tile, products, then
// the scatter and the softmax that wait on them, which the other warpgroup
// covers only in part (taking turns between them measured the same).
struct Layout128 {
  static constexpr int NT = 384;                  // producer, then two consumer warpgroups
  static constexpr int TQ = 128;                  // query rows an item, 64 a consumer warpgroup
  static constexpr int STAGES = 2;
  static constexpr uint32_t TILE = 2 * BOX64;     // 64 rows of 128 columns
  static constexpr uint32_t KP = 4 * TILE;        // a stage of the k, p ring: k, 192 rows of p
  static constexpr uint32_t V = STAGES * KP;      // the v ring
  static constexpr uint32_t G = V + STAGES * TILE;
  static constexpr uint32_t GBYTES = 64 * 128 * 4;  // a warpgroup's G ring
  static constexpr uint32_t BARS = G + 2 * GBYTES;  // k, p full and empty; v full and empty
  static constexpr uint32_t BYTES = BARS + 8 * 4 * STAGES + hopper::ATOM;  // + alignment
  static_assert(BYTES <= 232448, "K1 dh 128: more shared memory than a block can have");
};
constexpr int PRODUCER_REGS_128 = 24;   // 128 x 24 + 256 x 240 = 64,512 of the SM's 65,536
constexpr int CONSUMER_REGS_128 = 240;

__global__ void __launch_bounds__(Layout128::NT, 1) fwd128_kernel(
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tp, const bf16* __restrict__ qu,
    const bf16* __restrict__ qv, const int* __restrict__ lengths, bf16* __restrict__ o,
    float* __restrict__ lse, int B, int H, int Tn, float scale) {
  using L = Layout128;
  constexpr int D = 128, STAGES = L::STAGES, TQ = L::TQ;
  constexpr uint32_t TILE = L::TILE;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = (raw + hopper::ATOM - 1) & ~(hopper::ATOM - 1);
  uint8_t* const sm = smem_raw + (base - raw);
  auto full = [&](int s) { return base + L::BARS + 8 * s; };  // the k, p ring
  auto empty = [&](int s) { return base + L::BARS + 8 * (STAGES + s); };
  auto v_full = [&](int s) { return base + L::BARS + 8 * (2 * STAGES + s); };
  auto v_empty = [&](int s) { return base + L::BARS + 8 * (3 * STAGES + s); };

  // work item it: TQ query rows from i0 of head h, batch row b. The query
  // tiles of one (b, h) are consecutive items, so that blocks running at
  // once read the same k, v and p tiles and all but the first find them in
  // L2 (with the query tile outermost, as fwd_kernel orders them, k and v
  // came from device memory for every item at B=32: ~150 MB a launch)
  const int n_q = (Tn + TQ - 1) / TQ, n_items = n_q * H * B;
  auto item_of = [&](int it, int& i0, int& h, int& b) {
    const int bh = it / n_q;
    i0 = it % n_q * TQ;
    h = bh % H;
    b = bh / H;
  };
  auto length = [&](int b) { return min(max(lengths[b], 0), Tn); };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full(s), 1);     // the TMA bytes
      hopper::mbar_init(empty(s), 8);    // every consumer warp
      hopper::mbar_init(v_full(s), 1);
      hopper::mbar_init(v_empty(s), 8);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp < 4) {
    hopper::reg_dealloc<PRODUCER_REGS_128>();
    if (threadIdx.x != 0) return;
    int n = 0;  // stages filled
    for (int r = 0; r * (int)gridDim.x < n_items; ++r) {
      const int it = flash::tc::snake_item(r);
      if (it >= n_items) continue;
      int i0, h, b;
      item_of(it, i0, h, b);
      const int nk = (length(b) + 63) / 64;
      for (int kt = 0; kt < nk; ++kt, ++n) {
        const int s = n % STAGES, use = n / STAGES;
        if (use > 0) hopper::mbar_wait(empty(s), (use - 1) & 1);  // the stage is read out
        const uint32_t st = base + s * L::KP;
        hopper::mbar_arrive_tx(full(s), L::KP);
        for (int c = 0; c < 2; ++c) {
          hopper::tma_load_4d(st + c * BOX64, &tk, full(s), 64 * c, h, 64 * kt, b);
          for (int x = 0; x < 3; ++x)  // rows past either end of p read as zeros
            hopper::tma_load_4d(st + (1 + x) * TILE + c * BOX64, &tp, full(s), 64 * c, h,
                                Tn - TQ - i0 + 64 * kt + 64 * x, 0);
        }
        if (use > 0) hopper::mbar_wait(v_empty(s), (use - 1) & 1);
        hopper::mbar_arrive_tx(v_full(s), TILE);
        for (int c = 0; c < 2; ++c)
          hopper::tma_load_4d(base + L::V + s * TILE + c * BOX64, &tv, v_full(s), 64 * c, h,
                              64 * kt, b);
      }
    }
    return;
  }

  // consumer warpgroup w: query rows i0 + 64 w .. + 63 of each item; this
  // thread's local rows rl and rl + 8 (global ia, ib)
  hopper::reg_alloc<CONSUMER_REGS_128>();
  const int w = (warp >> 2) - 1, g = lane >> 2, t = lane & 3, rl = 16 * (warp & 3) + g;
  const float scale2 = scale * LOG2E;  // P = 2^((s - m) scale2), s and m in raw units
  const long long rs = (long long)H * D;
  float* const G = reinterpret_cast<float*>(sm + L::G + w * L::GBYTES);
  auto release = [&](uint32_t bar) {  // this warp is done with what `bar` guards
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(bar);
  };
  // the lane indices laundered at each use (tc::fresh), as in softmax_tile
  auto scatter = [&](const float (&bd)[8][4], int m) {
    relpos::scatter_band(G, bd, m, fresh(rl), fresh(g), fresh(t));
  };

  // as fwd_kernel's: tile kt's scores plus their band terms, masked, then the
  // online softmax (sc becomes P; m, l updated; alpha the rescale)
  auto softmax_tile = [&](float (&sc)[8][4], int kt, int len, float (&m)[2], float (&l)[2],
                          float (&alpha)[2]) {
    const int tf = fresh(t), gf = fresh(g), rf = fresh(rl);
    const float* grow[2] = {relpos::band_row(G, rf, kt), relpos::band_row(G, rf + 8, kt)};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float2 gv = *reinterpret_cast<const float2*>(grow[hh] + ((8 * nt + 2 * tf) ^ (8 * gf)));
        sc[nt][2 * hh] += gv.x;
        sc[nt][2 * hh + 1] += gv.y;
      }
    const int kmax = len - 64 * kt;  // keys c < kmax are valid
    if (__builtin_expect(kmax < 64, 0)) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = 8 * nt + 2 * tf + (e & 1) < kmax ? sc[nt][e] : NEG;
    }
    float mx[2][2] = {{NEG, NEG}, {NEG, NEG}};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1][nt & 1] = fmaxf(mx[e >> 1][nt & 1], sc[nt][e]);
    float ms2[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float x = fmaxf(mx[hh][0], mx[hh][1]);
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      const float m_new = fmaxf(m[hh], x);
      alpha[hh] = ex2((m[hh] - m_new) * scale2);
      ms2[hh] = m_new * scale2;
      m[hh] = m_new;
    }
    float ps[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[nt][e] = ex2(fmaf(sc[nt][e], scale2, -ms2[e >> 1]));
        ps[e >> 1][nt & 1] += sc[nt][e];
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * alpha[hh] + (ps[hh][0] + ps[hh][1]);
  };

  uint32_t quf[8][4], qvf[8][4];  // this warpgroup's rows of qu and qv as A fragments
  auto load_q = [&](int it) {
    int i0, h, b;
    item_of(it, i0, h, b);
    const long long off = (long long)b * Tn * rs + (long long)h * D;
    const int ia = i0 + 64 * w + rl;
    flash::tc::load_a<D>(quf, qu + off, ia, ia + 8, Tn, rs, t);
    flash::tc::load_a<D>(qvf, qv + off, ia, ia + 8, Tn, rs, t);
  };
  // the item of round r + 1, once every product of round r's that reads q
  // is done: its loads run under the item's last softmax and epilogue
  auto load_next_q = [&](int r) {
    const int nx = flash::tc::snake_item(r + 1);
    if ((r + 1) * (int)gridDim.x < n_items && nx < n_items) load_q(nx);
  };
  load_q(flash::tc::snake_item(0));  // round 0's item is block x's: x < gridDim.x <= n_items
  int n = 0;  // stages consumed
  for (int r = 0; r * (int)gridDim.x < n_items; ++r) {
    const int it = flash::tc::snake_item(r);
    if (it >= n_items) continue;
    int i0, h, b;
    item_of(it, i0, h, b);
    const int len = length(b), nk = (len + 63) / 64;
    const int ia = i0 + 64 * w + rl, ib = ia + 8;
    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, acc[D / 8][4], sc[8][4], bd[8][4], alpha[2];
    uint32_t pa[4][4];  // the held tile's probabilities as A fragments
    flash::tc::zero<D / 8>(acc);
    if (nk > 0) {
      // as fwd_kernel's: P v one tile behind, the first tile peeled
      int s = n % STAGES;
      hopper::mbar_wait(full(s), (n / STAGES) & 1);
      uint32_t k_at = base + s * L::KP;
      uint32_t old_at = k_at + (2 - w) * TILE;  // chunk kt of this warpgroup; kt + 1 follows
      hopper::wgmma_fence();
      hopper::product_rs_k<64, D>(bd, qvf, old_at);  // chunk 0
      hopper::wgmma_wait<0>();
      hopper::fence_regs(bd);
      scatter(bd, 0);
      hopper::wgmma_fence();
      hopper::product_rs_k<64, D>(sc, quf, k_at);           // s = qu k^T
      hopper::product_rs_k<64, D>(bd, qvf, old_at + TILE);  // chunk 1 of qv p^T
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      hopper::fence_regs(bd);
      release(empty(s));  // the tile's k and p are read out
      if (nk == 1) load_next_q(r);
      scatter(bd, 1);
      __syncwarp();
      softmax_tile(sc, 0, len, m, l, alpha);  // acc is 0: nothing to rescale
      pack_p<64>(pa, sc);
      int held = s;  // the v stage of the tile whose P v is to come
      for (int kt = 1; kt < nk; ++kt) {
        s = ++n % STAGES;
        hopper::mbar_wait(full(s), (n / STAGES) & 1);
        hopper::mbar_wait(v_full(held), ((n - 1) / STAGES) & 1);
        k_at = base + s * L::KP;
        old_at = k_at + (2 - w) * TILE;
        hopper::wgmma_fence();
        hopper::product_rs_k<64, D>(sc, quf, k_at);
        hopper::product_rs_k<64, D>(bd, qvf, old_at + TILE);  // chunk kt + 1
        product_rs<D, 64>(acc, pa, base + L::V + held * TILE);  // o += P v
        hopper::wgmma_wait<1>();  // the scores and the band chunk are in
        hopper::fence_regs(sc);
        hopper::fence_regs(bd);
        release(empty(s));
        if (kt == nk - 1) load_next_q(r);  // no product of the item reads q any more
        scatter(bd, kt + 1);
        __syncwarp();
        softmax_tile(sc, kt, len, m, l, alpha);
        hopper::wgmma_wait<0>();  // the held tile's P v is in
        hopper::fence_regs(acc);
        hopper::fence_regs(pa);
        release(v_empty(held));
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt) {
          acc[dt][0] *= alpha[0];
          acc[dt][1] *= alpha[0];
          acc[dt][2] *= alpha[1];
          acc[dt][3] *= alpha[1];
        }
        pack_p<64>(pa, sc);
        held = s;
      }
      hopper::mbar_wait(v_full(held), (n / STAGES) & 1);
      ++n;
      hopper::wgmma_fence();
      product_rs<D, 64>(acc, pa, base + L::V + held * TILE);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      release(v_empty(held));
    }
    if (nk == 0) load_next_q(r);

    // o = acc / l; lse = m scale + log l (as fwd_kernel's)
    float inv[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float lt = l[hh];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const float lv = fmaxf(lt, 1e-30f);
      inv[hh] = 1.f / lv;
      const int i = hh ? ib : ia;
      if (t == 0 && i < Tn)
        lse[((long long)b * H + h) * Tn + i] = (nk > 0 ? m[hh] * scale : NEG) + logf(lv);
    }
    flash::tc::store_rows<D / 8>(o + (long long)b * Tn * rs + (long long)h * D, acc, ia, ib, Tn,
                                 rs, t, inv);
  }
}

int launch128(const void* qu, const void* qv, const void* k, const void* v, const void* p,
              const int* lengths, void* o, float* lse, int B, int H, int Tn, float scale,
              cudaStream_t stream) {
  CUtensorMap mk, mv, mp;
  int err = hopper::encode_bthd(&mk, k, B, Tn, H, 128, 64);
  if (err == 0) err = hopper::encode_bthd(&mv, v, B, Tn, H, 128, 64);
  if (err == 0) err = hopper::encode_bthd(&mp, p, 1, 2 * Tn - 1, H, 128, 64);
  int grid = 0;
  if (err == 0) err = flash::persistent_grid((Tn + Layout128::TQ - 1) / Layout128::TQ * H * B, grid);
  if (err != 0) return err;
  const bf16 *pqu = static_cast<const bf16*>(qu), *pqv = static_cast<const bf16*>(qv);
  bf16* out = static_cast<bf16*>(o);
  void* args[] = {&mk, &mv, &mp, &pqu, &pqv, &lengths, &out, &lse, &B, &H, &Tn, &scale};
  return flash::launch(fwd128_kernel, Layout128::BYTES, Layout128::NT, grid, 1, 1, stream, args);
}

// the tensor maps and the launch, on a persistent grid
template <int D>
int launch(const void* qu, const void* qv, const void* k, const void* v, const void* p,
           const int* lengths, void* o, float* lse, int B, int H, int Tn, float scale,
           cudaStream_t stream) {
  using L = Layout<D>;
  CUtensorMap mqu, mqv, mk, mv, mp;
  int err = hopper::encode_bthd(&mqu, qu, B, Tn, H, D, 64);
  if (err == 0) err = hopper::encode_bthd(&mqv, qv, B, Tn, H, D, 64);
  if (err == 0) err = hopper::encode_bthd(&mk, k, B, Tn, H, D, 64);
  if (err == 0) err = hopper::encode_bthd(&mv, v, B, Tn, H, D, 64);
  if (err == 0) err = hopper::encode_bthd(&mp, p, 1, 2 * Tn - 1, H, D, 64);
  int grid = 0;
  if (err == 0) err = flash::persistent_grid((Tn + L::TQ - 1) / L::TQ * H * B, grid);
  if (err != 0) return err;
  bf16* out = static_cast<bf16*>(o);
  void* args[] = {&mqu, &mqv, &mk, &mv, &mp, &lengths, &out, &lse, &B, &H, &Tn, &scale};
  return flash::launch(fwd_kernel<D>, L::BYTES, L::NT, grid, 1, 1, stream, args);
}

}  // namespace wg

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
// 64 or 128. Returns a cudaError_t.
extern "C" int relpos_flash_fwd(int dtype, const void* qu, const void* qv, const void* k,
                                const void* v, const void* p, const void* lengths, void* o,
                                void* lse, int B, int H, int Tn, int head_dim, float scale,
                                void* stream) {
  if ((head_dim != 64 && head_dim != 128) || B <= 0 || H <= 0 || Tn <= 0)
    return (int)cudaErrorInvalidValue;
  const int* len = static_cast<const int*>(lengths);
  float* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return head_dim == 64
               ? launch<float>(f32::kernel<64>, f32::smem<64>(), f32::NT, qu, qv, k, v, p, len,
                               o, l, B, H, Tn, scale, s)
               : launch<float>(f32::kernel<128>, f32::smem<128>(), f32::NT, qu, qv, k, v, p,
                               len, o, l, B, H, Tn, scale, s);
  if (dtype == 1) {
    const void* tensors[] = {qu, qv, k, v, p, o};
    for (const void* ptr : tensors)
      if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return (int)cudaErrorMisalignedAddress;
    return head_dim == 64 ? wg::launch<64>(qu, qv, k, v, p, len, o, l, B, H, Tn, scale, s)
                          : wg::launch128(qu, qv, k, v, p, len, o, l, B, H, Tn, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The launch shape of the bf16 kernel at head_dim 64 or 128 into out[6]:
// threads a block, consumer warpgroups, blocks a cluster, dynamic shared
// memory bytes, and cudaFuncGetAttributes' registers a thread (at launch,
// before setmaxnreg moves them between warpgroups) and local memory bytes a
// thread (spills). Returns a cudaError_t.
extern "C" int relpos_flash_fwd_shape(int head_dim, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err;
  if (head_dim == 64) {
    err = cudaFuncGetAttributes(&attr, wg::fwd_kernel<64>);
    out[0] = wg::Layout<64>::NT, out[1] = wg::Layout<64>::WGS, out[3] = wg::Layout<64>::BYTES;
  } else if (head_dim == 128) {
    err = cudaFuncGetAttributes(&attr, wg::fwd128_kernel);
    out[0] = wg::Layout128::NT, out[1] = 2, out[3] = wg::Layout128::BYTES;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  out[2] = 1;
  out[4] = attr.numRegs;
  out[5] = (int)attr.localSizeBytes;
  return (int)err;
}
