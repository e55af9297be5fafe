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
//   shared memory (q 64 KB, 3 stages of 80 KB, the G rings 64 KB): a block
//   there is one consumer warpgroup of 64 query rows and the producer (256
//   threads, no setmaxnreg: ptxas may take 255 registers a thread for the 64
//   x 128 fp32 o accumulator beside the scores, the band chunk and P), with 2
//   stages of k, v and the 128 rows of p (192 KB in all).
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
using flash::tc::pack_p;
using hopper::product_rs;
using hopper::product_ss;

constexpr int PRODUCER_REGS = 40;    // registers a thread, after the split (setmaxnreg) at
constexpr int CONSUMER_REGS = 232;   // dh 64: 128 x 40 + 256 x 232 = 384 x 168 at launch
constexpr float LOG2E = 1.4426950408889634f;
constexpr uint32_t BOX64 = 64 * hopper::BOX_ROW_BYTES;  // a bf16 box of 64 rows, 8 KB

// A block owns TQ = 64 WGS query rows of one (b, h), a consumer warpgroup 64
// of them (rows i0 + 64 w), in a persistent grid over the (query tile, h, b)
// items. The producer's first thread loads qu and qv once an item and, per
// key tile kt of 64 keys up to the last valid key, k, v and the 64 (WGS + 1)
// rows of p from T - TQ - i0 + 64 kt (the warpgroups' band chunks kt and kt
// + 1, which overlap) by TMA into a ring of stages; rows before p's first or
// past its last read as zeros. A 64-row tile of D columns is D / 64 boxes of
// 64 columns, one after the other.
//
// The band (relpos_band.cuh, shared with K3): warpgroup w's chunk kt of qv
// p^T reads the stage's p rows from box WGS - 1 - w, chunk kt + 1 the next
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
// dh 64: two consumer warpgroups (384 threads, setmaxnreg), 3 stages (~217
// KB). dh 128: one consumer warpgroup (256 threads; its 64 x 128 o
// accumulator takes 64 registers more), 2 stages (~193 KB): three stages or
// a second warpgroup's q and G ring would pass the 227 KB a block can have.
template <int D>
struct Layout {
  static constexpr int WGS = D == 64 ? 2 : 1;   // consumer warpgroups, 64 query rows each
  static constexpr int NT = 128 * (WGS + 1);    // and a producer warpgroup, one thread at work
  static constexpr int TQ = 64 * WGS;           // query rows an item
  static constexpr int NB = D / 64;             // boxes a row
  static constexpr int STAGES = D == 64 ? 3 : 2;
  static constexpr uint32_t TILE = NB * BOX64;  // 64 rows of D columns
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
  constexpr int STAGES = L::STAGES, WGS = L::WGS, TQ = L::TQ, NB = L::NB;
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
    if constexpr (WGS == 2) hopper::reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x != 0) return;
    int n = 0, k = 0;  // stages filled, items taken
    for (int r = 0; r * (int)gridDim.x < n_items; ++r) {
      const int it = flash::tc::snake_item(r);
      if (it >= n_items) continue;
      int i0, h, b;
      item_of(it, i0, h, b);
      if (k > 0) hopper::mbar_wait(q_free, (k - 1) & 1);  // the last item is done with q
      hopper::mbar_arrive_tx(q_loaded, L::Q);
      for (int w = 0; w < WGS; ++w)
        for (int c = 0; c < NB; ++c) {
          hopper::tma_load_4d(base + w * TILE + c * BOX64, &tqu, q_loaded, 64 * c, h,
                              i0 + 64 * w, b);
          hopper::tma_load_4d(base + (WGS + w) * TILE + c * BOX64, &tqv, q_loaded, 64 * c, h,
                              i0 + 64 * w, b);
        }
      const int nk = (length(b) + 63) / 64;
      for (int kt = 0; kt < nk; ++kt, ++n) {
        const int s = n % STAGES, use = n / STAGES;
        if (use > 0) hopper::mbar_wait(empty(s), (use - 1) & 1);  // the stage is read out
        const uint32_t st = base + L::Q + s * L::STAGE;
        hopper::mbar_arrive_tx(full(s), L::STAGE);
        for (int c = 0; c < NB; ++c) {
          hopper::tma_load_4d(st + c * BOX64, &tk, full(s), 64 * c, h, 64 * kt, b);
          hopper::tma_load_4d(st + TILE + c * BOX64, &tv, full(s), 64 * c, h, 64 * kt, b);
          for (int x = 0; x <= WGS; ++x)  // rows past either end of p read as zeros
            hopper::tma_load_4d(st + (2 + x) * TILE + c * BOX64, &tp, full(s), 64 * c, h,
                                Tn - TQ - i0 + 64 * kt + 64 * x, 0);
        }
      }
      ++k;
    }
    return;
  }

  // consumer warpgroup w: query rows i0 + 64 w .. + 63 of each item; this
  // thread's local rows rl and rl + 8 (global ia, ib)
  if constexpr (WGS == 2) hopper::reg_alloc<CONSUMER_REGS>();
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
                          : wg::launch<128>(qu, qv, k, v, p, len, o, l, B, H, Tn, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}
