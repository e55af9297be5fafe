// Causal / sliding-window GQA flash attention forward for Hopper (sm_90a),
// fp32 or bf16 inputs, head width D in {64, 96, 128}: K5, K8, its form over
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
// One block owns (b, h, a tile of query rows) and loops over the key tiles
// that hold an unmasked pair (_block_active: from the window's first tile to
// the diagonal), with an online softmax; only boundary tiles (_needs_mask)
// are masked element by element. Causal, that is half the tiles at T = 2048.
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
// - bf16 (the main path; csrc/hopper.cuh): a block of 384 threads owns 128
//   query rows of one (b, h): two consumer warpgroups of 64 rows and a
//   producer warpgroup, which hands its registers to them (setmaxnreg: 224
//   a consumer thread, no spills) and works in one warp. The producer walks
//   the key tiles (128 keys at D = 64, 64 at D = 96 and 128), 32 at a time,
//   decides which to visit and which need the element mask (the tile tests
//   of Mask and Pairs at each warpgroup's 64 rows; the policies' 64-key
//   [min, max] entries merged two at a time where a tile holds 128), and
//   loads q once and each
//   visited tile's k and v by TMA into a ring of 3 shared-memory stages in
//   the 128-byte swizzle, each completed on an mbarrier, with the tile's
//   index and mask flags beside it; the consumers hand a stage back on
//   another mbarrier, so the next tiles are in flight while one is
//   computed. A consumer computes s = q k^T with wgmma from shared memory
//   (both operands K-major), masks an edge tile from each row's kept key
//   range (Mask::row_keys) and kept values (Pairs::kept), takes the online
//   softmax in registers (exp2 with the scale folded into one FMA), rounds P
//   to bf16 straight from the score registers (as flash_attention.py:131
//   rounds p to v's dtype) and adds P v with wgmma, P as register A
//   fragments and v MN-major (the transposed-B bit), issued right after the
//   next tile's q k^T. The grid is persistent, a block a multiprocessor
//   (K5, K8; K11 takes a block an item), each taking one work item (b, h,
//   128 rows) a round, the later query tiles over every (b, h) first, in a
//   snake order; q is double-buffered, so the next item's q and first tiles
//   load while this item ends. D = 96 (Phi-3-mini) takes D = 128's tiles
//   (flash_tiles.cuh:padded): q, k and v come as two boxes of 64 columns, the
//   second zero past column 96; q k^T takes only the 6 nonzero steps of 16
//   columns, and P v is an m64n96k16 product (hopper.cuh:wgmma_rs_n96)
//   into 96 columns of accumulators.
// - fp32 (the exactness check): scalar FMAs from shared-memory tiles, 16 x 16
//   threads with 4 x 4 scores each, 64-row blocks.
//
// Layouts: q, o [B, Tq, H, D]; k, v [B, Tkv, G, D]; lse [B, H, Tq] fp32;
// segment ids [B, T] int32 and their tile ranges [B, ceil(T / 64), 2] int32;
// positions [Tq], [Tkv] int32 and their tile ranges [ceil(T / 64), 2].

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "flash_tiles.cuh"
#include "hopper.cuh"

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

// shared memory, floats: Q^T, K^T (reused for the probabilities), V at the
// padded width DP (whole groups of 64 columns, zeros past D)
template <int D>
constexpr size_t smem() { return (2 * D * LDT + BKV * flash::padded(D)) * sizeof(float); }

template <int D, int M>
__global__ void __launch_bounds__(NT) fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const int* __restrict__ qv, const int* __restrict__ kv, const int* __restrict__ qr,
    const int* __restrict__ kr, float* __restrict__ o, float* __restrict__ lse, int H, int G,
    int Tq, int Tkv, float scale, int causal, int window) {
  constexpr int DP = flash::padded(D), NC = DP / 64;  // column groups of 64 per thread
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // [D][LDT]
  float* sK = sQ + D * LDT;                      // [D][LDT]; then probabilities [BKV][LDT]
  float* sV = sK + D * LDT;                      // [BKV][DP], zeros past column D
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
    for (int idx = tid; idx < BKV * DP; idx += NT) {
      const int r = idx / DP, d = idx % DP, j = j0 + r;
      float a = 0.f, c = 0.f;
      if (j < Tkv && d < D) {
        a = k[koff + j * rk + d];
        c = v[koff + j * rk + d];
      }
      if (d < D) sK[d * LDT + r] = a;
      sV[r * DP + d] = c;
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
        const float4 vv = *reinterpret_cast<const float4*>(&sV[j * DP + 64 * c + 4 * tx]);
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
      if (64 * c + 4 * tx < D) {  // the padded columns are not written
#pragma unroll
        for (int dd = 0; dd < 4; ++dd)
          o[qoff + i * rq + 64 * c + 4 * tx + dd] = acc[ii][4 * c + dd] * inv;
      }
    if (tx == 0) lse[((long long)b * H + h) * Tq + i] = dead ? NEG : m[ii] + logf(lv);
  }
}

}  // namespace f32

// ------------------------------------------------ bf16 path: TMA and wgmma

namespace wg {

using bf16 = __nv_bfloat16;
using hopper::ATOM;
using flash::tc::ex2;
using flash::tc::pack_p;

constexpr int WGS = 2;                // consumer warpgroups, 64 query rows each
constexpr int TQ = 64 * WGS;          // query rows a block
constexpr int NT = 128 * (WGS + 1);   // and a producer warpgroup, one warp of it at work
constexpr int STAGES = 3;             // K/V tiles in flight
constexpr int PRODUCER_REGS = 56;     // registers a thread, after the split (setmaxnreg):
constexpr int CONSUMER_REGS = 224;    // 128 x 56 + 256 x 224 <= 384 x 168 at launch
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory, in bytes from a 1024-aligned base: two q buffers (one
// box of 64 rows x 64 columns per warpgroup and 64 columns of DP), so that
// the next work item's q loads while this one's is read; STAGES stages of k
// and v (DP / 64 boxes of TK keys each); the mbarriers (q loaded[2], q
// free[2], full[STAGES], empty[STAGES]); the keys' ids or positions of each
// stage; and each stage's tile: its index (-1: the item has no more tiles)
// and which warpgroups need the element mask there (bit w).
template <int D>
struct Layout {
  static constexpr int DP = flash::padded(D);     // columns of a row in shared memory
  static constexpr int TK = DP == 64 ? 128 : 64;  // keys a tile, as the registers allow
  static constexpr int NB = DP / 64;              // boxes a row
  static constexpr uint32_t QBOX = 64 * hopper::BOX_ROW_BYTES;
  static constexpr uint32_t KBOX = TK * hopper::BOX_ROW_BYTES;
  static constexpr uint32_t QBUF = WGS * NB * QBOX;
  static constexpr uint32_t KV = 2 * QBUF;
  static constexpr uint32_t STAGE = 2 * NB * KBOX;  // k boxes, then v boxes
  static constexpr uint32_t BARS = KV + STAGES * STAGE;
  static constexpr uint32_t IDS = BARS + 8 * (4 + 2 * STAGES);
  static constexpr uint32_t INFO = IDS + STAGES * TK * 4;
  static constexpr uint32_t BYTES = INFO + STAGES * 8 + ATOM;  // + the alignment slack
};

// Work item `it` -> its 128 query rows from i0, head h, batch row b: the
// last query tiles (the most key tiles) first, over every (b, h);
// neighbouring items share a kv head. Blocks take them in a snake
// (flash_tiles.cuh:snake_item).
struct Item {
  int i0, h, b;
};
__device__ __forceinline__ Item item_of(int it, int n_q, int H, int B) {
  const int rem = it % (H * B);
  return {(n_q - 1 - it / (H * B)) * TQ, rem % H, rem / H};
}

// One tile's online softmax in this thread's registers: the raw scores sc
// (rows ia, ib as e / 2 = 0, 1; key 8 nt + 2 t + e % 2 of the tile) become
// the probabilities p = 2^((s - m_safe) * scale2). Where `edge`, masked pairs
// are set to -1e30 first: a key outside its row's [klo, khi] (offsets from
// the tile's key 2 t) or, under a policy, whose value (kid, from key 2 t) is
// outside the row's kept values [vlo, vhi]. The running max m (raw units)
// and this lane's share of the sum l are updated; alpha is the factor the
// rows' accumulators take. m_safe = max(m, -5e29) keeps a row with no kept
// key yet at p = 0.
template <int TK, int M>
__device__ __forceinline__ void softmax_tile(float (&sc)[TK / 8][4], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], bool edge, const int (&klo)[2],
                                             const int (&khi)[2], const int* kid,
                                             const int (&vlo)[2], const int (&vhi)[2],
                                             float scale2) {
  if (__builtin_expect(edge, 0)) {
#pragma unroll
    for (int nt = 0; nt < TK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jr = 8 * nt + (e & 1), hh = e >> 1;
        bool keep = jr >= klo[hh] && jr <= khi[hh];
        if constexpr (M != PLAIN) keep = keep && kid[jr] >= vlo[hh] && kid[jr] <= vhi[hh];
        sc[nt][e] = keep ? sc[nt][e] : NEG;
      }
  }
  float mx[2][2] = {{NEG, NEG}, {NEG, NEG}};  // [row][even, odd block]: two chains
#pragma unroll
  for (int nt = 0; nt < TK / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      mx[e >> 1][nt & 1] = fmaxf(mx[e >> 1][nt & 1], sc[nt][e]);
  float ms2[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {  // over the 4 lanes that share a row
    float r = fmaxf(mx[hh][0], mx[hh][1]);
    r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 1));
    r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 2));
    const float m_new = fmaxf(m[hh], r), m_safe = fmaxf(m_new, NEG_HALF);
    alpha[hh] = ex2((fmaxf(m[hh], NEG_HALF) - m_safe) * scale2);
    ms2[hh] = m_safe * scale2;
    m[hh] = m_new;
  }
  float ps[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int nt = 0; nt < TK / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[nt][e] = ex2(fmaf(sc[nt][e], scale2, -ms2[e >> 1]));
      ps[e >> 1][nt & 1] += sc[nt][e];
    }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * alpha[hh] + (ps[hh][0] + ps[hh][1]);
}

template <int N>
__device__ __forceinline__ void rescale(float (&acc)[N][4], const float (&alpha)[2]) {
#pragma unroll
  for (int dt = 0; dt < N; ++dt) {
    acc[dt][0] *= alpha[0];
    acc[dt][1] *= alpha[0];
    acc[dt][2] *= alpha[1];
    acc[dt][3] *= alpha[1];
  }
}

template <int D, int M>
__global__ void __launch_bounds__(NT, 1) fwd_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const int* __restrict__ qv,
    const int* __restrict__ kv, const int* __restrict__ qr, const int* __restrict__ kr,
    bf16* __restrict__ o, float* __restrict__ lse, int B, int H, int G, int Tq, int Tkv,
    float scale, int causal, int window) {
  using L = Layout<D>;
  constexpr int TK = L::TK, NB = L::NB;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = (raw + ATOM - 1) & ~(ATOM - 1);
  int* ids = reinterpret_cast<int*>(smem_raw + (base - raw) + L::IDS);
  int2* info = reinterpret_cast<int2*>(smem_raw + (base - raw) + L::INFO);
  auto q_loaded = [&](int qb) { return base + L::BARS + 8 * qb; };
  auto q_free = [&](int qb) { return base + L::BARS + 8 * (2 + qb); };
  auto full = [&](int s) { return base + L::BARS + 8 * (4 + s); };
  auto empty = [&](int s) { return base + L::BARS + 8 * (4 + STAGES + s); };

  // a persistent grid: a block takes one work item a round (snake_item)
  const int n_q = (Tq + TQ - 1) / TQ, n_items = n_q * H * B;
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
    // The producer warpgroup gives its registers to the consumers; its
    // first warp decides each item's tiles: it walks key tiles [lo, hi], 32
    // at a time (a tile a lane, then a ballot: under a policy the walk may
    // cross every key tile, each test reading the tile ranges, and ended
    // the items' time one tile at a time), and visits those that a
    // warpgroup's 64 rows may keep a pair of. For each
    // it loads k and v by TMA into the next stage (lane 0), the keys' ids or
    // positions where a warpgroup masks the tile (all lanes: loads on the
    // producer's path, so only there), and the stage's info; then
    // a stage with tile -1 ends the item. Both warpgroups compute every
    // visited tile: one a warpgroup does not meet is masked whole, which
    // leaves its rows' state as it was, bit for bit.
    hopper::reg_dealloc<PRODUCER_REGS>();
    if (warp != 0) return;
    int n = 0, k = 0;  // stages filled, items taken
    for (int r = 0; r * (int)gridDim.x < n_items; ++r) {
      const int it = flash::tc::snake_item(r);
      if (it >= n_items) continue;
      const Item item = item_of(it, n_q, H, B);
      const int i0 = item.i0, hk = item.h * G / H, qb = k & 1;
      const Pairs<M> pr = flash::pairs_of<M>(qv, kv, qr, kr, item.b, Tq, Tkv, causal, window);
      auto meets = [&](int r0, int kt) {
        if (r0 >= Tq) return false;
        int lo, hi;
        mask.kv_range<64, TK>(r0, lo, hi);
        return kt >= lo && kt <= hi && pr.template active<TK>(r0, kt * TK);
      };
      if (lane == 0) {  // q into buffer qb, once the item before last is done with it
        if (k >= 2) hopper::mbar_wait(q_free(qb), ((k >> 1) - 1) & 1);
        hopper::mbar_arrive_tx(q_loaded(qb), L::QBUF);
        for (int w = 0; w < WGS; ++w)
          for (int c = 0; c < NB; ++c)
            hopper::tma_load_4d(base + qb * L::QBUF + (w * NB + c) * L::QBOX, &tq,
                                q_loaded(qb), 64 * c, item.h, i0 + 64 * w, item.b);
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
              hopper::tma_load_4d(st + c * L::KBOX, &tk, full(s), 64 * c, hk, kt * TK, item.b);
              hopper::tma_load_4d(st + (NB + c) * L::KBOX, &tv, full(s), 64 * c, hk, kt * TK,
                                  item.b);
            }
          }
        }
        if constexpr (M != PLAIN) hopper::mbar_arrive(full(s));
      };
      // the walk, 32 tiles at a time: lane l tests tile kt0 + l
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
  const float scale2 = scale * LOG2E;  // p = 2^((s - m) * scale2)
  const uint32_t k0 = base + L::KV, v0 = k0 + NB * L::KBOX;
  auto release = [&](uint32_t bar) {  // this warp is done with what `bar` guards
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(bar);
  };

  int n = 0, k = 0;  // stages consumed, items taken
  for (int r = 0; r * (int)gridDim.x < n_items; ++r) {
    const int it = flash::tc::snake_item(r);
    if (it >= n_items) continue;
    const Item item = item_of(it, n_q, H, B);
    const Pairs<M> pr = flash::pairs_of<M>(qv, kv, qr, kr, item.b, Tq, Tkv, causal, window);
    const int r0 = item.i0 + 64 * w, ia = r0 + 16 * (warp & 3) + g, ib = ia + 8, qb = k & 1;
    int rlo[2], rhi[2], vlo[2], vhi[2];  // the keys and key values that rows ia, ib keep
    mask.row_keys(ia, rlo[0], rhi[0]);
    mask.row_keys(ib, rlo[1], rhi[1]);
    pr.kept(pr.qid(ia), vlo[0], vhi[0]);
    pr.kept(pr.qid(ib), vlo[1], vhi[1]);
    const uint32_t q_at = base + qb * L::QBUF + w * NB * L::QBOX;
    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, acc[D / 8][4], sc[TK / 8][4], alpha[2];
    uint32_t pa[TK / 16][4];  // the probabilities of the held tile as A fragments
    flash::tc::zero<D / 8>(acc);
    // stage s's tile (-1: no more), whether this warpgroup masks it, and each
    // row's kept keys as offsets from the tile's key 2 t
    auto tile = [&](int s, bool& edge, int (&klo)[2], int (&khi)[2], const int*& kid) {
      const int2 in = info[s];
      edge = (in.y >> w) & 1;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        klo[hh] = rlo[hh] - in.x * TK - 2 * t;
        khi[hh] = rhi[hh] - in.x * TK - 2 * t;
      }
      kid = ids + s * TK + 2 * t;
      return in.x;
    };

    // One tile behind: the product P v of a tile is issued right after the
    // next tile's q k^T, so the two run back to back on the tensor cores (8 %
    // faster than a tile at a time on the H100); the tile's stage goes back
    // once its product is done. The first tile is peeled. (ptxas places the
    // second wait before the softmax, so the softmax does not overlap P v
    // within a warpgroup; pinning it after did not pay. The two warpgroups
    // overlap each other's softmax and products.)
    bool edge;
    int klo[2], khi[2];
    const int* kid;
    hopper::mbar_wait(q_loaded(qb), (k >> 1) & 1);
    int s = n % STAGES;
    hopper::mbar_wait(full(s), (n / STAGES) & 1);
    if (tile(s, edge, klo, khi, kid) >= 0) {
      hopper::wgmma_fence();
      hopper::product_ss<TK, D>(sc, q_at, k0 + s * L::STAGE);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      softmax_tile<TK, M>(sc, m, l, alpha, edge, klo, khi, kid, vlo, vhi, scale2);
      pack_p<TK>(pa, sc);  // acc is 0: nothing to rescale
      int held = s;
      for (;;) {
        s = ++n % STAGES;
        hopper::mbar_wait(full(s), (n / STAGES) & 1);
        if (tile(s, edge, klo, khi, kid) < 0) break;
        hopper::wgmma_fence();
        hopper::product_ss<TK, D>(sc, q_at, k0 + s * L::STAGE);
        hopper::product_rs<D, TK>(acc, pa, v0 + held * L::STAGE);
        hopper::wgmma_wait<1>();  // the scores are in
        hopper::fence_regs(sc);
        softmax_tile<TK, M>(sc, m, l, alpha, edge, klo, khi, kid, vlo, vhi, scale2);
        hopper::wgmma_wait<0>();  // the held tile's product is in
        hopper::fence_regs(acc);
        hopper::fence_regs(pa);
        release(empty(held));
        rescale<D / 8>(acc, alpha);
        pack_p<TK>(pa, sc);
        held = s;
      }
      release(q_free(qb));  // every q k^T of the item is done
      hopper::wgmma_fence();
      hopper::product_rs<D, TK>(acc, pa, v0 + held * L::STAGE);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      release(empty(held));
    } else {
      release(q_free(qb));
    }
    release(empty(s));  // the stage that ended the item
    ++n;

    // a row that kept no key (padding, or no key in range): o = 0 and lse = -1e30
    const long long rq = (long long)H * D;
    const long long qoff = (long long)item.b * Tq * rq + (long long)item.h * D;
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
      if (t == 0 && i < Tq)
        lse[((long long)item.b * H + item.h) * Tq + i] = dead ? NEG : m[hh] * scale + logf(lv);
    }
    flash::tc::store_rows<D / 8>(o + qoff, acc, ia, ib, Tq, rq, t, inv);
    ++k;
  }
}

// the three tensor maps (q by 64 rows, k and v by TK keys) and the launch
template <int D, int M>
int launch(void* q, void* k, void* v, void* qv, void* kv, void* qr, void* kr, void* o, void* lse,
           int B, int H, int G, int Tq, int Tkv, float scale, int causal, int window,
           cudaStream_t stream) {
  using L = Layout<D>;
  CUtensorMap mq, mk, mv;
  int err = hopper::encode_bthd(&mq, q, B, Tq, H, D, 64);
  if (err == 0) err = hopper::encode_bthd(&mk, k, B, Tkv, G, D, L::TK);
  if (err == 0) err = hopper::encode_bthd(&mv, v, B, Tkv, G, D, L::TK);
  if (err != 0) return err;
  void* args[] = {&mq, &mk, &mv, &qv, &kv,    &qr,     &kr,    &o,  &lse,
                  &B,  &H,  &G,  &Tq, &Tkv, &scale, &causal, &window};
  // One block a multiprocessor (or an item, where there are fewer items).
  // Under positions (K11) one block an item: the persistent grid measured
  // 7-9 % slower there on the H100 (0.94 ms against 0.87 at one CP rank's
  // shape), where it is 12-16 % faster for K5 and K8.
  const int n_items = (Tq + TQ - 1) / TQ * H * B;
  int grid = n_items;
  if constexpr (M != flash::POS) {
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    grid = n_items < sms ? n_items : sms;
  }
  return flash::launch(fwd_kernel<D, M>, L::BYTES, NT, grid, 1, 1, stream, args);
}

}  // namespace wg

template <int M>
int fwd_entry(int dtype, void* q, void* k, void* v, void* qv, void* kv, void* qr, void* kr,
              void* o, void* lse, int B, int H, int G, int Tq, int Tkv, int head_dim,
              float scale, int causal, int window, void* stream) {
  if (!flash::valid_shape(B, H, G, Tq, Tkv, head_dim, window) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* bf[] = {q, k, v, o};
  if (dtype == 1 && !flash::aligned16(bf, 4)) return (int)cudaErrorMisalignedAddress;
  void* args[] = {&q,  &k, &v,  &qv,  &kv,    &qr,     &kr,    &o,
                  &lse, &H, &G, &Tq, &Tkv, &scale, &causal, &window};
  const int n_q = (Tq + BQ - 1) / BQ;
  return flash::with_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    if (dtype == 1)
      return wg::launch<D, M>(q, k, v, qv, kv, qr, kr, o, lse, B, H, G, Tq, Tkv, scale, causal,
                              window, s);
    return flash::launch(f32::fwd_kernel<D, M>, f32::smem<D>(), f32::NT, n_q, H, B, s, args);
  });
}

}  // namespace

// K5. dtype: 0 = float32, 1 = bfloat16 (every tensor 16-byte aligned).
// head_dim 64, 96 or 128; causal 0/1; window 0 = none. o [B, T, H, D] in the
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
