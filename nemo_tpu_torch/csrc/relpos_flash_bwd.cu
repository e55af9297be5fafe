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
// Both recompute s as K1 does, per 64 x 64 tile pair: qu.k^T plus the rel-pos
// term, from the BQ + BKV - 1 = 127 rows p[r0 .. r0+126] the pair reaches
// (r0 = T - 64 - i0 + j0, local row q = j - i + 63; the fp32 path at dh 128
// takes query tiles of 32 rows, 95 rows of p). K3 walks the key tiles
// up to the last valid key; K4 walks every query tile (every row is a query,
// padded rows included). P = 0 on masked pairs is set, never computed.
//
// bf16 (the main path; csrc/hopper.cuh, TMA and wgmma, no mma.sync): a block
// of 384 threads, a producer warpgroup that hands its registers to two
// consumer warpgroups (setmaxnreg 40 / 232) and works in one warp, which
// loads the tiles by TMA into a ring of shared-memory stages in the 128-byte
// swizzle, each completed on an mbarrier; the consumers take every product
// with wgmma. The rel-pos band is skewed through shared memory: the band
// products' fp32 results are scattered into a score tile at each score's
// diagonal, and dS (bf16) into a band tile in the 128-byte swizzle that
// wgmma reads as its A operand (see wg:: below). P and dS are rounded to
// bf16 before each product, as the JAX kernels round them to the input
// dtype (flash_attention.py:248,291,299). K3 and K4 are deterministic but
// for dp, which is summed across blocks by TMA reductions.
// fp32 (the exactness check): scalar fp32 FMAs from shared-memory tiles.
//
// Bound on the H100: per tile pair K3 does 5 products of 64 x 64 x dh (q.k,
// q.p band, dO.v, dS.k, band.p) and K4 6 (q.k, q.p, dO.v, P.dO, dS.q and the
// dp product), against ~6 x 2 B x T x H x dh bytes of inputs and outputs, so
// operations bound both at the main path's shapes. The wgmma band products
// of K4 are 64 rows wide where 127 of 128 rows are used, so K4 issues 8.
// Head widths dh = D of 64 (Conformer-Large) and 128 (FastConformer-XL).
// At dh 128 K3 and K4 are kernels of their own (dq128_kernel,
// dkv128_kernel): an item of 64 query rows or 64 keys at full width, its two
// consumer warpgroups split by output (K3: the band chunk, s and P; dP, dS,
// dqu and dqv. K4: P^T and dv; dS^T, dk and dp), q, or k and v, held as
// register fragments; what bounds each and its budget are noted there.
//
// Layouts: qu, qv, k, v, dO and dqu, dqv, dk, dv are [B, T, H, D]; p is
// [2T-1, H, D], dp [2T-1, H, D] fp32 (zeroed by the caller); lse and delta
// are [B, H, T] fp32; lengths [B] int32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "flash_tiles.cuh"
#include "hopper.cuh"
#include "relpos_band.cuh"

namespace {

constexpr int BKV = 64;

// ---------------------------------------------------------------- fp32 path

namespace f32 {

constexpr int NT = 256;       // 16 x 16 threads
constexpr int LDT = BKV + 1;  // stride of the [rows][64] score tiles

// The tiles of head width D: query tiles of FQ rows (32 at dh 128, where 64
// would pass the 227 KB of shared memory a block can have), the p rows a
// tile pair reaches (NP) and stages (NPR), and the stride of the [rows][D]
// tiles.
template <int D>
struct Tiles {
  static constexpr int FQ = D == 64 ? 64 : 32;
  static constexpr int NP = FQ + BKV - 1;
  static constexpr int NPR = FQ + BKV;
  static constexpr int LD = D + 1;
  // K3: Qu, Qv, dO [FQ][LD]; K, V [BKV][LD]; p [NPR][LD]; dS [FQ][LDT]
  static constexpr size_t SMEM_DQ =
      (3 * FQ * LD + 2 * BKV * LD + NPR * LD + FQ * LDT) * sizeof(float);
  // K4: K, V [BKV][LD]; Qu, Qv, dO [FQ][LD]; p [NPR][LD]; dS, P [FQ][LDT]; lse, delta [FQ]
  static constexpr size_t SMEM_DKV =
      (2 * BKV * LD + 3 * FQ * LD + NPR * LD + 2 * FQ * LDT + 2 * FQ) * sizeof(float);
  static_assert(SMEM_DQ <= 232448 && SMEM_DKV <= 232448, "fp32 K3/K4: too much shared memory");
};

// rows [row0, row0 + n) of a [rows, H, D] tensor at head offset hoff into
// shared memory [n][D + 1]; rows outside [0, rows) are 0
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int row0, int n,
                                      int rows, long long rs, long long hoff) {
  constexpr int LD = Tiles<D>::LD;
  for (int idx = threadIdx.x; idx < n * D; idx += NT) {
    const int r = idx / D, d = idx % D, t = row0 + r;
    dst[r * LD + d] = (t >= 0 && t < rows) ? src[t * rs + hoff + d] : 0.f;
  }
}

// s, P and dS of scores (il = ty + 16a, jl = tx + 16c) of a tile pair:
// returns the P of each into `pr` and dS into `ds` (both [FQ][LDT])
template <int D>
__device__ __forceinline__ void scores(const float* sQu, const float* sQv, const float* sO,
                                       const float* sK, const float* sV, const float* sP,
                                       const float* lse, const float* del, int j0, int i0,
                                       int len, int Tn, float scale, float* pr, float* ds) {
  using T = Tiles<D>;
  constexpr int LD = T::LD;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  for (int a = 0; a < T::FQ / 16; ++a) {
    const int il = ty + 16 * a;
    for (int c = 0; c < 4; ++c) {
      const int jl = tx + 16 * c;
      const float* prow = sP + (jl - il + T::FQ - 1) * LD;
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

template <int D>
__global__ void __launch_bounds__(NT) dq_kernel(
    const float* __restrict__ qu, const float* __restrict__ qv, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ p, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ lengths, float* __restrict__ dqu, float* __restrict__ dqv, int H,
    int Tn, float scale) {
  using T = Tiles<D>;
  constexpr int FQ = T::FQ, LD = T::LD, NC = D / 16;
  extern __shared__ float4 smem4[];
  float* sQu = reinterpret_cast<float*>(smem4);
  float* sQv = sQu + FQ * LD;
  float* sO = sQv + FQ * LD;
  float* sK = sO + FQ * LD;
  float* sV = sK + BKV * LD;
  float* sP = sV + BKV * LD;
  float* sDS = sP + T::NPR * LD;
  __shared__ float sL[FQ], sDl[FQ];

  const int i0 = blockIdx.x * FQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int len = min(max(lengths[b], 0), Tn);
  const long long rs = (long long)H * D;
  const long long bbase = (long long)b * Tn * rs, hoff = (long long)h * D;
  const long long lrow = ((long long)b * H + h) * Tn;

  stage<D>(sQu, qu + bbase, i0, FQ, Tn, rs, hoff);
  stage<D>(sQv, qv + bbase, i0, FQ, Tn, rs, hoff);
  stage<D>(sO, dout + bbase, i0, FQ, Tn, rs, hoff);
  for (int idx = tid; idx < FQ; idx += NT) {
    const int i = i0 + idx;
    sL[idx] = i < Tn ? lse[lrow + i] : 0.f;
    sDl[idx] = i < Tn ? delta[lrow + i] : 0.f;
  }

  float aq[FQ / 16][NC], av[FQ / 16][NC];  // rows ty + 16a, columns tx + 16c
  for (int a = 0; a < FQ / 16; ++a)
    for (int c = 0; c < NC; ++c) aq[a][c] = av[a][c] = 0.f;

  const int n_kv = (len + BKV - 1) / BKV;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int j0 = kt * BKV;
    __syncthreads();  // the previous tile is no longer read
    stage<D>(sK, k + bbase, j0, BKV, Tn, rs, hoff);
    stage<D>(sV, v + bbase, j0, BKV, Tn, rs, hoff);
    stage<D>(sP, p, Tn - FQ - i0 + j0, T::NPR, 2 * Tn - 1, rs, hoff);
    __syncthreads();
    scores<D>(sQu, sQv, sO, sK, sV, sP, sL, sDl, j0, i0, len, Tn, scale, nullptr, sDS);
    __syncthreads();
    for (int a = 0; a < FQ / 16; ++a) {
      const int il = ty + 16 * a;
      for (int jl = 0; jl < BKV; ++jl) {
        const float ds = sDS[il * LDT + jl];
        const float* prow = sP + (jl - il + FQ - 1) * LD;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          aq[a][c] = fmaf(ds, sK[jl * LD + tx + 16 * c], aq[a][c]);
          av[a][c] = fmaf(ds, prow[tx + 16 * c], av[a][c]);
        }
      }
    }
  }
  for (int a = 0; a < FQ / 16; ++a) {
    const int i = i0 + ty + 16 * a;
    if (i >= Tn) continue;
    for (int c = 0; c < NC; ++c) {
      dqu[bbase + i * rs + hoff + tx + 16 * c] = aq[a][c];
      dqv[bbase + i * rs + hoff + tx + 16 * c] = av[a][c];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NT) dkv_kernel(
    const float* __restrict__ qu, const float* __restrict__ qv, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ p, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ lengths, float* __restrict__ dk, float* __restrict__ dv,
    float* __restrict__ dp, int H, int Tn, float scale) {
  using T = Tiles<D>;
  constexpr int FQ = T::FQ, LD = T::LD, NP = T::NP, NC = D / 16;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);
  float* sV = sK + BKV * LD;
  float* sQu = sV + BKV * LD;
  float* sQv = sQu + FQ * LD;
  float* sO = sQv + FQ * LD;
  float* sP = sO + FQ * LD;
  float* sDS = sP + T::NPR * LD;
  float* sPr = sDS + FQ * LDT;
  float* sL = sPr + FQ * LDT;
  float* sDl = sL + FQ;

  const int j0 = blockIdx.x * BKV, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int len = min(max(lengths[b], 0), Tn);
  const long long rs = (long long)H * D;
  const long long bbase = (long long)b * Tn * rs, hoff = (long long)h * D;
  const long long lrow = ((long long)b * H + h) * Tn;

  float ak[4][NC], avv[4][NC];  // keys ty + 16a, columns tx + 16c
  for (int a = 0; a < 4; ++a)
    for (int c = 0; c < NC; ++c) ak[a][c] = avv[a][c] = 0.f;

  if (j0 < len) {  // a tile of masked keys has zero gradients
    stage<D>(sK, k + bbase, j0, BKV, Tn, rs, hoff);
    stage<D>(sV, v + bbase, j0, BKV, Tn, rs, hoff);
    const int n_q = (Tn + FQ - 1) / FQ;
    for (int qt = 0; qt < n_q; ++qt) {
      const int i0 = qt * FQ;
      const int r0 = Tn - FQ - i0 + j0;
      __syncthreads();  // the previous tile is no longer read
      stage<D>(sQu, qu + bbase, i0, FQ, Tn, rs, hoff);
      stage<D>(sQv, qv + bbase, i0, FQ, Tn, rs, hoff);
      stage<D>(sO, dout + bbase, i0, FQ, Tn, rs, hoff);
      stage<D>(sP, p, r0, T::NPR, 2 * Tn - 1, rs, hoff);
      for (int idx = tid; idx < FQ; idx += NT) {
        const int i = i0 + idx;
        sL[idx] = i < Tn ? lse[lrow + i] : 0.f;
        sDl[idx] = i < Tn ? delta[lrow + i] : 0.f;
      }
      __syncthreads();
      scores<D>(sQu, sQv, sO, sK, sV, sP, sL, sDl, j0, i0, len, Tn, scale, sPr, sDS);
      __syncthreads();
      for (int a = 0; a < 4; ++a) {
        const int jl = ty + 16 * a;
        for (int il = 0; il < FQ; ++il) {
          const float ds = sDS[il * LDT + jl], pp = sPr[il * LDT + jl];
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            ak[a][c] = fmaf(ds, sQu[il * LD + tx + 16 * c], ak[a][c]);
            avv[a][c] = fmaf(pp, sO[il * LD + tx + 16 * c], avv[a][c]);
          }
        }
      }
      // dp rows r0 + q (q = ty + 16a): the pairs (il, jl = q + il - (FQ - 1)) of the tile
      for (int a = 0; a < (NP + 15) / 16; ++a) {
        const int q = ty + 16 * a, r = r0 + q;
        if (q >= NP || r < 0 || r >= 2 * Tn - 1) continue;
        float acc[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[c] = 0.f;
        const int il_lo = max(0, FQ - 1 - q), il_hi = min(FQ - 1, NP - 1 - q);
        for (int il = il_lo; il <= il_hi; ++il) {
          const float ds = sDS[il * LDT + q + il - (FQ - 1)];
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[c] = fmaf(ds, sQv[il * LD + tx + 16 * c], acc[c]);
        }
        float* dst = dp + ((long long)r * H + h) * D + tx;
#pragma unroll
        for (int c = 0; c < NC; ++c) atomicAdd(dst + 16 * c, acc[c]);
      }
    }
  }
  for (int a = 0; a < 4; ++a) {
    const int j = j0 + ty + 16 * a;
    if (j >= Tn) continue;
    for (int c = 0; c < NC; ++c) {
      dk[bbase + j * rs + hoff + tx + 16 * c] = ak[a][c];
      dv[bbase + j * rs + hoff + tx + 16 * c] = avv[a][c];
    }
  }
}

}  // namespace f32

// ------------------------------------------------ bf16 path: TMA and wgmma

namespace wg {

using bf16 = __nv_bfloat16;
using flash::tc::ex2;
using flash::tc::fresh;
using flash::tc::pack_p;
using hopper::ATOM;
using hopper::product_rs;
using hopper::product_ss;
using hopper::product_ss_mn;
using hopper::sw128;

constexpr int PRODUCER_REGS = 40;    // registers a thread, after the split (setmaxnreg) at
constexpr int CONSUMER_REGS = 232;   // dh 64: 128 x 40 + 256 x 232 = 384 x 168 at launch
constexpr float LOG2E = 1.4426950408889634f;
constexpr uint32_t BOX64 = 64 * hopper::BOX_ROW_BYTES;  // a bf16 box of 64 rows, 8 KB

// this warp is done with what `bar` guards
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  __syncwarp();
  if (lane == 0) hopper::mbar_arrive(bar);
}

// the 128 threads of consumer warpgroup w meet
__device__ __forceinline__ void wg_sync(int w) { hopper::bar_sync(1 + w, 128); }

// The two consumer warpgroups take turns (named barriers 3 and 4): each
// issues its first products of a tile only in its turn and hands the turn
// over after the work that reads them, so one warpgroup's shared-memory
// skews and exponentials overlap the other's products (both run in step
// otherwise; 7 % faster for K3, 5 % for K4 at the calibration shape on the
// H100). turn(w) waits for warpgroup w's turn, pass(w) hands it to the
// other; warpgroup 1 passes once before the first tile and warpgroup 0
// takes that pass back after the last, so both barriers end balanced.
__device__ __forceinline__ void turn(int w) { hopper::bar_sync(3 + w, 256); }
__device__ __forceinline__ void pass(int w) { hopper::bar_arrive(4 - w, 256); }

// The band of a tile pair: with i the pair's query row and c its key (both
// 0..63 in their tiles), the rel-pos row of (i, c) is r0 + q, q = c - i + 63
// in [0, 126], r0 = T - 64 - i0 + j0: its lower chunk of 64 rows of p where
// c <= i, its upper chunk where c > i.

// ---- K3 at dh 64 (dh 128 is dq128_kernel below): dqu, dqv. A block of 384
// threads owns 128 query rows of one (b, h), a consumer warpgroup 64 of them
// (rows i0 + 64 w), and walks the key tiles of 64 up to the last valid key. The producer's first warp loads qu,
// qv and dO once an item and, per key tile kt, k, v and the 192 rows of p
// from T - 128 - i0 + 64 kt (the two warpgroups' chunks kt and kt + 1, which
// overlap) by TMA into a ring of stages.
//
// Consecutive key tiles of one query tile reach overlapping bands: tile kt's
// upper chunk is tile kt + 1's lower chunk (rows T - i0' + 64 kt, i0' the
// warpgroup's first row). So a warpgroup computes one chunk of qv p^T a tile
// (the new one, kt + 1) and keeps the rest, and skews through two rings in
// shared memory whose cells every element of a tile writes without a branch:
// - scores: chunk m's element (i, q) is the rel-pos term of row i and key
//   J = 64 m + q + i - 63 of the item; it goes to G [64 i][128] at column
//   J mod 128 (xor 8 (i % 8) against bank conflicts), and tile kt reads its
//   keys J = 64 kt + c from there, as plain rows. A row of G is written and
//   read only by the quad of threads that holds it: __syncwarp orders them.
// - dqv_i = sum_j dS_ij p_{T-1-i+j}: dS (bf16) of row i and key J goes to
//   band column Q = J - i + 63, chunk Q / 64, in a ring of two band tiles
//   [64 i][64] in the 128-byte swizzle (chunk m in tile m % 2). Chunk kt is
//   whole once tile kt is written (tile kt - 1 wrote its cells q < 63 - i),
//   so dqv += band_kt . p_chunk_kt (p MN-major). A tile of zeros before the
//   first tile and after the last fills the cells no tile writes.
// Five products of 64 x 64 x 64 a tile pair (s, the band chunk, dP, dqu and
// the dqv chunk), one more of each band an item.
template <int D>
struct DqLayout {
  static_assert(D == 64, "K3 at dh 128 is dq128_kernel");
  static constexpr int WGS = 2;                 // consumer warpgroups, 64 query rows each
  static constexpr int NT = 128 * (WGS + 1);    // and a producer warpgroup, one warp at work
  static constexpr int TQ = 64 * WGS;           // query rows an item
  static constexpr int STAGES = 2;
  static constexpr uint32_t TILE = BOX64;            // 64 rows of 64 columns
  static constexpr uint32_t Q = 3 * WGS * TILE;      // qu, qv, dO: a tile a warpgroup each
  static constexpr uint32_t STAGE = (WGS + 3) * TILE;  // k, v, then 64 (WGS + 1) rows of p
  static constexpr uint32_t G = Q + STAGES * STAGE;
  static constexpr uint32_t GBYTES = 64 * 128 * 4;  // a warpgroup's G ring
  static constexpr uint32_t BAND = G + WGS * GBYTES;
  static constexpr uint32_t BARS = BAND + WGS * 2 * BOX64;  // q loaded, q free, full, empty
  static constexpr uint32_t BYTES = BARS + 8 * (2 + 2 * STAGES) + ATOM;  // + alignment slack
  static_assert(BYTES <= 232448, "K3: more shared memory than a block can have");
};

template <int D>
__global__ void __launch_bounds__(DqLayout<D>::NT, 1) dq_kernel(
    const __grid_constant__ CUtensorMap tqu, const __grid_constant__ CUtensorMap tqv,
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tp, const __grid_constant__ CUtensorMap tdo,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ lengths, bf16* __restrict__ dqu, bf16* __restrict__ dqv, int B, int H,
    int Tn, float scale) {
  using L = DqLayout<D>;
  constexpr int STAGES = L::STAGES, WGS = L::WGS, TQ = L::TQ;
  constexpr uint32_t TILE = L::TILE;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = (raw + ATOM - 1) & ~(ATOM - 1);
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
        hopper::tma_load_4d(base + (2 * WGS + w) * TILE, &tdo, q_loaded, 0, h, i0 + 64 * w, b);
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
  const float scale2 = scale * LOG2E;  // P = 2^(s scale2 - lse log2(e))
  const long long rs = (long long)H * D;
  float* const G = reinterpret_cast<float*>(sm + L::G + w * L::GBYTES);
  uint8_t* const band = sm + L::BAND + w * 2 * BOX64;
  const uint32_t band_at = base + L::BAND + w * 2 * BOX64;
  const uint32_t qu_at = base + w * TILE, qv_at = base + (WGS + w) * TILE;
  const uint32_t do_at = base + (2 * WGS + w) * TILE;

  // band chunk m (64 x 64 accumulator) into the G ring
  auto scatter = [&](const float (&bd)[8][4], int m) { relpos::scatter_band(G, bd, m, rl, g, t); };
  // dS of tile kt (or zeros) into the band ring
  auto band_tile = [&](const float (&ds)[8][4], int kt, bool zeros) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = rl + 8 * (e >> 1), q = 64 * kt + 8 * nt + 2 * t + (e & 1) - i + 63;
        *reinterpret_cast<bf16*>(band + ((q & 64) << 7) + sw128(i, q & 63)) =
            __float2bfloat16_rn(zeros ? 0.f : ds[nt][e]);
      }
  };

  if (w == 1) pass(1);  // the first turn is warpgroup 0's
  int n = 0, k = 0;  // stages consumed, items taken
  for (int r = 0; r * (int)gridDim.x < n_items; ++r) {
    const int it = flash::tc::snake_item(r);
    if (it >= n_items) continue;
    int i0, h, b;
    item_of(it, i0, h, b);
    const int len = length(b), nk = (len + 63) / 64;
    const int ia = i0 + 64 * w + rl, ib = ia + 8;
    const long long lrow = ((long long)b * H + h) * Tn;
    float l2[2], dl[2];  // lse log2(e) and delta of rows ia, ib
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int i = hh ? ib : ia;
      l2[hh] = i < Tn ? lse[lrow + i] * LOG2E : 0.f;
      dl[hh] = i < Tn ? delta[lrow + i] : 0.f;
    }
    float aq[D / 8][4], av[D / 8][4], sc[8][4], bd[8][4], dp[8][4];
    uint32_t pa[4][4];  // dS as A fragments
    flash::tc::zero<D / 8>(aq);
    flash::tc::zero<D / 8>(av);
    hopper::mbar_wait(q_loaded, k & 1);
    int s = 0;
    for (int kt = 0; kt < nk; ++kt, ++n) {
      s = n % STAGES;
      hopper::mbar_wait(full(s), (n / STAGES) & 1);
      const uint32_t k_at = base + L::Q + s * L::STAGE, v_at = k_at + TILE;
      // chunks kt and kt + 1 of this warpgroup's band
      const uint32_t old_at = k_at + (WGS + 1 - w) * TILE, new_at = old_at + TILE;
      if (kt == 0) {  // chunk 0, and a tile of zeros before the first
        hopper::wgmma_fence();
        product_ss<64, D>(bd, qv_at, old_at);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(bd);
        scatter(bd, 0);
        band_tile(dp, -1, true);
      }
      turn(w);
      hopper::wgmma_fence();
      product_ss<64, D>(sc, qu_at, k_at);    // s = qu k^T
      product_ss<64, D>(bd, qv_at, new_at);  // chunk kt + 1 of qv p^T
      product_ss<64, D>(dp, do_at, v_at);    // dP = dO v^T
      hopper::wgmma_wait<1>();
      hopper::fence_regs(sc);
      hopper::fence_regs(bd);
      scatter(bd, kt + 1);
      __syncwarp();
      // P = exp(scale (qu.k + qv.p) - lse), 0 on keys past the length
      const float* grow[2] = {relpos::band_row(G, rl, kt), relpos::band_row(G, rl + 8, kt)};
      const int kmax = len - 64 * kt;  // keys c < kmax are valid
      if (__builtin_expect(kmax < 64, 0)) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int c = 8 * nt + 2 * t;
            const float2 gv = *reinterpret_cast<const float2*>(grow[hh] + (c ^ (8 * g)));
            sc[nt][2 * hh] =
                c < kmax ? ex2(fmaf(sc[nt][2 * hh] + gv.x, scale2, -l2[hh])) : 0.f;
            sc[nt][2 * hh + 1] =
                c + 1 < kmax ? ex2(fmaf(sc[nt][2 * hh + 1] + gv.y, scale2, -l2[hh])) : 0.f;
          }
      } else {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float2 gv =
                *reinterpret_cast<const float2*>(grow[hh] + ((8 * nt + 2 * t) ^ (8 * g)));
            sc[nt][2 * hh] = ex2(fmaf(sc[nt][2 * hh] + gv.x, scale2, -l2[hh]));
            sc[nt][2 * hh + 1] = ex2(fmaf(sc[nt][2 * hh + 1] + gv.y, scale2, -l2[hh]));
          }
      }
      pass(w);  // the other warpgroup's products overlap this tile's dS
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dp);
      // dS = P (dP - delta) scale, kept in dp's registers and as A fragments
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[nt][e] = sc[nt][e] * (dp[nt][e] - dl[e >> 1]) * scale;
      pack_p<64>(pa, dp);
      band_tile(dp, kt, false);  // completes chunk kt, starts chunk kt + 1
      hopper::fence_proxy_async();
      wg_sync(w);
      hopper::wgmma_fence();
      product_rs<D, 64>(aq, pa, k_at);  // dqu += dS k, k MN-major
      product_ss_mn<D, 64>(av, band_at + (kt & 1) * BOX64, old_at, 1);  // dqv += band_kt p_kt
      hopper::wgmma_wait<0>();
      hopper::fence_regs(aq);
      hopper::fence_regs(av);
      hopper::fence_regs(pa);
      if (kt + 1 < nk) release(empty(s), lane);  // the last stage's p serves the last chunk
    }
    if (nk > 0) {  // the last chunk, with a tile of zeros after the last
      band_tile(dp, nk, true);
      hopper::fence_proxy_async();
      wg_sync(w);
      hopper::wgmma_fence();
      product_ss_mn<D, 64>(av, band_at + (nk & 1) * BOX64,
                           base + L::Q + s * L::STAGE + (WGS + 2 - w) * TILE, 1);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(av);
      release(empty(s), lane);
    }
    release(q_free, lane);  // every product of the item that reads qu, qv and dO is done
    const float one[2] = {1.f, 1.f};
    const long long off = (long long)b * Tn * rs + (long long)h * D;
    flash::tc::store_rows<D / 8>(dqu + off, aq, ia, ib, Tn, rs, t, one);
    flash::tc::store_rows<D / 8>(dqv + off, av, ia, ib, Tn, rs, t, one);
    ++k;
  }
  if (w == 0) turn(0);  // warpgroup 1's first pass
}

// ---- K4 at dh 64 (dh 128 is dkv128_kernel below): dk, dv and dp. A block
// of 384 threads owns 128 keys of one (b, h),
// a consumer warpgroup 64 of them (keys c0 = j0 + 64 w), and walks every
// query tile of 64 rows (padded rows are queries too); a warpgroup whose 64
// keys all lie at or past the length computes nothing and writes zeros, and
// a block of such keys walks nothing. The producer's first warp loads k and
// v once an item and, per query tile, qu, qv, dO and the 192 rows of p from
// T - 64 - i0 + j0 (the two warpgroups' bands of 128 rows, which overlap),
// with the rows' lse log2(e) and delta (plain loads by the warp's lanes:
// those rows need not be 16-byte aligned for a bulk copy), into a ring of
// stages. Transposed scores, keys by queries:
// - s^T = k qu^T, dP^T = v dO^T (k, v as A, qu, dO as B, K-major), then
//   dv += P^T dO and dk += dS^T qu (register A fragments, dO, qu MN-major);
// - the rel-pos term: BD = qv p_band^T (64 queries x 128 rows of p) is
//   scattered into G^T [64 keys][LDG] at (c, i) for c = q + i - 63 (the
//   half of BD outside the tile into padding columns, without a branch),
//   read back per score (across warps: two warpgroup barriers a tile);
// - dp: dS^T (bf16) is scattered into a band [128 q][64 i] (q = c - i + 63,
//   the 128-byte swizzle; cells off the tile's diagonals stay 0), and
//   band . qv (qv MN-major) gives the pair's 128 rows of dp in two chunks of
//   64. A query tile's upper chunk is the previous tile's lower one, so one
//   fp32 accumulator carries a chunk from tile to tile and each chunk goes
//   out once: staged in shared memory (G^T's, in encode_rows_f32's layout)
//   and added to dp by a TMA reduction (cp.reduce.async.bulk.tensor), which
//   skips rows past the end of p (see flush for a chunk that starts before
//   its first row). dp is summed over blocks in the order the reductions
//   land, so its last bits vary from run to run.
// Eight products of 64 x 64 x 64 a tile pair (s^T, the two band halves,
// dP^T, dv, dk, the two dp chunks).
template <int D>
struct DkvLayout {
  static_assert(D == 64, "K4 at dh 128 is dkv128_kernel");
  static constexpr int WGS = 2;                  // consumer warpgroups, 64 keys each
  static constexpr int NT = 128 * (WGS + 1);     // and a producer warpgroup, one warp at work
  static constexpr int TK = 64 * WGS;            // keys an item
  static constexpr int STAGES = 2;
  static constexpr int LDG = 68;                 // fp32 stride of G^T
  static constexpr uint32_t TILE = BOX64;        // 64 rows of 64 columns
  static constexpr uint32_t KV = 2 * WGS * TILE;  // k tiles, then v tiles
  static constexpr uint32_t PB = 3 * TILE;        // in a stage: qu, qv, dO, then p
  static constexpr uint32_t ROWS = PB + (WGS + 1) * TILE;  // then lse log2(e), delta [2][64]
  static constexpr uint32_t STAGE = ROWS + 1024;
  static constexpr uint32_t G = KV + STAGES * STAGE;
  static constexpr uint32_t GBYTES = 64 * LDG * 4;      // a warpgroup's G^T, or its dp staging
  static constexpr uint32_t BAND = G + WGS * GBYTES;
  static constexpr uint32_t BARS = BAND + WGS * 2 * BOX64;  // kv loaded, kv free, full, empty
  static constexpr uint32_t BYTES = BARS + 8 * (2 + 2 * STAGES) + ATOM;
  static_assert(BYTES <= 232448, "K4: more shared memory than a block can have");
};

template <int D>
__global__ void __launch_bounds__(DkvLayout<D>::NT, 1) dkv_kernel(
    const __grid_constant__ CUtensorMap tqu, const __grid_constant__ CUtensorMap tqv,
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tp, const __grid_constant__ CUtensorMap tdo,
    const __grid_constant__ CUtensorMap tdp, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ lengths, bf16* __restrict__ dk,
    bf16* __restrict__ dv, float* __restrict__ dpp, int B, int H, int Tn, float scale) {
  using L = DkvLayout<D>;
  constexpr int STAGES = L::STAGES, LDG = L::LDG, WGS = L::WGS, TK = L::TK;
  constexpr uint32_t TILE = L::TILE;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = (raw + ATOM - 1) & ~(ATOM - 1);
  uint8_t* const sm = smem_raw + (base - raw);
  const uint32_t kv_loaded = base + L::BARS, kv_free = kv_loaded + 8;
  auto full = [&](int s) { return base + L::BARS + 8 * (2 + s); };
  auto empty = [&](int s) { return base + L::BARS + 8 * (2 + STAGES + s); };

  // work item it: TK keys from j0 of head h, batch row b
  const int n_k = (Tn + TK - 1) / TK, n_items = n_k * H * B, n_q = (Tn + 63) / 64;
  auto item_of = [&](int it, int& j0, int& h, int& b) {
    const int rem = it % (H * B);
    j0 = it / (H * B) * TK;
    h = rem % H;
    b = rem / H;
  };
  auto length = [&](int b) { return min(max(lengths[b], 0), Tn); };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_loaded, 1);
    hopper::mbar_init(kv_free, 4 * WGS);  // every consumer warp
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full(s), 1 + 32);    // the TMA bytes, each lane's rows
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
      int j0, h, b;
      item_of(it, j0, h, b);
      if (lane == 0) {  // k and v, once the last item is done with them
        if (k > 0) hopper::mbar_wait(kv_free, (k - 1) & 1);
        hopper::mbar_arrive_tx(kv_loaded, L::KV);
        for (int w = 0; w < WGS; ++w) {
          hopper::tma_load_4d(base + w * TILE, &tk, kv_loaded, 0, h, j0 + 64 * w, b);
          hopper::tma_load_4d(base + (WGS + w) * TILE, &tv, kv_loaded, 0, h, j0 + 64 * w, b);
        }
      }
      const int nq = j0 < length(b) ? n_q : 0;
      const long long lrow = ((long long)b * H + h) * Tn;
      for (int qt = 0; qt < nq; ++qt, ++n) {
        const int s = n % STAGES, use = n / STAGES;
        float lv[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};  // this lane's rows, loaded first
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int i = 64 * qt + lane + 32 * x;
          if (i < Tn) {
            lv[x] = lse[lrow + i] * LOG2E;
            dl[x] = delta[lrow + i];
          }
        }
        if (use > 0) hopper::mbar_wait(empty(s), (use - 1) & 1);  // the stage is read out
        float* rows = reinterpret_cast<float*>(sm + L::KV + s * L::STAGE + L::ROWS);
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          rows[lane + 32 * x] = lv[x];
          rows[64 + lane + 32 * x] = dl[x];
        }
        if (lane == 0) {
          const uint32_t st = base + L::KV + s * L::STAGE;
          hopper::mbar_arrive_tx(full(s), L::ROWS);  // the tiles' bytes
          hopper::tma_load_4d(st, &tqu, full(s), 0, h, 64 * qt, b);
          hopper::tma_load_4d(st + TILE, &tqv, full(s), 0, h, 64 * qt, b);
          hopper::tma_load_4d(st + 2 * TILE, &tdo, full(s), 0, h, 64 * qt, b);
          for (int x = 0; x <= WGS; ++x)  // rows past either end of p read as zeros
            hopper::tma_load_4d(st + L::PB + x * TILE, &tp, full(s), 0, h,
                                Tn - 64 - 64 * qt + j0 + 64 * x, 0);
        }
        hopper::mbar_arrive(full(s));
      }
      ++k;
    }
    return;
  }

  // consumer warpgroup w: keys c0 = j0 + 64 w .. + 63 of each item; this
  // thread's local keys rl and rl + 8 (global ja, jb), rows of s^T
  hopper::reg_alloc<CONSUMER_REGS>();
  const int w = (warp >> 2) - 1, g = lane >> 2, t = lane & 3, rl = 16 * (warp & 3) + g;
  const bool issuer = (threadIdx.x & 127) == 0;  // issues the warpgroup's dp reductions
  const float scale2 = scale * LOG2E;
  const long long rs = (long long)H * D;
  float* const Gt = reinterpret_cast<float*>(sm + L::G + w * L::GBYTES);
  uint8_t* const staging = sm + L::G + w * L::GBYTES;  // G^T's memory, once G^T is read out
  const uint32_t staging_at = base + L::G + w * L::GBYTES;
  uint8_t* const band = sm + L::BAND + w * 2 * BOX64;
  const uint32_t band_at = base + L::BAND + w * 2 * BOX64;
  const uint32_t k_at = base + w * TILE, v_at = base + (WGS + w) * TILE;

  // a dp chunk (64 rows of p from row r; fp32 accumulator) into the staging
  // tile, and from there into dp: by a
  // TMA reduction that the issuer starts or, for the one chunk that starts
  // before row 0 (the first keys' last query tile, where T is no multiple
  // of 64: once a (b, h)), by atomics. A TMA reduction's box may not start
  // at a negative row (it faults, error 715, on the H100); rows past the end
  // are skipped.
  auto flush = [&](const float (&acc)[8][4], int h, int r) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(staging +
                                   hopper::sw128_f32(rl + 8 * hh, 8 * nt + 2 * t, 64)) =
            make_float2(acc[nt][2 * hh], acc[nt][2 * hh + 1]);
    hopper::fence_proxy_async();
    wg_sync(w);
    if (r >= 0) {
      if (issuer) {
        hopper::tma_reduce_add_3d(&tdp, staging_at, 0, h, r);
        hopper::tma_reduce_add_3d(&tdp, staging_at + 64 * hopper::BOX_ROW_BYTES, 32, h, r);
        hopper::bulk_commit();
      }
    } else {
      for (int idx = threadIdx.x & 127; idx < 64 * 64; idx += 128) {
        const int row = idx >> 6, col = idx & 63;
        if (r + row >= 0)
          atomicAdd(dpp + ((long long)(r + row) * H + h) * D + col,
                    *reinterpret_cast<const float*>(staging + hopper::sw128_f32(row, col, 64)));
      }
    }
  };

  if (w == 1) pass(1);  // the first turn is warpgroup 0's
  int n = 0, k = 0;  // stages consumed, items taken
  for (int r = 0; r * (int)gridDim.x < n_items; ++r) {
    const int it = flash::tc::snake_item(r);
    if (it >= n_items) continue;
    int j0, h, b;
    item_of(it, j0, h, b);
    const int len = length(b), nq = j0 < len ? n_q : 0, c0 = j0 + 64 * w;
    const bool dead = c0 >= len;  // every key of this warpgroup is masked
    const int ja = c0 + rl, jb = ja + 8;
    const bool kok[2] = {ja < len, jb < len};
    float dka[8][4], dva[8][4], carry[8][4], sc[8][4], dp[8][4];
    uint32_t pa[4][4], pd[4][4];  // P^T and dS^T as A fragments
    flash::tc::zero<8>(dka);
    flash::tc::zero<8>(dva);
    flash::tc::zero<8>(carry);
    hopper::mbar_wait(kv_loaded, k & 1);
    int held = -1, r0 = 0;  // the stage whose qv the last dp product reads; its band's row
    for (int qt = 0; qt < nq; ++qt, ++n) {
      const int s = n % STAGES;
      hopper::mbar_wait(full(s), (n / STAGES) & 1);
      if (dead) {
        turn(w);  // a dead warpgroup keeps the turns balanced
        pass(w);
        release(empty(s), lane);
        continue;
      }
      const uint32_t qu_at = base + L::KV + s * L::STAGE, qv_at = qu_at + TILE;
      const uint32_t do_at = qu_at + 2 * TILE, pb_at = qu_at + L::PB + w * TILE;
      const int i0 = 64 * qt;
      // the query tile's rows' lse log2(e) (row i at i) and delta (at 64 + i)
      const float* rows = reinterpret_cast<const float*>(sm + L::KV + s * L::STAGE + L::ROWS);
      r0 = Tn - 64 - i0 + c0;
      {
        float bd[16][4];  // BD = qv p_band^T: query i by band row q
        turn(w);
        hopper::wgmma_fence();
        product_ss<128, D>(bd, qv_at, pb_at);
        hopper::wgmma_wait<0>();  // BD, and the last tile's dp chunk
        hopper::fence_regs(bd);
        hopper::fence_regs(carry);
        if (held >= 0) release(empty(held), lane);
        if (issuer) hopper::bulk_wait_read();  // the staging (G^T's memory) is read out
        wg_sync(w);
        if (qt == 0) {  // the band's cells off the diagonals stay 0 for the item
          for (int idx = threadIdx.x & 127; idx < 2 * BOX64 / 16; idx += 128)
            reinterpret_cast<uint4*>(band)[idx] = make_uint4(0, 0, 0, 0);
        }
        // BD's element (i, q) is the rel-pos term of key c = q + i - 63;
        // half of them fall outside the tile and go to a padding column
        float* const spare = Gt + (16 * (warp & 3) + g) * LDG + 64 + t;
#pragma unroll
        for (int nt = 0; nt < 16; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = rl + 8 * (e >> 1), c = 8 * nt + 2 * t + (e & 1) + i - 63;
            *((unsigned)c < 64u ? Gt + c * LDG + i : spare) = bd[nt][e];
          }
      }
      pass(w);  // the other warpgroup's band product overlaps s^T, dP^T
      hopper::wgmma_fence();
      product_ss<64, D>(sc, k_at, qu_at);  // s^T = k qu^T
      product_ss<64, D>(dp, v_at, do_at);  // dP^T = v dO^T
      wg_sync(w);
      hopper::wgmma_wait<1>();
      hopper::fence_regs(sc);
      // P^T = exp(scale (k.qu + p.qv) - lse), 0 on masked keys and on rows past T
      const int imax = Tn - i0;  // query columns i < imax are rows of the sequence
      if (__builtin_expect(imax < 64, 0)) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hh = e >> 1, i = 8 * nt + 2 * t + (e & 1);
            const float x = sc[nt][e] + Gt[(rl + 8 * hh) * LDG + i];
            sc[nt][e] = kok[hh] && i < imax ? ex2(fmaf(x, scale2, -rows[i])) : 0.f;
          }
      } else {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hh = e >> 1, i = 8 * nt + 2 * t + (e & 1);
            const float x = sc[nt][e] + Gt[(rl + 8 * hh) * LDG + i];
            sc[nt][e] = kok[hh] ? ex2(fmaf(x, scale2, -rows[i])) : 0.f;
          }
      }
      pack_p<64>(pa, sc);
      hopper::wgmma_fence();
      product_rs<64, 64>(dva, pa, do_at);  // dv += P^T dO, dO MN-major
      hopper::wgmma_wait<1>();
      hopper::fence_regs(dp);
      // dS^T = P^T (dP^T - delta) scale, as A fragments and into the band
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 8 * nt + 2 * t + (e & 1);
          dp[nt][e] = sc[nt][e] * (dp[nt][e] - rows[64 + i]) * scale;
        }
      pack_p<64>(pd, dp);
      hopper::wgmma_fence();
      product_rs<64, 64>(dka, pd, qu_at);  // dk += dS^T qu, qu MN-major
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = rl + 8 * (e >> 1), i = 8 * nt + 2 * t + (e & 1);
          *reinterpret_cast<bf16*>(band + sw128(c - i + 63, i)) = __float2bfloat16_rn(dp[nt][e]);
        }
      hopper::fence_proxy_async();
      wg_sync(w);
      hopper::wgmma_fence();
      product_ss_mn<64, 64>(carry, band_at + BOX64, qv_at, 1);  // + the upper chunk
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dva);
      hopper::fence_regs(dka);
      hopper::fence_regs(carry);
      hopper::fence_regs(pa);
      hopper::fence_regs(pd);
      flush(carry, h, r0 + 64);  // rows r0 + 64 ..: no later tile reaches them
      hopper::wgmma_fence();
      // the lower chunk, the next tile's upper
      product_ss_mn<64, 64>(carry, band_at, qv_at, 0);
      held = s;
    }
    if (held >= 0) {  // the last tile's lower chunk
      hopper::wgmma_wait<0>();
      hopper::fence_regs(carry);
      if (issuer) hopper::bulk_wait_read();
      wg_sync(w);
      flush(carry, h, r0);
      release(empty(held), lane);
    }
    release(kv_free, lane);  // every product of the item that reads k and v is done
    const float one[2] = {1.f, 1.f};
    const long long off = (long long)b * Tn * rs + (long long)h * D;
    flash::tc::store_rows<8>(dk + off, dka, ja, jb, Tn, rs, t, one);
    flash::tc::store_rows<8>(dv + off, dva, ja, jb, Tn, rs, t, one);
    ++k;
  }
  if (w == 0) turn(0);  // warpgroup 1's first pass
  if (issuer) hopper::bulk_wait_read();  // the staging outlives no reduction
}

// ---- K4 at dh 128 (FastConformer-XL): dkv128_kernel.
//
// Why this shape: at dh 128 the dh-64 block's two warpgroups' k, v, G^T and
// bands do not fit beside stages of 80 KB, and one warpgroup's dk, dv and dp
// chunk at full width (3 x 64 registers) do not fit beside s^T and dP^T. A
// block of one consumer warpgroup on items of 64 keys x one half of dh
// recomputes s^T, BD and dP^T for each half (24 products of 64^3 a tile
// pair where 16 do), reads each query tile's 80 KB stage twice, and waits
// on every product and exponential; on the H100 such a block took 0.103 ms,
// 0.029 of it in its loads alone (PERF.md §6).
//
// Here an item is 64 keys x all 128 columns of one (b, h), and its two
// consumer warpgroups split the work by output (setmaxnreg 24 / 240):
// - A: BD = qv p_band^T (SS, 4 units of 64^3) and its scatter into G^T, then
//   s^T = k qu^T (RS, 2), P^T, dv += P^T dO (RS, 2). It holds k (A
//   fragments, 32 registers) and dv (64) across tiles, and BD (64), s^T (32)
//   and P^T's fragments (16) in turn: the last tile's dv is waited for
//   before BD, and s^T is issued after BD's scatter (with s^T beside BD and
//   P^T in flight, ptxas spilled 32 bytes at 240 registers).
// - B: dP^T = v dO^T (RS, 2), dP^T - delta, dS^T from A's P^T, dk += dS^T
//   qu (RS, 2), the dS^T band (written from dS^T's bf16 fragments) and the
//   carried dp chunk band . qv (SS, 4); it holds v (32), dk (64) and the dp
//   chunk (64) across tiles, dP^T (32) and dS^T's fragments (16).
// The lane indices are laundered each tile (`fresh`), as ptxas otherwise
// keeps the ~100 loop-invariant addresses of the scatters in registers, and
// every path out of a walk waits for its products, as ptxas otherwise
// serializes every wgmma of the kernel (C7514) for a read it cannot rule out.
// What bounds it: a tile pair is 16 products of 64^3 and six barrier
// meetings (G^T's two in A, P^T's two between A and B, the band's and the
// staging's in B), so the latency of each warpgroup's chain, not the tensor
// cores nor the loads (a loads-only copy: 0.020 ms of ~0.05), sets its time.
// A hands P^T (fp32, so dS^T is the dh-64 kernel's) to B through a 16 KB tile
// in shared memory in the accumulator layout (each thread reads back what its
// twin thread of A wrote), under two named barriers (P full, P free). k and v
// are each one warpgroup's A operand, loaded from device memory once an item
// (flash_tiles.cuh:load_a), so shared memory holds 2 stages of qu, qv, dO,
// 128 rows of p and the rows' lse log2(e) and delta (162 KB), G^T (17 KB),
// the P^T tile (16 KB) and the dS^T band (16 KB): 212 KB of 227. A dp chunk
// (64 x 128 fp32, 32 KB) is staged for its TMA reduction in the stage's p
// rows, which A's BD has read out by then (B takes P^T after it); the stage
// goes back once the reduction has read them. 192 items at the calibration
// shape (B=4, T'=376): 1.45 waves on 132 SMs.
struct Dkv128Layout {
  static constexpr int NT = 384;                  // producer, consumer warpgroups A and B
  static constexpr int STAGES = 2;
  static constexpr int LDG = 68;                  // fp32 stride of G^T
  static constexpr uint32_t TILE = 2 * BOX64;     // 64 rows of 128 columns
  static constexpr uint32_t PB = 3 * TILE;        // in a stage: qu, qv, dO, then 128 rows of p
  static constexpr uint32_t ROWS = PB + 2 * TILE;  // then lse log2(e), delta [2][64]
  static constexpr uint32_t STAGE = ROWS + 1024;   // (1024-aligned)
  static constexpr uint32_t G = STAGES * STAGE;    // G^T [64 keys][LDG]
  static constexpr uint32_t PT = G + 64 * LDG * 4;  // P^T [8][128 threads] float4
  static constexpr uint32_t BAND = PT + 128 * 32 * 4;  // the dS^T band [128 q][64 i] bf16
  static constexpr uint32_t BARS = BAND + 2 * BOX64;   // full, empty
  static constexpr uint32_t BYTES = BARS + 8 * 2 * STAGES + ATOM;
  static_assert(STAGE % ATOM == 0 && G % ATOM == 0 && BAND % ATOM == 0, "K4 dh 128: alignment");
  static_assert(BYTES <= 232448, "K4 dh 128: more shared memory than a block can have");
};
constexpr int PRODUCER_REGS_128 = 24;   // 128 x 24 + 256 x 240 = 64,512 of the SM's 65,536
constexpr int CONSUMER_REGS_128 = 240;
constexpr int P_FULL = 3, P_FREE = 4;   // named barriers of A and B (256 threads)

__global__ void __launch_bounds__(Dkv128Layout::NT, 1) dkv128_kernel(
    const __grid_constant__ CUtensorMap tqu, const __grid_constant__ CUtensorMap tqv,
    const __grid_constant__ CUtensorMap tp, const __grid_constant__ CUtensorMap tdo,
    const __grid_constant__ CUtensorMap tdp, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ lengths, bf16* __restrict__ dk, bf16* __restrict__ dv,
    float* __restrict__ dpp, int B, int H, int Tn, float scale) {
  using L = Dkv128Layout;
  constexpr int D = 128, STAGES = L::STAGES, LDG = L::LDG;
  constexpr uint32_t TILE = L::TILE;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = (raw + ATOM - 1) & ~(ATOM - 1);
  uint8_t* const sm = smem_raw + (base - raw);
  auto full = [&](int s) { return base + L::BARS + 8 * s; };
  auto empty = [&](int s) { return base + L::BARS + 8 * (STAGES + s); };

  // work item it: 64 keys from j0 of head h, batch row b
  const int n_k = (Tn + 63) / 64, n_items = n_k * H * B, n_q = n_k;
  auto item_of = [&](int it, int& j0, int& h, int& b) {
    const int rem = it % (H * B);
    j0 = it / (H * B) * 64;
    h = rem % H;
    b = rem / H;
  };
  auto length = [&](int b) { return min(max(lengths[b], 0), Tn); };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full(s), 1 + 32);  // the TMA bytes, each lane's rows
      hopper::mbar_init(empty(s), 8);      // every consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp < 4) {
    hopper::reg_dealloc<PRODUCER_REGS_128>();
    if (warp != 0) return;
    int n = 0;  // stages filled
    for (int r = 0; r * (int)gridDim.x < n_items; ++r) {
      const int it = flash::tc::snake_item(r);
      if (it >= n_items) continue;
      int j0, h, b;
      item_of(it, j0, h, b);
      const int nq = j0 < length(b) ? n_q : 0;
      const long long lrow = ((long long)b * H + h) * Tn;
      for (int qt = 0; qt < nq; ++qt, ++n) {
        const int s = n % STAGES, use = n / STAGES;
        float lv[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};  // this lane's rows, loaded first
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int i = 64 * qt + lane + 32 * x;
          if (i < Tn) {
            lv[x] = lse[lrow + i] * LOG2E;
            dl[x] = delta[lrow + i];
          }
        }
        if (use > 0) hopper::mbar_wait(empty(s), (use - 1) & 1);  // the stage is read out
        float* rows = reinterpret_cast<float*>(sm + s * L::STAGE + L::ROWS);
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          rows[lane + 32 * x] = lv[x];
          rows[64 + lane + 32 * x] = dl[x];
        }
        if (lane == 0) {
          const uint32_t st = base + s * L::STAGE;
          hopper::mbar_arrive_tx(full(s), L::ROWS);  // the tiles' bytes
          for (int c = 0; c < 2; ++c) {
            hopper::tma_load_4d(st + c * BOX64, &tqu, full(s), 64 * c, h, 64 * qt, b);
            hopper::tma_load_4d(st + TILE + c * BOX64, &tqv, full(s), 64 * c, h, 64 * qt, b);
            hopper::tma_load_4d(st + 2 * TILE + c * BOX64, &tdo, full(s), 64 * c, h, 64 * qt,
                                b);
            for (int x = 0; x < 2; ++x)  // box c's 128 rows of p; zeros past either end
              hopper::tma_load_4d(st + L::PB + (2 * c + x) * BOX64, &tp, full(s), 64 * c, h,
                                  Tn - 64 - 64 * qt + j0 + 64 * x, 0);
          }
        }
        hopper::mbar_arrive(full(s));
      }
    }
    return;
  }

  // consumer warpgroup w (0: A, 1: B); this thread's local keys rl and rl + 8
  // (global ja, jb), rows of s^T, and its index tid in the warpgroup
  const int w = (warp >> 2) - 1, t0 = lane & 3, rl0 = 16 * (warp & 3) + (lane >> 2);
  hopper::reg_alloc<CONSUMER_REGS_128>();
  const int tid = threadIdx.x & 127;
  const float scale2 = scale * LOG2E;
  const long long rs = (long long)H * D;
  float* const Gt = reinterpret_cast<float*>(sm + L::G);
  // t0 and rl0 laundered in each tile (tc::fresh): ptxas otherwise keeps the
  // ~100 addresses of a tile's scatters and reads in registers, and spills
  float4* const ptile = reinterpret_cast<float4*>(sm + L::PT);
  int n = 0;  // stages consumed

  if (w == 0) {  // ---- A: BD, s^T, P^T, dv
    uint32_t kf[8][4];  // the item's keys as A fragments
    for (int r = 0; r * (int)gridDim.x < n_items; ++r) {
      const int it = flash::tc::snake_item(r);
      if (it >= n_items) continue;
      int j0, h, b;
      item_of(it, j0, h, b);
      const int len = length(b), nq = j0 < len ? n_q : 0;
      const int ja = j0 + rl0, jb = ja + 8;
      const bool kok[2] = {ja < len, jb < len};
      const long long off = (long long)b * Tn * rs + (long long)h * D;
      float dva[16][4], sc[8][4];
      uint32_t pa[4][4];  // P^T as A fragments
      flash::tc::zero<16>(dva);
      if (nq > 0) flash::tc::load_a<D>(kf, k + off, ja, jb, Tn, rs, t0);
      int held = -1;  // the stage whose dO the last dv product reads
      for (int qt = 0; qt < nq; ++qt, ++n) {
        const int s = n % STAGES;
        hopper::mbar_wait(full(s), (n / STAGES) & 1);
        const uint32_t qu_at = base + s * L::STAGE, qv_at = qu_at + TILE;
        const uint32_t do_at = qu_at + 2 * TILE, pb_at = qu_at + L::PB;
        const float* rows = reinterpret_cast<const float*>(sm + s * L::STAGE + L::ROWS);
        const int i0 = 64 * qt;
        const int t = fresh(t0), rl = fresh(rl0);
        hopper::wgmma_wait<0>();  // the last tile's dv: P^T's fragments are free
        hopper::fence_regs(dva);
        hopper::fence_regs(pa);
        if (held >= 0) release(empty(held), lane);
        {
          float bd[16][4];  // BD = qv p_band^T: query i by band row q
          hopper::wgmma_fence();
          product_ss<128, D>(bd, qv_at, pb_at);
          hopper::wgmma_wait<0>();  // BD
          hopper::fence_regs(bd);
          wg_sync(0);  // every thread of A has read the last tile's G^T
          // BD's element (i, q) is the rel-pos term of key c = q + i - 63;
          // half of them fall outside the tile and go to a padding column
          float* const spare = Gt + rl * LDG + 64 + t;
#pragma unroll
          for (int nt = 0; nt < 16; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = rl + 8 * (e >> 1), c = 8 * nt + 2 * t + (e & 1) + i - 63;
              *((unsigned)c < 64u ? Gt + c * LDG + i : spare) = bd[nt][e];
            }
        }
        wg_sync(0);
        hopper::wgmma_fence();
        hopper::product_rs_k<64, D>(sc, kf, qu_at);  // s^T = k qu^T, after BD's scatter
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sc);
        // P^T = exp(scale (k.qu + p.qv) - lse), 0 on masked keys and on rows past T
        const int imax = Tn - i0;  // query columns i < imax are rows of the sequence
        if (__builtin_expect(imax < 64, 0)) {
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int hh = e >> 1, i = 8 * nt + 2 * t + (e & 1);
              const float x = sc[nt][e] + Gt[(rl + 8 * hh) * LDG + i];
              sc[nt][e] = kok[hh] && i < imax ? ex2(fmaf(x, scale2, -rows[i])) : 0.f;
            }
        } else {
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int hh = e >> 1, i = 8 * nt + 2 * t + (e & 1);
              const float x = sc[nt][e] + Gt[(rl + 8 * hh) * LDG + i];
              sc[nt][e] = kok[hh] ? ex2(fmaf(x, scale2, -rows[i])) : 0.f;
            }
        }
        hopper::bar_sync(P_FREE, 256);  // B has read the last tile's P^T
#pragma unroll
        for (int j = 0; j < 8; ++j)
          ptile[j * 128 + tid] = make_float4(sc[j][0], sc[j][1], sc[j][2], sc[j][3]);
        hopper::bar_arrive(P_FULL, 256);
        pack_p<64>(pa, sc);
        hopper::wgmma_fence();
        product_rs<D, 64>(dva, pa, do_at);  // dv += P^T dO, dO MN-major
        held = s;
      }
      // on every path, so that ptxas sees no read of an accumulator in flight
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dva);
      hopper::fence_regs(pa);
      if (held >= 0) release(empty(held), lane);
      const float one[2] = {1.f, 1.f};
      flash::tc::store_rows<16>(dv + off, dva, ja, jb, Tn, rs, t0, one);
    }
    hopper::bar_sync(P_FREE, 256);  // B's first arrival: the barrier ends balanced
    return;
  }

  // ---- B: dP^T, dS^T, dk, the dp chunks
  const bool issuer = tid == 0;  // issues B's dp reductions
  uint8_t* const band = sm + L::BAND;
  const uint32_t band_at = base + L::BAND;
  // a dp chunk (64 rows of p from row r, all 128 columns; fp32 accumulator)
  // into the staging tile (stage s's p rows) and from there into dp: by a
  // TMA reduction that the issuer starts or, for the one chunk that starts
  // before row 0 (the first keys' last query tile, where T is no multiple of
  // 64: once a (b, h)), by atomics, as dkv_kernel's flush
  auto flush = [&](const float (&acc)[16][4], int h, int r, int s) {
    const int t = fresh(t0), rl = fresh(rl0);
    uint8_t* const staging = sm + s * L::STAGE + L::PB;
    const uint32_t staging_at = base + s * L::STAGE + L::PB;
#pragma unroll
    for (int nt = 0; nt < 16; ++nt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(staging +
                                   hopper::sw128_f32(rl + 8 * hh, 8 * nt + 2 * t, 64)) =
            make_float2(acc[nt][2 * hh], acc[nt][2 * hh + 1]);
    hopper::fence_proxy_async();
    wg_sync(1);
    if (r >= 0) {
      if (issuer) {
        for (int cb = 0; cb < 4; ++cb)
          hopper::tma_reduce_add_3d(&tdp, staging_at + cb * 64 * hopper::BOX_ROW_BYTES, 32 * cb,
                                    h, r);
        hopper::bulk_commit();
      }
    } else {
      for (int idx = tid; idx < 64 * D; idx += 128) {
        const int row = idx >> 7, col = idx & 127;
        if (r + row >= 0)
          atomicAdd(dpp + ((long long)(r + row) * H + h) * D + col,
                    *reinterpret_cast<const float*>(staging + hopper::sw128_f32(row, col, 64)));
      }
    }
  };

  hopper::bar_arrive(P_FREE, 256);  // A's first P^T finds the tile free
  uint32_t vf[8][4];  // the item's values as A fragments
  for (int r = 0; r * (int)gridDim.x < n_items; ++r) {
    const int it = flash::tc::snake_item(r);
    if (it >= n_items) continue;
    int j0, h, b;
    item_of(it, j0, h, b);
    const int len = length(b), nq = j0 < len ? n_q : 0;
    const int ja = j0 + rl0, jb = ja + 8;
    const long long off = (long long)b * Tn * rs + (long long)h * D;
    float dka[16][4], carry[16][4], dp[8][4];
    uint32_t pd[4][4];  // dS^T as A fragments
    flash::tc::zero<16>(dka);
    flash::tc::zero<16>(carry);
    if (nq > 0) flash::tc::load_a<D>(vf, v + off, ja, jb, Tn, rs, t0);
    int held = -1, r0 = 0;  // the stage whose qv the last dp product reads, and its band's row
    for (int qt = 0; qt < nq; ++qt, ++n) {
      const int s = n % STAGES;
      hopper::mbar_wait(full(s), (n / STAGES) & 1);
      const uint32_t qu_at = base + s * L::STAGE, qv_at = qu_at + TILE;
      const uint32_t do_at = qu_at + 2 * TILE;
      const float* rows = reinterpret_cast<const float*>(sm + s * L::STAGE + L::ROWS);
      const int i0 = 64 * qt;
      const int t = fresh(t0), rl = fresh(rl0);
      hopper::wgmma_fence();
      hopper::product_rs_k<64, D>(dp, vf, do_at);  // dP^T = v dO^T
      hopper::wgmma_wait<0>();  // dP^T, and the last tile's dk and lower dp chunk
      hopper::fence_regs(dp);
      hopper::fence_regs(dka);
      hopper::fence_regs(carry);
      hopper::fence_regs(pd);
      if (held >= 0) {  // its staged chunk is read out: the stage goes back
        if (issuer) hopper::bulk_wait_read();
        release(empty(held), lane);
      }
      r0 = Tn - 64 - i0 + j0;
#pragma unroll
      for (int j = 0; j < 8; ++j)  // dP^T - delta, before P^T's loads
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[j][e] -= rows[64 + 8 * j + 2 * t + (e & 1)];
      if (qt == 0) {  // the band's cells off the diagonals stay 0 for the item
        for (int idx = tid; idx < 2 * BOX64 / 16; idx += 128)
          reinterpret_cast<uint4*>(band)[idx] = make_uint4(0, 0, 0, 0);
      }
      hopper::bar_sync(P_FULL, 256);  // A's P^T of this tile
      // dS^T = P^T (dP^T - delta) scale, as A fragments and into the band
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 pv = ptile[j * 128 + tid];
        const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[j][e] = pr[e] * dp[j][e] * scale;
      }
      hopper::bar_arrive(P_FREE, 256);
      pack_p<64>(pd, dp);
      hopper::wgmma_fence();
      product_rs<D, 64>(dka, pd, qu_at);  // dk += dS^T qu, qu MN-major
      if (qt == 0) wg_sync(1);  // the band is zeroed
      // the band from the fragments (dS^T in bf16), so that dp's registers are free
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = rl + 8 * (e >> 1), i = 8 * nt + 2 * t + (e & 1);
          const uint32_t pair = pd[nt >> 1][2 * (nt & 1) + (e >> 1)];
          *reinterpret_cast<uint16_t*>(band + sw128(c - i + 63, i)) =
              (uint16_t)((e & 1) ? pair >> 16 : pair & 0xffffu);
        }
      hopper::fence_proxy_async();
      wg_sync(1);
      hopper::wgmma_fence();
      product_ss_mn<D, 64>(carry, band_at + BOX64, qv_at, 1);  // + the upper chunk
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dka);
      hopper::fence_regs(carry);
      hopper::fence_regs(pd);
      flush(carry, h, r0 + 64, s);  // rows r0 + 64 ..: no later tile reaches them
      hopper::wgmma_fence();
      product_ss_mn<D, 64>(carry, band_at, qv_at, 0);  // the lower chunk, the next tile's upper
      held = s;
    }
    hopper::wgmma_wait<0>();  // on every path, as A's
    hopper::fence_regs(carry);
    if (held >= 0) {  // the last tile's lower chunk, staged where its upper one was
      if (issuer) hopper::bulk_wait_read();
      wg_sync(1);
      flush(carry, h, r0, held);
      if (issuer) hopper::bulk_wait_read();
      release(empty(held), lane);
    }
    const float one[2] = {1.f, 1.f};
    flash::tc::store_rows<16>(dk + off, dka, ja, jb, Tn, rs, t0, one);
  }
}

// K4 at dh 128: the tensor maps and the launch, on a persistent grid
int launch_dkv128(void* qu, void* qv, void* k, void* v, void* p, void* dout, void* lse,
                  void* delta, void* lengths, void* dk, void* dv, void* dp, int B, int H, int Tn,
                  float scale, cudaStream_t stream) {
  CUtensorMap mqu, mqv, mp, mdo, mdp;
  int err = hopper::encode_bthd(&mqu, qu, B, Tn, H, 128, 64);
  if (err == 0) err = hopper::encode_bthd(&mqv, qv, B, Tn, H, 128, 64);
  if (err == 0) err = hopper::encode_bthd(&mp, p, 1, 2 * Tn - 1, H, 128, 64);
  if (err == 0) err = hopper::encode_bthd(&mdo, dout, B, Tn, H, 128, 64);
  if (err == 0) err = hopper::encode_rows_f32(&mdp, dp, 2 * Tn - 1, H, 128, 64);
  int grid = 0;
  if (err == 0) err = flash::persistent_grid((Tn + 63) / 64 * H * B, grid);
  if (err != 0) return err;
  void* args[] = {&mqu, &mqv, &mp, &mdo, &mdp, &k, &v, &lse, &delta,
                  &lengths, &dk, &dv, &dp, &B, &H, &Tn, &scale};
  return flash::launch(dkv128_kernel, Dkv128Layout::BYTES, Dkv128Layout::NT, grid, 1, 1, stream,
                       args);
}

// ---- K3 at dh 128 (FastConformer-XL): dq128_kernel.
//
// Why this shape: at dh 128 the dh-64 block's two warpgroups' q, dO, G rings
// and bands do not fit beside stages of 64 KB, and one warpgroup's dqu and
// dqv at full width (2 x 64 registers) leave no room for s, dP and the band
// chunk in flight together. A block of one consumer warpgroup ran each key
// tile as one chain of products, waits, scatters and exponentials: 0.035-
// 0.038 ms on the H100, 5.5 x its bound, half of it its loads (PERF.md §6).
//
// Here an item is still 64 query rows x all 128 columns of one (b, h) (192
// items at the calibration shape, B=4, H=8, T'=376: 1.45 waves on 132 SMs),
// and two consumer warpgroups split a key tile's work by output (setmaxnreg
// 24 / 240):
// - A: the band chunk kt + 1 = qv p^T and s = qu k^T (RS: qu and qv as
//   register A fragments, taken by ldmatrix from G, where TMA puts them at
//   the item's start; p and k K-major), the chunk's scatter into G
//   (relpos_band.cuh) and P, which it hands (fp32, so dS is the dh-64
//   kernel's) to B through one of two 16 KB tiles in the accumulator layout
//   (each thread of B reads what its twin thread of A wrote), under named
//   barriers (P full, P free): A runs up to two key tiles ahead of B.
// - B: dP = dO v^T (RS, dO as register fragments from device memory), dS =
//   P (dP - delta) scale, dqu += dS k (RS from dS's bf16 fragments, k
//   MN-major), the dS band ring (from the same fragments) and dqv += band_kt
//   p_kt (SS, p MN-major). It holds dO (32 registers), dqu and dqv (64
//   each), dP (32) and dS's fragments (16): dkv128_kernel's B's budget. It
//   waits for dqu and dqv at a tile's end, so that the stage goes back before
//   the next tile's products (A waited on its loads otherwise).
// A block's timeline (clock stamps a tile, PERF.md §6) showed each item's 64
// 4-byte loads a thread of qu and qv and 64 4-byte stores of dqu and dqv
// holding up the shared-memory traffic behind them for ~2-3 us: so qu and qv
// come by TMA into G, whose 32 KB are free between items, and dqu and dqv
// go out by TMA stores from the band ring and the 16 KB after it. Shared
// memory: 2 stages of k, v and the 128 rows of p of chunks kt and kt + 1
// (128 KB), G (32 KB), the P tiles (32 KB), the band ring and the staging
// (32 KB): 225 KB of 227. dqu and dqv are summed in one block in a fixed
// order: bitwise repeatable. Ten products of 64^3 a tile pair (the band
// chunk, s, dP, dqu, dqv), one band chunk and one dqv product more an item.
struct Dq128Layout {
  static constexpr int NT = 384;                     // producer, consumer warpgroups A and B
  static constexpr int STAGES = 2;
  static constexpr uint32_t TILE = 2 * BOX64;        // 64 rows of 128 columns
  static constexpr uint32_t STAGE = 4 * TILE;        // k, v, then p's chunks kt and kt + 1
  static constexpr uint32_t G = STAGES * STAGE;      // A's G ring [64 i][128] fp32, or qu, qv
  static constexpr uint32_t PT = G + 64 * 128 * 4;   // the P tiles, [2][8][128 threads] float4
  static constexpr uint32_t BAND = PT + 2 * 128 * 32 * 4;  // B's band ring [2][64 i][64] bf16,
  static constexpr uint32_t BARS = BAND + 4 * BOX64;       // or dqu, dqv; full, empty, q loaded
  static constexpr uint32_t BYTES = BARS + 8 * (2 * STAGES + 1) + ATOM;
  static_assert(STAGE % ATOM == 0 && BAND % ATOM == 0, "K3 dh 128: alignment");
  static_assert(BYTES <= 232448, "K3 dh 128: more shared memory than a block can have");
};
constexpr int DQ_P_FULL = 3, DQ_P_FREE = 5;  // named barriers of A and B, + the P tile (0, 1)

__global__ void __launch_bounds__(Dq128Layout::NT, 1) dq128_kernel(
    const __grid_constant__ CUtensorMap tqu, const __grid_constant__ CUtensorMap tqv,
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tp, const __grid_constant__ CUtensorMap tdqu,
    const __grid_constant__ CUtensorMap tdqv, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ lengths, int B, int H, int Tn, float scale) {
  using L = Dq128Layout;
  constexpr int D = 128, STAGES = L::STAGES;
  constexpr uint32_t TILE = L::TILE;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = (raw + ATOM - 1) & ~(ATOM - 1);
  uint8_t* const sm = smem_raw + (base - raw);
  auto full = [&](int s) { return base + L::BARS + 8 * s; };
  auto empty = [&](int s) { return base + L::BARS + 8 * (STAGES + s); };
  const uint32_t q_loaded = base + L::BARS + 8 * 2 * STAGES;  // an item's qu, qv are in G

  // work item it: 64 query rows from i0 of head h, batch row b
  const int n_q = (Tn + 63) / 64, n_items = n_q * H * B;
  auto item_of = [&](int it, int& i0, int& h, int& b) {
    const int rem = it % (H * B);
    i0 = it / (H * B) * 64;
    h = rem % H;
    b = rem / H;
  };
  auto length = [&](int b) { return min(max(lengths[b], 0), Tn); };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    hopper::prefetch_map(&tqu);  // under the barriers' setup
    hopper::prefetch_map(&tqv);
    hopper::prefetch_map(&tk);
    hopper::prefetch_map(&tv);
    hopper::prefetch_map(&tp);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full(s), 1);   // the TMA bytes
      hopper::mbar_init(empty(s), 8);  // every consumer warp
    }
    hopper::mbar_init(q_loaded, 1);
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
        const uint32_t st = base + s * L::STAGE;
        hopper::mbar_arrive_tx(full(s), L::STAGE);
        for (int c = 0; c < 2; ++c) {
          hopper::tma_load_4d(st + c * BOX64, &tk, full(s), 64 * c, h, 64 * kt, b);
          hopper::tma_load_4d(st + TILE + c * BOX64, &tv, full(s), 64 * c, h, 64 * kt, b);
          for (int x = 0; x < 2; ++x)  // chunk kt + x; rows past either end of p read as zeros
            hopper::tma_load_4d(st + (2 + x) * TILE + c * BOX64, &tp, full(s), 64 * c, h,
                                Tn - 64 - i0 + 64 * kt + 64 * x, 0);
        }
      }
    }
    return;
  }

  // consumer warpgroup w (0: A, 1: B); this thread's local rows rl0 and rl0
  // + 8, and its index tid in the warpgroup
  hopper::reg_alloc<CONSUMER_REGS_128>();
  const int w = (warp >> 2) - 1, t0 = lane & 3, rl0 = 16 * (warp & 3) + (lane >> 2);
  const int tid = threadIdx.x & 127;
  float4* const ptile = reinterpret_cast<float4*>(sm + L::PT);  // P tile x at ptile + 1024 x
  int n = 0;  // stages consumed, P tiles handed over (tile n % 2)

  if (w == 0) {  // ---- A: the band chunks, s, P
    const float scale2 = scale * LOG2E;  // P = 2^(s scale2 - lse log2(e))
    float* const G = reinterpret_cast<float*>(sm + L::G);
    const uint32_t g_at = base + L::G;
    uint32_t quf[8][4], qvf[8][4];
    // item it's qu and qv by TMA into G (2 tiles), which its first scatter
    // overwrites once every warp has taken its fragments
    auto load_q = [&](int it) {
      if (tid != 0) return;
      int i0, h, b;
      item_of(it, i0, h, b);
      hopper::mbar_arrive_tx(q_loaded, 2 * TILE);
      for (int x = 0; x < 2; ++x) {
        hopper::tma_load_4d(g_at + x * BOX64, &tqu, q_loaded, 64 * x, h, i0, b);
        hopper::tma_load_4d(g_at + TILE + x * BOX64, &tqv, q_loaded, 64 * x, h, i0, b);
      }
    };
    load_q(flash::tc::snake_item(0));  // round 0's item is block x's
    int k = 0;  // items taken
    for (int r = 0; r * (int)gridDim.x < n_items; ++r) {
      const int it = flash::tc::snake_item(r);
      if (it >= n_items) continue;
      int i0, h, b;
      item_of(it, i0, h, b);
      const int len = length(b), nk = (len + 63) / 64;
      const long long lrow = ((long long)b * H + h) * Tn;
      float l2[2];  // lse log2(e) of rows i0 + rl0, + 8
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = i0 + rl0 + 8 * hh;
        l2[hh] = i < Tn ? lse[lrow + i] * LOG2E : 0.f;
      }
      float sc[8][4], bd[8][4];
      hopper::mbar_wait(q_loaded, k & 1);
      hopper::ldsm_a<D>(quf, g_at, warp & 3, lane);
      hopper::ldsm_a<D>(qvf, g_at + TILE, warp & 3, lane);
      wg_sync(0);  // G is free for the scatters
      for (int kt = 0; kt < nk; ++kt, ++n) {
        const int s = n % STAGES;
        hopper::mbar_wait(full(s), (n / STAGES) & 1);
        const int t = fresh(t0), rl = fresh(rl0), g = rl & 7;
        const uint32_t k_at = base + s * L::STAGE, pc_at = k_at + 2 * TILE;  // p: chunk kt, kt + 1
        if (kt == 0) {  // chunk 0
          hopper::wgmma_fence();
          hopper::product_rs_k<64, D>(bd, qvf, pc_at);
          hopper::wgmma_wait<0>();
          hopper::fence_regs(bd);
          relpos::scatter_band(G, bd, 0, rl, g, t);
        }
        hopper::wgmma_fence();
        hopper::product_rs_k<64, D>(bd, qvf, pc_at + TILE);  // chunk kt + 1 of qv p^T
        hopper::product_rs_k<64, D>(sc, quf, k_at);          // s = qu k^T
        hopper::wgmma_wait<1>();
        hopper::fence_regs(bd);
        relpos::scatter_band(G, bd, kt + 1, rl, g, t);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sc);
        release(empty(s), lane);  // A has read the stage's k and p
        __syncwarp();
        // P = exp(scale (qu.k + qv.p) - lse), 0 on keys past the length
        const float* grow[2] = {relpos::band_row(G, rl, kt), relpos::band_row(G, rl + 8, kt)};
        const int kmax = len - 64 * kt;  // keys c < kmax are valid
        if (__builtin_expect(kmax < 64, 0)) {
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int c = 8 * nt + 2 * t;
              const float2 gv = *reinterpret_cast<const float2*>(grow[hh] + (c ^ (8 * g)));
              sc[nt][2 * hh] =
                  c < kmax ? ex2(fmaf(sc[nt][2 * hh] + gv.x, scale2, -l2[hh])) : 0.f;
              sc[nt][2 * hh + 1] =
                  c + 1 < kmax ? ex2(fmaf(sc[nt][2 * hh + 1] + gv.y, scale2, -l2[hh])) : 0.f;
            }
        } else {
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const float2 gv =
                  *reinterpret_cast<const float2*>(grow[hh] + ((8 * nt + 2 * t) ^ (8 * g)));
              sc[nt][2 * hh] = ex2(fmaf(sc[nt][2 * hh] + gv.x, scale2, -l2[hh]));
              sc[nt][2 * hh + 1] = ex2(fmaf(sc[nt][2 * hh + 1] + gv.y, scale2, -l2[hh]));
            }
        }
        const int x = n & 1;  // P tile x: B has read what tile n - 2 left there
        hopper::bar_sync(DQ_P_FREE + x, 256);
        const int tf = fresh(tid);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          ptile[1024 * x + 128 * j + tf] = make_float4(sc[j][0], sc[j][1], sc[j][2], sc[j][3]);
        hopper::bar_arrive(DQ_P_FULL + x, 256);
      }
      // the next item's q into G once every warp is done with G (the
      // scatters' generic writes ordered before the TMA's)
      hopper::fence_proxy_async();
      wg_sync(0);
      const int nx = flash::tc::snake_item(r + 1);
      if ((r + 1) * (int)gridDim.x < n_items && nx < n_items) load_q(nx);
      ++k;
    }
    // B's first arrival at each P tile: the barriers end balanced
    hopper::bar_sync(DQ_P_FREE, 256);
    hopper::bar_sync(DQ_P_FREE + 1, 256);
    return;
  }

  // ---- B: dP, dS, dqu, the band ring, dqv
  const bool issuer = tid == 0;  // issues B's TMA stores of dqu and dqv
  const long long rs = (long long)H * D;
  uint8_t* const band = sm + L::BAND;
  const uint32_t band_at = base + L::BAND;
  uint32_t dof[8][4], pd[4][4];  // dO, and dS as A fragments
  // dS (bf16, from its fragments) of key tile kt, or zeros, into the band
  // ring: row i and key 64 kt + c at column Q = 64 kt + c - i + 63, chunk Q / 64
  auto band_tile = [&](int kt, bool zeros) {
    const int t = fresh(t0), rl = fresh(rl0);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = rl + 8 * (e >> 1), q = 64 * kt + 8 * nt + 2 * t + (e & 1) - i + 63;
        const uint32_t pair = pd[nt >> 1][2 * (nt & 1) + (e >> 1)];
        *reinterpret_cast<uint16_t*>(band + ((q & 64) << 7) + sw128(i, q & 63)) =
            zeros ? (uint16_t)0 : (uint16_t)((e & 1) ? pair >> 16 : pair & 0xffffu);
      }
  };
  hopper::bar_arrive(DQ_P_FREE, 256);  // A's first two P find their tiles free
  hopper::bar_arrive(DQ_P_FREE + 1, 256);
  for (int r = 0; r * (int)gridDim.x < n_items; ++r) {
    const int it = flash::tc::snake_item(r);
    if (it >= n_items) continue;
    int i0, h, b;
    item_of(it, i0, h, b);
    const int len = length(b), nk = (len + 63) / 64;
    const int ia = i0 + rl0, ib = ia + 8;
    const long long lrow = ((long long)b * H + h) * Tn;
    const float dl[2] = {ia < Tn ? delta[lrow + ia] : 0.f, ib < Tn ? delta[lrow + ib] : 0.f};
    float aq[16][4], av[16][4], dp[8][4];
    // dO at the item's start (loaded during the last item's last tile, beside
    // dqu and dqv in flight, it made ptxas spill 28 bytes)
    flash::tc::load_a<D>(dof, dout + (long long)b * Tn * rs + (long long)h * D, ia, ib, Tn, rs,
                         t0);
    flash::tc::zero<16>(aq);
    flash::tc::zero<16>(av);
    for (int kt = 0; kt < nk; ++kt, ++n) {
      const int s = n % STAGES;
      hopper::mbar_wait(full(s), (n / STAGES) & 1);
      const uint32_t k_at = base + s * L::STAGE, v_at = k_at + TILE, pc_at = k_at + 2 * TILE;
      hopper::wgmma_fence();
      hopper::product_rs_k<64, D>(dp, dof, v_at);  // dP = dO v^T
      hopper::wgmma_wait<0>();  // dP, and the last tile's dqu and dqv
      hopper::fence_regs(dp);
      hopper::fence_regs(aq);
      hopper::fence_regs(av);
      hopper::fence_regs(pd);
      hopper::fence_regs(dof);
#pragma unroll
      for (int j = 0; j < 8; ++j)  // dP - delta, before P is waited for
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[j][e] -= dl[e >> 1];
      const int x = n & 1;
      if (kt == 0 && issuer) hopper::bulk_wait_read();  // the last item's dqu, dqv are out
      hopper::bar_sync(DQ_P_FULL + x, 256);  // A's P of this tile; every warp of B is past
                                             // the last tile's products
      if (kt == 0) {  // the band's cells no tile writes stay 0 for the item
        for (int idx = tid; idx < 2 * BOX64 / 16; idx += 128)
          reinterpret_cast<uint4*>(band)[idx] = make_uint4(0, 0, 0, 0);
      }
      // dS = P (dP - delta) scale, as A fragments
      const int tf = fresh(tid);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 pv = ptile[1024 * x + 128 * j + tf];
        const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[j][e] = pr[e] * dp[j][e] * scale;
      }
      hopper::bar_arrive(DQ_P_FREE + x, 256);
      pack_p<64>(pd, dp);
      hopper::wgmma_fence();
      product_rs<D, 64>(aq, pd, k_at);  // dqu += dS k, k MN-major
      if (kt == 0) wg_sync(1);  // the band is zeroed
      band_tile(kt, false);     // completes chunk kt, starts chunk kt + 1
      hopper::fence_proxy_async();
      wg_sync(1);
      hopper::wgmma_fence();
      product_ss_mn<D, 64>(av, band_at + (kt & 1) * BOX64, pc_at, 1);  // dqv += band_kt p_kt
      if (kt + 1 < nk) {  // the last stage's p serves the last chunk
        hopper::wgmma_wait<0>();
        hopper::fence_regs(aq);
        hopper::fence_regs(av);
        hopper::fence_regs(pd);
        release(empty(s), lane);  // B has read the stage's k, v and p
      }
    }
    hopper::wgmma_wait<0>();  // on every path, so that ptxas sees no read of an accumulator
    hopper::fence_regs(aq);   // in flight
    hopper::fence_regs(av);
    hopper::fence_regs(pd);
    if (nk > 0) {  // the last chunk, with a tile of zeros after the last
      const int s = (n - 1) % STAGES;
      wg_sync(1);  // every warp's dqv has read the ring
      band_tile(nk, true);
      hopper::fence_proxy_async();
      wg_sync(1);
      hopper::wgmma_fence();
      product_ss_mn<D, 64>(av, band_at + (nk & 1) * BOX64, base + s * L::STAGE + 3 * TILE, 1);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(av);
      release(empty(s), lane);
    }
    // dqu and dqv (bf16) into the band ring and the 16 KB after it, in the
    // 128-byte swizzle, and out by TMA stores, which skip rows past T
    if (nk == 0 && issuer) hopper::bulk_wait_read();
    wg_sync(1);  // every warp's last dqv has read the ring
    {
      const int t = fresh(t0), rl = fresh(rl0);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int dt = 0; dt < 16; ++dt) {
          const uint32_t at = (dt >> 3) * BOX64 + sw128(rl + 8 * hh, 8 * (dt & 7) + 2 * t);
          *reinterpret_cast<uint32_t*>(band + at) =
              pack_bf16x2(aq[dt][2 * hh], aq[dt][2 * hh + 1]);
          *reinterpret_cast<uint32_t*>(band + 2 * BOX64 + at) =
              pack_bf16x2(av[dt][2 * hh], av[dt][2 * hh + 1]);
        }
    }
    hopper::fence_proxy_async();
    wg_sync(1);
    if (issuer) {
      for (int x = 0; x < 2; ++x) {
        hopper::tma_store_4d(&tdqu, band_at + x * BOX64, 64 * x, h, i0, b);
        hopper::tma_store_4d(&tdqv, band_at + (2 + x) * BOX64, 64 * x, h, i0, b);
      }
      hopper::bulk_commit();
    }
  }
  if (issuer) hopper::bulk_wait_read();  // the staging outlives no store
}

// K3 at dh 128: the tensor maps and the launch, on a persistent grid
int launch_dq128(void* qu, void* qv, void* k, void* v, void* p, void* dout, void* lse,
                 void* delta, void* lengths, void* dqu, void* dqv, int B, int H, int Tn,
                 float scale, cudaStream_t stream) {
  CUtensorMap maps[7];  // qu, qv, k, v, dqu, dqv [B, T, H, 128] and p [2T-1, H, 128]
  const void* tensors[7] = {qu, qv, k, v, p, dqu, dqv};
  int err = 0;
  for (int i = 0; i < 7 && err == 0; ++i)
    err = i == 4 ? hopper::encode_bthd(&maps[i], tensors[i], 1, 2 * Tn - 1, H, 128, 64)
                 : hopper::encode_bthd(&maps[i], tensors[i], B, Tn, H, 128, 64);
  int grid = 0;
  if (err == 0) err = flash::persistent_grid((Tn + 63) / 64 * H * B, grid);
  if (err != 0) return err;
  void* args[] = {&maps[0], &maps[1], &maps[2], &maps[3], &maps[4], &maps[5], &maps[6],
                  &dout,    &lse,     &delta,   &lengths, &B,       &H,       &Tn,
                  &scale};
  return flash::launch(dq128_kernel, Dq128Layout::BYTES, Dq128Layout::NT, grid, 1, 1, stream,
                       args);
}

// K3 and K4 at dh 64: the tensor maps and the launch; dp == nullptr: K3
// (dqu, dqv into out0, out1), else K4 (dk, dv into out0, out1, dp added to)
template <int D>
int launch(void* qu, void* qv, void* k, void* v, void* p, void* dout, void* lse, void* delta,
           void* lengths, void* out0, void* out1, void* dp, int B, int H, int Tn, float scale,
           cudaStream_t stream) {
  CUtensorMap mqu, mqv, mk, mv, mp, mdo, mdp;
  int err = hopper::encode_bthd(&mqu, qu, B, Tn, H, D, 64);
  if (err == 0) err = hopper::encode_bthd(&mqv, qv, B, Tn, H, D, 64);
  if (err == 0) err = hopper::encode_bthd(&mk, k, B, Tn, H, D, 64);
  if (err == 0) err = hopper::encode_bthd(&mv, v, B, Tn, H, D, 64);
  if (err == 0) err = hopper::encode_bthd(&mp, p, 1, 2 * Tn - 1, H, D, 64);
  if (err == 0) err = hopper::encode_bthd(&mdo, dout, B, Tn, H, D, 64);
  if (err == 0 && dp != nullptr) err = hopper::encode_rows_f32(&mdp, dp, 2 * Tn - 1, H, D, 64);
  // a persistent grid, items in a snake order; one block an item measured
  // the same at the calibration shape (192 items of equal work) on the
  // H100: K3 0.6 % faster, K4 within the spread of two runs
  const int rows = dp == nullptr ? DqLayout<D>::TQ : DkvLayout<D>::TK;  // an item's
  int grid = 0;
  if (err == 0) err = flash::persistent_grid((Tn + rows - 1) / rows * H * B, grid);
  if (err != 0) return err;
  if (dp == nullptr) {
    void* args[] = {&mqu, &mqv, &mk,  &mv,   &mp, &mdo, &lse, &delta, &lengths,
                    &out0, &out1, &B, &H, &Tn, &scale};
    return flash::launch(dq_kernel<D>, DqLayout<D>::BYTES, DqLayout<D>::NT, grid, 1, 1, stream,
                         args);
  }
  void* args[] = {&mqu, &mqv, &mk,  &mv, &mp, &mdo, &mdp, &lse, &delta,
                  &lengths, &out0, &out1, &dp, &B, &H, &Tn, &scale};
  return flash::launch(dkv_kernel<D>, DkvLayout<D>::BYTES, DkvLayout<D>::NT, grid, 1, 1, stream,
                       args);
}

}  // namespace wg

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (every bf16 tensor 16-byte aligned).
// head_dim 64 or 128. Each returns a cudaError_t.

// K3: dqu, dqv [B, T, H, D] in the input dtype.
extern "C" int relpos_flash_bwd_dq(int dtype, void* qu, void* qv, void* k, void* v, void* p,
                                   void* dout, void* lse, void* delta, void* lengths, void* dqu,
                                   void* dqv, int B, int H, int Tn, int head_dim, float scale,
                                   void* stream) {
  if ((head_dim != 64 && head_dim != 128) || B <= 0 || H <= 0 || Tn <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    void* args[] = {&qu, &qv, &k, &v, &p, &dout, &lse, &delta, &lengths, &dqu, &dqv, &H, &Tn,
                    &scale};
    if (head_dim == 64)
      return flash::launch(f32::dq_kernel<64>, f32::Tiles<64>::SMEM_DQ, f32::NT,
                           (Tn + f32::Tiles<64>::FQ - 1) / f32::Tiles<64>::FQ, H, B, s, args);
    return flash::launch(f32::dq_kernel<128>, f32::Tiles<128>::SMEM_DQ, f32::NT,
                         (Tn + f32::Tiles<128>::FQ - 1) / f32::Tiles<128>::FQ, H, B, s, args);
  }
  if (dtype == 1) {
    const void* bf[] = {qu, qv, k, v, p, dout, dqu, dqv};
    if (!flash::aligned16(bf, 8)) return (int)cudaErrorMisalignedAddress;
    return head_dim == 64 ? wg::launch<64>(qu, qv, k, v, p, dout, lse, delta, lengths, dqu, dqv,
                                           nullptr, B, H, Tn, scale, s)
                          : wg::launch_dq128(qu, qv, k, v, p, dout, lse, delta, lengths, dqu,
                                             dqv, B, H, Tn, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

// K4: dk, dv [B, T, H, D] in the input dtype; dp [2T-1, H, D] fp32, added to
// (16-byte aligned for bf16).
extern "C" int relpos_flash_bwd_dkv(int dtype, void* qu, void* qv, void* k, void* v, void* p,
                                    void* dout, void* lse, void* delta, void* lengths, void* dk,
                                    void* dv, void* dp, int B, int H, int Tn, int head_dim,
                                    float scale, void* stream) {
  if ((head_dim != 64 && head_dim != 128) || B <= 0 || H <= 0 || Tn <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    void* args[] = {&qu, &qv, &k, &v, &p, &dout, &lse, &delta, &lengths, &dk, &dv, &dp, &H, &Tn,
                    &scale};
    if (head_dim == 64)
      return flash::launch(f32::dkv_kernel<64>, f32::Tiles<64>::SMEM_DKV, f32::NT,
                           (Tn + BKV - 1) / BKV, H, B, s, args);
    return flash::launch(f32::dkv_kernel<128>, f32::Tiles<128>::SMEM_DKV, f32::NT,
                         (Tn + BKV - 1) / BKV, H, B, s, args);
  }
  if (dtype == 1) {
    const void* bf[] = {qu, qv, k, v, p, dout, dk, dv, dp};
    if (!flash::aligned16(bf, 9)) return (int)cudaErrorMisalignedAddress;
    return head_dim == 64 ? wg::launch<64>(qu, qv, k, v, p, dout, lse, delta, lengths, dk, dv,
                                           dp, B, H, Tn, scale, s)
                          : wg::launch_dkv128(qu, qv, k, v, p, dout, lse, delta, lengths, dk, dv,
                                              dp, B, H, Tn, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The launch shape of the bf16 K3 and K4 at head_dim 64 or 128 into out[6],
// as relpos_flash.cu's relpos_flash_fwd_shape: threads a block, consumer
// warpgroups, blocks a cluster, dynamic shared memory bytes, registers a
// thread at launch and local memory (spill) bytes a thread. Each returns a
// cudaError_t.
template <typename K>
static int launch_shape(K kernel, int threads, int warpgroups, int bytes, int* out) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  out[0] = threads, out[1] = warpgroups, out[2] = 1, out[3] = bytes;
  out[4] = attr.numRegs;
  out[5] = (int)attr.localSizeBytes;
  return (int)err;
}

extern "C" int relpos_flash_bwd_dq_shape(int head_dim, int* out) {
  using L64 = wg::DqLayout<64>;
  using L128 = wg::Dq128Layout;
  if (head_dim == 64) return launch_shape(wg::dq_kernel<64>, L64::NT, L64::WGS, L64::BYTES, out);
  if (head_dim == 128) return launch_shape(wg::dq128_kernel, L128::NT, 2, L128::BYTES, out);
  return (int)cudaErrorInvalidValue;
}

extern "C" int relpos_flash_bwd_dkv_shape(int head_dim, int* out) {
  using L64 = wg::DkvLayout<64>;
  using L128 = wg::Dkv128Layout;
  if (head_dim == 64) return launch_shape(wg::dkv_kernel<64>, L64::NT, L64::WGS, L64::BYTES, out);
  if (head_dim == 128) return launch_shape(wg::dkv128_kernel, L128::NT, 2, L128::BYTES, out);
  return (int)cudaErrorInvalidValue;
}
