// Tiles, masks and register-tile helpers shared by the causal GQA flash
// attention kernels (flash_fwd.cu: K5, K8 with segments and K11 with
// positions; flash_bwd.cu: K6, K7, their segment forms K9, K10 and their
// position forms K12, K13).
//
// Layouts: q, o, dO, dq are [B, Tq, H, D] and k, v, dk, dv [B, Tkv, G, D]
// (the Linear outputs viewed per head; row stride H*D or G*D); query head h
// reads kv head h*G/H; segment ids [B, T] int32; positions [Tq] and [Tkv]
// int32, shared by the batch. Tiles are 64 query rows by 64 keys (BQ, BKV);
// the bf16 kernels take their own larger tiles through the TQ / TK template
// arguments of Mask and Pairs, which default to these.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"

namespace flash {

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr float NEG = -1e30f;

// The width of a head of D columns in the bf16 kernels' shared memory: whole
// TMA boxes of 64 columns. At D = 96 (Phi-3) a row is two boxes, the second
// box's last 32 columns zeros (TMA fills what lies past the row with zeros,
// hopper.cuh:encode_bthd), so those kernels take D = 128's tiles; they skip
// the zero columns of each reduction over D, and their products into D are
// 96 columns wide.
__host__ __device__ constexpr int padded(int D) { return (D + 63) / 64 * 64; }

// The causal / sliding-window mask (window 0 = none) over Tq rows and Tkv
// keys, row i against key i: nemo_tpu/ops/flash_attention.py:_mask_block,
// and the tile ranges of _block_active and _needs_mask. The position form
// (K11-K13) builds it with causal = window = 0, so that it only bounds the
// rows and keys, and masks by positions instead (Pairs<POS>).
struct Mask {
  int Tq, Tkv, causal, window;

  __device__ __forceinline__ bool allowed(int i, int j) const {
    return i < Tq && j < Tkv && (!causal || j <= i) && (window <= 0 || j > i - window);
  }
  // the keys [lo, hi] that row i keeps: allowed(i, j) for 0 <= j is lo <= j <= hi
  __device__ __forceinline__ void row_keys(int i, int& lo, int& hi) const {
    hi = i < Tq ? (causal ? min(i, Tkv - 1) : Tkv - 1) : -1;
    lo = window > 0 ? i - window + 1 : 0;
  }
  // the key tiles [lo, hi] (of TK keys) that hold an unmasked pair for the
  // TQ query rows at i0
  template <int TQ = BQ, int TK = BKV>
  __device__ __forceinline__ void kv_range(int i0, int& lo, int& hi) const {
    const int n = (Tkv + TK - 1) / TK;
    hi = causal ? min((i0 + TQ - 1) / TK, n - 1) : n - 1;
    lo = window > 0 ? max(i0 - window + 1, 0) / TK : 0;
  }
  // the rows [lo, hi] that key j is kept by: allowed(i, j) for 0 <= i is
  // lo <= i <= hi (the transpose of row_keys)
  __device__ __forceinline__ void key_rows(int j, int& lo, int& hi) const {
    lo = causal ? j : 0;
    hi = j < Tkv ? (window > 0 ? min(j + window - 1, Tq - 1) : Tq - 1) : -1;
  }
  // the query tiles [lo, hi] (of TQ rows) that hold an unmasked pair for
  // the TK keys at j0
  template <int TQ = BQ, int TK = BKV>
  __device__ __forceinline__ void q_range(int j0, int& lo, int& hi) const {
    const int n = (Tq + TQ - 1) / TQ;
    lo = causal ? j0 / TQ : 0;
    hi = window > 0 ? min((j0 + TK - 1 + window - 1) / TQ, n - 1) : n - 1;
  }
  // a tile pair (TQ rows at i0, TK keys at j0) with masked elements (a
  // boundary tile, or one past the end)
  template <int TQ = BQ, int TK = BKV>
  __device__ __forceinline__ bool edge(int i0, int j0) const {
    return (causal && j0 + TK - 1 > i0) || (window > 0 && j0 <= i0 + TQ - 1 - window) ||
           j0 + TK > Tkv || i0 + TQ > Tq;
  }
};

constexpr float NEG_HALF = NEG / 2;  // a running max at or below it: no key seen yet

// What keeps a pair beyond Mask, the kernels' policy:
// - PLAIN (K5-K7): nothing more; every test folds to a constant.
// - SEG (K8-K10), packed rows: a pair (i, j) is kept only where both tokens
//   carry the same nonzero id (nemo_tpu/ops/flash_attention.py:_seg_mask);
//   id 0 is padding and sees nothing. The values are the batch row's ids,
//   for the rows and the keys alike.
// - POS (K11-K13), explicit positions: a pair is kept where kpos[j] <=
//   qpos[i] (causal) and kpos[j] > qpos[i] - window (window > 0)
//   (_pos_mask); the values are qpos [Tq] for the rows and kpos [Tkv] for
//   the keys, in any order.
// `qr` and `kr` hold the [min, max] value of each 64-row tile of the rows
// and of the keys (a pre-pass). A tile pair is skipped where those ranges
// show that it keeps no pair (_seg_overlap, _pos_active: sound for values
// in any order), and needs no element mask where they show that it keeps
// every pair. The forward's key tiles of 128 merge two entries (min of the
// minima, max of the maxima), which keeps both tests sound.
enum Mode { PLAIN = 0, SEG = 1, POS = 2 };

template <int M>
struct Pairs {
  const int *qv, *kv;  // the rows' and the keys' values
  const int *qr, *kr;  // [ceil(Tq / 64)][2], [ceil(Tkv / 64)][2]
  int Tq, Tkv, causal, window;

  __device__ __forceinline__ int qid(int t) const {
    if constexpr (M != PLAIN) return t < Tq ? qv[t] : 0;
    return 1;
  }
  __device__ __forceinline__ int kid(int t) const {
    if constexpr (M != PLAIN) return t < Tkv ? kv[t] : 0;
    return 1;
  }
  // the pair of a row with value qs and a key with value ks is kept
  __device__ __forceinline__ bool same(int qs, int ks) const {
    if constexpr (M == SEG) return qs == ks && ks > 0;
    if constexpr (M == POS) return (!causal || ks <= qs) && (window <= 0 || ks > qs - window);
    return true;
  }
  // the key values [lo, hi] that a row with value qs keeps: same(qs, ks) is
  // lo <= ks <= hi
  __device__ __forceinline__ void kept(int qs, int& lo, int& hi) const {
    lo = INT_MIN;
    hi = INT_MAX;
    if constexpr (M == SEG) {
      lo = qs > 0 ? qs : 1;
      hi = qs > 0 ? qs : 0;
    }
    if constexpr (M == POS) {
      if (window > 0) lo = qs - window + 1;
      if (causal) hi = qs;
    }
  }
  // the row values [lo, hi] that a key with value ks is kept by: same(qs,
  // ks) is lo <= qs <= hi (the transpose of kept)
  __device__ __forceinline__ void kept_by(int ks, int& lo, int& hi) const {
    lo = INT_MIN;
    hi = INT_MAX;
    if constexpr (M == SEG) {
      lo = ks > 0 ? ks : 1;
      hi = ks > 0 ? ks : 0;
    }
    if constexpr (M == POS) {
      if (causal) lo = ks;
      if (window > 0) hi = ks + window - 1;
    }
  }
  // [lo, hi]: the [min, max] value of the TK keys from j0 (a multiple of
  // TK), merged from their 64-key entries; past Tkv nothing is read
  template <int TK>
  __device__ __forceinline__ void key_range(int j0, int& lo, int& hi) const {
    const int* b = kr + 2 * (j0 / BKV);
    const int n = (Tkv + BKV - 1) / BKV - j0 / BKV;  // entries left
    lo = b[0];
    hi = b[1];
#pragma unroll
    for (int e = 1; e < TK / BKV; ++e)
      if (e < n) {
        lo = min(lo, b[2 * e]);
        hi = max(hi, b[2 * e + 1]);
      }
  }
  // the tile pair of the 64 rows at i0 and the TK keys at j0 may hold a
  // kept pair
  template <int TK = BKV>
  __device__ __forceinline__ bool active(int i0, int j0) const {
    if constexpr (M != PLAIN) {
      const int* a = qr + 2 * (i0 / BQ);
      int b0, b1;
      key_range<TK>(j0, b0, b1);
      if constexpr (M == SEG) return b0 <= a[1] && b1 >= a[0];
      return (!causal || b0 <= a[1]) && (window <= 0 || b1 > a[0] - window);
    }
    return true;
  }
  // every pair of that tile pair is kept
  template <int TK = BKV>
  __device__ __forceinline__ bool uniform(int i0, int j0) const {
    if constexpr (M != PLAIN) {
      const int* a = qr + 2 * (i0 / BQ);
      int b0, b1;
      key_range<TK>(j0, b0, b1);
      if constexpr (M == SEG) return a[0] > 0 && a[0] == a[1] && b0 == b1 && a[0] == b0;
      return (!causal || b1 <= a[0]) && (window <= 0 || b0 > a[1] - window);
    }
    return true;
  }
};

// the policy of batch row b. SEG: vals = seg [B, Tq] (Tq = Tkv) and ranges
// [B, ceil(T / 64), 2]; POS: vals = qpos, vals2 = kpos, ranges and ranges2
// their tile ranges, shared by the batch; PLAIN: all null
template <int M>
__device__ __forceinline__ Pairs<M> pairs_of(const int* vals, const int* vals2,
                                             const int* ranges, const int* ranges2, int b,
                                             int Tq, int Tkv, int causal, int window) {
  if constexpr (M == SEG) {
    const int* ids = vals + (long long)b * Tq;
    const int* range = ranges + 2LL * b * ((Tq + BQ - 1) / BQ);
    return {ids, ids, range, range, Tq, Tkv, causal, window};
  }
  return {vals, vals2, ranges, ranges2, Tq, Tkv, causal, window};
}

// the Mask a policy runs under: without its causal and window terms for
// positions, which Pairs<POS> applies
template <int M>
__device__ __forceinline__ Mask mask_of(int Tq, int Tkv, int causal, int window) {
  if constexpr (M == POS) return {Tq, Tkv, 0, 0};
  return {Tq, Tkv, causal, window};
}

// keys [j0, j0 + BKV) (kid) or rows [i0, i0 + BQ) (qid) of a policy's values
// into shared memory; nothing without one
template <int M>
__device__ __forceinline__ void stage_kids(int* dst, const Pairs<M>& pr, int j0) {
  if constexpr (M != PLAIN)
    for (int idx = threadIdx.x; idx < BKV; idx += blockDim.x) dst[idx] = pr.kid(j0 + idx);
}
template <int M>
__device__ __forceinline__ void stage_qids(int* dst, const Pairs<M>& pr, int i0) {
  if constexpr (M != PLAIN)
    for (int idx = threadIdx.x; idx < BQ; idx += blockDim.x) dst[idx] = pr.qid(i0 + idx);
}

// ------------------------------------------------- bf16 tiles in registers

namespace tc {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// an m64 x NK accumulator tile (NK / 8 blocks of 8 columns) as bf16 A
// fragments of NK / 16 steps of 16 columns: the accumulator's layout is the
// A operand's (hopper.cuh), so the scores of one product feed the next
template <int NK>
__device__ __forceinline__ void pack_p(uint32_t (&a)[NK / 16][4], const float (&s)[NK / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk) {
    a[kk][0] = pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
    a[kk][1] = pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
    a[kk][2] = pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    a[kk][3] = pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
}

// x as the compiler sees it anew wherever this is called (an empty asm): a
// lane index laundered so in each tile keeps ptxas from holding the many
// loop-invariant shared-memory addresses that follow from it in registers
// across the tiles (the dh-128 K1 and K4 spilled so)
__device__ __forceinline__ int fresh(int x) {
  asm volatile("" : "+r"(x));
  return x;
}

// The register A fragments (K / 16 steps of 16 columns, hopper.cuh) of a
// warpgroup's 64-row A operand, read from a bf16 [rows][rs] tensor in device
// memory at src: this thread's rows ra and rb = ra + 8, columns 16 ks + 2 t
// (+ 8); rows at or past Tn are zeros. Every load is issued, from a row
// clamped into the tensor, and selected after (no branch an element).
template <int K>
__device__ __forceinline__ void load_a(uint32_t (&a)[K / 16][4], const bf16* src, int ra, int rb,
                                       int Tn, long long rs, int t) {
  const bool oka = ra < Tn, okb = rb < Tn;
  const unsigned int* la =
      reinterpret_cast<const unsigned int*>(src + (long long)min(ra, Tn - 1) * rs + 2 * t);
  const unsigned int* lb =
      reinterpret_cast<const unsigned int*>(src + (long long)min(rb, Tn - 1) * rs + 2 * t);
#pragma unroll
  for (int ks = 0; ks < K / 16; ++ks) {
    const unsigned int x0 = __ldg(la + 8 * ks), x1 = __ldg(lb + 8 * ks);
    const unsigned int x2 = __ldg(la + 8 * ks + 4), x3 = __ldg(lb + 8 * ks + 4);
    a[ks][0] = oka ? x0 : 0u;
    a[ks][1] = okb ? x1 : 0u;
    a[ks][2] = oka ? x2 : 0u;
    a[ks][3] = okb ? x3 : 0u;
  }
}

// A persistent grid's work item for round r: r G + x (G blocks, block x) or,
// in odd rounds, r G + G - 1 - x: a snake, so that no block takes the
// heaviest item of every round (a plain round robin did, and measured 3-6 %
// slower on K5 and on K11's diagonal step)
__device__ __forceinline__ int snake_item(int r) {
  const int G = gridDim.x, x = blockIdx.x;
  return r * G + ((r & 1) ? G - 1 - x : x);
}

template <int N>
__device__ __forceinline__ void zero(float acc[][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
}

// rows ra, rb of a 16 x 8 NDT accumulator into a [T, heads, D] bf16 tensor
// (dst at the head), times `mul[hh]` for row ra (hh 0) and rb (hh 1)
template <int NDT>
__device__ __forceinline__ void store_rows(bf16* dst, const float acc[][4], int ra, int rb,
                                           int Tn, long long rs, int t,
                                           const float mul[2]) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = hh ? rb : ra;
    if (r >= Tn) continue;
#pragma unroll
    for (int dt = 0; dt < NDT; ++dt)
      *reinterpret_cast<uint32_t*>(dst + r * rs + 8 * dt + 2 * t) =
          pack_bf16x2(acc[dt][2 * hh] * mul[hh], acc[dt][2 * hh + 1] * mul[hh]);
  }
}

}  // namespace tc

// head_dim in {64, 96, 128}, B, H, G, Tq, Tkv positive, H a multiple of G,
// window >= 0
inline bool valid_shape(int B, int H, int G, int Tq, int Tkv, int head_dim, int window) {
  return (head_dim == 64 || head_dim == 96 || head_dim == 128) && B > 0 && H > 0 && G > 0 &&
         Tq > 0 && Tkv > 0 && H % G == 0 && window >= 0;
}

// f(std::integral_constant<int, D>{}) for head_dim D in {64, 96, 128}: each
// head dim goes to its own instance of a kernel, and any other is refused
// (cudaErrorInvalidValue)
template <typename F>
int with_head_dim(int head_dim, F&& f) {
  switch (head_dim) {
    case 64: return f(std::integral_constant<int, 64>{});
    case 96: return f(std::integral_constant<int, 96>{});
    case 128: return f(std::integral_constant<int, 128>{});
  }
  return (int)cudaErrorInvalidValue;
}

inline bool aligned16(const void* const* ptrs, int n) {
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return false;
  return true;
}

// A persistent grid: one block a multiprocessor, or an item where there are
// fewer items (blocks take items by flash::tc::snake_item). Returns a
// cudaError_t.
inline int persistent_grid(int n_items, int& grid) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  grid = n_items < sms ? n_items : sms;
  return (int)e;
}

// launch `kernel` on grid (grid_x, grid_y, B) with `smem` bytes of dynamic
// shared memory; returns a cudaError_t
template <typename K>
int launch(K kernel, size_t smem, int threads, int grid_x, int grid_y, int B,
           cudaStream_t stream, void** args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernel(reinterpret_cast<const void*>(kernel), dim3(grid_x, grid_y, B),
                         dim3(threads), args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace flash
