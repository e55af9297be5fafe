// Fused conv-ReLU-conv-ReLU subsampling (x4) for Hopper (sm_90a), fp32 or bf16:
// K2.
//
// Replaces the TPU kernel nemo_tpu/ops/subsampling_kernel.py:_kernel
// (fused_subsampling_x4). It computes the two 3x3 stride-2 convolutions of
// the Conformer's striding ConvSubsampling:
//
//   h1[t1,f1,c]  = relu(b1[c] + sum_{di,df} x[2t1+di-1, 2f1+df-1] w1[di,df,c])
//                  for t1 < T2, f1 < F2, and 0 outside (conv2's zero padding)
//   out[t4,f4,o] = relu(b2[o] + sum_{di,df,c} h1[2t4+di-1, 2f4+df-1, c] w2[di,df,c,o])
//
// written as [B, T4, F4*C], flattened (f, c) like the JAX reshape. h1 is
// rounded to the input type (bf16 or fp32) before conv2, as the plain version
// does; every sum is accumulated in fp32. conv2 is an implicit GEMM of M =
// B*T4*F4 output positions by N = C output channels over K = 9*C; h1 never
// touches device memory.
//
// Bound on the H100: 2 * B * T4 * F4 * 9 * C * C operations for conv2 (2.3e12
// at B=32, 30 s, C=512: 2.3 ms at the bf16 tensor-core peak) against ~0.5 GB
// of bf16 output, so the operations bound it. Second, the L2: a block reads
// all of w2 for its TN output channels (9 C TN bf16, 2.36 MB at C=512, TN =
// 256) for 128 positions, 128 flops a byte, 19.0 GB from L2 a launch at the
// main path's shape.
//
// - bf16 (the main path; csrc/hopper.cuh, TMA and wgmma, no mma.sync): a
//   block of 384 threads, a producer warpgroup that hands its registers to
//   two consumer warpgroups (setmaxnreg 40 / 232), a persistent grid over
//   items of 128 GEMM rows (whole output rows: 6 rows of F4 + 1 = 21 at F4 =
//   20) by TN = 256 output channels (128 where C is no multiple of 256). The
//   producer loads w2 by TMA into a ring of 5 stages, one tap of 32 input
//   channels by TN output channels a stage (MN-major, 128-byte swizzle).
//   conv2 is m64nTNk16 wgmma SS, both operands from shared memory: h1 is kept
//   a chunk of 32 channels at a time as four parity planes with no swizzle
//   (hopper.cuh:desc_plain), so each tap's A operand is a window of 128
//   consecutive rows of one plane, read in place (no im2col). conv1 runs on
//   the tensor cores too, as a K = 16 product of x's 3 x 3 patches (with a
//   1 for the bias) by w1 and b1, m64n32k16 a tile of 64 cells, the next
//   chunk's tiles issued with the current chunk's conv2 products into the
//   next of three patch buffers; two taps of products stay in flight. The
//   epilogue stages relu(acc) (b2 is the accumulators' start) through a free
//   patch buffer and writes whole rows by 16-byte stores. See wg:: below.
// - fp32 (the exactness check): scalar fp32 FMAs, 64 positions x 128
//   channels a block, each thread an 8 x 4 tile.
//
// Layouts: x [B, T, F]; w1 [3, 3, C] (HWIO with I = 1); b1 [C];
// w2 [3, 3, C, C] (HWIO); b2 [C]; out [B, T4, F4 * C]. C % 128 == 0.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "flash_tiles.cuh"
#include "hopper.cuh"

namespace {

constexpr int CK = 16;  // input channels per chunk

// rows of the h1 patch that `tm` consecutive positions can need
__host__ __device__ inline int patch_rows(int tm, int F4) {
  return 2 * ((tm - 1 + F4 - 1) / F4) + 3;
}

// ---------------------------------------------------------------- fp32 path

namespace f32 {

constexpr int TM = 64;   // output positions per block
constexpr int TN = 128;  // output channels per block
constexpr int NT = 256;  // 8 x 32 threads: 8 positions x 4 channels each

__host__ inline size_t smem_bytes(int F4) {
  return (size_t)(CK * patch_rows(TM, F4) * (2 * F4 + 1) + 9 * CK * TN) * sizeof(float);
}

__global__ void __launch_bounds__(NT, 2) kernel(
    const float* __restrict__ x, const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2, float* __restrict__ out, int Tn,
    int F, int C, int T2, int F2, int T4, int F4) {
  extern __shared__ float4 smem4[];
  float* sH = reinterpret_cast<float*>(smem4);  // [CK][R][W] h1 patch
  const int R = patch_rows(TM, F4), W = 2 * F4 + 1;
  float* sW = sH + CK * R * W;                    // [9][CK][TN] w2 chunk

  const int m0 = blockIdx.x * TM, n0 = blockIdx.y * TN, b = blockIdx.z;
  const int M = T4 * F4;
  const int tid = threadIdx.x, tm = tid >> 5, tn = tid & 31;
  const int t4_lo = m0 / F4;
  const int t1_lo = 2 * t4_lo - 1;

  // patch offset of each of this thread's positions at (di, df) = (0, 0):
  // row 2*(t4 - t4_lo) + di, column 2*f4 + df (column c holds f1 = c - 1)
  int off[8];
#pragma unroll
  for (int mi = 0; mi < 8; ++mi) {
    const int mm = min(m0 + 8 * tm + mi, M - 1);
    const int t4 = mm / F4, f4 = mm - (mm / F4) * F4;
    off[mi] = 2 * (t4 - t4_lo) * W + 2 * f4;
  }
  float acc[8][4];
#pragma unroll
  for (int mi = 0; mi < 8; ++mi)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[mi][q] = 0.f;

  const float* xb = x + (long long)b * Tn * F;
  for (int c0 = 0; c0 < C; c0 += CK) {
    __syncthreads();  // the previous chunk is no longer read
    for (int idx = tid; idx < CK * R * W; idx += NT) {
      const int ck = idx / (R * W), rem = idx - ck * (R * W);
      const int r = rem / W, col = rem - r * W;
      const int t1 = t1_lo + r, f1 = col - 1, c = c0 + ck;
      float val = 0.f;
      if (t1 >= 0 && t1 < T2 && f1 >= 0 && f1 < F2) {
        float a = 0.f;
#pragma unroll
        for (int di = 0; di < 3; ++di) {
          const int tx = 2 * t1 + di - 1;
          if (tx < 0 || tx >= Tn) continue;
#pragma unroll
          for (int df = 0; df < 3; ++df) {
            const int fx = 2 * f1 + df - 1;
            if (fx < 0 || fx >= F) continue;
            a = fmaf(xb[(long long)tx * F + fx], w1[(di * 3 + df) * C + c], a);
          }
        }
        val = fmaxf(a + b1[c], 0.f);
      }
      sH[idx] = val;
    }
    for (int idx = tid; idx < 9 * CK * TN; idx += NT) {
      const int k9 = idx / (CK * TN), rem = idx - k9 * (CK * TN);
      const int ck = rem / TN, n = rem - ck * TN;
      sW[idx] = w2[((long long)k9 * C + c0 + ck) * C + n0 + n];
    }
    __syncthreads();

    for (int ck = 0; ck < CK; ++ck) {
      const float* hc = sH + ck * R * W;
#pragma unroll
      for (int k9 = 0; k9 < 9; ++k9) {
        const int koff = (k9 / 3) * W + (k9 % 3);
        const float4 w = *reinterpret_cast<const float4*>(&sW[(k9 * CK + ck) * TN + 4 * tn]);
#pragma unroll
        for (int mi = 0; mi < 8; ++mi) {
          const float a = hc[off[mi] + koff];
          acc[mi][0] = fmaf(a, w.x, acc[mi][0]);
          acc[mi][1] = fmaf(a, w.y, acc[mi][1]);
          acc[mi][2] = fmaf(a, w.z, acc[mi][2]);
          acc[mi][3] = fmaf(a, w.w, acc[mi][3]);
        }
      }
    }
  }

  float bias[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) bias[q] = b2[n0 + 4 * tn + q];
#pragma unroll
  for (int mi = 0; mi < 8; ++mi) {
    const int m = m0 + 8 * tm + mi;
    if (m >= M) continue;
    const long long o = ((long long)b * M + m) * C + n0 + 4 * tn;
#pragma unroll
    for (int q = 0; q < 4; ++q) out[o + q] = fmaxf(acc[mi][q] + bias[q], 0.f);
  }
}

}  // namespace f32

// ------------------------------------------------ bf16 path: TMA and wgmma

namespace wg {

using bf16 = __nv_bfloat16;
using hopper::ATOM;

constexpr int WGS = 2;               // consumer warpgroups, 64 GEMM rows each
constexpr int NT = 128 * (WGS + 1);  // and a producer warpgroup, one thread of it at work
constexpr int PRODUCER_REGS = 40;    // registers a thread, after the split (setmaxnreg):
constexpr int CONSUMER_REGS = 232;   // 128 x 40 + 256 x 232 = 384 x 168 at launch
constexpr int TM = 64 * WGS;         // GEMM rows a block
constexpr int KC = 32;               // input channels a chunk
constexpr int CELLS = 640;           // patch cells a chunk: 10 conv1 tiles of 64
constexpr int TILES = CELLS / 64 / WGS;  // conv1 tiles a warpgroup a chunk
constexpr int FW_MAX = 31;           // output columns an item: a plane row of <= 32 cells

// Work item: (batch row b, R4 output rows from t4_lo, FW output columns from
// f0, TN output channels from n0). Its GEMM row m = t4r PW + fr (PW = FW + 1)
// is output (t4_lo + t4r, f0 + fr); rows with fr = FW, or past the item, are
// computed and dropped.
//
// The h1 patch of a chunk of KC channels is kept as four parity planes, so
// that each of conv2's 9 taps reads its A operand as a window of 128
// consecutive rows of one plane: plane 2 rp + cp holds h1 rows 2 (t4_lo + a)
// - 1 + rp (a < R4 + 1) by columns 2 (f0 + u) - 1 + cp (u < PW), cell
// (2 rp + cp) RP PW + a PW + u (RP = R4 + 1). Tap (di, df) of GEMM row m
// reads plane (di == 1, df == 1) at cell m + (di == 2) PW + (df == 2). Cells
// are [KC / 8][CELLS][8] bf16 (K-major core matrices with no swizzle,
// hopper.cuh:desc_plain), so a window may start at any row.
struct Item {
  int b, t4_lo, f0, n0;
};
struct Shape {
  int Tn, F, C, T2, F2, T4, F4, FW, PW, R4, RP, n_tg, n_fg, n_nt;
  // item `it`: the output channel tiles of one patch side by side, then its
  // column groups, row groups and batch rows
  __device__ __forceinline__ Item item(int it, int TN) const {
    Item x;
    x.n0 = it % n_nt * TN;
    it /= n_nt;
    x.f0 = it % n_fg * FW;
    it /= n_fg;
    x.t4_lo = it % n_tg * R4;
    x.b = it / n_tg;
    return x;
  }
};

template <int TN>
struct Layout {
  static constexpr int STAGES = TN == 256 ? 5 : 8;
  static constexpr uint32_t BOXB = KC * hopper::BOX_ROW_BYTES;  // w2: 64 channels x KC rows
  static constexpr uint32_t STAGE = (TN / 64) * BOXB;           // one tap of a chunk
  static constexpr uint32_t PATCH = CELLS * KC * 2;             // a chunk's h1 patch
  static constexpr uint32_t XCOL = CELLS * 16 * 2;              // x patches: [2][CELLS][8]
  static constexpr uint32_t W1 = KC * 16 * 2;                   // w1 and b1: [2][KC][8]
  static constexpr uint32_t PATCHES = STAGES * STAGE;           // three patch buffers
  static constexpr uint32_t XC = PATCHES + 3 * PATCH;
  static constexpr uint32_t W1S = XC + XCOL;                    // three w1 buffers
  static constexpr uint32_t B2 = W1S + 3 * W1;                  // the item's b2 in fp32
  static constexpr uint32_t BARS = B2 + TN * 4;                 // full, empty
  static constexpr uint32_t BYTES = BARS + 8 * 2 * STAGES + ATOM;  // + alignment slack
};

template <int TN>
__global__ void __launch_bounds__(NT, 1) kernel(
    const __grid_constant__ CUtensorMap tw2, const bf16* __restrict__ x,
    const bf16* __restrict__ w1, const bf16* __restrict__ b1, const bf16* __restrict__ b2,
    bf16* __restrict__ out, const Shape sh, int B) {
  using L = Layout<TN>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = (raw + ATOM - 1) & ~(ATOM - 1);
  uint8_t* const sm = smem_raw + (base - raw);
  auto full = [&](int s) { return base + L::BARS + 8 * s; };
  auto empty = [&](int s) { return base + L::BARS + 8 * (STAGES + s); };
  const int C = sh.C, NC = C / KC;
  const int n_items = B * sh.n_tg * sh.n_fg * sh.n_nt;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full(s), 1);         // the TMA bytes
      hopper::mbar_init(empty(s), 4 * WGS);  // every consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp < 4) {
    // the producer: w2 [9 C][C] by TMA, a stage a (chunk, tap): KC input
    // channels by TN output channels, TN / 64 boxes, MN-major for wgmma
    hopper::reg_dealloc<PRODUCER_REGS>();
    if (threadIdx.x != 0) return;
    int n = 0;  // stages filled
    for (int r = 0; r * (int)gridDim.x < n_items; ++r) {
      const int it = flash::tc::snake_item(r);
      if (it >= n_items) continue;
      const int n0 = sh.item(it, TN).n0;
      for (int c = 0; c < NC; ++c)
        for (int tap = 0; tap < 9; ++tap, ++n) {
          const int s = n % STAGES, use = n / STAGES;
          if (use > 0) hopper::mbar_wait(empty(s), (use - 1) & 1);  // the stage is read out
          const uint32_t st = base + s * L::STAGE;
          hopper::mbar_arrive_tx(full(s), L::STAGE);
          for (int bx = 0; bx < TN / 64; ++bx)
            hopper::tma_load_4d(st + bx * L::BOXB, &tw2, full(s), n0 + 64 * bx, 0,
                                tap * C + c * KC, 0);
        }
    }
    return;
  }

  hopper::reg_alloc<CONSUMER_REGS>();
  const int w = (warp >> 2) - 1, wi = warp & 3, g = lane >> 2, t = lane & 3;
  const int ct = threadIdx.x - 128;  // 0 .. 255 over both consumer warpgroups
  const int PW = sh.PW, RP = sh.RP, plane = RP * PW;
  float* const b2s = reinterpret_cast<float*>(sm + L::B2);
  auto sync = [] { hopper::bar_sync(1, 128 * WGS); };  // both consumer warpgroups
  auto release = [&](uint32_t bar) {  // this warp is done with what `bar` guards
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(bar);
  };
  // Each item's inputs besides w2 are staged by the threads (global loads,
  // whose latency would stall the products): x's patches, conv1's B operand
  // of chunks 0 and 1 and b2, for the first item before the loop and for
  // the next during the last chunk of an item, which reads none of them;
  // conv1's B operand of chunk c + 2 is loaded into registers at the start
  // of chunk c and stored at its end.
  //
  // conv1's B operand for chunk c, row idx of [2][KC][8]: the taps of
  // channel c KC + n, b1 as the tenth (x's tenth column is 1 on the cells
  // conv1 computes), zeros after
  auto load_w1 = [&](int c, int idx) {
    const int j = idx / KC, ch = c * KC + idx % KC;
    uint4 v;
    uint32_t* const vv = &v.x;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float pr[2];
#pragma unroll
      for (int z = 0; z < 2; ++z) {
        const int kk = 8 * j + 2 * e + z;
        pr[z] = kk < 9 ? __bfloat162float(w1[kk * C + ch])
                       : (kk == 9 ? __bfloat162float(b1[ch]) : 0.f);
      }
      vv[e] = pack_bf16x2(pr[0], pr[1]);
    }
    return v;
  };
  auto store_w1 = [&](int slot, int idx, uint4 v) {
    *reinterpret_cast<uint4*>(sm + L::W1S + slot * L::W1 + idx * 16) = v;
  };
  // cell q of x's patches ([2][CELLS][8]): the 3 x 3 input values of the
  // cell's conv1 output (zeros where the input is padding) and a 1 for the
  // bias; all zeros where the cell is conv2's padding
  auto stage_cell = [&](const Item& item, int q) {
    float v[16];
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) v[kk] = 0.f;
    const int pl = q / plane, a = (q % plane) / PW, u = q % PW;
    const int y = 2 * (item.t4_lo + a) - 1 + (pl >> 1);  // h1 row and column
    const int xx = 2 * (item.f0 + u) - 1 + (pl & 1);
    if (pl < 4 && y >= 0 && y < sh.T2 && xx >= 0 && xx < sh.F2) {
      const bf16* xb = x + (long long)item.b * sh.Tn * sh.F;
#pragma unroll
      for (int di = 0; di < 3; ++di)
#pragma unroll
        for (int df = 0; df < 3; ++df) {
          const int tx = 2 * y + di - 1, fx = 2 * xx + df - 1;
          if (tx >= 0 && tx < sh.Tn && fx >= 0 && fx < sh.F)
            v[3 * di + df] = __bfloat162float(xb[(long long)tx * sh.F + fx]);
        }
      v[9] = 1.f;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
      *reinterpret_cast<uint4*>(sm + L::XC + (j * CELLS + q) * 16) =
          make_uint4(pack_bf16x2(v[8 * j], v[8 * j + 1]), pack_bf16x2(v[8 * j + 2], v[8 * j + 3]),
                     pack_bf16x2(v[8 * j + 4], v[8 * j + 5]),
                     pack_bf16x2(v[8 * j + 6], v[8 * j + 7]));
  };
  // step `part` (0 .. 4) of staging an item: warpgroup 0 x's patches, 128
  // cells a step; warpgroup 1 conv1's B operand of chunks 0 and 1 (step 0)
  // and b2 (step 1)
  auto stage_item = [&](const Item& item, int part) {
    const int i = threadIdx.x % 128;
    if (w == 0) {
      if (128 * part + i < CELLS) stage_cell(item, 128 * part + i);
    } else if (part == 0) {  // chunk i / (2 KC) into buffer i / (2 KC)
      const int c = i / (2 * KC), idx = i % (2 * KC);
      if (c < NC) store_w1(c, idx, load_w1(c, idx));
    } else if (part == 1) {
      for (int nn = i; nn < TN; nn += 128) b2s[nn] = __bfloat162float(b2[item.n0 + nn]);
    }
  };
  // conv1 tile `tile` of chunk c (64 cells x KC channels: x patches times
  // w1 buffer `slot`) into the accumulator c1
  auto conv1 = [&](float (&c1)[KC / 8][4], int tile, int slot) {
    hopper::wgmma_ss<KC, 0>(
        c1, hopper::desc_plain(base + L::XC + tile * 64 * 16, CELLS * 16, 128),
        hopper::desc_plain(base + L::W1S + slot * L::W1, KC * 16, 128), 0);
  };
  // h1 = relu(c1), rounded to bf16, into patch buffer `pb` at the tile's cells
  auto store_h1 = [&](const float (&c1)[KC / 8][4], int tile, int pb) {
    uint8_t* const patch = sm + L::PATCHES + pb * L::PATCH;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int q = 64 * tile + 16 * wi + g + 8 * hh;
#pragma unroll
      for (int i = 0; i < KC / 8; ++i)
        *reinterpret_cast<uint32_t*>(patch + ((i * CELLS + q) * 8 + 2 * t) * 2) =
            pack_bf16x2(fmaxf(c1[i][2 * hh], 0.f), fmaxf(c1[i][2 * hh + 1], 0.f));
    }
  };

  if (flash::tc::snake_item(0) < n_items)  // the first item's inputs
    for (int part = 0; part < 5; ++part) stage_item(sh.item(flash::tc::snake_item(0), TN), part);
  hopper::fence_proxy_async();
  int n = 0;  // stages consumed
  for (int r = 0; r * (int)gridDim.x < n_items; ++r) {
    const int it = flash::tc::snake_item(r);
    if (it >= n_items) continue;
    const Item item = sh.item(it, TN);
    const int it_next = flash::tc::snake_item(r + 1);  // past n_items: no next item
    const Item next_item = sh.item(it_next < n_items ? it_next : it, TN);
    sync();  // the item's inputs are staged; the last item's products and epilogue are done
    float c1[3][KC / 8][4], acc[TN / 8][4];
    {  // chunk 0's patch, before any product of conv2: this warpgroup's tiles at once
      float c1s[TILES][KC / 8][4];
      hopper::wgmma_fence();
#pragma unroll
      for (int tl = 0; tl < TILES; ++tl) conv1(c1s[tl], TILES * w + tl, 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
#pragma unroll
      for (int tl = 0; tl < TILES; ++tl) {
        hopper::fence_regs(c1s[tl]);
        store_h1(c1s[tl], TILES * w + tl, 0);
      }
    }
    hopper::fence_proxy_async();
    sync();
    // conv2's sums start from b2
#pragma unroll
    for (int i = 0; i < TN / 8; ++i) {
      const float2 bias = *reinterpret_cast<const float2*>(b2s + 8 * i + 2 * t);
      acc[i][0] = acc[i][2] = bias.x;
      acc[i][1] = acc[i][3] = bias.y;
    }

    // Chunk c: conv2's 9 taps from patch buffer c % 3, two k-steps of 16
    // channels a tap, one commit group a tap, two taps in flight: a tap
    // waits for the products of the tap two before it and then gives their
    // stage back. With taps 0 .. TILES - 1 go this warpgroup's conv1 tiles
    // of chunk c + 1 (into buffer (c + 1) % 3, from three sets of registers),
    // stored two taps later. Three buffers: chunk c + 1's conv1 writes a
    // buffer no product still reads (chunk c - 2's, done before either
    // warpgroup passed the last barrier).
    int prev1 = -1, prev2 = -1;  // the stages of the last two taps, in flight
    for (int c = 0; c < NC; ++c) {
      const uint32_t patch = base + L::PATCHES + (c % 3) * L::PATCH;
      const bool next = c + 1 < NC, ahead = c + 2 < NC && ct < 2 * KC;
      const bool last = !next && it_next < n_items;  // stage the next item's inputs
      uint4 w1_ahead;
      if (ahead) w1_ahead = load_w1(c + 2, ct);
#pragma unroll
      for (int tap = 0; tap < 9; ++tap, ++n) {
        const int s = n % STAGES;
        hopper::mbar_wait(full(s), (n / STAGES) & 1);
        const int di = tap / 3, df = tap % 3;
        const int a0 = (2 * (di == 1) + (df == 1)) * plane + (di == 2) * PW + (df == 2) + 64 * w;
        hopper::wgmma_fence();
        if (next && tap < TILES) conv1(c1[tap % 3], TILES * w + tap, (c + 1) % 3);
#pragma unroll
        for (int kk = 0; kk < KC / 16; ++kk)
          hopper::wgmma_ss<TN, 1>(
              acc, hopper::desc_plain(patch + (2 * kk * CELLS + a0) * 16, CELLS * 16, 128),
              hopper::desc_sw128(base + s * L::STAGE + kk * 2 * ATOM, L::BOXB), 1);
        hopper::wgmma_commit();
        if (last && tap < 5) stage_item(next_item, tap);
        hopper::wgmma_wait<2>();  // the taps before the last two are done, conv1 tiles too
        if (next && tap >= 2 && tap - 2 < TILES) {
          hopper::fence_regs(c1[(tap - 2) % 3]);
          store_h1(c1[(tap - 2) % 3], TILES * w + tap - 2, (c + 1) % 3);
        }
        if (prev2 >= 0) release(empty(prev2));
        prev2 = prev1;
        prev1 = s;
      }
      if (ahead) store_w1((c + 2) % 3, ct, w1_ahead);
      hopper::fence_proxy_async();
      sync();  // chunk c + 1's patch is whole
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    release(empty(prev2));
    release(empty(prev1));

    // out = relu(acc) in bf16 at the item's valid positions, staged through
    // a patch buffer that no product reads any more (chunk NC's for
    // warpgroup 0, chunk NC + 1's for warpgroup 1; chunk NC - 1's is still
    // read), rows of TN + 8 channels (conflict-free stores of the
    // accumulator layout), then written a row at a time by 16-byte stores
    {
      constexpr int LDO = TN * 2 + 16;  // bytes a staged row
      uint8_t* const stage = sm + L::PATCHES + ((NC + w) % 3) * L::PATCH;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int rr = 16 * wi + g + 8 * hh;
#pragma unroll
        for (int i = 0; i < TN / 8; ++i)
          *reinterpret_cast<uint32_t*>(stage + rr * LDO + (8 * i + 2 * t) * 2) =
              pack_bf16x2(fmaxf(acc[i][2 * hh], 0.f), fmaxf(acc[i][2 * hh + 1], 0.f));
      }
      hopper::bar_sync(2 + w, 128);  // this warpgroup's rows are staged
      for (int idx = threadIdx.x % 128; idx < 64 * (TN / 8); idx += 128) {
        const int rr = idx / (TN / 8), cc = idx % (TN / 8);
        const int m = 64 * w + rr, t4r = m / PW, fr = m % PW;
        const int t4 = item.t4_lo + t4r, f4 = item.f0 + fr;
        if (t4r >= sh.R4 || fr >= sh.FW || t4 >= sh.T4 || f4 >= sh.F4) continue;
        *reinterpret_cast<uint4*>(out + (((long long)item.b * sh.T4 + t4) * sh.F4 + f4) * C +
                                  item.n0 + 8 * cc) =
            *reinterpret_cast<const uint4*>(stage + rr * LDO + 16 * cc);
      }
    }
  }
}

// w2 as a tensor map ([9 C][C]: boxes of 64 output channels by KC rows of
// one tap) and the launch: a persistent grid, one block a multiprocessor
template <int TN>
int launch(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
           void* out, int B, int Tn, int F, int C, cudaStream_t stream) {
  Shape sh;
  sh.Tn = Tn;
  sh.F = F;
  sh.C = C;
  sh.T2 = (Tn - 1) / 2 + 1;
  sh.T4 = (sh.T2 - 1) / 2 + 1;
  sh.F2 = (F - 1) / 2 + 1;
  sh.F4 = (sh.F2 - 1) / 2 + 1;
  sh.FW = sh.F4 < FW_MAX ? sh.F4 : FW_MAX;
  sh.PW = sh.FW + 1;
  sh.R4 = TM / sh.PW;
  sh.RP = sh.R4 + 1;
  sh.n_tg = (sh.T4 + sh.R4 - 1) / sh.R4;
  sh.n_fg = (sh.F4 + sh.FW - 1) / sh.FW;
  sh.n_nt = C / TN;
  CUtensorMap mw2;
  int err = hopper::encode_bthd(&mw2, w2, 1, 9 * C, 1, C, KC);
  const long long n_items = (long long)B * sh.n_tg * sh.n_fg * sh.n_nt;
  if (err == 0 && n_items > 0x7fffffff) err = (int)cudaErrorInvalidValue;
  int grid = 0;
  if (err == 0) err = flash::persistent_grid((int)n_items, grid);
  if (err != 0) return err;
  void* args[] = {&mw2, &x, &w1, &b1, &b2, &out, &sh, &B};
  return flash::launch(kernel<TN>, Layout<TN>::BYTES, NT, grid, 1, 1, stream, args);
}

}  // namespace wg

template <typename T>
int launch(void (*kernel)(const T*, const T*, const T*, const T*, const T*, T*, int, int, int,
                          int, int, int, int),
           size_t smem, int tm, int tn, int threads, const void* x, const void* w1, const void* b1,
           const void* w2, const void* b2, void* out, int B, int Tn, int F, int C,
           cudaStream_t stream) {
  const int T2 = (Tn - 1) / 2 + 1, T4 = (T2 - 1) / 2 + 1;
  const int F2 = (F - 1) / 2 + 1, F4 = (F2 - 1) / 2 + 1;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T4 * F4 + tm - 1) / tm, C / tn, B);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<const T*>(b2), static_cast<T*>(out), Tn, F, C, T2,
      F2, T4, F4);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t.
extern "C" int fused_subsampling_x4(int dtype, const void* x, const void* w1, const void* b1,
                                    const void* w2, const void* b2, void* out, int B, int Tn,
                                    int F, int C, void* stream) {
  if (B <= 0 || Tn <= 0 || F <= 0 || C <= 0 || C % 128 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int F4 = ((F - 1) / 2) / 2 + 1;
  if (dtype == 0)
    return launch<float>(f32::kernel, f32::smem_bytes(F4), f32::TM, f32::TN, f32::NT, x, w1,
                         b1, w2, b2, out, B, Tn, F, C, s);
  if (dtype == 1) {
    if (reinterpret_cast<uintptr_t>(out) % 16 != 0 || reinterpret_cast<uintptr_t>(w2) % 16 != 0)
      return (int)cudaErrorMisalignedAddress;
    // 256 output channels a block where C allows, so conv1 is computed C / 256 times
    if (C % 256 == 0) return wg::launch<256>(x, w1, b1, w2, b2, out, B, Tn, F, C, s);
    return wg::launch<128>(x, w1, b1, w2, b2, out, B, Tn, F, C, s);
  }
  return (int)cudaErrorInvalidValue;
}
