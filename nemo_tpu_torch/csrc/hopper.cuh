// Hopper (sm_90a) building blocks as small PTX wrappers: TMA tensor maps and
// tile loads, mbarriers, and warpgroup MMA (wgmma) reading tiles that TMA
// wrote in the 128-byte swizzle, or that the threads wrote with no swizzle
// (desc_plain). Used by relpos_flash.cu (K1), relpos_flash_bwd.cu (K3, K4),
// fused_subsampling.cu (K2), flash_fwd.cu (K5, K8 and K11), flash_bwd.cu
// (K6, K7, K9, K10, K12 and K13) and hopper_check.cu (the unit check of
// these wrappers against torch.matmul).
//
// A tile in shared memory. TMA copies a box of 64 bf16 columns (128 bytes,
// the swizzle span) by R rows to R x 128 bytes at a 1024-byte-aligned
// address; the 16-byte chunk c of row r lands at chunk c ^ (r % 8), so 8 rows
// make one 1024-byte swizzle atom. A tile 128 columns wide (head dim 128) is
// two such boxes, one after the other; a head of 96 columns too, the second
// box zero past column 96 (flash_tiles.cuh:padded), whose products into the
// head take m64n96k16 (wgmma_rs_n96).
//
// wgmma reads a tile through a 64-bit descriptor: the start address >> 4
// (bits 0-13), the leading byte offset >> 4 (16-29), the stride byte offset
// >> 4 (32-45) and the layout, 1 = 128-byte swizzle (62-63). Two cases:
// - K-major (the reduction axis contiguous: rows of q and of k for s = q k^T):
//   stride offset 1024, the step from one 8-row group to the next; the
//   leading offset is unused. Step ks of 16 columns (32 bytes) starts at
//   box ks / 4, plus 32 (ks % 4) bytes inside the atom: the hardware applies
//   the swizzle to the address it forms, as it did for TMA.
// - MN-major (the output axis contiguous: v [keys][d] for o += p v, with the
//   transposed-B bit): stride offset 1024 between groups of 8 keys, leading
//   offset = one box's bytes between 64-column boxes of d; step kk of 16 keys
//   starts 2048 bytes further. The backward reads one tile both ways: k
//   K-major for s = q k^T and MN-major for dq += dS k, q and dO K-major for
//   s^T = k q^T and dP^T = v dO^T and MN-major for dk += dS^T q, dv += P^T dO.
//
// An m64nN accumulator holds, in thread (warp w, lane 4 g + t) of the
// warpgroup, rows 16 w + g and 16 w + g + 8 at columns 8 i + 2 t and 8 i +
// 2 t + 1 as d[i][0..1] and d[i][2..3]: mma.sync's C layout, one 8-column
// block at a time. An A operand in registers takes mma.sync's A layout for
// the warp's 16 rows (mma_bf16.cuh), so a score tile packs into the A
// fragments of the next product (flash_tiles.cuh:pack_p).

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: the driver is reached at run time
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int BOX = 64;                      // bf16 columns of one TMA box (128 bytes)
constexpr int BOX_ROW_BYTES = BOX * 2;       // a box row
constexpr uint32_t ATOM = 1024;              // bytes of 8 swizzled rows

// ------------------------------------------------------------------ host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (err == cudaSuccess && q == cudaDriverEntryPointSuccess) ? (EncodeTiled)p : nullptr;
  }();
  return fn;
}

// A bf16 tensor [B, T, heads, D] (contiguous, 16-byte aligned, D a multiple
// of 8) as a rank-4 map whose box is 64 columns of one head by `rows` rows of
// one batch row, in the 128-byte swizzle; rows past T, and columns past D
// (the second box of a 96-column head), read as zeros, and a box's bytes on
// its mbarrier are the whole box's, those zeros included. Returns a
// cudaError_t.
inline int encode_bthd(CUtensorMap* map, const void* ptr, int B, int T, int heads, int D,
                       int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {2ull * D, 2ull * D * heads, 2ull * D * heads * T};  // bytes
  const cuuint32_t box[4] = {(cuuint32_t)BOX, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// An fp32 tensor [rows, heads, D] (contiguous, 16-byte aligned) as a rank-3
// map whose box is 32 columns (128 bytes, the swizzle span) of one head by
// `box_rows` rows, in the 128-byte swizzle: the target of tma_reduce_add_3d,
// which skips the box's rows past `rows` (a box that starts at a negative
// row faults: error 715 on the H100). Returns a cudaError_t.
inline int encode_rows_f32(CUtensorMap* map, const void* ptr, int rows, int heads, int D,
                           int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)rows};
  const cuuint64_t strides[2] = {4ull * D, 4ull * D * heads};  // bytes
  const cuuint32_t box[3] = {32, 1, (cuuint32_t)box_rows};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------- device

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarriers (64-bit, in shared memory)
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// make the initialised barriers visible to the async proxy (TMA) and the block
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// arrive, and expect `bytes` more of TMA before the phase completes
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// TMA: the box at coordinates (c0 column, c1 head, c2 row, c3 batch row) of
// `map` into shared memory at dst, completing on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// TMA store: the box at shared address src (as tma_load_4d lays it out) into
// `map` at (c0 column, c1 head, c2 row, c3 batch row), in a bulk group; rows
// past the tensor's end are not written, and the source may be rewritten
// after bulk_wait_read
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// the register A fragments (K / 16 steps of 16 columns) of warp w's 16 rows
// of a 64 x K bf16 tile at shared address `at`, K / 64 TMA boxes in the
// 128-byte swizzle: what flash_tiles.cuh:load_a reads from device memory,
// by ldmatrix .x4 (lane l gives the address of row l % 8 of matrix l / 8,
// and matrix j lands in a[ks][j] in the mma A layout, mma_bf16.cuh)
template <int K>
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[K / 16][4], uint32_t at, int w, int lane) {
  const int row = 16 * w + (lane & 7) + 8 * ((lane >> 3) & 1), half = lane >> 4;
#pragma unroll
  for (int ks = 0; ks < K / 16; ++ks) {
    const int c = 16 * ks + 8 * half;
    const uint32_t addr = at + (c >> 6) * 64 * BOX_ROW_BYTES + row * BOX_ROW_BYTES +
                          ((((c & 63) >> 3) ^ (row & 7)) << 4);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(a[ks][0]), "=r"(a[ks][1]), "=r"(a[ks][2]), "=r"(a[ks][3])
                 : "r"(addr)
                 : "memory");
  }
}

// fetch a tensor map (a __grid_constant__ parameter) ahead of its first use
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// TMA reduction: add the fp32 box at shared address src (two 32-column boxes
// of a [rows][64] tile are two calls) into `map` at (c0 column, c1 head, c2
// row), in a bulk group; the source may be rewritten after bulk_wait_read
__device__ __forceinline__ void tma_reduce_add_3d(const CUtensorMap* map, uint32_t src, int c0,
                                                  int c1, int c2) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.tile.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the bulk groups this thread committed have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// make this thread's writes to shared memory visible to the async proxy
// (wgmma and TMA reading them), before the barrier that orders the read
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// named barrier `id` (1-15; 0 is __syncthreads) of `n` threads
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
// arrive at named barrier `id` of `n` threads without waiting
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// byte offset of bf16 element (r, c) of a [rows][64] tile in the 128-byte
// swizzle (the layout TMA writes and wgmma reads), for tiles the threads write
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return r * BOX_ROW_BYTES + ((((c >> 3) ^ r) & 7) << 4) + ((c & 7) << 1);
}
// the same for fp32 element (r, c) of a [rows][64] tile kept as two boxes of
// 32 columns (rows x 128 bytes each), the layout of encode_rows_f32's box
__device__ __forceinline__ uint32_t sw128_f32(int r, int c, int rows) {
  const int cc = c & 31;
  return (c >> 5) * rows * BOX_ROW_BYTES + r * BOX_ROW_BYTES + ((((cc >> 2) ^ r) & 7) << 4) +
         ((cc & 3) << 2);
}

// wgmma descriptor of a 128-byte-swizzled tile at shared address `addr`
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lead_bytes) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lead_bytes >> 4) << 16) |
         ((uint64_t)(ATOM >> 4) << 32) | (1ull << 62);
}

// wgmma descriptor of a K-major tile with no swizzle: core matrices of 8
// rows x 16 bytes (8 bf16 of the reduction axis), each 128 contiguous bytes;
// `lead_bytes` from one core matrix to the next along K, `stride_bytes` from
// one group of 8 rows to the next (layout 0 in bits 62-63). A tile kept as
// [K / 8][rows][8] has lead_bytes = rows x 16 and stride_bytes = 128, and
// any row may start it: fused_subsampling.cu's conv2 reads each tap's A as a
// window of rows of one such tile, and its conv1 both operands.
__device__ __forceinline__ uint64_t desc_plain(uint32_t addr, uint32_t lead_bytes,
                                               uint32_t stride_bytes) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lead_bytes >> 4) << 16) |
         ((uint64_t)(stride_bytes >> 4) << 32);
}

// warp specialisation: a warpgroup gives registers back to the block's pool
// (dealloc) or takes them (alloc); all its 128 threads execute it
template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from reading (or writing) registers of an accumulator,
// or of register A fragments, across a wgmma that is still in flight
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// d[64 x N] (+)= A[64 x 16] B[16 x N], fp32 accumulators, bf16 operands.
// wgmma_ss: A from shared memory (K-major descriptor a); wgmma_rs: A from
// registers. B by descriptor b, K-major (TB = 0) or MN-major (TB = 1).
// scale_d = 0 overwrites d.

template <int TB>
__device__ __forceinline__ void wgmma_ss_n64(
    float (&d)[8][4], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss_n128(
    float (&d)[16][4], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss_n32(
    float (&d)[4][4], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, %19;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss_n256(
    float (&d)[32][4], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, %131;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
        "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
        "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
        "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]),
        "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]),
        "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]),
        "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
        "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]),
        "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
        "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]),
        "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(
    float (&d)[8][4], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
}

// N = 96 (the dh-96 flash kernels' products into dh): with B MN-major in
// the 128-byte swizzle, the first box's 64 columns and the second's first 32
template <int TB>
__device__ __forceinline__ void wgmma_rs_n96(
    float (&d)[12][4], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, %54;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n128(
    float (&d)[16][4], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(TB));
}

template <int N, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 8][4], uint64_t a, uint64_t b,
                                         int scale_d) {
  static_assert(N == 32 || N == 64 || N == 128 || N == 256, "wgmma_ss: N is 32, 64, 128 or 256");
  if constexpr (N == 32) wgmma_ss_n32<TB>(d, a, b, scale_d);
  else if constexpr (N == 64) wgmma_ss_n64<TB>(d, a, b, scale_d);
  else if constexpr (N == 128) wgmma_ss_n128<TB>(d, a, b, scale_d);
  else wgmma_ss_n256<TB>(d, a, b, scale_d);
}
template <int N, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 8][4], const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  static_assert(N == 64 || N == 96 || N == 128, "wgmma_rs: N is 64, 96 or 128");
  if constexpr (N == 64) wgmma_rs_n64<TB>(d, a, b, scale_d);
  else if constexpr (N == 96) wgmma_rs_n96<TB>(d, a, b, scale_d);
  else wgmma_rs_n128<TB>(d, a, b, scale_d);
}

// Whole-tile products of 64 rows, one commit group each. A tile of R rows
// and K columns is K / 64 TMA boxes of R x 128 bytes, one after the other.
//
// d[64 x N] = A B^T: A [64][K] at a_at and B [N][K] at b_at, both K-major in
// shared memory, K / 16 steps of 16 columns (s = q k^T).
template <int N, int K>
__device__ __forceinline__ void product_ss(float (&d)[N / 8][4], uint32_t a_at, uint32_t b_at) {
  constexpr uint32_t ABOX = 64 * BOX_ROW_BYTES, BBOX = N * BOX_ROW_BYTES;
#pragma unroll
  for (int ks = 0; ks < K / 16; ++ks)
    wgmma_ss<N, 0>(d, desc_sw128(a_at + (ks / 4) * ABOX + (ks % 4) * 32, 0),
                   desc_sw128(b_at + (ks / 4) * BBOX + (ks % 4) * 32, 0), ks);
  wgmma_commit();
}

// d[64 x N] = A B^T: A [64][K] as register A fragments (K / 16 steps of 16
// columns) and B [N][K] at b_at, K-major in shared memory as in product_ss
// (s = q k^T with q held in registers: relpos_flash.cu's and
// relpos_flash_bwd.cu's dh-128 kernels).
template <int N, int K>
__device__ __forceinline__ void product_rs_k(float (&d)[N / 8][4], const uint32_t (&a)[K / 16][4],
                                             uint32_t b_at) {
  constexpr uint32_t BBOX = N * BOX_ROW_BYTES;
#pragma unroll
  for (int ks = 0; ks < K / 16; ++ks)
    wgmma_rs<N, 0>(d, a[ks], desc_sw128(b_at + (ks / 4) * BBOX + (ks % 4) * 32, 0), ks);
  wgmma_commit();
}

// d[64 x N] += A B: A [64][K] as register A fragments (K / 16 steps of 16
// columns) and B [K][N] at b_at, MN-major (the transposed-B bit): N / 64
// boxes of K rows (N = 96: the second box's first 32 columns), step kk of
// 16 rows 2048 bytes further (o += p v).
template <int N, int K>
__device__ __forceinline__ void product_rs(float (&d)[N / 8][4], const uint32_t (&a)[K / 16][4],
                                           uint32_t b_at) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    wgmma_rs<N, 1>(d, a[kk], desc_sw128(b_at + kk * 2 * ATOM, K * BOX_ROW_BYTES), 1);
  wgmma_commit();
}

// d[64 x N] (+)= A B: A [64][K] at a_at, K-major in shared memory (as TMA or
// the threads wrote it), and B [K][N] at b_at, MN-major as in product_rs;
// accumulate = 0 overwrites d.
template <int N, int K>
__device__ __forceinline__ void product_ss_mn(float (&d)[N / 8][4], uint32_t a_at, uint32_t b_at,
                                              int accumulate) {
  constexpr uint32_t ABOX = 64 * BOX_ROW_BYTES;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    wgmma_ss<N, 1>(d, desc_sw128(a_at + (kk / 4) * ABOX + (kk % 4) * 32, 0),
                   desc_sw128(b_at + kk * 2 * ATOM, K * BOX_ROW_BYTES), kk > 0 || accumulate);
  wgmma_commit();
}

}  // namespace hopper
