// Hopper (sm_90a) primitives shared by the flash-attention kernels
// (flash_fwd.cu, flash_bwd.cu): mbarriers, TMA loads and stores through 4-D
// tensor maps with 128-byte swizzle, wgmma on bf16 with fp32 accumulators,
// the bf16 staging of an accumulator for a TMA store, and the host-side
// tensor-map encoding.
//
// Every tile in shared memory is a set of 64-column slabs: R rows of 128
// bytes (64 bf16), 128-byte swizzled, one TMA box each, starting on a
// 1024-byte boundary (the swizzle's period). The wgmma descriptors below read
// that layout, as a K-major operand (D contiguous) or, with the transpose
// bit, as an MN-major one.
//
// Accumulator layout of an m64nN wgmma (fp32), per thread of a warpgroup:
// element i sits in row 16 * warp + lane / 4 + 8 * ((i >> 1) & 1) and column
// 8 * (i / 4) + 2 * (lane % 4) + (i & 1). So a thread holds two rows, each
// row lies in the 4 threads of one quad, and accumulator elements
// 8 kt .. 8 kt + 7 are, packed pairwise into bf16, the register A fragment of
// the k16 step kt of a following product.
//
// Everything here is in an unnamed namespace: each kernel library that
// includes it gets its own copy.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr uint32_t ROW = 128;   // bytes per row of a 64-column slab: the swizzle span
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the barrier's phase of this parity has completed. A wait that
// never ends (a lost arrival) traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 26)) __trap();
  }
}

// One box of a 4-D tensor map (coordinates innermost first: d, head, row, batch).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int d,
                                         int h, int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(h), "r"(row), "r"(b)
      : "memory");
}

// One box of a 1-D tensor map, starting at element x (16-byte aligned).
__device__ __forceinline__ void tma_load_1d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int x) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int d, int h,
                                          int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(d), "r"(h), "r"(row), "r"(b)
      : "memory");
}

// wgmma shared-memory descriptor for 128-byte-swizzled slabs, the layout TMA
// writes with CU_TENSOR_MAP_SWIZZLE_128B: start address, leading and stride
// byte offsets (16-byte units), layout type 1 (128B swizzle) in bits 62-63.
// K-major operands: sbo = 1024 (8 rows of 128 bytes), lbo unused. MN-major:
// sbo = 1024 (8 rows of K), lbo = the distance between 64-column slabs.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Wait until at most N of this warpgroup's committed wgmma groups are still
// running: with N = 1, the older of two groups has finished.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across the
// asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// 2^x by the special-function unit (flush-to-zero; exp2f's denormal handling
// costs three more instructions per score). 2^-inf = 0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The rounding residuals x - bf16(x) of a pair, packed to bf16: the pair is
// pack_bf16's plus these to about 16 bits of mantissa.
__device__ __forceinline__ uint32_t pack_bf16_residual(float lo, float hi) {
  const float2 r = __bfloat1622float2(__floats2bfloat162_rn(lo, hi));
  return pack_bf16(lo - r.x, hi - r.y);
}

// d (+)= A . B, A [64 x 16] and B [16 x 128] both K-major from shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (+)= A . B, A [64 x 16] and B [16 x 64] both K-major from shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d += A . B, A [64 x 16] bf16 from registers (a: this thread's fragment),
// B [16 x 128] MN-major from shared memory (transposed on read).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d += A . B, A [64 x 16] bf16 from registers (a: this thread's fragment),
// B [16 x 64] MN-major from shared memory (transposed on read).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (+)= A . B with both from shared memory, B [16 x N] K-major, N 64 or 128:
// the score product whose width is the K/V tile's (Q.K^T).
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  static_assert(N == 64 || N == 128, "wgmma_ss takes N 64 or 128");
  if constexpr (N == 128) wgmma_ss_n128(d, desc_a, desc_b, accumulate);
  else wgmma_ss_n64(d, desc_a, desc_b, accumulate);
}

// d += A . B with B [16 x N] MN-major, N the head dim (64, 128 or 256): the
// product whose width is a template parameter (P.V, dS.K, P^T.dO, dS^T.Q).
// N 256 is two m64n128k16 products, over B's slabs {0, 1} and {2, 3}: the
// second starts two slabs further, twice the descriptor's leading byte
// offset (bits 16-29, the slab distance), and accumulates into d's upper
// half, whose elements are columns 128 and up in the layout above.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  static_assert(N == 64 || N == 128 || N == 256, "wgmma_rs takes N 64, 128 or 256");
  if constexpr (N == 256) {
    const uint64_t lbo = (desc_b >> 16) & 0x3FFF;
    wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&d[0]), a, desc_b);
    wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&d[64]), a, desc_b + 2 * lbo);
  } else if constexpr (N == 128) {
    wgmma_rs_n128(d, a, desc_b);
  } else {
    wgmma_rs_n64(d, a, desc_b);
  }
}

// Write a warpgroup's m64nN fp32 accumulator, row half r times mul[r], as
// bf16 into rows row_base .. row_base + 63 of a tile in the slab layout (slabs
// slab_bytes apart): the swizzled layout a TMA store reads. RESIDUAL writes
// the rounding residuals of those values instead (pack_bf16_residual). Each
// thread writes 4 bytes into each 16-byte chunk of a row, and the 8 rows a
// warp writes at once fall into 8 different chunks, so the stores do not
// conflict.
template <int N, bool RESIDUAL = false>
__device__ __forceinline__ void stage_bf16(unsigned char* tile, uint32_t slab_bytes, int row_base,
                                           const float (&acc)[N / 2], const float (&mul)[2]) {
  const int lane = threadIdx.x % 32;
  const int row0 = row_base + 16 * ((threadIdx.x % 128) / 32) + lane / 4;
#pragma unroll
  for (int jn = 0; jn < N / 8; ++jn) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const uint32_t off = (jn / 8) * slab_bytes + row * ROW + (((jn % 8) ^ (row % 8)) * 16) +
                           (lane % 4) * 4;
      const float x0 = acc[4 * jn + 2 * r] * mul[r], x1 = acc[4 * jn + 2 * r + 1] * mul[r];
      *reinterpret_cast<uint32_t*>(tile + off) =
          RESIDUAL ? pack_bf16_residual(x0, x1) : pack_bf16(x0, x1);
    }
  }
}

// Make this thread's shared-memory writes visible to TMA, then meet the rest
// of warpgroup w (consumer warpgroups use named barriers 1 + w).
__device__ __forceinline__ void warpgroup_sync_for_tma(int w) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
}

// Wait until every TMA store this thread committed has read its source.
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// cuTensorMapEncodeTiled lives in libcuda: it is looked up at run time, so
// this library needs no link against libcuda and builds with plain nvcc.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 4-D map over a contiguous bf16 [B, S, H, D] tensor, boxes of 64 columns x
// `rows` rows of one head, 128-byte swizzle. Rows past S read as zero and are
// never written.
bool make_map(EncodeTiledFn encode, CUtensorMap* map, const void* ptr, int B, int S, int H, int D,
              int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 1-D map over a contiguous fp32 array of n elements (16-byte aligned),
// boxes of `box` elements (a multiple of 4), no swizzle. A box must start on a
// 16-byte boundary (an element index that is a multiple of 4); elements past n
// read as zero.
bool make_map_1d_f32(EncodeTiledFn encode, CUtensorMap* map, const void* ptr, long n, int box) {
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {0};  // a rank-1 map has none; never read
  const cuuint32_t boxes[1] = {(cuuint32_t)box};
  const cuuint32_t unit[1] = {1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(ptr), dims, strides,
                boxes, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
