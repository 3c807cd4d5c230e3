// fp32 primitives shared by the fp32 attention kernels (flash_fwd_f32.cu,
// flash_bwd_f32.cu, paged_attention_f32.cu): cp.async loads of fp32 rows
// into shared memory, and 3xTF32 products on mma.sync.m16n8k8.
//
// 3xTF32: each operand x is split as hi = tf32(x) and lo = tf32(x - hi)
// (tf32: cvt.rna's rounding), and a product a . b is lo_a hi_b + hi_a lo_b
// + hi_a hi_b, three mma.sync m16n8k8 tf32 with fp32 accumulators; the
// dropped lo . lo and lo's rounding leave about 2^-22 of each product,
// fp32's own rounding.
//
// Fragments, per lane, gid = lane / 4 and tig = lane % 4: A (16 x 8, row)
// a0 (gid, tig), a1 (gid + 8, tig), a2 (gid, tig + 4), a3 (gid + 8, tig + 4);
// B (8 x 8, col) b0 (k tig, n gid), b1 (tig + 4, gid); C (16 x 8) c0 (gid,
// 2 tig), c1 (gid, 2 tig + 1), c2 and c3 the same columns of row gid + 8.
//
// Operand tiles sit in shared memory with a row stride of D + 4 floats. A
// fragment of S = Q K^T (a_rows on Q, b_trans on K) reads (row gid, column
// tig) over the warp's 8 x 4 lanes: bank 4 gid + tig, all 32 distinct. A
// second product takes p straight from the first product's accumulator as
// its A fragment (a_acc): an m16n8k8 accumulator holds columns 2 tig and
// 2 tig + 1 of an 8-wide slice, the tf32 A fragment wants k = tig and
// tig + 4, and a sum over keys does not depend on its order, so the B
// fragment of the second product reads its rows in the same permuted order
// (b_perm: k = tig from row 2 tig, k = tig + 4 from row 2 tig + 1; bank
// 8 tig + gid, again 32 distinct). Nothing S x S goes to shared memory.
//
// Everything here is in an unnamed namespace: each kernel library that
// includes it gets its own copy.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes from global to shared memory; zeros, and nothing read,
// when !valid.
__device__ __forceinline__ void cp16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows row0 .. row0 + n - 1 (columns 0 .. D - 1) of a [rows, stride] fp32
// matrix into dst [n][D + 4], zeros from row_end on.
template <int D, int NT>
__device__ __forceinline__ void load_rows(float* dst, const float* src, long stride, int row0,
                                          int n, int row_end) {
  constexpr int C = D / 4;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < n * C; i += NT) {
    const int r = i / C, c = i % C;
    const bool valid = row0 + r < row_end;
    cp16(dst + r * (D + 4) + 4 * c, valid ? src + (long)(row0 + r) * stride + 4 * c : src, valid);
  }
}

// n floats row[i0 ..] into dst, zeros from end on.
template <int NT>
__device__ __forceinline__ void load_vec(float* dst, const float* row, int i0, int n, int end) {
  for (int i = threadIdx.x; i < n; i += NT) {
    const bool valid = i0 + i < end;
    cp4(dst + i, valid ? row + i0 + i : row, valid);
  }
}

// ---------------------------------------------------------------------------
// 3xTF32 on mma.sync.m16n8k8 (fp32 accumulate).
struct AFrag {
  uint32_t hi[4], lo[4];
};
struct BFrag {
  uint32_t hi[2], lo[2];
};

// tf32(x) as cvt.rna.tf32.f32 gives it (round to nearest, ties away from
// zero, to 10 mantissa bits), bit for bit, in two integer operations: on
// the H100 16-20% faster than the conversion instruction.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// d += a b in 3xTF32: the two small cross terms, then the large one
__device__ __forceinline__ void mma3(float (&d)[4], const AFrag& a, const BFrag& b) {
  mma(d, a.lo, b.hi);
  mma(d, a.hi, b.lo);
  mma(d, a.hi, b.hi);
}

// d += a b through a zeroed fragment and fp32 adds. A long chain of mma into
// one accumulator drifts away from the fp32 sum (the tensor cores do not
// round their fp32 sums to nearest): dK and dV summed that way over 4 heads
// of 2048 q rows missed the plain fp32 backward by 6.7x and 12x the
// tolerance; added one product at a time they stay within it.
__device__ __forceinline__ void mma3_add(float (&d)[4], const AFrag& a, const BFrag& b) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma3(t, a, b);
  d[0] += t[0];
  d[1] += t[1];
  d[2] += t[2];
  d[3] += t[3];
}

// d += a b into the accumulator (ADD false) or through mma3_add (ADD true)
template <bool ADD>
__device__ __forceinline__ void mma3_to(float (&d)[4], const AFrag& a, const BFrag& b) {
  if constexpr (ADD) {
    mma3_add(d, a, b);
  } else {
    mma3(d, a, b);
  }
}

// A fragment of rows 0..15, columns k0 .. k0 + 7 of a row-major tile.
__device__ __forceinline__ AFrag a_rows(const float* s, int ld, int k0, int gid, int tig) {
  AFrag f;
  split(s[gid * ld + k0 + tig], f.hi[0], f.lo[0]);
  split(s[(gid + 8) * ld + k0 + tig], f.hi[1], f.lo[1]);
  split(s[gid * ld + k0 + tig + 4], f.hi[2], f.lo[2]);
  split(s[(gid + 8) * ld + k0 + tig + 4], f.hi[3], f.lo[3]);
  return f;
}
// A fragment from an accumulator slice c (16 x 8), its columns in the
// permuted order k = tig <- column 2 tig, k = tig + 4 <- column 2 tig + 1.
__device__ __forceinline__ AFrag a_acc(const float (&c)[4]) {
  AFrag f;
  split(c[0], f.hi[0], f.lo[0]);
  split(c[2], f.hi[1], f.lo[1]);
  split(c[1], f.hi[2], f.lo[2]);
  split(c[3], f.hi[3], f.lo[3]);
  return f;
}
// B fragment of B = T^T, T a row-major tile: B[k][n] = T[n0 + n][k0 + k].
__device__ __forceinline__ BFrag b_trans(const float* s, int ld, int n0, int k0, int gid,
                                         int tig) {
  BFrag f;
  split(s[(n0 + gid) * ld + k0 + tig], f.hi[0], f.lo[0]);
  split(s[(n0 + gid) * ld + k0 + tig + 4], f.hi[1], f.lo[1]);
  return f;
}
// B fragment of a row-major tile, rows k0 .. k0 + 7 in a_acc's permuted
// order: B[k = tig][n] = T[k0 + 2 tig][n0 + n], B[tig + 4][n] = T[k0 + 2 tig + 1][n0 + n].
__device__ __forceinline__ BFrag b_perm(const float* s, int ld, int k0, int n0, int gid,
                                        int tig) {
  BFrag f;
  split(s[(k0 + 2 * tig) * ld + n0 + gid], f.hi[0], f.lo[0]);
  split(s[(k0 + 2 * tig + 1) * ld + n0 + gid], f.hi[1], f.lo[1]);
  return f;
}

// Shape checks of the flash entry points: cudaErrorInvalidValue or 0.
int check_shape(int B, int Sq, int Skv, int Hq, int Hkv) {
  if (Skv <= 0 || Hkv <= 0 || Hq <= 0 || B < 0 || Sq < 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace
