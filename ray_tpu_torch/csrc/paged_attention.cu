// Single-query GQA attention over a paged KV cache, for Hopper (sm_90a), bf16.
//
// Replaces: jax.experimental.pallas.ops.tpu.paged_attention (the Pallas library
// kernel) as called by ray_tpu/models/paged_decode.py:_paged_attention.
//
// What it computes: for each slot b and q head h, with g = h / (nh / n_kv),
// out[b, h, :] = softmax(q[b, h] . K^T) V over rows 0 .. lengths[b]-1 of the
// slot's logical sequence, where logical row t lives in pool page
// table[b, t / page_size], row t % page_size. q arrives pre-scaled. A slot
// with lengths[b] <= 0 gets zeros.
//
// Bound on the H100: one query row per slot makes it ~2 flops per byte of K/V,
// so it is bound by device-memory bytes: the K and V rows the slot owns must be
// read once. The design (flash-decoding over the pages, in place in the pool):
//
// - Split over the sequence. A slot's rows fall into chunks of CHUNK = 128
//   rows; the grid gives each (slot, kv head) n_splits blocks, and block z
//   takes chunks z, z + n_splits, ... up to lengths[b]. The wrapper picks
//   n_splits so that the grid fills the card (more splits for fewer slots),
//   never more than the table's chunks. A block past its slot's length exits
//   at once. One block serves up to PROWS = 8 q heads of its kv head (the top
//   half of the m16 A operand), so a group of up to 8 reads each K/V row once;
//   a larger group (16, 32) goes in passes of 8 heads, one pass a block along
//   the grid's y axis, each reading the slot's rows again (mostly from L2).
// - Loads. Lane i of warp 0 reads the block table entry of the chunk's box i
//   (a box is box_rows_of(page_size) rows of one page: the largest power of two
//   that divides the page size, at most 128) and starts that box's K and
//   V by TMA into shared memory, each on its own mbarrier; the whole chunk
//   (64 KB at D128, 128 KB at D256) is in flight at once, so the longest
//   chain is one round of loads.
//   Boxes past the slot's length (rounded up to 16 rows) are never loaded.
//   The pool is a 4-D tensor map [n_kv, total_pages * page_size, 1, D] with
//   128-byte swizzle (the slab layout of sm90.cuh); a box is addressed by its
//   pool row page * page_size + offset.
// - Products on the tensor cores (mma.sync m16n8k16, bf16, fp32 accumulate).
//   Each of the 4 warps owns 32 rows of the chunk. S = Q.K^T takes the pass's
//   q heads as rows 0-7 of the A operand (rows past the group's end are zero;
//   kept in registers for the whole block) and K from the swizzled tile by
//   ldmatrix. The online softmax runs
//   in the log2 domain (exp2 by ex2.approx, log2(e) on the scores), two quad
//   shuffles per row reduction; P packs in place into the bf16 A fragment of
//   O += P.V, whose V operand comes by ldmatrix.trans. Rows past the length
//   are masked only in the slot's last chunk.
// - Merge. The 4 warps' partial softmaxes meet in shared memory, in warp
//   order. A slot whose rows fit one block is written directly as bf16;
//   otherwise each block writes its fp32 (acc, m, l) to the partials, and a
//   second kernel, launched right after on the same stream, loads a slot's
//   partials at once and folds them in split order. No atomics: the result is
//   bitwise repeatable.
// A block that owns several chunks loads each one after computing the last:
// a ring of two 64-row stages, one loading while the other computes, was
// slower on the H100, both at the serving shape and with few long slots.
//
// Layout: q/out [B, nh, D] bf16 contiguous; pools [n_kv, total_pages, page_size,
// D] bf16 contiguous (one layer); table [B, max_pages] int32; lengths [B] int32;
// partials fp32: acc [B, nh, n_splits, D], then (m, l) [B, nh, n_splits, 2].
// D 128 or 256 (one instance each; at D256 a chunk's K and V tiles take 128 KB
// of shared memory), any group nh % n_kv == 0 (a run-time value), page_size a
// multiple of 8. Split kernel grid (n_splits, n_kv * passes, B), 128 threads;
// merge grid (n_kv * passes, B), where passes = ceil(group / PROWS).

#include "sm90.cuh"

namespace {

constexpr int PROWS = 8;        // q heads a block serves: rows 0-7 of the A operand
constexpr int CHUNK = 128;      // rows a block loads at once
constexpr int NWARPS = 4;       // each owns CHUNK / NWARPS rows of a chunk
constexpr int WROWS = CHUNK / NWARPS;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MAX_BOXES = CHUNK / 8;
constexpr uint32_t SLAB = CHUNK * ROW;            // one 64-column slab of a chunk
constexpr float NEG = -1e30f;
constexpr int MERGE_BATCH = 16;  // splits whose partials the merge loads at once

// Shared memory of the D instance: a chunk of K, then of V (D / 64 slabs
// each), then the barriers. The cross-warp merge reuses the K tile: per warp,
// PROWS rows of D floats (padded against bank conflicts), then m and l of
// each row.
template <int D>
struct Smem {
  static constexpr uint32_t TILE = (D / 64) * SLAB;
  static constexpr uint32_t BAR_OFF = 2 * TILE;
  static constexpr uint32_t BYTES = BAR_OFF + 16 * MAX_BOXES + 1024;  // + alignment slack
  static constexpr int OPAD = D + 4;
  static_assert(NWARPS * PROWS * (OPAD + 2) * 4 <= (int)TILE, "merge area fits the K tile");
  static_assert(BYTES <= 232448, "fits a block's shared memory");
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// (d0, d1) += A . B, m16n8k16, A row-major with rows 8-15 zero (a0, a2 given),
// B column-major (b0, b1): only rows 0-7 of the product are kept, so the
// accumulator's upper half costs no registers between products.
__device__ __forceinline__ void mma_top(float (&d)[2], uint32_t a0, uint32_t a2, uint32_t b0,
                                        uint32_t b1) {
  float u0, u1;
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %5}, {%7, %8}, {%0, %1, %9, %9};\n"
      : "+f"(d[0]), "+f"(d[1]), "=f"(u0), "=f"(u1)
      : "r"(a0), "r"(0u), "r"(a2), "r"(b0), "r"(b1), "f"(0.f));
}

// Shared address of the 16-byte column chunk ch (0 .. D/8 - 1) of row r of a
// tile in the swizzled slab layout TMA writes.
__device__ __forceinline__ uint32_t tile_addr(uint32_t tile, int r, int ch) {
  return tile + (ch >> 3) * SLAB + r * ROW + (((ch & 7) ^ (r & 7)) << 4);
}

// Rows of one TMA box: the largest power of two that divides page_size, at
// most CHUNK, so that a box never crosses a page and a chunk is whole boxes.
__host__ __device__ __forceinline__ int box_rows_of(int page_size) {
  const int p2 = page_size & -page_size;
  return p2 < CHUNK ? p2 : CHUNK;
}

__device__ __forceinline__ int slot_length(const int* lengths, int b, int max_pages,
                                           int page_size) {
  return max(0, min(lengths[b], max_pages * page_size));
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
paged_attention_split_kernel(const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const bf16* __restrict__ q, const int* __restrict__ table,
                             const int* __restrict__ lengths, bf16* __restrict__ out,
                             float* __restrict__ part_acc, float* __restrict__ part_ml,
                             int n_kv, int group, int n_pass, int total_pages, int page_size,
                             int max_pages, int n_splits) {
  using S = Smem<D>;
  const int z = blockIdx.x;
  const int g = blockIdx.y / n_pass;        // kv head
  const int pass = blockIdx.y % n_pass;     // which PROWS q heads of its group
  const int b = blockIdx.z;
  const int nh = n_kv * group;
  const int h0 = g * group + pass * PROWS;  // the pass's first q head
  const int rows = min(PROWS, group - pass * PROWS);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  // Lane i of warp 0 reads the table entry of box i of the block's first
  // chunk together with the length, so the two loads' latencies overlap.
  const int box_rows = box_rows_of(page_size);
  const int n_boxes = CHUNK / box_rows;
  const int* tb = table + (long)b * max_pages;
  const int box_page = min((z * CHUNK + lane * box_rows) / page_size, max_pages - 1);
  int next_page = warp == 0 && lane < n_boxes ? tb[box_page] : 0;
  const int len = slot_length(lengths, b, max_pages, page_size);
  const int n_chunks = (len + CHUNK - 1) / CHUNK;
  if (z >= max(n_chunks, 1)) return;
  if (n_chunks == 0) {  // lengths[b] <= 0: zeros, from split 0
    bf16* ob = out + ((long)b * nh + h0) * D;
    for (int i = tid; i < rows * D; i += NTHREADS) ob[i] = __float2bfloat16(0.f);
    return;
  }
  const int n_active = min(n_splits, n_chunks);

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t sK = base;
  const uint32_t sV = base + S::TILE;
  const uint32_t bar_k = base + S::BAR_OFF;      // + 8 i, box i of K
  const uint32_t bar_v = bar_k + 8 * MAX_BOXES;  // + 8 i, box i of V

  if (tid < n_boxes) {
    mbar_init(bar_k + 8 * tid, 1);
    mbar_init(bar_v + 8 * tid, 1);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  // Q as the A operand: row lane / 4 (0-7) is q head h0 + lane / 4 while it
  // lies in the group, else zero; rows 8-15 are zero. qa[kk] = the k16 step
  // kk's a0 and a2.
  uint32_t qa[D / 16][2];
  {
    const bool live = lane / 4 < rows;
    const uint32_t* qrow = reinterpret_cast<const uint32_t*>(
        q + ((long)b * nh + h0 + (live ? lane / 4 : 0)) * D);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qa[kk][0] = live ? qrow[8 * kk + lane % 4] : 0u;
      qa[kk][1] = live ? qrow[8 * kk + 4 + lane % 4] : 0u;
    }
  }

  const int lim = (len + 15) & ~15;  // rows loaded: the length, rounded up to a k16 step
  float m = NEG, l = 0.f;            // this thread's row (head lane / 4), log2 domain
  float o[D / 8][2];  // O: this thread's row, columns 8 n + 2 (lane % 4) + {0, 1}
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = 0.f;

  int it = 0;
  for (int c = z; c < n_chunks; c += n_splits, ++it) {
    const int c0 = c * CHUNK;  // the chunk's first logical row
    if (it > 0) __syncthreads();  // every warp is done with the previous chunk's tiles
    if (warp == 0 && lane < n_boxes && c0 + lane * box_rows < lim) {
      const int t = c0 + lane * box_rows;
      if (it > 0) next_page = tb[min(t / page_size, max_pages - 1)];
      const int page = min(max(next_page, 0), total_pages - 1);
      const int row = page * page_size + t % page_size;
      const uint32_t bytes = box_rows * D * 2;
      const uint32_t dst = lane * box_rows * ROW;
      mbar_expect_tx(bar_k + 8 * lane, bytes);
#pragma unroll
      for (int sl = 0; sl < D / 64; ++sl)
        tma_load(sK + sl * SLAB + dst, &tm_k, bar_k + 8 * lane, 64 * sl, 0, row, g);
      mbar_expect_tx(bar_v + 8 * lane, bytes);
#pragma unroll
      for (int sl = 0; sl < D / 64; ++sl)
        tma_load(sV + sl * SLAB + dst, &tm_v, bar_v + 8 * lane, 64 * sl, 0, row, g);
    }
    const int r0 = warp * WROWS;      // this warp's first row in the chunk
    const int wlim = lim - c0 - r0;   // rows of this warp that were loaded (may be <= 0)
    if (wlim <= 0) continue;          // warp-uniform: every row masked, nothing loaded
    const int box0 = r0 / box_rows;
    const int box1 = min(r0 + min(wlim, WROWS) - 1, CHUNK - 1) / box_rows;
    for (int i = box0; i <= box1; ++i) mbar_wait(bar_k + 8 * i, it & 1);

    // ---- S = Q.K^T over this warp's 32 rows: 4 n8 tiles -------------------
    float s[WROWS / 8][2];
#pragma unroll
    for (int t = 0; t < WROWS / 8; ++t) {
      s[t][0] = s[t][1] = 0.f;
      if (8 * t < wlim) {
        const int kr = r0 + 8 * t + lane % 8;
#pragma unroll
        for (int j = 0; j < D / 32; ++j) {  // two k16 steps per ldmatrix.x4
          uint32_t kb[4];
          ldmatrix_x4(kb, tile_addr(sK, kr, 4 * j + lane / 8));
          mma_top(s[t], qa[2 * j][0], qa[2 * j][1], kb[0], kb[1]);
          mma_top(s[t], qa[2 * j + 1][0], qa[2 * j + 1][1], kb[2], kb[3]);
        }
      }
    }
    // ---- online softmax (log2 domain), masked past the length --------------
    const bool edge = c0 + r0 + WROWS > len;
    float mx = NEG;
#pragma unroll
    for (int t = 0; t < WROWS / 8; ++t) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = s[t][e] * LOG2E;
        if (edge && c0 + r0 + 8 * t + 2 * (lane % 4) + e >= len) v = -INFINITY;
        s[t][e] = v;
        mx = fmaxf(mx, v);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float alpha = exp2_approx(m - m_new);
    m = m_new;
    float psum = 0.f;
    uint32_t pa[WROWS / 8];  // P packed: tile t's two columns of this thread's row
#pragma unroll
    for (int t = 0; t < WROWS / 8; ++t) {
      const float p0 = exp2_approx(s[t][0] - m_new);
      const float p1 = exp2_approx(s[t][1] - m_new);
      psum += p0 + p1;
      pa[t] = pack_bf16(p0, p1);
    }
    l = l * alpha + psum;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha;
      o[n][1] *= alpha;
    }

    // ---- O += P.V: 2 k16 steps of 16 rows, D / 8 n8 tiles ------------------
    for (int i = box0; i <= box1; ++i) mbar_wait(bar_v + 8 * i, it & 1);
#pragma unroll
    for (int kk = 0; kk < WROWS / 16; ++kk) {
      if (16 * kk < wlim) {
        const int vr = r0 + 16 * kk + 8 * ((lane / 8) % 2) + lane % 8;
#pragma unroll
        for (int n = 0; n < D / 16; ++n) {  // two n8 tiles per ldmatrix.x4.trans
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, tile_addr(sV, vr, 2 * n + lane / 16));
          mma_top(o[2 * n], pa[2 * kk], pa[2 * kk + 1], vb[0], vb[1]);
          mma_top(o[2 * n + 1], pa[2 * kk], pa[2 * kk + 1], vb[2], vb[3]);
        }
      }
    }
  }

  // ---- merge the warps' partial softmaxes, in warp order -------------------
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  __syncthreads();  // every warp is done with the K tile, which now holds the merge
  float* sO = reinterpret_cast<float*>(smem);          // [NWARPS][PROWS][OPAD]
  float* sML = sO + NWARPS * PROWS * S::OPAD;          // [NWARPS][PROWS][2]
  if (lane / 4 < rows) {
    const int r = lane / 4;
    float* dst = sO + (warp * PROWS + r) * S::OPAD + 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n) = make_float2(o[n][0], o[n][1]);
    if (lane % 4 == 0) {
      sML[(warp * PROWS + r) * 2] = m;
      sML[(warp * PROWS + r) * 2 + 1] = l;
    }
  }
  __syncthreads();
  // 4 columns per thread: item i is head i / (D / 4), columns 4 (i % (D / 4)) + 0..3
  for (int i = tid; i < rows * (D / 4); i += NTHREADS) {
    const int r = i / (D / 4);
    const int d0 = 4 * (i % (D / 4));
    float mw[NWARPS], M = NEG;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      mw[w] = sML[(w * PROWS + r) * 2];
      M = fmaxf(M, mw[w]);
    }
    float L = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float f = exp2_approx(mw[w] - M);
      L += sML[(w * PROWS + r) * 2 + 1] * f;
      const float4 v = *reinterpret_cast<const float4*>(sO + (w * PROWS + r) * S::OPAD + d0);
      acc[0] += v.x * f;
      acc[1] += v.y * f;
      acc[2] += v.z * f;
      acc[3] += v.w * f;
    }
    const long row = (long)b * nh + h0 + r;
    if (n_active == 1) {
      const float inv = 1.f / L;
      uint2 packed;
      packed.x = pack_bf16(acc[0] * inv, acc[1] * inv);
      packed.y = pack_bf16(acc[2] * inv, acc[3] * inv);
      *reinterpret_cast<uint2*>(out + row * D + d0) = packed;
    } else {
      const long part = row * n_splits + z;
      *reinterpret_cast<float4*>(part_acc + part * D + d0) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
      if (d0 == 0) {
        part_ml[part * 2] = M;
        part_ml[part * 2 + 1] = L;
      }
    }
  }
}

// Merge the splits of each slot that needed more than one, in split order.
template <int D>
__global__ void __launch_bounds__(NTHREADS)
paged_attention_merge_kernel(const int* __restrict__ lengths, const float* __restrict__ part_acc,
                             const float* __restrict__ part_ml, bf16* __restrict__ out, int n_kv,
                             int group, int n_pass, int page_size, int max_pages, int n_splits) {
  const int g = blockIdx.x / n_pass;
  const int pass = blockIdx.x % n_pass;
  const int b = blockIdx.y;
  const int len = slot_length(lengths, b, max_pages, page_size);
  const int n_active = min(n_splits, (len + CHUNK - 1) / CHUNK);
  if (n_active <= 1) return;  // written by the split kernel
  const int rows = min(PROWS, group - pass * PROWS);
  for (int i = threadIdx.x; i < rows * (D / 4); i += NTHREADS) {
    const int r = i / (D / 4);
    const int d0 = 4 * (i % (D / 4));
    const long row = (long)b * n_kv * group + (long)g * group + pass * PROWS + r;
    const float* ml = part_ml + row * n_splits * 2;
    const float* pa = part_acc + row * n_splits * D + d0;
    // MERGE_BATCH splits' partials are loaded at once, then folded in split
    // order into a running (M, L, acc): one round of loads per batch.
    float M = NEG, L = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int z0 = 0; z0 < n_active; z0 += MERGE_BATCH) {
      float mz[MERGE_BATCH], lz[MERGE_BATCH];
      float4 vz[MERGE_BATCH];
#pragma unroll
      for (int k = 0; k < MERGE_BATCH; ++k) {
        const bool live = z0 + k < n_active;
        mz[k] = live ? ml[2 * (z0 + k)] : NEG;
        lz[k] = live ? ml[2 * (z0 + k) + 1] : 0.f;
        vz[k] = live ? *reinterpret_cast<const float4*>(pa + (z0 + k) * D)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int k = 0; k < MERGE_BATCH; ++k) {
        const float m_new = fmaxf(M, mz[k]);
        const float a = exp2_approx(M - m_new), f = exp2_approx(mz[k] - m_new);
        M = m_new;
        L = L * a + lz[k] * f;
        acc[0] = acc[0] * a + vz[k].x * f;
        acc[1] = acc[1] * a + vz[k].y * f;
        acc[2] = acc[2] * a + vz[k].z * f;
        acc[3] = acc[3] * a + vz[k].w * f;
      }
    }
    const float inv = 1.f / L;
    uint2 packed;
    packed.x = pack_bf16(acc[0] * inv, acc[1] * inv);
    packed.y = pack_bf16(acc[2] * inv, acc[3] * inv);
    *reinterpret_cast<uint2*>(out + row * D + d0) = packed;
  }
}

template <int D>
int launch(EncodeTiledFn encode, const void* q, const void* k_pool, const void* v_pool,
           const void* table, const void* lengths, void* out, int B, int nh, int n_kv,
           int total_pages, int page_size, int max_pages, void* partials, int n_splits,
           cudaStream_t st) {
  using S = Smem<D>;
  const int group = nh / n_kv;
  const int n_pass = (group + PROWS - 1) / PROWS;
  const int box_rows = box_rows_of(page_size);
  CUtensorMap tm_k, tm_v;
  if (!make_map(encode, &tm_k, k_pool, n_kv, total_pages * page_size, 1, D, box_rows) ||
      !make_map(encode, &tm_v, v_pool, n_kv, total_pages * page_size, 1, D, box_rows))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(paged_attention_split_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)S::BYTES);
  if (err != cudaSuccess) return (int)err;
  float* part_acc = static_cast<float*>(partials);
  float* part_ml = n_splits > 1 ? part_acc + (long)B * nh * n_splits * D : nullptr;
  paged_attention_split_kernel<D><<<dim3(n_splits, n_kv * n_pass, B), NTHREADS, S::BYTES, st>>>(
      tm_k, tm_v, static_cast<const bf16*>(q), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<bf16*>(out), part_acc, part_ml, n_kv, group,
      n_pass, total_pages, page_size, max_pages, n_splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return (int)err;
  paged_attention_merge_kernel<D><<<dim3(n_kv * n_pass, B), NTHREADS, 0, st>>>(
      static_cast<const int*>(lengths), part_acc, part_ml, static_cast<bf16*>(out), n_kv, group,
      n_pass, page_size, max_pages, n_splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int paged_attention_bf16(const void* q, const void* k_pool, const void* v_pool,
                                    const void* table, const void* lengths, void* out, int B,
                                    int nh, int n_kv, int d, int total_pages, int page_size,
                                    int max_pages, void* partials, int n_splits, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (n_kv <= 0 || nh % n_kv != 0 || page_size <= 0 || max_pages <= 0 || total_pages <= 0 ||
      n_splits <= 0 || (n_splits > 1 && partials == nullptr))
    return (int)cudaErrorInvalidValue;
  // a page is whole boxes of 8..128 rows
  if (page_size % 8 != 0) return (int)cudaErrorInvalidValue;
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 128)
    return launch<128>(encode, q, k_pool, v_pool, table, lengths, out, B, nh, n_kv, total_pages,
                       page_size, max_pages, partials, n_splits, st);
  if (d == 256)
    return launch<256>(encode, q, k_pool, v_pool, table, lengths, out, B, nh, n_kv, total_pages,
                       page_size, max_pages, partials, n_splits, st);
  return (int)cudaErrorInvalidValue;
}

// Rows of a chunk, for the wrapper's split count to check against.
extern "C" int paged_attention_chunk_rows() { return CHUNK; }

// q heads a split block serves, for the wrapper's count of passes.
extern "C" int paged_attention_pass_rows() { return PROWS; }

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
