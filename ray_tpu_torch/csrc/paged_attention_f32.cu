// Single-query GQA attention over a paged KV cache, for Hopper (sm_90a), fp32.
//
// Replaces, in fp32: jax.experimental.pallas.ops.tpu.paged_attention (the
// Pallas library kernel) as called by ray_tpu/models/paged_decode.py:
// _paged_attention (:82-100, call at :93). bf16 is paged_attention.cu's.
//
// What it computes: for each slot b and q head h, with g = h / (nh / n_kv),
// out[b, h, :] = softmax(q[b, h] . K^T) V over rows 0 .. lengths[b]-1 of the
// slot's logical sequence, where logical row t lives in pool page
// table[b, t / page_size], row t % page_size. q arrives pre-scaled. A slot
// with lengths[b] <= 0 gets zeros. Any page size, any group, D 64, 128 or 256.
//
// Bound on the H100: one query row per slot, so at group 4 the products do
// about 2 flops a byte of K/V, far under the CUDA cores' ridge (67 TFLOP/s
// over 3.35 TB/s, about 20): it is bound by device-memory bytes, the K and V
// rows the slots own, read once. So the products stay full fp32 FFMA on the
// CUDA cores (no tensor cores, no splitting of operands), and the design,
// bf16 K4's plan in fp32 (paged_attention.cu), is about reading those
// bytes once and in parallel:
//
// - Split over the sequence. A slot's rows fall into chunks of CHUNK = 64
//   rows; the grid gives each (slot, kv head) n_splits blocks, and block z
//   takes chunks z, z + n_splits, ... up to lengths[b]. The wrapper picks
//   n_splits so that the grid gives each SM two blocks
//   (models/paged_decode.py:split_count), never more than the table's
//   chunks. A block past its slot's length exits at once. One block serves
//   up to PROWS = 8 q heads of its kv head from one read of each K/V row; a
//   larger group goes in passes of 8 heads, one pass a block along the
//   grid's y axis.
// - Loads. K and V rows come by 16-byte cp.async straight from the pool, in
//   place (consecutive threads on consecutive 16 bytes of a row), K and V
//   of a chunk as two commit groups, so that the scores start while V is
//   still in flight. Thread r of the block looks up the page of the chunk's
//   row r and writes the row's place in the pool to shared memory before
//   the loads are issued, and looks up its row of the block's next chunk
//   while this one loads and computes (the first chunk's, while the slot's
//   length loads): a load's address never waits on a table read of its
//   own. Rows past the length are zero-filled, never read. Row stride D + 4
//   floats in shared memory.
// - Products. Each of the 4 warps owns 16 rows of a chunk. S: lane l takes
//   row l % 16 and half l / 16 of the head dim for all 8 heads (q from
//   shared memory, a broadcast), and one shuffle adds the halves; a
//   quarter-warp reads 8 rows of one half, banks 4 r + c, all distinct. The
//   online softmax is per warp and head (4 shuffles a row max), in fp32 with
//   expf; P goes to shared memory, and O += P V has lane l own D / 32
//   columns of all 8 heads.
// - Merge. The 4 warps' partial softmaxes meet in shared memory, in warp
//   order. A slot whose rows fit one block is written directly; otherwise
//   each block writes its (acc, m, l) to the fp32 partials, and a second
//   kernel, launched right after on the same stream, folds a slot's
//   partials in split order. No atomics: the result is bitwise repeatable.
// - Shared memory: q 8 x D, one chunk of K and of V, P, the chunk's row
//   offsets; 74.2 KB at D 128 (three blocks an SM), 39.4 KB at D 64, 144 KB
//   at D 256.
//
// Layout: q/out [B, nh, D] fp32 contiguous; pools [n_kv, total_pages,
// page_size, D] fp32 contiguous (one layer); table [B, max_pages] int32;
// lengths [B] int32; partials fp32: acc [B, nh, n_splits, D], then (m, l)
// [B, nh, n_splits, 2]. Split kernel grid (n_splits, n_kv * passes, B), 128
// threads; merge grid (n_kv * passes, B), where passes = ceil(group / PROWS).

#include "tf32x3.cuh"

namespace {

constexpr int PROWS = 8;   // q heads a block serves
constexpr int CHUNK = 64;  // rows of a slot a block loads at once
constexpr int NWARPS = 4;  // each owns WROWS rows of a chunk
constexpr int WROWS = CHUNK / NWARPS;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MERGE_BATCH = 16;  // splits whose partials the merge loads at once
constexpr float NEG = -1e30f;

// Shared memory of the D instance: q [PROWS][D], K and V [CHUNK][LD] each,
// P [NWARPS][WROWS][PROWS] (floats), then the chunk's row offsets [CHUNK]
// (longs). The cross-warp merge reuses the K tile: per warp, PROWS rows of
// D + 4 floats, then m and l of each.
template <int D>
struct PagedShape {
  static constexpr int LD = D + 4;
  static constexpr int TILE = CHUNK * LD;
  static constexpr int FLOATS = PROWS * D + 2 * TILE + CHUNK * PROWS;  // even: the longs align
  static constexpr size_t BYTES = sizeof(float) * FLOATS + sizeof(long) * CHUNK;
  static_assert(NWARPS * PROWS * (LD + 2) <= TILE, "merge area fits the K tile");
};

__device__ __forceinline__ int slot_length(const int* lengths, int b, int max_pages,
                                           int page_size) {
  return max(0, min(lengths[b], max_pages * page_size));
}

// The chunk's rows (one kv head's pool, row r at pool + off[r], off[r] < 0
// past the length) into dst [CHUNK][D + 4], zeros past the length.
template <int D>
__device__ __forceinline__ void load_chunk(float* dst, const float* pool, const long* off) {
  constexpr int C = D / 4;  // 16-byte pieces a row
#pragma unroll 4
  for (int i = threadIdx.x; i < CHUNK * C; i += NTHREADS) {
    const int r = i / C, c = i % C;
    const long o = off[r];
    cp16(dst + r * (D + 4) + 4 * c, o >= 0 ? pool + o + 4 * c : pool, o >= 0);
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
paged_attention_f32_split_kernel(const float* __restrict__ q, const float* __restrict__ k_pool,
                                 const float* __restrict__ v_pool, const int* __restrict__ table,
                                 const int* __restrict__ lengths, float* __restrict__ out,
                                 float* __restrict__ part_acc, float* __restrict__ part_ml,
                                 int n_kv, int group, int n_pass, int total_pages, int page_size,
                                 int max_pages, int n_splits) {
  using S = PagedShape<D>;
  constexpr int LD = S::LD, VW = D / 32;  // VW: O columns a lane owns
  const int z = blockIdx.x;
  const int g = blockIdx.y / n_pass;        // kv head
  const int pass = blockIdx.y % n_pass;     // which PROWS q heads of its group
  const int b = blockIdx.z;
  const int nh = n_kv * group;
  const int h0 = g * group + pass * PROWS;  // the pass's first q head
  const int rows = min(PROWS, group - pass * PROWS);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int* tb = table + (long)b * max_pages;
  // thread r < CHUNK: the page of row r of the block's first chunk, read
  // while the length loads (so clamped to the table, not to the length)
  int page_r = tid < CHUNK ? tb[min((z * CHUNK + tid) / page_size, max_pages - 1)] : 0;
  const int len = slot_length(lengths, b, max_pages, page_size);
  const int n_chunks = (len + CHUNK - 1) / CHUNK;
  if (z >= max(n_chunks, 1)) return;
  if (n_chunks == 0) {  // lengths[b] <= 0: zeros, from split 0
    float* ob = out + ((long)b * nh + h0) * D;
    for (int i = tid; i < rows * D; i += NTHREADS) ob[i] = 0.f;
    return;
  }
  const int n_active = min(n_splits, n_chunks);

  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // [PROWS][D]
  float* sK = sQ + PROWS * D;                   // [CHUNK][LD]
  float* sV = sK + S::TILE;                     // [CHUNK][LD]
  float* sP = sV + S::TILE;                     // [NWARPS][WROWS][PROWS]
  long* sOff = reinterpret_cast<long*>(sQ + S::FLOATS);  // [CHUNK]
  const long pool_head = (long)g * total_pages * page_size * D;
  const float* kp = k_pool + pool_head;
  const float* vp = v_pool + pool_head;

  // q heads h0 .. h0 + rows - 1; zeros past the group's end
  for (int i = tid; i < PROWS * D; i += NTHREADS)
    sQ[i] = i / D < rows ? q[((long)b * nh + h0) * D + i] : 0.f;

  const int rl = lane % 16, half = lane / 16;  // S: the lane's row and half of D
  float m[PROWS], l[PROWS], o[PROWS][VW];
#pragma unroll
  for (int h = 0; h < PROWS; ++h) {
    m[h] = NEG;
    l[h] = 0.f;
#pragma unroll
    for (int j = 0; j < VW; ++j) o[h][j] = 0.f;
  }
  for (int c = z; c < n_chunks; c += n_splits) {
    const int c0 = c * CHUNK;
    __syncthreads();  // the previous chunk is consumed (and q is stored)
    if (tid < CHUNK) {
      const int t = c0 + tid;
      const int page = min(max(page_r, 0), total_pages - 1);
      sOff[tid] = t < len ? ((long)page * page_size + t % page_size) * D : -1;
      if (c + n_splits < n_chunks)  // the next chunk's page, in flight meanwhile
        page_r = tb[min((t + n_splits * CHUNK) / page_size, max_pages - 1)];
    }
    __syncthreads();  // the offsets are written
    load_chunk<D>(sK, kp, sOff);
    cp_commit();
    load_chunk<D>(sV, vp, sOff);
    cp_commit();
    const int wr0 = c0 + warp * WROWS;  // the warp's first row
    const bool live = wr0 < len;        // warp-uniform
    cp_wait<1>();
    __syncthreads();  // K landed for every thread
    if (live) {
      // ---- S = q . K^T: row rl, half of the head dim, all heads ----------
      const int t = wr0 + rl;
      const float* krow = sK + (warp * WROWS + rl) * LD + half * (D / 2);
      const float* qh = sQ + half * (D / 2);
      float s[PROWS];
#pragma unroll
      for (int h = 0; h < PROWS; ++h) s[h] = 0.f;
#pragma unroll 4
      for (int j = 0; j < D / 8; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(krow + 4 * j);
#pragma unroll
        for (int h = 0; h < PROWS; ++h) {
          const float4 qv = *reinterpret_cast<const float4*>(qh + h * D + 4 * j);
          s[h] = fmaf(qv.x, kv.x, s[h]);
          s[h] = fmaf(qv.y, kv.y, s[h]);
          s[h] = fmaf(qv.z, kv.z, s[h]);
          s[h] = fmaf(qv.w, kv.w, s[h]);
        }
      }
      // ---- online softmax over the warp's 16 rows, per head --------------
      const bool valid = t < len;
      float p[PROWS];
#pragma unroll
      for (int h = 0; h < PROWS; ++h) {
        s[h] += __shfl_xor_sync(0xffffffffu, s[h], 16);
        if (!valid) s[h] = NEG;
        float mx = s[h];
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        const float m_new = fmaxf(m[h], mx);
        const float alpha = expf(m[h] - m_new);
        m[h] = m_new;
        p[h] = valid ? expf(s[h] - m_new) : 0.f;
        l[h] = l[h] * alpha + (half == 0 ? p[h] : 0.f);  // the lane's share, summed at the end
#pragma unroll
        for (int j = 0; j < VW; ++j) o[h][j] *= alpha;
      }
      if (half == 0) {
        float4* dst = reinterpret_cast<float4*>(sP + (warp * WROWS + rl) * PROWS);
        dst[0] = make_float4(p[0], p[1], p[2], p[3]);
        dst[1] = make_float4(p[4], p[5], p[6], p[7]);
      }
    }
    cp_wait<0>();
    __syncthreads();  // V landed, and P is written
    if (live) {
      // ---- O += P V over the warp's rows: lane owns VW columns -----------
      const int nr = min(WROWS, len - wr0);
      for (int r = 0; r < nr; ++r) {
        const float4 pa = *reinterpret_cast<const float4*>(sP + (warp * WROWS + r) * PROWS);
        const float4 pb = *reinterpret_cast<const float4*>(sP + (warp * WROWS + r) * PROWS + 4);
        const float pr[PROWS] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
        const float* vrow = sV + (warp * WROWS + r) * LD;
        float vv[VW];
        if constexpr (VW == 2) {
          const float2 x = *reinterpret_cast<const float2*>(vrow + 2 * lane);
          vv[0] = x.x;
          vv[1] = x.y;
        } else {
#pragma unroll
          for (int j = 0; j < VW / 4; ++j) {
            const float4 x = *reinterpret_cast<const float4*>(vrow + 4 * lane + 128 * j);
            vv[4 * j] = x.x;
            vv[4 * j + 1] = x.y;
            vv[4 * j + 2] = x.z;
            vv[4 * j + 3] = x.w;
          }
        }
#pragma unroll
        for (int h = 0; h < PROWS; ++h)
#pragma unroll
          for (int j = 0; j < VW; ++j) o[h][j] = fmaf(pr[h], vv[j], o[h][j]);
      }
    }
  }

  // ---- merge the warps' partial softmaxes, in warp order -------------------
#pragma unroll
  for (int h = 0; h < PROWS; ++h)
#pragma unroll
    for (int x = 1; x < 32; x <<= 1) l[h] += __shfl_xor_sync(0xffffffffu, l[h], x);
  __syncthreads();  // every warp is done with the K tile, which now holds the merge
  constexpr int OPAD = D + 4;
  float* sO = sK;                             // [NWARPS][PROWS][OPAD]
  float* sML = sO + NWARPS * PROWS * OPAD;    // [NWARPS][PROWS][2]
#pragma unroll
  for (int h = 0; h < PROWS; ++h) {
    float* dst = sO + (warp * PROWS + h) * OPAD;
    if constexpr (VW == 2) {
      *reinterpret_cast<float2*>(dst + 2 * lane) = make_float2(o[h][0], o[h][1]);
    } else {
#pragma unroll
      for (int j = 0; j < VW / 4; ++j)
        *reinterpret_cast<float4*>(dst + 4 * lane + 128 * j) =
            make_float4(o[h][4 * j], o[h][4 * j + 1], o[h][4 * j + 2], o[h][4 * j + 3]);
    }
    if (lane == 0) {
      sML[(warp * PROWS + h) * 2] = m[h];
      sML[(warp * PROWS + h) * 2 + 1] = l[h];
    }
  }
  __syncthreads();
  // 4 columns a thread: item i is head i / (D / 4), columns 4 (i % (D / 4)) + 0..3
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
      const float f = expf(mw[w] - M);
      L += sML[(w * PROWS + r) * 2 + 1] * f;
      const float4 v = *reinterpret_cast<const float4*>(sO + (w * PROWS + r) * OPAD + d0);
      acc[0] += v.x * f;
      acc[1] += v.y * f;
      acc[2] += v.z * f;
      acc[3] += v.w * f;
    }
    const long row = (long)b * nh + h0 + r;
    if (n_active == 1) {
      const float inv = 1.f / L;
      *reinterpret_cast<float4*>(out + row * D + d0) =
          make_float4(acc[0] * inv, acc[1] * inv, acc[2] * inv, acc[3] * inv);
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
paged_attention_f32_merge_kernel(const int* __restrict__ lengths,
                                 const float* __restrict__ part_acc,
                                 const float* __restrict__ part_ml, float* __restrict__ out,
                                 int n_kv, int group, int n_pass, int page_size, int max_pages,
                                 int n_splits) {
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
      for (int j = 0; j < MERGE_BATCH; ++j) {
        const bool live = z0 + j < n_active;
        mz[j] = live ? ml[2 * (z0 + j)] : NEG;
        lz[j] = live ? ml[2 * (z0 + j) + 1] : 0.f;
        vz[j] = live ? *reinterpret_cast<const float4*>(pa + (z0 + j) * D)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int j = 0; j < MERGE_BATCH; ++j) {
        const float m_new = fmaxf(M, mz[j]);
        const float a = expf(M - m_new), f = expf(mz[j] - m_new);
        M = m_new;
        L = L * a + lz[j] * f;
        acc[0] = acc[0] * a + vz[j].x * f;
        acc[1] = acc[1] * a + vz[j].y * f;
        acc[2] = acc[2] * a + vz[j].z * f;
        acc[3] = acc[3] * a + vz[j].w * f;
      }
    }
    const float inv = 1.f / L;
    *reinterpret_cast<float4*>(out + row * D + d0) =
        make_float4(acc[0] * inv, acc[1] * inv, acc[2] * inv, acc[3] * inv);
  }
}

template <int D>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* table,
           const void* lengths, void* out, int B, int nh, int n_kv, int total_pages,
           int page_size, int max_pages, void* partials, int n_splits, cudaStream_t st) {
  using S = PagedShape<D>;
  const int group = nh / n_kv;
  const int n_pass = (group + PROWS - 1) / PROWS;
  cudaError_t err = cudaFuncSetAttribute(paged_attention_f32_split_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)S::BYTES);
  if (err != cudaSuccess) return (int)err;
  float* part_acc = static_cast<float*>(partials);
  float* part_ml = n_splits > 1 ? part_acc + (long)B * nh * n_splits * D : nullptr;
  paged_attention_f32_split_kernel<D>
      <<<dim3(n_splits, n_kv * n_pass, B), NTHREADS, S::BYTES, st>>>(
          static_cast<const float*>(q), static_cast<const float*>(k_pool),
          static_cast<const float*>(v_pool), static_cast<const int*>(table),
          static_cast<const int*>(lengths), static_cast<float*>(out), part_acc, part_ml, n_kv,
          group, n_pass, total_pages, page_size, max_pages, n_splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return (int)err;
  paged_attention_f32_merge_kernel<D><<<dim3(n_kv * n_pass, B), NTHREADS, 0, st>>>(
      static_cast<const int*>(lengths), part_acc, part_ml, static_cast<float*>(out), n_kv, group,
      n_pass, page_size, max_pages, n_splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int paged_attention_f32(const void* q, const void* k_pool, const void* v_pool,
                                   const void* table, const void* lengths, void* out, int B,
                                   int nh, int n_kv, int d, int total_pages, int page_size,
                                   int max_pages, void* partials, int n_splits, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (n_kv <= 0 || nh % n_kv != 0 || page_size <= 0 || max_pages <= 0 || total_pages <= 0 ||
      n_splits <= 0 || (n_splits > 1 && partials == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PAGED(DIM)                                                                           \
  launch<DIM>(q, k_pool, v_pool, table, lengths, out, B, nh, n_kv, total_pages, page_size, \
              max_pages, partials, n_splits, st)
  if (d == 64) return PAGED(64);
  if (d == 128) return PAGED(128);
  if (d == 256) return PAGED(256);
#undef PAGED
  return (int)cudaErrorInvalidValue;
}

// Rows of a chunk, for the wrapper's split count to check against.
extern "C" int paged_attention_f32_chunk_rows() { return CHUNK; }

// q heads a split block serves, for the wrapper's count of passes.
extern "C" int paged_attention_f32_pass_rows() { return PROWS; }

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
