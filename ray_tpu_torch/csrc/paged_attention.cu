// Single-query GQA attention over a paged KV cache, for Hopper (sm_90a), bf16.
//
// Replaces: jax.experimental.pallas.ops.tpu.paged_attention (the Pallas library
// kernel) as called by ray_tpu/models/paged_decode.py:_paged_attention.
//
// What it computes: for each slot b and q head h, with g = h / (nh / n_kv),
// out[b, h, :] = softmax(q[b, h] . K^T) V over rows 0 .. lengths[b]-1 of the
// slot's logical sequence, where logical row t lives in pool page
// table[b, t / page_size], row t % page_size. q arrives pre-scaled.
//
// Bound on the H100: one query row per slot makes it ~2 flops per byte of K/V,
// so it is bound by device-memory bytes: the K and V rows the slot owns must be
// read once. The design gives one block to each (slot, kv head), which serves
// all nh / n_kv q heads of the group from one read of each K/V row (GQA never
// re-reads the cache), walks the block table itself and reads the pages in
// place in the pool (never a gathered copy), and stops at lengths[b] so unused
// pages cost nothing. To keep enough bytes in flight, each of the block's 8
// warps owns an interleaved share of the rows, loads 4 K and 4 V rows at once
// (8 bytes a lane, 256 contiguous bytes a row), and keeps its q rows, running
// max, normaliser and fp32 accumulator in registers; the warps' partial
// softmaxes are merged once, at the end, through shared memory. Not yet done:
// splitting a long sequence over several blocks (flash-decoding), which the
// small-batch case needs to fill the card.
//
// Layout: q/out [B, nh, D] bf16 contiguous; pools [n_kv, total_pages, page_size,
// D] bf16 contiguous (one layer); table [B, max_pages] int32; lengths [B] int32.
// Grid (n_kv, B), 256 threads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int ROWS = 4;  // K/V rows a warp loads at once
constexpr float NEG = -1e30f;

// Load this lane's 4 consecutive bf16 values of a row (8 bytes) as floats.
__device__ __forceinline__ void load_row(float (&dst)[4], const bf16* src) {
  const uint2 raw = *reinterpret_cast<const uint2*>(src);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  dst[0] = a.x; dst[1] = a.y; dst[2] = b.x; dst[3] = b.y;
}

template <int D, int REP>
__global__ void __launch_bounds__(NTHREADS)
paged_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_pool,
                       const bf16* __restrict__ v_pool, const int* __restrict__ table,
                       const int* __restrict__ lengths, bf16* __restrict__ out, int n_kv,
                       int total_pages, int page_size, int max_pages) {
  constexpr int EPL = D / 32;  // elements of a row per lane
  static_assert(EPL == 4, "load_row reads 4 elements a lane");
  __shared__ float sm_m[NWARPS][REP];
  __shared__ float sm_l[NWARPS][REP];
  __shared__ float sm_acc[NWARPS][REP][D];

  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int nh = n_kv * REP;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  float qr[REP][EPL];
  const bf16* qb = q + ((long)b * nh + (long)g * REP) * D + lane * EPL;
#pragma unroll
  for (int r = 0; r < REP; ++r) load_row(qr[r], qb + r * D);

  const int len = max(0, min(lengths[b], max_pages * page_size));
  const long page_elems = (long)page_size * D;
  const bf16* kg = k_pool + (long)g * total_pages * page_elems + lane * EPL;
  const bf16* vg = v_pool + (long)g * total_pages * page_elems + lane * EPL;
  const int* tb = table + (long)b * max_pages;

  float m[REP], l[REP], acc[REP][EPL];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = NEG;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[r][e] = 0.f;
  }

  for (int t0 = warp * ROWS; t0 < len; t0 += NWARPS * ROWS) {
    float kf[ROWS][EPL], vf[ROWS][EPL];
    bool valid[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int t = t0 + i;
      valid[i] = t < len;
      if (valid[i]) {
        const int page = min(max(tb[t / page_size], 0), total_pages - 1);
        const long off = (long)page * page_elems + (long)(t % page_size) * D;
        load_row(kf[i], kg + off);
        load_row(vf[i], vg + off);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kf[i][e] = vf[i][e] = 0.f;
      }
    }
    float s[ROWS][REP];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) part += qr[r][e] * kf[i][e];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
        s[i][r] = part;
      }
    }
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      float mx = m[r];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
        if (valid[i]) mx = fmaxf(mx, s[i][r]);
      const float alpha = expf(m[r] - mx);
      float p[ROWS];
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        p[i] = valid[i] ? expf(s[i][r] - mx) : 0.f;
        psum += p[i];
      }
      l[r] = l[r] * alpha + psum;
      m[r] = mx;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        float a = acc[r][e] * alpha;
#pragma unroll
        for (int i = 0; i < ROWS; ++i) a += p[i] * vf[i][e];
        acc[r][e] = a;
      }
    }
  }

  // Merge the warps' partial softmaxes.
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    if (lane == 0) {
      sm_m[warp][r] = m[r];
      sm_l[warp][r] = l[r];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) sm_acc[warp][r][lane * EPL + e] = acc[r][e];
  }
  __syncthreads();
  bf16* ob = out + ((long)b * nh + (long)g * REP) * D;
  for (int idx = threadIdx.x; idx < REP * D; idx += NTHREADS) {
    const int r = idx / D, d = idx % D;
    float mx = NEG;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) mx = fmaxf(mx, sm_m[w][r]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float f = expf(sm_m[w][r] - mx);
      lsum += sm_l[w][r] * f;
      a += sm_acc[w][r][d] * f;
    }
    ob[r * D + d] = __float2bfloat16(a / fmaxf(lsum, 1e-30f));
  }
}

template <int D, int REP>
int launch(const void* q, const void* k_pool, const void* v_pool, const void* table,
           const void* lengths, void* out, int B, int n_kv, int total_pages, int page_size,
           int max_pages, cudaStream_t stream) {
  dim3 grid(n_kv, B);
  paged_attention_kernel<D, REP><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_pool),
      static_cast<const bf16*>(v_pool), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<bf16*>(out), n_kv, total_pages, page_size,
      max_pages);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int paged_attention_bf16(const void* q, const void* k_pool, const void* v_pool,
                                    const void* table, const void* lengths, void* out, int B,
                                    int nh, int n_kv, int D, int total_pages, int page_size,
                                    int max_pages, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (n_kv <= 0 || nh % n_kv != 0 || page_size <= 0 || max_pages <= 0 || total_pages <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // Built for the one shape on the serving path (llama_1b, llama3_8b): D 128,
  // 4 q heads per kv head. Other shapes get a template instance when a config
  // on the path needs one.
  if (D != 128 || nh / n_kv != 4) return (int)cudaErrorInvalidValue;
  return launch<128, 4>(q, k_pool, v_pool, table, lengths, out, B, n_kv, total_pages, page_size,
                        max_pages, st);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
