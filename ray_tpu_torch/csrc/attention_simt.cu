// Attention on the CUDA cores for Hopper (sm_90a), in fp32: the flash forward
// (with or without lse) and paged decode.
//
// Replaces, for the shapes the tensor-core kernels do not take:
//   ray_tpu/ops/attention.py:_flash_fwd_kernel (:71), with and without lse;
//   the Pallas library's paged_attention as called by
//   ray_tpu/models/paged_decode.py:_paged_attention (:93).
// The reference runs its kernels in any dtype. The bf16 kernels of
// flash_fwd.cu and flash_bwd.cu (wgmma) tile head dims 64, 128 and 256,
// paged_attention.cu (mma.sync) bf16 at 128 and 256, and flash_bwd_f32.cu
// the fp32 backward (dQ, dK/dV) at 64, 128 and 256 in 3xTF32. This file
// takes the rest of what the port's dispatch sends to a kernel: the fp32
// forward and the fp32 paged decode at head dims 64, 128 and 256.
//
// Precision. fp32 attention is computed with full fp32 products (FFMA on the
// CUDA cores), not TF32 on the tensor cores: the plain version on the card is
// full fp32 (torch's float32 matmuls do not use TF32 by default), the JAX
// tests hold flash against its reference in fp32 at 2e-5, and TF32 keeps
// about three decimal digits. Sums and exponentials are fp32 (expf, logf: no
// approximate intrinsics).
//
// Bound: at the shapes these kernels see, the products are operations on the
// CUDA cores (the H100's fp32 rate, 67 TFLOP/s, is 1/15 of bf16 on the tensor
// cores), so they are bound by operations. The design is the simple tiled
// one, right first: a forward block of 128 threads owns BR = 16 q rows; it
// streams K and V in tiles of BC = 64 rows through shared memory (row stride
// D + 1 floats, so the 8 threads of a row read 8 different banks). Thread
// (r, c) = (tid / 8, tid % 8) computes the scores of its row r against
// streamed rows c + 8 j, j < 8; the 8 threads of a row are 8 lanes of one warp
// and reduce the row's max and sum by shuffles; the row's output columns are
// c + 8 jj. Causal tiles past the diagonal are skipped; ragged edges are
// masked (causal bottom-right: query row i sees key j iff j <= i + Skv - Sq).
// No atomics: every kernel here is bitwise repeatable.
//
// Paged decode: one block per (q head, slot), 128 threads; the slot's rows in
// tiles of 64, each K/V row found through the block table; two threads a row
// for Q.K, block-wide max and sum, each thread owns D / 128 (at least one)
// output columns of P.V. It reads a kv head's rows once per q head.
//
// Layouts as in flash_fwd.cu and paged_attention.cu: q/out [B, Sq, Hq, D],
// k/v [B, Skv, Hkv, D], lse [B, Hq, Sq] fp32; pools [n_kv, total_pages,
// page_size, D], table [B, max_pages] int32, lengths [B] int32, q/out
// [B, nh, D]. All contiguous.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;        // threads a block
constexpr int BR = 16;         // q rows a forward block owns
constexpr int BC = 64;         // rows of the streamed operand a tile
constexpr int TPR = NT / BR;   // threads a row: 8 lanes of one warp
constexpr int CPT = BC / TPR;  // streamed rows a thread scores: 8
constexpr int PLD = BC + 1;    // row stride of the p tile
constexpr float NEG = -1e30f;
constexpr int F32 = 0;  // the entries' dtype code (the wrappers pass 1 for bf16, refused)

// Over the 8 lanes of a row (lanes 8 k .. 8 k + 7 of a warp).
__device__ __forceinline__ float row_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
}
__device__ __forceinline__ float row_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v + __shfl_xor_sync(0xffffffffu, v, 1);
}

// Rows row0 .. row0 + n - 1 of a [rows, stride] matrix (columns 0 .. D - 1)
// into dst [n][D + 1] as fp32, zeros past row_end.
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src, long stride, int row0,
                                          int n, int row_end) {
  for (int i = threadIdx.x; i < n * D; i += NT) {
    const int r = i / D, d = i % D;
    dst[r * (D + 1) + d] = row0 + r < row_end ? src[(long)(row0 + r) * stride + d] : 0.f;
  }
}

__device__ __forceinline__ float dot(const float* a, const float* b, int n) {
  float s = 0.f;
  for (int d = 0; d < n; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

// ---------------------------------------------------------------------------
// Forward, fp32: grid (ceil(Sq / BR), Hq, B). out_lo, the output's rounding
// residual, is 0 in fp32.
template <int D>
__global__ void __launch_bounds__(NT)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           float* __restrict__ out, float* __restrict__ lse, float* __restrict__ out_lo, int Sq,
           int Skv, int Hq, int Hkv, int causal, float scale) {
  constexpr int LD = D + 1;
  extern __shared__ float sm[];
  float* sQ = sm;                // [BR][LD]
  float* sK = sQ + BR * LD;      // [BC][LD]
  float* sV = sK + BC * LD;      // [BC][LD]
  float* sP = sV + BC * LD;      // [BR][PLD]
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int off = Skv - Sq;
  const int q0 = blockIdx.x * BR;
  const int r = threadIdx.x / TPR, c = threadIdx.x % TPR;
  const int qi = q0 + r;
  const long qs = (long)Hq * D, ks = (long)Hkv * D;
  const float* kb = k + (long)b * Skv * ks + (long)hk * D;
  const float* vb = v + (long)b * Skv * ks + (long)hk * D;
  load_rows<D>(sQ, q + (long)b * Sq * qs + (long)h * D, qs, q0, BR, Sq);
  // keys any row of the tile sees
  const int kend = causal ? min(Skv, min(q0 + BR, Sq) + off) : Skv;

  float m = NEG, l = 0.f;
  float o[D / TPR];
#pragma unroll
  for (int jj = 0; jj < D / TPR; ++jj) o[jj] = 0.f;
  for (int k0 = 0; k0 < kend; k0 += BC) {
    __syncthreads();  // the previous tile is consumed (and sQ is loaded)
    load_rows<D>(sK, kb, ks, k0, BC, Skv);
    load_rows<D>(sV, vb, ks, k0, BC, Skv);
    __syncthreads();
    float s[CPT];
    bool seen[CPT];
    float mx = NEG;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int kj = k0 + c + TPR * j;
      seen[j] = kj < Skv && (!causal || kj <= qi + off);
      s[j] = seen[j] ? dot(sQ + r * LD, sK + (c + TPR * j) * LD, D) * scale : NEG;
      mx = fmaxf(mx, s[j]);
    }
    const float m_new = fmaxf(m, row_max(mx));
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const float p = seen[j] ? expf(s[j] - m_new) : 0.f;
      psum += p;
      sP[r * PLD + c + TPR * j] = p;
    }
    l = l * alpha + row_sum(psum);
    m = m_new;
    __syncwarp();  // the row's p, written by its 8 lanes, read by the same 8
#pragma unroll
    for (int jj = 0; jj < D / TPR; ++jj) o[jj] *= alpha;
    for (int kk = 0; kk < BC; ++kk) {
      const float p = sP[r * PLD + kk];
#pragma unroll
      for (int jj = 0; jj < D / TPR; ++jj) o[jj] = fmaf(p, sV[kk * LD + c + TPR * jj], o[jj]);
    }
  }
  if (qi >= Sq) return;
  const float lsafe = fmaxf(l, 1e-30f);
  const float inv = 1.f / lsafe;
  const long row = ((long)b * Sq + qi) * qs + (long)h * D;
#pragma unroll
  for (int jj = 0; jj < D / TPR; ++jj) {
    out[row + c + TPR * jj] = o[jj] * inv;
    if (out_lo != nullptr) out_lo[row + c + TPR * jj] = 0.f;
  }
  if (lse != nullptr && c == 0) lse[((long)b * Hq + h) * Sq + qi] = m + logf(lsafe);
}

// ---------------------------------------------------------------------------
// Paged decode: grid (nh, B). q arrives pre-scaled.
constexpr int PT = 64;  // a slot's rows a tile

__device__ __forceinline__ float block_reduce(float v, float* red, bool is_max) {
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmaxf(v, w) : v + w;
  }
  __syncthreads();  // red is free
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < NT / 32; ++w) v = is_max ? fmaxf(v, red[w]) : v + red[w];
  return v;
}

template <int D>
__global__ void __launch_bounds__(NT)
paged_kernel(const float* __restrict__ q, const float* __restrict__ k_pool,
             const float* __restrict__ v_pool, const int* __restrict__ table,
             const int* __restrict__ lengths, float* __restrict__ out, int nh, int n_kv,
             int total_pages, int page_size, int max_pages) {
  constexpr int LD = D + 1;
  constexpr int OC = (D + NT - 1) / NT;  // output columns a thread
  extern __shared__ float sm[];
  float* sq = sm;              // [D]
  float* sK = sq + D;          // [PT][LD]
  float* sV = sK + PT * LD;    // [PT][LD]
  float* sp = sV + PT * LD;    // [PT]
  float* red = sp + PT;        // [NT / 32]
  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (nh / n_kv);
  const int tid = threadIdx.x;
  const int len = max(0, min(lengths[b], max_pages * page_size));
  const long orow = ((long)b * nh + h) * D;
  if (len == 0) {  // lengths[b] <= 0: zeros, as paged_attention.cu writes
    for (int d = tid; d < D; d += NT) out[orow + d] = 0.f;
    return;
  }
  for (int d = tid; d < D; d += NT) sq[d] = q[orow + d];
  const int* tb = table + (long)b * max_pages;
  const long pool_head = (long)g * total_pages * page_size;

  float m = NEG, l = 0.f, o[OC];
#pragma unroll
  for (int i = 0; i < OC; ++i) o[i] = 0.f;
  const int kr = tid / 2, half = tid % 2;  // Q.K: two threads a row, half of D each
  for (int t0 = 0; t0 < len; t0 += PT) {
    __syncthreads();  // the previous tile is consumed (and sq is loaded)
    for (int i = tid; i < PT * D; i += NT) {
      const int rr = i / D, d = i % D, t = t0 + rr;
      float kv = 0.f, vv = 0.f;
      if (t < len) {
        const int page = min(max(tb[t / page_size], 0), total_pages - 1);
        const long at = (pool_head + (long)page * page_size + t % page_size) * D + d;
        kv = k_pool[at];
        vv = v_pool[at];
      }
      sK[rr * LD + d] = kv;
      sV[rr * LD + d] = vv;
    }
    __syncthreads();
    float s = dot(sq + half * (D / 2), sK + kr * LD + half * (D / 2), D / 2);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    const bool seen = t0 + kr < len;
    if (!seen) s = NEG;
    const float m_new = fmaxf(m, block_reduce(s, red, true));
    const float alpha = expf(m - m_new);
    const float p = seen ? expf(s - m_new) : 0.f;
    if (half == 0) sp[kr] = p;
    l = l * alpha + block_reduce(half == 0 ? p : 0.f, red, false);
    m = m_new;
    __syncthreads();  // sp is written
#pragma unroll
    for (int i = 0; i < OC; ++i) {
      const int d = tid + NT * i;
      if (d < D) {
        float acc = o[i] * alpha;
        for (int t = 0; t < PT; ++t) acc = fmaf(sp[t], sV[t * LD + d], acc);
        o[i] = acc;
      }
    }
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < OC; ++i) {
    const int d = tid + NT * i;
    if (d < D) out[orow + d] = o[i] * inv;
  }
}

// ---------------------------------------------------------------------------
// Launchers
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int D>
int fwd_launch(const void* q, const void* k, const void* v, void* out, void* lse, void* out_lo,
               int B, int Sq, int Skv, int Hq, int Hkv, int causal, float scale,
               cudaStream_t st) {
  const size_t bytes = sizeof(float) * ((BR + 2 * BC) * (D + 1) + BR * PLD);
  cudaError_t err = allow_smem(fwd_kernel<D>, bytes);
  if (err != cudaSuccess) return (int)err;
  fwd_kernel<D><<<dim3((Sq + BR - 1) / BR, Hq, B), NT, bytes, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), static_cast<float*>(lse), static_cast<float*>(out_lo), Sq, Skv,
      Hq, Hkv, causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int paged_launch(const void* q, const void* k_pool, const void* v_pool, const void* table,
                 const void* lengths, void* out, int B, int nh, int n_kv, int total_pages,
                 int page_size, int max_pages, cudaStream_t st) {
  const size_t bytes = sizeof(float) * (D + 2 * PT * (D + 1) + PT + NT / 32);
  cudaError_t err = allow_smem(paged_kernel<D>, bytes);
  if (err != cudaSuccess) return (int)err;
  paged_kernel<D><<<dim3(nh, B), NT, bytes, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k_pool),
      static_cast<const float*>(v_pool), static_cast<const int*>(table),
      static_cast<const int*>(lengths), static_cast<float*>(out), nh, n_kv, total_pages,
      page_size, max_pages);
  return (int)cudaGetLastError();
}

int check_shape(int B, int Sq, int Skv, int Hq, int Hkv) {
  if (Skv <= 0 || Hkv <= 0 || Hq <= 0 || B < 0 || Sq < 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// The instances: fp32 at D 64, 128 and 256 for every kernel (bf16 is
// flash_fwd.cu's, flash_bwd.cu's and paged_attention.cu's). Any other
// (dtype, D) returns cudaErrorInvalidValue.
#define SIMT_F32(CALL)                            \
  if (dtype == F32 && D == 64) return CALL(64);   \
  if (dtype == F32 && D == 128) return CALL(128); \
  if (dtype == F32 && D == 256) return CALL(256);

extern "C" int simt_flash_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                              void* out_lo, int B, int Sq, int Skv, int Hq, int Hkv, int D,
                              int causal, float scale, int dtype, void* stream) {
  if (B == 0 || Sq == 0) return (int)cudaSuccess;
  if (int err = check_shape(B, Sq, Skv, Hq, Hkv)) return err;
  if ((lse == nullptr) != (out_lo == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FWD(DIM) fwd_launch<DIM>(q, k, v, out, lse, out_lo, B, Sq, Skv, Hq, Hkv, causal, scale, st)
  SIMT_F32(FWD)
#undef FWD
  return (int)cudaErrorInvalidValue;
}

extern "C" int simt_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                                    const void* table, const void* lengths, void* out, int B,
                                    int nh, int n_kv, int D, int total_pages, int page_size,
                                    int max_pages, int dtype, void* stream) {
  if (B == 0) return (int)cudaSuccess;
  if (n_kv <= 0 || nh % n_kv != 0 || page_size <= 0 || max_pages <= 0 || total_pages <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PAGED(DIM)                                                                      \
  paged_launch<DIM>(q, k_pool, v_pool, table, lengths, out, B, nh, n_kv, total_pages, \
                    page_size, max_pages, st)
  SIMT_F32(PAGED)
#undef PAGED
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
