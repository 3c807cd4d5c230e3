// Causal / non-causal GQA flash-attention backward for Hopper (sm_90a), bf16:
// K2 computes dQ, K3 computes dK and dV.
//
// Replaces: ray_tpu/ops/attention.py:_flash_bwd_dq_kernel (K2) and
// _flash_bwd_dkv_kernel (K3), both launched through _flash_bwd -> pl.pallas_call.
//
// What they compute, from the forward's residuals (q, k, v, out, lse) and the
// output gradient dO, with delta[b, h, i] = sum_d dO[b, i, h, d] * out[b, i, h, d]
// computed outside (fp32, as the JAX package does):
//   s  = scale * q_i . k_j over the keys j that row i may see (j < Skv, and
//        j <= i + Skv - Sq when causal: bottom-right alignment, as in the forward)
//   p  = exp(s - lse_i)                 (fp32; 0 where masked)
//   dp = dO_i . v_j                     (fp32)
//   ds = p * (dp - delta_i) * scale     (fp32, rounded to bf16 for the products)
//   dq_i  = sum_j ds_ij k_j                             (K2)
//   dv_j  = sum_{h in group} sum_i p_ij dO_i            (K3, p rounded to bf16)
//   dk_j  = sum_{h in group} sum_i ds_ij q_i            (K3)
// Every product takes bf16 operands and accumulates in fp32; dq, dk and dv are
// written once, in bf16.
//
// Bound on the H100: at the training shape (B 8, S 2048, 16 q heads over 4 kv
// heads, D 128, causal) each S x S x D product over the visible half is 68.7
// GFLOP; K2 does 3 of them (s, dp, dq) and K3 does 4 (s, dp, dv, dk), so 0.21
// and 0.28 ms at 989 TFLOP/s, against 0.24 GB and 0.20 GB of inputs and
// outputs (0.07 and 0.06 ms at 3.35 TB/s): both are bound by operations. The
// design therefore keeps the S x S matrices out of device memory (p and ds are
// rebuilt tile by tile from lse, as in the forward) and feeds the tensor cores
// bf16 tiles through warp-level WMMA 16x16x16 products with fp32 accumulators
// held in registers for the whole loop. Tiles that the causal mask hides
// entirely are skipped through the loop bounds. K3 runs one block per kv head
// and loops over the 4 q heads of its group itself, so the GQA sum happens in
// its registers: no atomics, a fixed order, and no fp32 per-q-head scratch in
// device memory. Not yet done: wgmma, TMA and a pipelined tile ring (the loads
// here are synchronous), so both kernels are far from their bound.
//
// Layout: q/dO/dq [B, Sq, Hq, D], k/v/dk/dv [B, Skv, Hkv, D], all contiguous
// bf16; lse and delta [B, Hq, Sq] fp32. Built for D 128 with 4 q heads per kv
// head only (every configuration on the training path); anything else is
// refused. Ragged edges (S not a tile multiple, Sq < Skv) are masked here.
// K2: grid (ceil(Sq/64), Hq, B); K3: grid (ceil(Skv/64), Hkv, B); 128 threads,
// 4 warps, each warp owning 16 rows of the block's 64-row tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int D = 128;
constexpr int GROUP = 4;  // q heads per kv head
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int NFRAG = D / 16;  // 16-column accumulator fragments across D

// Row pitches, padded against bank conflicts; every WMMA tile pointer stays
// 32-byte aligned.
constexpr int LDH = D + 8;   // bf16 tiles of q, dO, k, v
constexpr int LDS = 64 + 4;  // fp32 64 x 64 score tiles (s, dp)
constexpr int LDP = 64 + 8;  // bf16 64 x 64 tiles (p, ds)
constexpr int LDO = D + 4;   // fp32 64 x D staging of a result for its store

constexpr size_t TILE_H = sizeof(bf16) * 64 * LDH;
constexpr size_t TILE_S = sizeof(float) * 64 * LDS;
constexpr size_t TILE_P = sizeof(bf16) * 64 * LDP;
static_assert(sizeof(float) * 64 * LDO <= 2 * TILE_S, "result staging must fit in s + dp");
static_assert(sizeof(float) * 64 * LDO <= 2 * TILE_H, "result staging must fit in two tiles");

// Shared memory of K2 (dQ): q, dO, k, v tiles; s and dp; ds; lse and delta.
struct SmemDq {
  static constexpr size_t q_off = 0;
  static constexpr size_t do_off = q_off + TILE_H;
  static constexpr size_t k_off = do_off + TILE_H;
  static constexpr size_t v_off = k_off + TILE_H;
  static constexpr size_t s_off = v_off + TILE_H;
  static constexpr size_t dp_off = s_off + TILE_S;
  static constexpr size_t ds_off = dp_off + TILE_S;
  static constexpr size_t row_off = ds_off + TILE_P;
  static constexpr size_t bytes = row_off + sizeof(float) * 2 * BQ;
};

// Shared memory of K3 (dK/dV): k, v, q, dO tiles; s^T and dp^T; p^T and ds^T;
// lse and delta of the current q tile.
struct SmemDkv {
  static constexpr size_t k_off = 0;
  static constexpr size_t v_off = k_off + TILE_H;
  static constexpr size_t q_off = v_off + TILE_H;
  static constexpr size_t do_off = q_off + TILE_H;
  static constexpr size_t s_off = do_off + TILE_H;
  static constexpr size_t dp_off = s_off + TILE_S;
  static constexpr size_t p_off = dp_off + TILE_S;
  static constexpr size_t ds_off = p_off + TILE_P;
  static constexpr size_t row_off = ds_off + TILE_P;
  static constexpr size_t bytes = row_off + sizeof(float) * 2 * BQ;
};

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragBRow;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBCol;

// A 64-row tile of one head into shared memory (row pitch LDH); rows at or
// past rows_valid are zero-filled. 16-byte loads, neighbouring threads on
// neighbouring addresses.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int rows_valid,
                                          long row_stride) {
  constexpr int VPR = D / 8;  // 16-byte pieces per row
  for (int i = threadIdx.x; i < 64 * VPR; i += NTHREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    const uint4 val = r < rows_valid
                          ? *reinterpret_cast<const uint4*>(src + (long)r * row_stride + c)
                          : make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(dst + r * LDH + c) = val;
  }
}

// out[16 x 64] (fp32, pitch LDS) = A[16 x D] . B^T where B is a 64 x D tile
// stored row-major (so B^T is read column-major): q.k^T, dO.v^T and their
// transposes k.q^T, v.dO^T.
__device__ __forceinline__ void rows_times_tile_t(float* out, const bf16* a, const bf16* b) {
  Acc acc[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + kk, LDH);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      FragBCol fb;
      wmma::load_matrix_sync(fb, b + n * 16 * LDH + kk, LDH);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < 4; ++n)
    wmma::store_matrix_sync(out + n * 16, acc[n], LDS, wmma::mem_row_major);
}

// acc[16 x D] += A[16 x 64] (bf16, pitch LDP) . B[64 x D] (bf16 tile, row-major).
__device__ __forceinline__ void accumulate_rows(Acc (&acc)[NFRAG], const bf16* a, const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < 64; kk += 16) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + kk, LDP);
#pragma unroll
    for (int n = 0; n < NFRAG; ++n) {
      FragBRow fb;
      wmma::load_matrix_sync(fb, b + kk * LDH + n * 16, LDH);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
}

// Stage a warp's 16 x D accumulator rows in shared memory (pitch LDO).
__device__ __forceinline__ void stage_rows(float* dst, const Acc (&acc)[NFRAG]) {
#pragma unroll
  for (int n = 0; n < NFRAG; ++n)
    wmma::store_matrix_sync(dst + n * 16, acc[n], LDO, wmma::mem_row_major);
}

// Write a staged 64 x D fp32 tile as bf16 rows [0, rows_valid) of dst.
__device__ __forceinline__ void write_rows(bf16* dst, const float* staged, int rows_valid,
                                           long row_stride) {
  for (int i = threadIdx.x; i < 64 * D / 2; i += NTHREADS) {
    const int r = i / (D / 2), c = (i % (D / 2)) * 2;
    if (r < rows_valid)
      *reinterpret_cast<__nv_bfloat162*>(dst + (long)r * row_stride + c) =
          __floats2bfloat162_rn(staged[r * LDO + c], staged[r * LDO + c + 1]);
  }
}

// ---------------------------------------------------------------- K2: dQ ---
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int Sq, int Skv, int Hq, int Hkv, int causal,
                    float scale) {
  using SM = SmemDq;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + SM::q_off);
  bf16* sDO = reinterpret_cast<bf16*>(smem + SM::do_off);
  bf16* sK = reinterpret_cast<bf16*>(smem + SM::k_off);
  bf16* sV = reinterpret_cast<bf16*>(smem + SM::v_off);
  float* sS = reinterpret_cast<float*>(smem + SM::s_off);
  float* sDP = reinterpret_cast<float*>(smem + SM::dp_off);
  bf16* sDS = reinterpret_cast<bf16*>(smem + SM::ds_off);
  float* sLse = reinterpret_cast<float*>(smem + SM::row_off);
  float* sDelta = sLse + BQ;

  // The last q tiles see the most keys: hand them out first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / GROUP;
  const int offset = Skv - Sq;  // query row i sits at absolute position offset + i
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q_rows = min(BQ, Sq - q0);

  const long q_rs = (long)Hq * D;
  const long kv_rs = (long)Hkv * D;
  const long q_base = ((long)b * Sq + q0) * q_rs + (long)h * D;
  const bf16* kb = k + (long)b * Skv * kv_rs + (long)hk * D;
  const bf16* vb = v + (long)b * Skv * kv_rs + (long)hk * D;
  const long row_base = ((long)b * Hq + h) * Sq + q0;

  load_tile(sQ, q + q_base, q_rows, q_rs);
  load_tile(sDO, dout + q_base, q_rows, q_rs);
  for (int r = threadIdx.x; r < BQ; r += NTHREADS) {
    sLse[r] = r < q_rows ? lse[row_base + r] : 0.f;
    sDelta[r] = r < q_rows ? delta[row_base + r] : 0.f;
  }

  Acc acc[NFRAG];
#pragma unroll
  for (int n = 0; n < NFRAG; ++n) wmma::fill_fragment(acc[n], 0.f);

  // Block-level causal skip (the JAX loop bound): no row of this tile sees a
  // key at or past kv_end.
  const int kv_end = causal ? min(Skv, q0 + BQ + offset) : Skv;
  const int n_tiles = (kv_end + BK - 1) / BK;
  const int wr = warp * 16;  // this warp's first row in the tile

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile(sK, kb + (long)k0 * kv_rs, min(BK, Skv - k0), kv_rs);
    load_tile(sV, vb + (long)k0 * kv_rs, min(BK, Skv - k0), kv_rs);
    __syncthreads();

    rows_times_tile_t(sS + wr * LDS, sQ + wr * LDH, sK);    // s  (unscaled)
    rows_times_tile_t(sDP + wr * LDS, sDO + wr * LDH, sV);  // dp
    __syncwarp();

    for (int rr = 0; rr < 16; ++rr) {
      const int r = wr + rr;
      const int qpos = q0 + r + offset;
      const float l = sLse[r], dl = sDelta[r];
#pragma unroll
      for (int c = 0; c < BK / 32; ++c) {
        const int col = lane + c * 32;
        const int kpos = k0 + col;
        const bool ok = kpos < Skv && (!causal || kpos <= qpos);
        const float p = ok ? expf(sS[r * LDS + col] * scale - l) : 0.f;
        sDS[r * LDP + col] = __float2bfloat16(p * (sDP[r * LDS + col] - dl) * scale);
      }
    }
    __syncwarp();

    accumulate_rows(acc, sDS + wr * LDP, sK);  // dq += ds . K
  }

  __syncthreads();  // the s/dp region now stages the result
  float* staged = sS;
  stage_rows(staged + wr * LDO, acc);
  __syncthreads();
  write_rows(dq + q_base, staged, q_rows, q_rs);
}

// ------------------------------------------------------------- K3: dK/dV ---
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Skv, int Hq,
                     int Hkv, int causal, float scale) {
  using SM = SmemDkv;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem + SM::k_off);
  bf16* sV = reinterpret_cast<bf16*>(smem + SM::v_off);
  bf16* sQ = reinterpret_cast<bf16*>(smem + SM::q_off);
  bf16* sDO = reinterpret_cast<bf16*>(smem + SM::do_off);
  float* sS = reinterpret_cast<float*>(smem + SM::s_off);    // s^T: [key][query]
  float* sDP = reinterpret_cast<float*>(smem + SM::dp_off);  // dp^T
  bf16* sP = reinterpret_cast<bf16*>(smem + SM::p_off);      // p^T
  bf16* sDS = reinterpret_cast<bf16*>(smem + SM::ds_off);    // ds^T
  float* sLse = reinterpret_cast<float*>(smem + SM::row_off);
  float* sDelta = sLse + BQ;

  const int k0 = blockIdx.x * BK;  // the first k tiles see the most queries
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int offset = Skv - Sq;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int k_rows = min(BK, Skv - k0);

  const long q_rs = (long)Hq * D;
  const long kv_rs = (long)Hkv * D;
  const long kv_base = ((long)b * Skv + k0) * kv_rs + (long)hk * D;

  load_tile(sK, k + kv_base, k_rows, kv_rs);
  load_tile(sV, v + kv_base, k_rows, kv_rs);

  Acc dk_acc[NFRAG], dv_acc[NFRAG];
#pragma unroll
  for (int n = 0; n < NFRAG; ++n) {
    wmma::fill_fragment(dk_acc[n], 0.f);
    wmma::fill_fragment(dv_acc[n], 0.f);
  }

  // First q tile whose last row (absolute position offset + i) can see key
  // k0: i >= k0 - offset (the JAX kernel's `first`, floored at 0).
  const int first = causal && k0 > offset ? (k0 - offset) / BQ : 0;
  const int n_q_tiles = (Sq + BQ - 1) / BQ;
  const int wr = warp * 16;  // this warp's first key row in the tile

  for (int g = 0; g < GROUP; ++g) {
    const int h = hk * GROUP + g;
    const bf16* qh = q + (long)b * Sq * q_rs + (long)h * D;
    const bf16* doh = dout + (long)b * Sq * q_rs + (long)h * D;
    const float* lse_h = lse + ((long)b * Hq + h) * Sq;
    const float* delta_h = delta + ((long)b * Hq + h) * Sq;
    for (int i = first; i < n_q_tiles; ++i) {
      const int q0 = i * BQ;
      const int q_rows = min(BQ, Sq - q0);
      __syncthreads();  // every warp is done with the previous q tile
      load_tile(sQ, qh + (long)q0 * q_rs, q_rows, q_rs);
      load_tile(sDO, doh + (long)q0 * q_rs, q_rows, q_rs);
      for (int r = threadIdx.x; r < BQ; r += NTHREADS) {
        sLse[r] = r < q_rows ? lse_h[q0 + r] : 0.f;
        sDelta[r] = r < q_rows ? delta_h[q0 + r] : 0.f;
      }
      __syncthreads();

      rows_times_tile_t(sS + wr * LDS, sK + wr * LDH, sQ);    // s^T  (unscaled)
      rows_times_tile_t(sDP + wr * LDS, sV + wr * LDH, sDO);  // dp^T
      __syncwarp();

      for (int rr = 0; rr < 16; ++rr) {
        const int r = wr + rr;  // key row in the tile
        const int kpos = k0 + r;
#pragma unroll
        for (int c = 0; c < BQ / 32; ++c) {
          const int col = lane + c * 32;  // query row in the tile
          const bool ok = col < q_rows && kpos < Skv && (!causal || kpos <= q0 + col + offset);
          const float p = ok ? expf(sS[r * LDS + col] * scale - sLse[col]) : 0.f;
          sP[r * LDP + col] = __float2bfloat16(p);
          sDS[r * LDP + col] = __float2bfloat16(p * (sDP[r * LDS + col] - sDelta[col]) * scale);
        }
      }
      __syncwarp();

      accumulate_rows(dv_acc, sP + wr * LDP, sDO);  // dv += p^T . dO
      accumulate_rows(dk_acc, sDS + wr * LDP, sQ);  // dk += ds^T . Q
    }
  }

  __syncthreads();  // s/dp stage dk, q/dO stage dv
  float* staged_dk = sS;
  float* staged_dv = reinterpret_cast<float*>(sQ);
  stage_rows(staged_dk + wr * LDO, dk_acc);
  stage_rows(staged_dv + wr * LDO, dv_acc);
  __syncthreads();
  write_rows(dk + kv_base, staged_dk, k_rows, kv_rs);
  write_rows(dv + kv_base, staged_dv, k_rows, kv_rs);
}

static_assert(SmemDkv::q_off + 2 * TILE_H == SmemDkv::s_off, "q and dO tiles are adjacent");

int check_shape(int B, int Sq, int Skv, int Hq, int Hkv, int Dim) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0) return (int)cudaErrorInvalidValue;
  if (Dim != D || Hq != GROUP * Hkv) return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
}

}  // namespace

extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dq, int B, int Sq,
                                 int Skv, int Hq, int Hkv, int Dim, int causal, float scale,
                                 void* stream) {
  int err = check_shape(B, Sq, Skv, Hq, Hkv, Dim);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)SmemDq::bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_bwd_dq_kernel<<<grid, NTHREADS, SmemDq::bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), Sq, Skv, Hq, Hkv, causal, scale);
  return (int)cudaGetLastError();
}

extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dk, void* dv, int B,
                                  int Sq, int Skv, int Hq, int Hkv, int Dim, int causal,
                                  float scale, void* stream) {
  int err = check_shape(B, Sq, Skv, Hq, Hkv, Dim);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkv_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)SmemDkv::bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Skv + BK - 1) / BK, Hkv, B);
  flash_bwd_dkv_kernel<<<grid, NTHREADS, SmemDkv::bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), Sq, Skv,
      Hq, Hkv, causal, scale);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
