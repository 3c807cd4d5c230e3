// Causal / non-causal GQA flash-attention forward for Hopper (sm_90a), bf16.
//
// Replaces: ray_tpu/ops/attention.py:_flash_fwd_kernel, launched through
// _flash_fwd -> pl.pallas_call (the with_lse=False call on the serving path).
//
// What it computes: out[b, i, h, :] = softmax(scale * q_i . K^T) V over the keys
// j that row i may see (j < Skv, and j <= i + Skv - Sq when causal: the queries
// sit after the cached keys, bottom-right alignment), with q head h reading kv
// head h / (Hq / Hkv). Optionally lse[b, h, i] = m + log(l) (fp32), the residual
// the training backward needs; the serving path passes a null pointer.
//
// Bound on the H100: with causal masking and 4 q heads per kv head it does about
// S * 0.4 flops per byte moved (~205 at S 512), under the card's ~295 bf16
// flops per byte of HBM, so at the prefill buckets (S 64..512) its bound is
// bytes, with operations close behind; longer sequences are bound by the
// tensor cores (this kernel is still far from both; see PERF.md). The design
// keeps the S x S scores out of device memory (online softmax with fp32
// running max m, normaliser l and accumulator), feeds the
// tensor cores bf16 operands through warp-level WMMA 16x16x16 products with
// fp32 accumulation, skips key tiles that the causal mask hides entirely, and
// loads the next K/V tile into registers while the current one is in use.
// Ragged edges (S not a tile multiple, Sq < Skv) are masked here, so no caller
// pads. Not yet done: wgmma, TMA and a deeper K/V ring (later work).
//
// Layout: q [B, Sq, Hq, D], k/v [B, Skv, Hkv, D], out [B, Sq, Hq, D], all
// contiguous bf16; lse [B, Hq, Sq] fp32. Grid (ceil(Sq/64), Hq, B), 128 threads:
// 4 warps, each owning 16 rows of the 64-row query tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG = -1e30f;

// Shared-memory plan. Row pitches are padded (fewer bank conflicts) and keep
// every WMMA tile pointer 32-byte aligned.
template <int D>
struct Smem {
  static constexpr int LDH = D + 8;   // bf16 Q, K, V tiles
  static constexpr int LDS = BK + 4;  // fp32 scores
  static constexpr int LDP = BK + 8;  // bf16 probabilities
  static constexpr int LDO = D + 4;   // fp32 output accumulator
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + sizeof(bf16) * BQ * LDH;
  static constexpr size_t v_off = k_off + sizeof(bf16) * BK * LDH;
  static constexpr size_t s_off = v_off + sizeof(bf16) * BK * LDH;
  static constexpr size_t p_off = s_off + sizeof(float) * BQ * LDS;
  static constexpr size_t o_off = p_off + sizeof(bf16) * BQ * LDP;
  static constexpr size_t row_off = o_off + sizeof(float) * BQ * LDO;
  static constexpr size_t bytes = row_off + sizeof(float) * 3 * BQ;
};

// A 64-row tile of one head, staged in registers: each thread holds PER
// 16-byte pieces, so all of a tile's loads are in flight at once.
template <int D>
struct TileRegs {
  static constexpr int VEC = 8;  // bf16 per 16 bytes
  static constexpr int VPR = D / VEC;
  static constexpr int PER = 64 * VPR / NTHREADS;
  uint4 v[PER];

  // rows at or past rows_valid are zero-filled; row pitch row_stride elements
  __device__ __forceinline__ void load(const bf16* src, int rows_valid, long row_stride) {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = threadIdx.x + j * NTHREADS;
      const int r = i / VPR, c = (i % VPR) * VEC;
      v[j] = r < rows_valid ? *reinterpret_cast<const uint4*>(src + (long)r * row_stride + c)
                            : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  __device__ __forceinline__ void store(bf16* dst) const {
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = threadIdx.x + j * NTHREADS;
      *reinterpret_cast<uint4*>(dst + (i / VPR) * Smem<D>::LDH + (i % VPR) * VEC) = v[j];
    }
  }
};

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, float* __restrict__ lse,
                 int Sq, int Skv, int Hq, int Hkv, int causal, float scale) {
  using SM = Smem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + SM::q_off);
  bf16* sK = reinterpret_cast<bf16*>(smem + SM::k_off);
  bf16* sV = reinterpret_cast<bf16*>(smem + SM::v_off);
  float* sS = reinterpret_cast<float*>(smem + SM::s_off);
  bf16* sP = reinterpret_cast<bf16*>(smem + SM::p_off);
  float* sO = reinterpret_cast<float*>(smem + SM::o_off);
  float* sM = reinterpret_cast<float*>(smem + SM::row_off);
  float* sL = sM + BQ;
  float* sA = sL + BQ;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int offset = Skv - Sq;  // query row i sits at absolute position offset + i
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const long q_rs = (long)Hq * D;
  const long kv_rs = (long)Hkv * D;
  const bf16* qb = q + ((long)b * Sq + q0) * q_rs + (long)h * D;
  const bf16* kb = k + (long)b * Skv * kv_rs + (long)hk * D;
  const bf16* vb = v + (long)b * Skv * kv_rs + (long)hk * D;

  TileRegs<D> rk, rv;  // the next K/V tile, in flight while the current one is used
  rk.load(qb, min(BQ, Sq - q0), q_rs);
  rk.store(sQ);
  for (int i = threadIdx.x; i < BQ * D; i += NTHREADS) sO[(i / D) * SM::LDO + i % D] = 0.f;
  for (int i = threadIdx.x; i < BQ; i += NTHREADS) {
    sM[i] = NEG;
    sL[i] = 0.f;
  }

  // Block-level causal skip: no row of this tile sees a key at or past kv_end.
  const int kv_end = causal ? min(Skv, q0 + BQ + offset) : Skv;
  const int n_tiles = (kv_end + BK - 1) / BK;

  if (n_tiles > 0) {
    rk.load(kb, min(BK, Skv), kv_rs);
    rv.load(vb, min(BK, Skv), kv_rs);
  }
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    rk.store(sK);
    rv.store(sV);
    __syncthreads();
    if (j + 1 < n_tiles) {  // prefetch: these loads overlap this tile's math
      const int k1 = k0 + BK;
      rk.load(kb + (long)k1 * kv_rs, min(BK, Skv - k1), kv_rs);
      rv.load(vb + (long)k1 * kv_rs, min(BK, Skv - k1), kv_rs);
    }

    // Scores for this warp's 16 rows against all BK keys: Q [16, D] . K^T.
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BK / 16];
#pragma unroll
      for (int n = 0; n < BK / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, sQ + warp * 16 * SM::LDH + kk, SM::LDH);
#pragma unroll
        for (int n = 0; n < BK / 16; ++n) {
          // K stored [key, d] row-major is K^T in column-major order.
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
          wmma::load_matrix_sync(fb, sK + n * 16 * SM::LDH + kk, SM::LDH);
          wmma::mma_sync(acc[n], fa, fb, acc[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < BK / 16; ++n)
        wmma::store_matrix_sync(sS + warp * 16 * SM::LDS + n * 16, acc[n], SM::LDS,
                                wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax, one row at a time; each lane takes BK/32 columns.
    for (int rr = 0; rr < 16; ++rr) {
      const int r = warp * 16 + rr;
      const int qpos = q0 + r + offset;
      float s[BK / 32];
      bool ok[BK / 32];
      float mx = NEG;
#pragma unroll
      for (int c = 0; c < BK / 32; ++c) {
        const int col = lane + c * 32;
        const int kpos = k0 + col;
        ok[c] = kpos < Skv && (!causal || kpos <= qpos);
        s[c] = sS[r * SM::LDS + col] * scale;  // scale after the dot, in fp32
        if (ok[c]) mx = fmaxf(mx, s[c]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < BK / 32; ++c) {
        const float p = ok[c] ? expf(s[c] - m_new) : 0.f;
        sum += p;
        sP[r * SM::LDP + lane + c * 32] = __float2bfloat16(p);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();  // every lane has read sM[r]
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        sM[r] = m_new;
        sL[r] = sL[r] * alpha + sum;
        sA[r] = alpha;
      }
    }
    __syncwarp();

    // Rescale this warp's accumulator rows, then accumulate P [16, BK] . V.
    for (int i = lane; i < 16 * D; i += 32) {
      const int r = warp * 16 + i / D;
      sO[r * SM::LDO + i % D] *= sA[r];
    }
    __syncwarp();
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      float* optr = sO + warp * 16 * SM::LDO + n * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, optr, SM::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, sP + warp * 16 * SM::LDP + kk, SM::LDP);
        wmma::load_matrix_sync(fb, sV + kk * SM::LDH + n * 16, SM::LDH);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(optr, acc, SM::LDO, wmma::mem_row_major);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < BQ * D; i += NTHREADS) {
    const int r = i / D, c = i % D;
    if (q0 + r < Sq) {
      const float l = fmaxf(sL[r], 1e-30f);
      out[((long)b * Sq + q0 + r) * q_rs + (long)h * D + c] =
          __float2bfloat16(sO[r * SM::LDO + c] / l);
    }
  }
  if (lse != nullptr) {
    for (int r = threadIdx.x; r < BQ; r += NTHREADS)
      if (q0 + r < Sq)
        lse[((long)b * Hq + h) * Sq + q0 + r] = sM[r] + logf(fmaxf(sL[r], 1e-30f));
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, int B, int Sq,
           int Skv, int Hq, int Hkv, int causal, float scale, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Smem<D>::bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  kern<<<grid, NTHREADS, Smem<D>::bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), static_cast<float*>(lse), Sq, Skv, Hq, Hkv, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v, void* out, void* lse,
                              int B, int Sq, int Skv, int Hq, int Hkv, int D, int causal,
                              float scale, void* stream) {
  if (B <= 0 || Sq <= 0) return (int)cudaSuccess;
  if (Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128) return launch<128>(q, k, v, out, lse, B, Sq, Skv, Hq, Hkv, causal, scale, st);
  if (D == 64) return launch<64>(q, k, v, out, lse, B, Sq, Skv, Hq, Hkv, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
