// The flash-attention forward in fp32 for Hopper (sm_90a), on the tensor
// cores in 3xTF32: K1 (out) and K1' (out, lse and out_lo, the training
// forward).
//
// Replaces, in fp32: ray_tpu/ops/attention.py:_flash_fwd_kernel (:71),
// launched through _flash_fwd (:123) at pallas_call :155 (with lse) and
// :170 (without). bf16 is flash_fwd.cu's (wgmma). This file takes fp32 at
// head dims 64, 128 and 256, any GQA group.
//
// What it computes, per q row i and head h (kv head h / (Hq / Hkv)):
//   s_ij = scale * q_i . k_j over the keys j that row i may see (j < Skv,
//          and j <= i + Skv - Sq when causal: bottom-right alignment)
//   out_i = sum_j exp(s_ij - lse_i) v_j,  lse_i = log sum_j exp(s_ij)
// lse is written when the caller passes it (K1'), and out_lo, the output's
// rounding residual, is zeros in fp32.
//
// Precision: 3xTF32 (tf32x3.cuh): the JAX tests hold fp32 flash at atol =
// rtol = 2e-5 (tests/test_ops_attention.py), which one TF32 product misses.
// O's sum over keys takes each 8-key product P V from a zeroed accumulator
// and adds it in fp32 (mma3_add), and so does S's sum over the head dim at
// D 256 (32 steps); at D 64 and 128 (8 and 16 steps) S stays in the tensor
// cores' accumulator, as in flash_bwd_f32.cu. The online softmax (max,
// exp, the rescale of O and l by alpha between tiles) is fp32, with expf
// and logf: no approximate intrinsics.
//
// Bound on the H100: at the c5 fp32 train shape (B 2, S 512, 16 q heads over
// 4, D 128, causal) K1' does 2.2 GFLOP (two S x S x D products over the
// visible half); 3xTF32 takes three tensor-core products each, so at a
// third of 494.7 TFLOP/s of dense TF32 it is bound by operations, 0.013 ms,
// against 29.4 MB of inputs and outputs (0.009 ms at 3.35 TB/s). The design
// is PR 17's dQ kernel (flash_bwd_f32.cu, K2) with one product fewer:
//
// - A block owns 64 q rows, 4 warps of 16, with Q resident in shared
//   memory; K and V stream in tiles of BC keys through a ring of ST stages
//   (cp.async, row stride D + 4 floats). Tiles past a causal block's
//   diagonal are not loaded, and a warp whose 16 rows see none of a tile's
//   keys skips it. Grid (q tiles, Hq, B), the q tiles in reverse order, so
//   that a causal grid starts its longest blocks first.
// - S = Q K^T by a_rows on Q and b_trans on K; P, in S's accumulator
//   registers, feeds O += P V as the A fragment (a_acc) with V read in the
//   permuted key order (b_perm). Nothing S x S goes to shared memory.
// - The online softmax runs on the accumulator rows: a thread holds 2 rows
//   (gid and gid + 8 of its warp's 16), each row spread over a quad, so the
//   row max takes two quad shuffles; l is summed per thread and over the
//   quad once at the end.
// - Tiles of BC = 64 keys in one stage at D 64 (51 KB, four blocks an SM)
//   and D 128 (99 KB, two blocks an SM). On the H100, at D 128 that was
//   12-15% faster than two stages of 32 keys (the same 99 KB; fewer
//   barriers, 8 independent score accumulators) and 26-35% faster than two
//   stages of 64 (165 KB, one block an SM), at B2 S512 and B8 S2048; at
//   D 64, 16% faster than two stages of 64 at B8 S2048 and the same at B2
//   S512. D 256: O's 16 x 256 accumulator (128 registers) does not fit a
//   warp beside S, so 8 warps, two on each 16 rows, split the head dim of O
//   (DS = 2; each warp of a pair computes the same S and softmax, as
//   flash_bwd_f32.cu's K3 does at D 256); BC = 32, ST = 2 (195 KB): one
//   stage of 64 keys (the same 195 KB) was no faster.
// - No atomics: every sum runs in a fixed order, so the kernel is bitwise
//   repeatable.
//
// Layouts as in flash_fwd.cu: q/out/out_lo [B, Sq, Hq, D], k/v
// [B, Skv, Hkv, D], lse [B, Hq, Sq], all fp32 and contiguous.

#include "tf32x3.cuh"

namespace {

constexpr int ROWS = 64;  // q rows a block owns
constexpr int RW = 16;    // rows a warp owns: the m16 of the mma
constexpr float NEG = -1e30f;

template <int D, int BC, int ST>
struct FwdShape {
  static constexpr int LD = D + 4;
  static constexpr size_t BYTES = sizeof(float) * (ROWS + 2 * ST * BC) * LD;
};

// grid (ceil(Sq / 64), Hq, B), 128 * DS threads
template <int D, int BC, int ST, int DS>
__global__ void __launch_bounds__(128 * DS)
flash_fwd_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ out,
                        float* __restrict__ lse, float* __restrict__ out_lo, int Sq, int Skv,
                        int Hq, int Hkv, int causal, float scale) {
  constexpr int NT = 128 * DS, LD = D + 4, NB = BC / 8, ND = D / 8, DW = D / DS, NDW = DW / 8;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // [ROWS][LD]
  float* sK = sQ + ROWS * LD;                   // [ST][BC][LD]
  float* sV = sK + ST * BC * LD;                // [ST][BC][LD]
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (Hq / Hkv);
  const int off = Skv - Sq, q0 = (gridDim.x - 1 - blockIdx.x) * ROWS;
  const int warp = threadIdx.x / 32, gid = threadIdx.x % 32 / 4, tig = threadIdx.x % 4;
  const int qw = warp % 4, col0 = warp / 4 * DW;  // the warp's 16 rows, and its O columns
  const long qs = (long)Hq * D, ks = (long)Hkv * D;
  const float* qb = q + (long)b * Sq * qs + (long)h * D;
  const float* kb = k + (long)b * Skv * ks + (long)hk * D;
  const float* vb = v + (long)b * Skv * ks + (long)hk * D;
  // keys any row of the block sees
  const int kend = causal ? min(Skv, min(q0 + ROWS, Sq) + off) : Skv;
  const int ntiles = kend > 0 ? (kend + BC - 1) / BC : 0;

  load_rows<D, NT>(sQ, qb, qs, q0, ROWS, Sq);
  cp_commit();
#pragma unroll
  for (int s = 0; s < ST; ++s) {
    if (s < ntiles) {
      load_rows<D, NT>(sK + s * BC * LD, kb, ks, s * BC, BC, Skv);
      load_rows<D, NT>(sV + s * BC * LD, vb, ks, s * BC, BC, Skv);
    }
    cp_commit();
  }
  const int w0 = q0 + RW * qw;  // the warp's first row
  const int r0 = w0 + gid;      // this thread's rows: r0 and r0 + 8
  // whether the warp has rows, and the last key any of them sees
  const bool rows_live = w0 < Sq;
  const int wlast = causal ? min(w0 + RW, Sq) - 1 + off : Skv - 1;
  const float* wq = sQ + RW * qw * LD;

  float o[NDW][4];
#pragma unroll
  for (int n = 0; n < NDW; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  for (int t = 0; t < ntiles; ++t) {
    cp_wait<ST - 1>();
    __syncthreads();  // tile t (and Q) landed for every thread
    const float* tK = sK + (t % ST) * BC * LD;
    const float* tV = sV + (t % ST) * BC * LD;
    const int k0 = t * BC;
    if (rows_live && k0 <= wlast) {  // warp-uniform
      float s[NB][4];
#pragma unroll
      for (int n = 0; n < NB; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      // S = Q K^T over the head dim
#pragma unroll 2
      for (int kk = 0; kk < ND; ++kk) {
        const AFrag aq = a_rows(wq, LD, 8 * kk, gid, tig);
#pragma unroll
        for (int n = 0; n < NB; ++n)
          mma3_to<(D > 128)>(s[n], aq, b_trans(tK, LD, 8 * n, 8 * kk, gid, tig));
      }
      // scale and mask; the rows' max over the tile
      float mx[2] = {NEG, NEG};
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + 8 * (e >> 1), key = k0 + 8 * n + 2 * tig + (e & 1);
          const bool seen = key < Skv && (!causal || key <= row + off);
          s[n][e] = seen ? s[n][e] * scale : NEG;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
        }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        alpha[i] = expf(m[i] - m_new);
        m[i] = m_new;
        l[i] *= alpha[i];
      }
      // p in place of s
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + 8 * (e >> 1), key = k0 + 8 * n + 2 * tig + (e & 1);
          const bool seen = key < Skv && (!causal || key <= row + off);
          const float p = seen ? expf(s[n][e] - m[e >> 1]) : 0.f;
          l[e >> 1] += p;
          s[n][e] = p;
        }
#pragma unroll
      for (int nd = 0; nd < NDW; ++nd) {
        o[nd][0] *= alpha[0];
        o[nd][1] *= alpha[0];
        o[nd][2] *= alpha[1];
        o[nd][3] *= alpha[1];
      }
      // O += P V over the tile's keys in the permuted order, on the warp's
      // DW columns
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        const AFrag a = a_acc(s[n]);
#pragma unroll
        for (int nd = 0; nd < NDW; ++nd)
          mma3_add(o[nd], a, b_perm(tV, LD, 8 * n, col0 + 8 * nd, gid, tig));
      }
    }
    __syncthreads();  // every warp is done with the stage
    if (t + ST < ntiles) {
      load_rows<D, NT>(sK + (t % ST) * BC * LD, kb, ks, (t + ST) * BC, BC, Skv);
      load_rows<D, NT>(sV + (t % ST) * BC * LD, vb, ks, (t + ST) * BC, BC, Skv);
    }
    cp_commit();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = r0 + 8 * i;
    if (row >= Sq) continue;
    const float lsafe = fmaxf(l[i], 1e-30f);
    const float inv = 1.f / lsafe;
    const long at = ((long)b * Sq + row) * qs + (long)h * D + col0 + 2 * tig;
#pragma unroll
    for (int nd = 0; nd < NDW; ++nd) {
      *reinterpret_cast<float2*>(out + at + 8 * nd) =
          make_float2(o[nd][2 * i] * inv, o[nd][2 * i + 1] * inv);
      if (out_lo != nullptr)
        *reinterpret_cast<float2*>(out_lo + at + 8 * nd) = make_float2(0.f, 0.f);
    }
    if (lse != nullptr && tig == 0 && col0 == 0)
      lse[((long)b * Hq + h) * Sq + row] = m[i] + logf(lsafe);
  }
}

template <int D, int BC, int ST, int DS>
int fwd_launch(const void* q, const void* k, const void* v, void* out, void* lse, void* out_lo,
               int B, int Sq, int Skv, int Hq, int Hkv, int causal, float scale,
               cudaStream_t st) {
  const size_t bytes = FwdShape<D, BC, ST>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_tf32x3_kernel<D, BC, ST, DS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_tf32x3_kernel<D, BC, ST, DS>
      <<<dim3((Sq + ROWS - 1) / ROWS, Hq, B), 128 * DS, bytes, st>>>(
          static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
          static_cast<float*>(out), static_cast<float*>(lse), static_cast<float*>(out_lo), Sq,
          Skv, Hq, Hkv, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// fp32 at head dims 64, 128 and 256; any other D returns
// cudaErrorInvalidValue. lse and out_lo: both null (K1) or both given (K1').
extern "C" int flash_fwd_tf32x3(const void* q, const void* k, const void* v, void* out, void* lse,
                                void* out_lo, int B, int Sq, int Skv, int Hq, int Hkv, int D,
                                int causal, float scale, void* stream) {
  if (B == 0 || Sq == 0) return (int)cudaSuccess;
  if (int err = check_shape(B, Sq, Skv, Hq, Hkv)) return err;
  if ((lse == nullptr) != (out_lo == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FWD(DIM, BC, ST, DS) \
  fwd_launch<DIM, BC, ST, DS>(q, k, v, out, lse, out_lo, B, Sq, Skv, Hq, Hkv, causal, scale, st)
  if (D == 64) return FWD(64, 64, 1, 1);
  if (D == 128) return FWD(128, 64, 1, 1);
  if (D == 256) return FWD(256, 32, 2, 2);
#undef FWD
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
