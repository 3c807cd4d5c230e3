// The flash-attention backward in fp32 for Hopper (sm_90a), on the tensor
// cores in 3xTF32: K2 computes dQ, K3 computes dK and dV summed over the GQA
// group.
//
// Replaces, in fp32: ray_tpu/ops/attention.py:_flash_bwd_dq_kernel (:182,
// pallas_call at :301) and _flash_bwd_dkv_kernel (:224, pallas_call at :313),
// both launched through _flash_bwd (:280). bf16 is flash_bwd.cu's (wgmma).
// This file takes fp32 at head dims 64, 128 and 256.
//
// What they compute, from the forward's residuals (q, k, v, lse) and the
// output gradient dO, with delta[b, h, i] = sum_d dO * O computed outside:
//   s  = scale * q_i . k_j over the keys j that row i may see (j < Skv, and
//        j <= i + Skv - Sq when causal: bottom-right alignment)
//   p  = exp(s - lse_i)                  (0 where masked)
//   dp = dO_i . v_j
//   ds = p * (dp - delta_i) * scale
//   dq_i = sum_j ds_ij k_j                                  (K2)
//   dv_j = sum_{h in group} sum_i p_ij dO_i                  (K3)
//   dk_j = sum_{h in group} sum_i ds_ij q_i                  (K3)
//
// Precision: 3xTF32. The JAX tests hold fp32 flash at atol = rtol = 2e-5
// (tests/test_ops_attention.py); one TF32 product keeps 10 bits of mantissa
// and misses that. Each operand x is split as hi = tf32(x) and lo = tf32(x -
// hi) (tf32: cvt.rna's rounding), and a product a . b is lo_a hi_b + hi_a
// lo_b + hi_a hi_b, three mma.sync m16n8k8 tf32 with fp32 accumulators; the
// dropped lo . lo and lo's rounding leave about 2^-22 of each product,
// fp32's own rounding. The sums over keys (dQ) and q rows (dK, dV) take each
// 8-row product from a zeroed accumulator and add it in fp32 (mma3_add), as
// do the sums over the head dim (S, dP) at D 256 (32 steps); at D 64 and
// 128 (8 and 16 steps) those stay in the tensor cores' accumulators. On the
// H100, S and dP summed there at D 256 put dK past the tolerance at S 1024,
// and added in fp32 the worst of dQ, dK and dV at 0.39 of it; at D 128 the
// gradients stay within 0.17-0.83 of it up to S 4096 without those adds,
// which would cost 2-22% of the time. exp and the dS arithmetic are fp32
// (expf: no approximate intrinsics).
//
// Bound on the H100: at the c5 fp32 train shape (B 2, S 512, 16 q heads over
// 4, D 128, causal) K2 does 3.2 GFLOP and K3 4.3 (three and four S x S x D
// products over the visible half); 3xTF32 takes three tensor-core products
// each, so at 494.7 TFLOP/s of dense TF32 they are bound by operations,
// 0.020 and 0.026 ms, against 29.5 and 25.3 MB of inputs and outputs
// (0.009 and 0.008 ms at 3.35 TB/s). The design (its primitives, shared
// with the fp32 forward, in tf32x3.cuh):
//
// - mma.sync, not wgmma: wgmma takes tf32 operands only K-major from shared
//   memory, and dQ = dS K, dV = P^T dO and dK = dS^T Q read K, dO and Q along
//   their rows (MN-major), which would need a transposed copy of every tile.
// - Operand tiles sit in shared memory with a row stride of D + 4 floats,
//   filled by cp.async (16 bytes a thread, zeros past a batch's end) in a
//   ring of ST stages. A fragment of S = Q K^T (A rows, B = K rows) reads
//   (row gid, column tig) over the warp's 8 x 4 lanes: bank 4 gid + tig, all
//   32 distinct.
// - The second product of a step takes p or ds straight from the first
//   product's accumulator as its A fragment. An m16n8k8 accumulator holds
//   columns 2 tig and 2 tig + 1 of an 8-wide slice, the tf32 A fragment
//   wants k = tig and tig + 4: the sum over keys (or q rows) does not depend
//   on its order, so the B fragment of the second product reads its rows in
//   the same permuted order, k = tig from row 2 tig and k = tig + 4 from row
//   2 tig + 1 (bank 8 tig + gid, again 32 distinct). Nothing S x S goes to
//   shared memory.
// - K2 (dQ): a block owns 64 q rows, 4 warps of 16; Q and dO stay resident,
//   K and V stream in tiles of BC keys; each thread's two rows of lse and
//   delta sit in registers. Tiles past a causal block's diagonal are not
//   loaded. Grid (q tiles, Hq, B).
// - K3 (dK, dV): a block owns 64 keys, 4 warps of 16 each (DS = 1), or at
//   D 256 8 warps, two on each 16 keys, each pair splitting the head dim of
//   dK and dV (DS = 2: 64 x 256 accumulators of both would not fit 4 warps'
//   registers; each warp of a pair computes the same S^T and dP^T). K and V
//   stay resident; Q, dO, lse and delta of each q tile stream, for each
//   q head of the block's share of the group in head order, from the first
//   q tile that sees the block's keys. Where the grid of (key tiles, Hkv, B)
//   would not fill the card, the wrapper splits the group's q heads over
//   `splits` blocks: each writes its partial dK and dV to an fp32
//   workspace, and a second kernel, launched by the same entry point, sums
//   them in split order.
// - Shared memory: K2 2 x 64 rows of Q and dO plus ST x BC rows of K and V;
//   K3 2 x 64 rows of K and V plus ST x BQ rows of Q and dO (row stride
//   D + 4 floats). D 128: BC = BQ = 32, one stage (99 KB each), so two
//   blocks share an SM: on the H100 that beat a ring of two stages of 64
//   keys (198 KB, one block an SM) by 9% (K2) and 18% (K3) at B8 S2048.
//   D 64: K2 BC = 64, ST = 2 (102 KB), K3 BQ = 32, ST = 2 (69 KB). D 256:
//   BC = BQ = 32, one stage (195 KB): two stages would need 260 KB. K3 takes
//   32 q rows a tile: 64 would take 32 more registers a thread for S^T and
//   dP^T beside the 128 of dK and dV.
// - No atomics: every sum runs in a fixed order, so both kernels are bitwise
//   repeatable.
//
// Layouts as in flash_bwd.cu: q/dO/dq [B, Sq, Hq, D], k/v/dk/dv
// [B, Skv, Hkv, D], lse/delta [B, Hq, Sq], all fp32 and contiguous; the
// workspace [2, splits, B, Skv, Hkv, D] fp32 (dK's partials, then dV's).

#include "tf32x3.cuh"

namespace {

constexpr int ROWS = 64;  // q rows a K2 block owns, keys a K3 block owns
constexpr int RW = 16;    // rows a warp owns: the m16 of the mma

// ---------------------------------------------------------------------------
// K2, dQ: grid (ceil(Sq / 64), Hq, B), 128 threads.
template <int D, int BC, int ST>
struct DqShape {
  static constexpr int LD = D + 4;
  static constexpr size_t BYTES = sizeof(float) * (2 * ROWS + 2 * ST * BC) * LD;
};

template <int D, int BC, int ST>
__global__ void __launch_bounds__(128)
flash_bwd_dq_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           float* __restrict__ dq, int Sq, int Skv, int Hq, int Hkv, int causal,
                           float scale) {
  constexpr int NT = 128, LD = D + 4, NB = BC / 8, ND = D / 8;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // [ROWS][LD]
  float* sO = sQ + ROWS * LD;                   // [ROWS][LD]: dO
  float* sK = sO + ROWS * LD;                   // [ST][BC][LD]
  float* sV = sK + ST * BC * LD;                // [ST][BC][LD]
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (Hq / Hkv);
  const int off = Skv - Sq, q0 = blockIdx.x * ROWS;
  const int warp = threadIdx.x / 32, gid = threadIdx.x % 32 / 4, tig = threadIdx.x % 4;
  const long qs = (long)Hq * D, ks = (long)Hkv * D;
  const float* qb = q + (long)b * Sq * qs + (long)h * D;
  const float* ob = dout + (long)b * Sq * qs + (long)h * D;
  const float* kb = k + (long)b * Skv * ks + (long)hk * D;
  const float* vb = v + (long)b * Skv * ks + (long)hk * D;
  // keys any row of the block sees
  const int kend = causal ? min(Skv, min(q0 + ROWS, Sq) + off) : Skv;
  const int ntiles = kend > 0 ? (kend + BC - 1) / BC : 0;

  load_rows<D, NT>(sQ, qb, qs, q0, ROWS, Sq);
  load_rows<D, NT>(sO, ob, qs, q0, ROWS, Sq);
  cp_commit();
#pragma unroll
  for (int s = 0; s < ST; ++s) {
    if (s < ntiles) {
      load_rows<D, NT>(sK + s * BC * LD, kb, ks, s * BC, BC, Skv);
      load_rows<D, NT>(sV + s * BC * LD, vb, ks, s * BC, BC, Skv);
    }
    cp_commit();
  }
  // this thread's rows: r0 and r0 + 8
  const int r0 = q0 + RW * warp + gid;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    const long at = ((long)b * Hq + h) * Sq + row;
    lse_r[i] = row < Sq ? lse[at] : 0.f;
    delta_r[i] = row < Sq ? delta[at] : 0.f;
  }
  const float* wq = sQ + RW * warp * LD;
  const float* wo = sO + RW * warp * LD;

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int t = 0; t < ntiles; ++t) {
    cp_wait<ST - 1>();
    __syncthreads();  // tile t (and Q, dO) landed for every thread
    const float* tK = sK + (t % ST) * BC * LD;
    const float* tV = sV + (t % ST) * BC * LD;
    const int k0 = t * BC;
    float s[NB][4], dp[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    // S = Q K^T and dP = dO V^T over the head dim
#pragma unroll 2
    for (int kk = 0; kk < ND; ++kk) {
      const AFrag aq = a_rows(wq, LD, 8 * kk, gid, tig);
      const AFrag ao = a_rows(wo, LD, 8 * kk, gid, tig);
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        mma3_to<(D > 128)>(s[n], aq, b_trans(tK, LD, 8 * n, 8 * kk, gid, tig));
        mma3_to<(D > 128)>(dp[n], ao, b_trans(tV, LD, 8 * n, 8 * kk, gid, tig));
      }
    }
    // p, then ds in place of s
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + 8 * (e >> 1), key = k0 + 8 * n + 2 * tig + (e & 1);
        const bool seen = row < Sq && key < Skv && (!causal || key <= row + off);
        const float p = seen ? expf(s[n][e] * scale - lse_r[e >> 1]) : 0.f;
        s[n][e] = p * (dp[n][e] - delta_r[e >> 1]) * scale;
      }
    // dQ += dS K, over the tile's keys in the permuted order
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const AFrag a = a_acc(s[n]);
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
        mma3_add(acc[nd], a, b_perm(tK, LD, 8 * n, 8 * nd, gid, tig));
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
    const int row = r0 + 8 * i;
    if (row >= Sq) continue;
    float* out = dq + ((long)b * Sq + row) * qs + (long)h * D + 2 * tig;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
      *reinterpret_cast<float2*>(out + 8 * nd) = make_float2(acc[nd][2 * i], acc[nd][2 * i + 1]);
  }
}

// ---------------------------------------------------------------------------
// K3, dK and dV: grid (ceil(Skv / 64), Hkv * splits, B), 128 * DS threads.
// Block y = hk * splits + z takes the group's q heads z * group / splits ..
// (z + 1) * group / splits - 1, in order.
template <int D, int BQ, int DS, int ST>
struct DkvShape {
  static constexpr int LD = D + 4;
  static constexpr size_t BYTES = sizeof(float) * ((2 * ROWS + 2 * ST * BQ) * LD + 2 * ST * BQ);
};

template <int D, int BQ, int DS, int ST>
__global__ void __launch_bounds__(128 * DS)
flash_bwd_dkv_tf32x3_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            float* __restrict__ dk, float* __restrict__ dv, int Sq, int Skv,
                            int Hq, int Hkv, int splits, int causal, float scale) {
  constexpr int NT = 128 * DS, LD = D + 4, NQ = BQ / 8, ND = D / 8, DW = D / DS, NDW = DW / 8;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);  // [ROWS][LD]
  float* sV = sK + ROWS * LD;                   // [ROWS][LD]
  float* sQ = sV + ROWS * LD;                   // [ST][BQ][LD]
  float* sO = sQ + ST * BQ * LD;                // [ST][BQ][LD]: dO
  float* sL = sO + ST * BQ * LD;                // [ST][BQ]: lse
  float* sD = sL + ST * BQ;                     // [ST][BQ]: delta
  const int hk = blockIdx.y / splits, z = blockIdx.y % splits, b = blockIdx.z;
  const int group = Hq / Hkv, per = group / splits;
  const int h0 = hk * group + z * per;
  const int off = Skv - Sq, k0 = blockIdx.x * ROWS;
  const int warp = threadIdx.x / 32, gid = threadIdx.x % 32 / 4, tig = threadIdx.x % 4;
  const int kw = warp % 4, col0 = warp / 4 * DW;  // the warp's 16 keys, and its dK/dV columns
  const long qs = (long)Hq * D, ks = (long)Hkv * D;
  // the first q row that sees any key of the block
  const int qstart = causal ? max(0, k0 - off) : 0;
  const int nqt = Sq > qstart ? (Sq - qstart + BQ - 1) / BQ : 0;
  const int ntiles = per * nqt;

  load_rows<D, NT>(sK, k + (long)b * Skv * ks + (long)hk * D, ks, k0, ROWS, Skv);
  load_rows<D, NT>(sV, v + (long)b * Skv * ks + (long)hk * D, ks, k0, ROWS, Skv);
  cp_commit();
  // tile t: q head h0 + t / nqt, rows qstart + (t % nqt) BQ ..
  auto load_tile = [&](int t, int stage) {
    const int h = h0 + t / nqt, qt0 = qstart + t % nqt * BQ;
    load_rows<D, NT>(sQ + stage * BQ * LD, q + (long)b * Sq * qs + (long)h * D, qs, qt0, BQ, Sq);
    load_rows<D, NT>(sO + stage * BQ * LD, dout + (long)b * Sq * qs + (long)h * D, qs, qt0, BQ,
                     Sq);
    load_vec<NT>(sL + stage * BQ, lse + ((long)b * Hq + h) * Sq, qt0, BQ, Sq);
    load_vec<NT>(sD + stage * BQ, delta + ((long)b * Hq + h) * Sq, qt0, BQ, Sq);
  };
#pragma unroll
  for (int s = 0; s < ST; ++s) {
    if (s < ntiles) load_tile(s, s);
    cp_commit();
  }
  const int kr0 = k0 + RW * kw + gid;  // this thread's keys: kr0 and kr0 + 8
  const float* wk = sK + RW * kw * LD;
  const float* wv = sV + RW * kw * LD;

  float gk[NDW][4], gv[NDW][4];
#pragma unroll
  for (int n = 0; n < NDW; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) gk[n][e] = gv[n][e] = 0.f;
  for (int t = 0; t < ntiles; ++t) {
    cp_wait<ST - 1>();
    __syncthreads();  // tile t (and K, V) landed for every thread
    const int stage = t % ST;
    const float* tQ = sQ + stage * BQ * LD;
    const float* tO = sO + stage * BQ * LD;
    const float* tL = sL + stage * BQ;
    const float* tD = sD + stage * BQ;
    const int qt0 = qstart + t % nqt * BQ;
    float st[NQ][4], dpt[NQ][4];  // S^T and dP^T: the warp's 16 keys x BQ q rows
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < ND; ++kk) {
      const AFrag ak = a_rows(wk, LD, 8 * kk, gid, tig);
      const AFrag av = a_rows(wv, LD, 8 * kk, gid, tig);
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        mma3_to<(D > 128)>(st[n], ak, b_trans(tQ, LD, 8 * n, 8 * kk, gid, tig));
        mma3_to<(D > 128)>(dpt[n], av, b_trans(tO, LD, 8 * n, 8 * kk, gid, tig));
      }
    }
    // p^T in place of s^T, ds^T in place of dp^T
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * n + 2 * tig + (e & 1);
        const int key = kr0 + 8 * (e >> 1), qi = qt0 + c;
        const bool seen = key < Skv && qi < Sq && (!causal || key <= qi + off);
        const float p = seen ? expf(st[n][e] * scale - tL[c]) : 0.f;
        dpt[n][e] = p * (dpt[n][e] - tD[c]) * scale;
        st[n][e] = p;
      }
    // dV += P^T dO and dK += dS^T Q over the tile's q rows in the permuted
    // order, on the warp's DW columns
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      const AFrag ap = a_acc(st[n]);
      const AFrag ad = a_acc(dpt[n]);
#pragma unroll
      for (int nd = 0; nd < NDW; ++nd) {
        mma3_add(gv[nd], ap, b_perm(tO, LD, 8 * n, col0 + 8 * nd, gid, tig));
        mma3_add(gk[nd], ad, b_perm(tQ, LD, 8 * n, col0 + 8 * nd, gid, tig));
      }
    }
    __syncthreads();  // every warp is done with the stage
    if (t + ST < ntiles) load_tile(t + ST, stage);
    cp_commit();
  }
  // splits == 1: dk, dv; else this split's slice of the workspace (dk and dv
  // point at its dK and dV halves)
  const long slice = splits > 1 ? (long)z * gridDim.z * Skv * ks : 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = kr0 + 8 * i;
    if (row >= Skv) continue;
    const long at = slice + ((long)b * Skv + row) * ks + (long)hk * D + col0 + 2 * tig;
#pragma unroll
    for (int nd = 0; nd < NDW; ++nd) {
      *reinterpret_cast<float2*>(dk + at + 8 * nd) = make_float2(gk[nd][2 * i], gk[nd][2 * i + 1]);
      *reinterpret_cast<float2*>(dv + at + 8 * nd) = make_float2(gv[nd][2 * i], gv[nd][2 * i + 1]);
    }
  }
}

// dk = sum over z of ws[0, z], dv = sum over z of ws[1, z], in split order;
// n4 float4s in each of dk and dv.
__global__ void __launch_bounds__(256)
flash_bwd_dkv_merge_kernel(const float4* __restrict__ ws, float4* __restrict__ dk,
                           float4* __restrict__ dv, long n4, int splits) {
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < 2 * n4;
       i += (long)gridDim.x * blockDim.x) {
    const bool is_v = i >= n4;
    const long j = is_v ? i - n4 : i;
    const float4* src = ws + (is_v ? (long)splits * n4 : 0) + j;
    float4 s = src[0];
    for (int z = 1; z < splits; ++z) {
      const float4 x = src[z * n4];
      s.x += x.x;
      s.y += x.y;
      s.z += x.z;
      s.w += x.w;
    }
    (is_v ? dv : dk)[j] = s;
  }
}

// ---------------------------------------------------------------------------
// Launchers
template <int D, int BC, int ST>
int dq_launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, int B, int Sq, int Skv, int Hq, int Hkv, int causal,
              float scale, cudaStream_t st) {
  const size_t bytes = DqShape<D, BC, ST>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_tf32x3_kernel<D, BC, ST>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_tf32x3_kernel<D, BC, ST><<<dim3((Sq + ROWS - 1) / ROWS, Hq, B), 128, bytes, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq), Sq, Skv, Hq, Hkv, causal, scale);
  return (int)cudaGetLastError();
}

template <int D, int BQ, int DS, int ST>
int dkv_launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, void* ws, int B, int Sq, int Skv, int Hq,
               int Hkv, int causal, float scale, int splits, cudaStream_t st) {
  const size_t bytes = DkvShape<D, BQ, DS, ST>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_tf32x3_kernel<D, BQ, DS, ST>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const long n = (long)B * Skv * Hkv * D;  // floats in each of dk and dv
  float* part_k = splits > 1 ? static_cast<float*>(ws) : static_cast<float*>(dk);
  float* part_v = splits > 1 ? static_cast<float*>(ws) + splits * n : static_cast<float*>(dv);
  flash_bwd_dkv_tf32x3_kernel<D, BQ, DS, ST>
      <<<dim3((Skv + ROWS - 1) / ROWS, Hkv * splits, B), 128 * DS, bytes, st>>>(
          static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
          static_cast<const float*>(dout), static_cast<const float*>(lse),
          static_cast<const float*>(delta), part_k, part_v, Sq, Skv, Hq, Hkv, splits, causal,
          scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long n4 = n / 4, want = (2 * n4 + 255) / 256;
  const int blocks = (int)(want < 4096 ? want : 4096);  // a grid-stride loop past that
  flash_bwd_dkv_merge_kernel<<<blocks, 256, 0, st>>>(static_cast<const float4*>(ws),
                                                      static_cast<float4*>(dk),
                                                      static_cast<float4*>(dv), n4, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// fp32 at head dims 64, 128 and 256; any other D returns cudaErrorInvalidValue.
extern "C" int flash_bwd_dq_tf32x3(const void* q, const void* k, const void* v, const void* dout,
                                   const void* lse, const void* delta, void* dq, int B, int Sq,
                                   int Skv, int Hq, int Hkv, int D, int causal, float scale,
                                   void* stream) {
  if (B == 0 || Sq == 0) return (int)cudaSuccess;
  if (int err = check_shape(B, Sq, Skv, Hq, Hkv)) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DQ(DIM, BC, ST) \
  dq_launch<DIM, BC, ST>(q, k, v, dout, lse, delta, dq, B, Sq, Skv, Hq, Hkv, causal, scale, st)
  if (D == 64) return DQ(64, 64, 2);
  if (D == 128) return DQ(128, 32, 1);
  if (D == 256) return DQ(256, 32, 1);
#undef DQ
  return (int)cudaErrorInvalidValue;
}

// splits: blocks along the GQA group (a divisor of Hq / Hkv); above 1, ws is
// the [2, splits, B, Skv, Hkv, D] fp32 workspace.
extern "C" int flash_bwd_dkv_tf32x3(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dk, void* dv, void* ws, int B, int Sq, int Skv, int Hq,
                                    int Hkv, int D, int causal, float scale, int splits,
                                    void* stream) {
  if (B == 0) return (int)cudaSuccess;
  if (int err = check_shape(B, Sq, Skv, Hq, Hkv)) return err;
  if (splits <= 0 || (Hq / Hkv) % splits != 0 || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DKV(DIM, BQ, DS, ST)                                                                 \
  dkv_launch<DIM, BQ, DS, ST>(q, k, v, dout, lse, delta, dk, dv, ws, B, Sq, Skv, Hq, Hkv, \
                              causal, scale, splits, st)
  if (D == 64) return DKV(64, 32, 1, 2);
  if (D == 128) return DKV(128, 32, 1, 1);
  if (D == 256) return DKV(256, 32, 2, 1);
#undef DKV
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
