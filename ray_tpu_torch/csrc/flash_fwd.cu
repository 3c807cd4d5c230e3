// Causal / non-causal GQA flash-attention forward for Hopper (sm_90a), bf16.
//
// Replaces: ray_tpu/ops/attention.py:_flash_fwd_kernel, launched through
// _flash_fwd -> pl.pallas_call: with_lse=False on the serving path (K1),
// with_lse=True on the training path (K1').
//
// What it computes: out[b, i, h, :] = softmax(scale * q_i . K^T) V over the keys
// j that row i may see (j < Skv, and j <= i + Skv - Sq when causal: the queries
// sit after the cached keys, bottom-right alignment), with q head h reading kv
// head h / (Hq / Hkv). Optionally lse[b, h, i] = m + log(l) (fp32, natural
// log) and out_lo = o - bf16(o) (bf16, out's layout), where o is the output
// before its rounding to bf16: the residuals the training backward needs.
// Its delta = rowsum(dO * O) must match the sum over keys of p * dP that its
// own p and dP carry; from the bf16 output alone it misses by the rounding
// of O, which with keys that share a large common part (ViT's patches) moved
// dQ and dK by several percent. The serving path passes null pointers.
//
// Bound on the H100: with causal masking and 4 q heads per kv head it does about
// S * 0.4 flops per byte moved (~205 at S 512), under the card's ~295 bf16
// flops per byte of HBM, so at the prefill buckets (S 64..512) its bound is
// bytes, with operations close behind; at the training length (S 2048) it is
// bound by the tensor cores. The design keeps the S x S scores out of device
// memory (online softmax with fp32 running max m and normaliser l) and keeps
// every operand path off the threads that do the math:
//
// - One block per (b, q head, 128-row q tile), 384 threads: warpgroup 0 only
//   issues TMA loads (setmaxnreg down to 24 registers), warpgroups 1 and 2
//   each own 64 query rows, one wgmma M tile (setmaxnreg up to 240).
// - Q is loaded once; K and V tiles of 128 keys stream through a ring of
//   STAGES slots in shared memory, each slot's K and V completing on their own
//   mbarrier and released through a third one when both consumers are done.
//   The tensor maps are 4-D over [B, S, H, D], so rows past a batch's end read
//   as zero and the ragged edge costs no code. 128-byte swizzle: a row of D
//   bf16 is D / 64 slabs of 128 bytes, one TMA box each, the layout the wgmma
//   descriptors below read.
// - S = Q.K^T by wgmma, both operands from shared memory (K as a K-major B),
//   the fp32 scores in registers. Each row of the accumulator lies in the 4
//   threads of a quad, so the online softmax takes two shuffles per row
//   reduction, for all 64 rows at once; m and l stay in registers. Only the
//   tiles that cross the diagonal or the ragged end are masked; tiles past
//   the causal limit are never loaded.
// - O += P.V by wgmma with P as the register A operand: the fp32 score
//   accumulator packs pairwise into bf16 A fragments in place. V is read as
//   an MN-major B (the transpose bit). O stays in registers for the whole
//   loop; the rescale by exp(m_old - m_new) is a multiply on registers.
// - Epilogue: O / l in bf16 is staged through the warpgroup's own rows of the
//   Q tile (swizzled, conflict-free) and written by a TMA store, which clips
//   the rows past Sq; lse is written from registers; out_lo goes through
//   the same rows after the output's store has read them.
// - Launch order: the q heads of one kv head are neighbours (their K/V reads
//   meet in L2) and the widest causal q tiles go first.
// Not done: a persistent grid, softmax overlapped with the next product, and
// ping-pong scheduling of the two consumer warpgroups.
//
// Layout: q [B, Sq, Hq, D], k/v [B, Skv, Hkv, D], out and out_lo [B, Sq, Hq,
// D], all contiguous bf16 and 16-byte aligned; lse [B, Hq, Sq] fp32. D 64 or
// 128.
// Grid (Hq, B, ceil(Sq / 128)).

#include "sm90.cuh"

namespace {

constexpr int BQ = 128;         // query rows per block: two consumer warpgroups of 64
constexpr int BK = 128;         // keys per K/V tile
constexpr int STAGES = 2;       // K/V ring depth
constexpr int NTHREADS = 384;   // warpgroup 0 loads, warpgroups 1 and 2 compute
constexpr float LN2 = 0.6931471805599453f;

// Shared-memory plan; every tile starts on a 1024-byte boundary (the period of
// the 128-byte swizzle). A tile of R rows is D / 64 slabs of R x 128 bytes.
template <int D>
struct Smem {
  static constexpr int SLABS = D / 64;
  static constexpr uint32_t q_bytes = BQ * D * 2;
  static constexpr uint32_t kv_bytes = BK * D * 2;
  static constexpr uint32_t k_off = q_bytes;
  static constexpr uint32_t v_off = k_off + STAGES * kv_bytes;
  static constexpr uint32_t bar_off = v_off + STAGES * kv_bytes;
  // barriers: Q, then full_k, full_v and empty for each slot
  static constexpr uint32_t bytes = bar_off + 8 * (1 + 3 * STAGES) + 1024;  // + alignment slack
};

// The accumulator layout the softmax reads is set out in sm90.cuh.
template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o,
                 const __grid_constant__ CUtensorMap tm_olo, float* __restrict__ lse, int Sq,
                 int Skv, int Hq, int Hkv, int causal, float scale) {
  using SM = Smem<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t sQ = base;
  const uint32_t bar_q = base + SM::bar_off;
  const uint32_t bar_full_k = bar_q + 8;                // + 8 s
  const uint32_t bar_full_v = bar_full_k + 8 * STAGES;  // + 8 s
  const uint32_t bar_empty = bar_full_v + 8 * STAGES;   // + 8 s

  const int h = blockIdx.x;  // the q heads of one kv head are neighbours in launch order
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // the widest causal q tiles first
  const int hk = h / (Hq / Hkv);
  const int offset = Skv - Sq;  // query row i sits at absolute position offset + i
  // Block-level causal skip: no row of this tile sees a key at or past kv_end.
  const int kv_end = causal ? min(Skv, q0 + BQ + offset) : Skv;
  const int n_tiles = (kv_end + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full_k + 8 * s, 1);
      mbar_init(bar_full_v + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 2 * 128);  // every consumer thread releases the slot
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread issues every load --------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, SM::q_bytes);
#pragma unroll
      for (int c = 0; c < SM::SLABS; ++c)
        tma_load(sQ + c * BQ * ROW, &tm_q, bar_q, 64 * c, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(bar_empty + 8 * s, ((j / STAGES) - 1) & 1);
        const uint32_t sK = base + SM::k_off + s * SM::kv_bytes;
        const uint32_t sV = base + SM::v_off + s * SM::kv_bytes;
        mbar_expect_tx(bar_full_k + 8 * s, SM::kv_bytes);
#pragma unroll
        for (int c = 0; c < SM::SLABS; ++c)
          tma_load(sK + c * BK * ROW, &tm_k, bar_full_k + 8 * s, 64 * c, hk, j * BK, b);
        mbar_expect_tx(bar_full_v + 8 * s, SM::kv_bytes);
#pragma unroll
        for (int c = 0; c < SM::SLABS; ++c)
          tma_load(sV + c * BK * ROW, &tm_v, bar_full_v + 8 * s, 64 * c, hk, j * BK, b);
      }
    }
  } else {
    // ---- consumers: warpgroup w owns query rows q0 + 64 w .. + 63 --------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int w = wg - 1;
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int row0 = 16 * (t / 32) + lane / 4;  // this thread's rows: row0 and row0 + 8
    const int qw0 = q0 + 64 * w;
    const int lim0 = qw0 + row0 + offset;       // the last key each row may see (causal)
    const int lim1 = lim0 + 8;
    const float sl2 = scale * LOG2E;            // scale after the dot, in fp32; exp2 domain

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // running max of scale * log2(e) * q.k
    float l[2] = {0.f, 0.f};              // this thread's part of the running sum

    mbar_wait(bar_q, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % STAGES;
      const uint32_t parity = (j / STAGES) & 1;
      const uint32_t sK = base + SM::k_off + s * SM::kv_bytes;
      const uint32_t sV = base + SM::v_off + s * SM::kv_bytes;
      const int k0 = j * BK;

      // S = Q . K^T: D / 16 products of depth 16, 32 bytes along each slab row
      float sc[BK / 2];
      mbar_wait(bar_full_k + 8 * s, parity);
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t step = (kk % 4) * 32u;  // 16 bf16 into the slab row
        const uint64_t da = smem_desc(sQ + (kk / 4) * BQ * ROW + 64 * w * ROW + step, 16, 1024);
        const uint64_t db = smem_desc(sK + (kk / 4) * BK * ROW + step, 16, 1024);
        wgmma_ss_n128(sc, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // Mask only the tiles that cross the causal diagonal or the ragged end.
      if (k0 + BK > Skv || (causal && k0 + BK - 1 > qw0 + offset)) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int key = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
          if (key >= Skv || (causal && key > ((i & 2) ? lim1 : lim0))) sc[i] = -INFINITY;
        }
      }

      // Online softmax on registers: row max and sum over the quad.
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      float alpha[2], mb[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * sl2);
        mb[r] = m_new == -INFINITY ? 0.f : m_new;  // a row with nothing visible yet
        alpha[r] = exp2_approx(m[r] - mb[r]);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int r = (i >> 1) & 1;
        sc[i] = exp2_approx(fmaf(sc[i], sl2, -mb[r]));
        l[r] += sc[i];
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

      // P in bf16 as wgmma A fragments: k step kt takes score columns
      // 16 kt .. 16 kt + 15, i.e. accumulator elements 8 kt .. 8 kt + 7.
      uint32_t p[BK / 16][4];
#pragma unroll
      for (int kt = 0; kt < BK / 16; ++kt)
#pragma unroll
        for (int x = 0; x < 4; ++x) p[kt][x] = pack_bf16(sc[8 * kt + 2 * x], sc[8 * kt + 2 * x + 1]);

      // O += P . V: V [keys, D] is the MN-major B operand, 16 keys per step
      mbar_wait(bar_full_v + 8 * s, parity);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kt = 0; kt < BK / 16; ++kt)
        wgmma_rs<D>(o, p[kt], smem_desc(sV + kt * 16 * ROW, BK * ROW, 1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      mbar_arrive(bar_empty + 8 * s);
    }

    // ---- epilogue ---------------------------------------------------------
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
    }
    // Stage O in this warpgroup's own rows of the Q tile (their only reader,
    // this warpgroup's products, has finished), in the swizzled slab layout
    // the output tensor map stores from.
    stage_bf16<D>(smem, BQ * ROW, 64 * w, o, inv);
    warpgroup_sync_for_tma(w);
    if (t == 0) {
#pragma unroll
      for (int c = 0; c < SM::SLABS; ++c)
        tma_store(&tm_o, sQ + c * BQ * ROW + 64 * w * ROW, 64 * c, h, qw0, b);
      tma_store_wait();
    }
    if (lse == nullptr) return;
    // The training forward: out_lo through the same rows, once the output's
    // store has read them.
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
    stage_bf16<D, true>(smem, BQ * ROW, 64 * w, o, inv);
    warpgroup_sync_for_tma(w);
    if (t == 0) {
#pragma unroll
      for (int c = 0; c < SM::SLABS; ++c)
        tma_store(&tm_olo, sQ + c * BQ * ROW + 64 * w * ROW, 64 * c, h, qw0, b);
      tma_store_wait();
    }
    if (lane % 4 == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = qw0 + row0 + 8 * r;
        if (row < Sq) lse[((long)b * Hq + h) * Sq + row] = m[r] * LN2 + logf(l[r]);
      }
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse, void* out_lo, int B,
           int Sq, int Skv, int Hq, int Hkv, int causal, float scale, cudaStream_t stream) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tm_q, tm_k, tm_v, tm_o, tm_olo;
  if (!make_map(encode, &tm_q, q, B, Sq, Hq, D, BQ) ||
      !make_map(encode, &tm_k, k, B, Skv, Hkv, D, BK) ||
      !make_map(encode, &tm_v, v, B, Skv, Hkv, D, BK) ||
      !make_map(encode, &tm_o, out, B, Sq, Hq, D, 64) ||
      !make_map(encode, &tm_olo, lse != nullptr ? out_lo : out, B, Sq, Hq, D, 64))
    return (int)cudaErrorInvalidValue;
  auto kern = flash_fwd_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Smem<D>::bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Hq, B, (Sq + BQ - 1) / BQ);
  kern<<<grid, NTHREADS, Smem<D>::bytes, stream>>>(tm_q, tm_k, tm_v, tm_o, tm_olo,
                                                   static_cast<float*>(lse), Sq, Skv, Hq, Hkv,
                                                   causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// lse and out_lo: both null (serving) or both set (training).
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v, void* out, void* lse,
                              void* out_lo, int B, int Sq, int Skv, int Hq, int Hkv, int D,
                              int causal, float scale, void* stream) {
  if (B <= 0 || Sq <= 0) return (int)cudaSuccess;
  if (Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  if ((lse == nullptr) != (out_lo == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch<128>(q, k, v, out, lse, out_lo, B, Sq, Skv, Hq, Hkv, causal, scale, st);
  if (D == 64)
    return launch<64>(q, k, v, out, lse, out_lo, B, Sq, Skv, Hq, Hkv, causal, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
