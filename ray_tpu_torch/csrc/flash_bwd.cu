// Causal / non-causal GQA flash-attention backward for Hopper (sm_90a), bf16:
// K2 computes dQ, K3 computes dK and dV.
//
// Replaces: ray_tpu/ops/attention.py:_flash_bwd_dq_kernel (K2) and
// _flash_bwd_dkv_kernel (K3), both launched through _flash_bwd -> pl.pallas_call.
//
// What they compute, from the forward's residuals (q, k, v, lse) and the
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
// Bound on the H100: at llama_1b's training shape (B 8, S 2048, 16 q heads
// over 4 kv heads, D 128, causal) each S x S x D product over the visible
// half is 68.7 GFLOP; K2 does 3 of them (s, dp, dq) and K3 does 4 (s, dp, dv,
// dk), so 0.21 and 0.28 ms at 989 TFLOP/s, against 0.24 GB and 0.20 GB of
// inputs and outputs (0.07 and 0.06 ms at 3.35 TB/s): both are bound by the
// tensor cores. At ViT-L's (B 32, S 196, 16 heads over 16, D 64, not causal)
// a product is 2.5 GFLOP and both are bound by bytes (65 and 78 MB, about
// 0.02 ms each): short rows, one q head per kv head. One design serves both
// (flash_fwd.cu's: a TMA ring, wgmma, every S x S intermediate in
// registers), an instance per head dim, with the primitives of sm90.cuh:
//
// - 256 threads: two consumer warpgroups (wgmma needs whole, aligned
//   warpgroups), each owning 64 rows of the block's 128-row tile, and no
//   producer warp. Registers decide that: a warpgroup keeps its 64 x D fp32
//   accumulators for the whole loop (K2 dQ, K3 dK and dV) beside a step's
//   fp32 S and dP (K2: 64 x 128 each; K3's transposes: 64 x 64 each). At D
//   128 that is 192 accumulator registers a thread, about 230 in all; at D
//   64, 160 (K2) and 128 (K3). ptxas (nvcc 12.9,
//   sm_90a) gives these kernels 168 at __launch_bounds__(288, 1) as at
//   (384, 1), as if the block were rounded up to whole warpgroups, and
//   allocates the consumer code at 168 whatever setmaxnreg grants (it emits
//   the instruction, but the consumer spills), so a producer warp or
//   warpgroup costs 60 registers of every thread. At 256 threads each may
//   have 255; ptxas gives K2 221 (D 128) and 189 (D 64), K3 227 (D 128 at
//   group 4), 226 (D 128) and 163 (D 64), none spilling, so even at D 64 one
//   block fills an SM's register file.
//   Thread 0
//   is the producer as well as a consumer: it issues the block's resident
//   tiles and the first STAGES slots, and refills each slot once both
//   warpgroups have released it, STAGES - 1 slots ahead of the math.
// - Operands stream through an mbarrier-guarded ring of STAGES slots filled
//   by TMA over 4-D tensor maps of [B, S, H, D] with 128-byte swizzle; every
//   mbarrier wait traps after a bounded number of polls, so a lost arrival
//   fails the launch instead of hanging the card.
// - Every product is a wgmma; the first two of a step (S and dP, or their
//   transposes) take both operands from shared memory, and the one or two
//   that follow take p or ds as the register A operand, packed pairwise to
//   bf16 in place from the fp32 accumulator. No S x S tile ever goes to
//   shared memory. p = exp2(s * scale * log2 e - lse * log2 e) on the
//   special-function unit.
// - TMA zero-fills rows past a batch's end, which makes s = 0, not a masked
//   score, so rows past Sq (K3) and keys past Skv (K2) are masked explicitly
//   on the tiles that reach them.
// - The epilogue stages the bf16 result in the warpgroup's own rows of a tile
//   it no longer reads and writes it by TMA store, which clips rows past the
//   end.
//
// K2 (dQ): one block per (b, q head, 128-row q tile); grid (Hq, B, q tiles),
// so the q heads of one kv head are neighbours in launch order (their K/V
// reads meet in L2), and the widest causal q tiles go first. Q and dO are
// loaded once, and each thread's two rows of lse and delta read into
// registers; K and V tiles of 128 keys go through the ring, each slot with
// its own K and V barriers. dQ += dS . K reads K as an MN-major B.
//
// K3 (dK/dV): one block per (b, kv head, 128-key tile); grid (Hkv, B, key
// tiles), so the widest causal key tiles of every (b, kv head) go first and
// the last wave holds the narrowest. K and V are loaded once. The ring
// streams, for each of the group's q heads and each 64-row q tile from the
// first one that sees the block's keys, the Q and dO tiles and that tile's
// lse and delta rows, the last two by 1-D TMA boxes that start at the
// 16-byte boundary at or before the tile's first row (a row of ragged Sq
// starts anywhere; a box that runs past the head's last row reads the next
// head's rows, or zeros past the array's end, which the mask below
// discards). S^T = K . Q^T and dP^T = V . dO^T put keys on the
// accumulator's rows and queries on its columns, so each thread reads the
// lse and delta of its 16 columns from the slot. dV += P^T . dO and dK +=
// dS^T . Q read dO and Q as MN-major B. The GQA sum over the group happens in
// these registers: no atomics, a fixed order, bitwise-repeatable.
//
// D 256 has a kernel of its own for each (flash_bwd_dq_d256_kernel,
// flash_bwd_dkv_d256_kernel): the plan above needs 384 KB of shared memory
// for K2 (128 resident rows of Q and dO, two slots of 128-key K and V
// tiles) and 256 accumulator registers a thread for K3 (dK and dV of 64
// keys at D 256 over one warpgroup), against 227 KB and 255.
// - K2 keeps the 128-row block, its warpgroups and its resident Q and dO
//   (128 KB), and streams 64-key tiles through a ring of three 32 KB
//   buffers in which K and V are loads of their own, each released on its
//   own: the order is V_0, K_0, V_1, K_1, ..., V_j is released once dP =
//   dO . V^T is done and K_j once dQ += dS . K is, and thread 0 refills
//   V_j's buffer with K_(j+1) while dS . K runs and K_j's with V_(j+2) at
//   the tile's end (224 KB in all). S and dP are 64 x 64 per warpgroup (32
//   registers each) beside dQ's 128; ptxas (sm_90a) gives 246
//   registers, no spill. S is committed before dP, and p = exp(s - lse) is
//   computed while dP runs (wgmma_wait<1>): 1-2% faster at B8 S2048 than
//   waiting for both (PERF.md, the D256 backward's section).
// - K3 takes 64 keys a block, shared by both warpgroups: K and V resident
//   (64 KB), a ring of two slots of 64-row Q and dO tiles (128 KB; 195 KB
//   in all). Warpgroup w owns columns 128 w .. + 127 of dK and dV (128
//   registers). Both warpgroups compute the q tile's S^T = K . Q^T and
//   dP^T = V . dO^T over the whole head dim, form p^T and dS^T, and run
//   dV += P^T . dO and dK += dS^T . Q on their own two slabs of dO and Q:
//   six products where four are needed, and no traffic between the
//   warpgroups. p^T is computed while dP^T runs, as in K2 (1-3% faster).
//   225 registers, no spill. Tried first, in the same
//   attention_times.py call on the H100 (B8 S2048, 8 q heads over 2,
//   causal; PERF.md): warpgroup 0 computing S^T and p^T, warpgroup 1
//   dP^T, the two fp32 tiles crossing through 32 KB of shared memory
//   between two named barriers, four products (229 registers, no spill):
//   1.026-1.030 ms against these 0.710-0.716. The barriers hold each
//   warpgroup's exponentials and packing off the other's products, which
//   the duplicate products do not cost. Not built: separate dV and dK
//   kernels (five products, two launches).
//
// Not done: a persistent grid, overlap of one tile's exponentials with
// another tile's products inside a warpgroup, and ping-pong scheduling.
//
// Layout: q/dO/dq [B, Sq, Hq, D], k/v/dk/dv [B, Skv, Hkv, D], all contiguous
// bf16 and 16-byte aligned; lse and delta [B, Hq, Sq] fp32, contiguous and
// 16-byte aligned. D 64 or 128 (a template instance each) or 256 (the
// kernels above), any group Hq / Hkv (a run-time value: K2's kv head, K3's
// walk over the group's q heads; K3 also has llama_1b's D 128 at group 4 as
// an instance of its own); anything else is refused.

#include "sm90.cuh"

namespace {

constexpr int STAGES = 2;       // ring depth
constexpr int NTHREADS = 256;   // two consumer warpgroups; thread 0 also issues the loads

// Bytes of a tile of `rows` rows of head dim D (D / 64 slabs of rows x 128 bytes).
template <int D>
__host__ __device__ constexpr uint32_t tile_bytes(int rows) { return rows * D * 2; }

// ---------------------------------------------------------------- K2: dQ ---
namespace k2 {
constexpr int BQ = 128;  // query rows per block
constexpr int BK = 128;  // keys per K/V tile
// Shared-memory plan; every tile starts on a 1024-byte boundary.
template <int D>
struct Smem {
  static constexpr uint32_t q_off = 0;
  static constexpr uint32_t do_off = q_off + tile_bytes<D>(BQ);
  static constexpr uint32_t k_off = do_off + tile_bytes<D>(BQ);
  static constexpr uint32_t v_off = k_off + STAGES * tile_bytes<D>(BK);
  static constexpr uint32_t bar_off = v_off + STAGES * tile_bytes<D>(BK);
  // barriers: Q and dO, then full_k, full_v and empty for each slot
  static constexpr uint32_t bytes = bar_off + 8 * (1 + 3 * STAGES) + 1024;  // + alignment slack
};
}  // namespace k2

// Fill K2's ring slot s with the K and V tiles of keys k0 .. k0 + BK - 1, each
// on its own barrier, so S = Q.K^T can start before V has landed.
template <int D>
__device__ __forceinline__ void k2_load_kv(uint32_t base, int s, const CUtensorMap* tm_k,
                                           const CUtensorMap* tm_v, int hk, int k0, int b) {
  using namespace k2;
  using SM = Smem<D>;
  const uint32_t bar_full_k = base + SM::bar_off + 8 + 8 * s;
  const uint32_t bar_full_v = base + SM::bar_off + 8 + 8 * STAGES + 8 * s;
  const uint32_t sK = base + SM::k_off + s * tile_bytes<D>(BK);
  const uint32_t sV = base + SM::v_off + s * tile_bytes<D>(BK);
  mbar_expect_tx(bar_full_k, tile_bytes<D>(BK));
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
    tma_load(sK + c * BK * ROW, tm_k, bar_full_k, 64 * c, hk, k0, b);
  mbar_expect_tx(bar_full_v, tile_bytes<D>(BK));
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
    tma_load(sV + c * BK * ROW, tm_v, bar_full_v, 64 * c, hk, k0, b);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_dq, const float* __restrict__ lse,
                    const float* __restrict__ delta, int Sq, int Skv, int Hq, int group,
                    int causal, float scale) {
  using namespace k2;
  using SM = Smem<D>;
  constexpr int SLABS = D / 64;  // 64-column slabs per tile row
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t sQ = base + SM::q_off;
  const uint32_t sDO = base + SM::do_off;
  const uint32_t bar_q = base + SM::bar_off;
  const uint32_t bar_full_k = bar_q + 8;                // + 8 s
  const uint32_t bar_full_v = bar_full_k + 8 * STAGES;  // + 8 s
  const uint32_t bar_empty = bar_full_v + 8 * STAGES;   // + 8 s

  const int h = blockIdx.x;  // the q heads of one kv head are neighbours in launch order
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // the widest causal q tiles first
  const int hk = h / group;
  const int offset = Skv - Sq;  // query row i sits at absolute position offset + i
  // Block-level causal skip: no row of this tile sees a key at or past kv_end.
  const int kv_end = causal ? min(Skv, q0 + BQ + offset) : Skv;
  const int n_tiles = (kv_end + BK - 1) / BK;

  // Thread 0 is the producer as well as a consumer: it issues Q, dO and the
  // first STAGES K/V slots here, and each later slot once every consumer has
  // released it (below).
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full_k + 8 * s, 1);
      mbar_init(bar_full_v + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, NTHREADS);  // every consumer thread releases the slot
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar_q, 2 * tile_bytes<D>(BQ));
#pragma unroll
    for (int c = 0; c < SLABS; ++c) {
      tma_load(sQ + c * BQ * ROW, &tm_q, bar_q, 64 * c, h, q0, b);
      tma_load(sDO + c * BQ * ROW, &tm_do, bar_q, 64 * c, h, q0, b);
    }
    for (int j = 0; j < min(STAGES, n_tiles); ++j)
      k2_load_kv<D>(base, j, &tm_k, &tm_v, hk, j * BK, b);
  }
  __syncthreads();

  // ---- warpgroup w owns query rows q0 + 64 w .. + 63 --------------------
  const int w = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int lane = threadIdx.x % 32;
  const int row0 = 16 * (t / 32) + lane / 4;  // this thread's rows: row0 and row0 + 8
  const int qw0 = q0 + 64 * w;
  const int lim0 = qw0 + row0 + offset;       // the last key each row may see (causal)
  const int lim1 = lim0 + 8;
  const float sl2 = scale * LOG2E;            // scale after the dot, in fp32; exp2 domain
  // Tiles past the last key any of this warpgroup's rows sees, and every tile
  // of a warpgroup whose rows all lie past Sq, are released unread.
  const bool active = qw0 < Sq;
  const int wg_tiles = causal ? (min(Skv, qw0 + 64 + offset) + BK - 1) / BK : n_tiles;

  // This thread's two rows' lse (exp2 domain) and delta; 0 past Sq.
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qw0 + row0 + 8 * r;
    const long at = ((long)b * Hq + h) * Sq + row;
    lse2[r] = row < Sq ? lse[at] * LOG2E : 0.f;
    dlt[r] = row < Sq ? delta[at] : 0.f;
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(bar_q, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES;
    const uint32_t parity = (j / STAGES) & 1;
    const uint32_t sK = base + SM::k_off + s * tile_bytes<D>(BK);
    const uint32_t sV = base + SM::v_off + s * tile_bytes<D>(BK);
    const int k0 = j * BK;
    mbar_wait(bar_full_k + 8 * s, parity);
    if (active && j < wg_tiles) {
      // S = Q . K^T and dP = dO . V^T: D / 16 products of depth 16 each
      float sc[BK / 2], dp[BK / 2];
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t step = (kk % 4) * 32u;  // 16 bf16 into the slab row
        wgmma_ss_n128(sc, smem_desc(sQ + (kk / 4) * BQ * ROW + 64 * w * ROW + step, 16, 1024),
                     smem_desc(sK + (kk / 4) * BK * ROW + step, 16, 1024), kk > 0);
      }
      mbar_wait(bar_full_v + 8 * s, parity);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t step = (kk % 4) * 32u;
        wgmma_ss_n128(dp, smem_desc(sDO + (kk / 4) * BQ * ROW + 64 * w * ROW + step, 16, 1024),
                     smem_desc(sV + (kk / 4) * BK * ROW + step, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);

      // Mask only the tiles that cross the causal diagonal or the ragged end.
      if (k0 + BK > Skv || (causal && k0 + BK - 1 > qw0 + offset)) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int key = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
          if (key >= Skv || (causal && key > ((i & 2) ? lim1 : lim0))) sc[i] = -INFINITY;
        }
      }
      // p and ds on registers; ds packed pairwise into bf16 A fragments: k step
      // kt takes key columns 16 kt .. 16 kt + 15, accumulator elements 8 kt ..
      // 8 kt + 7.
      uint32_t a[BK / 16][4];
#pragma unroll
      for (int i = 0; i < BK / 2; i += 2) {
        const int r = (i >> 1) & 1;
        const float p0 = exp2_approx(fmaf(sc[i], sl2, -lse2[r]));
        const float p1 = exp2_approx(fmaf(sc[i + 1], sl2, -lse2[r]));
        a[i / 8][(i % 8) / 2] =
            pack_bf16(p0 * (dp[i] - dlt[r]) * scale, p1 * (dp[i + 1] - dlt[r]) * scale);
      }

      // dQ += dS . K: K [keys, D] is the MN-major B operand, 16 keys per step
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kt = 0; kt < BK / 16; ++kt)
        wgmma_rs<D>(acc, a[kt], smem_desc(sK + kt * 16 * ROW, BK * ROW, 1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    } else {
      mbar_wait(bar_full_v + 8 * s, parity);  // a slot is released once both loads landed
    }
    mbar_arrive(bar_empty + 8 * s);
    // Thread 0 refills the slot once both warpgroups have released it.
    const int next = j + STAGES;
    if (threadIdx.x == 0 && next < n_tiles) {
      mbar_wait(bar_empty + 8 * s, parity);
      k2_load_kv<D>(base, s, &tm_k, &tm_v, hk, next * BK, b);
    }
    __syncwarp();  // warp 0 meets again before its next wgmma
  }

  // ---- epilogue: dQ through this warpgroup's own rows of the Q tile ------
  if (!active) return;
  const float one[2] = {1.f, 1.f};
  stage_bf16<D>(smem + SM::q_off, BQ * ROW, 64 * w, acc, one);
  warpgroup_sync_for_tma(w);
  if (t == 0) {
#pragma unroll
    for (int c = 0; c < SLABS; ++c)
      tma_store(&tm_dq, sQ + c * BQ * ROW + 64 * w * ROW, 64 * c, h, qw0, b);
    tma_store_wait();
  }
}

// ------------------------------------------------------------- K3: dK/dV ---
namespace k3 {
constexpr int BK = 128;  // keys per block
constexpr int BQ = 64;   // query rows per ring slot
// per slot: ROW_BOX floats of lse, then (at + 512 bytes) ROW_BOX of delta. A
// TMA box starts on a 16-byte boundary, so a slot's rows q0 .. q0 + 63 start
// 0-3 floats into its box.
constexpr int ROW_BOX = BQ + 4;
constexpr uint32_t row_bytes = 1024;
template <int D>
struct Smem {
  static constexpr uint32_t k_off = 0;
  static constexpr uint32_t v_off = k_off + tile_bytes<D>(BK);
  static constexpr uint32_t q_off = v_off + tile_bytes<D>(BK);            // + s * tile_bytes(BQ)
  static constexpr uint32_t do_off = q_off + STAGES * tile_bytes<D>(BQ);  // + s * tile_bytes(BQ)
  static constexpr uint32_t row_off = do_off + STAGES * tile_bytes<D>(BQ);
  static constexpr uint32_t bar_off = row_off + STAGES * row_bytes;
  // barriers: K and V, then full and empty for each slot
  static constexpr uint32_t bytes = bar_off + 8 * (1 + 2 * STAGES) + 1024;  // + alignment slack
};
}  // namespace k3

// The flat index of row q0 of q head h in the [B, Hq, Sq] lse and delta.
__device__ __forceinline__ int k3_row(int b, int h, int q0, int Hq, int Sq) {
  return (b * Hq + h) * Sq + q0;
}

// Fill K3's ring slot s with one q tile: the Q and dO tiles and the lse and
// delta rows of q head h, rows q0 .. q0 + 63, all on the slot's one barrier.
// The lse and delta boxes start at the 16-byte boundary at or before row q0.
// Rows past Sq belong to the next head (or read as zero past the array's
// end): finite (every row sees at least one key, so every lse is finite),
// and masked like the zero rows of Q and dO.
template <int D>
__device__ __forceinline__ void k3_load_slot(uint32_t base, int s, const CUtensorMap* tm_q,
                                             const CUtensorMap* tm_do,
                                             const CUtensorMap* tm_lse,
                                             const CUtensorMap* tm_delta, int h, int q0, int b,
                                             int Hq, int Sq) {
  using namespace k3;
  using SM = Smem<D>;
  const uint32_t bar = base + SM::bar_off + 8 + 8 * s;
  const uint32_t sQ = base + SM::q_off + s * tile_bytes<D>(BQ);
  const uint32_t sDO = base + SM::do_off + s * tile_bytes<D>(BQ);
  const uint32_t sRows = base + SM::row_off + s * row_bytes;
  mbar_expect_tx(bar, 2 * tile_bytes<D>(BQ) + 2 * ROW_BOX * 4);
#pragma unroll
  for (int c = 0; c < D / 64; ++c) {
    tma_load(sQ + c * BQ * ROW, tm_q, bar, 64 * c, h, q0, b);
    tma_load(sDO + c * BQ * ROW, tm_do, bar, 64 * c, h, q0, b);
  }
  const int start = k3_row(b, h, q0, Hq, Sq) & ~3;
  tma_load_1d(sRows, tm_lse, bar, start);
  tma_load_1d(sRows + row_bytes / 2, tm_delta, bar, start);
}

// GROUP > 0 fixes the group at compile time (llama_1b's D 128 at 4, which a
// run-time group made 1.4% slower on the H100, the two timed in turns by
// attention_times.py); 0 takes it from group_arg.
template <int D, int GROUP>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_dk,
                     const __grid_constant__ CUtensorMap tm_dv,
                     const __grid_constant__ CUtensorMap tm_lse,
                     const __grid_constant__ CUtensorMap tm_delta, int Sq, int Skv, int Hq,
                     int group_arg, int causal, float scale) {
  using namespace k3;
  const int group = GROUP > 0 ? GROUP : group_arg;
  using SM = Smem<D>;
  constexpr int SLABS = D / 64;  // 64-column slabs per tile row
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t sK = base + SM::k_off;
  const uint32_t sV = base + SM::v_off;
  const float* rows = reinterpret_cast<const float*>(smem + SM::row_off);  // + s * row_bytes / 4
  const uint32_t bar_kv = base + SM::bar_off;
  const uint32_t bar_full = bar_kv + 8;              // + 8 s
  const uint32_t bar_empty = bar_full + 8 * STAGES;  // + 8 s

  // The widest causal key tiles of every (b, kv head) go first: the key tile
  // is the slowest grid dimension, so the last wave holds the narrowest tiles.
  const int k0 = blockIdx.z * BK;
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int offset = Skv - Sq;
  // First q tile whose last row (absolute position offset + i) can see key
  // k0: i >= k0 - offset (the JAX kernel's `first`, floored at 0).
  const int first = causal && k0 > offset ? (k0 - offset) / BQ : 0;
  const int per_head = (Sq + BQ - 1) / BQ - first;
  const int n_iters = group * per_head;  // the ring runs on across head boundaries

  // Thread 0 is the producer as well as a consumer: it issues K, V and the
  // first STAGES slots here, and each later slot once every consumer has
  // released it (below).
  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, NTHREADS);  // every consumer thread releases the slot
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar_kv, 2 * tile_bytes<D>(BK));
#pragma unroll
    for (int c = 0; c < SLABS; ++c) {
      tma_load(sK + c * BK * ROW, &tm_k, bar_kv, 64 * c, hk, k0, b);
      tma_load(sV + c * BK * ROW, &tm_v, bar_kv, 64 * c, hk, k0, b);
    }
    for (int it = 0; it < min(STAGES, n_iters); ++it)
      k3_load_slot<D>(base, it, &tm_q, &tm_do, &tm_lse, &tm_delta, hk * group + it / per_head,
                      (first + it % per_head) * BQ, b, Hq, Sq);
  }
  __syncthreads();

  // ---- warpgroup w owns keys k0 + 64 w .. + 63 ---------------------------
  const int w = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int lane = threadIdx.x % 32;
  const int kw0 = k0 + 64 * w;
  const int key0 = kw0 + 16 * (t / 32) + lane / 4;  // this thread's keys: key0 and key0 + 8
  const float sl2 = scale * LOG2E;
  // A warpgroup whose keys all lie past Skv has no rows to write: it only
  // releases the slots.
  const bool active = kw0 < Skv;

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(bar_kv, 0);
  for (int it = 0; it < n_iters; ++it) {
    const int h = hk * group + it / per_head;
    const int q0 = (first + it % per_head) * BQ;
    const int s = it % STAGES;
    const uint32_t parity = (it / STAGES) & 1;
    const uint32_t sQ = base + SM::q_off + s * tile_bytes<D>(BQ);
    const uint32_t sDO = base + SM::do_off + s * tile_bytes<D>(BQ);
    mbar_wait(bar_full + 8 * s, parity);
    // A q tile whose last row sees none of this warpgroup's keys is skipped.
    if (active && !(causal && q0 + BQ - 1 + offset < kw0)) {
      // S^T = K . Q^T and dP^T = V . dO^T: keys on the rows, queries on the columns
      float st[BQ / 2], dpt[BQ / 2];
      fence_regs(st);
      fence_regs(dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t step = (kk % 4) * 32u;
        wgmma_ss_n64(st, smem_desc(sK + (kk / 4) * BK * ROW + 64 * w * ROW + step, 16, 1024),
                     smem_desc(sQ + (kk / 4) * BQ * ROW + step, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t step = (kk % 4) * 32u;
        wgmma_ss_n64(dpt, smem_desc(sV + (kk / 4) * BK * ROW + 64 * w * ROW + step, 16, 1024),
                     smem_desc(sDO + (kk / 4) * BQ * ROW + step, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(st);
      fence_regs(dpt);

      // Mask only the tiles that reach past Sq or cross the causal diagonal:
      // column (query) q sees key k when q < Sq and k <= q + offset.
      if (q0 + BQ > Sq || (causal && kw0 + 63 > q0 + offset)) {
#pragma unroll
        for (int i = 0; i < BQ / 2; ++i) {
          const int q = q0 + 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
          const int key = (i & 2) ? key0 + 8 : key0;
          if (q >= Sq || (causal && key > q + offset)) st[i] = -INFINITY;
        }
      }
      // p^T and ds^T on registers, each packed pairwise into bf16 A fragments.
      // Element pair i, i + 1 holds columns 8 (i / 4) + 2 (lane % 4) + {0, 1}.
      const float* lse_s = rows + s * (row_bytes / 4) + (k3_row(b, h, q0, Hq, Sq) & 3);
      const float* delta_s = lse_s + row_bytes / 8;
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
      for (int i = 0; i < BQ / 2; i += 2) {
        const int col = 8 * (i / 4) + 2 * (lane % 4);
        const float p0 = exp2_approx(fmaf(st[i], sl2, -lse_s[col] * LOG2E));
        const float p1 = exp2_approx(fmaf(st[i + 1], sl2, -lse_s[col + 1] * LOG2E));
        pa[i / 8][(i % 8) / 2] = pack_bf16(p0, p1);
        da[i / 8][(i % 8) / 2] = pack_bf16(p0 * (dpt[i] - delta_s[col]) * scale,
                                           p1 * (dpt[i + 1] - delta_s[col + 1]) * scale);
      }

      // dV += P^T . dO and dK += dS^T . Q: dO and Q [q rows, D] are MN-major B
      // operands, 16 q rows per step
      fence_regs(dv);
      fence_regs(dk);
      wgmma_fence();
#pragma unroll
      for (int kt = 0; kt < BQ / 16; ++kt)
        wgmma_rs<D>(dv, pa[kt], smem_desc(sDO + kt * 16 * ROW, BQ * ROW, 1024));
#pragma unroll
      for (int kt = 0; kt < BQ / 16; ++kt)
        wgmma_rs<D>(dk, da[kt], smem_desc(sQ + kt * 16 * ROW, BQ * ROW, 1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dv);
      fence_regs(dk);
    }
    mbar_arrive(bar_empty + 8 * s);
    // Thread 0 refills the slot once both warpgroups have released it. It
    // lies in warpgroup 0, whose keys come first: on the causal diagonal
    // warpgroup 1 skips at least the tiles warpgroup 0 skips, so the wait is
    // mostly for work that is already done.
    const int next = it + STAGES;
    if (threadIdx.x == 0 && next < n_iters) {
      mbar_wait(bar_empty + 8 * s, parity);
      k3_load_slot<D>(base, s, &tm_q, &tm_do, &tm_lse, &tm_delta, hk * group + next / per_head,
                      (first + next % per_head) * BQ, b, Hq, Sq);
    }
    __syncwarp();  // warp 0 meets again before its next wgmma
  }

  // ---- epilogue: dK and dV through this warpgroup's own rows of K and V --
  if (active) {
    const float one[2] = {1.f, 1.f};
    stage_bf16<D>(smem + SM::k_off, BK * ROW, 64 * w, dk, one);
    stage_bf16<D>(smem + SM::v_off, BK * ROW, 64 * w, dv, one);
    warpgroup_sync_for_tma(w);
    if (t == 0) {
#pragma unroll
      for (int c = 0; c < SLABS; ++c) {
        tma_store(&tm_dk, sK + c * BK * ROW + 64 * w * ROW, 64 * c, hk, kw0, b);
        tma_store(&tm_dv, sV + c * BK * ROW + 64 * w * ROW, 64 * c, hk, kw0, b);
      }
      tma_store_wait();
    }
  }
}

// ------------------------------------------------------- K2 at D 256: dQ ---
namespace k2w {
constexpr int D = 256;
constexpr int BQ = 128;                        // query rows per block, as at D 64 and 128
constexpr int BK = 64;                         // keys per K or V tile
constexpr int BUFS = 3;                        // ring buffers, each holding one K or one V tile
constexpr uint32_t TILE = tile_bytes<D>(BK);   // 32 KB
// Shared-memory plan: Q and dO resident (64 KB each), then the ring; 224 KB
// of the 227 KB a block may have.
struct Smem {
  static constexpr uint32_t q_off = 0;
  static constexpr uint32_t do_off = q_off + tile_bytes<D>(BQ);
  static constexpr uint32_t ring_off = do_off + tile_bytes<D>(BQ);
  static constexpr uint32_t bar_off = ring_off + BUFS * TILE;
  // barriers: Q and dO, then full and empty for each buffer
  static constexpr uint32_t bytes = bar_off + 8 * (1 + 2 * BUFS) + 1024;  // + alignment slack
};
static_assert(Smem::bytes <= 232448, "K2 at D 256 exceeds a block's shared memory");
}  // namespace k2w

// Load n of K2's D 256 ring into buffer n % BUFS: V of key tile n / 2 when n
// is even, K of it when n is odd (V first: it is released first).
__device__ __forceinline__ void k2w_load(uint32_t base, int n, const CUtensorMap* tm_k,
                                         const CUtensorMap* tm_v, int hk, int b) {
  using namespace k2w;
  const int buf = n % BUFS;
  const uint32_t bar = base + Smem::bar_off + 8 + 8 * buf;
  const uint32_t dst = base + Smem::ring_off + buf * TILE;
  const CUtensorMap* map = (n & 1) ? tm_k : tm_v;
  mbar_expect_tx(bar, TILE);
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
    tma_load(dst + c * BK * ROW, map, bar, 64 * c, hk, (n / 2) * BK, b);
}

__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dq_d256_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const __grid_constant__ CUtensorMap tm_dq, const float* __restrict__ lse,
                         const float* __restrict__ delta, int Sq, int Skv, int Hq, int group,
                         int causal, float scale) {
  using namespace k2w;
  using SM = Smem;
  constexpr int SLABS = D / 64;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t sQ = base + SM::q_off;
  const uint32_t sDO = base + SM::do_off;
  const uint32_t ring = base + SM::ring_off;
  const uint32_t bar_q = base + SM::bar_off;
  const uint32_t bar_full = bar_q + 8;             // + 8 buffer
  const uint32_t bar_empty = bar_full + 8 * BUFS;  // + 8 buffer

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // the widest causal q tiles first
  const int hk = h / group;
  const int offset = Skv - Sq;
  const int kv_end = causal ? min(Skv, q0 + BQ + offset) : Skv;
  const int n_tiles = (kv_end + BK - 1) / BK;
  const int n_loads = 2 * n_tiles;  // V and K of each key tile

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < BUFS; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, NTHREADS);  // every consumer thread releases the buffer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar_q, 2 * tile_bytes<D>(BQ));
#pragma unroll
    for (int c = 0; c < SLABS; ++c) {
      tma_load(sQ + c * BQ * ROW, &tm_q, bar_q, 64 * c, h, q0, b);
      tma_load(sDO + c * BQ * ROW, &tm_do, bar_q, 64 * c, h, q0, b);
    }
    for (int n = 0; n < min(BUFS, n_loads); ++n) k2w_load(base, n, &tm_k, &tm_v, hk, b);
  }
  __syncthreads();

  // ---- warpgroup w owns query rows q0 + 64 w .. + 63 --------------------
  const int w = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int lane = threadIdx.x % 32;
  const int row0 = 16 * (t / 32) + lane / 4;
  const int qw0 = q0 + 64 * w;
  const int lim0 = qw0 + row0 + offset;
  const int lim1 = lim0 + 8;
  const float sl2 = scale * LOG2E;
  const bool active = qw0 < Sq;
  const int wg_tiles = causal ? (min(Skv, qw0 + 64 + offset) + BK - 1) / BK : n_tiles;

  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qw0 + row0 + 8 * r;
    const long at = ((long)b * Hq + h) * Sq + row;
    lse2[r] = row < Sq ? lse[at] * LOG2E : 0.f;
    dlt[r] = row < Sq ? delta[at] : 0.f;
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(bar_q, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int nv = 2 * j, nk = 2 * j + 1;  // this key tile's V and K loads
    const uint32_t sV = ring + (nv % BUFS) * TILE;
    const uint32_t sK = ring + (nk % BUFS) * TILE;
    const int k0 = j * BK;
    const bool work = active && j < wg_tiles;
    mbar_wait(bar_full + 8 * (nv % BUFS), (nv / BUFS) & 1);
    mbar_wait(bar_full + 8 * (nk % BUFS), (nk / BUFS) & 1);
    float sc[BK / 2], dp[BK / 2];
    if (work) {
      // S = Q . K^T, then dP = dO . V^T, each D / 16 products of depth 16 and
      // a commit group of its own: p = exp(s - lse) is computed in place in
      // sc while dP runs.
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t step = (kk % 4) * 32u;
        wgmma_ss_n64(sc, smem_desc(sQ + (kk / 4) * BQ * ROW + 64 * w * ROW + step, 16, 1024),
                     smem_desc(sK + (kk / 4) * BK * ROW + step, 16, 1024), kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t step = (kk % 4) * 32u;
        wgmma_ss_n64(dp, smem_desc(sDO + (kk / 4) * BQ * ROW + 64 * w * ROW + step, 16, 1024),
                     smem_desc(sV + (kk / 4) * BK * ROW + step, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sc);
      if (k0 + BK > Skv || (causal && k0 + BK - 1 > qw0 + offset)) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int key = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
          if (key >= Skv || (causal && key > ((i & 2) ? lim1 : lim0))) sc[i] = -INFINITY;
        }
      }
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] = exp2_approx(fmaf(sc[i], sl2, -lse2[(i >> 1) & 1]));
      wgmma_wait<0>();
      fence_regs(dp);
    }
    // V is read by dP alone: release it, and thread 0 refills its buffer
    // with the next key tile's K while dS . K runs.
    mbar_arrive(bar_empty + 8 * (nv % BUFS));
    if (threadIdx.x == 0 && nv + BUFS < n_loads) {
      mbar_wait(bar_empty + 8 * (nv % BUFS), (nv / BUFS) & 1);
      k2w_load(base, nv + BUFS, &tm_k, &tm_v, hk, b);
    }
    __syncwarp();
    if (work) {
      uint32_t a[BK / 16][4];
#pragma unroll
      for (int i = 0; i < BK / 2; i += 2) {
        const int r = (i >> 1) & 1;
        a[i / 8][(i % 8) / 2] =
            pack_bf16(sc[i] * (dp[i] - dlt[r]) * scale, sc[i + 1] * (dp[i + 1] - dlt[r]) * scale);
      }
      // dQ += dS . K: K [keys, D] is the MN-major B operand, as two n128 halves
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kt = 0; kt < BK / 16; ++kt)
        wgmma_rs<D>(acc, a[kt], smem_desc(sK + kt * 16 * ROW, BK * ROW, 1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    mbar_arrive(bar_empty + 8 * (nk % BUFS));
    if (threadIdx.x == 0 && nk + BUFS < n_loads) {
      mbar_wait(bar_empty + 8 * (nk % BUFS), (nk / BUFS) & 1);
      k2w_load(base, nk + BUFS, &tm_k, &tm_v, hk, b);
    }
    __syncwarp();
  }

  if (!active) return;
  const float one[2] = {1.f, 1.f};
  stage_bf16<D>(smem + SM::q_off, BQ * ROW, 64 * w, acc, one);
  warpgroup_sync_for_tma(w);
  if (t == 0) {
#pragma unroll
    for (int c = 0; c < SLABS; ++c)
      tma_store(&tm_dq, sQ + c * BQ * ROW + 64 * w * ROW, 64 * c, h, qw0, b);
    tma_store_wait();
  }
}

// --------------------------------------------------- K3 at D 256: dK/dV ---
namespace k3w {
constexpr int D = 256;
constexpr int BK = 64;   // keys per block: both warpgroups own the same 64 keys
constexpr int BQ = 64;   // query rows per ring slot
constexpr int ROW_BOX = BQ + 4;
// per slot: the lse box at 0 and the delta box at DELTA_AT (TMA destinations
// on 128-byte boundaries)
constexpr uint32_t DELTA_AT = 384;
constexpr uint32_t row_bytes = 768;
struct Smem {
  static constexpr uint32_t k_off = 0;
  static constexpr uint32_t v_off = k_off + tile_bytes<D>(BK);
  static constexpr uint32_t q_off = v_off + tile_bytes<D>(BK);            // + s * tile_bytes(BQ)
  static constexpr uint32_t do_off = q_off + STAGES * tile_bytes<D>(BQ);  // + s * tile_bytes(BQ)
  static constexpr uint32_t row_off = do_off + STAGES * tile_bytes<D>(BQ);
  static constexpr uint32_t bar_off = row_off + STAGES * row_bytes;
  // barriers: K and V, then full and empty for each slot
  static constexpr uint32_t bytes = bar_off + 8 * (1 + 2 * STAGES) + 1024;  // + alignment slack
};
static_assert(Smem::bytes <= 232448, "K3 at D 256 exceeds a block's shared memory");
}  // namespace k3w

// Fill slot s of K3's D 256 ring: k3_load_slot's tiles and rows in k3w's plan.
__device__ __forceinline__ void k3w_load_slot(uint32_t base, int s, const CUtensorMap* tm_q,
                                              const CUtensorMap* tm_do,
                                              const CUtensorMap* tm_lse,
                                              const CUtensorMap* tm_delta, int h, int q0, int b,
                                              int Hq, int Sq) {
  using namespace k3w;
  const uint32_t bar = base + Smem::bar_off + 8 + 8 * s;
  const uint32_t sQ = base + Smem::q_off + s * tile_bytes<D>(BQ);
  const uint32_t sDO = base + Smem::do_off + s * tile_bytes<D>(BQ);
  const uint32_t sRows = base + Smem::row_off + s * row_bytes;
  mbar_expect_tx(bar, 2 * tile_bytes<D>(BQ) + 2 * ROW_BOX * 4);
#pragma unroll
  for (int c = 0; c < D / 64; ++c) {
    tma_load(sQ + c * BQ * ROW, tm_q, bar, 64 * c, h, q0, b);
    tma_load(sDO + c * BQ * ROW, tm_do, bar, 64 * c, h, q0, b);
  }
  const int start = k3_row(b, h, q0, Hq, Sq) & ~3;
  tma_load_1d(sRows, tm_lse, bar, start);
  tma_load_1d(sRows + DELTA_AT, tm_delta, bar, start);
}

__global__ void __launch_bounds__(NTHREADS, 1)
flash_bwd_dkv_d256_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_dk,
                          const __grid_constant__ CUtensorMap tm_dv,
                          const __grid_constant__ CUtensorMap tm_lse,
                          const __grid_constant__ CUtensorMap tm_delta, int Sq, int Skv, int Hq,
                          int group, int causal, float scale) {
  using namespace k3w;
  using SM = Smem;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t sK = base + SM::k_off;
  const uint32_t sV = base + SM::v_off;
  const float* rows = reinterpret_cast<const float*>(smem + SM::row_off);  // + s * row_bytes / 4
  const uint32_t bar_kv = base + SM::bar_off;
  const uint32_t bar_full = bar_kv + 8;
  const uint32_t bar_empty = bar_full + 8 * STAGES;

  const int k0 = blockIdx.z * BK;  // the widest causal key tiles first
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int offset = Skv - Sq;
  // the first q tile whose last row sees key k0; every later one sees it too
  const int first = causal && k0 > offset ? (k0 - offset) / BQ : 0;
  const int per_head = (Sq + BQ - 1) / BQ - first;
  const int n_iters = group * per_head;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, NTHREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar_kv, 2 * tile_bytes<D>(BK));
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      tma_load(sK + c * BK * ROW, &tm_k, bar_kv, 64 * c, hk, k0, b);
      tma_load(sV + c * BK * ROW, &tm_v, bar_kv, 64 * c, hk, k0, b);
    }
    for (int it = 0; it < min(STAGES, n_iters); ++it)
      k3w_load_slot(base, it, &tm_q, &tm_do, &tm_lse, &tm_delta, hk * group + it / per_head,
                    (first + it % per_head) * BQ, b, Hq, Sq);
  }
  __syncthreads();

  // ---- warpgroup w owns columns 128 w .. + 127 of dK and dV for all 64 keys
  const int w = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int lane = threadIdx.x % 32;
  const int key0 = k0 + 16 * (t / 32) + lane / 4;  // this thread's keys: key0 and key0 + 8
  const float sl2 = scale * LOG2E;

  float dk[D / 4], dv[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(bar_kv, 0);
  for (int it = 0; it < n_iters; ++it) {
    const int h = hk * group + it / per_head;
    const int q0 = (first + it % per_head) * BQ;
    const int s = it % STAGES;
    const uint32_t parity = (it / STAGES) & 1;
    const uint32_t sQ = base + SM::q_off + s * tile_bytes<D>(BQ);
    const uint32_t sDO = base + SM::do_off + s * tile_bytes<D>(BQ);
    mbar_wait(bar_full + 8 * s, parity);

    // S^T = K . Q^T and dP^T = V . dO^T, keys on the rows and queries on the
    // columns, each over the whole head dim and in a commit group of its
    // own: both warpgroups compute both (the two share the block's 64 keys),
    // and p^T is computed in place in st while dP^T runs.
    float st[BQ / 2], dpt[BQ / 2];
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t step = (kk % 4) * 32u;
      wgmma_ss_n64(st, smem_desc(sK + (kk / 4) * BK * ROW + step, 16, 1024),
                   smem_desc(sQ + (kk / 4) * BQ * ROW + step, 16, 1024), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t step = (kk % 4) * 32u;
      wgmma_ss_n64(dpt, smem_desc(sV + (kk / 4) * BK * ROW + step, 16, 1024),
                   smem_desc(sDO + (kk / 4) * BQ * ROW + step, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(st);

    // p^T, 0 where column (query) q does not see key k (q >= Sq, or k > q +
    // offset); then p^T and ds^T, each packed pairwise into bf16 A fragments.
    const float* lse_s = rows + s * (row_bytes / 4) + (k3_row(b, h, q0, Hq, Sq) & 3);
    const float* delta_s = lse_s + DELTA_AT / 4;
    const bool edge = q0 + BQ > Sq || (causal && k0 + BK - 1 > q0 + offset);
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) {
      const int col = 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
      const int key = (i & 2) ? key0 + 8 : key0;
      const int q = q0 + col;
      const bool seen = !edge || (q < Sq && !(causal && key > q + offset));
      st[i] = seen ? exp2_approx(fmaf(st[i], sl2, -lse_s[col] * LOG2E)) : 0.f;
    }
    wgmma_wait<0>();
    fence_regs(dpt);
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
    for (int i = 0; i < BQ / 2; i += 2) {
      const int col = 8 * (i / 4) + 2 * (lane % 4);
      pa[i / 8][(i % 8) / 2] = pack_bf16(st[i], st[i + 1]);
      da[i / 8][(i % 8) / 2] = pack_bf16(st[i] * (dpt[i] - delta_s[col]) * scale,
                                         st[i + 1] * (dpt[i + 1] - delta_s[col + 1]) * scale);
    }

    // dV[:, 128 w ..] += P^T . dO[:, 128 w ..] and dK[:, 128 w ..] += dS^T .
    // Q[:, 128 w ..]: this warpgroup's two slabs of dO and Q, MN-major B
    fence_regs(dv);
    fence_regs(dk);
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < BQ / 16; ++kt)
      wgmma_rs<128>(dv, pa[kt], smem_desc(sDO + 2 * w * BQ * ROW + kt * 16 * ROW, BQ * ROW, 1024));
#pragma unroll
    for (int kt = 0; kt < BQ / 16; ++kt)
      wgmma_rs<128>(dk, da[kt], smem_desc(sQ + 2 * w * BQ * ROW + kt * 16 * ROW, BQ * ROW, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dv);
    fence_regs(dk);
    mbar_arrive(bar_empty + 8 * s);
    const int next = it + STAGES;
    if (threadIdx.x == 0 && next < n_iters) {
      mbar_wait(bar_empty + 8 * s, parity);
      k3w_load_slot(base, s, &tm_q, &tm_do, &tm_lse, &tm_delta, hk * group + next / per_head,
                    (first + next % per_head) * BQ, b, Hq, Sq);
    }
    __syncwarp();
  }

  // ---- epilogue: this warpgroup's slabs of dK and dV through those of K and
  // V, once neither warpgroup reads K or V any more (the score products).
  __syncthreads();
  const float one[2] = {1.f, 1.f};
  stage_bf16<128>(smem + SM::k_off + 2 * w * BK * ROW, BK * ROW, 0, dk, one);
  stage_bf16<128>(smem + SM::v_off + 2 * w * BK * ROW, BK * ROW, 0, dv, one);
  warpgroup_sync_for_tma(w);
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = 2 * w + i;
      tma_store(&tm_dk, sK + c * BK * ROW, 64 * c, hk, k0, b);
      tma_store(&tm_dv, sV + c * BK * ROW, 64 * c, hk, k0, b);
    }
    tma_store_wait();
  }
}

int check_shape(int B, int Sq, int Skv, int Hq, int Hkv, int Dim) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq <= 0) return (int)cudaErrorInvalidValue;
  if ((Dim != 64 && Dim != 128 && Dim != 256) || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, int B, int Sq, int Skv, int Hq, int Hkv, int causal,
              float scale, cudaStream_t stream) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tm_q, tm_k, tm_v, tm_do, tm_dq;
  if (!make_map(encode, &tm_q, q, B, Sq, Hq, D, k2::BQ) ||
      !make_map(encode, &tm_k, k, B, Skv, Hkv, D, k2::BK) ||
      !make_map(encode, &tm_v, v, B, Skv, Hkv, D, k2::BK) ||
      !make_map(encode, &tm_do, dout, B, Sq, Hq, D, k2::BQ) ||
      !make_map(encode, &tm_dq, dq, B, Sq, Hq, D, 64))
    return (int)cudaErrorInvalidValue;
  auto kern = flash_bwd_dq_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)k2::Smem<D>::bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(Hq, B, (Sq + k2::BQ - 1) / k2::BQ);
  kern<<<grid, NTHREADS, k2::Smem<D>::bytes, stream>>>(
      tm_q, tm_k, tm_v, tm_do, tm_dq, static_cast<const float*>(lse),
      static_cast<const float*>(delta), Sq, Skv, Hq, Hq / Hkv, causal, scale);
  return (int)cudaGetLastError();
}

template <int D, int GROUP>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, int B, int Sq, int Skv, int Hq, int Hkv,
               int causal, float scale, cudaStream_t stream) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tm_q, tm_k, tm_v, tm_do, tm_dk, tm_dv, tm_lse, tm_delta;
  const long rows = (long)B * Hq * Sq;
  if (!make_map_1d_f32(encode, &tm_lse, lse, rows, k3::ROW_BOX) ||
      !make_map_1d_f32(encode, &tm_delta, delta, rows, k3::ROW_BOX) ||
      !make_map(encode, &tm_q, q, B, Sq, Hq, D, k3::BQ) ||
      !make_map(encode, &tm_k, k, B, Skv, Hkv, D, k3::BK) ||
      !make_map(encode, &tm_v, v, B, Skv, Hkv, D, k3::BK) ||
      !make_map(encode, &tm_do, dout, B, Sq, Hq, D, k3::BQ) ||
      !make_map(encode, &tm_dk, dk, B, Skv, Hkv, D, 64) ||
      !make_map(encode, &tm_dv, dv, B, Skv, Hkv, D, 64))
    return (int)cudaErrorInvalidValue;
  auto kern = flash_bwd_dkv_kernel<D, GROUP>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)k3::Smem<D>::bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(Hkv, B, (Skv + k3::BK - 1) / k3::BK);
  kern<<<grid, NTHREADS, k3::Smem<D>::bytes, stream>>>(
      tm_q, tm_k, tm_v, tm_do, tm_dk, tm_dv, tm_lse, tm_delta, Sq, Skv, Hq, Hq / Hkv, causal,
      scale);
  return (int)cudaGetLastError();
}

int launch_dq_d256(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dq, int B, int Sq, int Skv, int Hq,
                   int Hkv, int causal, float scale, cudaStream_t stream) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tm_q, tm_k, tm_v, tm_do, tm_dq;
  if (!make_map(encode, &tm_q, q, B, Sq, Hq, 256, k2w::BQ) ||
      !make_map(encode, &tm_k, k, B, Skv, Hkv, 256, k2w::BK) ||
      !make_map(encode, &tm_v, v, B, Skv, Hkv, 256, k2w::BK) ||
      !make_map(encode, &tm_do, dout, B, Sq, Hq, 256, k2w::BQ) ||
      !make_map(encode, &tm_dq, dq, B, Sq, Hq, 256, 64))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_d256_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)k2w::Smem::bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(Hq, B, (Sq + k2w::BQ - 1) / k2w::BQ);
  flash_bwd_dq_d256_kernel<<<grid, NTHREADS, k2w::Smem::bytes, stream>>>(
      tm_q, tm_k, tm_v, tm_do, tm_dq, static_cast<const float*>(lse),
      static_cast<const float*>(delta), Sq, Skv, Hq, Hq / Hkv, causal, scale);
  return (int)cudaGetLastError();
}

int launch_dkv_d256(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dk, void* dv, int B, int Sq,
                    int Skv, int Hq, int Hkv, int causal, float scale, cudaStream_t stream) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tm_q, tm_k, tm_v, tm_do, tm_dk, tm_dv, tm_lse, tm_delta;
  const long rows = (long)B * Hq * Sq;
  if (!make_map_1d_f32(encode, &tm_lse, lse, rows, k3w::ROW_BOX) ||
      !make_map_1d_f32(encode, &tm_delta, delta, rows, k3w::ROW_BOX) ||
      !make_map(encode, &tm_q, q, B, Sq, Hq, 256, k3w::BQ) ||
      !make_map(encode, &tm_k, k, B, Skv, Hkv, 256, k3w::BK) ||
      !make_map(encode, &tm_v, v, B, Skv, Hkv, 256, k3w::BK) ||
      !make_map(encode, &tm_do, dout, B, Sq, Hq, 256, k3w::BQ) ||
      !make_map(encode, &tm_dk, dk, B, Skv, Hkv, 256, k3w::BK) ||
      !make_map(encode, &tm_dv, dv, B, Skv, Hkv, 256, k3w::BK))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkv_d256_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)k3w::Smem::bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(Hkv, B, (Skv + k3w::BK - 1) / k3w::BK);
  flash_bwd_dkv_d256_kernel<<<grid, NTHREADS, k3w::Smem::bytes, stream>>>(
      tm_q, tm_k, tm_v, tm_do, tm_dk, tm_dv, tm_lse, tm_delta, Sq, Skv, Hq, Hq / Hkv, causal,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dq, int B, int Sq,
                                 int Skv, int Hq, int Hkv, int Dim, int causal, float scale,
                                 void* stream) {
  int err = check_shape(B, Sq, Skv, Hq, Hkv, Dim);
  if (err) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dim == 256)
    return launch_dq_d256(q, k, v, dout, lse, delta, dq, B, Sq, Skv, Hq, Hkv, causal, scale, st);
  if (Dim == 128)
    return launch_dq<128>(q, k, v, dout, lse, delta, dq, B, Sq, Skv, Hq, Hkv, causal, scale, st);
  return launch_dq<64>(q, k, v, dout, lse, delta, dq, B, Sq, Skv, Hq, Hkv, causal, scale, st);
}

extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dk, void* dv, int B,
                                  int Sq, int Skv, int Hq, int Hkv, int Dim, int causal,
                                  float scale, void* stream) {
  int err = check_shape(B, Sq, Skv, Hq, Hkv, Dim);
  if (err) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Dim == 256)
    return launch_dkv_d256(q, k, v, dout, lse, delta, dk, dv, B, Sq, Skv, Hq, Hkv, causal,
                           scale, st);
  if (Dim == 128 && Hq == 4 * Hkv)
    return launch_dkv<128, 4>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Skv, Hq, Hkv, causal,
                              scale, st);
  if (Dim == 128)
    return launch_dkv<128, 0>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Skv, Hq, Hkv, causal,
                              scale, st);
  return launch_dkv<64, 0>(q, k, v, dout, lse, delta, dk, dv, B, Sq, Skv, Hq, Hkv, causal, scale,
                           st);
}

extern "C" const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
