// The bf16 attention tile steps on wgmma, shared by the flash kernels
// (flash_attention.cu) and the block-sparse kernels
// (block_sparse_attention.cu), which differ only in the tiles they walk:
//   fwd_tile_wgmma     online softmax over one kv tile (fa_fwd_wgmma_kernel,
//                      bsa_fwd_wgmma_kernel, bsa_fwd_dsplit_wgmma_kernel)
//   dq_tile_wgmma      dq += ds k over one kv tile (fa_dq_wgmma_kernel,
//                      bsa_dq_wgmma_kernel, bsa_dq_dsplit_wgmma_kernel)
//   dkv_tile_wgmma     dv += p^T dO, dk += ds^T q over one q tile
//                      (fa_dkv_wgmma_kernel, bsa_dkv_wgmma_kernel)
//   dkv_p_tile_wgmma,  the same split by role (bsa_dkv_split_wgmma_kernel,
//   dkv_ds_tile_wgmma  bsa_dkv_dsplit_wgmma_kernel)
// and, below, the kernels both families launch over a BlockList:
//   bsa_fwd_wgmma_kernel        the forward: block-sparse at padded D
//                               64..256, flash at 192 and 256
//   bsa_dq_wgmma_kernel         dQ: block-sparse at 64..256, flash at
//                               192 and 256
//   bsa_dkv_split_wgmma_kernel  dK/dV at 192 and 256, both families: a
//                               64-row block whose two warpgroups split
//                               the products by role
//   bsa_fwd_dsplit_wgmma_kernel the forward at 320..512, both families: a
//                               64-row block whose two warpgroups split D
//   bsa_dq_dsplit_wgmma_kernel  dQ at 320..512, both families: the same
//                               split
//   bsa_dkv_dsplit_wgmma_kernel dK/dV at 320..512, both families: two
//                               blocks split D, each with the two roles
//
// A block owns a 128-row tile (q rows in the forward and dQ, kv rows in
// dK/dV; 64 rows in the split and D-split kernels) and is two consumer
// warpgroups of 64 of its rows each (of all 64, split by role or by D, in
// those); the other side's tiles (64 rows; 32 in the D-split backward
// past D 320) stream through a ring of shared-memory stages, loaded by
// TMA (hopper_tiles.cuh's layout contract: 128-byte swizzle, column
// blocks of 64). Every product is wgmma: operands in shared memory, or p
// / ds re-packed from accumulators as register A fragments (rounded to
// bf16, as the reference casts them). These are the bf16 kernels: fp32
// past D 128 runs the 3xTF32 forward and dK/dV of attention_tf32.cuh and
// the FMA dQ of wide_attention.cuh.
#pragma once

#include "attention_tiles.cuh"
#include "hopper_tiles.cuh"

namespace {

constexpr int kWgRows = 64;                  // rows a consumer warpgroup owns
constexpr int kWgBlock = 2 * kWgRows;        // rows a block owns
constexpr int kConsumerThreads = 2 * 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kDkvStages = 3;                // q/dO/lse/delta ring of dK/dV
constexpr int kDqStages = 4;                 // K/V ring of dQ

template <int D>
__host__ __device__ constexpr int tile_bytes(int rows) {
  return rows * D * 2;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Accumulator chunks v[2 kk], v[2 kk + 1] (8 columns each) as the bf16 A
// fragment of the 16-deep step kk.
template <int NT>
__device__ __forceinline__ void to_a_frags(uint32_t (&pa)[NT / 2][4],
                                           const float (&v)[NT][4]) {
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    pa[kk][0] = pack_bf16(v[2 * kk][0], v[2 * kk][1]);
    pa[kk][1] = pack_bf16(v[2 * kk][2], v[2 * kk][3]);
    pa[kk][2] = pack_bf16(v[2 * kk + 1][0], v[2 * kk + 1][1]);
    pa[kk][3] = pack_bf16(v[2 * kk + 1][2], v[2 * kk + 1][3]);
  }
}

template <int D>
constexpr size_t dkv_wgmma_smem() {
  return 1024 + 2 * tile_bytes<D>(kWgBlock) +
         kDkvStages * (2 * tile_bytes<D>(kTile) + 2 * kTile * 4) +
         (1 + 2 * kDkvStages) * 8;
}

template <int D>
constexpr size_t dq_wgmma_smem() {
  return 1024 + 2 * tile_bytes<D>(kWgBlock) +
         2 * kDqStages * tile_bytes<D>(kTile) + (1 + 2 * kDqStages) * 8;
}

// A wait for nothing: the tile's V is in shared memory before its S.
struct NoWait {
  __device__ void operator()() const {}
};

// One kv tile (K at k_base, V at v_base, 64 rows each) against the
// warpgroup's 64 q rows (at q_base in a Q tile of QRows rows, D deep):
// the online softmax, with S = Q K^T and O += P V as wgmma. O holds N
// columns of the output, V's from v_base: all D, or a warpgroup's share
// where two split D. after_s() runs once S is in registers (a caller
// whose K and V are apart releases K there), before_pv() once p is ready
// and before P V (such a caller waits for V there).
template <int D, int N = D, int QRows = kWgBlock, typename AfterS = NoWait,
          typename BeforePV = NoWait>
__device__ __forceinline__ void fwd_tile_wgmma(
    float (&o)[N / 8][4], float (&m)[2], float (&l)[2], uint32_t q_base,
    uint32_t k_base, uint32_t v_base, const int (&rows)[2], int c0,
    bool mask, int offset, float scale, const Dropout& drop, uint32_t key,
    const AfterS& after_s = AfterS{}, const BeforePV& before_pv = BeforePV{}) {
  const int tig = threadIdx.x % 4;
  float s[kTile / 8][4] = {};
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<kTile>(s, kmajor_desc(q_base, kk, QRows),
                    kmajor_desc(k_base, kk, kTile), kk > 0);
  wg_commit();
  wg_wait<0>();
  wg_fence_regs(s);
  after_s();
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = c0 + j * 8 + 2 * tig + (e & 1);
      float x = s[j][e] * scale;
      if (mask && rows[e >> 1] + offset < col) x = -INFINITY;
      s[j][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  // exp(x - m) as exp2(x log2(e) - m log2(e)): one FFMA and one MUFU op
  float alpha[2], m_log2[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m_new = fmaxf(m[h], quad_max(mx[h]));
    const float m_use = safe_max(m_new);
    m_log2[h] = m_use * kLog2e;
    alpha[h] = exp2f((m[h] - m_use) * kLog2e);  // exactly 1 if m is kept
    m[h] = m_new;
  }
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(fmaf(s[j][e], kLog2e, -m_log2[e >> 1]));
      rs[e >> 1] += p;
      float pd = p;
      if (drop.on) {
        const uint32_t bits = dropout_bits(key, rows[e >> 1],
                                           c0 + j * 8 + 2 * tig + (e & 1));
        pd = bits >= drop.threshold ? p / drop.keep_div : 0.f;
      }
      s[j][e] = pd;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = alpha[h] * l[h] + quad_sum(rs[h]);
  // the running max moves less and less along a row: rescale only when a
  // row of the warp has a new one
  if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f))
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];
  uint32_t pa[kTile / 16][4];
  to_a_frags<kTile / 8>(pa, s);  // p rounded to bf16, as the reference
  before_pv();
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk)
    wgmma_rs_t<N>(o, pa[kk], mnmajor_desc(v_base, kk, kTile));
  wg_commit();
  wg_wait<0>();
  wg_fence_regs(o);
}

// One kv tile (K at k_base, V at v_base, R rows each) against the
// warpgroup's 64 q rows rows[h] (Q, dO at q_base, do_base in the block's
// tiles of QRows rows; lse_l2 = lse log2(e) and delta of the rows): S =
// Q K^T and dP = dO V^T, committed apart so that p is computed while dP
// runs, then dq += ds K, as attention_tiles.cuh's dq_tile. dq holds N
// columns of the output, K's from column block own0: all D, or a
// warpgroup's share where two split D. wait_v() runs once S is issued and
// before dP: a caller whose V tile comes in after its K waits for it
// there.
template <int D, int N = D, int R = kTile, int QRows = kWgBlock,
          typename WaitV = NoWait>
__device__ __forceinline__ void dq_tile_wgmma(
    float (&dq)[N / 8][4], uint32_t q_base, uint32_t do_base,
    uint32_t k_base, uint32_t v_base, const int (&rows)[2],
    const float (&lse_l2)[2], const float (&dl)[2], int c0, bool mask,
    int offset, float scale, const Dropout& drop, uint32_t key,
    const WaitV& wait_v = WaitV{}, int own0 = 0) {
  const int tig = threadIdx.x % 4;
  const float scale_log2 = scale * kLog2e;  // exp(x) = exp2(x log2(e))
  float s[R / 8][4] = {}, dp[R / 8][4] = {};
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<R>(s, kmajor_desc(q_base, kk, QRows),
                kmajor_desc(k_base, kk, R), kk > 0);
  wg_commit();
  wait_v();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<R>(dp, kmajor_desc(do_base, kk, QRows),
                kmajor_desc(v_base, kk, R), kk > 0);
  wg_commit();
  // p while dP is still in the tensor cores
  wg_wait<1>();
  wg_fence_regs(s);
#pragma unroll
  for (int j = 0; j < R / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1, col = c0 + j * 8 + 2 * tig + (e & 1);
      const bool masked = mask && rows[h] + offset < col;
      s[j][e] =
          masked ? 0.f : exp2f(fmaf(s[j][e], scale_log2, -lse_l2[h]));
    }
  wg_wait<0>();
  wg_fence_regs(dp);
#pragma unroll
  for (int j = 0; j < R / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1, col = c0 + j * 8 + 2 * tig + (e & 1);
      float dpv = dp[j][e];
      if (drop.on) {
        const uint32_t bits = dropout_bits(key, rows[h], col);
        dpv = bits >= drop.threshold ? dpv / drop.keep_div : 0.f;
      }
      s[j][e] = s[j][e] * (dpv - dl[h]) * scale;  // ds
    }
  uint32_t da[R / 16][4];
  to_a_frags<R / 8>(da, s);  // rounded to bf16, as the reference
  const uint32_t k_own = k_base + own0 * R * 128;
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < R / 16; ++kk)
    wgmma_rs_t<N>(dq, da[kk], mnmajor_desc(k_own, kk, R));
  wg_commit();
  wg_wait<0>();
  wg_fence_regs(dq);
}

// One 64-row q tile (Q, dO at q_base, do_base; its lse and delta in
// shared memory) against the warpgroup's 64 kv rows cols[h] (K, V at
// k_base, v_base in the block's 128-row tiles): S^T = K Q^T and
// dP^T = V dO^T, then dv += p_drop^T dO and dk += ds^T Q, as
// attention_tiles.cuh's dkv_tile.
template <int D>
__device__ __forceinline__ void dkv_tile_wgmma(
    float (&dk_acc)[D / 8][4], float (&dv_acc)[D / 8][4], uint32_t k_base,
    uint32_t v_base, uint32_t q_base, uint32_t do_base, const float* lse_t,
    const float* dl_t, const int (&cols)[2], int r0, bool mask, int offset,
    float scale, const Dropout& drop, uint32_t key) {
  const int tig = threadIdx.x % 4;
  const float scale_log2 = scale * kLog2e;  // exp(x) = exp2(x log2(e))
  float st[kTile / 8][4] = {}, dpt[kTile / 8][4] = {};
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<kTile>(st, kmajor_desc(k_base, kk, kWgBlock),
                    kmajor_desc(q_base, kk, kTile), kk > 0);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<kTile>(dpt, kmajor_desc(v_base, kk, kWgBlock),
                    kmajor_desc(do_base, kk, kTile), kk > 0);
  wg_commit();
  wg_wait<0>();
  wg_fence_regs(st);
  wg_fence_regs(dpt);
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rl = j * 8 + 2 * tig + (e & 1), row = r0 + rl;
      const int col = cols[e >> 1];
      const bool masked = mask && row + offset < col;
      const float p =
          masked ? 0.f
                 : exp2f(fmaf(st[j][e], scale_log2, -lse_t[rl] * kLog2e));
      float p_drop = p, dpv = dpt[j][e];
      if (drop.on) {
        const bool keep = dropout_bits(key, row, col) >= drop.threshold;
        p_drop = keep ? p * drop.keep_inv : 0.f;
        dpv = keep ? dpv * drop.keep_inv : 0.f;
      }
      dpt[j][e] = p * (dpv - dl_t[rl]) * scale;  // ds^T
      st[j][e] = p_drop;
    }
  uint32_t pa[kTile / 16][4], da[kTile / 16][4];
  to_a_frags<kTile / 8>(pa, st);  // rounded to bf16, as the reference
  to_a_frags<kTile / 8>(da, dpt);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk)
    wgmma_rs_t<D>(dv_acc, pa[kk], mnmajor_desc(do_base, kk, kTile));
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk)
    wgmma_rs_t<D>(dk_acc, da[kk], mnmajor_desc(q_base, kk, kTile));
  wg_commit();
  wg_wait<0>();
  wg_fence_regs(dv_acc);
  wg_fence_regs(dk_acc);
}

// ------------------------------------------- the forward over a BlockList
//
// bsa_fwd_wgmma_kernel replaces _bsa_fwd_kernel
// (paddle_tpu/ops/pallas/block_sparse_attention.py:92, pallas_call :146)
// in bf16 at padded D 64..256, and _fa_fwd_kernel
// (paddle_tpu/ops/pallas/flash_attention.py:162, pallas_call :230) in
// bf16 at padded D 192 and 256. Both compute O = softmax(Q K^T scale) V
// and lse = m + log(l) over a list of kv tiles, which is all this kernel
// needs to know of either family.
//
// A block owns 128 q rows, two consumer warpgroups of 64, and no
// producer warpgroup: a 384-thread block launches at 168 registers a
// thread, and at D 256 the output accumulator alone is 128. The Q tile is
// loaded once by TMA; K and V come through a ring of mbarrier stages (4
// at D <= 128, 3 at 192, 2 at 256: what 227 KB holds beside Q), kept in
// flight by a producer warp at D 128 and by thread 0 of the consumers
// elsewhere (fwd_list_producer_warp says why). Walk step t is the t-th
// 64-row kv tile of the listed blocks, in list order (ListWalk); under
// causal the tiles wholly above the block's diagonal are a suffix of the
// ascending walk and are cut before anything is loaded.
// A warpgroup skips the work (not the barriers) of a tile wholly above
// its own diagonal and masks only tiles that cross it. out goes through
// the warpgroup's rows of the Q tile and one TMA store; lse per row. A
// row that sees no column writes 0 and lse -inf.
//
// Two walks: a block-sparse BlockList (idx set; 128-multiple blocks, so a
// block's rows lie in one logical block), whose blocks launch heaviest
// list first (wg_block_row over L.order; every batch-head of a logical
// block side by side on x), or flash's dense_list (idx null: one entry of
// sk rows), whose grid is fa_fwd_wgmma_kernel's: a batch-head's q blocks
// together (its K and V then come from L2 about once), the last (the most
// tiles under causal) first. Flash lengths are 64-multiples, so the last
// block's second warpgroup may own no row (live false: it keeps the ring
// turning and writes nothing). Flash's dropout enters through
// fwd_tile_wgmma, as in fa_fwd_wgmma_kernel.
//
// Bound on the H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): 4 D FLOP a
// (q, k) pair over the active pairs; at the block-sparse path's shape
// (BH 32, S 4096, D 128, BigBird's 227 active block pairs a head) 60.9
// GFLOP against 135 MB, 0.062 ms by operations.

// The heaviest-first logical block a thread block works on, and its
// first row: blockIdx.y walks L.order, L.blk_own / kWgBlock thread blocks
// a logical block.
__device__ __forceinline__ int wg_block_row(const BlockList& L, int& blk) {
  const int per = L.blk_own / kWgBlock;
  blk = L.order[blockIdx.y / per];
  return blk * L.blk_own + (blockIdx.y % per) * kWgBlock;
}

// K + V stages of the forward's ring: as many as the 227 KB a block may
// take hold beside the 128-row Q tile (16 KB D / 64), up to 4.
template <int D>
__host__ __device__ constexpr int fwd_list_stages() {
  return D <= 128 ? 4 : D == 192 ? 3 : 2;
}

template <int D>
constexpr size_t fwd_list_wgmma_smem() {
  return 1024 + tile_bytes<D>(kWgBlock) +
         2 * fwd_list_stages<D>() * tile_bytes<D>(kTile) +
         (1 + 2 * fwd_list_stages<D>()) * 8;
}

// Who keeps the K/V ring in flight: at D 128 a producer warp beside the
// two consumer warpgroups; elsewhere thread 0 of the consumers. Thread 0
// refills a stage once both warpgroups have released it, which holds
// each within a tile of the other; the warp lets them drift, and on an
// H100 at the block-sparse path's shape (BigBird, BH 32, S 4096) it
// takes D 128 from about 0.245 to 0.20 ms (one 160 KB block an SM
// either way). At D 64 a block of eight warps (80 KB, 119 registers a
// thread) fits twice on an SM, which a ninth warp prevents (registers go
// to an SM's quarters by warp): 0.13 against 0.18 ms. At D 192 and 256
// ptxas holds a nine-warp block to 168 registers a thread, and the
// accumulators need over 200.
template <int D>
__host__ __device__ constexpr bool fwd_list_producer_warp() {
  return D == 128;
}
template <int D>
__host__ __device__ constexpr int fwd_list_threads() {
  return kConsumerThreads + (fwd_list_producer_warp<D>() ? 32 : 0);
}

// The walk's 64-row kv tiles in order (attention_tiles.cuh).
using ListWalk = TileWalk<kTile>;

template <int D>
__global__ void __launch_bounds__(fwd_list_threads<D>(), 1)
bsa_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_out,
                     float* __restrict__ lse, BlockList L, int sq, int sk,
                     int causal, float scale, Dropout drop) {
  constexpr int kStages = fwd_list_stages<D>();
  constexpr bool kWarp = fwd_list_producer_warp<D>();
  constexpr int kQBytes = tile_bytes<D>(kWgBlock);
  constexpr int kKvBytes = tile_bytes<D>(kTile);
  extern __shared__ unsigned char wg_smem[];
  unsigned char* qs = align_1024(wg_smem);
  unsigned char* ks = qs + kQBytes;             // [kStages] K tiles
  unsigned char* vs = ks + kStages * kKvBytes;  // [kStages] V tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + kStages * kKvBytes);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  int bh, blk = 0, q0;
  if (L.idx == nullptr) {  // flash's dense walk
    bh = blockIdx.y;
    q0 = (gridDim.x - 1 - blockIdx.x) * kWgBlock;
  } else {
    bh = blockIdx.x;
    q0 = wg_block_row(L, blk);
  }
  const int offset = sk - sq;
  const int n = list_len(L, blk), per_entry = L.blk_other / kTile;
  const int n_t = n * per_entry;
  // Whether step t (walk w standing at it) is one of the block's tiles.
  // Under causal the walk ends at the first tile wholly above the
  // block's diagonal (past its last row's last column), never loaded;
  // lists ascend, so the rest lie above it too. Each role decides this
  // as it goes: no pass over the list comes before the first load.
  const int last_col = min(q0 + kWgBlock, sq) - 1 + offset;
  const auto in_walk = [&](int t, const ListWalk& w) {
    return t < n_t && !(causal && w.col() > last_col);
  };
  // kv tile t of the walk (at c0) into its stage: K and V
  const auto load = [&](int t, int c0) {
    const int s = t % kStages;
    mbar_expect_tx(&full[s], 2 * kKvBytes);
#pragma unroll
    for (int cb = 0; cb < D / 64; ++cb) {
      tma_load_3d(ks + s * kKvBytes + cb * kTile * 128, &tm_k, &full[s],
                  cb * 64, c0, bh);
      tma_load_3d(vs + s * kKvBytes + cb * kTile * 128, &tm_v, &full[s],
                  cb * 64, c0, bh);
    }
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerThreads);
    }
    mbar_fence_init();
    mbar_expect_tx(q_full, kQBytes);
#pragma unroll
    for (int cb = 0; cb < D / 64; ++cb)
      tma_load_3d(qs + cb * kWgBlock * 128, &tm_q, q_full, cb * 64, q0, bh);
  }
  __syncthreads();
  if (kWarp && threadIdx.x >= kConsumerThreads) {
    if (threadIdx.x == kConsumerThreads) {  // the producer warp's lane 0
      ListWalk w(L, blk);
      for (int t = 0; in_walk(t, w); ++t, w.next()) {
        if (t >= kStages)
          mbar_wait(&empty[t % kStages], (t / kStages - 1) & 1);
        load(t, w.col());
      }
    }
    return;
  }
  // Without a producer warp, thread 0 fills the ring, then refills the
  // stage of each tile it releases with the tile kStages further on, once
  // both warpgroups have released it.
  ListWalk ahead(L, blk);
  int n_ahead = 0;  // tiles thread 0 has loaded
  if (!kWarp && threadIdx.x == 0)
    for (; n_ahead < kStages && in_walk(n_ahead, ahead); ++n_ahead) {
      load(n_ahead, ahead.col());
      ahead.next();
    }
  const auto release = [&](int t) {
    const int s = t % kStages;
    mbar_arrive(&empty[s]);
    if (!kWarp && threadIdx.x == 0 && n_ahead == t + kStages &&
        in_walk(n_ahead, ahead)) {
      mbar_wait(&empty[s], (t / kStages) & 1);
      load(n_ahead++, ahead.col());
      ahead.next();
    }
  };

  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int g = (threadIdx.x % 32) / 4, tig = threadIdx.x % 4;
  const int row0 = q0 + wg * kWgRows;
  const bool live = row0 < sq;
  const int rows[2] = {row0 + warp * 16 + g, row0 + warp * 16 + g + 8};
  const uint32_t q_base = smem_u32(qs) + wg * kWgRows * 128;
  const uint32_t key = dropout_key(drop, bh);
  float o[D / 8][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  // also with nothing to walk: the epilogue reuses the Q tile
  if (live) mbar_wait(q_full, 0);
  ListWalk w(L, blk);
  for (int t = 0; in_walk(t, w); ++t, w.next()) {
    const int st = t % kStages, c0 = w.col();
    mbar_wait(&full[st], (t / kStages) & 1);
    if (live && !(causal && c0 > row0 + kWgRows - 1 + offset))
      fwd_tile_wgmma<D>(o, m, l, q_base, smem_u32(ks + st * kKvBytes),
                        smem_u32(vs + st * kKvBytes), rows, c0,
                        causal && c0 + kTile - 1 > row0 + offset, offset,
                        scale, drop, key);
    release(t);
  }
  if (live) {
    // out through the warpgroup's rows of the Q tile, which it no longer
    // reads, and one TMA store: whole 128-byte lines to HBM
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) inv[h] = l[h] > 0.f ? 1.f / l[h] : 0.f;
    stage_acc_bf16<D>(qs, kWgBlock, wg * kWgRows, o, inv);
    fence_async_shared();
    named_barrier(1 + wg, 128);
    if (threadIdx.x % 128 == 0) {
#pragma unroll
      for (int cb = 0; cb < D / 64; ++cb)
        tma_store_3d(&tm_out, qs + (cb * kWgBlock + wg * kWgRows) * 128,
                     cb * 64, row0, bh);
      tma_store_drain();
    }
    if (tig == 0)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        lse[(size_t)bh * sq + rows[h]] =
            l[h] > 0.f ? m[h] + logf(l[h]) : -INFINITY;
  }
}

// A block-sparse list (block sizes 128-multiples that tile both
// sequences, L.order set) or dense_list(sk) (lengths 64-multiples).
template <int D>
cudaError_t launch_bsa_fwd_wgmma(const void* q, const void* k, const void* v,
                                 void* out, void* lse, BlockList L, int bh,
                                 int sq, int sk, int causal, float scale,
                                 Dropout drop, cudaStream_t st) {
  CUtensorMap tq, tk, tv, tout;
  cudaError_t err = bf16_map(&tq, q, bh, sq, D, kWgBlock);
  if (err == cudaSuccess) err = bf16_map(&tk, k, bh, sk, D, kTile);
  if (err == cudaSuccess) err = bf16_map(&tv, v, bh, sk, D, kTile);
  if (err == cudaSuccess) err = bf16_map(&tout, out, bh, sq, D, kWgRows);
  if (err != cudaSuccess) return err;
  auto kernel = bsa_fwd_wgmma_kernel<D>;
  err = set_smem(kernel, fwd_list_wgmma_smem<D>());
  if (err != cudaSuccess) return err;
  const dim3 grid = L.idx == nullptr
                        ? dim3((sq + kWgBlock - 1) / kWgBlock, bh)
                        : dim3(bh, sq / kWgBlock);
  kernel<<<grid, fwd_list_threads<D>(), fwd_list_wgmma_smem<D>(),
           st>>>(
      tq, tk, tv, tout, static_cast<float*>(lse), L, sq, sk, causal, scale,
      drop);
  return cudaGetLastError();
}

// ------------------- the forward past D 256: D split across warpgroups
//
// bsa_fwd_dsplit_wgmma_kernel replaces _bsa_fwd_kernel
// (paddle_tpu/ops/pallas/block_sparse_attention.py:92, pallas_call :146)
// and _fa_fwd_kernel (paddle_tpu/ops/pallas/flash_attention.py:162,
// pallas_call :230) in bf16 at padded D 320, 384, 448 and 512: O =
// softmax(Q K^T scale) V and lse over a list of kv tiles, as
// bsa_fwd_wgmma_kernel computes them at D <= 256 (the causal offset sk -
// sq, flash's dropout keep bits, p rounded to bf16 before P V, 0 and lse
// -inf for a row that sees no column).
//
// Why not that kernel: a warpgroup there owns 64 q rows with a full-D fp32
// accumulator, D / 2 registers a thread (256 at D 512), and a block's
// 128-row Q tile is 128 KB at D 512. Here a block owns 64 q rows and two
// consumer warpgroups that split D: warpgroup 0 owns the first
// ceil(D / 128) 64-column blocks of the output, warpgroup 1 the rest (at
// D 320 3 and 2, at 448 4 and 3), an accumulator of at most 128
// registers a thread. Per kv tile each warpgroup computes all of S = Q
// K^T itself (the same wgmma steps on the same tiles: both hold the same
// bits, so the same m, l and p) and runs P V against its own column
// blocks of V (fwd_tile_wgmma at width 64 kOwn). That is 1.5x the tile's
// products of a split of S's depth whose two partials meet in shared
// memory, but the warpgroups never wait for each other and the ring gets
// the 32 KB the partials would take; on an H100 the split read as fast or
// slower.
//
// Shared memory: the 64 x D Q tile (40..64 KB), loaded once by TMA; K and
// V as ring items of their own (K of walk step t is item 2t, V item
// 2t + 1), as many slots as 227 KB hold beside Q, up to 4 (4 at D 320, 3
// at 384 and 448, 2 at 512); thread 0 refills a slot once both
// warpgroups have released it: K right after S, V after P V. The walk
// is bsa_fwd_wgmma_kernel's (ListWalk; under causal it stops at the first
// tile wholly above the block's diagonal, never loaded). Blocks launch
// heaviest first, every batch-head side by side on x: block-sparse by
// L.order, flash's dense walk its last 64 q rows first (one 64-row block
// an SM: an order by batch-head would leave the longest walks of the last
// batch-heads to the end).
//
// Bound on the H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): 4 D FLOP a
// (q, k) pair over the active pairs, and q, k, v, out once: at flash BH
// 16, S 1024, D 512, causal 17.2 GFLOP (0.017 ms) against 67 MB (0.020
// ms, the bound).

template <int D>
__host__ __device__ constexpr size_t fwd_dsplit_smem_at(int slots) {
  return 1024 + (1 + slots) * tile_bytes<D>(kTile) + (1 + 2 * slots) * 8;
}
template <int D>
__host__ __device__ constexpr int fwd_dsplit_slots() {
  return fwd_dsplit_smem_at<D>(4) <= 232448   ? 4
         : fwd_dsplit_smem_at<D>(3) <= 232448 ? 3
                                              : 2;
}
template <int D>
constexpr size_t fwd_dsplit_smem() {
  return fwd_dsplit_smem_at<D>(fwd_dsplit_slots<D>());
}
static_assert(fwd_dsplit_smem<320>() <= 232448 &&
                  fwd_dsplit_smem<384>() <= 232448 &&
                  fwd_dsplit_smem<448>() <= 232448 &&
                  fwd_dsplit_smem<512>() <= 232448,
              "a block asks for more than 227 KB of shared memory");

template <int D>
__global__ void __launch_bounds__(kConsumerThreads, 1)
bsa_fwd_dsplit_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_out,
                            float* __restrict__ lse, BlockList L, int sq,
                            int sk, int causal, float scale, Dropout drop) {
  constexpr int kBlocks = D / 64;           // column blocks of a tile
  constexpr int kOwn0 = (kBlocks + 1) / 2;  // warpgroup 0's; 1 owns the rest
  constexpr int kSlots = fwd_dsplit_slots<D>();
  constexpr int kTileBytes = tile_bytes<D>(kTile);
  constexpr int kColBytes = kTile * 128;  // one column block of a tile
  constexpr int kQRead = 1;  // named barrier: neither warpgroup reads Q
  extern __shared__ unsigned char wg_smem[];
  unsigned char* qs = align_1024(wg_smem);
  unsigned char* kvs = qs + kTileBytes;  // [kSlots] K or V tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(kvs + kSlots * kTileBytes);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kSlots;

  const int bh = blockIdx.x;
  int blk = 0, q0;
  if (L.idx == nullptr) {  // flash's dense walk: the last q rows first
    q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  } else {
    const int per = L.blk_own / kTile;
    blk = L.order[blockIdx.y / per];
    q0 = blk * L.blk_own + (blockIdx.y % per) * kTile;
  }
  const int offset = sk - sq;
  const int n_t = list_len(L, blk) * (L.blk_other / kTile);
  const int last_col = q0 + kTile - 1 + offset;
  // whether walk step t (walk w standing at it) is one of the block's
  // tiles: under causal the walk ends at the first tile past the block's
  // last column; lists ascend, so the rest lie past it too
  const auto in_walk = [&](int t, const ListWalk& w) {
    return t < n_t && !(causal && w.col() > last_col);
  };
  // thread 0's loads: ring item n_ld, K (even) or V (odd) of the walk
  // step `ahead` stands at
  ListWalk ahead(L, blk);
  int n_ld = 0;
  const auto can_load = [&] { return in_walk(n_ld / 2, ahead); };
  const auto load_next = [&] {
    const int s = n_ld % kSlots;
    mbar_expect_tx(&full[s], kTileBytes);
#pragma unroll
    for (int cb = 0; cb < kBlocks; ++cb)
      tma_load_3d(kvs + s * kTileBytes + cb * kColBytes,
                  n_ld % 2 ? &tm_v : &tm_k, &full[s], cb * 64, ahead.col(),
                  bh);
    if (n_ld++ % 2) ahead.next();
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerThreads);
    }
    mbar_fence_init();
    mbar_expect_tx(q_full, kTileBytes);
#pragma unroll
    for (int cb = 0; cb < kBlocks; ++cb)
      tma_load_3d(qs + cb * kColBytes, &tm_q, q_full, cb * 64, q0, bh);
    while (n_ld < kSlots && can_load()) load_next();
  }
  __syncthreads();
  // both warpgroups are done with item j; thread 0 refills its slot with
  // item j + kSlots
  const auto release = [&](int j) {
    const int s = j % kSlots;
    mbar_arrive(&empty[s]);
    if (threadIdx.x == 0 && n_ld == j + kSlots && can_load()) {
      mbar_wait(&empty[s], (j / kSlots) & 1);
      load_next();
    }
  };

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, g = (tid % 32) / 4, tig = tid % 4;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const uint32_t q_base = smem_u32(qs);
  const uint32_t key = dropout_key(drop, bh);
  // also with nothing to walk: the epilogue reuses the Q tile
  mbar_wait(q_full, 0);
  // one warpgroup's walk over kOwn column blocks of the output
  const auto consume = [&](auto own) {
    constexpr int kOwn = decltype(own)::value;
    const int v_blk = wg == 0 ? 0 : kOwn0;  // the first block it owns
    float o[kOwn * 8][4] = {};
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    ListWalk w(L, blk);
    for (int t = 0; in_walk(t, w); ++t, w.next()) {
      const int c0 = w.col(), jk = 2 * t, jv = jk + 1;
      mbar_wait(&full[jk % kSlots], (jk / kSlots) & 1);
      const uint32_t v_base =
          smem_u32(kvs + (jv % kSlots) * kTileBytes + v_blk * kColBytes);
      fwd_tile_wgmma<D, kOwn * 64, kTile>(
          o, m, l, q_base, smem_u32(kvs + (jk % kSlots) * kTileBytes),
          v_base, rows, c0, causal && c0 + kTile - 1 > q0 + offset, offset,
          scale, drop, key, [&] { release(jk); },
          [&] { mbar_wait(&full[jv % kSlots], (jv / kSlots) & 1); });
      release(jv);
    }
    // out through the warpgroup's column blocks of the Q tile, once
    // neither warpgroup reads Q, and one TMA store a block
    named_barrier(kQRead, kConsumerThreads);
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) inv[h] = l[h] > 0.f ? 1.f / l[h] : 0.f;
    stage_acc_bf16<kOwn * 64>(qs + v_blk * kColBytes, kTile, 0, o, inv);
    fence_async_shared();
    named_barrier(3 + wg, 128);
    if (tid == 0) {
#pragma unroll
      for (int cb = 0; cb < kOwn; ++cb)
        tma_store_3d(&tm_out, qs + (v_blk + cb) * kColBytes,
                     (v_blk + cb) * 64, q0, bh);
      tma_store_drain();
    }
    if (wg == 0 && tig == 0)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        lse[(size_t)bh * sq + rows[h]] =
            l[h] > 0.f ? m[h] + logf(l[h]) : -INFINITY;
  };
  if (wg == 0)
    consume(IntC<kOwn0>{});
  else
    consume(IntC<kBlocks - kOwn0>{});
}

template <int D>
cudaError_t launch_fwd_dsplit_wgmma_at(const void* q, const void* k,
                                       const void* v, void* out, void* lse,
                                       BlockList L, int bh, int sq, int sk,
                                       int causal, float scale, Dropout drop,
                                       cudaStream_t st) {
  CUtensorMap tq, tk, tv, tout;
  cudaError_t err = bf16_map(&tq, q, bh, sq, D, kTile);
  if (err == cudaSuccess) err = bf16_map(&tk, k, bh, sk, D, kTile);
  if (err == cudaSuccess) err = bf16_map(&tv, v, bh, sk, D, kTile);
  if (err == cudaSuccess) err = bf16_map(&tout, out, bh, sq, D, kTile);
  if (err != cudaSuccess) return err;
  auto kernel = bsa_fwd_dsplit_wgmma_kernel<D>;
  err = set_smem(kernel, fwd_dsplit_smem<D>());
  if (err != cudaSuccess) return err;
  kernel<<<dim3(bh, sq / kTile), kConsumerThreads, fwd_dsplit_smem<D>(),
           st>>>(tq, tk, tv, tout, static_cast<float*>(lse), L, sq, sk,
                 causal, scale, drop);
  return cudaGetLastError();
}

// The bf16 forward at padded head dim d 320, 384, 448 or 512 over a
// block-sparse list (block sizes 128-multiples that tile both sequences,
// L.order set) or dense_list(sk) (lengths 64-multiples); any other d is
// refused.
inline cudaError_t launch_fwd_dsplit_wgmma(int d, const void* q,
                                           const void* k, const void* v,
                                           void* out, void* lse, BlockList L,
                                           int bh, int sq, int sk, int causal,
                                           float scale, Dropout drop,
                                           cudaStream_t st) {
  return head_dim_from<320>(d, [&](auto dc) {
    return launch_fwd_dsplit_wgmma_at<decltype(dc)::value>(
        q, k, v, out, lse, L, bh, sq, sk, causal, scale, drop, st);
  });
}

// ------------------------------------------------- dQ over a BlockList
//
// bsa_dq_wgmma_kernel replaces _bsa_dq_kernel
// (paddle_tpu/ops/pallas/block_sparse_attention.py:182, pallas_call :271)
// in bf16 at padded D 64..256, and _fa_dq_kernel
// (paddle_tpu/ops/pallas/flash_attention.py:277, pallas_call :380) in
// bf16 at padded D 192 and 256: p recomputed from lse, ds = p (dp_drop -
// delta) scale, dq += ds K over a list of kv tiles (dq_tile_wgmma).
//
// The forward's block and walks (bsa_fwd_wgmma_kernel): 128 q rows, two
// consumer warpgroups of 64, each with a full-D fp32 dQ accumulator (D / 8
// x 4 registers a thread: 128 at D 256); Q and dO loaded once by TMA;
// blocks launched heaviest list first, or in flash's dense grid. No
// producer warp: thread 0 keeps the K/V ring in flight, refilling the
// slots of a tile once both warpgroups have released it, one tile after
// its own release. Under causal the kv tiles wholly above the block's
// diagonal are a suffix of the walk, counted from the list and never
// loaded.
//
// The ring: at D <= 128 kDqStages stages, each a K and a V tile under one
// barrier pair. Past 128, Q and dO take 96 KB (D 192) or 128 KB (D 256)
// of the 227, and a K + V stage 48 or 64 KB, so K and V are items of
// their own, each with its barrier pair: K of kv tile t is item 2t, V item
// 2t + 1, in slot item % slots (5 at D 192, 3 at D 256). Three slots at
// D 256 keep the next tile's K in flight while a tile runs, and a tile's
// V comes in while its S is computed (dq_tile_wgmma's wait_v); with two,
// one K + V stage, both come in after the previous tile.
//
// The walk is chosen at compile time: kDense for flash's dense walk
// (L.idx null; kDropout for a call with dropout), else a block-sparse
// list, whose instantiation is the block-sparse dQ kernel as it was
// before flash shared it (a list pointer, every row live, no dropout).
// Checked at run time instead, the walk and the dropout held block-sparse
// D 128 14-34% slower than that kernel on an H100.
template <int D>
__host__ __device__ constexpr int dq_list_items() {  // ring items a tile
  return D <= 128 ? 1 : 2;
}
template <int D>
__host__ __device__ constexpr int dq_list_slots() {
  return D <= 128 ? kDqStages : D == 192 ? 5 : 3;
}
template <int D>
constexpr size_t dq_list_wgmma_smem() {
  return 1024 + 2 * tile_bytes<D>(kWgBlock) +
         dq_list_slots<D>() * (3 - dq_list_items<D>()) * tile_bytes<D>(kTile) +
         (1 + 2 * dq_list_slots<D>()) * 8;
}

template <int D, bool kDense, bool kDropout>
__global__ void __launch_bounds__(kConsumerThreads, 1)
bsa_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_dq,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, BlockList L, int sq,
                    int sk, int causal, float scale, Dropout drop) {
  constexpr int kItems = dq_list_items<D>();
  constexpr int kSlots = dq_list_slots<D>();
  constexpr int kQBytes = tile_bytes<D>(kWgBlock);
  constexpr int kKvBytes = tile_bytes<D>(kTile);
  constexpr int kSlotBytes = (3 - kItems) * kKvBytes;
  extern __shared__ unsigned char wg_smem[];
  unsigned char* qs = align_1024(wg_smem);
  unsigned char* dos = qs + kQBytes;
  unsigned char* kvs = dos + kQBytes;  // [kSlots]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(kvs + kSlots * kSlotBytes);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kSlots;

  // flash's grid is the forward's: a batch-head's q blocks side by side,
  // the last first
  int blk = 0;
  const int bh = kDense ? blockIdx.y : blockIdx.x;
  const int q0 = kDense ? (gridDim.x - 1 - blockIdx.x) * kWgBlock
                        : wg_block_row(L, blk);
  const int* list = kDense ? nullptr : L.idx + blk * L.width;
  const int offset = sk - sq;
  const int n = kDense ? 1 : L.count[blk], per_entry = L.blk_other / kTile;
  const auto entry_row = [&](int a) {
    return kDense ? 0 : list[a] * L.blk_other;
  };
  // kv tiles wholly above the block's diagonal (past its last row's last
  // column) are never loaded: a suffix of the ascending walk
  int n_t = n * per_entry;
  if (causal) {
    const int last_col = min(q0 + kWgBlock, sq) - 1 + offset;
    n_t = 0;
    for (int a = 0; a < n && entry_row(a) <= last_col; ++a)
      n_t += min(per_entry, (last_col - entry_row(a)) / kTile + 1);
  }
  const int n_items = n_t * kItems;
  const auto col_of = [&](int t) {
    return entry_row(t / per_entry) + (t % per_entry) * kTile;
  };
  // ring item j into its slot: K and V of kv tile j, or past D 128 K (j
  // even) or V (j odd) of kv tile j / 2
  const auto load = [&](int j) {
    const int s = j % kSlots, c0 = col_of(j / kItems);
    unsigned char* at = kvs + s * kSlotBytes;
    mbar_expect_tx(&full[s], kSlotBytes);
#pragma unroll
    for (int cb = 0; cb < D / 64; ++cb) {
      if (kItems == 2) {
        tma_load_3d(at + cb * kTile * 128, j % 2 ? &tm_v : &tm_k, &full[s],
                    cb * 64, c0, bh);
      } else {
        tma_load_3d(at + cb * kTile * 128, &tm_k, &full[s], cb * 64, c0, bh);
        tma_load_3d(at + kKvBytes + cb * kTile * 128, &tm_v, &full[s],
                    cb * 64, c0, bh);
      }
    }
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerThreads);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(q_full, 2 * kQBytes);
#pragma unroll
    for (int cb = 0; cb < D / 64; ++cb) {
      tma_load_3d(qs + cb * kWgBlock * 128, &tm_q, q_full, cb * 64, q0, bh);
      tma_load_3d(dos + cb * kWgBlock * 128, &tm_do, q_full, cb * 64, q0,
                  bh);
    }
    for (int j = 0; j < min(n_items, kSlots); ++j) load(j);
  }

  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int g = (threadIdx.x % 32) / 4;
  const int row0 = q0 + wg * kWgRows;
  // flash's last block may own no second 64 rows
  const bool live = !kDense || row0 < sq;
  const int rows[2] = {row0 + warp * 16 + g, row0 + warp * 16 + g + 8};
  const uint32_t q_base = smem_u32(qs) + wg * kWgRows * 128;
  const uint32_t do_base = smem_u32(dos) + wg * kWgRows * 128;
  if (!kDropout) drop.on = 0;  // compiled without the dropout code
  const uint32_t key = dropout_key(drop, bh);
  float lse_l2[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
  if (live)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lse_l2[h] = lse[(size_t)bh * sq + rows[h]] * kLog2e;
      dl[h] = delta[(size_t)bh * sq + rows[h]];
    }
  float acc[D / 8][4] = {};
  if (live) mbar_wait(q_full, 0);
  for (int t = 0; t < n_t; ++t) {
    const int c0 = col_of(t), j = t * kItems;
    if (threadIdx.x == 0 && t > 0)
#pragma unroll
      for (int i = j - kItems; i < j; ++i)
        if (i + kSlots < n_items) {
          mbar_wait(&empty[i % kSlots], (i / kSlots) & 1);
          load(i + kSlots);
        }
    const int s = j % kSlots, sv = (j + kItems - 1) % kSlots;
    mbar_wait(&full[s], (j / kSlots) & 1);
    const uint32_t k_base = smem_u32(kvs + s * kSlotBytes);
    const uint32_t v_base = kItems == 2 ? smem_u32(kvs + sv * kSlotBytes)
                                        : k_base + kKvBytes;
    const auto wait_v = [&] {
      if (kItems == 2) mbar_wait(&full[sv], ((j + 1) / kSlots) & 1);
    };
    if (live && !(causal && c0 > row0 + kWgRows - 1 + offset))
      dq_tile_wgmma<D>(acc, q_base, do_base, k_base, v_base, rows, lse_l2,
                       dl, c0, causal && c0 + kTile - 1 > row0 + offset,
                       offset, scale, drop, key, wait_v);
    else
      wait_v();
#pragma unroll
    for (int i = j; i < j + kItems; ++i) mbar_arrive(&empty[i % kSlots]);
  }
  if (live) {
    // dQ through the warpgroup's rows of the Q tile, which it no longer
    // reads, and one TMA store (zeros for rows that saw no column)
    const float one[2] = {1.f, 1.f};
    stage_acc_bf16<D>(qs, kWgBlock, wg * kWgRows, acc, one);
    fence_async_shared();
    named_barrier(1 + wg, 128);
    if (threadIdx.x % 128 == 0) {
#pragma unroll
      for (int cb = 0; cb < D / 64; ++cb)
        tma_store_3d(&tm_dq, qs + (cb * kWgBlock + wg * kWgRows) * 128,
                     cb * 64, row0, bh);
      tma_store_drain();
    }
  }
}

// A block-sparse list (block sizes 128-multiples that tile both
// sequences, L.order set; no dropout) or, kDense, dense_list(sk) (lengths
// 64-multiples).
template <int D, bool kDense>
cudaError_t launch_bsa_dq_wgmma(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, BlockList L,
                                int bh, int sq, int sk, int causal,
                                float scale, Dropout drop, cudaStream_t st) {
  CUtensorMap tq, tk, tv, tdo, tdq;
  cudaError_t err = bf16_map(&tq, q, bh, sq, D, kWgBlock);
  if (err == cudaSuccess) err = bf16_map(&tk, k, bh, sk, D, kTile);
  if (err == cudaSuccess) err = bf16_map(&tv, v, bh, sk, D, kTile);
  if (err == cudaSuccess) err = bf16_map(&tdo, dout, bh, sq, D, kWgBlock);
  if (err == cudaSuccess) err = bf16_map(&tdq, dq, bh, sq, D, kWgRows);
  if (err != cudaSuccess) return err;
  auto kernel = kDense && drop.on ? bsa_dq_wgmma_kernel<D, kDense, kDense>
                                  : bsa_dq_wgmma_kernel<D, kDense, false>;
  err = set_smem(kernel, dq_list_wgmma_smem<D>());
  if (err != cudaSuccess) return err;
  const dim3 grid = kDense ? dim3((sq + kWgBlock - 1) / kWgBlock, bh)
                           : dim3(bh, sq / kWgBlock);
  kernel<<<grid, kConsumerThreads, dq_list_wgmma_smem<D>(), st>>>(
      tq, tk, tv, tdo, tdq, static_cast<const float*>(lse),
      static_cast<const float*>(delta), L, sq, sk, causal, scale, drop);
  return cudaGetLastError();
}

// ----------------------------- dK/dV over a BlockList past D 128, by role
//
// bsa_dkv_split_wgmma_kernel replaces _bsa_dkv_kernel
// (paddle_tpu/ops/pallas/block_sparse_attention.py:216, pallas_call :310)
// and _fa_dkv_kernel (paddle_tpu/ops/pallas/flash_attention.py:316,
// pallas_call :397) in bf16 at padded D 192 and 256: dV += p_drop^T dO
// and dK += ds^T Q over a list of q tiles, p recomputed from lse.
//
// At D 128 a warpgroup holds dK and dV of its 64 kv rows (dkv_tile_wgmma:
// D fp32 registers a thread); at D 256 that is 256 before S and dP. So
// here a block owns 64 kv rows and its two warpgroups split the work by
// role, each with one D / 8 x 4 accumulator:
//   P   S^T = K Q^T, then p (masked, from lse), handed to dS as fp32
//       through a 16 KB shared tile in the accumulator's thread layout
//       (each thread of dS reads what its counterpart wrote: no shuffle,
//       no bank conflict), then dV += p_drop^T dO;
//   dS  dP^T = V dO^T while P computes S^T, then waits for p,
//       ds^T = p (dp_drop - delta) scale, and dK += ds^T Q.
// Each role issues two of a tile's four 64 x 64 x D products, and the
// scores are computed once. Two named barriers hand the p tile over: full
// (P arrives, dS waits) and empty (dS arrives once it has read p; P waits
// before it writes the next tile's).
//
// K and V (64 rows each) are loaded once by TMA; the q tiles with their
// dO, lse and delta come through a ring (3 stages at D 192, 2 at 256:
// what 227 KB holds beside K, V and the p tile), refilled by thread 0 of
// dS, the later role, once both have released a stage. Walk: the q tiles
// of the own kv block's list (flash: dense_list(sq)); under causal those
// wholly above the block's diagonal are a prefix, cut before anything is
// loaded. Blocks launch heaviest first: blockIdx.y walks L.order, blk_own
// / 64 thread blocks a logical block (flash: kv tile 0, the longest walk
// under causal, of every batch-head first). A block with nothing to walk
// writes exact zeros. No atomics: the result is deterministic.
constexpr int kPFull = 1, kPEmpty = 2;  // named barriers of the p hand-over

template <int D>
__host__ __device__ constexpr int dkv_split_stages() {
  return D == 192 ? 3 : 2;
}
template <int D>
constexpr size_t dkv_split_wgmma_smem() {
  return 1024 + 2 * tile_bytes<D>(kTile) +
         dkv_split_stages<D>() * (2 * tile_bytes<D>(kTile) + 2 * kTile * 4) +
         kTile * kTile * 4 + (1 + 2 * dkv_split_stages<D>()) * 8;
}
static_assert(dq_list_wgmma_smem<256>() <= 232448 &&
                  dkv_split_wgmma_smem<192>() <= 232448 &&
                  dkv_split_wgmma_smem<256>() <= 232448,
              "a block asks for more than 227 KB of shared memory");

// Role P on one q tile of R rows (Q, dO at q_base, do_base, its lse at
// lse_t) against the block's 64 kv rows cols[h] (K at k_base): p into
// p_s (p_busy: dS may still be reading the previous tile's), then
// dv += p_drop^T dO. dv holds N columns, dO's from column block own0: all
// D, or a block's share where blocks split D. before_dv() runs before the
// product: a caller whose dO comes in after its Q waits for it there.
template <int D, int N = D, int R = kTile, typename BeforeDV = NoWait>
__device__ __forceinline__ void dkv_p_tile_wgmma(
    float (&dv)[N / 8][4], uint32_t k_base, uint32_t q_base,
    uint32_t do_base, const float* lse_t, float4* p_s, const int (&cols)[2],
    int r0, bool mask, int offset, float scale, const Dropout& drop,
    uint32_t key, bool p_busy, int own0 = 0,
    const BeforeDV& before_dv = BeforeDV{}) {
  const int tig = threadIdx.x % 4, tid = threadIdx.x % 128;
  const float scale_log2 = scale * kLog2e;  // exp(x) = exp2(x log2(e))
  float st[R / 8][4] = {};
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<R>(st, kmajor_desc(k_base, kk, kTile),
                kmajor_desc(q_base, kk, R), kk > 0);
  wg_commit();
  wg_wait<0>();
  wg_fence_regs(st);
#pragma unroll
  for (int j = 0; j < R / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rl = j * 8 + 2 * tig + (e & 1);
      const bool masked = mask && r0 + rl + offset < cols[e >> 1];
      st[j][e] =
          masked ? 0.f
                 : exp2f(fmaf(st[j][e], scale_log2, -lse_t[rl] * kLog2e));
    }
  if (p_busy) named_barrier(kPEmpty, kConsumerThreads);
#pragma unroll
  for (int j = 0; j < R / 8; ++j)
    p_s[j * 128 + tid] = make_float4(st[j][0], st[j][1], st[j][2], st[j][3]);
  named_barrier_arrive(kPFull, kConsumerThreads);
  if (drop.on)
#pragma unroll
    for (int j = 0; j < R / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + j * 8 + 2 * tig + (e & 1);
        const bool keep =
            dropout_bits(key, row, cols[e >> 1]) >= drop.threshold;
        st[j][e] = keep ? st[j][e] * drop.keep_inv : 0.f;
      }
  uint32_t pa[R / 16][4];
  to_a_frags<R / 8>(pa, st);  // rounded to bf16, as the reference
  const uint32_t do_own = do_base + own0 * R * 128;
  before_dv();
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < R / 16; ++kk)
    wgmma_rs_t<N>(dv, pa[kk], mnmajor_desc(do_own, kk, R));
  wg_commit();
  wg_wait<0>();
  wg_fence_regs(dv);
}

// Role dS on the same tile (V at v_base, the q rows' delta at dl_t): dP^T,
// then p from p_s (p_next: tell P it may write the next tile's), and
// dk += ds^T Q over N columns of Q from column block own0; before_dk()
// runs before that product (a caller whose Q comes in apart waits there).
template <int D, int N = D, int R = kTile, typename BeforeDK = NoWait>
__device__ __forceinline__ void dkv_ds_tile_wgmma(
    float (&dk)[N / 8][4], uint32_t v_base, uint32_t q_base,
    uint32_t do_base, const float* dl_t, const float4* p_s,
    const int (&cols)[2], int r0, float scale, const Dropout& drop,
    uint32_t key, bool p_next, int own0 = 0,
    const BeforeDK& before_dk = BeforeDK{}) {
  const int tig = threadIdx.x % 4, tid = threadIdx.x % 128;
  float dpt[R / 8][4] = {};
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<R>(dpt, kmajor_desc(v_base, kk, kTile),
                kmajor_desc(do_base, kk, R), kk > 0);
  wg_commit();
  wg_wait<0>();
  wg_fence_regs(dpt);
  named_barrier(kPFull, kConsumerThreads);
  float4 p[R / 8];
#pragma unroll
  for (int j = 0; j < R / 8; ++j) p[j] = p_s[j * 128 + tid];
  if (p_next) named_barrier_arrive(kPEmpty, kConsumerThreads);
#pragma unroll
  for (int j = 0; j < R / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rl = j * 8 + 2 * tig + (e & 1);
      float dpv = dpt[j][e];
      if (drop.on) {
        const bool keep =
            dropout_bits(key, r0 + rl, cols[e >> 1]) >= drop.threshold;
        dpv = keep ? dpv * drop.keep_inv : 0.f;
      }
      const float pv = e == 0 ? p[j].x : e == 1 ? p[j].y
                                                : e == 2 ? p[j].z : p[j].w;
      dpt[j][e] = pv * (dpv - dl_t[rl]) * scale;  // ds^T
    }
  uint32_t da[R / 16][4];
  to_a_frags<R / 8>(da, dpt);  // rounded to bf16, as the reference
  const uint32_t q_own = q_base + own0 * R * 128;
  before_dk();
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < R / 16; ++kk)
    wgmma_rs_t<N>(dk, da[kk], mnmajor_desc(q_own, kk, R));
  wg_commit();
  wg_wait<0>();
  wg_fence_regs(dk);
}

template <int D, bool kDense, bool kDropout>
__global__ void __launch_bounds__(kConsumerThreads, 1)
bsa_dkv_split_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_do,
                           const __grid_constant__ CUtensorMap tm_dk,
                           const __grid_constant__ CUtensorMap tm_dv,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta, BlockList L,
                           int sq, int sk, int causal, float scale,
                           Dropout drop) {
  constexpr int kStages = dkv_split_stages<D>();
  constexpr int kTileBytes = tile_bytes<D>(kTile);
  constexpr int kRowBytes = kTile * 4;
  constexpr int kLoader = 128;  // thread 0 of role dS
  extern __shared__ unsigned char wg_smem[];
  unsigned char* ks = align_1024(wg_smem);
  unsigned char* vs = ks + kTileBytes;
  unsigned char* qs = vs + kTileBytes;             // [kStages] q tiles
  unsigned char* dos = qs + kStages * kTileBytes;  // [kStages] dO tiles
  float* lse_s = reinterpret_cast<float*>(dos + kStages * kTileBytes);
  float* dl_s = lse_s + kStages * kTile;           // [kStages][64] each
  float4* p_s = reinterpret_cast<float4*>(dl_s + kStages * kTile);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(p_s + kTile / 8 * 128);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int bh = blockIdx.x, per = L.blk_own / kTile;
  const int blk = kDense ? blockIdx.y : L.order[blockIdx.y / per];
  const int c0 = blk * L.blk_own + (blockIdx.y % per) * kTile;
  const int* list = kDense ? nullptr : L.idx + blk * L.width;
  const int offset = sk - sq;
  const int n = kDense ? 1 : L.count[blk], per_entry = L.blk_other / kTile;
  const auto entry_row = [&](int b) {
    return kDense ? 0 : list[b] * L.blk_other;
  };
  // q tiles wholly above the block's diagonal (r0 + 63 + offset < c0) see
  // none of it and are never loaded: a prefix of the ascending walk
  int first = 0;
  if (causal)
    for (int b = 0; b < n; ++b) {
      const int skip =
          min(per_entry, max(c0 - offset - entry_row(b), 0) / kTile);
      first += skip;
      if (skip < per_entry) break;
    }
  const int n_t = n * per_entry - first;
  const auto row_of = [&](int i) {
    const int t = first + i;
    return entry_row(t / per_entry) + (t % per_entry) * kTile;
  };
  // step i of the walk into its stage: Q, dO, lse and delta
  const auto load = [&](int i) {
    const int s = i % kStages, r0 = row_of(i);
    mbar_expect_tx(&full[s], 2 * kTileBytes + 2 * kRowBytes);
#pragma unroll
    for (int cb = 0; cb < D / 64; ++cb) {
      tma_load_3d(qs + s * kTileBytes + cb * kTile * 128, &tm_q, &full[s],
                  cb * 64, r0, bh);
      tma_load_3d(dos + s * kTileBytes + cb * kTile * 128, &tm_do, &full[s],
                  cb * 64, r0, bh);
    }
    bulk_load(lse_s + s * kTile, lse + (size_t)bh * sq + r0, kRowBytes,
              &full[s]);
    bulk_load(dl_s + s * kTile, delta + (size_t)bh * sq + r0, kRowBytes,
              &full[s]);
  };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerThreads);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == kLoader) {
    mbar_expect_tx(kv_full, 2 * kTileBytes);
#pragma unroll
    for (int cb = 0; cb < D / 64; ++cb) {
      tma_load_3d(ks + cb * kTile * 128, &tm_k, kv_full, cb * 64, c0, bh);
      tma_load_3d(vs + cb * kTile * 128, &tm_v, kv_full, cb * 64, c0, bh);
    }
    for (int i = 0; i < min(n_t, kStages); ++i) load(i);
  }

  const int role = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int g = (threadIdx.x % 32) / 4;
  const int cols[2] = {c0 + warp * 16 + g, c0 + warp * 16 + g + 8};
  if (!kDropout) drop.on = 0;  // compiled without the dropout code
  const uint32_t key = dropout_key(drop, bh);
  float acc[D / 8][4] = {};  // dV in role P, dK in role dS
  mbar_wait(kv_full, 0);  // also with nothing to walk: the stores reuse K, V
  // the walk, each stage waited for and released by both roles
  const auto walk = [&](const auto& step) {
    for (int i = 0; i < n_t; ++i) {
      const int s = i % kStages, r0 = row_of(i);
      mbar_wait(&full[s], (i / kStages) & 1);
      step(i, s, r0);
      mbar_arrive(&empty[s]);
      if (threadIdx.x == kLoader && i + kStages < n_t) {
        mbar_wait(&empty[s], (i / kStages) & 1);
        load(i + kStages);
      }
    }
  };
  if (role == 0)
    walk([&](int i, int s, int r0) {
      dkv_p_tile_wgmma<D>(acc, smem_u32(ks), smem_u32(qs + s * kTileBytes),
                          smem_u32(dos + s * kTileBytes), lse_s + s * kTile,
                          p_s, cols, r0,
                          causal && r0 + offset < c0 + kTile - 1, offset,
                          scale, drop, key, i > 0);
    });
  else
    walk([&](int i, int s, int r0) {
      dkv_ds_tile_wgmma<D>(acc, smem_u32(vs), smem_u32(qs + s * kTileBytes),
                           smem_u32(dos + s * kTileBytes), dl_s + s * kTile,
                           p_s, cols, r0, scale, drop, key, i + 1 < n_t);
    });
  // dV and dK through the V and K tiles, which neither role reads any
  // more, and TMA stores (exact zeros for an empty walk)
  __syncthreads();
  const float one[2] = {1.f, 1.f};
  stage_acc_bf16<D>(role == 0 ? vs : ks, kTile, 0, acc, one);
  fence_async_shared();
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int cb = 0; cb < D / 64; ++cb) {
      tma_store_3d(&tm_dk, ks + cb * kTile * 128, cb * 64, c0, bh);
      tma_store_3d(&tm_dv, vs + cb * kTile * 128, cb * 64, c0, bh);
    }
    tma_store_drain();
  }
}

// A block-sparse list (kv-major; block sizes 128-multiples that tile both
// sequences, L.order set; no dropout) or, kDense, dense_list(sq)
// (lengths 64-multiples). As the dQ kernel, the walk and the dropout are
// template arguments.
template <int D, bool kDense>
cudaError_t launch_bsa_dkv_split_wgmma(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, BlockList L,
                                       int bh, int sq, int sk, int causal,
                                       float scale, Dropout drop,
                                       cudaStream_t st) {
  CUtensorMap tq, tk, tv, tdo, tdk, tdv;
  cudaError_t err = bf16_map(&tq, q, bh, sq, D, kTile);
  if (err == cudaSuccess) err = bf16_map(&tk, k, bh, sk, D, kTile);
  if (err == cudaSuccess) err = bf16_map(&tv, v, bh, sk, D, kTile);
  if (err == cudaSuccess) err = bf16_map(&tdo, dout, bh, sq, D, kTile);
  if (err == cudaSuccess) err = bf16_map(&tdk, dk, bh, sk, D, kTile);
  if (err == cudaSuccess) err = bf16_map(&tdv, dv, bh, sk, D, kTile);
  if (err != cudaSuccess) return err;
  auto kernel = kDense && drop.on
                    ? bsa_dkv_split_wgmma_kernel<D, kDense, kDense>
                    : bsa_dkv_split_wgmma_kernel<D, kDense, false>;
  err = set_smem(kernel, dkv_split_wgmma_smem<D>());
  if (err != cudaSuccess) return err;
  kernel<<<dim3(bh, sk / kTile), kConsumerThreads,
           dkv_split_wgmma_smem<D>(), st>>>(
      tq, tk, tv, tdo, tdk, tdv, static_cast<const float*>(lse),
      static_cast<const float*>(delta), L, sq, sk, causal, scale, drop);
  return cudaGetLastError();
}

// --------------------- the backward past D 256: D split, over a BlockList
//
// bsa_dq_dsplit_wgmma_kernel replaces _bsa_dq_kernel
// (paddle_tpu/ops/pallas/block_sparse_attention.py:182, pallas_call :271)
// and _fa_dq_kernel (paddle_tpu/ops/pallas/flash_attention.py:277,
// pallas_call :380), and bsa_dkv_dsplit_wgmma_kernel replaces
// _bsa_dkv_kernel (block_sparse_attention.py:216, pallas_call :310) and
// _fa_dkv_kernel (flash_attention.py:316, pallas_call :397), in bf16 at
// padded D 320, 384, 448 and 512: what bsa_dq_wgmma_kernel and
// bsa_dkv_split_wgmma_kernel compute at D <= 256 (p recomputed from lse,
// ds = p (dp_drop - delta) scale, the causal offset sk - sq, flash's
// dropout keep bits, p and ds rounded to bf16 before their products,
// exact zeros where a row or column sees nothing).
//
// Why not those kernels: at D 512 a 64-row bf16 tile is 64 KB, and a
// full-D fp32 accumulator 256 registers a thread. The D 256 dQ keeps two
// 128-row tiles (Q, dO) beside its K/V ring, 256 KB here; the D 256
// dK/dV gives each role a full-D accumulator (dK and dV of 64 kv rows are
// the whole register file of an SM at D 512). So both split D, as
// bsa_fwd_dsplit_wgmma_kernel does, into the output's 64-column blocks:
// ceil(D / 128) of them to the first part, the rest to the second (3 + 2,
// 3 + 3, 4 + 3, 4 + 4 at D 320 / 384 / 448 / 512), each on whole 128-byte
// swizzle atoms, which an MN-major operand needs. Each part recomputes
// the scores over the full D: the same wgmma steps on the same tiles give
// both the same bits.
//
// dQ: a block owns 64 q rows (Q and dO loaded once by TMA, 40..64 KB
// each); its two warpgroups split dQ's column blocks. Per kv tile each
// computes S = Q K^T and dP = dO V^T itself, then dq[:, own] += ds
// K[:, own] (dq_tile_wgmma at width 64 kOwn). K and V come through a ring
// of items of their own (K of tile t item 2t, V item 2t + 1), as many
// slots as 227 KB hold beside Q and dO, refilled by thread 0 one tile
// after their release, as bsa_dq_wgmma_kernel does. kv tiles are 64 rows
// at D 320 (3 slots) and 32 past it (5, 4, 3 slots at D 384, 448, 512;
// 64-row tiles would leave 2, 2, 1): S and dP then take 16 registers each
// beside an accumulator of up to 128. At D 320 on an H100
// (ops/dsplit_backward_ab.py at commit 6d6f3cf), dQ on 32-row kv tiles
// (7 slots) ran 1.3-1.5x slower than on 64-row ones, and dK/dV (below)
// on 32-row q tiles (6 slots) 1.0-1.5x slower than on 64-row ones. Work:
// S and dP twice, 5 products of a tile against the 3 of one pass.
//
// dK/dV: a block owns 64 kv rows and one part of dK's and dV's column
// blocks (a grid axis: blockIdx.x = 2 bh + part, both parts of a kv tile
// side by side). Its two warpgroups keep bsa_dkv_split_wgmma_kernel's
// roles (P: S^T and p, handed to dS as fp32 through shared memory, then
// dv[:, own] += p_drop^T dO[:, own]; dS: dP^T, ds^T, dk[:, own] += ds^T
// Q[:, own]), each with one accumulator of kOwn column blocks. K and V
// stay resident (80..128 KB); the q tiles come through a ring as items of
// their own (Q of walk step i item 2i with its rows' lse, dO item 2i + 1
// with their delta): 64-row q tiles at D 320 (3 slots), 32-row past it (5, 3, 2
// slots at D 384, 448, 512; 64-row tiles would leave 2, 1, 1). Work: S^T
// and dP^T once a part, 3 products of a tile against the 2 of one pass.
// Thread 0 of role dS refills a slot once both roles have released it.
//
// Both walk the lists as the D 256 kernels do: under causal the tiles on
// the far side of the block's diagonal are cut before anything is loaded
// (a suffix of dQ's ascending walk, a prefix of dK/dV's); blocks launch
// heaviest first (block-sparse by L.order; flash's dense walk its last q
// block first for dQ, kv tile 0 first for dK/dV). No atomics: the result
// is deterministic. The walk and the dropout are template arguments, as in
// the D 256 kernels.
//
// Bound on the H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): 6 D FLOP a
// (q, k) pair for dQ and 8 D for dK/dV over the active pairs; at flash
// BH 16, S 1024, D 512, causal: 26.0 GFLOP (0.026 ms) for dQ and 34.6
// (0.035 ms) for dK/dV, both bound by operations.

template <int D>
__host__ __device__ constexpr size_t dq_dsplit_smem_at(int rows, int slots) {
  return 1024 + 2 * tile_bytes<D>(kTile) + slots * tile_bytes<D>(rows) +
         (1 + 2 * slots) * 8;
}
template <int D>
__host__ __device__ constexpr int dq_dsplit_slots_at(int rows) {
  int n = 0;
  while (n < 8 && dq_dsplit_smem_at<D>(rows, n + 1) <= 232448) ++n;
  return n;
}
// kv rows of dQ's tiles: 64 where that leaves 3 ring slots, else 32
template <int D>
__host__ __device__ constexpr int dq_dsplit_rows() {
  return dq_dsplit_slots_at<D>(kTile) >= 3 ? kTile : 32;
}
template <int D>
__host__ __device__ constexpr int dq_dsplit_slots() {
  return dq_dsplit_slots_at<D>(dq_dsplit_rows<D>());
}
template <int D>
constexpr size_t dq_dsplit_smem() {
  return dq_dsplit_smem_at<D>(dq_dsplit_rows<D>(), dq_dsplit_slots<D>());
}

template <int D>
__host__ __device__ constexpr size_t dkv_dsplit_smem_at(int rows,
                                                        int slots) {
  return 1024 + 2 * tile_bytes<D>(kTile) +
         slots * (tile_bytes<D>(rows) + rows * 4) + kTile * rows * 4 +
         (1 + 2 * slots) * 8;
}
template <int D>
__host__ __device__ constexpr int dkv_dsplit_slots_at(int rows) {
  int n = 0;
  while (n < 8 && dkv_dsplit_smem_at<D>(rows, n + 1) <= 232448) ++n;
  return n;
}
// q rows of dK/dV's tiles: 64 where that leaves 3 ring slots, else 32
template <int D>
__host__ __device__ constexpr int dkv_dsplit_rows() {
  return dkv_dsplit_slots_at<D>(kTile) >= 3 ? kTile : 32;
}
template <int D>
__host__ __device__ constexpr int dkv_dsplit_slots() {
  return dkv_dsplit_slots_at<D>(dkv_dsplit_rows<D>());
}
template <int D>
constexpr size_t dkv_dsplit_smem() {
  return dkv_dsplit_smem_at<D>(dkv_dsplit_rows<D>(), dkv_dsplit_slots<D>());
}
static_assert(dq_dsplit_slots<512>() >= 3 && dkv_dsplit_slots<512>() >= 2 &&
                  dq_dsplit_smem<320>() <= 232448 &&
                  dq_dsplit_smem<512>() <= 232448 &&
                  dkv_dsplit_smem<320>() <= 232448 &&
                  dkv_dsplit_smem<384>() <= 232448 &&
                  dkv_dsplit_smem<448>() <= 232448 &&
                  dkv_dsplit_smem<512>() <= 232448,
              "a block asks for more than 227 KB of shared memory");

template <int D, bool kDense, bool kDropout>
__global__ void __launch_bounds__(kConsumerThreads, 1)
bsa_dq_dsplit_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_do,
                           const __grid_constant__ CUtensorMap tm_dq,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta, BlockList L,
                           int sq, int sk, int causal, float scale,
                           Dropout drop) {
  constexpr int R = dq_dsplit_rows<D>();
  constexpr int kBlocks = D / 64;           // column blocks of a tile
  constexpr int kOwn0 = (kBlocks + 1) / 2;  // warpgroup 0's; 1 owns the rest
  constexpr int kSlots = dq_dsplit_slots<D>();
  constexpr int kQBytes = tile_bytes<D>(kTile);
  constexpr int kItemBytes = tile_bytes<D>(R);
  constexpr int kQRead = 1;  // named barrier: neither warpgroup reads Q
  extern __shared__ unsigned char wg_smem[];
  unsigned char* qs = align_1024(wg_smem);
  unsigned char* dos = qs + kQBytes;
  unsigned char* kvs = dos + kQBytes;  // [kSlots] K or V tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(kvs + kSlots * kItemBytes);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kSlots;

  // flash's dense walk: the last q rows (the longest walk) first
  const int bh = blockIdx.x;
  int blk = 0, q0;
  if (kDense) {
    q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  } else {
    const int per = L.blk_own / kTile;
    blk = L.order[blockIdx.y / per];
    q0 = blk * L.blk_own + (blockIdx.y % per) * kTile;
  }
  const int* list = kDense ? nullptr : L.idx + blk * L.width;
  const int offset = sk - sq;
  const int n = kDense ? 1 : L.count[blk], per_entry = L.blk_other / R;
  const auto entry_row = [&](int a) {
    return kDense ? 0 : list[a] * L.blk_other;
  };
  // kv tiles wholly past the block's diagonal (its last row's last
  // column) are never loaded: a suffix of the ascending walk
  int n_t = n * per_entry;
  if (causal) {
    const int last_col = q0 + kTile - 1 + offset;
    n_t = 0;
    for (int a = 0; a < n && entry_row(a) <= last_col; ++a)
      n_t += min(per_entry, (last_col - entry_row(a)) / R + 1);
  }
  const int n_items = 2 * n_t;
  const auto col_of = [&](int t) {
    return entry_row(t / per_entry) + (t % per_entry) * R;
  };
  // ring item j into its slot: K (j even) or V (j odd) of kv tile j / 2
  const auto load = [&](int j) {
    const int s = j % kSlots, c0 = col_of(j / 2);
    mbar_expect_tx(&full[s], kItemBytes);
#pragma unroll
    for (int cb = 0; cb < kBlocks; ++cb)
      tma_load_3d(kvs + s * kItemBytes + cb * R * 128,
                  j % 2 ? &tm_v : &tm_k, &full[s], cb * 64, c0, bh);
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerThreads);
    }
    mbar_fence_init();
    mbar_expect_tx(q_full, 2 * kQBytes);
#pragma unroll
    for (int cb = 0; cb < kBlocks; ++cb) {
      tma_load_3d(qs + cb * kTile * 128, &tm_q, q_full, cb * 64, q0, bh);
      tma_load_3d(dos + cb * kTile * 128, &tm_do, q_full, cb * 64, q0, bh);
    }
    for (int j = 0; j < min(n_items, kSlots); ++j) load(j);
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, g = (tid % 32) / 4;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  if (!kDropout) drop.on = 0;  // compiled without the dropout code
  const uint32_t key = dropout_key(drop, bh);
  float lse_l2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lse_l2[h] = lse[(size_t)bh * sq + rows[h]] * kLog2e;
    dl[h] = delta[(size_t)bh * sq + rows[h]];
  }
  // also with nothing to walk: the epilogue reuses the Q tile
  mbar_wait(q_full, 0);
  // one warpgroup's walk over kOwn column blocks of dQ
  const auto consume = [&](auto own) {
    constexpr int kOwn = decltype(own)::value;
    const int own0 = wg == 0 ? 0 : kOwn0;  // the first block it owns
    float acc[kOwn * 8][4] = {};
    for (int t = 0; t < n_t; ++t) {
      const int j = 2 * t, s = j % kSlots, sv = (j + 1) % kSlots;
      // thread 0 refills the slots of the tile before, once both
      // warpgroups have released them
      if (threadIdx.x == 0 && t > 0)
        for (int i = j - 2; i < j; ++i)
          if (i + kSlots < n_items) {
            mbar_wait(&empty[i % kSlots], (i / kSlots) & 1);
            load(i + kSlots);
          }
      const int c0 = col_of(t);
      mbar_wait(&full[s], (j / kSlots) & 1);
      dq_tile_wgmma<D, kOwn * 64, R, kTile>(
          acc, smem_u32(qs), smem_u32(dos), smem_u32(kvs + s * kItemBytes),
          smem_u32(kvs + sv * kItemBytes), rows, lse_l2, dl, c0,
          causal && c0 + R - 1 > q0 + offset, offset, scale, drop, key,
          [&] { mbar_wait(&full[sv], ((j + 1) / kSlots) & 1); }, own0);
      mbar_arrive(&empty[s]);
      mbar_arrive(&empty[sv]);
    }
    // dQ through the warpgroup's column blocks of the Q tile, once
    // neither warpgroup reads Q, and one TMA store a block (zeros for
    // rows that saw no column)
    named_barrier(kQRead, kConsumerThreads);
    const float one[2] = {1.f, 1.f};
    stage_acc_bf16<kOwn * 64>(qs + own0 * kTile * 128, kTile, 0, acc, one);
    fence_async_shared();
    named_barrier(3 + wg, 128);
    if (tid == 0) {
#pragma unroll
      for (int cb = 0; cb < kOwn; ++cb)
        tma_store_3d(&tm_dq, qs + (own0 + cb) * kTile * 128,
                     (own0 + cb) * 64, q0, bh);
      tma_store_drain();
    }
  };
  if (wg == 0)
    consume(IntC<kOwn0>{});
  else
    consume(IntC<kBlocks - kOwn0>{});
}

template <int D, bool kDense>
cudaError_t launch_dq_dsplit_wgmma_at(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, BlockList L, int bh, int sq,
                                      int sk, int causal, float scale,
                                      Dropout drop, cudaStream_t st) {
  constexpr int R = dq_dsplit_rows<D>();
  CUtensorMap tq, tk, tv, tdo, tdq;
  cudaError_t err = bf16_map(&tq, q, bh, sq, D, kTile);
  if (err == cudaSuccess) err = bf16_map(&tk, k, bh, sk, D, R);
  if (err == cudaSuccess) err = bf16_map(&tv, v, bh, sk, D, R);
  if (err == cudaSuccess) err = bf16_map(&tdo, dout, bh, sq, D, kTile);
  if (err == cudaSuccess) err = bf16_map(&tdq, dq, bh, sq, D, kTile);
  if (err != cudaSuccess) return err;
  auto kernel = kDense && drop.on
                    ? bsa_dq_dsplit_wgmma_kernel<D, kDense, kDense>
                    : bsa_dq_dsplit_wgmma_kernel<D, kDense, false>;
  err = set_smem(kernel, dq_dsplit_smem<D>());
  if (err != cudaSuccess) return err;
  kernel<<<dim3(bh, sq / kTile), kConsumerThreads, dq_dsplit_smem<D>(),
           st>>>(tq, tk, tv, tdo, tdq, static_cast<const float*>(lse),
                 static_cast<const float*>(delta), L, sq, sk, causal, scale,
                 drop);
  return cudaGetLastError();
}

// The bf16 dQ at padded head dim d 320, 384, 448 or 512 over a
// block-sparse q-major list (block sizes 128-multiples that tile both
// sequences, L.order set; no dropout) or, kDense, dense_list(sk) (lengths
// 64-multiples); any other d is refused.
template <bool kDense>
cudaError_t launch_dq_dsplit_wgmma(int d, const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dq, BlockList L, int bh, int sq,
                                   int sk, int causal, float scale,
                                   Dropout drop, cudaStream_t st) {
  return head_dim_from<320>(d, [&](auto dc) {
    return launch_dq_dsplit_wgmma_at<decltype(dc)::value, kDense>(
        q, k, v, dout, lse, delta, dq, L, bh, sq, sk, causal, scale, drop,
        st);
  });
}

template <int D, bool kDense, bool kDropout>
__global__ void __launch_bounds__(kConsumerThreads, 1)
bsa_dkv_dsplit_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_do,
                            const __grid_constant__ CUtensorMap tm_dk,
                            const __grid_constant__ CUtensorMap tm_dv,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta, BlockList L,
                            int sq, int sk, int causal, float scale,
                            Dropout drop) {
  constexpr int R = dkv_dsplit_rows<D>();
  constexpr int kBlocks = D / 64;           // column blocks of a tile
  constexpr int kOwn0 = (kBlocks + 1) / 2;  // part 0's; part 1 the rest
  constexpr int kSlots = dkv_dsplit_slots<D>();
  constexpr int kKvBytes = tile_bytes<D>(kTile);
  constexpr int kItemBytes = tile_bytes<D>(R);
  constexpr int kRowBytes = R * 4;
  constexpr int kLoader = 128;  // thread 0 of role dS
  extern __shared__ unsigned char wg_smem[];
  unsigned char* ks = align_1024(wg_smem);
  unsigned char* vs = ks + kKvBytes;
  unsigned char* items = vs + kKvBytes;  // [kSlots] Q or dO tiles
  // [kSlots][R]: the lse of a Q item's rows, the delta of a dO item's
  float* rows_s = reinterpret_cast<float*>(items + kSlots * kItemBytes);
  float4* p_s = reinterpret_cast<float4*>(rows_s + kSlots * R);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(p_s + R / 8 * 128);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kSlots;

  const int bh = blockIdx.x / 2, part = blockIdx.x % 2;
  const int per = L.blk_own / kTile;
  const int blk = kDense ? blockIdx.y : L.order[blockIdx.y / per];
  const int c0 = blk * L.blk_own + (blockIdx.y % per) * kTile;
  const int* list = kDense ? nullptr : L.idx + blk * L.width;
  const int offset = sk - sq;
  const int n = kDense ? 1 : L.count[blk], per_entry = L.blk_other / R;
  const auto entry_row = [&](int b) {
    return kDense ? 0 : list[b] * L.blk_other;
  };
  // q tiles wholly above the block's diagonal (r0 + R - 1 + offset < c0)
  // see none of it and are never loaded: a prefix of the ascending walk
  int first = 0;
  if (causal)
    for (int b = 0; b < n; ++b) {
      const int skip = min(per_entry, max(c0 - offset - entry_row(b), 0) / R);
      first += skip;
      if (skip < per_entry) break;
    }
  const int n_t = n * per_entry - first, n_items = 2 * n_t;
  const auto row_of = [&](int i) {
    const int t = first + i;
    return entry_row(t / per_entry) + (t % per_entry) * R;
  };
  // ring item j into its slot: Q with its rows' lse (j even) or dO with
  // their delta (j odd) of walk step j / 2
  const auto load = [&](int j) {
    const int s = j % kSlots, r0 = row_of(j / 2);
    const bool is_q = j % 2 == 0;
    mbar_expect_tx(&full[s], kItemBytes + kRowBytes);
#pragma unroll
    for (int cb = 0; cb < kBlocks; ++cb)
      tma_load_3d(items + s * kItemBytes + cb * R * 128,
                  is_q ? &tm_q : &tm_do, &full[s], cb * 64, r0, bh);
    bulk_load(rows_s + s * R, (is_q ? lse : delta) + (size_t)bh * sq + r0,
              kRowBytes, &full[s]);
  };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerThreads);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == kLoader) {
    mbar_expect_tx(kv_full, 2 * kKvBytes);
#pragma unroll
    for (int cb = 0; cb < kBlocks; ++cb) {
      tma_load_3d(ks + cb * kTile * 128, &tm_k, kv_full, cb * 64, c0, bh);
      tma_load_3d(vs + cb * kTile * 128, &tm_v, kv_full, cb * 64, c0, bh);
    }
    for (int j = 0; j < min(n_items, kSlots); ++j) load(j);
  }

  const int role = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int g = (threadIdx.x % 32) / 4;
  const int cols[2] = {c0 + warp * 16 + g, c0 + warp * 16 + g + 8};
  if (!kDropout) drop.on = 0;  // compiled without the dropout code
  const uint32_t key = dropout_key(drop, bh);
  mbar_wait(kv_full, 0);  // also with nothing to walk: the stores reuse K, V
  // the walk, each item waited for (P: Q first, dO before dV; dS: dO
  // first, Q before dK) and released by both roles; the loader refills a
  // slot once both have released it
  const auto walk = [&](const auto& step) {
    for (int i = 0; i < n_t; ++i) {
      const int jq = 2 * i, jo = jq + 1;
      const int first_j = role == 0 ? jq : jo, then_j = jq + jo - first_j;
      mbar_wait(&full[first_j % kSlots], (first_j / kSlots) & 1);
      step(i, items + (jq % kSlots) * kItemBytes,
           items + (jo % kSlots) * kItemBytes, rows_s + (jq % kSlots) * R,
           rows_s + (jo % kSlots) * R, row_of(i), [&] {
             mbar_wait(&full[then_j % kSlots], (then_j / kSlots) & 1);
           });
      for (int j = jq; j <= jo; ++j) {
        mbar_arrive(&empty[j % kSlots]);
        if (threadIdx.x == kLoader && j + kSlots < n_items) {
          mbar_wait(&empty[j % kSlots], (j / kSlots) & 1);
          load(j + kSlots);
        }
      }
    }
  };
  // one part's walk over kOwn column blocks of dK and dV
  const auto consume = [&](auto own) {
    constexpr int kOwn = decltype(own)::value;
    const int own0 = part == 0 ? 0 : kOwn0;  // the first block it owns
    float acc[kOwn * 8][4] = {};  // dV in role P, dK in role dS
    if (role == 0)
      walk([&](int i, unsigned char* q_t, unsigned char* do_t,
               const float* lse_t, const float*, int r0, const auto& then) {
        dkv_p_tile_wgmma<D, kOwn * 64, R>(
            acc, smem_u32(ks), smem_u32(q_t), smem_u32(do_t), lse_t, p_s,
            cols, r0, causal && r0 + offset < c0 + kTile - 1, offset, scale,
            drop, key, i > 0, own0, then);
      });
    else
      walk([&](int i, unsigned char* q_t, unsigned char* do_t, const float*,
               const float* dl_t, int r0, const auto& then) {
        dkv_ds_tile_wgmma<D, kOwn * 64, R>(
            acc, smem_u32(vs), smem_u32(q_t), smem_u32(do_t), dl_t, p_s, cols,
            r0, scale, drop, key, i + 1 < n_t, own0, then);
      });
    // dV and dK through the part's column blocks of the V and K tiles,
    // which neither role reads any more, and TMA stores (exact zeros for
    // an empty walk)
    __syncthreads();
    const float one[2] = {1.f, 1.f};
    stage_acc_bf16<kOwn * 64>((role == 0 ? vs : ks) + own0 * kTile * 128,
                              kTile, 0, acc, one);
    fence_async_shared();
    __syncthreads();
    if (threadIdx.x == 0) {
#pragma unroll
      for (int cb = own0; cb < own0 + kOwn; ++cb) {
        tma_store_3d(&tm_dk, ks + cb * kTile * 128, cb * 64, c0, bh);
        tma_store_3d(&tm_dv, vs + cb * kTile * 128, cb * 64, c0, bh);
      }
      tma_store_drain();
    }
  };
  if (part == 0)
    consume(IntC<kOwn0>{});
  else
    consume(IntC<kBlocks - kOwn0>{});
}

template <int D, bool kDense>
cudaError_t launch_dkv_dsplit_wgmma_at(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, BlockList L,
                                       int bh, int sq, int sk, int causal,
                                       float scale, Dropout drop,
                                       cudaStream_t st) {
  constexpr int R = dkv_dsplit_rows<D>();
  CUtensorMap tq, tk, tv, tdo, tdk, tdv;
  cudaError_t err = bf16_map(&tq, q, bh, sq, D, R);
  if (err == cudaSuccess) err = bf16_map(&tk, k, bh, sk, D, kTile);
  if (err == cudaSuccess) err = bf16_map(&tv, v, bh, sk, D, kTile);
  if (err == cudaSuccess) err = bf16_map(&tdo, dout, bh, sq, D, R);
  if (err == cudaSuccess) err = bf16_map(&tdk, dk, bh, sk, D, kTile);
  if (err == cudaSuccess) err = bf16_map(&tdv, dv, bh, sk, D, kTile);
  if (err != cudaSuccess) return err;
  auto kernel = kDense && drop.on
                    ? bsa_dkv_dsplit_wgmma_kernel<D, kDense, kDense>
                    : bsa_dkv_dsplit_wgmma_kernel<D, kDense, false>;
  err = set_smem(kernel, dkv_dsplit_smem<D>());
  if (err != cudaSuccess) return err;
  kernel<<<dim3(2 * bh, sk / kTile), kConsumerThreads, dkv_dsplit_smem<D>(),
           st>>>(tq, tk, tv, tdo, tdk, tdv, static_cast<const float*>(lse),
                 static_cast<const float*>(delta), L, sq, sk, causal, scale,
                 drop);
  return cudaGetLastError();
}

// The bf16 dK/dV at padded head dim d 320, 384, 448 or 512 over a
// block-sparse kv-major list (block sizes 128-multiples that tile both
// sequences, L.order set; no dropout) or, kDense, dense_list(sq) (lengths
// 64-multiples); any other d is refused.
template <bool kDense>
cudaError_t launch_dkv_dsplit_wgmma(int d, const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dk, void* dv, BlockList L, int bh,
                                    int sq, int sk, int causal, float scale,
                                    Dropout drop, cudaStream_t st) {
  return head_dim_from<320>(d, [&](auto dc) {
    return launch_dkv_dsplit_wgmma_at<decltype(dc)::value, kDense>(
        q, k, v, dout, lse, delta, dk, dv, L, bh, sq, sk, causal, scale,
        drop, st);
  });
}

}  // namespace
