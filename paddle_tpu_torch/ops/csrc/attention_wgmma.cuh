// The bf16 attention tile steps on wgmma, shared by the flash kernels
// (flash_attention.cu) and the block-sparse kernels
// (block_sparse_attention.cu), which differ only in the tiles they walk:
//   fwd_tile_wgmma   online softmax over one kv tile (fa_fwd_wgmma_kernel,
//                    bsa_fwd_wgmma_kernel)
//   dq_tile_wgmma    dq += ds k over one kv tile (fa_dq_wgmma_kernel,
//                    bsa_dq_wgmma_kernel)
//   dkv_tile_wgmma   dv += p^T dO, dk += ds^T q over one q tile
//                    (fa_dkv_wgmma_kernel, bsa_dkv_wgmma_kernel)
// and one kernel both families launch: bsa_fwd_wgmma_kernel, the forward
// over a BlockList (below; block-sparse at padded D 64..256, flash at
// 192 and 256).
//
// A block owns a 128-row tile (q rows in the forward and dQ, kv rows in
// dK/dV) and is two consumer warpgroups of 64 of its rows each; the other
// side's 64-row tiles stream through a ring of shared-memory stages,
// loaded by TMA (hopper_tiles.cuh's layout contract: 128-byte swizzle,
// column blocks of 64). Every product is wgmma: operands in shared
// memory, or p / ds re-packed from accumulators as register A fragments
// (rounded to bf16, as the reference casts them).
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

// Row reductions over the 4 lanes that hold one accumulator row.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
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

// One kv tile (K at k_base, V at v_base, 64 rows each) against the
// warpgroup's 64 q rows (at q_base in the block's 128-row Q tile): the
// online softmax, with S = Q K^T and O += P V as wgmma.
template <int D>
__device__ __forceinline__ void fwd_tile_wgmma(
    float (&o)[D / 8][4], float (&m)[2], float (&l)[2], uint32_t q_base,
    uint32_t k_base, uint32_t v_base, const int (&rows)[2], int c0,
    bool mask, int offset, float scale, const Dropout& drop, uint32_t key) {
  const int tig = threadIdx.x % 4;
  float s[kTile / 8][4] = {};
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<kTile>(s, kmajor_desc(q_base, kk, kWgBlock),
                    kmajor_desc(k_base, kk, kTile), kk > 0);
  wg_commit();
  wg_wait<0>();
  wg_fence_regs(s);
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
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];
  uint32_t pa[kTile / 16][4];
  to_a_frags<kTile / 8>(pa, s);  // p rounded to bf16, as the reference
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk)
    wgmma_rs_t<D>(o, pa[kk], mnmajor_desc(v_base, kk, kTile));
  wg_commit();
  wg_wait<0>();
  wg_fence_regs(o);
}

// One kv tile (K at k_base, V at v_base, 64 rows each) against the
// warpgroup's 64 q rows rows[h] (Q, dO at q_base, do_base in the block's
// 128-row tiles; lse_l2 = lse log2(e) and delta of the rows): S = Q K^T
// and dP = dO V^T, committed apart so that p is computed while dP runs,
// then dq += ds K, as attention_tiles.cuh's dq_tile.
template <int D>
__device__ __forceinline__ void dq_tile_wgmma(
    float (&dq)[D / 8][4], uint32_t q_base, uint32_t do_base,
    uint32_t k_base, uint32_t v_base, const int (&rows)[2],
    const float (&lse_l2)[2], const float (&dl)[2], int c0, bool mask,
    int offset, float scale, const Dropout& drop, uint32_t key) {
  const int tig = threadIdx.x % 4;
  const float scale_log2 = scale * kLog2e;  // exp(x) = exp2(x log2(e))
  float s[kTile / 8][4] = {}, dp[kTile / 8][4] = {};
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<kTile>(s, kmajor_desc(q_base, kk, kWgBlock),
                    kmajor_desc(k_base, kk, kTile), kk > 0);
  wg_commit();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<kTile>(dp, kmajor_desc(do_base, kk, kWgBlock),
                    kmajor_desc(v_base, kk, kTile), kk > 0);
  wg_commit();
  // p while dP is still in the tensor cores
  wg_wait<1>();
  wg_fence_regs(s);
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j)
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
  for (int j = 0; j < kTile / 8; ++j)
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
  uint32_t da[kTile / 16][4];
  to_a_frags<kTile / 8>(da, s);  // rounded to bf16, as the reference
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk)
    wgmma_rs_t<D>(dq, da[kk], mnmajor_desc(k_base, kk, kTile));
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

// The walk's kv tiles in order: entry a of the block's list, 64-row tile
// sub of that entry (the next entry's row is read at the end of the step
// before its first tile).
struct ListWalk {
  const int* idx;  // the block's list, or null: one entry at row 0
  int n, per_entry, blk_other, a = 0, sub = 0, row;
  __device__ ListWalk(const BlockList& L, int blk)
      : idx(L.idx == nullptr ? nullptr : L.idx + blk * L.width),
        n(list_len(L, blk)),
        per_entry(L.blk_other / kTile),
        blk_other(L.blk_other),
        row(idx == nullptr ? 0 : idx[0] * L.blk_other) {}
  __device__ int col() const { return row + sub * kTile; }
  __device__ void next() {
    if (++sub == per_entry) {
      sub = 0;
      if (++a < n) row = idx[a] * blk_other;
    }
  }
};

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

}  // namespace
