// The bf16 backward tile steps on wgmma, shared by the flash kernels
// (flash_attention.cu: fa_dq_wgmma_kernel, fa_dkv_wgmma_kernel) and the
// block-sparse kernels (block_sparse_attention.cu: bsa_dq_wgmma_kernel,
// bsa_dkv_wgmma_kernel), which differ only in the tiles they walk.
//
// A block owns a 128-row tile (q rows in dQ, kv rows in dK/dV) and is two
// consumer warpgroups of 64 of its rows each; the other side's 64-row
// tiles stream through a ring of shared-memory stages, loaded by TMA
// (hopper_tiles.cuh's layout contract: 128-byte swizzle, column blocks of
// 64). Every product is wgmma: operands in shared memory, or p / ds
// re-packed from accumulators as register A fragments (rounded to bf16,
// as the reference casts them).
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

}  // namespace
