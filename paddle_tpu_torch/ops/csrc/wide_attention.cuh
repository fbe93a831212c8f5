// The fp32 dQ kernel for padded head dims past 128 (192, 256, ..., 512),
// written by hand for Hopper (sm_90a), shared by the flash kernels
// (flash_attention.cu, which walk every kv tile, with dropout) and the
// block-sparse kernels (block_sparse_attention.cu, which walk their
// compacted lists).
//
// It replaces, at these head dims in fp32, the same Pallas TPU kernels as
// the narrow dQ kernels of those files: _fa_dq_kernel
// (paddle_tpu/ops/pallas/flash_attention.py) and _bsa_dq_kernel
// (paddle_tpu/ops/pallas/block_sparse_attention.py). The fp32 forward and
// dK/dV past 128 run the 3xTF32 tensor-core kernels of attention_tf32.cuh
// (bsa_fwd_tf32_kernel, bsa_dkv_tf32_kernel); bf16 past 128 runs the
// wgmma kernels of attention_wgmma.cuh (the list kernels at 192 and 256,
// the D-split kernels at 320..512).
//
// Why a path of its own: at D = 512 a 64-row fp32 tile is 128 KB, so the
// narrow dQ kernel's four tiles do not fit the 227 KB of shared memory,
// and its accumulator (D / 16 x 4 a thread) does not fit the registers.
// Here a block owns a 64-row q tile AND a 64-column slice of dQ (a third
// grid axis over D / 64 slices). Per kv tile it sums the full-D scores
// q k^T and do v^T over 64-column chunks staged in turn, then runs the
// narrow kernels' update step (attention_tiles.cuh dq_update, at D = 64)
// against its slice of k. Every slice block recomputes the scores: D / 64
// times the work, for shared memory and registers that do not grow with D
// (83 KB a block; the FMA units' 4 x 4 register tiles).
//
// Bound on the H100 SXM (67 TFLOP/s fp32, 3.35 TB/s): operations, as at
// D <= 128 (6 D FLOP a pair); this kernel runs on the FMA units and
// repeats the scores per slice (10-12x its bound). Right and simple first.
#pragma once

#include "attention_tiles.cuh"

namespace {

constexpr int kSlice = kTile;  // output columns a block owns; also a chunk

// --------------------------------------------------------------------- dQ

template <typename T>
__global__ void __launch_bounds__(kThreads)
wide_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dq, BlockList L, int sq, int sk, int d,
               int causal, float scale, Dropout drop) {
  const int bh = blockIdx.y, q0 = blockIdx.x * kTile;
  const int d0 = blockIdx.z * kSlice, offset = sk - sq;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  extern __shared__ float smem[];
  float* qt = smem;                       // [64][64] chunks, transposed:
  float* dot = qt + kTile * kSlice;       //   q, do
  float* ks = dot + kTile * kSlice;       // [64][65] chunks of k, then
  float* vs = ks + kTile * (kSlice + 1);  //   k's slice; of v
  float* dst = vs + kTile * (kSlice + 1);  // [64 kv][kLdP]

  const size_t qrow = (size_t)bh * sq + q0;
  float lse_r[4], dl_r[4], acc[4][kSlice / 16] = {};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lse_r[i] = lse[qrow + 4 * ty + i];
    dl_r[i] = delta[qrow + 4 * ty + i];
  }
  const uint32_t key = dropout_key(drop, bh);
  const int blk = q0 / L.blk_own, n = list_len(L, blk);
  for (int a = 0; a < n; ++a) {
    const int k0 = list_row(L, blk, a);
    for (int c0 = k0; c0 < k0 + L.blk_other; c0 += kTile) {
      if (causal && c0 > q0 + kTile - 1 + offset) break;
      const size_t kv = ((size_t)bh * sk + c0) * d;
      float s[4][4] = {}, dp[4][4] = {};
      for (int ch = 0; ch < d; ch += kSlice) {
        __syncthreads();
        stage_cols<T, kSlice>(q + qrow * d + ch, qt, d);
        stage_cols<T, kSlice>(dout + qrow * d + ch, dot, d);
        stage_rows<T, kSlice>(k + kv + ch, ks, kSlice + 1, d);
        stage_rows<T, kSlice>(v + kv + ch, vs, kSlice + 1, d);
        __syncthreads();
        tile_fma<4>(s, qt, kTile, ks, 1, kSlice + 1, kSlice);
        tile_fma<4>(dp, dot, kTile, vs, 1, kSlice + 1, kSlice);
      }
      __syncthreads();  // every thread is done with the last chunk of k
      stage_rows<T, kSlice>(k + kv + d0, ks, kSlice + 1, d);
      dq_update<T, kSlice>(acc, s, dp, ks, dst, lse_r, dl_r, q0, c0, causal,
                           offset, scale, drop, key);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    T* row = dq + (qrow + 4 * ty + i) * d + d0;
#pragma unroll
    for (int c = 0; c < kSlice / 16; ++c)
      row[tx + 16 * c] = from_float<T>(acc[i][c]);
  }
}

// ---------------------------------------------------------------- launch

// the narrow fp32 dQ kernel's layout at D = 64
constexpr size_t kWideDqSmem = dq_smem<kSlice>();

// A padded head dim the wide kernels take: 192..512, a multiple of 64.
inline bool wide_head_dim(int d) {
  return d > 128 && d <= 512 && d % kSlice == 0;
}

// fp32 only: every bf16 call past 128 is picked before the dispatch (the
// wgmma kernels of attention_wgmma.cuh), so no bf16 wide kernel is built
inline cudaError_t launch_wide_dq(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dq, BlockList L, int bh, int sq,
                                  int sk, int d, int causal, float scale,
                                  Dropout drop, cudaStream_t st) {
  auto kernel = wide_dq_kernel<float>;
  cudaError_t err = set_smem(kernel, kWideDqSmem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(sq / kTile, bh, d / kSlice), kThreads, kWideDqSmem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), L, sq, sk, d, causal, scale, drop);
  return cudaGetLastError();
}

}  // namespace
