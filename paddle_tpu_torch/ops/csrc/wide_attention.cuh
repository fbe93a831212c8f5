// Attention kernels for padded head dims past 128 (192, 256, ..., 512),
// written by hand for Hopper (sm_90a), fp32 only: forward, dQ and dK/dV,
// shared by the flash kernels (flash_attention.cu, which walk every kv
// tile, with dropout) and the block-sparse kernels
// (block_sparse_attention.cu, which walk their compacted lists).
//
// They replace, at these head dims, the same Pallas TPU kernels as the
// narrow kernels of those files: _fa_fwd_kernel, _fa_dq_kernel and
// _fa_dkv_kernel (paddle_tpu/ops/pallas/flash_attention.py) and
// _bsa_fwd_kernel, _bsa_dq_kernel and _bsa_dkv_kernel
// (paddle_tpu/ops/pallas/block_sparse_attention.py), in fp32 at every
// padded head dim past 128. bf16 past 128 runs the wgmma kernels of
// attention_wgmma.cuh instead (the list kernels at 192 and 256, the
// D-split kernels at 320..512), so no bf16 wide kernel is built.
//
// Why a path of their own: at D = 512 a 64-row fp32 tile is 128 KB, so
// the narrow kernels' tiles (dQ holds four) do not fit the 227 KB of
// shared memory, and their accumulators (D / 16 x 4 a thread, twice in
// dK/dV) do not fit the registers. Here a block owns a 64-row tile AND a
// 64-column slice of the output (a third grid axis over D / 64 slices).
// Per tile of the other side it sums the full-D scores over 64-column
// chunks staged in turn (q k^T, and do v^T for the backward), then runs
// the narrow kernels' update step (attention_tiles.cuh fwd_update,
// dq_update, dkv_update, at D = 64) against its slice of v, k, or q and
// do. Every slice block recomputes the scores: D / 64 times the QK^T
// work, for shared memory and registers that do not grow with D (67, 83
// and 101 KB a block; the FMA units' 4 x 4 register tiles).
//
// Bound on the H100 SXM (67 TFLOP/s fp32, 3.35 TB/s): operations, as at
// D <= 128 (4 D FLOP a pair forward, 6 D dQ, 8 D dK/dV); these kernels
// run on the FMA units and repeat the scores per slice (9-12x their
// bound). Right and simple first.
#pragma once

#include "attention_tiles.cuh"

namespace {

constexpr int kSlice = kTile;  // output columns a block owns; also a chunk

// s += (rows a0.. of A) (rows b0.. of B)^T over all d columns, A and B
// row-major of pitch d (64 rows each), 64 columns staged at a time: at
// as A's chunk transposed [64][64], bs as B's [64][65]. Begins with a
// barrier (every thread is done with at and bs), ends without one.
template <typename T>
__device__ __forceinline__ void wide_scores(float (&s)[4][4], const T* a,
                                            const T* b, int d, float* at,
                                            float* bs) {
  for (int ch = 0; ch < d; ch += kSlice) {
    __syncthreads();
    stage_cols<T, kSlice>(a + ch, at, d);
    stage_rows<T, kSlice>(b + ch, bs, kSlice + 1, d);
    __syncthreads();
    tile_fma<4>(s, at, kTile, bs, 1, kSlice + 1, kSlice);
  }
}

// ---------------------------------------------------------------- forward

template <typename T>
__global__ void __launch_bounds__(kThreads)
wide_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ out,
                float* __restrict__ lse, BlockList L, int sq, int sk, int d,
                int causal, float scale, Dropout drop) {
  const int bh = blockIdx.y, q0 = blockIdx.x * kTile;
  const int d0 = blockIdx.z * kSlice, offset = sk - sq;
  extern __shared__ float smem[];
  float* qt = smem;                     // [64][64] a chunk of q, transposed
  float* ks = qt + kTile * kSlice;      // [64][65] a chunk of k
  float* vs = ks + kTile * (kSlice + 1);  // [64][64] v's slice
  float* pt = vs + kTile * kSlice;      // [64 kv][kLdP]

  const T* qb = q + ((size_t)bh * sq + q0) * d;
  FwdAcc<kSlice> st;
  fwd_init(st);
  const uint32_t key = dropout_key(drop, bh);
  const int blk = q0 / L.blk_own, n = list_len(L, blk);
  for (int a = 0; a < n; ++a) {
    const int k0 = list_row(L, blk, a);
    for (int c0 = k0; c0 < k0 + L.blk_other; c0 += kTile) {
      if (causal && c0 > q0 + kTile - 1 + offset) break;  // above diagonal
      const size_t kv = ((size_t)bh * sk + c0) * d;
      float s[4][4] = {};
      wide_scores<T>(s, qb, k + kv, d, qt, ks);
      stage_rows<T, kSlice>(v + kv + d0, vs, kSlice, d);
      fwd_update<T, kSlice>(st, s, vs, pt, q0, c0, causal, offset, scale,
                            drop, key);
    }
  }
  fwd_store<T, kSlice>(st, out + (size_t)bh * sq * d + d0,
                       blockIdx.z == 0 ? lse + (size_t)bh * sq : nullptr, q0,
                       d);
}

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

// ------------------------------------------------------------------ dK/dV

template <typename T>
__global__ void __launch_bounds__(kThreads)
wide_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk,
                T* __restrict__ dv, BlockList L, int sq, int sk, int d,
                int causal, float scale, Dropout drop) {
  const int bh = blockIdx.y, c0 = blockIdx.x * kTile;
  const int d0 = blockIdx.z * kSlice, offset = sk - sq;
  extern __shared__ float smem[];
  float* kt = smem;                        // [64][64] chunks, transposed:
  float* vt = kt + kTile * kSlice;         //   k, v
  float* qs = vt + kTile * kSlice;         // [64][65] chunks, then the
  float* dos = qs + kTile * (kSlice + 1);  //   slices: q, do
  float* xs = dos + kTile * (kSlice + 1);  // p [64 q][kLdP]
  float* ys = xs + kTile * kLdP;           // ds [64 q][kLdP]
  float* lse_s = ys + kTile * kLdP;        // [64]
  float* dl_s = lse_s + kTile;             // [64]

  const size_t kv = ((size_t)bh * sk + c0) * d;
  float dk_acc[4][kSlice / 16] = {}, dv_acc[4][kSlice / 16] = {};
  const uint32_t key = dropout_key(drop, bh);
  const int blk = c0 / L.blk_own, n = list_len(L, blk);
  for (int b = 0; b < n; ++b) {
    const int q_start = list_row(L, blk, b);
    for (int r0 = q_start; r0 < q_start + L.blk_other; r0 += kTile) {
      // q tiles wholly above this kv tile's diagonal see none of it
      if (causal && r0 + kTile - 1 + offset < c0) continue;
      const size_t qrow = (size_t)bh * sq + r0;
      float s[4][4] = {}, dp[4][4] = {};
      // the q rows' lse and delta, read before dkv_update's barrier: the
      // chunk loop's first barrier publishes them
      if (threadIdx.x < kTile) {
        lse_s[threadIdx.x] = lse[qrow + threadIdx.x];
        dl_s[threadIdx.x] = delta[qrow + threadIdx.x];
      }
      for (int ch = 0; ch < d; ch += kSlice) {
        __syncthreads();
        stage_cols<T, kSlice>(k + kv + ch, kt, d);
        stage_cols<T, kSlice>(v + kv + ch, vt, d);
        stage_rows<T, kSlice>(q + qrow * d + ch, qs, kSlice + 1, d);
        stage_rows<T, kSlice>(dout + qrow * d + ch, dos, kSlice + 1, d);
        __syncthreads();
        tile_fma<4>(s, kt, kTile, qs, 1, kSlice + 1, kSlice);
        tile_fma<4>(dp, vt, kTile, dos, 1, kSlice + 1, kSlice);
      }
      __syncthreads();  // every thread is done with the last chunks
      stage_rows<T, kSlice>(q + qrow * d + d0, qs, kSlice + 1, d);
      stage_rows<T, kSlice>(dout + qrow * d + d0, dos, kSlice + 1, d);
      dkv_update<T, kSlice>(dk_acc, dv_acc, s, dp, qs, dos, lse_s, dl_s, xs,
                            ys, r0, c0, causal, offset, scale, drop, key);
    }
  }
  dkv_store<T, kSlice>(dk_acc, dv_acc, dk + d0, dv + d0,
                       (size_t)bh * sk + c0, d);
}

// ---------------------------------------------------------------- launch

// the narrow fp32 kernels' layouts at D = 64
constexpr size_t kWideFwdSmem = fwd_smem<kSlice>();
constexpr size_t kWideDqSmem = dq_smem<kSlice>();
constexpr size_t kWideDkvSmem = dkv_smem<kSlice>();

// A padded head dim the wide kernels take: 192..512, a multiple of 64.
inline bool wide_head_dim(int d) {
  return d > 128 && d <= 512 && d % kSlice == 0;
}

// fp32 only: every bf16 call past 128 is picked before the dispatch (the
// wgmma kernels of attention_wgmma.cuh), so no bf16 wide kernel is built
inline cudaError_t launch_wide_fwd(const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   BlockList L, int bh, int sq, int sk, int d,
                                   int causal, float scale, Dropout drop,
                                   cudaStream_t st) {
  auto kernel = wide_fwd_kernel<float>;
  cudaError_t err = set_smem(kernel, kWideFwdSmem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(sq / kTile, bh, d / kSlice), kThreads, kWideFwdSmem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), L, sq, sk, d, causal, scale, drop);
  return cudaGetLastError();
}

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

inline cudaError_t launch_wide_dkv(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dk, void* dv, BlockList L, int bh,
                                   int sq, int sk, int d, int causal,
                                   float scale, Dropout drop,
                                   cudaStream_t st) {
  auto kernel = wide_dkv_kernel<float>;
  cudaError_t err = set_smem(kernel, kWideDkvSmem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(sk / kTile, bh, d / kSlice), kThreads, kWideDkvSmem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), L, sq, sk, d, causal,
      scale, drop);
  return cudaGetLastError();
}

}  // namespace
