// Block-sparse attention for Hopper (sm_90a), written by hand: forward, dQ
// and dK/dV on [BH, S, D] tensors (D padded to 64 or 128 by the wrapper),
// over compacted lists of active blocks.
//
// Replaces the three Pallas TPU kernels of
// paddle_tpu/ops/pallas/block_sparse_attention.py:
//   bsa_fwd_[mma_]kernel  <- _bsa_fwd_kernel  (:92, pallas_call :146)
//   bsa_dq_[mma_]kernel   <- _bsa_dq_kernel   (:182, pallas_call :271)
//   bsa_dkv_[mma_]kernel  <- _bsa_dkv_kernel  (:216, pallas_call :310)
// The TPU grid is (BH, n blocks, list slot): each step's BlockSpec index
// map reads the list, so inactive blocks are never copied from HBM, and
// the sums ride in VMEM scratch from slot to slot. Here one thread block
// owns a 64-row tile of its side (q rows for the forward and dQ, kv rows
// for dK/dV) and walks, inside one loop, the list of the logical block
// that tile lies in:
//   forward, dQ  cols[i, :counts[i]]   (q block i -> its active kv blocks)
//   dK/dV        rows[j, :rcounts[j]]  (kv block j -> the q blocks that
//                                       attend it, the transposed lists)
// A logical block (128..512 rows, blk_q and blk_k may differ) spans
// several 64-row tiles; each is staged and handed to the same tile step
// as the flash kernels' (attention_tiles.cuh), which is where the online
// softmax, the recomputed p and the dq / dk, dv products live. Inactive
// blocks cost neither FLOPs nor bytes. dK/dV keeps the reference's split
// from dQ: no atomics, a deterministic result, and a kv block that no q
// block attends (rcounts[j] == 0) walks nothing and writes exact zeros.
//
// Causal masking keeps row + (sk - sq) >= col inside the active blocks;
// tiles wholly above a tile's diagonal are skipped. With blk_q > blk_k a
// row can see no unmasked column at all: the reference then divides 0 by
// 0 and returns NaN for that row; these kernels return 0 (lse -inf), the
// -inf-safe running max of attention_tiles.cuh.
//
// Bound on the H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s): 4 * D FLOP a
// (q, k) pair forward over the active pairs only, and q, k, v, out read
// or written once. At the path's BigBird pattern (B=2, H=16, S=4096,
// D=128, bf16, 227 active 128 x 128 block pairs of 1024 per head) that
// is 60.9 GFLOP and 135 MB: 0.062 ms by operations against 0.040 ms by
// bytes, so all three kernels (dQ 6 D, dK/dV 8 D FLOP a pair) are bound
// by the tensor cores. Right and simple first: mma.sync (bf16) and the
// FMA units (fp32) with synchronous staging, as the flash kernels; wgmma
// and TMA come later.

#include "attention_tiles.cuh"

namespace {

// For a tile of `own` rows starting at row0: its logical block is
// row0 / blk_own, whose active blocks on the other side are
// idx[blk * width + a] for a < count[blk], each blk_other rows long.
struct BlockList {
  const int* idx;
  const int* count;
  int width;
  int blk_own;
  int blk_other;
};

// ---------------------------------------------------------------- forward

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bsa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ out,
               float* __restrict__ lse, BlockList L, int sq, int sk,
               int causal, float scale) {
  const int bh = blockIdx.y, q0 = blockIdx.x * kTile;
  const int offset = sk - sq;
  extern __shared__ float smem[];
  float* qt = smem;                  // [D][64]
  float* ks = qt + D * kTile;        // [64][D + 1]
  float* vs = ks + kTile * (D + 1);  // [64][D]
  float* pt = vs + kTile * D;        // [64 kv][kLdP]

  stage_cols<T, D>(q + ((size_t)bh * sq + q0) * D, qt);
  FwdAcc<D> st;
  fwd_init(st);
  const Dropout none{};
  const int blk = q0 / L.blk_own, n = L.count[blk];
  for (int a = 0; a < n; ++a) {
    const int k0 = L.idx[blk * L.width + a] * L.blk_other;
    for (int c0 = k0; c0 < k0 + L.blk_other; c0 += kTile) {
      if (causal && c0 > q0 + kTile - 1 + offset) break;  // above diagonal
      __syncthreads();  // every thread is done with the previous tile
      stage_rows<T, D>(k + ((size_t)bh * sk + c0) * D, ks, D + 1);
      stage_rows<T, D>(v + ((size_t)bh * sk + c0) * D, vs, D);
      __syncthreads();
      fwd_tile<T, D>(st, qt, ks, vs, pt, q0, c0, causal, offset, scale, none,
                     0u);
    }
  }
  fwd_store<T, D>(st, out + (size_t)bh * sq * D, lse + (size_t)bh * sq, q0);
}

// --------------------------------------------------------------------- dQ

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bsa_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, BlockList L, int sq, int sk, int causal,
              float scale) {
  const int bh = blockIdx.y, q0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int offset = sk - sq;
  extern __shared__ float smem[];
  float* qt = smem;                  // [D][64]
  float* dot = qt + D * kTile;       // [D][64]
  float* ks = dot + D * kTile;       // [64][D + 1]
  float* vs = ks + kTile * (D + 1);  // [64][D + 1]
  float* dst = vs + kTile * (D + 1); // [64 kv][kLdP]

  stage_cols<T, D>(q + ((size_t)bh * sq + q0) * D, qt);
  stage_cols<T, D>(dout + ((size_t)bh * sq + q0) * D, dot);
  float lse_r[4], dl_r[4], acc[4][D / 16] = {};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lse_r[i] = lse[(size_t)bh * sq + q0 + 4 * ty + i];
    dl_r[i] = delta[(size_t)bh * sq + q0 + 4 * ty + i];
  }
  const Dropout none{};
  const int blk = q0 / L.blk_own, n = L.count[blk];
  for (int a = 0; a < n; ++a) {
    const int k0 = L.idx[blk * L.width + a] * L.blk_other;
    for (int c0 = k0; c0 < k0 + L.blk_other; c0 += kTile) {
      if (causal && c0 > q0 + kTile - 1 + offset) break;
      __syncthreads();
      stage_rows<T, D>(k + ((size_t)bh * sk + c0) * D, ks, D + 1);
      stage_rows<T, D>(v + ((size_t)bh * sk + c0) * D, vs, D + 1);
      __syncthreads();
      dq_tile<T, D>(acc, qt, dot, ks, vs, dst, lse_r, dl_r, q0, c0, causal,
                    offset, scale, none, 0u);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    T* row = dq + ((size_t)bh * sq + q0 + 4 * ty + i) * D;
#pragma unroll
    for (int c = 0; c < D / 16; ++c)
      row[tx + 16 * c] = from_float<T>(acc[i][c]);
  }
}

// ------------------------------------------------------------------ dK/dV

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bsa_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dk, T* __restrict__ dv, BlockList L, int sq,
               int sk, int causal, float scale) {
  const int bh = blockIdx.y, c0 = blockIdx.x * kTile;
  const int offset = sk - sq;
  extern __shared__ float smem[];
  float* kt = smem;                   // [D][64]
  float* vt = kt + D * kTile;         // [D][64]
  float* qs = vt + D * kTile;         // [64][D + 1]
  float* dos = qs + kTile * (D + 1);  // [64][D + 1]
  float* xs = dos + kTile * (D + 1);  // p [64 q][kLdP]
  float* ys = xs + kTile * kLdP;      // ds [64 q][kLdP]
  float* lse_s = ys + kTile * kLdP;   // [64]
  float* dl_s = lse_s + kTile;        // [64]

  stage_cols<T, D>(k + ((size_t)bh * sk + c0) * D, kt);
  stage_cols<T, D>(v + ((size_t)bh * sk + c0) * D, vt);
  float dk_acc[4][D / 16] = {}, dv_acc[4][D / 16] = {};
  const Dropout none{};
  const int blk = c0 / L.blk_own, n = L.count[blk];
  for (int b = 0; b < n; ++b) {
    const int q_start = L.idx[blk * L.width + b] * L.blk_other;
    for (int r0 = q_start; r0 < q_start + L.blk_other; r0 += kTile) {
      // q tiles wholly above this kv tile's diagonal see none of it
      if (causal && r0 + kTile - 1 + offset < c0) continue;
      __syncthreads();
      stage_rows<T, D>(q + ((size_t)bh * sq + r0) * D, qs, D + 1);
      stage_rows<T, D>(dout + ((size_t)bh * sq + r0) * D, dos, D + 1);
      if (threadIdx.x < kTile) {
        lse_s[threadIdx.x] = lse[(size_t)bh * sq + r0 + threadIdx.x];
        dl_s[threadIdx.x] = delta[(size_t)bh * sq + r0 + threadIdx.x];
      }
      __syncthreads();
      dkv_tile<T, D>(dk_acc, dv_acc, kt, vt, qs, dos, lse_s, dl_s, xs, ys,
                     r0, c0, causal, offset, scale, none, 0u);
    }
  }
  dkv_store<T, D>(dk_acc, dv_acc, dk, dv, (size_t)bh * sk + c0);
}

// ------------------------------------------ bf16: tensor cores (mma.sync)

template <int D>
__global__ void __launch_bounds__(kThreadsMma)
bsa_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                   BlockList L, int sq, int sk, int causal, float scale) {
  constexpr int kLd = D + 8;
  const int bh = blockIdx.y, q0 = blockIdx.x * kTile;
  const int offset = sk - sq;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kTile * kLd;
  __nv_bfloat16* vs = ks + kTile * kLd;

  stage_bf16<D>(q + ((size_t)bh * sq + q0) * D, qs, kTile);
  FwdAccMma<D> st;
  fwd_init_mma(st, q0);
  const Dropout none{};
  const int blk = q0 / L.blk_own, n = L.count[blk];
  for (int a = 0; a < n; ++a) {
    const int k0 = L.idx[blk * L.width + a] * L.blk_other;
    for (int c0 = k0; c0 < k0 + L.blk_other; c0 += kTile) {
      if (causal && c0 > q0 + kTile - 1 + offset) break;
      __syncthreads();
      stage_bf16<D>(k + ((size_t)bh * sk + c0) * D, ks, kTile);
      stage_bf16<D>(v + ((size_t)bh * sk + c0) * D, vs, kTile);
      __syncthreads();
      fwd_tile_mma<D>(st, qs, ks, vs, c0, causal, offset, scale, none, 0u);
    }
  }
  fwd_store_mma<D>(st, out + (size_t)bh * sq * D, lse + (size_t)bh * sq, q0);
}

template <int D>
__global__ void __launch_bounds__(kThreadsMma)
bsa_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dq, BlockList L, int sq, int sk,
                  int causal, float scale) {
  constexpr int kLd = D + 8;
  const int bh = blockIdx.y, q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) >> 2;
  const int offset = sk - sq;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos = qs + kTile * kLd;
  __nv_bfloat16* ks = dos + kTile * kLd;
  __nv_bfloat16* vs = ks + kTile * kLd;

  stage_bf16<D>(q + ((size_t)bh * sq + q0) * D, qs, kTile);
  stage_bf16<D>(dout + ((size_t)bh * sq + q0) * D, dos, kTile);
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lse_r[h] = lse[(size_t)bh * sq + rows[h]];
    dl_r[h] = delta[(size_t)bh * sq + rows[h]];
  }
  float acc[D / 8][4] = {};
  const Dropout none{};
  const int blk = q0 / L.blk_own, n = L.count[blk];
  for (int a = 0; a < n; ++a) {
    const int k0 = L.idx[blk * L.width + a] * L.blk_other;
    for (int c0 = k0; c0 < k0 + L.blk_other; c0 += kTile) {
      if (causal && c0 > q0 + kTile - 1 + offset) break;
      __syncthreads();
      stage_bf16<D>(k + ((size_t)bh * sk + c0) * D, ks, kTile);
      stage_bf16<D>(v + ((size_t)bh * sk + c0) * D, vs, kTile);
      __syncthreads();
      dq_tile_mma<D>(acc, qs, dos, ks, vs, rows, lse_r, dl_r, c0, causal,
                     offset, scale, none, 0u);
    }
  }
  const float one[2] = {1.f, 1.f};
  store_rows_bf16<D>(dq + ((size_t)bh * sq + q0 + warp * 16) * D, acc, one);
}

template <int D>
__global__ void __launch_bounds__(kThreadsMma)
bsa_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, BlockList L, int sq,
                   int sk, int causal, float scale) {
  constexpr int kLd = D + 8;
  const int bh = blockIdx.y, c0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) >> 2;
  const int offset = sk - sq;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kTile * kLd;
  __nv_bfloat16* qs = vs + kTile * kLd;
  __nv_bfloat16* dos = qs + kQTileKV * kLd;
  float* lse_s = reinterpret_cast<float*>(dos + kQTileKV * kLd);
  float* dl_s = lse_s + kQTileKV;

  stage_bf16<D>(k + ((size_t)bh * sk + c0) * D, ks, kTile);
  stage_bf16<D>(v + ((size_t)bh * sk + c0) * D, vs, kTile);
  const int cols[2] = {c0 + warp * 16 + g, c0 + warp * 16 + g + 8};
  float dk_acc[D / 8][4] = {}, dv_acc[D / 8][4] = {};
  const Dropout none{};
  const int blk = c0 / L.blk_own, n = L.count[blk];
  for (int b = 0; b < n; ++b) {
    const int q_start = L.idx[blk * L.width + b] * L.blk_other;
    for (int r0 = q_start; r0 < q_start + L.blk_other; r0 += kQTileKV) {
      if (causal && r0 + kQTileKV - 1 + offset < c0) continue;
      __syncthreads();
      stage_bf16<D>(q + ((size_t)bh * sq + r0) * D, qs, kQTileKV);
      stage_bf16<D>(dout + ((size_t)bh * sq + r0) * D, dos, kQTileKV);
      if (threadIdx.x < kQTileKV) {
        lse_s[threadIdx.x] = lse[(size_t)bh * sq + r0 + threadIdx.x];
        dl_s[threadIdx.x] = delta[(size_t)bh * sq + r0 + threadIdx.x];
      }
      __syncthreads();
      dkv_tile_mma<D>(dk_acc, dv_acc, ks, vs, qs, dos, lse_s, dl_s, cols, r0,
                      causal, offset, scale, none, 0u);
    }
  }
  const float one[2] = {1.f, 1.f};
  const size_t base = ((size_t)bh * sk + c0 + warp * 16) * D;
  store_rows_bf16<D>(dk + base, dk_acc, one);
  store_rows_bf16<D>(dv + base, dv_acc, one);
}

// ---------------------------------------------------------------- launch

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       void* out, void* lse, BlockList L, int bh, int sq,
                       int sk, int causal, float scale, cudaStream_t st) {
  auto kernel = bsa_fwd_kernel<T, D>;
  cudaError_t err = set_smem(kernel, fwd_smem<D>());
  if (err != cudaSuccess) return err;
  kernel<<<dim3(sq / kTile, bh), kThreads, fwd_smem<D>(), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), L, sq, sk, causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, BlockList L, int bh, int sq, int sk,
                      int causal, float scale, cudaStream_t st) {
  auto kernel = bsa_dq_kernel<T, D>;
  cudaError_t err = set_smem(kernel, dq_smem<D>());
  if (err != cudaSuccess) return err;
  kernel<<<dim3(sq / kTile, bh), kThreads, dq_smem<D>(), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), L, sq, sk, causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, BlockList L, int bh, int sq,
                       int sk, int causal, float scale, cudaStream_t st) {
  auto kernel = bsa_dkv_kernel<T, D>;
  cudaError_t err = set_smem(kernel, dkv_smem<D>());
  if (err != cudaSuccess) return err;
  kernel<<<dim3(sk / kTile, bh), kThreads, dkv_smem<D>(), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), L, sq, sk, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fwd_mma(const void* q, const void* k, const void* v,
                           void* out, void* lse, BlockList L, int bh, int sq,
                           int sk, int causal, float scale,
                           cudaStream_t st) {
  auto kernel = bsa_fwd_mma_kernel<D>;
  cudaError_t err = set_smem(kernel, fwd_smem_mma<D>());
  if (err != cudaSuccess) return err;
  kernel<<<dim3(sq / kTile, bh), kThreadsMma, fwd_smem_mma<D>(), st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), L, sq, sk,
      causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_mma(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dq, BlockList L, int bh,
                          int sq, int sk, int causal, float scale,
                          cudaStream_t st) {
  auto kernel = bsa_dq_mma_kernel<D>;
  cudaError_t err = set_smem(kernel, dq_smem_mma<D>());
  if (err != cudaSuccess) return err;
  kernel<<<dim3(sq / kTile, bh), kThreadsMma, dq_smem_mma<D>(), st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), L, sq, sk, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_mma(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dk, void* dv,
                           BlockList L, int bh, int sq, int sk, int causal,
                           float scale, cudaStream_t st) {
  auto kernel = bsa_dkv_mma_kernel<D>;
  cudaError_t err = set_smem(kernel, dkv_smem_mma<D>());
  if (err != cudaSuccess) return err;
  kernel<<<dim3(sk / kTile, bh), kThreadsMma, dkv_smem_mma<D>(), st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), L,
      sq, sk, causal, scale);
  return cudaGetLastError();
}

// Block sizes must be whole 64-row tiles and tile both sequences; the
// lists must have at least one slot.
bool bad_geometry(int bh, int sq, int sk, int blk_q, int blk_k, int width) {
  return bh < 1 || bh > 65535 || blk_q < kTile || blk_k < kTile ||
         blk_q % kTile != 0 || blk_k % kTile != 0 || sq < blk_q ||
         sk < blk_k || sq % blk_q != 0 || sk % blk_k != 0 || width < 1;
}

BlockList make_list(const void* idx, const void* count, int width,
                    int blk_own, int blk_other) {
  BlockList L;
  L.idx = static_cast<const int*>(idx);
  L.count = static_cast<const int*>(count);
  L.width = width;
  L.blk_own = blk_own;
  L.blk_other = blk_other;
  return L;
}

}  // namespace

// Dispatch on (dtype, padded head dim): dtype 0 = float32 runs the FMA
// kernels, 1 = bfloat16 the tensor-core kernels; head_dim 64 or 128.
// Everything else is refused with cudaErrorInvalidValue before any launch.
#define BSA_DISPATCH(FN, ...)                                                 \
  do {                                                                        \
    if (dtype == 0 && head_dim == 64) return (int)FN<float, 64>(__VA_ARGS__); \
    if (dtype == 0 && head_dim == 128)                                        \
      return (int)FN<float, 128>(__VA_ARGS__);                                \
    if (dtype == 1 && head_dim == 64) return (int)FN##_mma<64>(__VA_ARGS__);  \
    if (dtype == 1 && head_dim == 128)                                        \
      return (int)FN##_mma<128>(__VA_ARGS__);                                 \
    return (int)cudaErrorInvalidValue;                                        \
  } while (0)

extern "C" {

// Each returns a cudaError_t; nonzero means the kernel did not launch.
// cols [sq / blk_q, a_max] and counts [sq / blk_q] (int32) are the q-major
// lists; rows [sk / blk_k, b_max] and rcounts [sk / blk_k] the kv-major
// ones.
int bsa_fwd_launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, const void* cols, const void* counts,
                   int a_max, int bh, int sq, int sk, int head_dim,
                   int blk_q, int blk_k, int causal, float scale, int dtype,
                   void* stream) {
  if (bad_geometry(bh, sq, sk, blk_q, blk_k, a_max))
    return (int)cudaErrorInvalidValue;
  const BlockList L = make_list(cols, counts, a_max, blk_q, blk_k);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  BSA_DISPATCH(launch_fwd, q, k, v, out, lse, L, bh, sq, sk, causal, scale,
               st);
}

int bsa_dq_launch(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dq, const void* cols, const void* counts, int a_max,
                  int bh, int sq, int sk, int head_dim, int blk_q, int blk_k,
                  int causal, float scale, int dtype, void* stream) {
  if (bad_geometry(bh, sq, sk, blk_q, blk_k, a_max))
    return (int)cudaErrorInvalidValue;
  const BlockList L = make_list(cols, counts, a_max, blk_q, blk_k);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  BSA_DISPATCH(launch_dq, q, k, v, dout, lse, delta, dq, L, bh, sq, sk,
               causal, scale, st);
}

int bsa_dkv_launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, const void* rows, const void* rcounts,
                   int b_max, int bh, int sq, int sk, int head_dim,
                   int blk_q, int blk_k, int causal, float scale, int dtype,
                   void* stream) {
  if (bad_geometry(bh, sq, sk, blk_q, blk_k, b_max))
    return (int)cudaErrorInvalidValue;
  const BlockList L = make_list(rows, rcounts, b_max, blk_k, blk_q);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  BSA_DISPATCH(launch_dkv, q, k, v, dout, lse, delta, dk, dv, L, bh, sq, sk,
               causal, scale, st);
}

const char* bsa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
