// Block-sparse attention for Hopper (sm_90a), written by hand: forward, dQ
// and dK/dV on [BH, S, D] tensors (D padded to a multiple of 64 up to 512
// by the wrapper), over compacted lists of active blocks.
//
// Replaces the three Pallas TPU kernels of
// paddle_tpu/ops/pallas/block_sparse_attention.py:
//   bsa_fwd_[wgmma_]kernel  <- _bsa_fwd_kernel  (:92, pallas_call :146)
//   bsa_dq_[wgmma_]kernel   <- _bsa_dq_kernel   (:182, pallas_call :271)
//   bsa_dkv_[wgmma_]kernel  <- _bsa_dkv_kernel  (:216, pallas_call :310)
// Which kernel runs a call, by dtype and padded head dim:
//   fp32 at 64, 128         bsa_fwd_kernel, bsa_dq_kernel, bsa_dkv_kernel
//   bf16 at 64, 128         bsa_fwd_wgmma_kernel, bsa_dq_wgmma_kernel
//                           (both in attention_wgmma.cuh, which flash's
//                           bf16 D 192 and 256 run too),
//                           bsa_dkv_wgmma_kernel (below)
//   bf16 at 192, 256        bsa_fwd_wgmma_kernel, bsa_dq_wgmma_kernel,
//                           bsa_dkv_split_wgmma_kernel (attention_wgmma.cuh)
//   bf16 at 320..512        bsa_fwd_dsplit_wgmma_kernel,
//                           bsa_dq_dsplit_wgmma_kernel,
//                           bsa_dkv_dsplit_wgmma_kernel (attention_wgmma.cuh,
//                           D split across warpgroups or blocks)
//   fp32 at 192..512        bsa_fwd_tf32_kernel, bsa_dkv_tf32_kernel
//                           (attention_tf32.cuh, 3xTF32 on the tensor
//                           cores), wide_dq_kernel (wide_attention.cuh)
// The TPU grid is (BH, n blocks, list slot): each step's BlockSpec index
// map reads the list, so inactive blocks are never copied from HBM, and
// the sums ride in VMEM scratch from slot to slot. Here one thread block
// owns a tile of its side (q rows for the forward and dQ, kv rows for
// dK/dV; 64 rows, 128 in the wgmma kernels) and walks, inside one loop,
// the list of the logical block that tile lies in:
//   forward, dQ  cols[i, :counts[i]]   (q block i -> its active kv blocks)
//   dK/dV        rows[j, :rcounts[j]]  (kv block j -> the q blocks that
//                                       attend it, the transposed lists)
// A logical block (128..512 rows, blk_q and blk_k may differ) spans
// several 64-row tiles; each is staged and handed to the same tile step
// as the flash kernels' (attention_tiles.cuh, attention_wgmma.cuh), which
// is where the online softmax, the recomputed p and the dq / dk, dv
// products live. Inactive blocks cost neither FLOPs nor bytes. dK/dV
// keeps the reference's split from dQ: no atomics, a deterministic
// result, and a kv block that no q block attends (rcounts[j] == 0) walks
// nothing and writes exact zeros. A list's slots past its count repeat
// its last block (BlockMask's padding); no walk reads them.
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
// by the tensor cores. Instantiations: bf16 on wgmma fed by TMA rings
// (the flash kernels' design: dQ and dK/dV below, the forward in
// attention_wgmma.cuh); fp32 on the FMA units.

#include "attention_wgmma.cuh"
#include "attention_tf32.cuh"
#include "wide_attention.cuh"

namespace {

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

// ------------------------------------------ bf16: wgmma fed by TMA rings
//
// The backward's bf16 kernels at D 64 and 128 run the flash dQ and dK/dV
// kernels' design (flash_attention.cu fa_dq_wgmma_kernel,
// fa_dkv_wgmma_kernel, their tile steps shared through attention_wgmma.cuh,
// where the forward, bsa_fwd_wgmma_kernel, and dQ, bsa_dq_wgmma_kernel,
// walk the q-major lists; bsa_dkv_wgmma_kernel is here): a block owns
// 128 rows of its side, two consumer warpgroups of 64, 256 threads; one
// thread keeps a ring of the other side's 64-row tiles in flight by TMA,
// refilling a stage once both warpgroups have released it. Only the walk
// differs: step i of the ring is the i-th 64-row tile of the listed
// blocks, in list order, a listed block of blk_other rows being
// blk_other / 64 tiles. Block sizes are 128-multiples, so a block's 128
// rows lie in one logical block, and BlockMask's lists ascend: under
// causal the tiles wholly above the block's diagonal are a prefix (dK/dV)
// or a suffix (dQ) of the walk, which is cut to the rest before anything
// is loaded.
//
// Launch order: one block an SM, and a list may be far longer than the
// mean (BigBird's two global kv blocks are attended by every q block: 32
// entries against a mean of about 7 at S = 4096), so a heavy block that
// starts last sets the tail. L.order lists the own side's logical blocks
// by list length, longest first (BlockMask computes it once a pattern);
// the grid's y walks it (wg_block_row), every batch-head's blocks of one
// logical block side by side on x. No atomics: dK/dV keeps the
// reference's split from dQ and its result is deterministic.

template <int D>
__global__ void __launch_bounds__(kConsumerThreads, 1)
bsa_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_dk,
                     const __grid_constant__ CUtensorMap tm_dv,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, BlockList L, int sq,
                     int sk, int causal, float scale) {
  constexpr int kKvBytes = tile_bytes<D>(kWgBlock);
  constexpr int kQBytes = tile_bytes<D>(kTile);
  constexpr int kRowBytes = kTile * 4;
  extern __shared__ unsigned char wg_smem[];
  unsigned char* ks = align_1024(wg_smem);
  unsigned char* vs = ks + kKvBytes;
  unsigned char* qs = vs + kKvBytes;               // [kDkvStages] q tiles
  unsigned char* dos = qs + kDkvStages * kQBytes;  // [kDkvStages] dO tiles
  float* lse_s = reinterpret_cast<float*>(dos + kDkvStages * kQBytes);
  float* dl_s = lse_s + kDkvStages * kTile;        // [kDkvStages][64] each
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(dl_s + kDkvStages * kTile);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kDkvStages;

  const int bh = blockIdx.x;
  int blk;
  const int c0 = wg_block_row(L, blk);
  const int offset = sk - sq;
  const int* list = L.idx + blk * L.width;
  const int n = L.count[blk], per_entry = L.blk_other / kTile;
  // q tiles wholly above the block's diagonal (r0 + 63 + offset < c0) see
  // none of it and are never loaded: a prefix of the ascending walk
  int first = 0;
  if (causal)
    for (int b = 0; b < n; ++b) {
      const int skip = min(per_entry,
                           max(c0 - offset - list[b] * L.blk_other, 0) /
                               kTile);
      first += skip;
      if (skip < per_entry) break;
    }
  const int n_t = n * per_entry - first;
  const auto row_of = [&](int i) {
    const int t = first + i;
    return list[t / per_entry] * L.blk_other + (t % per_entry) * kTile;
  };
  // step i of the walk into its stage: Q, dO, lse and delta
  const auto load = [&](int i) {
    const int s = i % kDkvStages, r0 = row_of(i);
    mbar_expect_tx(&full[s], 2 * kQBytes + 2 * kRowBytes);
#pragma unroll
    for (int cb = 0; cb < D / 64; ++cb) {
      tma_load_3d(qs + s * kQBytes + cb * kTile * 128, &tm_q, &full[s],
                  cb * 64, r0, bh);
      tma_load_3d(dos + s * kQBytes + cb * kTile * 128, &tm_do, &full[s],
                  cb * 64, r0, bh);
    }
    bulk_load(lse_s + s * kTile, lse + (size_t)bh * sq + r0, kRowBytes,
              &full[s]);
    bulk_load(dl_s + s * kTile, delta + (size_t)bh * sq + r0, kRowBytes,
              &full[s]);
  };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kDkvStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerThreads);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(kv_full, 2 * kKvBytes);
#pragma unroll
    for (int cb = 0; cb < D / 64; ++cb) {
      tma_load_3d(ks + cb * kWgBlock * 128, &tm_k, kv_full, cb * 64, c0, bh);
      tma_load_3d(vs + cb * kWgBlock * 128, &tm_v, kv_full, cb * 64, c0, bh);
    }
    for (int i = 0; i < min(n_t, kDkvStages); ++i) load(i);
  }

  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int g = (threadIdx.x % 32) / 4;
  const int col0 = c0 + wg * kWgRows;
  const int cols[2] = {col0 + warp * 16 + g, col0 + warp * 16 + g + 8};
  const uint32_t k_base = smem_u32(ks) + wg * kWgRows * 128;
  const uint32_t v_base = smem_u32(vs) + wg * kWgRows * 128;
  const Dropout none{};
  float dk_acc[D / 8][4] = {}, dv_acc[D / 8][4] = {};
  mbar_wait(kv_full, 0);
  for (int i = 0; i < n_t; ++i) {
    const int s = i % kDkvStages, r0 = row_of(i);
    if (threadIdx.x == 0 && i > 0 && i - 1 + kDkvStages < n_t) {
      mbar_wait(&empty[(i - 1) % kDkvStages], ((i - 1) / kDkvStages) & 1);
      load(i - 1 + kDkvStages);
    }
    mbar_wait(&full[s], (i / kDkvStages) & 1);
    if (!(causal && r0 + kTile - 1 + offset < col0))
      dkv_tile_wgmma<D>(dk_acc, dv_acc, k_base, v_base,
                        smem_u32(qs + s * kQBytes), smem_u32(dos + s * kQBytes),
                        lse_s + s * kTile, dl_s + s * kTile, cols, r0,
                        causal && r0 + offset < col0 + kWgRows - 1, offset,
                        scale, none, 0u);
    mbar_arrive(&empty[s]);
  }
  // dK and dV through the warpgroup's rows of the K and V tiles, which it
  // no longer reads, and TMA stores (exact zeros for a kv block nothing
  // attends: its walk is empty)
  const float one[2] = {1.f, 1.f};
  stage_acc_bf16<D>(ks, kWgBlock, wg * kWgRows, dk_acc, one);
  stage_acc_bf16<D>(vs, kWgBlock, wg * kWgRows, dv_acc, one);
  fence_async_shared();
  named_barrier(1 + wg, 128);
  if (threadIdx.x % 128 == 0) {
#pragma unroll
    for (int cb = 0; cb < D / 64; ++cb) {
      const int at = (cb * kWgBlock + wg * kWgRows) * 128;
      tma_store_3d(&tm_dk, ks + at, cb * 64, col0, bh);
      tma_store_3d(&tm_dv, vs + at, cb * 64, col0, bh);
    }
    tma_store_drain();
  }
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

// The bf16 forward: bsa_fwd_wgmma_kernel (attention_wgmma.cuh) over the
// lists, with no dropout (the reference's block-sparse kernels have none).
template <int D>
cudaError_t launch_fwd_wgmma(const void* q, const void* k, const void* v,
                             void* out, void* lse, BlockList L, int bh,
                             int sq, int sk, int causal, float scale,
                             cudaStream_t st) {
  return launch_bsa_fwd_wgmma<D>(q, k, v, out, lse, L, bh, sq, sk, causal,
                                 scale, Dropout{}, st);
}

// The bf16 dQ: bsa_dq_wgmma_kernel (attention_wgmma.cuh) over the lists,
// with no dropout.
template <int D>
cudaError_t launch_dq_wgmma(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, BlockList L, int bh,
                            int sq, int sk, int causal, float scale,
                            cudaStream_t st) {
  return launch_bsa_dq_wgmma<D, false>(q, k, v, dout, lse, delta, dq, L, bh,
                                       sq, sk, causal, scale, Dropout{}, st);
}

template <int D>
cudaError_t launch_dkv_wgmma(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv,
                             BlockList L, int bh, int sq, int sk, int causal,
                             float scale, cudaStream_t st) {
  CUtensorMap tq, tk, tv, tdo, tdk, tdv;
  cudaError_t err = bf16_map(&tq, q, bh, sq, D, kTile);
  if (err == cudaSuccess) err = bf16_map(&tk, k, bh, sk, D, kWgBlock);
  if (err == cudaSuccess) err = bf16_map(&tv, v, bh, sk, D, kWgBlock);
  if (err == cudaSuccess) err = bf16_map(&tdo, dout, bh, sq, D, kTile);
  if (err == cudaSuccess) err = bf16_map(&tdk, dk, bh, sk, D, kWgRows);
  if (err == cudaSuccess) err = bf16_map(&tdv, dv, bh, sk, D, kWgRows);
  if (err != cudaSuccess) return err;
  auto kernel = bsa_dkv_wgmma_kernel<D>;
  err = set_smem(kernel, dkv_wgmma_smem<D>());
  if (err != cudaSuccess) return err;
  kernel<<<dim3(bh, sk / kWgBlock), kConsumerThreads, dkv_wgmma_smem<D>(),
           st>>>(tq, tk, tv, tdo, tdk, tdv, static_cast<const float*>(lse),
                 static_cast<const float*>(delta), L, sq, sk, causal, scale);
  return cudaGetLastError();
}

// Block sizes must be 128-multiples (whole 128-row blocks of the wgmma
// kernels, as BlockMask requires) that tile both sequences; the lists
// must have at least one slot.
bool bad_geometry(int bh, int sq, int sk, int blk_q, int blk_k, int width) {
  return bh < 1 || bh > 65535 || blk_q < kWgBlock || blk_k < kWgBlock ||
         blk_q % kWgBlock != 0 || blk_k % kWgBlock != 0 || sq % blk_q != 0 ||
         sk % blk_k != 0 || width < 1;
}

BlockList make_list(const void* idx, const void* count, const void* order,
                    int width, int blk_own, int blk_other) {
  return BlockList{static_cast<const int*>(idx),
                   static_cast<const int*>(count),
                   static_cast<const int*>(order), width, blk_own, blk_other};
}

}  // namespace

// Dispatch on (dtype, padded head dim) at head_dim 64 or 128: dtype 0 =
// float32 runs the FMA kernels (FP32), 1 = bfloat16 the tensor-core
// kernels (BF16). Past 128 (192..512, multiples of 64) each entry point
// picks its kernel before this dispatch: in bf16 the list kernels of
// attention_wgmma.cuh at 192 and 256, its D-split kernels at 320..512; in
// fp32 the 3xTF32 forward and dK/dV of attention_tf32.cuh and
// wide_dq_kernel (wide_attention.cuh). The arguments are the kernels' up
// to sq, sk; causal, scale and the stream follow. Everything else is
// refused with cudaErrorInvalidValue before any launch.
#define BSA_DISPATCH(FP32, BF16, ...)                                       \
  do {                                                                      \
    if (dtype == 0 && head_dim == 64)                                       \
      return (int)FP32<float, 64>(__VA_ARGS__, causal, scale, st);          \
    if (dtype == 0 && head_dim == 128)                                      \
      return (int)FP32<float, 128>(__VA_ARGS__, causal, scale, st);         \
    if (dtype == 1 && head_dim == 64)                                       \
      return (int)BF16<64>(__VA_ARGS__, causal, scale, st);                 \
    if (dtype == 1 && head_dim == 128)                                      \
      return (int)BF16<128>(__VA_ARGS__, causal, scale, st);                \
    return (int)cudaErrorInvalidValue;                                      \
  } while (0)

extern "C" {

// Each returns a cudaError_t; nonzero means the kernel did not launch.
// cols [sq / blk_q, a_max] and counts [sq / blk_q] (int32) are the q-major
// lists; rows [sk / blk_k, b_max] and rcounts [sk / blk_k] the kv-major
// ones; order_q [sq / blk_q] and order_kv [sk / blk_k] list the q and kv
// blocks by list length, longest first (the wgmma kernels' launch order).
int bsa_fwd_launch(const void* q, const void* k, const void* v, void* out,
                   void* lse, const void* cols, const void* counts,
                   const void* order_q, int a_max, int bh, int sq, int sk,
                   int head_dim, int blk_q, int blk_k, int causal,
                   float scale, int dtype, void* stream) {
  if (bad_geometry(bh, sq, sk, blk_q, blk_k, a_max))
    return (int)cudaErrorInvalidValue;
  const BlockList L = make_list(cols, counts, order_q, a_max, blk_q, blk_k);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // bf16 at padded D 192 and 256 runs the wgmma forward too
  if (dtype == 1 && head_dim == 192)
    return (int)launch_fwd_wgmma<192>(q, k, v, out, lse, L, bh, sq, sk,
                                      causal, scale, st);
  if (dtype == 1 && head_dim == 256)
    return (int)launch_fwd_wgmma<256>(q, k, v, out, lse, L, bh, sq, sk,
                                      causal, scale, st);
  // bf16 at 320..512: D split across two warpgroups
  if (dtype == 1 && head_dim > 256 && wide_head_dim(head_dim))
    return (int)launch_fwd_dsplit_wgmma(head_dim, q, k, v, out, lse, L, bh,
                                        sq, sk, causal, scale, Dropout{}, st);
  // fp32 at 192..512: 3xTF32 on the tensor cores
  if (dtype == 0 && wide_head_dim(head_dim))
    return (int)launch_fwd_tf32<false>(head_dim, q, k, v, out, lse, L, bh, sq,
                                       sk, causal, scale, Dropout{}, st);
  BSA_DISPATCH(launch_fwd, launch_fwd_wgmma, q, k, v, out, lse, L, bh, sq,
               sk);
}

int bsa_dq_launch(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dq, const void* cols, const void* counts,
                  const void* order_q, int a_max, int bh, int sq, int sk,
                  int head_dim, int blk_q, int blk_k, int causal,
                  float scale, int dtype, void* stream) {
  if (bad_geometry(bh, sq, sk, blk_q, blk_k, a_max))
    return (int)cudaErrorInvalidValue;
  const BlockList L = make_list(cols, counts, order_q, a_max, blk_q, blk_k);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // bf16 at padded D 192 and 256 runs the wgmma dQ too
  if (dtype == 1 && head_dim == 192)
    return (int)launch_dq_wgmma<192>(q, k, v, dout, lse, delta, dq, L, bh,
                                     sq, sk, causal, scale, st);
  if (dtype == 1 && head_dim == 256)
    return (int)launch_dq_wgmma<256>(q, k, v, dout, lse, delta, dq, L, bh,
                                     sq, sk, causal, scale, st);
  // bf16 at 320..512: D split across two warpgroups
  if (dtype == 1 && head_dim > 256 && wide_head_dim(head_dim))
    return (int)launch_dq_dsplit_wgmma<false>(head_dim, q, k, v, dout, lse,
                                              delta, dq, L, bh, sq, sk,
                                              causal, scale, Dropout{}, st);
  // fp32 at 192..512: the FMA kernel, a 64-column slice a block
  if (dtype == 0 && wide_head_dim(head_dim))
    return (int)launch_wide_dq(q, k, v, dout, lse, delta, dq, L, bh, sq, sk,
                               head_dim, causal, scale, Dropout{}, st);
  BSA_DISPATCH(launch_dq, launch_dq_wgmma, q, k, v, dout, lse, delta, dq, L,
               bh, sq, sk);
}

int bsa_dkv_launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, const void* rows, const void* rcounts,
                   const void* order_kv, int b_max, int bh, int sq, int sk,
                   int head_dim, int blk_q, int blk_k, int causal,
                   float scale, int dtype, void* stream) {
  if (bad_geometry(bh, sq, sk, blk_q, blk_k, b_max))
    return (int)cudaErrorInvalidValue;
  const BlockList L =
      make_list(rows, rcounts, order_kv, b_max, blk_k, blk_q);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // bf16 at padded D 192 and 256: a role a warpgroup
  // (attention_wgmma.cuh bsa_dkv_split_wgmma_kernel)
  if (dtype == 1 && head_dim == 192)
    return (int)launch_bsa_dkv_split_wgmma<192, false>(
        q, k, v, dout, lse, delta, dk, dv, L, bh, sq, sk, causal, scale,
        Dropout{}, st);
  if (dtype == 1 && head_dim == 256)
    return (int)launch_bsa_dkv_split_wgmma<256, false>(
        q, k, v, dout, lse, delta, dk, dv, L, bh, sq, sk, causal, scale,
        Dropout{}, st);
  // bf16 at 320..512: D split across two blocks, a role a warpgroup
  if (dtype == 1 && head_dim > 256 && wide_head_dim(head_dim))
    return (int)launch_dkv_dsplit_wgmma<false>(
        head_dim, q, k, v, dout, lse, delta, dk, dv, L, bh, sq, sk, causal,
        scale, Dropout{}, st);
  // fp32 at 192..512: 3xTF32 on the tensor cores, a role a warp
  if (dtype == 0 && wide_head_dim(head_dim))
    return (int)launch_dkv_tf32<false>(head_dim, q, k, v, dout, lse, delta,
                                       dk, dv, L, bh, sq, sk, causal, scale,
                                       Dropout{}, st);
  BSA_DISPATCH(launch_dkv, launch_dkv_wgmma, q, k, v, dout, lse, delta, dk,
               dv, L, bh, sq, sk);
}

const char* bsa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
