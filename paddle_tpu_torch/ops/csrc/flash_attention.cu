// Flash attention for Hopper (sm_90a), written by hand: forward, dQ and
// dK/dV, on [BH, S, D] tensors (D padded to 64 or 128 by the wrapper).
//
// Replaces the three Pallas TPU kernels of
// paddle_tpu/ops/pallas/flash_attention.py:
//   fa_fwd_[mma_]kernel  <- _fa_fwd_kernel  (:162, pallas_call :230)
//   fa_dq_[mma_]kernel   <- _fa_dq_kernel   (:277, pallas_call :380)
//   fa_dkv_[mma_]kernel  <- _fa_dkv_kernel  (:316, pallas_call :397)
// Each computes what its TPU kernel computes; none is carried over block
// by block. The TPU grids walk the inner tile loop in order and carry
// (m, l, acc) or the dq / dk,dv sums in VMEM scratch across grid steps; on
// the GPU that loop runs inside one thread block, and the sums stay in the
// block's registers:
//   forward  one block per (bh, 64-row q tile), looping over 64-column kv
//            tiles; online softmax (running max m, sum l, accumulator acc,
//            all fp32); kv tiles wholly above the causal diagonal
//            (rows + offset >= cols, offset = sk - sq) are skipped; writes
//            out and lse = m + log(l), fp32 [BH, Sq].
//   dQ       one block per (bh, q tile), looping over kv tiles: p is
//            recomputed from lse, ds = p * (dp - delta) * scale,
//            dq += ds . k. No atomics.
//   dK/dV    one block per (bh, kv tile), looping over q tiles:
//            dv += p_drop^T . do, dk += ds^T . q. No atomics: the
//            reference's split into two kernels is kept, so the result is
//            deterministic.
// delta = rowsum(do * o) is computed by the wrapper in plain torch, as the
// reference leaves it to XLA.
//
// Dropout is bit-exact with the reference (_dropout_mask, :134): the keep
// bit of (bh, global q row, global kv col) is a murmur3 fmix32 hash of
// seed * 0xC2B2AE3D + bh * 0x27D4EB2F, row * 0x9E3779B1 and
// col * 0x85EBCA77 in uint32 arithmetic, kept when >= the threshold
// min(int(rate * 2^32), 2^32 - 1). Forward and backward regenerate the
// same mask; it is never stored.
//
// Bound on the H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s) at the
// training path's shapes (B=8, S=1024, H=16, D=128, bf16, causal; one
// [BH, S, D] tensor is 33.5 MB):
//   forward  34.4 GFLOP, 134 MB (q, k, v, out)       -> 0.040 ms by bytes
//   dQ       51.5 GFLOP, 168 MB (q, k, v, do, dq)    -> 0.052 ms by ops
//   dK/dV    68.7 GFLOP, 201 MB (q, k, v, do, dk, dv)-> 0.069 ms by ops
// so at full rate the three are tensor-core bound (dQ, dK/dV) or at the
// balance point (forward). This first version is simple and right, not
// yet near those bounds. Two instantiations:
//   bf16  tensor cores through mma.sync.m16n8k16 (fp32 accumulation), 4
//         warps a block, each warp owning 16 rows of the tile; tiles
//         staged in shared memory with plain 16-byte loads, fragments
//         read with ldmatrix.
//   fp32  the FMA units (67 TFLOP/s peak; the tests' and the parity
//         step's type): tiles staged as fp32 and a 4 x (D/16) register
//         micro-tile per thread (256 threads = 16 x 16; a thread owns
//         rows 4*ty..4*ty+3 and columns tx + 16*j, so the row reductions
//         of the online softmax are half-warp shuffles). Operand layouts
//         in shared memory make every inner-loop load conflict-free: the
//         "A" operand is stored k-major and read as float4, the "B"
//         operand is read as scalars at a stride of 1 or an odd stride
//         (D + 1).
// The work on one pair of tiles (and the helpers above it) lives in
// attention_tiles.cuh, shared with the block-sparse kernels; the kernels
// here walk every tile up to the causal diagonal.
// Later work: wgmma with TMA-staged, double-buffered K/V tiles.

#include "attention_tiles.cuh"

namespace {

// ---------------------------------------------------------------- forward

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ out,
              float* __restrict__ lse, int sq, int sk, int causal,
              float scale, Dropout drop) {
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
  const uint32_t key = dropout_key(drop, bh);
  const int n_kv = sk / kTile;
  const int last = causal ? min(n_kv - 1, (q0 + kTile - 1 + offset) / kTile)
                          : n_kv - 1;
  for (int t = 0; t <= last; ++t) {
    const int c0 = t * kTile;
    __syncthreads();  // every thread is done with the previous tile
    stage_rows<T, D>(k + ((size_t)bh * sk + c0) * D, ks, D + 1);
    stage_rows<T, D>(v + ((size_t)bh * sk + c0) * D, vs, D);
    __syncthreads();
    fwd_tile<T, D>(st, qt, ks, vs, pt, q0, c0, causal, offset, scale, drop,
                   key);
  }
  fwd_store<T, D>(st, out + (size_t)bh * sq * D, lse + (size_t)bh * sq, q0);
}

// --------------------------------------------------------------------- dQ

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dq, int sq, int sk, int causal, float scale,
             Dropout drop) {
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
  const uint32_t key = dropout_key(drop, bh);
  const int n_kv = sk / kTile;
  const int last = causal ? min(n_kv - 1, (q0 + kTile - 1 + offset) / kTile)
                          : n_kv - 1;
  for (int t = 0; t <= last; ++t) {
    const int c0 = t * kTile;
    __syncthreads();
    stage_rows<T, D>(k + ((size_t)bh * sk + c0) * D, ks, D + 1);
    stage_rows<T, D>(v + ((size_t)bh * sk + c0) * D, vs, D + 1);
    __syncthreads();
    dq_tile<T, D>(acc, qt, dot, ks, vs, dst, lse_r, dl_r, q0, c0, causal,
                  offset, scale, drop, key);
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
fa_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dk, T* __restrict__ dv, int sq, int sk,
              int causal, float scale, Dropout drop) {
  const int bh = blockIdx.y, c0 = blockIdx.x * kTile;
  const int offset = sk - sq;
  extern __shared__ float smem[];
  float* kt = smem;                   // [D][64]
  float* vt = kt + D * kTile;         // [D][64]
  float* qs = vt + D * kTile;         // [64][D + 1]
  float* dos = qs + kTile * (D + 1);  // [64][D + 1]
  float* xs = dos + kTile * (D + 1);  // p_drop [64 q][kLdP]
  float* ys = xs + kTile * kLdP;      // ds     [64 q][kLdP]
  float* lse_s = ys + kTile * kLdP;   // [64]
  float* dl_s = lse_s + kTile;        // [64]

  stage_cols<T, D>(k + ((size_t)bh * sk + c0) * D, kt);
  stage_cols<T, D>(v + ((size_t)bh * sk + c0) * D, vt);
  float dk_acc[4][D / 16] = {}, dv_acc[4][D / 16] = {};
  const uint32_t key = dropout_key(drop, bh);
  const int n_q = sq / kTile;
  for (int t = 0; t < n_q; ++t) {
    const int r0 = t * kTile;
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
    dkv_tile<T, D>(dk_acc, dv_acc, kt, vt, qs, dos, lse_s, dl_s, xs, ys, r0,
                   c0, causal, offset, scale, drop, key);
  }
  dkv_store<T, D>(dk_acc, dv_acc, dk, dv, (size_t)bh * sk + c0);
}

// ------------------------------------------ bf16: tensor cores (mma.sync)

template <int D>
__global__ void __launch_bounds__(kThreadsMma)
fa_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                  int sq, int sk, int causal, float scale, Dropout drop) {
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
  const uint32_t key = dropout_key(drop, bh);
  const int n_kv = sk / kTile;
  const int last = causal ? min(n_kv - 1, (q0 + kTile - 1 + offset) / kTile)
                          : n_kv - 1;
  for (int t = 0; t <= last; ++t) {
    const int c0 = t * kTile;
    __syncthreads();
    stage_bf16<D>(k + ((size_t)bh * sk + c0) * D, ks, kTile);
    stage_bf16<D>(v + ((size_t)bh * sk + c0) * D, vs, kTile);
    __syncthreads();
    fwd_tile_mma<D>(st, qs, ks, vs, c0, causal, offset, scale, drop, key);
  }
  fwd_store_mma<D>(st, out + (size_t)bh * sq * D, lse + (size_t)bh * sq, q0);
}

template <int D>
__global__ void __launch_bounds__(kThreadsMma)
fa_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dq, int sq, int sk, int causal,
                 float scale, Dropout drop) {
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
  const uint32_t key = dropout_key(drop, bh);
  const int n_kv = sk / kTile;
  const int last = causal ? min(n_kv - 1, (q0 + kTile - 1 + offset) / kTile)
                          : n_kv - 1;
  for (int t = 0; t <= last; ++t) {
    const int c0 = t * kTile;
    __syncthreads();
    stage_bf16<D>(k + ((size_t)bh * sk + c0) * D, ks, kTile);
    stage_bf16<D>(v + ((size_t)bh * sk + c0) * D, vs, kTile);
    __syncthreads();
    dq_tile_mma<D>(acc, qs, dos, ks, vs, rows, lse_r, dl_r, c0, causal,
                   offset, scale, drop, key);
  }
  const float one[2] = {1.f, 1.f};
  store_rows_bf16<D>(dq + ((size_t)bh * sq + q0 + warp * 16) * D, acc, one);
}

template <int D>
__global__ void __launch_bounds__(kThreadsMma)
fa_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, int sq, int sk, int causal,
                  float scale, Dropout drop) {
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
  const uint32_t key = dropout_key(drop, bh);
  for (int r0 = 0; r0 < sq; r0 += kQTileKV) {
    // q tiles wholly above this kv tile's diagonal see none of it
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
                    causal, offset, scale, drop, key);
  }
  const float one[2] = {1.f, 1.f};
  const size_t base = ((size_t)bh * sk + c0 + warp * 16) * D;
  store_rows_bf16<D>(dk + base, dk_acc, one);
  store_rows_bf16<D>(dv + base, dv_acc, one);
}

// ---------------------------------------------------------------- launch

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       void* out, void* lse, int bh, int sq, int sk,
                       int causal, float scale, Dropout drop,
                       cudaStream_t st) {
  auto kernel = fa_fwd_kernel<T, D>;
  cudaError_t err = set_smem(kernel, fwd_smem<D>());
  if (err != cudaSuccess) return err;
  kernel<<<dim3(sq / kTile, bh), kThreads, fwd_smem<D>(), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), sq, sk, causal, scale, drop);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int bh, int sq, int sk, int causal,
                      float scale, Dropout drop, cudaStream_t st) {
  auto kernel = fa_dq_kernel<T, D>;
  cudaError_t err = set_smem(kernel, dq_smem<D>());
  if (err != cudaSuccess) return err;
  kernel<<<dim3(sq / kTile, bh), kThreads, dq_smem<D>(), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), sq, sk, causal, scale, drop);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int bh, int sq, int sk,
                       int causal, float scale, Dropout drop,
                       cudaStream_t st) {
  auto kernel = fa_dkv_kernel<T, D>;
  cudaError_t err = set_smem(kernel, dkv_smem<D>());
  if (err != cudaSuccess) return err;
  kernel<<<dim3(sk / kTile, bh), kThreads, dkv_smem<D>(), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), sq, sk, causal, scale,
      drop);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fwd_mma(const void* q, const void* k, const void* v,
                           void* out, void* lse, int bh, int sq, int sk,
                           int causal, float scale, Dropout drop,
                           cudaStream_t st) {
  auto kernel = fa_fwd_mma_kernel<D>;
  cudaError_t err = set_smem(kernel, fwd_smem_mma<D>());
  if (err != cudaSuccess) return err;
  kernel<<<dim3(sq / kTile, bh), kThreadsMma, fwd_smem_mma<D>(), st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), sq, sk,
      causal, scale, drop);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_mma(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dq, int bh, int sq,
                          int sk, int causal, float scale, Dropout drop,
                          cudaStream_t st) {
  auto kernel = fa_dq_mma_kernel<D>;
  cudaError_t err = set_smem(kernel, dq_smem_mma<D>());
  if (err != cudaSuccess) return err;
  kernel<<<dim3(sq / kTile, bh), kThreadsMma, dq_smem_mma<D>(), st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), sq, sk, causal, scale, drop);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_mma(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dk, void* dv, int bh,
                           int sq, int sk, int causal, float scale,
                           Dropout drop, cudaStream_t st) {
  auto kernel = fa_dkv_mma_kernel<D>;
  cudaError_t err = set_smem(kernel, dkv_smem_mma<D>());
  if (err != cudaSuccess) return err;
  kernel<<<dim3(sk / kTile, bh), kThreadsMma, dkv_smem_mma<D>(), st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), sq,
      sk, causal, scale, drop);
  return cudaGetLastError();
}

bool bad_geometry(int bh, int sq, int sk, int causal) {
  return bh < 1 || bh > 65535 || sq < kTile || sk < kTile ||
         sq % kTile != 0 || sk % kTile != 0 || (causal && sk < sq);
}

Dropout make_dropout(unsigned seed, unsigned threshold, float keep_div,
                     float keep_inv, int on) {
  Dropout d;
  d.seed = seed;
  d.threshold = threshold;
  d.keep_div = keep_div;
  d.keep_inv = keep_inv;
  d.on = on;
  return d;
}

}  // namespace

// Dispatch on (dtype, padded head dim): dtype 0 = float32 runs the FMA
// kernels, 1 = bfloat16 the tensor-core kernels; head_dim 64 or 128.
// Everything else is refused with cudaErrorInvalidValue before any launch.
#define FA_DISPATCH(FN, ...)                                                 \
  do {                                                                       \
    if (dtype == 0 && head_dim == 64) return (int)FN<float, 64>(__VA_ARGS__); \
    if (dtype == 0 && head_dim == 128)                                       \
      return (int)FN<float, 128>(__VA_ARGS__);                               \
    if (dtype == 1 && head_dim == 64) return (int)FN##_mma<64>(__VA_ARGS__);  \
    if (dtype == 1 && head_dim == 128)                                       \
      return (int)FN##_mma<128>(__VA_ARGS__);                                \
    return (int)cudaErrorInvalidValue;                                       \
  } while (0)

extern "C" {

// Each returns a cudaError_t; nonzero means the kernel did not launch.
int fa_fwd_launch(const void* q, const void* k, const void* v, void* out,
                  void* lse, int bh, int sq, int sk, int head_dim,
                  int causal, float scale, unsigned seed, unsigned threshold,
                  float keep_div, float keep_inv, int dropout_on, int dtype,
                  void* stream) {
  if (bad_geometry(bh, sq, sk, causal)) return (int)cudaErrorInvalidValue;
  const Dropout drop =
      make_dropout(seed, threshold, keep_div, keep_inv, dropout_on);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FA_DISPATCH(launch_fwd, q, k, v, out, lse, bh, sq, sk, causal, scale, drop,
              st);
}

int fa_dq_launch(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dq, int bh, int sq, int sk, int head_dim, int causal,
                 float scale, unsigned seed, unsigned threshold,
                 float keep_div, float keep_inv, int dropout_on, int dtype,
                 void* stream) {
  if (bad_geometry(bh, sq, sk, causal)) return (int)cudaErrorInvalidValue;
  const Dropout drop =
      make_dropout(seed, threshold, keep_div, keep_inv, dropout_on);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FA_DISPATCH(launch_dq, q, k, v, dout, lse, delta, dq, bh, sq, sk, causal,
              scale, drop, st);
}

int fa_dkv_launch(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dk, void* dv, int bh, int sq, int sk, int head_dim,
                  int causal, float scale, unsigned seed,
                  unsigned threshold, float keep_div, float keep_inv,
                  int dropout_on, int dtype, void* stream) {
  if (bad_geometry(bh, sq, sk, causal)) return (int)cudaErrorInvalidValue;
  const Dropout drop =
      make_dropout(seed, threshold, keep_div, keep_inv, dropout_on);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FA_DISPATCH(launch_dkv, q, k, v, dout, lse, delta, dk, dv, bh, sq, sk,
              causal, scale, drop, st);
}

const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
