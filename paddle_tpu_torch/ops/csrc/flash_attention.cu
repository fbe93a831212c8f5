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
//         read with ldmatrix (see the section below).
//   fp32  the FMA units (67 TFLOP/s peak; the tests' and the parity
//         step's type): tiles staged as fp32 and a 4 x (D/16) register
//         micro-tile per thread (256 threads = 16 x 16; a thread owns
//         rows 4*ty..4*ty+3 and columns tx + 16*j, so the row reductions
//         of the online softmax are half-warp shuffles). Operand layouts
//         in shared memory make every inner-loop load conflict-free: the
//         "A" operand is stored k-major and read as float4, the "B"
//         operand is read as scalars at a stride of 1 or an odd stride
//         (D + 1).
// Later work: wgmma with TMA-staged, double-buffered K/V tiles.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;        // rows of a q tile and of a kv tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kLdP = kTile + 4;  // row stride of the P / dS tiles

template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_float<
    __nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The reference casts p (and ds) to the input dtype before its matmuls.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float<T>(from_float<T>(x));
}

__device__ __forceinline__ uint32_t dropout_bits(uint32_t key, uint32_t row,
                                                 uint32_t col) {
  uint32_t x = (row * 0x9E3779B1u) ^ (col * 0x85EBCA77u) ^ key;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// 64 rows of a row-major [*, D] matrix into shared memory as fp32, row
// stride `ld` (D or D + 1): dst[r * ld + d].
template <typename T, int D>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src,
                                           float* __restrict__ dst, int ld) {
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D, d = e % D;
    dst[r * ld + d] = to_float<T>(src[(size_t)r * D + d]);
  }
}

// 64 rows of a row-major [*, D] matrix into shared memory transposed, as
// fp32: dst[d * kTile + r]. 16-byte loads; consecutive threads take
// consecutive rows, so the transposed stores are conflict-free.
template <typename T, int D>
__device__ __forceinline__ void stage_cols(const T* __restrict__ src,
                                           float* __restrict__ dst) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;
  for (int e = threadIdx.x; e < kTile * kChunks; e += kThreads) {
    const int r = e % kTile;
    const int c = (e / kTile) * kVec;
    const uint4 raw =
        *reinterpret_cast<const uint4*>(src + (size_t)r * D + c);
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int u = 0; u < kVec; ++u) dst[(c + u) * kTile + r] = to_float<T>(v[u]);
  }
}

// acc[i][j] += sum_k A[k * lda + 4 * ty + i] * B[k * bk + (tx + 16 j) * bn]
// for the calling thread's (ty, tx) = (threadIdx.x / 16, threadIdx.x % 16).
template <int NJ>
__device__ __forceinline__ void tile_fma(float (&acc)[4][NJ],
                                         const float* __restrict__ A,
                                         int lda,
                                         const float* __restrict__ B, int bk,
                                         int bn, int depth) {
  const float* a_ptr = A + 4 * (threadIdx.x / 16);
  const float* b_ptr = B + (threadIdx.x % 16) * bn;
#pragma unroll 4
  for (int k = 0; k < depth; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(a_ptr + k * lda);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float b = b_ptr[k * bk + 16 * j * bn];
      acc[0][j] = fmaf(a.x, b, acc[0][j]);
      acc[1][j] = fmaf(a.y, b, acc[1][j]);
      acc[2][j] = fmaf(a.z, b, acc[2][j]);
      acc[3][j] = fmaf(a.w, b, acc[3][j]);
    }
  }
}

// Store the thread's 4 x 4 tile v[i][j] (tile row 4*ty + i, column
// tx + 16 j) transposed: dst[(tx + 16 j) * kLdP + 4 * ty + i], one float4
// per j.
__device__ __forceinline__ void store_transposed(float* __restrict__ dst,
                                                 const float (&v)[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<float4*>(dst + (tx + 16 * j) * kLdP + 4 * ty) =
        make_float4(v[0][j], v[1][j], v[2][j], v[3][j]);
}

struct Dropout {
  uint32_t seed;       // the reference's int32 seed, as uint32
  uint32_t threshold;  // keep when bits >= threshold
  float keep_div;      // forward and dQ divide by 1 - rate ...
  float keep_inv;      // ... dK/dV multiplies by 1 / (1 - rate)
  int on;
};

// ---------------------------------------------------------------- forward

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ out,
              float* __restrict__ lse, int sq, int sk, int causal,
              float scale, Dropout drop) {
  constexpr int NO = D / 16;
  const int bh = blockIdx.y, q0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int offset = sk - sq;
  extern __shared__ float smem[];
  float* qt = smem;                  // [D][64]
  float* ks = qt + D * kTile;        // [64][D + 1]
  float* vs = ks + kTile * (D + 1);  // [64][D]
  float* pt = vs + kTile * D;        // [64 kv][kLdP]

  stage_cols<T, D>(q + ((size_t)bh * sq + q0) * D, qt);
  float m[4], l[4], acc[4][NO];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NO; ++c) acc[i][c] = 0.f;
  }
  const uint32_t key = drop.seed * 0xC2B2AE3Du + (uint32_t)bh * 0x27D4EB2Fu;
  const int n_kv = sk / kTile;
  const int last = causal ? min(n_kv - 1, (q0 + kTile - 1 + offset) / kTile)
                          : n_kv - 1;
  for (int t = 0; t <= last; ++t) {
    const int c0 = t * kTile;
    __syncthreads();  // every thread is done with the previous tile
    stage_rows<T, D>(k + ((size_t)bh * sk + c0) * D, ks, D + 1);
    stage_rows<T, D>(v + ((size_t)bh * sk + c0) * D, vs, D);
    __syncthreads();
    float s[4][4] = {};
    tile_fma<4>(s, qt, kTile, ks, 1, D + 1, D);
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx + 16 * j;
        s[i][j] *= scale;
        if (causal && row + offset < col) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      // the first tile holds column 0, which every row sees (sk >= sq
      // when causal), so m_new is finite from the first tile on
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = expf(s[i][j] - m_new);
        rs += p[i][j];
      }
      l[i] = alpha * l[i] + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float pd = p[i][j];
        if (drop.on) {
          const uint32_t bits = dropout_bits(key, row, c0 + tx + 16 * j);
          pd = bits >= drop.threshold ? pd / drop.keep_div : 0.f;
        }
        p[i][j] = round_to<T>(pd);
      }
#pragma unroll
      for (int c = 0; c < NO; ++c) acc[i][c] *= alpha;
    }
    store_transposed(pt, p);
    __syncthreads();
    tile_fma<NO>(acc, pt, kLdP, vs, D, 1, kTile);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    T* orow = out + ((size_t)bh * sq + row) * D;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int c = 0; c < NO; ++c)
      orow[tx + 16 * c] = from_float<T>(acc[i][c] * inv);
    if (tx == 0) lse[(size_t)bh * sq + row] = m[i] + logf(l[i]);
  }
}

// --------------------------------------------------------------------- dQ

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dq, int sq, int sk, int causal, float scale,
             Dropout drop) {
  constexpr int NO = D / 16;
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
  float lse_r[4], dl_r[4], acc[4][NO];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lse_r[i] = lse[(size_t)bh * sq + q0 + 4 * ty + i];
    dl_r[i] = delta[(size_t)bh * sq + q0 + 4 * ty + i];
#pragma unroll
    for (int c = 0; c < NO; ++c) acc[i][c] = 0.f;
  }
  const uint32_t key = drop.seed * 0xC2B2AE3Du + (uint32_t)bh * 0x27D4EB2Fu;
  const int n_kv = sk / kTile;
  const int last = causal ? min(n_kv - 1, (q0 + kTile - 1 + offset) / kTile)
                          : n_kv - 1;
  for (int t = 0; t <= last; ++t) {
    const int c0 = t * kTile;
    __syncthreads();
    stage_rows<T, D>(k + ((size_t)bh * sk + c0) * D, ks, D + 1);
    stage_rows<T, D>(v + ((size_t)bh * sk + c0) * D, vs, D + 1);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    tile_fma<4>(s, qt, kTile, ks, 1, D + 1, D);
    tile_fma<4>(dp, dot, kTile, vs, 1, D + 1, D);
    float ds[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx + 16 * j;
        const bool masked = causal && row + offset < col;
        const float p = masked ? 0.f : expf(s[i][j] * scale - lse_r[i]);
        float dpv = dp[i][j];
        if (drop.on) {
          const uint32_t bits = dropout_bits(key, row, col);
          dpv = bits >= drop.threshold ? dpv / drop.keep_div : 0.f;
        }
        ds[i][j] = round_to<T>(p * (dpv - dl_r[i]) * scale);
      }
    }
    store_transposed(dst, ds);
    __syncthreads();
    tile_fma<NO>(acc, dst, kLdP, ks, D + 1, 1, kTile);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    T* row = dq + ((size_t)bh * sq + q0 + 4 * ty + i) * D;
#pragma unroll
    for (int c = 0; c < NO; ++c) row[tx + 16 * c] = from_float<T>(acc[i][c]);
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
  constexpr int NO = D / 16;
  const int bh = blockIdx.y, c0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
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
  float dk_acc[4][NO], dv_acc[4][NO];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NO; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;
  const uint32_t key = drop.seed * 0xC2B2AE3Du + (uint32_t)bh * 0x27D4EB2Fu;
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
    // transposed scores: rows are kv columns c, columns are q rows r
    float s[4][4] = {}, dp[4][4] = {};
    tile_fma<4>(s, kt, kTile, qs, 1, D + 1, D);
    tile_fma<4>(dp, vt, kTile, dos, 1, D + 1, D);
    float pd[4][4], ds[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = c0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int rl = tx + 16 * j;
        const int row = r0 + rl;
        const bool masked = causal && row + offset < col;
        const float p = masked ? 0.f : expf(s[i][j] * scale - lse_s[rl]);
        float p_drop = p, dpv = dp[i][j];
        if (drop.on) {
          const bool keep = dropout_bits(key, row, col) >= drop.threshold;
          p_drop = keep ? p * drop.keep_inv : 0.f;
          dpv = keep ? dpv * drop.keep_inv : 0.f;
        }
        pd[i][j] = round_to<T>(p_drop);
        ds[i][j] = round_to<T>(p * (dpv - dl_s[rl]) * scale);
      }
    }
    store_transposed(xs, pd);
    store_transposed(ys, ds);
    __syncthreads();
    tile_fma<NO>(dv_acc, xs, kLdP, dos, D + 1, 1, kTile);
    tile_fma<NO>(dk_acc, ys, kLdP, qs, D + 1, 1, kTile);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t base = ((size_t)bh * sk + c0 + 4 * ty + i) * D;
#pragma unroll
    for (int c = 0; c < NO; ++c) {
      dk[base + tx + 16 * c] = from_float<T>(dk_acc[i][c]);
      dv[base + tx + 16 * c] = from_float<T>(dv_acc[i][c]);
    }
  }
}

// ------------------------------------------ bf16: tensor cores (mma.sync)
//
// The bf16 kernels do the same math on the tensor cores with
// mma.sync.m16n8k16 (bf16 inputs, fp32 accumulation). A block is 4 warps;
// each warp owns 16 rows of the block's tile (q rows in the forward and
// dQ, kv rows in dK/dV), and the tiles are staged in shared memory as
// bf16 with a row pitch of D + 8 elements, so the 8 rows an ldmatrix
// reads fall in 8 distinct bank groups. Scores stay in the mma
// accumulator fragments: a thread holds rows g and g + 8 (g = lane / 4)
// at columns 2 * (lane % 4) + {0, 1} of every 8-column tile, so row
// reductions are two shuffles within a group of 4 lanes, and the
// fragments of p (or ds) are re-packed as bf16 straight into the A
// operand of the next product, never written to shared memory.

constexpr int kWarpsMma = 4;
constexpr int kThreadsMma = 32 * kWarpsMma;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a . b on one 16 x 8 tile (a 16 x 16, b 16 x 8), fp32 accumulate.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [0, n_rows) of a row-major [*, D] bf16 matrix into shared memory
// with row pitch D + 8, 16-byte copies.
template <int D>
__device__ __forceinline__ void stage_bf16(const __nv_bfloat16* __restrict__ src,
                                           __nv_bfloat16* __restrict__ dst,
                                           int n_rows) {
  constexpr int kChunks = D / 8;
  for (int e = threadIdx.x; e < n_rows * kChunks; e += kThreadsMma) {
    const int r = e / kChunks, c = (e % kChunks) * 8;
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * D + c);
  }
}

// acc[j] (16 x 8 tiles j = 0..NT-1) += A[16 rows at a_row0] . X^T, where
// X is a row-major [n][k] tile in shared memory (pitch D + 8): the
// product over k = 0..D-1 of rows a_row0.. of A (row-major, pitch D + 8)
// with rows n = 8 j .. 8 j + 7 of X.
template <int D, int NT>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4],
                                        const __nv_bfloat16* A, int a_row0,
                                        const __nv_bfloat16* X) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, A + (a_row0 + (lane & 15)) * (D + 8) + kk * 16 +
                   (lane >> 4) * 8);
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      uint32_t b[4];
      ldsm_x4(b, X + (jp * 16 + (lane >> 4) * 8 + (lane & 7)) * (D + 8) +
                     kk * 16 + ((lane >> 3) & 1) * 8);
      mma16816(acc[2 * jp], a, b[0], b[1]);
      mma16816(acc[2 * jp + 1], a, b[2], b[3]);
    }
  }
}

// acc[j] (16 x 8 tiles over D columns) += P . X, where P is given as
// bf16 A fragments pa[kk] over the k = 16 kk .. 16 kk + 15 chunks and X
// is a row-major [k][D] tile in shared memory (pitch D + 8).
template <int D, int KK>
__device__ __forceinline__ void mma_px(float (&acc)[D / 8][4],
                                       const uint32_t (&pa)[KK][4],
                                       const __nv_bfloat16* X) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
#pragma unroll
    for (int jp = 0; jp < D / 16; ++jp) {
      uint32_t b[4];
      ldsm_x4_trans(b, X + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                               (D + 8) +
                           jp * 16 + (lane >> 4) * 8);
      mma16816(acc[2 * jp], pa[kk], b[0], b[1]);
      mma16816(acc[2 * jp + 1], pa[kk], b[2], b[3]);
    }
  }
}

// Accumulator tiles v[2 kk], v[2 kk + 1] (16 x 8 each) as the bf16 A
// fragment of the 16 x 16 chunk kk.
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

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Store 16 x D accumulator tiles (rows row0 + g, row0 + g + 8) as bf16.
template <int D>
__device__ __forceinline__ void store_rows_bf16(__nv_bfloat16* base,
                                                const float (&acc)[D / 8][4],
                                                const float (&mul)[2]) {
  const int lane = threadIdx.x % 32, g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<__nv_bfloat162*>(base + (g + 8 * h) * D + j * 8 +
                                         2 * tig) =
          __floats2bfloat162_rn(acc[j][2 * h] * mul[h],
                                acc[j][2 * h + 1] * mul[h]);
}

template <int D>
__global__ void __launch_bounds__(kThreadsMma)
fa_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                  int sq, int sk, int causal, float scale, Dropout drop) {
  constexpr int kLd = D + 8;
  const int bh = blockIdx.y, q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int offset = sk - sq;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kTile * kLd;
  __nv_bfloat16* vs = ks + kTile * kLd;

  stage_bf16<D>(q + ((size_t)bh * sq + q0) * D, qs, kTile);
  float o[D / 8][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const uint32_t key = drop.seed * 0xC2B2AE3Du + (uint32_t)bh * 0x27D4EB2Fu;
  const int n_kv = sk / kTile;
  const int last = causal ? min(n_kv - 1, (q0 + kTile - 1 + offset) / kTile)
                          : n_kv - 1;
  for (int t = 0; t <= last; ++t) {
    const int c0 = t * kTile;
    __syncthreads();
    stage_bf16<D>(k + ((size_t)bh * sk + c0) * D, ks, kTile);
    stage_bf16<D>(v + ((size_t)bh * sk + c0) * D, vs, kTile);
    __syncthreads();
    float s[kTile / 8][4] = {};
    mma_abt<D, kTile / 8>(s, qs, warp * 16, ks);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + j * 8 + 2 * tig + (e & 1);
        float x = s[j][e] * scale;
        if (causal && rows[e >> 1] + offset < col) x = -INFINITY;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // column 0 of the first tile is seen by every row (sk >= sq when
      // causal), so m is finite from the first tile on
      const float m_new = fmaxf(m[h], quad_max(mx[h]));
      alpha[h] = expf(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m[e >> 1]);
        rs[e >> 1] += p;
        float pd = p;
        if (drop.on) {
          const uint32_t bits = dropout_bits(
              key, rows[e >> 1], c0 + j * 8 + 2 * tig + (e & 1));
          pd = bits >= drop.threshold ? p / drop.keep_div : 0.f;
        }
        s[j][e] = pd;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = alpha[h] * l[h] + quad_sum(rs[h]);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];
    uint32_t pa[kTile / 16][4];
    to_a_frags<kTile / 8>(pa, s);
    mma_px<D, kTile / 16>(o, pa, vs);
  }
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
  store_rows_bf16<D>(out + ((size_t)bh * sq + q0 + warp * 16) * D, o, inv);
  if (tig == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      lse[(size_t)bh * sq + rows[h]] = m[h] + logf(l[h]);
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
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
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
  const uint32_t key = drop.seed * 0xC2B2AE3Du + (uint32_t)bh * 0x27D4EB2Fu;
  const int n_kv = sk / kTile;
  const int last = causal ? min(n_kv - 1, (q0 + kTile - 1 + offset) / kTile)
                          : n_kv - 1;
  for (int t = 0; t <= last; ++t) {
    const int c0 = t * kTile;
    __syncthreads();
    stage_bf16<D>(k + ((size_t)bh * sk + c0) * D, ks, kTile);
    stage_bf16<D>(v + ((size_t)bh * sk + c0) * D, vs, kTile);
    __syncthreads();
    float s[kTile / 8][4] = {}, dp[kTile / 8][4] = {};
    mma_abt<D, kTile / 8>(s, qs, warp * 16, ks);
    mma_abt<D, kTile / 8>(dp, dos, warp * 16, vs);
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, col = c0 + j * 8 + 2 * tig + (e & 1);
        const bool masked = causal && rows[h] + offset < col;
        const float p = masked ? 0.f : expf(s[j][e] * scale - lse_r[h]);
        float dpv = dp[j][e];
        if (drop.on) {
          const uint32_t bits = dropout_bits(key, rows[h], col);
          dpv = bits >= drop.threshold ? dpv / drop.keep_div : 0.f;
        }
        s[j][e] = p * (dpv - dl_r[h]) * scale;  // ds
      }
    uint32_t da[kTile / 16][4];
    to_a_frags<kTile / 8>(da, s);
    mma_px<D, kTile / 16>(acc, da, ks);
  }
  const float one[2] = {1.f, 1.f};
  store_rows_bf16<D>(dq + ((size_t)bh * sq + q0 + warp * 16) * D, acc, one);
}

// dK/dV: a block owns a 64-row kv tile (16 rows per warp) and walks q
// tiles of 32 rows, which keeps the transposed scores, dp and both
// accumulators in registers.
constexpr int kQTileKV = 32;

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
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
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
  const uint32_t key = drop.seed * 0xC2B2AE3Du + (uint32_t)bh * 0x27D4EB2Fu;
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
    // transposed scores: rows are this warp's kv columns, columns q rows
    float st[kQTileKV / 8][4] = {}, dpt[kQTileKV / 8][4] = {};
    mma_abt<D, kQTileKV / 8>(st, ks, warp * 16, qs);
    mma_abt<D, kQTileKV / 8>(dpt, vs, warp * 16, dos);
#pragma unroll
    for (int j = 0; j < kQTileKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rl = j * 8 + 2 * tig + (e & 1), row = r0 + rl;
        const int col = cols[e >> 1];
        const bool masked = causal && row + offset < col;
        const float p = masked ? 0.f : expf(st[j][e] * scale - lse_s[rl]);
        float p_drop = p, dpv = dpt[j][e];
        if (drop.on) {
          const bool keep = dropout_bits(key, row, col) >= drop.threshold;
          p_drop = keep ? p * drop.keep_inv : 0.f;
          dpv = keep ? dpv * drop.keep_inv : 0.f;
        }
        dpt[j][e] = p * (dpv - dl_s[rl]) * scale;  // ds^T
        st[j][e] = p_drop;
      }
    uint32_t pa[kQTileKV / 16][4], da[kQTileKV / 16][4];
    to_a_frags<kQTileKV / 8>(pa, st);
    to_a_frags<kQTileKV / 8>(da, dpt);
    mma_px<D, kQTileKV / 16>(dv_acc, pa, dos);
    mma_px<D, kQTileKV / 16>(dk_acc, da, qs);
  }
  const float one[2] = {1.f, 1.f};
  const size_t base = ((size_t)bh * sk + c0 + warp * 16) * D;
  store_rows_bf16<D>(dk + base, dk_acc, one);
  store_rows_bf16<D>(dv + base, dv_acc, one);
}

// ---------------------------------------------------------------- launch

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v,
                       void* out, void* lse, int bh, int sq, int sk,
                       int causal, float scale, Dropout drop,
                       cudaStream_t st) {
  const size_t smem =
      (size_t)(2 * D * kTile + kTile * (D + 1) + kTile * kLdP) *
      sizeof(float);
  auto kernel = fa_fwd_kernel<T, D>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(sq / kTile, bh), kThreads, smem, st>>>(
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
  const size_t smem =
      (size_t)(2 * D * kTile + 2 * kTile * (D + 1) + kTile * kLdP) *
      sizeof(float);
  auto kernel = fa_dq_kernel<T, D>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(sq / kTile, bh), kThreads, smem, st>>>(
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
  const size_t smem = (size_t)(2 * D * kTile + 2 * kTile * (D + 1) +
                               2 * kTile * kLdP + 2 * kTile) *
                      sizeof(float);
  auto kernel = fa_dkv_kernel<T, D>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(sk / kTile, bh), kThreads, smem, st>>>(
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
  const size_t smem = (size_t)3 * kTile * (D + 8) * sizeof(__nv_bfloat16);
  auto kernel = fa_fwd_mma_kernel<D>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(sq / kTile, bh), kThreadsMma, smem, st>>>(
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
  const size_t smem = (size_t)4 * kTile * (D + 8) * sizeof(__nv_bfloat16);
  auto kernel = fa_dq_mma_kernel<D>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(sq / kTile, bh), kThreadsMma, smem, st>>>(
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
  const size_t smem =
      (size_t)(2 * kTile + 2 * kQTileKV) * (D + 8) * sizeof(__nv_bfloat16) +
      2 * kQTileKV * sizeof(float);
  auto kernel = fa_dkv_mma_kernel<D>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(sk / kTile, bh), kThreadsMma, smem, st>>>(
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
