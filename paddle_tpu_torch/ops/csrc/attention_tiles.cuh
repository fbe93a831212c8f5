// Tile steps shared by the flash attention kernels (flash_attention.cu)
// and the block-sparse attention kernels (block_sparse_attention.cu).
//
// Both families walk 64-row q tiles against 64-row kv tiles (kv tiles
// against 32- or 64-row q tiles in dK/dV); they differ only in which
// tiles they walk: every tile up to the causal diagonal (flash) or the
// tiles of a q block's compacted list of active kv blocks (block-sparse).
// So the work on one pair of tiles lives here, once, as a step function
// a kernel calls from its own loop:
//   fwd_tile / fwd_tile_mma   online softmax over one kv tile
//   dq_tile  / dq_tile_mma    dq += ds . k over one kv tile
//   dkv_tile / dkv_tile_mma   dv += p^T . do, dk += ds^T . q over one q tile
// and the forward's epilogue (fwd_store / fwd_store_mma).
//
// Masked scores are -inf. The running max is -inf-safe: while every
// column a row has seen is masked, its max stays -inf and the step
// exponentiates against 0 instead, so the rescale factor and p are 0, not
// exp(-inf - (-inf)) = NaN. A row that sees no unmasked column at all
// (possible in block-sparse causal attention) ends with l = 0: its output
// is written as 0 and its lse as -inf, and the backward steps give it
// p = 0 (every one of its scores is masked).
//
// Two instantiations of every step (the flash kernels use the fp32 ones
// and wgmma kernels of their own for bf16; the block-sparse kernels both):
//   fp32  the FMA units: 256 threads as 16 x 16, a thread owning a 4 x 4
//         block of the 64 x 64 score tile (rows 4*ty..4*ty+3, columns
//         tx + 16*j) and a 4 x (D/16) block of the accumulators.
//   bf16  tensor cores through mma.sync.m16n8k16 (fp32 accumulation), 4
//         warps, each owning 16 rows of the block's own tile; tiles staged
//         in shared memory as bf16 with a D + 8 pitch; p and ds re-packed
//         from accumulator fragments straight into A operands.
#pragma once

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

// The row max to exponentiate against: m itself, or 0 while m is -inf.
__device__ __forceinline__ float safe_max(float m) {
  return m == -INFINITY ? 0.f : m;
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

struct Dropout {
  uint32_t seed;       // the reference's int32 seed, as uint32
  uint32_t threshold;  // keep when bits >= threshold
  float keep_div;      // forward and dQ divide by 1 - rate ...
  float keep_inv;      // ... dK/dV multiplies by 1 / (1 - rate)
  int on;
};

__device__ __forceinline__ uint32_t dropout_key(const Dropout& drop, int bh) {
  return drop.seed * 0xC2B2AE3Du + (uint32_t)bh * 0x27D4EB2Fu;
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

// ------------------------------------------------------ fp32 tile steps

// The forward's running state for the calling thread's 4 q rows.
template <int D>
struct FwdAcc {
  float m[4], l[4], acc[4][D / 16];
};

template <int D>
__device__ __forceinline__ void fwd_init(FwdAcc<D>& st) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    st.m[i] = -INFINITY;
    st.l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) st.acc[i][c] = 0.f;
  }
}

// One kv tile (columns c0..c0+63, staged: ks [64][D + 1], vs [64][D])
// against the q tile at q0 (qt [D][64], transposed); pt is [64][kLdP]
// scratch for p.
template <typename T, int D>
__device__ __forceinline__ void fwd_tile(FwdAcc<D>& st, const float* qt,
                                         const float* ks, const float* vs,
                                         float* pt, int q0, int c0,
                                         int causal, int offset, float scale,
                                         const Dropout& drop, uint32_t key) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
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
    const float m_new = fmaxf(st.m[i], half_warp_max(mx));
    const float m_use = safe_max(m_new);
    const float alpha = expf(st.m[i] - m_use);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      p[i][j] = expf(s[i][j] - m_use);
      rs += p[i][j];
    }
    st.l[i] = alpha * st.l[i] + half_warp_sum(rs);
    st.m[i] = m_new;
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
    for (int c = 0; c < D / 16; ++c) st.acc[i][c] *= alpha;
  }
  store_transposed(pt, p);
  __syncthreads();
  tile_fma<D / 16>(st.acc, pt, kLdP, vs, D, 1, kTile);
}

// out = acc / l and lse = m + log(l) for the thread's rows; 0 and -inf
// for a row that saw no unmasked column.
template <typename T, int D>
__device__ __forceinline__ void fwd_store(const FwdAcc<D>& st, T* out,
                                          float* lse, int row0) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + 4 * ty + i;
    T* orow = out + (size_t)row * D;
    const bool seen = st.l[i] > 0.f;
    const float inv = seen ? 1.f / st.l[i] : 0.f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c)
      orow[tx + 16 * c] = from_float<T>(st.acc[i][c] * inv);
    if (tx == 0) lse[row] = seen ? st.m[i] + logf(st.l[i]) : -INFINITY;
  }
}

// dq += ds . k over one kv tile (ks, vs [64][D + 1]); qt, dot [D][64]
// hold the q tile and its output gradient transposed; dst is [64][kLdP]
// scratch for ds.
template <typename T, int D>
__device__ __forceinline__ void dq_tile(float (&acc)[4][D / 16],
                                        const float* qt, const float* dot,
                                        const float* ks, const float* vs,
                                        float* dst, const float (&lse_r)[4],
                                        const float (&dl_r)[4], int q0,
                                        int c0, int causal, int offset,
                                        float scale, const Dropout& drop,
                                        uint32_t key) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
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
  tile_fma<D / 16>(acc, dst, kLdP, ks, D + 1, 1, kTile);
}

// dv += p_drop^T . do and dk += ds^T . q over one q tile (qs, dos
// [64][D + 1], lse_s and dl_s its 64 rows' lse and delta) for the kv tile
// at c0 (kt, vt [D][64], transposed); xs, ys are [64][kLdP] scratch.
template <typename T, int D>
__device__ __forceinline__ void dkv_tile(
    float (&dk_acc)[4][D / 16], float (&dv_acc)[4][D / 16], const float* kt,
    const float* vt, const float* qs, const float* dos, const float* lse_s,
    const float* dl_s, float* xs, float* ys, int r0, int c0, int causal,
    int offset, float scale, const Dropout& drop, uint32_t key) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
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
  tile_fma<D / 16>(dv_acc, xs, kLdP, dos, D + 1, 1, kTile);
  tile_fma<D / 16>(dk_acc, ys, kLdP, qs, D + 1, 1, kTile);
}

// Store the thread's dk and dv rows of the kv tile starting at row0.
template <typename T, int D>
__device__ __forceinline__ void dkv_store(const float (&dk_acc)[4][D / 16],
                                          const float (&dv_acc)[4][D / 16],
                                          T* dk, T* dv, size_t row0) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t base = (row0 + 4 * ty + i) * D;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      dk[base + tx + 16 * c] = from_float<T>(dk_acc[i][c]);
      dv[base + tx + 16 * c] = from_float<T>(dv_acc[i][c]);
    }
  }
}

// ------------------------------------------ bf16: tensor cores (mma.sync)
//
// A thread holds rows g and g + 8 (g = lane / 4) of its warp's 16 rows at
// columns 2 * (lane % 4) + {0, 1} of every 8-column accumulator tile, so
// row reductions are two shuffles within a group of 4 lanes.

constexpr int kWarpsMma = 4;
constexpr int kThreadsMma = 32 * kWarpsMma;
// dK/dV: a block owns a 64-row kv tile (16 rows per warp) and walks q
// tiles of 32 rows, which keeps the transposed scores, dp and both
// accumulators in registers.
constexpr int kQTileKV = 32;

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

// The forward's running state for the calling thread's two q rows.
template <int D>
struct FwdAccMma {
  float o[D / 8][4];
  float m[2], l[2];
  int rows[2];
};

template <int D>
__device__ __forceinline__ void fwd_init_mma(FwdAccMma<D>& st, int q0) {
  const int warp = threadIdx.x / 32, g = (threadIdx.x % 32) >> 2;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.o[j][e] = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    st.m[h] = -INFINITY;
    st.l[h] = 0.f;
    st.rows[h] = q0 + warp * 16 + g + 8 * h;
  }
}

// One kv tile (columns c0..c0+63, ks and vs staged) against the warp's 16
// rows of the q tile qs.
template <int D>
__device__ __forceinline__ void fwd_tile_mma(FwdAccMma<D>& st,
                                             const __nv_bfloat16* qs,
                                             const __nv_bfloat16* ks,
                                             const __nv_bfloat16* vs, int c0,
                                             int causal, int offset,
                                             float scale, const Dropout& drop,
                                             uint32_t key) {
  const int warp = threadIdx.x / 32, tig = threadIdx.x % 4;
  float s[kTile / 8][4] = {};
  mma_abt<D, kTile / 8>(s, qs, warp * 16, ks);
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = c0 + j * 8 + 2 * tig + (e & 1);
      float x = s[j][e] * scale;
      if (causal && st.rows[e >> 1] + offset < col) x = -INFINITY;
      s[j][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float alpha[2], m_use[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m_new = fmaxf(st.m[h], quad_max(mx[h]));
    m_use[h] = safe_max(m_new);
    alpha[h] = expf(st.m[h] - m_use[h]);
    st.m[h] = m_new;
  }
#pragma unroll
  for (int j = 0; j < kTile / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = expf(s[j][e] - m_use[e >> 1]);
      rs[e >> 1] += p;
      float pd = p;
      if (drop.on) {
        const uint32_t bits = dropout_bits(
            key, st.rows[e >> 1], c0 + j * 8 + 2 * tig + (e & 1));
        pd = bits >= drop.threshold ? p / drop.keep_div : 0.f;
      }
      s[j][e] = pd;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) st.l[h] = alpha[h] * st.l[h] + quad_sum(rs[h]);
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.o[j][e] *= alpha[e >> 1];
  uint32_t pa[kTile / 16][4];
  to_a_frags<kTile / 8>(pa, s);
  mma_px<D, kTile / 16>(st.o, pa, vs);
}

// out = o / l and lse = m + log(l) for the warp's 16 rows (out points at
// the block's first row); 0 and -inf for a row that saw no unmasked
// column.
template <int D>
__device__ __forceinline__ void fwd_store_mma(const FwdAccMma<D>& st,
                                              __nv_bfloat16* out, float* lse,
                                              int q0) {
  const int warp = threadIdx.x / 32, tig = threadIdx.x % 4;
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) inv[h] = st.l[h] > 0.f ? 1.f / st.l[h] : 0.f;
  store_rows_bf16<D>(out + (size_t)(q0 + warp * 16) * D, st.o, inv);
  if (tig == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      lse[st.rows[h]] =
          st.l[h] > 0.f ? st.m[h] + logf(st.l[h]) : -INFINITY;
}

// dq += ds . k over one kv tile for the warp's 16 rows (rows[h], with
// their lse and delta) of the q tile qs and its output gradient dos.
template <int D>
__device__ __forceinline__ void dq_tile_mma(
    float (&acc)[D / 8][4], const __nv_bfloat16* qs,
    const __nv_bfloat16* dos, const __nv_bfloat16* ks,
    const __nv_bfloat16* vs, const int (&rows)[2], const float (&lse_r)[2],
    const float (&dl_r)[2], int c0, int causal, int offset, float scale,
    const Dropout& drop, uint32_t key) {
  const int warp = threadIdx.x / 32, tig = threadIdx.x % 4;
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

// dv += p_drop^T . do and dk += ds^T . q over one 32-row q tile (qs, dos,
// lse_s, dl_s) for the warp's 16 kv rows cols[h] of the kv tile ks, vs.
template <int D>
__device__ __forceinline__ void dkv_tile_mma(
    float (&dk_acc)[D / 8][4], float (&dv_acc)[D / 8][4],
    const __nv_bfloat16* ks, const __nv_bfloat16* vs,
    const __nv_bfloat16* qs, const __nv_bfloat16* dos, const float* lse_s,
    const float* dl_s, const int (&cols)[2], int r0, int causal, int offset,
    float scale, const Dropout& drop, uint32_t key) {
  const int warp = threadIdx.x / 32, tig = threadIdx.x % 4;
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

// ---------------------------------------------------------------- launch

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Dynamic shared memory of each kernel family's blocks, in bytes.
template <int D>
constexpr size_t fwd_smem() {
  return (size_t)(2 * D * kTile + kTile * (D + 1) + kTile * kLdP) *
         sizeof(float);
}
template <int D>
constexpr size_t dq_smem() {
  return (size_t)(2 * D * kTile + 2 * kTile * (D + 1) + kTile * kLdP) *
         sizeof(float);
}
template <int D>
constexpr size_t dkv_smem() {
  return (size_t)(2 * D * kTile + 2 * kTile * (D + 1) + 2 * kTile * kLdP +
                  2 * kTile) *
         sizeof(float);
}
template <int D>
constexpr size_t fwd_smem_mma() {
  return (size_t)3 * kTile * (D + 8) * sizeof(__nv_bfloat16);
}
template <int D>
constexpr size_t dq_smem_mma() {
  return (size_t)4 * kTile * (D + 8) * sizeof(__nv_bfloat16);
}
template <int D>
constexpr size_t dkv_smem_mma() {
  return (size_t)(2 * kTile + 2 * kQTileKV) * (D + 8) *
             sizeof(__nv_bfloat16) +
         2 * kQTileKV * sizeof(float);
}

}  // namespace
