// Tile steps shared by the flash attention kernels (flash_attention.cu)
// and the block-sparse attention kernels (block_sparse_attention.cu).
//
// Both families walk 64-row q tiles against 64-row kv tiles; they differ
// only in which tiles they walk: every tile up to the causal diagonal
// (flash) or the tiles of a q block's compacted list of active kv blocks
// (block-sparse). So the work on one pair of tiles lives here, once, as a
// step function a kernel calls from its own loop:
//   fwd_tile   online softmax over one kv tile
//   dq_tile    dq += ds . k over one kv tile
//   dkv_tile   dv += p^T . do, dk += ds^T . q over one q tile
// and the forward's epilogue (fwd_store). The walk itself is a BlockList:
// a block-sparse kernel's compacted list, or the dense list a flash
// kernel walks (dense_list). Each step comes in two halves: the scores
// over the head dim, and the update given the scores (fwd_update,
// dq_update, dkv_update); the fp32 dQ kernel past D 128
// (wide_attention.cuh) calls dq_update on scores it sums over 64-column
// chunks. These are the fp32 steps, on the FMA units; the bf16 steps on
// wgmma are in attention_wgmma.cuh, the fp32 forward and dK/dV past D 128
// on TF32 tensor cores in attention_tf32.cuh.
//
// Masked scores are -inf. The running max is -inf-safe: while every
// column a row has seen is masked, its max stays -inf and the step
// exponentiates against 0 instead, so the rescale factor and p are 0, not
// exp(-inf - (-inf)) = NaN. A row that sees no unmasked column at all
// (possible in block-sparse causal attention) ends with l = 0: its output
// is written as 0 and its lse as -inf, and the backward steps give it
// p = 0 (every one of its scores is masked).
//
// 256 threads as 16 x 16, a thread owning a 4 x 4 block of the 64 x 64
// score tile (rows 4*ty..4*ty+3, columns tx + 16*j) and a 4 x (D/16) block
// of the accumulators. Typed on the inputs' T: p and ds are rounded to T,
// as the reference does.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;        // rows of a q tile and of a kv tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kLdP = kTile + 4;  // row stride of the P / dS tiles

// The other side's tiles a kernel walks for its own tile at row row0: the
// tile's logical block is row0 / blk_own, whose list holds idx[blk *
// width + a] for a < count[blk], each a block of blk_other rows. With idx
// null the list is one block of blk_other rows at row 0: the flash
// kernels' dense walk. order, where given, lists the own side's blocks in
// the order their thread blocks launch (the wgmma kernels').
struct BlockList {
  const int* idx;
  const int* count;
  const int* order;
  int width;
  int blk_own;
  int blk_other;
};

__host__ __device__ inline BlockList dense_list(int n_other) {
  return BlockList{nullptr, nullptr, nullptr, 1, kTile, n_other};
}

__device__ __forceinline__ int list_len(const BlockList& L, int blk) {
  return L.idx == nullptr ? 1 : L.count[blk];
}

__device__ __forceinline__ int list_row(const BlockList& L, int blk, int a) {
  return (L.idx == nullptr ? 0 : L.idx[blk * L.width + a]) * L.blk_other;
}

// The walk's R-row tiles of the other side, in list order: entry a of the
// block's list, tile sub of that entry (the next entry's row is read at
// the end of the step before its first tile).
template <int R>
struct TileWalk {
  const int* idx;  // the block's list, or null: one entry at row 0
  int n, per_entry, blk_other, a = 0, sub = 0, row;
  __device__ TileWalk(const BlockList& L, int blk)
      : idx(L.idx == nullptr ? nullptr : L.idx + blk * L.width),
        n(list_len(L, blk)),
        per_entry(L.blk_other / R),
        blk_other(L.blk_other),
        row(idx == nullptr ? 0 : idx[0] * L.blk_other) {}
  __device__ int col() const { return row + sub * R; }
  __device__ void next() {
    if (++sub == per_entry) {
      sub = 0;
      if (++a < n) row = idx[a] * blk_other;
    }
  }
};

template <int N>
struct IntC {
  static constexpr int value = N;
};

// f(IntC<d>{}) for a padded head dim d of Lo, Lo + 64, ..., 512 (the
// head dims past 128 a kernel is built for); any other d is refused.
template <int Lo, typename F>
cudaError_t head_dim_from(int d, const F& f) {
  if constexpr (Lo > 512)
    return cudaErrorInvalidValue;
  else
    return d == Lo ? f(IntC<Lo>{}) : head_dim_from<Lo + 64>(d, f);
}

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

// Row reductions over the 4 lanes that hold one row of an mma (or wgmma)
// accumulator.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
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

// D columns of 64 rows of a row-major matrix (row pitch `pitch`, D by
// default) into shared memory as fp32, row stride `ld` (D or D + 1):
// dst[r * ld + d].
template <typename T, int D>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src,
                                           float* __restrict__ dst, int ld,
                                           int pitch = D) {
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D, d = e % D;
    dst[r * ld + d] = to_float<T>(src[(size_t)r * pitch + d]);
  }
}

// D columns of 64 rows of a row-major matrix (row pitch `pitch`, D by
// default) into shared memory transposed, as fp32: dst[d * kTile + r].
// 16-byte loads; consecutive threads take consecutive rows, so the
// transposed stores are conflict-free.
template <typename T, int D>
__device__ __forceinline__ void stage_cols(const T* __restrict__ src,
                                           float* __restrict__ dst,
                                           int pitch = D) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;
  for (int e = threadIdx.x; e < kTile * kChunks; e += kThreads) {
    const int r = e % kTile;
    const int c = (e / kTile) * kVec;
    const uint4 raw =
        *reinterpret_cast<const uint4*>(src + (size_t)r * pitch + c);
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

// The online softmax over one kv tile (columns c0..c0+63) of the q tile
// at q0, given its scores s = q k^T (the thread's 4 x 4 block, unscaled):
// acc += p v over vs [64][D] (D columns of v); pt is [64][kLdP] scratch
// for p. Its barrier also publishes vs, staged since the last one.
template <typename T, int D>
__device__ __forceinline__ void fwd_update(FwdAcc<D>& st, float (&s)[4][4],
                                           const float* vs, float* pt,
                                           int q0, int c0, int causal,
                                           int offset, float scale,
                                           const Dropout& drop,
                                           uint32_t key) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
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

// One kv tile (columns c0..c0+63, staged: ks [64][D + 1], vs [64][D])
// against the q tile at q0 (qt [D][64], transposed); pt is [64][kLdP]
// scratch for p.
template <typename T, int D>
__device__ __forceinline__ void fwd_tile(FwdAcc<D>& st, const float* qt,
                                         const float* ks, const float* vs,
                                         float* pt, int q0, int c0,
                                         int causal, int offset, float scale,
                                         const Dropout& drop, uint32_t key) {
  float s[4][4] = {};
  tile_fma<4>(s, qt, kTile, ks, 1, D + 1, D);
  fwd_update<T, D>(st, s, vs, pt, q0, c0, causal, offset, scale, drop, key);
}

// out = acc / l and lse = m + log(l) for the thread's rows (out: D
// columns of rows of pitch `pitch`, D by default; lse skipped when null);
// 0 and -inf for a row that saw no unmasked column.
template <typename T, int D>
__device__ __forceinline__ void fwd_store(const FwdAcc<D>& st, T* out,
                                          float* lse, int row0,
                                          int pitch = D) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + 4 * ty + i;
    T* orow = out + (size_t)row * pitch;
    const bool seen = st.l[i] > 0.f;
    const float inv = seen ? 1.f / st.l[i] : 0.f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c)
      orow[tx + 16 * c] = from_float<T>(st.acc[i][c] * inv);
    if (tx == 0 && lse != nullptr)
      lse[row] = seen ? st.m[i] + logf(st.l[i]) : -INFINITY;
  }
}

// dq += ds . k over one kv tile, given its scores s = q k^T and dp =
// do v^T (the thread's 4 x 4 blocks): ks [64][D + 1] holds D columns of
// k; dst is [64][kLdP] scratch for ds. Its barrier also publishes ks,
// staged since the last one.
template <typename T, int D>
__device__ __forceinline__ void dq_update(
    float (&acc)[4][D / 16], const float (&s)[4][4], const float (&dp)[4][4],
    const float* ks, float* dst, const float (&lse_r)[4],
    const float (&dl_r)[4], int q0, int c0, int causal, int offset,
    float scale, const Dropout& drop, uint32_t key) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
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
  float s[4][4] = {}, dp[4][4] = {};
  tile_fma<4>(s, qt, kTile, ks, 1, D + 1, D);
  tile_fma<4>(dp, dot, kTile, vs, 1, D + 1, D);
  dq_update<T, D>(acc, s, dp, ks, dst, lse_r, dl_r, q0, c0, causal, offset,
                  scale, drop, key);
}

// dv += p_drop^T . do and dk += ds^T . q over one q tile at r0 for the
// kv tile at c0, given the transposed scores s = k q^T and dp = v do^T
// (the thread's 4 x 4 blocks; rows are kv columns, columns q rows): qs,
// dos [64][D + 1] hold D columns of q and do, lse_s and dl_s the q rows'
// lse and delta (read before its barrier: published by the caller); xs,
// ys are [64][kLdP] scratch. Its barrier also publishes qs and dos,
// staged since the last one.
template <typename T, int D>
__device__ __forceinline__ void dkv_update(
    float (&dk_acc)[4][D / 16], float (&dv_acc)[4][D / 16],
    const float (&s)[4][4], const float (&dp)[4][4], const float* qs,
    const float* dos, const float* lse_s, const float* dl_s, float* xs,
    float* ys, int r0, int c0, int causal, int offset, float scale,
    const Dropout& drop, uint32_t key) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
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

// dv += p_drop^T . do and dk += ds^T . q over one q tile (qs, dos
// [64][D + 1], lse_s and dl_s its 64 rows' lse and delta) for the kv tile
// at c0 (kt, vt [D][64], transposed); xs, ys are [64][kLdP] scratch.
template <typename T, int D>
__device__ __forceinline__ void dkv_tile(
    float (&dk_acc)[4][D / 16], float (&dv_acc)[4][D / 16], const float* kt,
    const float* vt, const float* qs, const float* dos, const float* lse_s,
    const float* dl_s, float* xs, float* ys, int r0, int c0, int causal,
    int offset, float scale, const Dropout& drop, uint32_t key) {
  float s[4][4] = {}, dp[4][4] = {};
  tile_fma<4>(s, kt, kTile, qs, 1, D + 1, D);
  tile_fma<4>(dp, vt, kTile, dos, 1, D + 1, D);
  dkv_update<T, D>(dk_acc, dv_acc, s, dp, qs, dos, lse_s, dl_s, xs, ys, r0,
                   c0, causal, offset, scale, drop, key);
}

// Store the thread's dk and dv rows of the kv tile starting at row0 (D
// columns of rows of pitch `pitch`, D by default).
template <typename T, int D>
__device__ __forceinline__ void dkv_store(const float (&dk_acc)[4][D / 16],
                                          const float (&dv_acc)[4][D / 16],
                                          T* dk, T* dv, size_t row0,
                                          int pitch = D) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t base = (row0 + 4 * ty + i) * pitch;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      dk[base + tx + 16 * c] = from_float<T>(dk_acc[i][c]);
      dv[base + tx + 16 * c] = from_float<T>(dv_acc[i][c]);
    }
  }
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

}  // namespace
