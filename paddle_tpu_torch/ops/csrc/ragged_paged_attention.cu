// Ragged paged attention for Hopper (sm_90a), written by hand: two kernels
// over the paged pools
//     k_pool, v_pool  [N, B, H, D]   (token stride H * D)
//
// 1. `rpa_chunked_kernel` replaces the Pallas TPU kernel
//    `_rpa_chunked_kernel` (paddle_tpu/ops/pallas/ragged_paged_attention.py)
//    behind `ragged_paged_attention_chunked`: a step's token rows are
//    grouped into segments (up to TQ consecutive rows of one sequence
//    sharing one block table); row i of segment s sits at cache position
//    seg_pos[s] + i and attends every cached position <= its own.
// 2. `rpa_row_kernel` (below the first) replaces `_rpa_kernel`, the
//    per-row decode kernel of the same file, behind
//    `ragged_paged_attention`: row s is one query token and attends cache
//    positions p < min(seq_lens[s], MAXB * B).
//
// Bound: on the serving path this is a bytes-bound kernel. Each (segment,
// head) reads ceil((seg_pos + seg_rows) / B) blocks of K and V and does
// 4 * D flops per (row, kv token) -- at most TQ = 8 rows reuse each K/V
// element, far below the ~295 flop/byte the card needs before compute
// limits. The design keeps every K/V element read from device memory once
// per (segment, head) and nothing else:
//   * one thread block per (segment, head); inactive segments exit at once;
//   * the block loops over exactly the KV blocks its segment needs (the
//     Pallas grid walks all MAXB blocks and predicates);
//   * per KV block, all 128 threads stage K and V for this head into shared
//     memory as fp32 with 16-byte loads, then each warp takes every 4th
//     token: a lane holds D/32 elements of every query row of the tile in
//     registers, so one staged K row serves all TQ rows (scores are warp
//     shuffle reductions) and one staged V row updates all TQ accumulators;
//   * each warp runs its own online softmax in fp32 (running max m, sum l,
//     accumulator acc per row); masked tokens are skipped outright, which is
//     the CUDA form of the Pallas kernel's finite stand-in for fully masked
//     rows: a row's m stays -inf until its first valid token, and
//     exp(-inf - finite) = 0 rescales the empty accumulator;
//   * at the end the 4 warps' partial states are merged through shared
//     memory and each valid row is written straight to
//     out[seg_row_idx[s, i]] -- no [S, TQ, H, D] intermediate.
// Rows that belong to no valid segment slot are never written; the wrapper
// hands in a zeroed output.
//
// Later work (not here): double-buffered cp.async/TMA staging, wgmma for
// long prefill tiles, and a pool layout with per-head contiguous blocks.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxTQ = 8;

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Copy one head's [B, D] slice of a pool block into shared memory as fp32.
// src points at (block, token 0, head h, 0); consecutive tokens are
// token_stride elements apart.
template <typename T, int D>
__device__ __forceinline__ void stage_block(const T* __restrict__ src,
                                            float* __restrict__ dst,
                                            int block_size,
                                            int token_stride) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int kVecPerRow = D / kVec;
  const int total = block_size * kVecPerRow;
  for (int v = threadIdx.x; v < total; v += kThreads) {
    const int t = v / kVecPerRow;
    const int c = (v % kVecPerRow) * kVec;
    const uint4 raw = *reinterpret_cast<const uint4*>(
        src + (size_t)t * token_stride + c);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int u = 0; u < kVec; ++u) dst[t * D + c + u] = to_float<T>(e[u]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
rpa_chunked_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                   const T* __restrict__ v_pool,
                   const int* __restrict__ seg_tables,
                   const int* __restrict__ seg_pos,
                   const int* __restrict__ seg_rows,
                   const int* __restrict__ seg_row_idx,
                   T* __restrict__ out, int n_heads, int block_size,
                   int max_blocks, int tq, float scale) {
  constexpr int kPer = D / 32;  // elements of a D-vector per lane
  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int n_rows = min(seg_rows[s], tq);
  if (n_rows <= 0) return;
  const int pos0 = seg_pos[s];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int token_stride = n_heads * D;

  extern __shared__ float smem[];
  float* ks = smem;                    // [B, D]
  float* vs = smem + block_size * D;   // [B, D]

  float qr[kMaxTQ][kPer];
  float m[kMaxTQ], l[kMaxTQ], acc[kMaxTQ][kPer];
#pragma unroll
  for (int i = 0; i < kMaxTQ; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kPer; ++c) {
      acc[i][c] = 0.f;
      qr[i][c] = 0.f;
    }
    if (i < n_rows) {
      const T* qrow =
          q + ((size_t)seg_row_idx[s * tq + i] * n_heads + h) * D;
#pragma unroll
      for (int c = 0; c < kPer; ++c)
        qr[i][c] = to_float<T>(qrow[lane + 32 * c]) * scale;
    }
  }

  // the segment's last row attends kv positions [0, pos0 + n_rows)
  const int kv_len = pos0 + n_rows;
  const int n_blocks = min((kv_len + block_size - 1) / block_size,
                           max_blocks);
  const int* table = seg_tables + (size_t)s * max_blocks;
  for (int b = 0; b < n_blocks; ++b) {
    const size_t base =
        ((size_t)table[b] * block_size * n_heads + h) * D;
    __syncthreads();  // every warp is done with the previous block
    stage_block<T, D>(k_pool + base, ks, block_size, token_stride);
    stage_block<T, D>(v_pool + base, vs, block_size, token_stride);
    __syncthreads();
    for (int j = warp; j < block_size; j += kWarps) {
      const int kv_pos = b * block_size + j;
      if (kv_pos >= kv_len) break;
      float kr[kPer], vr[kPer];
#pragma unroll
      for (int c = 0; c < kPer; ++c) {
        kr[c] = ks[j * D + lane + 32 * c];
        vr[c] = vs[j * D + lane + 32 * c];
      }
#pragma unroll
      for (int i = 0; i < kMaxTQ; ++i) {
        // row i attends kv positions <= pos0 + i: causal inside the tile
        if (i >= n_rows || kv_pos > pos0 + i) continue;
        float part = 0.f;
#pragma unroll
        for (int c = 0; c < kPer; ++c) part += qr[i][c] * kr[c];
        const float score = warp_sum(part);
        const float m_new = fmaxf(m[i], score);
        const float alpha = expf(m[i] - m_new);
        const float p = expf(score - m_new);
        l[i] = l[i] * alpha + p;
#pragma unroll
        for (int c = 0; c < kPer; ++c) acc[i][c] = acc[i][c] * alpha + p * vr[c];
        m[i] = m_new;
      }
    }
  }

  // merge the warps' partial softmax states: red[w][i] = (acc[D], m, l)
  __syncthreads();
  float* red = smem;
#pragma unroll
  for (int i = 0; i < kMaxTQ; ++i) {
    if (i >= n_rows) continue;
    float* r = red + (warp * kMaxTQ + i) * (D + 2);
#pragma unroll
    for (int c = 0; c < kPer; ++c) r[lane + 32 * c] = acc[i][c];
    if (lane == 0) {
      r[D] = m[i];
      r[D + 1] = l[i];
    }
  }
  __syncthreads();
  for (int i = warp; i < n_rows; i += kWarps) {
    float m_all = -INFINITY;
    for (int w = 0; w < kWarps; ++w)
      m_all = fmaxf(m_all, red[(w * kMaxTQ + i) * (D + 2) + D]);
    float l_all = 0.f;
    float o[kPer];
#pragma unroll
    for (int c = 0; c < kPer; ++c) o[c] = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float* r = red + (w * kMaxTQ + i) * (D + 2);
      if (r[D] == -INFINITY) continue;  // this warp saw no token of row i
      const float f = expf(r[D] - m_all);
      l_all += r[D + 1] * f;
#pragma unroll
      for (int c = 0; c < kPer; ++c) o[c] += r[lane + 32 * c] * f;
    }
    const float inv = l_all > 0.f ? 1.f / l_all : 0.f;
    T* orow = out + ((size_t)seg_row_idx[s * tq + i] * n_heads + h) * D;
#pragma unroll
    for (int c = 0; c < kPer; ++c)
      orow[lane + 32 * c] = from_float<T>(o[c] * inv);
  }
}

// ------------------------------------------------------------ per row
//
// `rpa_row_kernel`: one query token a row. Bound by bytes like the chunked
// kernel: a (row, head) reads min(len, MAXB * B) tokens of K and V once and
// does 4 * D flops per token, one token's K/V serving one query. Design:
//   * one thread block per (row, head); a row of length <= 0 writes zeros
//     and exits, and the block walks exactly the tokens the row attends, in
//     chunks of kRowChunk tokens (the Pallas grid walks all MAXB blocks and
//     predicates; table entries past the row's need are never read);
//   * per chunk, the block stages this head's K and V of every token into
//     shared memory in the pools' dtype with 16-byte copies, all of a
//     thread's loads issued before its stores. Rows are padded by 32 bytes
//     so that the score reads below hit distinct banks;
//   * scores: two threads a token, each over alternate 16-byte vectors of
//     D against q in shared memory (fp32, scaled once), one shuffle to add
//     the halves -- not a 5-step warp reduction per token;
//   * the online softmax is updated once a chunk: the chunk's max and sum
//     come from one warp reduction and one pass through shared memory, the
//     running max m and sum l are the same in every thread;
//   * P.V: a thread owns one output column over every kGroups-th token of
//     the chunk (kGroups = 128 / D) and rescales its accumulator once a
//     chunk; the groups are added through shared memory at the end.
// Everything accumulates in fp32; the output is cast once, at the end.
// Left to later work: split-KV across blocks for long rows with a merge
// pass (a 16-row decode step is 16 * H blocks, fewer than 2 per SM at
// H = 16), cp.async/TMA double buffering, a head-contiguous pool layout.

constexpr int kRowChunk = 64;  // tokens staged per iteration: 2 per thread

template <typename T, int D>
struct RowTile {
  static constexpr int kVec = 16 / sizeof(T);        // elements a copy
  static constexpr int kVecPerRow = D / kVec;
  static constexpr int kPitch = D + 2 * kVec;        // row + 32 bytes
  static constexpr int kCopies = kRowChunk * kVecPerRow / kThreads;
  static constexpr int kGroups = kThreads / D;       // threads a column
  static constexpr size_t kStageBytes =
      (size_t)kRowChunk * kPitch * sizeof(T);        // K or V of a chunk
  static constexpr size_t kSmemBytes =
      2 * kStageBytes + (D + kRowChunk + 2 * kWarps) * sizeof(float);
  static_assert(kRowChunk * kVecPerRow % kThreads == 0, "copies");
  static_assert(kThreads % D == 0 && 2 * kRowChunk == kThreads, "threads");
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
rpa_row_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
               const T* __restrict__ v_pool,
               const int* __restrict__ block_tables,
               const int* __restrict__ seq_lens, T* __restrict__ out,
               int n_heads, int block_size, int max_blocks, float scale) {
  using Tile = RowTile<T, D>;
  constexpr int kVec = Tile::kVec;
  constexpr int kPitch = Tile::kPitch;
  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  T* orow = out + ((size_t)s * n_heads + h) * D;
  // the Pallas grid walks MAXB blocks: positions past MAXB * B are not seen
  const long long cap = (long long)max_blocks * block_size;
  const int kv_len = (int)min((long long)seq_lens[s], cap);
  if (kv_len <= 0) {
    for (int c = tid; c < D; c += kThreads) orow[c] = from_float<T>(0.f);
    return;
  }

  extern __shared__ __align__(16) unsigned char row_smem[];
  T* ks = reinterpret_cast<T*>(row_smem);                  // [chunk, pitch]
  T* vs = ks + kRowChunk * kPitch;                         // [chunk, pitch]
  float* qs = reinterpret_cast<float*>(vs + kRowChunk * kPitch);  // [D]
  float* ps = qs + D;                                      // [chunk]
  float* red_max = ps + kRowChunk;                         // [warps]
  float* red_sum = red_max + kWarps;                       // [warps]

  const T* qrow = q + ((size_t)s * n_heads + h) * D;
  for (int c = tid; c < D; c += kThreads)
    qs[c] = to_float<T>(qrow[c]) * scale;

  const int* table = block_tables + (size_t)s * max_blocks;
  const size_t token_stride = (size_t)n_heads * D;
  const int tok = tid >> 1;   // the chunk token this thread scores
  const int half = tid & 1;   // which alternate 16-byte vectors of it
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int col = tid % D;    // P.V: output column ...
  const int grp = tid / D;    // ... over tokens grp, grp + kGroups, ...
  float m = -INFINITY, l = 0.f, acc = 0.f;

  for (int c0 = 0; c0 < kv_len; c0 += kRowChunk) {
    const int n_tok = min(kRowChunk, kv_len - c0);
    __syncthreads();  // the previous chunk's K, V and p are consumed
    uint4 kbuf[Tile::kCopies], vbuf[Tile::kCopies];
#pragma unroll
    for (int i = 0; i < Tile::kCopies; ++i) {
      const int v = tid + i * kThreads;
      const int t = v / Tile::kVecPerRow;
      if (t < n_tok) {
        const int p = c0 + t;
        const size_t src =
            ((size_t)table[p / block_size] * block_size + p % block_size) *
                token_stride +
            (size_t)h * D + (v % Tile::kVecPerRow) * kVec;
        kbuf[i] = *reinterpret_cast<const uint4*>(k_pool + src);
        vbuf[i] = *reinterpret_cast<const uint4*>(v_pool + src);
      }
    }
#pragma unroll
    for (int i = 0; i < Tile::kCopies; ++i) {
      const int v = tid + i * kThreads;
      const int t = v / Tile::kVecPerRow;
      if (t < n_tok) {
        const int at = t * kPitch + (v % Tile::kVecPerRow) * kVec;
        *reinterpret_cast<uint4*>(ks + at) = kbuf[i];
        *reinterpret_cast<uint4*>(vs + at) = vbuf[i];
      }
    }
    __syncthreads();

    // tokens past the row's length (in the last chunk) are masked
    const bool live = tok < n_tok;
    float part = 0.f;
    if (live) {
#pragma unroll
      for (int j = 0; j < D / (2 * kVec); ++j) {
        const int e = (2 * j + half) * kVec;
        const uint4 raw = *reinterpret_cast<const uint4*>(
            ks + tok * kPitch + e);
        const T* kv = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int u = 0; u < kVec; ++u) part += qs[e + u] * to_float<T>(kv[u]);
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    const float score = live ? part : -INFINITY;

    float cmax = warp_max(score);
    if (lane == 0) red_max[warp] = cmax;
    __syncthreads();
    cmax = red_max[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) cmax = fmaxf(cmax, red_max[w]);
    const float m_new = fmaxf(m, cmax);
    const float p = live ? expf(score - m_new) : 0.f;
    if (half == 0) ps[tok] = p;
    const float psum = warp_sum(half == 0 ? p : 0.f);
    if (lane == 0) red_sum[warp] = psum;
    __syncthreads();
    float chunk_sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) chunk_sum += red_sum[w];
    const float alpha = m == -INFINITY ? 0.f : expf(m - m_new);
    l = l * alpha + chunk_sum;
    m = m_new;
    acc *= alpha;
    for (int t = grp; t < n_tok; t += Tile::kGroups)
      acc += ps[t] * to_float<T>(vs[t * kPitch + col]);
  }

  if (Tile::kGroups > 1) {
    float* merge = reinterpret_cast<float*>(row_smem);  // [groups, D]
    __syncthreads();  // every thread is done with ks
    merge[tid] = acc;
    __syncthreads();
    if (grp == 0)
      for (int g = 1; g < Tile::kGroups; ++g) acc += merge[g * D + col];
  }
  if (grp == 0) orow[col] = from_float<T>(acc / l);
}

// Launch `kernel` on a (rows, heads) grid of kThreads-thread blocks with
// `smem` bytes of dynamic shared memory (opted into past 48 KB).
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, size_t smem, int n_rows, int n_heads,
                   cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(n_rows, n_heads), kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <typename T, int D> struct Geometry {
  using type = T;
  static constexpr int head_dim = D;
};

template <typename T, typename F>
cudaError_t with_head_dim(int head_dim, F f) {
  switch (head_dim) {
    case 32: return f(Geometry<T, 32>());
    case 64: return f(Geometry<T, 64>());
    case 128: return f(Geometry<T, 128>());
    default: return cudaErrorInvalidValue;
  }
}

// Call f(Geometry<T, D>()) for the dtype code (0 = float32, 1 = bfloat16)
// and the head dim, or return cudaErrorInvalidValue for any other.
template <typename F>
cudaError_t dispatch(int dtype, int head_dim, F f) {
  if (dtype == 0) return with_head_dim<float>(head_dim, f);
  if (dtype == 1) return with_head_dim<__nv_bfloat16>(head_dim, f);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, pools and out share it). Returns a
// cudaError_t; nonzero means the kernel did not launch.
int rpa_chunked_launch(const void* q, const void* k_pool, const void* v_pool,
                       const void* seg_tables, const void* seg_pos,
                       const void* seg_rows, const void* seg_row_idx,
                       void* out, int n_seg, int n_heads, int head_dim,
                       int block_size, int max_blocks, int tq, float scale,
                       int dtype, void* stream) {
  if (tq < 1 || tq > kMaxTQ || n_seg < 1 || n_heads < 1 ||
      block_size < 1 || max_blocks < 1)
    return (int)cudaErrorInvalidValue;
  return (int)dispatch(dtype, head_dim, [&](auto g) {
    using T = typename decltype(g)::type;
    constexpr int D = decltype(g)::head_dim;
    const size_t stage = 2 * (size_t)block_size * D;
    const size_t merge = (size_t)kWarps * kMaxTQ * (D + 2);
    return launch(rpa_chunked_kernel<T, D>,
                  (stage > merge ? stage : merge) * sizeof(float), n_seg,
                  n_heads, static_cast<cudaStream_t>(stream),
                  static_cast<const T*>(q), static_cast<const T*>(k_pool),
                  static_cast<const T*>(v_pool),
                  static_cast<const int*>(seg_tables),
                  static_cast<const int*>(seg_pos),
                  static_cast<const int*>(seg_rows),
                  static_cast<const int*>(seg_row_idx), static_cast<T*>(out),
                  n_heads, block_size, max_blocks, tq, scale);
  });
}

// The per-row kernel: block_tables [n_rows, max_blocks] and seq_lens
// [n_rows] int32; dtype as above. max_blocks may be 0 (every row is zero).
int rpa_row_launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* block_tables, const void* seq_lens, void* out,
                   int n_rows, int n_heads, int head_dim, int block_size,
                   int max_blocks, float scale, int dtype, void* stream) {
  if (n_rows < 1 || n_heads < 1 || n_heads > 65535 || block_size < 1 ||
      max_blocks < 0)
    return (int)cudaErrorInvalidValue;
  return (int)dispatch(dtype, head_dim, [&](auto g) {
    using T = typename decltype(g)::type;
    constexpr int D = decltype(g)::head_dim;
    return launch(rpa_row_kernel<T, D>, RowTile<T, D>::kSmemBytes, n_rows,
                  n_heads, static_cast<cudaStream_t>(stream),
                  static_cast<const T*>(q), static_cast<const T*>(k_pool),
                  static_cast<const T*>(v_pool),
                  static_cast<const int*>(block_tables),
                  static_cast<const int*>(seq_lens), static_cast<T*>(out),
                  n_heads, block_size, max_blocks, scale);
  });
}

const char* rpa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
