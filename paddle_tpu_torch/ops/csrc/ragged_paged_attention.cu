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
// Head dims. Both kernels are instantiated at D = 16, 32, 64, 128, 256 and
// 512 (the reference's gates stop at 512); the launchers in
// ragged_paged_attention.py pad any other head dim up to the next of these
// (the serving engine allocates its pools padded, so it never copies).
//
// Bound: on the serving path this is a bytes-bound kernel. Each (segment,
// head) reads ceil((seg_pos + seg_rows) / B) blocks of K and V and does
// 4 * D flops per (row, kv token); at TQ = 8 rows a K/V element serves 8
// rows, far below the ~295 flop/byte the card needs before compute limits.
// The segmented kernel's design keeps every K/V element read from device
// memory once per (segment, head) and spreads the reads over the card:
//   * split-KV: the grid is (split, head, segment), from static shapes
//     only; split j of a segment covers kv positions [j S, (j + 1) S), S a
//     multiple of 64 picked by the launcher (ragged_paged_attention.py
//     split_plan). Blocks past a segment's length, and every block of an
//     inactive segment, exit after reading two ints. A block first turns
//     its split's block-table entries into the pool row of every token,
//     in shared memory;
//   * a decode segment (one row) reads K and V straight into registers: a
//     group of lanes per token, 16 bytes a lane, a step's loads in flight
//     while the step before is scored, one online-softmax update per
//     group per step, no barrier in the loop (run_row);
//   * a tile of 2..16 rows (bf16, D <= 128) stages each 64-token chunk of
//     K and V through a two-stage cp.async ring in the pools' dtype and
//     runs on tensor cores: each warp takes 16 tokens of the chunk against
//     the 16-row tile with mma.sync (S = q k^T, then O += p v from p
//     re-packed in registers) and keeps its own online softmax; the warps
//     are merged at the end (run_pass_mma). Wider tiles, fp32 and D >= 256
//     run the same ring on the FMA units: a score tile of 8 rows against
//     the chunk's tokens spread over the threads, one softmax update a
//     chunk a row, P.V into fp32 accumulators in shared memory
//     (run_pass);
//   * rows beyond what one pass holds (64 at D = 128, 16 at D = 512) run
//     in further passes over the split, so any q_tile runs. Each further
//     pass reads the split's K/V again (from L2 while it fits there):
//     only tiles of at most one pass keep the rule of one read per
//     (segment, head);
//   * a segment whose length fits one split writes its rows straight to
//     out[seg_row_idx[s, i]]. Otherwise each split writes its unnormalised
//     fp32 rows with their running max m and sum l to a workspace, and the
//     last block of the (segment, head) to finish (an atomic counter,
//     which it resets to 0 for the next launch) merges them into out.
//     A split covers at most kMaxSplit positions, so that its pool rows
//     fit shared memory beside the ring and a pass.
// Everything accumulates in fp32 (p enters the tensor-core P.V as two bf16
// parts, high and low, so it keeps about 16 bits).
// Rows that belong to no valid segment slot are never written; the
// wrapper hands in a zeroed output.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// 16 bytes from global to shared memory without passing through registers;
// with full == false nothing is read and the 16 bytes are zeroed.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

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

// (a, b) as a packed bf16 pair hi and the packed bf16 pair of what the
// rounding left, lo: hi + lo holds each value to about 16 bits.
__device__ __forceinline__ void split_bf16(uint32_t& hi, uint32_t& lo,
                                           float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// One thread's 16-byte vector of T as kVec floats.
template <typename T>
__device__ __forceinline__ void unpack16(const T* p, float* f) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int u = 0; u < 16 / (int)sizeof(T); ++u) f[u] = to_float<T>(e[u]);
}

// ------------------------------------------------------------- segmented

// Geometry of the segmented kernel (ops/paged_splits.py times other
// values of kStageBytes and kRowUnroll)
constexpr int kStageBytes = 32 * 1024;  // K and V of one chunk, at most
constexpr int kStages = 2;      // chunks in the cp.async ring
constexpr int kRowUnroll = 4;   // 16-byte K loads a lane a decode step
constexpr int kGroupRows = 8;   // rows of a score tile
constexpr int kMaxChunk = 64;   // tokens of a chunk, at most
constexpr int kPassBytes = 64 * 1024;  // q and accumulators of a pass
constexpr int kMmaRows = 16;    // rows of a tensor-core tile (mma m16)
constexpr int kMaxSplit = 8192; // kv positions a split, at most
constexpr size_t kSmemOptIn = 227 * 1024;  // the H100's opt-in limit

template <typename T, int D>
struct SegTile {
  static constexpr int kVec = 16 / sizeof(T);          // elements a copy
  static constexpr int kVecPerTok = D / kVec;
  static constexpr int kFit = kStageBytes / (2 * D * (int)sizeof(T));
  static constexpr int kChunk =
      kFit < 8 ? 8 : (kFit < kMaxChunk ? kFit : kMaxChunk);
  static constexpr int kTpt = kThreads / kChunk;        // threads a token
  static constexpr int kVecPerThr = kVecPerTok / kTpt;
  // Tiles of 2..16 rows run on tensor cores (bf16, D <= 128, 64-token
  // chunks: four warps of 16 tokens), the others on the FMA units.
  static constexpr bool kMma =
      sizeof(T) == 2 && D <= 128 && kChunk == kMaxChunk;
  // pad a row: 16 bytes puts the 8 rows of an ldmatrix on distinct banks;
  // 32 (64) bytes do so for the FMA path's 16-byte score reads of 4 (2)
  // tokens a quarter-warp
  static constexpr int kPitch =
      D + (kMma ? 16 : kTpt == 2 ? 32 : 64) / (int)sizeof(T);
  static constexpr int kCopies = kChunk * kVecPerTok / kThreads;
  static constexpr int kMaxRows = kPassBytes / (8 * D);  // rows a pass
  // P.V: kColThreads threads over the columns, kRowThreads over the rows
  static constexpr int kColThreads = D < kThreads ? D : kThreads;
  static constexpr int kRowThreads = kThreads / kColThreads;
  static constexpr int kColsPer = D / kColThreads;
  static constexpr size_t kRingBytes =
      (size_t)kStages * 2 * kChunk * kPitch * sizeof(T);
  static_assert(kChunk >= 8 && kChunk % 4 == 0 && kTpt <= 16, "chunk");
  static_assert(kChunk * kTpt == kThreads, "threads a token");
  static_assert(kVecPerTok % kTpt == 0, "vectors a thread");
  static_assert((kChunk * kVecPerTok) % kThreads == 0, "copies");
  static_assert(kMaxRows >= kGroupRows, "rows a pass");
  static_assert(!kMma || kRingBytes >= (size_t)kWarps * kMmaRows * (D + 2) *
                                           sizeof(float),
                "the warps' states merge in the ring");
};

// A decode segment's path (one row; see run_row): a group of kLanes lanes
// reads one token's K and V straight into registers, kUnroll tokens a
// group at a time, 16 bytes a lane a load.
template <typename T, int D>
struct RowPath {
  static constexpr int kVec = 16 / sizeof(T);
  static constexpr int kVecPerTok = D / kVec;
  static constexpr int kLanes = kVecPerTok < 32 ? kVecPerTok : 32;
  static constexpr int kVecPerLane = kVecPerTok / kLanes;
  static constexpr int kPerLane = kVecPerLane * kVec;   // elements a lane
  static constexpr int kGroups = 32 / kLanes;           // tokens a warp
  static constexpr int kUnroll =
      kVecPerLane >= kRowUnroll ? 1 : kRowUnroll / kVecPerLane;
  static constexpr int kStep = kUnroll * kWarps * kGroups;  // tokens a step
  // the groups' states (acc[D], m, l), merged through shared memory
  static constexpr size_t kMergeBytes =
      (size_t)kWarps * kGroups * (D + 2) * sizeof(float);
};

// Shared memory of one segmented block, by byte offset: the K/V ring (for
// tiles of two or more rows; a launch whose q_tile is 1 holds none), which
// a decode row's path reuses to merge its groups; then q and the
// accumulators of a pass (rows_alloc x D fp32 each), the score tile, m, l
// and alpha, and the pool row of every token of the split.
struct SegLayout {
  size_t qs, acc, ps, m, l, al, qb, rows, total;
};

template <typename T, int D>
__host__ __device__ constexpr SegLayout seg_layout(int pass_rows,
                                                   int split) {
  using Tile = SegTile<T, D>;
  constexpr size_t kMerge = RowPath<T, D>::kMergeBytes;
  const size_t ring = pass_rows > 1 && Tile::kRingBytes > kMerge
                          ? Tile::kRingBytes : kMerge;
  const int rows_alloc = (pass_rows + kGroupRows - 1) / kGroupRows *
                         kGroupRows;
  SegLayout s{};
  s.qs = (ring + 15) / 16 * 16;
  s.acc = s.qs + (size_t)rows_alloc * D * sizeof(float);
  s.ps = s.acc + (size_t)rows_alloc * D * sizeof(float);
  s.m = s.ps + (size_t)kGroupRows * Tile::kChunk * sizeof(float);
  s.l = s.m + (size_t)rows_alloc * sizeof(float);
  s.al = s.l + (size_t)rows_alloc * sizeof(float);
  s.qb = s.al + (size_t)kGroupRows * sizeof(float);
  // the tensor-core path's q tile: 16 rows of bf16 at the ring's pitch
  s.rows = s.qb + (Tile::kMma ? (size_t)kMmaRows * Tile::kPitch * 2 : 0);
  s.total = s.rows + (size_t)split * sizeof(int);
  return s;
}

// What one block works on (segment s, head h, kv positions [k0, hi)).
template <typename T>
struct SegWork {
  const T* k_pool;
  const T* v_pool;
  T* ring;
  const float* qs;
  float* acc;
  float* ps;
  float* m;
  float* l;
  float* al;
  const int* pool_row;  // pool row (block * B + offset) of token k0 + i
  int n_heads, h;
  int k0, hi;       // kv positions of this pass in this split
  int row0;         // cache position of the pass's first row
  int rows;         // rows of this pass
  const __nv_bfloat16* qb;  // the pass's q rows, bf16 (tensor-core path)
  float qscale;     // scale * log2(e)
};

// Issue the cp.async copies of chunk c (tokens k0 + c * kChunk ...) into
// its ring stage; tokens at or past hi are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void issue_chunk(const SegWork<T>& w, int c) {
  using Tile = SegTile<T, D>;
  T* kd = w.ring + (size_t)(c % kStages) * 2 * Tile::kChunk * Tile::kPitch;
  T* vd = kd + Tile::kChunk * Tile::kPitch;
  const int c0 = w.k0 + c * Tile::kChunk;
#pragma unroll
  for (int i = 0; i < Tile::kCopies; ++i) {
    const int v = threadIdx.x + i * kThreads;
    const int t = v / Tile::kVecPerTok;
    const int e = (v % Tile::kVecPerTok) * Tile::kVec;
    const int p = c0 + t;
    const bool live = p < w.hi;
    const size_t src =
        live ? ((size_t)w.pool_row[p - w.k0] * w.n_heads + w.h) * D + e : 0;
    cp_async16(kd + t * Tile::kPitch + e, w.k_pool + src, live);
    cp_async16(vd + t * Tile::kPitch + e, w.v_pool + src, live);
  }
}

// One chunk against rows g0 .. g0 + G - 1 of the pass: the score tile, the
// online softmax update, P.V into the accumulators. Ends synchronised.
template <typename T, int D>
__device__ __forceinline__ void chunk_group(const SegWork<T>& w,
                                            const T* ks, const T* vs,
                                            int c0, int g0) {
  using Tile = SegTile<T, D>;
  constexpr int kChunk = Tile::kChunk;
  constexpr int G = kGroupRows;
  const int tid = threadIdx.x;

  // scores: kTpt threads a token, each over alternate 16-byte vectors
  {
    const int tok = tid / Tile::kTpt;
    const int part = tid % Tile::kTpt;
    float sc[G];
#pragma unroll
    for (int r = 0; r < G; ++r) sc[r] = 0.f;
    const T* krow = ks + tok * Tile::kPitch;
#pragma unroll
    for (int j = 0; j < Tile::kVecPerThr; ++j) {
      const int e = (j * Tile::kTpt + part) * Tile::kVec;
      float kf[Tile::kVec];
      unpack16<T>(krow + e, kf);
#pragma unroll
      for (int r = 0; r < G; ++r) {
        const float4* qv =
            reinterpret_cast<const float4*>(w.qs + (g0 + r) * D + e);
#pragma unroll
        for (int u = 0; u < Tile::kVec / 4; ++u) {
          const float4 x = qv[u];
          sc[r] += x.x * kf[4 * u] + x.y * kf[4 * u + 1] +
                   x.z * kf[4 * u + 2] + x.w * kf[4 * u + 3];
        }
      }
    }
#pragma unroll
    for (int off = 1; off < Tile::kTpt; off <<= 1)
#pragma unroll
      for (int r = 0; r < G; ++r)
        sc[r] += __shfl_xor_sync(0xffffffffu, sc[r], off);
    if (part == 0) {
      const int pos = c0 + tok;
#pragma unroll
      for (int r = 0; r < G; ++r) {
        const int row = g0 + r;
        // row attends kv positions <= its own: causal inside the tile
        const bool ok = row < w.rows && pos < w.hi && pos <= w.row0 + row;
        w.ps[r * kChunk + tok] = ok ? sc[r] : -INFINITY;
      }
    }
  }
  __syncthreads();

  // online softmax, once a chunk a row: warp r % 4 takes row r
  {
    const int warp = tid / 32;
    const int lane = tid % 32;
    constexpr int kPerLane = (kChunk + 31) / 32;
    for (int r = warp; r < G; r += kWarps) {
      const int row = g0 + r;
      if (row >= w.rows) continue;
      float x[kPerLane];
      float mx = -INFINITY;
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const int t = lane + 32 * k;
        x[k] = t < kChunk ? w.ps[r * kChunk + t] : -INFINITY;
        mx = fmaxf(mx, x[k]);
      }
      mx = warp_max(mx);
      const float m_old = w.m[row];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const int t = lane + 32 * k;
        const float p = x[k] == -INFINITY ? 0.f : exp2f(x[k] - m_new);
        if (t < kChunk) w.ps[r * kChunk + t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = m_old == -INFINITY ? 0.f : exp2f(m_old - m_new);
        w.l[row] = w.l[row] * alpha + sum;
        w.m[row] = m_new;
        w.al[r] = alpha;
      }
    }
  }
  __syncthreads();

  // P.V: a thread owns kColsPer columns of kRowsPer rows
  {
    constexpr int kRowsPer = (G + Tile::kRowThreads - 1) / Tile::kRowThreads;
    const int cb = tid % Tile::kColThreads;
    const int rb = tid / Tile::kColThreads;
    float a[kRowsPer][Tile::kColsPer];
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
      for (int j = 0; j < Tile::kColsPer; ++j) a[i][j] = 0.f;
    if (rb < G) {
#pragma unroll 2
      for (int t = 0; t < kChunk; t += 4) {
        float vv[4][Tile::kColsPer];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int j = 0; j < Tile::kColsPer; ++j)
            vv[u][j] = to_float<T>(
                vs[(t + u) * Tile::kPitch + cb + j * Tile::kColThreads]);
#pragma unroll
        for (int i = 0; i < kRowsPer; ++i) {
          const int r = rb + i * Tile::kRowThreads;
          if (r >= G) break;
          const float4 p =
              *reinterpret_cast<const float4*>(w.ps + r * kChunk + t);
#pragma unroll
          for (int j = 0; j < Tile::kColsPer; ++j)
            a[i][j] += p.x * vv[0][j] + p.y * vv[1][j] + p.z * vv[2][j] +
                       p.w * vv[3][j];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
      const int r = rb + i * Tile::kRowThreads;
      const int row = g0 + r;
      if (r >= G || row >= w.rows) break;
      const float alpha = w.al[r];
#pragma unroll
      for (int j = 0; j < Tile::kColsPer; ++j) {
        float* dst = w.acc + row * D + cb + j * Tile::kColThreads;
        *dst = *dst * alpha + a[i][j];
      }
    }
  }
  __syncthreads();
}

// Stream the pass's kv positions [k0, hi) through the ring and fold every
// chunk into the accumulators of all its rows, kGroupRows at a time.
template <typename T, int D>
__device__ __forceinline__ void run_pass(const SegWork<T>& w) {
  using Tile = SegTile<T, D>;
  const int n_chunks = (w.hi - w.k0 + Tile::kChunk - 1) / Tile::kChunk;
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < n_chunks) issue_chunk<T, D>(w, c);
    cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    if (c + kStages - 1 < n_chunks) issue_chunk<T, D>(w, c + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // chunk c has landed
    __syncthreads();
    const T* ks = w.ring + (size_t)(c % kStages) * 2 * Tile::kChunk *
                               Tile::kPitch;
    const T* vs = ks + Tile::kChunk * Tile::kPitch;
    for (int g0 = 0; g0 < w.rows; g0 += kGroupRows)
      chunk_group<T, D>(w, ks, vs, w.k0 + c * Tile::kChunk, g0);
  }
  cp_async_wait<0>();
}

// A tile of 2..16 rows on tensor cores (bf16, D <= 128): the same ring as
// run_pass, and each of the four warps takes 16 tokens of every 64-token
// chunk against all 16 rows (rows past the tile are zero q): S = q k^T by
// mma.sync.m16n8k16 (fp32 accumulation, scaled in fp32), the warp's own
// online softmax over its tokens in registers, p re-packed from the S
// fragments into the A operands of O += p v (as a bf16 high and low part,
// two products, so p keeps about 16 bits as the reference's fp32). The
// warps' states (m, l, O) are merged through shared memory at the end of
// the pass into acc, m and l, so no barrier is spent on the softmax.
template <int D>
__device__ __forceinline__ void run_pass_mma(
    const SegWork<__nv_bfloat16>& w) {
  using T = __nv_bfloat16;
  using Tile = SegTile<T, D>;
  constexpr int kP = Tile::kPitch;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int t0 = warp * 16;  // the warp's tokens in a chunk
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};

  const int n_chunks = (w.hi - w.k0 + Tile::kChunk - 1) / Tile::kChunk;
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < n_chunks) issue_chunk<T, D>(w, c);
    cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    if (c + kStages - 1 < n_chunks) issue_chunk<T, D>(w, c + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // chunk c has landed
    __syncthreads();
    const T* ks = w.ring + (size_t)(c % kStages) * 2 * Tile::kChunk * kP;
    const T* vs = ks + Tile::kChunk * kP;
    float sc[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4], b[4];
      ldsm_x4(a, w.qb + (lane & 15) * kP + kk * 16 + (lane >> 4) * 8);
      ldsm_x4(b, ks + (t0 + (lane & 7) + ((lane >> 4) << 3)) * kP +
                     kk * 16 + ((lane >> 3) & 1) * 8);
      mma16816(sc[0], a, b[0], b[1]);
      mma16816(sc[1], a, b[2], b[3]);
    }
    // lane holds rows lane / 4 (+ 8), tokens t0 + 8 j + 2 (lane % 4) + e
    const int pos0 = w.k0 + c * Tile::kChunk + t0 + 2 * (lane % 4);
    uint32_t pa[4];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = lane / 4 + 8 * hr;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int pos = pos0 + 8 * j + e;
          const bool ok = row < w.rows && pos < w.hi && pos <= w.row0 + row;
          float& x = sc[j][2 * hr + e];
          x = ok ? x * w.qscale : -INFINITY;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[hr], mx);
      const float alpha =
          m_r[hr] == -INFINITY ? 0.f : exp2f(m_r[hr] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[j][2 * hr + e];
          x = x == -INFINITY ? 0.f : exp2f(x - m_new);
          sum += x;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_r[hr] = l_r[hr] * alpha + sum;
      m_r[hr] = m_new;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[j][2 * hr] *= alpha;
        o[j][2 * hr + 1] *= alpha;
      }
    }
    // p as a bf16 high part and the bf16 rounding of what it leaves, so
    // P.V keeps p to about 16 bits, as the reference's fp32 p
    uint32_t pl[4];
    split_bf16(pa[0], pl[0], sc[0][0], sc[0][1]);
    split_bf16(pa[1], pl[1], sc[0][2], sc[0][3]);
    split_bf16(pa[2], pl[2], sc[1][0], sc[1][1]);
    split_bf16(pa[3], pl[3], sc[1][2], sc[1][3]);
#pragma unroll
    for (int nd = 0; nd < D / 16; ++nd) {
      uint32_t b[4];
      ldsm_x4_trans(b, vs + (t0 + (lane & 15)) * kP + nd * 16 +
                           (lane >> 4) * 8);
      mma16816(o[2 * nd], pa, b[0], b[1]);
      mma16816(o[2 * nd], pl, b[0], b[1]);
      mma16816(o[2 * nd + 1], pa, b[2], b[3]);
      mma16816(o[2 * nd + 1], pl, b[2], b[3]);
    }
    __syncthreads();  // every warp is done with this stage
  }
  cp_async_wait<0>();

  // merge the four warps' states: red[warp][row] = (O[D], m, l)
  float* red = reinterpret_cast<float*>(w.ring);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float* mine = red + (warp * kMmaRows + lane / 4 + 8 * hr) * (D + 2);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      mine[8 * j + 2 * (lane % 4)] = o[j][2 * hr];
      mine[8 * j + 2 * (lane % 4) + 1] = o[j][2 * hr + 1];
    }
    if (lane % 4 == 0) {
      mine[D] = m_r[hr];
      mine[D + 1] = l_r[hr];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < w.rows * D; i += kThreads) {
    const int r = i / D;
    const int col = i % D;
    float m_all = -INFINITY;
#pragma unroll
    for (int v = 0; v < kWarps; ++v)
      m_all = fmaxf(m_all, red[(v * kMmaRows + r) * (D + 2) + D]);
    float acc = 0.f, l_all = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      const float* st = red + (v * kMmaRows + r) * (D + 2);
      const float f = st[D] == -INFINITY ? 0.f : exp2f(st[D] - m_all);
      l_all += st[D + 1] * f;
      acc += st[col] * f;
    }
    w.acc[i] = acc;
    if (col == 0) {
      w.m[r] = m_all;
      w.l[r] = l_all;
    }
  }
}

// A decode segment (one row) over kv positions [k0, hi): no staging and
// no barrier in the loop. Group g of warp w takes tokens k0 + (u * kWarps
// + w) * kGroups + g of every step of kStep tokens, kUnroll at a time: its
// lanes load them (16 bytes a lane, a step's loads in flight while the
// step before is scored), score them against q in registers (a shuffle
// tree over the group's lanes), and update the group's online softmax
// once for the kUnroll tokens. The groups' states are merged through shared memory into
// acc[0..D), m[0] and l[0].
template <typename T, int D>
__device__ __forceinline__ void run_row(const SegWork<T>& w,
                                        const T* __restrict__ k_pool,
                                        const T* __restrict__ v_pool) {
  using P = RowPath<T, D>;
  constexpr int kVec = P::kVec;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / P::kLanes;
  const int li = lane % P::kLanes;
  float qv[P::kPerLane], acc[P::kPerLane];
#pragma unroll
  for (int j = 0; j < P::kVecPerLane; ++j)
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      qv[j * kVec + u] = w.qs[(j * P::kLanes + li) * kVec + u];
      acc[j * kVec + u] = 0.f;
    }
  float m = -INFINITY, l = 0.f;
  using Regs = uint4[P::kUnroll][P::kVecPerLane];
  // the loads of a step's tokens (zeros past hi), all issued before use
  auto load = [&](int base, Regs& kr, Regs& vr, bool (&live)[P::kUnroll]) {
#pragma unroll
    for (int u = 0; u < P::kUnroll; ++u) {
      const int p = base + (u * kWarps + warp) * P::kGroups + g;
      live[u] = p < w.hi;
      const size_t src =
          live[u] ? ((size_t)w.pool_row[p - w.k0] * w.n_heads + w.h) * D : 0;
#pragma unroll
      for (int j = 0; j < P::kVecPerLane; ++j) {
        const size_t at = src + (j * P::kLanes + li) * kVec;
        kr[u][j] = live[u] ? *reinterpret_cast<const uint4*>(k_pool + at)
                           : make_uint4(0, 0, 0, 0);
        vr[u][j] = live[u] ? *reinterpret_cast<const uint4*>(v_pool + at)
                           : make_uint4(0, 0, 0, 0);
      }
    }
  };
  // score a step's tokens and fold them in with one softmax update
  auto consume = [&](const Regs& kr, const Regs& vr,
                     const bool (&live)[P::kUnroll]) {
    float sc[P::kUnroll];
    float mx = -INFINITY;
#pragma unroll
    for (int u = 0; u < P::kUnroll; ++u) {
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < P::kVecPerLane; ++j) {
        const T* kv = reinterpret_cast<const T*>(&kr[u][j]);
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          dot += qv[j * kVec + e] * to_float<T>(kv[e]);
      }
#pragma unroll
      for (int off = 1; off < P::kLanes; off <<= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      sc[u] = live[u] ? dot : -INFINITY;
      mx = fmaxf(mx, sc[u]);
    }
    const float m_new = fmaxf(m, mx);
    const float alpha = m == -INFINITY ? 0.f : exp2f(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < P::kPerLane; ++i) acc[i] *= alpha;
#pragma unroll
    for (int u = 0; u < P::kUnroll; ++u) {
      const float p = sc[u] == -INFINITY ? 0.f : exp2f(sc[u] - m_new);
      l += p;
#pragma unroll
      for (int j = 0; j < P::kVecPerLane; ++j) {
        const T* vv = reinterpret_cast<const T*>(&vr[u][j]);
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          acc[j * kVec + e] += p * to_float<T>(vv[e]);
      }
    }
    m = m_new;
  };
  // two register buffers: a step's loads are in flight while the one
  // before it is scored
  Regs ka, va, kb, vb;
  bool la[P::kUnroll], lb[P::kUnroll];
  load(w.k0, ka, va, la);
  for (int base = w.k0; base < w.hi; base += 2 * P::kStep) {
    load(base + P::kStep, kb, vb, lb);
    consume(ka, va, la);
    load(base + 2 * P::kStep, ka, va, la);
    consume(kb, vb, lb);
  }

  // merge the block's kWarps * kGroups group states
  float* red = reinterpret_cast<float*>(w.ring);  // [groups][D + 2]
  float* mine = red + (warp * P::kGroups + g) * (D + 2);
#pragma unroll
  for (int j = 0; j < P::kVecPerLane; ++j)
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      mine[(j * P::kLanes + li) * kVec + e] = acc[j * kVec + e];
  if (li == 0) {
    mine[D] = m;
    mine[D + 1] = l;
  }
  __syncthreads();
  constexpr int kAll = kWarps * P::kGroups;
  for (int c = threadIdx.x; c < D; c += kThreads) {
    float m_all = -INFINITY;
    for (int i = 0; i < kAll; ++i) m_all = fmaxf(m_all, red[i * (D + 2) + D]);
    float o = 0.f, l_all = 0.f;
    for (int i = 0; i < kAll; ++i) {
      const float mi = red[i * (D + 2) + D];
      const float f = mi == -INFINITY ? 0.f : exp2f(mi - m_all);
      l_all += red[i * (D + 2) + D + 1] * f;
      o += red[i * (D + 2) + c] * f;
    }
    w.acc[c] = o;
    if (c == 0) {
      w.m[0] = m_all;
      w.l[0] = l_all;
    }
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
                   T* __restrict__ out, float* __restrict__ work_acc,
                   float* __restrict__ work_ml, int* __restrict__ counters,
                   int n_heads, int block_size, int max_blocks, int tq,
                   int split, int n_splits, int pass_rows, float scale) {
  const int sp = blockIdx.x;
  const int h = blockIdx.y;
  const int s = blockIdx.z;
  const int tid = threadIdx.x;
  const int n_rows = min(seg_rows[s], tq);
  if (n_rows <= 0) return;
  const int pos0 = seg_pos[s];
  // the segment's last row attends kv positions [0, pos0 + n_rows), and
  // nothing past the table's MAXB * B
  const long long cap = (long long)max_blocks * block_size;
  const int kv_end = (int)min((long long)pos0 + n_rows, cap);
  const int n_live = (kv_end + split - 1) / split;
  if (sp >= n_live) return;
  const int k0 = sp * split;
  const int k1 = min(k0 + split, kv_end);

  const SegLayout lay = seg_layout<T, D>(pass_rows, split);
  extern __shared__ __align__(16) unsigned char seg_smem[];
  SegWork<T> w;
  w.k_pool = k_pool;
  w.v_pool = v_pool;
  w.ring = reinterpret_cast<T*>(seg_smem);
  float* qs = reinterpret_cast<float*>(seg_smem + lay.qs);
  w.qs = qs;
  w.acc = reinterpret_cast<float*>(seg_smem + lay.acc);
  w.ps = reinterpret_cast<float*>(seg_smem + lay.ps);
  w.m = reinterpret_cast<float*>(seg_smem + lay.m);
  w.l = reinterpret_cast<float*>(seg_smem + lay.l);
  w.al = reinterpret_cast<float*>(seg_smem + lay.al);
  T* qb = reinterpret_cast<T*>(seg_smem + lay.qb);
  w.qb = reinterpret_cast<const __nv_bfloat16*>(qb);
  int* pool_row = reinterpret_cast<int*>(seg_smem + lay.rows);
  w.pool_row = pool_row;
  w.n_heads = n_heads;
  w.h = h;
  w.k0 = k0;

  // the pool row of every token of the split, through the block table
  // read once
  const int* table = seg_tables + (size_t)s * max_blocks;
  for (int p = k0 + tid; p < k1; p += kThreads)
    pool_row[p - k0] = table[p / block_size] * block_size + p % block_size;

  const int pair = s * n_heads + h;
  const int* row_idx = seg_row_idx + (size_t)s * tq;
  const float qscale = scale * kLog2e;  // scores in log2 units: exp2f
  w.qscale = qscale;
  for (int p0 = 0; p0 < n_rows; p0 += pass_rows) {
    const int rows = min(pass_rows, n_rows - p0);
    const int rows_alloc = (rows + kGroupRows - 1) / kGroupRows *
                           kGroupRows;
    __syncthreads();  // the previous pass is written out
    for (int o = tid; o < rows_alloc * D; o += kThreads) {
      const int r = o / D;
      const int c = o % D;
      qs[o] = r < rows ? to_float<T>(q[((size_t)row_idx[p0 + r] * n_heads +
                                        h) * D + c]) * qscale
                       : 0.f;
      w.acc[o] = 0.f;
    }
    if constexpr (SegTile<T, D>::kMma) {
      constexpr int kP = SegTile<T, D>::kPitch;
      for (int o = tid; o < kMmaRows * D; o += kThreads) {
        const int r = o / D;
        const int c = o % D;
        qb[r * kP + c] = r < rows && r < kMmaRows
            ? q[((size_t)row_idx[p0 + r] * n_heads + h) * D + c]
            : __float2bfloat16(0.f);
      }
    }
    for (int r = tid; r < rows; r += kThreads) {
      w.m[r] = -INFINITY;
      w.l[r] = 0.f;
    }
    __syncthreads();  // q, state and the table entries are in place
    w.row0 = pos0 + p0;
    w.rows = rows;
    w.hi = min(k1, pos0 + p0 + rows);
    if (w.hi > k0) {
      if (rows == 1) {
        run_row<T, D>(w, k_pool, v_pool);
      } else if constexpr (SegTile<T, D>::kMma) {
        if (rows <= kMmaRows) run_pass_mma<D>(w);
        else run_pass<T, D>(w);
      } else {
        run_pass<T, D>(w);
      }
    }
    __syncthreads();
    if (n_live == 1) {
      // one split holds the whole segment: normalise and write out
      for (int o = tid; o < rows * D; o += kThreads) {
        const int r = o / D;
        out[((size_t)row_idx[p0 + r] * n_heads + h) * D + o % D] =
            from_float<T>(w.acc[o] / w.l[r]);
      }
    } else {
      const size_t slot = ((size_t)pair * n_splits + sp) * tq + p0;
      for (int o = tid; o < rows * D; o += kThreads)
        work_acc[slot * D + o] = w.acc[o];
      for (int r = tid; r < rows; r += kThreads) {
        work_ml[(slot + r) * 2] = w.m[r];
        work_ml[(slot + r) * 2 + 1] = w.l[r];
      }
    }
  }
  if (n_live == 1) return;

  // the last split of the (segment, head) to finish merges all of them
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(counters + pair, 1) == n_live - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const size_t base = (size_t)pair * n_splits * tq;
  for (int o = tid; o < n_rows * D; o += kThreads) {
    const int i = o / D;
    const int c = o % D;
    float m_all = -INFINITY, l_all = 0.f, o_all = 0.f;
    for (int j = 0; j < n_live; ++j) {  // the splits' states, merged
      const size_t slot = base + (size_t)j * tq + i;
      const float mj = __ldcg(work_ml + slot * 2);
      if (mj == -INFINITY) continue;  // no kv position of row i in split j
      const float m_new = fmaxf(m_all, mj);
      const float f_old = exp2f(m_all - m_new);  // 0 while m_all = -inf
      const float f_new = exp2f(mj - m_new);
      l_all = l_all * f_old + __ldcg(work_ml + slot * 2 + 1) * f_new;
      o_all = o_all * f_old + __ldcg(work_acc + slot * D + c) * f_new;
      m_all = m_new;
    }
    out[((size_t)row_idx[i] * n_heads + h) * D + c] =
        from_float<T>(o_all / l_all);
  }
  if (tid == 0) counters[pair] = 0;  // ready for the next launch
}

// ------------------------------------------------------------ per row
//
// `rpa_row_kernel`: one query token a row. Bound by bytes like the
// segmented kernel: a (row, head) reads min(len, MAXB * B) tokens of K and V
// once and does 4 * D flops per token, one token's K/V serving one query.
// Design:
//   * one thread block per (row, head); a row of length <= 0 writes zeros
//     and exits, and the block walks exactly the tokens the row attends, in
//     chunks of kChunk tokens (64 up to D = 128, 32 at 256, 16 at 512; the
//     Pallas grid walks all MAXB blocks and predicates; table entries past
//     the row's need are never read);
//   * per chunk, the block stages this head's K and V of every token into
//     shared memory in the pools' dtype with 16-byte copies, all of a
//     thread's loads issued before its stores. Rows are padded by 32 (64)
//     bytes so that the score reads below hit distinct banks;
//   * scores: kTpt threads a token (2 up to D = 128), each over alternate
//     16-byte vectors of D against q in shared memory (fp32, scaled once),
//     shuffles to add the parts -- not a 5-step warp reduction per token;
//   * the online softmax is updated once a chunk: the chunk's max and sum
//     come from one warp reduction and one pass through shared memory, the
//     running max m and sum l are the same in every thread;
//   * P.V: a thread owns D / 128 output columns (or one column over every
//     kGroups-th token of the chunk, kGroups = 128 / D) and rescales its
//     accumulators once a chunk; the groups are added through shared
//     memory at the end.
// Everything accumulates in fp32; the output is cast once, at the end.
// Left to later work: split-KV across blocks (the segmented kernel's),
// cp.async/TMA double buffering, a head-contiguous pool layout.

template <typename T, int D>
struct RowTile {
  static constexpr int kChunk = D <= 128 ? 64 : 8192 / D;  // tokens
  static constexpr int kTpt = kThreads / kChunk;        // threads a token
  static constexpr int kVec = 16 / sizeof(T);           // elements a copy
  static constexpr int kVecPerRow = D / kVec;
  static constexpr int kPitch = D + (kTpt == 2 ? 2 : 4) * kVec;
  static constexpr int kCopies = kChunk * kVecPerRow / kThreads;
  static constexpr int kColThreads = D < kThreads ? D : kThreads;
  static constexpr int kGroups = kThreads / kColThreads;  // threads a col
  static constexpr int kCols = D / kColThreads;           // cols a thread
  static constexpr size_t kStageBytes =
      (size_t)kChunk * kPitch * sizeof(T);             // K or V of a chunk
  static constexpr size_t kSmemBytes =
      2 * kStageBytes + (D + kChunk + 2 * kWarps) * sizeof(float);
  static_assert(kChunk * kVecPerRow % kThreads == 0, "copies");
  static_assert(kChunk * kTpt == kThreads && kVecPerRow % kTpt == 0,
                "threads");
};

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
  constexpr int kRowChunk = Tile::kChunk;
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
  const int tok = tid / Tile::kTpt;   // the chunk token this thread scores
  const int part = tid % Tile::kTpt;  // which alternate 16-byte vectors
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int col = tid % Tile::kColThreads;  // P.V: output columns ...
  const int grp = tid / Tile::kColThreads;  // ... over tokens grp, grp + G
  float m = -INFINITY, l = 0.f, acc[Tile::kCols];
#pragma unroll
  for (int k = 0; k < Tile::kCols; ++k) acc[k] = 0.f;

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
    float dot = 0.f;
    if (live) {
#pragma unroll
      for (int j = 0; j < D / (Tile::kTpt * kVec); ++j) {
        const int e = (Tile::kTpt * j + part) * kVec;
        const uint4 raw = *reinterpret_cast<const uint4*>(
            ks + tok * kPitch + e);
        const T* kv = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int u = 0; u < kVec; ++u) dot += qs[e + u] * to_float<T>(kv[u]);
      }
    }
#pragma unroll
    for (int off = 1; off < Tile::kTpt; off <<= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    const float score = live ? dot : -INFINITY;

    float cmax = warp_max(score);
    if (lane == 0) red_max[warp] = cmax;
    __syncthreads();
    cmax = red_max[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) cmax = fmaxf(cmax, red_max[w]);
    const float m_new = fmaxf(m, cmax);
    const float p = live ? expf(score - m_new) : 0.f;
    if (part == 0) ps[tok] = p;
    const float psum = warp_sum(part == 0 ? p : 0.f);
    if (lane == 0) red_sum[warp] = psum;
    __syncthreads();
    float chunk_sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) chunk_sum += red_sum[w];
    const float alpha = m == -INFINITY ? 0.f : expf(m - m_new);
    l = l * alpha + chunk_sum;
    m = m_new;
#pragma unroll
    for (int k = 0; k < Tile::kCols; ++k) acc[k] *= alpha;
    for (int t = grp; t < n_tok; t += Tile::kGroups)
#pragma unroll
      for (int k = 0; k < Tile::kCols; ++k)
        acc[k] += ps[t] * to_float<T>(
                              vs[t * kPitch + col + k * Tile::kColThreads]);
  }

  if (Tile::kGroups > 1) {
    float* merge = reinterpret_cast<float*>(row_smem);  // [groups, D]
    __syncthreads();  // every thread is done with ks
    merge[tid] = acc[0];
    __syncthreads();
    if (grp == 0)
      for (int g = 1; g < Tile::kGroups; ++g) acc[0] += merge[g * D + col];
  }
  if (grp == 0)
#pragma unroll
    for (int k = 0; k < Tile::kCols; ++k)
      orow[col + k * Tile::kColThreads] = from_float<T>(acc[k] / l);
}

// Set `kernel`'s dynamic shared memory opt-in past 48 KB, then launch it on
// `grid` with kThreads threads a block.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, size_t smem, dim3 grid, cudaStream_t stream,
                   Args... args) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <typename T, int D> struct Geometry {
  using type = T;
  static constexpr int head_dim = D;
};

template <typename T, typename F>
cudaError_t with_head_dim(int head_dim, F f) {
  switch (head_dim) {
    case 16: return f(Geometry<T, 16>());
    case 32: return f(Geometry<T, 32>());
    case 64: return f(Geometry<T, 64>());
    case 128: return f(Geometry<T, 128>());
    case 256: return f(Geometry<T, 256>());
    case 512: return f(Geometry<T, 512>());
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

// dtype: 0 = float32, 1 = bfloat16 (q, pools and out share it); head_dim
// one of 16, 32, 64, 128, 256, 512. The grid is (n_splits, n_heads, n_seg)
// with split * n_splits >= max_blocks * block_size and split a multiple of
// 64, at most 8192. work_acc [n_seg * n_heads * n_splits * tq * head_dim]
// and work_ml [... * tq * 2] fp32 hold the splits' states (unused, may be
// null, when n_splits == 1); counters [n_seg * n_heads] int32 must be zero
// and are left zero, and no other launch may use them meanwhile. Returns a cudaError_t; nonzero means the kernel did not
// launch.
int rpa_chunked_launch(const void* q, const void* k_pool, const void* v_pool,
                       const void* seg_tables, const void* seg_pos,
                       const void* seg_rows, const void* seg_row_idx,
                       void* out, void* work_acc, void* work_ml,
                       void* counters, int n_seg, int n_heads, int head_dim,
                       int block_size, int max_blocks, int tq, int split,
                       int n_splits, float scale, int dtype, void* stream) {
  if (tq < 1 || n_seg < 1 || n_seg > 65535 || n_heads < 1 ||
      n_heads > 65535 || block_size < 1 || max_blocks < 1 || split < 1 ||
      split % kMaxChunk != 0 || split > kMaxSplit || n_splits < 1 ||
      (long long)split * n_splits < (long long)max_blocks * block_size ||
      (n_splits > 1 && (work_acc == nullptr || work_ml == nullptr ||
                        counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  return (int)dispatch(dtype, head_dim, [&](auto g) {
    using T = typename decltype(g)::type;
    constexpr int D = decltype(g)::head_dim;
    const int pass_rows = tq < SegTile<T, D>::kMaxRows
                              ? tq : SegTile<T, D>::kMaxRows;
    static_assert(seg_layout<T, D>(SegTile<T, D>::kMaxRows, kMaxSplit)
                      .total <= kSmemOptIn,
                  "the largest split and pass fit shared memory");
    const size_t smem = seg_layout<T, D>(pass_rows, split).total;
    return launch(rpa_chunked_kernel<T, D>, smem,
                  dim3(n_splits, n_heads, n_seg),
                  static_cast<cudaStream_t>(stream),
                  static_cast<const T*>(q), static_cast<const T*>(k_pool),
                  static_cast<const T*>(v_pool),
                  static_cast<const int*>(seg_tables),
                  static_cast<const int*>(seg_pos),
                  static_cast<const int*>(seg_rows),
                  static_cast<const int*>(seg_row_idx), static_cast<T*>(out),
                  static_cast<float*>(work_acc),
                  static_cast<float*>(work_ml), static_cast<int*>(counters),
                  n_heads, block_size, max_blocks, tq, split, n_splits,
                  pass_rows, scale);
  });
}

// The per-row kernel: block_tables [n_rows, max_blocks] and seq_lens
// [n_rows] int32; dtype and head_dim as above. max_blocks may be 0 (every
// row is zero).
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
    return launch(rpa_row_kernel<T, D>, RowTile<T, D>::kSmemBytes,
                  dim3(n_rows, n_heads), static_cast<cudaStream_t>(stream),
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
