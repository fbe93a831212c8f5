// The fp32 attention forward and dK/dV at padded head dims past 128 (192,
// 256, ..., 512), written by hand for Hopper (sm_90a) on the tensor cores
// in split TF32 ("3xTF32"), shared by the flash kernels
// (flash_attention.cu: the dense walk, with dropout) and the block-sparse
// kernels (block_sparse_attention.cu: their compacted lists):
//   bsa_fwd_tf32_kernel  the forward
//   bsa_dkv_tf32_kernel  dK/dV
// fp32 dQ past 128 stays on wide_dq_kernel (wide_attention.cuh).
//
// They replace, in fp32 at these head dims, _fa_fwd_kernel and
// _fa_dkv_kernel (paddle_tpu/ops/pallas/flash_attention.py:162, :316;
// pallas_call :230, :397) and _bsa_fwd_kernel and _bsa_dkv_kernel
// (paddle_tpu/ops/pallas/block_sparse_attention.py:92, :216; pallas_call
// :146, :310), and compute what they compute: O and lse with the online
// softmax in fp32; dV += p_drop^T dO and dK += ds^T Q with p recomputed
// from lse and ds = p (dp_drop - delta) scale; the causal offset sk - sq;
// flash's dropout keep bits (dropout_bits, as the FMA kernels draw them);
// 0 and lse -inf for a q row that sees nothing, exact zeros for a kv row
// no q row attends.
//
// fp32 accuracy on the tensor cores. TF32 keeps 11 significant bits, far
// from the fp32 limits. So each operand x is split as it is loaded into
// a fragment, hi = tf32(x) and lo = tf32(x - hi) (cvt.rna), and a product
// is the fp32 sum a_lo b_hi + a_hi b_lo + a_hi b_hi, the corrections
// first; a_lo b_lo, under 2^-22 of a b, is dropped. The tensor core
// rounds its sums toward zero, a bias that grows with the count of sums:
// so the scores start from zero every 16 columns of depth, and P V (p^T
// dO, ds^T Q) every tile of the walk, and each part is added to its
// accumulator on the FMA units, where the error grows as a random walk
// (scores_3xtf32, pv_3xtf32). Softmax, exp and the dropout hash stay in
// fp32 on the FMA units.
//
// The products are mma.sync.m16n8k8.tf32 (a warp: 16 rows of its side by
// 8-column n-tiles), fed from shared memory by ld.shared. wgmma's TF32
// form reads a shared operand K-major only, and P V, p^T dO and ds^T Q
// take V, dO and Q MN-major, as TMA lands them; and the split would have
// to be stored (a lo tile beside each tile) instead of made in registers.
// mma.sync takes any layout from registers. The tiles come by TMA with
// 128-byte swizzle (f32_map: 32-column blocks of R rows x 128 bytes,
// 16-byte chunk c of row r at c ^ (r % 8)), and every fragment load is 16
// bytes a lane with no bank conflict, by two reorderings the sums allow:
//   depth   in Q K^T (and K Q^T, V dO^T) the depth order is free: k-step
//           (h, s) of each 32-column block gives lane t columns
//           8 t + 4 h + 2 s and + 1, so one 16-byte chunk of a row holds
//           two k-steps' A (or B) values of a lane;
//   p as A  P V's depth (kv rows) is reordered so that the scores'
//           accumulator is P's A fragment as it stands (slot t of k-step
//           j is kv row 8 j + 2 t, slot t + 4 row 8 j + 2 t + 1), and the
//           output's columns within each 32 so that a lane's B values of
//           four n-tiles are one chunk of V's row (n-tile 4 i + u, column
//           n is 32 i + 4 n + u); store_rows undoes that order.
//
// Column parts. The warps of a row group split the output's columns into
// parts of whole 32-column blocks, as even as blocks allow (D 448 in 4:
// 3, 4, 3, 4 blocks), and the scores' depth the same way: each warp sums
// the scores over its part of the depth, and every warp of the group adds
// all the parts' partials in part order, through shared memory over a
// named barrier of the group (add_parts): the scores are computed once a
// tile, never once a 64-column slice, as the FMA kernels did (D / 64
// times). 2 parts, or 4 where ptxas spilled with 2 (the forward past
// D 256, dK/dV past 384: an accumulator of D / 2 columns beside the
// scores, the ring's fragments and the split took more than 255
// registers; 432 bytes spilled in dK/dV at D 512).
//
// Forward: a block has 8 warps and owns 64 q rows, 4 row groups of 16 by
// 2 parts, to D 256, and 32 q rows, 2 row groups by 4 parts, past it.
// Q stays in shared memory (loaded once by TMA); K and V come through a
// ring of items of their own (K of walk step t item 2 t, V item 2 t + 1)
// of 16..64 kv rows, as many slots as fit beside Q and the exchange
// (3..5): thread 0 refills a slot once every warp has released it.
//
// dK/dV: a block has 8 warps that split the work by role, as
// bsa_dkv_split_wgmma_kernel does: P (S^T = K Q^T, p from lse, handed to
// dS through shared memory in the accumulator's lane layout, then dV +=
// p_drop^T dO) and dS (dP^T = V dO^T, ds^T from p and delta, then dK +=
// ds^T Q). It owns 32 kv rows, a role's four warps 2 row groups of 16 by
// 2 parts, to D 384, and 16 kv rows, one row group by 4 parts, past it
// (K and V resident, loaded once by TMA). The q tiles come through the
// ring as items of their own: Q with its rows' lse (walk step i item
// 2 i), dO with their delta (item 2 i + 1), of 32 rows where a walk
// step's two items fit beside K, V, the p tile and the exchange (every
// D), in as many slots as fit (2..6). Named barriers 1..4 (p written)
// and 5..8 (p read) pair each P warp with its dS warp, 9..12 the parts'
// warps of a role and row group. No atomics: the result is
// deterministic.
//
// Both walk the lists as the wgmma kernels do: under causal the forward's
// walk ends at the first kv tile past the block's last column (lists
// ascend) and dK/dV's skips the q tiles wholly above its diagonal (a
// prefix); a warp skips the work (not the ring) of a kv tile wholly above
// its own rows' diagonal. Blocks launch heaviest first: flash's forward
// its last q block, dK/dV kv tile 0; block-sparse by L.order.
//
// Bound on the H100 SXM: 4 D FLOP a (q, k) pair forward and 8 D dK/dV
// over the active pairs; at 67 TFLOP/s (the FMA units, fp32's peak) a
// flash BH 16, S 1024, D 256, causal forward is 8.6 GFLOP, 0.128 ms.
// Here each of those FLOPs is three TF32 ones at 495 TFLOP/s dense:
// 0.052 ms (chip_smoke.py's tc_bound_ms), which mma.sync (below wgmma's
// rate) and the split's instructions keep these kernels from.
#pragma once

// Not attention_wgmma.cuh: a source includes it itself, so that a copy of
// that header beside the source (the card tests' mutants) is the one it
// finds.
#include "attention_tiles.cuh"
#include "hopper_tiles.cuh"

namespace {

constexpr int kTf32Threads = 256;     // 8 warps
constexpr int kMaxBlockSmem = 232448;  // what a block may take

// The column parts of D a row group's warps split (the header).
template <int D>
__host__ __device__ constexpr int fwd_tf32_parts() {
  return D <= 256 ? 2 : 4;
}
template <int D>
__host__ __device__ constexpr int dkv_tf32_parts() {
  return D <= 384 ? 2 : 4;
}
// 32-column blocks of the widest part, the accumulator's columns / 32
template <int D>
__host__ __device__ constexpr int tf32_part_blocks(int parts) {
  return (D / 32 + parts - 1) / parts;
}
// the first 32-column block of part `part`
template <int D>
__device__ __forceinline__ int tf32_part_begin(int parts, int part) {
  return part * (D / 32) / parts;
}
// its count of 32-column blocks (a constant where the parts are even)
template <int D>
__device__ __forceinline__ int tf32_part_size(int parts, int part) {
  return D / 32 % parts == 0
             ? D / 32 / parts
             : tf32_part_begin<D>(parts, part + 1) -
                   tf32_part_begin<D>(parts, part);
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// A TF32 operand fragment as its high and low parts.
struct Tf32Frag {
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// The A fragment (a0: row g, slot t; a1: row g + 8, slot t; a2: row g,
// slot t + 4; a3: row g + 8, slot t + 4) split.
__device__ __forceinline__ void split_a(Tf32Frag& f, float a0, float a1,
                                        float a2, float a3) {
  split_tf32(a0, f.hi[0], f.lo[0]);
  split_tf32(a1, f.hi[1], f.lo[1]);
  split_tf32(a2, f.hi[2], f.lo[2]);
  split_tf32(a3, f.hi[3], f.lo[3]);
}

// d (16 x 8) += a (16 x 8) b (8 x 8), TF32 in, fp32 accumulate; b0 is
// (slot t, column g), b1 (slot t + 4, column g).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b at about fp32 accuracy: a_lo b_hi + a_hi b_lo + a_hi b_hi.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const Tf32Frag& a,
                                           float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(d, a.lo, bh0, bh1);
  mma_tf32(d, a.hi, bl0, bl1);
  mma_tf32(d, a.hi, bh0, bh1);
}

// The 16-byte chunk c (0..7) of 32-column block cb of row r of an fp32
// tile of `rows` rows as TMA lands it (f32_map, 128-byte swizzle).
__device__ __forceinline__ float4 ld_chunk(const unsigned char* tile,
                                           int rows, int r, int cb, int c) {
  return *reinterpret_cast<const float4*>(tile + (cb * rows + r) * 128 +
                                          ((c ^ (r & 7)) << 4));
}

// s (16 x 8 NT) = A B^T over 32-column blocks cb0 .. cb1 - 1 of the
// depth: A's rows a_r0 .. a_r0 + 15 of tile a (a_rows rows) and B's rows
// 0 .. 8 NT - 1 of tile b
// (b_rows rows), in the depth order of the header. s[j] is n-tile j in
// mma's accumulator layout: (row g, columns 8 j + 2 t, + 1), (row g + 8,
// the same). Each 16 columns of depth (two k-steps, six products) are
// summed from zero in the tensor core and added to s on the FMA units,
// as the header says; the fresh sums also keep the chains of dependent
// mma short, so that several are in flight.
template <int NT>
__device__ __forceinline__ void scores_3xtf32(float (&s)[NT][4],
                                              const unsigned char* a,
                                              int a_rows, int a_r0,
                                              const unsigned char* b,
                                              int b_rows, int cb0, int cb1) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll 1
  for (int cb = cb0; cb < cb1; ++cb)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 2 * t + h;
      const float4 x0 = ld_chunk(a, a_rows, a_r0 + g, cb, c);
      const float4 x1 = ld_chunk(a, a_rows, a_r0 + g + 8, cb, c);
      Tf32Frag f0, f1;
      split_a(f0, x0.x, x1.x, x0.y, x1.y);
      split_a(f1, x0.z, x1.z, x0.w, x1.w);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float4 y = ld_chunk(b, b_rows, 8 * j + g, cb, c);
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        mma_3xtf32(part, f0, y.x, y.y);
        mma_3xtf32(part, f1, y.z, y.w);
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += part[e];
      }
    }
}

// o (16 x N) += P V: P the warp's 16 rows by 8 KT columns in
// scores_3xtf32's accumulator layout (p[j]: columns 8 j ..), V rows 0 ..
// 8 KT - 1 of tile v (v_rows rows), its 32-column blocks cb0 .. cb0 +
// nb - 1 (nb <= N / 32), in the header's orders: step j's slot t is V's
// row 8 j + 2 t, slot t + 4 row 8 j + 2 t + 1; o's n-tile 4 i + u column
// n is column 32 (cb0 + i) + 4 n + u. As in scores_3xtf32, the tile's
// products are summed from zero in the tensor core (four n-tiles at a
// time) and added to o on the FMA units: o sums over a whole walk (up to
// 1024 rows of V, dO or Q), where the tensor core's rounding toward zero
// took dK and dV past the fp32 limits.
template <int KT, int N>
__device__ __forceinline__ void pv_3xtf32(float (&o)[N / 8][4],
                                          const float (&p)[KT][4],
                                          const unsigned char* v, int v_rows,
                                          int cb0, int nb) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  Tf32Frag f[KT];
#pragma unroll
  for (int j = 0; j < KT; ++j)
    split_a(f[j], p[j][0], p[j][2], p[j][1], p[j][3]);
#pragma unroll
  for (int i = 0; i < N / 32; ++i) {
    if (i >= nb) continue;
    float part[4][4] = {};
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const int r = 8 * j + 2 * t;
      const float4 y0 = ld_chunk(v, v_rows, r, cb0 + i, g);
      const float4 y1 = ld_chunk(v, v_rows, r + 1, cb0 + i, g);
      mma_3xtf32(part[0], f[j], y0.x, y1.x);
      mma_3xtf32(part[1], f[j], y0.y, y1.y);
      mma_3xtf32(part[2], f[j], y0.z, y1.z);
      mma_3xtf32(part[3], f[j], y0.w, y1.w);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[4 * i + u][e] += part[u][e];
  }
}

// Row g (h = 0) or g + 8 (h = 1) of pv_3xtf32's accumulator o, its nb
// 32-column blocks, times mul, to `row` (their first column; fp32,
// row-major): the lane's columns 8 t .. 8 t + 7 of each 32, two 16-byte
// stores.
template <int N>
__device__ __forceinline__ void store_rows(float* row,
                                           const float (&o)[N / 8][4], int h,
                                           float mul, int nb) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int i = 0; i < N / 32; ++i) {
    if (i >= nb) continue;
    float* at = row + 32 * i + 8 * t;
    *reinterpret_cast<float4*>(at) =
        make_float4(o[4 * i][2 * h] * mul, o[4 * i + 1][2 * h] * mul,
                    o[4 * i + 2][2 * h] * mul, o[4 * i + 3][2 * h] * mul);
    *reinterpret_cast<float4*>(at + 4) = make_float4(
        o[4 * i][2 * h + 1] * mul, o[4 * i + 1][2 * h + 1] * mul,
        o[4 * i + 2][2 * h + 1] * mul, o[4 * i + 3][2 * h + 1] * mul);
  }
}

// ---------------------------------------------------------------- forward

// q rows a block owns: 16 a row group, 8 warps by the parts
template <int D>
__host__ __device__ constexpr int fwd_tf32_rows() {
  return 16 * (kTf32Threads / 32 / fwd_tf32_parts<D>());
}

// shared memory: Q, the ring, and the exchange of partial scores (a
// 16 x kv_rows fp32 tile a warp)
template <int D>
__host__ __device__ constexpr size_t fwd_tf32_smem_at(int kv_rows,
                                                      int slots) {
  return 1024 + (size_t)fwd_tf32_rows<D>() * D * 4 +
         (size_t)slots * kv_rows * D * 4 +
         (size_t)kTf32Threads / 32 * 16 * kv_rows * 4 +
         (1 + 2 * slots) * 8;
}
template <int D>
__host__ __device__ constexpr int fwd_tf32_slots_at(int kv_rows) {
  int n = 0;
  while (n < 8 && fwd_tf32_smem_at<D>(kv_rows, n + 1) <= kMaxBlockSmem) ++n;
  return n;
}
// kv rows of a ring item: the most of 64, 32, 16 that leaves 3 slots, or
// 16 (with 2)
template <int D>
__host__ __device__ constexpr int fwd_tf32_kv_rows() {
  return fwd_tf32_slots_at<D>(64) >= 3   ? 64
         : fwd_tf32_slots_at<D>(32) >= 3 ? 32
                                         : 16;
}
template <int D>
__host__ __device__ constexpr int fwd_tf32_slots() {
  return fwd_tf32_slots_at<D>(fwd_tf32_kv_rows<D>());
}
template <int D>
constexpr size_t fwd_tf32_smem() {
  return fwd_tf32_smem_at<D>(fwd_tf32_kv_rows<D>(), fwd_tf32_slots<D>());
}
static_assert(fwd_tf32_slots<192>() >= 2 && fwd_tf32_slots<256>() >= 2 &&
                  fwd_tf32_slots<320>() >= 2 && fwd_tf32_slots<384>() >= 2 &&
                  fwd_tf32_slots<448>() >= 2 && fwd_tf32_slots<512>() >= 2 &&
                  fwd_tf32_smem<192>() <= kMaxBlockSmem &&
                  fwd_tf32_smem<256>() <= kMaxBlockSmem &&
                  fwd_tf32_smem<320>() <= kMaxBlockSmem &&
                  fwd_tf32_smem<384>() <= kMaxBlockSmem &&
                  fwd_tf32_smem<448>() <= kMaxBlockSmem &&
                  fwd_tf32_smem<512>() <= kMaxBlockSmem,
              "a block asks for more shared memory than it may take");

// s = the sum of the partial scores of a row group's kParts warps (each
// over its part of the depth) through shared memory: part p's 16 x 8 NT
// partial at group + p * stride, in the accumulator's lane layout, over
// named barrier `bar` of the kParts warps (`again`: a previous
// exchange's reads must end before the writes). Every warp adds the same
// partials in part order: the same bits.
template <int NT, int kParts>
__device__ __forceinline__ void add_parts(float (&s)[NT][4], float4* group,
                                          int stride, int part, int bar,
                                          bool again) {
  const int lane = threadIdx.x % 32;
  if (again) named_barrier(bar, 32 * kParts);
#pragma unroll
  for (int j = 0; j < NT; ++j)
    group[part * stride + j * 32 + lane] =
        make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
  named_barrier(bar, 32 * kParts);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float4 x = group[j * 32 + lane];
#pragma unroll
    for (int p = 1; p < kParts; ++p) {
      const float4 o = group[p * stride + j * 32 + lane];
      x.x += o.x;
      x.y += o.y;
      x.z += o.z;
      x.w += o.w;
    }
    s[j][0] = x.x;
    s[j][1] = x.y;
    s[j][2] = x.z;
    s[j][3] = x.w;
  }
}

template <int D, bool kDropout>
__global__ void __launch_bounds__(kTf32Threads, 1)
bsa_fwd_tf32_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    float* __restrict__ out, float* __restrict__ lse,
                    BlockList L, int sq, int sk, int causal, float scale,
                    Dropout drop) {
  // 64 (or 32) q rows: 4 (or 2) row groups of 16 by 2 (or 4) column parts
  constexpr int kParts = fwd_tf32_parts<D>();
  constexpr int kCols = 32 * tf32_part_blocks<D>(kParts);
  constexpr int kRows = fwd_tf32_rows<D>(), kRowWarps = kRows / 16;
  constexpr int kThreads = kTf32Threads;
  constexpr int BN = fwd_tf32_kv_rows<D>(), kSlots = fwd_tf32_slots<D>();
  constexpr int kQBytes = kRows * D * 4, kItemBytes = BN * D * 4;
  extern __shared__ unsigned char tf_smem[];
  unsigned char* qs = align_1024(tf_smem);
  unsigned char* kvs = qs + kQBytes;  // [kSlots] K or V tiles
  // [warps][BN / 8][32] partial scores
  float4* xchg = reinterpret_cast<float4*>(kvs + kSlots * kItemBytes);
  uint64_t* q_full =
      reinterpret_cast<uint64_t*>(xchg + kThreads / 32 * (BN / 8) * 32);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kSlots;

  // heaviest first, every batch-head side by side: flash's dense walk
  // its last q tile, block-sparse by L.order
  const int bh = blockIdx.x;
  int blk = 0, q0;
  if (L.idx == nullptr) {
    q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  } else {
    const int per = L.blk_own / kRows;
    blk = L.order[blockIdx.y / per];
    q0 = blk * L.blk_own + (blockIdx.y % per) * kRows;
  }
  const int offset = sk - sq;
  const int n_t = list_len(L, blk) * (L.blk_other / BN);
  const int last_col = q0 + kRows - 1 + offset;  // the block's last column
  const auto in_walk = [&](int t, const TileWalk<BN>& w) {
    return t < n_t && !(causal && w.col() > last_col);
  };
  // thread 0's loads: ring item n_ld, K (even) or V (odd) of the walk
  // step `ahead` stands at
  TileWalk<BN> ahead(L, blk);
  int n_ld = 0;
  const auto can_load = [&] { return in_walk(n_ld / 2, ahead); };
  const auto load_next = [&] {
    const int s = n_ld % kSlots;
    mbar_expect_tx(&full[s], kItemBytes);
#pragma unroll
    for (int cb = 0; cb < D / 32; ++cb)
      tma_load_3d(kvs + s * kItemBytes + cb * BN * 128,
                  n_ld % 2 ? &tm_v : &tm_k, &full[s], cb * 32, ahead.col(),
                  bh);
    if (n_ld++ % 2) ahead.next();
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kThreads);
    }
    mbar_fence_init();
    mbar_expect_tx(q_full, kQBytes);
#pragma unroll
    for (int cb = 0; cb < D / 32; ++cb)
      tma_load_3d(qs + cb * kRows * 128, &tm_q, q_full, cb * 32, q0, bh);
    while (n_ld < kSlots && can_load()) load_next();
  }
  __syncthreads();
  // every warp is done with item j; thread 0 refills its slot with item
  // j + kSlots
  const auto release = [&](int j) {
    const int s = j % kSlots;
    mbar_arrive(&empty[s]);
    if (threadIdx.x == 0 && n_ld == j + kSlots && can_load()) {
      mbar_wait(&empty[s], (j / kSlots) & 1);
      load_next();
    }
  };

  const int warp = threadIdx.x / 32, t = threadIdx.x % 4;
  const int g = (threadIdx.x % 32) / 4;
  const int group = warp % kRowWarps, part = warp / kRowWarps;
  // the part's 32-column blocks, of the output and of the scores' depth
  const int cb0 = tf32_part_begin<D>(kParts, part);
  const int nb = tf32_part_size<D>(kParts, part);
  const int r_lo = 16 * group;
  const int rows[2] = {q0 + r_lo + g, q0 + r_lo + g + 8};
  if (!kDropout) drop.on = 0;  // compiled without the dropout code
  const uint32_t key = dropout_key(drop, bh);
  float o[kCols / 8][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  mbar_wait(q_full, 0);
  TileWalk<BN> w(L, blk);
  int n_x = 0;  // exchanges of partial scores made
  for (int tt = 0; in_walk(tt, w); ++tt, w.next()) {
    const int c0 = w.col(), jk = 2 * tt, jv = jk + 1;
    // a tile wholly above the row group's diagonal: nothing to do
    const bool work = !(causal && c0 > q0 + r_lo + 15 + offset);
    float s[BN / 8][4];
    mbar_wait(&full[jk % kSlots], (jk / kSlots) & 1);
    // each warp of the row group sums its part of the depth
    if (work)
      scores_3xtf32<BN / 8>(s, qs, kRows, r_lo,
                            kvs + (jk % kSlots) * kItemBytes, BN, cb0,
                            cb0 + nb);
    release(jk);
    if (work) {
      add_parts<BN / 8, kParts>(s, xchg + group * (BN / 8) * 32,
                                kRowWarps * (BN / 8) * 32, part, 1 + group,
                                n_x++ > 0);
      // the online softmax, in fp32, as attention_tiles.cuh's fwd_update
      const bool mask = causal && c0 + BN - 1 > q0 + r_lo + offset;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + 8 * j + 2 * t + (e & 1);
          float x = s[j][e] * scale;
          if (mask && rows[e >> 1] + offset < col) x = -INFINITY;
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float m_use[2], alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_new = fmaxf(m[h], quad_max(mx[h]));
        m_use[h] = safe_max(m_new);
        alpha[h] = expf(m[h] - m_use[h]);
        m[h] = m_new;
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(s[j][e] - m_use[e >> 1]);
          rs[e >> 1] += p;
          float pd = p;
          if (drop.on) {
            const uint32_t bits = dropout_bits(
                key, rows[e >> 1], c0 + 8 * j + 2 * t + (e & 1));
            pd = bits >= drop.threshold ? p / drop.keep_div : 0.f;
          }
          s[j][e] = pd;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = alpha[h] * l[h] + quad_sum(rs[h]);
      // the running max moves less and less along a row: rescale only
      // when a row of the warp has a new one
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f))
#pragma unroll
        for (int j = 0; j < kCols / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];
    }
    const unsigned char* v_t = kvs + (jv % kSlots) * kItemBytes;
    mbar_wait(&full[jv % kSlots], (jv / kSlots) & 1);
    if (work) pv_3xtf32<BN / 8, kCols>(o, s, v_t, BN, cb0, nb);
    release(jv);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t row = (size_t)bh * sq + rows[h];
    store_rows<kCols>(out + row * D + 32 * cb0, o, h,
                      l[h] > 0.f ? 1.f / l[h] : 0.f, nb);
    if (part == 0 && t == 0)
      lse[row] = l[h] > 0.f ? m[h] + logf(l[h]) : -INFINITY;
  }
}

template <int D, bool kMayDrop>
cudaError_t launch_fwd_tf32_at(const void* q, const void* k, const void* v,
                               void* out, void* lse, BlockList L, int bh,
                               int sq, int sk, int causal, float scale,
                               Dropout drop, cudaStream_t st) {
  constexpr int BN = fwd_tf32_kv_rows<D>(), kRows = fwd_tf32_rows<D>();
  CUtensorMap tq, tk, tv;
  cudaError_t err = f32_map(&tq, q, bh, sq, D, kRows);
  if (err == cudaSuccess) err = f32_map(&tk, k, bh, sk, D, BN);
  if (err == cudaSuccess) err = f32_map(&tv, v, bh, sk, D, BN);
  if (err != cudaSuccess) return err;
  auto kernel = kMayDrop && drop.on ? bsa_fwd_tf32_kernel<D, kMayDrop>
                                    : bsa_fwd_tf32_kernel<D, false>;
  err = set_smem(kernel, fwd_tf32_smem<D>());
  if (err != cudaSuccess) return err;
  kernel<<<dim3(bh, sq / kRows), kTf32Threads, fwd_tf32_smem<D>(), st>>>(
      tq, tk, tv, static_cast<float*>(out), static_cast<float*>(lse), L, sq,
      sk, causal, scale, drop);
  return cudaGetLastError();
}

// The fp32 forward at padded head dim d 192..512 over a block-sparse list
// (block sizes 128-multiples that tile both sequences, L.order set; no
// dropout) or, kMayDrop, flash's dense_list(sk) (lengths 64-multiples,
// with its dropout); any other d is refused.
template <bool kMayDrop>
cudaError_t launch_fwd_tf32(int d, const void* q, const void* k,
                            const void* v, void* out, void* lse, BlockList L,
                            int bh, int sq, int sk, int causal, float scale,
                            Dropout drop, cudaStream_t st) {
  return head_dim_from<192>(d, [&](auto dc) {
    return launch_fwd_tf32_at<decltype(dc)::value, kMayDrop>(
        q, k, v, out, lse, L, bh, sq, sk, causal, scale, drop, st);
  });
}

// ------------------------------------------------------------------ dK/dV

// kv rows a block owns: 16 a row group, a role's 4 warps by the parts
template <int D>
__host__ __device__ constexpr int dkv_tf32_kv_rows() {
  return 16 * (4 / dkv_tf32_parts<D>());
}

// shared memory: K and V, the ring's q tiles with their lse or delta, the
// p hand-over of the 4 P / dS pairs and the exchange of partial scores (a
// 16 x rows fp32 tile a warp)
template <int D>
__host__ __device__ constexpr size_t dkv_tf32_smem_at(int rows, int slots) {
  return 1024 + 2 * (size_t)dkv_tf32_kv_rows<D>() * D * 4 +
         (size_t)slots * (rows * D * 4 + rows * 4) + 4 * 16 * rows * 4 +
         8 * 16 * rows * 4 + (1 + 2 * slots) * 8;
}
template <int D>
__host__ __device__ constexpr int dkv_tf32_slots_at(int rows) {
  int n = 0;
  while (n < 8 && dkv_tf32_smem_at<D>(rows, n + 1) <= kMaxBlockSmem) ++n;
  return n;
}
// q rows of a ring item: the most of 32, 16, 8 that leaves 2 slots (Q
// and dO of one walk step; larger q tiles beat more slots)
template <int D>
__host__ __device__ constexpr int dkv_tf32_rows() {
  return dkv_tf32_slots_at<D>(32) >= 2   ? 32
         : dkv_tf32_slots_at<D>(16) >= 2 ? 16
                                         : 8;
}
template <int D>
__host__ __device__ constexpr int dkv_tf32_slots() {
  return dkv_tf32_slots_at<D>(dkv_tf32_rows<D>());
}
template <int D>
constexpr size_t dkv_tf32_smem() {
  return dkv_tf32_smem_at<D>(dkv_tf32_rows<D>(), dkv_tf32_slots<D>());
}
static_assert(dkv_tf32_slots<192>() >= 2 && dkv_tf32_slots<256>() >= 2 &&
                  dkv_tf32_slots<320>() >= 2 && dkv_tf32_slots<384>() >= 2 &&
                  dkv_tf32_slots<448>() >= 2 && dkv_tf32_slots<512>() >= 2 &&
                  dkv_tf32_smem<192>() <= kMaxBlockSmem &&
                  dkv_tf32_smem<256>() <= kMaxBlockSmem &&
                  dkv_tf32_smem<320>() <= kMaxBlockSmem &&
                  dkv_tf32_smem<384>() <= kMaxBlockSmem &&
                  dkv_tf32_smem<448>() <= kMaxBlockSmem &&
                  dkv_tf32_smem<512>() <= kMaxBlockSmem,
              "a block asks for more than 227 KB of shared memory");

template <int D, bool kDense, bool kDropout>
__global__ void __launch_bounds__(kTf32Threads, 1)
bsa_dkv_tf32_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dk,
                    float* __restrict__ dv, BlockList L, int sq, int sk,
                    int causal, float scale, Dropout drop) {
  constexpr int kParts = dkv_tf32_parts<D>();
  constexpr int kCols = 32 * tf32_part_blocks<D>(kParts);
  constexpr int BKV = dkv_tf32_kv_rows<D>(), kGroups = BKV / 16;
  constexpr int R = dkv_tf32_rows<D>(), kSlots = dkv_tf32_slots<D>();
  constexpr int kKvBytes = BKV * D * 4, kItemBytes = R * D * 4;
  constexpr int kRowBytes = R * 4;
  constexpr int kLoader = 128;  // thread 0 of role dS
  extern __shared__ unsigned char tf_smem[];
  unsigned char* ks = align_1024(tf_smem);
  unsigned char* vs = ks + kKvBytes;
  unsigned char* items = vs + kKvBytes;  // [kSlots] Q or dO tiles
  // [kSlots][R]: the lse of a Q item's rows, the delta of a dO item's
  float* rows_s = reinterpret_cast<float*>(items + kSlots * kItemBytes);
  float4* p_s = reinterpret_cast<float4*>(rows_s + kSlots * R);  // [4][R/8][32]
  float4* xchg = p_s + 4 * (R / 8) * 32;  // [8 warps][R/8][32]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(xchg + 8 * (R / 8) * 32);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kSlots;

  const int bh = blockIdx.x, per = L.blk_own / BKV;
  const int blk = kDense ? 0 : L.order[blockIdx.y / per];
  const int c0 = kDense ? blockIdx.y * BKV
                        : blk * L.blk_own + (blockIdx.y % per) * BKV;
  const int* list = kDense ? nullptr : L.idx + blk * L.width;
  const int offset = sk - sq;
  const int n = kDense ? 1 : L.count[blk], per_entry = L.blk_other / R;
  const auto entry_row = [&](int b) {
    return kDense ? 0 : list[b] * L.blk_other;
  };
  // q tiles wholly above the block's diagonal (r0 + R - 1 + offset < c0)
  // see none of it and are never loaded: a prefix of the ascending walk
  int first = 0;
  if (causal)
    for (int b = 0; b < n; ++b) {
      const int skip = min(per_entry, max(c0 - offset - entry_row(b), 0) / R);
      first += skip;
      if (skip < per_entry) break;
    }
  const int n_t = n * per_entry - first, n_items = 2 * n_t;
  const auto row_of = [&](int i) {
    const int t = first + i;
    return entry_row(t / per_entry) + (t % per_entry) * R;
  };
  // ring item j into its slot: Q with its rows' lse (j even) or dO with
  // their delta (j odd) of walk step j / 2
  const auto load = [&](int j) {
    const int s = j % kSlots, r0 = row_of(j / 2);
    const bool is_q = j % 2 == 0;
    mbar_expect_tx(&full[s], kItemBytes + kRowBytes);
#pragma unroll
    for (int cb = 0; cb < D / 32; ++cb)
      tma_load_3d(items + s * kItemBytes + cb * R * 128,
                  is_q ? &tm_q : &tm_do, &full[s], cb * 32, r0, bh);
    bulk_load(rows_s + s * R, (is_q ? lse : delta) + (size_t)bh * sq + r0,
              kRowBytes, &full[s]);
  };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kTf32Threads);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == kLoader) {
    mbar_expect_tx(kv_full, 2 * kKvBytes);
#pragma unroll
    for (int cb = 0; cb < D / 32; ++cb) {
      tma_load_3d(ks + cb * BKV * 128, &tm_k, kv_full, cb * 32, c0, bh);
      tma_load_3d(vs + cb * BKV * 128, &tm_v, kv_full, cb * 32, c0, bh);
    }
    for (int j = 0; j < min(n_items, kSlots); ++j) load(j);
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int role = warp / 4, pair = warp % 4, t = lane % 4, g = lane / 4;
  const int group = pair % kGroups, part = pair / kGroups;
  // the part's 32-column blocks, of dK / dV and of the scores' depth
  const int cb0 = tf32_part_begin<D>(kParts, part);
  const int nb = tf32_part_size<D>(kParts, part);
  const int k_lo = 16 * group;
  const int cols[2] = {c0 + k_lo + g, c0 + k_lo + g + 8};
  const int bar_full = 1 + pair, bar_empty = 5 + pair;  // this pair's p
  float4* p_w = p_s + pair * (R / 8) * 32;
  if (!kDropout) drop.on = 0;  // compiled without the dropout code
  const uint32_t key = dropout_key(drop, bh);
  float acc[kCols / 8][4] = {};  // dV in role P, dK in role dS
  // the parts' warps of a role and row group each sum their part of the
  // depth of S^T (or dP^T) and add all the parts'
  const auto scores = [&](float (&sc)[R / 8][4], const unsigned char* kv,
                          const unsigned char* item, int i) {
    scores_3xtf32<R / 8>(sc, kv, BKV, k_lo, item, R, cb0, cb0 + nb);
    add_parts<R / 8, kParts>(sc, xchg + (4 * role + group) * (R / 8) * 32,
                             kGroups * (R / 8) * 32, part,
                             9 + 2 * role + group, i > 0);
  };
  mbar_wait(kv_full, 0);
  for (int i = 0; i < n_t; ++i) {
    const int jq = 2 * i, jo = jq + 1, r0 = row_of(i);
    const unsigned char* q_t = items + (jq % kSlots) * kItemBytes;
    const unsigned char* do_t = items + (jo % kSlots) * kItemBytes;
    float sc[R / 8][4];
    if (role == 0) {
      // S^T = K Q^T, p from lse, handed to dS; then dV += p_drop^T dO
      const float* lse_t = rows_s + (jq % kSlots) * R;
      const bool mask = causal && r0 + offset < c0 + k_lo + 15;
      mbar_wait(&full[jq % kSlots], (jq / kSlots) & 1);
      scores(sc, ks, q_t, i);
#pragma unroll
      for (int j = 0; j < R / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rl = 8 * j + 2 * t + (e & 1);
          const bool masked = mask && r0 + rl + offset < cols[e >> 1];
          sc[j][e] = masked ? 0.f : expf(sc[j][e] * scale - lse_t[rl]);
        }
      if (i > 0) named_barrier(bar_empty, 64);  // dS has read the last p
#pragma unroll
      for (int j = 0; j < R / 8; ++j)
        p_w[j * 32 + lane] =
            make_float4(sc[j][0], sc[j][1], sc[j][2], sc[j][3]);
      named_barrier_arrive(bar_full, 64);
      if (drop.on)
#pragma unroll
        for (int j = 0; j < R / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = r0 + 8 * j + 2 * t + (e & 1);
            const bool keep =
                dropout_bits(key, row, cols[e >> 1]) >= drop.threshold;
            sc[j][e] = keep ? sc[j][e] * drop.keep_inv : 0.f;
          }
      mbar_wait(&full[jo % kSlots], (jo / kSlots) & 1);
      pv_3xtf32<R / 8, kCols>(acc, sc, do_t, R, cb0, nb);
    } else {
      // dP^T = V dO^T, ds^T from p and delta; then dK += ds^T Q
      const float* dl_t = rows_s + (jo % kSlots) * R;
      mbar_wait(&full[jo % kSlots], (jo / kSlots) & 1);
      scores(sc, vs, do_t, i);
      named_barrier(bar_full, 64);
      float4 p[R / 8];
#pragma unroll
      for (int j = 0; j < R / 8; ++j) p[j] = p_w[j * 32 + lane];
      if (i + 1 < n_t) named_barrier_arrive(bar_empty, 64);
#pragma unroll
      for (int j = 0; j < R / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rl = 8 * j + 2 * t + (e & 1);
          float dpv = sc[j][e];
          if (drop.on) {
            const bool keep =
                dropout_bits(key, r0 + rl, cols[e >> 1]) >= drop.threshold;
            dpv = keep ? dpv * drop.keep_inv : 0.f;
          }
          const float pv = e == 0 ? p[j].x : e == 1 ? p[j].y
                                                    : e == 2 ? p[j].z : p[j].w;
          sc[j][e] = pv * (dpv - dl_t[rl]) * scale;  // ds^T
        }
      mbar_wait(&full[jq % kSlots], (jq / kSlots) & 1);
      pv_3xtf32<R / 8, kCols>(acc, sc, q_t, R, cb0, nb);
    }
    // both roles are done with the step's items; the loader refills their
    // slots
    for (int j = jq; j <= jo; ++j) {
      mbar_arrive(&empty[j % kSlots]);
      if (threadIdx.x == kLoader && j + kSlots < n_items) {
        mbar_wait(&empty[j % kSlots], (j / kSlots) & 1);
        load(j + kSlots);
      }
    }
  }
  // exact zeros for a kv row nothing attends
  float* dst = role == 0 ? dv : dk;
#pragma unroll
  for (int h = 0; h < 2; ++h)
    store_rows<kCols>(dst + ((size_t)bh * sk + cols[h]) * D + 32 * cb0, acc,
                      h, 1.f, nb);
}

template <int D, bool kDense>
cudaError_t launch_dkv_tf32_at(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dk, void* dv,
                               BlockList L, int bh, int sq, int sk,
                               int causal, float scale, Dropout drop,
                               cudaStream_t st) {
  constexpr int BKV = dkv_tf32_kv_rows<D>(), R = dkv_tf32_rows<D>();
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = f32_map(&tq, q, bh, sq, D, R);
  if (err == cudaSuccess) err = f32_map(&tk, k, bh, sk, D, BKV);
  if (err == cudaSuccess) err = f32_map(&tv, v, bh, sk, D, BKV);
  if (err == cudaSuccess) err = f32_map(&tdo, dout, bh, sq, D, R);
  if (err != cudaSuccess) return err;
  auto kernel = kDense && drop.on ? bsa_dkv_tf32_kernel<D, kDense, kDense>
                                  : bsa_dkv_tf32_kernel<D, kDense, false>;
  err = set_smem(kernel, dkv_tf32_smem<D>());
  if (err != cudaSuccess) return err;
  kernel<<<dim3(bh, sk / BKV), kTf32Threads, dkv_tf32_smem<D>(), st>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk),
      static_cast<float*>(dv), L, sq, sk, causal, scale, drop);
  return cudaGetLastError();
}

// The fp32 dK/dV at padded head dim d 192..512 over a block-sparse
// kv-major list (block sizes 128-multiples that tile both sequences,
// L.order set; no dropout) or, kDense, flash's dense_list(sq) (lengths
// 64-multiples, with its dropout); any other d is refused.
template <bool kDense>
cudaError_t launch_dkv_tf32(int d, const void* q, const void* k,
                            const void* v, const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv,
                            BlockList L, int bh, int sq, int sk, int causal,
                            float scale, Dropout drop, cudaStream_t st) {
  return head_dim_from<192>(d, [&](auto dc) {
    return launch_dkv_tf32_at<decltype(dc)::value, kDense>(
        q, k, v, dout, lse, delta, dk, dv, L, bh, sq, sk, causal, scale,
        drop, st);
  });
}

}  // namespace
