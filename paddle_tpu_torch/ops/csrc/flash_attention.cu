// Flash attention for Hopper (sm_90a), written by hand: forward, dQ and
// dK/dV, on [BH, S, D] tensors (D padded to a multiple of 64 up to 512 by
// the wrapper; bf16 at D 192 and 256 runs the list kernels of
// attention_wgmma.cuh over a dense walk, bf16 at 320..512 that header's
// D-split kernels, fp32 past 128 the 3xTF32 forward and dK/dV of
// attention_tf32.cuh and the FMA dQ of wide_attention.cuh).
//
// Replaces the three Pallas TPU kernels of
// paddle_tpu/ops/pallas/flash_attention.py:
//   fa_fwd_kernel, fa_fwd_wgmma_kernel  <- _fa_fwd_kernel (:162, call :230)
//   fa_dq_kernel, fa_dq_wgmma_kernel    <- _fa_dq_kernel  (:277, call :380)
//   fa_dkv_kernel, fa_dkv_wgmma_kernel  <- _fa_dkv_kernel (:316, call :397)
// and, in bf16 at padded D 192 and 256, the list kernels of
// attention_wgmma.cuh over a dense walk: bsa_fwd_wgmma_kernel,
// bsa_dq_wgmma_kernel and bsa_dkv_split_wgmma_kernel; at 320..512 that
// header's bsa_fwd_dsplit_wgmma_kernel, bsa_dq_dsplit_wgmma_kernel and
// bsa_dkv_dsplit_wgmma_kernel (D split across warpgroups or blocks); in
// fp32 past 128, attention_tf32.cuh's bsa_fwd_tf32_kernel and
// bsa_dkv_tf32_kernel (3xTF32 on mma.sync) and wide_attention.cuh's
// wide_dq_kernel. Each computes what its TPU kernel computes; none is carried over block
// by block. The TPU grids walk the inner tile loop in order and carry
// (m, l, acc) or the dq / dk,dv sums in VMEM scratch across grid steps; on
// the GPU that loop runs inside one thread block, and the sums stay in the
// block's registers:
//   forward  a block per (bh, q tile) loops over 64-column kv tiles;
//            online softmax (running max m, sum l, accumulator acc, all
//            fp32); kv tiles wholly above the causal diagonal (rows +
//            offset >= cols, offset = sk - sq) are skipped; writes out and
//            lse = m + log(l), fp32 [BH, Sq].
//   dQ       a block per (bh, q tile) loops over kv tiles: p is
//            recomputed from lse, ds = p * (dp - delta) * scale,
//            dq += ds . k. No atomics.
//   dK/dV    a block per (bh, kv tile) loops over q tiles:
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
// balance point (forward); only wgmma reaches the tensor cores' rate.
// Instantiations:
//   bf16  wgmma fed by TMA rings (below; building blocks in
//         hopper_tiles.cuh). A block of 128 rows (q rows in the forward
//         and dQ, kv rows in dK/dV) is two consumer warpgroups of 64 and
//         streams the other side's 64-row tiles through a ring of shared-
//         memory stages; heaviest causal blocks are launched first.
//   fp32  the FMA units (67 TFLOP/s peak; the tests' and the parity
//         step's type): tiles staged as fp32 and a 4 x (D/16) register
//         micro-tile per thread (256 threads = 16 x 16; a thread owns
//         rows 4*ty..4*ty+3 and columns tx + 16*j, so the row reductions
//         of the online softmax are half-warp shuffles). Operand layouts
//         in shared memory make every inner-loop load conflict-free: the
//         "A" operand is stored k-major and read as float4, the "B"
//         operand is read as scalars at a stride of 1 or an odd stride
//         (D + 1).
// The FMA tile steps (and the helpers above them) live in
// attention_tiles.cuh, the bf16 wgmma tile steps in attention_wgmma.cuh,
// both shared with the block-sparse kernels.

#include "attention_wgmma.cuh"
#include "attention_tf32.cuh"
#include "wide_attention.cuh"

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

// ------------------------------------------ bf16: wgmma fed by TMA rings
//
// A block owns a 128-row tile (q rows in the forward and dQ, kv rows in
// dK/dV), loaded once by TMA, and is two consumer warpgroups of 64 of its
// rows each. The other side's 64-row tiles stream through a ring of
// shared-memory stages, each with a full and an empty mbarrier, kept in
// flight by TMA loads that one thread issues. Every product is wgmma
// (operands in shared memory, 128-byte swizzle, or p / ds re-packed from
// accumulators as register A fragments). One block an SM; under causal
// the blocks with the most tiles are launched first (each kernel says in
// what order). A consumer warpgroup skips the work (not the barriers) of
// a tile wholly above its causal diagonal and masks only tiles that cross
// it; with an odd count of 64-row tiles the last block's second
// warpgroup owns rows past the end (TMA reads them as zeros) and only
// keeps the ring turning.
//
// Registers decide who issues the loads. The forward's consumers fit in
// 168 registers a thread, so its block adds a producer warpgroup (384
// threads launch at 168 each: a quarter of the SM holds three warps) and
// setmaxnreg moves registers from the producer (40) to the consumers
// (232). dK/dV's consumers need 224 (dK and dV alone take 128 a thread at
// D = 128) and dQ's 190 (dQ 64, S and dP 64, the dS fragments 16); see
// fa_dkv_wgmma_kernel.

constexpr int kWgThreads = kConsumerThreads + 128;  // + the producer
// setmaxnreg's budget: each of an SM's four quarters runs one producer
// warp and two consumer warps, and holds 3 x 168 registers a lane from
// launch on; a request past that waits for ever
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
static_assert(kProducerRegs + 2 * kConsumerRegs <= 3 * 168,
              "setmaxnreg asks for more registers than the block holds");
constexpr int kFwdStages = 4;                // K/V ring of the forward

template <int D>
constexpr size_t fwd_wgmma_smem() {
  return 1024 + tile_bytes<D>(kWgBlock) +
         2 * kFwdStages * tile_bytes<D>(kTile) + (1 + 2 * kFwdStages) * 8;
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
fa_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_out,
                    float* __restrict__ lse, int sq, int sk, int causal,
                    float scale, Dropout drop) {
  constexpr int kQBytes = tile_bytes<D>(kWgBlock);
  constexpr int kKvBytes = tile_bytes<D>(kTile);
  extern __shared__ unsigned char wg_smem[];
  unsigned char* qs = align_1024(wg_smem);
  unsigned char* ks = qs + kQBytes;                // [kFwdStages] K tiles
  unsigned char* vs = ks + kFwdStages * kKvBytes;  // [kFwdStages] V tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + kFwdStages * kKvBytes);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kFwdStages;

  // a batch-head's q blocks are launched together, so its K and V are
  // read from HBM about once and then from L2 (a grid in batch-head
  // order would cycle more K and V than L2 holds); among them the last
  // (the most kv tiles under causal) first
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kWgBlock;
  const int offset = sk - sq;
  const int q_last = min(q0 + kWgBlock, sq) - 1;
  // kv tiles wholly above the block's diagonal are never loaded
  const int n_t = causal ? min(sk / kTile, (q_last + offset) / kTile + 1)
                         : sk / kTile;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerThreads);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // the role as a warp-uniform value, so the compiler sees one branch per
  // role (setmaxnreg needs that)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == 2) {  // the producer warpgroup
    regs_dealloc<kProducerRegs>();
    if (threadIdx.x == kConsumerThreads) {
      mbar_expect_tx(q_full, kQBytes);
#pragma unroll
      for (int cb = 0; cb < D / 64; ++cb)
        tma_load_3d(qs + cb * kWgBlock * 128, &tm_q, q_full, cb * 64, q0, bh);
      for (int t = 0; t < n_t; ++t) {
        const int s = t % kFwdStages;
        if (t >= kFwdStages) mbar_wait(&empty[s], (t / kFwdStages - 1) & 1);
        mbar_expect_tx(&full[s], 2 * kKvBytes);
#pragma unroll
        for (int cb = 0; cb < D / 64; ++cb) {
          tma_load_3d(ks + s * kKvBytes + cb * kTile * 128, &tm_k, &full[s],
                      cb * 64, t * kTile, bh);
          tma_load_3d(vs + s * kKvBytes + cb * kTile * 128, &tm_v, &full[s],
                      cb * 64, t * kTile, bh);
        }
      }
    }
  } else {  // the two consumer warpgroups
    regs_alloc<kConsumerRegs>();
    const int warp = (threadIdx.x / 32) % 4;
    const int g = (threadIdx.x % 32) / 4, tig = threadIdx.x % 4;
    const int row0 = q0 + wg * kWgRows;
    const bool live = row0 < sq;
    const int rows[2] = {row0 + warp * 16 + g, row0 + warp * 16 + g + 8};
    const uint32_t q_base = smem_u32(qs) + wg * kWgRows * 128;
    const uint32_t key = dropout_key(drop, bh);
    float o[D / 8][4] = {};
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    if (live) mbar_wait(q_full, 0);
    for (int t = 0; t < n_t; ++t) {
      const int s = t % kFwdStages, c0 = t * kTile;
      mbar_wait(&full[s], (t / kFwdStages) & 1);
      if (live && !(causal && c0 > row0 + kWgRows - 1 + offset))
        fwd_tile_wgmma<D>(o, m, l, q_base, smem_u32(ks + s * kKvBytes),
                          smem_u32(vs + s * kKvBytes), rows, c0,
                          causal && c0 + kTile - 1 > row0 + offset, offset,
                          scale, drop, key);
      mbar_arrive(&empty[s]);
    }
    if (live) {
      // out through the warpgroup's rows of the Q tile, which it no
      // longer reads, and one TMA store: whole 128-byte lines to HBM
      float inv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) inv[h] = l[h] > 0.f ? 1.f / l[h] : 0.f;
      stage_acc_bf16<D>(qs, kWgBlock, wg * kWgRows, o, inv);
      fence_async_shared();
      named_barrier(1 + wg, 128);
      if (threadIdx.x % 128 == 0) {
#pragma unroll
        for (int cb = 0; cb < D / 64; ++cb)
          tma_store_3d(&tm_out, qs + (cb * kWgBlock + wg * kWgRows) * 128,
                       cb * 64, row0, bh);
        tma_store_drain();
      }
      if (tig == 0)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          lse[(size_t)bh * sq + rows[h]] =
              l[h] > 0.f ? m[h] + logf(l[h]) : -INFINITY;
    }
  }
}

// dQ runs as dK/dV does, without a producer warpgroup (its consumers take
// 190 registers a thread at D = 128): 256 threads, and one of them keeps the
// K/V ring's TMA loads in flight, refilling a stage with the tile
// kDqStages further on once both warpgroups have released it, one tile
// after its own release. The Q and dO tiles are loaded once.
template <int D>
__global__ void __launch_bounds__(kConsumerThreads, 1)
fa_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_do,
                   const __grid_constant__ CUtensorMap tm_dq,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, int sq, int sk,
                   int causal, float scale, Dropout drop) {
  constexpr int kQBytes = tile_bytes<D>(kWgBlock);
  constexpr int kKvBytes = tile_bytes<D>(kTile);
  extern __shared__ unsigned char wg_smem[];
  unsigned char* qs = align_1024(wg_smem);
  unsigned char* dos = qs + kQBytes;
  unsigned char* ks = dos + kQBytes;              // [kDqStages] K tiles
  unsigned char* vs = ks + kDqStages * kKvBytes;  // [kDqStages] V tiles
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + kDqStages * kKvBytes);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kDqStages;

  // as the forward: a batch-head's q blocks together, the last (the most
  // kv tiles under causal) first
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kWgBlock;
  const int offset = sk - sq;
  const int q_last = min(q0 + kWgBlock, sq) - 1;
  // kv tiles wholly above the block's diagonal are never loaded
  const int n_t = causal ? min(sk / kTile, (q_last + offset) / kTile + 1)
                         : sk / kTile;
  // kv tile t into its stage: K and V
  const auto load = [&](int t) {
    const int s = t % kDqStages;
    mbar_expect_tx(&full[s], 2 * kKvBytes);
#pragma unroll
    for (int cb = 0; cb < D / 64; ++cb) {
      tma_load_3d(ks + s * kKvBytes + cb * kTile * 128, &tm_k, &full[s],
                  cb * 64, t * kTile, bh);
      tma_load_3d(vs + s * kKvBytes + cb * kTile * 128, &tm_v, &full[s],
                  cb * 64, t * kTile, bh);
    }
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerThreads);
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(q_full, 2 * kQBytes);
#pragma unroll
    for (int cb = 0; cb < D / 64; ++cb) {
      tma_load_3d(qs + cb * kWgBlock * 128, &tm_q, q_full, cb * 64, q0, bh);
      tma_load_3d(dos + cb * kWgBlock * 128, &tm_do, q_full, cb * 64, q0,
                  bh);
    }
    for (int t = 0; t < min(n_t, kDqStages); ++t) load(t);
  }

  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
  const int g = (threadIdx.x % 32) / 4;
  const int row0 = q0 + wg * kWgRows;
  const bool live = row0 < sq;
  const int rows[2] = {row0 + warp * 16 + g, row0 + warp * 16 + g + 8};
  const uint32_t q_base = smem_u32(qs) + wg * kWgRows * 128;
  const uint32_t do_base = smem_u32(dos) + wg * kWgRows * 128;
  const uint32_t key = dropout_key(drop, bh);
  float lse_l2[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
  if (live)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lse_l2[h] = lse[(size_t)bh * sq + rows[h]] * kLog2e;
      dl[h] = delta[(size_t)bh * sq + rows[h]];
    }
  float acc[D / 8][4] = {};
  if (live) mbar_wait(q_full, 0);
  for (int t = 0; t < n_t; ++t) {
    const int s = t % kDqStages, c0 = t * kTile;
    if (threadIdx.x == 0 && t > 0 && t - 1 + kDqStages < n_t) {
      mbar_wait(&empty[(t - 1) % kDqStages], ((t - 1) / kDqStages) & 1);
      load(t - 1 + kDqStages);
    }
    mbar_wait(&full[s], (t / kDqStages) & 1);
    if (live && !(causal && c0 > row0 + kWgRows - 1 + offset))
      dq_tile_wgmma<D>(acc, q_base, do_base, smem_u32(ks + s * kKvBytes),
                       smem_u32(vs + s * kKvBytes), rows, lse_l2, dl, c0,
                       causal && c0 + kTile - 1 > row0 + offset, offset,
                       scale, drop, key);
    mbar_arrive(&empty[s]);
  }
  if (live) {
    // dQ through the warpgroup's rows of the Q tile, which it no longer
    // reads, and one TMA store: whole 128-byte lines to HBM
    const float one[2] = {1.f, 1.f};
    stage_acc_bf16<D>(qs, kWgBlock, wg * kWgRows, acc, one);
    fence_async_shared();
    named_barrier(1 + wg, 128);
    if (threadIdx.x % 128 == 0) {
#pragma unroll
      for (int cb = 0; cb < D / 64; ++cb)
        tma_store_3d(&tm_dq, qs + (cb * kWgBlock + wg * kWgRows) * 128,
                     cb * 64, row0, bh);
      tma_store_drain();
    }
  }
}

// dK/dV runs without a producer warpgroup. Its consumers need 224
// registers a thread at D = 128 (dK and dV take 128), and with a producer
// warpgroup the block launches at 168 a thread, from which setmaxnreg did
// not lift the consumers' code: ptxas (CUDA 12.8) allocated it within far
// fewer registers than it released, spilled and serialised the wgmma
// chain. So the block is the two consumer warpgroups alone (256 threads,
// up to 255 registers each), and one of their threads keeps the ring's
// TMA loads in flight: it issues the first kDkvStages q tiles at once and
// refills a stage with the tile kDkvStages further on once both
// warpgroups have released it, one tile after its own warpgroup's release
// so that the two are not held in step.
template <int D>
__global__ void __launch_bounds__(kConsumerThreads, 1)
fa_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_dk,
                    const __grid_constant__ CUtensorMap tm_dv,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, int sq, int sk,
                    int causal, float scale, Dropout drop) {
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

  // kv block 0 (the most q tiles under causal) of every batch-head is
  // launched first
  const int bh = blockIdx.x, c0 = blockIdx.y * kWgBlock;
  const int offset = sk - sq;
  // q tiles wholly above the block's diagonal (r0 + 63 + offset < c0)
  // see none of it and are never loaded
  const int t_first = causal ? max(c0 - offset, 0) / kTile : 0;
  const int n_t = sq / kTile - t_first;
  // step i of the walk into its stage: Q, dO, lse and delta
  const auto load = [&](int i) {
    const int s = i % kDkvStages, r0 = (t_first + i) * kTile;
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
  const bool live = col0 < sk;
  const int cols[2] = {col0 + warp * 16 + g, col0 + warp * 16 + g + 8};
  const uint32_t k_base = smem_u32(ks) + wg * kWgRows * 128;
  const uint32_t v_base = smem_u32(vs) + wg * kWgRows * 128;
  const uint32_t key = dropout_key(drop, bh);
  float dk_acc[D / 8][4] = {}, dv_acc[D / 8][4] = {};
  if (live) mbar_wait(kv_full, 0);
  for (int i = 0; i < n_t; ++i) {
    const int s = i % kDkvStages, r0 = (t_first + i) * kTile;
    if (threadIdx.x == 0 && i > 0 && i - 1 + kDkvStages < n_t) {
      mbar_wait(&empty[(i - 1) % kDkvStages], ((i - 1) / kDkvStages) & 1);
      load(i - 1 + kDkvStages);
    }
    mbar_wait(&full[s], (i / kDkvStages) & 1);
    if (live && !(causal && r0 + kTile - 1 + offset < col0))
      dkv_tile_wgmma<D>(dk_acc, dv_acc, k_base, v_base,
                        smem_u32(qs + s * kQBytes), smem_u32(dos + s * kQBytes),
                        lse_s + s * kTile, dl_s + s * kTile, cols, r0,
                        causal && r0 + offset < col0 + kWgRows - 1, offset,
                        scale, drop, key);
    mbar_arrive(&empty[s]);
  }
  if (live) {
    // dK and dV through the warpgroup's rows of the K and V tiles, which
    // it no longer reads, and TMA stores: whole 128-byte lines to HBM
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
cudaError_t launch_fwd_wgmma(const void* q, const void* k, const void* v,
                             void* out, void* lse, int bh, int sq, int sk,
                             int causal, float scale, Dropout drop,
                             cudaStream_t st) {
  CUtensorMap tq, tk, tv, tout;
  cudaError_t err = bf16_map(&tq, q, bh, sq, D, kWgBlock);
  if (err == cudaSuccess) err = bf16_map(&tk, k, bh, sk, D, kTile);
  if (err == cudaSuccess) err = bf16_map(&tv, v, bh, sk, D, kTile);
  if (err == cudaSuccess) err = bf16_map(&tout, out, bh, sq, D, kWgRows);
  if (err != cudaSuccess) return err;
  auto kernel = fa_fwd_wgmma_kernel<D>;
  err = set_smem(kernel, fwd_wgmma_smem<D>());
  if (err != cudaSuccess) return err;
  kernel<<<dim3((sq + kWgBlock - 1) / kWgBlock, bh), kWgThreads,
           fwd_wgmma_smem<D>(), st>>>(
      tq, tk, tv, tout, static_cast<float*>(lse), sq, sk, causal, scale,
      drop);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_wgmma(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int bh, int sq,
                            int sk, int causal, float scale, Dropout drop,
                            cudaStream_t st) {
  CUtensorMap tq, tk, tv, tdo, tdq;
  cudaError_t err = bf16_map(&tq, q, bh, sq, D, kWgBlock);
  if (err == cudaSuccess) err = bf16_map(&tk, k, bh, sk, D, kTile);
  if (err == cudaSuccess) err = bf16_map(&tv, v, bh, sk, D, kTile);
  if (err == cudaSuccess) err = bf16_map(&tdo, dout, bh, sq, D, kWgBlock);
  if (err == cudaSuccess) err = bf16_map(&tdq, dq, bh, sq, D, kWgRows);
  if (err != cudaSuccess) return err;
  auto kernel = fa_dq_wgmma_kernel<D>;
  err = set_smem(kernel, dq_wgmma_smem<D>());
  if (err != cudaSuccess) return err;
  kernel<<<dim3((sq + kWgBlock - 1) / kWgBlock, bh), kConsumerThreads,
           dq_wgmma_smem<D>(), st>>>(
      tq, tk, tv, tdo, tdq, static_cast<const float*>(lse),
      static_cast<const float*>(delta), sq, sk, causal, scale, drop);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_wgmma(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int bh,
                             int sq, int sk, int causal, float scale,
                             Dropout drop, cudaStream_t st) {
  CUtensorMap tq, tk, tv, tdo, tdk, tdv;
  cudaError_t err = bf16_map(&tq, q, bh, sq, D, kTile);
  if (err == cudaSuccess) err = bf16_map(&tk, k, bh, sk, D, kWgBlock);
  if (err == cudaSuccess) err = bf16_map(&tv, v, bh, sk, D, kWgBlock);
  if (err == cudaSuccess) err = bf16_map(&tdo, dout, bh, sq, D, kTile);
  if (err == cudaSuccess) err = bf16_map(&tdk, dk, bh, sk, D, kWgRows);
  if (err == cudaSuccess) err = bf16_map(&tdv, dv, bh, sk, D, kWgRows);
  if (err != cudaSuccess) return err;
  auto kernel = fa_dkv_wgmma_kernel<D>;
  err = set_smem(kernel, dkv_wgmma_smem<D>());
  if (err != cudaSuccess) return err;
  kernel<<<dim3(bh, (sk + kWgBlock - 1) / kWgBlock), kConsumerThreads,
           dkv_wgmma_smem<D>(), st>>>(
      tq, tk, tv, tdo, tdk, tdv, static_cast<const float*>(lse),
      static_cast<const float*>(delta), sq, sk, causal, scale, drop);
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

// Dispatch on (dtype, padded head dim) at head_dim 64 or 128: dtype 0 =
// float32 runs the FMA kernels (FP32), 1 = bfloat16 the tensor-core
// kernels (BF16). Past 128 (192..512, multiples of 64) each entry point
// picks its kernel before this dispatch, over a dense walk: in bf16 the
// list kernels of attention_wgmma.cuh at 192 and 256, its D-split kernels
// at 320..512 (bsa_fwd_dsplit_wgmma_kernel, bsa_dq_dsplit_wgmma_kernel,
// bsa_dkv_dsplit_wgmma_kernel); in fp32 the 3xTF32 forward and dK/dV of
// attention_tf32.cuh (bsa_fwd_tf32_kernel, bsa_dkv_tf32_kernel) and
// wide_dq_kernel. Everything else is refused with cudaErrorInvalidValue
// before any launch.
#define FA_DISPATCH(FP32, BF16, ...)                                       \
  do {                                                                     \
    if (dtype == 0 && head_dim == 64)                                      \
      return (int)FP32<float, 64>(__VA_ARGS__);                            \
    if (dtype == 0 && head_dim == 128)                                     \
      return (int)FP32<float, 128>(__VA_ARGS__);                           \
    if (dtype == 1 && head_dim == 64) return (int)BF16<64>(__VA_ARGS__);   \
    if (dtype == 1 && head_dim == 128) return (int)BF16<128>(__VA_ARGS__); \
    return (int)cudaErrorInvalidValue;                                     \
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
  // bf16 at padded D 192 and 256: the wgmma forward over the dense walk
  if (dtype == 1 && head_dim == 192)
    return (int)launch_bsa_fwd_wgmma<192>(q, k, v, out, lse, dense_list(sk),
                                          bh, sq, sk, causal, scale, drop, st);
  if (dtype == 1 && head_dim == 256)
    return (int)launch_bsa_fwd_wgmma<256>(q, k, v, out, lse, dense_list(sk),
                                          bh, sq, sk, causal, scale, drop, st);
  // bf16 at 320..512: D split across two warpgroups
  if (dtype == 1 && head_dim > 256 && wide_head_dim(head_dim))
    return (int)launch_fwd_dsplit_wgmma(head_dim, q, k, v, out, lse,
                                        dense_list(sk), bh, sq, sk, causal,
                                        scale, drop, st);
  // fp32 at 192..512: 3xTF32 on the tensor cores
  if (dtype == 0 && wide_head_dim(head_dim))
    return (int)launch_fwd_tf32<true>(head_dim, q, k, v, out, lse,
                                      dense_list(sk), bh, sq, sk, causal,
                                      scale, drop, st);
  FA_DISPATCH(launch_fwd, launch_fwd_wgmma, q, k, v, out, lse, bh, sq, sk,
              causal, scale, drop, st);
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
  // bf16 at padded D 192 and 256: the wgmma dQ over the dense walk
  if (dtype == 1 && head_dim == 192)
    return (int)launch_bsa_dq_wgmma<192, true>(q, k, v, dout, lse, delta, dq,
                                         dense_list(sk), bh, sq, sk, causal,
                                         scale, drop, st);
  if (dtype == 1 && head_dim == 256)
    return (int)launch_bsa_dq_wgmma<256, true>(q, k, v, dout, lse, delta, dq,
                                         dense_list(sk), bh, sq, sk, causal,
                                         scale, drop, st);
  // bf16 at 320..512: D split across two warpgroups
  if (dtype == 1 && head_dim > 256 && wide_head_dim(head_dim))
    return (int)launch_dq_dsplit_wgmma<true>(head_dim, q, k, v, dout, lse,
                                             delta, dq, dense_list(sk), bh,
                                             sq, sk, causal, scale, drop, st);
  // fp32 at 192..512: the FMA kernel, a 64-column slice a block
  if (dtype == 0 && wide_head_dim(head_dim))
    return (int)launch_wide_dq(q, k, v, dout, lse, delta, dq, dense_list(sk),
                               bh, sq, sk, head_dim, causal, scale, drop, st);
  FA_DISPATCH(launch_dq, launch_dq_wgmma, q, k, v, dout, lse, delta, dq, bh,
              sq, sk, causal, scale, drop, st);
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
  // bf16 at padded D 192 and 256: a role a warpgroup, over the dense walk
  if (dtype == 1 && head_dim == 192)
    return (int)launch_bsa_dkv_split_wgmma<192, true>(
        q, k, v, dout, lse, delta, dk, dv, dense_list(sq), bh, sq, sk, causal,
        scale, drop, st);
  if (dtype == 1 && head_dim == 256)
    return (int)launch_bsa_dkv_split_wgmma<256, true>(
        q, k, v, dout, lse, delta, dk, dv, dense_list(sq), bh, sq, sk, causal,
        scale, drop, st);
  // bf16 at 320..512: D split across two blocks, a role a warpgroup
  if (dtype == 1 && head_dim > 256 && wide_head_dim(head_dim))
    return (int)launch_dkv_dsplit_wgmma<true>(
        head_dim, q, k, v, dout, lse, delta, dk, dv, dense_list(sq), bh, sq,
        sk, causal, scale, drop, st);
  // fp32 at 192..512: 3xTF32 on the tensor cores, a role a warp
  if (dtype == 0 && wide_head_dim(head_dim))
    return (int)launch_dkv_tf32<true>(head_dim, q, k, v, dout, lse, delta, dk,
                                      dv, dense_list(sq), bh, sq, sk, causal,
                                      scale, drop, st);
  FA_DISPATCH(launch_dkv, launch_dkv_wgmma, q, k, v, dout, lse, delta, dk,
              dv, bh, sq, sk, causal, scale, drop, st);
}

const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
