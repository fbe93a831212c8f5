// Hopper (sm_90a) building blocks for kernels that stage tiles by TMA and
// multiply them with wgmma: mbarriers, TMA loads, wgmma descriptors and
// products, register rebalancing, and the host-side tensor maps.
//
// Layout contract. A tile of R rows x D bf16 columns (R a multiple of 8,
// D a multiple of 64) lies in shared memory as D / 64 column blocks of
// R rows x 128 bytes, each written by one TMA box with 128-byte swizzle
// (16-byte chunk c of row r stored at chunk c ^ (r % 8)); every block
// starts on a 1024-byte boundary. wgmma reads such a tile two ways:
//   K-major   the tile's columns are the product's depth (q k^T reads q
//             and k so): a 16-deep step kk starts 32 * (kk % 4) bytes into
//             column block kk / 4; 8-row groups 1024 bytes apart (SBO).
//   MN-major  the tile's rows are the depth (p v reads v so, with the
//             transpose bit): step kk starts 16 rows = 2048 bytes down;
//             8-row groups 1024 bytes apart (SBO), column blocks R * 128
//             bytes apart (LBO).
//
// Accumulator layout of wgmma.m64nN (fp32): warp w of the warpgroup owns
// rows 16 w .. 16 w + 15; lane l holds, for every 8-column chunk j,
// d[j][2 h + e] = (row 16 w + l / 4 + 8 h, column 8 j + 2 (l % 4) + e).
// That is mma.sync's m16n8 layout repeated over N / 8 chunks, so two
// neighbouring chunks re-pack into the bf16 A fragment of one 16-deep
// step (to_a_frags in attention_wgmma.cuh) with no data movement.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// `p` moved up to the next 1024-byte boundary of shared memory (what the
// 128-byte swizzle's 8-row atoms need); the caller allots 1 KB of slack.
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// ----------------------------------------------------------- mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// One arrival that also announces `bytes` of TMA traffic to come.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t addr,
                                                  uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done;
}

// Waits until the phase of parity `parity` has completed. A wait that
// lasts ~10 s means a broken pipeline: trap (the launch then fails with
// an error) rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(addr, parity))
    if (clock64() - t0 > 20000000000LL) __trap();
}

// ------------------------------------------------------------------ TMA

// One box of a 3-D tensor map (coordinates innermost first) into shared
// memory; completion is counted on `bar` in bytes.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) of global
// memory into shared memory; completion counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// One box of shared memory (laid out as the tensor map's loads lay it
// out) to a 3-D tensor map, as a bulk group.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Commits the bulk stores issued so far and waits until their shared
// memory has been read (a block must not exit before).
__device__ __forceinline__ void tma_store_drain() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Makes this thread's shared-memory writes visible to TMA (the async
// proxy); put it before the barrier that precedes a tma_store_3d.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` (1..15; 0 is __syncthreads') over `n` threads.
__device__ __forceinline__ void named_barrier(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Arrives at barrier `id` (of `n` threads) without waiting: the threads
// that wait there with named_barrier see this thread's shared-memory
// writes made before it.
__device__ __forceinline__ void named_barrier_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// ---------------------------------------------------- register budgets

template <int N>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------- wgmma

// Shared-memory matrix descriptor, 128-byte swizzle.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// Step kk of a K-major tile whose column blocks are `rows` rows tall;
// `base` is the shared address of the operand's first row in block 0.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t base, int kk,
                                                int rows) {
  return wg_desc(base + (kk / 4) * rows * 128 + (kk % 4) * 32, 16, 1024);
}

// Step kk of an MN-major tile of `rows` rows (the depth).
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t base, int kk,
                                                 int rows) {
  return wg_desc(base + kk * 2048, rows * 128, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from reading (or writing) accumulator registers
// across a wgmma wait: call after every wg_wait on what it produced.
template <int N>
__device__ __forceinline__ void wg_fence_regs(float (&r)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(r[j][e])::"memory");
}

#define WG_F8(d, j)                                                        \
  "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3]),               \
      "+f"(d[j + 1][0]), "+f"(d[j + 1][1]), "+f"(d[j + 1][2]),               \
      "+f"(d[j + 1][3])
#define WG_D16                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "                                      \
  "%8, %9, %10, %11, %12, %13, %14, %15}"
#define WG_D32                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "                                      \
  "%8, %9, %10, %11, %12, %13, %14, %15, "                                 \
  "%16, %17, %18, %19, %20, %21, %22, %23, "                               \
  "%24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_D64                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "                                      \
  "%8, %9, %10, %11, %12, %13, %14, %15, "                                 \
  "%16, %17, %18, %19, %20, %21, %22, %23, "                               \
  "%24, %25, %26, %27, %28, %29, %30, %31, "                               \
  "%32, %33, %34, %35, %36, %37, %38, %39, "                               \
  "%40, %41, %42, %43, %44, %45, %46, %47, "                               \
  "%48, %49, %50, %51, %52, %53, %54, %55, "                               \
  "%56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x N) = [d +] A . B^T, A [64 x 16] and B [N x 16] both K-major in
// shared memory; scale_d = 0 ignores d's old value.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 8][4], uint64_t da,
                                         uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[4][4], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " WG_D16
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : WG_F8(d, 0), WG_F8(d, 2)
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[8][4], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_F8(d, 0), WG_F8(d, 2), WG_F8(d, 4), WG_F8(d, 6)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x N) += A . B, A [64 x 16] bf16 fragments in registers (a), B
// [16 x N] in shared memory, MN-major (transpose bit set). N 192 and 256
// issue the N = 128 form on the first two column blocks and the N = 64 or
// 128 form on the rest, from the descriptor moved two column blocks on.
template <int N>
__device__ __forceinline__ void wgmma_rs_t(float (&d)[N / 8][4],
                                           const uint32_t (&a)[4],
                                           uint64_t db);

// An MN-major descriptor moved `blocks` column blocks on: they lie LBO
// bytes apart, and the address field counts 16 bytes as LBO's does.
__device__ __forceinline__ uint64_t desc_cols_on(uint64_t db, int blocks) {
  return db + (uint64_t)blocks * ((db >> 16) & 0x3FFF);
}

// the m64n64k16 / m64n128k16 register-A forms on d[j0 ..]
#define WG_RS_T64(d, j0, a, db)                                            \
  asm volatile(                                                            \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                         \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32       \
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                      \
      : WG_F8(d, j0), WG_F8(d, j0 + 2), WG_F8(d, j0 + 4), WG_F8(d, j0 + 6) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
#define WG_RS_T128(d, j0, a, db)                                           \
  asm volatile(                                                            \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                         \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D64      \
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                      \
      : WG_F8(d, j0), WG_F8(d, j0 + 2), WG_F8(d, j0 + 4), WG_F8(d, j0 + 6), \
        WG_F8(d, j0 + 8), WG_F8(d, j0 + 10), WG_F8(d, j0 + 12),            \
        WG_F8(d, j0 + 14)                                                  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

template <>
__device__ __forceinline__ void wgmma_rs_t<64>(float (&d)[8][4],
                                               const uint32_t (&a)[4],
                                               uint64_t db) {
  WG_RS_T64(d, 0, a, db);
}

template <>
__device__ __forceinline__ void wgmma_rs_t<128>(float (&d)[16][4],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  WG_RS_T128(d, 0, a, db);
}

template <>
__device__ __forceinline__ void wgmma_rs_t<192>(float (&d)[24][4],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  WG_RS_T128(d, 0, a, db);
  WG_RS_T64(d, 16, a, desc_cols_on(db, 2));
}

template <>
__device__ __forceinline__ void wgmma_rs_t<256>(float (&d)[32][4],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  WG_RS_T128(d, 0, a, db);
  WG_RS_T128(d, 16, a, desc_cols_on(db, 2));
}

#undef WG_RS_T64
#undef WG_RS_T128
#undef WG_F8
#undef WG_D16
#undef WG_D32
#undef WG_D64

// The warpgroup's 64 x D accumulator tile, row halves scaled by mul[h],
// as bf16 into a tile of the layout contract above (column blocks `rows`
// rows tall), its first row at row `row0` of the blocks. A warp writes 8
// rows of one 16-byte chunk at a time, which the swizzle spreads over all
// 32 banks.
template <int D>
__device__ __forceinline__ void stage_acc_bf16(unsigned char* tile, int rows,
                                               int row0,
                                               const float (&acc)[D / 8][4],
                                               const float (&mul)[2]) {
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + warp * 16 + g + 8 * h;
      unsigned char* at = tile + (j / 8) * rows * 128 + r * 128 +
                          (((j % 8) ^ (r % 8)) * 16) + t * 4;
      *reinterpret_cast<__nv_bfloat162*>(at) = __floats2bfloat162_rn(
          acc[j][2 * h] * mul[h], acc[j][2 * h + 1] * mul[h]);
    }
}

// -------------------------------------------------------- tensor maps

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so
// no source links libcuda itself.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A [bh, rows, d] tensor of `elem`-byte elements as a 3-D tensor map
// read in boxes of 128 bytes of columns x box_rows rows with 128-byte
// swizzle. Rows past `rows` read as zeros (a box never runs into the next
// batch-head).
inline cudaError_t tiled_map(CUtensorMap* map, CUtensorMapDataType type,
                             int elem, const void* ptr, int bh, int rows,
                             int d, int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * elem,
                                 (cuuint64_t)rows * d * elem};
  const cuuint32_t box[3] = {(cuuint32_t)(128 / elem), (cuuint32_t)box_rows,
                             1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, type, 3, const_cast<void*>(ptr), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// bf16: boxes of 64 columns, the layout contract above
inline cudaError_t bf16_map(CUtensorMap* map, const void* ptr, int bh,
                            int rows, int d, int box_rows) {
  return tiled_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptr, bh, rows,
                   d, box_rows);
}

// fp32: boxes of 32 columns, laid out as the contract lays bf16 out (D / 32
// column blocks of R rows x 128 bytes, 16-byte chunk c of row r at
// c ^ (r % 8))
inline cudaError_t f32_map(CUtensorMap* map, const void* ptr, int bh,
                           int rows, int d, int box_rows) {
  return tiled_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ptr, bh, rows, d,
                   box_rows);
}

}  // namespace
