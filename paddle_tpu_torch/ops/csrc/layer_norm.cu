// Fused LayerNorm forward for Hopper (sm_90a), written by hand, over a
// row-major [N, F] matrix.
//
// Replaces the Pallas TPU kernel of paddle_tpu/ops/pallas/layer_norm.py:
//   ln_fwd_kernel, ln_fwd_loop_kernel  <- _ln_kernel (:23, pallas_call :38)
// and computes what it computes, in the same order: the fp32 mean, then
// the variance as the mean of (x - mean)^2 (two passes, not E[x^2] -
// mean^2), rsqrt(var + eps), the affine in fp32, the output cast to x's
// dtype. gamma and beta arrive as fp32 (the wrapper widens them).
//
// The TPU kernel holds a (256, F) block in VMEM; here the row is held in
// registers. Bound on the H100 SXM: bytes, at 3.35 TB/s; at the train
// path's activations ([8192, 2048] bf16, 33.6 MB each way) about 0.020
// ms. So the design is about keeping enough loads in flight:
//   ln_fwd_kernel<T, W, C>  W warps own a row (8 / W rows a block of 8
//       warps); each thread reads C 16-byte vectors of it (8 bf16 or 4
//       fp32 each, vector c * 32 W + thread), all C loads issued before
//       the first reduction, and keeps them in registers: the mean and the
//       variance are reduced from registers and x is read once. A row's
//       partial sums meet by warp shuffles and, when W > 1, through shared
//       memory. gamma and beta are read as float4. A row takes as many
//       warps as it has vectors for, up to 8 (a 2048-wide row all 8), so
//       each thread holds as few as it can and a decode step's 16 rows
//       run on 16 SMs.
//   ln_fwd_loop_kernel<T, VEC>  rows the templates do not cover (F not a
//       multiple of the vector width, or past C = 16 vectors at W = 8):
//       one warp a row walks it three times (mean, variance, output), 16-
//       byte loads where F allows, else one element a lane.
// The wrapper (ops/layer_norm.py, _plan) picks the kernel and (W, C) from
// F before the launch: a choice by shape, not a fallback.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
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

// VEC consecutive elements at p as fp32: one 16-byte load, or a scalar.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float (&out)[VEC]) {
  if constexpr (VEC == 1) {
    out[0] = to_float(p[0]);
  } else {
    static_assert(VEC * sizeof(T) == 16, "one 16-byte vector");
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int u = 0; u < VEC; ++u) out[u] = to_float(v[u]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* __restrict__ p,
                                          const float (&in)[VEC]) {
  if constexpr (VEC == 1) {
    p[0] = from_float<T>(in[0]);
  } else {
    uint4 raw;
    T* v = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int u = 0; u < VEC; ++u) v[u] = from_float<T>(in[u]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// 32-bit word k of a 16-byte vector (k known at compile time).
__device__ __forceinline__ uint32_t word(const uint4& r, int k) {
  return k == 0 ? r.x : k == 1 ? r.y : k == 2 ? r.z : r.w;
}

// Element u of a 16-byte vector of T, as fp32, straight from the register
// that holds it.
template <typename T> __device__ __forceinline__ float elem(const uint4& r,
                                                            int u);
template <> __device__ __forceinline__ float elem<float>(const uint4& r,
                                                         int u) {
  return __uint_as_float(word(r, u));
}
template <> __device__ __forceinline__ float elem<__nv_bfloat16>(
    const uint4& r, int u) {
  const uint32_t w = word(r, u / 2);
  return __uint_as_float(u % 2 ? w & 0xFFFF0000u : w << 16);
}

template <typename T>
__device__ __forceinline__ float vec_sum(const uint4& r) {
  float s = 0.f;
#pragma unroll
  for (int u = 0; u < 16 / (int)sizeof(T); ++u) s += elem<T>(r, u);
  return s;
}

template <typename T>
__device__ __forceinline__ float vec_sq(const uint4& r, float mean) {
  float s = 0.f;
#pragma unroll
  for (int u = 0; u < 16 / (int)sizeof(T); ++u) {
    const float d = elem<T>(r, u) - mean;
    s += d * d;
  }
  return s;
}

// 16 bytes of T from fp32 values.
template <typename T>
__device__ __forceinline__ uint4 pack(const float (&o)[16 / sizeof(T)]) {
  uint4 out;
  T* v = reinterpret_cast<T*>(&out);
#pragma unroll
  for (int u = 0; u < (int)(16 / sizeof(T)); ++u) v[u] = from_float<T>(o[u]);
  return out;
}

// The sum over the W warps that own the calling thread's row; `part`
// holds a partial per warp of the block (a buffer of its own for each
// reduction, so one barrier suffices).
template <int W>
__device__ __forceinline__ float row_sum(float v, float* part) {
  v = warp_sum(v);
  if constexpr (W == 1) {
    return v;
  } else {
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0) part[warp] = v;
    __syncthreads();
    const int first = warp / W * W;
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) total += part[first + w];
    return total;
  }
}

template <typename T, int W, int C>
__global__ void __launch_bounds__(kThreads)
ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ beta, T* __restrict__ y, int n,
              int f, float eps) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kRowThreads = 32 * W;
  __shared__ float part[2][kWarps];
  const int tr = threadIdx.x % kRowThreads;  // the thread's place in its row
  const int row = blockIdx.x * (kWarps / W) + threadIdx.x / kRowThreads;
  const int nv = f / kVec;  // 16-byte vectors a row
  // rows past n keep their threads for the block's barriers
  const bool row_ok = row < n;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * f);

  // the thread's share of the row, every load in flight at once
  uint4 raw[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int i = c * kRowThreads + tr;
    raw[c] = row_ok && i < nv ? __ldg(xr + i) : make_uint4(0, 0, 0, 0);
  }

  float sum = 0.f;  // vectors past the row's end hold zeros
#pragma unroll
  for (int c = 0; c < C; ++c) sum += vec_sum<T>(raw[c]);
  const float mean = row_sum<W>(sum, part[0]) / f;

  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (c * kRowThreads + tr < nv) sq += vec_sq<T>(raw[c], mean);
  const float inv = rsqrtf(row_sum<W>(sq, part[1]) / f + eps);

  if (!row_ok) return;
  uint4* yr = reinterpret_cast<uint4*>(y + (size_t)row * f);
  const float4* g4 = reinterpret_cast<const float4*>(gamma);
  const float4* b4 = reinterpret_cast<const float4*>(beta);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int i = c * kRowThreads + tr;
    if (i >= nv) continue;
    float o[kVec];
#pragma unroll
    for (int q = 0; q < kVec / 4; ++q) {
      const float4 gm = __ldg(g4 + i * (kVec / 4) + q);
      const float4 bt = __ldg(b4 + i * (kVec / 4) + q);
      o[4 * q + 0] = (elem<T>(raw[c], 4 * q + 0) - mean) * inv * gm.x + bt.x;
      o[4 * q + 1] = (elem<T>(raw[c], 4 * q + 1) - mean) * inv * gm.y + bt.y;
      o[4 * q + 2] = (elem<T>(raw[c], 4 * q + 2) - mean) * inv * gm.z + bt.z;
      o[4 * q + 3] = (elem<T>(raw[c], 4 * q + 3) - mean) * inv * gm.w + bt.w;
    }
    yr[i] = pack<T>(o);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
ln_fwd_loop_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ beta, T* __restrict__ y, int n,
                   int f, float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= n) return;  // whole warps leave together
  const T* xr = x + (size_t)row * f;
  T* yr = y + (size_t)row * f;

  float sum = 0.f;
  for (int i = lane * VEC; i < f; i += 32 * VEC) {
    float v[VEC];
    load_vec<T, VEC>(xr + i, v);
#pragma unroll
    for (int u = 0; u < VEC; ++u) sum += v[u];
  }
  const float mean = warp_sum(sum) / f;

  float sq = 0.f;
  for (int i = lane * VEC; i < f; i += 32 * VEC) {
    float v[VEC];
    load_vec<T, VEC>(xr + i, v);
#pragma unroll
    for (int u = 0; u < VEC; ++u) {
      const float d = v[u] - mean;
      sq += d * d;
    }
  }
  const float inv = rsqrtf(warp_sum(sq) / f + eps);

  for (int i = lane * VEC; i < f; i += 32 * VEC) {
    float v[VEC];
    load_vec<T, VEC>(xr + i, v);
#pragma unroll
    for (int u = 0; u < VEC; ++u)
      v[u] = (v[u] - mean) * inv * gamma[i + u] + beta[i + u];
    store_vec<T, VEC>(yr + i, v);
  }
}

template <typename T, int W, int C>
cudaError_t launch_rows(const T* x, const float* g, const float* b, T* y,
                        int n, int f, float eps, cudaStream_t st) {
  constexpr int kRows = kWarps / W;  // rows a block
  ln_fwd_kernel<T, W, C><<<(n + kRows - 1) / kRows, kThreads, 0, st>>>(
      x, g, b, y, n, f, eps);
  return cudaGetLastError();
}

template <typename T, int W>
cudaError_t launch_w(int chunks, const T* x, const float* g, const float* b,
                     T* y, int n, int f, float eps, cudaStream_t st) {
  switch (chunks) {
    case 1: return launch_rows<T, W, 1>(x, g, b, y, n, f, eps, st);
    case 2: return launch_rows<T, W, 2>(x, g, b, y, n, f, eps, st);
    case 4: return launch_rows<T, W, 4>(x, g, b, y, n, f, eps, st);
    case 8: return launch_rows<T, W, 8>(x, g, b, y, n, f, eps, st);
    case 16: return launch_rows<T, W, 16>(x, g, b, y, n, f, eps, st);
  }
  return cudaErrorInvalidValue;
}

// warps == 0 runs the looping kernel; else W = warps (1, 2, 4, 8) and C
// = chunks (1, 2, 4, 8, 16), which must cover the row: 32 W C 16-byte
// vectors >= F / the vector width.
template <typename T>
cudaError_t launch(const void* x, const void* gamma, const void* beta,
                   void* y, int n, int f, float eps, int warps, int chunks,
                   cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  const T* xt = static_cast<const T*>(x);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  T* yt = static_cast<T*>(y);
  if (warps == 0) {
    const dim3 grid((n + kWarps - 1) / kWarps);
    if (f % kVec == 0)
      ln_fwd_loop_kernel<T, kVec><<<grid, kThreads, 0, st>>>(xt, g, b, yt, n,
                                                             f, eps);
    else
      ln_fwd_loop_kernel<T, 1><<<grid, kThreads, 0, st>>>(xt, g, b, yt, n, f,
                                                          eps);
    return cudaGetLastError();
  }
  if (f % kVec != 0 || (long long)32 * warps * chunks * kVec < f)
    return cudaErrorInvalidValue;
  switch (warps) {
    case 1: return launch_w<T, 1>(chunks, xt, g, b, yt, n, f, eps, st);
    case 2: return launch_w<T, 2>(chunks, xt, g, b, yt, n, f, eps, st);
    case 4: return launch_w<T, 4>(chunks, xt, g, b, yt, n, f, eps, st);
    case 8: return launch_w<T, 8>(chunks, xt, g, b, yt, n, f, eps, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Returns a cudaError_t; nonzero means the kernel did not launch. dtype 0
// = float32, 1 = bfloat16 (x and y); gamma and beta are fp32 [f]; warps
// and chunks as launch() above says.
int ln_fwd_launch(const void* x, const void* gamma, const void* beta,
                  void* y, int n, int f, float eps, int dtype, int warps,
                  int chunks, void* stream) {
  if (n < 1 || f < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(x, gamma, beta, y, n, f, eps, warps, chunks,
                              st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, gamma, beta, y, n, f, eps, warps,
                                      chunks, st);
  return (int)cudaErrorInvalidValue;
}

const char* ln_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
