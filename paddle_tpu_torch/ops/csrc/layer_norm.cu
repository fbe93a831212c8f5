// Fused LayerNorm forward for Hopper (sm_90a), written by hand, over a
// row-major [N, F] matrix.
//
// Replaces the Pallas TPU kernel of paddle_tpu/ops/pallas/layer_norm.py:
//   ln_fwd_kernel  <- _ln_kernel (:23, pallas_call :38)
// and computes what it computes, in the same order: the fp32 mean, then
// the variance as the mean of (x - mean)^2 (two passes, not E[x^2] -
// mean^2), rsqrt(var + eps), the affine in fp32, the output cast to x's
// dtype. gamma and beta arrive as fp32 (the wrapper widens them).
//
// The TPU kernel holds a (256, F) block in VMEM; here one warp owns a
// row, 8 rows a block, and reads it with 16-byte loads (8 bf16 or 4 fp32
// a lane) when F is a multiple of the vector width, else one element a
// lane. The row is read three times (mean, variance, output), the second
// and third time from the L1 / L2 cache, so device memory sees x read
// once and y written once. Bound on the H100 SXM: bytes, at 3.35 TB/s;
// at the train path's activations ([8192, 2048] bf16, 33.6 MB each way)
// about 0.020 ms.

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

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
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

template <typename T>
cudaError_t launch(const void* x, const void* gamma, const void* beta,
                   void* y, int n, int f, float eps, cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  const dim3 grid((n + kWarps - 1) / kWarps);
  const T* xt = static_cast<const T*>(x);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  T* yt = static_cast<T*>(y);
  if (f % kVec == 0)
    ln_fwd_kernel<T, kVec><<<grid, kThreads, 0, st>>>(xt, g, b, yt, n, f, eps);
  else
    ln_fwd_kernel<T, 1><<<grid, kThreads, 0, st>>>(xt, g, b, yt, n, f, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t; nonzero means the kernel did not launch. dtype 0
// = float32, 1 = bfloat16 (x and y); gamma and beta are fp32 [f].
int ln_fwd_launch(const void* x, const void* gamma, const void* beta,
                  void* y, int n, int f, float eps, int dtype,
                  void* stream) {
  if (n < 1 || f < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(x, gamma, beta, y, n, f, eps, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, gamma, beta, y, n, f, eps, st);
  return (int)cudaErrorInvalidValue;
}

const char* ln_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
