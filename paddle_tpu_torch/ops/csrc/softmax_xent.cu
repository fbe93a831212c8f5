// Fused softmax cross-entropy for Hopper (sm_90a), written by hand: the
// forward (per-row loss and lse) and the backward (the logits' gradient),
// on logits z [N, V] (fp32 or bf16) and int64 labels [N].
//
// Replaces the two Pallas TPU kernels of
// paddle_tpu/ops/pallas/softmax_xent.py:
//   xent_fwd_kernel <- _xent_fwd_kernel (:59, pallas_call :132)
//   xent_bwd_kernel <- _xent_bwd_kernel (:97, pallas_call :166)
// The TPU grid walks (row block, vocab block) with the vocab innermost and
// carries the online-softmax state (m, l, z_y) in VMEM scratch across
// grid steps; here one 256-thread block owns one row and sweeps its whole
// vocabulary itself, so the state stays in registers and is merged across
// the block once, at the end. The reference pads rows to 128 and masks a
// ragged final vocab block; a row per block needs neither.
//   forward   lse = m + log(l) by one online sweep (each thread keeps its
//             own running max m and sum l over 16-byte vectors, rescaling
//             l once per vector), then loss = lse - z_y. z_y is the label's
//             logit when 0 <= label < V and 0 otherwise (the reference sums
//             the columns that equal the label); ignore_index rows give
//             loss 0. Writes loss and lse, fp32 [N].
//   backward  dz = (exp(z - lse) - onehot(label)) * g, with g zero on
//             ignore_index rows; fp32 arithmetic, dz written in z's type.
// exp is the fast __expf (ex2.approx): the sweep is bound by bytes, and
// its relative error (a few 1e-7) is far inside fp32 parity.
//
// Bound on the H100 SXM (3.35 TB/s) at the training path's shapes
// (N = 8 x 1024 rows, V = 50304, bf16 logits: 824 MB):
//   forward   reads z once (824 MB), writes 64 KB          -> 0.246 ms
//   backward  reads z once, writes dz once (1.65 GB)       -> 0.492 ms
// both by bytes: the forward's ~4 fp32 operations per logit (1.6 GFLOP)
// take 0.025 ms at the 67 TFLOP/s fp32 peak.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// 16-byte vectors: 4 fp32 or 8 bf16 values.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  using Raw = float4;
  __device__ static void unpack(const Raw& r, float* x) {
    x[0] = r.x; x[1] = r.y; x[2] = r.z; x[3] = r.w;
  }
  __device__ static Raw pack(const float* x) {
    return make_float4(x[0], x[1], x[2], x[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  using Raw = uint4;
  __device__ static void unpack(const Raw& r, float* x) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
  __device__ static Raw pack(const float* x) {
    Raw r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    return r;
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Adds x to the running (m, l): l counts exp(x - m).
__device__ __forceinline__ void online_add(float x, float& m, float& l) {
  if (x > m) {
    l = l * __expf(m - x) + 1.f;
    m = x;
  } else {
    l += __expf(x - m);
  }
}

// Merges (m2, l2) into (m, l); an empty side has m = -inf, l = 0.
__device__ __forceinline__ void merge(float& m, float& l, float m2,
                                      float l2) {
  const float mm = fmaxf(m, m2);
  if (mm == -INFINITY) return;
  l = l * __expf(m - mm) + l2 * __expf(m2 - mm);
  m = mm;
}

// Whether the row at zr can be read (or written) with 16-byte vectors.
template <typename T>
__device__ __forceinline__ bool vector_row(const T* zr, int v) {
  return v % Vec<T>::N == 0 &&
         reinterpret_cast<uintptr_t>(zr) % sizeof(typename Vec<T>::Raw) == 0;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    xent_fwd_kernel(const T* __restrict__ z,
                    const int64_t* __restrict__ labels,
                    float* __restrict__ loss, float* __restrict__ lse,
                    int v, int64_t ignore_index) {
  const int row = blockIdx.x;
  const T* zr = z + (size_t)row * v;
  float m = -INFINITY, l = 0.f;
  int done = 0;
  if (vector_row(zr, v)) {
    using V = Vec<T>;
    const typename V::Raw* zv = reinterpret_cast<const typename V::Raw*>(zr);
    const int nv = v / V::N;
    for (int i = threadIdx.x; i < nv; i += kThreads) {
      float x[V::N];
      V::unpack(zv[i], x);
      float mx = x[0];
#pragma unroll
      for (int e = 1; e < V::N; ++e) mx = fmaxf(mx, x[e]);
      if (mx > m) {
        l *= __expf(m - mx);
        m = mx;
      }
#pragma unroll
      for (int e = 0; e < V::N; ++e) l += __expf(x[e] - m);
    }
    done = nv * V::N;
  }
  for (int c = done + threadIdx.x; c < v; c += kThreads)
    online_add(to_f32(zr[c]), m, l);

  // merge the block's (m, l): warp shuffles, then one value per warp
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, off);
    merge(m, l, m2, l2);
  }
  __shared__ float ms[kThreads / 32], ls[kThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    ms[warp] = m;
    ls[warp] = l;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) merge(m, l, ms[w], ls[w]);
    const float row_lse = m + logf(l);
    const int64_t lab = labels[row];
    const float zy = (lab >= 0 && lab < v) ? to_f32(zr[lab]) : 0.f;
    loss[row] = lab == ignore_index ? 0.f : row_lse - zy;
    lse[row] = row_lse;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    xent_bwd_kernel(const T* __restrict__ z,
                    const int64_t* __restrict__ labels,
                    const float* __restrict__ lse,
                    const float* __restrict__ g, T* __restrict__ dz, int v,
                    int64_t ignore_index) {
  const int row = blockIdx.x;
  const T* zr = z + (size_t)row * v;
  T* dr = dz + (size_t)row * v;
  const int64_t lab = labels[row];
  const float gr = lab == ignore_index ? 0.f : g[row];
  const float row_lse = lse[row];
  int done = 0;
  if (vector_row(zr, v) && vector_row(static_cast<const T*>(dr), v)) {
    using V = Vec<T>;
    const typename V::Raw* zv = reinterpret_cast<const typename V::Raw*>(zr);
    typename V::Raw* dv = reinterpret_cast<typename V::Raw*>(dr);
    const int nv = v / V::N;
    for (int i = threadIdx.x; i < nv; i += kThreads) {
      float x[V::N];
      V::unpack(zv[i], x);
#pragma unroll
      for (int e = 0; e < V::N; ++e) {
        const float hit = (int64_t)(i * V::N + e) == lab ? 1.f : 0.f;
        x[e] = (__expf(x[e] - row_lse) - hit) * gr;
      }
      dv[i] = V::pack(x);
    }
    done = nv * V::N;
  }
  for (int c = done + threadIdx.x; c < v; c += kThreads) {
    const float hit = (int64_t)c == lab ? 1.f : 0.f;
    dr[c] = from_f32<T>((__expf(to_f32(zr[c]) - row_lse) - hit) * gr);
  }
}

template <typename T>
cudaError_t launch_fwd(const void* z, const void* labels, void* loss,
                       void* lse, int n, int v, int64_t ignore_index,
                       cudaStream_t st) {
  xent_fwd_kernel<T><<<n, kThreads, 0, st>>>(
      static_cast<const T*>(z), static_cast<const int64_t*>(labels),
      static_cast<float*>(loss), static_cast<float*>(lse), v, ignore_index);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* z, const void* labels, const void* lse,
                       const void* g, void* dz, int n, int v,
                       int64_t ignore_index, cudaStream_t st) {
  xent_bwd_kernel<T><<<n, kThreads, 0, st>>>(
      static_cast<const T*>(z), static_cast<const int64_t*>(labels),
      static_cast<const float*>(lse), static_cast<const float*>(g),
      static_cast<T*>(dz), v, ignore_index);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each returns a cudaError_t; nonzero means the kernel did not launch.
// dtype 0 = float32, 1 = bfloat16; anything else, or an empty grid, is
// refused with cudaErrorInvalidValue before any launch.
int xent_fwd_launch(const void* z, const void* labels, void* loss,
                    void* lse, int n, int v, long long ignore_index,
                    int dtype, void* stream) {
  if (n <= 0 || v <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_fwd<float>(z, labels, loss, lse, n, v, ignore_index,
                                  st);
  if (dtype == 1)
    return (int)launch_fwd<__nv_bfloat16>(z, labels, loss, lse, n, v,
                                          ignore_index, st);
  return (int)cudaErrorInvalidValue;
}

int xent_bwd_launch(const void* z, const void* labels, const void* lse,
                    const void* g, void* dz, int n, int v,
                    long long ignore_index, int dtype, void* stream) {
  if (n <= 0 || v <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_bwd<float>(z, labels, lse, g, dz, n, v, ignore_index,
                                  st);
  if (dtype == 1)
    return (int)launch_bwd<__nv_bfloat16>(z, labels, lse, g, dz, n, v,
                                          ignore_index, st);
  return (int)cudaErrorInvalidValue;
}

const char* xent_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
