// bias + leaky ReLU + gain, one elementwise pass, and its gradient, for sm_90a.
//
// Replaces inclusivegan_tpu/ops/pallas_kernels.py::_bias_lrelu_2d (kernel
// body _bias_lrelu_kernel): y = where(x + b >= 0, x + b, alpha * (x + b)) * gain
// with x viewed as [outer, C, inner] and one bias per channel. The TPU kernel
// views NCHW as [N*C, H*W] rows; here the channel of element i is
// (i / inner) % C, which covers NCHW (inner = H*W) and a dense layer's [B, C]
// output (inner = 1) with the same kernel.
//
// Bound: memory. Each element is read once and written once for three
// floating-point operations, far below the ~20 operations per byte at which
// an H100 stops being limited by its 3.35 TB/s of HBM, so the least time is
// (bytes of x + bytes of y + bytes of b) / 3.35 TB/s. The design keeps loads
// wide where it can: when `inner` is a multiple of 4 and both pointers are
// 16-byte aligned, a thread loads four neighbouring elements at once (one
// float4, or 8 bytes of half or bfloat16), which share one bias. A
// grid-stride loop walks the whole tensor.
//
// Arithmetic is float32 whatever the storage type: the sum, the sign test and
// both scalings, rounded once on store.
//
// The gradient kernel (bias_lrelu_grad_launch) computes dx = slope(y) * dy
// with slope = gain where y >= 0 and gain * alpha elsewhere: the tangent of
// the TPU kernel's custom_jvp (pallas_kernels.py::_bias_act_jvp), read from
// the output alone, since lrelu with gain > 0 keeps the sign of x + b. The
// same kernel is the gradient's own gradient (slope(y) * ddx; y gets none,
// as the slope is piecewise constant). It needs no channel: the bias
// gradient, a sum of dx over every axis but the channel's, is left to the
// caller, as JAX leaves it to XLA. Bound: memory, y and dy read once and dx
// written once; four elements per thread where all three pointers allow.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dtype.cuh"

namespace {

// Four elements in one load: 16 bytes of float, 8 bytes of a 16-bit type.
template <typename T> struct Vec4 { using type = uint2; };
template <> struct Vec4<float> { using type = float4; };

__device__ __forceinline__ float lrelu(float v, float alpha, float gain) {
  return (v >= 0.0f ? v : v * alpha) * gain;
}

template <typename T>
__global__ void bias_lrelu_kernel(const T* __restrict__ x, const T* __restrict__ b,
                                  T* __restrict__ y, long long n, int C, long long inner,
                                  float alpha, float gain) {
  const long long stride = (long long)blockDim.x * gridDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int c = (int)((i / inner) % C);
    y[i] = from_f32<T>(lrelu(to_f32(x[i]) + to_f32(b[c]), alpha, gain));
  }
}

template <typename T>
__global__ void bias_lrelu_vec4_kernel(const T* __restrict__ x, const T* __restrict__ b,
                                       T* __restrict__ y, long long groups, int C,
                                       long long inner, float alpha, float gain) {
  using V = typename Vec4<T>::type;
  const long long stride = (long long)blockDim.x * gridDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < groups; g += stride) {
    const float bc = to_f32(b[(int)((g * 4 / inner) % C)]);
    V raw = reinterpret_cast<const V*>(x)[g];
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) e[k] = from_f32<T>(lrelu(to_f32(e[k]) + bc, alpha, gain));
    reinterpret_cast<V*>(y)[g] = raw;
  }
}

template <typename T>
int launch(const void* xp, const void* bp, void* yp, long long n, int C, long long inner,
           float alpha, float gain, cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  const T* x = static_cast<const T*>(xp);
  const T* b = static_cast<const T*>(bp);
  T* y = static_cast<T*>(yp);
  const int threads = 256;
  const bool vec = inner % 4 == 0 && (uintptr_t)xp % 16 == 0 && (uintptr_t)yp % 16 == 0;
  const long long work = vec ? n / 4 : n;
  long long blocks = (work + threads - 1) / threads;
  if (blocks > 65535) blocks = 65535;
  if (vec) {
    bias_lrelu_vec4_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(x, b, y, work, C, inner,
                                                                       alpha, gain);
  } else {
    bias_lrelu_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(x, b, y, n, C, inner, alpha,
                                                                  gain);
  }
  return (int)cudaGetLastError();
}

template <typename T>
__global__ void bias_lrelu_grad_kernel(const T* __restrict__ y, const T* __restrict__ dy,
                                       T* __restrict__ dx, long long n, float alpha, float gain) {
  const long long stride = (long long)blockDim.x * gridDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float slope = to_f32(y[i]) >= 0.0f ? gain : gain * alpha;
    dx[i] = from_f32<T>(slope * to_f32(dy[i]));
  }
}

template <typename T>
__global__ void bias_lrelu_grad_vec4_kernel(const T* __restrict__ y, const T* __restrict__ dy,
                                            T* __restrict__ dx, long long groups, float alpha,
                                            float gain) {
  using V = typename Vec4<T>::type;
  const long long stride = (long long)blockDim.x * gridDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < groups; g += stride) {
    V ry = reinterpret_cast<const V*>(y)[g];
    V rd = reinterpret_cast<const V*>(dy)[g];
    const T* ey = reinterpret_cast<const T*>(&ry);
    T* ed = reinterpret_cast<T*>(&rd);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float slope = to_f32(ey[k]) >= 0.0f ? gain : gain * alpha;
      ed[k] = from_f32<T>(slope * to_f32(ed[k]));
    }
    reinterpret_cast<V*>(dx)[g] = rd;
  }
}

template <typename T>
int launch_grad(const void* yp, const void* dyp, void* dxp, long long n, float alpha, float gain,
                cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  const T* y = static_cast<const T*>(yp);
  const T* dy = static_cast<const T*>(dyp);
  T* dx = static_cast<T*>(dxp);
  const int threads = 256;
  const bool vec = n % 4 == 0 && (uintptr_t)yp % 16 == 0 && (uintptr_t)dyp % 16 == 0 &&
                   (uintptr_t)dxp % 16 == 0;
  const long long work = vec ? n / 4 : n;
  long long blocks = (work + threads - 1) / threads;
  if (blocks > 65535) blocks = 65535;
  if (vec) {
    bias_lrelu_grad_vec4_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(y, dy, dx, work,
                                                                            alpha, gain);
  } else {
    bias_lrelu_grad_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(y, dy, dx, n, alpha,
                                                                       gain);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16. x, y: n contiguous elements; b: C.
// Returns the cudaError_t of the launch (0 on success); does not synchronise.
extern "C" int bias_lrelu_launch(const void* x, const void* b, void* y, long long n, int C,
                                 long long inner, float alpha, float gain, int dtype,
                                 void* stream) {
  if (C < 1 || inner < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(x, b, y, n, C, inner, alpha, gain, s);
    case 1: return launch<__half>(x, b, y, n, C, inner, alpha, gain, s);
    case 2: return launch<__nv_bfloat16>(x, b, y, n, C, inner, alpha, gain, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dx = slope(y) * dy elementwise over n contiguous elements of y, dy and dx
// (one dtype, as above). Returns the cudaError_t of the launch; does not
// synchronise.
extern "C" int bias_lrelu_grad_launch(const void* y, const void* dy, void* dx, long long n,
                                      float alpha, float gain, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_grad<float>(y, dy, dx, n, alpha, gain, s);
    case 1: return launch_grad<__half>(y, dy, dx, n, alpha, gain, s);
    case 2: return launch_grad<__nv_bfloat16>(y, dy, dx, n, alpha, gain, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
