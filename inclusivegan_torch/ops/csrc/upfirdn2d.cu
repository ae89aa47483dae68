// upfirdn2d for sm_90a: zero-insert upsample, pad or crop, FIR, decimate, on
// NCHW, in one pass with no padded copy.
//
// Replaces inclusivegan_tpu/ops/pallas_kernels.py::_upfirdn_core_impl (kernel
// body _fir_kernel). The TPU version pads and dilates the input on the host
// (lax.pad) and runs an unrolled shift-and-sum per (n, c) image in VMEM. Here
// one thread computes one output pixel and folds the zero-insert, the pad or
// crop and the decimation into index arithmetic: for output row oy and tap
// row i the source row on the upsampled grid is u = oy*down + i - pady0, and
// the tap contributes only when 0 <= u < H*up and u % up == 0 (it then reads
// input row u / up). Columns likewise. Nothing padded is ever written.
//
// Blocks tile (ox, oy) in 32x8 and walk the (n, c) images along z. A thread
// works out once which input rows and columns its taps read, without a
// division for up = 1 or 2, then applies them to kImagesPerThread images.
// Taps arrive already flipped and multiplied by gain (so the loop is a
// correlation), as a fixed-size by-value argument laid out KMAX x KMAX, with
// KMAX = 4 or 8 fixed at compile time so the tap loops unroll. The sum is
// float32 whatever the storage type, rounded once on store. It takes the
// taps in the plain version's order (row-major over the flipped taps), and
// rounds each product and each sum (__fmul_rn, __fadd_rn: never contracted
// into an FMA), so a float32 output equals the plain version's bit for bit.
// The gradients of a training step sum millions of these outputs with
// heavy cancellation (on the CPU a noise strength's gradient moves by up to
// 0.55% when the 16-term sum is merely taken in reverse order:
// tests/torch_golden/fir_order_sensitivity.py), so an FIR that rounded
// otherwise would make the kernel path and the plain path disagree by more
// than any fixed tolerance can tell from a fault.
//
// Bound: memory on the generator's shapes. An output pixel costs at most
// 2*kh*kw = 32 operations for a 4x4 filter (a quarter of that when up = 2,
// since three taps in four fall on inserted zeros), against 8 bytes moved per
// float32 pixel in and out: about 4 operations per byte, under the ~20 at
// which an H100's float32 units, not its 3.35 TB/s of HBM, would set the
// pace. The least time is (bytes of x + bytes of y) / 3.35 TB/s. Neighbouring
// threads take neighbouring output columns, so stores coalesce and the
// overlapping input reads hit L1/L2. Shared-memory tiling is later work.

#include <cuda_runtime.h>

#include "dtype.cuh"

namespace {

constexpr int kMaxTaps = 8;
constexpr int kImagesPerThread = 4;

struct Taps {
  float v[kMaxTaps * kMaxTaps];  // row-major KMAX x KMAX, zero-padded
};

// Index into the input of sample u of the upsampled axis, or -1 where u
// falls on an inserted zero or outside [0, size*up). Divides only when up > 2.
__device__ __forceinline__ int source_index(int u, int up, int size) {
  if (u < 0) return -1;
  int q = u;
  if (up == 2) {
    if (u & 1) return -1;
    q = u >> 1;
  } else if (up > 2) {
    if (u % up != 0) return -1;
    q = u / up;
  }
  return q < size ? q : -1;
}

template <typename T, int KMAX>
__global__ void upfirdn2d_kernel(const T* __restrict__ x, T* __restrict__ y, const Taps taps,
                                 int nc, int H, int W, int OH, int OW, int up, int down,
                                 int padx0, int pady0, int kh, int kw) {
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  const int oy = blockIdx.y * blockDim.y + threadIdx.y;
  if (ox >= OW || oy >= OH) return;
  // Input row offset and column each tap reads, or -1 where the tap falls on
  // an inserted zero, in the padding, or beyond the filter.
  int row[KMAX], col[KMAX];
#pragma unroll
  for (int i = 0; i < KMAX; ++i) {
    const int r = i < kh ? source_index(oy * down - pady0 + i, up, H) : -1;
    row[i] = r < 0 ? -1 : r * W;
    col[i] = i < kw ? source_index(ox * down - padx0 + i, up, W) : -1;
  }
  for (int p = blockIdx.z; p < nc; p += gridDim.z) {
    const T* img = x + (long long)p * H * W;
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < KMAX; ++i) {
      if (row[i] < 0) continue;
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        if (col[j] >= 0)
          acc = __fadd_rn(acc, __fmul_rn(taps.v[i * KMAX + j], to_f32(img[row[i] + col[j]])));
      }
    }
    y[((long long)p * OH + oy) * OW + ox] = from_f32<T>(acc);
  }
}

template <typename T, int KMAX>
int launch(const void* x, void* y, const float* taps, int kh, int kw, long long nc, int H,
           int W, int OH, int OW, int up, int down, int padx0, int pady0, cudaStream_t stream) {
  if (nc == 0 || OH == 0 || OW == 0) return cudaSuccess;
  Taps t = {};
  for (int i = 0; i < kh; ++i)
    for (int j = 0; j < kw; ++j) t.v[i * KMAX + j] = taps[i * kw + j];
  const dim3 block(32, 8);
  long long gz = (nc + kImagesPerThread - 1) / kImagesPerThread;
  if (gz > 65535) gz = 65535;
  const dim3 grid((OW + 31) / 32, (OH + 7) / 8, (unsigned)gz);
  upfirdn2d_kernel<T, KMAX><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), t, (int)nc, H, W, OH, OW, up, down, padx0,
      pady0, kh, kw);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, void* y, const float* taps, int kh, int kw, long long nc, int H,
           int W, int OH, int OW, int up, int down, int padx0, int pady0, cudaStream_t stream) {
  if (kh <= 4 && kw <= 4)
    return launch<T, 4>(x, y, taps, kh, kw, nc, H, W, OH, OW, up, down, padx0, pady0, stream);
  return launch<T, kMaxTaps>(x, y, taps, kh, kw, nc, H, W, OH, OW, up, down, padx0, pady0,
                             stream);
}

}  // namespace

// x: [nc, H, W] contiguous; y: [nc, OH, OW] contiguous. taps: host array of
// kh*kw floats, flipped and scaled by gain. dtype: 0 float32, 1 float16,
// 2 bfloat16. Returns the cudaError_t of the launch; does not synchronise.
extern "C" int upfirdn2d_launch(const void* x, void* y, const float* taps, int kh, int kw,
                                long long nc, int H, int W, int OH, int OW, int up, int down,
                                int padx0, int pady0, int dtype, void* stream) {
  if (kh < 1 || kw < 1 || kh > kMaxTaps || kw > kMaxTaps || up < 1 || down < 1 || H < 1 ||
      W < 1 || OH < 0 || OW < 0 || nc < 0 || nc > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(x, y, taps, kh, kw, nc, H, W, OH, OW, up, down, padx0, pady0, s);
    case 1:
      return launch<__half>(x, y, taps, kh, kw, nc, H, W, OH, OW, up, down, padx0, pady0, s);
    case 2:
      return launch<__nv_bfloat16>(x, y, taps, kh, kw, nc, H, W, OH, OW, up, down, padx0, pady0,
                                   s);
    default: return (int)cudaErrorInvalidValue;
  }
}
