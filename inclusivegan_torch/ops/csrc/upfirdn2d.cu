// upfirdn2d for sm_90a: zero-insert upsample, pad or crop, FIR, decimate, on
// NCHW, with no padded copy in global memory.
//
// Replaces inclusivegan_tpu/ops/pallas_kernels.py::_upfirdn_core_impl (kernel
// body _fir_kernel). The TPU version pads and dilates the input on the host
// (lax.pad) and runs an unrolled shift-and-sum per (n, c) image in VMEM. Here
// the zero-insert, the pad or crop and the decimation are index arithmetic:
// for output row oy and tap row i the sample on the upsampled, padded grid is
// u = oy*down + i - pady0, which is input row u / up when 0 <= u < H*up and
// u % up == 0, and a zero otherwise. Columns likewise.
//
// The sum is float32 whatever the storage type, rounded once on store. Taps
// arrive already flipped and multiplied by gain (so the loop is a
// correlation). Each output's sum starts at 0 and takes the taps in the
// plain version's order (row-major over the flipped taps, the zeros of the
// padding and of the zero-insert included), rounding each product and each
// sum (__fmul_rn, __fadd_rn: never contracted into an FMA). So a float32
// output equals the plain version's bit for bit, and a float16 or bfloat16
// one the TPU kernel's. The gradients of a training step sum millions of
// these outputs with heavy cancellation (on the CPU a noise strength's
// gradient moves by up to 0.55% when the 16-term sum is merely taken in
// reverse order: tests/torch_golden/fir_order_sensitivity.py), so an FIR
// that rounded otherwise would make the kernel path and the plain path
// disagree by more than any fixed tolerance can tell from a fault.
//
// Bound: memory. An output pixel costs at most 2*kh*kw = 32 operations for a
// 4x4 filter against 8 bytes moved per float32 pixel in and out: about 4
// operations per byte, under the ~20 at which an H100's float32 units, not
// its 3.35 TB/s of HBM, would set the pace. Even unfused, the 32 operations
// per output of [24,128,128,128] take 0.048 ms at half the 67 TFLOP/s FMA
// rate, under its 0.121 ms byte bound. Tensor cores are not used: mma/wgmma
// take TF32 or bf16 operands and sum in their own order, which would break
// the equality above, and the op is memory-bound anyway.
//
// The tiled kernel (up and down in {1, 2}, taps up to 4x4: every
// configuration of the generator, the discriminator and their gradients):
// - A block owns a tile of one (n, c) image: up to 160 output columns (80
//   when down = 2) and as many rows as keep 24 KB of shared memory and three
//   work items per thread (32 rows of a 128-wide output, 72 of a 65-wide
//   one), with the rows spread evenly over the image's height. An image that
//   fits one small tile shares a step with others, up to 256 work items. The
//   block stages the samples of the upsampled, padded grid that the tile
//   reads, halo included, in shared memory as float32, once: real input
//   values where the index arithmetic finds one, zeros elsewhere. The row
//   stride is padded off multiples of 32 words.
// - It walks several steps, double-buffered: the copies of step p+1's tiles
//   are in flight (cp.async, cp.async.wait_group, __syncthreads) while it
//   computes step p. float32 rows whose width is a multiple of 4 are copied
//   16 bytes at a time, from a tile start rounded down to a 16-byte boundary;
//   odd widths (129 floats, a 516-byte stride) 4 bytes at a time; a copy
//   that falls in the padding reads nothing and writes zeros (src-size 0).
//   A warp copies a row of 96 copies or more; the copies of narrower rows
//   are dealt to the threads in turn across rows and images, so that narrow
//   tiles keep every lane busy.
//   TMA does not apply: a tensor map needs global strides that are multiples
//   of 16 bytes, and the main path's rows are 127, 129, 63, 65... floats
//   wide. float16 and bfloat16 tiles are loaded and converted by the threads.
// - Register blocking, by columns of 8 outputs: a thread computes 8
//   vertically neighbouring outputs of one column. It walks the input rows
//   that they share, reads each row's kw samples from shared memory into
//   registers once, and adds them into every output whose tap row it is.
//   Each output still takes its taps in row-major order, and the 8
//   accumulator chains are independent. Neighbouring threads take
//   neighbouring columns, so the shared-memory reads are free of bank
//   conflicts (down = 1) and the global stores of a warp coalesce. (Blocking
//   along a row instead would read shared memory at a stride of the block
//   width, and an odd output width leaves most rows misaligned for wide
//   stores.)
// - The grid is sized from the occupancy API to one wave of blocks, each
//   walking its share of the steps; the busiest walk at most one step more
//   than the mean, which costs the most where blocks walk few steps.
// Each input byte is read from HBM once; the halo rows that neighbouring
// tiles share come from L2.
//
// Configurations outside those templates (taps up to 8x8, any up and down)
// take the direct kernel: one thread per output pixel and per image, each tap
// one global load, in the same order and rounding.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <tuple>
#include <utility>

#include "dtype.cuh"

namespace {

constexpr int kMaxTaps = 8;
constexpr int kImagesPerThread = 4;  // direct kernel

struct Taps {
  float v[kMaxTaps * kMaxTaps];  // row-major KMAX x KMAX, zero-padded
};

// ---------------------------------------------------------------------------
// Tiled kernel
// ---------------------------------------------------------------------------

// Threads, rows per thread and stages were chosen by timing the main path's
// large configurations against 128 and 512 threads, 4 and 16 rows, 3 stages.
constexpr int kTiledTaps = 4;     // taps per axis the tiled kernel takes
constexpr int kTileThreads = 256;
constexpr int kRowsPerThread = 8;
constexpr int kTileCols = 160;    // most output columns per tile when down = 1
constexpr int kStages = 2;        // steps in flight per block
constexpr int kStageBytes = 24 * 1024;  // shared memory of one step, at most
constexpr int kMaxItems = 3;      // work items (a column of outputs) per thread
constexpr int kMaxTileSmem = 227 * 1024;

struct TileGeom {
  long long nc;
  int H, W, OH, OW, padx0, pady0, kh, kw;
  int TH, TW, ntx;  // output tile and tiles per row
  int rows, stride; // shared-memory rows and row stride of one image's tile, floats
  int G;            // images a block takes at each step (small images: several)
  int vec16;        // float32, up = 1, W % 4 == 0, 16-byte aligned input
};

__device__ __forceinline__ void cp_async4(float* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One sample into shared memory as float32: cp.async for float32, a load
// and a conversion for the 16-bit types (cp.async copies 4 bytes at least);
// zero where !ok.
template <typename T>
__device__ __forceinline__ void copy_one(float* dst, const T* src, bool ok) {
  if constexpr (sizeof(T) == 4) {
    cp_async4(dst, src, ok);
  } else {
    *dst = ok ? to_f32(*src) : 0.0f;
  }
}

// Stage the samples of the upsampled, padded grid that an output tile at
// (oy0, ox0) of rows x cols reads, for images first .. first + count - 1,
// into s: s[m * rows * stride + r * stride + shift + c] holds sample
// (oy0*DOWN - pady0 + r, ox0*DOWN - padx0 + c) of image first + m, by copies
// of one float or of 16 bytes.
template <typename T, int UP, int DOWN>
__device__ __forceinline__ void load_tiles(float* s, const T* x, long long first, int count,
                                           const TileGeom& g, int oy0, int ox0, int rows,
                                           int cols) {
  const int ur0 = oy0 * DOWN - g.pady0;
  const int uc0 = ox0 * DOWN - g.padx0;
  const int h = (rows - 1) * DOWN + g.kh;
  const int w = (cols - 1) * DOWN + g.kw;
  const long long in_size = (long long)g.H * g.W;
  bool vec = false;
  int c0 = uc0, units = w;  // first column and copies of a row
  if constexpr (sizeof(T) == 4 && UP == 1) {
    if (g.vec16) {
      vec = true;
      c0 = uc0 & ~3;  // rounded down to a 16-byte boundary
      units = (uc0 - c0 + w + 3) >> 2;
    }
  }
  if (units >= 96) {  // wide rows: a warp takes a row, its lanes the copies
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int mr = warp; mr < count * h; mr += kTileThreads / 32) {
      const int m = mr / h, r = mr - m * h;
      float* dst = s + (m * g.rows + r) * g.stride;
      const T* img = x + (first + m) * in_size;
      const int ur = ur0 + r;
      const bool row_ok = ur >= 0 && ur < g.H * UP && (ur & (UP - 1)) == 0;
      const T* src = img + (long long)(row_ok ? ur / UP : 0) * g.W;
      if (vec) {
        for (int u = lane; u < units; u += 32) {
          const int ic = c0 + 4 * u;
          const bool ok = row_ok && ic >= 0 && ic < g.W;  // all 4 in or all out
          cp_async16(dst + 4 * u, ok ? src + ic : src, ok);
        }
      } else {
        for (int u = lane; u < units; u += 32) {
          const int uc = uc0 + u;
          const bool ok = row_ok && uc >= 0 && uc < g.W * UP && (uc & (UP - 1)) == 0;
          copy_one(dst + u, ok ? src + uc / UP : src, ok);
        }
      }
    }
    return;
  }
  // copy number u of row r of image m
  auto copy = [&](int m, int r, int u) {
    float* dst = s + (m * g.rows + r) * g.stride;
    const T* img = x + (first + m) * in_size;
    if (vec) {
      const int ir = ur0 + r, ic = c0 + 4 * u;
      // W % 4 == 0: the 4 columns are all in or all out
      const bool ok = ir >= 0 && ir < g.H && ic >= 0 && ic < g.W;
      cp_async16(dst + 4 * u, ok ? img + (long long)ir * g.W + ic : img, ok);
    } else {
      const int ur = ur0 + r, uc = uc0 + u;
      const bool ok = ur >= 0 && ur < g.H * UP && (ur & (UP - 1)) == 0 && uc >= 0 &&
                      uc < g.W * UP && (uc & (UP - 1)) == 0;
      copy_one(dst + u, ok ? img + (long long)(ur / UP) * g.W + uc / UP : img, ok);
    }
  };
  // narrow rows: the copies of all rows and images dealt to the threads in
  // turn, each thread stepping through its own with counters
  const int per_image = h * units, total = count * per_image;
  int e = threadIdx.x;
  if (e >= total) return;
  int m = e / per_image;
  int r = (e - m * per_image) / units;
  int u = e - m * per_image - r * units;
  const int dm = kTileThreads / per_image, rem = kTileThreads - dm * per_image;
  const int dr = rem / units, du = rem - dr * units;
  for (; e < total; e += kTileThreads) {
    copy(m, r, u);
    u += du;
    r += dr;
    m += dm;
    if (u >= units) u -= units, ++r;
    if (r >= h) r -= h, ++m;
  }
}

// One thread's share of a step: up to kMaxItems columns of kRowsPerThread
// outputs, each as its image among the step's G, its offset in shared memory,
// its offset in the step's output and its number of rows inside the tile (0
// for none).
struct Items {
  int img[kMaxItems], smem[kMaxItems], out[kMaxItems], rows[kMaxItems];
};

template <int DOWN>
__device__ __forceinline__ Items thread_items(const TileGeom& g, int oy0, int ox0, int rows,
                                              int cols, int shift) {
  Items it;
  const int items = (rows + kRowsPerThread - 1) / kRowsPerThread * cols;  // per image
#pragma unroll
  for (int n = 0; n < kMaxItems; ++n) {
    const int qg = threadIdx.x + n * kTileThreads;
    const int m = qg / items, q = qg - m * items;
    const int rg = q / cols, x = q - rg * cols;
    it.img[n] = m;
    it.smem[n] = m * g.rows * g.stride + rg * kRowsPerThread * DOWN * g.stride + shift + x * DOWN;
    it.out[n] = m * g.OH * g.OW + (oy0 + rg * kRowsPerThread) * g.OW + ox0 + x;
    it.rows[n] = m < g.G ? min(kRowsPerThread, rows - rg * kRowsPerThread) : 0;
  }
  return it;
}

// The FIR of one step's staged tiles, for its first count images. K = 4:
// taps 4x4, known at compile time; K = 0: taps up to 4x4, g.kh x g.kw.
template <typename T, int DOWN, int K>
__device__ __forceinline__ void compute_tiles(const float* s, T* out, int count, const Taps& taps,
                                              const TileGeom& g, const Items& it) {
  constexpr int RY = kRowsPerThread;
  constexpr int KT = kTiledTaps;
  const int kh = K ? K : g.kh, kw = K ? K : g.kw;
#pragma unroll 1
  for (int n = 0; n < kMaxItems; ++n) {
    if (it.rows[n] == 0 || it.img[n] >= count) continue;
    const float* base = s + it.smem[n];
    float acc[RY];
#pragma unroll
    for (int k = 0; k < RY; ++k) acc[k] = 0.0f;
#pragma unroll
    for (int r = 0; r < (RY - 1) * DOWN + KT; ++r) {
      float v[KT];
#pragma unroll
      for (int j = 0; j < KT; ++j) v[j] = base[r * g.stride + j];
#pragma unroll
      for (int k = 0; k < RY; ++k) {
        const int i = r - k * DOWN;  // tap row of output row k that reads row r
        if (i >= 0 && i < KT && i < kh) {
#pragma unroll
          for (int j = 0; j < KT; ++j)
            if (j < kw) acc[k] = __fadd_rn(acc[k], __fmul_rn(taps.v[i * kMaxTaps + j], v[j]));
        }
      }
    }
    T* dst = out + it.out[n];
#pragma unroll
    for (int k = 0; k < RY; ++k)
      if (k < it.rows[n]) dst[k * g.OW] = from_f32<T>(acc[k]);
  }
}

template <typename T, int UP, int DOWN, int K>
__global__ void __launch_bounds__(kTileThreads)
    upfirdn2d_tiled_kernel(const T* __restrict__ x, T* __restrict__ y, const Taps taps,
                           const TileGeom g) {
  extern __shared__ __align__(16) float smem[];
  const int buf_size = g.G * g.rows * g.stride;
  const int ty = blockIdx.x / g.ntx;
  const int oy0 = ty * g.TH;
  const int ox0 = (blockIdx.x - ty * g.ntx) * g.TW;
  const int rows = min(g.TH, g.OH - oy0);
  const int cols = min(g.TW, g.OW - ox0);
  const int shift = g.vec16 ? ((ox0 * DOWN - g.padx0) & 3) : 0;
  const Items it = thread_items<DOWN>(g, oy0, ox0, rows, cols, shift);
  const long long out_size = (long long)g.OH * g.OW;
  const long long steps = (g.nc + g.G - 1) / g.G;
  auto count = [&](long long p) { return (int)min((long long)g.G, g.nc - p * g.G); };
  // steps p, p + gridDim.y, ... (each G images) go through a ring of kStages
  // buffers: the copies of the next kStages - 1 steps are in flight while
  // step p is computed
  long long p = blockIdx.y;
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    const long long q = p + k * (long long)gridDim.y;
    if (q < steps)
      load_tiles<T, UP, DOWN>(smem + k * buf_size, x, q * g.G, count(q), g, oy0, ox0, rows, cols);
    cp_async_commit();
  }
  for (int k = 0; p < steps; ++k, p += gridDim.y) {
    const long long ahead = p + (kStages - 1) * (long long)gridDim.y;
    if (ahead < steps)
      load_tiles<T, UP, DOWN>(smem + ((k + kStages - 1) % kStages) * buf_size, x, ahead * g.G,
                              count(ahead), g, oy0, ox0, rows, cols);
    cp_async_commit();
    cp_async_wait_group<kStages - 1>();  // step p's copies have landed
    __syncthreads();
    compute_tiles<T, DOWN, K>(smem + (k % kStages) * buf_size, y + p * g.G * out_size, count(p),
                              taps, g, it);
    __syncthreads();  // the buffer is free for the copies of a later step
  }
}

// SMs of the current device, and blocks of a kernel resident on one SM at
// a dynamic shared-memory size (opting the kernel in to more than 48 KB).
// Cached per kernel, device and size: the queries cost more host time than
// a launch.
cudaError_t occupancy(const void* kernel, int smem, int* sms, int* per_sm) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int>, std::pair<int, int>> cache;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const auto key = std::make_tuple(kernel, device, smem);
  std::lock_guard<std::mutex> lock(mu);
  auto it = cache.find(key);
  if (it == cache.end()) {
    int n = 0, b = 0;
    if (smem > 48 * 1024)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kMaxTileSmem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, kernel, kTileThreads, smem);
    if (err != cudaSuccess) return err;
    it = cache.emplace(key, std::make_pair(n, b)).first;
  }
  *sms = it->second.first;
  *per_sm = it->second.second;
  return cudaSuccess;
}

// A launch as the wrappers make it: the kernel's geometry, its grid and
// shared memory, and the occupancy the grid was sized from.
struct Plan {
  TileGeom g;
  dim3 grid, block;
  int smem, sms, per_sm;
};

template <typename T, int UP, int DOWN, int K>
cudaError_t plan_tiled(Plan* p, bool aligned16, int kh, int kw, long long nc, int H, int W,
                       int OH, int OW, int padx0, int pady0) {
  TileGeom& g = p->g;
  g.nc = nc;
  g.H = H, g.W = W, g.OH = OH, g.OW = OW, g.padx0 = padx0, g.pady0 = pady0, g.kh = kh, g.kw = kw;
  constexpr int RY = kRowsPerThread;
  const int max_cols = kTileCols / DOWN;
  g.ntx = (OW + max_cols - 1) / max_cols;
  g.TW = (OW + g.ntx - 1) / g.ntx;
  // room for the reads of taps beyond kh x kw and of rows past the tile's
  // last output, which only outputs that are not stored use
  g.stride = (3 + (g.TW - 1) * DOWN + kTiledTaps + 3) & ~3;
  if (g.stride % 32 == 0) g.stride += 4;
  // as many rows as keep a thread's items within kMaxItems and a tile
  // within kStageBytes, spread evenly over the image's height
  int th = std::min(kMaxItems * kTileThreads / g.TW,
                    ((kStageBytes / 4 / g.stride - kTiledTaps) / DOWN + 1) / RY) * RY;
  th = std::max(RY, std::min(th, (OH + RY - 1) / RY * RY));
  const int nty = (OH + th - 1) / th;
  g.TH = ((OH + nty - 1) / nty + RY - 1) / RY * RY;
  g.rows = (g.TH - 1) * DOWN + kTiledTaps;
  g.vec16 = sizeof(T) == 4 && UP == 1 && W % 4 == 0 && aligned16;
  if ((long long)OH * OW > 0x7fffffff) return cudaErrorInvalidValue;
  // small images: up to as many per step as keep the threads busy, within
  // 48 KB, and no more than it takes to give one wave of blocks work
  const int items = g.TH / kRowsPerThread * g.TW;
  const int tile_bytes = kStages * g.rows * g.stride * (int)sizeof(float);
  g.G = 1;
  if (nty == 1 && g.ntx == 1)
    g.G = (int)std::max(1LL, std::min({(long long)kTileThreads / items,
                                       48LL * 1024 / tile_bytes, nc,
                                       0x7fffffffLL / ((long long)OH * OW)}));
  if (g.G * tile_bytes > kMaxTileSmem) return cudaErrorInvalidValue;

  const cudaError_t err =
      occupancy(reinterpret_cast<const void*>(upfirdn2d_tiled_kernel<T, UP, DOWN, K>),
                g.G * tile_bytes, &p->sms, &p->per_sm);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)g.ntx * nty;
  const long long slots = (long long)p->sms * std::max(p->per_sm, 1);  // blocks of one wave
  g.G = (int)std::min((long long)g.G, std::max(1LL, (nc + slots - 1) / slots));
  p->smem = g.G * tile_bytes;
  const long long steps = (nc + g.G - 1) / g.G;
  const long long walkers = std::max(1LL, std::min({(slots + tiles - 1) / tiles, steps, 65535LL}));
  p->grid = dim3((unsigned)tiles, (unsigned)walkers);
  p->block = dim3(kTileThreads);
  return cudaSuccess;
}

template <typename T, int UP, int DOWN, int K>
int launch_tiled(const void* x, void* y, const float* taps, int kh, int kw, long long nc, int H,
                 int W, int OH, int OW, int padx0, int pady0, cudaStream_t stream) {
  Plan p;
  const cudaError_t err = plan_tiled<T, UP, DOWN, K>(&p, (uintptr_t)x % 16 == 0, kh, kw, nc, H,
                                                     W, OH, OW, padx0, pady0);
  if (err != cudaSuccess) return (int)err;
  Taps t = {};
  for (int i = 0; i < kh; ++i)
    for (int j = 0; j < kw; ++j) t.v[i * kMaxTaps + j] = taps[i * kw + j];
  upfirdn2d_tiled_kernel<T, UP, DOWN, K><<<p.grid, p.block, p.smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), t, p.g);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Direct kernel: any up and down, taps up to 8x8
// ---------------------------------------------------------------------------

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

// Blocks tile (ox, oy) in 32x8 and walk the (n, c) images along z. A thread
// works out once which input rows and columns its taps read, then applies
// them to kImagesPerThread images. Taps that fall on an inserted zero or in
// the padding are skipped: adding their zero products would not change the
// sum.
template <typename T, int KMAX>
__global__ void upfirdn2d_direct_kernel(const T* __restrict__ x, T* __restrict__ y,
                                        const Taps taps, int nc, int H, int W, int OH, int OW,
                                        int up, int down, int padx0, int pady0, int kh, int kw) {
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  const int oy = blockIdx.y * blockDim.y + threadIdx.y;
  if (ox >= OW || oy >= OH) return;
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

dim3 direct_grid(long long nc, int OH, int OW) {
  long long gz = (nc + kImagesPerThread - 1) / kImagesPerThread;
  if (gz > 65535) gz = 65535;
  return dim3((OW + 31) / 32, (OH + 7) / 8, (unsigned)gz);
}

template <typename T, int KMAX>
int launch_direct(const void* x, void* y, const float* taps, int kh, int kw, long long nc, int H,
                  int W, int OH, int OW, int up, int down, int padx0, int pady0,
                  cudaStream_t stream) {
  Taps t = {};
  for (int i = 0; i < kh; ++i)
    for (int j = 0; j < kw; ++j) t.v[i * KMAX + j] = taps[i * kw + j];
  upfirdn2d_direct_kernel<T, KMAX><<<direct_grid(nc, OH, OW), dim3(32, 8), 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), t, (int)nc, H, W, OH, OW, up, down, padx0,
      pady0, kh, kw);
  return (int)cudaGetLastError();
}

bool tiled(int kh, int kw, int up, int down) {
  return kh <= kTiledTaps && kw <= kTiledTaps && up <= 2 && down <= 2;
}

// f(up, down, taps) with the tiled kernel's template arguments for a
// configuration that tiled() accepts, each as a std::integral_constant;
// taps is 4 for 4x4 taps and 0 for fewer.
template <typename F>
int with_tiled_args(int kh, int kw, int up, int down, F&& f) {
  using std::integral_constant;
  auto by_taps = [&](auto u, auto d) {
    return kh == 4 && kw == 4 ? f(u, d, integral_constant<int, 4>{})
                              : f(u, d, integral_constant<int, 0>{});
  };
  auto by_down = [&](auto u) {
    return down == 1 ? by_taps(u, integral_constant<int, 1>{})
                     : by_taps(u, integral_constant<int, 2>{});
  };
  return up == 1 ? by_down(integral_constant<int, 1>{}) : by_down(integral_constant<int, 2>{});
}

// f(T{}) with T the storage type of dtype code 0 (float32), 1 (float16) or
// 2 (bfloat16); cudaErrorInvalidValue for any other code.
template <typename F>
int with_dtype(int dtype, F&& f) {
  switch (dtype) {
    case 0: return f(float{});
    case 1: return f(__half{});
    case 2: return f(__nv_bfloat16{});
    default: return (int)cudaErrorInvalidValue;
  }
}

bool valid_args(int kh, int kw, long long nc, int H, int W, int OH, int OW, int up, int down) {
  return kh >= 1 && kw >= 1 && kh <= kMaxTaps && kw <= kMaxTaps && up >= 1 && down >= 1 &&
         H >= 1 && W >= 1 && OH >= 0 && OW >= 0 && nc >= 0 && nc <= 0x7fffffff;
}

}  // namespace

// x: [nc, H, W] contiguous; y: [nc, OH, OW] contiguous. taps: host array of
// kh*kw floats, flipped and scaled by gain. dtype: 0 float32, 1 float16,
// 2 bfloat16. Returns the cudaError_t of the launch; does not synchronise.
extern "C" int upfirdn2d_launch(const void* x, void* y, const float* taps, int kh, int kw,
                                long long nc, int H, int W, int OH, int OW, int up, int down,
                                int padx0, int pady0, int dtype, void* stream) {
  if (!valid_args(kh, kw, nc, H, W, OH, OW, up, down)) return (int)cudaErrorInvalidValue;
  if (nc == 0 || OH == 0 || OW == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    if (tiled(kh, kw, up, down))
      return with_tiled_args(kh, kw, up, down, [&](auto u, auto d, auto k) {
        return launch_tiled<T, decltype(u)::value, decltype(d)::value, decltype(k)::value>(
            x, y, taps, kh, kw, nc, H, W, OH, OW, padx0, pady0, s);
      });
    if (kh <= 4 && kw <= 4)
      return launch_direct<T, 4>(x, y, taps, kh, kw, nc, H, W, OH, OW, up, down, padx0, pady0,
                                 s);
    return launch_direct<T, kMaxTaps>(x, y, taps, kh, kw, nc, H, W, OH, OW, up, down, padx0,
                                      pady0, s);
  });
}

// The launch that upfirdn2d_launch makes for the same arguments, without
// making it (x is read for its alignment only). info receives 11 ints: 1
// for the tiled kernel or 0 for the direct one; the grid's x, y and z;
// threads per block; dynamic shared memory bytes; the device's SMs; blocks
// resident per SM; images per step; tile rows; tile columns. The last four
// are 0 for the direct kernel. Returns a cudaError_t.
extern "C" int upfirdn2d_plan(const void* x, int kh, int kw, long long nc, int H, int W, int OH,
                              int OW, int up, int down, int padx0, int pady0, int dtype,
                              int* info) {
  if (!valid_args(kh, kw, nc, H, W, OH, OW, up, down) || nc == 0 || OH == 0 || OW == 0)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 11; ++i) info[i] = 0;
  return with_dtype(dtype, [&](auto tag) {
    using T = decltype(tag);
    if (!tiled(kh, kw, up, down)) {
      const dim3 grid = direct_grid(nc, OH, OW);
      int device = 0;
      cudaError_t err = cudaGetDevice(&device);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&info[6], cudaDevAttrMultiProcessorCount, device);
      info[1] = grid.x, info[2] = grid.y, info[3] = grid.z, info[4] = 32 * 8;
      return (int)err;
    }
    Plan p;
    const int err = with_tiled_args(kh, kw, up, down, [&](auto u, auto d, auto k) {
      return (int)plan_tiled<T, decltype(u)::value, decltype(d)::value, decltype(k)::value>(
          &p, (uintptr_t)x % 16 == 0, kh, kw, nc, H, W, OH, OW, padx0, pady0);
    });
    if (err != cudaSuccess) return err;
    const int values[11] = {1, (int)p.grid.x, (int)p.grid.y, (int)p.grid.z, (int)p.block.x,
                            p.smem, p.sms, p.per_sm, p.g.G, p.g.TH, p.g.TW};
    for (int i = 0; i < 11; ++i) info[i] = values[i];
    return (int)cudaSuccess;
  });
}
