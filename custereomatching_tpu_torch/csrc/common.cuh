// Shared pieces of the port's hand-written Hopper kernels (sm_90a):
// the block tile, the zero-padded staging of a halo'd image tile, the
// separable k x k window sums, and the window-statistics pass that both
// plane kernels (zncc_banded.cu, fused_pipeline.cu) run first.
//
// Numerical contract (as custereomatching_tpu/ops/zncc.py): windows read
// zeros outside the image, means divide by k^2 including the padding, and
// cost = (exy + eps) / sqrt(ex2 * ey2 + eps), all in fp32.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace custereo {

// One block owns a kTileH x kTileW tile of output pixels, one thread per
// pixel; a thread keeps its pixel's per-frame state in registers.
constexpr int kTileH = 16;
constexpr int kTileW = 64;
constexpr int kThreads = kTileH * kTileW;
constexpr size_t kDefaultSmem = 48 * 1024;

// Shared-memory geometry of a plane kernel, in floats:
//   camera tile     rows x cam_w   image rows [h0-p, h0+kTileH+p), cols [w0-p, w0+kTileW+p)
//   projector tile  rows x proj_w  the same rows, cols [w0-p-D, w0+kTileW+p)
//   vertical sums   kTileH x cam_w one disparity plane at a time
struct PlaneTile {
  int p, rows, cam_w, proj_w;
  __host__ __device__ PlaneTile(int k, int D)
      : p(k / 2),
        rows(kTileH + 2 * (k / 2)),
        cam_w(kTileW + 2 * (k / 2)),
        proj_w(kTileW + 2 * (k / 2) + D) {}
  __host__ __device__ size_t floats() const {
    return static_cast<size_t>(rows) * cam_w +
           static_cast<size_t>(rows) * proj_w +
           static_cast<size_t>(kTileH) * cam_w;
  }
};

// dst[r][c] = scale * src[row0 + r][col0 + c] for r < rows, c < width, and
// zero where that pixel lies outside the H x W image.
__device__ inline void stage_tile(float* dst, const float* __restrict__ src,
                                  int H, int W, int row0, int col0, int rows,
                                  int width, float scale) {
  for (int i = threadIdx.x; i < rows * width; i += blockDim.x) {
    const int r = i / width, c = i - r * width;
    const int h = row0 + r, x = col0 + c;
    dst[i] = (h >= 0 && h < H && x >= 0 && x < W)
                 ? scale * __ldg(src + static_cast<size_t>(h) * W + x)
                 : 0.f;
  }
}

// Rows pass of one disparity plane's cross term:
//   vsum[r][c] = sum_{t<k} cam_t[r+t][c] * proj_t[r+t][c + shift]
// for r < kTileH, c < cam_w.  Camera tile column c pairs with projector
// tile column c + D - d for disparity d, so shift = D - d.
__device__ inline void vertical_products(float* vsum, const float* cam_t,
                                         const float* proj_t,
                                         const PlaneTile& g, int k,
                                         int shift) {
  for (int i = threadIdx.x; i < kTileH * g.cam_w; i += blockDim.x) {
    const int r = i / g.cam_w, c = i - r * g.cam_w;
    const float* a = cam_t + r * g.cam_w + c;
    const float* b = proj_t + r * g.proj_w + c + shift;
    float acc = 0.f;
    for (int t = 0; t < k; ++t) acc = fmaf(a[t * g.cam_w], b[t * g.proj_w], acc);
    vsum[i] = acc;
  }
}

// Columns pass: the k x k window sum of output pixel (r, c) of the tile.
__device__ inline float horizontal_sum(const float* vsum, int cam_w, int r,
                                       int c, int k) {
  const float* v = vsum + r * cam_w + c;
  float acc = 0.f;
  for (int t = 0; t < k; ++t) acc += v[t];
  return acc;
}

// Internal linkage: each translation unit that includes this header gets
// its own copy of the statistics kernel and its launcher.
namespace {

// Window statistics of one image per frame, for output columns j in
// [0, wout) that sit at image column j - col_off.  col_off = D widens the
// projector's statistics to the columns x - d < 0 that its band reads;
// windows there still reach real pixels, so they are not zero.
//   s  = box(scale * img)
//   e2 = (box((scale * img)^2) - s^2 / k^2) / scale^2
// Grid: (ceil(wout / kTileW), ceil(H / kTileH), B), kThreads threads.
__global__ void __launch_bounds__(kThreads)
    box_stats_kernel(const float* __restrict__ img, float* __restrict__ s_out,
                     float* __restrict__ e2_out, int H, int W, int k,
                     int col_off, int wout, float scale, float inv_scale2) {
  extern __shared__ float smem[];
  const int p = k / 2, rows = kTileH + 2 * p, cols = kTileW + 2 * p;
  float* tile = smem;
  float* v1 = tile + rows * cols;
  float* v2 = v1 + kTileH * cols;
  const int b = blockIdx.z, h0 = blockIdx.y * kTileH, j0 = blockIdx.x * kTileW;

  stage_tile(tile, img + static_cast<size_t>(b) * H * W, H, W, h0 - p,
             j0 - col_off - p, rows, cols, scale);
  __syncthreads();
  for (int i = threadIdx.x; i < kTileH * cols; i += blockDim.x) {
    const int r = i / cols, c = i - r * cols;
    float a = 0.f, a2 = 0.f;
    for (int t = 0; t < k; ++t) {
      const float v = tile[(r + t) * cols + c];
      a += v;
      a2 = fmaf(v, v, a2);
    }
    v1[i] = a;
    v2[i] = a2;
  }
  __syncthreads();

  const int r = threadIdx.x / kTileW, c = threadIdx.x % kTileW;
  const int h = h0 + r, j = j0 + c;
  if (h >= H || j >= wout) return;
  const float a = horizontal_sum(v1, cols, r, c, k);
  const float a2 = horizontal_sum(v2, cols, r, c, k);
  const float inv_k2 = 1.f / static_cast<float>(k * k);
  const size_t o = (static_cast<size_t>(b) * H + h) * wout + j;
  s_out[o] = a;
  e2_out[o] = (a2 - a * a * inv_k2) * inv_scale2;
}

// Opts a kernel into more than 48 KB of dynamic shared memory.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

inline cudaError_t launch_box_stats(const float* img, float* s, float* e2,
                                    int B, int H, int W, int k, int col_off,
                                    int wout, float scale,
                                    cudaStream_t stream) {
  const int p = k / 2;
  const size_t cols = kTileW + 2 * p;
  const size_t bytes =
      sizeof(float) * ((kTileH + 2 * p) * cols + 2 * kTileH * cols);
  const cudaError_t e = allow_smem(box_stats_kernel, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((wout + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  box_stats_kernel<<<grid, kThreads, bytes, stream>>>(
      img, s, e2, H, W, k, col_off, wout, scale, 1.f / (scale * scale));
  return cudaGetLastError();
}

}  // namespace
}  // namespace custereo
