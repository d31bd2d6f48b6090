// K1: the banded ZNCC cost volume on Hopper.
//
// Replaces: custereomatching_tpu/ops/pallas_zncc.py:_banded_kernel (driven
// by pallas_cost_volume_banded_hdw).  Same values, not the same blocks:
// the TPU kernel's padded [ndt, h_pad, wo] extents, lane rolls and DMA
// rings are TPU choices and are not carried over.
//
// What it computes, per frame b, row h, column w and disparity d in [0, D]:
//   exy  = box(cam * proj(. - d))[h, w] - mux[h, w] * sy[h, w - d]
//   cost = (exy + eps) * rsqrt(ex2[h, w] * ey2[h, w - d] + eps)
// with box the zero-padded k x k window sum, mux = box(cam) / k^2,
// ex2/ey2 the centered second moments and sy = box(proj); the projector
// statistics are taken over the image widened left by D zero columns.
//
// Layout: the volume is written plane-major, out[b][d][h][w], so that the
// 32 threads of a warp store 32 neighbouring w of one plane (coalesced).
// The wrapper returns it as a [B, H, W, D+1] permuted view.  Bytes: the
// volume is 4 * B * (D+1) * H * W (KITTI 375 x 1242, D = 192: 360 MB a
// frame); the images and statistics add 4 * B * H * (6W + 2D).
//
// What bounds it on the H100: the volume write is the floor (360 MB at
// 3.35 TB/s is about 0.11 ms a KITTI frame).  This first kernel is
// simple, not tuned: it is bound by shared-memory traffic, since each
// plane recomputes its k-row products (2k shared loads for each of the
// kTileH x (kTileW + 2p) row-pass entries) and pays two barriers.  What
// the design does about it: one pass over the image per block (both
// tiles staged once in shared memory and reused by all D+1 planes), the
// window sum separable (rows, then columns: 2k operations, not k^2), the
// statistics computed once per image by a small pass and read through the
// read-only cache, and stores coalesced along W.
#include "common.cuh"

namespace custereo {
namespace {

// Grid: (ceil(W / kTileW), ceil(H / kTileH), B); kThreads threads; dynamic
// shared memory PlaneTile(k, D).floats() floats.
__global__ void __launch_bounds__(kThreads)
    banded_volume_kernel(const float* __restrict__ camera,
                         const float* __restrict__ projector,
                         const float* __restrict__ cam_s,
                         const float* __restrict__ cam_e2,
                         const float* __restrict__ proj_s,
                         const float* __restrict__ proj_e2,
                         float* __restrict__ out, int H, int W, int D, int k,
                         float eps) {
  extern __shared__ float smem[];
  const PlaneTile g(k, D);
  float* cam_t = smem;
  float* proj_t = cam_t + g.rows * g.cam_w;
  float* vsum = proj_t + g.rows * g.proj_w;

  const int b = blockIdx.z, h0 = blockIdx.y * kTileH, w0 = blockIdx.x * kTileW;
  const size_t plane = static_cast<size_t>(H) * W;
  stage_tile(cam_t, camera + b * plane, H, W, h0 - g.p, w0 - g.p, g.rows,
             g.cam_w, 1.f);
  stage_tile(proj_t, projector + b * plane, H, W, h0 - g.p, w0 - g.p - D,
             g.rows, g.proj_w, 1.f);

  const int r = threadIdx.x / kTileW, c = threadIdx.x % kTileW;
  const int h = h0 + r, w = w0 + c;
  const bool valid = h < H && w < W;
  float mux = 0.f, ex2 = 0.f;
  // Projector statistics row; image column x sits at index x + D.
  const float* sy_row = proj_s;
  const float* ey2_row = proj_e2;
  float* out_px = out;
  if (valid) {
    const size_t o = b * plane + static_cast<size_t>(h) * W + w;
    mux = cam_s[o] * (1.f / static_cast<float>(k * k));
    ex2 = cam_e2[o];
    const size_t row = (static_cast<size_t>(b) * H + h) * (W + D) + D + w;
    sy_row = proj_s + row;
    ey2_row = proj_e2 + row;
    out_px = out + static_cast<size_t>(b) * (D + 1) * plane +
             static_cast<size_t>(h) * W + w;
  }
  __syncthreads();

  for (int d = 0; d <= D; ++d) {
    vertical_products(vsum, cam_t, proj_t, g, k, D - d);
    __syncthreads();
    if (valid) {
      const float sxy = horizontal_sum(vsum, g.cam_w, r, c, k);
      const float exy = sxy - mux * __ldg(sy_row - d);
      out_px[d * plane] = (exy + eps) * rsqrtf(ex2 * __ldg(ey2_row - d) + eps);
    }
    __syncthreads();
  }
}

}  // namespace
}  // namespace custereo

using namespace custereo;

// Plain C interface, loaded with ctypes.  camera/projector: [B, H, W];
// scratch cam_s/cam_e2: [B, H, W], proj_s/proj_e2: [B, H, W + D];
// out: [B, D + 1, H, W]; all fp32, contiguous, on the current device.
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 when every launch was accepted).
extern "C" int custereo_banded_volume(const float* camera,
                                      const float* projector, float* cam_s,
                                      float* cam_e2, float* proj_s,
                                      float* proj_e2, float* out, int B,
                                      int H, int W, int D, int k, float eps,
                                      void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t e =
      launch_box_stats(camera, cam_s, cam_e2, B, H, W, k, 0, W, 1.f, stream);
  if (e != cudaSuccess) return e;
  e = launch_box_stats(projector, proj_s, proj_e2, B, H, W, k, D, W + D, 1.f,
                       stream);
  if (e != cudaSuccess) return e;

  const size_t bytes = PlaneTile(k, D).floats() * sizeof(float);
  e = allow_smem(banded_volume_kernel, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  banded_volume_kernel<<<grid, kThreads, bytes, stream>>>(
      camera, projector, cam_s, cam_e2, proj_s, proj_e2, out, H, W, D, k, eps);
  return cudaGetLastError();
}

extern "C" const char* custereo_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
