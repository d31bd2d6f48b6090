// K3: the fused stereo pipeline on Hopper -- banded ZNCC planes folded into
// an online disparity head, so that the cost volume is never written.
//
// Replaces: custereomatching_tpu/ops/pallas_pipeline.py:_fused_kernel with
// write_volume=False (driven by _pipeline_forward_full).  Same values, not
// the same blocks: the TPU grid walks disparity tiles in order and carries
// the head in scratch; here one thread owns one pixel, keeps its head in
// registers and loops over d = 0..D in order, so no state crosses blocks.
//
// Per plane, with the projector pre-scaled by beta when it is staged (as
// the JAX wrapper _pipeline_forward_full folds beta into the projector):
//   bc = (box(cam * beta proj(. - d)) - mux * sy_b + beta eps)
//        * rsqrt(ex2 * ey2 + eps)                       (= beta * cost)
// where sy_b = box(beta proj) and ey2 is unscaled by 1 / beta^2 in the
// statistics pass.  The head keeps the running max m, its first argmax am
// (strict >, so the first maximum wins as torch.argmax does) and the
// softmax sums s = sum e^bc, t = sum d e^bc:
//   * unnormalized (beta + ln(D (D+1)) <= 85): raw e^bc, which cannot
//     overflow fp32 while |cost| <= 1 + eps;
//   * rescaled otherwise: s, t kept relative to e^m and rescaled when m
//     grows.
// Outputs [B, H, W] maps: conf = m / beta, mask = conf > threshold,
// disparity = am * mask, soft = (t / s) * mask.
//
// What bounds it on the H100: it reads two images and writes four maps
// (about 6 * 4 * H * W bytes a frame), so unlike K1 it has no memory
// floor worth the name; the work is (D+1) planes of the k-tap row and
// column sums plus one rsqrt and one or two exp per pixel and plane.  As
// in K1 the simple first version is bound by the shared-memory traffic of
// the row pass and by two barriers per plane; the design keeps both
// images in shared memory for all planes, the head in registers, and
// writes nothing per plane.
#include "common.cuh"

namespace custereo {
namespace {

// Grid: (ceil(W / kTileW), ceil(H / kTileH), B); kThreads threads; dynamic
// shared memory PlaneTile(k, D).floats() floats.
template <bool kUnnormalized>
__global__ void __launch_bounds__(kThreads)
    fused_pipeline_kernel(const float* __restrict__ camera,
                          const float* __restrict__ projector,
                          const float* __restrict__ cam_s,
                          const float* __restrict__ cam_e2,
                          const float* __restrict__ proj_s,
                          const float* __restrict__ proj_e2,
                          float* __restrict__ disparity,
                          float* __restrict__ soft, float* __restrict__ mask,
                          float* __restrict__ conf, int H, int W, int D,
                          int k, float eps, float beta, float threshold) {
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
             g.rows, g.proj_w, beta);

  const int r = threadIdx.x / kTileW, c = threadIdx.x % kTileW;
  const int h = h0 + r, w = w0 + c;
  const bool valid = h < H && w < W;
  const size_t o = b * plane + static_cast<size_t>(h) * W + w;
  float mux = 0.f, ex2 = 0.f;
  // Projector statistics row; image column x sits at index x + D.
  const float* sy_row = proj_s;
  const float* ey2_row = proj_e2;
  if (valid) {
    mux = cam_s[o] * (1.f / static_cast<float>(k * k));
    ex2 = cam_e2[o];
    const size_t row = (static_cast<size_t>(b) * H + h) * (W + D) + D + w;
    sy_row = proj_s + row;
    ey2_row = proj_e2 + row;
  }
  const float beps = beta * eps;
  float m = -3.0e38f, am = 0.f, s = 0.f, t = 0.f;
  __syncthreads();

  for (int d = 0; d <= D; ++d) {
    vertical_products(vsum, cam_t, proj_t, g, k, D - d);
    __syncthreads();
    if (valid) {
      const float sxy_b = horizontal_sum(vsum, g.cam_w, r, c, k);
      const float exy_b = sxy_b - mux * __ldg(sy_row - d);
      const float bc =
          (exy_b + beps) * rsqrtf(ex2 * __ldg(ey2_row - d) + eps);
      const float df = static_cast<float>(d);
      if (kUnnormalized) {
        const float u = expf(bc);
        s += u;
        t = fmaf(df, u, t);
        if (bc > m) {
          m = bc;
          am = df;
        }
      } else if (bc > m) {
        const float scale = expf(m - bc);
        s = fmaf(s, scale, 1.f);
        t = fmaf(t, scale, df);
        m = bc;
        am = df;
      } else {
        const float e = expf(bc - m);
        s += e;
        t = fmaf(df, e, t);
      }
    }
    __syncthreads();
  }

  if (!valid) return;
  const float cf = m * (1.f / beta);
  const float mk = cf > threshold ? 1.f : 0.f;
  conf[o] = cf;
  mask[o] = mk;
  disparity[o] = am * mk;
  soft[o] = (t / s) * mk;
}

template <bool kUnnormalized>
cudaError_t launch_fused(const float* camera, const float* projector,
                         const float* cam_s, const float* cam_e2,
                         const float* proj_s, const float* proj_e2,
                         float* disparity, float* soft, float* mask,
                         float* conf, int B, int H, int W, int D, int k,
                         float eps, float beta, float threshold,
                         cudaStream_t stream) {
  const size_t bytes = PlaneTile(k, D).floats() * sizeof(float);
  const cudaError_t e = allow_smem(fused_pipeline_kernel<kUnnormalized>, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  fused_pipeline_kernel<kUnnormalized><<<grid, kThreads, bytes, stream>>>(
      camera, projector, cam_s, cam_e2, proj_s, proj_e2, disparity, soft,
      mask, conf, H, W, D, k, eps, beta, threshold);
  return cudaGetLastError();
}

}  // namespace
}  // namespace custereo

using namespace custereo;

// Plain C interface, loaded with ctypes.  camera/projector: [B, H, W];
// scratch cam_s/cam_e2: [B, H, W], proj_s/proj_e2: [B, H, W + D]; the four
// output maps: [B, H, W]; all fp32, contiguous, on the current device.
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 when every launch was accepted).
extern "C" int custereo_fused_pipeline(
    const float* camera, const float* projector, float* cam_s, float* cam_e2,
    float* proj_s, float* proj_e2, float* disparity, float* soft, float* mask,
    float* conf, int B, int H, int W, int D, int k, float eps, float beta,
    float threshold, int unnormalized, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t e =
      launch_box_stats(camera, cam_s, cam_e2, B, H, W, k, 0, W, 1.f, stream);
  if (e != cudaSuccess) return e;
  e = launch_box_stats(projector, proj_s, proj_e2, B, H, W, k, D, W + D, beta,
                       stream);
  if (e != cudaSuccess) return e;
  if (unnormalized)
    return launch_fused<true>(camera, projector, cam_s, cam_e2, proj_s,
                              proj_e2, disparity, soft, mask, conf, B, H, W,
                              D, k, eps, beta, threshold, stream);
  return launch_fused<false>(camera, projector, cam_s, cam_e2, proj_s,
                             proj_e2, disparity, soft, mask, conf, B, H, W, D,
                             k, eps, beta, threshold, stream);
}
