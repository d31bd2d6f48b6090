// K3: the fused stereo pipeline on Hopper -- banded ZNCC planes folded into
// an online disparity head.  The serving variant never writes the cost
// volume; the training variant (K3w) also streams each plane out as the
// backward's cost residual; the volume-free training variant (K3m) writes
// the training maps but no volume.
//
// Replaces: custereomatching_tpu/ops/pallas_pipeline.py:_fused_kernel, with
// write_volume=False (driven by _pipeline_forward_full; the serving path)
// and with write_volume=True (the forward of _fused_train_v); K3m is what
// _fused_train_fwd gets from _pipeline_forward_full without write_volume.
// Same values, not the same blocks: the TPU grid walks disparity tiles in
// order and carries the head in scratch; here one thread owns one pixel,
// keeps its head in registers and loops over d = 0..D in order, so no
// state crosses blocks.
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
// disparity = am * mask, soft = (t / s) * mask.  The training variant adds
// the cost planes c = bc * (1 / beta) as a [B, D+1, H, W] volume (as the
// Pallas kernel writes bc * inv_b) and the raw am, s and t maps that the
// backward (K4, fused_pipeline_bwd.cu) reads; K3m adds the three maps
// alone, for the volume-free backward (K5).  The training variants' four
// maps are the serving variant's bit for bit: the extra stores change no
// arithmetic.
//
// What bounds it on the H100: the serving variant reads two images and
// writes four maps (about 6 * 4 * H * W bytes a frame), so it has no memory
// floor worth the name; the work is (D+1) planes of the k-tap row and
// column sums plus one rsqrt and one or two exp per pixel and plane.  As
// in K1 the simple first version is bound by the shared-memory traffic of
// the row pass and by two barriers per plane; the design keeps both
// images in shared memory for all planes and the head in registers.  K3m
// adds three map stores (12 bytes a pixel).  K3w adds K1's volume write
// (360 MB a KITTI frame, about 0.11 ms at 3.35 TB/s), stored coalesced
// along W.  It is not hidden
// behind the planes' arithmetic: on the H100 K3w takes about that much
// longer than the serving variant.
#include "common.cuh"

namespace custereo {
namespace {

// Grid: (ceil(W / kTileW), ceil(H / kTileH), B); kThreads threads; dynamic
// shared memory PlaneTile(k, D).floats() floats.  am_out, s_out and t_out
// are written only when kResiduals, volume only when kVolume.
template <bool kUnnormalized, bool kResiduals, bool kVolume>
__global__ void __launch_bounds__(kThreads)
    fused_pipeline_kernel(const float* __restrict__ camera,
                          const float* __restrict__ projector,
                          const float* __restrict__ cam_s,
                          const float* __restrict__ cam_e2,
                          const float* __restrict__ proj_s,
                          const float* __restrict__ proj_e2,
                          float* __restrict__ disparity,
                          float* __restrict__ soft, float* __restrict__ mask,
                          float* __restrict__ conf, float* __restrict__ volume,
                          float* __restrict__ am_out,
                          float* __restrict__ s_out,
                          float* __restrict__ t_out, int H, int W, int D,
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
  float* vol_px = volume;
  if (valid) {
    mux = cam_s[o] * (1.f / static_cast<float>(k * k));
    ex2 = cam_e2[o];
    const size_t row = (static_cast<size_t>(b) * H + h) * (W + D) + D + w;
    sy_row = proj_s + row;
    ey2_row = proj_e2 + row;
    if (kVolume)
      vol_px = volume + static_cast<size_t>(b) * (D + 1) * plane +
               static_cast<size_t>(h) * W + w;
  }
  const float beps = beta * eps;
  const float inv_b = 1.f / beta;
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
      if (kVolume) vol_px[d * plane] = bc * inv_b;
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
  if (kResiduals) {
    am_out[o] = am;
    s_out[o] = s;
    t_out[o] = t;
  }
}

template <bool kUnnormalized, bool kResiduals, bool kVolume>
cudaError_t launch_fused(const float* camera, const float* projector,
                         const float* cam_s, const float* cam_e2,
                         const float* proj_s, const float* proj_e2,
                         float* disparity, float* soft, float* mask,
                         float* conf, float* volume, float* am, float* s,
                         float* t, int B, int H, int W, int D, int k,
                         float eps, float beta, float threshold,
                         cudaStream_t stream) {
  auto kernel = fused_pipeline_kernel<kUnnormalized, kResiduals, kVolume>;
  const size_t bytes = PlaneTile(k, D).floats() * sizeof(float);
  const cudaError_t e = allow_smem(kernel, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      camera, projector, cam_s, cam_e2, proj_s, proj_e2, disparity, soft,
      mask, conf, volume, am, s, t, H, W, D, k, eps, beta, threshold);
  return cudaGetLastError();
}

// The statistics passes, then the fused kernel in the head branch that
// `unnormalized` selects.
template <bool kResiduals, bool kVolume>
int run_pipeline(const float* camera, const float* projector, float* cam_s,
                 float* cam_e2, float* proj_s, float* proj_e2,
                 float* disparity, float* soft, float* mask, float* conf,
                 float* volume, float* am, float* s, float* t, int B, int H,
                 int W, int D, int k, float eps, float beta, float threshold,
                 int unnormalized, cudaStream_t stream) {
  cudaError_t e =
      launch_box_stats(camera, cam_s, cam_e2, B, H, W, k, 0, W, 1.f, stream);
  if (e != cudaSuccess) return e;
  e = launch_box_stats(projector, proj_s, proj_e2, B, H, W, k, D, W + D, beta,
                       stream);
  if (e != cudaSuccess) return e;
  if (unnormalized)
    return launch_fused<true, kResiduals, kVolume>(
        camera, projector, cam_s, cam_e2, proj_s, proj_e2, disparity, soft,
        mask, conf, volume, am, s, t, B, H, W, D, k, eps, beta, threshold,
        stream);
  return launch_fused<false, kResiduals, kVolume>(
      camera, projector, cam_s, cam_e2, proj_s, proj_e2, disparity, soft,
      mask, conf, volume, am, s, t, B, H, W, D, k, eps, beta, threshold,
      stream);
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
  return run_pipeline<false, false>(
      camera, projector, cam_s, cam_e2, proj_s, proj_e2, disparity, soft,
      mask, conf, nullptr, nullptr, nullptr, nullptr, B, H, W, D, k, eps,
      beta, threshold, unnormalized, static_cast<cudaStream_t>(stream_ptr));
}

// The training forward (K3w): as custereo_fused_pipeline, plus the cost
// volume [B, D + 1, H, W] and the raw argmax, s and t maps [B, H, W].
extern "C" int custereo_fused_pipeline_train(
    const float* camera, const float* projector, float* cam_s, float* cam_e2,
    float* proj_s, float* proj_e2, float* disparity, float* soft, float* mask,
    float* conf, float* volume, float* am, float* s, float* t, int B, int H,
    int W, int D, int k, float eps, float beta, float threshold,
    int unnormalized, void* stream_ptr) {
  return run_pipeline<true, true>(
      camera, projector, cam_s, cam_e2, proj_s, proj_e2, disparity, soft,
      mask, conf, volume, am, s, t, B, H, W, D, k, eps, beta, threshold,
      unnormalized, static_cast<cudaStream_t>(stream_ptr));
}

// The volume-free training forward (K3m): as custereo_fused_pipeline, plus
// the raw argmax, s and t maps [B, H, W]; no volume.
extern "C" int custereo_fused_pipeline_train_maps(
    const float* camera, const float* projector, float* cam_s, float* cam_e2,
    float* proj_s, float* proj_e2, float* disparity, float* soft, float* mask,
    float* conf, float* am, float* s, float* t, int B, int H, int W, int D,
    int k, float eps, float beta, float threshold, int unnormalized,
    void* stream_ptr) {
  return run_pipeline<true, false>(
      camera, projector, cam_s, cam_e2, proj_s, proj_e2, disparity, soft,
      mask, conf, nullptr, am, s, t, B, H, W, D, k, eps, beta, threshold,
      unnormalized, static_cast<cudaStream_t>(stream_ptr));
}
