// K4 and K5: the backward of the trainable fused pipeline on Hopper, with
// the forward cost volume (written by K3w) as a residual (K4) or without
// it (K5, after the volume-free forward K3m).
//
// Replaces: custereomatching_tpu/ops/pallas_pipeline.py:_fused_bwd_c_kernel
// (K4, driven by _fused_train_bwd_c_impl) and _fused_bwd_kernel (K5,
// driven by _fused_train_bwd_impl).  The cost-volume cotangent is never
// materialised: each plane's g_d is formed from per-pixel maps of the head,
//   g_d = gs_hat mask beta w_d (d - t/s) + gc_hat 1[d = am]
//   w_d = e^{beta c_d} / s            (unnormalized head)
//       = e^{beta (c_d - conf)} / s   (rescaled head, s relative to e^m)
// where gs_hat and gc_hat are the cotangents of the soft disparity and the
// confidence map.  The gradient of the confidence goes to the first argmax
// only, as the Pallas kernel's 1[d = am] does.  The rest is the body K2
// runs (camera_grad.cuh).  1/s, t/s, gs_hat mask beta, gc_hat, am and conf
// are staged once a tile in shared memory, zero outside the image, as
// _fused_bwd_c_kernel derives them once per row tile.
//
// K5 recomputes the cost at every pixel of the halo'd 30 x 78 tile (k =
// 15), since g_d needs it there: camera_grad.cuh's recompute over the
// halo'd tile.  Its planes kernel holds, at k = 15, D = 192, the camera
// tile 44 x 92, the D-widened projector tile 44 x 284, the rows pass
// 30 x 92, GradTile's ex2, gr and vsum, the six head maps and the camera's
// window means (30 x 78 each): 41,612 floats = 166,448 bytes of dynamic
// shared memory, so one 1024-thread block an SM.  The projector tile grows
// by 44 floats a plane; past the card's 227 KB a block (D > 567 at k = 15,
// D > 252 at k = 21) it is staged in chunks of planes that fit, so any D
// runs.  At one plane a chunk the block needs 56,108 floats at k = 27 and
// 60,464 at k = 29: k <= 27 runs (the wrapper checks it), larger k does
// not.
//
// What bounds it on the H100: K4 reads one volume, the cost (360 MB a
// KITTI frame, about 0.11 ms at 3.35 TB/s); per plane and halo pixel it
// adds one exp to K2's work.  K5 reads no volume; it does K1's per-plane
// cross-term work over 2.2 times K1's region.  The least work of its
// function, one cost, head cotangent and VJP body an entry (about
// 4k + 25 flops with the k x k window sums taken separably), puts its
// floor at 0.11 ms a KITTI frame at 67 TFLOP/s.  Otherwise as K2
// (camera_grad.cuh).
#include "camera_grad.cuh"

namespace custereo {
namespace {

// g_d formed from the head's maps [B, H, W] and the cost.
template <bool kUnnormalized>
struct HeadSource {
  // Staged tiles: gs_hat mask beta, t/s, 1/s, am, gc_hat, conf.
  static constexpr int kMaps = 6;
  static constexpr bool kNeedsCost = true;
  const float *am, *mask, *conf, *s, *t, *gsoft, *gconf;
  float beta;

  __device__ void stage(float* maps, int halo, int i, size_t pix,
                        bool inside) const {
    float gs = 0.f, tos = 0.f, inv_s = 0.f, a = 0.f, gc = 0.f, m = 0.f;
    if (inside) {
      inv_s = 1.f / __ldg(s + pix);
      tos = __ldg(t + pix) * inv_s;
      gs = __ldg(gsoft + pix) * __ldg(mask + pix) * beta;
      a = __ldg(am + pix);
      gc = __ldg(gconf + pix);
      m = __ldg(conf + pix);
    }
    maps[i] = gs;
    maps[halo + i] = tos;
    maps[2 * halo + i] = inv_s;
    maps[3 * halo + i] = a;
    maps[4 * halo + i] = gc;
    maps[5 * halo + i] = m;
  }

  __device__ float value(const float* maps, int halo, int i, size_t,
                         float c, float df) const {
    const float arg =
        kUnnormalized ? beta * c : beta * (c - maps[5 * halo + i]);
    const float w = expf(arg) * maps[2 * halo + i];
    const float hit = maps[3 * halo + i] == df ? 1.f : 0.f;
    return maps[i] * w * (df - maps[halo + i]) + maps[4 * halo + i] * hit;
  }
};

template <bool kUnnormalized, bool kRecompute>
int run(const float* camera, const float* projector, float* cam_s,
        float* cam_e2, float* proj_s, float* proj_e2, const float* cost,
        const float* am, const float* mask, const float* conf, const float* s,
        const float* t, const float* gsoft, const float* gconf, float* a1,
        float* bm, float* grmu, float* grad, int B, int H, int W, int D,
        int k, float eps, float beta, cudaStream_t stream) {
  const HeadSource<kUnnormalized> src{am, mask, conf, s, t, gsoft, gconf,
                                      beta};
  return launch_camera_grad<kRecompute>(src, camera, projector, cam_s,
                                        cam_e2, proj_s, proj_e2, cost, a1,
                                        bm, grmu, grad, B, H, W, D, k, eps,
                                        stream);
}

// The head branch `unnormalized` selects.
template <bool kRecompute>
int run_branch(const float* camera, const float* projector, float* cam_s,
               float* cam_e2, float* proj_s, float* proj_e2,
               const float* cost, const float* am, const float* mask,
               const float* conf, const float* s, const float* t,
               const float* gsoft, const float* gconf, float* a1, float* bm,
               float* grmu, float* grad, int B, int H, int W, int D, int k,
               float eps, float beta, int unnormalized,
               cudaStream_t stream) {
  if (unnormalized)
    return run<true, kRecompute>(camera, projector, cam_s, cam_e2, proj_s,
                                 proj_e2, cost, am, mask, conf, s, t, gsoft,
                                 gconf, a1, bm, grmu, grad, B, H, W, D, k,
                                 eps, beta, stream);
  return run<false, kRecompute>(camera, projector, cam_s, cam_e2, proj_s,
                                proj_e2, cost, am, mask, conf, s, t, gsoft,
                                gconf, a1, bm, grmu, grad, B, H, W, D, k, eps,
                                beta, stream);
}

}  // namespace
}  // namespace custereo

using namespace custereo;

// Plain C interface, loaded with ctypes.  camera/projector: [B, H, W];
// cost: [B, D + 1, H, W]; the forward's maps am, mask, conf, s, t and the
// cotangents gsoft, gconf: [B, H, W]; scratch cam_s/cam_e2: [B, H, W],
// proj_s/proj_e2: [B, H, W + D], a1/bm/grmu: [B, H, W]; grad: [B, H, W];
// all fp32, contiguous, on the current device.  `unnormalized` must be the
// head branch the forward ran.  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 when every launch was
// accepted).
extern "C" int custereo_fused_pipeline_bwd(
    const float* camera, const float* projector, float* cam_s, float* cam_e2,
    float* proj_s, float* proj_e2, const float* cost, const float* am,
    const float* mask, const float* conf, const float* s, const float* t,
    const float* gsoft, const float* gconf, float* a1, float* bm, float* grmu,
    float* grad, int B, int H, int W, int D, int k, float eps, float beta,
    int unnormalized, void* stream_ptr) {
  return run_branch<false>(camera, projector, cam_s, cam_e2, proj_s, proj_e2,
                           cost, am, mask, conf, s, t, gsoft, gconf, a1, bm,
                           grmu, grad, B, H, W, D, k, eps, beta, unnormalized,
                           static_cast<cudaStream_t>(stream_ptr));
}

// K5: as custereo_fused_pipeline_bwd without the cost volume; the cost is
// recomputed from camera and projector at every pixel of the halo'd tile.
extern "C" int custereo_fused_pipeline_bwd_recompute(
    const float* camera, const float* projector, float* cam_s, float* cam_e2,
    float* proj_s, float* proj_e2, const float* am, const float* mask,
    const float* conf, const float* s, const float* t, const float* gsoft,
    const float* gconf, float* a1, float* bm, float* grmu, float* grad, int B,
    int H, int W, int D, int k, float eps, float beta, int unnormalized,
    void* stream_ptr) {
  return run_branch<true>(camera, projector, cam_s, cam_e2, proj_s, proj_e2,
                          nullptr, am, mask, conf, s, t, gsoft, gconf, a1, bm,
                          grmu, grad, B, H, W, D, k, eps, beta, unnormalized,
                          static_cast<cudaStream_t>(stream_ptr));
}
