// K2 and K6: the camera VJP of the banded ZNCC volume on Hopper, with the
// forward cost volume as a residual (K2) or without it (K6).
//
// Replaces: custereomatching_tpu/ops/pallas_zncc_bwd.py:_bwd_kernel in its
// with-cost mode (K2: have_c=True, direct_g=True; driven by
// pallas_camera_grad_banded_hdw_with_cost) and in its two no-cost modes
// (K6: pallas_camera_grad_banded_hdw, direct_g=True, and
// pallas_camera_grad_banded, direct_g=False, whose restaged [H, W, D+1]
// cotangent the port stages plane-major with K9b).  The cotangent g (and
// for K2 the cost c) arrive plane-major, [B, D+1, H, W], the layout K1
// writes; the body (the accumulation of A1, B and GRMU and the combine) is
// camera_grad.cuh, shared with K4 and K5.  K6 recomputes each cost plane
// over K1's 16 x 64 tile for the B term; its planes kernel stages K1's two
// image tiles beside K2's, 17,616 floats = 70,464 bytes of shared memory
// at k = 15, D = 192 (past the card's limit the projector tile is staged
// in chunks of planes, camera_grad.cuh).
//
// What bounds it on the H100: K2 reads two volumes, g and c (720 MB a
// KITTI frame, about 0.21 ms at 3.35 TB/s); K6 one, g (0.11 ms), and
// instead does K1's per-plane cross-term work, about 4k + 17 flops a pixel
// and plane with the k x k window sums taken separably (0.10 ms a KITTI
// frame at 67 TFLOP/s), so its read still bounds it.  Both take far
// longer, as K1 does, for the per-plane row and column passes in shared
// memory (see camera_grad.cuh).
#include "camera_grad.cuh"

namespace custereo {
namespace {

// g_d read from the plane-major cotangent volume.
struct CotangentSource {
  static constexpr int kMaps = 0;
  static constexpr bool kNeedsCost = false;
  const float* g;

  __device__ void stage(float*, int, int, size_t, bool) const {}
  __device__ float value(const float*, int, int, size_t vidx, float,
                         float) const {
    return __ldg(g + vidx);
  }
};

}  // namespace
}  // namespace custereo

using namespace custereo;

// Plain C interface, loaded with ctypes.  camera/projector: [B, H, W];
// cost and cotangent: [B, D + 1, H, W]; scratch cam_s/cam_e2: [B, H, W],
// proj_s/proj_e2: [B, H, W + D], a1/bm/grmu: [B, H, W]; grad: [B, H, W];
// all fp32, contiguous, on the current device.  Launches on `stream`, does
// not synchronise, and returns cudaGetLastError() (0 when every launch was
// accepted).
extern "C" int custereo_camera_grad(const float* camera,
                                    const float* projector, float* cam_s,
                                    float* cam_e2, float* proj_s,
                                    float* proj_e2, const float* cost,
                                    const float* cotangent, float* a1,
                                    float* bm, float* grmu, float* grad,
                                    int B, int H, int W, int D, int k,
                                    float eps, void* stream_ptr) {
  return launch_camera_grad<false>(CotangentSource{cotangent}, camera,
                                   projector, cam_s, cam_e2, proj_s, proj_e2,
                                   cost, a1, bm, grmu, grad, B, H, W, D, k,
                                   eps, static_cast<cudaStream_t>(stream_ptr));
}

// K6: as custereo_camera_grad without the cost volume; each cost plane is
// recomputed from camera and projector.
extern "C" int custereo_camera_grad_recompute(
    const float* camera, const float* projector, float* cam_s, float* cam_e2,
    float* proj_s, float* proj_e2, const float* cotangent, float* a1,
    float* bm, float* grmu, float* grad, int B, int H, int W, int D, int k,
    float eps, void* stream_ptr) {
  return launch_camera_grad<true>(CotangentSource{cotangent}, camera,
                                  projector, cam_s, cam_e2, proj_s, proj_e2,
                                  nullptr, a1, bm, grmu, grad, B, H, W, D, k,
                                  eps, static_cast<cudaStream_t>(stream_ptr));
}
