// K2: the camera VJP of the banded ZNCC volume on Hopper, with the forward
// cost volume as a residual.
//
// Replaces: custereomatching_tpu/ops/pallas_zncc_bwd.py:_bwd_kernel in its
// with-cost mode (have_c=True, direct_g=True; driven by
// pallas_camera_grad_banded_hdw_with_cost).  The cotangent g and the cost c
// arrive plane-major, [B, D+1, H, W], the layout K1 writes; the body (the
// accumulation of A1, B and GRMU and the combine) is camera_grad.cuh,
// shared with K4.  The no-cost modes of the same Pallas function, which
// recompute the cost from the images (K6), are not ported here.
//
// What bounds it on the H100: it reads two volumes, g and c (720 MB a
// KITTI frame, about 0.21 ms at 3.35 TB/s), and is otherwise bound, as K1,
// by the per-plane row and column passes in shared memory (see
// camera_grad.cuh).
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
  return launch_camera_grad(CotangentSource{cotangent}, camera, projector,
                            cam_s, cam_e2, proj_s, proj_e2, cost, a1, bm,
                            grmu, grad, B, H, W, D, k, eps,
                            static_cast<cudaStream_t>(stream_ptr));
}
