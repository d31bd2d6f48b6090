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
// writes.  Both run camera_grad.cuh's rounds kernel, which K4 shares: a
// round of P planes forms gr_d = g_d r_d over the halo'd 16 x 64 tile,
// box-sums it on the register-blocked pass and adds A1; the tile's own
// pixels add B from the cost, which K2 reads there from its volume (the
// P planes' loads issued with the cotangent's) and K6 recomputes (K3's
// cross-term round).  At k = 15, D = 192 both take P = 8: K2 holds ex2 (30
// x 78) and 8 planes of the two buffers (30 x 79 + 16 x 79), 31,412
// floats = 125,648 bytes; K6 also the camera tile and the projector tile
// 30 x (78 + 192), 41,852 floats = 167,408 bytes, and past the card's
// limit stages the projector in chunks of planes, so any D runs.  K2
// takes every odd k <= 127 at every D (P = 1 at k = 127: 57,158 floats;
// its combine box-filters the three maps one at a time from k = 95).  K6's
// block fits up to k = 81 (59,682 floats at k = 83); beyond, it takes
// camera_grad.cuh's chunked route: K1's costs of kCostChunk planes at a
// time in a slab, K2's rounds kernel reading them beside the cotangent,
// so its gradient is K2's on K1's volume, as the recompute's is.  Both
// take every odd k <= 127 at every D.
//
// What bounds it on the H100: K2 reads two volumes, g and c (720 MB a
// KITTI frame, about 0.21 ms at 3.35 TB/s); K6 one, g (0.11 ms), and
// instead does K1's per-plane cross-term work, about 4k + 17 flops a pixel
// and plane with the k x k window sums taken separably (0.10 ms a KITTI
// frame at 67 TFLOP/s), so its read still bounds it.
#include "camera_grad.cuh"

namespace custereo {
namespace {

// g_d read from the plane-major cotangent volume (camera_grad.cuh's
// Source), with the cost read at the tile's own pixels from a second
// volume (K2, kCost) or recomputed there (K6, `cost` null).
template <bool kCost>
struct CotangentSource {
  static constexpr bool kStaged = true;
  static constexpr int kMaps = 0;
  static constexpr bool kReadsCost = false;
  static constexpr bool kCentreCost = kCost;
  const float* vol;
  const float* cost;

  struct Entry {};
  __device__ void stage(float*, int, int, size_t, bool) const {}
  __device__ Entry entry(const float*, int, int, size_t) const {
    return {};
  }
  __device__ float cotangent(const Entry&, float v, float) const {
    return v;
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
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  return launch_grad_kernels(
      [&](size_t budget) {
        return launch_all_planes<CotangentSource<true>, false>(
            CotangentSource<true>{cotangent, cost}, camera, projector, cam_s,
            cam_e2, proj_s, proj_e2, a1, bm, grmu, B, H, W, D, k, eps,
            budget, stream);
      },
      camera, projector, cam_s, cam_e2, proj_s, proj_e2, a1, bm, grmu, grad,
      B, H, W, D, k, stream);
}

// K6: as custereo_camera_grad without the cost volume; each cost plane is
// recomputed from camera and projector, or, where that block does not
// fit, written a slab of kCostChunk planes at a time into `slab` ([B,
// min(kCostChunk, D + 1), H, W]; null where the recompute runs:
// kernel_model.cost_slab_planes says which).  The slab comes after the
// stream, so a caller of the entry without it still runs the recompute.
extern "C" int custereo_camera_grad_recompute(
    const float* camera, const float* projector, float* cam_s, float* cam_e2,
    float* proj_s, float* proj_e2, const float* cotangent, float* a1,
    float* bm, float* grmu, float* grad, int B, int H, int W, int D, int k,
    float eps, void* stream_ptr, float* slab) {
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  return launch_grad_kernels(
      [&](size_t budget) {
        using Recompute = CotangentSource<false>;
        if (grad_round(k, D, staged_consts<Recompute>(), true, budget)
                .planes >= 1)
          return launch_all_planes<Recompute, true>(
              Recompute{cotangent, nullptr}, camera, projector, cam_s,
              cam_e2, proj_s, proj_e2, a1, bm, grmu, B, H, W, D, k, eps,
              budget, stream);
        return launch_cost_slabs<CotangentSource<true>>(
            [cotangent](const float* costs) {
              return CotangentSource<true>{cotangent, costs};
            },
            camera, projector, cam_s, cam_e2, proj_s, proj_e2, slab, a1, bm,
            grmu, B, H, W, D, k, eps, budget, stream);
      },
      camera, projector, cam_s, cam_e2, proj_s, proj_e2, a1, bm, grmu, grad,
      B, H, W, D, k, stream);
}
