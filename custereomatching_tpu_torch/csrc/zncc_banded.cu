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
// The kernel is K3's (fused_pipeline.cuh) without the head, at beta = 1:
// the statistics passes, then a block a 16 x 64 pixel tile that stages
// the camera tile once and the projector tile in chunks of planes (all
// D + 1 at once where they fit: one staging at KITTI), and runs the planes
// in rounds of P on the register-blocked pass (K3's round_products and
// round_column_sums, common.cuh); each pixel's thread reads its P window
// sums in plane order and stores its cost planes.  Every window sum adds
// its taps in the order of common.cuh's first pass (vertical_products,
// horizontal_sum), so the volume is that pass's bit for bit, and K3w's at
// beta = 1 is K1's.  At KITTI (k = 15, D = 192): P = 13, 40,392 floats =
// 161,568 bytes a block, one 1024-thread block an SM.  Every odd k <= 127
// runs at every D (at k = 127 one plane a round and a one-plane projector
// chunk: 58,056 of the 58,112 floats a block may hold).
//
// What bounds it on the H100: the volume write is the floor (360 MB at
// 3.35 TB/s is about 0.11 ms a KITTI frame; the card writes a pixel's
// planes in turn at about 1.23 TB/s, 0.30 ms).  Beside it, a round makes
// about 11 shared accesses a pixel and plane at k = 15 and passes two
// barriers for P planes.
#include "fused_pipeline.cuh"

using namespace custereo;

// Plain C interface, loaded with ctypes.  camera/projector: [B, H, W];
// scratch cam_s/cam_e2: [B, H, W], proj_s/proj_e2: [B, H, W + D];
// out: [B, D + 1, H, W]; all fp32, contiguous, on the current device.
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 when every launch was accepted).  `tile_rows` and
// `planes`: the rounds kernel's tile and planes a round, as
// custereo_fused_pipeline's (fused_pipeline.cu).
extern "C" int custereo_banded_volume(const float* camera,
                                      const float* projector, float* cam_s,
                                      float* cam_e2, float* proj_s,
                                      float* proj_e2, float* out, int B,
                                      int H, int W, int D, int k, float eps,
                                      void* stream_ptr, int tile_rows,
                                      int planes) {
  return run_pipeline<false, false, true>(
      camera, projector, cam_s, cam_e2, proj_s, proj_e2, nullptr, nullptr,
      nullptr, nullptr, out, nullptr, nullptr, nullptr, B, H, W, D, k, eps,
      1.f, 0.f, 0, static_cast<cudaStream_t>(stream_ptr), tile_rows, planes);
}

extern "C" const char* custereo_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
