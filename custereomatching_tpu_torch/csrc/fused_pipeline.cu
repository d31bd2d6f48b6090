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
// state crosses blocks.  The kernel, its rounds of planes and its head are
// fused_pipeline.cuh's, which K1 (zncc_banded.cu) instantiates without
// the head.
//
// What bounds it on the H100: the serving variant reads two images and
// writes four maps (about 6 * 4 * H * W bytes a frame), so it has no memory
// floor worth the name; the work is (D+1) planes of the k-tap row and
// column sums plus one rsqrt and one or two exp per pixel and plane, on
// the rounds of the register-blocked pass (fused_pipeline.cuh).  K3m adds
// three map stores (12 bytes a pixel).  K3w adds K1's volume write (360 MB
// a KITTI frame, about 0.11 ms at 3.35 TB/s), stored coalesced along W.
// It is not hidden behind the planes' arithmetic: on the H100 K3w took
// about that much longer than the serving variant.
#include "fused_pipeline.cuh"

using namespace custereo;

// Plain C interface, loaded with ctypes.  camera/projector: [B, H, W];
// scratch cam_s/cam_e2: [B, H, W], proj_s/proj_e2: [B, H, W + D]; the four
// output maps: [B, H, W]; all fp32, contiguous, on the current device.
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 when every launch was accepted).  `tile_rows`: the
// rounds kernel's tile, 8, 16 (the default) or 32 rows of 1024 / tile_rows
// columns; `planes`: planes a round, 0 for fused_round's; a tile or a
// round that does not fit is refused (cudaErrorInvalidConfiguration)
// before anything launches.
extern "C" int custereo_fused_pipeline(
    const float* camera, const float* projector, float* cam_s, float* cam_e2,
    float* proj_s, float* proj_e2, float* disparity, float* soft, float* mask,
    float* conf, int B, int H, int W, int D, int k, float eps, float beta,
    float threshold, int unnormalized, void* stream_ptr, int tile_rows,
    int planes) {
  return run_pipeline<true, false, false>(
      camera, projector, cam_s, cam_e2, proj_s, proj_e2, disparity, soft,
      mask, conf, nullptr, nullptr, nullptr, nullptr, B, H, W, D, k, eps,
      beta, threshold, unnormalized, static_cast<cudaStream_t>(stream_ptr),
      tile_rows, planes);
}

// The training forward (K3w): as custereo_fused_pipeline, plus the cost
// volume [B, D + 1, H, W] and the raw argmax, s and t maps [B, H, W].
extern "C" int custereo_fused_pipeline_train(
    const float* camera, const float* projector, float* cam_s, float* cam_e2,
    float* proj_s, float* proj_e2, float* disparity, float* soft, float* mask,
    float* conf, float* volume, float* am, float* s, float* t, int B, int H,
    int W, int D, int k, float eps, float beta, float threshold,
    int unnormalized, void* stream_ptr, int tile_rows, int planes) {
  return run_pipeline<true, true, true>(
      camera, projector, cam_s, cam_e2, proj_s, proj_e2, disparity, soft,
      mask, conf, volume, am, s, t, B, H, W, D, k, eps, beta, threshold,
      unnormalized, static_cast<cudaStream_t>(stream_ptr), tile_rows,
      planes);
}

// The volume-free training forward (K3m): as custereo_fused_pipeline, plus
// the raw argmax, s and t maps [B, H, W]; no volume.
extern "C" int custereo_fused_pipeline_train_maps(
    const float* camera, const float* projector, float* cam_s, float* cam_e2,
    float* proj_s, float* proj_e2, float* disparity, float* soft, float* mask,
    float* conf, float* am, float* s, float* t, int B, int H, int W, int D,
    int k, float eps, float beta, float threshold, int unnormalized,
    void* stream_ptr, int tile_rows, int planes) {
  return run_pipeline<true, true, false>(
      camera, projector, cam_s, cam_e2, proj_s, proj_e2, disparity, soft,
      mask, conf, nullptr, am, s, t, B, H, W, D, k, eps, beta, threshold,
      unnormalized, static_cast<cudaStream_t>(stream_ptr), tile_rows,
      planes);
}

// The planes a round and projector chunk K1's and K3's launcher takes at
// (k, D) on the current device at a tile of `tile_rows` rows and `planes`
// a round (0: fused_round's): round[0], round[1]; {0, 0} and
// cudaErrorInvalidConfiguration where they do not fit.  What the bound
// model mirrors (kernel_model.fused_round); launches nothing.
extern "C" int custereo_fused_rounds(int k, int D, int tile_rows, int planes,
                                     int* round) {
  Rounds r{0, 0};
  const cudaError_t e = fused_rounds_at(k, D, tile_rows, planes, &r);
  round[0] = r.planes;
  round[1] = r.chunk;
  return e;
}
