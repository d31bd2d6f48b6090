// K4's part of the trainable backward (fused_pipeline_bwd.cu) that the
// translation units of its tiles share: the head cotangent, the source
// that forms it from the head's maps for camera_grad.cuh's rounds kernel,
// and the launcher of that kernel over d = 0..D.  K4's rounds kernel runs
// at a tile of 8, 16 (the default) or 32 rows (Tile, common.cuh); the
// default tile is instantiated in fused_pipeline_bwd.cu, the others each
// in a translation unit of its own (fused_pipeline_bwd_tile8.cu,
// fused_pipeline_bwd_tile32.cu), so that nvcc compiles them side by side.
// A tile changes which pixels a block owns and the halo it stages, never
// the order of a pixel's taps or planes, so its gradient is the default
// tile's bit for bit.  The statistics and combine kernels, and K5, stay at
// the default tile.
#pragma once

#include "camera_grad.cuh"

namespace custereo {

// One call of K4's rounds kernel: the head's maps, the cost volume and
// the images and statistics it reads, the A1, B and GRMU it writes.
struct HeadRoundsCall {
  const float *am, *mask, *conf, *s, *t, *gsoft, *gconf, *cost;
  float beta;
  int unnormalized;
  const float *camera, *projector, *cam_s, *cam_e2, *proj_s, *proj_e2;
  float *a1, *bm, *grmu;
  int B, H, W, D, k;
  float eps;
  size_t budget;
  cudaStream_t stream;
};

// K4's rounds kernel at the tiles of 8 and 32 rows.
cudaError_t head_rounds_tile8(const HeadRoundsCall& c);
cudaError_t head_rounds_tile32(const HeadRoundsCall& c);

namespace {

// g_d at one pixel from the head's per-pixel values: gs = gs_hat mask
// beta, tos = t/s, inv_s = 1/s, am, gc = gc_hat and conf (read only by
// the rescaled head).
template <bool kUnnormalized>
__device__ __forceinline__ float head_cotangent(float gs, float tos,
                                                float inv_s, float am,
                                                float gc, float conf,
                                                float beta, float c,
                                                float df) {
  const float arg = kUnnormalized ? beta * c : beta * (c - conf);
  const float w = expf(arg) * inv_s;
  const float hit = am == df ? 1.f : 0.f;
  return gs * w * (df - tos) + gc * hit;
}

// g_d formed from the head's maps [B, H, W] and the cost (camera_grad.cuh's
// Source; K5 reads the maps itself).  kStaged: the entries' constants
// staged over the halo; otherwise read from the maps at every entry.
template <bool kUnnormalized, bool kStaged_ = true>
struct HeadSource {
  static constexpr bool kStaged = kStaged_;
  // Staged tiles: gs_hat mask beta, t/s, 1/s, am, gc_hat, conf.
  static constexpr int kMaps = kStaged ? 6 : 0;
  static constexpr bool kReadsCost = true;
  static constexpr bool kCentreCost = false;
  const float *am, *mask, *conf, *s, *t, *gsoft, *gconf;
  float beta;
  // The cost volume (K4; K5 recomputes the cost and leaves it null).
  const float* vol;

  struct Entry {
    float gs, tos, inv_s, am, gc, conf;
  };

  // The constants of frame pixel pix, from the maps.
  __device__ Entry load(size_t pix) const {
    const float inv_s = 1.f / __ldg(s + pix);
    return {__ldg(gsoft + pix) * __ldg(mask + pix) * beta,
            __ldg(t + pix) * inv_s,
            inv_s,
            __ldg(am + pix),
            __ldg(gconf + pix),
            __ldg(conf + pix)};
  }

  __device__ void stage(float* maps, int halo, int i, size_t pix,
                        bool inside) const {
    const Entry e = inside ? load(pix) : Entry{0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    maps[i] = e.gs;
    maps[halo + i] = e.tos;
    maps[2 * halo + i] = e.inv_s;
    maps[3 * halo + i] = e.am;
    maps[4 * halo + i] = e.gc;
    maps[5 * halo + i] = e.conf;
  }

  __device__ Entry entry(const float* maps, int halo, int i,
                         size_t pix) const {
    if constexpr (kStaged)
      return {maps[i],          maps[halo + i],     maps[2 * halo + i],
              maps[3 * halo + i], maps[4 * halo + i], maps[5 * halo + i]};
    else
      return load(pix);
  }

  __device__ float cotangent(const Entry& e, float c, float df) const {
    return head_cotangent<kUnnormalized>(e.gs, e.tos, e.inv_s, e.am, e.gc,
                                         e.conf, beta, c, df);
  }
};

// K4's rounds kernel over d = 0..D at a tile of TH rows: the constants
// staged where a plane's buffers fit beside them, else read from the maps.
template <bool kUnnormalized, int TH = kTileH>
cudaError_t launch_head_rounds(const HeadSource<kUnnormalized>& src,
                               const float* camera, const float* projector,
                               const float* cam_s, const float* cam_e2,
                               const float* proj_s, const float* proj_e2,
                               float* a1, float* bm, float* grmu, int B,
                               int H, int W, int D, int k, float eps,
                               size_t budget, cudaStream_t stream,
                               Tile<TH> tile = {}) {
  using Staged = HeadSource<kUnnormalized, true>;
  using Unstaged = HeadSource<kUnnormalized, false>;
  if (grad_round(k, D, staged_consts<Staged>(), false, budget, TH).planes >=
      1)
    return launch_all_planes<Staged, false>(
        src, camera, projector, cam_s, cam_e2, proj_s, proj_e2, a1, bm, grmu,
        B, H, W, D, k, eps, budget, stream, tile);
  return launch_all_planes<Unstaged, false>(
      Unstaged{src.am, src.mask, src.conf, src.s, src.t, src.gsoft,
               src.gconf, src.beta, src.vol},
      camera, projector, cam_s, cam_e2, proj_s, proj_e2, a1, bm, grmu, B, H,
      W, D, k, eps, budget, stream, tile);
}

// The planes a round and chunk K4's rounds kernel takes at (k, D) at a
// tile of th rows within `budget` floats, as launch_head_rounds picks
// them: with the constants staged (*staged) where a plane's buffers fit
// beside them, else read from their maps; {0, 0} where neither fits.
inline Rounds head_round(int k, int D, size_t budget, int th, bool* staged) {
  const Rounds r = grad_round(k, D, staged_consts<HeadSource<true>>(), false,
                              budget, th);
  *staged = r.planes >= 1;
  return *staged ? r : grad_round(k, D, 0, false, budget, th);
}

// Whether K4's rounds kernel takes (k, D) at a tile of th rows within
// `budget` floats, its constants staged or read from their maps.
inline bool head_rounds_fit(int k, int D, size_t budget, int th) {
  bool staged = false;
  return head_round(k, D, budget, th, &staged).planes >= 1;
}

// `c` at a tile of TH rows, in the head branch it names.
template <int TH>
cudaError_t head_rounds_call(const HeadRoundsCall& c) {
  if (c.unnormalized)
    return launch_head_rounds(
        HeadSource<true>{c.am, c.mask, c.conf, c.s, c.t, c.gsoft, c.gconf,
                         c.beta, c.cost},
        c.camera, c.projector, c.cam_s, c.cam_e2, c.proj_s, c.proj_e2, c.a1,
        c.bm, c.grmu, c.B, c.H, c.W, c.D, c.k, c.eps, c.budget, c.stream,
        Tile<TH>());
  return launch_head_rounds(
      HeadSource<false>{c.am, c.mask, c.conf, c.s, c.t, c.gsoft, c.gconf,
                        c.beta, c.cost},
      c.camera, c.projector, c.cam_s, c.cam_e2, c.proj_s, c.proj_e2, c.a1,
      c.bm, c.grmu, c.B, c.H, c.W, c.D, c.k, c.eps, c.budget, c.stream,
      Tile<TH>());
}

}  // namespace
}  // namespace custereo
