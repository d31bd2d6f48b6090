// The rounds kernel of the banded cost planes on Hopper: K3's fused
// pipeline (banded ZNCC planes folded into an online disparity head; K3w
// also streams each plane out as the backward's cost residual, K3m writes
// the training maps but no volume) and, without the head, K1's volume.
// The C entries are fused_pipeline.cu's (K3, K3w, K3m) and zncc_banded.cu's
// (K1).
//
// Per plane, with the projector pre-scaled by beta when it is staged (as
// the JAX wrapper _pipeline_forward_full folds beta into the projector):
//   bc = (box(cam * beta proj(. - d)) - mux * sy_b + beta eps)
//        * rsqrt(ex2 * ey2 + eps)                       (= beta * cost)
// where sy_b = box(beta proj) and ey2 is unscaled by 1 / beta^2 in the
// statistics pass.  K1 runs at beta = 1, where the staged projector is the
// projector, beta eps = eps and bc * (1 / beta) = bc: its planes are
// K1's costs, (box(cam * proj(. - d)) - mux * sy + eps) * rsqrt(ex2 * ey2
// + eps), and K3w's volume at beta = 1 is K1's bit for bit.
//
// The head (K3, K3w, K3m) keeps the running max m, its first argmax am
// (strict >, so the first maximum wins as torch.argmax does) and the
// softmax sums s = sum e^bc, t = sum d e^bc:
//   * unnormalized (beta + ln(D (D+1)) <= 85): raw e^bc, which cannot
//     overflow fp32 while |cost| <= 1 + eps;
//   * rescaled otherwise: s, t kept relative to e^m and rescaled when m
//     grows.
// Outputs [B, H, W] maps: conf = m / beta, mask = conf > threshold,
// disparity = am * mask, soft = (t / s) * mask.  K3w adds the cost planes
// c = bc * (1 / beta) as a [B, D+1, H, W] volume (as the Pallas kernel
// writes bc * inv_b) and the raw am, s and t maps that the backward (K4,
// fused_pipeline_bwd.cu) reads; K3m adds the three maps alone, for the
// volume-free backward (K5).  The training variants' four maps are the
// serving variant's bit for bit: the extra stores change no arithmetic.
//
// The planes go in rounds of P on the register-blocked pass of common.cuh
// (round_products, round_column_sums): a rows-pass item sums a whole tile
// column of one plane (16 outputs from 2 (15 + k) loads), a column-sums
// item 16 outputs from 15 + k loads, and a round has two barriers, so at
// k = 15 a pixel and plane costs about 11 shared loads and stores, and
// D = 192 takes 30 barriers.  The round's sums wait in shared memory and
// each pixel's thread reads its own in plane order, storing its cost
// planes coalesced along W.  The projector tile is staged in chunks of planes (fused_round, common.cuh):
// all D + 1 at once where they fit beside the round's buffers, else a
// multiple of the round at a time, so any D runs.  At KITTI (k = 15, D =
// 192) a block holds the two image tiles (30 x 78 and 30 x 270, one
// staging) and P = 13 planes of rows-pass sums (16 x 79) and window sums
// (16 x 65): 40,392 floats = 161,568 bytes, and its threads take up to 64
// registers, so one 1024-thread block an SM.  K1 in slab mode (kSlab)
// writes the planes [d_lo, d_hi] alone, into a volume of their own: the
// chunked route of K5 and K6 (camera_grad.cuh) reads its costs so.
//
// The tile is a template parameter (Tile<TH>, common.cuh): 16 x 64 by
// default, 8 x 128 and 32 x 32 in translation units of their own
// (fused_pipeline_tile8.cu, fused_pipeline_tile32.cu), which the C entries
// reach through run_pipeline; the planes a round are an argument (0:
// fused_round's choice).  Neither changes a value: a pixel's taps and
// planes keep their order, so every tile gives the default's outputs bit
// for bit.  The autotuner (ops/tuning.py) picks them.
#pragma once

#include "common.cuh"

namespace custereo {

// One call of K1, K3, K3w or K3m: the C entries' arguments.  `head`: the
// head runs (K3, K3w, K3m; K1 writes the volume alone); `residuals`: am, s
// and t are written (K3w, K3m); a volume is written where `volume` is not
// null.
struct PipelineCall {
  const float *camera, *projector;
  float *cam_s, *cam_e2, *proj_s, *proj_e2;
  float *disparity, *soft, *mask, *conf, *volume, *am, *s, *t;
  int B, H, W, D, k;
  float eps, beta, threshold;
  int unnormalized, planes;
  bool head, residuals;
  cudaStream_t stream;
};

// The rounds kernel at the tiles of 8 and 32 rows, each built in a
// translation unit of its own (fused_pipeline_tile8.cu,
// fused_pipeline_tile32.cu), so that nvcc compiles them beside the others.
int run_pipeline_tile8(const PipelineCall& c);
int run_pipeline_tile32(const PipelineCall& c);

namespace {

// Grid: (ceil(W / TW), ceil(H / TH), B) for a TH x TW pixel tile
// (Tile<TH>; 16 x 64 by default); kThreads threads, one block an SM (the
// register-blocked pass takes up to 64 registers a thread); dynamic shared
// memory RoundTile(PlaneTile(k, chunk - 1, TH), planes).floats() floats.
// The four head maps are written only when kHead, am_out, s_out and t_out
// only when kResiduals, volume only when kVolume; without the head (K1)
// the kernel writes the volume alone.
// kSlab (K1 only): the planes d_lo..d_hi alone, the volume [B, d_hi - d_lo
// + 1, H, W]; otherwise d = 0..D, and d_lo and d_hi are unused.
template <bool kHead, bool kUnnormalized, bool kResiduals, bool kVolume,
          bool kSlab, int TH = kTileH>
__global__ void __launch_bounds__(kThreads, 1)
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
                          int k, int planes, int chunk, int d_lo, int d_hi,
                          float eps, float beta, float threshold) {
  static_assert(kHead || (kVolume && !kResiduals),
                "without the head the kernel writes the volume alone (K1)");
  static_assert(!kSlab || !kHead, "a slab of planes is K1's");
  constexpr int TW = Tile<TH>::kW;
  extern __shared__ float smem[];
  // The projector tile holds `chunk` planes: for the chunk's last plane
  // `last` it starts at image column w0 - p - last, and plane d reads it
  // at shift last - d.
  const PlaneTile g(k, chunk - 1, TH);
  const RoundTile x(g, planes);
  float* cam_t = smem;
  float* proj_t = cam_t + g.rows * g.cam_w;
  float* vsum = proj_t + g.rows * g.proj_w;
  float* box = vsum + planes * x.vsum_floats();

  const int b = blockIdx.z, h0 = blockIdx.y * TH, w0 = blockIdx.x * TW;
  const size_t plane = static_cast<size_t>(H) * W;
  const float* proj_b = projector + b * plane;
  // The planes walked.
  const int first = kSlab ? d_lo : 0, end = kSlab ? d_hi : D;
  int last = min(first + chunk - 1, end);
  stage_tile(cam_t, camera + b * plane, H, W, h0 - g.p, w0 - g.p, g.rows,
             g.cam_w, 1.f);
  stage_tile(proj_t, proj_b, H, W, h0 - g.p, w0 - g.p - last, g.rows,
             g.proj_w, beta);

  const int r = threadIdx.x / TW, c = threadIdx.x % TW;
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
      vol_px = volume + static_cast<size_t>(b) * (end - first + 1) * plane +
               static_cast<size_t>(h) * W + w;
  }
  const float beps = beta * eps;
  const float inv_b = 1.f / beta;
  const float* my_box = box + r * x.bs + c;
  float m = -3.0e38f, am = 0.f, s = 0.f, t = 0.f;
  __syncthreads();

  // Rounds of `planes` planes; a chunk holds a whole number of rounds.
  // The rows pass of a round overwrites vsum, whose last reader (the round
  // before's column sums) is behind a barrier; the column sums overwrite
  // box after the rows pass's barrier, which every read of the round
  // before's sums precedes.
  for (int d0 = first; d0 <= end; d0 += planes) {
    if (d0 > last) {
      // The round before's rows pass, behind its barrier, read the old
      // chunk last.
      last = min(d0 + chunk - 1, end);
      stage_tile(proj_t, proj_b, H, W, h0 - g.p, w0 - g.p - last, g.rows,
                 g.proj_w, beta);
      __syncthreads();
    }
    const int np = min(planes, last + 1 - d0);
    round_products<TH>(vsum, cam_t, proj_t, g, x, k, last - d0, np);
    __syncthreads();
    round_column_sums(box, vsum, x, k, np);
    __syncthreads();
    if (!valid) continue;
    for (int j = 0; j < np; ++j) {
      const int d = d0 + j;
      const float sxy_b = my_box[j * x.box_floats()];
      const float exy_b = sxy_b - mux * __ldg(sy_row - d);
      const float bc =
          (exy_b + beps) * rsqrtf(ex2 * __ldg(ey2_row - d) + eps);
      if (kVolume) vol_px[(d - first) * plane] = bc * inv_b;
      if constexpr (kHead) {
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
    }
  }

  if constexpr (kHead) {
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
}

// The rounds of a K1 or K3 launch over D + 1 planes at a tile of th rows
// on the current device: fused_round within its opt-in shared memory,
// `planes` a round where > 0.  cudaErrorInvalidConfiguration where they
// do not fit.
inline cudaError_t fused_rounds_at(int k, int D, int th, int planes,
                                   Rounds* round) {
  int device = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device);
  if (e != cudaSuccess) return e;
  *round = fused_round(k, D, static_cast<size_t>(optin) / sizeof(float), th,
                       planes);
  return round->planes < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

// The rounds kernel over the planes d_lo..d_hi (all D + 1 unless kSlab),
// at a tile of TH rows, at fused_round's planes a round (or `planes`, where
// > 0) and projector chunk for them.
template <bool kHead, bool kUnnormalized, bool kResiduals, bool kVolume,
          bool kSlab = false, int TH = kTileH>
cudaError_t launch_fused(const float* camera, const float* projector,
                         const float* cam_s, const float* cam_e2,
                         const float* proj_s, const float* proj_e2,
                         float* disparity, float* soft, float* mask,
                         float* conf, float* volume, float* am, float* s,
                         float* t, int B, int H, int W, int D, int k,
                         int d_lo, int d_hi, float eps, float beta,
                         float threshold, cudaStream_t stream,
                         Tile<TH> = {}, int planes = 0) {
  constexpr int TW = Tile<TH>::kW;
  auto kernel = fused_pipeline_kernel<kHead, kUnnormalized, kResiduals,
                                      kVolume, kSlab, TH>;
  Rounds round;
  // Not even one plane's buffers (or not the planes asked for) fit beside
  // the image tiles.
  cudaError_t e = fused_rounds_at(k, d_hi - d_lo, TH, planes, &round);
  if (e != cudaSuccess) return e;
  const PlaneTile g(k, round.chunk - 1, TH);
  const size_t bytes = RoundTile(g, round.planes).floats(g) * sizeof(float);
  e = allow_smem(kernel, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      camera, projector, cam_s, cam_e2, proj_s, proj_e2, disparity, soft,
      mask, conf, volume, am, s, t, H, W, D, k, round.planes, round.chunk,
      d_lo, d_hi, eps, beta, threshold);
  return cudaGetLastError();
}

// The statistics passes (the projector's scaled by beta), then the rounds
// kernel at a tile of TH rows: with the head in the branch that
// `unnormalized` selects, or without it (K1, at beta = 1).  A tile or
// `planes` that does not fit is refused before anything launches.
template <bool kHead, bool kResiduals, bool kVolume, int TH>
int run_tile(const PipelineCall& c) {
  Rounds round;
  cudaError_t e = fused_rounds_at(c.k, c.D, TH, c.planes, &round);
  if (e != cudaSuccess) return e;
  e = launch_box_stats(c.camera, c.cam_s, c.cam_e2, c.B, c.H, c.W, c.k, 0,
                       c.W, 1.f, c.stream);
  if (e != cudaSuccess) return e;
  e = launch_box_stats(c.projector, c.proj_s, c.proj_e2, c.B, c.H, c.W, c.k,
                       c.D, c.W + c.D, c.beta, c.stream);
  if (e != cudaSuccess) return e;
  if constexpr (kHead) {
    if (c.unnormalized)
      return launch_fused<true, true, kResiduals, kVolume>(
          c.camera, c.projector, c.cam_s, c.cam_e2, c.proj_s, c.proj_e2,
          c.disparity, c.soft, c.mask, c.conf, c.volume, c.am, c.s, c.t, c.B,
          c.H, c.W, c.D, c.k, 0, c.D, c.eps, c.beta, c.threshold, c.stream,
          Tile<TH>(), c.planes);
  }
  return launch_fused<kHead, false, kResiduals, kVolume>(
      c.camera, c.projector, c.cam_s, c.cam_e2, c.proj_s, c.proj_e2,
      c.disparity, c.soft, c.mask, c.conf, c.volume, c.am, c.s, c.t, c.B, c.H,
      c.W, c.D, c.k, 0, c.D, c.eps, c.beta, c.threshold, c.stream, Tile<TH>(),
      c.planes);
}

// The outputs `c` asks for (K1, K3, K3w or K3m) at a tile of TH rows: what
// the translation unit of a tile other than the default instantiates.
template <int TH>
int run_outputs(const PipelineCall& c) {
  if (!c.head) return run_tile<false, false, true, TH>(c);
  if (!c.residuals) return run_tile<true, false, false, TH>(c);
  return c.volume != nullptr ? run_tile<true, true, true, TH>(c)
                             : run_tile<true, true, false, TH>(c);
}

// K1, K3, K3w or K3m at a tile of `tile_rows` rows (kTileH, or another of
// the tiles Tile instantiates the rounds kernel at) and `planes` planes a
// round (0: fused_round's).  A tile with no instantiation is refused.
template <bool kHead, bool kResiduals, bool kVolume>
int run_pipeline(const float* camera, const float* projector, float* cam_s,
                 float* cam_e2, float* proj_s, float* proj_e2,
                 float* disparity, float* soft, float* mask, float* conf,
                 float* volume, float* am, float* s, float* t, int B, int H,
                 int W, int D, int k, float eps, float beta, float threshold,
                 int unnormalized, cudaStream_t stream, int tile_rows,
                 int planes) {
  const PipelineCall c{camera, projector, cam_s, cam_e2, proj_s, proj_e2,
                       disparity, soft, mask, conf, volume, am, s, t,
                       B, H, W, D, k, eps, beta, threshold, unnormalized,
                       planes, kHead, kResiduals, stream};
  switch (tile_rows) {
    case kTileH:
      return run_tile<kHead, kResiduals, kVolume, kTileH>(c);
    case 8:
      return run_pipeline_tile8(c);
    case 32:
      return run_pipeline_tile32(c);
    default:
      return cudaErrorInvalidConfiguration;
  }
}

}  // namespace
}  // namespace custereo
