// The closed-form camera VJP of the banded ZNCC volume: the one
// accumulation and combine body that K2 and K6 (zncc_banded_bwd.cu,
// cotangent read from memory) and K4 and K5 (fused_pipeline_bwd.cu,
// cotangent formed from the disparity head's maps) all run.  Two template
// axes: where the cotangent plane g_d comes from (Source), and where the
// cost comes from (kRecompute): read from the forward's volume (K2, K4)
// or recomputed from the staged images (K6, K5).
//
// Replaces the bodies of custereomatching_tpu/ops/pallas_zncc_bwd.py:
// _bwd_kernel (have_c=True: K2; the no-cost modes: K6) and of
// pallas_pipeline.py:_fused_bwd_c_kernel (K4) and _fused_bwd_kernel (K5).
// With r = (ex2 ey2(. - d) + eps)^{-1/2} and n r = c (the cost):
//   gr_d = g_d r_d
//   B    = sum_d g_d c_d r_d^2 ey2(. - d)
//   GRMU = sum_d gr_d muy(. - d)
//   A1   = sum_d box(gr_d) proj(. - d)
//   grad = A1 - box(GRMU) + box(B mux) - cam * box(B)
// Every box reads zeros outside the image: gr_d, B and GRMU are zero at
// window centres outside it (the form here of the zero-cotangent contract
// of pallas_zncc_bwd.py:961-967; the port's volume has no padding).  The
// projector statistics at columns x - d < 0 come from the D-widened
// statistics pass and are not zero there; proj(x - d) is.
//
// The recompute is K1's per-plane cross term (a rows pass of camera x
// shifted projector products, then the columns pass):
//   c_d = (box(cam proj(. - d)) - mux sy(. - d) + eps) r_d
// Where it is needed depends on the Source.  With the cotangent read from
// memory (K6) the cost enters only the B term of the tile's own pixels,
// so the recompute covers K1's kTileH x kTileW tile.  With the head's
// cotangent (K5) g_d needs the cost at every pixel of the halo'd tile, so
// the recompute covers (kTileH + 2p) x (kTileW + 2p) pixels, reading the
// images over (kTileH + 4p) x (kTileW + 4p) and the projector widened
// left by the planes of one chunk.  The projector tile is staged once per
// chunk of planes: all D + 1 when the block fits the card's shared memory
// that way (K6 and K5 at k = 15 up to D ~ 560), fewer otherwise, so any D
// runs; the chunk changes where values sit, not the arithmetic.
//
// Two kernels:
//   1. camera_grad_planes_kernel: one block per kTileH x kTileW pixel tile
//      walks d = 0..D.  Per plane it forms gr_d over the halo'd tile in
//      shared memory, box-sums it (rows, then columns), and accumulates A1,
//      B and GRMU of its own pixels in registers; it writes the three
//      [B, H, W] fields once.
//   2. camera_grad_combine_kernel: the three [H, W] box filters and the
//      final sum.
//
// What bounds it on the H100: with the cost read from memory, the cost
// (and for K2 the cotangent) volume is read once, 360 MB a KITTI frame
// each (about 0.11 ms at 3.35 TB/s); the halo'd gr tile re-reads a
// neighbour's cotangent through L2.  Beyond that, as K1, the per-plane row
// and column passes through shared memory and three barriers a plane
// (four with the recompute, which adds K1's rows pass, 2.2 times K1's
// region for K5); per-pixel constants of the tile (ex2, the head maps)
// are staged once in shared memory.
#pragma once

#include "common.cuh"

namespace custereo {
namespace {

// Shared-memory geometry of the planes kernel, in floats: the camera
// second moment and the gr_d plane over the halo'd tile (rows x cam_w
// each), the rows pass (kTileH x cam_w), then `maps` more halo'd tiles of
// the cotangent source's per-pixel constants.
struct GradTile {
  int p, rows, cam_w;
  __host__ __device__ explicit GradTile(int k)
      : p(k / 2), rows(kTileH + 2 * (k / 2)), cam_w(kTileW + 2 * (k / 2)) {}
  __host__ __device__ int halo() const { return rows * cam_w; }
  __host__ __device__ size_t floats(int maps) const {
    return static_cast<size_t>(2 + maps) * halo() +
           static_cast<size_t>(kTileH) * cam_w;
  }
};

// Shared-memory geometry of the cost recompute, in floats, after
// GradTile's: the camera tile (img_rows x cam_w) and the projector tile
// widened left by `chunk` - 1 columns (img_rows x proj_w) over the image
// region the recomputed windows of `chunk` planes read, the cross term's
// rows pass (out_rows x cam_w) and, when the recompute covers the halo'd
// tile, the camera's window means there (one more halo'd tile).  `ext` is
// how far the recomputed region reaches past the kTileH x kTileW tile on
// each side: 0 or p.
struct RecomputeTile {
  int p, ext, chunk, out_rows, img_rows, cam_w, proj_w;
  __host__ __device__ RecomputeTile(int k, int chunk, bool halo_cost)
      : p(k / 2),
        ext(halo_cost ? k / 2 : 0),
        chunk(chunk),
        out_rows(kTileH + 2 * ext),
        img_rows(kTileH + 2 * ext + 2 * (k / 2)),
        cam_w(kTileW + 2 * ext + 2 * (k / 2)),
        proj_w(kTileW + 2 * ext + 2 * (k / 2) + chunk - 1) {}
  __host__ __device__ size_t floats(int halo) const {
    return static_cast<size_t>(img_rows) * (cam_w + proj_w) +
           static_cast<size_t>(out_rows) * cam_w + (ext ? halo : 0);
  }
};

// The most planes a projector staging of the recompute can cover within
// `budget` floats of shared memory beside `fixed` (GradTile's), capped at
// D + 1; 0 when not even one plane fits.
inline int recompute_chunk(int k, int D, bool halo_cost, size_t fixed,
                           int halo, size_t budget) {
  const size_t one = fixed + RecomputeTile(k, 1, halo_cost).floats(halo);
  if (one > budget) return 0;
  const size_t more =
      (budget - one) / RecomputeTile(k, 1, halo_cost).img_rows;
  return static_cast<int>(more + 1 < static_cast<size_t>(D) + 1
                              ? more + 1
                              : static_cast<size_t>(D) + 1);
}

// The cross term's rows pass for shift = D - d (K1's vertical_products
// over out_rows rows): xsum[r][c] = sum_{t<k} cam_t[r + t][c] *
// proj_t[r + t][c + shift].
__device__ inline void cross_rows(float* xsum, const float* cam_t,
                                  const float* proj_t,
                                  const RecomputeTile& x, int k, int shift) {
  for (int i = threadIdx.x; i < x.out_rows * x.cam_w; i += blockDim.x) {
    const int r = i / x.cam_w, c = i - r * x.cam_w;
    const float* a = cam_t + r * x.cam_w + c;
    const float* b = proj_t + r * x.proj_w + c + shift;
    float acc = 0.f;
    for (int t = 0; t < k; ++t)
      acc = fmaf(a[t * x.cam_w], b[t * x.proj_w], acc);
    xsum[i] = acc;
  }
}

// Rows pass of one halo'd tile: vsum[r][c] = sum_{t<k} tile[r + t][c] for
// r < kTileH, c < width (i = r * width + c, so tile[(r + t) * width + c]
// is tile[i + t * width]).
__device__ inline void vertical_sum(float* vsum, const float* tile,
                                    int width, int k) {
  for (int i = threadIdx.x; i < kTileH * width; i += blockDim.x) {
    const float* a = tile + i;
    float acc = 0.f;
    for (int t = 0; t < k; ++t) acc += a[t * width];
    vsum[i] = acc;
  }
}

// Grid: (ceil(W / kTileW), ceil(H / kTileH), B); kThreads threads; dynamic
// shared memory GradTile(k).floats(Source::kMaps) floats, plus
// RecomputeTile(k, chunk, Source::kNeedsCost).floats(halo) with kRecompute.
//
// Source: the cotangent plane.
//   kMaps       halo'd tiles of per-pixel constants it stages
//   kNeedsCost  whether value() reads the cost at every halo pixel
//   stage(maps, halo, i, pix, inside)  fill entry i of its tiles
//   value(maps, halo, i, vidx, c, df)  g_d at halo entry i (inside the
//     image), volume offset vidx, cost c, disparity df
// kRecompute: the cost is recomputed from camera and projector (cost is
// not read), the projector tile staged anew every `chunk` planes;
// otherwise it is read from the plane-major volume `cost` (chunk unused).
template <class Source, bool kRecompute>
__global__ void __launch_bounds__(kThreads)
    camera_grad_planes_kernel(Source src, const float* __restrict__ camera,
                              const float* __restrict__ projector,
                              const float* __restrict__ cam_s,
                              const float* __restrict__ cam_e2,
                              const float* __restrict__ proj_s,
                              const float* __restrict__ proj_e2,
                              const float* __restrict__ cost,
                              float* __restrict__ a1_out,
                              float* __restrict__ b_out,
                              float* __restrict__ grmu_out, int H, int W,
                              int D, int k, int chunk, float eps) {
  // The recompute covers the halo'd tile when g_d needs the cost there.
  constexpr bool kHaloCost = kRecompute && Source::kNeedsCost;
  extern __shared__ float smem[];
  const GradTile g(k);
  const int halo = g.halo();
  float* ex2_t = smem;
  float* gr_t = ex2_t + halo;
  float* vsum = gr_t + halo;
  float* maps = vsum + kTileH * g.cam_w;
  const RecomputeTile x(k, chunk, kHaloCost);
  float* cam_x = maps + Source::kMaps * halo;
  float* proj_x = cam_x + x.img_rows * x.cam_w;
  float* xsum = proj_x + x.img_rows * x.proj_w;
  float* mux_t = xsum + x.out_rows * x.cam_w;

  const int b = blockIdx.z, h0 = blockIdx.y * kTileH, w0 = blockIdx.x * kTileW;
  const size_t plane = static_cast<size_t>(H) * W;
  const size_t frame = static_cast<size_t>(b) * plane;
  const size_t stats_w = static_cast<size_t>(W) + D;
  const float* cost_b =
      kRecompute ? nullptr : cost + static_cast<size_t>(b) * (D + 1) * plane;
  const float inv_k2 = 1.f / static_cast<float>(k * k);

  // Per-pixel constants of the halo'd tile, zero outside the image.
  for (int i = threadIdx.x; i < halo; i += blockDim.x) {
    const int rr = i / g.cam_w, cc = i - rr * g.cam_w;
    const int y = h0 - g.p + rr, xx = w0 - g.p + cc;
    const bool inside = y >= 0 && y < H && xx >= 0 && xx < W;
    const size_t pix = frame + static_cast<size_t>(y) * W + xx;
    ex2_t[i] = inside ? __ldg(cam_e2 + pix) : 0.f;
    if (kHaloCost) mux_t[i] = inside ? __ldg(cam_s + pix) * inv_k2 : 0.f;
    src.stage(maps, halo, i, pix, inside);
  }
  const int row0 = h0 - x.ext - x.p, col0 = w0 - x.ext - x.p;
  if (kRecompute)
    stage_tile(cam_x, camera + frame, H, W, row0, col0, x.img_rows, x.cam_w,
               1.f);

  const int r = threadIdx.x / kTileW, c = threadIdx.x % kTileW;
  const int h = h0 + r, w = w0 + c;
  const bool valid = h < H && w < W;
  const int centre = (r + g.p) * g.cam_w + c + g.p;
  // Image column x of the projector statistics sits at index x + D.
  const size_t o = frame + static_cast<size_t>(h) * W + w;
  const size_t stats_row = (static_cast<size_t>(b) * H + h) * stats_w + D + w;
  // The camera's window mean at the tile's own pixel (K6's recompute).
  const float mux =
      kRecompute && !kHaloCost && valid ? __ldg(cam_s + o) * inv_k2 : 0.f;
  float a1 = 0.f, bacc = 0.f, grmu = 0.f;
  // The last plane of the staged projector chunk: its tile starts at image
  // column col0 - last, so plane d reads it at shift last - d.
  int last = -1;
  __syncthreads();

  for (int d = 0; d <= D; ++d) {
    const float* cost_d = cost_b + d * plane;
    const float df = static_cast<float>(d);
    if (kRecompute) {
      if (d > last) {
        // The previous plane's closing barrier has retired every read of
        // the old chunk.
        last = min(d + x.chunk - 1, D);
        stage_tile(proj_x, projector + frame, H, W, row0, col0 - last,
                   x.img_rows, x.proj_w, 1.f);
        __syncthreads();
      }
      cross_rows(xsum, cam_x, proj_x, x, k, last - d);
      __syncthreads();
    }
    for (int i = threadIdx.x; i < halo; i += blockDim.x) {
      const int rr = i / g.cam_w, cc = i - rr * g.cam_w;
      const int y = h0 - g.p + rr, xx = w0 - g.p + cc;
      float v = 0.f;
      if (y >= 0 && y < H && xx >= 0 && xx < W) {
        const size_t px = static_cast<size_t>(y) * W + xx;
        const size_t srow =
            (static_cast<size_t>(b) * H + y) * stats_w + D + xx - d;
        const float ri = rsqrtf(ex2_t[i] * __ldg(proj_e2 + srow) + eps);
        float cv = 0.f;
        if (kHaloCost) {
          // Halo entry i is recompute output (rr, cc): ext = p.
          const float sxy = horizontal_sum(xsum, x.cam_w, rr, cc, k);
          cv = (sxy - mux_t[i] * __ldg(proj_s + srow) + eps) * ri;
        } else if (Source::kNeedsCost) {
          cv = __ldg(cost_d + px);
        }
        const float gd = src.value(
            maps, halo, i, (static_cast<size_t>(b) * (D + 1) + d) * plane + px,
            cv, df);
        v = gd * ri;
      }
      gr_t[i] = v;
    }
    __syncthreads();
    vertical_sum(vsum, gr_t, g.cam_w, k);
    __syncthreads();
    if (valid) {
      const float box = horizontal_sum(vsum, g.cam_w, r, c, k);
      const float pj = w >= d ? __ldg(projector + o - d) : 0.f;
      a1 = fmaf(box, pj, a1);
      const float gr = gr_t[centre];
      const float e2 = __ldg(proj_e2 + stats_row - d);
      const float sy = __ldg(proj_s + stats_row - d);
      const float rc = rsqrtf(ex2_t[centre] * e2 + eps);
      float cv;
      if (kRecompute) {
        const float sxy =
            horizontal_sum(xsum, x.cam_w, r + x.ext, c + x.ext, k);
        cv = (sxy - (kHaloCost ? mux_t[centre] : mux) * sy + eps) * rc;
      } else {
        cv = __ldg(cost_d + (o - frame));
      }
      bacc = fmaf(gr * cv, rc * e2, bacc);
      grmu = fmaf(gr, sy * inv_k2, grmu);
    }
    __syncthreads();
  }

  if (!valid) return;
  a1_out[o] = a1;
  b_out[o] = bacc;
  grmu_out[o] = grmu;
}

// grad = A1 - box(GRMU) + box(B mux) - cam * box(B), the boxes reading
// zeros outside the image.  Grid: (ceil(W / kTileW), ceil(H / kTileH), B);
// dynamic shared memory 3 * (rows * cols + kTileH * cols) floats.
__global__ void __launch_bounds__(kThreads)
    camera_grad_combine_kernel(const float* __restrict__ camera,
                               const float* __restrict__ cam_s,
                               const float* __restrict__ a1,
                               const float* __restrict__ bm,
                               const float* __restrict__ grmu,
                               float* __restrict__ grad, int H, int W,
                               int k) {
  extern __shared__ float smem[];
  const int p = k / 2, rows = kTileH + 2 * p, cols = kTileW + 2 * p;
  const int halo = rows * cols, vsz = kTileH * cols;
  float* t_grmu = smem;
  float* t_bmu = t_grmu + halo;
  float* t_b = t_bmu + halo;
  float* v_grmu = t_b + halo;
  float* v_bmu = v_grmu + vsz;
  float* v_b = v_bmu + vsz;
  const int b = blockIdx.z, h0 = blockIdx.y * kTileH, w0 = blockIdx.x * kTileW;
  const size_t frame = static_cast<size_t>(b) * H * W;
  const float inv_k2 = 1.f / static_cast<float>(k * k);

  for (int i = threadIdx.x; i < halo; i += blockDim.x) {
    const int rr = i / cols, cc = i - rr * cols;
    const int y = h0 - p + rr, x = w0 - p + cc;
    float vg = 0.f, vbm = 0.f, vb = 0.f;
    if (y >= 0 && y < H && x >= 0 && x < W) {
      const size_t pix = frame + static_cast<size_t>(y) * W + x;
      vg = __ldg(grmu + pix);
      vb = __ldg(bm + pix);
      vbm = vb * (__ldg(cam_s + pix) * inv_k2);
    }
    t_grmu[i] = vg;
    t_bmu[i] = vbm;
    t_b[i] = vb;
  }
  __syncthreads();
  vertical_sum(v_grmu, t_grmu, cols, k);
  vertical_sum(v_bmu, t_bmu, cols, k);
  vertical_sum(v_b, t_b, cols, k);
  __syncthreads();

  const int r = threadIdx.x / kTileW, c = threadIdx.x % kTileW;
  const int h = h0 + r, w = w0 + c;
  if (h >= H || w >= W) return;
  const size_t o = frame + static_cast<size_t>(h) * W + w;
  const float s_grmu = horizontal_sum(v_grmu, cols, r, c, k);
  const float s_bmu = horizontal_sum(v_bmu, cols, r, c, k);
  const float s_b = horizontal_sum(v_b, cols, r, c, k);
  grad[o] = (a1[o] - s_grmu) + (s_bmu - camera[o] * s_b);
}

// The statistics passes (camera; projector over the D-widened columns),
// the planes kernel and the combine.  Scratch: cam_s/cam_e2 [B, H, W],
// proj_s/proj_e2 [B, H, W + D], a1/bm/grmu [B, H, W].  With kRecompute
// `cost` is not read (pass nullptr).
template <bool kRecompute, class Source>
cudaError_t launch_camera_grad(const Source& src, const float* camera,
                               const float* projector, float* cam_s,
                               float* cam_e2, float* proj_s, float* proj_e2,
                               const float* cost, float* a1, float* bm,
                               float* grmu, float* grad, int B, int H, int W,
                               int D, int k, float eps, cudaStream_t stream) {
  cudaError_t e =
      launch_box_stats(camera, cam_s, cam_e2, B, H, W, k, 0, W, 1.f, stream);
  if (e != cudaSuccess) return e;
  e = launch_box_stats(projector, proj_s, proj_e2, B, H, W, k, D, W + D, 1.f,
                       stream);
  if (e != cudaSuccess) return e;

  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  auto planes = camera_grad_planes_kernel<Source, kRecompute>;
  const GradTile g(k);
  size_t floats = g.floats(Source::kMaps);
  int chunk = D + 1;
  if (kRecompute) {
    int device = 0, optin = 0;
    e = cudaGetDevice(&device);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (e != cudaSuccess) return e;
    chunk = recompute_chunk(k, D, Source::kNeedsCost, floats, g.halo(),
                            static_cast<size_t>(optin) / sizeof(float));
    // Not even one plane's projector tile fits beside the block's tiles.
    if (chunk < 1) return cudaErrorInvalidConfiguration;
    floats += RecomputeTile(k, chunk, Source::kNeedsCost).floats(g.halo());
  }
  const size_t bytes = floats * sizeof(float);
  e = allow_smem(planes, bytes);
  if (e != cudaSuccess) return e;
  planes<<<grid, kThreads, bytes, stream>>>(src, camera, projector, cam_s,
                                            cam_e2, proj_s, proj_e2, cost, a1,
                                            bm, grmu, H, W, D, k, chunk, eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const int p = k / 2;
  const size_t cols = kTileW + 2 * p;
  const size_t combine_bytes =
      sizeof(float) * 3 * ((kTileH + 2 * p) * cols + kTileH * cols);
  e = allow_smem(camera_grad_combine_kernel, combine_bytes);
  if (e != cudaSuccess) return e;
  camera_grad_combine_kernel<<<grid, kThreads, combine_bytes, stream>>>(
      camera, cam_s, a1, bm, grmu, grad, H, W, k);
  return cudaGetLastError();
}

}  // namespace
}  // namespace custereo
