// K7: the projector VJP of the banded ZNCC volume on Hopper, with the
// forward cost volume as a residual.
//
// Replaces: custereomatching_tpu/ops/pallas_zncc_bwd.py:_proj_bwd_kernel
// (driven by pallas_projector_grad_banded_hdw_with_cost, whose XLA
// epilogue of three box filters is the combine kernel here).  The
// cotangent g and the cost c arrive plane-major, [B, D+1, H, W], the layout
// K1 writes.
//
// What it computes.  Every per-plane field is shifted to projector
// coordinates, f~_d[h, x] = f_d[h, x + d] (zero where x + d lies outside
// the image: g and c are zero there by the volume's extent), with
// r = (ex2(x + d) ey2(x) + eps)^{-1/2} and n r = c:
//   A1p  = sum_d cam(x + d) box(g~_d r)                    x in [0, W)
//   z2   = sum_d g~_d r mux(x + d)                         x in [-p, W)
//   z3   = sum_d g~_d c~_d r^2 ex2(x + d)                  x in [-p, W)
//   grad = A1p - box(z2) - proj box(z3) + box(muy z3)
// z2 and z3 are accumulated on the extended column axis e = x + p: a
// shifted field holds real values at x < 0 (camera columns x + d >= 0),
// and the boxes at x in [0, p) read them; a centre-only accumulation
// fails the oracle (pallas_zncc_bwd.py:624-629).  ey2 and muy there are
// the statistics of the partial windows of the image widened left by p
// zero columns (the statistics pass with col_off = p).
//
// Two kernels, the split of K2 (camera_grad.cuh):
//   1. proj_grad_rounds_kernel<P>: one block per kTileH x kTileW tile of
//      the extended columns walks the planes in rounds of P on the
//      register-blocked pass, built from camera_grad.cuh's rounds-kernel
//      pieces (GradRoundTile, grad_round, ring_entry, grad_rows,
//      grad_column_sums).  The projector's ey2 over the halo'd tile is
//      staged once (it does not shift).  A round:
//        b. g~_d r at every halo entry for the round's P planes: an entry
//           issues its P planes' loads of g and of the camera's ex2, at
//           camera column ei - p + d, before it uses the first (zero where
//           that column or the entry's row lies outside the image).  The
//           tile's own pixels are their own threads' entries, which also
//           load cam_s and the cost there and add z2 and z3 in registers
//           from the same r; the ring of the halo around them is spread
//           over the block;
//        c. its rows pass and column sums (grad_rows, grad_column_sums);
//        d. A1p of each pixel with x >= 0, by its thread, in plane order.
//      Four barriers a round.  P is a template constant (kGradPlanes, or
//      the largest power of two below it whose buffers fit), so the plane
//      loops have a fixed count; a short last round is predicated.  Every
//      window sum adds its taps in the order of common.cuh's first pass,
//      and A1p, z2 and z3 accumulate in plane order, so the gradient does
//      not depend on P.  It writes A1p [B, H, W] and z2, z3 [B, H, W + p]
//      once.
//   2. proj_grad_combine_kernel: the three box filters on the extended
//      columns and the final sum, the three maps staged together, or one
//      after another where their tiles do not fit together (k > 93), each
//      in the same order.
// At k = 15: P = 8, ey2 (30 x 78) and 8 planes of the two buffers (30 x
// 79 + 16 x 79): 31,412 floats = 125,648 bytes, one 1024-thread block an
// SM.  The rounds kernel takes every odd k <= 127 (P = 1 from k = 95), and
// so does the combine, at any D.
//
// What bounds it on the H100: it reads two volumes, g and c (720 MB a
// KITTI frame, about 0.21 ms at 3.35 TB/s; at a halo entry the g and ex2
// loads of neighbouring tiles come through L2), and otherwise the entries'
// loads and rsqrt and the window passes, as K4's and K6's rounds.
#include "camera_grad.cuh"

namespace custereo {
namespace {

// Grid: (ceil((W + p) / kTileW), ceil(H / kTileH), B); kThreads threads,
// one block an SM; dynamic shared memory GradRoundTile(k, 1, false, 1,
// P).floats() floats: the projector's ey2 over the halo'd tile, then P
// planes of buffer Y (g~r over the halo'd tile, then its box sums) and of
// buffer X (its rows pass).
template <int P>
__global__ void __launch_bounds__(kThreads, 1)
    proj_grad_rounds_kernel(const float* __restrict__ camera,
                            const float* __restrict__ cam_s,
                            const float* __restrict__ cam_e2,
                            const float* __restrict__ proj_e2,
                            const float* __restrict__ cost,
                            const float* __restrict__ g,
                            float* __restrict__ a1p_out,
                            float* __restrict__ z2_out,
                            float* __restrict__ z3_out, int H, int W, int D,
                            int k, float eps) {
  extern __shared__ float smem[];
  const GradRoundTile x(k, 1, false, 1, P);
  const GradStrides gs = x.strides();
  const int halo = x.halo, hc = x.halo_cols, p = x.p, we = W + p;
  float* ey2_t = smem;
  float* ybuf = ey2_t + halo;
  float* xbuf = ybuf + P * x.ysz;

  const int b = blockIdx.z, h0 = blockIdx.y * kTileH, e0 = blockIdx.x * kTileW;
  const size_t plane = static_cast<size_t>(H) * W;
  const size_t frame = static_cast<size_t>(b) * plane;
  const size_t ext_frame = static_cast<size_t>(b) * H * we;
  const float* g_b = g + static_cast<size_t>(b) * (D + 1) * plane;
  const float* c_b = cost + static_cast<size_t>(b) * (D + 1) * plane;
  const float* cam_e2_b = cam_e2 + frame;
  const float inv_k2 = 1.f / static_cast<float>(k * k);

  // Halo entry (rr, cc) is row h0 - p + rr and extended column
  // e0 - p + cc (projector column x = e - p).  ey2 is needed at
  // e in [0, W + p); entries outside hold 0 and are never used.
  for (int i = threadIdx.x; i < halo; i += blockDim.x) {
    const int rr = i / hc, cc = i - rr * hc;
    const int y = h0 - p + rr, e = e0 - p + cc;
    const bool inside = y >= 0 && y < H && e >= 0 && e < we;
    ey2_t[i] = inside
                   ? __ldg(proj_e2 + ext_frame + static_cast<size_t>(y) * we + e)
                   : 0.f;
  }

  const int r = threadIdx.x / kTileW, c = threadIdx.x % kTileW;
  const int h = h0 + r, e = e0 + c, xc = e - p;
  const bool valid = h < H && e < we;
  const int centre = (r + p) * hc + c + p;
  float* centre_y = ybuf + (r + p) * x.ys + c + p;
  // The pixel's row of the camera-side maps (used only when valid).
  const size_t hw = static_cast<size_t>(h) * W;
  const int ring = halo - kThreads;
  float a1 = 0.f, z2 = 0.f, z3 = 0.f;

  for (int d0 = 0; d0 <= D; d0 += P) {
    const int np = min(P, D + 1 - d0);
    // The round before's A1p has read Y (and the prologue's ey2 is in).
    __syncthreads();

    // b. g~r of the tile's own entry, the pixel's camera column x + d,
    // with its z2 and z3 terms.  Planes past D (a short last round) load
    // plane D and add nothing.  Every load is issued: its column is
    // clamped into the image, and a plane whose column lies outside is
    // zero.
    if (valid) {
      const float ey2 = ey2_t[centre];
      float gv[P], e2[P], sv[P], cv[P];
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int d = min(d0 + j, D);
        const size_t px = hw + min(max(xc + d, 0), W - 1);
        gv[j] = __ldg(g_b + d * plane + px);
        e2[j] = __ldg(cam_e2_b + px);
        sv[j] = __ldg(cam_s + frame + px);
        cv[j] = __ldg(c_b + d * plane + px);
      }
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int w = xc + min(d0 + j, D);
        float gr = 0.f;
        if (w >= 0 && w < W) {
          const float ri = rsqrtf(e2[j] * ey2 + eps);
          gr = gv[j] * ri;
          if (j < np) {
            z2 = fmaf(gr, sv[j] * inv_k2, z2);
            z3 = fmaf(gr * cv[j], ri * e2[j], z3);
          }
        }
        centre_y[j * x.ysz] = gr;
      }
    } else {
#pragma unroll
      for (int j = 0; j < P; ++j) centre_y[j * x.ysz] = 0.f;
    }
    // g~r at the ring's entries.
    for (int q = threadIdx.x; q < ring; q += kThreads) {
      const int i = ring_entry(q, p, hc);
      const int rr = i / hc, cc = i - rr * hc;
      const int y = h0 - p + rr, ei = e0 - p + cc;
      float* ey = ybuf + rr * x.ys + cc;
      if (!(y >= 0 && y < H && ei >= 0)) {
#pragma unroll
        for (int j = 0; j < P; ++j) ey[j * x.ysz] = 0.f;
        continue;
      }
      const float ey2 = ey2_t[i];
      const size_t yw = static_cast<size_t>(y) * W;
      float gv[P], e2[P];
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int d = min(d0 + j, D);
        // The entry's camera column ei - p + d, clamped as above.
        const size_t px = yw + min(max(ei - p + d, 0), W - 1);
        gv[j] = __ldg(g_b + d * plane + px);
        e2[j] = __ldg(cam_e2_b + px);
      }
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int w = ei - p + min(d0 + j, D);
        ey[j * x.ysz] = w >= 0 && w < W
                            ? gv[j] * rsqrtf(e2[j] * ey2 + eps)
                            : 0.f;
      }
    }
    __syncthreads();

    // c. The rows pass (Y to X) and column sums (X to Y).
    grad_rows(xbuf, ybuf, gs, k, np);
    __syncthreads();
    grad_column_sums(ybuf, xbuf, gs, k, np);
    __syncthreads();

    // d. A1p of the tile's pixels with x >= 0, in plane order.
    if (valid && xc >= 0) {
      const float* box = ybuf + r * x.bs + c;
      float cm[P];
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int w = xc + d0 + j;
        const float cam = __ldg(camera + frame + hw + min(w, W - 1));
        cm[j] = j < np && w < W ? cam : 0.f;
      }
#pragma unroll
      for (int j = 0; j < P; ++j)
        if (j < np) a1 = fmaf(box[j * x.ysz], cm[j], a1);
    }
  }

  if (!valid) return;
  if (xc >= 0) a1p_out[frame + hw + xc] = a1;
  const size_t o = ext_frame + static_cast<size_t>(h) * we + e;
  z2_out[o] = z2;
  z3_out[o] = z3;
}

// grad = A1p - box(z2) - proj * box(z3) + box(muy z3), the boxes over the
// extended columns e in [0, W + p) and rows [0, H), reading zeros outside;
// output column x sits at e = x + p.  muy comes from the widened
// projector statistics (index e).  The three maps are box-filtered
// kAtOnce at a time (3, or 1 where three tiles do not fit), each in the
// same order.  Grid: (ceil(W / kTileW), ceil(H / kTileH), B); dynamic
// shared memory combine_floats(k, kAtOnce) floats.
template <int kAtOnce>
__global__ void __launch_bounds__(kThreads)
    proj_grad_combine_kernel(const float* __restrict__ projector,
                             const float* __restrict__ proj_s,
                             const float* __restrict__ a1p,
                             const float* __restrict__ z2,
                             const float* __restrict__ z3,
                             float* __restrict__ grad, int H, int W, int k) {
  static_assert(3 % kAtOnce == 0, "the maps go in whole groups");
  extern __shared__ float smem[];
  const int p = k / 2, rows = kTileH + 2 * p, cols = kTileW + 2 * p;
  const int halo = rows * cols, vsz = kTileH * cols, we = W + p;
  float* tiles = smem;
  float* vert = tiles + kAtOnce * halo;
  const int b = blockIdx.z, h0 = blockIdx.y * kTileH, w0 = blockIdx.x * kTileW;
  const size_t ext_frame = static_cast<size_t>(b) * H * we;
  const float inv_k2 = 1.f / static_cast<float>(k * k);
  const int r = threadIdx.x / kTileW, c = threadIdx.x % kTileW;
  // box(z2), box(z3), box(muy z3) at the thread's pixel.
  float s[3];

#pragma unroll
  for (int m0 = 0; m0 < 3; m0 += kAtOnce) {
    // The group before has read its tiles.
    if (m0 > 0) __syncthreads();
    // Halo entry (rr, cc) is row h0 - p + rr, extended column w0 + cc.
    for (int i = threadIdx.x; i < halo; i += blockDim.x) {
      const int rr = i / cols, cc = i - rr * cols;
      const int y = h0 - p + rr, e = w0 + cc;
      const bool inside = y >= 0 && y < H && e < we;
      const size_t o = ext_frame + static_cast<size_t>(y) * we + e;
#pragma unroll
      for (int m = m0; m < m0 + kAtOnce; ++m) {
        float v = 0.f;
        if (inside) {
          if (m == 0)
            v = __ldg(z2 + o);
          else if (m == 1)
            v = __ldg(z3 + o);
          else
            v = __ldg(proj_s + o) * inv_k2 * __ldg(z3 + o);
        }
        tiles[(m - m0) * halo + i] = v;
      }
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < kAtOnce; ++m)
      vertical_sum(vert + m * vsz, tiles + m * halo, cols, k);
    __syncthreads();
#pragma unroll
    for (int m = 0; m < kAtOnce; ++m)
      s[m0 + m] = horizontal_sum(vert + m * vsz, cols, r, c, k);
  }

  const int h = h0 + r, w = w0 + c;
  if (h >= H || w >= W) return;
  const size_t o = static_cast<size_t>(b) * H * W + static_cast<size_t>(h) * W + w;
  grad[o] = (a1p[o] - s[0]) - projector[o] * s[1] + s[2];
}

template <int P>
cudaError_t launch_proj_rounds(const float* camera, const float* cam_s,
                               const float* cam_e2, const float* proj_e2,
                               const float* cost, const float* cotangent,
                               float* a1p, float* z2, float* z3, int B, int H,
                               int W, int D, int k, float eps,
                               cudaStream_t stream) {
  auto kernel = proj_grad_rounds_kernel<P>;
  const size_t bytes =
      GradRoundTile(k, 1, false, 1, P).floats() * sizeof(float);
  const cudaError_t e = allow_smem(kernel, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((W + k / 2 + kTileW - 1) / kTileW,
                  (H + kTileH - 1) / kTileH, B);
  kernel<<<grid, kThreads, bytes, stream>>>(camera, cam_s, cam_e2, proj_e2,
                                            cost, cotangent, a1p, z2, z3, H,
                                            W, D, k, eps);
  return cudaGetLastError();
}

}  // namespace
}  // namespace custereo

using namespace custereo;

// Plain C interface, loaded with ctypes.  camera/projector: [B, H, W];
// cost and cotangent: [B, D + 1, H, W]; scratch cam_s/cam_e2: [B, H, W],
// proj_s/proj_e2: [B, H, W + p] (columns -p .. W-1), a1p: [B, H, W],
// z2/z3: [B, H, W + p]; grad: [B, H, W]; all fp32, contiguous, on the
// current device.  Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 when every launch was accepted).
extern "C" int custereo_projector_grad(const float* camera,
                                       const float* projector, float* cam_s,
                                       float* cam_e2, float* proj_s,
                                       float* proj_e2, const float* cost,
                                       const float* cotangent, float* a1p,
                                       float* z2, float* z3, float* grad,
                                       int B, int H, int W, int D, int k,
                                       float eps, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int p = k / 2;
  cudaError_t e =
      launch_box_stats(camera, cam_s, cam_e2, B, H, W, k, 0, W, 1.f, stream);
  if (e != cudaSuccess) return e;
  e = launch_box_stats(projector, proj_s, proj_e2, B, H, W, k, p, W + p, 1.f,
                       stream);
  if (e != cudaSuccess) return e;

  static_assert(kGradPlanes == 8, "the planes a round instantiated below");
  size_t budget = 0;
  e = optin_floats(&budget);
  if (e != cudaSuccess) return e;
  switch (grad_round(k, D, 1, false, budget).planes) {
    case 8:
      e = launch_proj_rounds<8>(camera, cam_s, cam_e2, proj_e2, cost,
                                cotangent, a1p, z2, z3, B, H, W, D, k, eps,
                                stream);
      break;
    case 4:
      e = launch_proj_rounds<4>(camera, cam_s, cam_e2, proj_e2, cost,
                                cotangent, a1p, z2, z3, B, H, W, D, k, eps,
                                stream);
      break;
    case 2:
      e = launch_proj_rounds<2>(camera, cam_s, cam_e2, proj_e2, cost,
                                cotangent, a1p, z2, z3, B, H, W, D, k, eps,
                                stream);
      break;
    case 1:
      e = launch_proj_rounds<1>(camera, cam_s, cam_e2, proj_e2, cost,
                                cotangent, a1p, z2, z3, B, H, W, D, k, eps,
                                stream);
      break;
    default:
      // Not one plane's buffers fit beside the block's tile.
      return cudaErrorInvalidConfiguration;
  }
  if (e != cudaSuccess) return e;

  // The combine, its three maps together where their tiles fit, else one
  // at a time.
  const bool together = combine_floats(k, 3) <= budget;
  const size_t combine_bytes =
      combine_floats(k, together ? 3 : 1) * sizeof(float);
  auto combine = together ? proj_grad_combine_kernel<3>
                          : proj_grad_combine_kernel<1>;
  e = allow_smem(combine, combine_bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  combine<<<grid, kThreads, combine_bytes, stream>>>(projector, proj_s, a1p,
                                                     z2, z3, grad, H, W, k);
  return cudaGetLastError();
}
