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
//   1. proj_grad_planes_kernel: one block per kTileH x kTileW tile of the
//      extended columns walks d = 0..D.  Per plane it forms g~_d r over the
//      halo'd tile in shared memory, box-sums it (rows, then columns) for
//      A1p, and accumulates A1p, z2 and z3 of its own pixels in registers;
//      the projector's ey2 over the halo is staged once (it does not
//      shift).  It writes A1p [B, H, W] and z2, z3 [B, H, W + p] once.
//   2. proj_grad_combine_kernel: the three box filters on the extended
//      columns and the final sum.
//
// What bounds it on the H100: it reads two volumes, g and c (720 MB a
// KITTI frame, about 0.21 ms at 3.35 TB/s), and is otherwise bound, as K1
// and K2, by the per-plane row and column passes in shared memory and
// three barriers a plane.
#include "camera_grad.cuh"

namespace custereo {
namespace {

// Grid: (ceil((W + p) / kTileW), ceil(H / kTileH), B); kThreads threads;
// dynamic shared memory GradTile(k).floats(0) floats: the projector's ey2
// and the g~r plane over the halo'd tile, then the rows pass.
__global__ void __launch_bounds__(kThreads)
    proj_grad_planes_kernel(const float* __restrict__ camera,
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
  const GradTile t(k);
  const int halo = t.halo();
  float* ey2_t = smem;
  float* gr_t = ey2_t + halo;
  float* vsum = gr_t + halo;

  const int p = t.p, we = W + p;
  const int b = blockIdx.z, h0 = blockIdx.y * kTileH, e0 = blockIdx.x * kTileW;
  const size_t plane = static_cast<size_t>(H) * W;
  const size_t frame = static_cast<size_t>(b) * plane;
  const size_t ext_frame = static_cast<size_t>(b) * H * we;
  const float* g_b = g + static_cast<size_t>(b) * (D + 1) * plane;
  const float* c_b = cost + static_cast<size_t>(b) * (D + 1) * plane;

  // Halo entry (rr, cc) is row h0 - p + rr and extended column
  // e0 - p + cc (projector column x = e - p).  ey2 is needed at
  // e in [0, W + p); entries outside hold 0 and are never used.
  for (int i = threadIdx.x; i < halo; i += blockDim.x) {
    const int rr = i / t.cam_w, cc = i - rr * t.cam_w;
    const int y = h0 - p + rr, e = e0 - p + cc;
    const bool inside = y >= 0 && y < H && e >= 0 && e < we;
    ey2_t[i] = inside
                   ? __ldg(proj_e2 + ext_frame + static_cast<size_t>(y) * we + e)
                   : 0.f;
  }

  const int r = threadIdx.x / kTileW, c = threadIdx.x % kTileW;
  const int h = h0 + r, e = e0 + c, x = e - p;
  const bool valid = h < H && e < we;
  const int centre = (r + p) * t.cam_w + c + p;
  const float inv_k2 = 1.f / static_cast<float>(k * k);
  float a1 = 0.f, z2 = 0.f, z3 = 0.f;
  __syncthreads();

  for (int d = 0; d <= D; ++d) {
    const float* g_d = g_b + d * plane;
    for (int i = threadIdx.x; i < halo; i += blockDim.x) {
      const int rr = i / t.cam_w, cc = i - rr * t.cam_w;
      const int y = h0 - p + rr, ei = e0 - p + cc;
      const int w = ei - p + d;   // camera column of this entry
      float v = 0.f;
      if (y >= 0 && y < H && ei >= 0 && w >= 0 && w < W) {
        const size_t px = static_cast<size_t>(y) * W + w;
        v = __ldg(g_d + px) *
            rsqrtf(__ldg(cam_e2 + frame + px) * ey2_t[i] + eps);
      }
      gr_t[i] = v;
    }
    __syncthreads();
    vertical_sum(vsum, gr_t, t.cam_w, k);
    __syncthreads();
    if (valid) {
      const int w = x + d;
      if (x >= 0) {
        const float box = horizontal_sum(vsum, t.cam_w, r, c, k);
        const float cm =
            w < W ? __ldg(camera + frame + static_cast<size_t>(h) * W + w)
                  : 0.f;
        a1 = fmaf(box, cm, a1);
      }
      if (w >= 0 && w < W) {
        const size_t px = static_cast<size_t>(h) * W + w;
        const float gr = gr_t[centre];
        const float e2 = __ldg(cam_e2 + frame + px);
        const float rc = rsqrtf(e2 * ey2_t[centre] + eps);
        z2 = fmaf(gr, __ldg(cam_s + frame + px) * inv_k2, z2);
        z3 = fmaf(gr * __ldg(c_b + d * plane + px), rc * e2, z3);
      }
    }
    __syncthreads();
  }

  if (!valid) return;
  if (x >= 0) a1p_out[frame + static_cast<size_t>(h) * W + x] = a1;
  const size_t o = ext_frame + static_cast<size_t>(h) * we + e;
  z2_out[o] = z2;
  z3_out[o] = z3;
}

// grad = A1p - box(z2) - proj * box(z3) + box(muy z3), the boxes over the
// extended columns e in [0, W + p) and rows [0, H), reading zeros outside;
// output column x sits at e = x + p.  muy comes from the widened
// projector statistics (index e).  Grid: (ceil(W / kTileW),
// ceil(H / kTileH), B); dynamic shared memory 3 * (rows * cols +
// kTileH * cols) floats.
__global__ void __launch_bounds__(kThreads)
    proj_grad_combine_kernel(const float* __restrict__ projector,
                             const float* __restrict__ proj_s,
                             const float* __restrict__ a1p,
                             const float* __restrict__ z2,
                             const float* __restrict__ z3,
                             float* __restrict__ grad, int H, int W, int k) {
  extern __shared__ float smem[];
  const int p = k / 2, rows = kTileH + 2 * p, cols = kTileW + 2 * p;
  const int halo = rows * cols, vsz = kTileH * cols, we = W + p;
  float* t_z2 = smem;
  float* t_z3 = t_z2 + halo;
  float* t_mz = t_z3 + halo;
  float* v_z2 = t_mz + halo;
  float* v_z3 = v_z2 + vsz;
  float* v_mz = v_z3 + vsz;
  const int b = blockIdx.z, h0 = blockIdx.y * kTileH, w0 = blockIdx.x * kTileW;
  const size_t ext_frame = static_cast<size_t>(b) * H * we;
  const float inv_k2 = 1.f / static_cast<float>(k * k);

  // Halo entry (rr, cc) is row h0 - p + rr, extended column w0 + cc.
  for (int i = threadIdx.x; i < halo; i += blockDim.x) {
    const int rr = i / cols, cc = i - rr * cols;
    const int y = h0 - p + rr, e = w0 + cc;
    float a = 0.f, s = 0.f, m = 0.f;
    if (y >= 0 && y < H && e < we) {
      const size_t o = ext_frame + static_cast<size_t>(y) * we + e;
      a = __ldg(z2 + o);
      s = __ldg(z3 + o);
      m = __ldg(proj_s + o) * inv_k2 * s;
    }
    t_z2[i] = a;
    t_z3[i] = s;
    t_mz[i] = m;
  }
  __syncthreads();
  vertical_sum(v_z2, t_z2, cols, k);
  vertical_sum(v_z3, t_z3, cols, k);
  vertical_sum(v_mz, t_mz, cols, k);
  __syncthreads();

  const int r = threadIdx.x / kTileW, c = threadIdx.x % kTileW;
  const int h = h0 + r, w = w0 + c;
  if (h >= H || w >= W) return;
  const size_t o = static_cast<size_t>(b) * H * W + static_cast<size_t>(h) * W + w;
  const float s_z2 = horizontal_sum(v_z2, cols, r, c, k);
  const float s_z3 = horizontal_sum(v_z3, cols, r, c, k);
  const float s_mz = horizontal_sum(v_mz, cols, r, c, k);
  grad[o] = (a1p[o] - s_z2) - projector[o] * s_z3 + s_mz;
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

  const size_t bytes = GradTile(k).floats(0) * sizeof(float);
  e = allow_smem(proj_grad_planes_kernel, bytes);
  if (e != cudaSuccess) return e;
  const dim3 planes_grid((W + p + kTileW - 1) / kTileW,
                         (H + kTileH - 1) / kTileH, B);
  proj_grad_planes_kernel<<<planes_grid, kThreads, bytes, stream>>>(
      camera, cam_s, cam_e2, proj_e2, cost, cotangent, a1p, z2, z3, H, W, D,
      k, eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const size_t cols = kTileW + 2 * p;
  const size_t combine_bytes =
      sizeof(float) * 3 * ((kTileH + 2 * p) * cols + kTileH * cols);
  e = allow_smem(proj_grad_combine_kernel, combine_bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  proj_grad_combine_kernel<<<grid, kThreads, combine_bytes, stream>>>(
      projector, proj_s, a1p, z2, z3, grad, H, W, k);
  return cudaGetLastError();
}
