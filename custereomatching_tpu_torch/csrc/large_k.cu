// The large-k route: the windows that no block of the rounds kernels
// (K1-K7, fused_pipeline.cuh, camera_grad.cuh, zncc_banded_proj_bwd.cu) or
// of K8's strip (zncc_allpairs.cu) holds.  From k = 129 a halo'd 16 x 64
// tile and one plane's buffers pass the 227 KB a block may hold (K8's
// strip from k = 145), and the halo alone, (k - 1)^2 floats, passes it at
// k = 239, so a smaller tile only moves the wall.  The route separates the
// window instead: one axis at a time, a line of a stack, so what a block
// stages grows with k and not with k^2, and the route takes every odd k.
//
// Replaces, where the blocks above do not fit, the same TPU kernels as the
// kernels it stands in for:
//   custereomatching_tpu/ops/pallas_zncc.py:_banded_kernel (K1),
//   custereomatching_tpu/ops/pallas_pipeline.py:_fused_kernel (K3, K3w, K3m),
//   custereomatching_tpu/ops/pallas_zncc_bwd.py:_bwd_kernel (K2, K6),
//   custereomatching_tpu/ops/pallas_pipeline.py:_fused_bwd_c_kernel (K4),
//   custereomatching_tpu/ops/pallas_pipeline.py:_fused_bwd_kernel (K5),
//   custereomatching_tpu/ops/pallas_zncc_bwd.py:_proj_bwd_kernel (K7),
//   custereomatching_tpu/ops/pallas_allpairs.py:_allpairs_kernel (K8).
//
// The kernels mirror the plain forms of ops/zncc.py step for step, and
// ops/cuda_large_k.py strings them together (each C entry is one launch):
//   box_axis        the k-tap zero-padded windowed sum along H or W of an
//                   [N, H, W] stack, taps t = 0..k-1 added in the order of
//                   _box_axis; two launches make box2d.  A block stages
//                   32 lines' tile and halo in shared memory, and a thread
//                   makes kBoxOut adjacent outputs of its line with
//                   window_sweep (common.cuh);
//   pad_square      an image stack left-extended by zero columns, and its
//                   square: box2d of the pair, then moments_finish, gives
//                   the window sum S and E2 = S2 - S S / k^2 (_image_moments);
//   band_products   a slab of planes d_lo.. of cam * proj(x - d);
//   band_cost       box2d of those products to the cost planes,
//                   (exy + eps) * rsqrt(ex2 ey2 + eps) (forward_banded);
//   online_head     K3's head over the slabs in plane order: the first
//                   maximum, s and t carried in maps between slabs, both
//                   beta branches (unnormalized_head);
//   grad_fields     gr = g r of each plane of a slab, B and GRMU summed in
//                   plane order; g read from a cotangent volume or formed
//                   from the head's maps (head_cotangent, K4 and K5);
//   grad_a1         A1 += box2d(gr) proj(x - d);
//   grad_stack /    box2d of GRMU, B mux and B, then A1 - box2d(GRMU) +
//   grad_combine    box2d(B mux) - cam box2d(B) (camera_grad_banded);
//   proj_*          the same four steps in projector columns on the
//                   extended range [-p, W) (projector_grad_banded, K7);
//   row_products    the all-pairs row products sum_j cam[h, x + j - p]
//                   proj[h, y + j - p] (_allpairs_cross): a block stages
//                   its camera and projector row segments in shared memory
//                   and a thread keeps a kRpXPer x kRpYPer tile of (x, y)
//                   in registers; then box_axis over the rows and
//                   allpairs_cost (forward_allpairs).
// Every product, sum, quotient and square root is rounded as the plain
// form rounds it (__fmul_rn and friends, which nvcc never contracts into
// an FMA; 1 / sqrt for torch.rsqrt), so only expf differs from the plain
// version in its last bits.  The window sums start from -0.f, which adds
// to the first tap exactly, and add each output's taps in order: the
// values of a loop that starts from the first tap, bit for bit.
//
// What bounds it on the H100.  The route's work is its window sums: k
// adds an output of each box_axis pass (2 k an entry of a box2d: 23.2 G
// adds for K1's volume at KITTI, k = 129) and 2 k rounded products and
// adds an entry of K8's row products; the rest are elementwise passes over
// slabs of 8 planes (15 MB at KITTI, within the 50 MB L2).  A thread
// loads kBoxOut + k - 1 staged entries for kBoxOut outputs (a row product
// tap 1 + kRpYPer loads for kRpXPer x kRpYPer pairs), so the adds, on the
// FMA pipe, bind, as utils/kernel_model.py's large_k_cost counts them.
// What keeps box_axis from that pipe's rate: window_sweep's middle loop
// issues 41 instructions for 32 adds, and a block's staging, barriers and
// stores about a fifth more again; on an H100 at 700 W its passes run at
// about 45% of the FMA pipe, the row products at about 78% (PERF.md).  A
// running or prefix sum would do less work but round otherwise; a fused
// products + rows pass for K8 is the next step.  No workload uses k > 31;
// the route exists so that every k the JAX kernels take gives a value
// here.
#include <cuda_runtime.h>

#include <cstddef>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

inline dim3 grid_for(size_t n) {
  size_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132 * 64) blocks = 132 * 64;
  if (blocks < 1) blocks = 1;
  return dim3(static_cast<unsigned>(blocks));
}

#define GRID_STRIDE(i, n)                                               \
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x +        \
                  threadIdx.x;                                          \
       i < (n); i += static_cast<size_t>(gridDim.x) * blockDim.x)

__device__ __forceinline__ float inv_sqrt(float x) {
  return __fdiv_rn(1.f, __fsqrt_rn(x));
}

// ---------------------------------------------------------------------------
// box_axis: a block is 32 lanes x kBoxGroups groups.  Lane l owns a line
// (a column for axis 0, a row of the stack for axis 1) and group g the
// line's kBoxOut adjacent outputs g kBoxOut .. g kBoxOut + kBoxOut - 1 of
// the block's tile of kBoxTile; so a block makes 32 lines x kBoxTile
// outputs.  It stages its lines' entries [tile - p, tile + kBoxTile + p)
// in shared memory, zero outside the image, kBoxSpan of a line at a time:
// one chunk for every k <= 256; a larger k walks its span in chunks, each
// output's taps still in order.
constexpr int kBoxOut = 16;
constexpr int kBoxGroups = 8;
constexpr int kBoxThreads = 32 * kBoxGroups;    // 256
constexpr int kBoxTile = kBoxOut * kBoxGroups;  // 128
constexpr int kBoxSpan = kBoxTile + 255;  // 383: 32 lines, 49,024 B
static_assert(kBoxSpan % 2 == 1, "axis 1's 32 staged lines in 32 banks");

// Entries [i0, i1) of a line's window sums, entry i to output n where 0 <=
// i - n < k, each output's taps in order: a whole line is window_sweep;
// a chunk of one predicates the taps of its first kBoxOut - 1 entries and
// of those from k on, which feed some outputs, and adds the others to all.
template <class Load>
__device__ __forceinline__ void box_entries(float (&acc)[kBoxOut], int k,
                                            int i0, int i1,
                                            const Load& load) {
  const auto add = [](float& s, float v) { s = __fadd_rn(s, v); };
  if (i0 == 0 && i1 == kBoxOut - 1 + k) {
    custereo::window_sweep(acc, k, load, add);
    return;
  }
  for (int i = i0; i < i1; ++i) {
    const float v = load(i);
    if (i >= kBoxOut - 1 && i < k) {
#pragma unroll
      for (int n = 0; n < kBoxOut; ++n) add(acc[n], v);
    } else {
#pragma unroll
      for (int n = 0; n < kBoxOut; ++n)
        if (i - n >= 0 && i - n < k) add(acc[n], v);
    }
  }
}

// Axis 0: block (plane n x column tile, strip of kBoxTile rows); lanes are
// 32 adjacent columns, so a warp's loads, staged rows and stores are
// coalesced and its shared reads hit 32 banks.
// out[n][h][w] = sum_{t<k} x[n][h + t - p][w], zero outside.
__global__ void __launch_bounds__(kBoxThreads, 4)
    box_axis_h_kernel(const float* __restrict__ x, float* __restrict__ out,
                      int H, int W, int k, int col_tiles, int strips) {
  __shared__ float buf[kBoxSpan * 32];
  const int p = k / 2, span = kBoxTile + k - 1;
  const int lane = threadIdx.x & 31, first = (threadIdx.x >> 5) * kBoxOut;
  const size_t n = blockIdx.x / col_tiles;
  const int c0 = static_cast<int>(blockIdx.x - n * col_tiles) * 32;
  const float* xn = x + n * H * W;
  float* on = out + n * H * W;
  // The lane's column (read only where in_column).
  const float* column = xn + c0 + lane;
  const bool in_column = c0 + lane < W;
  for (int s = blockIdx.y; s < strips; s += gridDim.y) {
    const int h0 = s * kBoxTile;
    float acc[kBoxOut];
#pragma unroll
    for (int m = 0; m < kBoxOut; ++m) acc[m] = -0.f;
    for (int s0 = 0; s0 < span; s0 += kBoxSpan) {
      const int rows = min(kBoxSpan, span - s0);
      __syncthreads();
      // Lane l stages column c0 + l of the chunk's rows g, g + 8, ...
      for (int r = threadIdx.x >> 5; r < rows; r += kBoxGroups) {
        const int h = h0 - p + s0 + r;
        buf[r * 32 + lane] =
            (in_column && static_cast<unsigned>(h) < static_cast<unsigned>(H))
                ? __ldg(column + static_cast<ptrdiff_t>(h) * W)
                : 0.f;
      }
      __syncthreads();
      const int i0 = max(s0 - first, 0);
      const int i1 = min(s0 + rows - first, kBoxOut - 1 + k);
      // Entry i of the group's line is staged row first + i - s0.
      const float* line = buf + (first - s0) * 32 + lane;
      if (i0 < i1 && h0 + first < H)
        box_entries(acc, k, i0, i1, [&](int i) { return line[i * 32]; });
    }
    const int c = c0 + lane;
    if (c < W) {
#pragma unroll
      for (int m = 0; m < kBoxOut; ++m) {
        const int h = h0 + first + m;
        if (h < H) on[static_cast<size_t>(h) * W + c] = acc[m];
      }
    }
  }
}

// Axis 1: block (32 rows of the stack's `rows`, column tile); lane l's row
// is staged in buf's row l, kBoxSpan (odd) floats apart, so a warp's
// reads of its 32 rows hit 32 banks; the stage goes a row at a time and
// the outputs go back through buf, so both global sides are coalesced.
// out[r][w] = sum_{t<k} x[r][w + t - p], zero outside.
__global__ void __launch_bounds__(kBoxThreads, 4)
    box_axis_w_kernel(const float* __restrict__ x, float* __restrict__ out,
                      size_t rows, int W, int k, int col_tiles) {
  __shared__ float buf[kBoxSpan * 32];
  const int p = k / 2, span = kBoxTile + k - 1;
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int first = g * kBoxOut;
  const size_t r0 = static_cast<size_t>(blockIdx.x) * 32;
  const int nrows = static_cast<int>(rows - r0 < 32 ? rows - r0 : 32);
  for (int t = blockIdx.y; t < col_tiles; t += gridDim.y) {
    const int w0 = t * kBoxTile;
    float acc[kBoxOut];
#pragma unroll
    for (int m = 0; m < kBoxOut; ++m) acc[m] = -0.f;
    for (int s0 = 0; s0 < span; s0 += kBoxSpan) {
      const int len = min(kBoxSpan, span - s0);
      __syncthreads();
      const int w_first = w0 - p + s0;
      for (int r = g; r < 32; r += kBoxGroups) {
        // Row r's entries from column w_first on (read only inside it).
        const float* src = x + (r0 + r) * W + w_first;
        const bool in_rows = r < nrows;
        for (int j = lane; j < len; j += 32)
          buf[r * kBoxSpan + j] =
              (in_rows && static_cast<unsigned>(w_first + j) <
                              static_cast<unsigned>(W))
                  ? __ldg(src + j)
                  : 0.f;
      }
      __syncthreads();
      const int i0 = max(s0 - first, 0);
      const int i1 = min(s0 + len - first, kBoxOut - 1 + k);
      // Entry i of the group's line is staged entry first + i - s0.
      const float* line = buf + lane * kBoxSpan + first - s0;
      if (i0 < i1 && w0 + first < W)
        box_entries(acc, k, i0, i1, [&](int i) { return line[i]; });
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < kBoxOut; ++m)
      buf[lane * kBoxSpan + first + m] = acc[m];
    __syncthreads();
    const int cols = min(kBoxTile, W - w0);
    for (int r = g; r < nrows; r += kBoxGroups) {
      float* orow = out + (r0 + r) * W + w0;
      for (int j = lane; j < cols; j += 32) orow[j] = buf[r * kBoxSpan + j];
    }
  }
}

// out[0][n][h][j] = img[n][h][j - left] (zero for j < left) and out[1] its
// square, j < W + left.
__global__ void pad_square_kernel(const float* __restrict__ img,
                                  float* __restrict__ out, size_t N, int H,
                                  int W, int left) {
  const int wx = W + left;
  const size_t n_all = N * H * wx;
  GRID_STRIDE(i, n_all) {
    const int j = static_cast<int>(i % wx);
    const size_t row = i / wx;
    const float v = j >= left ? __ldg(img + row * W + (j - left)) : 0.f;
    out[i] = v;
    out[n_all + i] = __fmul_rn(v, v);
  }
}

// e2 = s2 - s s / k^2, in place over s2.
__global__ void moments_finish_kernel(const float* __restrict__ s,
                                      float* __restrict__ s2, size_t n,
                                      float k2) {
  GRID_STRIDE(i, n) {
    const float a = s[i];
    s2[i] = __fsub_rn(s2[i], __fdiv_rn(__fmul_rn(a, a), k2));
  }
}

// out[b][j][h][w] = cam[b][h][w] * proj[b][h][w - d], d = d_lo + j, zero
// projector where w < d.
__global__ void band_products_kernel(const float* __restrict__ cam,
                                     const float* __restrict__ proj,
                                     float* __restrict__ out, int B, int H,
                                     int W, int d_lo, int P) {
  const size_t plane = static_cast<size_t>(H) * W;
  const size_t n_all = static_cast<size_t>(B) * P * plane;
  GRID_STRIDE(i, n_all) {
    const size_t px = i % plane;
    const int j = static_cast<int>((i / plane) % P);
    const int b = static_cast<int>(i / (plane * P));
    const int w = static_cast<int>(px % W), d = d_lo + j;
    const size_t o = static_cast<size_t>(b) * plane + px;
    const float y = w >= d ? __ldg(proj + o - d) : 0.f;
    out[i] = __fmul_rn(__ldg(cam + o), y);
  }
}

// The cost planes d_lo .. d_lo + P - 1 from their window sums sxy [B, P,
// H, W]: exy = sxy - sx sy / k^2, cost = (exy + eps) / sqrt(ex2 ey2 + eps),
// the projector's statistics on the columns extended left by D.  Written
// to plane d - out_lo of out [B, out_planes, H, W].
__global__ void band_cost_kernel(const float* __restrict__ sxy,
                                 const float* __restrict__ cam_s,
                                 const float* __restrict__ cam_e2,
                                 const float* __restrict__ proj_s,
                                 const float* __restrict__ proj_e2,
                                 float* __restrict__ out, int out_planes,
                                 int out_lo, int B, int H, int W, int D,
                                 int d_lo, int P, float k2, float eps) {
  const size_t plane = static_cast<size_t>(H) * W;
  const size_t n_all = static_cast<size_t>(B) * P * plane;
  GRID_STRIDE(i, n_all) {
    const size_t px = i % plane;
    const int j = static_cast<int>((i / plane) % P);
    const int b = static_cast<int>(i / (plane * P));
    const int w = static_cast<int>(px % W), h = static_cast<int>(px / W);
    const int d = d_lo + j;
    const size_t o = static_cast<size_t>(b) * plane + px;
    const size_t e =
        (static_cast<size_t>(b) * H + h) * (W + D) + (w - d + D);
    const float exy = __fsub_rn(
        sxy[i], __fdiv_rn(__fmul_rn(__ldg(cam_s + o), __ldg(proj_s + e)), k2));
    const float r =
        inv_sqrt(__fadd_rn(__fmul_rn(__ldg(cam_e2 + o), __ldg(proj_e2 + e)),
                           eps));
    out[(static_cast<size_t>(b) * out_planes + (d - out_lo)) * plane + px] =
        __fmul_rn(__fadd_rn(exy, eps), r);
  }
}

// The disparity head over planes d_lo .. d_lo + P - 1 of cost [B,
// cost_planes, H, W] (plane d at index d - cost_lo), continued from the
// state maps (m, am, s, t: [4, B, H, W]) unless `first`; the last slab
// writes the maps, the others the state.
__global__ void online_head_kernel(
    const float* __restrict__ cost, int cost_planes, int cost_lo,
    float* __restrict__ state, float* __restrict__ disparity,
    float* __restrict__ soft, float* __restrict__ mask,
    float* __restrict__ conf, float* __restrict__ am_out,
    float* __restrict__ s_out, float* __restrict__ t_out, int B, int H,
    int W, int d_lo, int P, float beta, float threshold, int unnormalized,
    int first, int last) {
  const size_t plane = static_cast<size_t>(H) * W;
  const size_t n_all = static_cast<size_t>(B) * plane;
  GRID_STRIDE(i, n_all) {
    const size_t px = i % plane;
    const size_t b = i / plane;
    float m = -INFINITY, am = 0.f, s = 0.f, t = 0.f;
    if (!first) {
      m = state[i];
      am = state[n_all + i];
      s = state[2 * n_all + i];
      t = state[3 * n_all + i];
    }
    // beta m, the running maximum of beta c (beta > 0 keeps the order).
    float mb = __fmul_rn(beta, m);
    for (int j = 0; j < P; ++j) {
      const int d = d_lo + j;
      const float df = static_cast<float>(d);
      const float c =
          __ldg(cost + (b * cost_planes + (d - cost_lo)) * plane + px);
      const float bc = __fmul_rn(c, beta);
      if (unnormalized) {
        const float u = expf(bc);
        s = __fadd_rn(s, u);
        t = __fadd_rn(t, __fmul_rn(u, df));
        if (c > m) {
          m = c;
          am = df;
        }
      } else if (c > m) {
        const float scale = m == -INFINITY ? 0.f : expf(__fsub_rn(mb, bc));
        s = __fadd_rn(__fmul_rn(s, scale), 1.f);
        t = __fadd_rn(__fmul_rn(t, scale), df);
        m = c;
        mb = bc;
        am = df;
      } else {
        const float e = expf(__fsub_rn(bc, mb));
        s = __fadd_rn(s, e);
        t = __fadd_rn(t, __fmul_rn(e, df));
      }
    }
    if (!last) {
      state[i] = m;
      state[n_all + i] = am;
      state[2 * n_all + i] = s;
      state[3 * n_all + i] = t;
      continue;
    }
    const float mk = m > threshold ? 1.f : 0.f;
    conf[i] = m;
    mask[i] = mk;
    disparity[i] = __fmul_rn(am, mk);
    soft[i] = __fmul_rn(__fdiv_rn(t, s), mk);
    if (am_out != nullptr) {
      am_out[i] = am;
      s_out[i] = s;
      t_out[i] = t;
    }
  }
}

// For the planes d_lo .. d_lo + P - 1 of a slab: gr_d = g_d r_d into gr
// [B, P, H, W], and, in plane order from the maps (zero when `first`),
// bm += g c r^2 ey2 and grmu += gr sy / k^2.  The cost is plane d - cost_lo
// of cost [B, cost_planes, H, W]; g is plane d of the plane-major
// cotangent g_vol [B, D + 1, H, W] or, where g_vol is null, formed from
// the head's maps (head_cotangent): gsoft mask beta w_d (d - t / s) +
// gconf [d = am], w_d = e^{beta c} / s (unnormalized) or e^{beta (c -
// conf)} / s.
__global__ void grad_fields_kernel(
    const float* __restrict__ cost, int cost_planes, int cost_lo,
    const float* __restrict__ g_vol, const float* __restrict__ am,
    const float* __restrict__ mask, const float* __restrict__ conf,
    const float* __restrict__ s_map, const float* __restrict__ t_map,
    const float* __restrict__ gsoft, const float* __restrict__ gconf,
    const float* __restrict__ cam_e2, const float* __restrict__ proj_s,
    const float* __restrict__ proj_e2, float* __restrict__ gr,
    float* __restrict__ bm, float* __restrict__ grmu, int B, int H, int W,
    int D, int d_lo, int P, float k2, float eps, float beta,
    int unnormalized, int first) {
  const size_t plane = static_cast<size_t>(H) * W;
  const size_t n_all = static_cast<size_t>(B) * plane;
  GRID_STRIDE(i, n_all) {
    const size_t px = i % plane;
    const size_t b = i / plane;
    const int w = static_cast<int>(px % W), h = static_cast<int>(px / W);
    const float ex2 = __ldg(cam_e2 + i);
    float bsum = first ? 0.f : bm[i];
    float msum = first ? 0.f : grmu[i];
    float gs = 0.f, inv_s = 0.f, tos = 0.f, gc = 0.f, amf = 0.f, cf = 0.f;
    if (g_vol == nullptr) {
      inv_s = __fdiv_rn(1.f, s_map[i]);
      tos = __fmul_rn(t_map[i], inv_s);
      gs = __fmul_rn(__fmul_rn(gsoft[i], mask[i]), beta);
      gc = gconf[i];
      amf = am[i];
      cf = conf[i];
    }
    for (int j = 0; j < P; ++j) {
      const int d = d_lo + j;
      const float c =
          __ldg(cost + (b * cost_planes + (d - cost_lo)) * plane + px);
      float g;
      if (g_vol != nullptr) {
        g = __ldg(g_vol + (b * (D + 1) + d) * plane + px);
      } else {
        const float df = static_cast<float>(d);
        const float arg =
            unnormalized ? __fmul_rn(beta, c) : __fmul_rn(beta, __fsub_rn(c, cf));
        const float wd = __fmul_rn(expf(arg), inv_s);
        g = __fadd_rn(__fmul_rn(__fmul_rn(gs, wd), __fsub_rn(df, tos)),
                      amf == df ? gc : __fmul_rn(gc, 0.f));
      }
      const size_t e = (b * H + h) * (W + D) + (w - d + D);
      const float ey2 = __ldg(proj_e2 + e);
      const float r = inv_sqrt(__fadd_rn(__fmul_rn(ex2, ey2), eps));
      const float grv = __fmul_rn(g, r);
      gr[(b * P + j) * plane + px] = grv;
      bsum = __fadd_rn(
          bsum, __fmul_rn(__fmul_rn(__fmul_rn(g, c), __fmul_rn(r, r)), ey2));
      msum = __fadd_rn(msum, __fmul_rn(grv, __fdiv_rn(__ldg(proj_s + e), k2)));
    }
    bm[i] = bsum;
    grmu[i] = msum;
  }
}

// a1 += sum_j box[b][j][h][w] * proj[b][h][w - d] over the slab's planes
// in order (from zero when `first`).
__global__ void grad_a1_kernel(const float* __restrict__ box,
                               const float* __restrict__ proj,
                               float* __restrict__ a1, int B, int H, int W,
                               int d_lo, int P, int first) {
  const size_t plane = static_cast<size_t>(H) * W;
  const size_t n_all = static_cast<size_t>(B) * plane;
  GRID_STRIDE(i, n_all) {
    const size_t px = i % plane;
    const size_t b = i / plane;
    const int w = static_cast<int>(px % W);
    float acc = first ? 0.f : a1[i];
    for (int j = 0; j < P; ++j) {
      const int d = d_lo + j;
      const float y = w >= d ? __ldg(proj + i - d) : 0.f;
      acc = __fadd_rn(acc, __fmul_rn(__ldg(box + (b * P + j) * plane + px), y));
    }
    a1[i] = acc;
  }
}

// stack [3, n]: grmu, bm sx / k^2, bm.
__global__ void grad_stack_kernel(const float* __restrict__ bm,
                                  const float* __restrict__ grmu,
                                  const float* __restrict__ cam_s,
                                  float* __restrict__ stack, size_t n,
                                  float k2) {
  GRID_STRIDE(i, n) {
    const float b = bm[i];
    stack[i] = grmu[i];
    stack[n + i] = __fmul_rn(b, __fdiv_rn(__ldg(cam_s + i), k2));
    stack[2 * n + i] = b;
  }
}

// grad = a1 - box(grmu) + box(bm mux) - cam box(bm), boxes [3, n].
__global__ void grad_combine_kernel(const float* __restrict__ a1,
                                    const float* __restrict__ boxes,
                                    const float* __restrict__ cam,
                                    float* __restrict__ grad, size_t n) {
  GRID_STRIDE(i, n) {
    grad[i] = __fsub_rn(
        __fadd_rn(__fsub_rn(a1[i], boxes[i]), boxes[n + i]),
        __fmul_rn(__ldg(cam + i), boxes[2 * n + i]));
  }
}

// K7's fields on the extended projector columns e = x + p, x in [-p, W):
// for the slab's planes, with w = x + d the camera column and `inside`
// 0 <= w < W, g~ = g[d][h][w], ex2~ = ex2[w] (zero outside), r =
// rsqrt(ex2~ ey2e[e] + eps) with ey2e the projector's second moment over
// the image widened left by p; gr~ [B, P, H, W + p] = g~ r, and in plane
// order z2 += gr~ sx[w] / k^2, z3 += g~ c~ r^2 ex2~.
__global__ void proj_fields_kernel(
    const float* __restrict__ cost, const float* __restrict__ g,
    const float* __restrict__ cam_s, const float* __restrict__ cam_e2,
    const float* __restrict__ proj_e2e, float* __restrict__ gr,
    float* __restrict__ z2, float* __restrict__ z3, int B, int H, int W,
    int D, int p, int d_lo, int P, float k2, float eps, int first) {
  const int we = W + p;
  const size_t plane = static_cast<size_t>(H) * W;
  const size_t eplane = static_cast<size_t>(H) * we;
  const size_t n_all = static_cast<size_t>(B) * eplane;
  GRID_STRIDE(i, n_all) {
    const int e = static_cast<int>(i % we);
    const size_t b = i / eplane;
    const int h = static_cast<int>((i / we) % H);
    const float ey2 = __ldg(proj_e2e + i);
    float a = first ? 0.f : z2[i];
    float c3 = first ? 0.f : z3[i];
    for (int j = 0; j < P; ++j) {
      const int d = d_lo + j;
      const int w = e - p + d;
      const bool inside = w >= 0 && w < W;
      const size_t o = b * plane + static_cast<size_t>(h) * W + w;
      const size_t v = (b * (D + 1) + d) * plane + static_cast<size_t>(h) * W + w;
      const float gs = inside ? __ldg(g + v) : 0.f;
      const float cs = inside ? __ldg(cost + v) : 0.f;
      const float ex2 = inside ? __ldg(cam_e2 + o) : 0.f;
      const float mux = inside ? __fdiv_rn(__ldg(cam_s + o), k2) : 0.f;
      const float r = inv_sqrt(__fadd_rn(__fmul_rn(ex2, ey2), eps));
      const float grv = __fmul_rn(gs, r);
      gr[(b * P + j) * eplane + (i - b * eplane)] = grv;
      a = __fadd_rn(a, __fmul_rn(grv, mux));
      c3 = __fadd_rn(c3, __fmul_rn(__fmul_rn(__fmul_rn(gs, cs), __fmul_rn(r, r)),
                                   ex2));
    }
    z2[i] = a;
    z3[i] = c3;
  }
}

// a1p += sum_j cam~ box(gr~)_j over the slab's planes in order, cam~ =
// cam[e - p + d] inside the image, else zero.
__global__ void proj_a1_kernel(const float* __restrict__ box,
                               const float* __restrict__ cam,
                               float* __restrict__ a1p, int B, int H, int W,
                               int p, int d_lo, int P, int first) {
  const int we = W + p;
  const size_t plane = static_cast<size_t>(H) * W;
  const size_t eplane = static_cast<size_t>(H) * we;
  const size_t n_all = static_cast<size_t>(B) * eplane;
  GRID_STRIDE(i, n_all) {
    const int e = static_cast<int>(i % we);
    const size_t b = i / eplane;
    const int h = static_cast<int>((i / we) % H);
    float acc = first ? 0.f : a1p[i];
    for (int j = 0; j < P; ++j) {
      const int w = e - p + d_lo + j;
      const float c = (w >= 0 && w < W)
                          ? __ldg(cam + b * plane + static_cast<size_t>(h) * W + w)
                          : 0.f;
      acc = __fadd_rn(acc, __fmul_rn(c, __ldg(box + (b * P + j) * eplane +
                                                  (i - b * eplane))));
    }
    a1p[i] = acc;
  }
}

// stack [3, n]: z2, sy~ / k^2 z3, z3 (n = B H (W + p)).
__global__ void proj_stack_kernel(const float* __restrict__ z2,
                                  const float* __restrict__ z3,
                                  const float* __restrict__ proj_se,
                                  float* __restrict__ stack, size_t n,
                                  float k2) {
  GRID_STRIDE(i, n) {
    const float c = z3[i];
    stack[i] = z2[i];
    stack[n + i] = __fmul_rn(__fdiv_rn(__ldg(proj_se + i), k2), c);
    stack[2 * n + i] = c;
  }
}

// grad[b][h][x] = a1p - box(z2) - proj box(z3) + box(sy~ z3 / k^2), each
// box read at e = x + p.
__global__ void proj_combine_kernel(const float* __restrict__ a1p,
                                    const float* __restrict__ boxes,
                                    const float* __restrict__ proj,
                                    float* __restrict__ grad, int B, int H,
                                    int W, int p) {
  const int we = W + p;
  const size_t n = static_cast<size_t>(B) * H * we;
  const size_t n_all = static_cast<size_t>(B) * H * W;
  GRID_STRIDE(i, n_all) {
    const int x = static_cast<int>(i % W);
    const size_t row = i / W;
    const size_t e = row * we + x + p;
    grad[i] = __fadd_rn(
        __fsub_rn(__fsub_rn(a1p[e], boxes[e]),
                  __fmul_rn(__ldg(proj + i), boxes[2 * n + e])),
        boxes[n + e]);
  }
}

// ---------------------------------------------------------------------------
// row_products: block (y tile, x tile, image row (b, h)) of kRpWarps warps.
// A warp's lanes are 32 adjacent y, each with kRpYPer of them 32 apart,
// and the warp kRpXPer adjacent x, so a thread holds kRpXPer x kRpYPer
// sums.  The block stages its camera columns [x0 - p, x0 + kRpTileX + p)
// and projector columns [y0 - p, y0 + kRpTileY + p) of the row, zero
// outside it, kRpTaps taps at a time (one chunk for every k <= 256); a
// tap loads one camera entry (the warp's window slid by one: a broadcast)
// and kRpYPer projector entries (32 banks), then makes kRpXPer x kRpYPer
// products and adds.  A warp stores 32 neighbouring y of one (h, x).
constexpr int kRpWarps = 2;
constexpr int kRpXPer = 8;
constexpr int kRpYPer = 2;
constexpr int kRpThreads = 32 * kRpWarps;     // 64
constexpr int kRpTileX = kRpWarps * kRpXPer;  // 16
constexpr int kRpTileY = 32 * kRpYPer;        // 64
constexpr int kRpTaps = 256;

// out[r][x][y] = sum_{j<k} cam[r][x + j - p] proj[r][y + j - p] over the
// rows r = (b, h) of the stack, zero outside the row, each product rounded
// and added from j = 0.
__global__ void __launch_bounds__(kRpThreads)
    row_products_kernel(const float* __restrict__ cam,
                        const float* __restrict__ proj,
                        float* __restrict__ out, size_t rows, int W, int k) {
  __shared__ float cs[kRpTileX + kRpTaps - 1];
  __shared__ float ps[kRpTileY + kRpTaps - 1];
  const int p = k / 2;
  const int lane = threadIdx.x & 31, xl = (threadIdx.x >> 5) * kRpXPer;
  const int y0 = blockIdx.x * kRpTileY, x0 = blockIdx.y * kRpTileX;
  for (size_t r = blockIdx.z; r < rows; r += gridDim.z) {
    const float* crow = cam + r * W;
    const float* prow = proj + r * W;
    float acc[kRpXPer][kRpYPer];
#pragma unroll
    for (int a = 0; a < kRpXPer; ++a)
#pragma unroll
      for (int c = 0; c < kRpYPer; ++c) acc[a][c] = -0.f;
    for (int j0 = 0; j0 < k; j0 += kRpTaps) {
      const int taps = min(kRpTaps, k - j0);
      __syncthreads();
#pragma unroll 4
      for (int e = threadIdx.x; e < kRpTileX + taps - 1; e += kRpThreads) {
        const int c = x0 - p + j0 + e;
        cs[e] = (c >= 0 && c < W) ? __ldg(crow + c) : 0.f;
      }
#pragma unroll 4
      for (int e = threadIdx.x; e < kRpTileY + taps - 1; e += kRpThreads) {
        const int c = y0 - p + j0 + e;
        ps[e] = (c >= 0 && c < W) ? __ldg(prow + c) : 0.f;
      }
      __syncthreads();
      // Tap j reads camera entries cs[xl + j .. xl + j + kRpXPer - 1]: the
      // window of tap j - 1 moved on by one.
      float cv[kRpXPer];
#pragma unroll
      for (int a = 1; a < kRpXPer; ++a) cv[a] = cs[xl + a - 1];
#pragma unroll 8
      for (int j = 0; j < taps; ++j) {
#pragma unroll
        for (int a = 0; a + 1 < kRpXPer; ++a) cv[a] = cv[a + 1];
        cv[kRpXPer - 1] = cs[xl + j + kRpXPer - 1];
        float pv[kRpYPer];
#pragma unroll
        for (int c = 0; c < kRpYPer; ++c) pv[c] = ps[lane + 32 * c + j];
#pragma unroll
        for (int a = 0; a < kRpXPer; ++a)
#pragma unroll
          for (int c = 0; c < kRpYPer; ++c)
            acc[a][c] = __fadd_rn(acc[a][c], __fmul_rn(cv[a], pv[c]));
      }
    }
#pragma unroll
    for (int a = 0; a < kRpXPer; ++a) {
      const int xx = x0 + xl + a;
      if (xx >= W) continue;
      float* orow = out + (r * W + xx) * W;
#pragma unroll
      for (int c = 0; c < kRpYPer; ++c) {
        const int y = y0 + lane + 32 * c;
        if (y < W) orow[y] = acc[a][c];
      }
    }
  }
}

// out = (A - sx[x] sy[y] / k^2 + eps) / sqrt(ex2[x] ey2[y] + eps).
__global__ void allpairs_cost_kernel(const float* __restrict__ a,
                                     const float* __restrict__ cam_s,
                                     const float* __restrict__ cam_e2,
                                     const float* __restrict__ proj_s,
                                     const float* __restrict__ proj_e2,
                                     float* __restrict__ out, int B, int H,
                                     int W, float k2, float eps) {
  const size_t n_all = static_cast<size_t>(B) * H * W * W;
  GRID_STRIDE(i, n_all) {
    const int y = static_cast<int>(i % W);
    const size_t row_x = i / W;               // (b, h, x)
    const size_t row = row_x / W;             // (b, h)
    const size_t ox = row_x, oy = row * W + y;
    const float exy = __fsub_rn(
        a[i], __fdiv_rn(__fmul_rn(__ldg(cam_s + ox), __ldg(proj_s + oy)), k2));
    const float r = inv_sqrt(
        __fadd_rn(__fmul_rn(__ldg(cam_e2 + ox), __ldg(proj_e2 + oy)), eps));
    out[i] = __fmul_rn(__fadd_rn(exy, eps), r);
  }
}

}  // namespace

// Plain C interface, loaded with ctypes: one launch an entry, on `stream`,
// no synchronisation; each returns cudaGetLastError().  Every tensor is
// fp32, contiguous, on the current device; shapes as the kernels above.
#define LAUNCH(kernel, n, ...)                                           \
  kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>( \
      __VA_ARGS__);                                                      \
  return cudaGetLastError()

// Grid dimensions y and z hold at most 65,535 blocks; the kernels loop
// over the rest.
inline unsigned grid_yz(size_t n) {
  return static_cast<unsigned>(n < 65535 ? n : 65535);
}

extern "C" int custereo_lk_box_axis(const float* x, float* out, long long N,
                                    int H, int W, int k, int axis,
                                    void* stream) {
  if (N <= 0 || H <= 0 || W <= 0) return cudaGetLastError();
  const auto st = static_cast<cudaStream_t>(stream);
  if (axis == 0) {
    const int col_tiles = (W + 31) / 32;
    const int strips = (H + kBoxTile - 1) / kBoxTile;
    box_axis_h_kernel<<<dim3(static_cast<unsigned>(N * col_tiles),
                             grid_yz(strips)),
                        kBoxThreads, 0, st>>>(x, out, H, W, k, col_tiles,
                                              strips);
  } else {
    const size_t rows = static_cast<size_t>(N) * H;
    const int col_tiles = (W + kBoxTile - 1) / kBoxTile;
    box_axis_w_kernel<<<dim3(static_cast<unsigned>((rows + 31) / 32),
                             grid_yz(col_tiles)),
                        kBoxThreads, 0, st>>>(x, out, rows, W, k, col_tiles);
  }
  return cudaGetLastError();
}

extern "C" int custereo_lk_pad_square(const float* img, float* out,
                                      long long N, int H, int W, int left,
                                      void* stream) {
  LAUNCH(pad_square_kernel, static_cast<size_t>(N) * H * (W + left), img,
         out, static_cast<size_t>(N), H, W, left);
}

extern "C" int custereo_lk_moments_finish(const float* s, float* s2,
                                          long long n, float k2,
                                          void* stream) {
  LAUNCH(moments_finish_kernel, static_cast<size_t>(n), s, s2,
         static_cast<size_t>(n), k2);
}

extern "C" int custereo_lk_band_products(const float* cam, const float* proj,
                                         float* out, int B, int H, int W,
                                         int d_lo, int P, void* stream) {
  LAUNCH(band_products_kernel, static_cast<size_t>(B) * P * H * W, cam, proj,
         out, B, H, W, d_lo, P);
}

extern "C" int custereo_lk_band_cost(const float* sxy, const float* cam_s,
                                     const float* cam_e2, const float* proj_s,
                                     const float* proj_e2, float* out,
                                     int out_planes, int out_lo, int B, int H,
                                     int W, int D, int d_lo, int P, float k2,
                                     float eps, void* stream) {
  LAUNCH(band_cost_kernel, static_cast<size_t>(B) * P * H * W, sxy, cam_s,
         cam_e2, proj_s, proj_e2, out, out_planes, out_lo, B, H, W, D, d_lo,
         P, k2, eps);
}

extern "C" int custereo_lk_online_head(
    const float* cost, int cost_planes, int cost_lo, float* state,
    float* disparity, float* soft, float* mask, float* conf, float* am,
    float* s, float* t, int B, int H, int W, int d_lo, int P, float beta,
    float threshold, int unnormalized, int first, int last, void* stream) {
  LAUNCH(online_head_kernel, static_cast<size_t>(B) * H * W, cost,
         cost_planes, cost_lo, state, disparity, soft, mask, conf, am, s, t,
         B, H, W, d_lo, P, beta, threshold, unnormalized, first, last);
}

extern "C" int custereo_lk_grad_fields(
    const float* cost, int cost_planes, int cost_lo, const float* g_vol,
    const float* am, const float* mask, const float* conf, const float* s,
    const float* t, const float* gsoft, const float* gconf,
    const float* cam_e2, const float* proj_s, const float* proj_e2,
    float* gr, float* bm, float* grmu, int B, int H, int W, int D, int d_lo,
    int P, float k2, float eps, float beta, int unnormalized, int first,
    void* stream) {
  LAUNCH(grad_fields_kernel, static_cast<size_t>(B) * H * W, cost,
         cost_planes, cost_lo, g_vol, am, mask, conf, s, t, gsoft, gconf,
         cam_e2, proj_s, proj_e2, gr, bm, grmu, B, H, W, D, d_lo, P, k2, eps,
         beta, unnormalized, first);
}

extern "C" int custereo_lk_grad_a1(const float* box, const float* proj,
                                   float* a1, int B, int H, int W, int d_lo,
                                   int P, int first, void* stream) {
  LAUNCH(grad_a1_kernel, static_cast<size_t>(B) * H * W, box, proj, a1, B,
         H, W, d_lo, P, first);
}

extern "C" int custereo_lk_grad_stack(const float* bm, const float* grmu,
                                      const float* cam_s, float* stack,
                                      long long n, float k2, void* stream) {
  LAUNCH(grad_stack_kernel, static_cast<size_t>(n), bm, grmu, cam_s, stack,
         static_cast<size_t>(n), k2);
}

extern "C" int custereo_lk_grad_combine(const float* a1, const float* boxes,
                                        const float* cam, float* grad,
                                        long long n, void* stream) {
  LAUNCH(grad_combine_kernel, static_cast<size_t>(n), a1, boxes, cam, grad,
         static_cast<size_t>(n));
}

extern "C" int custereo_lk_proj_fields(
    const float* cost, const float* g, const float* cam_s,
    const float* cam_e2, const float* proj_e2e, float* gr, float* z2,
    float* z3, int B, int H, int W, int D, int p, int d_lo, int P, float k2,
    float eps, int first, void* stream) {
  LAUNCH(proj_fields_kernel, static_cast<size_t>(B) * H * (W + p), cost, g,
         cam_s, cam_e2, proj_e2e, gr, z2, z3, B, H, W, D, p, d_lo, P, k2, eps,
         first);
}

extern "C" int custereo_lk_proj_a1(const float* box, const float* cam,
                                   float* a1p, int B, int H, int W, int p,
                                   int d_lo, int P, int first, void* stream) {
  LAUNCH(proj_a1_kernel, static_cast<size_t>(B) * H * (W + p), box, cam, a1p,
         B, H, W, p, d_lo, P, first);
}

extern "C" int custereo_lk_proj_stack(const float* z2, const float* z3,
                                      const float* proj_se, float* stack,
                                      long long n, float k2, void* stream) {
  LAUNCH(proj_stack_kernel, static_cast<size_t>(n), z2, z3, proj_se, stack,
         static_cast<size_t>(n), k2);
}

extern "C" int custereo_lk_proj_combine(const float* a1p, const float* boxes,
                                        const float* proj, float* grad, int B,
                                        int H, int W, int p, void* stream) {
  LAUNCH(proj_combine_kernel, static_cast<size_t>(B) * H * W, a1p, boxes,
         proj, grad, B, H, W, p);
}

extern "C" int custereo_lk_row_products(const float* cam, const float* proj,
                                        float* out, int B, int H, int W,
                                        int k, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return cudaGetLastError();
  const size_t rows = static_cast<size_t>(B) * H;
  row_products_kernel<<<dim3((W + kRpTileY - 1) / kRpTileY,
                             (W + kRpTileX - 1) / kRpTileX, grid_yz(rows)),
                        kRpThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      cam, proj, out, rows, W, k);
  return cudaGetLastError();
}

extern "C" int custereo_lk_allpairs_cost(const float* a, const float* cam_s,
                                         const float* cam_e2,
                                         const float* proj_s,
                                         const float* proj_e2, float* out,
                                         int B, int H, int W, float k2,
                                         float eps, void* stream) {
  LAUNCH(allpairs_cost_kernel, static_cast<size_t>(B) * H * W * W, a, cam_s,
         cam_e2, proj_s, proj_e2, out, B, H, W, k2, eps);
}
