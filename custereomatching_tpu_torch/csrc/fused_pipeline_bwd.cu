// K4 and K5: the backward of the trainable fused pipeline on Hopper, with
// the forward cost volume (written by K3w) as a residual (K4) or without
// it (K5, after the volume-free forward K3m).
//
// Replaces: custereomatching_tpu/ops/pallas_pipeline.py:_fused_bwd_c_kernel
// (K4, driven by _fused_train_bwd_c_impl) and _fused_bwd_kernel (K5,
// driven by _fused_train_bwd_impl).  The cost-volume cotangent is never
// materialised: each plane's g_d is formed from per-pixel maps of the head,
//   g_d = gs_hat mask beta w_d (d - t/s) + gc_hat 1[d = am]
//   w_d = e^{beta c_d} / s            (unnormalized head)
//       = e^{beta (c_d - conf)} / s   (rescaled head, s relative to e^m)
// where gs_hat and gc_hat are the cotangents of the soft disparity and the
// confidence map.  The gradient of the confidence goes to the first argmax
// only, as the Pallas kernel's 1[d = am] does.  1/s, t/s, gs_hat mask
// beta, gc_hat, am and conf are staged once a tile in shared memory, zero
// outside the image, as _fused_bwd_c_kernel derives them once per row
// tile.
//
// K4 is camera_grad.cuh's rounds kernel with HeadSource: K5's round
// without the cost recompute, the cost read from K3w's plane-major volume
// at every halo entry.  A round of P planes forms g_d and gr_d at the
// halo's entries (each entry's seven constants read once a round, its P
// planes of cost and ey2 loaded before the first is used; the tile's own
// pixels also add B and GRMU), then gr's rows pass and column sums, then
// A1, behind four barriers where the first version had three a plane.  At
// k = 15, D = 192: P = 8, the constants (7 x 30 x 78) and 8 planes of the
// two buffers (30 x 79 + 16 x 79): 45,452 floats = 181,808 bytes, one
// 1024-thread block an SM.  A larger k takes P = 4, 2 or 1; at P = 1 the
// block fits up to k = 47 (56,398 floats).  Past that the constants stay
// in their maps (HeadSource<kUnnormalized, false>): every entry reads its
// seven from global memory once a round, and one plane's buffers, 30,178
// floats at k = 127, fit; the values are the staged route's.
//
// K5 recomputes the cost at every pixel of the halo'd 30 x 78 tile (k =
// 15), since g_d needs it there, in a kernel of its own on the
// register-blocked pass of common.cuh, in rounds of P planes.  A round:
//   1. the cross term's rows pass over the halo'd rows (30 x 92 at k = 15;
//      an item 15 rows of one column and plane from 2 (14 + k) loads);
//   2. its column sums at every halo entry (an item 13 entries of a row
//      from 12 + k loads);
//   3. each thread, for the halo entries it owns (entry i = thread +
//      n 1024, at most kHaloOwn = 4), reads the entry's eight constants
//      (ex2, mux and the six head maps) once and, plane by plane, forms
//      r_d, c_d = (sxy - mux sy + eps) r_d, g_d and gr_d = g_d r_d, which
//      overwrites the sum in place; where the entry is one of the tile's
//      own pixels it adds that pixel's B and GRMU terms in registers from
//      the same c_d and r_d (the first version recomputed both there);
//   4. gr's rows pass (an item 8 output rows of one column and plane);
//   5. its column sums (an item 8 pixels of a row);
//   6. each pixel's thread adds box(gr_d) proj(. - d) to A1 in plane order.
// Six barriers a round, one more when the projector chunk is restaged,
// where the first version had four a plane.  Every output sums its taps
// in the order the first version did, so the values are unchanged; B and
// GRMU of a pixel are added plane by plane by the thread that owns its
// halo entry, in plane order.  Shared memory at k = 15, D = 192: the
// entries' constants (8 x 30 x 78), the camera tile 44 x 92, the
// projector tile 44 x (92 + 124) for chunks of 125 planes, and P = 5
// planes of the round's two buffers (the cross term's rows pass, then
// gr's; the entries' sums, then gr, then gr's box sums: 2,790 + 2,370
// floats with the rows padded to an odd stride for the banks): 58,072
// floats = 232,288 bytes, one 1024-thread block an SM; the projector is
// staged twice a frame.  P is what gives each thread about one rows-pass
// item (1024 / (92 x 2)); the chunk takes the rest.  At one plane a round
// and a chunk the block needs 54,752 floats at k = 27 and 59,080 at k =
// 29, and from k = 31 the halo has more entries than kHaloOwn a thread.
// Where it does not fit K5 takes camera_grad.cuh's chunked route: K1's
// costs of kCostChunk planes at a time in a slab, K4's rounds kernel on
// each slab, so its gradient is K4's on K1's volume, which this kernel's
// recompute gives too; the volume is never whole.
//
// What bounds it on the H100: K4 reads one volume, the cost (360 MB a
// KITTI frame, about 0.11 ms at 3.35 TB/s); per plane and halo pixel it
// adds one exp to K6's work without the recompute.  K5 reads no volume;
// it does K1's per-plane cross-term work over 2.2 times K1's region.  The
// least work of its function, one cost, head cotangent and VJP body an
// entry (about 4k + 25 flops with the k x k window sums taken separably),
// puts its floor at 0.11 ms a KITTI frame at 67 TFLOP/s.  Otherwise as K6
// (camera_grad.cuh).
#include "head_rounds.cuh"

namespace custereo {
namespace {

// K5's register blocking: outputs an item of the cross term's rows pass
// (kHaloRows) and of its column sums (kHaloCols; gr's passes are
// camera_grad.cuh's, kGradRows and kGradCols); the halo entries a thread
// owns (kHaloOwn: the halo'd tile at k = 27 has 3,780); the constants
// staged an entry (ex2, mux and HeadSource's six maps).
constexpr int kHaloRows = 15;
constexpr int kHaloCols = 13;
constexpr int kHaloOwn = 4;
constexpr int kHaloConsts = 8;

// Shared-memory geometry of K5, in floats: the entries' constants
// (kHaloConsts x halo), the camera tile (img_rows x img_w), the projector
// tile widened left by chunk - 1 columns (img_rows x proj_w), then
// `planes` planes of buffer X (the cross term's rows pass, halo_rows x
// xs; then gr's, kTileH x vs) and of buffer Y (the entries' sums and then
// their gr, halo_rows x ys; then gr's box sums, kTileH x bs).  Row
// strides are odd, so a warp's 32 rows hit 32 banks.
struct HaloTile {
  int p, halo_rows, halo_cols, halo, img_rows, img_w, chunk, proj_w;
  int xs, ys, vs, bs, xsz, ysz, planes;
  __host__ __device__ HaloTile(int k, int chunk, int planes)
      : p(k / 2),
        halo_rows(kTileH + 2 * (k / 2)),
        halo_cols(kTileW + 2 * (k / 2)),
        halo(halo_rows * halo_cols),
        img_rows(kTileH + 4 * (k / 2)),
        img_w(kTileW + 4 * (k / 2)),
        chunk(chunk),
        proj_w(img_w + chunk - 1),
        xs(img_w + 1),
        ys(halo_cols + 1),
        vs(halo_cols + 1),
        bs(kTileW + 1),
        xsz(halo_rows * xs > kTileH * vs ? halo_rows * xs : kTileH * vs),
        ysz(halo_rows * ys > kTileH * bs ? halo_rows * ys : kTileH * bs),
        planes(planes) {}
  __host__ __device__ int row_groups() const {
    return (halo_rows + kHaloRows - 1) / kHaloRows;
  }
  __host__ __device__ size_t fixed_floats() const {
    return static_cast<size_t>(kHaloConsts) * halo +
           static_cast<size_t>(img_rows) * img_w;
  }
  __host__ __device__ size_t floats() const {
    return fixed_floats() + static_cast<size_t>(img_rows) * proj_w +
           static_cast<size_t>(planes) * (xsz + ysz);
  }
  // Where gr's passes (camera_grad.cuh) find buffers Y and X.
  __host__ __device__ GradStrides grad() const {
    return {halo_cols, ys, ysz, vs, xsz, bs};
  }
};

// Planes a round and a projector staging of K5 within `budget` floats:
// as many planes a round as give each thread one rows-pass item, fewer if
// they do not fit beside one plane's projector tile; the projector chunk
// takes what is left, a multiple of the round; {0, 0} when not one plane
// fits.
inline Rounds halo_round(int k, int D, size_t budget) {
  const HaloTile one(k, 1, 1);
  const size_t fixed = one.fixed_floats();
  const size_t proj1 = static_cast<size_t>(one.img_rows) * one.proj_w;
  const size_t per = static_cast<size_t>(one.xsz) + one.ysz;
  if (fixed + proj1 + per > budget) return {0, 0};
  int planes = kThreads / (one.img_w * one.row_groups());
  if (planes < 1) planes = 1;
  if (planes > D + 1) planes = D + 1;
  if (fixed + proj1 + planes * per > budget)
    planes = static_cast<int>((budget - fixed - proj1) / per);
  return whole_rounds(
      planes,
      staging_chunk(D, fixed + planes * per, proj1, one.img_rows, budget), D);
}

// 1. The cross term's rows pass of `np` planes over the halo'd rows:
// X[j][r][c] = sum_{t<k} cam_x[r + t][c] * proj_x[r + t][c + shift0 - j].
// An item is kHaloRows rows of one column and plane.
__device__ inline void halo_products(float* xbuf, const float* cam_x,
                                     const float* proj_x, const HaloTile& x,
                                     int k, int shift0, int np) {
  const int groups = x.row_groups();
  for (int i = threadIdx.x; i < np * groups * x.img_w; i += blockDim.x) {
    const int line = i / x.img_w, c = i - line * x.img_w;
    const int j = line / groups, s = group_start<kHaloRows>(
                                     line - j * groups, x.halo_rows);
    float acc[kHaloRows];
    window_taps<kHaloRows, true>(acc, cam_x + s * x.img_w + c, x.img_w,
                                 proj_x + s * x.proj_w + c + shift0 - j,
                                 x.proj_w, k);
    float* out = xbuf + j * x.xsz + s * x.xs + c;
#pragma unroll
    for (int n = 0; n < kHaloRows; ++n) out[n * x.xs] = acc[n];
  }
}

// 2. Its column sums at every halo entry: Y[j][r][c] = sum_{t<k}
// X[j][r][c + t].  An item is kHaloCols entries of one row; a warp's
// items are consecutive rows.
__device__ inline void halo_column_sums(float* ybuf, const float* xbuf,
                                        const HaloTile& x, int k, int np) {
  const int lines = np * x.halo_rows;
  const int groups = (x.halo_cols + kHaloCols - 1) / kHaloCols;
  for (int i = threadIdx.x; i < lines * groups; i += blockDim.x) {
    const int q = i / lines, line = i - q * lines;
    const int j = line / x.halo_rows, r = line - j * x.halo_rows;
    const int s = group_start<kHaloCols>(q, x.halo_cols);
    float acc[kHaloCols];
    window_taps<kHaloCols, false>(acc, xbuf + j * x.xsz + r * x.xs + s, 1,
                                  nullptr, 0, k);
    float* out = ybuf + j * x.ysz + r * x.ys + s;
#pragma unroll
    for (int n = 0; n < kHaloCols; ++n) out[n] = acc[n];
  }
}

// K5's planes kernel: A1, B and GRMU of each pixel, as
// camera_grad_rounds_kernel computes them for K4, with the cost
// recomputed over the halo'd tile.  Grid: (ceil(W / kTileW),
// ceil(H / kTileH), B); kThreads threads, one block an SM; dynamic shared
// memory HaloTile(k, chunk, planes).floats() floats.
template <bool kUnnormalized>
__global__ void __launch_bounds__(kThreads, 1)
    fused_bwd_halo_kernel(HeadSource<kUnnormalized> src,
                          const float* __restrict__ camera,
                          const float* __restrict__ projector,
                          const float* __restrict__ cam_s,
                          const float* __restrict__ cam_e2,
                          const float* __restrict__ proj_s,
                          const float* __restrict__ proj_e2,
                          float* __restrict__ a1_out,
                          float* __restrict__ b_out,
                          float* __restrict__ grmu_out, int H, int W, int D,
                          int k, int chunk, int planes, float eps) {
  extern __shared__ float smem[];
  const HaloTile x(k, chunk, planes);
  const int halo = x.halo;
  float* consts = smem;
  float* cam_x = consts + kHaloConsts * halo;
  float* proj_x = cam_x + x.img_rows * x.img_w;
  float* xbuf = proj_x + x.img_rows * x.proj_w;
  float* ybuf = xbuf + planes * x.xsz;

  const int b = blockIdx.z, h0 = blockIdx.y * kTileH, w0 = blockIdx.x * kTileW;
  const size_t plane = static_cast<size_t>(H) * W;
  const size_t frame = static_cast<size_t>(b) * plane;
  const size_t stats_w = static_cast<size_t>(W) + D;
  const float inv_k2 = 1.f / static_cast<float>(k * k);

  // Per-entry constants of the halo'd tile, zero outside the image.
  for (int i = threadIdx.x; i < halo; i += blockDim.x) {
    const int rr = i / x.halo_cols, cc = i - rr * x.halo_cols;
    const int y = h0 - x.p + rr, xx = w0 - x.p + cc;
    const bool inside = y >= 0 && y < H && xx >= 0 && xx < W;
    const size_t pix = frame + static_cast<size_t>(y) * W + xx;
    consts[i] = inside ? __ldg(cam_e2 + pix) : 0.f;
    consts[halo + i] = inside ? __ldg(cam_s + pix) * inv_k2 : 0.f;
    src.stage(consts + 2 * halo, halo, i, pix, inside);
  }
  const int row0 = h0 - 2 * x.p, col0 = w0 - 2 * x.p;
  stage_tile(cam_x, camera + frame, H, W, row0, col0, x.img_rows, x.img_w,
             1.f);

  const int r = threadIdx.x / kTileW, c = threadIdx.x % kTileW;
  const int h = h0 + r, w = w0 + c;
  const bool valid = h < H && w < W;
  const size_t o = frame + static_cast<size_t>(h) * W + w;
  float a1 = 0.f;
  float bacc[kHaloOwn], grmu[kHaloOwn];
#pragma unroll
  for (int n = 0; n < kHaloOwn; ++n) bacc[n] = grmu[n] = 0.f;
  // The last plane of the staged projector chunk: its tile starts at image
  // column col0 - last, so plane d reads it at shift last - d.
  int last = -1;
  __syncthreads();

  for (int d0 = 0; d0 <= D;) {
    if (d0 > last) {
      // The round before's barriers have retired every read of the old
      // chunk.
      last = min(d0 + chunk - 1, D);
      stage_tile(proj_x, projector + frame, H, W, row0, col0 - last,
                 x.img_rows, x.proj_w, 1.f);
      __syncthreads();
    }
    const int np = min(planes, last + 1 - d0);
    halo_products(xbuf, cam_x, proj_x, x, k, last - d0, np);
    __syncthreads();
    halo_column_sums(ybuf, xbuf, x, k, np);
    __syncthreads();

    // 3. The cost, g_d and gr_d at each owned entry, gr_d in place of the
    // entry's sum; B and GRMU of the tile's own pixels.
#pragma unroll
    for (int n = 0; n < kHaloOwn; ++n) {
      const int i = threadIdx.x + n * kThreads;
      if (i >= halo) continue;
      const int rr = i / x.halo_cols, cc = i - rr * x.halo_cols;
      const int y = h0 - x.p + rr, xx = w0 - x.p + cc;
      float* e = ybuf + rr * x.ys + cc;
      if (!(y >= 0 && y < H && xx >= 0 && xx < W)) {
        for (int j = 0; j < np; ++j) e[j * x.ysz] = 0.f;
        continue;
      }
      const float ex2 = consts[i], mux = consts[halo + i];
      const float* mp = consts + 2 * halo;
      const float gs = mp[i], tos = mp[halo + i], inv_s = mp[2 * halo + i];
      const float am = mp[3 * halo + i], gc = mp[4 * halo + i];
      const float cf = mp[5 * halo + i];
      const bool centre = rr >= x.p && rr < x.p + kTileH && cc >= x.p &&
                          cc < x.p + kTileW;
      const size_t srow = (static_cast<size_t>(b) * H + y) * stats_w + D + xx;
      for (int j = 0; j < np; ++j) {
        const int d = d0 + j;
        const float df = static_cast<float>(d);
        const float ey2 = __ldg(proj_e2 + srow - d);
        const float sy = __ldg(proj_s + srow - d);
        const float ri = rsqrtf(ex2 * ey2 + eps);
        const float cv = (e[j * x.ysz] - mux * sy + eps) * ri;
        const float gr =
            head_cotangent<kUnnormalized>(gs, tos, inv_s, am, gc, cf,
                                          src.beta, cv, df) *
            ri;
        e[j * x.ysz] = gr;
        if (centre) {
          bacc[n] = fmaf(gr * cv, ri * ey2, bacc[n]);
          grmu[n] = fmaf(gr, sy * inv_k2, grmu[n]);
        }
      }
    }
    __syncthreads();
    // 4-5. gr's rows pass and its column sums (camera_grad.cuh).
    grad_rows(xbuf, ybuf, x.grad(), k, np);
    __syncthreads();
    grad_column_sums(ybuf, xbuf, x.grad(), k, np);
    __syncthreads();
    // 6. A1 of the tile's pixels, in plane order.
    if (valid) {
      const float* box = ybuf + r * x.bs + c;
      for (int j = 0; j < np; ++j) {
        const int d = d0 + j;
        const float pj = w >= d ? __ldg(projector + o - d) : 0.f;
        a1 = fmaf(box[j * x.ysz], pj, a1);
      }
    }
    d0 += np;
  }

  if (valid) a1_out[o] = a1;
#pragma unroll
  for (int n = 0; n < kHaloOwn; ++n) {
    const int i = threadIdx.x + n * kThreads;
    if (i >= halo) continue;
    const int rr = i / x.halo_cols, cc = i - rr * x.halo_cols;
    const int y = h0 - x.p + rr, xx = w0 - x.p + cc;
    if (rr < x.p || rr >= x.p + kTileH || cc < x.p || cc >= x.p + kTileW ||
        y >= H || xx >= W)
      continue;
    const size_t pix = frame + static_cast<size_t>(y) * W + xx;
    b_out[pix] = bacc[n];
    grmu_out[pix] = grmu[n];
  }
}

// K5's chunked route: K4's rounds kernel on slabs of K1's costs, its
// constants staged where a plane's buffers fit beside them.
template <bool kUnnormalized, bool kStaged>
cudaError_t launch_head_slabs(const HeadSource<kUnnormalized>& src,
                              const float* camera, const float* projector,
                              const float* cam_s, const float* cam_e2,
                              const float* proj_s, const float* proj_e2,
                              float* slab, float* a1, float* bm, float* grmu,
                              int B, int H, int W, int D, int k, float eps,
                              size_t budget, cudaStream_t stream) {
  using Source = HeadSource<kUnnormalized, kStaged>;
  const auto make_source = [&src](const float* costs) {
    return Source{src.am, src.mask, src.conf, src.s, src.t, src.gsoft,
                  src.gconf, src.beta, costs};
  };
  return launch_cost_slabs<Source>(make_source, camera, projector, cam_s,
                                   cam_e2, proj_s, proj_e2, slab, a1, bm,
                                   grmu, B, H, W, D, k, eps, budget, stream);
}

// K5's A1, B and GRMU within `budget` floats: the halo kernel, or, where
// its block does not fit, the chunked route on `slab`.
template <bool kUnnormalized>
cudaError_t launch_halo_rounds(const HeadSource<kUnnormalized>& src,
                               const float* camera, const float* projector,
                               const float* cam_s, const float* cam_e2,
                               const float* proj_s, const float* proj_e2,
                               float* a1, float* bm, float* grmu,
                               float* slab, int B, int H, int W, int D, int k,
                               float eps, size_t budget,
                               cudaStream_t stream) {
  const Rounds round = halo_round(k, D, budget);
  const HaloTile x(k, round.chunk, round.planes);
  // Not one plane fits, or the halo has more entries than threads own.
  if (round.planes < 1 || x.halo > kHaloOwn * kThreads) {
    const bool staged = grad_round(k, kCostChunk - 1,
                                   staged_consts<HeadSource<kUnnormalized>>(),
                                   false, budget)
                            .planes >= 1;
    return staged ? launch_head_slabs<kUnnormalized, true>(
                        src, camera, projector, cam_s, cam_e2, proj_s,
                        proj_e2, slab, a1, bm, grmu, B, H, W, D, k, eps,
                        budget, stream)
                  : launch_head_slabs<kUnnormalized, false>(
                        src, camera, projector, cam_s, cam_e2, proj_s,
                        proj_e2, slab, a1, bm, grmu, B, H, W, D, k, eps,
                        budget, stream);
  }
  auto kernel = fused_bwd_halo_kernel<kUnnormalized>;
  const size_t bytes = x.floats() * sizeof(float);
  const cudaError_t e = allow_smem(kernel, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      src, camera, projector, cam_s, cam_e2, proj_s, proj_e2, a1, bm, grmu, H,
      W, D, k, round.chunk, round.planes, eps);
  return cudaGetLastError();
}

// K4 (the cost read from `cost`, its rounds kernel at a tile of
// `tile_rows` rows) or K5 (recomputed, at the default tile), through
// camera_grad.cuh's launch_grad_kernels.  K4 at a tile it has no
// instantiation for, or whose blocks do not fit, is refused before
// anything launches.
template <bool kUnnormalized, bool kRecompute>
int run(const float* camera, const float* projector, float* cam_s,
        float* cam_e2, float* proj_s, float* proj_e2, const float* cost,
        const float* am, const float* mask, const float* conf, const float* s,
        const float* t, const float* gsoft, const float* gconf, float* a1,
        float* bm, float* grmu, float* grad, float* slab, int B, int H,
        int W, int D, int k, float eps, float beta, cudaStream_t stream,
        int tile_rows) {
  const HeadSource<kUnnormalized> src{am, mask, conf, s, t, gsoft, gconf,
                                      beta, cost};
  if constexpr (!kRecompute) {
    size_t budget = 0;
    const cudaError_t e = optin_floats(&budget);
    if (e != cudaSuccess) return e;
    if ((tile_rows != 8 && tile_rows != kTileH && tile_rows != 32) ||
        !head_rounds_fit(k, D, budget, tile_rows))
      return cudaErrorInvalidConfiguration;
  }
  return launch_grad_kernels(
      [&](size_t budget) {
        if constexpr (kRecompute) {
          return launch_halo_rounds(src, camera, projector, cam_s, cam_e2,
                                    proj_s, proj_e2, a1, bm, grmu, slab, B,
                                    H, W, D, k, eps, budget, stream);
        } else {
          if (tile_rows == kTileH)
            return launch_head_rounds(src, camera, projector, cam_s, cam_e2,
                                      proj_s, proj_e2, a1, bm, grmu, B, H, W,
                                      D, k, eps, budget, stream);
          const HeadRoundsCall c{am, mask, conf, s, t, gsoft, gconf, cost,
                                 beta, kUnnormalized, camera, projector,
                                 cam_s, cam_e2, proj_s, proj_e2, a1, bm,
                                 grmu, B, H, W, D, k, eps, budget, stream};
          return tile_rows == 8 ? head_rounds_tile8(c)
                                : head_rounds_tile32(c);
        }
      },
      camera, projector, cam_s, cam_e2, proj_s, proj_e2, a1, bm, grmu, grad,
      B, H, W, D, k, stream);
}

// The head branch `unnormalized` selects.
template <bool kRecompute>
int run_branch(const float* camera, const float* projector, float* cam_s,
               float* cam_e2, float* proj_s, float* proj_e2,
               const float* cost, const float* am, const float* mask,
               const float* conf, const float* s, const float* t,
               const float* gsoft, const float* gconf, float* a1, float* bm,
               float* grmu, float* grad, float* slab, int B, int H, int W,
               int D, int k, float eps, float beta, int unnormalized,
               cudaStream_t stream, int tile_rows) {
  if (unnormalized)
    return run<true, kRecompute>(camera, projector, cam_s, cam_e2, proj_s,
                                 proj_e2, cost, am, mask, conf, s, t, gsoft,
                                 gconf, a1, bm, grmu, grad, slab, B, H, W, D,
                                 k, eps, beta, stream, tile_rows);
  return run<false, kRecompute>(camera, projector, cam_s, cam_e2, proj_s,
                                proj_e2, cost, am, mask, conf, s, t, gsoft,
                                gconf, a1, bm, grmu, grad, slab, B, H, W, D,
                                k, eps, beta, stream, tile_rows);
}

}  // namespace
}  // namespace custereo

using namespace custereo;

// Plain C interface, loaded with ctypes.  camera/projector: [B, H, W];
// cost: [B, D + 1, H, W]; the forward's maps am, mask, conf, s, t and the
// cotangents gsoft, gconf: [B, H, W]; scratch cam_s/cam_e2: [B, H, W],
// proj_s/proj_e2: [B, H, W + D], a1/bm/grmu: [B, H, W]; grad: [B, H, W];
// all fp32, contiguous, on the current device.  `unnormalized` must be the
// head branch the forward ran.  `tile_rows`: the rounds kernel's tile, 8,
// 16 (the default) or 32 rows of 1024 / tile_rows columns; another, or one
// whose blocks do not fit, is refused (cudaErrorInvalidConfiguration)
// before anything launches.  Launches on `stream`, does not synchronise,
// and returns cudaGetLastError() (0 when every launch was accepted).
extern "C" int custereo_fused_pipeline_bwd(
    const float* camera, const float* projector, float* cam_s, float* cam_e2,
    float* proj_s, float* proj_e2, const float* cost, const float* am,
    const float* mask, const float* conf, const float* s, const float* t,
    const float* gsoft, const float* gconf, float* a1, float* bm, float* grmu,
    float* grad, int B, int H, int W, int D, int k, float eps, float beta,
    int unnormalized, void* stream_ptr, int tile_rows) {
  return run_branch<false>(camera, projector, cam_s, cam_e2, proj_s, proj_e2,
                           cost, am, mask, conf, s, t, gsoft, gconf, a1, bm,
                           grmu, grad, nullptr, B, H, W, D, k, eps, beta,
                           unnormalized, static_cast<cudaStream_t>(stream_ptr),
                           tile_rows);
}

// K5: as custereo_fused_pipeline_bwd without the cost volume; the cost is
// recomputed from camera and projector at every pixel of the halo'd tile,
// or, where that block does not fit, written a slab of kCostChunk planes
// at a time into `slab` ([B, min(kCostChunk, D + 1), H, W]; null where
// the halo kernel runs: kernel_model.cost_slab_planes says which).  The
// slab comes after the stream, so a caller of the entry without it still
// runs the halo kernel.
extern "C" int custereo_fused_pipeline_bwd_recompute(
    const float* camera, const float* projector, float* cam_s, float* cam_e2,
    float* proj_s, float* proj_e2, const float* am, const float* mask,
    const float* conf, const float* s, const float* t, const float* gsoft,
    const float* gconf, float* a1, float* bm, float* grmu, float* grad, int B,
    int H, int W, int D, int k, float eps, float beta, int unnormalized,
    void* stream_ptr, float* slab) {
  return run_branch<true>(camera, projector, cam_s, cam_e2, proj_s, proj_e2,
                          nullptr, am, mask, conf, s, t, gsoft, gconf, a1, bm,
                          grmu, grad, slab, B, H, W, D, k, eps, beta,
                          unnormalized, static_cast<cudaStream_t>(stream_ptr),
                          kTileH);
}

// The planes a round and chunk of K4's rounds kernel at (k, D) on the
// current device at a tile of `tile_rows` rows, and whether its constants
// are staged: round[0], round[1], round[2]; {0, 0, 0} and
// cudaErrorInvalidConfiguration where it does not fit or the tile has no
// instantiation.  What the bound model mirrors (kernel_model.grad_round,
// k4_staged); launches nothing.
extern "C" int custereo_head_rounds(int k, int D, int tile_rows, int* round) {
  round[0] = round[1] = round[2] = 0;
  size_t budget = 0;
  const cudaError_t e = optin_floats(&budget);
  if (e != cudaSuccess) return e;
  if (tile_rows != 8 && tile_rows != kTileH && tile_rows != 32)
    return cudaErrorInvalidConfiguration;
  bool staged = false;
  const Rounds r = head_round(k, D, budget, tile_rows, &staged);
  if (r.planes < 1) return cudaErrorInvalidConfiguration;
  round[0] = r.planes;
  round[1] = r.chunk;
  round[2] = staged;
  return cudaSuccess;
}
