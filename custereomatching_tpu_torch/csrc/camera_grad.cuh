// The closed-form camera VJP of the banded ZNCC volume: the accumulation
// and combine bodies that K2 and K6 (zncc_banded_bwd.cu, cotangent read
// from memory) and K4 and K5 (fused_pipeline_bwd.cu, cotangent formed from
// the disparity head's maps) run.  The rounds kernel's template axis
// `Source` says where the cotangent plane g_d comes from.  K7's rounds
// kernel (zncc_banded_proj_bwd.cu) is built from the same pieces:
// GradRoundTile, grad_round, ring_entry, grad_rows and grad_column_sums.
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
// Two kernels:
//   1. camera_grad_rounds_kernel (K2, K4, K6): A1, B and GRMU of a
//      kTileH x kTileW pixel tile, the planes d = 0..D in rounds of P on
//      the register-blocked window pass of common.cuh (window_taps), as K5
//      runs them (fused_pipeline_bwd.cu).  Where the cost c_d comes from is
//      the instantiation's: read at every halo entry as the source's
//      volume (K4, which forms g_d from it), recomputed on the tile's own
//      pixels (K6), or read there from a second volume beside the
//      cotangent (K2).  Where the entries' constants do not fit beside a
//      plane's buffers (K4 past k = 47), the source reads them from their
//      maps in global memory (through L2) at every entry once a round
//      instead of staging them (Source::kStaged false).  A round:
//        a. (K6) the cost's cross term on the tile's own pixels: K3's
//           round_products and round_column_sums (common.cuh), the
//           projector tile staged in chunks of planes, so any D runs;
//        b. gr_d at every halo entry for the round's P planes: an entry
//           reads its constants (ex2 and the source's maps) once a round
//           and issues its P planes' global loads (the cost or the
//           cotangent, ey2; at the tile's own pixels also sy, and for K2
//           the cost) before it uses the first.  The tile's own pixels
//           are their own threads' entries, which add B and GRMU in
//           registers from the same c_d and r_d; the ring of the halo
//           around them is spread over the block;
//        c. gr's rows pass and column sums (grad_rows, grad_column_sums,
//           which K5 runs too);
//        d. A1 of each pixel, by its thread, in plane order.
//      Four barriers a round (six with the recompute, and one more stage
//      of the projector a chunk).  P is a template constant (kGradPlanes,
//      or the largest power of two below it whose buffers fit), so the
//      per-plane loops have a fixed count; a short last round is
//      predicated.
//   2. camera_grad_combine_kernel: the three [H, W] box filters and the
//      final sum, the three maps staged together, or one after another
//      where their tiles do not fit together (k > 93).
// The chunked route (launch_cost_slabs), where a block that recomputes
// the cost does not fit (K6 past k = 81, K5 past k = 27): for each slab of
// kCostChunk planes, K1's rounds kernel (fused_pipeline.cuh, the head
// off, beta = 1) writes the slab's costs into a [B, kCostChunk, H, W]
// scratch, and the rounds kernel in slab mode (kSlab) walks those planes
// with the cost read, K2's instantiation for K6 and K4's for K5, A1, B
// and GRMU continued from their maps.  The costs are K1's bit for bit and
// the sums stay in plane order, so the route gives K2's (K4's) gradient
// on K1's volume, as the recompute does.
// Every output of every pass adds its taps in K1's order, and A1, B and
// GRMU accumulate in plane order, so the three instantiations give the
// same values bit for bit: K6, recomputing the cost, gives K2's gradient
// on one cotangent.  Every odd k <= 127 runs at every D.  The rounds
// kernel's tile is a template parameter (Tile<TH>): K4 runs it at 8, 16
// or 32 rows (head_rounds.cuh), the others at the default 16 x 64; the
// statistics and combine kernels stay at 16 x 64.
//
// What bounds it on the H100: with the cost read from memory, the cost
// (and for K2 the cotangent) volume is read once, 360 MB a KITTI frame
// each (about 0.11 ms at 3.35 TB/s); the halo'd gr tile re-reads a
// neighbour's values through L2.  Beyond that the window passes and, at
// every halo entry and plane, an rsqrt (K4 also an exp).
#pragma once

#include "common.cuh"
#include "fused_pipeline.cuh"

namespace custereo {
namespace {

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

// ---------------------------------------------------------------------------
// gr's passes on the register-blocked window pass (K4, K5, K6).  Outputs an
// item of gr's rows pass (kGradRows) and of its column sums (kGradCols).
constexpr int kGradRows = 8;
constexpr int kGradCols = 8;
static_assert(kTileH % kGradRows == 0 && kTileW % kGradCols == 0,
              "gr's groups tile the tile");
static_assert(Tile<8>::kH % kGradRows == 0 && Tile<8>::kW % kGradCols == 0 &&
                  Tile<32>::kH % kGradRows == 0 &&
                  Tile<32>::kW % kGradCols == 0,
              "gr's groups tile every tile K4 runs at");

// Where gr's passes find their planes, in floats: buffer Y holds gr_d over
// the halo'd rows (row stride ys, plane stride ysz, halo_cols entries a
// row) and then gr's box sums (row stride bs); buffer X holds gr's rows
// pass (row stride vs, plane stride xsz); the tile is th x tw pixels.
struct GradStrides {
  int halo_cols, ys, ysz, vs, xsz, bs;
  int th = kTileH, tw = kTileW;
};

// gr's rows pass: X[j][r][c] = sum_{t<k} Y[j][r + t][c] for r < th,
// c < halo_cols (vertical_sum).  An item is kGradRows rows of one column
// and plane.
__device__ inline void grad_rows(float* xbuf, const float* ybuf,
                                 const GradStrides& x, int k, int np) {
  const int groups = x.th / kGradRows;
  for (int i = threadIdx.x; i < np * groups * x.halo_cols;
       i += blockDim.x) {
    const int line = i / x.halo_cols, c = i - line * x.halo_cols;
    const int j = line / groups, s = (line - j * groups) * kGradRows;
    float acc[kGradRows];
    window_taps<kGradRows, false>(acc, ybuf + j * x.ysz + s * x.ys + c, x.ys,
                                  nullptr, 0, k);
    float* out = xbuf + j * x.xsz + s * x.vs + c;
#pragma unroll
    for (int n = 0; n < kGradRows; ++n) out[n * x.vs] = acc[n];
  }
}

// Its column sums, box(gr_d) at each pixel of the tile: Y[j][r][c] =
// sum_{t<k} X[j][r][c + t] (horizontal_sum).  An item is kGradCols pixels
// of a row; a warp's items are consecutive rows.
__device__ inline void grad_column_sums(float* ybuf, const float* xbuf,
                                        const GradStrides& x, int k,
                                        int np) {
  const int groups = x.tw / kGradCols;
  const int lines = np * x.th;
  for (int i = threadIdx.x; i < lines * groups; i += blockDim.x) {
    const int q = i / lines, line = i - q * lines;
    const int j = line / x.th, r = line - j * x.th;
    float acc[kGradCols];
    window_taps<kGradCols, false>(
        acc, xbuf + j * x.xsz + r * x.vs + q * kGradCols, 1, nullptr, 0, k);
    float* out = ybuf + j * x.ysz + r * x.bs + q * kGradCols;
#pragma unroll
    for (int n = 0; n < kGradCols; ++n) out[n] = acc[n];
  }
}

// The most planes a round of the rounds kernel takes; where their buffers
// do not fit, or D + 1 is smaller, it takes the largest power of two below
// that does (launch_rounds_at instantiates each).
constexpr int kGradPlanes = 8;

// Shared-memory geometry of the rounds kernel at a th x tw pixel tile
// (16 x 64 by default), in floats: the entries' constants (consts x halo:
// ex2, then the source's maps); with the recompute, the camera tile
// (halo_rows x halo_cols) and the projector tile widened left by chunk - 1
// columns (halo_rows x proj_w); then `planes` planes of buffer Y (gr_d
// over the halo'd tile, halo_rows x ys; then gr's box sums, th x bs) and
// of buffer X (gr's rows pass, th x vs).  Before gr's passes the recompute
// runs K3's round in the same space: its rows pass (RoundTile's vsum,
// planes x th x vs) in Y, its window sums (planes x th x bs) in X.  Row
// strides are odd, so a warp's 32 rows hit 32 banks.
struct GradRoundTile {
  int p, th, tw, halo_rows, halo_cols, halo, consts, proj_w, ys, ysz, vs,
      xsz, bs, planes;
  bool recompute;
  __host__ __device__ GradRoundTile(int k, int consts, bool recompute,
                                    int chunk, int planes, int th = kTileH)
      : p(k / 2),
        th(th),
        tw(kThreads / th),
        halo_rows(th + 2 * (k / 2)),
        halo_cols(kThreads / th + 2 * (k / 2)),
        halo(halo_rows * halo_cols),
        consts(consts),
        proj_w(halo_cols + chunk - 1),
        ys(halo_cols + 1),
        ysz(halo_rows * (halo_cols + 1)),
        vs(halo_cols + 1),
        xsz(th * (halo_cols + 1)),
        bs(kThreads / th + 1),
        planes(planes),
        recompute(recompute) {}
  __host__ __device__ size_t fixed_floats() const {
    return static_cast<size_t>(consts + (recompute ? 1 : 0)) * halo;
  }
  __host__ __device__ size_t proj_floats() const {
    return recompute ? static_cast<size_t>(halo_rows) * proj_w : 0;
  }
  __host__ __device__ size_t plane_floats() const {
    return static_cast<size_t>(ysz) + xsz;
  }
  __host__ __device__ size_t floats() const {
    return fixed_floats() + proj_floats() + planes * plane_floats();
  }
  __host__ __device__ GradStrides strides() const {
    return {halo_cols, ys, ysz, vs, xsz, bs, th, tw};
  }
};

// Planes a round and a projector staging of the rounds kernel at a tile
// of th rows within `budget` floats: the most planes (kGradPlanes,
// halving) whose buffers fit beside the constants (and with the recompute
// one plane's projector tile) and that D + 1 fills; with the recompute the
// staging takes what is left, a multiple of the round, and the round
// halves where fewer planes than that fit.  {0, 0} when not one plane
// fits.
inline Rounds grad_round(int k, int D, int consts, bool recompute,
                            size_t budget, int th = kTileH) {
  for (int planes = kGradPlanes; planes >= 1; planes /= 2) {
    if (planes > 1 && planes > D + 1) continue;
    const GradRoundTile t(k, consts, recompute, 1, planes, th);
    if (t.floats() > budget) continue;
    if (!recompute) return {planes, D + 1};
    const int chunk =
        staging_chunk(D, t.fixed_floats() + planes * t.plane_floats(),
                      t.proj_floats(), t.halo_rows, budget);
    if (chunk >= D + 1) return {planes, chunk};
    if (chunk >= planes) return {planes, chunk - chunk % planes};
  }
  return {0, 0};
}

// Halo index of ring entry q, the halo'd tile less the tile's own pixels
// (a tile of TH rows): the top p rows, the bottom p rows, then the left
// and right p columns of the TH rows between.
template <int TH = kTileH>
__device__ __forceinline__ int ring_entry(int q, int p, int halo_cols) {
  const int band = p * halo_cols;
  if (q < band) return q;
  if (q < 2 * band) return (TH + p) * halo_cols + (q - band);
  const int s = q - 2 * band, row = s / (2 * p), col = s - row * 2 * p;
  return (p + row) * halo_cols + (col < p ? col : col + Tile<TH>::kW);
}

// Source: the cotangent plane.
//   kStaged      whether the entries' constants (ex2 and its maps) are
//                staged over the halo once a block, or read from global
//                memory at every entry once a round
//   kMaps        halo'd tiles of per-pixel constants it stages
//   kReadsCost   whether its volume is the cost, g_d formed from it (K4),
//                or the cotangent itself (K2, K6)
//   kCentreCost  whether it reads the cost c_d at the tile's own pixels
//                from a second plane-major volume, `cost` (K2)
//   vol          the plane-major [B, D + 1, H, W] volume it reads at every
//                halo entry and plane
//   stage(maps, halo, i, pix, inside)  fill entry i of its tiles
//   Entry, entry(maps, halo, i, pix)   entry i's constants: staged, or
//                                      read at frame pixel pix
//   cotangent(entry, v, df)            g_d from them and vol's value v
//
// Grid: (ceil(W / TW), ceil(H / TH), B) for a TH x TW pixel tile
// (Tile<TH>; K4 at 8, 16 or 32 rows, the others at the default 16);
// kThreads threads, one block an SM; dynamic shared memory
// GradRoundTile(k, staged_consts<Source>(), kRecompute, chunk, P,
// TH).floats() floats.  kRecompute: the cost
// is recomputed from camera and projector on the tile's own pixels, the
// projector tile staged anew every `chunk` planes (K6, whose source reads
// the cotangent); otherwise the source's volume is the cost (K4) or the
// source reads it at the tile's own pixels (K2), and camera, cam_s and
// `chunk` are unused.  kSlab: the launch walks the planes [d_lo, d_hi]
// alone, whose costs (the source's volume for K4's source, its `cost` for
// K2's) sit in a slab of their own, [B, d_hi - d_lo + 1, H, W], and adds
// to the A1, B and GRMU that the slabs before left in their maps;
// otherwise it walks d = 0..D and d_lo, d_hi are unused.
template <class Source>
__host__ __device__ constexpr int staged_consts() {
  return Source::kStaged ? 1 + Source::kMaps : 0;
}

template <class Source, bool kRecompute, bool kSlab, int P, int TH = kTileH>
__global__ void __launch_bounds__(kThreads, 1)
    camera_grad_rounds_kernel(Source src, const float* __restrict__ camera,
                              const float* __restrict__ projector,
                              const float* __restrict__ cam_s,
                              const float* __restrict__ cam_e2,
                              const float* __restrict__ proj_s,
                              const float* __restrict__ proj_e2,
                              float* __restrict__ a1_out,
                              float* __restrict__ b_out,
                              float* __restrict__ grmu_out, int H, int W,
                              int D, int k, int chunk, int d_lo, int d_hi,
                              float eps) {
  static_assert(int(Source::kReadsCost) + int(kRecompute) +
                        int(Source::kCentreCost) ==
                    1,
                "the cost is the source's volume (K4), recomputed (K6) or "
                "read at the tile's own pixels (K2)");
  static_assert(!kSlab || !kRecompute, "a slab's costs are read");
  static_assert(Source::kStaged || (!kRecompute && Source::kMaps == 0),
                "unstaged constants: none in shared memory");
  constexpr int TW = Tile<TH>::kW;
  extern __shared__ float smem[];
  const GradRoundTile x(k, staged_consts<Source>(), kRecompute, chunk, P, TH);
  const GradStrides gs = x.strides();
  const int halo = x.halo, hc = x.halo_cols, p = x.p;
  float* ex2_t = smem;
  float* maps = ex2_t + (Source::kStaged ? halo : 0);
  float* cam_x = maps + Source::kMaps * halo;
  float* proj_x = cam_x + (kRecompute ? halo : 0);
  float* ybuf = proj_x + x.proj_floats();
  float* xbuf = ybuf + P * x.ysz;
  // The recompute's round (K3's geometry, the projector tile `chunk`
  // planes wide).
  const PlaneTile pt(k, chunk - 1, TH);
  const RoundTile rt(pt, P);

  const int b = blockIdx.z, h0 = blockIdx.y * TH, w0 = blockIdx.x * TW;
  const size_t plane = static_cast<size_t>(H) * W;
  const size_t frame = static_cast<size_t>(b) * plane;
  const size_t stats_w = static_cast<size_t>(W) + D;
  // The planes walked, and the slab's frame: the cost volume's planes.
  const int first = kSlab ? d_lo : 0, end = kSlab ? d_hi : D;
  const size_t slab = kSlab ? d_hi - d_lo + 1 : D + 1;
  const int vol_first = kSlab && Source::kReadsCost ? first : 0;
  const size_t vol_frame = kSlab && Source::kReadsCost ? slab : D + 1;
  const float* vol_b = src.vol + static_cast<size_t>(b) * vol_frame * plane;
  const float inv_k2 = 1.f / static_cast<float>(k * k);

  // Per-entry constants of the halo'd tile, zero outside the image.
  if constexpr (Source::kStaged) {
    for (int i = threadIdx.x; i < halo; i += blockDim.x) {
      const int rr = i / hc, cc = i - rr * hc;
      const int y = h0 - p + rr, xx = w0 - p + cc;
      const bool inside = y >= 0 && y < H && xx >= 0 && xx < W;
      const size_t pix = frame + static_cast<size_t>(y) * W + xx;
      ex2_t[i] = inside ? __ldg(cam_e2 + pix) : 0.f;
      src.stage(maps, halo, i, pix, inside);
    }
  }
  if constexpr (kRecompute)
    stage_tile(cam_x, camera + frame, H, W, h0 - p, w0 - p, x.halo_rows, hc,
               1.f);

  const int r = threadIdx.x / TW, c = threadIdx.x % TW;
  const int h = h0 + r, w = w0 + c;
  const bool valid = h < H && w < W;
  const int centre = (r + p) * hc + c + p;
  float* centre_y = ybuf + (r + p) * x.ys + c + p;
  const size_t o = frame + static_cast<size_t>(h) * W + w;
  // Image column x of the projector statistics sits at index x + D.
  const size_t stats_row = (static_cast<size_t>(b) * H + h) * stats_w + D + w;
  // The camera's window mean at the tile's own pixel (the recompute).
  const float mux = kRecompute && valid ? __ldg(cam_s + o) * inv_k2 : 0.f;
  const int ring = halo - kThreads;
  float a1 = 0.f, bacc = 0.f, grmu = 0.f;
  if (kSlab && first > 0 && valid) {
    a1 = a1_out[o];
    bacc = b_out[o];
    grmu = grmu_out[o];
  }
  // The last plane of the staged projector chunk: its tile starts at image
  // column w0 - p - last, so plane d reads it at shift last - d.
  int last = kRecompute ? -1 : end;

  for (int d0 = first; d0 <= end;) {
    if constexpr (kRecompute) {
      // The round before's barriers have retired every read of the old
      // chunk.
      if (d0 > last) {
        last = min(d0 + chunk - 1, D);
        stage_tile(proj_x, projector + frame, H, W, h0 - p, w0 - p - last,
                   x.halo_rows, x.proj_w, 1.f);
      }
    }
    const int np = min(P, last + 1 - d0);
    if constexpr (kRecompute) {
      // a. The cross term's window sums at the tile's pixels, in X.
      __syncthreads();
      round_products<TH>(ybuf, cam_x, proj_x, pt, rt, k, last - d0, np);
      __syncthreads();
      round_column_sums(xbuf, ybuf, rt, k, np);
    }
    // The round before's A1 has read Y (and the recompute's sums are in).
    __syncthreads();

    // b. gr_d of the tile's own pixel, with its B and GRMU terms.  Planes
    // past D (a short last round) load plane D and add nothing.
    if (valid) {
      const auto e = src.entry(maps, halo, centre, o);
      const float ex2 = Source::kStaged ? ex2_t[centre] : __ldg(cam_e2 + o);
      float ey2[P], sy[P], v[P], cost[P];
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int d = min(d0 + j, end);
        ey2[j] = __ldg(proj_e2 + stats_row - d);
        sy[j] = __ldg(proj_s + stats_row - d);
        v[j] = __ldg(vol_b + (d - vol_first) * plane + (o - frame));
        if constexpr (Source::kCentreCost)
          cost[j] = __ldg(src.cost +
                          (static_cast<size_t>(b) * slab + d - first) *
                              plane +
                          (o - frame));
      }
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const float ri = rsqrtf(ex2 * ey2[j] + eps);
        const float gr =
            src.cotangent(e, v[j], static_cast<float>(d0 + j)) * ri;
        float cv = v[j];
        if constexpr (Source::kCentreCost) cv = cost[j];
        if constexpr (kRecompute)
          cv = (xbuf[j * rt.box_floats() + r * rt.bs + c] - mux * sy[j] +
                eps) *
               ri;
        centre_y[j * x.ysz] = gr;
        if (j < np) {
          bacc = fmaf(gr * cv, ri * ey2[j], bacc);
          grmu = fmaf(gr, sy[j] * inv_k2, grmu);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < P; ++j) centre_y[j * x.ysz] = 0.f;
    }
    // gr_d at the ring's entries.
    for (int q = threadIdx.x; q < ring; q += kThreads) {
      const int i = ring_entry<TH>(q, p, hc);
      const int rr = i / hc, cc = i - rr * hc;
      const int y = h0 - p + rr, xx = w0 - p + cc;
      float* ey = ybuf + rr * x.ys + cc;
      if (!(y >= 0 && y < H && xx >= 0 && xx < W)) {
#pragma unroll
        for (int j = 0; j < P; ++j) ey[j * x.ysz] = 0.f;
        continue;
      }
      const size_t px = static_cast<size_t>(y) * W + xx;
      const auto e = src.entry(maps, halo, i, frame + px);
      const float ex2 =
          Source::kStaged ? ex2_t[i] : __ldg(cam_e2 + frame + px);
      const size_t srow = (static_cast<size_t>(b) * H + y) * stats_w + D + xx;
      float ey2[P], v[P];
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int d = min(d0 + j, end);
        ey2[j] = __ldg(proj_e2 + srow - d);
        v[j] = __ldg(vol_b + (d - vol_first) * plane + px);
      }
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const float ri = rsqrtf(ex2 * ey2[j] + eps);
        ey[j * x.ysz] =
            src.cotangent(e, v[j], static_cast<float>(d0 + j)) * ri;
      }
    }
    __syncthreads();

    // c. gr's rows pass (Y to X) and column sums (X to Y).
    grad_rows(xbuf, ybuf, gs, k, np);
    __syncthreads();
    grad_column_sums(ybuf, xbuf, gs, k, np);
    __syncthreads();

    // d. A1 of the tile's pixels, in plane order.
    if (valid) {
      const float* box = ybuf + r * x.bs + c;
      float pj[P];
#pragma unroll
      for (int j = 0; j < P; ++j) {
        const int d = d0 + j;
        pj[j] = j < np && w >= d ? __ldg(projector + o - d) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < P; ++j)
        if (j < np) a1 = fmaf(box[j * x.ysz], pj[j], a1);
    }
    d0 += np;
  }

  if (!valid) return;
  a1_out[o] = a1;
  b_out[o] = bacc;
  grmu_out[o] = grmu;
}

// grad = A1 - box(GRMU) + box(B mux) - cam * box(B), the boxes reading
// zeros outside the image.  The three maps are box-filtered kAtOnce at a
// time (3, or 1 where three tiles do not fit), each in the same order.
// Grid: (ceil(W / kTileW), ceil(H / kTileH), B); dynamic shared memory
// combine_floats(k, kAtOnce) floats.
inline size_t combine_floats(int k, int at_once) {
  const size_t p = k / 2, cols = kTileW + 2 * p;
  return at_once * ((kTileH + 2 * p) * cols + kTileH * cols);
}

template <int kAtOnce>
__global__ void __launch_bounds__(kThreads)
    camera_grad_combine_kernel(const float* __restrict__ camera,
                               const float* __restrict__ cam_s,
                               const float* __restrict__ a1,
                               const float* __restrict__ bm,
                               const float* __restrict__ grmu,
                               float* __restrict__ grad, int H, int W,
                               int k) {
  static_assert(3 % kAtOnce == 0, "the maps go in whole groups");
  extern __shared__ float smem[];
  const int p = k / 2, rows = kTileH + 2 * p, cols = kTileW + 2 * p;
  const int halo = rows * cols, vsz = kTileH * cols;
  float* tiles = smem;
  float* vsums = tiles + kAtOnce * halo;
  const int b = blockIdx.z, h0 = blockIdx.y * kTileH, w0 = blockIdx.x * kTileW;
  const size_t frame = static_cast<size_t>(b) * H * W;
  const float inv_k2 = 1.f / static_cast<float>(k * k);
  const int r = threadIdx.x / kTileW, c = threadIdx.x % kTileW;
  // box(GRMU), box(B mux), box(B) at the thread's pixel.
  float s[3];

#pragma unroll
  for (int m0 = 0; m0 < 3; m0 += kAtOnce) {
    // The group before has read its tiles.
    if (m0 > 0) __syncthreads();
    for (int i = threadIdx.x; i < halo; i += blockDim.x) {
      const int rr = i / cols, cc = i - rr * cols;
      const int y = h0 - p + rr, x = w0 - p + cc;
      const bool inside = y >= 0 && y < H && x >= 0 && x < W;
      const size_t pix = frame + static_cast<size_t>(y) * W + x;
#pragma unroll
      for (int m = m0; m < m0 + kAtOnce; ++m) {
        float v = 0.f;
        if (inside) {
          if (m == 0)
            v = __ldg(grmu + pix);
          else if (m == 1)
            v = __ldg(bm + pix) * (__ldg(cam_s + pix) * inv_k2);
          else
            v = __ldg(bm + pix);
        }
        tiles[(m - m0) * halo + i] = v;
      }
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < kAtOnce; ++m)
      vertical_sum(vsums + m * vsz, tiles + m * halo, cols, k);
    __syncthreads();
#pragma unroll
    for (int m = 0; m < kAtOnce; ++m)
      s[m0 + m] = horizontal_sum(vsums + m * vsz, cols, r, c, k);
  }

  const int h = h0 + r, w = w0 + c;
  if (h >= H || w >= W) return;
  const size_t o = frame + static_cast<size_t>(h) * W + w;
  grad[o] = (a1[o] - s[0]) + (s[1] - camera[o] * s[2]);
}

// The opt-in shared memory a block of the current device may hold, in
// floats.
inline cudaError_t optin_floats(size_t* floats) {
  int device = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device);
  *floats = static_cast<size_t>(optin) / sizeof(float);
  return e;
}

// The statistics passes: the camera's, and the projector's over the
// D-widened columns.
inline cudaError_t launch_grad_stats(const float* camera,
                                     const float* projector, float* cam_s,
                                     float* cam_e2, float* proj_s,
                                     float* proj_e2, int B, int H, int W,
                                     int D, int k, cudaStream_t stream) {
  const cudaError_t e =
      launch_box_stats(camera, cam_s, cam_e2, B, H, W, k, 0, W, 1.f, stream);
  if (e != cudaSuccess) return e;
  return launch_box_stats(projector, proj_s, proj_e2, B, H, W, k, D, W + D,
                          1.f, stream);
}

// The combine, its three maps together where their tiles fit in `budget`
// floats, else one at a time.
inline cudaError_t launch_grad_combine(const float* camera,
                                       const float* cam_s, const float* a1,
                                       const float* bm, const float* grmu,
                                       float* grad, int B, int H, int W,
                                       int k, size_t budget,
                                       cudaStream_t stream) {
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  const bool together = combine_floats(k, 3) <= budget;
  const size_t bytes = combine_floats(k, together ? 3 : 1) * sizeof(float);
  auto kernel = together ? camera_grad_combine_kernel<3>
                         : camera_grad_combine_kernel<1>;
  const cudaError_t e = allow_smem(kernel, bytes);
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, bytes, stream>>>(camera, cam_s, a1, bm, grmu,
                                            grad, H, W, k);
  return cudaGetLastError();
}

// K2, K4, K5 and K6: the statistics passes, then `rounds(budget)` (the
// rounds kernel, or the route that fits in the `budget` floats a block
// may hold), then the combine.
template <class RoundsFn>
cudaError_t launch_grad_kernels(const RoundsFn& rounds, const float* camera,
                                const float* projector, float* cam_s,
                                float* cam_e2, float* proj_s, float* proj_e2,
                                float* a1, float* bm, float* grmu,
                                float* grad, int B, int H, int W, int D,
                                int k, cudaStream_t stream) {
  cudaError_t e = launch_grad_stats(camera, projector, cam_s, cam_e2, proj_s,
                                    proj_e2, B, H, W, D, k, stream);
  if (e != cudaSuccess) return e;
  size_t budget = 0;
  e = optin_floats(&budget);
  if (e != cudaSuccess) return e;
  e = rounds(budget);
  if (e != cudaSuccess) return e;
  return launch_grad_combine(camera, cam_s, a1, bm, grmu, grad, B, H, W, k,
                             budget, stream);
}

template <class Source, bool kRecompute, bool kSlab, int P, int TH = kTileH>
cudaError_t launch_rounds(const Source& src, const float* camera,
                          const float* projector, const float* cam_s,
                          const float* cam_e2, const float* proj_s,
                          const float* proj_e2, float* a1, float* bm,
                          float* grmu, int B, int H, int W, int D, int k,
                          int chunk, int d_lo, int d_hi, float eps,
                          cudaStream_t stream, Tile<TH> = {}) {
  constexpr int TW = Tile<TH>::kW;
  auto kernel = camera_grad_rounds_kernel<Source, kRecompute, kSlab, P, TH>;
  const size_t bytes =
      GradRoundTile(k, staged_consts<Source>(), kRecompute, chunk, P, TH)
          .floats() *
      sizeof(float);
  const cudaError_t e = allow_smem(kernel, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  kernel<<<grid, kThreads, bytes, stream>>>(src, camera, projector, cam_s,
                                            cam_e2, proj_s, proj_e2, a1, bm,
                                            grmu, H, W, D, k, chunk, d_lo,
                                            d_hi, eps);
  return cudaGetLastError();
}

// The rounds kernel at `round`, grad_round's planes a round (one of the
// powers of two it is instantiated at) and projector chunk, at a tile of
// TH rows.
template <class Source, bool kRecompute, bool kSlab, int TH = kTileH>
cudaError_t launch_rounds_at(Rounds round, const Source& src,
                             const float* camera, const float* projector,
                             const float* cam_s, const float* cam_e2,
                             const float* proj_s, const float* proj_e2,
                             float* a1, float* bm, float* grmu, int B, int H,
                             int W, int D, int k, int d_lo, int d_hi,
                             float eps, cudaStream_t stream,
                             Tile<TH> tile = {}) {
  static_assert(kGradPlanes == 8, "the planes a round instantiated below");
  switch (round.planes) {
    case 8:
      return launch_rounds<Source, kRecompute, kSlab, 8>(
          src, camera, projector, cam_s, cam_e2, proj_s, proj_e2, a1, bm,
          grmu, B, H, W, D, k, round.chunk, d_lo, d_hi, eps, stream, tile);
    case 4:
      return launch_rounds<Source, kRecompute, kSlab, 4>(
          src, camera, projector, cam_s, cam_e2, proj_s, proj_e2, a1, bm,
          grmu, B, H, W, D, k, round.chunk, d_lo, d_hi, eps, stream, tile);
    case 2:
      return launch_rounds<Source, kRecompute, kSlab, 2>(
          src, camera, projector, cam_s, cam_e2, proj_s, proj_e2, a1, bm,
          grmu, B, H, W, D, k, round.chunk, d_lo, d_hi, eps, stream, tile);
    case 1:
      return launch_rounds<Source, kRecompute, kSlab, 1>(
          src, camera, projector, cam_s, cam_e2, proj_s, proj_e2, a1, bm,
          grmu, B, H, W, D, k, round.chunk, d_lo, d_hi, eps, stream, tile);
    default:
      // Not one plane's buffers fit beside the block's tiles.
      return cudaErrorInvalidConfiguration;
  }
}

// The rounds kernel over d = 0..D at a tile of TH rows, at the planes a
// round and chunk that grad_round gives within `budget` floats.
template <class Source, bool kRecompute, int TH = kTileH>
cudaError_t launch_all_planes(const Source& src, const float* camera,
                              const float* projector, const float* cam_s,
                              const float* cam_e2, const float* proj_s,
                              const float* proj_e2, float* a1, float* bm,
                              float* grmu, int B, int H, int W, int D, int k,
                              float eps, size_t budget, cudaStream_t stream,
                              Tile<TH> tile = {}) {
  return launch_rounds_at<Source, kRecompute, false>(
      grad_round(k, D, staged_consts<Source>(), kRecompute, budget, TH), src,
      camera, projector, cam_s, cam_e2, proj_s, proj_e2, a1, bm, grmu, B, H,
      W, D, k, 0, D, eps, stream, tile);
}

// The planes of a slab of the chunked route.
constexpr int kCostChunk = 8;

// The chunked route (K5 and K6 where their recomputing blocks do not
// fit): for each slab [lo, hi] of kCostChunk planes, K1's rounds kernel
// over those planes (the head off, beta = 1, on the statistics of
// launch_grad_stats, which are K1's) writes their costs into `slab`,
// [B, hi - lo + 1, H, W], then the rounds kernel in slab mode, its source
// make_source(slab), adds them to A1, B and GRMU.  `slab` holds at least
// B kCostChunk H W floats (min(kCostChunk, D + 1) planes a frame).
template <class Source, class MakeSource>
cudaError_t launch_cost_slabs(const MakeSource& make_source,
                              const float* camera, const float* projector,
                              const float* cam_s, const float* cam_e2,
                              const float* proj_s, const float* proj_e2,
                              float* slab, float* a1, float* bm, float* grmu,
                              int B, int H, int W, int D, int k, float eps,
                              size_t budget, cudaStream_t stream) {
  // The caller allocates the slab where this route runs (its Python
  // wrapper mirrors the choice: kernel_model.cost_slab_planes).
  if (slab == nullptr) return cudaErrorInvalidValue;
  for (int lo = 0; lo <= D; lo += kCostChunk) {
    const int hi = lo + kCostChunk - 1 < D ? lo + kCostChunk - 1 : D;
    cudaError_t e = launch_fused<false, false, false, true, true>(
        camera, projector, cam_s, cam_e2, proj_s, proj_e2, nullptr, nullptr,
        nullptr, nullptr, slab, nullptr, nullptr, nullptr, B, H, W, D, k, lo,
        hi, eps, 1.f, 0.f, stream);
    if (e != cudaSuccess) return e;
    e = launch_rounds_at<Source, false, true>(
        grad_round(k, hi - lo, staged_consts<Source>(), false, budget),
        make_source(slab), camera, projector, cam_s, cam_e2, proj_s, proj_e2,
        a1, bm, grmu, B, H, W, D, k, lo, hi, eps, stream);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace
}  // namespace custereo
