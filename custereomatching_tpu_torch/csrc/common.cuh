// Shared pieces of the port's hand-written Hopper kernels (sm_90a):
// the block tile, the zero-padded staging of a halo'd image tile, the
// separable k x k window sums, and the window-statistics pass that every
// banded kernel runs first.
//
// Numerical contract (as custereomatching_tpu/ops/zncc.py): windows read
// zeros outside the image, means divide by k^2 including the padding, and
// cost = (exy + eps) / sqrt(ex2 * ey2 + eps), all in fp32.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace custereo {

// One block owns a kTileH x kTileW tile of output pixels, one thread per
// pixel; a thread keeps its pixel's per-frame state in registers.
constexpr int kTileH = 16;
constexpr int kTileW = 64;
constexpr int kThreads = kTileH * kTileW;
constexpr size_t kDefaultSmem = 48 * 1024;

// The rounds kernels of K1, K3 (K3w, K3m) and K4 also run at a tile of TH
// rows and kThreads / TH columns (TH = 8, 16, 32: 8 x 128 and 32 x 32
// besides the default), still one 1024-thread block an SM; every other
// kernel runs the default.  The tag passes TH to the launchers, whose
// template arguments it completes.
template <int TH>
struct Tile {
  static_assert(kThreads % TH == 0, "a tile of kThreads pixels");
  static constexpr int kH = TH;
  static constexpr int kW = kThreads / TH;
};

// Shared-memory geometry of a plane kernel with a th x tw pixel tile, in
// floats:
//   camera tile     rows x cam_w   image rows [h0-p, h0+th+p), cols [w0-p, w0+tw+p)
//   projector tile  rows x proj_w  the same rows, cols [w0-p-D, w0+tw+p)
//   vertical sums   th x cam_w     one disparity plane at a time
struct PlaneTile {
  int p, th, tw, rows, cam_w, proj_w;
  __host__ __device__ PlaneTile(int k, int D, int th = kTileH)
      : p(k / 2),
        th(th),
        tw(kThreads / th),
        rows(th + 2 * (k / 2)),
        cam_w(kThreads / th + 2 * (k / 2)),
        proj_w(kThreads / th + 2 * (k / 2) + D) {}
  __host__ __device__ size_t floats() const {
    return static_cast<size_t>(rows) * cam_w +
           static_cast<size_t>(rows) * proj_w +
           static_cast<size_t>(th) * cam_w;
  }
};

// dst[r][c] = scale * src[row0 + r][col0 + c] for r < rows, c < width, and
// zero where that pixel lies outside the H x W image.
__device__ inline void stage_tile(float* dst, const float* __restrict__ src,
                                  int H, int W, int row0, int col0, int rows,
                                  int width, float scale) {
  for (int i = threadIdx.x; i < rows * width; i += blockDim.x) {
    const int r = i / width, c = i - r * width;
    const int h = row0 + r, x = col0 + c;
    dst[i] = (h >= 0 && h < H && x >= 0 && x < W)
                 ? scale * __ldg(src + static_cast<size_t>(h) * W + x)
                 : 0.f;
  }
}

// K1's first window pass, which the boxadd rate probe (rate_probes.cu)
// still runs, and whose columns pass the statistics and combine kernels
// run.  Rows pass of one disparity plane's cross term:
//   vsum[r][c] = sum_{t<k} cam_t[r+t][c] * proj_t[r+t][c + shift]
// for r < kTileH, c < cam_w.  Camera tile column c pairs with projector
// tile column c + D - d for disparity d, so shift = D - d.
__device__ inline void vertical_products(float* vsum, const float* cam_t,
                                         const float* proj_t,
                                         const PlaneTile& g, int k,
                                         int shift) {
  for (int i = threadIdx.x; i < kTileH * g.cam_w; i += blockDim.x) {
    const int r = i / g.cam_w, c = i - r * g.cam_w;
    const float* a = cam_t + r * g.cam_w + c;
    const float* b = proj_t + r * g.proj_w + c + shift;
    float acc = 0.f;
    for (int t = 0; t < k; ++t) acc = fmaf(a[t * g.cam_w], b[t * g.proj_w], acc);
    vsum[i] = acc;
  }
}

// Columns pass: the k x k window sum of output pixel (r, c) of the tile.
__device__ inline float horizontal_sum(const float* vsum, int cam_w, int r,
                                       int c, int k) {
  const float* v = vsum + r * cam_w + c;
  float acc = 0.f;
  for (int t = 0; t < k; ++t) acc += v[t];
  return acc;
}

// ---------------------------------------------------------------------------
// The register-blocked window pass (K1, K2, K3, K3w, K3m, K4, K5, K6, K7
// and, over whole row products, K8).  The boxadd rate probe keeps the pass
// above.
//
// One work item makes N adjacent outputs of a window of k taps along one
// line (a column of rows, or a row of columns) from N + k - 1 loads of each
// operand, where the pass above makes k loads an output:
//   acc[n] = sum_{t<k} a[(n + t) as] * b[(n + t) bs]    (kProducts: fmaf)
//   acc[n] = sum_{t<k} a[(n + t) as]                    (sums: +)
// Each output adds its taps t = 0..k-1 in order, from 0, with fmaf for
// products and + for sums, as vertical_products, horizontal_sum and
// vertical_sum do: the operands come from registers, the
// arithmetic is theirs, so the values are theirs bit for bit.  Line entry
// i feeds the outputs n with 0 <= i - n < k; for k >= N - 1 the first and
// last N - 1 entries feed a set of outputs known at compile time, and the
// middle entries feed all N, so no tap is predicated.  A smaller k takes
// the predicated loop (same taps, same order).
template <bool kProducts>
__device__ __forceinline__ float window_tap(float acc, float x, float y) {
  if constexpr (kProducts)
    return fmaf(x, y, acc);
  else
    return acc + x;
}

// The loop structure of window_taps for any types: entry i of a line is
// load(i), and tap(acc[n], entry) adds it to output n, each output's taps
// t = 0..k-1 in order.  K8 (zncc_allpairs.cu) sums whole register
// tiles of row products so.
template <int N, class T, class Load, class Tap>
__device__ __forceinline__ void window_sweep(T (&acc)[N], int k,
                                             const Load& load,
                                             const Tap& tap) {
  if (k >= N - 1) {
#pragma unroll
    for (int i = 0; i < N - 1; ++i) {
      const auto x = load(i);
#pragma unroll
      for (int n = 0; n <= i; ++n) tap(acc[n], x);
    }
#pragma unroll 2
    for (int i = N - 1; i < k; ++i) {
      const auto x = load(i);
#pragma unroll
      for (int n = 0; n < N; ++n) tap(acc[n], x);
    }
#pragma unroll
    for (int j = 0; j < N - 1; ++j) {
      const auto x = load(k + j);
#pragma unroll
      for (int n = j + 1; n < N; ++n) tap(acc[n], x);
    }
  } else {
    for (int i = 0; i < N - 1 + k; ++i) {
      const auto x = load(i);
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const int t = i - n;
        if (t >= 0 && t < k) tap(acc[n], x);
      }
    }
  }
}

template <int N, bool kProducts>
__device__ __forceinline__ void window_taps(float (&acc)[N], const float* a,
                                            int as, const float* b, int bs,
                                            int k) {
#pragma unroll
  for (int n = 0; n < N; ++n) acc[n] = 0.f;
  struct Entry {
    float x, y;
  };
  window_sweep(
      acc, k,
      [&](int i) { return Entry{a[i * as], kProducts ? b[i * bs] : 0.f}; },
      [](float& s, const Entry& e) {
        s = window_tap<kProducts>(s, e.x, e.y);
      });
}

// The first output of group q of a line of `len` outputs cut in groups of
// N: the last group is moved back to end at the line's end, so it reads
// nothing past it (its outputs shared with the group before are computed
// twice, to the same value).  len >= N.
template <int N>
__device__ __forceinline__ int group_start(int q, int len) {
  return min(q * N, len - N);
}

// K3's round, which K1 and K6 run too: P planes of the rows pass
// (kRoundRows output rows a column, the whole tile height: TH at a tile of
// TH rows), one barrier, P planes of column sums (kRoundCols outputs a
// row), one barrier; then each pixel's thread reads its P sums in plane
// order.  Rows of the round's buffers are padded to an odd stride, so the
// column sums' 32 rows of a warp hit 32 banks.
constexpr int kRoundRows = 16;
constexpr int kRoundCols = 16;
static_assert(kRoundRows == kTileH, "the rows pass covers the tile height");
static_assert(Tile<8>::kW % kRoundCols == 0 &&
                  Tile<16>::kW % kRoundCols == 0 &&
                  Tile<32>::kW % kRoundCols == 0,
              "column groups tile the width of every tile");

// Shared-memory geometry of K3's round, in floats, after PlaneTile's two
// image tiles: `planes` planes of the rows pass (th x vs, vs = cam_w + 1)
// and of the window sums (th x bs, bs = tw + 1).
struct RoundTile {
  int th, tw, vs, bs, planes;
  __host__ __device__ RoundTile(const PlaneTile& g, int planes)
      : th(g.th), tw(g.tw), vs(g.cam_w + 1), bs(g.tw + 1), planes(planes) {}
  __host__ __device__ int vsum_floats() const { return th * vs; }
  __host__ __device__ int box_floats() const { return th * bs; }
  __host__ __device__ static size_t image_floats(const PlaneTile& g) {
    return static_cast<size_t>(g.rows) * (g.cam_w + g.proj_w);
  }
  __host__ __device__ size_t floats(const PlaneTile& g) const {
    return image_floats(g) +
           static_cast<size_t>(planes) * (vsum_floats() + box_floats());
  }
};

// The most planes a projector staging can cover within `budget` floats
// of shared memory, when a block holds `fixed` floats beside a staging of
// `rows` image rows that grows by a column a plane and takes `one_plane`
// floats at one plane; capped at D + 1; 0 when not even one plane fits.
inline int staging_chunk(int D, size_t fixed, size_t one_plane, int rows,
                         size_t budget) {
  const size_t one = fixed + one_plane;
  if (one > budget) return 0;
  const size_t more = (budget - one) / rows;
  return static_cast<int>(more + 1 < static_cast<size_t>(D) + 1
                              ? more + 1
                              : static_cast<size_t>(D) + 1);
}

// Planes a round, and planes a staging of the projector tile, of a kernel
// that walks the planes in rounds (K1 and K3, K4, K5, K6, K7).
struct Rounds {
  int planes, chunk;
};

// {planes, chunk} with a chunk short of D + 1 cut to a whole number of
// rounds, or the round cut to the chunk where the chunk is the smaller.
inline Rounds whole_rounds(int planes, int chunk, int D) {
  if (chunk < D + 1) {
    if (chunk < planes)
      planes = chunk;
    else
      chunk -= chunk % planes;
  }
  return {planes, chunk};
}

// Planes a round and a projector staging of K1 and K3 at a tile of th
// rows within `budget` floats of shared memory: as many planes a round as
// give every thread one rows-pass column (kThreads / cam_w), fewer where
// they do not fit beside the camera tile and a one-plane projector tile,
// and no more than D + 1; the projector staging takes what is left: all
// D + 1 planes where they fit, else a multiple of the round.  `want` > 0
// asks for that many planes a round instead (no more than D + 1), refused
// where they do not fit.  {0, 0} when not one plane (or not `want`) fits.
inline Rounds fused_round(int k, int D, size_t budget, int th = kTileH,
                          int want = 0) {
  const PlaneTile g(k, 0, th);
  const RoundTile one(g, 1);
  const size_t fixed = RoundTile::image_floats(g);
  const size_t per = static_cast<size_t>(one.vsum_floats()) + one.box_floats();
  if (fixed + per > budget) return {0, 0};
  size_t planes = want > 0 ? want : kThreads / g.cam_w;
  if (planes < 1) planes = 1;
  if (planes > static_cast<size_t>(D) + 1) planes = static_cast<size_t>(D) + 1;
  if (planes > (budget - fixed) / per) {
    if (want > 0) return {0, 0};
    planes = (budget - fixed) / per;
  }
  const size_t cam = static_cast<size_t>(g.rows) * g.cam_w;
  return whole_rounds(
      static_cast<int>(planes),
      staging_chunk(D, cam + planes * per, cam, g.rows, budget), D);
}

// Rows pass of `np` planes: vsum[j][r][c] = sum_{t<k} cam_t[r + t][c] *
// proj_t[r + t][c + shift0 - j] for r < TH, c < cam_w (plane d0 + j reads
// the projector at shift D - d0 - j).  An item is a column of one plane:
// TH outputs (kRoundRows at the default tile).
template <int TH = kTileH>
__device__ inline void round_products(float* vsum, const float* cam_t,
                                      const float* proj_t, const PlaneTile& g,
                                      const RoundTile& x, int k, int shift0,
                                      int np) {
  for (int i = threadIdx.x; i < np * g.cam_w; i += blockDim.x) {
    const int j = i / g.cam_w, c = i - j * g.cam_w;
    float acc[TH];
    window_taps<TH, true>(acc, cam_t + c, g.cam_w, proj_t + c + shift0 - j,
                          g.proj_w, k);
    float* out = vsum + j * x.vsum_floats() + c;
#pragma unroll
    for (int n = 0; n < TH; ++n) out[n * x.vs] = acc[n];
  }
}

// Column sums of `np` planes: box[j][r][c] = sum_{t<k} vsum[j][r][c + t]
// for r < th, c < tw.  An item is kRoundCols outputs of one row; a warp's
// items are consecutive rows (planes continue the rows).
__device__ inline void round_column_sums(float* box, const float* vsum,
                                         const RoundTile& x, int k, int np) {
  const int groups = x.tw / kRoundCols;
  const int lines = np * x.th;
  for (int i = threadIdx.x; i < lines * groups; i += blockDim.x) {
    const int q = i / lines, line = i - q * lines;
    float acc[kRoundCols];
    window_taps<kRoundCols, false>(acc, vsum + line * x.vs + q * kRoundCols,
                                   1, nullptr, 0, k);
    float* out = box + line * x.bs + q * kRoundCols;
#pragma unroll
    for (int n = 0; n < kRoundCols; ++n) out[n] = acc[n];
  }
}

// Internal linkage: each translation unit that includes this header gets
// its own copy of the statistics kernel and its launcher.
namespace {

// Window statistics of one image per frame, for output columns j in
// [0, wout) that sit at image column j - col_off.  col_off = D widens the
// projector's statistics to the columns x - d < 0 that its band reads;
// windows there still reach real pixels, so they are not zero.
//   s  = box(scale * img)
//   e2 = (box((scale * img)^2) - s^2 / k^2) / scale^2
// Grid: (ceil(wout / kTileW), ceil(H / kTileH), B), kThreads threads.
__global__ void __launch_bounds__(kThreads)
    box_stats_kernel(const float* __restrict__ img, float* __restrict__ s_out,
                     float* __restrict__ e2_out, int H, int W, int k,
                     int col_off, int wout, float scale, float inv_scale2) {
  extern __shared__ float smem[];
  const int p = k / 2, rows = kTileH + 2 * p, cols = kTileW + 2 * p;
  float* tile = smem;
  float* v1 = tile + rows * cols;
  float* v2 = v1 + kTileH * cols;
  const int b = blockIdx.z, h0 = blockIdx.y * kTileH, j0 = blockIdx.x * kTileW;

  stage_tile(tile, img + static_cast<size_t>(b) * H * W, H, W, h0 - p,
             j0 - col_off - p, rows, cols, scale);
  __syncthreads();
  for (int i = threadIdx.x; i < kTileH * cols; i += blockDim.x) {
    const int r = i / cols, c = i - r * cols;
    float a = 0.f, a2 = 0.f;
    for (int t = 0; t < k; ++t) {
      const float v = tile[(r + t) * cols + c];
      a += v;
      a2 = fmaf(v, v, a2);
    }
    v1[i] = a;
    v2[i] = a2;
  }
  __syncthreads();

  const int r = threadIdx.x / kTileW, c = threadIdx.x % kTileW;
  const int h = h0 + r, j = j0 + c;
  if (h >= H || j >= wout) return;
  const float a = horizontal_sum(v1, cols, r, c, k);
  const float a2 = horizontal_sum(v2, cols, r, c, k);
  const float inv_k2 = 1.f / static_cast<float>(k * k);
  const size_t o = (static_cast<size_t>(b) * H + h) * wout + j;
  s_out[o] = a;
  e2_out[o] = (a2 - a * a * inv_k2) * inv_scale2;
}

// Opts a kernel into more than 48 KB of dynamic shared memory.  A block
// past the card's opt-in budget is refused with the error returned and
// none left pending: the runtime records the failed call, and the next
// cudaGetLastError on this thread (the port's launchers' or PyTorch's)
// would report it against a launch that was fine.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) cudaGetLastError();
  return e;
}

inline cudaError_t launch_box_stats(const float* img, float* s, float* e2,
                                    int B, int H, int W, int k, int col_off,
                                    int wout, float scale,
                                    cudaStream_t stream) {
  const int p = k / 2;
  const size_t cols = kTileW + 2 * p;
  const size_t bytes =
      sizeof(float) * ((kTileH + 2 * p) * cols + 2 * kTileH * cols);
  const cudaError_t e = allow_smem(box_stats_kernel, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((wout + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  box_stats_kernel<<<grid, kThreads, bytes, stream>>>(
      img, s, e2, H, W, k, col_off, wout, scale, 1.f / (scale * scale));
  return cudaGetLastError();
}

}  // namespace
}  // namespace custereo
