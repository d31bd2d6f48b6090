// K8b: the camera VJP of the all-pairs ZNCC volume on Hopper.
//
// Replaces no TPU kernel: the JAX package leaves this backward to XLA
// (custereomatching_tpu/ops/zncc.py:_camera_grad_allpairs), and the port's
// plain version is ops/zncc.py::camera_grad_allpairs, which on the card
// took about 330 launches over [B, H, W, W] intermediates.  K8b computes
// the same values in another order of sums.
//
// What it computes, per frame b, output row y, camera column x and
// projector column w (K8's [H, W, W] layout), from the cotangent g, the
// cost residual c = n r and K8's window statistics:
//   r           = rsqrt(ex2[y, x] ey2[y, w] + eps),  gr = g r
//   B[y, x]     = sum_w g c r^2 ey2[y, w]
//   GRMU[y, x]  = sum_w gr muy[y, w]
//   G2[y, x, w] = sum_{|i| <= p} gr[y + i, x, w]      (zero outside the rows)
//   E[y, x, j]  = sum_w G2[y, x, w] proj[y, w + j - p] (zero outside the row)
//   A1[y, x]    = sum_j E[y, x + p - j, j]
//   grad        = A1 - box(GRMU) + box(B mux) - cam box(B)
// Only the taps j in [p - W + 1, p + W) can meet a projector column, so
// where k // 2 >= W the others are skipped (they add nothing).
//
// Precision: exact fp32 FMAs and adds on the CUDA cores (no TF32 or bf16
// product), as K8 and the plain version.
//
// What bounds it on the H100: bytes.  The function must read the
// cotangent and the cost once each, 2 x 4 H W^2 bytes (470 MB at the
// 330 x 422, k = 15 verify shape, 0.14 ms at 3.35 TB/s); its arithmetic
// is about (2k + 9) operations an entry (2.3 GFLOP there, 0.03 ms at the
// 67 TFLOP/s fp32 peak) and an rsqrt an entry.  So the design keeps every
// [H, W, W] intermediate on the chip, reads the cost once and the
// cotangent once from memory (its halo rows again, mostly from L2), and
// keeps those reads in flight while it computes:
//   1. allpairs_grad_kernel: a block of kGbThreads threads owns a strip of
//      kGbRows output rows and kGbTileX camera columns and walks the
//      projector columns in chunks of kGbChunkW, a thread a (camera,
//      projector) column, so a warp reads 32 neighbouring floats of a
//      volume row and a camera column's warps kGbChunkW contiguous floats
//      (a row of W floats is not 16-byte aligned for odd W, so a thread
//      loads 4 bytes).  Each thread streams its column's rows, the
//      strip's and their k - 1 halo rows, chunk after chunk, into
//      registers kGbAhead rows ahead of their use; the halo rows are read
//      again by the neighbouring strips, which run beside it (the strips
//      go fastest in the grid), so mostly from L2.  Four blocks an SM.
//      A chunk:
//        a. gr formed at every row and summed over the k rows in
//           registers by common.cuh's window_sweep (the register-blocked
//           pass of K1-K8: kGbRows outputs from kGbRows + k - 1 entries),
//           so G2 never leaves the block; at the own rows gr and B's
//           entry g c r^2 ey2 are staged in shared memory;
//        b. a thread sums a 32-column split of one pair's (output row,
//           camera column) staged GRMU or B entries;
//        c. G2 staged in shared memory; an E unit (a pair, kGbTaps taps
//           and a 32-column split) adds its columns with the projector
//           row slid through registers: per column one shared load of G2
//           and one of the projector for kGbTaps FMAs.  GRMU adds its
//           columns in the same order, so at k = 1, where G2 = gr and
//           muy = proj, A1 and GRMU are equal and the gradient is exactly
//           zero, as the function's.
//      E, GRMU and B stay in shared memory across the chunks, a partial a
//      split, and leave once, the splits summed in order; E as a [B, H,
//      taps, W] buffer (8.4 MB at the verify shape).  Past kGbTapChunk
//      taps (k >= 129 with W > 64) the columns are walked again for each
//      chunk of taps.
//   2. allpairs_grad_a1_kernel: A1 by the diagonal sum over the taps, j
//      ascending, as the plain version adds them.
//   3. camera_grad.cuh's combine kernel (launch_grad_combine), as K2, K4
//      and K6 call it, where its tiles fit (k <= 193 on an H100); beyond,
//      the wrapper finishes with the large-k route's combine.
#include "camera_grad.cuh"

namespace custereo {
namespace {

constexpr int kGbThreads = 256;
constexpr int kGbTileX = 4;    // camera columns of a block
constexpr int kGbChunkW = kGbThreads / kGbTileX;  // projector columns a chunk
constexpr int kGbRows = 16;    // output rows of a block's strip
constexpr int kGbPairs = kGbRows * kGbTileX;  // (row, camera column) pairs
constexpr int kGbSplits = kGbChunkW / 32;     // 32-column splits of a chunk
constexpr int kGbTaps = 8;        // taps of an E unit
constexpr int kGbTapChunk = 128;  // most taps a walk over the columns
constexpr int kGbAhead = 4;       // rows a thread's loads run ahead
constexpr int kGbStride = kGbChunkW + 1;  // a pair's staged columns, padded
static_assert(kGbChunkW % 32 == 0, "whole warps a camera column");
static_assert(kGbTapChunk % kGbTaps == 0, "whole groups of taps");
static_assert(2 * kGbSplits * kGbPairs == kGbThreads,
              "a thread a split of a pair's GRMU or B");

// Groups of kGbTaps taps in a walk of `chunk` taps.
__host__ __device__ inline int tap_groups(int chunk) {
  return (chunk + kGbTaps - 1) / kGbTaps;
}

// The most groups of a walk, for `taps` taps in all.
__host__ __device__ inline int walk_groups(int taps) {
  return tap_groups(taps < kGbTapChunk ? taps : kGbTapChunk);
}

// Floats of a row of the staged projector: a chunk's columns and a
// walk's taps, padded to an odd count.
__host__ __device__ inline int projector_stride(int taps) {
  return (kGbChunkW + walk_groups(taps) * kGbTaps) | 1;
}

// Shared memory of a block in floats, for `taps` taps in all: the own
// rows' gr (then G2) and B entries of a chunk (a pair's columns each), the
// strip's projector rows over the chunk's columns and a walk's taps and
// its sy rows, and a split's partial sums of GRMU, B and a walk's E.
inline size_t allpairs_grad_smem_floats(int taps) {
  const size_t groups = walk_groups(taps);
  return 2 * static_cast<size_t>(kGbPairs) * kGbStride +
         kGbRows * (projector_stride(taps) + kGbChunkW) +
         kGbSplits * kGbPairs * (2 + groups * kGbTaps);
}

// A 4-byte copy from global to shared memory that does not wait
// (cp.async), and the wait for all of the thread's copies; the "memory"
// clobbers keep the compiler from moving shared accesses across them.
// Without a device (the host pass) the copy is a plain one.
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void copy_wait_all() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// Grid: (ceil(H / kGbRows), ceil(W / kGbTileX), B); kGbThreads threads.
// Block (strip, tile, b) writes bm and grmu at its strip's rows and tile's
// columns, and e_out[b][h][t][x] there for every tap t < taps (tap j =
// j_lo + t).
__global__ void __launch_bounds__(kGbThreads, 4)
    allpairs_grad_kernel(const float* __restrict__ cotangent,
                         const float* __restrict__ cost,
                         const float* __restrict__ projector,
                         const float* __restrict__ cam_e2,
                         const float* __restrict__ proj_s,
                         const float* __restrict__ proj_e2,
                         float* __restrict__ e_out, float* __restrict__ bm,
                         float* __restrict__ grmu, int H, int W, int k,
                         int j_lo, int taps, float eps) {
  extern __shared__ float smem[];
  const int p = k / 2, rows = kGbRows + k - 1;
  const int b = blockIdx.z, h0 = blockIdx.x * kGbRows;
  const int x0 = blockIdx.y * kGbTileX;
  const int tid = threadIdx.x;
  const int xl = tid / kGbChunkW, wl = tid - xl * kGbChunkW;
  const int x = x0 + xl, xc = x < W ? x : W - 1;
  const int psw = projector_stride(taps);
  float* grs = smem;                        // [pair][kGbStride]: gr, then G2
  float* bes = grs + kGbPairs * kGbStride;  // [pair][kGbStride]: B entries
  float* ps = bes + kGbPairs * kGbStride;   // [row][psw]: projector
  float* mus = ps + kGbRows * psw;          // [row][kGbChunkW]: sy
  float* sums = mus + kGbRows * kGbChunkW;  // [GRMU, B][split][pair]
  float* es = sums + 2 * kGbSplits * kGbPairs;  // [split][tap][item]: E
  const size_t plane = static_cast<size_t>(H) * W;
  const float* proj_b = projector + b * plane;
  const float* proj_s_b = proj_s + b * plane;
  const float* cam_e2_b = cam_e2 + b * plane;
  const float* proj_e2_b = proj_e2 + b * plane;
  const float k2 = static_cast<float>(k * k);
  const int chunks = (W + kGbChunkW - 1) / kGbChunkW;
  sums[tid] = 0.f;

  // The walk's stream of the thread's cotangent entries, chunk after
  // chunk, rows li of chunk lc's strip and halo, loaded kGbAhead rows
  // ahead of their use (the cost with them at the own rows on the first
  // walk); the addresses are clamped into the volume, the values of rows
  // and columns outside it never used.
  float pg[kGbAhead], pc[kGbAhead];
  int lc = 0, li = 0;
  bool lfirst = true;
  const size_t vol_b = static_cast<size_t>(b) * H;
  const auto fetch = [&](float& g, float& c) {
    const int hh = h0 - p + li, hc = hh < 0 ? 0 : (hh < H ? hh : H - 1);
    const int wf = lc * kGbChunkW + wl, wfc = wf < W ? wf : W - 1;
    const size_t o = ((vol_b + hc) * W + xc) * W + wfc;
    g = __ldg(cotangent + o);
    const int n = li - p;
    c = lfirst && n >= 0 && n < kGbRows ? __ldg(cost + o) : 0.f;
    if (++li == rows) {
      li = 0;
      ++lc;
    }
  };
  for (int t0 = 0; t0 < taps; t0 += kGbTapChunk) {
    const bool first = t0 == 0;
    lc = 0;
    li = 0;
    lfirst = first;
#pragma unroll
    for (int j = 0; j < kGbAhead; ++j) fetch(pg[j], pc[j]);
    const int jc = taps - t0 < kGbTapChunk ? taps - t0 : kGbTapChunk;
    const int groups = tap_groups(jc);
    const int items = kGbPairs * groups;
    // Projector column of a chunk's staged entry m: w0 + m + col0.
    const int col0 = j_lo + t0 - p;
    for (int i = tid; i < kGbSplits * kGbTaps * items; i += kGbThreads)
      es[i] = 0.f;

    for (int chunk = 0; chunk < chunks; ++chunk) {
      const int w0 = chunk * kGbChunkW, w = w0 + wl;
      const bool live = x < W && w < W;
      const int wc = w < W ? w : W - 1;
      // The chunk's projector rows and (first walk) sy rows, staged by the
      // block while the sweep runs.
      for (int i = tid; i < kGbRows * psw; i += kGbThreads) {
        const int n = i / psw, m = i - n * psw;
        const int hp = h0 + n, col = w0 + m + col0;
        if (hp < H && col >= 0 && col < W)
          copy_async(ps + i, proj_b + static_cast<size_t>(hp) * W + col);
        else
          ps[i] = 0.f;
      }
      if (first) {
        for (int i = tid; i < kGbRows * kGbChunkW; i += kGbThreads) {
          const int n = i / kGbChunkW, m = i - n * kGbChunkW;
          const int hp = h0 + n, col = w0 + m;
          if (hp < H && col < W)
            copy_async(mus + i, proj_s_b + static_cast<size_t>(hp) * W + col);
          else
            mus[i] = 0.f;
        }
      }

      // a. G2 of the strip's rows, gr's k-row window in registers; at the
      // own rows (first walk) gr and B's entry staged.  window_sweep loads
      // the rows in order, so the stream moves a row a load.
      float acc[kGbRows];
#pragma unroll
      for (int n = 0; n < kGbRows; ++n) acc[n] = 0.f;
      int h = h0 - p;
      window_sweep(
          acc, k,
          [&](int) {
            const float gv = pg[0], cv = pc[0];
#pragma unroll
            for (int j = 0; j + 1 < kGbAhead; ++j) {
              pg[j] = pg[j + 1];
              pc[j] = pc[j + 1];
            }
            fetch(pg[kGbAhead - 1], pc[kGbAhead - 1]);
            const bool valid = live && h >= 0 && h < H;
            const int hc = h < 0 ? 0 : (h < H ? h : H - 1);
            const size_t row = static_cast<size_t>(hc) * W;
            const float ey2 = __ldg(proj_e2_b + row + wc);
            const float rr = rsqrtf(__ldg(cam_e2_b + row + xc) * ey2 + eps);
            const float gr = valid ? gv * rr : 0.f;
            const int n = h - h0;
            if (first && n >= 0 && n < kGbRows) {
              const int so = (n * kGbTileX + xl) * kGbStride + wl;
              grs[so] = gr;
              bes[so] = valid ? gv * cv * (rr * rr) * ey2 : 0.f;
            }
            ++h;
            return gr;
          },
          [](float& s, float v) { s += v; });
      copy_wait_all();
      __syncthreads();

      // b. GRMU and B over the chunk's own rows (first walk): a thread a
      // split of a pair's columns of one.  GRMU adds in E's order.
      if (first) {
        const int map = tid / (kGbSplits * kGbPairs);
        const int s = (tid / kGbPairs) % kGbSplits, pair = tid % kGbPairs;
        const int o = pair * kGbStride + s * 32;
        float v = sums[tid];
        if (map == 0) {
          const float* mq = mus + (pair / kGbTileX) * kGbChunkW + s * 32;
#pragma unroll
          for (int c = 0; c < 32; ++c) v = fmaf(grs[o + c], mq[c], v);
        } else {
#pragma unroll
          for (int c = 0; c < 32; ++c) v += bes[o + c];
        }
        sums[tid] = v;
        __syncthreads();
      }
#pragma unroll
      for (int n = 0; n < kGbRows; ++n)
        grs[(n * kGbTileX + xl) * kGbStride + wl] = acc[n];
      __syncthreads();

      // c. E += the chunk's columns, a unit's taps slid through registers.
      for (int u = tid; u < kGbSplits * items; u += kGbThreads) {
        const int s = u / items, it = u - s * items;
        const int pair = it / groups, grp = it - pair * groups;
        const float* gq = grs + pair * kGbStride + s * 32;
        const float* pq =
            ps + (pair / kGbTileX) * psw + s * 32 + grp * kGbTaps;
        float* eq = es + s * kGbTaps * items + it;
        float e[kGbTaps], pv[kGbTaps];
#pragma unroll
        for (int jj = 0; jj < kGbTaps; ++jj) {
          e[jj] = eq[jj * items];
          pv[jj] = pq[jj];
        }
#pragma unroll
        for (int c = 0; c < 32; ++c) {
          const float gv = gq[c];
#pragma unroll
          for (int jj = 0; jj < kGbTaps; ++jj) e[jj] = fmaf(gv, pv[jj], e[jj]);
#pragma unroll
          for (int jj = 0; jj + 1 < kGbTaps; ++jj) pv[jj] = pv[jj + 1];
          pv[kGbTaps - 1] = pq[c + kGbTaps];
        }
#pragma unroll
        for (int jj = 0; jj < kGbTaps; ++jj) eq[jj * items] = e[jj];
      }
      __syncthreads();
    }

    // This walk's taps of E, out, the splits summed in order.
    for (int i = tid; i < kGbTaps * items; i += kGbThreads) {
      const int jj = i / items, it = i - jj * items;
      const int pair = it / groups, grp = it - pair * groups;
      const int tap = grp * kGbTaps + jj;
      const int h = h0 + pair / kGbTileX, xo = x0 + pair % kGbTileX;
      float v = 0.f;
#pragma unroll
      for (int s = 0; s < kGbSplits; ++s) v += es[s * kGbTaps * items + i];
      if (tap < jc && h < H && xo < W)
        e_out[((static_cast<size_t>(b) * H + h) * taps + t0 + tap) * W +
              xo] = v;
    }
    __syncthreads();
  }

  // GRMU (its sums are of gr sy: muy = sy / k^2) and B, the splits summed
  // in order.
  const int h = h0 + tid / kGbTileX, xo = x0 + tid % kGbTileX;
  if (tid < kGbPairs && h < H && xo < W) {
    float gm = 0.f, bv = 0.f;
#pragma unroll
    for (int s = 0; s < kGbSplits; ++s) {
      gm += sums[s * kGbPairs + tid];
      bv += sums[(kGbSplits + s) * kGbPairs + tid];
    }
    const size_t o = (static_cast<size_t>(b) * H + h) * W + xo;
    bm[o] = bv;
    grmu[o] = gm / k2;
  }
}

// A1[b, h, x] = sum_t e[b, h, t, x + p - j_lo - t] over the columns in the
// image, t ascending.  A thread a pixel.
__global__ void __launch_bounds__(kGbThreads)
    allpairs_grad_a1_kernel(const float* __restrict__ e,
                            float* __restrict__ a1, int B, int H, int W,
                            int p, int j_lo, int taps) {
  const size_t n = static_cast<size_t>(B) * H * W;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t row = i / W;
    const int x = static_cast<int>(i - row * W);
    const float* er = e + row * taps * W;
    float s = 0.f;
    for (int t = 0; t < taps; ++t) {
      const int xs = x + p - j_lo - t;
      if (xs >= 0 && xs < W) s += __ldg(er + static_cast<size_t>(t) * W + xs);
    }
    a1[i] = s;
  }
}

}  // namespace
}  // namespace custereo

using namespace custereo;

// Plain C interface, loaded with ctypes.  cotangent/cost: [B, H, W, W];
// camera/projector and K8's statistics cam_s/cam_e2/proj_s/proj_e2:
// [B, H, W]; scratch e: [B, H, taps, W] (tap j = j_lo + t), a1/bm/grmu:
// [B, H, W]; grad: [B, H, W], or null to stop after a1, bm and grmu (the
// wrapper then combines on the large-k route); all fp32, contiguous, on
// the current device.  Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() (0 when every launch was accepted).
extern "C" int custereo_allpairs_grad(
    const float* cotangent, const float* cost, const float* camera,
    const float* projector, const float* cam_s, const float* cam_e2,
    const float* proj_s, const float* proj_e2, float* e, float* a1,
    float* bm, float* grmu, float* grad, int B, int H, int W, int k,
    int j_lo, int taps, float eps, void* stream_ptr) {
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t bytes = allpairs_grad_smem_floats(taps) * sizeof(float);
  cudaError_t err = allow_smem(allpairs_grad_kernel, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((H + kGbRows - 1) / kGbRows, (W + kGbTileX - 1) / kGbTileX,
                  B);
  allpairs_grad_kernel<<<grid, kGbThreads, bytes, stream>>>(
      cotangent, cost, projector, cam_e2, proj_s, proj_e2, e, bm, grmu, H, W,
      k, j_lo, taps, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t pixels = static_cast<size_t>(B) * H * W;
  const size_t blocks = (pixels + kGbThreads - 1) / kGbThreads;
  allpairs_grad_a1_kernel<<<blocks < 65535 ? blocks : 65535, kGbThreads, 0,
                            stream>>>(e, a1, B, H, W, k / 2, j_lo, taps);
  err = cudaGetLastError();
  if (err != cudaSuccess || grad == nullptr) return err;

  size_t budget = 0;
  err = optin_floats(&budget);
  if (err != cudaSuccess) return err;
  return launch_grad_combine(camera, cam_s, a1, bm, grmu, grad, B, H, W, k,
                             budget, stream);
}
