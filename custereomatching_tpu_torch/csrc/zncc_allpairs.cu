// K8: the all-pairs ZNCC cost volume on Hopper.
//
// Replaces: custereomatching_tpu/ops/pallas_allpairs.py:_allpairs_kernel
// (driven by pallas_cost_volume_allpairs).  Same values, not the same
// blocks: the TPU kernel's lane-rolled im2col stacks, 8-aligned pad rows
// and MXU contraction are TPU choices and are not carried over.
//
// What it computes, per frame b, row h, camera column x and projector
// column y (the reference's own [H, W, W] layout):
//   A[x, y] = sum_{i,j} cam_pad[h+i-p, x+j-p] * proj_pad[h+i-p, y+j-p]
//   cost    = (A - sx[x] sy[y] / k^2 + eps) / sqrt(ex2[x] ey2[y] + eps)
// with sx/sy the k x k window sums and ex2/ey2 the centred second moments
// (the statistics pass of common.cuh).  Each row's sum over j comes first,
// then the sum over the k rows, the order of the plain version
// (ops/zncc.py:forward_allpairs), so the two differ only by FMA rounding.
//
// Precision: exact fp32 FMAs on the CUDA cores, for the JAX op's
// "highest" and "default" alike (no TF32 tensor-core product).
//
// What bounds it on the H100: the function needs a 4 H W^2-byte write
// (235 MB at the 330 x 422, k = 15 verify shape, 0.07 ms at 3.35 TB/s);
// its window sum separates (a k-row sum of products, then a k-tap
// diagonal sum: about (2k + 8) H W^2 flops, 0.03 ms at the 67 TFLOP/s
// fp32 peak), so the write bounds it.
//
// The design.  The row product R_r[x, y] = sum_j cam[r, x+j-p] *
// proj[r, y+j-p] depends on the image row r alone, and output row h sums
// R_{h-p} .. R_{h+p}.  A block owns a kApTileX x kApTileY (x, y) tile and a
// strip of kApRows output rows h0 .. h0 + kApRows - 1; it stages the
// strip's kApRows + k - 1 camera rows (its halo'd x range) and projector
// rows (its halo'd y range) once, zero outside the image.  Each thread
// computes R_r of its kApXPerThread x kApYPerThread pairs for each of the
// kApRows + k - 1 rows once, fmaf over j from 0, and window_sweep
// (common.cuh, the loops of window_taps in sums mode) adds each output's k
// rows from 0 in order, in registers: the additions of the direct k^2 sum
// (each row's j-sum, then += over the rows) in its order, so the values
// are that sum's bit for bit, from k (kApRows + k - 1) / kApRows FMAs an
// output instead of k^2 (28 against 225 at k = 15).  A thread's camera
// columns are the same for the whole warp (a broadcast load) and slide one
// column a tap, so a tap loads one camera value, kApYPerThread projector
// values 32 apart (one a lane, no bank conflict), and makes kApXPerThread
// x kApYPerThread FMAs.  A warp stores 32 neighbouring y of one (h, x): 128
// contiguous bytes.  The sums leave the registers through shared memory
// for the normalisation, a loop over the strip's rows: unrolled, its code
// and the sweep's would not fit the instruction cache.  Shared memory the
// larger of (kApRows + k - 1) x (kApTileX + kApTileY + 4p) floats (the
// staged rows) and the block's 16,384 sums: 16,384 at k = 15, three
// blocks an SM; every odd k <= 143 fits an H100's 227 KB (48,384 floats
// at k = 129).
#include "common.cuh"

namespace custereo {
namespace {

constexpr int kApWarps = 4;
constexpr int kApThreads = 32 * kApWarps;
constexpr int kApXPerThread = 4;  // camera columns per thread (per warp)
constexpr int kApYPerThread = 2;  // projector columns per thread, 32 apart
constexpr int kApRows = 16;       // output rows of a block's strip
constexpr int kApTileX = kApWarps * kApXPerThread;  // 16
constexpr int kApTileY = 32 * kApYPerThread;        // 64

// The window sums a block holds at the end of its strip, in floats: a
// thread's kApRows x kApXPerThread x kApYPerThread.
constexpr int kApSums =
    kApRows * kApXPerThread * kApYPerThread * kApThreads;  // 16,384

// Shared memory of a block in floats: the strip's kApRows + k - 1 camera
// rows of kApTileX + 2p columns, then as many projector rows of kApTileY +
// 2p columns; afterwards the same space holds the block's window sums.
inline size_t allpairs_smem_floats(int k) {
  const int p = k / 2;
  const size_t staged = static_cast<size_t>(kApRows + k - 1) *
                        (kApTileX + 2 * p + kApTileY + 2 * p);
  return staged > kApSums ? staged : kApSums;
}

// A thread's pairs: [camera column][projector column].
struct PairTile {
  float v[kApXPerThread][kApYPerThread];
};

// Grid: (ceil(W / kApTileY), ceil(W / kApTileX), B * ceil(H / kApRows));
// kApThreads threads.  Block (ty, tx, b strip) writes out[b][h0 ..
// h0 + kApRows - 1][x0 .. x0 + kApTileX - 1][y0 .. y0 + kApTileY - 1].  The
// y tiles go fastest, so the blocks that write one row of the volume run
// together: a row starts part-way into a 32-byte sector (W = 422), and its
// neighbours complete the sectors a block's edges leave partly written.
__global__ void __launch_bounds__(kApThreads)
    allpairs_volume_kernel(const float* __restrict__ camera,
                           const float* __restrict__ projector,
                           const float* __restrict__ cam_s,
                           const float* __restrict__ cam_e2,
                           const float* __restrict__ proj_s,
                           const float* __restrict__ proj_e2,
                           float* __restrict__ out, int H, int W, int k,
                           float eps) {
  extern __shared__ float smem[];
  const int p = k / 2, rows = kApRows + k - 1;
  const int cam_w = kApTileX + 2 * p, proj_w = kApTileY + 2 * p;
  float* cam_t = smem;
  float* proj_t = cam_t + rows * cam_w;

  const int strips = (H + kApRows - 1) / kApRows;
  const int b = blockIdx.z / strips, h0 = (blockIdx.z - b * strips) * kApRows;
  const int x0 = blockIdx.y * kApTileX, y0 = blockIdx.x * kApTileY;
  const size_t plane = static_cast<size_t>(H) * W;
  stage_tile(cam_t, camera + b * plane, H, W, h0 - p, x0 - p, rows, cam_w,
             1.f);
  stage_tile(proj_t, projector + b * plane, H, W, h0 - p, y0 - p, rows,
             proj_w, 1.f);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int xl = (threadIdx.x >> 5) * kApXPerThread;
  // R of the strip's row i (image row h0 - p + i) at the thread's pairs.
  const auto row_products = [&](int i) {
    const float* crow = cam_t + i * cam_w + xl;
    const float* prow = proj_t + i * proj_w + lane;
    PairTile r;
#pragma unroll
    for (int a = 0; a < kApXPerThread; ++a)
#pragma unroll
      for (int c = 0; c < kApYPerThread; ++c) r.v[a][c] = 0.f;
    // Tap j reads camera columns crow[j .. j + kApXPerThread - 1]: the
    // window of tap j - 1 moved on by one.
    float cv[kApXPerThread];
#pragma unroll
    for (int a = 1; a < kApXPerThread; ++a) cv[a] = crow[a - 1];
#pragma unroll 4
    for (int j = 0; j < k; ++j) {
#pragma unroll
      for (int a = 0; a + 1 < kApXPerThread; ++a) cv[a] = cv[a + 1];
      cv[kApXPerThread - 1] = crow[j + kApXPerThread - 1];
      float pv[kApYPerThread];
#pragma unroll
      for (int c = 0; c < kApYPerThread; ++c) pv[c] = prow[32 * c + j];
#pragma unroll
      for (int a = 0; a < kApXPerThread; ++a)
#pragma unroll
        for (int c = 0; c < kApYPerThread; ++c)
          r.v[a][c] = fmaf(cv[a], pv[c], r.v[a][c]);
    }
    return r;
  };
  PairTile acc[kApRows];
#pragma unroll
  for (int n = 0; n < kApRows; ++n)
#pragma unroll
    for (int a = 0; a < kApXPerThread; ++a)
#pragma unroll
      for (int c = 0; c < kApYPerThread; ++c) acc[n].v[a][c] = 0.f;
  window_sweep(acc, k, row_products, [](PairTile& s, const PairTile& r) {
#pragma unroll
    for (int a = 0; a < kApXPerThread; ++a)
#pragma unroll
      for (int c = 0; c < kApYPerThread; ++c) s.v[a][c] += r.v[a][c];
  });

  // The sums go through shared memory (a thread's own entries, a warp's
  // 32 consecutive), so the normalisation below is a loop over the rows and
  // not kApRows copies of its code.
  __syncthreads();
  float* sums = smem + threadIdx.x;
#pragma unroll
  for (int n = 0; n < kApRows; ++n)
#pragma unroll
    for (int a = 0; a < kApXPerThread; ++a)
#pragma unroll
      for (int c = 0; c < kApYPerThread; ++c)
        sums[((n * kApXPerThread + a) * kApYPerThread + c) * kApThreads] =
            acc[n].v[a][c];

  const float k2 = static_cast<float>(k * k);
#pragma unroll 1
  for (int n = 0; n < kApRows; ++n) {
    const int h = h0 + n;
    if (h >= H) break;
    const size_t stats = b * plane + static_cast<size_t>(h) * W;
    float sy[kApYPerThread], ey2[kApYPerThread];
#pragma unroll
    for (int c = 0; c < kApYPerThread; ++c) {
      const int y = y0 + lane + 32 * c;
      sy[c] = y < W ? __ldg(proj_s + stats + y) : 0.f;
      ey2[c] = y < W ? __ldg(proj_e2 + stats + y) : 0.f;
    }
#pragma unroll
    for (int a = 0; a < kApXPerThread; ++a) {
      const int x = x0 + xl + a;
      if (x >= W) continue;
      const float sx = __ldg(cam_s + stats + x);
      const float ex2 = __ldg(cam_e2 + stats + x);
      float* orow = out + ((static_cast<size_t>(b) * H + h) * W + x) * W;
#pragma unroll
      for (int c = 0; c < kApYPerThread; ++c) {
        const int y = y0 + lane + 32 * c;
        if (y < W) {
          const float sum =
              sums[((n * kApXPerThread + a) * kApYPerThread + c) * kApThreads];
          const float exy = sum - sx * sy[c] / k2;
          orow[y] = (exy + eps) / sqrtf(ex2 * ey2[c] + eps);
        }
      }
    }
  }
}

}  // namespace
}  // namespace custereo

using namespace custereo;

// Plain C interface, loaded with ctypes.  camera/projector: [B, H, W];
// scratch cam_s/cam_e2/proj_s/proj_e2: [B, H, W]; out: [B, H, W, W]; all
// fp32, contiguous, on the current device.  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 when every launch was
// accepted).
extern "C" int custereo_allpairs_volume(const float* camera,
                                        const float* projector, float* cam_s,
                                        float* cam_e2, float* proj_s,
                                        float* proj_e2, float* out, int B,
                                        int H, int W, int k, float eps,
                                        void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t e =
      launch_box_stats(camera, cam_s, cam_e2, B, H, W, k, 0, W, 1.f, stream);
  if (e != cudaSuccess) return e;
  e = launch_box_stats(projector, proj_s, proj_e2, B, H, W, k, 0, W, 1.f,
                       stream);
  if (e != cudaSuccess) return e;

  const size_t bytes = allpairs_smem_floats(k) * sizeof(float);
  e = allow_smem(allpairs_volume_kernel, bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((W + kApTileY - 1) / kApTileY,
                  (W + kApTileX - 1) / kApTileX,
                  B * ((H + kApRows - 1) / kApRows));
  allpairs_volume_kernel<<<grid, kApThreads, bytes, stream>>>(
      camera, projector, cam_s, cam_e2, proj_s, proj_e2, out, H, W, k, eps);
  return cudaGetLastError();
}
