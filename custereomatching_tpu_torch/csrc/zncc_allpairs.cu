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
// fp32 peak), so the write bounds it.  This kernel sums the k^2 products
// of every output directly, 2 H W^2 k^2 flops (26.4 GFLOP there, 0.39 ms
// at the peak), so its own arithmetic is what it spends its time on.
// What the design does about that arithmetic:
// each thread keeps an 8 x 4 register tile of outputs, so one (i, j) step
// costs 12 shared-memory loads for 32 FMAs; the 8 camera values are the
// same for the whole warp (broadcast) and the 4 projector values are 32
// apart (one per lane, no bank conflict).  The halo'd k camera and
// projector rows of the block are staged once in shared memory.  A warp
// stores 32 neighbouring y of one (h, x): 128 contiguous bytes.
#include "common.cuh"

namespace custereo {
namespace {

constexpr int kApThreads = 256;
constexpr int kApXPerThread = 8;   // camera columns per thread (per warp)
constexpr int kApYPerThread = 4;   // projector columns per thread, 32 apart
constexpr int kApTileX = (kApThreads / 32) * kApXPerThread;  // 64
constexpr int kApTileY = 32 * kApYPerThread;                 // 128

// Shared memory: k camera rows of kApTileX + 2p columns, then k projector
// rows of kApTileY + 2p columns, in floats.
inline size_t allpairs_smem_floats(int k) {
  const int p = k / 2;
  return static_cast<size_t>(k) * (kApTileX + 2 * p + kApTileY + 2 * p);
}

// Grid: (B * H, ceil(W / kApTileX), ceil(W / kApTileY)); kApThreads
// threads.  Block (bh, tx, ty) writes out[bh][x0 .. x0+63][y0 .. y0+127].
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
  const int p = k / 2;
  const int cam_w = kApTileX + 2 * p, proj_w = kApTileY + 2 * p;
  float* cam_t = smem;
  float* proj_t = cam_t + k * cam_w;

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int x0 = blockIdx.y * kApTileX, y0 = blockIdx.z * kApTileY;
  const size_t plane = static_cast<size_t>(H) * W;
  stage_tile(cam_t, camera + b * plane, H, W, h - p, x0 - p, k, cam_w, 1.f);
  stage_tile(proj_t, projector + b * plane, H, W, h - p, y0 - p, k, proj_w,
             1.f);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int xl = (threadIdx.x >> 5) * kApXPerThread;
  float acc[kApXPerThread][kApYPerThread];
#pragma unroll
  for (int a = 0; a < kApXPerThread; ++a)
#pragma unroll
    for (int c = 0; c < kApYPerThread; ++c) acc[a][c] = 0.f;

  for (int i = 0; i < k; ++i) {
    const float* crow = cam_t + i * cam_w + xl;
    const float* prow = proj_t + i * proj_w + lane;
    float row[kApXPerThread][kApYPerThread];
#pragma unroll
    for (int a = 0; a < kApXPerThread; ++a)
#pragma unroll
      for (int c = 0; c < kApYPerThread; ++c) row[a][c] = 0.f;
    for (int j = 0; j < k; ++j) {
      float cv[kApXPerThread], pv[kApYPerThread];
#pragma unroll
      for (int a = 0; a < kApXPerThread; ++a) cv[a] = crow[a + j];
#pragma unroll
      for (int c = 0; c < kApYPerThread; ++c) pv[c] = prow[32 * c + j];
#pragma unroll
      for (int a = 0; a < kApXPerThread; ++a)
#pragma unroll
        for (int c = 0; c < kApYPerThread; ++c)
          row[a][c] = fmaf(cv[a], pv[c], row[a][c]);
    }
#pragma unroll
    for (int a = 0; a < kApXPerThread; ++a)
#pragma unroll
      for (int c = 0; c < kApYPerThread; ++c) acc[a][c] += row[a][c];
  }

  const float k2 = static_cast<float>(k * k);
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
    if (x >= W) break;
    const float sx = __ldg(cam_s + stats + x);
    const float ex2 = __ldg(cam_e2 + stats + x);
    float* orow = out + (static_cast<size_t>(bh) * W + x) * W;
#pragma unroll
    for (int c = 0; c < kApYPerThread; ++c) {
      const int y = y0 + lane + 32 * c;
      if (y < W) {
        const float exy = acc[a][c] - sx * sy[c] / k2;
        orow[y] = (exy + eps) / sqrtf(ex2 * ey2[c] + eps);
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
  const dim3 grid(B * H, (W + kApTileX - 1) / kApTileX,
                  (W + kApTileY - 1) / kApTileY);
  allpairs_volume_kernel<<<grid, kApThreads, bytes, stream>>>(
      camera, projector, cam_s, cam_e2, proj_s, proj_e2, out, H, W, k, eps);
  return cudaGetLastError();
}
