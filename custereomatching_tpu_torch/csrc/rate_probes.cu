// K10a, K10b and K10c: the rate probes of the port's bound model
// (custereomatching_tpu_torch/utils/kernel_model.py) on Hopper.
//
// Replaces: custereomatching_tpu/utils/kernel_model.py:_rate_kernel (K10a,
// driven by _rate_call and _run_rate), _dma_read_kernel (K10b, driven by
// _run_dma_rate("hbm_r3d")) and _dma_write_kernel (K10c,
// _run_dma_rate("hbm_w3d")).  Each probe runs one class of the work the
// port's kernels are made of, so that a kernel's counted work can be
// priced at what this card sustains for it.  Nothing is calibrated against
// the kernels themselves.
//
// K10a computes what _rate_kernel computes: accumulators that start at a0
// (0.6) and go through `iters` iterations of one class op,
//   madd    a = a * 0.9996 + 0.00025                  (one FFMA)
//   exp     a = expf(a * 0.25)
//   rsqrt   a = rsqrtf(a + 1)
//   smem    a = a * 0.9996 + wide[i + off]          (one shared load, one FFMA)
//   boxadd  a = a * 0.9996 + box                     (box: one real pass)
// with `wide` filled with `fill` (0.015625).  smem is the counterpart of
// the TPU's lshift/sshift: there a shifted slice is a relayout, here the
// window sums' neighbour reads are shared-memory loads (common.cuh), so the
// offset moves every iteration and no load is loop-invariant.  boxadd runs
// one per-plane pass of common.cuh (K1's first pass: no kernel runs it any
// more, and JAX's bound model keeps the class) at its geometry (16 x 64
// pixels, k = 15, D = 192, 1024 threads, 46,752 bytes of shared memory:
// two blocks an SM): vertical_products, a barrier,
// horizontal_sum, a barrier, over camera and projector tiles staged with
// `fill` (0.125), so box = 225 * 0.015625 exactly, the value of JAX's
// boxadd.  The shift walks the planes as that pass does.
//
// The op modes keep kChains independent accumulators a thread (one chain
// a thread would run at the FFMA latency, about 4x below the peak), 256
// threads a block; every chain computes the same function and holds the
// same value.  They start at a0 + zero * (j + thread) with zero = 0 passed at
// run time, so the compiler can neither merge the chains nor fold them; the
// trip count is a run-time argument and the shared loads are volatile.  The
// intrinsics are the kernels' own (expf, rsqrtf, fmaf), built with the same
// flags and no --use_fast_math, so a rate prices what the kernels run.
//
// K10b reads a plane-major [P, H, W] fp32 volume the way K2, K4 and K7 read
// the cost and the cotangent: one 16 x 64 pixel tile a block, a thread a
// pixel, every plane in turn (a plane's loads do not wait for the last
// plane's; here four planes' loads are in flight a thread).  It writes each
// pixel's sum over the planes, in plane order, an [H, W] map.  K10c writes
// out[d][h][w] = d the way K1 and K3w store their volumes: a thread a
// pixel, a plane after another, each warp storing 32 neighbouring w of one
// plane.  Both run at KITTI's
// volume (P = 193, 375 x 1242: 360 MB, seven times the 50 MB L2), so every
// byte crosses HBM.
//
// What bounds them on the H100: madd, exp and rsqrt the FP32 and
// multi-function pipes (67 TFLOP/s is 33.5 T FFMA/s); smem and boxadd the
// shared-memory pipe (one warp-wide 32-bit load a clock an SM), boxadd
// also its barriers; K10b and K10c the HBM (3.35 TB/s).
#include "common.cuh"

namespace custereo {
namespace {

constexpr int kRateThreads = 256;
constexpr int kChains = 8;
// Iterations a trip of the probe loop; iters is a multiple of it.
constexpr int kUnroll = 8;
constexpr int kWide = kRateThreads + 256;
// boxadd's pass: K1's geometry at KITTI.
constexpr int kBoxK = 15;
constexpr int kBoxD = 192;

enum Mode { kMadd = 0, kSmem = 1, kExp = 2, kRsqrt = 3, kBoxadd = 4 };

// out[(block * kRateThreads + thread) * kChains + j]: chain j's last value.
// Grid: blocks; kRateThreads threads.
template <int kMode>
__global__ void __launch_bounds__(kRateThreads)
    op_probe_kernel(float* __restrict__ out, int iters, float a0, float zero,
                    float fill) {
  __shared__ float wide[kWide];
  for (int i = threadIdx.x; i < kWide; i += kRateThreads) wide[i] = fill;
  __syncthreads();
  const volatile float* w = wide + threadIdx.x;
  float a[kChains];
#pragma unroll
  for (int j = 0; j < kChains; ++j)
    a[j] = a0 + zero * static_cast<float>(j + threadIdx.x);

  for (int it = 0; it < iters; it += kUnroll) {
    // The offsets move every trip: base in [0, 64), plus 1 .. 128.
    const int base = (it / kUnroll) & 63;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int j = 0; j < kChains; ++j) {
        if constexpr (kMode == kMadd) {
          a[j] = fmaf(a[j], 0.9996f, 0.00025f);
        } else if constexpr (kMode == kSmem) {
          a[j] = fmaf(a[j], 0.9996f,
                      w[base + ((u * kChains + j) * 13) % 128 + 1]);
        } else if constexpr (kMode == kExp) {
          a[j] = expf(a[j] * 0.25f);
        } else {
          a[j] = rsqrtf(a[j] + 1.f);
        }
      }
    }
  }
  float* o = out + (static_cast<size_t>(blockIdx.x) * kRateThreads +
                    threadIdx.x) * kChains;
#pragma unroll
  for (int j = 0; j < kChains; ++j) o[j] = a[j];
}

// out[block * kThreads + thread]: the pixel's accumulator after `iters`
// passes.  k and D are run-time values, as in K1, so the pass's index
// arithmetic is K1's.  Grid: blocks; kThreads threads; dynamic shared
// memory PlaneTile(k, D).floats() floats.
__global__ void __launch_bounds__(kThreads)
    box_probe_kernel(float* __restrict__ out, int iters, int k, int D,
                     float a0, float zero, float fill) {
  extern __shared__ float smem[];
  const PlaneTile g(k, D);
  float* cam_t = smem;
  float* proj_t = cam_t + g.rows * g.cam_w;
  float* vsum = proj_t + g.rows * g.proj_w;
  for (int i = threadIdx.x; i < g.rows * (g.cam_w + g.proj_w); i += blockDim.x)
    cam_t[i] = fill;
  const int r = threadIdx.x / kTileW, c = threadIdx.x % kTileW;
  float a = a0 + zero * static_cast<float>(threadIdx.x);
  int d = 0;
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    vertical_products(vsum, cam_t, proj_t, g, k, D - d);
    __syncthreads();
    a = fmaf(a, 0.9996f, horizontal_sum(vsum, g.cam_w, r, c, k));
    d = d == D ? 0 : d + 1;
    __syncthreads();
  }
  out[static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x] = a;
}

// out[h][w] = sum_d vol[d][h][w], the planes in order.  Grid:
// (ceil(W / kTileW), ceil(H / kTileH)); kThreads threads.
__global__ void __launch_bounds__(kThreads)
    hbm_read_kernel(const float* __restrict__ vol, float* __restrict__ out,
                    int P, int H, int W) {
  const int h = blockIdx.y * kTileH + threadIdx.x / kTileW;
  const int w = blockIdx.x * kTileW + threadIdx.x % kTileW;
  if (h >= H || w >= W) return;
  const size_t plane = static_cast<size_t>(H) * W;
  const float* px = vol + static_cast<size_t>(h) * W + w;
  float acc = 0.f;
#pragma unroll 4
  for (int d = 0; d < P; ++d) acc += __ldg(px + d * plane);
  out[static_cast<size_t>(h) * W + w] = acc;
}

// vol[d][h][w] = d.  Grid and block as hbm_read_kernel.
__global__ void __launch_bounds__(kThreads)
    hbm_write_kernel(float* __restrict__ vol, int P, int H, int W) {
  const int h = blockIdx.y * kTileH + threadIdx.x / kTileW;
  const int w = blockIdx.x * kTileW + threadIdx.x % kTileW;
  if (h >= H || w >= W) return;
  const size_t plane = static_cast<size_t>(H) * W;
  float* px = vol + static_cast<size_t>(h) * W + w;
#pragma unroll 1
  for (int d = 0; d < P; ++d) px[d * plane] = static_cast<float>(d);
}

template <int kMode>
cudaError_t launch_op(float* out, int blocks, int iters, float a0,
                      float zero, float fill, cudaStream_t stream) {
  op_probe_kernel<kMode><<<blocks, kRateThreads, 0, stream>>>(out, iters, a0,
                                                              zero, fill);
  return cudaGetLastError();
}

}  // namespace
}  // namespace custereo

using namespace custereo;

// Plain C interface, loaded with ctypes.  All launch on `stream`, do not
// synchronise, and return cudaGetLastError() (0 when the launch was
// accepted); fp32, contiguous, on the current device.
//
// K10a.  mode: 0 madd, 1 smem, 2 exp, 3 rsqrt, 4 boxadd.  out: [blocks,
// 256 * 8] for modes 0-3, [blocks, 1024] for boxadd; iters >= 0, a multiple
// of 8 for modes 0-3.
extern "C" int custereo_rate_probe(int mode, float* out, int blocks,
                                   int iters, float a0, float zero,
                                   float fill, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (blocks < 1 || iters < 0) return cudaErrorInvalidValue;
  if (mode != kBoxadd && iters % kUnroll != 0) return cudaErrorInvalidValue;
  switch (mode) {
    case kMadd:
      return launch_op<kMadd>(out, blocks, iters, a0, zero, fill, stream);
    case kSmem:
      return launch_op<kSmem>(out, blocks, iters, a0, zero, fill, stream);
    case kExp:
      return launch_op<kExp>(out, blocks, iters, a0, zero, fill, stream);
    case kRsqrt:
      return launch_op<kRsqrt>(out, blocks, iters, a0, zero, fill, stream);
    case kBoxadd: {
      const size_t bytes = PlaneTile(kBoxK, kBoxD).floats() * sizeof(float);
      const cudaError_t e = allow_smem(box_probe_kernel, bytes);
      if (e != cudaSuccess) return e;
      box_probe_kernel<<<blocks, kThreads, bytes, stream>>>(
          out, iters, kBoxK, kBoxD, a0, zero, fill);
      return cudaGetLastError();
    }
    default:
      return cudaErrorInvalidValue;
  }
}

// K10b.  vol: [P, H, W]; out: [H, W].
extern "C" int custereo_hbm_read_probe(const float* vol, float* out, int P,
                                       int H, int W, void* stream_ptr) {
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH);
  hbm_read_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(
                                           stream_ptr)>>>(vol, out, P, H, W);
  return cudaGetLastError();
}

// K10c.  vol: [P, H, W].
extern "C" int custereo_hbm_write_probe(float* vol, int P, int H, int W,
                                        void* stream_ptr) {
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH);
  hbm_write_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(
                                            stream_ptr)>>>(vol, P, H, W);
  return cudaGetLastError();
}
