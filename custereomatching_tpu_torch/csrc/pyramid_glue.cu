// K11p, K11w and K11c: the glue of the coarse-to-fine pyramid matcher
// (models/pyramid.py::PyramidStereoMatcher) on Hopper, one launch a stage.
//
// Replaces no TPU kernel: the JAX package leaves the pyramid's glue
// (custereomatching_tpu/models/pyramid.py: _avg_pool, _upsample,
// _select_shifted and the composition) to XLA.  The port's plain glue
// makes about 35 passes a call over full-resolution maps (int64 column
// maps, clamps, compares, a gather and a where per selection, stacks);
// these kernels make one pass a stage.
//
//   K11p (pool):    both images' f x f means, the frame edge-padded (its
//                   last row and column repeated) to a multiple of f.  A
//                   block's sum runs in row-major order from 0 and is
//                   scaled by 1 / f^2: the plain version's order of the
//                   sum is torch's reduction's, so the two differ in the
//                   last bits.
//   K11w (warp):    shift[y, x] = clamp(rint(coarse[y / f, x / f] * f) - r,
//                   -r, D) and proj_w[y, x] = projector[y, x - shift], 0
//                   where the column is out of view.
//   K11c (compose): for d the fine level's hard and soft values, k =
//                   rint(d), s = shift[y, x - k] (0 where x - k is out of
//                   view or k is outside [0, 2r], NaN included), total =
//                   (s + d) m; the mask drops where either total is
//                   negative, and each map is max(total, 0) times it.
//
// K11w and K11c are the plain glue's values bit for bit on the card: the
// same fp32 operations in the same order, each rounded on its own
// (__fadd_rn / __fmul_rn: no FMA contraction), torch's round (rintf, half
// to even), its clamp and clamp_min (NaN through, else fmaxf / fminf).  A
// NaN shift reads the column x (k = 0), as the JAX package's int32 cast of
// a NaN gives 0; a NaN d reads s = 0, where the JAX package reads the
// shift at x: either way the total is NaN.
//
// What bounds them on the H100: bytes.  At 2880 x 1988 (one fp32 frame
// 22.9 MB): K11p reads both images and writes the pooled pair (48.7 MB),
// K11w reads the projector and the coarse soft map and writes the shift
// and the warped projector (70.1 MB), K11c reads three maps and the shift
// and writes three maps (160.3 MB): 0.084 ms at 3.35 TB/s in all.  Their
// arithmetic is a few operations a pixel.
//
// The design: a thread an output pixel of a few rows, a block 256 neighbouring
// pixels of a row (so every load and store of a warp covers 128 neighbouring
// bytes), grid.y the rows and grid.z the frames, each strided past 65535: no
// thread divides but by f.  Latency bounds a pass of one 4-byte read a thread
// (the card needs ~25 KB in flight an SM), so each thread keeps several reads
// in flight: K11p the f rows of its f x f block (with f = 4, where W % 4 == 0
// and the images are 16-byte aligned, one 16-byte load a row), K11w kWarpRows
// rows, their coarse values first and then their projector columns, K11c its
// three maps and two shift columns.  The gathers (the warp's projector column,
// the composition's two shift columns) read within a few hundred columns of
// the thread's own, which the caches hold.  At 2880 x 1988 on an H100 the
// three take 19.6, 28.8 and 60.0 us, 1.25-1.38 times their bounds.
#include <cuda_runtime.h>

#include <cmath>

namespace custereo {
namespace {

constexpr int kGlueThreads = 256;
constexpr int kWarpRows = 4;

unsigned int strided(long long n) {
  return static_cast<unsigned int>(n < 65535 ? n : 65535);
}

// torch's clamp_min(v, 0) on the card: NaN through, else fmaxf.
__device__ __forceinline__ float clamp_min0(float v) {
  return isnan(v) ? v : fmaxf(v, 0.f);
}

// K11p: a thread an output pixel.  Planes [0, frames) of grid.z are the
// camera's, [frames, 2 frames) the projector's.  kVec4: f = 4 and each row
// of a block one 16-byte load.
template <bool kVec4>
__global__ void __launch_bounds__(kGlueThreads)
    pool_kernel(const float* __restrict__ camera,
                const float* __restrict__ projector,
                float* __restrict__ cam_out, float* __restrict__ proj_out,
                int frames, int H, int W, int f_arg, int Hc, int Wc,
                float inv) {
  const int f = kVec4 ? 4 : f_arg;
  const int xc = blockIdx.x * kGlueThreads + threadIdx.x;
  if (xc >= Wc) return;
  for (int z = blockIdx.z; z < 2 * frames; z += gridDim.z) {
    const bool second = z >= frames;
    const long long n = second ? z - frames : z;
    const float* img = (second ? projector : camera) + n * H * W;
    float* out = (second ? proj_out : cam_out) + n * Hc * Wc;
    for (int yc = blockIdx.y; yc < Hc; yc += gridDim.y) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < f; ++i) {
        const float* line =
            img + static_cast<long long>(min(yc * f + i, H - 1)) * W;
        if (kVec4) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(line) + xc);
          acc = __fadd_rn(acc, v.x);
          acc = __fadd_rn(acc, v.y);
          acc = __fadd_rn(acc, v.z);
          acc = __fadd_rn(acc, v.w);
        } else {
#pragma unroll
          for (int j = 0; j < f; ++j)
            acc = __fadd_rn(acc, __ldg(line + min(xc * f + j, W - 1)));
        }
      }
      out[static_cast<long long>(yc) * Wc + xc] = __fmul_rn(acc, inv);
    }
  }
}

// K11w: a thread a column of kWarpRows rows.  coarse is [frames, h, w]
// with h f >= H, w f >= W.
__global__ void __launch_bounds__(kGlueThreads)
    warp_kernel(const float* __restrict__ projector,
                const float* __restrict__ coarse, float* __restrict__ shift,
                float* __restrict__ proj_w, int frames, int H, int W, int h,
                int w, int f, int r, int D) {
  const int x = blockIdx.x * kGlueThreads + threadIdx.x;
  if (x >= W) return;
  const int xc = x / f;
  for (int n = blockIdx.z; n < frames; n += gridDim.z) {
    const float* src = projector + static_cast<long long>(n) * H * W;
    const float* cmap = coarse + static_cast<long long>(n) * h * w + xc;
    for (int y0 = blockIdx.y * kWarpRows; y0 < H;
         y0 += gridDim.y * kWarpRows) {
      float s[kWarpRows], v[kWarpRows];
#pragma unroll
      for (int i = 0; i < kWarpRows; ++i)
        s[i] = __ldg(cmap +
                     static_cast<long long>(min(y0 + i, H - 1) / f) * w);
#pragma unroll
      for (int i = 0; i < kWarpRows; ++i) {
        s[i] = __fsub_rn(rintf(__fmul_rn(s[i], static_cast<float>(f))),
                         static_cast<float>(r));
        if (!isnan(s[i]))
          s[i] = fminf(fmaxf(s[i], static_cast<float>(-r)),
                       static_cast<float>(D));
        // A NaN shift reads the column x, as the JAX package's does.
        const int k = isnan(s[i]) ? 0 : static_cast<int>(s[i]);
        const int col = x - k;
        const long long line = static_cast<long long>(min(y0 + i, H - 1)) * W;
        v[i] = (k >= -r && k <= D && col >= 0 && col < W)
                   ? __ldg(src + line + col)
                   : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kWarpRows; ++i) {
        if (y0 + i >= H) break;
        const long long at = (static_cast<long long>(n) * H + y0 + i) * W + x;
        shift[at] = s[i];
        proj_w[at] = v[i];
      }
    }
  }
}

// K11c's s: the shift at x - rint(d), 0 where rint(d) is outside [0, 2r]
// (NaN included) or the column is out of view.
__device__ __forceinline__ float band_shift(const float* __restrict__ line,
                                           float d, int x, int two_r) {
  const float k = rintf(d);
  if (!(k >= 0.f && k <= static_cast<float>(two_r))) return 0.f;
  const int col = x - static_cast<int>(k);
  return col >= 0 ? __ldg(line + col) : 0.f;
}

// K11c: a thread a pixel.
__global__ void __launch_bounds__(kGlueThreads)
    compose_kernel(const float* __restrict__ hard,
                   const float* __restrict__ soft,
                   const float* __restrict__ mask,
                   const float* __restrict__ shift,
                   float* __restrict__ hard_out, float* __restrict__ soft_out,
                   float* __restrict__ mask_out, int frames, int H, int W,
                   int r) {
  const int x = blockIdx.x * kGlueThreads + threadIdx.x;
  if (x >= W) return;
  for (int n = blockIdx.z; n < frames; n += gridDim.z) {
    for (int y = blockIdx.y; y < H; y += gridDim.y) {
      const long long row = (static_cast<long long>(n) * H + y) * W;
      const long long at = row + x;
      const float m = __ldg(mask + at);
      const float dh = __ldg(hard + at), ds = __ldg(soft + at);
      const float th =
          __fmul_rn(__fadd_rn(band_shift(shift + row, dh, x, 2 * r), dh), m);
      const float ts =
          __fmul_rn(__fadd_rn(band_shift(shift + row, ds, x, 2 * r), ds), m);
      const float keep = (th < 0.f || ts < 0.f) ? 0.f : m;
      hard_out[at] = __fmul_rn(clamp_min0(th), keep);
      soft_out[at] = __fmul_rn(clamp_min0(ts), keep);
      mask_out[at] = keep;
    }
  }
}

dim3 glue_grid(int width, int rows, int planes) {
  return dim3((width + kGlueThreads - 1) / kGlueThreads, strided(rows),
              strided(planes));
}

}  // namespace
}  // namespace custereo

using namespace custereo;

// camera, projector: [frames, H, W]; cam_out, proj_out: [frames, Hc, Wc],
// Hc = ceil(H / f), Wc = ceil(W / f).  frames, H, W, f >= 1.
extern "C" int custereo_pyramid_pool(const float* camera,
                                     const float* projector, float* cam_out,
                                     float* proj_out, int frames, int H,
                                     int W, int f, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int Hc = (H + f - 1) / f, Wc = (W + f - 1) / f;
  const float inv = 1.f / static_cast<float>(f * f);
  const dim3 grid = glue_grid(Wc, Hc, 2 * frames);
  const auto bits = reinterpret_cast<unsigned long long>(camera) |
                    reinterpret_cast<unsigned long long>(projector);
  if (f == 4 && W % 4 == 0 && bits % 16 == 0) {
    pool_kernel<true><<<grid, kGlueThreads, 0, stream>>>(
        camera, projector, cam_out, proj_out, frames, H, W, f, Hc, Wc, inv);
  } else {
    pool_kernel<false><<<grid, kGlueThreads, 0, stream>>>(
        camera, projector, cam_out, proj_out, frames, H, W, f, Hc, Wc, inv);
  }
  return cudaGetLastError();
}

// projector, shift, proj_w: [frames, H, W]; coarse: [frames, h, w], h f >=
// H, w f >= W.  frames, H, W, f >= 1, r >= 0.
extern "C" int custereo_pyramid_warp(const float* projector,
                                     const float* coarse, float* shift,
                                     float* proj_w, int frames, int H, int W,
                                     int h, int w, int f, int r, int D,
                                     void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const dim3 grid = glue_grid(W, (H + kWarpRows - 1) / kWarpRows, frames);
  warp_kernel<<<grid, kGlueThreads, 0, stream>>>(
      projector, coarse, shift, proj_w, frames, H, W, h, w, f, r, D);
  return cudaGetLastError();
}

// hard, soft, mask, shift and the three outputs: [frames, H, W].
extern "C" int custereo_pyramid_compose(const float* hard, const float* soft,
                                        const float* mask, const float* shift,
                                        float* hard_out, float* soft_out,
                                        float* mask_out, int frames, int H,
                                        int W, int r, void* stream_ptr) {
  compose_kernel<<<glue_grid(W, H, frames), kGlueThreads, 0,
                   static_cast<cudaStream_t>(stream_ptr)>>>(
      hard, soft, mask, shift, hard_out, soft_out, mask_out, frames, H, W, r);
  return cudaGetLastError();
}
