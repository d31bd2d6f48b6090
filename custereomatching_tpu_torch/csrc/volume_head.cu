// K8h: the disparity head over a written cost volume on Hopper, and K8hb,
// its VJP.
//
// Replaces no TPU kernel: the JAX package leaves the head
// (custereomatching_tpu/ops/disparity.py:extract_disparity) and its
// gradient to XLA.  The port's plain version, ops/disparity.py::
// extract_disparity, makes about ten passes over the volume forward (amax,
// the compare, argmax, x * beta, softmax, weights * indices, the sum) and
// as many through autograd (the sum's, the product's and softmax's
// backward, amax's scatter); these two kernels make one each.
//
// What K8h computes, per pixel n of a [B, H, W, L] volume c (L = W
// all-pairs, D + 1 banded):
//   m     = max_j c[j]              (the confidence)
//   a     = the first j with c[j] = m   (torch.argmax)
//   ties  = the number of j with c[j] = m
//   e[j]  = exp(beta c[j] - beta m),  s = sum_j e[j],  t = sum_j j e[j]
//   corr  = t / s                   (the soft argmax)
//   mask  = m > threshold
// and the maps as extract_disparity forms them: all-pairs (w - a) mask and
// (w - corr) mask, w the pixel's camera column; banded a mask and corr
// mask.  It keeps s, corr and ties for the backward, [3, B, H, W].  beta m
// is max_j beta c[j] for beta > 0 (the wrapper refuses beta <= 0), and
// beta c[j] is rounded before the subtraction, as the plain version's
// x * beta is, so the largest entry's exponent is exactly 0.  The hard
// map, the mask and the confidence equal the plain version's bit for bit;
// the soft map differs by the order of the sums.
//
// What K8hb computes, from the cotangents g_soft and g_conf (either may be
// absent, a null pointer):
//   g_corr   = -mask g_soft all-pairs, +mask g_soft banded
//   g_c[j]   = beta g_corr / s * e[j] * (j - corr)
//            + (c[j] = m ? g_conf / ties : 0)
// the softmax and sum's VJP in closed form, and amax's, which splits the
// cotangent evenly over a tie as torch's does.  The hard map and the mask
// carry no gradient, as in the plain version.
//
// What bounds them on the H100: bytes.  K8h must read the volume once, 4
// B H W L bytes (235 MB at the 330 x 422 verify shape, 0.07 ms at 3.35
// TB/s); K8hb must read it once and write the cotangent once (0.14 ms).
// Their arithmetic is an exp and a few FMAs an entry.
//
// The design.  The volume comes in one of two layouts: parity, its last
// axis contiguous (what K8 writes), or plane-major, the [B, H, W, L] view
// of a contiguous [B, L, H, W] (what K1 writes); the cotangent takes the
// volume's.  A group of lanes owns a pixel and reads its row a tile at a
// time into registers, kHeadRegs entries a lane, so that every load of a
// warp covers neighbouring addresses: in parity a warp a pixel, with
// 16-byte loads where the rows are 16-byte aligned (L % 4 == 0), 8-byte
// where they are 8-byte aligned (L even: 1,688 bytes at W = 422), else 4;
// in plane-major a thread a pixel, a warp loading one plane of 32
// neighbouring pixels.  The loads of a tile are independent and issued
// together.  K8h reduces the tile's maximum, its first index and its tie
// count over the group by shuffles, then adds the tile's e[j] and j e[j]
// into per-lane sums; a later tile with a larger maximum rescales the
// sums by exp(old - new), so a row of any L runs the same loop, and a
// parity row within one tile (L <= 512: the verify shape) needs no
// rescale.  K8h counts the ties so that K8hb makes one pass at any L: it
// recomputes e[j] from the row, the confidence and s, and writes the
// cotangent with the loads' width.  Blocks of 256 threads; registers hold
// the tile, so every warp of an SM can be resident.
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace custereo {
namespace {

constexpr int kHeadThreads = 256;
constexpr int kHeadRegs = 16;  // entries a lane holds of a row tile

// How a kernel walks the volume.  Parity ([B, H, W, L], the last axis
// contiguous): a warp owns a pixel (kLanes = 32) and loads V-wide vectors
// of its row.  Plane-major (the [B, H, W, L] view of a contiguous [B, L,
// H, W], what K1 writes): a thread owns a pixel (kLanes = 1) and a warp
// loads one plane of 32 neighbouring pixels.
template <bool kPlaneMajor, int V>
struct Walk {
  static constexpr int kLanes = kPlaneMajor ? 1 : 32;  // lanes a pixel
  static constexpr int kTile = kLanes * kHeadRegs;     // entries a tile
  static_assert(!kPlaneMajor || V == 1, "plane-major loads 4 bytes");

  long long n;     // the pixel, B H W of them
  int lane;        // the lane within the pixel's group
  const float* row;
  long long stride;  // between entries of the row

  __device__ Walk(const float* base, long long pixels, long long frame,
                  int L) {
    n = static_cast<long long>(blockIdx.x) * (kHeadThreads / kLanes) +
        threadIdx.x / kLanes;
    lane = threadIdx.x % kLanes;
    const long long m = n < pixels ? n : 0;
    row = kPlaneMajor ? base + (m / frame) * L * frame + m % frame
                      : base + m * L;
    stride = kPlaneMajor ? frame : 1;
  }

  // The first entry of vector q of the tile at base: q 32 V + lane V in
  // a warp's row (kLanes V a chunk), base + q in a thread's.
  __device__ int index(int base, int q) const {
    return base + q * kLanes * V + lane * V;
  }

  __device__ void load(int j, float* v) const {
    const float* p = row + j * stride;
    if constexpr (V == 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p));
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
      v[3] = q.w;
    } else if constexpr (V == 2) {
      const float2 q = __ldg(reinterpret_cast<const float2*>(p));
      v[0] = q.x;
      v[1] = q.y;
    } else {
      v[0] = __ldg(p);
    }
  }

  // A tile into registers: entries past L read as -inf (they never win
  // the maximum and are never stored).  L is a multiple of V, so a vector
  // is wholly inside the row or wholly past it.
  __device__ void load_tile(int base, int L, float (&v)[kHeadRegs]) const {
#pragma unroll
    for (int q = 0; q < kHeadRegs / V; ++q) {
      const int j = index(base, q);
      if (j < L) {
        load(j, v + q * V);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) v[q * V + e] = -INFINITY;
      }
    }
  }
};

template <bool kPlaneMajor, int V>
__global__ void __launch_bounds__(kHeadThreads)
    volume_head_kernel(const float* __restrict__ cost,
                       float* __restrict__ disparity, float* __restrict__ soft,
                       float* __restrict__ mask, float* __restrict__ conf,
                       float* __restrict__ resid, long long pixels,
                       long long frame, int W, int L, float beta,
                       float threshold, int all_pairs) {
  using Wk = Walk<kPlaneMajor, V>;
  const Wk walk(cost, pixels, frame, L);
  if (walk.n >= pixels) return;  // a warp's pixel: the whole warp

  float m = -INFINITY;   // the row's maximum so far (the group's)
  int arg = 0;           // its first index
  int ties = 0;          // the entries equal to it
  float bm = -INFINITY;  // beta m, the exponents' offset
  float s = 0.f, t = 0.f;  // this lane's sums of e[j] and j e[j]
  for (int base = 0; base < L; base += Wk::kTile) {
    float v[kHeadRegs];
    walk.load_tile(base, L, v);
    // The tile's maximum and first index: a lane's entries in index order
    // (a strict > keeps the first), then the group's, the lower index
    // winning a tie.
    float tm = -INFINITY;
    int ti = INT_MAX;
#pragma unroll
    for (int q = 0; q < kHeadRegs / V; ++q) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        if (v[q * V + e] > tm) {
          tm = v[q * V + e];
          ti = walk.index(base, q) + e;
        }
      }
    }
#pragma unroll
    for (int off = Wk::kLanes / 2; off > 0; off >>= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, tm, off);
      const int oi = __shfl_xor_sync(0xffffffffu, ti, off);
      if (om > tm || (om == tm && oi < ti)) {
        tm = om;
        ti = oi;
      }
    }
    int tc = 0;
#pragma unroll
    for (int r = 0; r < kHeadRegs; ++r) tc += v[r] == tm;
#pragma unroll
    for (int off = Wk::kLanes / 2; off > 0; off >>= 1)
      tc += __shfl_xor_sync(0xffffffffu, tc, off);
    if (tm > m) {
      m = tm;
      arg = ti;
      ties = tc;
    } else if (tm == m) {
      ties += tc;
    }
    const float bn = __fmul_rn(beta, m);
    if (bn > bm) {  // a larger maximum: the sums so far to the new offset
      const float scale = expf(__fsub_rn(bm, bn));
      s *= scale;
      t *= scale;
      bm = bn;
    }
#pragma unroll
    for (int q = 0; q < kHeadRegs / V; ++q) {
      const int j0 = walk.index(base, q);
      if (j0 < L) {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float x = expf(__fsub_rn(__fmul_rn(v[q * V + e], beta), bm));
          s += x;
          t = fmaf(static_cast<float>(j0 + e), x, t);
        }
      }
    }
  }
#pragma unroll
  for (int off = Wk::kLanes / 2; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    t += __shfl_xor_sync(0xffffffffu, t, off);
  }
  if (walk.lane == 0) {
    const long long n = walk.n;
    const float corr = t / s;
    const float mk = m > threshold ? 1.f : 0.f;
    const float w = static_cast<float>(n % W);
    const float a = static_cast<float>(arg);
    disparity[n] = all_pairs ? (w - a) * mk : a * mk;
    soft[n] = all_pairs ? (w - corr) * mk : corr * mk;
    mask[n] = mk;
    conf[n] = m;
    resid[n] = s;
    resid[pixels + n] = corr;
    resid[2 * pixels + n] = static_cast<float>(ties);
  }
}

template <bool kPlaneMajor, int V>
__global__ void __launch_bounds__(kHeadThreads)
    volume_head_grad_kernel(const float* __restrict__ cost,
                            const float* __restrict__ conf,
                            const float* __restrict__ resid,
                            const float* __restrict__ g_soft,
                            const float* __restrict__ g_conf,
                            float* __restrict__ g_cost, long long pixels,
                            long long frame, int L, float beta,
                            float threshold, int all_pairs) {
  using Wk = Walk<kPlaneMajor, V>;
  const Wk walk(cost, pixels, frame, L);
  if (walk.n >= pixels) return;
  const long long n = walk.n;
  const float m = __ldg(conf + n);
  const float bm = __fmul_rn(beta, m);
  const float s = __ldg(resid + n);
  const float corr = __ldg(resid + pixels + n);
  const float mk = m > threshold ? 1.f : 0.f;
  float gc = 0.f;
  if (g_soft != nullptr) {
    const float g = __ldg(g_soft + n) * mk;
    gc = all_pairs ? -g : g;
  }
  const float coef = beta * gc / s;
  const float gm =
      g_conf != nullptr ? __ldg(g_conf + n) / __ldg(resid + 2 * pixels + n)
                        : 0.f;
  // The cotangent has the volume's layout: the same offsets.
  float* __restrict__ out = g_cost + (walk.row - cost);
  for (int base = 0; base < L; base += Wk::kTile) {
    float v[kHeadRegs];
    walk.load_tile(base, L, v);
#pragma unroll
    for (int q = 0; q < kHeadRegs / V; ++q) {
      const int j0 = walk.index(base, q);
      if (j0 < L) {
        float g[V];
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float c = v[q * V + e];
          const float x = expf(__fsub_rn(__fmul_rn(c, beta), bm));
          g[e] = coef * x * (static_cast<float>(j0 + e) - corr);
          if (c == m) g[e] += gm;
        }
        float* p = out + j0 * walk.stride;
        if constexpr (V == 4) {
          *reinterpret_cast<float4*>(p) = make_float4(g[0], g[1], g[2], g[3]);
        } else if constexpr (V == 2) {
          *reinterpret_cast<float2*>(p) = make_float2(g[0], g[1]);
        } else {
          p[0] = g[0];
        }
      }
    }
  }
}

// The widest vector a parity row of L floats starting at each of the
// pointers takes: 4 where L % 4 == 0 and they are 16-byte aligned, 2 where
// L is even and they are 8-byte aligned, else 1.
int vector_width(int L, const void* a, const void* b) {
  const auto bits = reinterpret_cast<unsigned long long>(a) |
                    reinterpret_cast<unsigned long long>(b);
  if (L % 4 == 0 && bits % 16 == 0) return 4;
  if (L % 2 == 0 && bits % 8 == 0) return 2;
  return 1;
}

unsigned int head_blocks(long long pixels, bool plane_major) {
  const int per_block = plane_major ? kHeadThreads : kHeadThreads / 32;
  return static_cast<unsigned int>((pixels + per_block - 1) / per_block);
}

}  // namespace
}  // namespace custereo

using namespace custereo;

// cost: [pixels, L] (plane_major 0) or [pixels / frame, L, frame]
// (plane_major 1); disparity, soft, mask, conf [pixels]; resid [3, pixels]
// (s, corr, ties).  pixels >= 1, L >= 1.
extern "C" int custereo_volume_head(const float* cost, float* disparity,
                                    float* soft, float* mask, float* conf,
                                    float* resid, long long pixels,
                                    long long frame, int W, int L,
                                    float beta, float threshold,
                                    int all_pairs, int plane_major,
                                    void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const unsigned int grid = head_blocks(pixels, plane_major);
#define CUSTEREO_HEAD(P, V)                                                 \
  volume_head_kernel<P, V><<<grid, kHeadThreads, 0, stream>>>(              \
      cost, disparity, soft, mask, conf, resid, pixels, frame, W, L, beta, \
      threshold, all_pairs)
  if (plane_major) {
    CUSTEREO_HEAD(true, 1);
  } else {
    switch (vector_width(L, cost, cost)) {
      case 4: CUSTEREO_HEAD(false, 4); break;
      case 2: CUSTEREO_HEAD(false, 2); break;
      default: CUSTEREO_HEAD(false, 1);
    }
  }
#undef CUSTEREO_HEAD
  return cudaGetLastError();
}

// cost, g_cost as custereo_volume_head's cost; conf [pixels]; resid [3,
// pixels] from custereo_volume_head; g_soft, g_conf [pixels] or null (no
// cotangent).
extern "C" int custereo_volume_head_grad(const float* cost, const float* conf,
                                         const float* resid,
                                         const float* g_soft,
                                         const float* g_conf, float* g_cost,
                                         long long pixels, long long frame,
                                         int L, float beta, float threshold,
                                         int all_pairs, int plane_major,
                                         void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const unsigned int grid = head_blocks(pixels, plane_major);
#define CUSTEREO_HEAD_GRAD(P, V)                                           \
  volume_head_grad_kernel<P, V><<<grid, kHeadThreads, 0, stream>>>(        \
      cost, conf, resid, g_soft, g_conf, g_cost, pixels, frame, L, beta,   \
      threshold, all_pairs)
  if (plane_major) {
    CUSTEREO_HEAD_GRAD(true, 1);
  } else {
    switch (vector_width(L, cost, g_cost)) {
      case 4: CUSTEREO_HEAD_GRAD(false, 4); break;
      case 2: CUSTEREO_HEAD_GRAD(false, 2); break;
      default: CUSTEREO_HEAD_GRAD(false, 1);
    }
  }
#undef CUSTEREO_HEAD_GRAD
  return cudaGetLastError();
}
