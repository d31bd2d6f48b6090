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
// K10b and K10c measure what the card's bulk copies sustain on a volume,
// as their JAX counterparts do on the TPU's DMA engine: _dma_read_kernel
// keeps a double-buffered ring of large async copies and issues step
// s + 1's before it consumes step s's, _dma_write_kernel writes whole
// [48, 8, 1280] tiles through the output pipeline.  Their rates,
// hbm_r3d and hbm_w3d, are the yardstick of every volume byte of the
// model: what a kernel's own loads and stores reach is measured against
// them, not built into them.
//
// K10b reads a plane-major [P, H, W] fp32 volume and writes each pixel's
// sum over the planes, in plane order, an [H, W] map.  A block owns a run
// of at most kReadRun pixels and walks the planes; the runs are cut so
// that every SM holds as many blocks (at KITTI's shape 527 runs of 884
// pixels, four blocks an SM).  The block's ring of kReadStages stages of
// kReadPlanes planes is filled by 1-D cp.async.bulk copies that a warp of
// its own issues and that complete on the stage's mbarrier with the
// bytes expected; that warp refills a stage as soon as each summing warp
// has arrived on the stage's second mbarrier, so no barrier holds the
// block (a block-wide barrier and thread 0 refilling ran 3% slower).  A
// bulk copy starts and ends on 16-byte boundaries, and at KITTI's shape a
// plane is 1,863,000 bytes (8 mod 16), so every other plane's run starts
// 2 floats off one: a run is copied from the boundary before it to the
// boundary after it, and a thread finds its pixel that many floats into
// the copy.  Only where that would cross the volume's first or last float
// is the copy cut to the boundaries inside the run, the few floats
// outside it read from global memory.  Each pixel's planes are added in
// order, so the sums are the plain version's.
//
// K10c writes out[d][h][w] = d over a new volume as one dense stream:
// the flat volume cut into one contiguous span a block, a grid that
// fills every SM (kWriteBlocksPerSm blocks of kWriteThreads threads), a
// 16-byte store a thread an instruction, a warp's stores 512 contiguous
// bytes.  A thread knows the plane its stores fall in and divides only
// when it crosses into the next; the floats after the last 16-byte
// boundary (the volume's count, 89,889,750 at KITTI, is 2 mod 4) are
// stored one at a time.  Both run at KITTI's volume
// (P = 193, 375 x 1242: 360 MB, seven times the 50 MB L2), so every byte
// crosses HBM.
//
// What bounds them on the H100: madd, exp and rsqrt the FP32 and
// multi-function pipes (67 TFLOP/s is 33.5 T FFMA/s); smem and boxadd the
// shared-memory pipe (one warp-wide 32-bit load a clock an SM), boxadd
// also its barriers; K10b and K10c the HBM (3.35 TB/s).
#include <cstdint>

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

// K10b's block: kReadThreads threads sum a run of at most kReadRun
// pixels, and one more warp issues the copies; its ring holds kReadStages
// stages of kReadPlanes planes' runs, each run kReadSlot floats (the run
// widened to the 16-byte boundaries around it, at most 6 floats more),
// and after them two barriers a stage.
constexpr int kReadThreads = 256;
constexpr int kReadRun = 1024;
constexpr int kReadPlanes = 4;
constexpr int kReadStages = 3;
constexpr int kReadSlot = kReadRun + 8;
constexpr int kReadPerThread = kReadRun / kReadThreads;
constexpr int kReadRingFloats = kReadStages * kReadPlanes * kReadSlot;
constexpr size_t kReadSmem =
    sizeof(float) * kReadRingFloats + sizeof(uint64_t) * 2 * kReadStages;
// K10c's grid: blocks an SM of kWriteThreads threads.
constexpr int kWriteThreads = 256;
constexpr int kWriteBlocksPerSm = 4;

__device__ inline uint32_t smem_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ inline void barrier_init(uint64_t* bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_address(bar)),
               "r"(arrivals)
               : "memory");
}

// One arrival that also expects `bytes` more of asynchronous copies.
__device__ inline void barrier_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_address(bar)),
      "r"(bytes)
      : "memory");
}

// One arrival.
__device__ inline void barrier_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_address(bar))
               : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed.
__device__ inline void barrier_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_address(bar)),
      "r"(parity)
      : "memory");
}

// Copies `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// global to shared memory; they count against `bar`'s expected bytes.
__device__ inline void bulk_load(float* dst, const float* src, uint32_t bytes,
                                 uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_address(dst)),
      "l"(src), "r"(bytes), "r"(smem_address(bar))
      : "memory");
}

// The copy of a run of `run` floats that starts at float s of a volume of
// n, `mis` floats past a 16-byte boundary: the floats [s + lo, s + hi).
// Widened to the boundaries around the run where they lie inside the
// volume (`whole`); else cut to the boundaries inside it (none when
// hi <= lo), and the few floats outside are read from global memory.
struct RunSpan {
  int lo, hi;
  bool whole;
  __device__ RunSpan(int mis, int run, long long s, long long n) {
    const int pad = (4 - ((mis + run) & 3)) & 3;
    whole = s >= mis && s + run + pad <= n;
    lo = whole ? -mis : (4 - mis) & 3;
    hi = whole ? run + pad : run - ((mis + run) & 3);
    if (hi < lo) hi = lo;
  }
};

// out[h][w] = sum_d vol[d][h][w], the planes in order.  Grid:
// ceil(H W / run_len) blocks of kReadThreads + 32 threads, block b the
// pixels [b run_len, (b + 1) run_len) (run_len <= kReadRun, a multiple of
// 4); dynamic shared memory kReadSmem bytes.
__global__ void __launch_bounds__(kReadThreads + 32)
    hbm_read_kernel(const float* __restrict__ vol, float* __restrict__ out,
                    int P, long long plane, int run_len) {
  extern __shared__ float smem[];
  float* ring = smem;
  // full[s]: stage s's copies have landed; empty[s]: every summing warp
  // is done with it.
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kReadRingFloats);
  uint64_t* empty = full + kReadStages;
  const long long q0 = static_cast<long long>(blockIdx.x) * run_len;
  const int run =
      static_cast<int>(plane - q0 < run_len ? plane - q0 : run_len);
  const int groups = (P + kReadPlanes - 1) / kReadPlanes;
  // Plane d's run starts (mis0 + d * mis_step) mod 4 floats past a
  // boundary (q0 is a multiple of 4).
  const int mis0 = static_cast<int>(reinterpret_cast<uintptr_t>(vol) >> 2) & 3;
  const int mis_step = static_cast<int>(plane & 3);
  const long long n = plane * P;
  const auto span = [&](int d) {
    return RunSpan((mis0 + (d & 3) * mis_step) & 3, run, d * plane + q0, n);
  };
  const auto slot = [&](int g, int j) {
    return ring + ((g % kReadStages) * kReadPlanes + j) * kReadSlot;
  };

  // Stage g % kReadStages takes planes [g kReadPlanes, +kReadPlanes), each
  // run's copy at slot(g, j).
  const auto issue = [&](int g) {
    uint64_t* bar = &full[g % kReadStages];
    const int d0 = g * kReadPlanes;
    uint32_t bytes = 0;
    for (int j = 0; j < kReadPlanes && d0 + j < P; ++j) {
      const RunSpan sp = span(d0 + j);
      bytes += 4 * (sp.hi - sp.lo);
    }
    barrier_expect(bar, bytes);
    for (int j = 0; j < kReadPlanes && d0 + j < P; ++j) {
      const RunSpan sp = span(d0 + j);
      if (sp.hi > sp.lo)
        bulk_load(slot(g, j), vol + (d0 + j) * plane + q0 + sp.lo,
                  4 * (sp.hi - sp.lo), bar);
    }
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < kReadStages; ++i) {
      barrier_init(&full[i], 1);
      barrier_init(&empty[i], kReadThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // The last warp: each group's copies, once the summing warps have left
  // the stage's last group.
  if (threadIdx.x >= kReadThreads) {
    if (threadIdx.x == kReadThreads)
      for (int g = 0; g < groups; ++g) {
        if (g >= kReadStages)
          barrier_wait(&empty[g % kReadStages], (g / kReadStages - 1) & 1);
        issue(g);
      }
    return;
  }

  float acc[kReadPerThread];
#pragma unroll
  for (int r = 0; r < kReadPerThread; ++r) acc[r] = 0.f;
  for (int g = 0; g < groups; ++g) {
    const int d0 = g * kReadPlanes;
    barrier_wait(&full[g % kReadStages], (g / kReadStages) & 1);
#pragma unroll
    for (int j = 0; j < kReadPlanes; ++j) {
      if (d0 + j < P) {
        // Pixel i of the run at s[i].
        const RunSpan sp = span(d0 + j);
        const float* s = slot(g, j) - sp.lo;
        if (sp.whole) {
#pragma unroll
          for (int r = 0; r < kReadPerThread; ++r) {
            const int i = threadIdx.x + r * kReadThreads;
            if (i < run) acc[r] += s[i];
          }
        } else {
          const float* src = vol + (d0 + j) * plane + q0;
#pragma unroll
          for (int r = 0; r < kReadPerThread; ++r) {
            const int i = threadIdx.x + r * kReadThreads;
            if (i >= sp.lo && i < sp.hi)
              acc[r] += s[i];
            else if (i < run)
              acc[r] += __ldg(src + i);
          }
        }
      }
    }
    // The warp is done with the stage.
    __syncwarp();
    if ((threadIdx.x & 31) == 0) barrier_arrive(&empty[g % kReadStages]);
  }
#pragma unroll
  for (int r = 0; r < kReadPerThread; ++r) {
    const int i = threadIdx.x + r * kReadThreads;
    if (i < run) out[q0 + i] = acc[r];
  }
}

// vol[x] = x / plane over the flat volume of n floats, 16-byte aligned:
// its quads (n / 4) 16 bytes a store, each block a contiguous span of
// them, and elements [4 quads, n) one at a time.  Grid: at most
// kWriteBlocksPerSm blocks an SM of kWriteThreads threads.
__global__ void __launch_bounds__(kWriteThreads)
    hbm_write_kernel(float* __restrict__ vol, long long n, long long plane,
                     long long quads) {
  // Threads 0-2 of block 0 store the floats after the quads.
  if (blockIdx.x == 0 && threadIdx.x < 3) {
    const long long x = 4 * quads + threadIdx.x;
    if (x < n) vol[x] = static_cast<float>(x / plane);
  }
  const long long per = (quads + gridDim.x - 1) / gridDim.x;
  const long long q_end =
      (blockIdx.x + 1) * per < quads ? (blockIdx.x + 1) * per : quads;
  long long q = blockIdx.x * per + threadIdx.x;
  if (q >= q_end) return;
  // next: the first element of the plane after d's.
  long long d = 4 * q / plane, next = (d + 1) * plane;
  float4* out = reinterpret_cast<float4*>(vol);
#pragma unroll 4
  for (; q < q_end; q += kWriteThreads) {
    const long long x = 4 * q;
    if (x >= next) {
      d = x / plane;
      next = (d + 1) * plane;
    }
    const float v = static_cast<float>(d);
    float4 w = make_float4(v, v, v, v);
    if (x + 3 >= next) {
      w.y = static_cast<float>((x + 1) / plane);
      w.z = static_cast<float>((x + 2) / plane);
      w.w = static_cast<float>((x + 3) / plane);
    }
    out[q] = w;
  }
}

// The current device's SM count, asked of the runtime once a device.
cudaError_t sm_count(int* sms) {
  static int known[64] = {};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device < 64 && known[device] > 0) {
    *sms = known[device];
    return cudaSuccess;
  }
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess && device < 64) known[device] = *sms;
  return e;
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

// K10b.  vol: [P, H, W], 4-byte aligned (any offset); out: [H, W].
extern "C" int custereo_hbm_read_probe(const float* vol, float* out, int P,
                                       int H, int W, void* stream_ptr) {
  if (P < 1 || H < 1 || W < 1) return cudaErrorInvalidValue;
  // The kernel's shared memory is allowed once a device.
  static bool allowed[64] = {};
  int device = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess && !(device < 64 && allowed[device])) {
    e = allow_smem(hbm_read_kernel, kReadSmem);
    if (e == cudaSuccess && device < 64) allowed[device] = true;
  }
  if (e == cudaSuccess) e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  // As many blocks on every SM, each a run of at most kReadRun pixels: the
  // fewest blocks an SM that take the plane, the pixels spread evenly
  // over them in runs of a multiple of 4.
  const long long plane = static_cast<long long>(H) * W;
  const long long per_sm = ((plane + kReadRun - 1) / kReadRun + sms - 1) / sms;
  const long long spread = per_sm * sms;
  const int run = static_cast<int>((plane + spread - 1) / spread + 3) / 4 * 4;
  const long long blocks = (plane + run - 1) / run;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  hbm_read_kernel<<<static_cast<unsigned>(blocks), kReadThreads + 32,
                    kReadSmem, static_cast<cudaStream_t>(stream_ptr)>>>(
      vol, out, P, plane, run);
  return cudaGetLastError();
}

// K10c.  vol: [P, H, W], 16-byte aligned.
extern "C" int custereo_hbm_write_probe(float* vol, int P, int H, int W,
                                        void* stream_ptr) {
  if (P < 1 || H < 1 || W < 1) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(vol) & 15) return cudaErrorInvalidValue;
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  const long long plane = static_cast<long long>(H) * W, n = plane * P;
  const long long quads = n / 4;
  const long long want = (quads + kWriteThreads - 1) / kWriteThreads;
  const long long fill = 1LL * sms * kWriteBlocksPerSm;
  const int blocks =
      static_cast<int>(want < 1 ? 1 : want < fill ? want : fill);
  hbm_write_kernel<<<blocks, kWriteThreads, 0,
                     static_cast<cudaStream_t>(stream_ptr)>>>(vol, n, plane,
                                                              quads);
  return cudaGetLastError();
}
