// K9a and K9b: the layout conversions of a banded volume between
// plane-major [B, D+1, H, W] (what K1 and K3w write, what K2, K6 and K7
// read) and parity [B, H, W, D+1] (the reference's layout, disparity
// last), on Hopper.
//
// Replaces: custereomatching_tpu/ops/pallas_layout.py:_to_parity_kernel
// (K9a, driven by plane_major_to_parity) and _to_plane_major_kernel (K9b,
// driven by parity_to_plane_major).  The JAX kernels crop or fill the
// TPU's padded [ndt, h_pad, wo] extents; the port's volumes are exact, so
// both directions are one transpose of a [B, R, C] array to [B, C, R]:
// K9a with R = D+1 planes and C = H W pixels, K9b the other way round.
//
// What bounds it on the H100: bytes.  It moves each element once each way,
// 2 * 4 * B * (D+1) * H * W bytes (719 MB a KITTI frame, 0.215 ms at
// 3.35 TB/s).
//
// K9b: transpose_kernel.  A block stages a 32 x 32 tile in shared memory
// (one column of padding, so the transposed reads hit 32 banks) and both
// its reads and its writes run along rows of 32 neighbouring floats; its
// writes run along the planes, and the blocks that share a 128-byte
// segment of a plane are neighbours in the grid.
//
// K9a: to_parity_kernel, designed around the parity side's writes.  A
// block owns a run of kParityPixels pixels across a chunk of the planes
// (all R of them where R <= kParityChunk, as at KITTI's 193).  It reads
// each plane's run as one coalesced row (256 bytes), stages it in shared
// memory pixel-major, [pixel][plane], at an odd row stride (so a warp's
// 32 pixels of one plane hit 32 banks), and writes each pixel's planes as
// a warp-wide run.  With one chunk the block's output is one contiguous
// span, kParityPixels R floats from c0 R, 256-byte aligned, written by
// the block alone: no 32-byte sector of it waits in L2 for a block far
// away in the grid (transpose_kernel's row tiles would cut a pixel's 193
// planes into seven runs at a 772-byte stride, the last of one plane).
// Past kParityChunk planes the planes go in
// near-equal chunks, each pixel's output a run of the chunk's length, the
// chunks of a pixel run neighbours in the grid.  At R = 193: 64 x 193
// floats = 49,408 bytes a block, four blocks of 512 threads an SM, a
// thread's reads eight at a time (the loop unrolled by 8) in flight
// together: the reads bound it (about 0.19 of its 0.32 ms at KITTI on an
// H100; 512 threads a block ran 9% faster there than 256).
#include <cuda_runtime.h>

#include <cstddef>

namespace custereo {
namespace {

constexpr int kParityPixels = 64;
constexpr int kParityThreads = 512;
constexpr int kParityChunk = 256;
static_assert(kParityThreads % kParityPixels == 0 &&
                  kParityPixels % 32 == 0,
              "a pass reads whole runs; a warp's pixels are one run's");

// K9a's planes: chunks of near-equal length, at most kParityChunk; a
// pixel's staged row `stride` floats (odd).
struct ParityChunks {
  int chunks, planes, stride;
};

inline ParityChunks parity_chunks(int R) {
  const int chunks = (R + kParityChunk - 1) / kParityChunk;
  const int planes = (R + chunks - 1) / chunks;
  return {chunks, planes, planes | 1};
}

// out[b][c][r] = in[b][r][c] for r < R, c < C.  Grid: x = a pixel run
// times the chunks (the chunks of a run neighbours), frames in z;
// kParityThreads threads; dynamic shared memory kParityPixels * stride
// floats.
__global__ void __launch_bounds__(kParityThreads)
    to_parity_kernel(const float* __restrict__ in, float* __restrict__ out,
                     int R, int C, int chunks, int planes, int stride) {
  extern __shared__ float stage[];
  const int run = blockIdx.x / chunks, chunk = blockIdx.x - run * chunks;
  const int c0 = run * kParityPixels, r0 = chunk * planes;
  const int rn = min(planes, R - r0), cn = min(kParityPixels, C - c0);
  const size_t frame = static_cast<size_t>(blockIdx.z) * R * C;

  // Reads: kParityThreads / kParityPixels planes a pass, a plane's run of
  // pixels a row; a warp's 32 pixels of one plane.
  constexpr int kPass = kParityThreads / kParityPixels;
  const int c = threadIdx.x % kParityPixels;
  if (c < cn) {
    const float* src = in + frame + static_cast<size_t>(r0) * C + c0 + c;
#pragma unroll 8
    for (int r = threadIdx.x / kParityPixels; r < rn; r += kPass)
      stage[c * stride + r] = __ldg(src + static_cast<size_t>(r) * C);
  }
  __syncthreads();

  // Writes: a warp a pixel's rn planes at a time.
  const int lane = threadIdx.x % 32;
  for (int p = threadIdx.x / 32; p < cn; p += kParityThreads / 32) {
    float* dst = out + frame + static_cast<size_t>(c0 + p) * R + r0;
    const float* row = stage + p * stride;
    for (int r = lane; r < rn; r += 32) dst[r] = row[r];
  }
}

cudaError_t launch_to_parity(const float* in, float* out, int B, int R,
                             int C, cudaStream_t stream) {
  const ParityChunks pc = parity_chunks(R);
  const long long blocks =
      static_cast<long long>((C + kParityPixels - 1) / kParityPixels) *
      pc.chunks;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const size_t bytes =
      static_cast<size_t>(kParityPixels) * pc.stride * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        to_parity_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(static_cast<unsigned>(blocks), 1, B);
  to_parity_kernel<<<grid, kParityThreads, bytes, stream>>>(
      in, out, R, C, pc.chunks, pc.planes, pc.stride);
  return cudaGetLastError();
}

constexpr int kTile = 32;
constexpr int kTileRows = 8;  // threads per tile column: 32 x 8 a block

// out[b][c][r] = in[b][r][c] for r < R, c < C.  Grid: one block per 32 x 32
// tile, numbered row-tile-major in x (no grid-dimension limit on R or C),
// frames in z; block (32, 8).
__global__ void __launch_bounds__(kTile * kTileRows)
    transpose_kernel(const float* __restrict__ in, float* __restrict__ out,
                     int R, int C) {
  __shared__ float tile[kTile][kTile + 1];
  const int c_tiles = (C + kTile - 1) / kTile;
  const int r0 = (blockIdx.x / c_tiles) * kTile;
  const int c0 = (blockIdx.x % c_tiles) * kTile;
  const size_t frame = static_cast<size_t>(blockIdx.z) * R * C;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int j = ty; j < kTile; j += kTileRows) {
    const int r = r0 + j, c = c0 + tx;
    if (r < R && c < C)
      tile[j][tx] = __ldg(in + frame + static_cast<size_t>(r) * C + c);
  }
  __syncthreads();
  for (int j = ty; j < kTile; j += kTileRows) {
    const int c = c0 + j, r = r0 + tx;
    if (c < C && r < R)
      out[frame + static_cast<size_t>(c) * R + r] = tile[tx][j];
  }
}

cudaError_t launch_transpose(const float* in, float* out, int B, int R,
                             int C, cudaStream_t stream) {
  const long long tiles = static_cast<long long>((R + kTile - 1) / kTile) *
                          ((C + kTile - 1) / kTile);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(tiles), 1, B);
  transpose_kernel<<<grid, dim3(kTile, kTileRows), 0, stream>>>(in, out, R,
                                                                 C);
  return cudaGetLastError();
}

}  // namespace
}  // namespace custereo

using namespace custereo;

// Plain C interface, loaded with ctypes.  K9a: vol [B, planes, pixels] to
// out [B, pixels, planes]; K9b: g [B, pixels, planes] to out [B, planes,
// pixels]; fp32, contiguous, on the current device, every extent >= 1.
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 when the launch was accepted).
extern "C" int custereo_plane_major_to_parity(const float* vol, float* out,
                                              int B, int planes, int pixels,
                                              void* stream_ptr) {
  return launch_to_parity(vol, out, B, planes, pixels,
                          static_cast<cudaStream_t>(stream_ptr));
}

extern "C" int custereo_parity_to_plane_major(const float* g, float* out,
                                              int B, int planes, int pixels,
                                              void* stream_ptr) {
  return launch_transpose(g, out, B, pixels, planes,
                          static_cast<cudaStream_t>(stream_ptr));
}
