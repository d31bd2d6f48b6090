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
// 3.35 TB/s).  A block stages a 32 x 32 tile in shared memory (one column
// of padding, so the transposed reads hit 32 banks) and both its reads and
// its writes run along rows of 32 neighbouring floats.
#include <cuda_runtime.h>

#include <cstddef>

namespace custereo {
namespace {

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
  return launch_transpose(vol, out, B, planes, pixels,
                          static_cast<cudaStream_t>(stream_ptr));
}

extern "C" int custereo_parity_to_plane_major(const float* g, float* out,
                                              int B, int planes, int pixels,
                                              void* stream_ptr) {
  return launch_transpose(g, out, B, pixels, planes,
                          static_cast<cudaStream_t>(stream_ptr));
}
