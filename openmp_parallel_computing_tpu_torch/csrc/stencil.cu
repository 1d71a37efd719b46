// The 3x3 Sobel stencil on a u8 plane, and the fused edge pipeline that
// forms that plane from an RGB(A) frame.
//
// Replaces two TPU kernels, both built on `stencil_mag` of
// openmp_parallel_computing_tpu/ops/sobel.py:
//   sobel_kernel <- `_sobel_kernel` (ops/sobel.py): (H, W) u8 -> (H, W) u8
//   edge_kernel  <- `_edge_kernel` (ops/pipeline.py): planar (3|4, H, W)
//                   u8 -> luma -> Sobel -> the magnitude in R, G and B,
//                   alpha copied.
// Same result, bit for bit:
//   mag = min(floor(sqrt(gx^2 + gy^2)), 255), neighbours outside the plane
//   are 0; zero_border != 0 also sets the 1-px image border to 0
//   (border="zero"), else the border is computed like the rest
//   (border="none").
//
// What bounds them on Hopper: bytes. One edge pass on a 1080p RGB frame
// reads 6.2 MB and writes 6.2 MB (~3.7 us at 3.35 TB/s); the arithmetic
// is a few dozen integer operations a pixel. Design: the shared halo tile
// of stencil3x3.cuh, one u8 read per staged pixel and plane, luma formed
// once per staged pixel in edge_kernel (not once per tap), outputs
// written by neighbouring threads to neighbouring bytes. A pass never
// runs in place (its neighbours' inputs would be overwritten): the
// wrapper ping-pongs two buffers.

#include "stencil3x3.cuh"

namespace {

using namespace stencil3x3;

__device__ __forceinline__ bool on_border(int y, int x, int H, int W) {
  return y == 0 || x == 0 || y == H - 1 || x == W - 1;
}

__global__ void sobel_kernel(const uint8_t* __restrict__ in,
                             uint8_t* __restrict__ out, int H, int W,
                             int zero_border) {
  __shared__ int tile[kHaloH * kHaloW];
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  load_halo_tile(tile, y0, x0, H, W, [in](size_t o) { return (int)in[o]; });
  __syncthreads();

  const int x = x0 + threadIdx.x;
  if (x >= W) return;
  for (int ty = threadIdx.y; ty < kTileH && y0 + ty < H; ty += blockDim.y) {
    const int y = y0 + ty;
    const int m = (zero_border && on_border(y, x, H, W))
                      ? 0
                      : sobel_mag(tile, (ty + 1) * kHaloW + threadIdx.x + 1);
    out[(size_t)y * W + x] = (uint8_t)m;
  }
}

__global__ void edge_kernel(const uint8_t* __restrict__ in,
                            uint8_t* __restrict__ out, int C, int H, int W,
                            int zero_border) {
  __shared__ int tile[kHaloH * kHaloW];
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const size_t plane = (size_t)H * W;
  load_halo_tile(tile, y0, x0, H, W, [in, plane](size_t o) {
    return luma_fix(in[o], in[plane + o], in[2 * plane + o]);
  });
  __syncthreads();

  const int x = x0 + threadIdx.x;
  if (x >= W) return;
  for (int ty = threadIdx.y; ty < kTileH && y0 + ty < H; ty += blockDim.y) {
    const int y = y0 + ty;
    const size_t o = (size_t)y * W + x;
    const uint8_t e =
        (uint8_t)((zero_border && on_border(y, x, H, W))
                      ? 0
                      : sobel_mag(tile, (ty + 1) * kHaloW + threadIdx.x + 1));
    out[o] = e;
    out[plane + o] = e;
    out[2 * plane + o] = e;
    if (C == 4) out[3 * plane + o] = in[3 * plane + o];
  }
}

}  // namespace

extern "C" int sobel_launch(const void* in, void* out, int H, int W,
                            int zero_border, void* stream) {
  if (H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  sobel_kernel<<<grid_for(H, W), block_dims(), 0, (cudaStream_t)stream>>>(
      (const uint8_t*)in, (uint8_t*)out, H, W, zero_border);
  return (int)cudaGetLastError();
}

extern "C" int edge_launch(const void* in, void* out, int C, int H, int W,
                           int zero_border, void* stream) {
  if (H < 1 || W < 1 || (C != 3 && C != 4)) return (int)cudaErrorInvalidValue;
  edge_kernel<<<grid_for(H, W), block_dims(), 0, (cudaStream_t)stream>>>(
      (const uint8_t*)in, (uint8_t*)out, C, H, W, zero_border);
  return (int)cudaGetLastError();
}
