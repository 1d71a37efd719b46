// Pieces shared by the port's 3x3 image stencils: csrc/stencil.cu (Sobel,
// fused edge pipeline), csrc/conv3x3.cu (weighted convolution) and the
// luma of csrc/grayscale.cu.
//
// Tiling: a block of kTileW x kBlockY threads computes a kTileH x kTileW
// tile of one plane. It first stages the tile plus a one-pixel halo in
// shared memory, each value read from device memory once and 0 outside
// the H x W plane (every kernel's out-of-plane neighbours are zero), then
// each thread computes kTileH / kBlockY outputs down one column.
// Neighbouring threads own neighbouring columns, so a warp's loads and
// stores touch consecutive bytes. Halo reads are 1.13x the tile's own
// (34 x 34 staged for 32 x 32 computed), most of them served by L2.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace stencil3x3 {

constexpr int kTileW = 32;
constexpr int kTileH = 32;
constexpr int kBlockY = 8;
constexpr int kHaloW = kTileW + 2;
constexpr int kHaloH = kTileH + 2;

inline dim3 grid_for(int H, int W, int planes = 1) {
  return dim3((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, planes);
}

inline dim3 block_dims() { return dim3(kTileW, kBlockY); }

// Fixed-point BT.601 luma, (19595 r + 38470 g + 7471 b) >> 16: the weights
// sum to 2^16, so the result is an exact integer in [0, 255].
__device__ __forceinline__ int luma_fix(int r, int g, int b) {
  return (19595 * r + 38470 * g + 7471 * b) >> 16;
}

// Stage the halo tile of the block whose first output is (y0, x0):
// tile[ry * kHaloW + rx] = value((y0 - 1 + ry) * W + (x0 - 1 + rx)), and
// 0 outside the plane. The caller synchronises before reading it.
template <typename T, typename Value>
__device__ __forceinline__ void load_halo_tile(T* tile, int y0, int x0,
                                               int H, int W, Value value) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int n = blockDim.x * blockDim.y;
  for (int i = tid; i < kHaloH * kHaloW; i += n) {
    const int ry = i / kHaloW;
    const int rx = i - ry * kHaloW;
    const int gy = y0 - 1 + ry;
    const int gx = x0 - 1 + rx;
    tile[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                  ? value((size_t)gy * W + gx)
                  : T(0);
  }
}

// min(floor(sqrt(gx^2 + gy^2)), 255) of the 3x3 Sobel taps around tile
// index c. gx^2 + gy^2 <= 2 * 1020^2 < 2^24 is exact in f32, and
// __fsqrt_rn is the correctly rounded square root whatever the compiler
// flags, so the floor is the integer square root (an approximate sqrt can
// return k - eps for k^2 and floor one below).
__device__ __forceinline__ int sobel_mag(const int* tile, int c) {
  const int* up = tile + c - kHaloW;
  const int* mid = tile + c;
  const int* dn = tile + c + kHaloW;
  const int gx = -up[-1] - 2 * mid[-1] - dn[-1] + up[1] + 2 * mid[1] + dn[1];
  const int gy = up[-1] + 2 * up[0] + up[1] - dn[-1] - 2 * dn[0] - dn[1];
  return min((int)floorf(__fsqrt_rn((float)(gx * gx + gy * gy))), 255);
}

}  // namespace stencil3x3
