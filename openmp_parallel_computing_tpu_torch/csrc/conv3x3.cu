// Zero-padded 3x3 weighted correlation (no flip) of every plane of a
// planar (C, H, W) image, normalized, optionally clamped to u8.
//
// Replaces the TPU kernel `_conv_kernel` of
// openmp_parallel_computing_tpu/ops/conv.py. Inputs u8, int32 or f32;
// the accumulator is int32 (integer mode) or f32; the output is the
// accumulator's type, or u8 when clamped. Per output pixel:
//   acc = 0; for ky, for kx (ky-major), tap != 0: acc += x[y+ky-1][x+kx-1] * tap
//   integer: acc = acc / norm            (C division, truncates toward 0)
//   float:   acc = acc * (1 / norm)      (f32(1/norm), as the Pallas kernel)
//   clamped: min(max(acc, 0), 255), then truncated to u8
// with x = 0 outside the plane. Integer modes are exact. The float mode
// adds and multiplies with __fadd_rn/__fmul_rn in the order above, so nvcc
// cannot contract them into FMAs: it is bit-exact with the plain PyTorch
// version, whose adds and multiplies are separate ops, at any number of
// passes.
//
// What bounds it on Hopper: bytes (a u8 blur pass on a 1080p RGB frame
// reads and writes 6.2 MB each); nine multiply-adds a value. Design: the
// shared halo tile of stencil3x3.cuh, one block per 32 x 32 tile of one
// plane (grid z = plane), input converted to the accumulator's type once
// as it is staged. The wrapper ping-pongs two buffers across passes.

#include <type_traits>

#include "stencil3x3.cuh"

namespace {

using namespace stencil3x3;

struct ConvParams {
  int itap[9];     // taps for integer mode
  float ftap[9];   // taps for float mode
  int norm;        // integer mode divisor
  float inv_norm;  // float mode factor
};

template <typename Out, typename Acc>
__device__ __forceinline__ Out finish(Acc acc, const ConvParams& p) {
  if constexpr (std::is_same<Acc, float>::value) {
    acc = __fmul_rn(acc, p.inv_norm);
  } else {
    acc = acc / p.norm;
  }
  if constexpr (std::is_same<Out, uint8_t>::value) {
    if constexpr (std::is_same<Acc, float>::value) {
      return (uint8_t)(int)fminf(fmaxf(acc, 0.f), 255.f);
    } else {
      return (uint8_t)min(max(acc, 0), 255);
    }
  } else {
    return acc;
  }
}

template <typename In, typename Acc, typename Out>
__global__ void conv3x3_kernel(const In* __restrict__ in,
                               Out* __restrict__ out, int H, int W,
                               ConvParams p) {
  __shared__ Acc tile[kHaloH * kHaloW];
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const size_t plane = (size_t)H * W;
  const In* src = in + blockIdx.z * plane;
  Out* dst = out + blockIdx.z * plane;
  load_halo_tile(tile, y0, x0, H, W, [src](size_t o) { return (Acc)src[o]; });
  __syncthreads();

  const int x = x0 + threadIdx.x;
  if (x >= W) return;
  for (int ty = threadIdx.y; ty < kTileH && y0 + ty < H; ty += blockDim.y) {
    const Acc* c = tile + (ty + 1) * kHaloW + threadIdx.x + 1;
    Acc acc = 0;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const Acc v = c[(k / 3 - 1) * kHaloW + (k % 3 - 1)];
      if constexpr (std::is_same<Acc, float>::value) {
        if (p.ftap[k] != 0.f) acc = __fadd_rn(acc, __fmul_rn(v, p.ftap[k]));
      } else {
        if (p.itap[k] != 0) acc += v * p.itap[k];
      }
    }
    dst[(size_t)(y0 + ty) * W + x] = finish<Out>(acc, p);
  }
}

template <typename In, typename Acc, typename Out>
int launch(const void* in, void* out, int C, int H, int W,
           const ConvParams& p, cudaStream_t stream) {
  conv3x3_kernel<In, Acc, Out><<<grid_for(H, W, C), block_dims(), 0, stream>>>(
      (const In*)in, (Out*)out, H, W, p);
  return (int)cudaGetLastError();
}

template <typename In>
int launch_modes(const void* in, void* out, int C, int H, int W, int integer,
                 int clamp_u8, const ConvParams& p, cudaStream_t stream) {
  if (integer) {
    return clamp_u8 ? launch<In, int, uint8_t>(in, out, C, H, W, p, stream)
                    : launch<In, int, int>(in, out, C, H, W, p, stream);
  }
  return clamp_u8 ? launch<In, float, uint8_t>(in, out, C, H, W, p, stream)
                  : launch<In, float, float>(in, out, C, H, W, p, stream);
}

}  // namespace

// in_dtype: 0 = u8, 1 = int32, 2 = float32. itaps/ftaps: 9 host values,
// row-major.
extern "C" int conv3x3_launch(const void* in, void* out, int in_dtype, int C,
                              int H, int W, int integer, int clamp_u8,
                              const int* itaps, const float* ftaps, int norm,
                              float inv_norm, void* stream) {
  if (H < 1 || W < 1 || C < 1 || C > 65535 || (integer && norm < 1))
    return (int)cudaErrorInvalidValue;
  ConvParams p;
  for (int k = 0; k < 9; ++k) {
    p.itap[k] = itaps[k];
    p.ftap[k] = ftaps[k];
  }
  p.norm = norm;
  p.inv_norm = inv_norm;
  cudaStream_t s = (cudaStream_t)stream;
  switch (in_dtype) {
    case 0: return launch_modes<uint8_t>(in, out, C, H, W, integer, clamp_u8, p, s);
    case 1: return launch_modes<int>(in, out, C, H, W, integer, clamp_u8, p, s);
    case 2: return launch_modes<float>(in, out, C, H, W, integer, clamp_u8, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
