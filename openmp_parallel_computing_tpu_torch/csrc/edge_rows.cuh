// The luma -> Sobel row policy of the row-streaming body
// (stencil_rows.cuh), shared by the two kernels that take the Sobel edge
// of a frame's luma: the fused edge pass (csrc/stencil.cu, edge_kernel)
// and the edge pyramid (csrc/edge_pyramid.cu). Each adds its own emit.
//
// A lane loads a run of V bytes of each of R, G and B (and A) a row, and
// lanes 0 and 31 the band's outer column; stage forms the fixed-point luma
// once per pixel and takes the neighbouring columns from the neighbouring
// lanes by shuffles. One plane (C = 1: the plane of ops.sobel, or a grey
// frame) is its own luma, since luma_fix(p, p, p) == p: one run a row is
// loaded and its bytes taken as they are. sobel_run gives a row's V magnitudes
// min(floor(sqrt(gx^2 + gy^2)), 255) from the window of three luma rows,
// with no border rule: each emit applies its own.

#pragma once

#include "luma.cuh"
#include "stencil_rows.cuh"

namespace edge_rows {

using luma::luma_fix;
using namespace stencil_rows;

// min(floor(sqrt(n)), 255) for 0 <= n < 2^23, exact. m = min(n, 255^2)
// goes to float and back by the 2^23 bias (m and the floor as the low
// mantissa bits), not the conversion instructions. The approximate rsqrtf
// (at most 2 ulp) gives s = m / sqrt(m) within 1e-4 of sqrt(m) <= 255;
// floor(s + 2^-10) is then exact: a perfect square k^2 lands in
// [k, k + 0.002), and any other m's root is at least 1 / 510 below the
// next integer, more than 2^-10 + 1e-4.
__device__ __forceinline__ int isqrt_255(int n) {
  constexpr float kBias = 8388608.f;  // 2^23
  const int m = min(n, 255 * 255);
  const float f = __int_as_float(0x4b000000 | m) - kBias;
  const float s = __fmaf_rn(f, rsqrtf(fmaxf(f, 1.f)), 0x1p-10f);
  return __float_as_int(__fadd_rz(s, kBias)) - 0x4b000000;
}

// The loads and the luma rows of a strip: C planes in (3 or 4; alpha is
// loaded, not used for the luma; 1 below), V bytes a lane.
template <int C, int V>
struct LumaRows {
  struct Raw {
    Run<uint8_t, V> c[C];  // R, G, B (and A) runs
    uint8_t e[3];          // R, G, B of the band's outer column (lanes 0, 31)
  };
  struct Row {
    int l[V + 2];          // luma of columns x - 1 .. x + V
    Run<uint8_t, V> a;     // alpha run (C == 4)
  };

  const uint8_t* __restrict__ src;
  int H, W;
  size_t plane;
  Strip s;

  __device__ __forceinline__ Raw fetch(int y) const {
    Raw raw;
    if (y < 0 || y >= H) {
#pragma unroll
      for (int c = 0; c < C; ++c) raw.c[c] = zero_run<uint8_t, V>();
#pragma unroll
      for (int c = 0; c < 3; ++c) raw.e[c] = 0;
      return raw;
    }
    const uint8_t* row = src + (size_t)y * W;
#pragma unroll
    for (int c = 0; c < C; ++c)
      raw.c[c] = fetch_run<V>(row + c * plane, s.x, W);
#pragma unroll
    for (int c = 0; c < 3; ++c) raw.e[c] = fetch_edge<V>(row + c * plane, s, W);
    return raw;
  }

  __device__ __forceinline__ Row stage(const Raw& raw) const {
    Row w;
#pragma unroll
    for (int v = 0; v < V; ++v)
      w.l[v + 1] = luma_fix(elem(raw.c[0], v), elem(raw.c[1], v),
                            elem(raw.c[2], v));
    link<V>(w.l, luma_fix(raw.e[0], raw.e[1], raw.e[2]), s.lane);
    if constexpr (C == 4) w.a = raw.c[3];
    return w;
  }
};

// One plane: a run of V bytes a row (and the band's outer byte), the bytes
// themselves as the luma.
template <int V>
struct LumaRows<1, V> {
  struct Raw {
    Run<uint8_t, V> c[1];
    uint8_t e;             // the band's outer column (lanes 0, 31)
  };
  struct Row {
    int l[V + 2];          // columns x - 1 .. x + V
  };

  const uint8_t* __restrict__ src;
  int H, W;
  size_t plane;
  Strip s;

  __device__ __forceinline__ Raw fetch(int y) const {
    Raw raw;
    if (y < 0 || y >= H) {
      raw.c[0] = zero_run<uint8_t, V>();
      raw.e = 0;
      return raw;
    }
    const uint8_t* row = src + (size_t)y * W;
    raw.c[0] = fetch_run<V>(row, s.x, W);
    raw.e = fetch_edge<V>(row, s, W);
    return raw;
  }

  __device__ __forceinline__ Row stage(const Raw& raw) const {
    Row w;
#pragma unroll
    for (int v = 0; v < V; ++v) w.l[v + 1] = elem(raw.c[0], v);
    link<V>(w.l, (int)raw.e, s.lane);
    return w;
  }
};

// The Sobel magnitudes of columns x .. x + V - 1 of the middle row of the
// window (up, mid, dn); out-of-plane neighbours are the zeros of the
// luma rows.
template <class Row, int V>
__device__ __forceinline__ void sobel_run(const Row& up, const Row& mid,
                                          const Row& dn, int (&o)[V]) {
  int cs[V + 2], dd[V + 2];  // column sums (1 2 1) and up - dn
#pragma unroll
  for (int j = 0; j < V + 2; ++j) {
    cs[j] = up.l[j] + 2 * mid.l[j] + dn.l[j];
    dd[j] = up.l[j] - dn.l[j];
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int gx = cs[v + 2] - cs[v];
    const int gy = dd[v] + 2 * dd[v + 1] + dd[v + 2];
    o[v] = isqrt_255(gx * gx + gy * gy);
  }
}

}  // namespace edge_rows
