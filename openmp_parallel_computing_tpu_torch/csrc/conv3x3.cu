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
// passes. A zero tap is skipped, never multiplied by 0 (that would turn an
// inf neighbour into a NaN).
//
// What bounds it on Hopper: bytes (a u8 blur pass on a 1080p RGB frame
// reads and writes 6.2 MB each, ~3.7 us at 3.35 TB/s). Design: the
// row-streaming body of stencil_rows.cuh (a warp walks a strip of 16 rows
// of one plane, a lane holds 4 values of a row: a 4-byte load and store
// for u8, 16 bytes for int32 and float32; neighbours by shuffles). The tap
// tests run once per run of V pixels, not per pixel. The division is a
// multiply-high and shifts by a magic number computed once on the host
// (Granlund-Montgomery, exact for every int32 accumulator), not a
// run-time integer division. The blur itself (GBLUR taps, norm 16, u8 in
// and out) has its own instance: the taps are 1-2-1 in both directions
// and non-negative on u8 input, so each row's horizontal 1-2-1 sum is
// formed once and reused by the three output rows whose window holds it,
// acc >= 0 divides by a shift, and acc <= 16 * 255 needs no clamp. The
// wrapper ping-pongs two buffers across passes.

#include <type_traits>

#include "stencil_rows.cuh"

namespace {

using namespace stencil_rows;

// The walk's sizes, chosen by timing the blur, the sharpen and the float
// modes at 1080p and 6 MP on an H100 (PERF.md §6): runs of 4, 8 and
// 16 u8 values, strips of 2-16 rows, rings of 2-8 rows.
constexpr int kStripRows = 16;  // S: output rows a warp walks
constexpr int kRingRows = 4;    // D: rows loaded ahead
constexpr int kU8Run = 4;       // V of u8 input: values (bytes) a lane

// V: u8 runs of kU8Run bytes, int32 and float32 runs of 16 bytes.
template <typename In>
__host__ __device__ constexpr int run_values() {
  return sizeof(In) == 1 ? kU8Run : 4;
}

// Truncating division by norm >= 1 as q = mulhi(mul, n) (+ n where add is
// -1), >> shift, + 1 for negative n where fix is 1 (Hacker's Delight,
// 10-1); norm 1 is mul 0, add -1, shift 0, fix 0.
struct Div {
  int mul, add, shift, fix;
};

struct ConvParams {
  int itap[9];     // taps for integer mode
  float ftap[9];   // taps for float mode
  Div div;         // integer mode divisor
  float inv_norm;  // float mode factor
};

__device__ __forceinline__ int div_trunc(int n, const Div& d) {
  int q = (int)((unsigned)__mulhi(d.mul, n) + (unsigned)(n & d.add));
  q >>= d.shift;
  return q + ((int)((unsigned)n >> 31) & d.fix);
}

template <typename Out, typename Acc>
__device__ __forceinline__ auto finish(Acc acc, const ConvParams& p) {
  if constexpr (std::is_same<Acc, float>::value) {
    acc = __fmul_rn(acc, p.inv_norm);
  } else {
    acc = div_trunc(acc, p.div);
  }
  if constexpr (std::is_same<Out, uint8_t>::value) {
    if constexpr (std::is_same<Acc, float>::value) {
      return (int)fminf(fmaxf(acc, 0.f), 255.f);
    } else {
      return min(max(acc, 0), 255);
    }
  } else {
    return acc;
  }
}

// Any taps, norm and types: each row's run converted to Acc and linked to
// its neighbours; per output row the nine taps, each tested once a run.
template <typename In, typename Acc, typename Out>
struct General {
  static constexpr int V = run_values<In>();
  struct Raw {
    Run<In, V> c;
    In e;
  };
  struct Row {
    Acc r[V + 2];
  };

  const In* __restrict__ src;
  Out* __restrict__ dst;
  int H, W;
  Strip s;
  const ConvParams& p;

  __device__ __forceinline__ Raw fetch(int y) const {
    if (y < 0 || y >= H) return Raw{zero_run<In, V>(), In(0)};
    const In* row = src + (size_t)y * W;
    return Raw{fetch_run<V>(row, s.x, W), fetch_edge<V>(row, s, W)};
  }

  __device__ __forceinline__ Row stage(const Raw& raw) const {
    Row w;
#pragma unroll
    for (int v = 0; v < V; ++v) w.r[v + 1] = (Acc)elem(raw.c, v);
    link<V>(w.r, (Acc)raw.e, s.lane);
    return w;
  }

  // acc += row[v + kx] * tap for the three taps of row ky.
  __device__ __forceinline__ void taps(Acc (&acc)[V], const Row& w,
                                       int ky) const {
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
      if constexpr (std::is_same<Acc, float>::value) {
        const float t = p.ftap[3 * ky + kx];
        if (t != 0.f) {
#pragma unroll
          for (int v = 0; v < V; ++v)
            acc[v] = __fadd_rn(acc[v], __fmul_rn(w.r[v + kx], t));
        }
      } else {
        const int t = p.itap[3 * ky + kx];
        if (t != 0) {
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] += w.r[v + kx] * t;
        }
      }
    }
  }

  __device__ __forceinline__ void emit(const Row& up, const Row& mid,
                                       const Row& dn, int y) const {
    Acc acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = Acc(0);
    taps(acc, up, 0);
    taps(acc, mid, 1);
    taps(acc, dn, 2);
    decltype(finish<Out>(Acc(0), p)) o[V];
#pragma unroll
    for (int v = 0; v < V; ++v) o[v] = finish<Out>(acc[v], p);
    store_run<Out>(dst + (size_t)y * W, s.x, W, o);
  }
};

// The Gaussian blur, u8 -> u8: taps (1 2 1) x (1 2 1), norm 16. A row
// keeps its horizontal sums l + 2c + r; an output is
// (up + 2 mid + dn) >> 4, in [0, 255].
struct Blur {
  using In = uint8_t;
  using Out = uint8_t;
  static constexpr int V = run_values<In>();
  using Raw = General<In, int, Out>::Raw;
  struct Row {
    int h[V];
  };

  const In* __restrict__ src;
  Out* __restrict__ dst;
  int H, W;
  Strip s;

  __device__ __forceinline__ Raw fetch(int y) const {
    if (y < 0 || y >= H) return Raw{zero_run<In, V>(), In(0)};
    const In* row = src + (size_t)y * W;
    return Raw{fetch_run<V>(row, s.x, W), fetch_edge<V>(row, s, W)};
  }

  __device__ __forceinline__ Row stage(const Raw& raw) const {
    int r[V + 2];
#pragma unroll
    for (int v = 0; v < V; ++v) r[v + 1] = elem(raw.c, v);
    link<V>(r, (int)raw.e, s.lane);
    Row w;
#pragma unroll
    for (int v = 0; v < V; ++v) w.h[v] = r[v] + 2 * r[v + 1] + r[v + 2];
    return w;
  }

  __device__ __forceinline__ void emit(const Row& up, const Row& mid,
                                       const Row& dn, int y) const {
    int o[V];
#pragma unroll
    for (int v = 0; v < V; ++v) o[v] = (up.h[v] + 2 * mid.h[v] + dn.h[v]) >> 4;
    store_run<Out>(dst + (size_t)y * W, s.x, W, o);
  }
};

template <typename In, typename Acc, typename Out>
__global__ void __launch_bounds__(kThreads)
    conv3x3_kernel(const In* __restrict__ in, Out* __restrict__ out, int C,
                   int H, int W, ConvParams p) {
  constexpr int V = run_values<In>();
  Strip s;
  if (!strip_of<V, kStripRows>(C, H, W, s)) return;
  const size_t plane = (size_t)s.z * H * W;
  General<In, Acc, Out> k{in + plane, out + plane, H, W, s, p};
  walk<kStripRows, kRingRows>(k, s.y0, H);
}

__global__ void __launch_bounds__(kThreads)
    blur_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                int C, int H, int W) {
  Strip s;
  if (!strip_of<Blur::V, kStripRows>(C, H, W, s)) return;
  const size_t plane = (size_t)s.z * H * W;
  Blur k{in + plane, out + plane, H, W, s};
  walk<kStripRows, kRingRows>(k, s.y0, H);
}

// Hacker's Delight 10-1 (magic for signed division) for d >= 2; norm 1
// divides by itself.
Div div_magic(int d) {
  if (d == 1) return Div{0, -1, 0, 0};
  const unsigned two31 = 0x80000000u;
  const unsigned ad = (unsigned)d;
  const unsigned anc = two31 - 1 - two31 % ad;
  int p = 31;
  unsigned q1 = two31 / anc, r1 = two31 - q1 * anc;
  unsigned q2 = two31 / ad, r2 = two31 - q2 * ad;
  unsigned delta;
  do {
    ++p;
    q1 *= 2;
    r1 *= 2;
    if (r1 >= anc) {
      ++q1;
      r1 -= anc;
    }
    q2 *= 2;
    r2 *= 2;
    if (r2 >= ad) {
      ++q2;
      r2 -= ad;
    }
    delta = ad - r2;
  } while (q1 < delta || (q1 == delta && r1 == 0));
  const int mul = (int)(q2 + 1);
  return Div{mul, mul < 0 ? -1 : 0, p - 32, 1};
}

template <typename In, typename Acc, typename Out>
int launch(const void* in, void* out, int C, int H, int W,
           const ConvParams& p, cudaStream_t stream) {
  const long long blocks = blocks_for(C, H, W, run_values<In>(), kStripRows);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  conv3x3_kernel<In, Acc, Out><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const In*)in, (Out*)out, C, H, W, p);
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

bool is_blur(int in_dtype, int integer, int clamp_u8, const int* itaps,
             int norm) {
  static const int kGblur[9] = {1, 2, 1, 2, 4, 2, 1, 2, 1};
  if (in_dtype != 0 || !integer || !clamp_u8 || norm != 16) return false;
  for (int k = 0; k < 9; ++k)
    if (itaps[k] != kGblur[k]) return false;
  return true;
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
  cudaStream_t s = (cudaStream_t)stream;
  if (is_blur(in_dtype, integer, clamp_u8, itaps, norm)) {
    const long long blocks = blocks_for(C, H, W, Blur::V, kStripRows);
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    blur_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        (const uint8_t*)in, (uint8_t*)out, C, H, W);
    return (int)cudaGetLastError();
  }
  ConvParams p;
  for (int k = 0; k < 9; ++k) {
    p.itap[k] = itaps[k];
    p.ftap[k] = ftaps[k];
  }
  p.div = div_magic(integer ? norm : 1);
  p.inv_norm = inv_norm;
  switch (in_dtype) {
    case 0: return launch_modes<uint8_t>(in, out, C, H, W, integer, clamp_u8, p, s);
    case 1: return launch_modes<int>(in, out, C, H, W, integer, clamp_u8, p, s);
    case 2: return launch_modes<float>(in, out, C, H, W, integer, clamp_u8, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
