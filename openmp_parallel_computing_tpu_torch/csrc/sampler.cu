// Pyramid edge cost and its analytic gradient at every trajectory point.
//
// Replaces the TPU kernel `_sample_kernel` of
// openmp_parallel_computing_tpu/models/mpc/sampler_pallas.py (called through
// `edge_vals_lanes` and `edge_vg_lanes`). The TPU kernel builds dense
// one-hot-pair hat weights per point and contracts them with the level on
// the matrix unit, because its compiler handles gathers poorly; here each
// point reads its four texels per level, the native form on a GPU:
//   row0 = w0x L[y0][x0] + w1x L[y0][x0+1],  row1 = the same on row y0+1,
//   col0 = w0y L[y0][x0] + w1y L[y0+1][x0],  col1 = the same on x0+1,
//   e = w0y row0 + w1y row1,  de/dxl = col1 - col0,  de/dyl = row1 - row0.
// Kept from the TPU kernel: the pixel map (xn + 1) * (0.5 (w - 1)), the
// half-cell offset (s - 1) / 2 and the * (1/s), the clip to [0, size - 1],
// x0 = clip(floor(xl), 0, size - 2), a single-cell axis with weight 1 and
// derivative 0 (x0 unused), the border masks that pass the gradient on the
// border and block it strictly outside, and the chain factors cx, cy formed
// in double precision on the host and rounded once. Levels add in level
// order; the mean over features and levels stays outside the kernel.
//
// Every operation is rounded as the plain PyTorch version rounds it
// (__fmul_rn / __fadd_rn / __fsub_rn forbid FMA contraction). Contraction
// would move xl by an ulp, and at an integer coordinate that flips x0 and
// with it the one-sided gradient; so the kernel and its plain version agree
// bit for bit.
//
// Layout: point (k, j, b) of the (K, m, B) coordinates; x and y may be
// views whose (m, B) block is contiguous with a k stride of their own (the
// x and y halves of a (K, 2m, B) split-layout state). Outputs v (K, m, B)
// and, in the gradient mode, g (K, 2m, B) = [dv/dx; dv/dy].
//
// What bounds it on Hopper: bytes, in principle. At B = 4096, H = 20,
// m = 8 there are 688,128 points: the gradient mode moves 20 B a point
// (2 floats in, 3 out), 13.8 MB, ~4.1 us at 3.35 TB/s; the value mode
// 12 B a point. In practice its arithmetic: the same launch without the
// level work takes well under half the time (PERF.md §6), the ~30
// rounded operations a
// point and level (each one the plain version's, so none can be fused or
// dropped) and their dependent chain the rest. Design: kPoints
// consecutive b a thread, with 8-byte loads of x and y and 8-byte stores
// of v and g where B, the k strides and the pointers allow it, else one
// point a thread; a thread's points are independent, so their chains
// interleave. Texels are read through L1 (the 1080p levels are 34.7 KB).
// Measured and not kept (bench/kernel_variants.py, PERF.md §6): copying
// the levels into each block's shared memory (slower at B = 4096 and 256),
// one point a thread throughout, the main path's two levels unrolled.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kPoints = 2;               // points a thread where aligned
constexpr int kThreads = 256;

struct Level {
  const float* L;
  int hf, wf;
  float off, inv_s, cx, cy;
  float xhi, yhi;          // wf - 1, hf - 1: the clip
};

struct Params {
  Level lv[kMaxLevels];
  int nlev, m, B, n_groups;
  int groups_k;            // groups of one k: m * B / kVec
  long long xs, ys;        // k strides of x and y, in floats
  float half_w, half_h, inv255;
};

__device__ __forceinline__ float lerp2(float w0, float a, float w1, float b) {
  return __fadd_rn(__fmul_rn(w0, a), __fmul_rn(w1, b));
}

// kVec (1 or 2) consecutive floats, one load or store.
template <int kVec>
__device__ __forceinline__ void load_vec(const float* p, float (&o)[kVec]) {
  static_assert(kVec == 1 || kVec == 2, "points a thread");
  if constexpr (kVec == 2) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(p));
    o[0] = q.x, o[1] = q.y;
  } else {
    o[0] = __ldg(p);
  }
}

template <int kVec>
__device__ __forceinline__ void store_vec(float* p, const float (&o)[kVec]) {
  if constexpr (kVec == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(o[0], o[1]);
  } else {
    p[0] = o[0];
  }
}

// Add level lv's cost (and gradient) at kVec points, in pixel
// coordinates (xp, yp).
template <bool kGrads, int kVec>
__device__ __forceinline__ void add_level(const Params& P, const Level& lv,
                                          const float (&xp)[kVec],
                                          const float (&yp)[kVec],
                                          float (&acc)[kVec],
                                          float (&gx)[kVec],
                                          float (&gy)[kVec]) {
  const bool ax = lv.wf > 1, ay = lv.hf > 1;
#pragma unroll
  for (int p = 0; p < kVec; ++p) {
    const float xr = __fmul_rn(__fsub_rn(xp[p], lv.off), lv.inv_s);
    const float yr = __fmul_rn(__fsub_rn(yp[p], lv.off), lv.inv_s);
    const float xl = fminf(fmaxf(xr, 0.0f), lv.xhi);
    const float yl = fminf(fmaxf(yr, 0.0f), lv.yhi);
    int x0 = 0, y0 = 0;
    float w0x = 1.0f, w1x = 0.0f, w0y = 1.0f, w1y = 0.0f;
    if (ax) {
      x0 = min(max((int)floorf(xl), 0), lv.wf - 2);
      w1x = __fsub_rn(xl, (float)x0);
      w0x = __fsub_rn(1.0f, w1x);
    }
    if (ay) {
      y0 = min(max((int)floorf(yl), 0), lv.hf - 2);
      w1y = __fsub_rn(yl, (float)y0);
      w0y = __fsub_rn(1.0f, w1y);
    }
    const float* row = lv.L + (size_t)y0 * lv.wf + x0;
    const float L00 = __ldg(row);
    const float L01 = ax ? __ldg(row + 1) : 0.0f;
    const float L10 = ay ? __ldg(row + lv.wf) : 0.0f;
    const float L11 = ax && ay ? __ldg(row + lv.wf + 1) : 0.0f;
    const float row0 = ax ? lerp2(w0x, L00, w1x, L01) : L00;
    const float row1 = ay ? (ax ? lerp2(w0x, L10, w1x, L11) : L10) : 0.0f;
    const float e = ay ? lerp2(w0y, row0, w1y, row1) : row0;
    acc[p] = __fadd_rn(acc[p], __fsub_rn(1.0f, __fmul_rn(e, P.inv255)));
    if (kGrads) {
      if (ax) {
        const float mx = (xr >= 0.0f && xr <= lv.xhi) ? 1.0f : 0.0f;
        const float col0 = ay ? lerp2(w0y, L00, w1y, L10) : L00;
        const float col1 = ay ? lerp2(w0y, L01, w1y, L11) : L01;
        gx[p] = __fadd_rn(gx[p], __fmul_rn(__fmul_rn(lv.cx, mx),
                                           __fsub_rn(col1, col0)));
      }
      if (ay) {
        const float my = (yr >= 0.0f && yr <= lv.yhi) ? 1.0f : 0.0f;
        gy[p] = __fadd_rn(gy[p], __fmul_rn(__fmul_rn(lv.cy, my),
                                           __fsub_rn(row1, row0)));
      }
    }
  }
}

// One thread a group of kVec points (k, r .. r + kVec - 1), r = j B + b,
// each summed over the levels in level order.
template <bool kGrads, int kVec>
__global__ void __launch_bounds__(kThreads)
sample_kernel(const float* __restrict__ x, const float* __restrict__ y,
              float* __restrict__ v, float* __restrict__ g, Params P) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P.n_groups) return;
  const int mb = P.m * P.B;
  const int k = i / P.groups_k;
  const int r = (i - k * P.groups_k) * kVec;
  float xp[kVec], yp[kVec], acc[kVec], gx[kVec], gy[kVec];
  load_vec<kVec>(x + k * P.xs + r, xp);
  load_vec<kVec>(y + k * P.ys + r, yp);
#pragma unroll
  for (int p = 0; p < kVec; ++p) {
    xp[p] = __fmul_rn(__fadd_rn(xp[p], 1.0f), P.half_w);
    yp[p] = __fmul_rn(__fadd_rn(yp[p], 1.0f), P.half_h);
    acc[p] = 0.0f, gx[p] = 0.0f, gy[p] = 0.0f;
  }
  for (int l = 0; l < P.nlev; ++l)
    add_level<kGrads, kVec>(P, P.lv[l], xp, yp, acc, gx, gy);
  store_vec<kVec>(v + (size_t)k * mb + r, acc);
  if (kGrads) {
    float* gk = g + (size_t)k * 2 * mb;
    store_vec<kVec>(gk + r, gx);
    store_vec<kVec>(gk + mb + r, gy);
  }
}

template <bool kGrads, int kVec>
void launch(const float* x, const float* y, float* v, float* g,
            const Params& P, cudaStream_t s) {
  const unsigned blocks = (unsigned)((P.n_groups + kThreads - 1) / kThreads);
  sample_kernel<kGrads, kVec><<<blocks, kThreads, 0, s>>>(x, y, v, g, P);
}

template <int kVec>
void launch_mode(const float* x, const float* y, float* v, float* g,
                 const Params& P, cudaStream_t s) {
  if (g)
    launch<true, kVec>(x, y, v, g, P, s);
  else
    launch<false, kVec>(x, y, v, nullptr, P, s);
}

}  // namespace

// levels: nlev device pointers; dims: (hf, wf) per level; consts: (off,
// inv_s, cx, cy) per level. g == nullptr selects the value-only mode.
extern "C" int sample_launch(const void* x, const void* y, long long xs,
                             long long ys, void* v, void* g, int nlev,
                             const void* const* levels, const int* dims,
                             const float* consts, int K, int m, int B,
                             float half_w, float half_h, float inv255,
                             void* stream) {
  if (nlev < 1 || nlev > kMaxLevels || K < 0 || m < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)K * m * B;
  if (n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Params P{};
  for (int l = 0; l < nlev; ++l) {
    const int hf = dims[2 * l], wf = dims[2 * l + 1];
    if (hf < 1 || wf < 1) return (int)cudaErrorInvalidValue;
    const float* c = consts + 4 * l;
    P.lv[l] = Level{(const float*)levels[l], hf, wf, c[0], c[1], c[2], c[3],
                    (float)(wf - 1), (float)(hf - 1)};
  }
  P.nlev = nlev;
  P.m = m;
  P.B = B;
  P.xs = xs;
  P.ys = ys;
  P.half_w = half_w;
  P.half_h = half_h;
  P.inv255 = inv255;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(y) |
                         reinterpret_cast<uintptr_t>(v) |
                         reinterpret_cast<uintptr_t>(g);
  const bool vec = B % kPoints == 0 && xs % kPoints == 0 &&
                   ys % kPoints == 0 && (addr & (4 * kPoints - 1)) == 0;
  P.n_groups = (int)(vec ? n / kPoints : n);
  P.groups_k = vec ? m * B / kPoints : m * B;
  const float* xf = (const float*)x;
  const float* yf = (const float*)y;
  float* vf = (float*)v;
  float* gf = (float*)g;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    launch_mode<kPoints>(xf, yf, vf, gf, P, s);
  else
    launch_mode<1>(xf, yf, vf, gf, P, s);
  return (int)cudaGetLastError();
}
