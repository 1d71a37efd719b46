// Pyramid edge cost and its analytic gradient at every trajectory point,
// one thread per point.
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
// x and y halves of a (K, 2m, B) split-layout state), so neighbouring
// threads read neighbouring floats. Outputs v (K, m, B) and, in the
// gradient mode, g (K, 2m, B) = [dv/dx; dv/dy].
//
// What bounds it on Hopper: bytes. At B = 4096, H = 20, m = 8 there are
// 688,128 points: the gradient mode moves 20 B a point (2 floats in,
// 3 out), 13.8 MB, ~4.1 us at 3.35 TB/s; the value mode 12 B a point.
// Its ~40 FP32 operations a point and level are far below the card's rate.
// The levels (34.7 KB at 1080p) are read through the read-only path and
// stay in L1/L2; staging them in shared memory is later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kThreads = 256;

struct Level {
  const float* L;
  int hf, wf;
  float off, inv_s, cx, cy;
};

struct Params {
  Level lv[kMaxLevels];
  int nlev, m, B, n_pts;
  long long xs, ys;        // k strides of x and y, in floats
  float half_w, half_h, inv255;
};

__device__ __forceinline__ float lerp2(float w0, float a, float w1, float b) {
  return __fadd_rn(__fmul_rn(w0, a), __fmul_rn(w1, b));
}

template <bool kGrads>
__global__ void __launch_bounds__(kThreads)
sample_kernel(const float* __restrict__ x, const float* __restrict__ y,
              float* __restrict__ v, float* __restrict__ g, Params P) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P.n_pts) return;
  const int mb = P.m * P.B;
  const int k = i / mb, r = i - k * mb;            // r = j * B + b
  const float xp = __fmul_rn(__fadd_rn(x[k * P.xs + r], 1.0f), P.half_w);
  const float yp = __fmul_rn(__fadd_rn(y[k * P.ys + r], 1.0f), P.half_h);
  float acc = 0.0f, gx = 0.0f, gy = 0.0f;
  for (int l = 0; l < P.nlev; ++l) {
    const Level& lv = P.lv[l];
    const float xr = __fmul_rn(__fsub_rn(xp, lv.off), lv.inv_s);
    const float yr = __fmul_rn(__fsub_rn(yp, lv.off), lv.inv_s);
    const float xhi = (float)(lv.wf - 1), yhi = (float)(lv.hf - 1);
    const float xl = fminf(fmaxf(xr, 0.0f), xhi);
    const float yl = fminf(fmaxf(yr, 0.0f), yhi);
    const bool ax = lv.wf > 1, ay = lv.hf > 1;
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
    acc = __fadd_rn(acc, __fsub_rn(1.0f, __fmul_rn(e, P.inv255)));
    if (kGrads) {
      if (ax) {
        const float mx = (xr >= 0.0f && xr <= xhi) ? 1.0f : 0.0f;
        const float col0 = ay ? lerp2(w0y, L00, w1y, L10) : L00;
        const float col1 = ay ? lerp2(w0y, L01, w1y, L11) : L01;
        gx = __fadd_rn(gx, __fmul_rn(__fmul_rn(lv.cx, mx),
                                     __fsub_rn(col1, col0)));
      }
      if (ay) {
        const float my = (yr >= 0.0f && yr <= yhi) ? 1.0f : 0.0f;
        gy = __fadd_rn(gy, __fmul_rn(__fmul_rn(lv.cy, my),
                                     __fsub_rn(row1, row0)));
      }
    }
  }
  v[i] = acc;
  if (kGrads) {
    float* gk = g + (size_t)k * 2 * mb;
    gk[r] = gx;
    gk[mb + r] = gy;
  }
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
    if (dims[2 * l] < 1 || dims[2 * l + 1] < 1)
      return (int)cudaErrorInvalidValue;
    P.lv[l] = Level{(const float*)levels[l], dims[2 * l], dims[2 * l + 1],
                    consts[4 * l], consts[4 * l + 1], consts[4 * l + 2],
                    consts[4 * l + 3]};
  }
  P.nlev = nlev;
  P.m = m;
  P.B = B;
  P.n_pts = (int)n;
  P.xs = xs;
  P.ys = ys;
  P.half_w = half_w;
  P.half_h = half_h;
  P.inv255 = inv255;
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads));
  cudaStream_t s = (cudaStream_t)stream;
  if (g)
    sample_kernel<true><<<grid, kThreads, 0, s>>>(
        (const float*)x, (const float*)y, (float*)v, (float*)g, P);
  else
    sample_kernel<false><<<grid, kThreads, 0, s>>>(
        (const float*)x, (const float*)y, (float*)v, nullptr, P);
  return (int)cudaGetLastError();
}
