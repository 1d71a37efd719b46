// Batched Riccati backward sweep, a group of n lanes per scenario.
//
// Replaces the TPU kernel `_backward_kernel` of
// openmp_parallel_computing_tpu/models/mpc/riccati_pallas.py (called through
// `backward_batched`, the "fused" solver backend's backward). Per scenario,
// from the terminal (Vx, Vxx) = (vx, vxx), over t = H-1 .. 0:
//   Qx  = lx + fx^T Vx            Qu  = lu + fu^T Vx
//   Qxx = lxx + fx^T (Vxx fx)     Quu = luu + fu^T Vxx fu + reg I
//   Qux = lux + fu^T (Vxx fx)
//   [k | K] = -Quu^{-1} [Qu | Qux]  (one column Cholesky of the 6 x 6 Quu,
//                                    triangular solves multiplying by 1/d)
//   Vx  = Qx + Qux^T k            Vxx = Qxx + Qux^T K   (no symmetrization)
//
// Inputs arrive batch-first, as the JAX package's: fx (B,H,n,n), fu
// (B,H,n,c), lx (B,H,n), lu (B,H,c), lxx (B,H,n,n), luu (B,H,c,c), lux
// (B,H,c,n), vx (B,n), vxx (B,n,n), each with its own element strides along
// (b, t, i, j), 0 allowed: the solver passes the constant cost Hessians as
// broadcasts (stride 0), and they are read without being copied. Outputs K
// (B,H,c,n) and k (B,H,c) are contiguous. n = 4, 8 or 16; any B >= 1 and
// H >= 0.
//
// What bounds it. At B = 4096, H = 20, n = 16 the work is 2.4 GFLOP of FP32
// (~0.036 ms at 67 TFLOP/s) and the bytes ~156 MB (~0.047 ms at 3.35 TB/s),
// but the H steps of a scenario are a serial chain: two 16-deep sums, the
// Cholesky's 6 reciprocal square roots and its dependent updates, two
// 6-deep triangular solves. So the kernel is bound by latency and by how
// many scenarios an SM keeps in flight, and every barrier or shared-memory
// load on the chain counts.
//
// Design. A scenario gets a group of n lanes, a block is one warp (two
// scenarios at n = 16, four at 8, eight at 4), and the group synchronises
// with __syncwarp only: no block barrier, so all the scenarios of an SM are
// in flight at once. Lane k owns column k of every n x n product and keeps
// Vxx[:, k] in registers. Each step it publishes Vxx[:, k], fx[:, k], fu's
// row k and Vx[k] to a few KB of shared memory; then, three __syncwarp a
// step,
//   T[:, k] = Vxx fx[:, k]          columns of Vxx as float4s,
//   W[k, :] = Vxx[k, :] fu          row k of Vxx across the columns,
//   Quu = luu + fu^T W + reg I      21 entries spread over the lanes,
//   Qux[:, k] = lux + fu^T T[:, k]  and Qu = lu + fu^T Vx, one loop,
//   Qxx[:, k] = lxx + fx^T T[:, k]  columns of fx as float4s, the n sums
//                                   advancing together,
// so one shared load feeds four multiply-adds in the n x n products, and no
// product is computed twice (against ~970 warp-wide loads a scenario-step
// when a thread owned one element). Operands come back from shared memory
// rather than staying in the registers that published them: a value held
// across the step's long sums costs the scheduler more than the load. The
// 6 x 6 Cholesky (sweep_common.cuh, shared with the sweep kernels, here with
// rsqrtf for 1 / d) runs alike on every lane, and lane k solves both
// right-hand sides: column k of K and the feed-forward k. The next step's
// fx[:, k], fu row, lx, lu and lux[:, k] are loaded into registers while
// this step computes, so no load from device memory starts a step. Every sum
// runs in the plain version's order (riccati_lanes.py); nvcc contracts
// a*b+c into FMA and rsqrtf is within 2 ulp, so the kernel is held to the
// plain version within a tolerance. No tensor cores: TF32 keeps ~3 digits,
// short of the 1e-4 the kernel is held to, and the FP32 work is not what
// bounds it.

#include <climits>
#include <cstdlib>

#include "sweep_common.cuh"

namespace {

using sweep::C;

enum { FX, FU, LX, LU, LXX, LUU, LUX, VX, VXX, kInputs };

struct Args {
  const float* in[kInputs];
  long long sb[kInputs];         // element stride along b
  int st[kInputs][3];            // element strides along (t, i, j)
  float* K;
  float* k;
  int B, H;
  float reg;
};

// Element (t, i, j) of input w for scenario b. Within a scenario the
// offsets fit 32 bits (the launcher checks), which keeps the address
// arithmetic of the unrolled loops out of 64-bit registers.
__device__ __forceinline__ float at(const Args& a, int w, long long b, int t,
                                    int i, int j) {
  const int* s = a.st[w];
  return a.in[w][b * a.sb[w] + (t * s[0] + i * s[1] + j * s[2])];
}

// A block is one warp of 32 / n scenarios. One scenario's shared memory, in
// floats: the columns of Vxx, fx and T = Vxx fx (a column every P floats:
// P = n + 4 puts the eight lanes of a float4 store phase on different
// banks); the rows of fu and of W = Vxx fu and the columns of Qux, 8
// floats each, controls 0-2 at 0-2 and 3-5 at 4-6 (two float4s, a half of
// the controls each); Quu's lower triangle; Vx.
template <int N>
struct Geom {
  static constexpr int S = 32 / N;            // scenarios a block
  static constexpr int P = N + 4;
  static constexpr int V = 0;
  static constexpr int FXC = N * P;
  static constexpr int T = 2 * N * P;
  static constexpr int FU = 3 * N * P;
  static constexpr int W = FU + 8 * N;
  static constexpr int QUX = W + 8 * N;
  static constexpr int QUU = QUX + 8 * N;     // 21 used of 24
  static constexpr int VX = QUU + 24;
  static constexpr int STRIDE = VX + N;       // a multiple of 4
  static_assert(N == 4 || N == 8 || N == 16, "n must be 4, 8 or 16");
};

// Control c's place in an 8-float row: 0-2, then 4-6.
__device__ __forceinline__ int slot(int c) { return c + (c >= 3); }

// R consecutive floats of shared memory (R a multiple of 4), 16 bytes at a
// time.
template <int R>
__device__ __forceinline__ void load_rows(const float* p, float* v) {
#pragma unroll
  for (int q = 0; q < R; q += 4) {
    const float4 x = *reinterpret_cast<const float4*>(p + q);
    v[q] = x.x; v[q + 1] = x.y; v[q + 2] = x.z; v[q + 3] = x.w;
  }
}

template <int R>
__device__ __forceinline__ void store_rows(float* p, const float* v) {
#pragma unroll
  for (int q = 0; q < R; q += 4)
    *reinterpret_cast<float4*>(p + q) =
        make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
}

// What lane k reads of one step from device memory ahead of the step:
// fx[:, k]; for each half hh of the work, three of fu's row k (controls
// 3 hh .. 3 hh + 2) and the addend of that half's right-hand side
// (lux[:, k] for Qux[:, k], lu for Qu); lx[k].
template <int N>
struct StepIn {
  float fx[N], fu[2][3], add[2][C], lx;
};

template <int N>
__device__ __forceinline__ StepIn<N> load_step(const Args& a, long long b,
                                               int t, int k) {
  StepIn<N> s;
#pragma unroll
  for (int i = 0; i < N; ++i) s.fx[i] = at(a, FX, b, t, i, k);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
    for (int i = 0; i < 3; ++i) s.fu[hh][i] = at(a, FU, b, t, k, 3 * hh + i);
#pragma unroll
    for (int c = 0; c < C; ++c)
      s.add[hh][c] = hh == 0 ? at(a, LUX, b, t, c, k) : at(a, LU, b, t, c, 0);
  }
  s.lx = at(a, LX, b, t, k, 0);
  return s;
}

template <int N>
__global__ void __launch_bounds__(32) riccati_kernel(Args a) {
  using G = Geom<N>;
  constexpr int P = G::P;
  __shared__ __align__(16) float smem[G::S * G::STRIDE];
  const int k = threadIdx.x % N;               // the column this lane owns
  const int b_raw = blockIdx.x * G::S + threadIdx.x / N;
  const bool live = b_raw < a.B;
  const long long b = live ? b_raw : a.B - 1;  // a group past the end
                                               // reruns the last, writes none
  float* sm = smem + (threadIdx.x / N) * G::STRIDE;
  float* Vs = sm + G::V;
  float* fxs = sm + G::FXC;
  float* Ts = sm + G::T;
  float* fus = sm + G::FU;
  float* ws = sm + G::W;
  float* quxs = sm + G::QUX;
  float* quus = sm + G::QUU;
  float* vxs = sm + G::VX;

  float V[N];                                  // Vxx[:, k]
#pragma unroll
  for (int i = 0; i < N; ++i) V[i] = at(a, VXX, b, 0, i, k);
  float Vx = at(a, VX, b, 0, k, 0);            // Vx[k]

  StepIn<N> cur = load_step<N>(a, b, a.H - 1, k);
  for (int t = a.H - 1; t >= 0; --t) {
    const StepIn<N> nxt = load_step<N>(a, b, t > 0 ? t - 1 : 0, k);
    // Publish Vxx[:, k], fx[:, k], fu's row k and Vx[k]. Every reader of
    // these in the last step passed its second __syncwarp.
    store_rows<N>(Vs + k * P, V);
    store_rows<N>(fxs + k * P, cur.fx);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float4*>(fus + k * 8 + 4 * hh) =
          make_float4(cur.fu[hh][0], cur.fu[hh][1], cur.fu[hh][2], 0.0f);
    vxs[k] = Vx;
    __syncwarp();

    // Qx[k] = lx[k] + fx[:, k] . Vx; W[k, :] = Vxx[k, :] fu (row k of Vxx
    // across its columns); T[:, k] = Vxx fx[:, k]. The operands come back
    // from shared memory, not from the registers that published them: a
    // value held across the step's long sums costs the scheduler more.
    float sx = 0.0f, w[2][3], T[N];
#pragma unroll
    for (int j4 = 0; j4 < N; j4 += 4) {
      const float4 f4 = *reinterpret_cast<const float4*>(fxs + k * P + j4);
      const float4 v4 = *reinterpret_cast<const float4*>(vxs + j4);
      const float fj4[4] = {f4.x, f4.y, f4.z, f4.w};
      const float vj4[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = j4 + jj;
        const float fj = fj4[jj], vkj = Vs[j * P + k];
        float vr[N];
        load_rows<N>(Vs + j * P, vr);
        sx = j == 0 ? fj * vj4[jj] : sx + fj * vj4[jj];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float4 u =
              *reinterpret_cast<const float4*>(fus + j * 8 + 4 * hh);
          w[hh][0] = j == 0 ? vkj * u.x : w[hh][0] + vkj * u.x;
          w[hh][1] = j == 0 ? vkj * u.y : w[hh][1] + vkj * u.y;
          w[hh][2] = j == 0 ? vkj * u.z : w[hh][2] + vkj * u.z;
        }
#pragma unroll
        for (int i = 0; i < N; ++i)
          T[i] = j == 0 ? vr[i] * fj : T[i] + vr[i] * fj;
      }
    }
    const float Qx = cur.lx + sx;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float4*>(ws + k * 8 + 4 * hh) =
          make_float4(w[hh][0], w[hh][1], w[hh][2], 0.0f);
    store_rows<N>(Ts + k * P, T);
    __syncwarp();

    // Quu = luu + fu^T W + reg I: entry e = k, k + n, ... of the lower
    // triangle (row-major) to a lane.
#pragma unroll
    for (int e0 = 0; e0 < 21; e0 += N) {
      const int e = e0 + k < 21 ? e0 + k : 20;   // a spare lane redoes 20
      const int c = (e >= 1) + (e >= 3) + (e >= 6) + (e >= 10) + (e >= 15);
      const int d = e - c * (c + 1) / 2;
      const int sc = slot(c), sd = slot(d);
      float q = fus[sc] * ws[sd];
#pragma unroll
      for (int j = 1; j < N; ++j) q += fus[j * 8 + sc] * ws[j * 8 + sd];
      q = (at(a, LUU, b, t, c, d) + q) + (c == d ? a.reg : 0.0f);
      if (e0 + k < 21) quus[e] = q;
    }
    // The two right-hand sides: rhs[0] = Qux[:, k] = lux[:, k] +
    // fu^T T[:, k], rhs[1] = Qu = lu + fu^T Vx.
    float rhs[2][C];
#pragma unroll
    for (int j4 = 0; j4 < N; j4 += 4) {
      float vj4[2][4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float* vec = hh == 0 ? Ts + k * P : vxs;
        const float4 v4 = *reinterpret_cast<const float4*>(vec + j4);
        vj4[hh][0] = v4.x; vj4[hh][1] = v4.y;
        vj4[hh][2] = v4.z; vj4[hh][3] = v4.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = j4 + jj;
        const float4 u0 = *reinterpret_cast<const float4*>(fus + j * 8);
        const float4 u1 = *reinterpret_cast<const float4*>(fus + j * 8 + 4);
        const float f[C] = {u0.x, u0.y, u0.z, u1.x, u1.y, u1.z};
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int c = 0; c < C; ++c)
            rhs[hh][c] = j == 0 ? f[c] * vj4[hh][jj]
                                : rhs[hh][c] + f[c] * vj4[hh][jj];
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int c = 0; c < C; ++c) rhs[hh][c] = cur.add[hh][c] + rhs[hh][c];
    // Qxx[:, k] = lxx[:, k] + fx^T T[:, k], fx's columns and T four rows at
    // a time, so that the n sums advance together.
    float Qxx[N];
#pragma unroll
    for (int j4 = 0; j4 < N; j4 += 4) {
      const float4 t4 = *reinterpret_cast<const float4*>(Ts + k * P + j4);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float4 f4 = *reinterpret_cast<const float4*>(fxs + i * P + j4);
        float q = j4 == 0 ? f4.x * t4.x : Qxx[i] + f4.x * t4.x;
        q += f4.y * t4.y;
        q += f4.z * t4.z;
        Qxx[i] = q + f4.w * t4.w;
      }
    }
#pragma unroll
    for (int i = 0; i < N; ++i) Qxx[i] = at(a, LXX, b, t, i, k) + Qxx[i];
    *reinterpret_cast<float4*>(quxs + k * 8) =
        make_float4(rhs[0][0], rhs[0][1], rhs[0][2], 0.0f);
    *reinterpret_cast<float4*>(quxs + k * 8 + 4) =
        make_float4(rhs[0][3], rhs[0][4], rhs[0][5], 0.0f);
    __syncwarp();

    // [k | K[:, k]] = -Quu^-1 [Qu | Qux[:, k]], the factor alike on every
    // lane.
    float q24[24], Quu[C][C];
    load_rows<24>(quus, q24);
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int d = 0; d <= c; ++d) Quu[c][d] = q24[c * (c + 1) / 2 + d];
    float Lc[C][C], inv_d[C], X[2][C], Kc[C], kff[C];
    sweep::chol_factor<true>(Quu, Lc, inv_d);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      sweep::chol_solve(Lc, inv_d, rhs[hh], X[hh]);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      Kc[c] = -X[0][c];
      kff[c] = -X[1][c];
    }
    const size_t row = ((size_t)b * a.H + t) * C;
    if (live) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        a.K[(row + c) * N + k] = Kc[c];
        if (c % N == k) a.k[row + c] = kff[c];
      }
    }

    // Vx[k] = Qx[k] + Qux[:, k] . k; Vxx[:, k] = Qxx[:, k] + Qux^T K[:, k].
    {
      float s = rhs[0][0] * kff[0];
#pragma unroll
      for (int c = 1; c < C; ++c) s += rhs[0][c] * kff[c];
      Vx = Qx + s;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float4 q0 = *reinterpret_cast<const float4*>(quxs + i * 8);
      const float4 q1 = *reinterpret_cast<const float4*>(quxs + i * 8 + 4);
      const float q[C] = {q0.x, q0.y, q0.z, q1.x, q1.y, q1.z};
      float s = q[0] * Kc[0];
#pragma unroll
      for (int c = 1; c < C; ++c) s += q[c] * Kc[c];
      V[i] = Qxx[i] + s;
    }
    cur = nxt;
  }
}

template <int N>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int S = Geom<N>::S;
  if (a.H == 0) return 0;                       // no step, no output
  riccati_kernel<N><<<(a.B + S - 1) / S, 32, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int riccati_backward_launch(
    int n, const void* fx, const void* fu, const void* lx, const void* lu,
    const void* lxx, const void* luu, const void* lux, const void* vx,
    const void* vxx, const void* strides, void* K, void* k, int B, int H,
    float reg, void* stream) {
  if (B < 1 || H < 0) return (int)cudaErrorInvalidValue;
  Args a;
  const void* in[kInputs] = {fx, fu, lx, lu, lxx, luu, lux, vx, vxx};
  const long long* st = (const long long*)strides;
  for (int w = 0; w < kInputs; ++w) {
    a.in[w] = (const float*)in[w];
    a.sb[w] = st[4 * w];
    long long reach = 0;                        // the largest offset in b
    for (int d = 1; d < 4; ++d) {
      a.st[w][d - 1] = (int)st[4 * w + d];
      reach += (d == 1 ? H : n) * llabs(st[4 * w + d]);
    }
    if (reach > INT_MAX) return (int)cudaErrorInvalidValue;
  }
  a.K = (float*)K;
  a.k = (float*)k;
  a.B = B;
  a.H = H;
  a.reg = reg;
  cudaStream_t s = (cudaStream_t)stream;
  switch (n) {
    case 4: return launch<4>(a, s);
    case 8: return launch<8>(a, s);
    case 16: return launch<16>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
