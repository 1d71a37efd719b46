// One iLQR sweep, one thread per scenario: the per-sweep path of the sweep
// backend (edge_refresh="ilqr", where the edge term is linearized again
// before every sweep, so the sweeps of an ADMM iteration cannot share one
// launch as in csrc/multi_sweep.cu).
//
// Replaces three TPU kernels of
// openmp_parallel_computing_tpu/models/mpc/sweep_pallas.py:
//   unified_sweep_launch  <- `_unified_sweep_kernel` (via `unified_sweep`):
//       the Riccati backward over tau = H-1 .. 0, then the line-searched
//       forward of the candidates alpha = (0, 1, 0.5, 0.25), in one launch;
//   backward_sweep_launch <- `_backward_sweep_kernel` (via `backward_sweep`):
//       the backward alone, the gains K, k as outputs;
//   forward_sweep_launch  <- `_forward_sweep_kernel` (via `forward_sweep`):
//       the forward alone, the gains as inputs (with zero gains it is the
//       nominal rollout of the controls, candidate 0).
// The steps are those of csrc/sweep_steps.cuh, shared with multi_sweep.cu.
// The forward writes every candidate's states ps_c (H+1, A, n, B), row 0 =
// p0 for every candidate, its controls us_c (H, A, c, B) and its cost
// J (A, B) with the terminal terms; the first-wins pick stays outside, as
// in the JAX solver.
//
// Where the gains live: the TPU kernel keeps them in VMEM scratch, which
// bounded the batch tile it admitted; here the wrapper allocates them in
// global memory (H, c, n, B), so nothing on the card bounds the unified
// kernel's admission and the solver takes it for every configuration. The
// split pair stays a path of the solver.
//
// What bounds it on Hopper, at B = 4096, H = 20, m = 8: the work is
// ~1 GFLOP of FP32 for the unified sweep (~15 us at 67 TFLOP/s); its inputs
// and outputs are ~2,900 floats a scenario (~47 MB, ~14 us at 3.35 TB/s),
// and ~4,100 more with the gains written and read back. As in multi_sweep,
// one thread carries a scenario's 16 x 16 Vxx and the step's 6 x 16
// products, beyond its 255 registers, so they live in local memory and the
// kernel is latency-bound per thread, far from either bound. Splitting a
// scenario over several threads is later work. nvcc contracts a*b+c into
// FMA, so the kernel is held to its plain version within a tolerance.

#include "sweep_steps.cuh"

namespace {

using sweep::A;
using sweep::C;
using sweep::kThreads;
using sweep::lane;
using sweep::load_row;
using sweep::store_row;

struct Params {
  int H, B;
  sweep::Weights W;
};

struct In {  // inputs; K and k only for the forward-only entry
  const float *p0, *ps, *us, *z, *y, *g, *target, *izd, *K, *k;
};

struct Out {  // outputs; K and k are the backward's (scratch of unified)
  float *ps_c, *us_c, *J, *K, *k;
};

// The candidate forward of one sweep against the gains K, k.
template <int M>
__device__ __forceinline__ void forward_pass(const In& in, const float* Kg,
                                             const float* kg, const Out& out,
                                             const float* tgt, const float* iz,
                                             const sweep::Weights& W, int H,
                                             size_t B, int b) {
  constexpr int N = 2 * M;
  float p0[N], pa[A][N], J[A];
  load_row<N>(in.p0, 0, B, b, p0);
#pragma unroll
  for (int a = 0; a < A; ++a) {
    J[a] = 0.0f;
#pragma unroll
    for (int i = 0; i < N; ++i) pa[a][i] = p0[i];
    store_row<N>(out.ps_c, a, B, b, p0);             // row 0, candidate a
  }
  for (int tau = 0; tau < H; ++tau) {
    float pn[N], un[C], zt[C], yt[C], gt[N], kt[C];
    load_row<N>(in.ps, tau, B, b, pn);
    load_row<N>(in.g, tau, B, b, gt);
    load_row<C>(in.us, tau, B, b, un);
    load_row<C>(in.z, tau, B, b, zt);
    load_row<C>(in.y, tau, B, b, yt);
    load_row<C>(kg, tau, B, b, kt);
    const float* Kt = Kg + lane(tau * C, 0, N, B, b);
#pragma unroll
    for (int a = 0; a < A; ++a) {
      float ua[C], nxt[N];
      J[a] = J[a] + sweep::cand_step<M>(sweep::alpha_of(a), pa[a], pn, un,
                                        kt, Kt, B, zt, yt, gt, tgt, iz, W,
                                        ua, nxt);
#pragma unroll
      for (int i = 0; i < N; ++i) pa[a][i] = nxt[i];
      store_row<C>(out.us_c, tau * A + a, B, b, ua);
      store_row<N>(out.ps_c, (tau + 1) * A + a, B, b, nxt);
    }
  }
  float pterm[N], gterm[N];
  load_row<N>(in.ps, H, B, b, pterm);
  load_row<N>(in.g, H, B, b, gterm);
#pragma unroll
  for (int a = 0; a < A; ++a)
    out.J[lane(0, a, A, B, b)] =
        sweep::add_terminal<M>(J[a], pa[a], pterm, gterm, tgt, W);
}

// kBackward, kForward: which halves of the sweep this launch runs.
template <int M, bool kBackward, bool kForward>
__global__ void __launch_bounds__(kThreads)
sweep_kernel(In in, Out out, Params P) {
  constexpr int N = 2 * M;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= P.B) return;
  const size_t B = (size_t)P.B;
  float tgt[N], iz[M];
  load_row<N>(in.target, 0, B, b, tgt);
  load_row<M>(in.izd, 0, B, b, iz);
  if (kBackward)
    sweep::backward_pass<M>(in.ps, in.us, in.z, in.y, in.g, tgt, iz, P.W,
                            P.H, B, b, out.K, out.k);
  if (kForward)
    forward_pass<M>(in, kBackward ? out.K : in.K, kBackward ? out.k : in.k,
                    out, tgt, iz, P.W, P.H, B, b);
}

template <bool kBackward, bool kForward>
int launch(int m, const In& in, const Out& out, const Params& P, void* stream) {
  if (P.H < 1 || P.B < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((P.B + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  switch (m) {
    case 2: sweep_kernel<2, kBackward, kForward><<<grid, kThreads, 0, s>>>(in, out, P); break;
    case 4: sweep_kernel<4, kBackward, kForward><<<grid, kThreads, 0, s>>>(in, out, P); break;
    case 8: sweep_kernel<8, kBackward, kForward><<<grid, kThreads, 0, s>>>(in, out, P); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Arrays (float32, scenario last): p0, target (n, B); inv_depth (m, B);
// ps, g (H+1, n, B); us, z, y, k (H, c, B); K (H, c, n, B); ps_c
// (H+1, A, n, B); us_c (H, A, c, B); J (A, B).

extern "C" int unified_sweep_launch(
    int m, const void* p0, const void* ps, const void* us, const void* z,
    const void* y, const void* g, const void* target, const void* inv_depth,
    void* ps_c, void* us_c, void* J, void* K_scratch, void* k_scratch, int H,
    int B, float q, float r, float rho, float qe, float dt, float reg,
    void* stream) {
  const In in{(const float*)p0, (const float*)ps, (const float*)us,
              (const float*)z, (const float*)y, (const float*)g,
              (const float*)target, (const float*)inv_depth, nullptr, nullptr};
  const Out out{(float*)ps_c, (float*)us_c, (float*)J, (float*)K_scratch,
                (float*)k_scratch};
  return launch<true, true>(m, in, out, Params{H, B, {q, r, rho, qe, dt, reg}},
                            stream);
}

extern "C" int backward_sweep_launch(
    int m, const void* ps, const void* us, const void* z, const void* y,
    const void* g, const void* target, const void* inv_depth, void* K,
    void* k, int H, int B, float q, float r, float rho, float qe, float dt,
    float reg, void* stream) {
  const In in{nullptr, (const float*)ps, (const float*)us, (const float*)z,
              (const float*)y, (const float*)g, (const float*)target,
              (const float*)inv_depth, nullptr, nullptr};
  const Out out{nullptr, nullptr, nullptr, (float*)K, (float*)k};
  return launch<true, false>(m, in, out,
                             Params{H, B, {q, r, rho, qe, dt, reg}}, stream);
}

extern "C" int forward_sweep_launch(
    int m, const void* p0, const void* ps, const void* us, const void* K,
    const void* k, const void* z, const void* y, const void* g,
    const void* target, const void* inv_depth, void* ps_c, void* us_c,
    void* J, int H, int B, float q, float r, float rho, float qe, float dt,
    void* stream) {
  const In in{(const float*)p0, (const float*)ps, (const float*)us,
              (const float*)z, (const float*)y, (const float*)g,
              (const float*)target, (const float*)inv_depth, (const float*)K,
              (const float*)k};
  const Out out{(float*)ps_c, (float*)us_c, (float*)J, nullptr, nullptr};
  return launch<false, true>(m, in, out,
                             Params{H, B, {q, r, rho, qe, dt, 0.0f}}, stream);
}
