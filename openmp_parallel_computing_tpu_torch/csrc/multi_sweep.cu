// All iLQR sweeps of one ADMM iteration, one thread per scenario.
//
// Replaces the TPU kernel `_multi_sweep_kernel` of
// openmp_parallel_computing_tpu/models/mpc/sweep_pallas.py (called through
// `multi_sweep`) and its helpers `_backward_step`, `_spd_solve_lanes`
// (riccati_pallas.py), `_forward_cand_step`, `_terminal_cost_accum`,
// `_select_winner` and `_dyn_step`. The whole sweep (`sweep::ilqr_sweep`)
// comes from csrc/sweep_steps.cuh, which csrc/sweep.cu (the per-sweep
// kernels) and csrc/full_solve.cu share. Per sweep, per scenario:
//   1. Riccati backward over tau = H-1 .. 0: closed-form IBVS Jacobian
//      (four diagonal m x m blocks in split layout) and fu, the expansion
//      of tracking + effort + ADMM augmentation + linearized edge term,
//      Quu + (2r + rho + reg) I, a 6x6 column Cholesky solve for the
//      gains K (c, n) and k (c). Vxx is not symmetrized.
//   2. Forward over tau = 0 .. H-1 for the candidates alpha = (0, 1, 0.5,
//      0.25): u = u_nom + alpha k + K (p - p_nom), running costs, the
//      clipped Euler step; the non-nominal candidates are stored.
//   3. Terminal cost, then a first-wins argmin over the candidates with a
//      non-finite cost counted as +inf; the winner's stored trajectory
//      replaces the nominal (a choice, never a one-hot product: 0 * NaN
//      would poison the winner). Row 0 of ps stays p0.
//
// Layout: the scenario index b is the fastest axis of every array, so a
// warp's 32 threads touch 32 consecutive floats on every access.
//   p0, target (n, B); inv_depth (m, B); ps, g (H+1, n, B);
//   us, z, y (H, c, B); outputs ps_out (H+1, n, B), us_out (H, c, B);
//   scratch (allocated by the caller) K (H, c, n, B), k (H, c, B),
//   pc (A-1, H, n, B), uc (A-1, H, c, B).
//
// What bounds it on Hopper: per-thread state. With m = 8 (n = 16) one
// scenario carries Vx (16), Vxx and its fx product (2 x 256), the
// candidate states (64) and the 6 x 16 products of the step; that is far
// above the 255 registers a thread may hold, so Vxx and the step's
// matrices live in local memory (cached in L1/L2, coalesced because local
// memory is interleaved by thread). The gains and candidates, ~53 MB at
// B = 4096, H = 20, go through global memory. The design keeps to one
// thread per scenario and small blocks (32 threads) so that even a batch
// of 4096 spreads over all 132 SMs; splitting one scenario's matrix work
// over several threads is later work. nvcc contracts a*b+c into FMA, so
// the last bits differ from the plain PyTorch version: this kernel is
// held to a tolerance, not to bit equality.

#include "sweep_steps.cuh"

namespace {

using sweep::C;
using sweep::kThreads;
using sweep::lane;
using sweep::load_row;

struct Params {
  int H, B, sweeps;
  sweep::Weights W;
};

template <int M>
__global__ void __launch_bounds__(kThreads)
multi_sweep_kernel(const float* __restrict__ p0g, const float* __restrict__ ps,
                   const float* __restrict__ us, const float* __restrict__ zg,
                   const float* __restrict__ yg, const float* __restrict__ g,
                   const float* __restrict__ tg, const float* __restrict__ izg,
                   float* __restrict__ ps_out, float* __restrict__ us_out,
                   float* __restrict__ Kg, float* __restrict__ kg,
                   float* __restrict__ pc, float* __restrict__ uc, Params P) {
  constexpr int N = 2 * M;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= P.B) return;
  const size_t B = (size_t)P.B;
  const int H = P.H;
  const sweep::Weights& W = P.W;

  float p0[N], tgt[N], iz[M];
  load_row<N>(p0g, 0, B, b, p0);
  load_row<N>(tg, 0, B, b, tgt);
  load_row<M>(izg, 0, B, b, iz);

  // The outputs double as the nominal trajectory across sweeps.
  for (int t = 0; t <= H; ++t)
#pragma unroll
    for (int i = 0; i < N; ++i) ps_out[lane(t, i, N, B, b)] = ps[lane(t, i, N, B, b)];
  for (int t = 0; t < H; ++t)
#pragma unroll
    for (int c = 0; c < C; ++c) us_out[lane(t, c, C, B, b)] = us[lane(t, c, C, B, b)];

  for (int sw = 0; sw < P.sweeps; ++sw)
    sweep::ilqr_sweep<M>(p0, tgt, iz, ps_out, us_out, zg, yg, g, W, H, B, b,
                         Kg, kg, pc, uc);
}

template <int M>
int launch(const float* const* in, float* const* out, const Params& P,
           cudaStream_t stream) {
  dim3 grid((P.B + kThreads - 1) / kThreads);
  multi_sweep_kernel<M><<<grid, kThreads, 0, stream>>>(
      in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7],
      out[0], out[1], out[2], out[3], out[4], out[5], P);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int multi_sweep_launch(
    int m, const void* p0, const void* ps, const void* us, const void* z,
    const void* y, const void* g, const void* target, const void* inv_depth,
    void* ps_out, void* us_out, void* K, void* k, void* pc, void* uc,
    int H, int B, int sweeps, float q, float r, float rho, float qe, float dt,
    float reg, void* stream) {
  if (H < 1 || B < 1 || sweeps < 0) return (int)cudaErrorInvalidValue;
  const float* in[8] = {(const float*)p0, (const float*)ps, (const float*)us,
                        (const float*)z, (const float*)y, (const float*)g,
                        (const float*)target, (const float*)inv_depth};
  float* out[6] = {(float*)ps_out, (float*)us_out, (float*)K, (float*)k,
                   (float*)pc, (float*)uc};
  const Params P{H, B, sweeps, {q, r, rho, qe, dt, reg}};
  cudaStream_t s = (cudaStream_t)stream;
  switch (m) {
    case 2: return launch<2>(in, out, P, s);
    case 4: return launch<4>(in, out, P, s);
    case 8: return launch<8>(in, out, P, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
