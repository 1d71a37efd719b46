// All iLQR sweeps of one ADMM iteration, a thread group per scenario.
//
// Replaces the TPU kernel `_multi_sweep_kernel` of
// openmp_parallel_computing_tpu/models/mpc/sweep_pallas.py (called through
// `multi_sweep`) and its helpers `_backward_step`, `_spd_solve_lanes`
// (riccati_pallas.py), `_forward_cand_step`, `_terminal_cost_accum`,
// `_select_winner` and `_dyn_step`. Each sweep is `sweep_group::ilqr_sweep`
// of csrc/sweep_group.cuh, the body csrc/full_solve.cu runs too: the
// Riccati backward about the nominal (closed-form IBVS Jacobians, the
// expansion of tracking + effort + ADMM augmentation + linearized edge
// term, Quu + (2r + rho + reg) I, a 6 x 6 Cholesky solve; Vxx not
// symmetrized), the forward of the candidates alpha = (0, 1, 0.5, 0.25),
// the terminal cost, a first-wins select with a non-finite cost counted as
// +inf, and the winner's replay over the nominal. Row 0 of ps stays p0.
//
// Layout: the scenario index b is the fastest axis of every array.
//   p0, target (n, B); inv_depth (m, B); ps, g (H+1, n, B);
//   us, z, y (H, c, B); outputs ps_out (H+1, n, B), us_out (H, c, B), which
//   hold the nominal across sweeps. No global scratch: the gains K (H, c, n)
//   and k (H, c) of a scenario live in shared memory, the candidates are
//   not stored.
//
// What bounds it on Hopper: the recursion is serial along the horizon, so a
// scenario's sweep is a chain of dependent steps; within a step the work is
// a few hundred FP32 operations a lane, shuffles and shared-memory
// broadcasts. The group of n threads (csrc/sweep_group.cuh) cuts the chain
// of a step n-fold against one thread per scenario and keeps every operand
// in registers or shared memory (no local memory), and the one-warp blocks
// spread even B = 256 over 128 SMs. Shared memory, ~9.5 KB a scenario at
// m = 8, H = 20 (the gains), sets how many groups an SM holds. The sums of
// Quu, Qu, K (p - p_nom) and the costs are taken in a butterfly order, and
// nvcc contracts a*b+c into FMA, so the last bits differ from the plain
// PyTorch version (~1e-6 relative on ps/us, growing along the horizon): the
// kernel is held to a tolerance, not to bit equality.

#include "sweep_group.cuh"

namespace {

using sweep_group::Geom;
using sweep_group::Layout;

struct Params {
  int H, B, sweeps;
  sweep::Weights W;
};

template <int M>
__global__ void __launch_bounds__(32)
multi_sweep_kernel(const float* __restrict__ p0, const float* __restrict__ ps,
                   const float* __restrict__ us, const float* __restrict__ z,
                   const float* __restrict__ y, const float* __restrict__ g,
                   const float* __restrict__ tgt, const float* __restrict__ iz,
                   float* ps_out, float* us_out, Params P) {
  constexpr int N = 2 * M, G = Geom<M>::G;
  extern __shared__ float4 smem4[];
  const Layout Lo = sweep_group::layout(M, P.H, false);
  const sweep_group::Place me = sweep_group::place<M>(
      reinterpret_cast<float*>(smem4), Lo, P.B);
  const size_t B = (size_t)P.B;
  if (me.live) {      // the outputs double as the nominal across sweeps
    for (int e = me.g; e < (P.H + 1) * N; e += G)
      ps_out[e * B + me.b] = ps[e * B + me.b];
    for (int e = me.g; e < P.H * sweep::C; e += G)
      us_out[e * B + me.b] = us[e * B + me.b];
  }
  __syncwarp();
  const sweep_group::Arrays X{p0, g, tgt, iz, z, y, ps_out, us_out, P.H, B,
                              P.W};
  for (int sw = 0; sw < P.sweeps; ++sw) sweep_group::ilqr_sweep<M>(X, me, Lo);
}

template <int M>
int launch(const float* const* in, float* const* out, const Params& P,
           cudaStream_t stream) {
  const Layout Lo = sweep_group::layout(M, P.H, false);
  const size_t bytes = sizeof(float) * Geom<M>::S * Lo.stride;
  int err = sweep_group::allow_smem(multi_sweep_kernel<M>, bytes);
  if (err) return err;
  const dim3 grid((P.B + Geom<M>::S - 1) / Geom<M>::S);
  multi_sweep_kernel<M><<<grid, 32, bytes, stream>>>(
      in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], out[0], out[1],
      P);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one block (bytes), for the solver's choice of
// path (sweep.group_sweep_fits).
extern "C" int multi_sweep_smem_bytes(int m, int H) {
  return (int)(sizeof(float) * (32 / (2 * m)) *
               sweep_group::layout(m, H, false).stride);
}

extern "C" int multi_sweep_launch(
    int m, const void* p0, const void* ps, const void* us, const void* z,
    const void* y, const void* g, const void* target, const void* inv_depth,
    void* ps_out, void* us_out, int H, int B, int sweeps, float q, float r,
    float rho, float qe, float dt, float reg, void* stream) {
  if (H < 1 || B < 1 || sweeps < 0) return (int)cudaErrorInvalidValue;
  const float* in[8] = {(const float*)p0, (const float*)ps, (const float*)us,
                        (const float*)z, (const float*)y, (const float*)g,
                        (const float*)target, (const float*)inv_depth};
  float* out[2] = {(float*)ps_out, (float*)us_out};
  const Params P{H, B, sweeps, {q, r, rho, qe, dt, reg}};
  cudaStream_t s = (cudaStream_t)stream;
  switch (m) {
    case 2: return launch<2>(in, out, P, s);
    case 4: return launch<4>(in, out, P, s);
    case 8: return launch<8>(in, out, P, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
