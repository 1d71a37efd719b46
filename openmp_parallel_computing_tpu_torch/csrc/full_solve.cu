// The whole ADMM solve in one launch, one thread per scenario.
//
// Replaces the TPU kernel `_full_solve_kernel` of
// openmp_parallel_computing_tpu/models/mpc/sweep_pallas.py (called through
// `full_solve`), for the edge schedule that linearizes the edge term once a
// solve (g fixed for the whole solve). Per scenario:
//   1. z = clip(us0, +-u_limit), y = 0; the nominal is the streamed input
//      (ps, the rollout of us0 done outside, and us0).
//   2. For each of `admm_iters` iterations: `sweeps` iLQR sweeps with a
//      winner select (`sweep::ilqr_sweep` of csrc/sweep_steps.cuh, the
//      source multi_sweep.cu runs: one source of the recursion), each about
//      the current nominal, its terminal expansion at the nominal's row H;
//      then u^ = relax us + (1 - relax) z (u^ = us when relax is 1),
//      z = clip(u^ + y), y = y + u^ - z over the whole horizon.
//   3. The feasible rollout of z from p0 (the clipped Euler `dyn_step`).
// Outputs: ps_out (H+1, n, B), the rollout of z with row 0 = p0; z_out
// (H, c, B); us_out (H, c, B), the last unprojected controls.
//
// Layout and memory as multi_sweep.cu: the scenario index b is the fastest
// axis of every array; the nominal lives in ps_out / us_out during the
// solve (ps_out is overwritten by the final rollout), z in z_out, and y, the
// gains K (H, c, n, B), k (H, c, B) and the stored candidates pc
// (A-1, H, n, B), uc (A-1, H, c, B) in global scratch the caller allocates.
//
// What bounds it on Hopper: as multi_sweep, the per-thread state (m = 8
// spills Vxx to local memory) and the latency of one thread's sequential
// recursion, now admm_iters x sweeps long; at B = 4096 one thread per
// scenario fills 128 blocks of 32. The ADMM update rounds each product and
// sum on its own (`__fmul_rn`, `__fadd_rn`), as the eager update between
// multi_sweep launches does, so the two agree bit for bit when the sweeps
// do.

#include "sweep_steps.cuh"

namespace {

using sweep::C;
using sweep::kThreads;
using sweep::lane;
using sweep::load_row;
using sweep::store_row;

struct Params {
  int H, B, sweeps, admm_iters, over_relax;
  float u_limit, relax, one_minus_relax;
  sweep::Weights W;
};

// clamp(x, -lim, lim) keeping a NaN, as torch.clamp does.
__device__ __forceinline__ float clip(float x, float lim) {
  return x != x ? x : fminf(fmaxf(x, -lim), lim);
}

template <int M>
__global__ void __launch_bounds__(kThreads)
full_solve_kernel(const float* __restrict__ p0g, const float* __restrict__ ps,
                  const float* __restrict__ us, const float* __restrict__ g,
                  const float* __restrict__ tg, const float* __restrict__ izg,
                  float* __restrict__ ps_out, float* __restrict__ z_out,
                  float* __restrict__ us_out, float* __restrict__ yg,
                  float* __restrict__ Kg, float* __restrict__ kg,
                  float* __restrict__ pc, float* __restrict__ uc, Params P) {
  constexpr int N = 2 * M;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= P.B) return;
  const size_t B = (size_t)P.B;
  const int H = P.H;

  float p0[N], tgt[N], iz[M];
  load_row<N>(p0g, 0, B, b, p0);
  load_row<N>(tg, 0, B, b, tgt);
  load_row<M>(izg, 0, B, b, iz);

  for (int t = 0; t <= H; ++t)
#pragma unroll
    for (int i = 0; i < N; ++i) ps_out[lane(t, i, N, B, b)] = ps[lane(t, i, N, B, b)];
  for (int t = 0; t < H; ++t)
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const size_t i = lane(t, c, C, B, b);
      us_out[i] = us[i];
      z_out[i] = clip(us[i], P.u_limit);
      yg[i] = 0.0f;
    }

  for (int it = 0; it < P.admm_iters; ++it) {
    for (int sw = 0; sw < P.sweeps; ++sw)
      sweep::ilqr_sweep<M>(p0, tgt, iz, ps_out, us_out, z_out, yg, g, P.W, H,
                           B, b, Kg, kg, pc, uc);
    for (int t = 0; t < H; ++t)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const size_t i = lane(t, c, C, B, b);
        const float u = us_out[i], zt = z_out[i], yt = yg[i];
        const float uh = P.over_relax
            ? __fadd_rn(__fmul_rn(P.relax, u), __fmul_rn(P.one_minus_relax, zt))
            : u;
        const float zn = clip(__fadd_rn(uh, yt), P.u_limit);
        yg[i] = __fsub_rn(__fadd_rn(yt, uh), zn);
        z_out[i] = zn;
      }
  }

  // The feasible rollout of z.
  float p[N];
#pragma unroll
  for (int i = 0; i < N; ++i) p[i] = p0[i];
  store_row<N>(ps_out, 0, B, b, p0);
  for (int t = 0; t < H; ++t) {
    float u[C], nxt[N];
    load_row<C>(z_out, t, B, b, u);
    sweep::dyn_step<M>(p, u, iz, P.W.dt, nxt);
    store_row<N>(ps_out, t + 1, B, b, nxt);
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = nxt[i];
  }
}

template <int M>
int launch(const float* const* in, float* const* out, const Params& P,
           cudaStream_t stream) {
  dim3 grid((P.B + kThreads - 1) / kThreads);
  full_solve_kernel<M><<<grid, kThreads, 0, stream>>>(
      in[0], in[1], in[2], in[3], in[4], in[5], out[0], out[1], out[2],
      out[3], out[4], out[5], out[6], out[7], P);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int full_solve_launch(
    int m, const void* p0, const void* ps, const void* us, const void* g,
    const void* target, const void* inv_depth, void* ps_out, void* z_out,
    void* us_out, void* y, void* K, void* k, void* pc, void* uc, int H,
    int B, int sweeps, int admm_iters, int over_relax, float q, float r,
    float rho, float qe, float dt, float reg, float u_limit, float relax,
    float one_minus_relax, void* stream) {
  if (H < 1 || B < 1 || sweeps < 0 || admm_iters < 0)
    return (int)cudaErrorInvalidValue;
  const float* in[6] = {(const float*)p0, (const float*)ps, (const float*)us,
                        (const float*)g, (const float*)target,
                        (const float*)inv_depth};
  float* out[8] = {(float*)ps_out, (float*)z_out, (float*)us_out, (float*)y,
                   (float*)K, (float*)k, (float*)pc, (float*)uc};
  const Params P{H, B, sweeps, admm_iters, over_relax, u_limit, relax,
                 one_minus_relax, {q, r, rho, qe, dt, reg}};
  cudaStream_t s = (cudaStream_t)stream;
  switch (m) {
    case 2: return launch<2>(in, out, P, s);
    case 4: return launch<4>(in, out, P, s);
    case 8: return launch<8>(in, out, P, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
