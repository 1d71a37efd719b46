// What both designs of the iLQR sweep share: the control and candidate
// counts, the cost weights, the line-search step sizes and the clipped Euler
// step of the IBVS dynamics. csrc/sweep_steps.cuh (one thread per scenario,
// the forward kernel of csrc/sweep.cu) and csrc/sweep_group.cuh (a thread
// group per scenario: csrc/multi_sweep.cu, csrc/full_solve.cu and the
// unified and backward kernels of csrc/sweep.cu) include it, so the
// dynamics have one source.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace sweep {

constexpr int C = 6;          // control dimension
constexpr int A = 4;          // line-search candidates

struct Weights {
  float q, r, rho, qe, dt, reg;
};

// Line-search step sizes, ALPHAS = (0, 1, 0.5, 0.25).
__device__ __forceinline__ float alpha_of(int a) {
  return a == 0 ? 0.0f : a == 1 ? 1.0f : a == 2 ? 0.5f : 0.25f;
}

// clamp(v, -4, 4) keeping a NaN, as torch.clamp and jnp.clip do (fmaxf
// would turn it into the bound).
__device__ __forceinline__ float clip_state(float v) {
  return v < -4.0f ? -4.0f : (v > 4.0f ? 4.0f : v);
}

// One feature (x, y) of the clipped Euler step p' = clip(p + dt L(p) u, +-4)
// with inverse depth iz.
__device__ __forceinline__ void dyn_feature(float x, float y, const float* u,
                                            float iz, float dt, float& nx,
                                            float& ny) {
  const float vx = u[0], vy = u[1], vz = u[2];
  const float wx = u[3], wy = u[4], wz = u[5];
  const float xdot = -vx * iz + x * vz * iz + x * y * wx -
                     (1.0f + x * x) * wy + y * wz;
  const float ydot = -vy * iz + y * vz * iz + (1.0f + y * y) * wx -
                     x * y * wy - x * wz;
  nx = clip_state(x + dt * xdot);
  ny = clip_state(y + dt * ydot);
}

// The whole split-layout step: p (n = 2M) -> out.
template <int M>
__device__ __forceinline__ void dyn_step(const float* p, const float* u,
                                         const float* iz, float dt,
                                         float* out) {
#pragma unroll
  for (int j = 0; j < M; ++j)
    dyn_feature(p[j], p[M + j], u, iz[j], dt, out[j], out[M + j]);
}

}  // namespace sweep
