// The iLQR sweep's steps with one thread per scenario, for the per-sweep
// kernels of csrc/sweep.cu (unified, backward and forward), as
// `_backward_step`, `_forward_step` and `_dyn_step` of
// openmp_parallel_computing_tpu/models/mpc/sweep_pallas.py are for the TPU
// kernels. Each function works on one scenario held by the calling thread.
// csrc/multi_sweep.cu and csrc/full_solve.cu run the same recursion on a
// thread group per scenario (csrc/sweep_group.cuh); the two designs share
// csrc/sweep_common.cuh (weights, step sizes, dynamics).
//
// Layout of every array: the scenario index b is the fastest axis, so a
// warp's 32 threads touch 32 consecutive floats. Element [t][i] of a
// (T, R, B) array for scenario b is at ((t * R) + i) * B + b (`lane`).
// The state axis is in split order [x_0..x_{m-1}, y_0..y_{m-1}], so the
// IBVS state Jacobian is four diagonal m x m blocks (A, Bc, C, D).
#pragma once

#include "sweep_common.cuh"

namespace sweep {

constexpr int kThreads = 32;  // small blocks: a batch of 4096 spans all SMs

__device__ __forceinline__ size_t lane(int t, int i, int R, size_t B, int b) {
  return ((size_t)t * R + i) * B + b;
}

// Row t of a (T, R, B) array into registers.
template <int R>
__device__ __forceinline__ void load_row(const float* arr, int t, size_t B,
                                         int b, float* out) {
#pragma unroll
  for (int i = 0; i < R; ++i) out[i] = arr[lane(t, i, R, B, b)];
}

template <int R>
__device__ __forceinline__ void store_row(float* arr, int t, size_t B, int b,
                                          const float* in) {
#pragma unroll
  for (int i = 0; i < R; ++i) arr[lane(t, i, R, B, b)] = in[i];
}

// Terminal expansion: Vx = 2q (p_H - target) + qe g_H, Vxx = 2q I.
template <int M>
__device__ __forceinline__ void riccati_terminal(const float* pterm,
                                                 const float* gterm,
                                                 const float* tgt,
                                                 const Weights& W, float* Vx,
                                                 float* Vxx) {
  constexpr int N = 2 * M;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    Vx[i] = 2.0f * W.q * (pterm[i] - tgt[i]) + W.qe * gterm[i];
#pragma unroll
    for (int k = 0; k < N; ++k) Vxx[i * N + k] = (i == k) ? 2.0f * W.q : 0.0f;
  }
}

// One Riccati backward step at (p, u) with the ADMM pair (z, y) and the edge
// linearization g: the closed-form IBVS Jacobians, the expansion of
// tracking + effort + ADMM augmentation + linearized edge term, Quu +
// (2r + rho + reg) I, a 6 x 6 column Cholesky solve for the gains k (C) and
// K (C x N), then the value update in place: Vx' = Qx + Qux^T k,
// Vxx' = 2q I + fx^T (Vxx fx) + Qux^T K. Vxx is not symmetrized.
template <int M>
__device__ __forceinline__ void riccati_step(
    const float* p, const float* u, const float* zt, const float* yt,
    const float* gt, const float* tgt, const float* iz, const Weights& W,
    float* Vx, float* Vxx, float* kff, float (*K)[2 * M]) {
  constexpr int N = 2 * M;
  const float q = W.q, r = W.r, rho = W.rho, qe = W.qe, dt = W.dt;
  float Af[M], Bf[M], Cf[M], Df[M], fu[N][C];
  const float vz = u[2], wx = u[3], wy = u[4], wz = u[5];
#pragma unroll
  for (int j = 0; j < M; ++j) {
    const float x = p[j], y = p[M + j];
    Af[j] = 1.0f + dt * (vz * iz[j] + y * wx - 2.0f * x * wy);
    Bf[j] = dt * (x * wx + wz);
    Cf[j] = dt * (-y * wy - wz);
    Df[j] = 1.0f + dt * (vz * iz[j] + 2.0f * y * wx - x * wy);
    fu[j][0] = dt * -iz[j];   fu[M + j][0] = 0.0f;
    fu[j][1] = 0.0f;          fu[M + j][1] = dt * -iz[j];
    fu[j][2] = dt * (x * iz[j]);          fu[M + j][2] = dt * (y * iz[j]);
    fu[j][3] = dt * (x * y);              fu[M + j][3] = dt * (1.0f + y * y);
    fu[j][4] = dt * -(1.0f + x * x);      fu[M + j][4] = dt * -(x * y);
    fu[j][5] = dt * y;                    fu[M + j][5] = dt * -x;
  }
  // Qx = lx + fx^T Vx, Qu = lu + fu^T Vx
  float Qx[N], Qu[C];
#pragma unroll
  for (int j = 0; j < M; ++j) {
    const float lxa = 2.0f * q * (p[j] - tgt[j]) + qe * gt[j];
    const float lxb = 2.0f * q * (p[M + j] - tgt[M + j]) + qe * gt[M + j];
    Qx[j] = lxa + (Af[j] * Vx[j] + Cf[j] * Vx[M + j]);
    Qx[M + j] = lxb + (Bf[j] * Vx[j] + Df[j] * Vx[M + j]);
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float lu = 2.0f * r * u[c] + rho * (u[c] - zt[c] + yt[c]);
    float s = fu[0][c] * Vx[0];
#pragma unroll
    for (int i = 1; i < N; ++i) s += fu[i][c] * Vx[i];
    Qu[c] = lu + s;
  }
  // U = fu^T Vxx (C x N); Quu = (2r + rho + reg) I + U fu; Qux = U fx.
  float U[C][N], Quu[C][C], Qux[C][N];
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float s = fu[0][c] * Vxx[k];
#pragma unroll
      for (int i = 1; i < N; ++i) s += fu[i][c] * Vxx[i * N + k];
      U[c][k] = s;
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int d = 0; d < C; ++d) {
      float s = U[c][0] * fu[0][d];
#pragma unroll
      for (int k = 1; k < N; ++k) s += U[c][k] * fu[k][d];
      Quu[c][d] = (c == d ? 2.0f * r + rho + W.reg : 0.0f) + s;
    }
#pragma unroll
    for (int j = 0; j < M; ++j) {
      Qux[c][j] = U[c][j] * Af[j] + U[c][M + j] * Cf[j];
      Qux[c][M + j] = U[c][j] * Bf[j] + U[c][M + j] * Df[j];
    }
  }
  // Column Cholesky of Quu (lower triangle read column by column):
  // L[i][j] = cols[j][i] for i >= j, with cached 1 / d_j.
  float L[C][C], inv_d[C];
#pragma unroll
  for (int j = 0; j < C; ++j) {
#pragma unroll
    for (int i = j; i < C; ++i) {
      float s = Quu[i][j];
#pragma unroll
      for (int pp = 0; pp < j; ++pp) s -= L[pp][i] * L[pp][j];
      L[j][i] = s;
    }
    const float rr = 1.0f / sqrtf(L[j][j]);
#pragma unroll
    for (int i = j; i < C; ++i) L[j][i] *= rr;
    inv_d[j] = rr;
  }
  // Solve Quu X = [Qu | Qux] one right-hand column at a time; the gains
  // are -X: k = -X[:, 0], K = -X[:, 1:].
#pragma unroll
  for (int col = 0; col <= N; ++col) {
    float Y[C], X[C];
#pragma unroll
    for (int i = 0; i < C; ++i) {
      float s = col == 0 ? Qu[i] : Qux[i][col - 1];
#pragma unroll
      for (int pp = 0; pp < i; ++pp) s -= L[pp][i] * Y[pp];
      Y[i] = s * inv_d[i];
    }
#pragma unroll
    for (int i = C - 1; i >= 0; --i) {
      float s = Y[i];
#pragma unroll
      for (int pp = i + 1; pp < C; ++pp) s -= L[i][pp] * X[pp];
      X[i] = s * inv_d[i];
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (col == 0) kff[c] = -X[c]; else K[c][col - 1] = -X[c];
    }
  }
  // Vx' = Qx + Qux^T k;  Vxx' = 2q I + fx^T (Vxx fx) + Qux^T K.
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = Qux[0][i] * kff[0];
#pragma unroll
    for (int c = 1; c < C; ++c) s += Qux[c][i] * kff[c];
    Vx[i] = Qx[i] + s;
  }
  float T[N * N];                       // Vxx fx
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const float vl = Vxx[i * N + j], vr = Vxx[i * N + M + j];
      T[i * N + j] = vl * Af[j] + vr * Cf[j];
      T[i * N + M + j] = vl * Bf[j] + vr * Df[j];
    }
  }
#pragma unroll
  for (int j = 0; j < M; ++j) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float tt = T[j * N + k], tb = T[(M + j) * N + k];
      float top = Af[j] * tt + Cf[j] * tb;
      float bot = Bf[j] * tt + Df[j] * tb;
      if (k == j) top += 2.0f * q;
      if (k == M + j) bot += 2.0f * q;
      float st = Qux[0][j] * K[0][k], sb = Qux[0][M + j] * K[0][k];
#pragma unroll
      for (int c = 1; c < C; ++c) {
        st += Qux[c][j] * K[c][k];
        sb += Qux[c][M + j] * K[c][k];
      }
      Vxx[j * N + k] = top + st;
      Vxx[(M + j) * N + k] = bot + sb;
    }
  }
}

// The backward pass of one sweep over tau = H-1 .. 0 about the nominal
// (ps (H+1, N, B), us (H, C, B)), writing the gains K (H, C, N, B) and
// k (H, C, B).
template <int M>
__device__ __forceinline__ void backward_pass(
    const float* ps, const float* us, const float* zg, const float* yg,
    const float* g, const float* tgt, const float* iz, const Weights& W,
    int H, size_t B, int b, float* Kg, float* kg) {
  constexpr int N = 2 * M;
  float Vx[N], Vxx[N * N];
  {
    float pterm[N], gterm[N];
    load_row<N>(ps, H, B, b, pterm);
    load_row<N>(g, H, B, b, gterm);
    riccati_terminal<M>(pterm, gterm, tgt, W, Vx, Vxx);
  }
  for (int tau = H - 1; tau >= 0; --tau) {
    float p[N], u[C], zt[C], yt[C], gt[N], kff[C], K[C][N];
    load_row<N>(ps, tau, B, b, p);
    load_row<C>(us, tau, B, b, u);
    load_row<C>(zg, tau, B, b, zt);
    load_row<C>(yg, tau, B, b, yt);
    load_row<N>(g, tau, B, b, gt);
    riccati_step<M>(p, u, zt, yt, gt, tgt, iz, W, Vx, Vxx, kff, K);
    store_row<C>(kg, tau, B, b, kff);
#pragma unroll
    for (int c = 0; c < C; ++c) store_row<N>(Kg, tau * C + c, B, b, K[c]);
  }
}

// One candidate's forward step: u = u_nom + alpha k + K (p - p_nom) with K
// row c at Kt[c * N * ks + j * ks], the stage cost (tracking, effort, ADMM
// augmentation, linearized edge term), and the next state. Writes ua and
// nxt; returns the stage cost.
template <int M>
__device__ __forceinline__ float cand_step(
    float alpha, const float* pa, const float* pn, const float* un,
    const float* kt, const float* Kt, size_t ks, const float* zt,
    const float* yt, const float* gt, const float* tgt, const float* iz,
    const Weights& W, float* ua, float* nxt) {
  constexpr int N = 2 * M;
  float dp[N];
#pragma unroll
  for (int i = 0; i < N; ++i) dp[i] = pa[i] - pn[i];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float* Kc = Kt + (size_t)c * N * ks;
    float s = Kc[0] * dp[0];
#pragma unroll
    for (int j = 1; j < N; ++j) s += Kc[(size_t)j * ks] * dp[j];
    ua[c] = (un[c] + alpha * kt[c]) + s;
  }
  float tr = 0.0f, ed = 0.0f, ef = 0.0f, ad = 0.0f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float e = pa[i] - tgt[i];
    tr += e * e;
    ed += gt[i] * dp[i];
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float w = ua[c] - zt[c] + yt[c];
    ef += ua[c] * ua[c];
    ad += w * w;
  }
  dyn_step<M>(pa, ua, iz, W.dt, nxt);
  return W.q * tr + W.r * ef + 0.5f * W.rho * ad + W.qe * ed;
}

// The terminal tracking + linearized edge terms added to a candidate's
// cost: (J + q |p_H - target|^2) + qe g_H . (p_H - pterm).
template <int M>
__device__ __forceinline__ float add_terminal(float J, const float* pa,
                                              const float* pterm,
                                              const float* gterm,
                                              const float* tgt,
                                              const Weights& W) {
  float tr = 0.0f, ed = 0.0f;
#pragma unroll
  for (int i = 0; i < 2 * M; ++i) {
    const float e = pa[i] - tgt[i];
    tr += e * e;
    ed += gterm[i] * (pa[i] - pterm[i]);
  }
  return J + W.q * tr + W.qe * ed;
}

}  // namespace sweep
