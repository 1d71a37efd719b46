// All iLQR sweeps of one ADMM iteration, one thread per scenario.
//
// Replaces the TPU kernel `_multi_sweep_kernel` of
// openmp_parallel_computing_tpu/models/mpc/sweep_pallas.py (called through
// `multi_sweep`) and its helpers `_backward_step`, `_spd_solve_lanes`
// (riccati_pallas.py), `_forward_cand_step`, `_terminal_cost_accum`,
// `_select_winner` and `_dyn_step`. Per sweep, per scenario:
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

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int C = 6;          // control dimension
constexpr int A = 4;          // line-search candidates
constexpr int kThreads = 32;

struct Params {
  int H, B, sweeps;
  float q, r, rho, qe, dt, reg;
};

__device__ __forceinline__ float alpha_of(int a) {
  return a == 0 ? 0.0f : a == 1 ? 1.0f : a == 2 ? 0.5f : 0.25f;
}

// Split-layout clipped Euler step p' = clip(p + dt L(p) u, +-4).
template <int M>
__device__ __forceinline__ void dyn_step(const float* p, const float* u,
                                         const float* iz, float dt,
                                         float* out) {
  const float vx = u[0], vy = u[1], vz = u[2];
  const float wx = u[3], wy = u[4], wz = u[5];
#pragma unroll
  for (int j = 0; j < M; ++j) {
    const float x = p[j], y = p[M + j];
    const float xdot = -vx * iz[j] + x * vz * iz[j] + x * y * wx -
                       (1.0f + x * x) * wy + y * wz;
    const float ydot = -vy * iz[j] + y * vz * iz[j] + (1.0f + y * y) * wx -
                       x * y * wy - x * wz;
    out[j] = fminf(fmaxf(x + dt * xdot, -4.0f), 4.0f);
    out[M + j] = fminf(fmaxf(y + dt * ydot, -4.0f), 4.0f);
  }
}

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
  const float q = P.q, r = P.r, rho = P.rho, qe = P.qe, dt = P.dt;
  // Element [t][i] of a (T, R, B) array, for this thread's scenario.
#define AT(arr, t, i, R) (arr)[((size_t)(t) * (R) + (i)) * B + b]

  float p0[N], tgt[N], iz[M];
#pragma unroll
  for (int i = 0; i < N; ++i) { p0[i] = AT(p0g, 0, i, N); tgt[i] = AT(tg, 0, i, N); }
#pragma unroll
  for (int j = 0; j < M; ++j) iz[j] = AT(izg, 0, j, M);

  // The outputs double as the nominal trajectory across sweeps.
  for (int t = 0; t <= H; ++t)
#pragma unroll
    for (int i = 0; i < N; ++i) AT(ps_out, t, i, N) = AT(ps, t, i, N);
  for (int t = 0; t < H; ++t)
#pragma unroll
    for (int c = 0; c < C; ++c) AT(us_out, t, c, C) = AT(us, t, c, C);

  for (int sweep = 0; sweep < P.sweeps; ++sweep) {
    // ---- backward -------------------------------------------------------
    float Vx[N], Vxx[N * N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      Vx[i] = 2.0f * q * (AT(ps_out, H, i, N) - tgt[i]) + qe * AT(g, H, i, N);
#pragma unroll
      for (int k = 0; k < N; ++k) Vxx[i * N + k] = (i == k) ? 2.0f * q : 0.0f;
    }
    for (int tau = H - 1; tau >= 0; --tau) {
      float p[N], u[C], Af[M], Bf[M], Cf[M], Df[M], fu[N][C];
#pragma unroll
      for (int i = 0; i < N; ++i) p[i] = AT(ps_out, tau, i, N);
#pragma unroll
      for (int c = 0; c < C; ++c) u[c] = AT(us_out, tau, c, C);
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
        const float lxa = 2.0f * q * (p[j] - tgt[j]) + qe * AT(g, tau, j, N);
        const float lxb = 2.0f * q * (p[M + j] - tgt[M + j]) + qe * AT(g, tau, M + j, N);
        Qx[j] = lxa + (Af[j] * Vx[j] + Cf[j] * Vx[M + j]);
        Qx[M + j] = lxb + (Bf[j] * Vx[j] + Df[j] * Vx[M + j]);
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float lu = 2.0f * r * u[c] +
                         rho * (u[c] - AT(zg, tau, c, C) + AT(yg, tau, c, C));
        float s = fu[0][c] * Vx[0];
#pragma unroll
        for (int i = 1; i < N; ++i) s += fu[i][c] * Vx[i];
        Qu[c] = lu + s;
      }
      // U = fu^T Vxx (C x N); Quu = (2r + rho + reg) I + U fu;
      // Qux = U fx (C x N).
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
          Quu[c][d] = (c == d ? 2.0f * r + rho + P.reg : 0.0f) + s;
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
      // Solve Quu X = [Qu | Qux] one right-hand column at a time; the
      // gains are -X: k = -X[:, 0], K = -X[:, 1:].
      float kff[C], K[C][N];
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
#pragma unroll
      for (int c = 0; c < C; ++c) {
        AT(kg, tau, c, C) = kff[c];
#pragma unroll
        for (int j = 0; j < N; ++j)
          Kg[(((size_t)tau * C + c) * N + j) * B + b] = K[c][j];
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

    // ---- forward: the A candidates -------------------------------------
    float pa[A][N], J[A];
#pragma unroll
    for (int a = 0; a < A; ++a) {
      J[a] = 0.0f;
#pragma unroll
      for (int i = 0; i < N; ++i) pa[a][i] = p0[i];
    }
    for (int tau = 0; tau < H; ++tau) {
      float pn[N], un[C], zt[C], yt[C], gt[N], kt[C];
#pragma unroll
      for (int i = 0; i < N; ++i) { pn[i] = AT(ps_out, tau, i, N); gt[i] = AT(g, tau, i, N); }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        un[c] = AT(us_out, tau, c, C);
        zt[c] = AT(zg, tau, c, C);
        yt[c] = AT(yg, tau, c, C);
        kt[c] = AT(kg, tau, c, C);
      }
#pragma unroll
      for (int a = 0; a < A; ++a) {
        const float alpha = alpha_of(a);
        float dp[N], ua[C], nxt[N];
#pragma unroll
        for (int i = 0; i < N; ++i) dp[i] = pa[a][i] - pn[i];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float* Kc = Kg + ((size_t)tau * C + c) * N * B + b;
          float s = Kc[0] * dp[0];
#pragma unroll
          for (int j = 1; j < N; ++j) s += Kc[(size_t)j * B] * dp[j];
          ua[c] = (un[c] + alpha * kt[c]) + s;
        }
        float tr = 0.0f, ed = 0.0f, ef = 0.0f, ad = 0.0f;
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float e = pa[a][i] - tgt[i];
          tr += e * e;
          ed += gt[i] * dp[i];
        }
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float w = ua[c] - zt[c] + yt[c];
          ef += ua[c] * ua[c];
          ad += w * w;
        }
        J[a] = J[a] + (q * tr + r * ef + 0.5f * rho * ad + qe * ed);
        dyn_step<M>(pa[a], ua, iz, dt, nxt);
#pragma unroll
        for (int i = 0; i < N; ++i) pa[a][i] = nxt[i];
        if (a > 0) {
#pragma unroll
          for (int c = 0; c < C; ++c) AT(uc, (a - 1) * H + tau, c, C) = ua[c];
#pragma unroll
          for (int i = 0; i < N; ++i) AT(pc, (a - 1) * H + tau, i, N) = nxt[i];
        }
      }
    }
    // ---- terminal cost and select --------------------------------------
#pragma unroll
    for (int a = 0; a < A; ++a) {
      float tr = 0.0f, ed = 0.0f;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float e = pa[a][i] - tgt[i];
        tr += e * e;
        ed += AT(g, H, i, N) * (pa[a][i] - AT(ps_out, H, i, N));
      }
      J[a] = J[a] + q * tr + qe * ed;
      if (!isfinite(J[a])) J[a] = INFINITY;
    }
    float jmin = J[0];
#pragma unroll
    for (int a = 1; a < A; ++a) jmin = fminf(jmin, J[a]);
    int win = 0;
#pragma unroll
    for (int a = A - 1; a >= 0; --a)
      if (J[a] == jmin) win = a;                 // first wins
    if (win > 0) {
      for (int t = 0; t < H; ++t) {
#pragma unroll
        for (int i = 0; i < N; ++i)
          AT(ps_out, t + 1, i, N) = AT(pc, (win - 1) * H + t, i, N);
#pragma unroll
        for (int c = 0; c < C; ++c)
          AT(us_out, t, c, C) = AT(uc, (win - 1) * H + t, c, C);
      }
    }
#pragma unroll
    for (int i = 0; i < N; ++i) AT(ps_out, 0, i, N) = p0[i];
  }
#undef AT
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
  const Params P{H, B, sweeps, q, r, rho, qe, dt, reg};
  cudaStream_t s = (cudaStream_t)stream;
  switch (m) {
    case 2: return launch<2>(in, out, P, s);
    case 4: return launch<4>(in, out, P, s);
    case 8: return launch<8>(in, out, P, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
