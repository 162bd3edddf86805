// Per-member bodies of the fused EK1 kernels (ek1_fused.cu): the square-root
// EK1 filter step with the field's Jacobian evaluated in the kernel and the
// loop over one member's time steps that the filter runs (the smoother and
// the sampler spread a member over a group of lanes: ek1_group.cuh). Their
// plain PyTorch versions, in the same order of operations, are in
// odefilters_torch/ops/ek1_fused.py (ek1_step, ek1_filter_states_plain).
//
// The state is flat and derivative-major, N = DIM * NQ entries: entry i is
// derivative i / DIM of dimension i % DIM. The transition A = kron(At, I)
// and the noise factor QLf = kron(QLt, I) are read from the NQ x NQ blocks;
// their structural zeros (At upper and QLt lower triangular, the identity's
// off-diagonal) are known at compile time once the loops are unrolled.
#pragma once

#include "ek0_common.cuh"
#include "ek0_filter.cuh"
#include "ek0_sample.cuh"

namespace ek1 {

using ek0::cho_solve;
using ek0::floor_at;
using ek0::log_;
using ek0::mgs_tril;
using ek0::sqrt_;

// the filter's mode argument: dynamic, fixed or fixedMAP (ek0_common.cuh)
using ek0::DYNAMIC;
using ek0::FIXED;
using ek0::FIXED_MAP;

// Constants of the three kernels: the preconditioned IBM transition At
// (upper triangular) and noise factor QLt (lower triangular), the
// preconditioner entries of blocks 0 and 1, the grid, and qsq[j] =
// QLf[j][j]^2 taken in double and rounded once (the static models' stack
// holds the noise factor as constants, whose squares the plain version's
// Python floats take in double).
template <typename S, int NQ, int DIM>
struct Consts {
  static constexpr int N = NQ * DIM;
  S At[NQ][NQ];
  S QLt[NQ][NQ];
  S pinv0, pinv1, t0, dt;
  S qsq[N];
};

// The nonzero pattern of A = kron(At, I): r and c of one dimension, c's
// derivative block at or after r's.
template <int DIM>
__device__ __forceinline__ constexpr bool a_live(int r, int c) {
  return r % DIM == c % DIM && c / DIM >= r / DIM;
}

// The nonzero pattern of QLf = kron(QLt, I).
template <int DIM>
__device__ __forceinline__ constexpr bool q_live(int r, int c) {
  return r % DIM == c % DIM && r / DIM >= c / DIM;
}

// Row of the filter's stream: mean (N) | L (N*N, row-major) | s2 | the
// lower triangle of Lp, row by row (N(N+1)/2; only when a backward pass
// follows).
template <int N>
struct Layout {
  static constexpr int L = N;
  static constexpr int S2 = N + N * N;
  static constexpr int LP = S2 + 1;
  static constexpr int V_FILTER = S2 + 1;
  static constexpr int V = V_FILTER + N * (N + 1) / 2;
};

// Cholesky factor of the symmetric K x K matrix C: pivots
// sqrt(max(s, 1e-30)), the entries below divided by them.
template <typename S, int K>
__device__ __forceinline__ void chol(const S (&C)[K][K], S (&L)[K][K]) {
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (j > i) {
        L[i][j] = S(0);
        continue;
      }
      S s = C[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) s = s - L[i][k] * L[j][k];
      L[i][j] = i == j ? sqrt_(floor_at(s, S(1e-30))) : s / L[j][j];
    }
}

// X Y^T for two DIM x N blocks.
template <typename S, int DIM, int N>
__device__ __forceinline__ void gram(const S (&Z)[DIM][N],
                                     S (&G)[DIM][DIM]) {
#pragma unroll
  for (int a = 0; a < DIM; ++a)
#pragma unroll
    for (int b = 0; b < DIM; ++b) {
      S acc = S(0);
#pragma unroll
      for (int c = 0; c < N; ++c) acc += Z[a][c] * Z[b][c];
      G[a][b] = acc;
    }
}

// y = A x over A's nonzero entries. K: any constants with the NQ x NQ
// blocks At and QLt (Consts, or the adaptive kernels' ek0::AdaptConsts).
template <typename S, int NQ, int DIM, class K>
__device__ __forceinline__ void a_times_vec(const K& c,
                                            const S (&x)[NQ * DIM],
                                            S (&y)[NQ * DIM]) {
  constexpr int N = NQ * DIM;
#pragma unroll
  for (int r = 0; r < N; ++r) {
    S acc = S(0);
#pragma unroll
    for (int cc = 0; cc < N; ++cc)
      if (a_live<DIM>(r, cc)) acc += c.At[r / DIM][cc / DIM] * x[cc];
    y[r] = acc;
  }
}

// Y = A X over A's nonzero entries.
template <typename S, int NQ, int DIM, class K>
__device__ __forceinline__ void a_times_mat(
    const K& c, const S (&X)[NQ * DIM][NQ * DIM],
    S (&Y)[NQ * DIM][NQ * DIM]) {
  constexpr int N = NQ * DIM;
#pragma unroll
  for (int r = 0; r < N; ++r)
#pragma unroll
    for (int k = 0; k < N; ++k) {
      S acc = S(0);
#pragma unroll
      for (int cc = 0; cc < N; ++cc)
        if (a_live<DIM>(r, cc)) acc += c.At[r / DIM][cc / DIM] * X[cc][k];
      Y[r][k] = acc;
    }
}

// H M for H = (E1 - J E0) P^-1 and an N x N block M given entry by entry:
// out[a][k] = pinv1 M[DIM + a][k] - sum_b J[a][b] (pinv0 M[b][k]).
template <typename S, int NQ, int DIM, class Get>
__device__ __forceinline__ void h_times(S pinv0, S pinv1,
                                        const S (&J)[DIM * DIM], Get M,
                                        S (&out)[DIM][NQ * DIM]) {
  constexpr int N = NQ * DIM;
#pragma unroll
  for (int a = 0; a < DIM; ++a)
#pragma unroll
    for (int k = 0; k < N; ++k) {
      S v = pinv1 * M(DIM + a, k);
#pragma unroll
      for (int b = 0; b < DIM; ++b) v = v - J[a * DIM + b] * (pinv0 * M(b, k));
      out[a][k] = v;
    }
}

// The prediction's 2N x N stack [(A L)^T; (sq QLf)^T], from AL = A L.
template <typename S, int NQ, int DIM, class K>
__device__ __forceinline__ void predict_stack(
    const K& c, const S (&AL)[NQ * DIM][NQ * DIM], S sq,
    S (&v)[2 * NQ * DIM][NQ * DIM]) {
  constexpr int N = NQ * DIM;
#pragma unroll
  for (int k = 0; k < N; ++k)
#pragma unroll
    for (int i = 0; i < N; ++i) {
      v[k][i] = AL[i][k];
      v[N + k][i] = q_live<DIM>(i, k) ? sq * c.QLt[i / DIM][k / DIM] : S(0);
    }
}

// The predicted factor Lp: MGS of predict_stack; qsq (the static models'
// noise squares, ek1_fused.cu) or nullptr; AL_out, when given, receives
// A L.
template <typename S, int NQ, int DIM, class K>
__device__ __forceinline__ void predict_lp(
    const K& c, const S (&L)[NQ * DIM][NQ * DIM], S sq,
    S (&Lp)[NQ * DIM][NQ * DIM], const S* qsq = nullptr,
    S (*AL_out)[NQ * DIM] = nullptr) {
  constexpr int N = NQ * DIM;
  S AL[N][N], v[2 * N][N];
  a_times_mat<S, NQ, DIM>(c, L, AL);
  if (AL_out) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int k = 0; k < N; ++k) AL_out[i][k] = AL[i][k];
  }
  predict_stack<S, NQ, DIM>(c, AL, sq, v);
  mgs_tril<S, N, 2 * N, true>(v, Lp, qsq);
}

// What an adaptive attempt needs of a dynamic step besides the update: the
// diagonal of H Q H^T (its error estimate) and the log-likelihood increment
// log N(z; 0, H Lp Lp^T H^T).
template <typename S, int DIM>
struct StepStats {
  S hqh[DIM];
  S ll_inc;
};

// What the reverse of a dynamic step reads of it (ek1_datalik.cuh:
// step_vjp): the quantities of filter_step, in its order of operations.
template <typename S, int NQ, int DIM>
struct StepRec {
  static constexpr int N = NQ * DIM;
  S mp[N];           // predicted mean
  S u[DIM];          // predicted solution pinv0 mp[0..DIM-1]
  S J[DIM * DIM];    // the field's Jacobian at u
  S z[DIM];          // residual pinv1 mp[DIM + a] - f(u)[a]
  S HQ[DIM][N];      // H QLf
  S Lq[DIM][DIM];    // Cholesky factor of H Q H^T
  S w[DIM];          // (H Q H^T)^-1 z
  S s2, sq;          // diffusion and sqrt(max(s2, 0))
  S AL[N][N];        // A L
  S Lp[N][N];        // predicted factor (upper entries zero)
  S Z[DIM][N];       // H Lp
  S Ls[DIM][DIM];    // Cholesky factor of Z Z^T
  S LpZt[N][DIM];    // Lp Z^T
  S Kg[N][DIM];      // gain rows
  S ws[DIM];         // (Z Z^T)^-1 z
};

// One square-root EK1 step from (m, L), updated in place, with the
// preconditioner entries pinv0, pinv1 of blocks 0 and 1: predict the mean,
// evaluate the field and its Jacobian (at u_lin when given, the IEKS hook;
// the field itself at the predicted mean), calibrate the dynamic diffusion
// s2 = z^T (H Q H^T)^-1 z / DIM (STATIC: the unscaled prior), factor the
// predicted covariance by MGS of [(A L)^T; (sqrt(s2) QLf)^T] into Lp, and
// apply the update L = Lp - K H Lp. Returns s2, or under STATIC the step's
// statistic z^T S^-1 z / DIM. K: Consts (fixed grid), ek0::AdaptConsts
// (the adaptive kernels, which also ask for stats) or ek1dl::DlConsts (the
// data likelihood's, whose adjoint also asks for rec: the step's
// intermediates, so that it reverses the very step the forward ran).
template <typename S, int NQ, class F, bool STATIC, class K>
__device__ __forceinline__ S filter_step(const K& c, S pinv0, S pinv1,
                                         const S* p, S t, const S* u_lin,
                                         S (&m)[NQ * F::D],
                                         S (&L)[NQ * F::D][NQ * F::D],
                                         S (&Lp)[NQ * F::D][NQ * F::D],
                                         StepStats<S, F::D>* stats = nullptr,
                                         StepRec<S, NQ, F::D>* rec = nullptr) {
  constexpr int DIM = F::D;
  constexpr int N = NQ * DIM;
  S mp[N];
  a_times_vec<S, NQ, DIM>(c, m, mp);
  S u[DIM], du[DIM], J[DIM * DIM], z[DIM];
#pragma unroll
  for (int j = 0; j < DIM; ++j) u[j] = pinv0 * mp[j];
  F()(u, p, t, du);
  F().jac(u_lin ? u_lin : u, p, t, J);
#pragma unroll
  for (int a = 0; a < DIM; ++a) z[a] = ek0::innovation(pinv1, mp[DIM + a], du[a]);
  if (rec) {
#pragma unroll
    for (int r = 0; r < N; ++r) rec->mp[r] = mp[r];
#pragma unroll
    for (int a = 0; a < DIM; ++a) {
      rec->u[a] = u[a];
      rec->z[a] = z[a];
    }
#pragma unroll
    for (int a = 0; a < DIM * DIM; ++a) rec->J[a] = J[a];
  }

  S sq = S(1), s2 = S(1);
  if (!STATIC) {
    S HQ[DIM][N], Sq[DIM][DIM], Lq[DIM][DIM], w[DIM];
    h_times<S, NQ, DIM>(pinv0, pinv1, J, [&](int r, int k) {
      return q_live<DIM>(r, k) ? c.QLt[r / DIM][k / DIM] : S(0);
    }, HQ);
    gram<S, DIM, N>(HQ, Sq);
    chol<S, DIM>(Sq, Lq);
    cho_solve<S, DIM>(Lq, z, w);
    S zw = S(0);
#pragma unroll
    for (int a = 0; a < DIM; ++a) zw += z[a] * w[a];
    s2 = zw * (S(1) / S(DIM));
    sq = sqrt_(floor_at(s2, S(0)));
    if (stats) {
#pragma unroll
      for (int a = 0; a < DIM; ++a) stats->hqh[a] = Sq[a][a];
    }
    if (rec) {
#pragma unroll
      for (int a = 0; a < DIM; ++a) {
        rec->w[a] = w[a];
#pragma unroll
        for (int b = 0; b < DIM; ++b) rec->Lq[a][b] = Lq[a][b];
#pragma unroll
        for (int k = 0; k < N; ++k) rec->HQ[a][k] = HQ[a][k];
      }
      rec->s2 = s2;
      rec->sq = sq;
    }
  }

  const S* qsq = nullptr;
  if constexpr (STATIC) qsq = c.qsq;
  predict_lp<S, NQ, DIM>(c, L, sq, Lp, qsq, rec ? rec->AL : nullptr);

  S Z[DIM][N], Sm[DIM][DIM], Ls[DIM][DIM];
  h_times<S, NQ, DIM>(pinv0, pinv1, J, [&](int r, int k) { return Lp[r][k]; },
                      Z);
  gram<S, DIM, N>(Z, Sm);
  chol<S, DIM>(Sm, Ls);
#pragma unroll
  for (int r = 0; r < N; ++r) {
    S lz[DIM], kg[DIM];
#pragma unroll
    for (int a = 0; a < DIM; ++a) {
      S acc = S(0);
#pragma unroll
      for (int k = 0; k < N; ++k) acc += Lp[r][k] * Z[a][k];
      lz[a] = acc;
    }
    cho_solve<S, DIM>(Ls, lz, kg);
    if (rec) {
#pragma unroll
      for (int a = 0; a < DIM; ++a) {
        rec->LpZt[r][a] = lz[a];
        rec->Kg[r][a] = kg[a];
      }
#pragma unroll
      for (int k = 0; k < N; ++k) rec->Lp[r][k] = Lp[r][k];
    }
    S km = S(0);
#pragma unroll
    for (int a = 0; a < DIM; ++a) km += kg[a] * z[a];
    m[r] = mp[r] - km;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      S kz = S(0);
#pragma unroll
      for (int a = 0; a < DIM; ++a) kz += kg[a] * Z[a][k];
      L[r][k] = Lp[r][k] - kz;
    }
  }
  if (!STATIC && !stats && !rec) return s2;
  S ws[DIM];
  cho_solve<S, DIM>(Ls, z, ws);
  if (rec) {
#pragma unroll
    for (int a = 0; a < DIM; ++a) {
      rec->ws[a] = ws[a];
#pragma unroll
      for (int b = 0; b < DIM; ++b) rec->Ls[a][b] = Ls[a][b];
#pragma unroll
      for (int k = 0; k < N; ++k) rec->Z[a][k] = Z[a][k];
    }
  }
  if (!STATIC && !stats) return s2;
  S zs = S(0);
#pragma unroll
  for (int a = 0; a < DIM; ++a) zs += z[a] * ws[a];
  if (STATIC) return zs * (S(1) / S(DIM));
  // log N(z; 0, Ls Ls^T)
  S logdet = S(0);
#pragma unroll
  for (int a = 0; a < DIM; ++a) logdet += log_(floor_at(Ls[a][a], S(1e-30)));
  stats->ll_inc =
      S(-0.5) * (zs + S(2) * logdet + S(double(DIM) * ek0::LOG_2PI));
  return s2;
}

template <typename S, int N>
__device__ __forceinline__ void store_row(S* __restrict__ st, size_t row0,
                                          size_t sB, const S (&m)[N],
                                          const S (&L)[N][N], S s2,
                                          const S (&Lp)[N][N], bool smooth) {
#pragma unroll
  for (int r = 0; r < N; ++r) st[row0 + r * sB] = m[r];
#pragma unroll
  for (int r = 0; r < N; ++r)
#pragma unroll
    for (int k = 0; k < N; ++k) st[row0 + (Layout<N>::L + r * N + k) * sB] = L[r][k];
  st[row0 + Layout<N>::S2 * sB] = s2;
  if (!smooth) return;
  int v = Layout<N>::LP;
#pragma unroll
  for (int r = 0; r < N; ++r)
#pragma unroll
    for (int k = 0; k <= r; ++k) st[row0 + (v++) * sB] = Lp[r][k];
}

// The filter over one member's T steps: row 0 is the exact initial state
// (L = 0, s2 = 1, Lp = 0), row k+1 the state after step k, its s2 and its
// Lp. lin (T+1, DIM, B), when given, linearizes step k at row k+1. Under
// STATIC, mode (FIXED or FIXED_MAP) picks the running estimate written to
// sig_out[b].
template <typename S, int NQ, class F, bool STATIC>
__device__ __forceinline__ void filter_member(
    const Consts<S, NQ, F::D>& c, const S* __restrict__ m0,
    const S* __restrict__ ps, const S* __restrict__ lin, S* __restrict__ st,
    S* __restrict__ sig_out, int b, int B, int T, int mode, bool smooth) {
  constexpr int DIM = F::D;
  constexpr int N = NQ * DIM;
  const size_t sB = (size_t)B;
  const size_t V = smooth ? Layout<N>::V : Layout<N>::V_FILTER;
  S p[F::NP], m[N], L[N][N], Lp[N][N];
#pragma unroll
  for (int k = 0; k < F::NP; ++k) p[k] = ps[k * sB + b];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    m[i] = m0[i * sB + b];
#pragma unroll
    for (int k = 0; k < N; ++k) L[i][k] = Lp[i][k] = S(0);
  }
  store_row<S, N>(st, b, sB, m, L, S(1), Lp, smooth);
  S sig = S(0), kf = S(0);
  for (int k = 0; k < T; ++k) {
    // t_{k+1} in the working dtype, never accumulated
    const S t = c.t0 + c.dt * S(k + 1);
    S u_lin[DIM];
    if (lin) {
#pragma unroll
      for (int j = 0; j < DIM; ++j)
        u_lin[j] = lin[((size_t)(k + 1) * DIM + j) * sB + b];
    }
    S s2 = filter_step<S, NQ, F, STATIC>(c, c.pinv0, c.pinv1, p, t,
                                         lin ? u_lin : nullptr, m, L, Lp);
    if (STATIC) {
      if (mode == FIXED)
        ek0::static_scalar_update<FIXED, S, DIM>(sig, kf, s2);
      else
        ek0::static_scalar_update<FIXED_MAP, S, DIM>(sig, kf, s2);
      kf = kf + S(1);
      s2 = S(1);
    }
    store_row<S, N>(st, (size_t)(k + 1) * V * sB + b, sB, m, L, s2, Lp,
                    smooth);
  }
  if (STATIC) sig_out[b] = sig;
}

}  // namespace ek1
