// Per-member bodies of the dense EK1 data-likelihood kernels
// (ek1_datalik.cu): the joint noisy data update in Joseph
// square-root form and the hand-written reverses of it and of the EK1 step
// (ek1_fused.cuh: filter_step, which records what the reverse reads), with
// the reverses of their modified Gram-Schmidt (MGS) QRs, Cholesky factors
// and Cholesky solves. Their plain PyTorch versions, in the same order of
// operations, are in odefilters_torch/ops/ek1_datalik.py (ek1_data_update,
// mgs_tril_vjp) and ek1_fused.py (ek1_step).
//
// The state is flat and derivative-major, N = DIM * NQ entries, with its
// N x N factor L. The observation model is padded to DOBS_MAX rows: rows
// a >= n have C = 0, R = 0 and R R^T = I, so that every loop has a
// compile-time length. The padded rows add exact zeros after the live
// terms of every sum (and a Cholesky block [S 0; 0 I]), so the live
// values are those of the plain version, which has no padded rows.
#pragma once

#include "ek0_datalik_pd.cuh"
#include "ek1_fused.cuh"

namespace ek1dl {

using ek0::cho_solve;
using ek0::floor_at;
using ek0::log_;
using ek0::LOG_2PI;
using ek0::mgs_tril;
using ek0::sqrt_;
using ek0::stack_zero;
using ek0pd::DOBS_MAX;
using ek1::a_live;
using ek1::q_live;
constexpr int DM = DOBS_MAX;

// Constants of the three kernels: the preconditioned IBM transition At
// (upper triangular) and noise factor QLt (lower triangular), the
// preconditioner entries of blocks 0 and 1, and the observation model: n
// observed rows of C (DM x DIM), the lower noise factor R and R R^T (formed
// in the working type on the host, as the plain version forms it), and
// l2pi = n log(2 pi), folded in double.
template <typename S, int NQ, int DIM>
struct DlConsts {
  S At[NQ][NQ];
  S QLt[NQ][NQ];
  S pinv0, pinv1;
  int n;
  S C[DM][DIM];
  S R[DM][DM];
  S RRT[DM][DM];
  S l2pi;
};

// Row of the stream: the mean (N), then L row by row (N * N).
template <int N>
struct Layout {
  static constexpr int V = N + N * N;
};

template <typename S, int N>
__device__ __forceinline__ void store_state(S* __restrict__ st, size_t row0,
                                            size_t sB, const S (&m)[N],
                                            const S (&L)[N][N]) {
#pragma unroll
  for (int r = 0; r < N; ++r) st[row0 + r * sB] = m[r];
#pragma unroll
  for (int r = 0; r < N; ++r)
#pragma unroll
    for (int c = 0; c < N; ++c) st[row0 + (N + r * N + c) * sB] = L[r][c];
}

template <typename S, int N>
__device__ __forceinline__ void load_state(const S* __restrict__ st,
                                           size_t row0, size_t sB,
                                           S (&m)[N], S (&L)[N][N]) {
#pragma unroll
  for (int r = 0; r < N; ++r) m[r] = st[row0 + r * sB];
#pragma unroll
  for (int r = 0; r < N; ++r)
#pragma unroll
    for (int c = 0; c < N; ++c) L[r][c] = st[row0 + (N + r * N + c) * sB];
}

// ---------------------------------------------------------------------------
// The data update
// ---------------------------------------------------------------------------

// What the data update's reverse reads of its forward.
template <typename S, int N>
struct UpdRec {
  S z[DM];        // residual y - C P0 m
  S Z[DM][N];     // C P0 L
  S Ls[DM][DM];   // Cholesky factor of Z Z^T + R R^T
  S w[DM];        // S^-1 z
  S Kg[N][DM];    // gain rows (L Z^T)[r] S^-1
  S LZt[N][DM];   // L Z^T
};

// Z Z^T + R R^T (both triangles).
template <typename S, int N>
__device__ __forceinline__ void innov_cov(const S (&Z)[DM][N],
                                          const S (&RRT)[DM][DM],
                                          S (&Sm)[DM][DM]) {
#pragma unroll
  for (int a = 0; a < DM; ++a)
#pragma unroll
    for (int b = 0; b < DM; ++b) {
      S acc = S(0);
#pragma unroll
      for (int c = 0; c < N; ++c) acc += Z[a][c] * Z[b][c];
      Sm[a][b] = acc + RRT[a][b];
    }
}

// The stack [L - K Z | K R]^T, (N + DM) x N: row k < N is column k of
// L - K Z, row N + a column a of K R (zero for a >= n).
template <typename S, int NQ, int DIM>
__device__ __forceinline__ void update_stack(
    const DlConsts<S, NQ, DIM>& c, const S (&L)[NQ * DIM][NQ * DIM],
    const UpdRec<S, NQ * DIM>& u, S (&v)[NQ * DIM + DM][NQ * DIM]) {
  constexpr int N = NQ * DIM;
#pragma unroll
  for (int r = 0; r < N; ++r) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      S kz = u.Kg[r][0] * u.Z[0][k];
#pragma unroll
      for (int a = 1; a < DM; ++a) kz += u.Kg[r][a] * u.Z[a][k];
      v[k][r] = L[r][k] - kz;
    }
#pragma unroll
    for (int a = 0; a < DM; ++a) {
      S acc = S(0);
#pragma unroll
      for (int b = 0; b < DM; ++b)
        if (c.R[b][a] != S(0)) acc += u.Kg[r][b] * c.R[b][a];
      v[N + a][r] = acc;
    }
  }
}

// The joint noisy update of (m, L) in place on the observations y (DM
// entries, zero past n), recording what the reverse reads in u: residual,
// C P0 L, the innovation covariance's Cholesky factor, the gain, and the new
// factor by MGS of update_stack. Returns the data log-likelihood increment
// log N(y; C P0 m, Z Z^T + R R^T) (ek1_datalik.py: ek1_data_update).
template <typename S, int NQ, int DIM>
__device__ __forceinline__ S data_update(const DlConsts<S, NQ, DIM>& c,
                                         const S (&y)[DM],
                                         S (&m)[NQ * DIM],
                                         S (&L)[NQ * DIM][NQ * DIM],
                                         UpdRec<S, NQ * DIM>& u) {
  constexpr int N = NQ * DIM;
#pragma unroll
  for (int a = 0; a < DM; ++a) {
    S yhat = S(0);
#pragma unroll
    for (int j = 0; j < DIM; ++j)
      if (c.C[a][j] != S(0)) yhat += c.C[a][j] * (c.pinv0 * m[j]);
    u.z[a] = y[a] - yhat;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      S acc = S(0);
#pragma unroll
      for (int j = 0; j < DIM; ++j)
        if (c.C[a][j] != S(0)) acc += c.C[a][j] * (c.pinv0 * L[j][k]);
      u.Z[a][k] = acc;
    }
  }
  S Sm[DM][DM];
  innov_cov<S, N>(u.Z, c.RRT, Sm);
  ek1::chol<S, DM>(Sm, u.Ls);
  cho_solve<S, DM>(u.Ls, u.z, u.w);
  S zSz = S(0), logdet = S(0);
#pragma unroll
  for (int a = 0; a < DM; ++a) {
    zSz += u.z[a] * u.w[a];
    if (a < c.n) logdet += S(2) * log_(floor_at(u.Ls[a][a], S(1e-30)));
  }
#pragma unroll
  for (int r = 0; r < N; ++r) {
#pragma unroll
    for (int a = 0; a < DM; ++a) {
      S acc = S(0);
#pragma unroll
      for (int k = 0; k < N; ++k) acc += L[r][k] * u.Z[a][k];
      u.LZt[r][a] = acc;
    }
    cho_solve<S, DM>(u.Ls, u.LZt[r], u.Kg[r]);
    S km = u.Kg[r][0] * u.z[0];
#pragma unroll
    for (int a = 1; a < DM; ++a) km += u.Kg[r][a] * u.z[a];
    m[r] = m[r] + km;
  }
  S v[N + DM][N];
  update_stack<S, NQ, DIM>(c, L, u, v);
  mgs_tril<S, N, N + DM, false>(v, L);
  return S(-0.5) * (zSz + logdet + c.l2pi);
}

// ---------------------------------------------------------------------------
// Reverses of the small factorizations
// ---------------------------------------------------------------------------

// Reverse of ek1::chol on C (its lower triangle read): gL (cotangent of the
// factor L, consumed) adds the cotangent of C's lower triangle to gC. Each
// entry's s is recomputed from C in the forward's order (the pivot's clamp
// at 1e-30 passes no cotangent below it, as torch.clamp's).
template <typename S, int K>
__device__ __forceinline__ void chol_vjp(const S (&C)[K][K],
                                         const S (&L)[K][K], S (&gL)[K][K],
                                         S (&gC)[K][K]) {
#pragma unroll
  for (int i = K - 1; i >= 0; --i)
#pragma unroll
    for (int j = i; j >= 0; --j) {
      S gs;
      if (i == j) {
        S s = C[i][i];
#pragma unroll
        for (int k = 0; k < i; ++k) s = s - L[i][k] * L[i][k];
        gs = s >= S(1e-30) ? gL[i][i] / (S(2) * L[i][i]) : S(0);
      } else {
        gs = gL[i][j] / L[j][j];
        gL[j][j] -= gL[i][j] * L[i][j] / L[j][j];
      }
      gC[i][j] += gs;
#pragma unroll
      for (int k = 0; k < j; ++k) {
        gL[i][k] -= gs * L[j][k];
        gL[j][k] -= gs * L[i][k];
      }
    }
}

// Reverse of ek0::cho_solve(L, b) -> x: from gx (consumed), adds the
// cotangents of b to gb and of L to gL; the forward substitution's y is
// recomputed.
template <typename S, int K>
__device__ __forceinline__ void cho_solve_vjp(const S (&L)[K][K],
                                              const S (&b)[K],
                                              const S (&x)[K], S (&gx)[K],
                                              S (&gb)[K], S (&gL)[K][K]) {
  S y[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    S s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
  S gy[K];
#pragma unroll
  for (int i = 0; i < K; ++i) gy[i] = S(0);
  // x[i] = (y[i] - sum_{k > i} L[k][i] x[k]) / L[i][i], i from K-1 down
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const S gs = gx[i] / L[i][i];
    gL[i][i] -= gx[i] * x[i] / L[i][i];
    gy[i] += gs;
#pragma unroll
    for (int k = i + 1; k < K; ++k) {
      gL[k][i] -= gs * x[k];
      gx[k] -= gs * L[k][i];
    }
  }
  // y[i] = (b[i] - sum_{k < i} L[i][k] y[k]) / L[i][i]
#pragma unroll
  for (int i = K - 1; i >= 0; --i) {
    const S gs = gy[i] / L[i][i];
    gL[i][i] -= gy[i] * y[i] / L[i][i];
    gb[i] += gs;
#pragma unroll
    for (int k = 0; k < i; ++k) {
      gL[i][k] -= gs * y[k];
      gy[k] -= gs * L[i][k];
    }
  }
}

// Reverse of a Gram product G = X X^T (K x N) of which only the lower
// triangle is read: adds to gX.
template <typename S, int K, int N>
__device__ __forceinline__ void gram_vjp(const S (&X)[K][N],
                                         const S (&gG)[K][K],
                                         S (&gX)[K][N]) {
#pragma unroll
  for (int a = 0; a < K; ++a)
#pragma unroll
    for (int b = 0; b <= a; ++b)
#pragma unroll
      for (int c = 0; c < N; ++c) {
        gX[a][c] += gG[a][b] * X[b][c];
        gX[b][c] += gG[a][b] * X[a][c];
      }
}

// Reverse of ek0::mgs_tril<S, N, K, TRI> on the stack v0 (what it read):
// from gL (the lower factor's cotangent; its upper entries unread) writes
// gv, the stack's cotangent (entries of the TRI pattern's structural zeros
// left 0). Column by column from the last: stage j's state is recomputed
// from v0 in the forward's order of operations, then its products, the
// normalisation and the pivot sqrt(max(ss, 1e-30)) are reversed line by
// line (ek1_datalik.py: mgs_tril_vjp). Line by line rather than the closed
// form Q copyltu(R gR^T) R^-T: the data update's stack is singular (an EK1
// step's R = 0 update leaves the factor rank N - DIM). The stage loop is
// not unrolled: the recomputed state lives in local memory.
template <typename S, int N, int K, bool TRI>
__device__ __forceinline__ void mgs_tril_vjp(const S (&v0)[K][N],
                                             const S (&gL)[N][N],
                                             S (&gv)[K][N]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int l = 0; l < N; ++l) gv[k][l] = S(0);
#pragma unroll 1
  for (int j = N - 1; j >= 0; --j) {
    S v[K][N], q[K], gq[K];
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int l = 0; l < N; ++l) v[k][l] = v0[k][l];
    S ss, Rjj, inv;
#pragma unroll 1
    for (int i = 0; i <= j; ++i) {
      ss = S(0);
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (!stack_zero<N, TRI>(k, i)) ss += v[k][i] * v[k][i];
      Rjj = sqrt_(floor_at(ss, S(1e-30)));
      inv = S(1) / Rjj;
#pragma unroll
      for (int k = 0; k < K; ++k)
        q[k] = stack_zero<N, TRI>(k, i) ? S(0) : v[k][i] * inv;
      if (i == j) break;
#pragma unroll
      for (int l = 0; l < N; ++l) {
        if (l <= i) continue;
        S r = S(0);
#pragma unroll
        for (int k = 0; k < K; ++k)
          if (!stack_zero<N, TRI>(k, i)) r += q[k] * v[k][l];
#pragma unroll
        for (int k = 0; k < K; ++k)
          if (!stack_zero<N, TRI>(k, i)) v[k][l] = v[k][l] - r * q[k];
      }
    }
    // reverse stage j: the columns l > j, then the normalisation
#pragma unroll
    for (int k = 0; k < K; ++k) gq[k] = S(0);
#pragma unroll
    for (int l = 0; l < N; ++l) {
      if (l <= j) continue;
      S r = S(0), gr = gL[l][j];
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (!stack_zero<N, TRI>(k, j)) {
          r += q[k] * v[k][l];
          gr -= gv[k][l] * q[k];
        }
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (!stack_zero<N, TRI>(k, j)) {
          gq[k] += gr * v[k][l] - r * gv[k][l];
          gv[k][l] += gr * q[k];
        }
    }
    S ginv = S(0);
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (!stack_zero<N, TRI>(k, j)) ginv += gq[k] * v[k][j];
    const S gR = gL[j][j] - ginv * inv * inv;
    const S gss = ss >= S(1e-30) ? gR / (S(2) * Rjj) : S(0);
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (!stack_zero<N, TRI>(k, j))
        gv[k][j] += gq[k] * inv + S(2) * gss * v[k][j];
  }
}

// Reverse of data_update at the state (m, L) before it, with its record u:
// gm and gL (cotangents of the state after it) become those of (m, L); gdll
// is the increment's cotangent. Writes the observations' cotangent gy.
template <typename S, int NQ, int DIM>
__device__ __forceinline__ void data_update_vjp(
    const DlConsts<S, NQ, DIM>& c, const S (&L)[NQ * DIM][NQ * DIM],
    const UpdRec<S, NQ * DIM>& u, S gdll, S (&gm)[NQ * DIM],
    S (&gL)[NQ * DIM][NQ * DIM], S (&gy)[DM]) {
  constexpr int N = NQ * DIM;
  S gZ[DM][N], gKg[N][DM], gLs[DM][DM], gz[DM];
#pragma unroll
  for (int a = 0; a < DM; ++a) {
    gz[a] = S(0);
#pragma unroll
    for (int k = 0; k < N; ++k) gZ[a][k] = S(0);
#pragma unroll
    for (int b = 0; b < DM; ++b) gLs[a][b] = S(0);
  }
  S gLin[N][N];
  {
    // L_new = MGS(stack)
    S v[N + DM][N], gv[N + DM][N];
    update_stack<S, NQ, DIM>(c, L, u, v);
    mgs_tril_vjp<S, N, N + DM, false>(v, gL, gv);
#pragma unroll
    for (int r = 0; r < N; ++r) {
      // rows k < N: v[k][r] = L[r][k] - sum_a Kg[r][a] Z[a][k]
#pragma unroll
      for (int a = 0; a < DM; ++a) {
        S acc = S(0);
#pragma unroll
        for (int k = 0; k < N; ++k) {
          acc -= gv[k][r] * u.Z[a][k];
          gZ[a][k] -= gv[k][r] * u.Kg[r][a];
        }
        gKg[r][a] = acc;
      }
#pragma unroll
      for (int k = 0; k < N; ++k) gLin[r][k] = gv[k][r];
      // rows N + a: v[N + a][r] = sum_b Kg[r][b] R[b][a]
#pragma unroll
      for (int a = 0; a < DM; ++a)
#pragma unroll
        for (int b = 0; b < DM; ++b)
          if (c.R[b][a] != S(0)) gKg[r][b] += gv[N + a][r] * c.R[b][a];
    }
  }
  // m_new[r] = m[r] + sum_a Kg[r][a] z[a]; Kg[r] = cho_solve(Ls, LZt[r]);
  // LZt[r][a] = sum_k L[r][k] Z[a][k]
#pragma unroll
  for (int r = 0; r < N; ++r) {
#pragma unroll
    for (int a = 0; a < DM; ++a) {
      gKg[r][a] += gm[r] * u.z[a];
      gz[a] += gm[r] * u.Kg[r][a];
    }
    S gLZt[DM];
#pragma unroll
    for (int a = 0; a < DM; ++a) gLZt[a] = S(0);
    cho_solve_vjp<S, DM>(u.Ls, u.LZt[r], u.Kg[r], gKg[r], gLZt, gLs);
#pragma unroll
    for (int a = 0; a < DM; ++a)
#pragma unroll
      for (int k = 0; k < N; ++k) {
        gLin[r][k] += gLZt[a] * u.Z[a][k];
        gZ[a][k] += gLZt[a] * L[r][k];
      }
  }
  // dll = -0.5 (z^T w + sum_a 2 log(max(Ls[a][a], 1e-30)) + n log 2 pi)
  const S gx = S(-0.5) * gdll;
  S gw[DM];
#pragma unroll
  for (int a = 0; a < DM; ++a) {
    gz[a] += gx * u.w[a];
    gw[a] = gx * u.z[a];
    if (a < c.n && u.Ls[a][a] >= S(1e-30))
      gLs[a][a] += S(2) * gx / u.Ls[a][a];
  }
  cho_solve_vjp<S, DM>(u.Ls, u.z, u.w, gw, gz, gLs);
  // Ls = chol(Z Z^T + R R^T)
  {
    S Sm[DM][DM], gS[DM][DM];
    innov_cov<S, N>(u.Z, c.RRT, Sm);
#pragma unroll
    for (int a = 0; a < DM; ++a)
#pragma unroll
      for (int b = 0; b < DM; ++b) gS[a][b] = S(0);
    chol_vjp<S, DM>(Sm, u.Ls, gLs, gS);
    gram_vjp<S, DM, N>(u.Z, gS, gZ);
  }
  // Z[a][k] = sum_j C[a][j] (pinv0 L[j][k]); z[a] = y[a] - sum_j C[a][j]
  // (pinv0 m[j])
#pragma unroll
  for (int a = 0; a < DM; ++a) gy[a] = gz[a];
#pragma unroll
  for (int r = 0; r < N; ++r) {
    if (r >= DIM) continue;
#pragma unroll
    for (int a = 0; a < DM; ++a)
      if (c.C[a][r] != S(0)) {
        gm[r] -= gz[a] * c.C[a][r] * c.pinv0;
#pragma unroll
        for (int k = 0; k < N; ++k)
          gLin[r][k] += gZ[a][k] * c.C[a][r] * c.pinv0;
      }
  }
#pragma unroll
  for (int r = 0; r < N; ++r)
#pragma unroll
    for (int k = 0; k < N; ++k) gL[r][k] = gLin[r][k];
}

// ---------------------------------------------------------------------------
// The reverse of the EK1 step
// ---------------------------------------------------------------------------

using ek1::StepRec;

// Reverse of H M for H = (E1 - J E0) P^-1 (ek1::h_times), with M given:
// from gX (the product's cotangent) adds J's cotangent to gJ and, with
// WANT_M, M's to gM.
template <typename S, int NQ, int DIM, bool WANT_M, class Get>
__device__ __forceinline__ void h_times_vjp(S pinv0, S pinv1,
                                            const S (&J)[DIM * DIM], Get M,
                                            const S (&gX)[DIM][NQ * DIM],
                                            S (&gJ)[DIM * DIM],
                                            S (&gM)[NQ * DIM][NQ * DIM]) {
  constexpr int N = NQ * DIM;
#pragma unroll
  for (int a = 0; a < DIM; ++a)
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const S g = gX[a][k];
      if (WANT_M) gM[DIM + a][k] += pinv1 * g;
#pragma unroll
      for (int b = 0; b < DIM; ++b) {
        gJ[a * DIM + b] -= g * (pinv0 * M(b, k));
        if (WANT_M) gM[b][k] -= g * J[a * DIM + b] * pinv0;
      }
    }
}

// Reverse of the dynamic step ek1::filter_step<S, NQ, F, false> from its
// record r (the forward's own intermediates: the adjoint steps with
// filter_step and reverses what it ran): gm and gL (cotangents of the state
// after it) become those of the state before it; gll is
// the increment's cotangent; the parameters' cotangent is added to gp.
// stop_calib drops the calibration s2's cotangent (the plain version's
// s2.detach()), so none reaches the residual or J through it.
template <typename S, int NQ, class F>
__device__ __forceinline__ void step_vjp(const DlConsts<S, NQ, F::D>& c,
                                         const S* p, S t,
                                         const StepRec<S, NQ, F::D>& r,
                                         bool stop_calib, S gll,
                                         S (&gm)[NQ * F::D],
                                         S (&gL)[NQ * F::D][NQ * F::D],
                                         S* gp) {
  constexpr int DIM = F::D;
  constexpr int N = NQ * DIM;
  S gz[DIM], gJ[DIM * DIM], gLs[DIM][DIM], gZ[DIM][N], gmp[N];
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
    gz[a] = S(0);
#pragma unroll
    for (int b = 0; b < DIM; ++b) {
      gJ[a * DIM + b] = S(0);
      gLs[a][b] = S(0);
    }
#pragma unroll
    for (int k = 0; k < N; ++k) gZ[a][k] = S(0);
  }
  // ll = -0.5 (z^T ws + 2 sum_a log(max(Ls[a][a], 1e-30)) + DIM log 2 pi)
  {
    const S gx = S(-0.5) * gll;
    S gws[DIM];
#pragma unroll
    for (int a = 0; a < DIM; ++a) {
      gz[a] += gx * r.ws[a];
      gws[a] = gx * r.z[a];
      if (r.Ls[a][a] >= S(1e-30)) gLs[a][a] += S(2) * gx / r.Ls[a][a];
    }
    cho_solve_vjp<S, DIM>(r.Ls, r.z, r.ws, gws, gz, gLs);
  }
  // m_new = mp - Kg z; L_new = Lp - Kg Z; Kg[i] = cho_solve(Ls, LpZt[i]);
  // LpZt[i][a] = sum_k Lp[i][k] Z[a][k]
  S gLp[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    gmp[i] = gm[i];
    S gKg[DIM], gLpZt[DIM];
#pragma unroll
    for (int a = 0; a < DIM; ++a) {
      S acc = -gm[i] * r.z[a];
      gz[a] -= gm[i] * r.Kg[i][a];
#pragma unroll
      for (int k = 0; k < N; ++k) {
        acc -= gL[i][k] * r.Z[a][k];
        gZ[a][k] -= gL[i][k] * r.Kg[i][a];
      }
      gKg[a] = acc;
      gLpZt[a] = S(0);
    }
    cho_solve_vjp<S, DIM>(r.Ls, r.LpZt[i], r.Kg[i], gKg, gLpZt, gLs);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      S acc = gL[i][k];
#pragma unroll
      for (int a = 0; a < DIM; ++a) {
        acc += gLpZt[a] * r.Z[a][k];
        gZ[a][k] += gLpZt[a] * r.Lp[i][k];
      }
      gLp[i][k] = acc;
    }
  }
  // Ls = chol(Z Z^T)
  {
    S Sm[DIM][DIM], gS[DIM][DIM];
    ek1::gram<S, DIM, N>(r.Z, Sm);
#pragma unroll
    for (int a = 0; a < DIM; ++a)
#pragma unroll
      for (int b = 0; b < DIM; ++b) gS[a][b] = S(0);
    chol_vjp<S, DIM>(Sm, r.Ls, gLs, gS);
    gram_vjp<S, DIM, N>(r.Z, gS, gZ);
  }
  // Z = H Lp
  h_times_vjp<S, NQ, DIM, true>(c.pinv0, c.pinv1, r.J,
                                [&](int i, int k) { return r.Lp[i][k]; }, gZ,
                                gJ, gLp);
  // Lp = MGS([(A L)^T; (sq QLf)^T]); only its lower triangle is the MGS's
  S gsq = S(0);
  {
    S v[2 * N][N], gv[2 * N][N];
    ek1::predict_stack<S, NQ, DIM>(c, r.AL, r.sq, v);
    mgs_tril_vjp<S, N, 2 * N, true>(v, gLp, gv);
    // AL = A L: gL_in[cc][k] = sum_i A[i][cc] gAL[i][k], gAL[i][k] = gv[k][i]
#pragma unroll
    for (int cc = 0; cc < N; ++cc)
#pragma unroll
      for (int k = 0; k < N; ++k) {
        S acc = S(0);
#pragma unroll
        for (int i = 0; i < N; ++i)
          if (a_live<DIM>(i, cc)) acc += c.At[i / DIM][cc / DIM] * gv[k][i];
        gL[cc][k] = acc;
      }
#pragma unroll
    for (int k = 0; k < N; ++k)
#pragma unroll
      for (int i = 0; i < N; ++i)
        if (q_live<DIM>(i, k)) gsq += gv[N + k][i] * c.QLt[i / DIM][k / DIM];
  }
  // sq = sqrt(max(s2, 0)); s2 = z^T w / DIM; w = cho_solve(Lq, z);
  // Lq = chol(HQ HQ^T); HQ = H QLf
  if (!stop_calib) {
    const S gs2 = r.s2 >= S(0) ? gsq / (S(2) * r.sq) : S(0);
    const S gzw = gs2 * (S(1) / S(DIM));
    S gw[DIM], gLq[DIM][DIM], gSq[DIM][DIM], gHQ[DIM][N];
#pragma unroll
    for (int a = 0; a < DIM; ++a) {
      gz[a] += gzw * r.w[a];
      gw[a] = gzw * r.z[a];
#pragma unroll
      for (int b = 0; b < DIM; ++b) gLq[a][b] = gSq[a][b] = S(0);
#pragma unroll
      for (int k = 0; k < N; ++k) gHQ[a][k] = S(0);
    }
    cho_solve_vjp<S, DIM>(r.Lq, r.z, r.w, gw, gz, gLq);
    S Sq[DIM][DIM];
    ek1::gram<S, DIM, N>(r.HQ, Sq);
    chol_vjp<S, DIM>(Sq, r.Lq, gLq, gSq);
    gram_vjp<S, DIM, N>(r.HQ, gSq, gHQ);
    S unused[N][N];
    h_times_vjp<S, NQ, DIM, false>(
        c.pinv0, c.pinv1, r.J,
        [&](int i, int k) {
          return q_live<DIM>(i, k) ? c.QLt[i / DIM][k / DIM] : S(0);
        },
        gHQ, gJ, unused);
  }
  // z = pinv1 mp[DIM + a] - f(u); J = J(u); u = pinv0 mp[0 .. DIM-1]
  S gdu[DIM], gu[DIM], guj[DIM];
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
    gmp[DIM + a] += c.pinv1 * gz[a];
    gdu[a] = -gz[a];
  }
  F().vjp(r.u, p, t, gdu, gu, gp);
  F().jac_vjp(r.u, p, t, gJ, guj, gp);
#pragma unroll
  for (int j = 0; j < DIM; ++j) gmp[j] += c.pinv0 * (gu[j] + guj[j]);
  // mp = A m
#pragma unroll
  for (int cc = 0; cc < N; ++cc) {
    S acc = S(0);
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (a_live<DIM>(i, cc)) acc += c.At[i / DIM][cc / DIM] * gmp[i];
    gm[cc] = acc;
  }
}

}  // namespace ek1dl
