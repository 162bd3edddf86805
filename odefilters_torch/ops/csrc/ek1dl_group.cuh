// The dense EK1 data likelihood's adjoint sweep with a group of N = NQ DIM
// lanes per member (ek1_datalik.cu: ek1_datalik_grad_bwd_kernel): the
// forward of a step (ek1_fused.cuh: filter_step) and of the data update
// (ek1_datalik.cuh: data_update) recomputed with their intermediates
// recorded, then reversed line by line. Each entry is formed by the
// operations of the one-thread reverse that this design replaced (its
// plain version is the torch.func.vjp of odefilters_torch/ops/
// ek1_datalik.py, mgs_tril_vjp its MGS reverse) in the same order, so the
// two are bit for bit.
//
// Lane r of a member owns row r of every N x N matrix (the factors L, Lp
// and the cotangents gL, gLp), entry r of the mean's cotangent, row r of
// the gains, and column r of each modified Gram-Schmidt stack (the step's
// 2N x N prediction stack, the update's (N + DM) x N one). The quantities
// of size DIM or DM (the field, its Jacobian, the residuals, the small
// Cholesky factors and their reverses, the parameters' cotangent) are
// formed by every lane of the member with the same operations, so they are
// the same bits in each. Where the one-thread reverse accumulates over the
// rows (a cotangent of C P0 L, of H Lp, of the residual or of a small
// Cholesky factor), each lane publishes its row's terms in the member's
// shared memory and the sum is taken in one lane (or in every lane alike)
// in the row order of the one-thread loop.
//
// Each Gram-Schmidt's forward runs once a step: at pivot j every lane at or
// after j keeps its column (its state at stage j) in the member's shared
// memory, so that the reverse of stage j reads the stage's state instead of
// recomputing stages 0 .. j from the stack, which the one-thread reverse
// did for every j (N / 2 forward QRs a reverse).
#pragma once

#include "ek1_datalik.cuh"  // ek1dl::DlConsts, DM, chol, gram
#include "ek1_group.cuh"    // ek1g::MemberSync, ek1g::Stager

namespace ek1dlg {

using ek0::cho_solve;
using ek0::floor_at;
using ek0::sqrt_;
using ek0::stack_zero;
using ek1::a_live;
using ek1::q_live;
using ek1dl::DlConsts;
using ek1dl::DM;

// Members per CTA: 8 float32 (64 threads) or 4 float64 ones, 4 CTAs an SM
// (their shared memory, ~53 kB a CTA).
template <typename S>
struct Tile {
  static constexpr int MB = sizeof(S) == 4 ? 8 : 4;
};

// A member's shared memory: rows 0 .. 2 DIM - 1 of Lp, Z = H Lp and the
// update's C P0 L (a column by each lane), the two Gram-Schmidts' kept
// stages (lane l's column at stages 0 .. l at ST + (l (l + 1) / 2 + j) KP,
// KP = K made odd so that the lanes' columns start in different banks),
// the update's cotangent of C P0 L (GZ), and GA, whose parts live at
// different times: in the forward, a Gram-Schmidt's scaled pivot columns
// (FQ) and the state after the step (FM: m; FL: rows 0 .. DIM-1 of L); in
// the reverses, each lane's published rows and terms for the sums over the
// rows (PV .. TL), a Gram-Schmidt reverse's terms (RT, 2 N K1) and scaled
// pivot column (RQ, 2 K1), the rows of gLp and the Jacobian's terms (GP,
// TJ), the prediction stack's cotangent (GV) and the predicted mean's
// (GM).
template <int N, int DIM>
struct Ws {
  static constexpr int K1 = 2 * N, K2 = N + DM;
  static constexpr int KP1 = K1 | 1, KP2 = K2 | 1, TRI = N * (N + 1) / 2;
  static constexpr int LP = 0, Z = LP + 2 * DIM * N, ZO = Z + DIM * N,
                       ST1 = ZO + DM * N, ST2 = ST1 + TRI * KP1,
                       GZ = ST2 + TRI * KP2, GA = GZ + DM * N;
  // offsets in GA
  static constexpr int FQ = 0, FM = N * K1, FL = FM + N;
  static constexpr int PV = 0, PK = PV + N * N, PG = PK + N * DM,
                       PL = PG + N * DM, TZ = PL + N * N, TL = TZ + N * DM,
                       ROWS = TL + N * DM * (DM + 1);
  static constexpr int RT = 0, RQ = 2 * N * K1, GP = RQ + 2 * K1,
                       TJ = GP + 2 * DIM * N, GV = 0, GM = K1 * N,
                       SPAN = TJ + N * DIM * DIM;
  static constexpr int GA_SIZE = ROWS > SPAN ? ROWS : SPAN;
  static constexpr int SIZE = GA + GA_SIZE + 1;
  static_assert(FL + DIM * N <= GA_SIZE && GM + N <= GA_SIZE,
                "GA holds each of its parts");
};

// ---- the Gram-Schmidt forward with its stages kept, and its reverse ----

// grp::mgs_rows's pivots (ek0::mgs_tril's operations) on the K x N stack
// whose column `lane` is col, writing row `lane` of L; at pivot j each lane
// at or after j first keeps col at cols + j KP (the lane's stages, shared),
// and lane j keeps its pivot's ss, R and 1 / R. Qs (N K, shared): the
// scaled pivot columns, kept for the reverse.
template <typename S, int N, int K, int KP, bool TRI, class Sync>
__device__ __forceinline__ void mgs_keep(S (&col)[K], int lane, S* Qs,
                                         S* cols, S& ss_o, S& rjj_o,
                                         S& inv_o, S (&Lr)[N],
                                         const Sync& sync) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    Lr[j] = S(0);
    if (lane >= j) {
#pragma unroll
      for (int k = 0; k < K; ++k) cols[j * KP + k] = col[k];
    }
    if (lane == j) {
      S ss = S(0);
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (!stack_zero<N, TRI>(k, j)) ss += col[k] * col[k];
      const S rjj = sqrt_(floor_at(ss, S(1e-30)));
      const S inv = S(1) / rjj;
      Lr[j] = rjj;
      ss_o = ss;
      rjj_o = rjj;
      inv_o = inv;
#pragma unroll
      for (int k = 0; k < K; ++k)
        Qs[j * K + k] = stack_zero<N, TRI>(k, j) ? S(0) : col[k] * inv;
    }
    sync();
    if (lane > j) {
      S r = S(0);
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (!stack_zero<N, TRI>(k, j)) r += Qs[j * K + k] * col[k];
      Lr[j] = r;
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (!stack_zero<N, TRI>(k, j)) col[k] = col[k] - r * Qs[j * K + k];
    }
  }
}

// The MGS reverse (ek1_datalik.py: mgs_tril_vjp) by the group: from row
// `lane` of gL (the factor's cotangent) writes column `lane` of the stack's
// cotangent gv, reversing stage j from the kept state at cols + j KP: lane
// j publishes the stage's scaled pivot column in Q (2 K, shared,
// alternating; formed as the forward formed it), the lanes after j form
// their terms of gq and publish them in T (2 N K, alternating), and lane j
// sums them in the order of the columns. Ends at a barrier.
template <typename S, int N, int K, int KP, bool TRI, class Sync>
__device__ __forceinline__ void mgs_vjp(const S* cols, S ss, S rjj, S inv,
                                        const S (&gLr)[N], int lane, S* T,
                                        S* Q, S (&gv)[K], const Sync& sync) {
#pragma unroll
  for (int k = 0; k < K; ++k) gv[k] = S(0);
#pragma unroll
  for (int j = N - 1; j >= 0; --j) {
    S* Tj = T + (j & 1) * N * K;
    S* Qj = Q + (j & 1) * K;
    if (lane == j) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        Qj[k] = stack_zero<N, TRI>(k, j) ? S(0) : cols[j * KP + k] * inv;
    }
    sync();
    if (lane > j) {
      S r = S(0), gr = gLr[j];
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (!stack_zero<N, TRI>(k, j)) {
          r += Qj[k] * cols[j * KP + k];
          gr -= gv[k] * Qj[k];
        }
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (!stack_zero<N, TRI>(k, j)) {
          Tj[lane * K + k] = gr * cols[j * KP + k] - r * gv[k];
          gv[k] += gr * Qj[k];
        }
    }
    sync();
    if (lane == j) {
      S gq[K];
#pragma unroll
      for (int k = 0; k < K; ++k) gq[k] = S(0);
#pragma unroll
      for (int l = j + 1; l < N; ++l)
#pragma unroll
        for (int k = 0; k < K; ++k)
          if (!stack_zero<N, TRI>(k, j)) gq[k] += Tj[l * K + k];
      S ginv = S(0);
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (!stack_zero<N, TRI>(k, j)) ginv += gq[k] * cols[j * KP + k];
      const S gR = gLr[j] - ginv * inv * inv;
      const S gss = ss >= S(1e-30) ? gR / (S(2) * rjj) : S(0);
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (!stack_zero<N, TRI>(k, j))
          gv[k] += gq[k] * inv + S(2) * gss * cols[j * KP + k];
    }
  }
  sync();
}

// ---- the reverse of a Cholesky solve, its factor's cotangent deferred ----

// ek1dl::cho_solve_vjp with the updates of gL written as terms, in their
// order, to T (K (K + 1) values); replay applies them.
template <typename S, int K>
__device__ __forceinline__ void cho_solve_vjp_terms(const S (&L)[K][K],
                                                    const S (&b)[K],
                                                    const S (&x)[K],
                                                    S (&gx)[K], S (&gb)[K],
                                                    S* T) {
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
  int n = 0;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const S gs = gx[i] / L[i][i];
    T[n++] = gx[i] * x[i] / L[i][i];
    gy[i] += gs;
#pragma unroll
    for (int k = i + 1; k < K; ++k) {
      T[n++] = gs * x[k];
      gx[k] -= gs * L[k][i];
    }
  }
#pragma unroll
  for (int i = K - 1; i >= 0; --i) {
    const S gs = gy[i] / L[i][i];
    T[n++] = gy[i] * y[i] / L[i][i];
    gb[i] += gs;
#pragma unroll
    for (int k = 0; k < i; ++k) {
      T[n++] = gs * y[k];
      gy[k] -= gs * L[i][k];
    }
  }
}

// gL -= the terms of cho_solve_vjp_terms, in its order.
template <typename S, int K>
__device__ __forceinline__ void replay(const S* T, S (&gL)[K][K]) {
  int n = 0;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    gL[i][i] -= T[n++];
#pragma unroll
    for (int k = i + 1; k < K; ++k) gL[k][i] -= T[n++];
  }
#pragma unroll
  for (int i = K - 1; i >= 0; --i) {
    gL[i][i] -= T[n++];
#pragma unroll
    for (int k = 0; k < i; ++k) gL[i][k] -= T[n++];
  }
}

// Column c of ek1dl::gram_vjp: gX[a][c] += gG[a][b] X[b][c] and gX[b][c] +=
// gG[a][b] X[a][c] over b <= a, for the DIM x N X of column xc.
template <typename S, int KK>
__device__ __forceinline__ void gram_vjp_col(const S (&xc)[KK],
                                             const S (&gG)[KK][KK],
                                             S (&gc)[KK]) {
#pragma unroll
  for (int a = 0; a < KK; ++a)
#pragma unroll
    for (int b = 0; b <= a; ++b) {
      gc[a] += gG[a][b] * xc[b];
      gc[b] += gG[a][b] * xc[a];
    }
}

// ---- the forward, recorded ----

// What the reverse of a step reads of its forward: the quantities of
// ek1::filter_step (each lane holds those of size DIM, and its rows),
// and lane r's prediction stack column at every stage.
template <typename S, int NQ, int DIM>
struct StepRec {
  static constexpr int N = NQ * DIM, K = 2 * N;
  S mp[N];          // predicted mean (every entry)
  S u[DIM], J[DIM * DIM], z[DIM];
  S HQ[DIM][N];     // H QLf
  S Lq[DIM][DIM], w[DIM], s2, sq;
  S Ls[DIM][DIM], ws[DIM];
  S lp[N];          // row r of Lp
  S lpzt[DIM];      // row r of Lp Z^T
  S kg[DIM];        // row r of the gain
  S ss, rjj, inv;   // pivot r of the prediction stack
};

// What the reverse of the data update reads.
template <typename S, int N>
struct UpdRec {
  static constexpr int K = N + DM;
  S z[DM], Ls[DM][DM], w[DM];
  S lrow[N];        // row r of L before the update
  S lzt[DM];        // row r of L Z^T
  S kg[DM];         // row r of the gain
  S ss, rjj, inv;   // pivot r of the update stack
};

// ek1::filter_step<S, NQ, F, false> from (m, L) by the group: R holds the
// member's staged stream row (value v at R[v SP]: m, then L row by row).
// Leaves the state after the step in ws (m; rows 0 .. DIM-1 of L) and row
// r of L in lnew, and records the step in rec.
template <typename S, int NQ, class F, int SP, class Sync>
__device__ __forceinline__ void step_fwd(const DlConsts<S, NQ, F::D>& c,
                                         const S* p, S t, const S* R, int r,
                                         S* ws, S (&lnew)[NQ * F::D],
                                         StepRec<S, NQ, F::D>& rec,
                                         const Sync& sync) {
  constexpr int DIM = F::D;
  constexpr int N = NQ * DIM;
  constexpr int K = 2 * N;
  using W = Ws<N, DIM>;
  auto Lin = [&](int i, int k) { return R[(N + i * N + k) * SP]; };
  S m[N];
#pragma unroll
  for (int i = 0; i < N; ++i) m[i] = R[i * SP];
  ek1::a_times_vec<S, NQ, DIM>(c, m, rec.mp);
  S du[DIM];
#pragma unroll
  for (int j = 0; j < DIM; ++j) rec.u[j] = c.pinv0 * rec.mp[j];
  F()(rec.u, p, t, du);
  F().jac(rec.u, p, t, rec.J);
#pragma unroll
  for (int a = 0; a < DIM; ++a)
    rec.z[a] = ek0::innovation(c.pinv1, rec.mp[DIM + a], du[a]);
  {
    S Sq[DIM][DIM];
    ek1::h_times<S, NQ, DIM>(c.pinv0, c.pinv1, rec.J, [&](int i, int k) {
      return q_live<DIM>(i, k) ? c.QLt[i / DIM][k / DIM] : S(0);
    }, rec.HQ);
    ek1::gram<S, DIM, N>(rec.HQ, Sq);
    ek1::chol<S, DIM>(Sq, rec.Lq);
    cho_solve<S, DIM>(rec.Lq, rec.z, rec.w);
    S zw = S(0);
#pragma unroll
    for (int a = 0; a < DIM; ++a) zw += rec.z[a] * rec.w[a];
    rec.s2 = zw * (S(1) / S(DIM));
    rec.sq = sqrt_(floor_at(rec.s2, S(0)));
  }
  // column r of [(A L)^T; (sq QLf)^T]: row r of A L (a_times_mat), then
  // row r of sq QLf
  S col[K];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    S acc = S(0);
#pragma unroll
    for (int cc = 0; cc < N; ++cc)
      if (a_live<DIM>(r, cc)) acc += c.At[r / DIM][cc / DIM] * Lin(cc, k);
    col[k] = acc;
  }
#pragma unroll
  for (int k = 0; k < N; ++k)
    col[N + k] = q_live<DIM>(r, k) ? rec.sq * c.QLt[r / DIM][k / DIM] : S(0);
  mgs_keep<S, N, K, W::KP1, true>(col, r, ws + W::GA + W::FQ,
                                  ws + W::ST1 + r * (r + 1) / 2 * W::KP1,
                                  rec.ss, rec.rjj, rec.inv, rec.lp, sync);
  // rows 0 .. 2 DIM - 1 of Lp for Z = H Lp: column k of Z by lane k
  if (r < 2 * DIM) {
#pragma unroll
    for (int k = 0; k < N; ++k) ws[W::LP + r * N + k] = rec.lp[k];
  }
  sync();
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
    S v = c.pinv1 * ws[W::LP + (DIM + a) * N + r];
#pragma unroll
    for (int b = 0; b < DIM; ++b)
      v = v - rec.J[a * DIM + b] * (c.pinv0 * ws[W::LP + b * N + r]);
    ws[W::Z + a * N + r] = v;
  }
  sync();
  S Z[DIM][N];
#pragma unroll
  for (int a = 0; a < DIM; ++a)
#pragma unroll
    for (int k = 0; k < N; ++k) Z[a][k] = ws[W::Z + a * N + k];
  {
    S Sm[DIM][DIM];
    ek1::gram<S, DIM, N>(Z, Sm);
    ek1::chol<S, DIM>(Sm, rec.Ls);
  }
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
    S acc = S(0);
#pragma unroll
    for (int k = 0; k < N; ++k) acc += rec.lp[k] * Z[a][k];
    rec.lpzt[a] = acc;
  }
  cho_solve<S, DIM>(rec.Ls, rec.lpzt, rec.kg);
  S km = S(0);
#pragma unroll
  for (int a = 0; a < DIM; ++a) km += rec.kg[a] * rec.z[a];
  const S mr = rec.mp[r] - km;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    S kz = S(0);
#pragma unroll
    for (int a = 0; a < DIM; ++a) kz += rec.kg[a] * Z[a][k];
    lnew[k] = rec.lp[k] - kz;
  }
  cho_solve<S, DIM>(rec.Ls, rec.z, rec.ws);
  ws[W::GA + W::FM + r] = mr;
  if (r < DIM) {
#pragma unroll
    for (int k = 0; k < N; ++k) ws[W::GA + W::FL + r * N + k] = lnew[k];
  }
  sync();
}

// ek1dl::data_update by the group on the state ws (m) and lrow (row r of
// L) after the step, y the observations (DM entries, zero past n):
// records the update in u (the new state is not needed) and leaves C P0 L
// in ws.
template <typename S, int NQ, int DIM, class Sync>
__device__ __forceinline__ void update_fwd(const DlConsts<S, NQ, DIM>& c,
                                           const S (&y)[DM], int r, S* ws,
                                           const S (&lrow)[NQ * DIM],
                                           UpdRec<S, NQ * DIM>& u,
                                           const Sync& sync) {
  constexpr int N = NQ * DIM;
  constexpr int K = N + DM;
  using W = Ws<N, DIM>;
#pragma unroll
  for (int k = 0; k < N; ++k) u.lrow[k] = lrow[k];
#pragma unroll
  for (int a = 0; a < DM; ++a) {
    S yhat = S(0);
#pragma unroll
    for (int j = 0; j < DIM; ++j)
      if (c.C[a][j] != S(0))
        yhat += c.C[a][j] * (c.pinv0 * ws[W::GA + W::FM + j]);
    u.z[a] = y[a] - yhat;
    S acc = S(0);
#pragma unroll
    for (int j = 0; j < DIM; ++j)
      if (c.C[a][j] != S(0))
        acc += c.C[a][j] * (c.pinv0 * ws[W::GA + W::FL + j * N + r]);
    ws[W::ZO + a * N + r] = acc;
  }
  sync();
  S Z[DM][N];
#pragma unroll
  for (int a = 0; a < DM; ++a)
#pragma unroll
    for (int k = 0; k < N; ++k) Z[a][k] = ws[W::ZO + a * N + k];
  {
    S Sm[DM][DM];
    ek1dl::innov_cov<S, N>(Z, c.RRT, Sm);
    ek1::chol<S, DM>(Sm, u.Ls);
  }
  cho_solve<S, DM>(u.Ls, u.z, u.w);
#pragma unroll
  for (int a = 0; a < DM; ++a) {
    S acc = S(0);
#pragma unroll
    for (int k = 0; k < N; ++k) acc += lrow[k] * Z[a][k];
    u.lzt[a] = acc;
  }
  cho_solve<S, DM>(u.Ls, u.lzt, u.kg);
  // column r of [L - K Z | K R]^T
  S col[K];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    S kz = u.kg[0] * Z[0][k];
#pragma unroll
    for (int a = 1; a < DM; ++a) kz += u.kg[a] * Z[a][k];
    col[k] = lrow[k] - kz;
  }
#pragma unroll
  for (int a = 0; a < DM; ++a) {
    S acc = S(0);
#pragma unroll
    for (int b = 0; b < DM; ++b)
      if (c.R[b][a] != S(0)) acc += u.kg[b] * c.R[b][a];
    col[N + a] = acc;
  }
  S Lr[N];
  mgs_keep<S, N, K, W::KP2, false>(col, r, ws + W::GA + W::FQ,
                                   ws + W::ST2 + r * (r + 1) / 2 * W::KP2,
                                   u.ss, u.rjj, u.inv, Lr, sync);
}

// ---- the reverses ----

// The reverse of ek1dl::data_update by the group: gm (entry r), gL (row r),
// cotangents of the state after the update, become those of the state before
// it; gdll the increment's cotangent (every lane); writes the observations'
// cotangent gy (every lane).
template <typename S, int NQ, int DIM, class Sync>
__device__ __forceinline__ void update_vjp(const DlConsts<S, NQ, DIM>& c,
                                           const UpdRec<S, NQ * DIM>& u,
                                           S gdll, int r, S* ws, S& gm,
                                           S (&gL)[NQ * DIM], S (&gy)[DM],
                                           const Sync& sync) {
  constexpr int N = NQ * DIM;
  constexpr int K = N + DM;
  constexpr int NT = DM * (DM + 1);  // Cholesky-solve terms
  using W = Ws<N, DIM>;
  // each lane's rows, for the sums over the rows
  S* PV = ws + W::GA + W::PV;      // gv[0 .. N-1][r]
  S* PK = ws + W::GA + W::PK;      // Kg[r]
  S* PG = ws + W::GA + W::PG;      // gLZt (row r's)
  S* PL = ws + W::GA + W::PL;      // L[r]
  S* Tz = ws + W::GA + W::TZ;      // += gm[r] Kg[r][a]: [r][a]
  S* Tl = ws + W::GA + W::TL;      // the gLs terms: [r][NT]
  S gv[K];
  mgs_vjp<S, N, K, W::KP2, false>(ws + W::ST2 + r * (r + 1) / 2 * W::KP2,
                                  u.ss, u.rjj, u.inv, gL, r,
                                  ws + W::GA + W::RT, ws + W::GA + W::RQ, gv,
                                  sync);
  S Z[DM][N];
#pragma unroll
  for (int a = 0; a < DM; ++a)
#pragma unroll
    for (int k = 0; k < N; ++k) Z[a][k] = ws[W::ZO + a * N + k];
  S gKg[DM], gLin[N];
  // rows k < N: v[k][r] = L[r][k] - sum_a Kg[r][a] Z[a][k]
#pragma unroll
  for (int a = 0; a < DM; ++a) {
    S acc = S(0);
#pragma unroll
    for (int k = 0; k < N; ++k) acc -= gv[k] * Z[a][k];
    gKg[a] = acc;
    PK[r * DM + a] = u.kg[a];
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
    gLin[k] = gv[k];
    PV[r * N + k] = gv[k];
    PL[r * N + k] = u.lrow[k];
  }
  // rows N + a: v[N + a][r] = sum_b Kg[r][b] R[b][a]
#pragma unroll
  for (int a = 0; a < DM; ++a)
#pragma unroll
    for (int b = 0; b < DM; ++b)
      if (c.R[b][a] != S(0)) gKg[b] += gv[N + a] * c.R[b][a];
  // m_new[r] = m[r] + sum_a Kg[r][a] z[a]; Kg[r] = cho_solve(Ls, LZt[r])
#pragma unroll
  for (int a = 0; a < DM; ++a) {
    gKg[a] += gm * u.z[a];
    Tz[r * DM + a] = gm * u.kg[a];
  }
  {
    S gLZt[DM];
#pragma unroll
    for (int a = 0; a < DM; ++a) gLZt[a] = S(0);
    cho_solve_vjp_terms<S, DM>(u.Ls, u.lzt, u.kg, gKg, gLZt, Tl + r * NT);
#pragma unroll
    for (int a = 0; a < DM; ++a) {
      PG[r * DM + a] = gLZt[a];
#pragma unroll
      for (int k = 0; k < N; ++k) gLin[k] += gLZt[a] * Z[a][k];
    }
  }
  sync();
  // the sums over the rows, in the one-thread loop's row order
  S gz[DM], gLs[DM][DM], gZc[DM];
#pragma unroll
  for (int a = 0; a < DM; ++a) {
    gz[a] = S(0);
    gZc[a] = S(0);
#pragma unroll
    for (int b = 0; b < DM; ++b) gLs[a][b] = S(0);
  }
  // column r of gZ: -= gv[r][rr] Kg[rr][a], then += gLZt_rr[a] L[rr][r]
#pragma unroll
  for (int rr = 0; rr < N; ++rr)
#pragma unroll
    for (int a = 0; a < DM; ++a)
      gZc[a] -= PV[rr * N + r] * PK[rr * DM + a];
#pragma unroll
  for (int rr = 0; rr < N; ++rr) {
#pragma unroll
    for (int a = 0; a < DM; ++a) {
      gz[a] += Tz[rr * DM + a];
      gZc[a] += PG[rr * DM + a] * PL[rr * N + r];
    }
    replay<S, DM>(Tl + rr * NT, gLs);
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
  ek1dl::cho_solve_vjp<S, DM>(u.Ls, u.z, u.w, gw, gz, gLs);
  // Ls = chol(Z Z^T + R R^T): column r of gZ
  {
    S Sm[DM][DM], gS[DM][DM], zc[DM];
    ek1dl::innov_cov<S, N>(Z, c.RRT, Sm);
#pragma unroll
    for (int a = 0; a < DM; ++a) {
      zc[a] = Z[a][r];
#pragma unroll
      for (int b = 0; b < DM; ++b) gS[a][b] = S(0);
    }
    ek1dl::chol_vjp<S, DM>(Sm, u.Ls, gLs, gS);
    gram_vjp_col<S, DM>(zc, gS, gZc);
  }
#pragma unroll
  for (int a = 0; a < DM; ++a) {
    gy[a] = gz[a];
    ws[W::GZ + a * N + r] = gZc[a];
  }
  sync();
  // Z[a][k] = sum_j C[a][j] (pinv0 L[j][k]); z[a] = y[a] - sum_j C[a][j]
  // (pinv0 m[j])
  if (r < DIM) {
#pragma unroll
    for (int a = 0; a < DM; ++a)
      if (c.C[a][r] != S(0)) {
        gm -= gz[a] * c.C[a][r] * c.pinv0;
#pragma unroll
        for (int k = 0; k < N; ++k)
          gLin[k] += ws[W::GZ + a * N + k] * c.C[a][r] * c.pinv0;
      }
  }
#pragma unroll
  for (int k = 0; k < N; ++k) gL[k] = gLin[k];
  sync();
}

// The reverse of the dynamic ek1::filter_step by the group: gm (entry r) and
// gL (row r), cotangents of the state after the step, become those of the
// state before it; gll the increment's cotangent; the parameters' cotangent
// is added to gp (every lane alike).
template <typename S, int NQ, class F, class Sync>
__device__ __forceinline__ void step_vjp(const DlConsts<S, NQ, F::D>& c,
                                         const S* p, S t,
                                         const StepRec<S, NQ, F::D>& rec,
                                         bool stop_calib, S gll, int r,
                                         S* ws, S& gm, S (&gL)[NQ * F::D],
                                         S* gp, const Sync& sync) {
  constexpr int DIM = F::D;
  constexpr int N = NQ * DIM;
  constexpr int K = 2 * N;
  constexpr int NT = DIM * (DIM + 1);
  using W = Ws<N, DIM>;
  // each lane's rows, for the sums over the rows
  S* PV = ws + W::GA + W::PV;      // gL[i]
  S* PK = ws + W::GA + W::PK;      // Kg[i]
  S* PG = ws + W::GA + W::PG;      // gLpZt (row i's)
  S* PL = ws + W::GA + W::PL;      // Lp[i]
  S* Tz = ws + W::GA + W::TZ;      // -= gm[i] Kg[i][a]: [i][a]
  S* Tl = ws + W::GA + W::TL;      // the gLs terms: [i][NT]
  S Z[DIM][N];
#pragma unroll
  for (int a = 0; a < DIM; ++a)
#pragma unroll
    for (int k = 0; k < N; ++k) Z[a][k] = ws[W::Z + a * N + k];
  S gz[DIM], gJ[DIM * DIM], gLs[DIM][DIM];
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
    gz[a] = S(0);
#pragma unroll
    for (int b = 0; b < DIM; ++b) {
      gJ[a * DIM + b] = S(0);
      gLs[a][b] = S(0);
    }
  }
  // ll = -0.5 (z^T ws + 2 sum_a log(max(Ls[a][a], 1e-30)) + DIM log 2 pi)
  {
    const S gx = S(-0.5) * gll;
    S gws[DIM];
#pragma unroll
    for (int a = 0; a < DIM; ++a) {
      gz[a] += gx * rec.ws[a];
      gws[a] = gx * rec.z[a];
      if (rec.Ls[a][a] >= S(1e-30)) gLs[a][a] += S(2) * gx / rec.Ls[a][a];
    }
    ek1dl::cho_solve_vjp<S, DIM>(rec.Ls, rec.z, rec.ws, gws, gz, gLs);
  }
  // row r: m_new = mp - Kg z; L_new = Lp - Kg Z; Kg[r] = cho_solve(Ls,
  // LpZt[r]); LpZt[r][a] = sum_k Lp[r][k] Z[a][k]
  S gmp = gm, gLp[N];
  {
    S gKg[DIM], gLpZt[DIM];
#pragma unroll
    for (int a = 0; a < DIM; ++a) {
      S acc = -gm * rec.z[a];
      Tz[r * DIM + a] = gm * rec.kg[a];
      PK[r * DM + a] = rec.kg[a];
#pragma unroll
      for (int k = 0; k < N; ++k) acc -= gL[k] * Z[a][k];
      gKg[a] = acc;
      gLpZt[a] = S(0);
    }
#pragma unroll
    for (int k = 0; k < N; ++k) {
      PV[r * N + k] = gL[k];
      PL[r * N + k] = rec.lp[k];
    }
    cho_solve_vjp_terms<S, DIM>(rec.Ls, rec.lpzt, rec.kg, gKg, gLpZt,
                                Tl + r * NT);
#pragma unroll
    for (int a = 0; a < DIM; ++a) PG[r * DM + a] = gLpZt[a];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      S acc = gL[k];
#pragma unroll
      for (int a = 0; a < DIM; ++a) acc += gLpZt[a] * Z[a][k];
      gLp[k] = acc;
    }
  }
  sync();
  // the sums over the rows, in the one-thread loop's row order; lane r
  // takes column r of gZ
  S gZc[DIM];
#pragma unroll
  for (int a = 0; a < DIM; ++a) gZc[a] = S(0);
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int a = 0; a < DIM; ++a) {
      gz[a] -= Tz[i * DIM + a];
      gZc[a] -= PV[i * N + r] * PK[i * DM + a];
    }
    replay<S, DIM>(Tl + i * NT, gLs);
#pragma unroll
    for (int a = 0; a < DIM; ++a) gZc[a] += PG[i * DM + a] * PL[i * N + r];
  }
  // Ls = chol(Z Z^T)
  {
    S Sm[DIM][DIM], gS[DIM][DIM], zc[DIM];
    ek1::gram<S, DIM, N>(Z, Sm);
#pragma unroll
    for (int a = 0; a < DIM; ++a) {
      zc[a] = Z[a][r];
#pragma unroll
      for (int b = 0; b < DIM; ++b) gS[a][b] = S(0);
    }
    ek1dl::chol_vjp<S, DIM>(Sm, rec.Ls, gLs, gS);
    gram_vjp_col<S, DIM>(zc, gS, gZc);
  }
  // Z = H Lp: lane r forms column r's updates of rows
  // 0 .. 2 DIM - 1 of gLp, in shared, and its terms of gJ (after every
  // lane's reads of the rows above: GP shares GA with them)
  sync();
  if (r < 2 * DIM) {
#pragma unroll
    for (int k = 0; k < N; ++k) ws[W::GA + W::GP + r * N + k] = gLp[k];
  }
  sync();
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
    const S g = gZc[a];
    ws[W::GA + W::GP + (DIM + a) * N + r] += c.pinv1 * g;
#pragma unroll
    for (int b = 0; b < DIM; ++b) {
      ws[W::GA + W::TJ + (r * DIM + a) * DIM + b] =
          g * (c.pinv0 * ws[W::LP + b * N + r]);
      ws[W::GA + W::GP + b * N + r] -= g * rec.J[a * DIM + b] * c.pinv0;
    }
  }
  sync();
  if (r < 2 * DIM) {
#pragma unroll
    for (int k = 0; k < N; ++k) gLp[k] = ws[W::GA + W::GP + r * N + k];
  }
#pragma unroll
  for (int a = 0; a < DIM; ++a)
#pragma unroll
    for (int k = 0; k < N; ++k)
#pragma unroll
      for (int b = 0; b < DIM; ++b)
        gJ[a * DIM + b] -= ws[W::GA + W::TJ + (k * DIM + a) * DIM + b];
  // Lp = MGS([(A L)^T; (sq QLf)^T]): column r of the stack's cotangent
  S gv[K];
  mgs_vjp<S, N, K, W::KP1, true>(ws + W::ST1 + r * (r + 1) / 2 * W::KP1,
                                 rec.ss, rec.rjj, rec.inv, gLp, r,
                                 ws + W::GA + W::RT, ws + W::GA + W::RQ, gv,
                                 sync);
#pragma unroll
  for (int k = 0; k < K; ++k) ws[W::GA + W::GV + k * N + r] = gv[k];
  sync();
  // AL = A L: gL_in[r][k] = sum_i A[i][r] gAL[i][k], gAL[i][k] = gv[k][i]
#pragma unroll
  for (int k = 0; k < N; ++k) {
    S acc = S(0);
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (a_live<DIM>(i, r))
        acc += c.At[i / DIM][r / DIM] * ws[W::GA + W::GV + k * N + i];
    gL[k] = acc;
  }
  S gsq = S(0);
#pragma unroll
  for (int k = 0; k < N; ++k)
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (q_live<DIM>(i, k))
        gsq += ws[W::GA + W::GV + (N + k) * N + i] * c.QLt[i / DIM][k / DIM];
  // sq = sqrt(max(s2, 0)); s2 = z^T w / DIM; w = cho_solve(Lq, z);
  // Lq = chol(HQ HQ^T); HQ = H QLf
  if (!stop_calib) {
    const S gs2 = rec.s2 >= S(0) ? gsq / (S(2) * rec.sq) : S(0);
    const S gzw = gs2 * (S(1) / S(DIM));
    S gw[DIM], gLq[DIM][DIM], gSq[DIM][DIM], gHQ[DIM][N];
#pragma unroll
    for (int a = 0; a < DIM; ++a) {
      gz[a] += gzw * rec.w[a];
      gw[a] = gzw * rec.z[a];
#pragma unroll
      for (int b = 0; b < DIM; ++b) gLq[a][b] = gSq[a][b] = S(0);
#pragma unroll
      for (int k = 0; k < N; ++k) gHQ[a][k] = S(0);
    }
    ek1dl::cho_solve_vjp<S, DIM>(rec.Lq, rec.z, rec.w, gw, gz, gLq);
    S Sq[DIM][DIM];
    ek1::gram<S, DIM, N>(rec.HQ, Sq);
    ek1dl::chol_vjp<S, DIM>(Sq, rec.Lq, gLq, gSq);
    ek1dl::gram_vjp<S, DIM, N>(rec.HQ, gSq, gHQ);
#pragma unroll
    for (int a = 0; a < DIM; ++a)
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const S g = gHQ[a][k];
#pragma unroll
        for (int b = 0; b < DIM; ++b)
          gJ[a * DIM + b] -=
              g * (c.pinv0 * (q_live<DIM>(b, k) ? c.QLt[b / DIM][k / DIM]
                                                 : S(0)));
      }
  }
  // z = pinv1 mp[DIM + a] - f(u); J = J(u); u = pinv0 mp[0 .. DIM-1]
  S gdu[DIM], gu[DIM], guj[DIM];
#pragma unroll
  for (int a = 0; a < DIM; ++a) {
    if (r == DIM + a) gmp += c.pinv1 * gz[a];
    gdu[a] = -gz[a];
  }
  F().vjp(rec.u, p, t, gdu, gu, gp);
  F().jac_vjp(rec.u, p, t, gJ, guj, gp);
  if (r < DIM) gmp += c.pinv0 * (gu[r] + guj[r]);
  // mp = A m
  ws[W::GA + W::GM + r] = gmp;
  sync();
  S acc = S(0);
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (a_live<DIM>(i, r)) acc += c.At[i / DIM][r / DIM] * ws[W::GA + W::GM + i];
  gm = acc;
  sync();
}

}  // namespace ek1dlg
