// Per-member bodies of the adaptive EK0 kernels (ek0_adaptive.cu): one
// attempt of the PI-controlled EK0(dynamic) step loop, the accepted-step
// stream row, one square-root RTS step over a member's accepted steps, and
// the sampler's terminal draw and conditioning step, with the parts the
// DiagonalEK1 and EK1 kernels (ek1d.cu, ek1_adaptive.cu) share: an
// attempt's begin and control, the factor's prediction and the backward
// walk (smooth_member). Their plain PyTorch versions, in the same order of
// operations, are in odefilters_torch/ops/ek0_adaptive.py (attempt, begin,
// control, predict_factor, backward_shared, conditioned_mean,
// smoother_step, ek0_adaptive_smoother_plain) and ek0_adaptive_sample.py
// (list_cholesky, terminal_draw, sampler_step).
//
// The state is carried unpreconditioned and preconditioned afresh at each
// attempt's step size, as in the JAX kernels, but the covariance is carried
// as a factor L (C = L L^T, not triangular), re-triangularised by modified
// Gram-Schmidt at each prediction: the JAX kernels' plain covariance loses
// its positive definiteness in float32. The adaptive loop turns a one-ulp
// difference anywhere into another accepted step sequence on about one
// member in a hundred, so every rounding follows the plain version's. Divisions by a constant are products with
// its reciprocal folded in double (as the plain version writes them), the
// transcendentals are the CUDA math library's exp / log (those of
// PyTorch's exp / log on the card), and min / max / clamp keep a NaN as
// PyTorch's do.
#pragma once

#include "ek0_filter.cuh"
#include "ek0_sample.cuh"

namespace ek0 {

// OrdinaryDiffEq's PI controller constants
constexpr double GAMMA = 0.9, QMIN = 0.2, QMAX = 10.0, QOLDINIT = 1e-4;

template <typename S>
__device__ __forceinline__ S exp_(S x);
template <>
__device__ __forceinline__ float exp_(float x) { return expf(x); }
template <>
__device__ __forceinline__ double exp_(double x) { return exp(x); }

// torch.maximum / torch.minimum / torch.clamp: a NaN operand gives NaN
template <typename S>
__device__ __forceinline__ S max_(S a, S b) {
  return (a != a || a > b) ? a : b;
}
template <typename S>
__device__ __forceinline__ S min_(S a, S b) {
  return (a != a || a < b) ? a : b;
}
template <typename S>
__device__ __forceinline__ S clamp_(S x, S lo, S hi) {
  return x != x ? x : (x < lo ? lo : (x > hi ? hi : x));
}

// Constants of the adaptive kernels: the preconditioned IBM transition
// (upper triangular), its noise factor QLt (lower triangular), the measured
// entry qbx = (QLt QLt^T)[BX][BX] and the leading 2 x 2 block Qh of
// QLt QLt^T (the DiagonalEK1 measurement rows see it), the save grid, the
// tolerances, the smallest step and the controller's exponents; the counts
// are the kernels' int arguments.
template <typename S, int NQ>
struct AdaptConsts {
  S At[NQ][NQ], QLt[NQ][NQ];
  S qbx, t0, dt_save, abstol, reltol, dtmin, beta1, beta2;
  S Qh[2][2];
  int n_save, max_iters;
};

// consts: At, QLt (NQ*NQ each), then qbx, t0, dt_save, abstol, reltol,
// dtmin, beta1, beta2, Qh (row-major)
template <typename S, int NQ>
inline AdaptConsts<S, NQ> read_adapt_consts(const double* k, int n_save,
                                            int max_iters) {
  AdaptConsts<S, NQ> c;
  int o = 0;
  for (int i = 0; i < NQ; ++i)
    for (int l = 0; l < NQ; ++l) c.At[i][l] = S(k[o++]);
  for (int i = 0; i < NQ; ++i)
    for (int l = 0; l < NQ; ++l) c.QLt[i][l] = S(k[o++]);
  c.qbx = S(k[o++]);
  c.t0 = S(k[o++]);
  c.dt_save = S(k[o++]);
  c.abstol = S(k[o++]);
  c.reltol = S(k[o++]);
  c.dtmin = S(k[o++]);
  c.beta1 = S(k[o++]);
  c.beta2 = S(k[o++]);
  for (int i = 0; i < 2; ++i)
    for (int l = 0; l < 2; ++l) c.Qh[i][l] = S(k[o++]);
  c.n_save = n_save;
  c.max_iters = max_iters;
  return c;
}

// Row of the accepted-step stream: m (NQ*D) | L (NQ*NQ, row-major) |
// log dt_eff | s2 | save index (seg + 1 where the step reached save point
// seg + 1, else 0).
template <int NQ, int D>
struct AdaptLayout {
  static constexpr int V = NQ * D + NQ * NQ + 3;
};

// A member's loop state besides its mean and covariance factor(s): the
// previous accepted solution, time, step, controller memory,
// log-likelihood, save points reached, accepted and rejected attempts.
template <typename S, int D>
struct Progress {
  S u_prev[D];
  S t, dt, qold, ll;
  int seg, nacc, nrej;
  bool failed;

  template <int NQ>
  __device__ __forceinline__ bool live(const AdaptConsts<S, NQ>& c) const {
    return !failed && seg < c.n_save && nacc + nrej < c.max_iters;
  }
};

// The EK0 member: m (NQ x D) and the factor L (NQ x NQ), unpreconditioned.
template <typename S, int NQ, int D>
struct Member : Progress<S, D> {
  S m[NQ][D], L[NQ][NQ];
};

// The factor Lp (lower) of [(At Lh)^T; (sq QLt)^T]: row NQ + a of the
// stack is zero in the columns i < a.
template <typename S, int NQ>
__device__ __forceinline__ void predict_factor(const AdaptConsts<S, NQ>& c,
                                               const S (&Lh)[NQ][NQ], S sq,
                                               S (&Lp)[NQ][NQ]) {
  S AtL[NQ][NQ];
  at_times<S, NQ, NQ>(c.At, Lh, AtL);
  S v[2 * NQ][NQ];
#pragma unroll
  for (int k = 0; k < NQ; ++k)
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      v[k][i] = AtL[i][k];
      v[NQ + k][i] = i >= k ? sq * c.QLt[i][k] : S(0);
    }
  mgs_tril<S, NQ, 2 * NQ, true>(v, Lp);
}

template <typename S, int NQ>
__device__ __forceinline__ S std_row0(const S (&L)[NQ][NQ]) {
  S acc = S(0);
#pragma unroll
  for (int l = 0; l < NQ; ++l) acc += L[0][l] * L[0][l];
  return sqrt_(acc);
}

template <typename S>
struct AttemptOut {
  bool accept, reached;  // reached: an accepted step at save point seg + 1
  int seg_before;
  S lh, s2;
};

// The start of an attempt (ek0_adaptive.py: begin), shared by the EK0 and
// DiagonalEK1 loops: the next save time, whether the member is active, the
// attempt's step (truncated to land on the save point), its log, the
// preconditioner ps_ at that step and the new time.
template <typename S>
struct Begin {
  S t_save, dt_eff, lh, t_new;
  bool active, hit_save;
};

template <typename S, int NQ, int D>
__device__ __forceinline__ Begin<S> begin(const AdaptConsts<S, NQ>& c,
                                          const Progress<S, D>& st,
                                          S (&ps_)[NQ]) {
  constexpr double QH = NQ - 0.5;  // q + 1/2
  Begin<S> a;
  const S t = st.t, dt = st.dt;
  a.t_save = c.t0 + c.dt_save * (S(st.seg) + S(1));
  a.active = t < a.t_save;
  const S remaining = a.t_save - t;
  a.hit_save = dt >= remaining;
  a.dt_eff = a.active ? (a.hit_save ? remaining : dt) : S(1);
  // -- precondition at this attempt's h (fresh from canonical) --
  a.lh = log_(a.dt_eff);
#pragma unroll
  for (int i = 0; i < NQ; ++i) ps_[i] = exp_(S(i - QH) * a.lh);
  a.t_new = a.hit_save ? a.t_save : t + a.dt_eff;
  return a;
}

// The end of an attempt (ek0_adaptive.py: control), shared by the EK0 and
// DiagonalEK1 loops: the error estimate from the per-dimension unscaled
// errors err and the filtered solution u_filt, the per-member PI
// controller, the failure checks, and the commit of everything but the mean
// and the covariance factor. Returns accept; fills o but lh and s2.
template <typename S, int NQ, int D>
__device__ __forceinline__ bool control(const AdaptConsts<S, NQ>& c,
                                        const Begin<S>& a, const S (&err)[D],
                                        const S (&u_filt)[D], S ll_inc,
                                        Progress<S, D>& st,
                                        AttemptOut<S>& o) {
  const S inv_d = S(1) / S(D);
  S ee = S(0);
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const S sc =
        c.abstol + c.reltol * max_(fabs(st.u_prev[j]), fabs(u_filt[j]));
    const S r = a.dt_eff * err[j] / sc;
    ee += r * r;
  }
  S EEst = sqrt_(ee * inv_d);
  if (!(EEst - EEst == S(0))) EEst = S(1e10);  // not finite
  const bool accept = a.active && EEst <= S(1);

  // -- per-member PI controller --
  const S inv_gamma = S(1.0 / GAMMA);
  const S leg = log_(floor_at(EEst, S(1e-35)));
  const S q11 = exp_(c.beta1 * leg);
  S qq = q11 * exp_(-c.beta2 * log_(floor_at(st.qold, S(1e-35))));
  qq = clamp_(qq * inv_gamma, S(1.0 / QMAX), S(1.0 / QMIN));
  S dt_acc = a.dt_eff / qq;
  // a step truncated to land on a save point must not collapse the
  // controller's step size
  if (a.hit_save && st.seg < c.n_save - 1) dt_acc = max_(dt_acc, st.dt);
  const S qold_acc = floor_at(EEst, S(QOLDINIT));
  const S dt_rej = a.dt_eff / min_(q11 * inv_gamma, S(1.0 / QMIN));
  const S dt_new = accept ? dt_acc : dt_rej;
  // a member fails when its next dt collapses below dtmin (accepted or
  // not) or when an accepted step makes no floating-point progress
  const bool failed =
      st.failed || (a.active && !a.hit_save &&
                    (dt_new < c.dtmin || (accept && a.t_new <= st.t)));

  if (accept) {
    st.t = a.t_new;
    st.qold = qold_acc;
    st.ll = st.ll + ll_inc;
#pragma unroll
    for (int j = 0; j < D; ++j) st.u_prev[j] = u_filt[j];
    st.nacc += 1;
  } else if (a.active) {
    st.nrej += 1;
  }
  if (a.active && !failed) st.dt = dt_new;
  st.failed = failed;
  o.accept = accept;
  o.seg_before = st.seg;
  o.reached = accept && st.t >= a.t_save;
  if (o.reached) st.seg += 1;
  return accept;
}

// One attempt of a live member (ek0_adaptive.py: attempt): begin, one
// square-root EK0(dynamic) step in the member's preconditioned frame,
// control, and the commit of the mean and the factor.
template <typename S, int NQ, class F>
__device__ __forceinline__ void attempt(const AdaptConsts<S, NQ>& c,
                                        const S* p, Member<S, NQ, F::D>& st,
                                        AttemptOut<S>& o) {
  constexpr int D = F::D;
  constexpr double QH = NQ - 0.5;  // q + 1/2
  S ps_[NQ];
  const Begin<S> a = begin<S, NQ, D>(c, st, ps_);
  S mh[NQ][D], Lh[NQ][NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) mh[i][j] = st.m[i][j] * ps_[i];
#pragma unroll
    for (int l = 0; l < NQ; ++l) Lh[i][l] = st.L[i][l] * ps_[i];
  }
  const S pinv0 = exp_(S(QH) * a.lh);
  const S pb = exp_(S(QH - BX) * a.lh);
  const S hq = pb * pb * c.qbx;

  S mp[NQ][D];
  at_times<S, NQ, D>(c.At, mh, mp);
  S u[D], du[D], z[D];
#pragma unroll
  for (int j = 0; j < D; ++j) u[j] = pinv0 * mp[0][j];
  F()(u, p, a.t_new, du);
#pragma unroll
  for (int j = 0; j < D; ++j) z[j] = innovation(pb, mp[BX][j], du[j]);
  S zz = S(0);
#pragma unroll
  for (int j = 0; j < D; ++j) zz += z[j] * z[j];
  const S s2 = zz / (S(D) * hq);
  S Lp[NQ][NQ];
  predict_factor<S, NQ>(c, Lh, sqrt_(s2), Lp);
  S s = S(0);
#pragma unroll
  for (int l = 0; l < NQ; ++l) s += Lp[BX][l] * Lp[BX][l];
  s = pb * pb * s;
  const S inv_s = S(1) / s;
  S kg[NQ], zrow[NQ], m_new[NQ][D], L_new[NQ][NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    S cc = S(0);
#pragma unroll
    for (int l = 0; l < NQ; ++l) cc += Lp[i][l] * Lp[BX][l];
    kg[i] = pb * cc * inv_s;
    zrow[i] = pb * Lp[BX][i];
  }
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) m_new[i][j] = mp[i][j] - kg[i] * z[j];
#pragma unroll
    for (int l = 0; l < NQ; ++l) L_new[i][l] = Lp[i][l] - kg[i] * zrow[l];
  }
  const S ll_inc = ll_increment<S, D>(zz, s, inv_s);
  S u_filt[D];
#pragma unroll
  for (int j = 0; j < D; ++j) u_filt[j] = pinv0 * m_new[0][j];

  // -- error estimate (EK0 dynamic: sqrt(s2 hq) == sqrt(zz/D)) --
  S err[D];
  const S err_all = sqrt_(zz * (S(1) / S(D)));
#pragma unroll
  for (int j = 0; j < D; ++j) err[j] = err_all;
  // -- un-precondition, then commit --
  if (control<S, NQ, D>(c, a, err, u_filt, ll_inc, st, o)) {
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j) st.m[i][j] = m_new[i][j] / ps_[i];
#pragma unroll
      for (int l = 0; l < NQ; ++l) st.L[i][l] = L_new[i][l] / ps_[i];
    }
  }
  o.lh = a.lh;
  o.s2 = s2;
}

// The member's progress at the start: u_prev = m[0], t = t0, dt = dt0.
template <typename S, int NQ, int D>
__device__ __forceinline__ void start_progress(const S (&m)[NQ][D],
                                               const S* __restrict__ dt0s,
                                               int b,
                                               const AdaptConsts<S, NQ>& c,
                                               Progress<S, D>& st) {
#pragma unroll
  for (int j = 0; j < D; ++j) st.u_prev[j] = m[0][j];
  st.t = c.t0;
  st.dt = dt0s[b];
  st.qold = S(QOLDINIT);
  st.ll = S(0);
  st.seg = st.nacc = st.nrej = 0;
  st.failed = false;
}

template <typename S, int NQ, int NP, int D>
__device__ __forceinline__ void start_member(const S* __restrict__ m0,
                                             const S* __restrict__ ps,
                                             const S* __restrict__ dt0s,
                                             int b, size_t sB,
                                             const AdaptConsts<S, NQ>& c,
                                             S (&p)[NP],
                                             Member<S, NQ, D>& st) {
  load_member<S, NQ, NP, D>(m0, ps, b, sB, p, st.m, st.L);
  start_progress<S, NQ, D>(st.m, dt0s, b, c, st);
}

// counts (4, B): nacc, nrej, failed (a failure, or save points left),
// save points reached
template <typename S, int D>
__device__ __forceinline__ void store_counts(int* __restrict__ counts, int b,
                                             size_t sB,
                                             const Progress<S, D>& st,
                                             int n_save) {
  counts[b] = st.nacc;
  counts[sB + b] = st.nrej;
  counts[2 * sB + b] = (st.failed || st.seg < n_save) ? 1 : 0;
  counts[3 * sB + b] = st.seg;
}

template <typename S, int NQ, int D>
__device__ __forceinline__ void store_adapt_row(S* __restrict__ st,
                                                size_t row0, size_t sB,
                                                const S (&m)[NQ][D],
                                                const S (&L)[NQ][NQ], S lh,
                                                S s2, S mark) {
  int v = 0;
#pragma unroll
  for (int i = 0; i < NQ; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) st[row0 + (v++) * sB] = m[i][j];
#pragma unroll
  for (int i = 0; i < NQ; ++i)
#pragma unroll
    for (int l = 0; l < NQ; ++l) st[row0 + (v++) * sB] = L[i][l];
  st[row0 + (v++) * sB] = lh;
  st[row0 + (v++) * sB] = s2;
  st[row0 + v * sB] = mark;
}

// A stream row: m, L, log dt_eff, s2, save index.
template <typename S, int NQ, int D>
struct AdaptRow {
  S m[NQ][D], L[NQ][NQ];
  S lh, s2, mark;
};

template <typename S, int NQ, int D>
__device__ __forceinline__ void load_adapt_row(const S* __restrict__ st,
                                               size_t row0, size_t sB,
                                               AdaptRow<S, NQ, D>& r) {
  int v = 0;
#pragma unroll
  for (int i = 0; i < NQ; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) r.m[i][j] = st[row0 + (v++) * sB];
#pragma unroll
  for (int i = 0; i < NQ; ++i)
#pragma unroll
    for (int l = 0; l < NQ; ++l) r.L[i][l] = st[row0 + (v++) * sB];
  r.lh = st[row0 + (v++) * sB];
  r.s2 = st[row0 + (v++) * sB];
  r.mark = st[row0 + v * sB];
}

// The part of a backward step from the filtered state (m_f, L_f) of an
// accepted step that the smoother and the sampler share
// (ek0_adaptive.py: backward_shared), in the frame preconditioned at the
// next accepted step's lh (log dt_eff) with its s2: the preconditioner ps_,
// the preconditioned mean mh_f, the gain G = Ch_f At^T (Lp Lp^T)^-1 (Lp
// recomputed by the forward's MGS), the predicted mean mp, and the first
// 2 NQ rows of the stack: row l holds column l of (I - G At) Lh_f, row
// NQ + l column l of sq G QLt. Lh_f is the filtered factor with its rows
// scaled (no Cholesky factorisation).
template <typename S, int NQ, int D, int K>
__device__ __forceinline__ void backward_shared(
    const AdaptConsts<S, NQ>& c, const S (&m_f)[NQ][D],
    const S (&L_f)[NQ][NQ], S lh, S s2, S (&ps_)[NQ], S (&mh_f)[NQ][D],
    S (&G)[NQ][NQ], S (&mp)[NQ][D], S (&v)[K][NQ]) {
  constexpr double QH = NQ - 0.5;
#pragma unroll
  for (int i = 0; i < NQ; ++i) ps_[i] = exp_(S(i - QH) * lh);
  S Lh[NQ][NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
#pragma unroll
    for (int l = 0; l < NQ; ++l) Lh[i][l] = L_f[i][l] * ps_[i];
#pragma unroll
    for (int j = 0; j < D; ++j) mh_f[i][j] = m_f[i][j] * ps_[i];
  }
  const S sq = sqrt_(s2);
  S AtL[NQ][NQ], Lp[NQ][NQ];
  at_times<S, NQ, NQ>(c.At, Lh, AtL);
  predict_factor<S, NQ>(c, Lh, sq, Lp);
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    S M[NQ];
#pragma unroll
    for (int l = 0; l < NQ; ++l) {
      S acc = S(0);
#pragma unroll
      for (int b = 0; b < NQ; ++b) acc += Lh[i][b] * AtL[l][b];
      M[l] = acc;
    }
    cho_solve<S, NQ>(Lp, M, G[i]);
  }
  at_times<S, NQ, D>(c.At, mh_f, mp);
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    S IGA[NQ];
#pragma unroll
    for (int l = 0; l < NQ; ++l) {
      S ga = S(0);
#pragma unroll
      for (int a = 0; a <= l; ++a) ga += G[i][a] * c.At[a][l];
      IGA[l] = (i == l ? S(1) : S(0)) - ga;
    }
#pragma unroll
    for (int l = 0; l < NQ; ++l) {
      S b1 = S(0), gq = S(0);
#pragma unroll
      for (int a = 0; a < NQ; ++a) b1 += IGA[a] * Lh[a][l];
#pragma unroll
      for (int a = l; a < NQ; ++a) gq += G[i][a] * c.QLt[a][l];
      v[l][i] = b1;
      v[NQ + l][i] = sq * gq;
    }
  }
}

// mh_f + G (x ps_ - mp), the conditioned mean of one column j in the
// preconditioned frame, summed as the plain version sums it.
template <typename S, int NQ, int D>
__device__ __forceinline__ S conditioned_mean(const S (&mh_f)[NQ][D],
                                              const S (&G)[NQ][NQ],
                                              const S (&mp)[NQ][D],
                                              const S (&ps_)[NQ],
                                              const S (&x)[NQ][D], int i,
                                              int j) {
  S acc = S(0);
#pragma unroll
  for (int l = 0; l < NQ; ++l) acc += G[i][l] * (x[l][j] * ps_[l] - mp[l][j]);
  return mh_f[i][j] + acc;
}

// One square-root RTS step (ek0_adaptive.py: smoother_step) from the
// filtered state (m_f, L_f) of an accepted step to the smoothed (ms, Ls) of
// the next one, with the next step's lh (log dt_eff) and s2, in place, in
// the frame preconditioned at the next step's size (the filtered factor's
// rows scaled).
template <typename S, int NQ, int D>
__device__ __forceinline__ void smoother_step(const AdaptConsts<S, NQ>& c,
                                              const S (&m_f)[NQ][D],
                                              const S (&L_f)[NQ][NQ], S lh,
                                              S s2, S (&ms)[NQ][D],
                                              S (&Ls)[NQ][NQ]) {
  constexpr double QH = NQ - 0.5;
  S ps_[NQ], mh_f[NQ][D], G[NQ][NQ], mp[NQ][D];
  // the stack's rows 2 NQ + l: column l of G Lsh
  S v[3 * NQ][NQ];
  backward_shared<S, NQ, D, 3 * NQ>(c, m_f, L_f, lh, s2, ps_, mh_f, G, mp, v);
  S ms_new[NQ][D];
#pragma unroll
  for (int i = 0; i < NQ; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j)
      ms_new[i][j] = conditioned_mean<S, NQ, D>(mh_f, G, mp, ps_, ms, i, j);
  S Lsh[NQ][NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i)
#pragma unroll
    for (int l = 0; l < NQ; ++l) Lsh[i][l] = ps_[i] * Ls[i][l];
#pragma unroll
  for (int i = 0; i < NQ; ++i)
#pragma unroll
    for (int l = 0; l < NQ; ++l) {
      S b3 = S(0);
#pragma unroll
      for (int a = 0; a < NQ; ++a) b3 += G[i][a] * Lsh[a][l];
      v[2 * NQ + l][i] = b3;
    }
  S Ls_new[NQ][NQ];
  mgs_tril<S, NQ, 3 * NQ, false>(v, Ls_new);
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    const S pinv = exp_(S(QH - i) * lh);
#pragma unroll
    for (int j = 0; j < D; ++j) ms[i][j] = pinv * ms_new[i][j];
#pragma unroll
    for (int l = 0; l < NQ; ++l) Ls[i][l] = pinv * Ls_new[i][l];
  }
}

// Lower Cholesky factor of the symmetric C with row and column ZR
// structurally zero (ek0_adaptive_sample.py: list_cholesky): the R = 0
// update collapses the measured block to zero variance up to rounding, and
// a guarded pivot would turn that rounding into an arbitrary direction.
// Pivots sqrt(max(s, 1e-30)), the entries below times their reciprocals;
// every term through row or column ZR is skipped.
template <typename S, int NQ, int ZR>
__device__ __forceinline__ void cholesky_zero_row(const S (&C)[NQ][NQ],
                                                  S (&L)[NQ][NQ]) {
#pragma unroll
  for (int i = 0; i < NQ; ++i)
#pragma unroll
    for (int l = 0; l < NQ; ++l) L[i][l] = S(0);
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    if (i == ZR) continue;
    S s = C[i][i];
#pragma unroll
    for (int k = 0; k < i; ++k)
      if (k != ZR) s = s - L[i][k] * L[i][k];
    L[i][i] = sqrt_(floor_at(s, S(1e-30)));
    const S inv = S(1) / L[i][i];
#pragma unroll
    for (int l = i + 1; l < NQ; ++l) {
      if (l == ZR) continue;
      S v = C[l][i];
#pragma unroll
      for (int k = 0; k < i; ++k)
        if (k != ZR) v = v - L[l][k] * L[i][k];
      L[l][i] = v * inv;
    }
  }
}

// The terminal draw of the adaptive sampler (ek0_adaptive_sample.py:
// terminal_draw) at a member's last accepted step (m, L, lh):
// x = m + pinv chol0(P L L^T P) z with P = diag(ps_) at lh and chol0 the
// Cholesky factor with the measured block BX structurally zero, for the
// samples s < ns of the chunk; z(s, l, j) reads a normal.
template <typename S, int NQ, int D, int SC, class Z>
__device__ __forceinline__ void terminal_draw(const S (&m)[NQ][D],
                                              const S (&L)[NQ][NQ], S lh,
                                              int ns, Z z,
                                              S (&x)[SC][NQ][D]) {
  constexpr double QH = NQ - 0.5;
  S Lh[NQ][NQ], C[NQ][NQ], Lc[NQ][NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    const S p = exp_(S(i - QH) * lh);
#pragma unroll
    for (int l = 0; l < NQ; ++l) Lh[i][l] = L[i][l] * p;
  }
#pragma unroll
  for (int i = 0; i < NQ; ++i)
#pragma unroll
    for (int l = 0; l < NQ; ++l) {
      S acc = S(0);
#pragma unroll
      for (int b = 0; b < NQ; ++b) acc += Lh[i][b] * Lh[l][b];
      C[i][l] = acc;
    }
  cholesky_zero_row<S, NQ, BX>(C, Lc);
#pragma unroll
  for (int s = 0; s < SC; ++s) {
    if (s >= ns) continue;
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const S pinv = exp_(S(QH - i) * lh);
#pragma unroll
      for (int j = 0; j < D; ++j) {
        S acc = S(0);
#pragma unroll
        for (int l = 0; l <= i; ++l)
          if (i != BX && l != BX) acc += Lc[i][l] * z(s, l, j);
        x[s][i][j] = m[i][j] + pinv * acc;
      }
    }
  }
}

// One backward conditioning step of the adaptive sampler
// (ek0_adaptive_sample.py: sampler_step): the samples s < ns of the chunk,
// drawn at the next accepted step, conditioned on the filtered state
// (m_f, L_f) with the next step's lh and s2 and re-drawn from the
// conditional factor Lc (the smoothing stack without its G Ls block):
// x = pinv ((mh_f + G (x ps_ - mp)) + Lc z), in place.
template <typename S, int NQ, int D, int SC, class Z>
__device__ __forceinline__ void sampler_step(const AdaptConsts<S, NQ>& c,
                                             const S (&m_f)[NQ][D],
                                             const S (&L_f)[NQ][NQ], S lh,
                                             S s2, int ns, Z z,
                                             S (&x)[SC][NQ][D]) {
  constexpr double QH = NQ - 0.5;
  S ps_[NQ], mh_f[NQ][D], G[NQ][NQ], mp[NQ][D], Lc[NQ][NQ];
  {
    S v[2 * NQ][NQ];
    backward_shared<S, NQ, D, 2 * NQ>(c, m_f, L_f, lh, s2, ps_, mh_f, G, mp,
                                      v);
    mgs_tril<S, NQ, 2 * NQ, false>(v, Lc);
  }
#pragma unroll
  for (int s = 0; s < SC; ++s) {
    if (s >= ns) continue;
    S xn[NQ][D];
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const S pinv = exp_(S(QH - i) * lh);
#pragma unroll
      for (int j = 0; j < D; ++j) {
        S lz = S(0);
#pragma unroll
        for (int l = 0; l <= i; ++l) lz += Lc[i][l] * z(s, l, j);
        xn[i][j] =
            pinv * (conditioned_mean<S, NQ, D>(mh_f, G, mp, ps_, x[s], i, j) +
                    lz);
      }
    }
#pragma unroll
    for (int i = 0; i < NQ; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) x[s][i][j] = xn[i][j];
  }
}

// The backward pass of one member (ek0_adaptive.py:
// ek0_adaptive_smoother_plain) over its K accepted rows, rows K - 1 .. 0:
// load(k, r) reads row k into an AdaptRow of DM mean columns, emit(k, m0row,
// std) writes save row k. Row 0 is the exact initial state first with std
// 0, each save row the smoothed state of the step that reached it, the rows
// past the segs save points reached the final state.
template <typename S, int NQ, int DM, class Load, class Emit>
__device__ __forceinline__ void smooth_member(const AdaptConsts<S, NQ>& c,
                                              int K, int segs,
                                              const S (&first)[DM], Load load,
                                              Emit emit) {
  emit(0, first, S(0));
  if (K == 0) {
    for (int k = 1; k <= c.n_save; ++k) emit(k, first, S(0));
    return;
  }
  AdaptRow<S, NQ, DM> r;
  load(K - 1, r);
  // the last accepted step: smoothed = filtered
  S ms[NQ][DM], Ls[NQ][NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
#pragma unroll
    for (int j = 0; j < DM; ++j) ms[i][j] = r.m[i][j];
#pragma unroll
    for (int l = 0; l < NQ; ++l) Ls[i][l] = r.L[i][l];
  }
  {
    const S std = std_row0<S, NQ>(Ls);
    for (int k = segs + 1; k <= c.n_save; ++k) emit(k, ms[0], std);
  }
  if (r.mark > S(0.5)) emit((int)r.mark, ms[0], std_row0<S, NQ>(Ls));
  S pend_lh = r.lh, pend_s2 = r.s2;
  for (int k = K - 2; k >= 0; --k) {
    load(k, r);
    smoother_step<S, NQ, DM>(c, r.m, r.L, pend_lh, pend_s2, ms, Ls);
    pend_lh = r.lh;
    pend_s2 = r.s2;
    if (r.mark > S(0.5)) emit((int)r.mark, ms[0], std_row0<S, NQ>(Ls));
  }
}

}  // namespace ek0
