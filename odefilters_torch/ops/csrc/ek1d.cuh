// Per-member bodies of the DiagonalEK1 kernels (ek1d.cu): the fixed-grid
// per-dimension step with plain covariances, one attempt of the adaptive
// loop with per-dimension factors, and the adaptive stream row. Their plain
// PyTorch versions, in the same order of operations, are in
// odefilters_torch/ops/ek1d.py (ek1d_pd_step) and ek1d_adaptive.py
// (attempt).
//
// DiagonalEK1 linearizes at the Jacobian diagonal J_jj (the field's
// jac_diag, fields.cuh): each member runs D independent NQ x NQ filters,
// dimension j measuring h_j = pinv1 e_1 - J_jj pinv0 e_0 with one dynamic
// diffusion shared by the dimensions. Every rounding follows the plain
// version's: products of constants are folded in double as its Python
// floats are, a division by a Python number is a product with its
// reciprocal (as PyTorch computes it on the card), and the files are built
// without FMA contraction.
#pragma once

#include "ek0_adaptive.cuh"

namespace ek1d {

using ek0::AdaptConsts;
using ek0::BX;
using ek0::floor_at;
using ek0::innovation;
using ek0::log_;
using ek0::LOG_2PI;
using ek0::sqrt_;

// Fixed-grid constants: the preconditioned IBM transition and noise (both
// rounded to the working type by the host), the preconditioner entries of
// blocks 0 and 1, the grid, and the products of constants the measurement
// row forms, folded in double: pinv1^2, pinv0 pinv1, pinv0^2 and
// hq1 = pinv1^2 Qt[1][1].
template <typename S, int NQ>
struct FixedConsts {
  S At[NQ][NQ], Qt[NQ][NQ];
  S pinv0, pinv1, t0, dt;
  S pb2, p01, p00, hq1;
};

// consts: At, Qt (NQ*NQ each), then pinv0, pinv1, t0, dt
template <typename S, int NQ>
inline FixedConsts<S, NQ> read_fixed_consts(const double* k) {
  FixedConsts<S, NQ> c;
  int o = 0;
  for (int i = 0; i < NQ; ++i)
    for (int l = 0; l < NQ; ++l) c.At[i][l] = S(k[o++]);
  for (int i = 0; i < NQ; ++i)
    for (int l = 0; l < NQ; ++l) c.Qt[i][l] = S(k[o++]);
  const double pinv0 = k[o++], pinv1 = k[o++];
  c.pinv0 = S(pinv0);
  c.pinv1 = S(pinv1);
  c.t0 = S(k[o++]);
  c.dt = S(k[o++]);
  c.pb2 = S(pinv1 * pinv1);
  c.p01 = S(pinv0 * pinv1);
  c.p00 = S(pinv0 * pinv0);
  c.hq1 = S(pinv1 * pinv1 * k[NQ * NQ + NQ + 1]);
  return c;
}

// h_j M h_j^T for the symmetric M's leading block m00, m01, m11 (a
// covariance's entries), in the plain version's order.
template <typename S, int NQ>
__device__ __forceinline__ S h_quad(const FixedConsts<S, NQ>& c, S jd, S m00,
                                    S m01, S m11) {
  return c.pb2 * m11 - S(2) * jd * c.p01 * m01 + jd * jd * c.p00 * m00;
}

// One fixed-grid DiagonalEK1 step (ek1d.py: ek1d_pd_step) from the
// committed per-dimension covariances C, in place: predict the mean,
// evaluate the field and its Jacobian diagonal at the predicted state,
// calibrate s2 (STATIC: s2 = 1, the unscaled prior), then per dimension
// predict the covariance and apply the R = 0 update C_new = Cp - k k^T s.
// Returns the step's log-likelihood increment; z and inv_s for the static
// diffusions' estimate.
template <typename S, int NQ, class F, bool STATIC>
__device__ __forceinline__ S fixed_step(const FixedConsts<S, NQ>& c,
                                        const S* p, S t, S (&m)[NQ][F::D],
                                        S (&C)[F::D][NQ][NQ], S (&z)[F::D],
                                        S (&inv_s)[F::D]) {
  constexpr int D = F::D;
  S mp[NQ][D];
  ek0::at_times<S, NQ, D>(c.At, m, mp);
  S u[D], du[D], jd[D];
#pragma unroll
  for (int j = 0; j < D; ++j) u[j] = c.pinv0 * mp[0][j];
  F()(u, p, t, du);
  F().jac_diag(u, p, t, jd);
#pragma unroll
  for (int j = 0; j < D; ++j) z[j] = innovation(c.pinv1, mp[1][j], du[j]);
  S s2 = S(1);
  if (!STATIC) {
    S acc = S(0);
#pragma unroll
    for (int j = 0; j < D; ++j) {
      // h_j Qt h_j^T with Qt's constant entries
      const S hq = (c.hq1 - S(2) * jd[j] * c.p01 * c.Qt[0][1]) +
                   jd[j] * jd[j] * c.p00 * c.Qt[0][0];
      acc += z[j] * z[j] / hq;
    }
    s2 = acc * (S(1) / S(D));
  }
  S ll_inc = S(0);
#pragma unroll
  for (int j = 0; j < D; ++j) {
    S tmp[NQ][NQ], Cp[NQ][NQ];
    ek0::at_times<S, NQ, NQ>(c.At, C[j], tmp);
#pragma unroll
    for (int i = 0; i < NQ; ++i)
#pragma unroll
      for (int l = 0; l < NQ; ++l) {
        S acc = S(0);
#pragma unroll
        for (int b = l; b < NQ; ++b) acc += tmp[i][b] * c.At[l][b];
        Cp[i][l] = acc + c.Qt[i][l] * s2;
      }
    const S s = h_quad<S, NQ>(c, jd[j], Cp[0][0], Cp[0][1], Cp[1][1]);
    inv_s[j] = S(1) / s;
    S kg[NQ];
#pragma unroll
    for (int i = 0; i < NQ; ++i)
      kg[i] = (c.pinv1 * Cp[i][1] - jd[j] * c.pinv0 * Cp[i][0]) * inv_s[j];
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      m[i][j] = mp[i][j] - kg[i] * z[j];
#pragma unroll
      for (int l = 0; l < NQ; ++l) C[j][i][l] = Cp[i][l] - kg[i] * kg[l] * s;
    }
    const S inc = S(-0.5) * (z[j] * z[j] * inv_s[j] +
                             log_(floor_at(s, S(1e-30))) + S(LOG_2PI));
    ll_inc = j == 0 ? inc : ll_inc + inc;
  }
  return ll_inc;
}

// The static diffusions' running estimate after one more step (kf previous
// steps) from the per-dimension statistics z_j^2 / s_j (ek0_pair.py:
// static_local_update with a list of 1/s_j): per dimension under fixedMV,
// else their mean through ek0's scalar update.
template <int MODE, typename S, int D>
__device__ __forceinline__ void static_update(S (&sig)[D], S kf,
                                              const S (&z)[D],
                                              const S (&inv_s)[D]) {
  if (MODE == ek0::FIXED_MV) {
    const S kmax = kf < S(1) ? S(1) : kf;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const S local = z[j] * z[j] * inv_s[j];
      const S cand = sig[j] + (local - sig[j]) / kmax;
      sig[j] = kf == S(0) ? local : cand;
    }
  } else if (MODE != ek0::DYNAMIC) {
    S local = S(0);
#pragma unroll
    for (int j = 0; j < D; ++j) local += z[j] * z[j] * inv_s[j];
    ek0::static_scalar_update<MODE, S, D>(sig[0], kf, local * (S(1) / S(D)));
  }
}

// Row of the adaptive stream: m (NQ*D) | L_0 .. L_{D-1} (NQ*NQ each,
// row-major) | log dt_eff | s2 | save index.
template <int NQ, int D>
struct Layout {
  static constexpr int V = NQ * D + D * NQ * NQ + 3;
};

// The adaptive member: m (NQ x D) and one factor per dimension,
// unpreconditioned.
template <typename S, int NQ, int D>
struct Member : ek0::Progress<S, D> {
  S m[NQ][D], L[D][NQ][NQ];
};

// One attempt of a live member (ek1d_adaptive.py: attempt): ek0::begin,
// one square-root DiagonalEK1(dynamic) step per dimension in the member's
// preconditioned frame (the prediction re-triangularised by modified
// Gram-Schmidt, the update L_new = Lp - k w^T with w = Lp^T h_j and
// k = Lp w / s), ek0::control, and the commit of the mean and the factors.
template <typename S, int NQ, class F>
__device__ __forceinline__ void attempt(const AdaptConsts<S, NQ>& c,
                                        const S* p, Member<S, NQ, F::D>& st,
                                        ek0::AttemptOut<S>& o) {
  constexpr int D = F::D;
  constexpr double QH = NQ - 0.5;  // q + 1/2
  S ps_[NQ];
  const ek0::Begin<S> a = ek0::begin<S, NQ, D>(c, st, ps_);
  S mh[NQ][D];
#pragma unroll
  for (int i = 0; i < NQ; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) mh[i][j] = st.m[i][j] * ps_[i];
  const S pinv0 = ek0::exp_(S(QH) * a.lh);
  const S pinv1 = ek0::exp_(S(QH - 1.0) * a.lh);

  // -- predict the mean; linearize --
  S mp[NQ][D];
  ek0::at_times<S, NQ, D>(c.At, mh, mp);
  S u[D], du[D], jd[D], z[D], hc0[D], hq[D];
#pragma unroll
  for (int j = 0; j < D; ++j) u[j] = pinv0 * mp[0][j];
  F()(u, p, a.t_new, du);
  F().jac_diag(u, p, a.t_new, jd);
#pragma unroll
  for (int j = 0; j < D; ++j) {
    z[j] = innovation(pinv1, mp[1][j], du[j]);
    // h_j = hc0 e_0 + pinv1 e_1, and h_j Qt h_j^T over its 2 x 2 block
    hc0[j] = -jd[j] * pinv0;
    hq[j] = hc0[j] * hc0[j] * c.Qh[0][0] + hc0[j] * pinv1 * c.Qh[0][1] +
            pinv1 * hc0[j] * c.Qh[1][0] + pinv1 * pinv1 * c.Qh[1][1];
  }
  // dynamic diffusion: sigma^2 = mean_j z_j^2 / (h_j Qt h_j^T)
  S s2 = S(0);
#pragma unroll
  for (int j = 0; j < D; ++j) s2 += z[j] * z[j] / hq[j];
  s2 = s2 * (S(1) / S(D));
  const S sq = sqrt_(s2);

  // -- per dimension: predict the factor, the scalar R = 0 update --
  S m_new[NQ][D], L_new[D][NQ][NQ], s[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    S Lh[NQ][NQ], Lp[NQ][NQ];
#pragma unroll
    for (int i = 0; i < NQ; ++i)
#pragma unroll
      for (int l = 0; l < NQ; ++l) Lh[i][l] = st.L[j][i][l] * ps_[i];
    ek0::predict_factor<S, NQ>(c, Lh, sq, Lp);
    S w[NQ];
#pragma unroll
    for (int l = 0; l < NQ; ++l) w[l] = hc0[j] * Lp[0][l] + pinv1 * Lp[1][l];
    S ss = S(0);
#pragma unroll
    for (int l = 0; l < NQ; ++l) ss += w[l] * w[l];
    s[j] = ss;
    const S inv_s = S(1) / ss;
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      S cc = S(0);
#pragma unroll
      for (int l = 0; l < NQ; ++l) cc += Lp[i][l] * w[l];
      const S kg = cc * inv_s;
      m_new[i][j] = mp[i][j] - kg * z[j];
#pragma unroll
      for (int l = 0; l < NQ; ++l) L_new[j][i][l] = Lp[i][l] - kg * w[l];
    }
  }
  S maha = S(0), logdet = S(0);
#pragma unroll
  for (int j = 0; j < D; ++j) maha += z[j] * z[j] / s[j];
#pragma unroll
  for (int j = 0; j < D; ++j) logdet += log_(floor_at(s[j], S(1e-30)));
  const S ll_inc = S(-0.5) * (maha + logdet + S(double(D) * LOG_2PI));
  S u_filt[D], err[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    u_filt[j] = pinv0 * m_new[0][j];
    // err_j = sqrt(s2 hq_j); control scales it by dt / sc_j
    err[j] = sqrt_(floor_at(s2 * hq[j], S(0)));
  }
  // -- un-precondition, then commit --
  if (ek0::control<S, NQ, D>(c, a, err, u_filt, ll_inc, st, o)) {
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j) st.m[i][j] = m_new[i][j] / ps_[i];
#pragma unroll
      for (int j = 0; j < D; ++j)
#pragma unroll
        for (int l = 0; l < NQ; ++l) st.L[j][i][l] = L_new[j][i][l] / ps_[i];
    }
  }
  o.lh = a.lh;
  o.s2 = s2;
}

template <typename S, int NQ, int NP, int D>
__device__ __forceinline__ void start_member(const S* __restrict__ m0,
                                             const S* __restrict__ ps,
                                             const S* __restrict__ dt0s,
                                             int b, size_t sB,
                                             const AdaptConsts<S, NQ>& c,
                                             S (&p)[NP],
                                             Member<S, NQ, D>& st) {
#pragma unroll
  for (int k = 0; k < NP; ++k) p[k] = ps[k * sB + b];
#pragma unroll
  for (int i = 0; i < NQ; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) st.m[i][j] = m0[(i * D + j) * sB + b];
#pragma unroll
  for (int j = 0; j < D; ++j)
#pragma unroll
    for (int i = 0; i < NQ; ++i)
#pragma unroll
      for (int l = 0; l < NQ; ++l) st.L[j][i][l] = S(0);
  ek0::start_progress<S, NQ, D>(st.m, dt0s, b, c, st);
}

template <typename S, int NQ, int D>
__device__ __forceinline__ void store_row(S* __restrict__ st, size_t row0,
                                          size_t sB,
                                          const Member<S, NQ, D>& mb, S lh,
                                          S s2, S mark) {
  int v = 0;
#pragma unroll
  for (int i = 0; i < NQ; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) st[row0 + (v++) * sB] = mb.m[i][j];
#pragma unroll
  for (int j = 0; j < D; ++j)
#pragma unroll
    for (int i = 0; i < NQ; ++i)
#pragma unroll
      for (int l = 0; l < NQ; ++l) st[row0 + (v++) * sB] = mb.L[j][i][l];
  st[row0 + (v++) * sB] = lh;
  st[row0 + (v++) * sB] = s2;
  st[row0 + v * sB] = mark;
}

// Dimension j's columns of stream row row0 as the EK0 smoother's row of
// one dimension: m[:, j], L_j, log dt_eff, s2, save index.
template <typename S, int NQ, int D>
__device__ __forceinline__ void load_dim_row(const S* __restrict__ st,
                                             size_t row0, size_t sB, int j,
                                             ek0::AdaptRow<S, NQ, 1>& r) {
  constexpr int V = Layout<NQ, D>::V;
#pragma unroll
  for (int i = 0; i < NQ; ++i) r.m[i][0] = st[row0 + (i * D + j) * sB];
  const int o = NQ * D + j * NQ * NQ;
#pragma unroll
  for (int i = 0; i < NQ; ++i)
#pragma unroll
    for (int l = 0; l < NQ; ++l)
      r.L[i][l] = st[row0 + (o + i * NQ + l) * sB];
  r.lh = st[row0 + (V - 3) * sB];
  r.s2 = st[row0 + (V - 2) * sB];
  r.mark = st[row0 + (V - 1) * sB];
}

}  // namespace ek1d
