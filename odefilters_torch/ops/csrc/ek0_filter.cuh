// Per-member bodies of the fused EK0 filter kernels (ek0_filter.cu): the
// primal filter with its static-diffusion estimates, the gradient's
// streaming forward, and the adjoint sweep with the hand-written reverse of
// one collapsed step. Their plain PyTorch versions are in
// odefilters_torch/ops/ek0_filter.py.
#pragma once

#include "ek0_common.cuh"

namespace ek0 {

// diffusion models of the primal filter (the C entry points' mode)
enum Mode { DYNAMIC = 0, FIXED = 1, FIXED_MAP = 2, FIXED_MV = 3 };

constexpr double LOG_2PI = 1.8378770664093453;  // log(2 pi)

// per-member data log-likelihood increment log N(z; 0, s I_D)
template <typename S, int D>
__device__ __forceinline__ S ll_increment(S zz, S s, S inv_s) {
  return S(-0.5) *
         (zz * inv_s + S(D) * (log_(floor_at(s, S(1e-30))) + S(LOG_2PI)));
}

// Running static-diffusion estimate after one more step (kf previous
// steps): the MLE (fixed: scalar, fixedMV: per dimension) or the online
// InverseGamma(1/2, 1/2) MAP (fixedMAP). Scalar models use sig[0].
template <int MODE, typename S, int D>
__device__ __forceinline__ void static_update(S (&sig)[D], S kf, S zz,
                                              const S (&z)[D], S inv_s) {
  const S kmax = kf < S(1) ? S(1) : kf;
  if (MODE == FIXED_MV) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const S local = z[j] * z[j] * inv_s;
      const S cand = sig[j] + (local - sig[j]) / kmax;
      sig[j] = kf == S(0) ? local : cand;
    }
  } else if (MODE == FIXED) {
    const S local = zz * inv_s * (S(1) / S(D));
    const S cand = sig[0] + (local - sig[0]) / kmax;
    sig[0] = kf == S(0) ? local : cand;
  } else if (MODE == FIXED_MAP) {
    const S alpha = S(0.5), beta = S(0.5);
    const S local = zz * inv_s * (S(1) / S(D));
    const S N = kf + S(1);
    const S den = alpha + N * S(D) * S(0.5) + S(1);
    const S first = (beta + S(0.5) * local) / den;
    const S res_prev =
        (sig[0] * (alpha + (N - S(1)) * S(D) * S(0.5) + S(1)) - beta) * S(2);
    const S later = (beta + S(0.5) * (res_prev + local)) / den;
    sig[0] = kf == S(0) ? first : later;
  }
}

// Primal filter of member b: us (T+1, D, B), raw variances C[0][0]
// var (T+1, B) with var[0] = 0, the summed log-likelihood lls (B,) and,
// under a static model, the final estimate sig ((B,), or (D, B) for
// fixedMV).
template <typename S, int NQ, class F, int MODE>
__device__ __forceinline__ void filter_member(
    int b, int B, int T, const S* __restrict__ m0, const S* __restrict__ ps,
    S* __restrict__ us, S* __restrict__ var, S* __restrict__ lls,
    S* __restrict__ sig_out, const FwdConsts<S, NQ>& c) {
  constexpr int D = F::D;
  const size_t sB = (size_t)B;
  S p[F::NP], m[NQ][D], C[NQ][NQ];
  load_member<S, NQ, F::NP, D>(m0, ps, b, sB, p, m, C);
#pragma unroll
  for (int j = 0; j < D; ++j) us[j * sB + b] = c.pinv0 * m[0][j];
  var[b] = S(0);
  S ll = S(0);
  S sig[D];
#pragma unroll
  for (int j = 0; j < D; ++j) sig[j] = S(0);
  for (int k = 0; k < T; ++k) {
    const S t = c.t0 + c.dt * S(k + 1);
    StepVals<S, NQ, D> v;
    ek0_step<S, NQ, F, MODE != DYNAMIC>(c, p, t, m, C, v);
    const size_t row = (size_t)(k + 1);
#pragma unroll
    for (int j = 0; j < D; ++j)
      us[(row * D + j) * sB + b] = c.pinv0 * v.m_new[0][j];
    var[row * sB + b] = v.C_new[0][0];
    ll = ll + ll_increment<S, D>(v.zz, v.s, v.inv_s);
    static_update<MODE, S, D>(sig, S(k), v.zz, v.z, v.inv_s);
    commit<S, NQ, D>(v, m, C);
  }
  lls[b] = ll;
  if (MODE == FIXED_MV) {
#pragma unroll
    for (int j = 0; j < D; ++j) sig_out[j * sB + b] = sig[j];
  } else if (MODE != DYNAMIC) {
    sig_out[b] = sig[0];
  }
}

// The gradient's forward for member b: the dynamic filter with
// stds = pinv0 sqrt(max(C00, 1e-30)) (exactly 0 at t0), streaming the
// packed state row before each step (row k+1 carries step k's s2).
template <typename S, int NQ, class F>
__device__ __forceinline__ void grad_fwd_member(
    int b, int B, int T, const S* __restrict__ m0, const S* __restrict__ ps,
    S* __restrict__ us, S* __restrict__ stds, S* __restrict__ lls,
    S* __restrict__ st, const FwdConsts<S, NQ>& c) {
  constexpr int D = F::D;
  constexpr int V = Layout<NQ, D>::V;
  const size_t sB = (size_t)B;
  S p[F::NP], m[NQ][D], C[NQ][NQ];
  load_member<S, NQ, F::NP, D>(m0, ps, b, sB, p, m, C);
#pragma unroll
  for (int j = 0; j < D; ++j) us[j * sB + b] = c.pinv0 * m[0][j];
  stds[b] = S(0);
  store_row<S, NQ, D>(st, b, sB, m, C, S(1));
  S ll = S(0);
  for (int k = 0; k < T; ++k) {
    const S t = c.t0 + c.dt * S(k + 1);
    StepVals<S, NQ, D> v;
    ek0_step<S, NQ, F, false>(c, p, t, m, C, v);
    const size_t row = (size_t)(k + 1);
#pragma unroll
    for (int j = 0; j < D; ++j)
      us[(row * D + j) * sB + b] = c.pinv0 * v.m_new[0][j];
    stds[row * sB + b] = c.pinv0 * sqrt_(floor_at(v.C_new[0][0], S(1e-30)));
    ll = ll + ll_increment<S, D>(v.zz, v.s, v.inv_s);
    commit<S, NQ, D>(v, m, C);
    store_row<S, NQ, D>(st, row * V * sB + b, sB, m, C, v.s2);
  }
  lls[b] = ll;
}

// Reverse of one collapsed dynamic-diffusion step, written by hand.
//
// In: the committed state (m, C) before the step, and the cotangents of the
// step's outputs: gm and gC of the updated state (gC on the active upper
// triangle i <= l, each entry the cotangent of the one value that C[i][l]
// and C[l][i] share), gus of us_row = pinv0 m_new[0], gstd of
// std = pinv0 sqrt(max(C_new[0][0], 1e-30)) and gll of ll_inc.
// Out: gm and gC overwritten with the cotangents of (m, C), in the same
// representation; the parameter cotangent added to gp.
//
// The step is recomputed from (m, C) and reversed line by line. The
// calibration s2 = zz / (D hq) is differentiated, so z collects cotangents
// through s2 (the predicted covariance), through the update and through
// ll_inc. Both clamps pass no cotangent where they clamp. Row and column BX
// of C and C_new are structural zeros and carry none.
template <typename S, int NQ, class F>
__device__ __forceinline__ void ek0_step_vjp(
    const FwdConsts<S, NQ>& c, const S* p, S t, const S (&m)[NQ][F::D],
    const S (&C)[NQ][NQ], const S (&gus)[F::D], S gstd, S gll,
    S (&gm)[NQ][F::D], S (&gC)[NQ][NQ], S* gp) {
  constexpr int D = F::D;
  StepVals<S, NQ, D> v;
  ek0_step<S, NQ, F, false>(c, p, t, m, C, v);
  const S pb = c.pinv1;

  // us_row = pinv0 m_new[0]; std = pinv0 sqrt(max(C_new[0][0], 1e-30))
#pragma unroll
  for (int j = 0; j < D; ++j) gm[0][j] += c.pinv0 * gus[j];
  if (v.C_new[0][0] > S(1e-30))
    gC[0][0] += gstd * c.pinv0 * S(0.5) / sqrt_(v.C_new[0][0]);

  // ll_inc = -0.5 (zz inv_s + D (log(max(s, 1e-30)) + log 2 pi))
  S g_zz = S(-0.5) * gll * v.inv_s;
  S g_inv_s = S(-0.5) * gll * v.zz;
  S g_s = v.s > S(1e-30) ? S(-0.5) * gll * S(D) / v.s : S(0);

  // C_new[i][l] = Cp[i][l] - kg[i] kg[l] s over the active upper triangle
  S gCp[NQ][NQ], gkg[NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    gkg[i] = S(0);
#pragma unroll
    for (int l = 0; l < NQ; ++l) gCp[i][l] = S(0);
  }
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    if (i == BX) continue;
#pragma unroll
    for (int l = i; l < NQ; ++l) {
      if (l == BX) continue;
      const S g = gC[i][l];
      gCp[i][l] += g;
      gkg[i] -= g * v.kg[l] * v.s;
      gkg[l] -= g * v.kg[i] * v.s;
      g_s -= g * v.kg[i] * v.kg[l];
    }
  }

  // m_new[i][j] = mp[i][j] - kg[i] z[j]
  S gmp[NQ][D], gz[D];
#pragma unroll
  for (int j = 0; j < D; ++j) gz[j] = S(0);
#pragma unroll
  for (int i = 0; i < NQ; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      gmp[i][j] = gm[i][j];
      gkg[i] -= gm[i][j] * v.z[j];
      gz[j] -= gm[i][j] * v.kg[i];
    }

  // kg[i] = pb Cp[i][BX] inv_s (Cp[i][BX] is the upper entry (min, max))
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    const int lo = i < BX ? i : BX, hi = i < BX ? BX : i;
    gCp[lo][hi] += gkg[i] * pb * v.inv_s;
    g_inv_s += gkg[i] * pb * v.Cp[i][BX];
  }

  // inv_s = 1 / s; s = pb^2 Cp[BX][BX]
  g_s -= g_inv_s * v.inv_s * v.inv_s;
  gCp[BX][BX] += g_s * c.pb2;

  // Cp[i][l] = sum_{c active, c >= l} tmp[i][c] At[l][c] + Qt[i][l] s2
  // (i <= l; the mirror is the same value)
  S gtmp[NQ][NQ];
  S g_s2 = S(0);
#pragma unroll
  for (int i = 0; i < NQ; ++i)
#pragma unroll
    for (int cc = 0; cc < NQ; ++cc) gtmp[i][cc] = S(0);
#pragma unroll
  for (int i = 0; i < NQ; ++i)
#pragma unroll
    for (int l = i; l < NQ; ++l) {
      const S g = gCp[i][l];
      g_s2 += g * c.Qt[i][l];
#pragma unroll
      for (int cc = l; cc < NQ; ++cc)
        if (cc != BX) gtmp[i][cc] += g * c.At[l][cc];
    }

  // tmp[i][cc] = sum_{a active, a >= i} At[i][a] C[a][cc] (cc active);
  // C[a][cc] is the upper entry (min, max)
#pragma unroll
  for (int i = 0; i < NQ; ++i)
#pragma unroll
    for (int l = 0; l < NQ; ++l) gC[i][l] = S(0);
#pragma unroll
  for (int i = 0; i < NQ; ++i)
#pragma unroll
    for (int cc = 0; cc < NQ; ++cc) {
      if (cc == BX) continue;
#pragma unroll
      for (int a = i; a < NQ; ++a) {
        if (a == BX) continue;
        const int lo = a < cc ? a : cc, hi = a < cc ? cc : a;
        gC[lo][hi] += gtmp[i][cc] * c.At[i][a];
      }
    }

  // s2 = zz / (D hq); zz = sum_j z[j]^2
  g_zz += g_s2 * (S(1) / S(double(D) * c.hq));
#pragma unroll
  for (int j = 0; j < D; ++j) gz[j] += S(2) * v.z[j] * g_zz;

  // z = pb mp[BX] - f(u, p, t); u = pinv0 mp[0]
  S gdu[D], gu[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    gmp[BX][j] += pb * gz[j];
    gdu[j] = -gz[j];
  }
  F().vjp(v.u, p, t, gdu, gu, gp);
#pragma unroll
  for (int j = 0; j < D; ++j) gmp[0][j] += c.pinv0 * gu[j];

  // mp[i][j] = sum_{l >= i} At[i][l] m[l][j]
#pragma unroll
  for (int l = 0; l < NQ; ++l)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      S acc = S(0);
#pragma unroll
      for (int i = 0; i <= l; ++i) acc += c.At[i][l] * gmp[i][j];
      gm[l][j] = acc;
    }
}

// Adjoint sweep of member b over the stream st (T+1, V, B): from step T-1
// down to 0, with the cotangents dus[k+1], dstds[k+1] and dlls (the same
// at every step); dstds[0] is dropped and dus[0] adds pinv0 dus[0] to the
// cotangent of m0[0]. Writes dm0 (NQ, D, B) and dps (NP, B).
template <typename S, int NQ, class F>
__device__ __forceinline__ void grad_bwd_member(
    int b, int B, int T, const S* __restrict__ st, const S* __restrict__ ps,
    const S* __restrict__ dus, const S* __restrict__ dstds,
    const S* __restrict__ dlls, S* __restrict__ dm0, S* __restrict__ dps,
    const FwdConsts<S, NQ>& c) {
  constexpr int D = F::D;
  constexpr int V = Layout<NQ, D>::V;
  const size_t sB = (size_t)B;
  S p[F::NP], gp[F::NP], gm[NQ][D], gC[NQ][NQ];
#pragma unroll
  for (int k = 0; k < F::NP; ++k) {
    p[k] = ps[k * sB + b];
    gp[k] = S(0);
  }
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) gm[i][j] = S(0);
#pragma unroll
    for (int l = 0; l < NQ; ++l) gC[i][l] = S(0);
  }
  const S gll = dlls[b];
  for (int k = T - 1; k >= 0; --k) {
    S m[NQ][D], C[NQ][NQ], s2_unused;
    load_row<S, NQ, D>(st, (size_t)k * V * sB + b, sB, m, C, s2_unused);
    const size_t row = (size_t)(k + 1);
    S gus[D];
#pragma unroll
    for (int j = 0; j < D; ++j) gus[j] = dus[(row * D + j) * sB + b];
    const S t = c.t0 + c.dt * S(k + 1);
    ek0_step_vjp<S, NQ, F>(c, p, t, m, C, gus, dstds[row * sB + b], gll, gm,
                           gC, gp);
  }
#pragma unroll
  for (int j = 0; j < D; ++j) gm[0][j] += c.pinv0 * dus[j * sB + b];
#pragma unroll
  for (int i = 0; i < NQ; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) dm0[(i * D + j) * sB + b] = gm[i][j];
#pragma unroll
  for (int k = 0; k < F::NP; ++k) dps[k * sB + b] = gp[k];
}

}  // namespace ek0
