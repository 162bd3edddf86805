// Per-member bodies of the per-dimension data-likelihood kernels
// (ek0_datalik_pd.cu): the EK0 step with per-dimension covariances (the
// DiagonalEK1 step is ek1d.cuh's fixed_step), the sequential scalar data
// update over the observed rows, and the hand-written reverse of both.
// Their plain PyTorch versions, in the same order of operations, are in
// odefilters_torch/ops/ek0_datalik_pd.py (ek0_pd_step, ek0_pd_data_update)
// and ek1d.py (ek1d_pd_step).
//
// A member's covariance is D blocks of NQ x NQ, one per state dimension,
// carried whole: the prediction rounds Cp[i][l] and Cp[l][i] apart, and
// the update reads column 0 (C[i][0]), so no entry is mirrored. Products of
// constants are folded in double as the plain version's Python floats are
// (c pinv0, c^2 pinv0^2, 1 / (D hq)).
#pragma once

#include "ek1d.cuh"

namespace ek0pd {

using ek0::floor_at;
using ek0::innovation;
using ek0::log_;
using ek0::LOG_2PI;
using ek1d::FixedConsts;

// The most observed rows a kernel takes: the rows are unrolled, so their
// values live in registers (the wrapper raises above it).
constexpr int DOBS_MAX = 4;
// Steps of the table staged in shared memory at a time.
constexpr int TILE = 32;

// The observation model: row a observes c_a u[dim_a] with noise variance
// r2_a; cp0 = c pinv0 and cc00 = c^2 pinv0^2 are folded in double.
template <typename S>
struct ObsConsts {
  int n;
  int dim[DOBS_MAX];
  S cp0[DOBS_MAX], cc00[DOBS_MAX], r2[DOBS_MAX];
};

// Everything a launch needs: the step's constants, the EK0 calibration's
// 1 / (D hq) (double, rounded once) and the observation model.
template <typename S, int NQ>
struct PdConsts {
  FixedConsts<S, NQ> c;
  S s2k;
  ObsConsts<S> o;
};

// TILE consecutive steps of the table: time, observation row (-1: none)
// and, for observations shared by every member, its values.
template <typename S>
struct Tile {
  S t[TILE];
  int row[TILE];
  S y[TILE][DOBS_MAX];
};

// Stage steps [k0, k0 + n) of the table, by all threads of the block.
// times (T,), codes (2, T) (row 1: the observation row of each step); ys
// (n_obs, n_rows) when shared (YB false).
template <typename S, bool YB>
__device__ __forceinline__ void load_tile(Tile<S>& tile, int k0, int n, int T,
                                          int n_rows,
                                          const S* __restrict__ times,
                                          const int* __restrict__ codes,
                                          const S* __restrict__ ys) {
  for (int s = threadIdx.x; s < n; s += blockDim.x) {
    const int k = k0 + s;
    const int row = codes[T + k];
    tile.t[s] = times[k];
    tile.row[s] = row;
#pragma unroll
    for (int a = 0; a < DOBS_MAX; ++a)
      tile.y[s][a] =
          (!YB && row >= 0 && a < n_rows) ? ys[row * n_rows + a] : S(0);
  }
}

// The observations of step s's row for member b: the tile's (shared) or
// ys (n_obs, n_rows, B)'s (per member).
template <typename S, bool YB>
__device__ __forceinline__ void obs_values(const Tile<S>& tile, int s,
                                           const S* __restrict__ ys, int b,
                                           size_t sB, int n_rows,
                                           S (&y)[DOBS_MAX]) {
#pragma unroll
  for (int a = 0; a < DOBS_MAX; ++a) {
    if (YB)
      y[a] = a < n_rows ? ys[((size_t)tile.row[s] * n_rows + a) * sB + b]
                        : S(0);
    else
      y[a] = tile.y[s][a];
  }
}

// The stream row: per derivative row i, m[i][0..D-1] | C_0[i][:] | ... |
// C_{D-1}[i][:] (the TPU kernels' layout).
template <int NQ, int D>
struct Layout {
  static constexpr int W = D + D * NQ;
  static constexpr int V = NQ * W;
};

template <typename S, int NQ, int D>
__device__ __forceinline__ void store_state(S* __restrict__ st, size_t row0,
                                            size_t sB, const S (&m)[NQ][D],
                                            const S (&C)[D][NQ][NQ]) {
  int v = 0;
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) st[row0 + (v++) * sB] = m[i][j];
#pragma unroll
    for (int j = 0; j < D; ++j)
#pragma unroll
      for (int l = 0; l < NQ; ++l) st[row0 + (v++) * sB] = C[j][i][l];
  }
}

template <typename S, int NQ, int D>
__device__ __forceinline__ void load_state(const S* __restrict__ st,
                                           size_t row0, size_t sB,
                                           S (&m)[NQ][D], S (&C)[D][NQ][NQ]) {
  int v = 0;
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) m[i][j] = st[row0 + (v++) * sB];
#pragma unroll
    for (int j = 0; j < D; ++j)
#pragma unroll
      for (int l = 0; l < NQ; ++l) C[j][i][l] = st[row0 + (v++) * sB];
  }
}

// One EK0(dynamic) step with per-dimension covariances, in place
// (ek0_datalik_pd.py: ek0_pd_step): s2 = |z|^2 / (D hq), then per
// dimension the prediction and the R = 0 update. Returns the step's
// log-likelihood increment.
template <typename S, int NQ, class F>
__device__ __forceinline__ S ek0_pd_step(const FixedConsts<S, NQ>& c, S s2k,
                                         const S* p, S t, S (&m)[NQ][F::D],
                                         S (&C)[F::D][NQ][NQ]) {
  constexpr int D = F::D;
  S mp[NQ][D];
  ek0::at_times<S, NQ, D>(c.At, m, mp);
  S u[D], du[D], z[D];
#pragma unroll
  for (int j = 0; j < D; ++j) u[j] = c.pinv0 * mp[0][j];
  F()(u, p, t, du);
#pragma unroll
  for (int j = 0; j < D; ++j) z[j] = innovation(c.pinv1, mp[1][j], du[j]);
  S zz = z[0] * z[0];
#pragma unroll
  for (int j = 1; j < D; ++j) zz += z[j] * z[j];
  const S s2 = zz * s2k;
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
    const S s = c.pb2 * Cp[1][1];
    const S inv_s = S(1) / s;
    S kg[NQ];
#pragma unroll
    for (int i = 0; i < NQ; ++i) kg[i] = c.pinv1 * Cp[i][1] * inv_s;
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      m[i][j] = mp[i][j] - kg[i] * z[j];
#pragma unroll
      for (int l = 0; l < NQ; ++l) C[j][i][l] = Cp[i][l] - kg[i] * kg[l] * s;
    }
    const S inc = S(-0.5) * (z[j] * z[j] * inv_s +
                             log_(floor_at(s, S(1e-30))) + S(LOG_2PI));
    ll_inc = j == 0 ? inc : ll_inc + inc;
  }
  return ll_inc;
}

// The step of the path in place: EK0 or (JD) DiagonalEK1. Returns its
// log-likelihood increment.
template <typename S, int NQ, class F, bool JD>
__device__ __forceinline__ S pd_step(const PdConsts<S, NQ>& k, const S* p,
                                     S t, S (&m)[NQ][F::D],
                                     S (&C)[F::D][NQ][NQ]) {
  if (JD) {
    S z[F::D], inv_s[F::D];
    return ek1d::fixed_step<S, NQ, F, false>(k.c, p, t, m, C, z, inv_s);
  }
  return ek0_pd_step<S, NQ, F>(k.c, k.s2k, p, t, m, C);
}

// Observed row a's scalar noisy update in place (ek0_datalik_pd.py:
// ek0_pd_data_update, one row). Returns its data log-likelihood increment.
template <typename S, int NQ, int D>
__device__ __forceinline__ S data_row(const ObsConsts<S>& o, int a, S y,
                                      S (&m)[NQ][D], S (&C)[D][NQ][NQ]) {
  S inc = S(0);
#pragma unroll
  for (int j = 0; j < D; ++j) {
    if (o.dim[a] != j) continue;
    const S z = y - o.cp0[a] * m[0][j];
    const S s_d = o.cc00[a] * C[j][0][0] + o.r2[a];
    const S inv_sd = S(1) / s_d;
    S kg[NQ];
#pragma unroll
    for (int i = 0; i < NQ; ++i) kg[i] = o.cp0[a] * C[j][i][0] * inv_sd;
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      m[i][j] = m[i][j] + kg[i] * z;
#pragma unroll
      for (int l = 0; l < NQ; ++l)
        C[j][i][l] = C[j][i][l] - kg[i] * kg[l] * s_d;
    }
    inc = S(-0.5) * (z * z * inv_sd + log_(s_d) + S(LOG_2PI));
  }
  return inc;
}

// The data update over every observed row in place. Returns the summed
// increment.
template <typename S, int NQ, int D>
__device__ __forceinline__ S data_update(const ObsConsts<S>& o,
                                         const S (&y)[DOBS_MAX],
                                         S (&m)[NQ][D], S (&C)[D][NQ][NQ]) {
  S dll = S(0);
#pragma unroll
  for (int a = 0; a < DOBS_MAX; ++a) {
    if (a >= o.n) break;
    const S inc = data_row<S, NQ, D>(o, a, y[a], m, C);
    dll = a == 0 ? inc : dll + inc;
  }
  return dll;
}

// Reverse of data_row for row a, from what the row read of the state before
// it: m0 = m[0][dim], c0[i] = C_dim[i][0]. gm and gC (cotangents of the
// state after the row) become those of the state before it; gdll is the
// increment's cotangent. Returns the observation's cotangent.
template <typename S, int NQ, int D>
__device__ __forceinline__ S data_row_vjp(const ObsConsts<S>& o, int a, S y,
                                          S m0, const S (&c0)[NQ], S gdll,
                                          S (&gm)[NQ][D],
                                          S (&gC)[D][NQ][NQ]) {
  const S z = y - o.cp0[a] * m0;
  const S s_d = o.cc00[a] * c0[0] + o.r2[a];
  const S inv_sd = S(1) / s_d;
  S kg[NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) kg[i] = o.cp0[a] * c0[i] * inv_sd;
  // inc = -0.5 (z^2 inv_sd + log s_d + log 2 pi)
  S gz = -gdll * z * inv_sd;
  S g_inv = S(-0.5) * gdll * z * z;
  S g_sd = S(-0.5) * gdll / s_d;
#pragma unroll
  for (int j = 0; j < D; ++j) {
    if (o.dim[a] != j) continue;
    // C_new[i][l] = C[i][l] - kg[i] kg[l] s_d
    S gk[NQ];
#pragma unroll
    for (int i = 0; i < NQ; ++i) gk[i] = S(0);
#pragma unroll
    for (int i = 0; i < NQ; ++i)
#pragma unroll
      for (int l = 0; l < NQ; ++l) {
        const S g = gC[j][i][l];
        gk[i] -= g * kg[l] * s_d;
        gk[l] -= g * kg[i] * s_d;
        g_sd -= g * kg[i] * kg[l];
      }
    // m_new[i] = m[i] + kg[i] z
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      gk[i] += gm[i][j] * z;
      gz += gm[i][j] * kg[i];
    }
    // kg[i] = cp0 C[i][0] inv_sd
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      gC[j][i][0] += gk[i] * o.cp0[a] * inv_sd;
      g_inv += gk[i] * o.cp0[a] * c0[i];
    }
    // inv_sd = 1 / s_d; s_d = cc00 C[0][0] + r2
    g_sd -= g_inv * inv_sd * inv_sd;
    gC[j][0][0] += g_sd * o.cc00[a];
    // z = y - cp0 m[0]
    gm[0][j] -= o.cp0[a] * gz;
  }
  return gz;
}

// Reverse of data_update at the state (m, C) before it: the rows are
// replayed forward to record what each reads, then reversed. gy receives
// each row's observation cotangent.
template <typename S, int NQ, int D>
__device__ __forceinline__ void data_update_vjp(
    const ObsConsts<S>& o, const S (&y)[DOBS_MAX], S (&m)[NQ][D],
    S (&C)[D][NQ][NQ], S gdll, S (&gm)[NQ][D], S (&gC)[D][NQ][NQ],
    S (&gy)[DOBS_MAX]) {
  S m0[DOBS_MAX], c0[DOBS_MAX][NQ];
#pragma unroll
  for (int a = 0; a < DOBS_MAX; ++a) {
    if (a >= o.n) break;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      if (o.dim[a] != j) continue;
      m0[a] = m[0][j];
#pragma unroll
      for (int i = 0; i < NQ; ++i) c0[a][i] = C[j][i][0];
    }
    if (a + 1 < o.n) data_row<S, NQ, D>(o, a, y[a], m, C);
  }
#pragma unroll
  for (int a = DOBS_MAX - 1; a >= 0; --a) {
    if (a >= o.n) continue;
    gy[a] = data_row_vjp<S, NQ, D>(o, a, y[a], m0[a], c0[a], gdll, gm, gC);
  }
}

// Reverse of pd_step at the state (m, C) before it: gm, gC (cotangents of
// the state after the step) become those of (m, C); gll is the increment's
// cotangent and the parameters' cotangent is added to gp. The forward's
// values are recomputed in the plain version's order; STOP_CALIB drops the
// calibration s2's cotangent (the plain version's s2.detach()).
template <typename S, int NQ, class F, bool JD, bool STOP_CALIB>
__device__ __forceinline__ void pd_step_vjp(const PdConsts<S, NQ>& k,
                                            const S* p, S t,
                                            const S (&m)[NQ][F::D],
                                            const S (&C)[F::D][NQ][NQ], S gll,
                                            S (&gm)[NQ][F::D],
                                            S (&gC)[F::D][NQ][NQ], S* gp) {
  constexpr int D = F::D;
  const FixedConsts<S, NQ>& c = k.c;
  // -- the forward's shared part --
  S mp[NQ][D];
  ek0::at_times<S, NQ, D>(c.At, m, mp);
  S u[D], du[D], jd[D], z[D], hq[D];
#pragma unroll
  for (int j = 0; j < D; ++j) u[j] = c.pinv0 * mp[0][j];
  F()(u, p, t, du);
  if (JD) F().jac_diag(u, p, t, jd);
#pragma unroll
  for (int j = 0; j < D; ++j) z[j] = innovation(c.pinv1, mp[1][j], du[j]);
  S s2;
  if (JD) {
    S acc = S(0);
#pragma unroll
    for (int j = 0; j < D; ++j) {
      hq[j] = (c.hq1 - S(2) * jd[j] * c.p01 * c.Qt[0][1]) +
              jd[j] * jd[j] * c.p00 * c.Qt[0][0];
      acc += z[j] * z[j] / hq[j];
    }
    s2 = acc * (S(1) / S(D));
  } else {
    S zz = S(0);
#pragma unroll
    for (int j = 0; j < D; ++j) zz += z[j] * z[j];
    s2 = zz * k.s2k;
  }

  S gmp[NQ][D], gz[D], gjd[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    gz[j] = S(0);
    gjd[j] = S(0);
#pragma unroll
    for (int i = 0; i < NQ; ++i) gmp[i][j] = gm[i][j];
  }
  S g_s2 = S(0);

  // -- per dimension: the prediction and the update, reversed --
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
    const S s = JD ? ek1d::h_quad<S, NQ>(c, jd[j], Cp[0][0], Cp[0][1],
                                         Cp[1][1])
                   : c.pb2 * Cp[1][1];
    const S inv_s = S(1) / s;
    S kg[NQ];
#pragma unroll
    for (int i = 0; i < NQ; ++i)
      kg[i] = JD ? (c.pinv1 * Cp[i][1] - jd[j] * c.pinv0 * Cp[i][0]) * inv_s
                 : c.pinv1 * Cp[i][1] * inv_s;

    // inc_j = -0.5 (z_j^2 inv_s + log(max(s, 1e-30)) + log 2 pi)
    gz[j] -= gll * z[j] * inv_s;
    S g_inv = S(-0.5) * gll * z[j] * z[j];
    S g_s = s > S(1e-30) ? S(-0.5) * gll / s : S(0);
    // C_new[i][l] = Cp[i][l] - kg[i] kg[l] s
    S gCp[NQ][NQ], gkg[NQ];
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      gkg[i] = S(0);
#pragma unroll
      for (int l = 0; l < NQ; ++l) gCp[i][l] = gC[j][i][l];
    }
#pragma unroll
    for (int i = 0; i < NQ; ++i)
#pragma unroll
      for (int l = 0; l < NQ; ++l) {
        const S g = gC[j][i][l];
        gkg[i] -= g * kg[l] * s;
        gkg[l] -= g * kg[i] * s;
        g_s -= g * kg[i] * kg[l];
      }
    // m_new[i][j] = mp[i][j] - kg[i] z[j]
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      gkg[i] -= gm[i][j] * z[j];
      gz[j] -= gm[i][j] * kg[i];
    }
    // the gain
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const S gi = gkg[i] * inv_s;
      gCp[i][1] += gi * c.pinv1;
      if (JD) {
        gCp[i][0] -= gi * jd[j] * c.pinv0;
        gjd[j] -= gi * c.pinv0 * Cp[i][0];
        g_inv += gkg[i] * (c.pinv1 * Cp[i][1] - jd[j] * c.pinv0 * Cp[i][0]);
      } else {
        g_inv += gkg[i] * c.pinv1 * Cp[i][1];
      }
    }
    // inv_s = 1 / s; s = h_j Cp h_j^T
    g_s -= g_inv * inv_s * inv_s;
    gCp[1][1] += g_s * c.pb2;
    if (JD) {
      gCp[0][1] -= g_s * S(2) * jd[j] * c.p01;
      gCp[0][0] += g_s * jd[j] * jd[j] * c.p00;
      gjd[j] += g_s * (S(2) * jd[j] * c.p00 * Cp[0][0] -
                       S(2) * c.p01 * Cp[0][1]);
    }
    // Cp[i][l] = sum_{b >= l} tmp[i][b] At[l][b] + Qt[i][l] s2
    S gtmp[NQ][NQ];
#pragma unroll
    for (int i = 0; i < NQ; ++i)
#pragma unroll
      for (int b = 0; b < NQ; ++b) gtmp[i][b] = S(0);
#pragma unroll
    for (int i = 0; i < NQ; ++i)
#pragma unroll
      for (int l = 0; l < NQ; ++l) {
        g_s2 += gCp[i][l] * c.Qt[i][l];
#pragma unroll
        for (int b = l; b < NQ; ++b) gtmp[i][b] += gCp[i][l] * c.At[l][b];
      }
    // tmp[i][b] = sum_{a >= i} At[i][a] C[a][b]
#pragma unroll
    for (int a = 0; a < NQ; ++a)
#pragma unroll
      for (int b = 0; b < NQ; ++b) {
        S acc = S(0);
#pragma unroll
        for (int i = 0; i <= a; ++i) acc += c.At[i][a] * gtmp[i][b];
        gC[j][a][b] = acc;
      }
  }

  // -- the calibration --
  if (!STOP_CALIB) {
    if (JD) {
      // s2 = (sum_j z_j^2 / hq_j) / D, hq_j = h_j Qt h_j^T
      const S gq = g_s2 * (S(1) / S(D));
#pragma unroll
      for (int j = 0; j < D; ++j) {
        gz[j] += gq * S(2) * z[j] / hq[j];
        const S ghq = -gq * z[j] * z[j] / (hq[j] * hq[j]);
        gjd[j] += ghq * (S(2) * jd[j] * c.p00 * c.Qt[0][0] -
                         S(2) * c.p01 * c.Qt[0][1]);
      }
    } else {
      // s2 = zz / (D hq)
      const S gzz = g_s2 * k.s2k;
#pragma unroll
      for (int j = 0; j < D; ++j) gz[j] += S(2) * z[j] * gzz;
    }
  }

  // z = pinv1 mp[1] - f(u); jd = J_jj(u); u = pinv0 mp[0]
  S gdu[D], gu[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    gmp[1][j] += c.pinv1 * gz[j];
    gdu[j] = -gz[j];
  }
  F().vjp(u, p, t, gdu, gu, gp);
  if (JD) {
    S guj[D];
    F().jac_diag_vjp(u, p, t, gjd, guj, gp);
#pragma unroll
    for (int j = 0; j < D; ++j) gu[j] += guj[j];
  }
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

}  // namespace ek0pd
