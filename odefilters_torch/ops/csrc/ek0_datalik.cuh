// Per-member bodies of the fused EK0 data-likelihood kernels
// (ek0_datalik.cu): the step table staged in shared memory, the step of
// another length, the isotropic noisy data update and the hand-written
// reverse of both. Their plain PyTorch versions are in
// odefilters_torch/ops/ek0_datalik.py (ek0_odd_step, ek0_data_update).
#pragma once

#include "ek0_filter.cuh"

namespace ek0 {

// Steps of the table staged in shared memory at a time.
constexpr int TILE = 32;

// The constants of a step of another length dt': its forward constants and
// the static rescale factors r_i = p_i(dt') / p_i(dt) between the base
// frame and its own, as the plain version's Python floats enter PyTorch's
// CUDA ops: a product with r_i (rm) or r_i r_l (rC, the double product
// rounded once), a division by them as a product with the reciprocal taken
// in double and rounded once (rmi, rCi).
template <typename S, int NQ>
struct OddConsts {
  FwdConsts<S, NQ> c;
  S rm[NQ], rmi[NQ];
  S rC[NQ][NQ], rCi[NQ][NQ];
};

// An odd set's row: At, Qt (NQ*NQ each), pinv0, pinv1, t0, dt (unused: the
// table holds the step times), then r (NQ).
template <int NQ>
__host__ __device__ constexpr int odd_width() {
  return 2 * NQ * NQ + 4 + NQ;
}

template <typename S, int NQ>
__device__ __forceinline__ void read_odd(const double* k,
                                         OddConsts<S, NQ>& o) {
  o.c = read_fwd_consts<S, NQ>(k);
  const double* r = k + 2 * NQ * NQ + 4;
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    o.rm[i] = S(r[i]);
    o.rmi[i] = S(1.0 / r[i]);
#pragma unroll
    for (int l = 0; l < NQ; ++l) {
      o.rC[i][l] = S(r[i] * r[l]);
      o.rCi[i][l] = S(1.0 / (r[i] * r[l]));
    }
  }
}

// TILE consecutive steps of the table: time, constants set (0 base, i > 0
// the i-th odd set, built here), observation row (-1: none) and its values.
template <typename S, int NQ, int D>
struct Tile {
  S t[TILE];
  int set[TILE];
  int row[TILE];
  S y[TILE][D];
  OddConsts<S, NQ> odd[TILE];
};

// Stage steps [k0, k0 + n) of the table, by all threads of the block.
// times (T,), codes (2, T): the set and the row of each step; ys (n_obs, D);
// odd (n_odd, odd_width) in double.
template <typename S, int NQ, int D>
__device__ __forceinline__ void load_tile(Tile<S, NQ, D>& tile, int k0, int n,
                                          int T, const S* __restrict__ times,
                                          const int* __restrict__ codes,
                                          const S* __restrict__ ys,
                                          const double* __restrict__ odd) {
  for (int s = threadIdx.x; s < n; s += blockDim.x) {
    const int k = k0 + s;
    const int set = codes[k], row = codes[T + k];
    tile.t[s] = times[k];
    tile.set[s] = set;
    tile.row[s] = row;
#pragma unroll
    for (int j = 0; j < D; ++j)
      tile.y[s][j] = row >= 0 ? ys[row * D + j] : S(0);
    if (set > 0) read_odd<S, NQ>(odd + (size_t)(set - 1) * odd_width<NQ>(),
                                 tile.odd[s]);
  }
}

// The stream row: mean (NQ*D) | active upper triangle.
template <int NQ, int D>
struct StateLayout {
  static constexpr int V = NQ * D + (NQ - 1) * NQ / 2;
};

template <typename S, int NQ, int D>
__device__ __forceinline__ void store_state(S* __restrict__ st, size_t row0,
                                            size_t sB, const S (&m)[NQ][D],
                                            const S (&C)[NQ][NQ]) {
  int v = 0;
#pragma unroll
  for (int i = 0; i < NQ; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) st[row0 + (v++) * sB] = m[i][j];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    if (i == BX) continue;
#pragma unroll
    for (int l = i; l < NQ; ++l) {
      if (l == BX) continue;
      st[row0 + (v++) * sB] = C[i][l];
    }
  }
}

template <typename S, int NQ, int D>
__device__ __forceinline__ void load_state(const S* __restrict__ st,
                                           size_t row0, size_t sB,
                                           S (&m)[NQ][D], S (&C)[NQ][NQ]) {
  int v = 0;
#pragma unroll
  for (int i = 0; i < NQ; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) m[i][j] = st[row0 + (v++) * sB];
#pragma unroll
  for (int i = 0; i < NQ; ++i)
#pragma unroll
    for (int l = 0; l < NQ; ++l) C[i][l] = S(0);
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    if (i == BX) continue;
#pragma unroll
    for (int l = i; l < NQ; ++l) {
      if (l == BX) continue;
      C[i][l] = st[row0 + (v++) * sB];
      C[l][i] = C[i][l];
    }
  }
}

// One step of the table in place: the base step (set 0) or an odd one,
// rescaled into its frame and back. Returns the step's ll increment.
template <typename S, int NQ, class F>
__device__ __forceinline__ S table_step(const FwdConsts<S, NQ>& c,
                                        const Tile<S, NQ, F::D>& tile, int s,
                                        const S* p, S (&m)[NQ][F::D],
                                        S (&C)[NQ][NQ]) {
  constexpr int D = F::D;
  StepVals<S, NQ, D> v;
  if (tile.set[s] == 0) {
    ek0_step<S, NQ, F, false>(c, p, tile.t[s], m, C, v);
    commit<S, NQ, D>(v, m, C);
    return ll_increment<S, D>(v.zz, v.s, v.inv_s);
  }
  const OddConsts<S, NQ>& o = tile.odd[s];
  S mh[NQ][D], Ch[NQ][NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) mh[i][j] = m[i][j] * o.rm[i];
#pragma unroll
    for (int l = 0; l < NQ; ++l)
      Ch[i][l] = (i == BX || l == BX) ? S(0) : C[i][l] * o.rC[i][l];
  }
  ek0_step<S, NQ, F, false>(o.c, p, tile.t[s], mh, Ch, v);
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) m[i][j] = v.m_new[i][j] * o.rmi[i];
#pragma unroll
    for (int l = 0; l < NQ; ++l) C[i][l] = v.C_new[i][l] * o.rCi[i][l];
  }
  return ll_increment<S, D>(v.zz, v.s, v.inv_s);
}

// Reverse of table_step: the cotangents gm, gC (active triangle) of the
// state after the step become those of the state (m, C) before it; gll is
// the ll increment's and the parameters' cotangent is added to gp.
template <typename S, int NQ, class F, bool STOP_CALIB>
__device__ __forceinline__ void table_step_vjp(
    const FwdConsts<S, NQ>& c, const Tile<S, NQ, F::D>& tile, int s,
    const S* p, const S (&m)[NQ][F::D], const S (&C)[NQ][NQ], S gll,
    S (&gm)[NQ][F::D], S (&gC)[NQ][NQ], S* gp) {
  constexpr int D = F::D;
  const S no_us[D] = {};
  if (tile.set[s] == 0) {
    ek0_step_vjp<S, NQ, F, false, STOP_CALIB>(c, p, tile.t[s], m, C, no_us,
                                              S(0), gll, gm, gC, gp);
    return;
  }
  const OddConsts<S, NQ>& o = tile.odd[s];
  S mh[NQ][D], Ch[NQ][NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      mh[i][j] = m[i][j] * o.rm[i];
      gm[i][j] = gm[i][j] * o.rmi[i];
    }
#pragma unroll
    for (int l = 0; l < NQ; ++l) {
      const bool act = i != BX && l != BX;
      Ch[i][l] = act ? C[i][l] * o.rC[i][l] : S(0);
      gC[i][l] = act ? gC[i][l] * o.rCi[i][l] : S(0);
    }
  }
  ek0_step_vjp<S, NQ, F, false, STOP_CALIB>(o.c, p, tile.t[s], mh, Ch, no_us,
                                            S(0), gll, gm, gC, gp);
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) gm[i][j] = gm[i][j] * o.rm[i];
#pragma unroll
    for (int l = 0; l < NQ; ++l) gC[i][l] = gC[i][l] * o.rC[i][l];
  }
}

// Data-update constants: pinv0, pinv0^2 (the double product rounded once)
// and the noise variance r2.
template <typename S>
struct DataConsts {
  S pinv0, pd2, r2;
};

// Everything one data update computes, for its result and its reverse.
template <typename S, int NQ, int D>
struct DataVals {
  S zd[D];          // residual y - pinv0 m[0]
  S s_d, inv_sd;    // innovation variance pinv0^2 C[0][0] + r2, its inverse
  S kgd[NQ];        // gain, kgd[BX] = 0
  S zzd;            // |zd|^2
};

template <typename S, int NQ, int D>
__device__ __forceinline__ void data_vals(const DataConsts<S>& dc,
                                          const S (&y)[D],
                                          const S (&m)[NQ][D],
                                          const S (&C)[NQ][NQ],
                                          DataVals<S, NQ, D>& w) {
#pragma unroll
  for (int j = 0; j < D; ++j) w.zd[j] = y[j] - dc.pinv0 * m[0][j];
  w.s_d = dc.pd2 * C[0][0] + dc.r2;
  w.inv_sd = S(1) / w.s_d;
#pragma unroll
  for (int i = 0; i < NQ; ++i)
    w.kgd[i] = i == BX ? S(0) : dc.pinv0 * C[i][0] * w.inv_sd;
  w.zzd = w.zd[0] * w.zd[0];
#pragma unroll
  for (int j = 1; j < D; ++j) w.zzd += w.zd[j] * w.zd[j];
}

// The isotropic noisy update on block 0 in place (ek0_datalik.py:
// ek0_data_update): the mean and the active triangle; row and column BX
// stay zero, block BX of the mean unchanged. Returns the data
// log-likelihood increment log N(y; pinv0 m[0], s_d I_D).
template <typename S, int NQ, int D>
__device__ __forceinline__ S data_update(const DataConsts<S>& dc,
                                         const S (&y)[D], S (&m)[NQ][D],
                                         S (&C)[NQ][NQ]) {
  DataVals<S, NQ, D> w;
  data_vals<S, NQ, D>(dc, y, m, C, w);
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    if (i == BX) continue;
#pragma unroll
    for (int j = 0; j < D; ++j) m[i][j] = m[i][j] + w.kgd[i] * w.zd[j];
  }
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    if (i == BX) continue;
#pragma unroll
    for (int l = i; l < NQ; ++l) {
      if (l == BX) continue;
      C[i][l] = C[i][l] - w.kgd[i] * w.kgd[l] * w.s_d;
      C[l][i] = C[i][l];
    }
  }
  return S(-0.5) *
         (w.zzd * w.inv_sd + S(D) * (log_(w.s_d) + S(LOG_2PI)));
}

// Reverse of data_update at the state (m, C) before it: gm and gC (active
// triangle) of the updated state become those of (m, C); gdll is the
// increment's cotangent; gy receives the observation's.
template <typename S, int NQ, int D>
__device__ __forceinline__ void data_update_vjp(
    const DataConsts<S>& dc, const S (&y)[D], const S (&m)[NQ][D],
    const S (&C)[NQ][NQ], S gdll, S (&gm)[NQ][D], S (&gC)[NQ][NQ],
    S (&gy)[D]) {
  DataVals<S, NQ, D> w;
  data_vals<S, NQ, D>(dc, y, m, C, w);
  // dll = -0.5 (zzd inv_sd + D (log s_d + log 2 pi))
  const S g_zzd = S(-0.5) * gdll * w.inv_sd;
  S g_inv = S(-0.5) * gdll * w.zzd;
  S g_sd = S(-0.5) * gdll * S(D) / w.s_d;
  // C_new[i][l] = C[i][l] - kgd[i] kgd[l] s_d over the active triangle
  S gk[NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) gk[i] = S(0);
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    if (i == BX) continue;
#pragma unroll
    for (int l = i; l < NQ; ++l) {
      if (l == BX) continue;
      const S g = gC[i][l];
      gk[i] -= g * w.kgd[l] * w.s_d;
      gk[l] -= g * w.kgd[i] * w.s_d;
      g_sd -= g * w.kgd[i] * w.kgd[l];
    }
  }
  // m_new[i][j] = m[i][j] + kgd[i] zd[j] (i != BX)
  S gzd[D];
#pragma unroll
  for (int j = 0; j < D; ++j) gzd[j] = S(0);
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    if (i == BX) continue;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      gk[i] += gm[i][j] * w.zd[j];
      gzd[j] += gm[i][j] * w.kgd[i];
    }
  }
  // kgd[i] = pinv0 C[i][0] inv_sd; C[i][0] is the triangle's entry (0, i)
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    if (i == BX) continue;
    gC[0][i] += gk[i] * dc.pinv0 * w.inv_sd;
    g_inv += gk[i] * dc.pinv0 * C[i][0];
  }
  // inv_sd = 1 / s_d; s_d = pinv0^2 C[0][0] + r2
  g_sd -= g_inv * w.inv_sd * w.inv_sd;
  gC[0][0] += g_sd * dc.pd2;
  // zzd = sum_j zd[j]^2; zd[j] = y[j] - pinv0 m[0][j]
#pragma unroll
  for (int j = 0; j < D; ++j) {
    gzd[j] += S(2) * w.zd[j] * g_zzd;
    gy[j] = gzd[j];
    gm[0][j] -= dc.pinv0 * gzd[j];
  }
}

}  // namespace ek0
