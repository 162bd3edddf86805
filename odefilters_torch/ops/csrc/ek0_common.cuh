// Device helpers shared by the fused EK0 kernels (ek0_pair.cu,
// ek0_filter.cu, ek0_sample.cu): the constants, the packed stream row, the
// collapsed EK0 filter step in the order of operations of its plain PyTorch
// version (odefilters_torch/ops/ek0_pair.py: ek0_step_core) and the static
// diffusions' running estimates (ek0_pair.py: static_local_update).
//
// One thread holds one ensemble member. Every index loop is unrolled at
// compile time, so the structural zeros of the measured block (row and
// column BX of a committed EK0 covariance, exactly zero after the R = 0
// update) and of the IBM prior's upper-triangular transition cost nothing.
#pragma once

namespace ek0 {

constexpr int BX = 1;  // measured derivative block (first-order ODE)

// Forward constants: the preconditioned IBM transition (upper triangular),
// the process noise QLt QLt^T, the preconditioner entries of blocks 0 and
// 1, and the uniform grid. Products of constants are taken in double and
// rounded once, as the plain version's Python floats are: pb2 = pinv1^2
// and hq = pinv1^2 Qt[BX][BX].
template <typename S, int NQ>
struct FwdConsts {
  S At[NQ][NQ];
  S Qt[NQ][NQ];
  S pinv0, pinv1, t0, dt;
  S pb2;
  double hq;
};

// consts: At (NQ*NQ), Qt (NQ*NQ), then pinv0, pinv1, t0, dt (on the host
// for a launch's constants, on the card for the data likelihood's odd
// steps)
template <typename S, int NQ>
__host__ __device__ inline FwdConsts<S, NQ> read_fwd_consts(const double* k) {
  FwdConsts<S, NQ> c;
  int o = 0;
  for (int i = 0; i < NQ; ++i)
    for (int l = 0; l < NQ; ++l) c.At[i][l] = S(k[o++]);
  for (int i = 0; i < NQ; ++i)
    for (int l = 0; l < NQ; ++l) c.Qt[i][l] = S(k[o++]);
  c.pinv0 = S(k[o++]);
  const double pinv1 = k[o++];
  c.pinv1 = S(pinv1);
  c.t0 = S(k[o++]);
  c.dt = S(k[o++]);
  c.pb2 = S(pinv1 * pinv1);
  c.hq = pinv1 * pinv1 * k[NQ * NQ + BX * NQ + BX];
  return c;
}

template <int NQ, int D>
struct Layout {
  // stream row: mean (NQ*D) | active upper triangle | s2
  static constexpr int V = NQ * D + (NQ - 1) * NQ / 2 + 1;
};

template <typename S>
__device__ __forceinline__ S rsqrt_(S x);
template <>
__device__ __forceinline__ float rsqrt_(float x) { return rsqrtf(x); }
template <>
__device__ __forceinline__ double rsqrt_(double x) { return rsqrt(x); }

template <typename S>
__device__ __forceinline__ S sqrt_(S x);
template <>
__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
template <>
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }

template <typename S>
__device__ __forceinline__ S log_(S x);
template <>
__device__ __forceinline__ float log_(float x) { return logf(x); }
template <>
__device__ __forceinline__ double log_(double x) { return log(x); }

// max(x, floor) that keeps a NaN, as torch.clamp and jnp.maximum do
template <typename S>
__device__ __forceinline__ S floor_at(S x, S floor) {
  return x < floor ? floor : x;
}

// The measurement residual pb h - f (ek0_pair.py: innovation). In float
// it is taken from the exact product in double and rounded once, as a fused
// multiply-add forms it: the rounded product cancels against f to exactly 0
// at the accuracy floor, and s2 = 0 leaves a backward pass a singular
// predicted factor.
__device__ __forceinline__ float innovation(float pb, float h, float f) {
  return (float)((double)pb * (double)h - (double)f);
}

__device__ __forceinline__ double innovation(double pb, double h, double f) {
  return pb * h - f;
}

template <typename S, int NQ, int D>
__device__ __forceinline__ void store_row(S* __restrict__ st, size_t row0,
                                          size_t sB, const S (&m)[NQ][D],
                                          const S (&C)[NQ][NQ], S s2) {
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
  st[row0 + v * sB] = s2;
}

template <typename S, int NQ, int D>
__device__ __forceinline__ void load_row(const S* __restrict__ st,
                                         size_t row0, size_t sB,
                                         S (&m)[NQ][D], S (&C)[NQ][NQ],
                                         S& s2) {
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
  s2 = st[row0 + v * sB];
}

// tmp = At C over the active block: tmp[i][c] for c != BX, summing
// a >= i (At upper triangular), a != BX (C's row BX is zero).
template <typename S, int NQ>
__device__ __forceinline__ void at_times_c(const S (&At)[NQ][NQ],
                                           const S (&C)[NQ][NQ],
                                           S (&tmp)[NQ][NQ]) {
#pragma unroll
  for (int i = 0; i < NQ; ++i)
#pragma unroll
    for (int c = 0; c < NQ; ++c) {
      S acc = S(0);
      if (c != BX) {
#pragma unroll
        for (int a = i; a < NQ; ++a)
          if (a != BX) acc += At[i][a] * C[a][c];
      }
      tmp[i][c] = acc;
    }
}

// Cp = tmp At^T + s2 Qt, symmetric (upper triangle computed, mirrored).
template <typename S, int NQ>
__device__ __forceinline__ void predict_cov(const S (&tmp)[NQ][NQ],
                                            const S (&At)[NQ][NQ],
                                            const S (&Qt)[NQ][NQ], S s2,
                                            S (&Cp)[NQ][NQ]) {
#pragma unroll
  for (int i = 0; i < NQ; ++i)
#pragma unroll
    for (int l = i; l < NQ; ++l) {
      S acc = S(0);
#pragma unroll
      for (int c = l; c < NQ; ++c)
        if (c != BX) acc += tmp[i][c] * At[l][c];
      acc += s2 * Qt[i][l];
      Cp[i][l] = acc;
      Cp[l][i] = acc;
    }
}

// Everything one collapsed EK0 step computes, for the step's outputs and
// for its adjoint.
template <typename S, int NQ, int D>
struct StepVals {
  S mp[NQ][D];     // predicted mean
  S u[D];          // predicted solution pinv0 * mp[0]
  S z[D];          // innovation pb * mp[BX] - f(u), rounded once
  S zz, s2;        // |z|^2 and the step's diffusion
  S Cp[NQ][NQ];    // predicted covariance (symmetric)
  S s, inv_s;      // innovation variance pb^2 Cp[BX][BX] and its inverse
  S kg[NQ];        // gain
  S m_new[NQ][D];  // updated mean
  S C_new[NQ][NQ]; // updated covariance, row/column BX exactly zero
};

// One collapsed EK0 step from the committed state (m, C): predict the mean,
// evaluate the field at the predicted state, calibrate s2 = |z|^2/(D hq)
// (STATIC: s2 = 1, the unscaled prior), predict the covariance, apply the
// R = 0 update.
template <typename S, int NQ, class F, bool STATIC>
__device__ __forceinline__ void ek0_step(const FwdConsts<S, NQ>& c,
                                         const S* p, S t,
                                         const S (&m)[NQ][F::D],
                                         const S (&C)[NQ][NQ],
                                         StepVals<S, NQ, F::D>& v) {
  constexpr int D = F::D;
  const S pb = c.pinv1;
#pragma unroll
  for (int i = 0; i < NQ; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      S acc = S(0);
#pragma unroll
      for (int l = i; l < NQ; ++l) acc += c.At[i][l] * m[l][j];
      v.mp[i][j] = acc;
    }
  S du[D];
#pragma unroll
  for (int j = 0; j < D; ++j) v.u[j] = c.pinv0 * v.mp[0][j];
  F()(v.u, p, t, du);
#pragma unroll
  for (int j = 0; j < D; ++j) v.z[j] = innovation(pb, v.mp[BX][j], du[j]);
  v.zz = S(0);
#pragma unroll
  for (int j = 0; j < D; ++j) v.zz += v.z[j] * v.z[j];
  // zz / (D hq), as PyTorch's CUDA division by a Python number computes it:
  // a product with the divisor's reciprocal, taken in double and rounded
  // once (a reciprocal of the rounded divisor misses it in float wherever
  // D hq is not a float, e.g. at dt = 0.075)
  v.s2 = STATIC ? S(1) : v.zz * S(1.0 / (double(D) * c.hq));

  S tmp[NQ][NQ];
  at_times_c<S, NQ>(c.At, C, tmp);
  predict_cov<S, NQ>(tmp, c.At, c.Qt, v.s2, v.Cp);
  v.s = c.pb2 * v.Cp[BX][BX];
  v.inv_s = S(1) / v.s;
#pragma unroll
  for (int i = 0; i < NQ; ++i) v.kg[i] = pb * v.Cp[i][BX] * v.inv_s;
#pragma unroll
  for (int i = 0; i < NQ; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j)
        v.m_new[i][j] = v.mp[i][j] - v.kg[i] * v.z[j];
#pragma unroll
  for (int i = 0; i < NQ; ++i)
#pragma unroll
    for (int l = 0; l < NQ; ++l) v.C_new[i][l] = S(0);
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    if (i == BX) continue;
#pragma unroll
    for (int l = i; l < NQ; ++l) {
      if (l == BX) continue;
      v.C_new[i][l] = v.Cp[i][l] - v.kg[i] * v.kg[l] * v.s;
      v.C_new[l][i] = v.C_new[i][l];
    }
  }
}

// diffusion models (the C entry points' mode argument)
enum Mode { DYNAMIC = 0, FIXED = 1, FIXED_MAP = 2, FIXED_MV = 3 };

// The scalar models' running estimate after one more step (kf previous
// steps) from the step's statistic local = z^T S^-1 z / D: the MLE (FIXED)
// or the online InverseGamma(1/2, 1/2) MAP (FIXED_MAP), as in
// ek0_pair.py: static_scalar_update. The EK1 filter calls it too.
template <int MODE, typename S, int D>
__device__ __forceinline__ void static_scalar_update(S& sig, S kf, S local) {
  const S kmax = kf < S(1) ? S(1) : kf;
  if (MODE == FIXED) {
    const S cand = sig + (local - sig) / kmax;
    sig = kf == S(0) ? local : cand;
  } else if (MODE == FIXED_MAP) {
    const S alpha = S(0.5), beta = S(0.5);
    const S N = kf + S(1);
    const S den = alpha + N * S(D) * S(0.5) + S(1);
    const S first = (beta + S(0.5) * local) / den;
    const S res_prev =
        (sig * (alpha + (N - S(1)) * S(D) * S(0.5) + S(1)) - beta) * S(2);
    const S later = (beta + S(0.5) * (res_prev + local)) / den;
    sig = kf == S(0) ? first : later;
  }
}

// Running static-diffusion estimate after one more step (kf previous
// steps): the MLE (fixed: scalar, fixedMV: per dimension) or the online
// InverseGamma(1/2, 1/2) MAP (fixedMAP). Scalar models use sig[0].
template <int MODE, typename S, int D>
__device__ __forceinline__ void static_update(S (&sig)[D], S kf, S zz,
                                              const S (&z)[D], S inv_s) {
  if (MODE == FIXED_MV) {
    const S kmax = kf < S(1) ? S(1) : kf;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const S local = z[j] * z[j] * inv_s;
      const S cand = sig[j] + (local - sig[j]) / kmax;
      sig[j] = kf == S(0) ? local : cand;
    }
  } else if (MODE != DYNAMIC) {
    static_scalar_update<MODE, S, D>(sig[0], kf, zz * inv_s * (S(1) / S(D)));
  }
}

// The final static estimate of member b: sig (D, B) under fixedMV, else
// (B,); nothing under the dynamic diffusion.
template <int MODE, typename S, int D>
__device__ __forceinline__ void store_sig(S* __restrict__ out, int b,
                                          size_t sB, const S (&sig)[D]) {
  if (MODE == FIXED_MV) {
#pragma unroll
    for (int j = 0; j < D; ++j) out[j * sB + b] = sig[j];
  } else if (MODE != DYNAMIC) {
    out[b] = sig[0];
  }
}

// A member's parameters and initial mean; its initial covariance is zero.
template <typename S, int NQ, int NP, int D>
__device__ __forceinline__ void load_member(const S* __restrict__ m0,
                                            const S* __restrict__ ps, int b,
                                            size_t sB, S (&p)[NP],
                                            S (&m)[NQ][D], S (&C)[NQ][NQ]) {
#pragma unroll
  for (int k = 0; k < NP; ++k) p[k] = ps[k * sB + b];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) m[i][j] = m0[(i * D + j) * sB + b];
#pragma unroll
    for (int l = 0; l < NQ; ++l) C[i][l] = S(0);
  }
}

template <typename S, int NQ, int D>
__device__ __forceinline__ void commit(const StepVals<S, NQ, D>& v,
                                       S (&m)[NQ][D], S (&C)[NQ][NQ]) {
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) m[i][j] = v.m_new[i][j];
#pragma unroll
    for (int l = 0; l < NQ; ++l) C[i][l] = v.C_new[i][l];
  }
}

}  // namespace ek0
