// Per-dimension EK0 / DiagonalEK1 data likelihood for Hopper (sm_90a):
// three kernels.
//
// Replaces the TPU kernels in odefilters/ops/pallas_kernels.py:
//   ek0_datalik_pd_kernel          <- _ek0_datalik_pd_kernel (the primal:
//                                     the per-dimension EK0 or DiagonalEK1
//                                     filter with scalar noisy updates on
//                                     (scaled) one-hot observed rows,
//                                     per-member data and ODE
//                                     log-likelihoods);
//   ek0_datalik_pd_grad_fwd_kernel <- _ek0_datalik_pd_grad_fwd_kernel (the
//                                     custom VJP's forward, streaming the
//                                     state);
//   ek0_datalik_pd_grad_bwd_kernel <- _ek0_datalik_pd_grad_bwd_kernel (the
//                                     adjoint sweep: initial means,
//                                     parameters and the observations'
//                                     per-member cotangents).
// Their plain PyTorch versions, in the same order of operations, and the
// Python wrappers are in odefilters_torch/ops/ek0_datalik_pd.py; the
// per-member bodies are in ek0_datalik_pd.cuh (the DiagonalEK1 step is
// ek1d.cuh's fixed_step).
//
// Design: one thread per ensemble member, its state (the mean and one
// NQ x NQ covariance per dimension) in registers for the whole time loop,
// arrays (rows, B) with the member index contiguous so that a warp's
// accesses coalesce; 64 threads a block, any B >= 1. The TPU kernels'
// keyword switches are template flags: JD (DiagonalEK1 or EK0 step), YB
// (observations per member or shared) and, for the adjoint, STOP_CALIB.
// The schedule is the on-grid step table (time, observation row) that
// every member reads, staged TILE steps at a time in shared memory by the
// whole block, with the shared observations' values; per-member
// observations are read from (n_obs, n_rows, B). So every thread runs the
// tile loop to its end, members past B included, and only members below B
// compute. The observation model (each row's dimension, scale and noise
// variance, at most DOBS_MAX rows) is a launch constant, its rows unrolled.
// The TPU backward took the composed step's adjoint from an in-kernel
// jax.vjp; here it is written by hand: the data update's reverse (its rows
// replayed to record what each reads, then reversed) and the step's,
// through the field's vjp and, for DiagonalEK1, its jac_diag_vjp, with the
// calibration's cotangent dropped under STOP_CALIB. The observations'
// cotangent is written per member, (n_obs, n_rows, B); the caller sums it
// over the members when they are shared, so no atomics.
//
// What bounds them (8192 members, 120 steps, float32): the primal reads
// the initial state and parameters and writes two numbers a member,
// 0.4 MB, and does ~25k dependent operations a member; the gradient's
// forward also writes the 157 MB stream (40 values a step) and the
// backward reads it. All three are serial recursions per member,
// latency-bound like the other filters' kernels. Built without FMA
// contraction (ops/_build.py: SOURCE_FLAGS): the kernels round op by op
// as their plain versions do on the card.

#include <cuda_runtime.h>

#include "ek0_datalik_pd.cuh"
#include "fields.cuh"

using ek0pd::DOBS_MAX;
using ek0pd::PdConsts;
using ek0pd::Tile;

namespace {

constexpr int THREADS = 64;

// Forward over the table for member b (STREAM: write the state at entry of
// every step into st (T, V, B)).
template <typename S, int NQ, class F, bool JD, bool YB, bool STREAM>
__device__ __forceinline__ void pd_fwd(
    Tile<S>& tile, const S* __restrict__ m0, const S* __restrict__ ps,
    const S* __restrict__ ys, const S* __restrict__ times,
    const int* __restrict__ codes, S* __restrict__ dll_out,
    S* __restrict__ ll_out, S* __restrict__ st, int B, int T,
    const PdConsts<S, NQ>& k) {
  constexpr int D = F::D;
  constexpr int V = ek0pd::Layout<NQ, D>::V;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = b < B;
  const size_t sB = (size_t)B;
  S p[F::NP], m[NQ][D], C[D][NQ][NQ];
  if (active) {
#pragma unroll
    for (int q = 0; q < F::NP; ++q) p[q] = ps[q * sB + b];
#pragma unroll
    for (int i = 0; i < NQ; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) m[i][j] = m0[(i * D + j) * sB + b];
#pragma unroll
    for (int j = 0; j < D; ++j)
#pragma unroll
      for (int i = 0; i < NQ; ++i)
#pragma unroll
        for (int l = 0; l < NQ; ++l) C[j][i][l] = S(0);
  }
  S ll = S(0), dll = S(0);
  for (int k0 = 0; k0 < T; k0 += ek0pd::TILE) {
    const int n = T - k0 < ek0pd::TILE ? T - k0 : ek0pd::TILE;
    __syncthreads();
    ek0pd::load_tile<S, YB>(tile, k0, n, T, k.o.n, times, codes, ys);
    __syncthreads();
    if (!active) continue;
    for (int s = 0; s < n; ++s) {
      if (STREAM)
        ek0pd::store_state<S, NQ, D>(st, (size_t)(k0 + s) * V * sB + b, sB,
                                     m, C);
      ll = ll + ek0pd::pd_step<S, NQ, F, JD>(k, p, tile.t[s], m, C);
      if (tile.row[s] >= 0) {
        S y[DOBS_MAX];
        ek0pd::obs_values<S, YB>(tile, s, ys, b, sB, k.o.n, y);
        dll = dll + ek0pd::data_update<S, NQ, D>(k.o, y, m, C);
      }
    }
  }
  if (active) {
    dll_out[b] = dll;
    ll_out[b] = ll;
  }
}

template <typename S, int NQ, class F, bool JD, bool YB>
__global__ void __launch_bounds__(THREADS)
    ek0_datalik_pd_kernel(const S* __restrict__ m0, const S* __restrict__ ps,
                          const S* __restrict__ ys,
                          const S* __restrict__ times,
                          const int* __restrict__ codes, S* __restrict__ dll,
                          S* __restrict__ ll, int B, int T,
                          PdConsts<S, NQ> k) {
  __shared__ Tile<S> tile;
  pd_fwd<S, NQ, F, JD, YB, false>(tile, m0, ps, ys, times, codes, dll, ll,
                                  nullptr, B, T, k);
}

template <typename S, int NQ, class F, bool JD, bool YB>
__global__ void __launch_bounds__(THREADS) ek0_datalik_pd_grad_fwd_kernel(
    const S* __restrict__ m0, const S* __restrict__ ps,
    const S* __restrict__ ys, const S* __restrict__ times,
    const int* __restrict__ codes, S* __restrict__ dll, S* __restrict__ ll,
    S* __restrict__ st, int B, int T, PdConsts<S, NQ> k) {
  __shared__ Tile<S> tile;
  pd_fwd<S, NQ, F, JD, YB, true>(tile, m0, ps, ys, times, codes, dll, ll, st,
                                 B, T, k);
}

// The adjoint sweep of member b over the stream st (T, V, B), from step
// T-1 down to 0: where an observation follows a step, the reverse of the
// data update (at the state the step produced, recomputed) and then the
// step's. Cotangents: ddll of the data log-likelihood, dall of the ODE one.
// Writes dm0 (NQ, D, B), dps (NP, B) and each observation's cotangent per
// member into dy (n_obs, n_rows, B).
template <typename S, int NQ, class F, bool JD, bool YB, bool STOP_CALIB>
__global__ void __launch_bounds__(THREADS) ek0_datalik_pd_grad_bwd_kernel(
    const S* __restrict__ st, const S* __restrict__ ps,
    const S* __restrict__ ys, const S* __restrict__ times,
    const int* __restrict__ codes, const S* __restrict__ ddll,
    const S* __restrict__ dall, S* __restrict__ dm0, S* __restrict__ dps,
    S* __restrict__ dy, int B, int T, PdConsts<S, NQ> k) {
  constexpr int D = F::D;
  constexpr int V = ek0pd::Layout<NQ, D>::V;
  __shared__ Tile<S> tile;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = b < B;
  const size_t sB = (size_t)B;
  S p[F::NP], gp[F::NP], gm[NQ][D], gC[D][NQ][NQ];
  S g_dll = S(0), g_ll = S(0);
#pragma unroll
  for (int q = 0; q < F::NP; ++q) {
    p[q] = active ? ps[q * sB + b] : S(0);
    gp[q] = S(0);
  }
#pragma unroll
  for (int i = 0; i < NQ; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) gm[i][j] = S(0);
#pragma unroll
  for (int j = 0; j < D; ++j)
#pragma unroll
    for (int i = 0; i < NQ; ++i)
#pragma unroll
      for (int l = 0; l < NQ; ++l) gC[j][i][l] = S(0);
  if (active) {
    g_dll = ddll[b];
    g_ll = dall[b];
  }
  const int n_rows = k.o.n;
  for (int k0 = ((T - 1) / ek0pd::TILE) * ek0pd::TILE; k0 >= 0;
       k0 -= ek0pd::TILE) {
    const int n = T - k0 < ek0pd::TILE ? T - k0 : ek0pd::TILE;
    __syncthreads();
    ek0pd::load_tile<S, YB>(tile, k0, n, T, n_rows, times, codes, ys);
    __syncthreads();
    if (!active) continue;
    for (int s = n - 1; s >= 0; --s) {
      S m[NQ][D], C[D][NQ][NQ];
      ek0pd::load_state<S, NQ, D>(st, (size_t)(k0 + s) * V * sB + b, sB, m,
                                  C);
      const int row = tile.row[s];
      if (row >= 0) {
        S m1[NQ][D], C1[D][NQ][NQ], y[DOBS_MAX], gy[DOBS_MAX];
#pragma unroll
        for (int i = 0; i < NQ; ++i)
#pragma unroll
          for (int j = 0; j < D; ++j) m1[i][j] = m[i][j];
#pragma unroll
        for (int j = 0; j < D; ++j)
#pragma unroll
          for (int i = 0; i < NQ; ++i)
#pragma unroll
            for (int l = 0; l < NQ; ++l) C1[j][i][l] = C[j][i][l];
        ek0pd::pd_step<S, NQ, F, JD>(k, p, tile.t[s], m1, C1);
        ek0pd::obs_values<S, YB>(tile, s, ys, b, sB, n_rows, y);
        ek0pd::data_update_vjp<S, NQ, D>(k.o, y, m1, C1, g_dll, gm, gC, gy);
#pragma unroll
        for (int a = 0; a < DOBS_MAX; ++a)
          if (a < n_rows) dy[((size_t)row * n_rows + a) * sB + b] = gy[a];
      }
      ek0pd::pd_step_vjp<S, NQ, F, JD, STOP_CALIB>(k, p, tile.t[s], m, C,
                                                   g_ll, gm, gC, gp);
    }
  }
  if (!active) return;
#pragma unroll
  for (int i = 0; i < NQ; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) dm0[(i * D + j) * sB + b] = gm[i][j];
#pragma unroll
  for (int q = 0; q < F::NP; ++q) dps[q * sB + b] = gp[q];
}

inline int blocks_for(int B) { return (B + THREADS - 1) / THREADS; }

// consts: At, Qt (NQ*NQ each), pinv0, pinv1, t0, dt (unused: the table
// holds the step times), then (dim, scale, r2) for each of the n_rows
// observed rows. Returns false if the observation model is out of range.
template <typename S, int NQ, int D>
bool read_pd_consts(const double* kk, int n_rows, PdConsts<S, NQ>& k) {
  if (n_rows < 1 || n_rows > DOBS_MAX) return false;
  k.c = ek1d::read_fixed_consts<S, NQ>(kk);
  const double pinv0 = kk[2 * NQ * NQ], pinv1 = kk[2 * NQ * NQ + 1];
  const double hq = pinv1 * pinv1 * kk[NQ * NQ + NQ + 1];
  k.s2k = S(1.0 / (double(D) * hq));
  k.o.n = n_rows;
  const double* o = kk + 2 * NQ * NQ + 4;
  for (int a = 0; a < DOBS_MAX; ++a) {
    const bool live = a < n_rows;
    const double c = live ? o[3 * a + 1] : 0.0;
    k.o.dim[a] = live ? (int)o[3 * a] : -1;
    if (live && (k.o.dim[a] < 0 || k.o.dim[a] >= D)) return false;
    k.o.cp0[a] = S(c * pinv0);
    k.o.cc00[a] = S(c * c * pinv0 * pinv0);
    k.o.r2[a] = S(live ? o[3 * a + 2] : 0.0);
  }
  return true;
}

template <typename S, int NQ, class F, bool STREAM>
int launch_fwd(const void* m0, const void* ps, const void* ys,
               const void* times, const void* codes, void* dll, void* ll,
               void* st, int B, int T, int n_rows, int jd, int yb,
               const double* kk, void* stream) {
  PdConsts<S, NQ> k;
  if (B < 1 || T < 0 || !read_pd_consts<S, NQ, F::D>(kk, n_rows, k))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int nb = blocks_for(B);
#define PD_FWD(JD, YB)                                                        \
  if (STREAM)                                                                 \
    ek0_datalik_pd_grad_fwd_kernel<S, NQ, F, JD, YB><<<nb, THREADS, 0, s>>>( \
        (const S*)m0, (const S*)ps, (const S*)ys, (const S*)times,            \
        (const int*)codes, (S*)dll, (S*)ll, (S*)st, B, T, k);                 \
  else                                                                        \
    ek0_datalik_pd_kernel<S, NQ, F, JD, YB><<<nb, THREADS, 0, s>>>(          \
        (const S*)m0, (const S*)ps, (const S*)ys, (const S*)times,            \
        (const int*)codes, (S*)dll, (S*)ll, B, T, k);
  if (jd && yb) {
    PD_FWD(true, true)
  } else if (jd) {
    PD_FWD(true, false)
  } else if (yb) {
    PD_FWD(false, true)
  } else {
    PD_FWD(false, false)
  }
#undef PD_FWD
  return (int)cudaGetLastError();
}

template <typename S, int NQ, class F>
int launch_bwd(const void* st, const void* ps, const void* ys,
               const void* times, const void* codes, const void* ddll,
               const void* dall, void* dm0, void* dps, void* dy, int B, int T,
               int n_rows, int jd, int yb, int stop_calib, const double* kk,
               void* stream) {
  PdConsts<S, NQ> k;
  if (B < 1 || T < 0 || !read_pd_consts<S, NQ, F::D>(kk, n_rows, k))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int nb = blocks_for(B);
#define PD_BWD(JD, YB, SC)                                                   \
  ek0_datalik_pd_grad_bwd_kernel<S, NQ, F, JD, YB, SC>                       \
      <<<nb, THREADS, 0, s>>>((const S*)st, (const S*)ps, (const S*)ys,      \
                              (const S*)times, (const int*)codes,            \
                              (const S*)ddll, (const S*)dall, (S*)dm0,       \
                              (S*)dps, (S*)dy, B, T, k);
#define PD_BWD_SC(JD, YB) \
  if (stop_calib) {       \
    PD_BWD(JD, YB, true)  \
  } else {                \
    PD_BWD(JD, YB, false) \
  }
  if (jd && yb) {
    PD_BWD_SC(true, true)
  } else if (jd) {
    PD_BWD_SC(true, false)
  } else if (yb) {
    PD_BWD_SC(false, true)
  } else {
    PD_BWD_SC(false, false)
  }
#undef PD_BWD_SC
#undef PD_BWD
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, bound with ctypes (ops/_build.py: ENTRIES). Each
// launches on the given stream, does not synchronise, and returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue, without a
// launch, for arguments out of range). Instantiated for q = 3 (NQ = 4),
// d = 2, and the FHN and LV fields. times (T,) in the working type, codes
// int32 (2, T) (row 1 read), ys (n_obs, n_rows) shared or (n_obs, n_rows,
// B) per member (yb); jd selects the DiagonalEK1 step; consts: At, Qt
// (NQ*NQ each), then pinv0, pinv1, t0, dt (unused), and (dim, scale, r2)
// per observed row.
extern "C" {

#define EK0_DATALIK_PD_ENTRIES(NAME, FIELD, S, SUF)                           \
  int ek0_datalik_pd_##NAME##_##SUF(                                         \
      const void* m0, const void* ps, const void* ys, const void* times,     \
      const void* codes, void* dll, void* ll, int B, int T, int n_rows,      \
      int jd, int yb, const double* consts, void* stream) {                  \
    return launch_fwd<S, 4, FIELD<S>, false>(m0, ps, ys, times, codes, dll,  \
                                             ll, nullptr, B, T, n_rows, jd,  \
                                             yb, consts, stream);            \
  }                                                                          \
  int ek0_datalik_pd_grad_fwd_##NAME##_##SUF(                                \
      const void* m0, const void* ps, const void* ys, const void* times,     \
      const void* codes, void* dll, void* ll, void* st, int B, int T,        \
      int n_rows, int jd, int yb, const double* consts, void* stream) {      \
    return launch_fwd<S, 4, FIELD<S>, true>(m0, ps, ys, times, codes, dll,   \
                                            ll, st, B, T, n_rows, jd, yb,    \
                                            consts, stream);                 \
  }                                                                          \
  int ek0_datalik_pd_grad_bwd_##NAME##_##SUF(                                \
      const void* st, const void* ps, const void* ys, const void* times,     \
      const void* codes, const void* ddll, const void* dall, void* dm0,      \
      void* dps, void* dy, int B, int T, int n_rows, int jd, int yb,         \
      int stop_calib, const double* consts, void* stream) {                  \
    return launch_bwd<S, 4, FIELD<S>>(st, ps, ys, times, codes, ddll, dall,  \
                                      dm0, dps, dy, B, T, n_rows, jd, yb,    \
                                      stop_calib, consts, stream);           \
  }

EK0_DATALIK_PD_ENTRIES(fhn, Fhn, float, f32)
EK0_DATALIK_PD_ENTRIES(fhn, Fhn, double, f64)
EK0_DATALIK_PD_ENTRIES(lv, LotkaVolterra, float, f32)
EK0_DATALIK_PD_ENTRIES(lv, LotkaVolterra, double, f64)

#undef EK0_DATALIK_PD_ENTRIES

}  // extern "C"
