// Fused EK0 data likelihood for Hopper (sm_90a): three kernels.
//
// Replaces the TPU kernels in odefilters/ops/pallas_kernels.py:
//   ek0_datalik_kernel          <- _ek0_datalik_kernel (the primal: the EK0
//                                  filter with isotropic noisy data updates,
//                                  per-member data and ODE log-likelihoods);
//   ek0_datalik_grad_fwd_kernel <- _ek0_datalik_grad_fwd_kernel (the custom
//                                  VJP's forward, streaming the state);
//   ek0_datalik_grad_bwd_kernel <- _ek0_datalik_grad_bwd_kernel (the adjoint
//                                  sweep: initial means, parameters and the
//                                  observations' per-member cotangents).
// Their plain PyTorch versions, in the same order of operations, and the
// Python wrappers are in odefilters_torch/ops/ek0_datalik.py; the
// per-member bodies are in ek0_datalik.cuh, the EK0 step and its
// hand-written adjoint in ek0_common.cuh and ek0_filter.cuh.
//
// Design: one thread per ensemble member, its state in registers for the
// whole time loop, arrays (rows, B) with the member index contiguous so
// that a warp's accesses coalesce; 64 threads a block, any B >= 1. The TPU
// kernels unrolled the observation schedule at trace time; here it is
// data: a step table (time, constants set, observation row) that every
// member reads, staged TILE steps at a time in shared memory by the whole
// block together with the steps' observations and, for a step of another
// length, its constants (built in the tile from the double row). So every
// thread runs the tile loop to its end, members past B included, and only
// members below B compute. The TPU backward took the composed step's
// adjoint from an in-kernel jax.vjp; here it is written by hand: the data
// update's reverse (ek0_datalik.cuh) and the EK0 step's (ek0_filter.cuh),
// with the calibration's cotangent dropped under stop_calib. The
// observations are shared by every member; their cotangent is written per
// member, (n_obs, D, B), and summed by the caller, so no atomics and the
// plain version's sum.
//
// What bounds them (8192 members, 120 steps, float32): the primal reads
// the initial state and parameters and writes two numbers a member,
// 0.4 MB; the gradient's forward also writes the 55 MB stream (14 values a
// step) and the backward reads it. All three are serial recursions per
// member, latency-bound like the EK0 filter's kernels.

#include <cuda_runtime.h>

#include "ek0_datalik.cuh"
#include "fields.cuh"

using ek0::DataConsts;
using ek0::FwdConsts;
using ek0::Tile;

namespace {

constexpr int THREADS = 64;

// Forward over the table for member b (STREAM: write the state at entry of
// every step into st (T, V, B)), the block's tile in shared memory.
template <typename S, int NQ, class F, bool STREAM>
__device__ __forceinline__ void datalik_fwd(
    Tile<S, NQ, F::D>& tile, const S* __restrict__ m0,
    const S* __restrict__ ps, const S* __restrict__ ys,
    const S* __restrict__ times, const int* __restrict__ codes,
    const double* __restrict__ odd, S* __restrict__ dll_out,
    S* __restrict__ ll_out, S* __restrict__ st, int B, int T,
    const FwdConsts<S, NQ>& c, const DataConsts<S>& dc) {
  constexpr int D = F::D;
  constexpr int V = ek0::StateLayout<NQ, D>::V;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = b < B;
  const size_t sB = (size_t)B;
  S p[F::NP], m[NQ][D], C[NQ][NQ];
  if (active) ek0::load_member<S, NQ, F::NP, D>(m0, ps, b, sB, p, m, C);
  S ll = S(0), dll = S(0);
  for (int k0 = 0; k0 < T; k0 += ek0::TILE) {
    const int n = T - k0 < ek0::TILE ? T - k0 : ek0::TILE;
    __syncthreads();
    ek0::load_tile<S, NQ, D>(tile, k0, n, T, times, codes, ys, odd);
    __syncthreads();
    if (!active) continue;
    for (int s = 0; s < n; ++s) {
      if (STREAM)
        ek0::store_state<S, NQ, D>(st, (size_t)(k0 + s) * V * sB + b, sB, m,
                                   C);
      ll = ll + ek0::table_step<S, NQ, F>(c, tile, s, p, m, C);
      if (tile.row[s] >= 0)
        dll = dll + ek0::data_update<S, NQ, D>(dc, tile.y[s], m, C);
    }
  }
  if (active) {
    dll_out[b] = dll;
    ll_out[b] = ll;
  }
}

template <typename S, int NQ, class F>
__global__ void __launch_bounds__(THREADS)
    ek0_datalik_kernel(const S* __restrict__ m0, const S* __restrict__ ps,
                       const S* __restrict__ ys, const S* __restrict__ times,
                       const int* __restrict__ codes,
                       const double* __restrict__ odd, S* __restrict__ dll,
                       S* __restrict__ ll, int B, int T, FwdConsts<S, NQ> c,
                       DataConsts<S> dc) {
  __shared__ Tile<S, NQ, F::D> tile;
  datalik_fwd<S, NQ, F, false>(tile, m0, ps, ys, times, codes, odd, dll, ll,
                               nullptr, B, T, c, dc);
}

template <typename S, int NQ, class F>
__global__ void __launch_bounds__(THREADS)
    ek0_datalik_grad_fwd_kernel(const S* __restrict__ m0,
                                const S* __restrict__ ps,
                                const S* __restrict__ ys,
                                const S* __restrict__ times,
                                const int* __restrict__ codes,
                                const double* __restrict__ odd,
                                S* __restrict__ dll, S* __restrict__ ll,
                                S* __restrict__ st, int B, int T,
                                FwdConsts<S, NQ> c, DataConsts<S> dc) {
  __shared__ Tile<S, NQ, F::D> tile;
  datalik_fwd<S, NQ, F, true>(tile, m0, ps, ys, times, codes, odd, dll, ll,
                              st, B, T, c, dc);
}

// The adjoint sweep of member b over the stream st (T, V, B), from step
// T-1 down to 0: where an observation follows a step, the reverse of the
// data update (at the state the step produced, recomputed) and then the
// step's. Cotangents: ddll of the data log-likelihood, dall of the ODE one.
// Writes dm0 (NQ, D, B), dps (NP, B) and each observation's cotangent per
// member into dy (n_obs, D, B).
template <typename S, int NQ, class F, bool STOP_CALIB>
__global__ void __launch_bounds__(THREADS) ek0_datalik_grad_bwd_kernel(
    const S* __restrict__ st, const S* __restrict__ ps,
    const S* __restrict__ ys, const S* __restrict__ times,
    const int* __restrict__ codes, const double* __restrict__ odd,
    const S* __restrict__ ddll, const S* __restrict__ dall,
    S* __restrict__ dm0, S* __restrict__ dps, S* __restrict__ dy, int B, int T,
    FwdConsts<S, NQ> c, DataConsts<S> dc) {
  constexpr int D = F::D;
  constexpr int V = ek0::StateLayout<NQ, D>::V;
  __shared__ Tile<S, NQ, D> tile;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = b < B;
  const size_t sB = (size_t)B;
  S p[F::NP], gp[F::NP], gm[NQ][D], gC[NQ][NQ];
  S g_dll = S(0), g_ll = S(0);
#pragma unroll
  for (int k = 0; k < F::NP; ++k) {
    p[k] = active ? ps[k * sB + b] : S(0);
    gp[k] = S(0);
  }
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) gm[i][j] = S(0);
#pragma unroll
    for (int l = 0; l < NQ; ++l) gC[i][l] = S(0);
  }
  if (active) {
    g_dll = ddll[b];
    g_ll = dall[b];
  }
  for (int k0 = ((T - 1) / ek0::TILE) * ek0::TILE; k0 >= 0; k0 -= ek0::TILE) {
    const int n = T - k0 < ek0::TILE ? T - k0 : ek0::TILE;
    __syncthreads();
    ek0::load_tile<S, NQ, D>(tile, k0, n, T, times, codes, ys, odd);
    __syncthreads();
    if (!active) continue;
    for (int s = n - 1; s >= 0; --s) {
      S m[NQ][D], C[NQ][NQ];
      ek0::load_state<S, NQ, D>(st, (size_t)(k0 + s) * V * sB + b, sB, m, C);
      const int row = tile.row[s];
      if (row >= 0) {
        S m1[NQ][D], C1[NQ][NQ], gy[D];
#pragma unroll
        for (int i = 0; i < NQ; ++i) {
#pragma unroll
          for (int j = 0; j < D; ++j) m1[i][j] = m[i][j];
#pragma unroll
          for (int l = 0; l < NQ; ++l) C1[i][l] = C[i][l];
        }
        ek0::table_step<S, NQ, F>(c, tile, s, p, m1, C1);
        ek0::data_update_vjp<S, NQ, D>(dc, tile.y[s], m1, C1, g_dll, gm, gC,
                                       gy);
#pragma unroll
        for (int j = 0; j < D; ++j) dy[((size_t)row * D + j) * sB + b] = gy[j];
      }
      ek0::table_step_vjp<S, NQ, F, STOP_CALIB>(c, tile, s, p, m, C, g_ll, gm,
                                                gC, gp);
    }
  }
  if (!active) return;
#pragma unroll
  for (int i = 0; i < NQ; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) dm0[(i * D + j) * sB + b] = gm[i][j];
#pragma unroll
  for (int k = 0; k < F::NP; ++k) dps[k * sB + b] = gp[k];
}

inline int blocks_for(int B) { return (B + THREADS - 1) / THREADS; }

// consts: At, Qt (NQ*NQ each), pinv0, pinv1, t0, dt, then r2
template <typename S, int NQ>
DataConsts<S> read_data_consts(const double* k) {
  const double pinv0 = k[2 * NQ * NQ];
  return DataConsts<S>{S(pinv0), S(pinv0 * pinv0), S(k[2 * NQ * NQ + 4])};
}

template <typename S, int NQ, class F, bool STREAM>
int launch_fwd(const void* m0, const void* ps, const void* ys,
               const void* times, const void* codes, const void* odd,
               void* dll, void* ll, void* st, int B, int T, int n_obs,
               int n_odd, const double* k, void* stream) {
  if (B < 1 || T < 0 || n_obs < 0 || n_odd < 0 || (n_odd > 0 && !odd))
    return (int)cudaErrorInvalidValue;
  const FwdConsts<S, NQ> c = ek0::read_fwd_consts<S, NQ>(k);
  const DataConsts<S> dc = read_data_consts<S, NQ>(k);
  const cudaStream_t s = (cudaStream_t)stream;
  if (STREAM)
    ek0_datalik_grad_fwd_kernel<S, NQ, F><<<blocks_for(B), THREADS, 0, s>>>(
        (const S*)m0, (const S*)ps, (const S*)ys, (const S*)times,
        (const int*)codes, (const double*)odd, (S*)dll, (S*)ll, (S*)st, B, T,
        c, dc);
  else
    ek0_datalik_kernel<S, NQ, F><<<blocks_for(B), THREADS, 0, s>>>(
        (const S*)m0, (const S*)ps, (const S*)ys, (const S*)times,
        (const int*)codes, (const double*)odd, (S*)dll, (S*)ll, B, T, c, dc);
  return (int)cudaGetLastError();
}

template <typename S, int NQ, class F>
int launch_bwd(const void* st, const void* ps, const void* ys,
               const void* times, const void* codes, const void* odd,
               const void* ddll, const void* dall, void* dm0, void* dps,
               void* dy, int B, int T, int n_obs, int n_odd, int stop_calib,
               const double* k, void* stream) {
  if (B < 1 || T < 0 || n_obs < 0 || n_odd < 0 || (n_odd > 0 && !odd))
    return (int)cudaErrorInvalidValue;
  const FwdConsts<S, NQ> c = ek0::read_fwd_consts<S, NQ>(k);
  const DataConsts<S> dc = read_data_consts<S, NQ>(k);
  const cudaStream_t s = (cudaStream_t)stream;
  const int nb = blocks_for(B);
  if (stop_calib)
    ek0_datalik_grad_bwd_kernel<S, NQ, F, true><<<nb, THREADS, 0, s>>>(
        (const S*)st, (const S*)ps, (const S*)ys, (const S*)times,
        (const int*)codes, (const double*)odd, (const S*)ddll,
        (const S*)dall, (S*)dm0, (S*)dps, (S*)dy, B, T, c, dc);
  else
    ek0_datalik_grad_bwd_kernel<S, NQ, F, false><<<nb, THREADS, 0, s>>>(
        (const S*)st, (const S*)ps, (const S*)ys, (const S*)times,
        (const int*)codes, (const double*)odd, (const S*)ddll,
        (const S*)dall, (S*)dm0, (S*)dps, (S*)dy, B, T, c, dc);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, bound with ctypes (ops/_build.py: ENTRIES). Each
// launches on the given stream, does not synchronise, and returns
// cudaGetLastError() after the launch. Instantiated for q = 3 (NQ = 4),
// d = 2, and the FHN and LV fields. times (T,) in the working type, codes
// int32 (2, T), odd double (n_odd, 2*NQ*NQ + 4 + NQ) or null when n_odd is
// 0; consts: At, Qt (NQ*NQ each), then pinv0, pinv1, t0, dt (unused), r2.
extern "C" {

#define EK0_DATALIK_ENTRIES(NAME, FIELD, S, SUF)                              \
  int ek0_datalik_##NAME##_##SUF(                                            \
      const void* m0, const void* ps, const void* ys, const void* times,     \
      const void* codes, const void* odd, void* dll, void* ll, int B, int T, \
      int n_obs, int n_odd, const double* consts, void* stream) {            \
    return launch_fwd<S, 4, FIELD<S>, false>(m0, ps, ys, times, codes, odd, \
                                             dll, ll, nullptr, B, T, n_obs, \
                                             n_odd, consts, stream);         \
  }                                                                          \
  int ek0_datalik_grad_fwd_##NAME##_##SUF(                                   \
      const void* m0, const void* ps, const void* ys, const void* times,     \
      const void* codes, const void* odd, void* dll, void* ll, void* st,     \
      int B, int T, int n_obs, int n_odd, const double* consts,              \
      void* stream) {                                                        \
    return launch_fwd<S, 4, FIELD<S>, true>(m0, ps, ys, times, codes, odd,  \
                                            dll, ll, st, B, T, n_obs, n_odd, \
                                            consts, stream);                 \
  }                                                                          \
  int ek0_datalik_grad_bwd_##NAME##_##SUF(                                   \
      const void* st, const void* ps, const void* ys, const void* times,     \
      const void* codes, const void* odd, const void* ddll,                  \
      const void* dall, void* dm0, void* dps, void* dy, int B, int T,        \
      int n_obs, int n_odd, int stop_calib, const double* consts,            \
      void* stream) {                                                        \
    return launch_bwd<S, 4, FIELD<S>>(st, ps, ys, times, codes, odd, ddll,   \
                                      dall, dm0, dps, dy, B, T, n_obs,       \
                                      n_odd, stop_calib, consts, stream);    \
  }

EK0_DATALIK_ENTRIES(fhn, Fhn, float, f32)
EK0_DATALIK_ENTRIES(fhn, Fhn, double, f64)
EK0_DATALIK_ENTRIES(lv, LotkaVolterra, float, f32)
EK0_DATALIK_ENTRIES(lv, LotkaVolterra, double, f64)

#undef EK0_DATALIK_ENTRIES

}  // extern "C"
