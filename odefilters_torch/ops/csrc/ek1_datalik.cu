// Dense EK1 data likelihood for Hopper (sm_90a): three kernels.
//
// Replaces the TPU kernels in odefilters/ops/pallas_kernels.py:
//   ek1_datalik_kernel          <- _ek1_datalik_kernel (the primal: the
//                                  square-root EK1 filter with the dynamic
//                                  diffusion and, after the steps that end
//                                  at an observation, the joint noisy
//                                  update in Joseph square-root form; data
//                                  and ODE log-likelihoods per member);
//   ek1_datalik_grad_fwd_kernel <- _ek1_datalik_grad_fwd_kernel (the
//                                  custom VJP's forward, streaming the
//                                  state (m, L) at entry of every step);
//   ek1_datalik_grad_bwd_kernel <- _ek1_datalik_grad_bwd_kernel (the
//                                  adjoint sweep: initial means, parameters
//                                  and the observations' per-member
//                                  cotangents).
// Their plain PyTorch versions, in the same order of operations, and the
// Python wrappers are in odefilters_torch/ops/ek1_datalik.py; the
// per-member bodies are in ek1_datalik.cuh (the forward's EK1 step is
// ek1_fused.cuh's filter_step).
//
// Design: the primal and the gradient's forward run one thread per
// ensemble member, its mean and N x N factor in registers (and what does
// not fit, in local memory) for the whole time loop; arrays (rows, B) with
// the member index contiguous so that a warp's accesses coalesce; 64
// threads a block, any B >= 1. The TPU kernels' switches are template
// flags of the forward kernels (YB: observations per member or shared) and
// run-time flags of the adjoint (yb, stop_calib), whose code is the largest
// of the build: as templates, its four instantiations per field and type
// took 186 s of nvcc. The schedule is the on-grid step table (time,
// observation row) staged TILE steps at a time in shared memory by the
// whole block, with the shared observations' values, as the per-dimension
// kernels stage it (ek0_datalik_pd.cuh); every thread runs the tile loop
// to its end, members past B included, and only members below B write.
// The observation model (C, R, R R^T, at most DOBS_MAX rows) is a launch
// constant, padded to DOBS_MAX rows. The TPU backward took the composed
// step's adjoint from an in-kernel jax.vjp; here it is written by hand from
// the streamed state: per step in reverse the forward is recomputed with
// its intermediates recorded, then reversed through the field's vjp and
// jac_vjp, both MGS QRs, the Cholesky factors and solves and, unless
// stop_calib, the calibration s2. The adjoint runs a group of N = 8 lanes
// per member (ek1dl_group.cuh), 8 float32 (4 float64) members a CTA: lane
// r owns row r of the factors and their cotangents and column r of each
// MGS stack, whose forward keeps every stage's column so that the reverse
// reads it instead of recomputing the stages. The observations' cotangent
// is written per member, (n_obs, d_obs, B); the caller sums it over the
// members when they are shared, so no atomics.
//
// What bounds them (8192 members, 120 steps, 9 observations, float32): the
// primal reads the initial state and parameters and writes two numbers a
// member, 0.4 MB, and does ~3,300 dependent operations a step; the
// gradient's forward also writes the 283 MB stream (72 values a step) and
// the backward reads it and does several times the forward's operations.
// All three are serial recursions per member, latency-bound as the other
// EK1 kernels are (the adjoint's chains a member are 8 lanes wide, one
// Gram-Schmidt pivot or one row's sum at a time). Built without FMA
// contraction (ops/_build.py: SOURCE_FLAGS): the kernels round op by op as
// their plain versions do on the card.

#include <cuda_runtime.h>

#include "ek1_datalik.cuh"
#include "ek1dl_group.cuh"
#include "fields.cuh"

using ek1dl::DlConsts;
using ek1dl::DM;
using ek0pd::Tile;

namespace {

constexpr int THREADS = 64;

// Forward over the table for member b (STREAM: write the state at entry of
// every step into st (T, V, B)).
template <typename S, int NQ, class F, bool YB, bool STREAM>
__device__ __forceinline__ void dl_fwd(
    Tile<S>& tile, const S* __restrict__ m0, const S* __restrict__ ps,
    const S* __restrict__ ys, const S* __restrict__ times,
    const int* __restrict__ codes, S* __restrict__ dll_out,
    S* __restrict__ ll_out, S* __restrict__ st, int B, int T,
    const DlConsts<S, NQ, F::D>& c) {
  constexpr int N = NQ * F::D;
  constexpr int V = ek1dl::Layout<N>::V;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = b < B;
  const size_t sB = (size_t)B;
  S p[F::NP], m[N], L[N][N];
  if (active) {
#pragma unroll
    for (int q = 0; q < F::NP; ++q) p[q] = ps[q * sB + b];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      m[i] = m0[i * sB + b];
#pragma unroll
      for (int k = 0; k < N; ++k) L[i][k] = S(0);
    }
  }
  S ll = S(0), dll = S(0);
  for (int k0 = 0; k0 < T; k0 += ek0pd::TILE) {
    const int n = T - k0 < ek0pd::TILE ? T - k0 : ek0pd::TILE;
    __syncthreads();
    ek0pd::load_tile<S, YB>(tile, k0, n, T, c.n, times, codes, ys);
    __syncthreads();
    if (!active) continue;
    for (int s = 0; s < n; ++s) {
      if (STREAM)
        ek1dl::store_state<S, N>(st, (size_t)(k0 + s) * V * sB + b, sB, m, L);
      S Lp[N][N];
      ek1::StepStats<S, F::D> stats;
      ek1::filter_step<S, NQ, F, false>(c, c.pinv0, c.pinv1, p, tile.t[s],
                                        nullptr, m, L, Lp, &stats);
      ll = ll + stats.ll_inc;
      if (tile.row[s] >= 0) {
        S y[DM];
        ek1dl::UpdRec<S, N> u;
        ek0pd::obs_values<S, YB>(tile, s, ys, b, sB, c.n, y);
        dll = dll + ek1dl::data_update<S, NQ, F::D>(c, y, m, L, u);
      }
    }
  }
  if (active) {
    dll_out[b] = dll;
    ll_out[b] = ll;
  }
}

template <typename S, int NQ, class F, bool YB>
__global__ void __launch_bounds__(THREADS)
    ek1_datalik_kernel(const S* __restrict__ m0, const S* __restrict__ ps,
                       const S* __restrict__ ys, const S* __restrict__ times,
                       const int* __restrict__ codes, S* __restrict__ dll,
                       S* __restrict__ ll, int B, int T,
                       DlConsts<S, NQ, F::D> c) {
  __shared__ Tile<S> tile;
  dl_fwd<S, NQ, F, YB, false>(tile, m0, ps, ys, times, codes, dll, ll,
                              nullptr, B, T, c);
}

template <typename S, int NQ, class F, bool YB>
__global__ void __launch_bounds__(THREADS) ek1_datalik_grad_fwd_kernel(
    const S* __restrict__ m0, const S* __restrict__ ps,
    const S* __restrict__ ys, const S* __restrict__ times,
    const int* __restrict__ codes, S* __restrict__ dll, S* __restrict__ ll,
    S* __restrict__ st, int B, int T, DlConsts<S, NQ, F::D> c) {
  __shared__ Tile<S> tile;
  dl_fwd<S, NQ, F, YB, true>(tile, m0, ps, ys, times, codes, dll, ll, st, B,
                             T, c);
}

// The adjoint sweep over the stream st (T, V, B), from step T-1 down to 0,
// a group of N lanes per member (ek1dl_group.cuh), MB members a CTA: the
// step recomputed and recorded from the streamed state, staged for the
// CTA's members in shared memory (loads along the member index, the next
// row's in flight); where an observation follows, the data update too,
// reversed first; then the step reversed. Cotangents: ddll of the data
// log-likelihood, dall of the ODE one. Writes dm0 (NQ, D, B), dps (NP, B)
// and each observation's cotangent per member into dy (n_obs, n, B).
template <typename S, int NQ, class F>
__global__ void __launch_bounds__(ek1dlg::Tile<S>::MB * NQ * F::D, 4)
    ek1_datalik_grad_bwd_kernel(const S* __restrict__ st,
                                const S* __restrict__ ps,
                                const S* __restrict__ ys,
                                const S* __restrict__ times,
                                const int* __restrict__ codes,
                                const S* __restrict__ ddll,
                                const S* __restrict__ dall,
                                S* __restrict__ dm0, S* __restrict__ dps,
                                S* __restrict__ dy, int B, int T, bool yb,
                                bool stop_calib, DlConsts<S, NQ, F::D> c) {
  constexpr int DIM = F::D;
  constexpr int N = NQ * DIM;
  constexpr int V = ek1dl::Layout<N>::V;
  constexpr int MB = ek1dlg::Tile<S>::MB;
  constexpr int THREADS = MB * N;
  constexpr int SP = MB + 1;
  using W = ek1dlg::Ws<N, DIM>;
  __shared__ Tile<S> tile;
  extern __shared__ __align__(16) unsigned char dl_smem[];
  S* sR = reinterpret_cast<S*>(dl_smem);
  const int tid = threadIdx.x, mm = tid / N, r = tid % N;
  const int b0 = blockIdx.x * MB, b = b0 + mm;
  const bool active = b < B;
  const size_t sB = (size_t)B;
  S* ws = sR + ek1g::staged_size<V, MB>() + mm * W::SIZE;
  const S* R = sR + mm;
  const ek1g::MemberSync<N> sync;
  S p[F::NP], gp[F::NP], gL[N];
#pragma unroll
  for (int q = 0; q < F::NP; ++q) {
    p[q] = active ? ps[q * sB + b] : S(0);
    gp[q] = S(0);
  }
#pragma unroll
  for (int k = 0; k < N; ++k) gL[k] = S(0);
  S gm = S(0);
  const S g_dll = active ? ddll[b] : S(0);
  const S g_ll = active ? dall[b] : S(0);
  const int n_rows = c.n;
  ek1g::Stager<S, V, MB, THREADS> stg;
  if (T > 0) stg.fetch(st + (size_t)(T - 1) * V * sB, sB, b0, B, tid, V);
  for (int kk = T - 1; kk >= 0; --kk) {
    const int s = kk % ek0pd::TILE, k0 = kk - s;
    if (kk == T - 1 || s == ek0pd::TILE - 1) {
      const int n = T - k0 < ek0pd::TILE ? T - k0 : ek0pd::TILE;
      __syncthreads();
      if (yb)
        ek0pd::load_tile<S, true>(tile, k0, n, T, n_rows, times, codes, ys);
      else
        ek0pd::load_tile<S, false>(tile, k0, n, T, n_rows, times, codes, ys);
    }
    __syncthreads();  // the tile, and the last step's reads of sR
    stg.put(sR, tid);
    __syncthreads();
    if (kk > 0) stg.fetch(st + (size_t)(kk - 1) * V * sB, sB, b0, B, tid, V);
    const S t = tile.t[s];
    ek1dlg::StepRec<S, NQ, DIM> rec;
    S lnew[N];
    ek1dlg::step_fwd<S, NQ, F, SP>(c, p, t, R, r, ws, lnew, rec, sync);
    const int row = tile.row[s];
    if (row >= 0) {
      S y[DM], gy[DM];
      ek1dlg::UpdRec<S, N> u;
      if (yb)
        ek0pd::obs_values<S, true>(tile, s, ys, active ? b : 0, sB, n_rows,
                                   y);
      else
        ek0pd::obs_values<S, false>(tile, s, ys, b, sB, n_rows, y);
      ek1dlg::update_fwd<S, NQ, DIM>(c, y, r, ws, lnew, u, sync);
      ek1dlg::update_vjp<S, NQ, DIM>(c, u, g_dll, r, ws, gm, gL, gy, sync);
      if (active && r == 0) {
#pragma unroll
        for (int a = 0; a < DM; ++a)
          if (a < n_rows) dy[((size_t)row * n_rows + a) * sB + b] = gy[a];
      }
    }
    ek1dlg::step_vjp<S, NQ, F>(c, p, t, rec, stop_calib, g_ll, r, ws, gm, gL,
                               gp, sync);
  }
  if (!active) return;
  dm0[r * sB + b] = gm;
  if (r == 0) {
#pragma unroll
    for (int q = 0; q < F::NP; ++q) dps[q * sB + b] = gp[q];
  }
}

inline int blocks_for(int B) { return (B + THREADS - 1) / THREADS; }

// consts: At, QLt (NQ*NQ each), pinv0, pinv1, n, then C (n x DIM), R and
// R R^T (n x n each), row-major. Returns false if n is out of range.
template <typename S, int NQ, int DIM>
bool read_dl_consts(const double* kk, DlConsts<S, NQ, DIM>& c) {
  int o = 0;
  for (int i = 0; i < NQ; ++i)
    for (int l = 0; l < NQ; ++l) c.At[i][l] = S(kk[o++]);
  for (int i = 0; i < NQ; ++i)
    for (int l = 0; l < NQ; ++l) c.QLt[i][l] = S(kk[o++]);
  c.pinv0 = S(kk[o++]);
  c.pinv1 = S(kk[o++]);
  const int n = (int)kk[o++];
  if (n < 1 || n > DM) return false;
  c.n = n;
  for (int a = 0; a < DM; ++a)
    for (int j = 0; j < DIM; ++j)
      c.C[a][j] = a < n ? S(kk[o + a * DIM + j]) : S(0);
  o += n * DIM;
  for (int a = 0; a < DM; ++a)
    for (int b2 = 0; b2 < DM; ++b2) {
      const bool live = a < n && b2 < n;
      c.R[a][b2] = live ? S(kk[o + a * n + b2]) : S(0);
      c.RRT[a][b2] = live ? S(kk[o + n * n + a * n + b2])
                          : S(a == b2 ? 1.0 : 0.0);
    }
  c.l2pi = S(double(n) * ek0::LOG_2PI);
  return true;
}

template <typename S, int NQ, class F, bool STREAM>
int launch_fwd(const void* m0, const void* ps, const void* ys,
               const void* times, const void* codes, void* dll, void* ll,
               void* st, int B, int T, int yb, const double* kk,
               void* stream) {
  DlConsts<S, NQ, F::D> c;
  if (B < 1 || T < 0 || !read_dl_consts<S, NQ, F::D>(kk, c))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int nb = blocks_for(B);
#define DL_FWD(YB)                                                         \
  if (STREAM)                                                              \
    ek1_datalik_grad_fwd_kernel<S, NQ, F, YB><<<nb, THREADS, 0, s>>>(      \
        (const S*)m0, (const S*)ps, (const S*)ys, (const S*)times,         \
        (const int*)codes, (S*)dll, (S*)ll, (S*)st, B, T, c);              \
  else                                                                     \
    ek1_datalik_kernel<S, NQ, F, YB><<<nb, THREADS, 0, s>>>(               \
        (const S*)m0, (const S*)ps, (const S*)ys, (const S*)times,         \
        (const int*)codes, (S*)dll, (S*)ll, B, T, c);
  if (yb) {
    DL_FWD(true)
  } else {
    DL_FWD(false)
  }
#undef DL_FWD
  return (int)cudaGetLastError();
}

template <typename S, int NQ, class F>
int launch_bwd(const void* st, const void* ps, const void* ys,
               const void* times, const void* codes, const void* ddll,
               const void* dall, void* dm0, void* dps, void* dy, int B, int T,
               int yb, int stop_calib, const double* kk, void* stream) {
  constexpr int N = NQ * F::D;
  constexpr int MB = ek1dlg::Tile<S>::MB;
  DlConsts<S, NQ, F::D> c;
  if (B < 1 || T < 0 || !read_dl_consts<S, NQ, F::D>(kk, c))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const size_t shared =
      ((size_t)ek1g::staged_size<ek1dl::Layout<N>::V, MB>() +
       (size_t)MB * ek1dlg::Ws<N, F::D>::SIZE) *
      sizeof(S);
  const void* kern = (const void*)ek1_datalik_grad_bwd_kernel<S, NQ, F>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
  if (e != cudaSuccess) return (int)e;
  const int nb = (B + MB - 1) / MB;
  ek1_datalik_grad_bwd_kernel<S, NQ, F><<<nb, MB * N, shared, s>>>(
      (const S*)st, (const S*)ps, (const S*)ys, (const S*)times,
      (const int*)codes, (const S*)ddll, (const S*)dall, (S*)dm0, (S*)dps,
      (S*)dy, B, T, yb != 0, stop_calib != 0, c);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, bound with ctypes (ops/_build.py: ENTRIES). Each
// launches on the given stream, does not synchronise, and returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue, without a
// launch, for arguments out of range). Instantiated for q = 3 (NQ = 4),
// d = 2, and the FHN and LV fields. times (T,) in the working type, codes
// int32 (2, T) (row 1 read), ys (n_obs, n) shared or (n_obs, n, B) per
// member (yb); consts: At, QLt (NQ*NQ each), pinv0, pinv1, n, C (n x 2), R
// and R R^T (n x n each).
extern "C" {

#define EK1_DATALIK_ENTRIES(NAME, FIELD, S, SUF)                              \
  int ek1_datalik_##NAME##_##SUF(                                            \
      const void* m0, const void* ps, const void* ys, const void* times,     \
      const void* codes, void* dll, void* ll, int B, int T, int yb,          \
      const double* consts, void* stream) {                                  \
    return launch_fwd<S, 4, FIELD<S>, false>(m0, ps, ys, times, codes, dll,  \
                                             ll, nullptr, B, T, yb, consts,  \
                                             stream);                        \
  }                                                                          \
  int ek1_datalik_grad_fwd_##NAME##_##SUF(                                   \
      const void* m0, const void* ps, const void* ys, const void* times,     \
      const void* codes, void* dll, void* ll, void* st, int B, int T,        \
      int yb, const double* consts, void* stream) {                          \
    return launch_fwd<S, 4, FIELD<S>, true>(m0, ps, ys, times, codes, dll,   \
                                            ll, st, B, T, yb, consts,        \
                                            stream);                         \
  }                                                                          \
  int ek1_datalik_grad_bwd_##NAME##_##SUF(                                   \
      const void* st, const void* ps, const void* ys, const void* times,     \
      const void* codes, const void* ddll, const void* dall, void* dm0,      \
      void* dps, void* dy, int B, int T, int yb, int stop_calib,             \
      const double* consts, void* stream) {                                  \
    return launch_bwd<S, 4, FIELD<S>>(st, ps, ys, times, codes, ddll, dall,  \
                                      dm0, dps, dy, B, T, yb, stop_calib,    \
                                      consts, stream);                       \
  }

EK1_DATALIK_ENTRIES(fhn, Fhn, float, f32)
EK1_DATALIK_ENTRIES(fhn, Fhn, double, f64)
EK1_DATALIK_ENTRIES(lv, LotkaVolterra, float, f32)
EK1_DATALIK_ENTRIES(lv, LotkaVolterra, double, f64)

#undef EK1_DATALIK_ENTRIES

}  // extern "C"
