// Differentiable fused EK0 filter for Hopper (sm_90a): three kernels.
//
// Replaces the TPU kernels in odefilters/ops/pallas_kernels.py:
//   ek0_filter_kernel           <- _ek0_kernel (the primal filter, dynamic
//                                  and static diffusions);
//   ek0_filter_grad_fwd_kernel  <- _ek0_grad_fwd_kernel (the custom VJP's
//                                  forward, streaming the state);
//   ek0_filter_grad_bwd_kernel  <- _ek0_grad_bwd_kernel (the adjoint sweep).
// Their plain PyTorch versions, in the same order of operations, and the
// Python wrappers are in odefilters_torch/ops/ek0_filter.py; the per-member
// bodies are in ek0_filter.cuh and the shared step in ek0_common.cuh.
//
// Design: one thread per ensemble member, its state in registers for the
// whole time loop, every index loop unrolled, arrays (rows, B) with the
// member index contiguous so that a warp's accesses coalesce; 64 threads a
// block, any B >= 1. The TPU backward took the step's adjoint from an
// in-kernel jax.vjp; CUDA has no autodiff, so ek0_step_vjp (ek0_filter.cuh)
// is the reverse of the collapsed step written by hand, through the field's
// vjp (fields.cuh) and the 1/s2 calibration. The gradient's stream is the
// pair's packed row (15 values a step at q = 3) instead of the TPU
// kernel's full (nq, d+nq) carry: the measured row and column of the
// covariance are exact zeros and are rebuilt as such.
//
// What bounds them (8192 members, 500 steps, float32): the primal writes
// us and the variances, 8192*501*3*4 B = 49.3 MB, 0.015 ms at 3.35 TB/s;
// the gradient's forward also writes the 246.3 MB stream and the backward
// reads it with the cotangents, about 295.5 MB each, 0.088 ms. All three
// are serial recursions per member whose dependency chain per step is far
// longer than those bytes take, and 8192 threads fill about one block of
// 64 per SM, so latency, not bandwidth, bounds them. The backward
// recomputes the step before reversing it, so it holds the forward's
// intermediates and their cotangents at once; in float64 that may spill.
// Filling the card (several members per thread, a member's work split over
// threads) is left for later work.

#include <cuda_runtime.h>

#include "ek0_filter.cuh"
#include "fields.cuh"

using ek0::FwdConsts;

namespace {

constexpr int THREADS = 64;

}  // namespace

template <typename S, int NQ, class F, int MODE>
__global__ void __launch_bounds__(THREADS)
    ek0_filter_kernel(const S* __restrict__ m0, const S* __restrict__ ps,
                      S* __restrict__ us, S* __restrict__ var,
                      S* __restrict__ lls, S* __restrict__ sig, int B, int T,
                      FwdConsts<S, NQ> c) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  ek0::filter_member<S, NQ, F, MODE>(b, B, T, m0, ps, us, var, lls, sig, c);
}

template <typename S, int NQ, class F>
__global__ void __launch_bounds__(THREADS)
    ek0_filter_grad_fwd_kernel(const S* __restrict__ m0,
                               const S* __restrict__ ps, S* __restrict__ us,
                               S* __restrict__ stds, S* __restrict__ lls,
                               S* __restrict__ st, int B, int T,
                               FwdConsts<S, NQ> c) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  ek0::grad_fwd_member<S, NQ, F>(b, B, T, m0, ps, us, stds, lls, st, c);
}

template <typename S, int NQ, class F>
__global__ void __launch_bounds__(THREADS)
    ek0_filter_grad_bwd_kernel(const S* __restrict__ st,
                               const S* __restrict__ ps,
                               const S* __restrict__ dus,
                               const S* __restrict__ dstds,
                               const S* __restrict__ dlls,
                               S* __restrict__ dm0, S* __restrict__ dps,
                               int B, int T, FwdConsts<S, NQ> c) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  ek0::grad_bwd_member<S, NQ, F>(b, B, T, st, ps, dus, dstds, dlls, dm0, dps,
                                 c);
}

namespace {

inline int blocks_for(int B) { return (B + THREADS - 1) / THREADS; }

template <typename S, int NQ, class F, int MODE>
void launch_filter_mode(const void* m0, const void* ps, void* us, void* var,
                        void* lls, void* sig, int B, int T,
                        const FwdConsts<S, NQ>& c, cudaStream_t stream) {
  ek0_filter_kernel<S, NQ, F, MODE><<<blocks_for(B), THREADS, 0, stream>>>(
      (const S*)m0, (const S*)ps, (S*)us, (S*)var, (S*)lls, (S*)sig, B, T, c);
}

template <typename S, int NQ, class F>
int launch_filter(const void* m0, const void* ps, void* us, void* var,
                  void* lls, void* sig, int B, int T, int mode,
                  const double* k, void* stream) {
  if (B < 1 || T < 0) return (int)cudaErrorInvalidValue;
  const FwdConsts<S, NQ> c = ek0::read_fwd_consts<S, NQ>(k);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case ek0::DYNAMIC:
      launch_filter_mode<S, NQ, F, ek0::DYNAMIC>(m0, ps, us, var, lls, sig,
                                                  B, T, c, s);
      break;
    case ek0::FIXED:
      launch_filter_mode<S, NQ, F, ek0::FIXED>(m0, ps, us, var, lls, sig, B,
                                                T, c, s);
      break;
    case ek0::FIXED_MAP:
      launch_filter_mode<S, NQ, F, ek0::FIXED_MAP>(m0, ps, us, var, lls, sig,
                                                    B, T, c, s);
      break;
    case ek0::FIXED_MV:
      launch_filter_mode<S, NQ, F, ek0::FIXED_MV>(m0, ps, us, var, lls, sig,
                                                   B, T, c, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename S, int NQ, class F>
int launch_grad_fwd(const void* m0, const void* ps, void* us, void* stds,
                    void* lls, void* st, int B, int T, const double* k,
                    void* stream) {
  if (B < 1 || T < 0) return (int)cudaErrorInvalidValue;
  ek0_filter_grad_fwd_kernel<S, NQ, F>
      <<<blocks_for(B), THREADS, 0, (cudaStream_t)stream>>>(
          (const S*)m0, (const S*)ps, (S*)us, (S*)stds, (S*)lls, (S*)st, B,
          T, ek0::read_fwd_consts<S, NQ>(k));
  return (int)cudaGetLastError();
}

template <typename S, int NQ, class F>
int launch_grad_bwd(const void* st, const void* ps, const void* dus,
                    const void* dstds, const void* dlls, void* dm0,
                    void* dps, int B, int T, const double* k, void* stream) {
  if (B < 1 || T < 0) return (int)cudaErrorInvalidValue;
  ek0_filter_grad_bwd_kernel<S, NQ, F>
      <<<blocks_for(B), THREADS, 0, (cudaStream_t)stream>>>(
          (const S*)st, (const S*)ps, (const S*)dus, (const S*)dstds,
          (const S*)dlls, (S*)dm0, (S*)dps, B, T,
          ek0::read_fwd_consts<S, NQ>(k));
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, bound with ctypes (ops/_build.py: ENTRIES). Each
// launches on the given stream, does not synchronise, and returns
// cudaGetLastError() after the launch. consts: At, Qt (NQ*NQ each), then
// pinv0, pinv1, t0, dt. Instantiated for q = 3 (NQ = 4) and the FHN and LV
// fields.
extern "C" {

#define EK0_FILTER_ENTRIES(NAME, FIELD, S, SUF)                               \
  int ek0_filter_##NAME##_##SUF(const void* m0, const void* ps, void* us,    \
                                void* var, void* lls, void* sig, int B,      \
                                int T, int mode, const double* consts,       \
                                void* stream) {                              \
    return launch_filter<S, 4, FIELD<S>>(m0, ps, us, var, lls, sig, B, T,    \
                                         mode, consts, stream);              \
  }                                                                          \
  int ek0_filter_grad_fwd_##NAME##_##SUF(                                    \
      const void* m0, const void* ps, void* us, void* stds, void* lls,       \
      void* st, int B, int T, const double* consts, void* stream) {          \
    return launch_grad_fwd<S, 4, FIELD<S>>(m0, ps, us, stds, lls, st, B, T,  \
                                           consts, stream);                  \
  }                                                                          \
  int ek0_filter_grad_bwd_##NAME##_##SUF(                                    \
      const void* st, const void* ps, const void* dus, const void* dstds,    \
      const void* dlls, void* dm0, void* dps, int B, int T,                  \
      const double* consts, void* stream) {                                  \
    return launch_grad_bwd<S, 4, FIELD<S>>(st, ps, dus, dstds, dlls, dm0,    \
                                           dps, B, T, consts, stream);       \
  }

EK0_FILTER_ENTRIES(fhn, Fhn, float, f32)
EK0_FILTER_ENTRIES(fhn, Fhn, double, f64)
EK0_FILTER_ENTRIES(lv, LotkaVolterra, float, f32)
EK0_FILTER_ENTRIES(lv, LotkaVolterra, double, f64)

#undef EK0_FILTER_ENTRIES

}  // extern "C"
