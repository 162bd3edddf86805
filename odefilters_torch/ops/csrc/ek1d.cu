// DiagonalEK1 ensemble solves for Hopper (sm_90a): four kernels.
//
// Replaces the TPU kernels in odefilters/ops/pallas_kernels.py:
//   ek1d_filter_kernel            <- _ek1d_kernel (the fixed-grid filter,
//                                    dynamic and static diffusions);
//   ek1d_adaptive_kernel          <- _ek1d_adaptive_kernel (the
//                                    PI-controlled filter, outputs on the
//                                    save grid);
//   ek1d_adaptive_stream_kernel   <- _ek1d_adaptive_stream_kernel (the same
//                                    loop, streaming each accepted step);
//   ek1d_adaptive_smoother_kernel <- _ek1d_adaptive_smoother_kernel (the
//                                    square-root RTS pass over each member's
//                                    accepted steps, per dimension).
// Their plain PyTorch versions, in the same order of operations, and the
// Python wrappers are in odefilters_torch/ops/ek1d.py and ek1d_adaptive.py;
// the per-member bodies are in ek1d.cuh, the adaptive loop's begin, control
// and smoothing walk in ek0_adaptive.cuh.
//
// Design: one thread per ensemble member, its state in registers for the
// whole loop, 64 threads a block, any B >= 1, arrays (rows, B) with the
// member index contiguous. The fixed grid carries each dimension's plain
// covariance, as the TPU kernel does. The adaptive kernels carry a factor
// per dimension, where the TPU kernels carry the plain covariance, stream
// it with the committed Jacobian diagonal, and factor it in the backward
// pass by a Householder reflection and a structural-zero Cholesky: with the
// factor, the backward step is the adaptive EK0 smoother's on each
// dimension (ek0::smooth_member over that dimension's columns), and the
// stream holds only accepted steps, at row nacc - 1 of a (max_iters, V, B)
// stream (V = 43 at q = 3, d = 2), as the adaptive EK0 kernels do. The TPU
// kernels' 1024-lane barrier is dropped: each thread writes its own save
// rows.
//
// What bounds them (8192 members, float32): the fixed grid at 500 steps
// writes us and stds, 8192*501*4*4 B = 65.7 MB, 0.020 ms at 3.35 TB/s; the
// adaptive stream kernel writes its accepted rows (172 B each) and the
// smoother reads them back. Each step or attempt is a chain of about a
// thousand dependent operations per member, and 8192 threads fill about one
// block of 64 per SM, so latency, not bandwidth or the operation rate,
// bounds them; members take different numbers of attempts, so an adaptive
// warp runs as long as its slowest member. Built without FMA contraction
// (ops/_build.py: SOURCE_FLAGS): the kernels round op by op as their plain
// versions do on the card.

#include <cuda_runtime.h>

#include "ek1d.cuh"
#include "fields.cuh"

using ek0::AdaptConsts;
using ek1d::FixedConsts;

namespace {

constexpr int THREADS = 64;

}  // namespace

// Fixed-grid filter of member b: us, stds (T+1, D, B) (row 0 the initial
// mean with std 0), the summed log-likelihood lls (B,) and, under a static
// model, the final estimate sig ((B,), or (D, B) for fixedMV).
template <typename S, int NQ, class F, int MODE>
__global__ void __launch_bounds__(THREADS)
    ek1d_filter_kernel(const S* __restrict__ m0, const S* __restrict__ ps,
                       S* __restrict__ us, S* __restrict__ stds,
                       S* __restrict__ lls, S* __restrict__ sig_out, int B,
                       int T, FixedConsts<S, NQ> c) {
  constexpr int D = F::D;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = (size_t)B;
  S p[F::NP], m[NQ][D], C[D][NQ][NQ];
#pragma unroll
  for (int k = 0; k < F::NP; ++k) p[k] = ps[k * sB + b];
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
#pragma unroll
  for (int j = 0; j < D; ++j) {
    us[j * sB + b] = c.pinv0 * m[0][j];
    stds[j * sB + b] = S(0);
  }
  S ll = S(0), sig[D];
#pragma unroll
  for (int j = 0; j < D; ++j) sig[j] = S(0);
  for (int k = 0; k < T; ++k) {
    const S t = c.t0 + c.dt * S(k + 1);
    S z[D], inv_s[D];
    const S ll_inc = ek1d::fixed_step<S, NQ, F, MODE != ek0::DYNAMIC>(
        c, p, t, m, C, z, inv_s);
    const size_t row = (size_t)(k + 1);
#pragma unroll
    for (int j = 0; j < D; ++j) {
      us[(row * D + j) * sB + b] = c.pinv0 * m[0][j];
      stds[(row * D + j) * sB + b] =
          c.pinv0 * ek0::sqrt_(ek0::floor_at(C[j][0][0], S(0)));
    }
    ll = ll + ll_inc;
    ek1d::static_update<MODE, S, D>(sig, S(k), z, inv_s);
  }
  lls[b] = ll;
  ek0::store_sig<MODE, S, D>(sig_out, b, sB, sig);
}

// Adaptive filter of member b: us, stds (S+1, D, B) on the save grid (row
// 0 the exact initial state with std 0), lls (B,), counts (4, B).
template <typename S, int NQ, class F>
__global__ void __launch_bounds__(THREADS)
    ek1d_adaptive_kernel(const S* __restrict__ m0, const S* __restrict__ ps,
                         const S* __restrict__ dt0s, S* __restrict__ us,
                         S* __restrict__ stds, S* __restrict__ lls,
                         int* __restrict__ counts, int B,
                         AdaptConsts<S, NQ> c) {
  constexpr int D = F::D;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = (size_t)B;
  S p[F::NP];
  ek1d::Member<S, NQ, D> st;
  ek1d::start_member<S, NQ, F::NP, D>(m0, ps, dt0s, b, sB, c, p, st);
  auto emit = [&](int k) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      us[((size_t)k * D + j) * sB + b] = st.m[0][j];
      stds[((size_t)k * D + j) * sB + b] = ek0::std_row0<S, NQ>(st.L[j]);
    }
  };
  emit(0);
  while (st.live(c)) {
    ek0::AttemptOut<S> o;
    ek1d::attempt<S, NQ, F>(c, p, st, o);
    if (o.reached) emit(o.seg_before + 1);
  }
  // a failed or unfinished member's remaining save rows: its final state
  for (int k = st.seg + 1; k <= c.n_save; ++k) emit(k);
  lls[b] = st.ll;
  ek0::store_counts<S, D>(counts, b, sB, st, c.n_save);
}

// The same loop, writing each accepted step into st (max_iters, V, B) at
// row nacc - 1 of its member; lls (B,), counts (4, B).
template <typename S, int NQ, class F>
__global__ void __launch_bounds__(THREADS)
    ek1d_adaptive_stream_kernel(const S* __restrict__ m0,
                                const S* __restrict__ ps,
                                const S* __restrict__ dt0s,
                                S* __restrict__ stream, S* __restrict__ lls,
                                int* __restrict__ counts, int B,
                                AdaptConsts<S, NQ> c) {
  constexpr int D = F::D;
  constexpr int V = ek1d::Layout<NQ, D>::V;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = (size_t)B;
  S p[F::NP];
  ek1d::Member<S, NQ, D> st;
  ek1d::start_member<S, NQ, F::NP, D>(m0, ps, dt0s, b, sB, c, p, st);
  while (st.live(c)) {
    ek0::AttemptOut<S> o;
    ek1d::attempt<S, NQ, F>(c, p, st, o);
    if (o.accept)
      ek1d::store_row<S, NQ, D>(stream, (size_t)(st.nacc - 1) * V * sB + b,
                                sB, st, o.lh, o.s2,
                                o.reached ? S(o.seg_before + 1) : S(0));
  }
  lls[b] = st.ll;
  ek0::store_counts<S, D>(counts, b, sB, st, c.n_save);
}

// Backward pass of member b, one dimension after another, each the adaptive
// EK0 smoother's walk over rows nacc - 1 .. 0 of that dimension's columns,
// into us, stds (S+1, D, B).
template <typename S, int NQ, int D>
__global__ void __launch_bounds__(THREADS)
    ek1d_adaptive_smoother_kernel(const S* __restrict__ stream,
                                  const int* __restrict__ counts,
                                  const S* __restrict__ m0,
                                  S* __restrict__ us, S* __restrict__ stds,
                                  int B, AdaptConsts<S, NQ> c) {
  constexpr int V = ek1d::Layout<NQ, D>::V;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = (size_t)B;
  const int K = counts[b], segs = counts[3 * sB + b];
  for (int j = 0; j < D; ++j) {
    const S first[1] = {m0[j * sB + b]};
    ek0::smooth_member<S, NQ, 1>(
        c, K, segs, first,
        [&](int k, ek0::AdaptRow<S, NQ, 1>& r) {
          ek1d::load_dim_row<S, NQ, D>(stream, (size_t)k * V * sB + b, sB, j,
                                       r);
        },
        [&](int k, const S (&m0row)[1], S std) {
          us[((size_t)k * D + j) * sB + b] = m0row[0];
          stds[((size_t)k * D + j) * sB + b] = std;
        });
  }
}

namespace {

inline int blocks_for(int B) { return (B + THREADS - 1) / THREADS; }

inline bool bad_sizes(int B, int n_save, int max_iters) {
  return B < 1 || n_save < 1 || max_iters < 1;
}

template <typename S, int NQ, class F, int MODE>
void launch_filter_mode(const void* m0, const void* ps, void* us, void* stds,
                        void* lls, void* sig, int B, int T,
                        const FixedConsts<S, NQ>& c, cudaStream_t stream) {
  ek1d_filter_kernel<S, NQ, F, MODE><<<blocks_for(B), THREADS, 0, stream>>>(
      (const S*)m0, (const S*)ps, (S*)us, (S*)stds, (S*)lls, (S*)sig, B, T,
      c);
}

template <typename S, int NQ, class F>
int launch_filter(const void* m0, const void* ps, void* us, void* stds,
                  void* lls, void* sig, int B, int T, int mode,
                  const double* k, void* stream) {
  if (B < 1 || T < 0) return (int)cudaErrorInvalidValue;
  const FixedConsts<S, NQ> c = ek1d::read_fixed_consts<S, NQ>(k);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case ek0::DYNAMIC:
      launch_filter_mode<S, NQ, F, ek0::DYNAMIC>(m0, ps, us, stds, lls, sig,
                                                  B, T, c, s);
      break;
    case ek0::FIXED:
      launch_filter_mode<S, NQ, F, ek0::FIXED>(m0, ps, us, stds, lls, sig, B,
                                                T, c, s);
      break;
    case ek0::FIXED_MAP:
      launch_filter_mode<S, NQ, F, ek0::FIXED_MAP>(m0, ps, us, stds, lls, sig,
                                                    B, T, c, s);
      break;
    case ek0::FIXED_MV:
      launch_filter_mode<S, NQ, F, ek0::FIXED_MV>(m0, ps, us, stds, lls, sig,
                                                   B, T, c, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename S, int NQ, class F>
int launch_adaptive(const void* m0, const void* ps, const void* dt0s,
                    void* us, void* stds, void* lls, void* counts, int B,
                    int n_save, int max_iters, const double* k,
                    void* stream) {
  if (bad_sizes(B, n_save, max_iters)) return (int)cudaErrorInvalidValue;
  ek1d_adaptive_kernel<S, NQ, F>
      <<<blocks_for(B), THREADS, 0, (cudaStream_t)stream>>>(
          (const S*)m0, (const S*)ps, (const S*)dt0s, (S*)us, (S*)stds,
          (S*)lls, (int*)counts, B,
          ek0::read_adapt_consts<S, NQ>(k, n_save, max_iters));
  return (int)cudaGetLastError();
}

template <typename S, int NQ, class F>
int launch_stream(const void* m0, const void* ps, const void* dt0s, void* st,
                  void* lls, void* counts, int B, int n_save, int max_iters,
                  const double* k, void* stream) {
  if (bad_sizes(B, n_save, max_iters)) return (int)cudaErrorInvalidValue;
  ek1d_adaptive_stream_kernel<S, NQ, F>
      <<<blocks_for(B), THREADS, 0, (cudaStream_t)stream>>>(
          (const S*)m0, (const S*)ps, (const S*)dt0s, (S*)st, (S*)lls,
          (int*)counts, B,
          ek0::read_adapt_consts<S, NQ>(k, n_save, max_iters));
  return (int)cudaGetLastError();
}

template <typename S, int NQ, int D>
int launch_smoother(const void* st, const void* counts, const void* m0,
                    void* us, void* stds, int B, int n_save, int max_iters,
                    const double* k, void* stream) {
  if (bad_sizes(B, n_save, max_iters)) return (int)cudaErrorInvalidValue;
  ek1d_adaptive_smoother_kernel<S, NQ, D>
      <<<blocks_for(B), THREADS, 0, (cudaStream_t)stream>>>(
          (const S*)st, (const int*)counts, (const S*)m0, (S*)us, (S*)stds, B,
          ek0::read_adapt_consts<S, NQ>(k, n_save, max_iters));
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, bound with ctypes (ops/_build.py: ENTRIES). Each
// launches on the given stream, does not synchronise, and returns
// cudaGetLastError() after the launch. Instantiated for q = 3 (NQ = 4),
// d = 2, and the FHN and LV fields for the forwards. The filter's consts:
// At, Qt (NQ*NQ each), then pinv0, pinv1, t0, dt; its mode: 0 dynamic,
// 1 fixed, 2 fixedMAP, 3 fixedMV. The adaptive consts: those of
// ek0_adaptive.cu.
extern "C" {

#define EK1D_ENTRIES(NAME, FIELD, S, SUF)                                     \
  int ek1d_filter_##NAME##_##SUF(const void* m0, const void* ps, void* us,   \
                                 void* stds, void* lls, void* sig, int B,    \
                                 int T, int mode, const double* consts,      \
                                 void* stream) {                             \
    return launch_filter<S, 4, FIELD<S>>(m0, ps, us, stds, lls, sig, B, T,   \
                                         mode, consts, stream);              \
  }                                                                          \
  int ek1d_adaptive_##NAME##_##SUF(                                          \
      const void* m0, const void* ps, const void* dt0s, void* us,            \
      void* stds, void* lls, void* counts, int B, int n_save,                \
      int max_iters, const double* consts, void* stream) {                   \
    return launch_adaptive<S, 4, FIELD<S>>(m0, ps, dt0s, us, stds, lls,      \
                                           counts, B, n_save, max_iters,     \
                                           consts, stream);                  \
  }                                                                          \
  int ek1d_adaptive_stream_##NAME##_##SUF(                                   \
      const void* m0, const void* ps, const void* dt0s, void* st,            \
      void* lls, void* counts, int B, int n_save, int max_iters,             \
      const double* consts, void* stream) {                                  \
    return launch_stream<S, 4, FIELD<S>>(m0, ps, dt0s, st, lls, counts, B,   \
                                         n_save, max_iters, consts,          \
                                         stream);                            \
  }

EK1D_ENTRIES(fhn, Fhn, float, f32)
EK1D_ENTRIES(fhn, Fhn, double, f64)
EK1D_ENTRIES(lv, LotkaVolterra, float, f32)
EK1D_ENTRIES(lv, LotkaVolterra, double, f64)

#undef EK1D_ENTRIES

int ek1d_adaptive_smoother_f32(const void* st, const void* counts,
                               const void* m0, void* us, void* stds, int B,
                               int n_save, int max_iters,
                               const double* consts, void* stream) {
  return launch_smoother<float, 4, 2>(st, counts, m0, us, stds, B, n_save,
                                      max_iters, consts, stream);
}

int ek1d_adaptive_smoother_f64(const void* st, const void* counts,
                               const void* m0, void* us, void* stds, int B,
                               int n_save, int max_iters,
                               const double* consts, void* stream) {
  return launch_smoother<double, 4, 2>(st, counts, m0, us, stds, B, n_save,
                                       max_iters, consts, stream);
}

}  // extern "C"
