// Fused EK1 dense-factor kernels for Hopper (sm_90a): three kernels.
//
// Replaces the TPU kernels in odefilters/ops/pallas_kernels.py:
//   ek1_filter_states_kernel <- _ek1_filter_states_kernel (the full D x D
//                               square-root EKF with the field's Jacobian
//                               in the kernel; dynamic, fixed or fixedMAP
//                               diffusion; optional IEKS linearization
//                               rows);
//   ekd_smoother_kernel      <- _ekd_smoother_kernel (the backward
//                               square-root RTS pass over its stream);
//   ekd_sampler_kernel       <- _ekd_sampler_kernel (the backward
//                               conditioning sampler, S samples a member).
// Their plain PyTorch versions, in the same order of operations, and the
// Python wrappers are in odefilters_torch/ops/ek1_fused.py; the per-member
// bodies are in ek1_fused.cuh.
//
// Design: one thread per ensemble member, its state in registers (and
// what does not fit, in local memory) for the whole time loop, every index
// loop unrolled so that the structural zeros of A = kron(At, I) and
// QLf = kron(QLt, I) cost nothing; arrays (T+1, rows, B) with the member
// index contiguous, so that a warp's loads and stores coalesce; 64 threads
// a block, any B >= 1. The filter streams 109 values a step at q = 3, d = 2
// (mean, full factor, s2 and the lower triangle of the predicted factor,
// which the backward passes read instead of re-factoring; 73 without a
// backward pass). The sampler keeps a chunk of SC samples in registers
// (SC = 1, 2 or 4 in float32, up to 2 in float64, the largest not above S)
// and recomputes the shared per-step work once per chunk: the grid's y
// dimension runs over the chunks.
//
// What bounds them (8192 members, 500 steps, float32): by bytes, the
// filter writes a 1.79 GB stream (0.53 ms at 3.35 TB/s), the smoother reads
// it (0.55 ms with its outputs), the sampler reads it and the normals
// (0.58 ms at S = 1). Each is a serial recursion per member of several
// thousand dependent operations a step (Gram-Schmidt on a 16 x 8 or
// 24 x 8 stack, eight 8 x 8 triangular solves for the gain), with about
// 200 (float32) to 400 (float64) registers' worth of live state a thread,
// more than the 255 a thread may hold: latency and local-memory spills
// bound them, not bandwidth. Built without FMA contraction
// (ops/_build.py: SOURCE_FLAGS): the stream's s2 and the static models'
// sigma^2 carry the innovation at the accuracy floor, so the kernels round
// op by op as their plain versions do on the card.

#include <cuda_runtime.h>

#include "ek1_fused.cuh"
#include "fields.cuh"

using ek1::Consts;

namespace {

constexpr int THREADS = 64;

inline int blocks_for(int B) { return (B + THREADS - 1) / THREADS; }

// consts: At, QLt (NQ*NQ each), then pinv0 and, for the filter, pinv1,
// t0, dt
template <typename S, int NQ, int DIM>
Consts<S, NQ, DIM> read_consts(const double* k, bool with_grid) {
  Consts<S, NQ, DIM> c;
  double QLt[NQ][NQ];
  int o = 0;
  for (int i = 0; i < NQ; ++i)
    for (int l = 0; l < NQ; ++l) c.At[i][l] = S(k[o++]);
  for (int i = 0; i < NQ; ++i)
    for (int l = 0; l < NQ; ++l) {
      QLt[i][l] = k[o++];
      c.QLt[i][l] = S(QLt[i][l]);
    }
  for (int j = 0; j < NQ * DIM; ++j)
    c.qsq[j] = S(QLt[j / DIM][j / DIM] * QLt[j / DIM][j / DIM]);
  c.pinv0 = S(k[o++]);
  c.pinv1 = c.t0 = c.dt = S(0);
  if (with_grid) {
    c.pinv1 = S(k[o++]);
    c.t0 = S(k[o++]);
    c.dt = S(k[o++]);
  }
  return c;
}

}  // namespace

// The EK1 filter: row 0 (the exact initial state), then one row per step
// into st (T+1, V, B); sigma^2 into sig under a static model.
template <typename S, int NQ, class F, bool STATIC>
__global__ void __launch_bounds__(THREADS)
    ek1_filter_states_kernel(const S* __restrict__ m0,
                             const S* __restrict__ ps,
                             const S* __restrict__ lin, S* __restrict__ st,
                             S* __restrict__ sig, int B, int T, int mode,
                             int smooth, Consts<S, NQ, F::D> c) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  ek1::filter_member<S, NQ, F, STATIC>(c, m0, ps, lin, st, sig, b, B, T,
                                       mode, smooth != 0);
}

// The backward RTS pass: st (T+1, V, B) into us, stds (T+1, DIM, B).
template <typename S, int NQ, int DIM>
__global__ void __launch_bounds__(THREADS)
    ekd_smoother_kernel(const S* __restrict__ st, S* __restrict__ us,
                        S* __restrict__ stds, int B, int T,
                        Consts<S, NQ, DIM> c) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  ek1::smoother_member<S, NQ, DIM>(c, st, us, stds, b, B, T);
}

// The backward sampler: samples blockIdx.y * SC .. of member b.
template <typename S, int NQ, int DIM, int SC>
__global__ void __launch_bounds__(THREADS)
    ekd_sampler_kernel(const S* __restrict__ st, const S* __restrict__ zn,
                       S* __restrict__ out, int B, int T, int NS,
                       Consts<S, NQ, DIM> c) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  ek1::sampler_member<S, NQ, DIM, SC>(c, st, zn, out, b, B, T, NS,
                                      blockIdx.y * SC);
}

namespace {

template <typename S, int NQ, class F>
int launch_filter(const void* m0, const void* ps, const void* lin, void* st,
                  void* sig, int B, int T, int mode, int smooth,
                  const double* k, void* stream) {
  if (B < 1 || T < 0 || mode < ek1::DYNAMIC || mode > ek1::FIXED_MAP
      || (mode != ek1::DYNAMIC && (lin != nullptr || sig == nullptr)))
    return (int)cudaErrorInvalidValue;
  const auto c = read_consts<S, NQ, F::D>(k, true);
  const cudaStream_t s = (cudaStream_t)stream;
  if (mode == ek1::DYNAMIC)
    ek1_filter_states_kernel<S, NQ, F, false><<<blocks_for(B), THREADS, 0, s>>>(
        (const S*)m0, (const S*)ps, (const S*)lin, (S*)st, (S*)sig, B, T, mode,
        smooth, c);
  else
    ek1_filter_states_kernel<S, NQ, F, true><<<blocks_for(B), THREADS, 0, s>>>(
        (const S*)m0, (const S*)ps, (const S*)lin, (S*)st, (S*)sig, B, T, mode,
        smooth, c);
  return (int)cudaGetLastError();
}

template <typename S, int NQ, int DIM>
int launch_smoother(const void* st, void* us, void* stds, int B, int T,
                    const double* k, void* stream) {
  if (B < 1 || T < 0) return (int)cudaErrorInvalidValue;
  ekd_smoother_kernel<S, NQ, DIM>
      <<<blocks_for(B), THREADS, 0, (cudaStream_t)stream>>>(
          (const S*)st, (S*)us, (S*)stds, B, T,
          read_consts<S, NQ, DIM>(k, false));
  return (int)cudaGetLastError();
}

template <typename S, int NQ, int DIM, int SC>
void launch_sampler_chunk(const void* st, const void* zn, void* out, int B,
                          int T, int NS, const Consts<S, NQ, DIM>& c,
                          cudaStream_t stream) {
  const dim3 grid(blocks_for(B), (NS + SC - 1) / SC);
  ekd_sampler_kernel<S, NQ, DIM, SC><<<grid, THREADS, 0, stream>>>(
      (const S*)st, (const S*)zn, (S*)out, B, T, NS, c);
}

// The chunk of samples a thread keeps in registers: the largest of 1, 2, 4
// not above NS, at most MAX_SC.
template <typename S, int NQ, int DIM, int MAX_SC>
int launch_sampler(const void* st, const void* zn, void* out, int B, int T,
                   int NS, const double* k, void* stream) {
  if (B < 1 || T < 0 || NS < 1) return (int)cudaErrorInvalidValue;
  const auto c = read_consts<S, NQ, DIM>(k, false);
  const cudaStream_t s = (cudaStream_t)stream;
  if constexpr (MAX_SC >= 4) {
    if (NS >= 4) {
      launch_sampler_chunk<S, NQ, DIM, 4>(st, zn, out, B, T, NS, c, s);
      return (int)cudaGetLastError();
    }
  }
  if (NS >= 2)
    launch_sampler_chunk<S, NQ, DIM, 2>(st, zn, out, B, T, NS, c, s);
  else
    launch_sampler_chunk<S, NQ, DIM, 1>(st, zn, out, B, T, NS, c, s);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, bound with ctypes (ops/_build.py: ENTRIES). Each
// launches on the given stream, does not synchronise, and returns
// cudaGetLastError() after the launch. Instantiated for q = 3 (NQ = 4),
// d = 2, and the FHN field and its Jacobian for the filter.
extern "C" {

// mode: 0 dynamic, 1 fixed, 2 fixedMAP; lin may be null (no IEKS rows;
// dynamic only); sig is written under a static mode; smooth: stream Lp
int ek1_filter_states_fhn_f32(const void* m0, const void* ps, const void* lin,
                              void* st, void* sig, int B, int T, int mode,
                              int smooth, const double* consts,
                              void* stream) {
  return launch_filter<float, 4, Fhn<float>>(m0, ps, lin, st, sig, B, T,
                                             mode, smooth, consts, stream);
}

int ek1_filter_states_fhn_f64(const void* m0, const void* ps, const void* lin,
                              void* st, void* sig, int B, int T, int mode,
                              int smooth, const double* consts,
                              void* stream) {
  return launch_filter<double, 4, Fhn<double>>(m0, ps, lin, st, sig, B, T,
                                               mode, smooth, consts, stream);
}

int ekd_smoother_f32(const void* st, void* us, void* stds, int B, int T,
                     const double* consts, void* stream) {
  return launch_smoother<float, 4, 2>(st, us, stds, B, T, consts, stream);
}

int ekd_smoother_f64(const void* st, void* us, void* stds, int B, int T,
                     const double* consts, void* stream) {
  return launch_smoother<double, 4, 2>(st, us, stds, B, T, consts, stream);
}

int ekd_sampler_f32(const void* st, const void* zn, void* out, int B, int T,
                    int NS, const double* consts, void* stream) {
  return launch_sampler<float, 4, 2, 4>(st, zn, out, B, T, NS, consts,
                                        stream);
}

int ekd_sampler_f64(const void* st, const void* zn, void* out, int B, int T,
                    int NS, const double* consts, void* stream) {
  return launch_sampler<double, 4, 2, 2>(st, zn, out, B, T, NS, consts,
                                         stream);
}

}  // extern "C"
