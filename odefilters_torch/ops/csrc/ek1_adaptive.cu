// Adaptive per-member dense EK1 ensemble solve for Hopper (sm_90a): three
// kernels.
//
// Replaces the TPU kernels in odefilters/ops/pallas_kernels.py:
//   ek1_adaptive_kernel          <- _ek1_adaptive_kernel (the PI-controlled
//                                   EK1(dynamic) filter with the field's
//                                   Jacobian in the kernel, outputs on the
//                                   save grid);
//   ek1_adaptive_stream_kernel   <- _ek1_adaptive_stream_kernel (the same
//                                   loop, streaming each accepted step);
//   ek1_adaptive_smoother_kernel <- _ek1_adaptive_smoother_kernel (the
//                                   square-root RTS pass over each member's
//                                   accepted steps).
// Their plain PyTorch versions, in the same order of operations, and the
// Python wrappers are in odefilters_torch/ops/ek1_adaptive.py; the
// forwards' per-member bodies are in ek1_adaptive.cuh, the step in
// ek1_fused.cuh and the loop's begin and control in ek0_adaptive.cuh; the
// smoother's group body in ek1_adaptive_group.cuh.
//
// Design (the forwards): one thread per ensemble member, its state in
// registers (and what does not fit, in local memory) for the whole step
// loop, 64 threads a block, any B >= 1. The TPU kernels step a block of
// 1024 lanes in lockstep and stream one row per block attempt, rejected
// and idle rows included; here each thread runs its own loop, writes its
// save rows when its accepted step reaches them, and streams only its
// accepted steps, at row nacc - 1 of a (max_iters, 75, B) stream (mean,
// factor, log dt_eff, s2, save index; B contiguous). The smoother spreads
// a member over NQ DIM = 8 lanes (ek1_adaptive_group.cuh), as the
// fixed-grid EK1 smoother does (ek1_group.cuh): a lane owns a row of the
// factors and of the gain and a column of each Gram-Schmidt stack, 32
// float32 (16 float64) members a CTA. Each member walks rows nacc - 1 .. 0
// of its own stream without masks, recomputing each interval's predicted
// factor by the forward's Gram-Schmidt instead of streaming it; its lanes
// load its row together and synchronise among themselves only, so that
// members that end early do not wait for the others.
//
// What bounds them (8192 members over (0, 20), 20 save intervals, abstol
// 1e-6, reltol 1e-4, float32): each attempt is the fixed-grid EK1 step,
// several thousand dependent operations (Gram-Schmidt on a 16 x 8 stack,
// the d x d Choleskys, the gain), and each smoothing step more (two
// Gram-Schmidts, eight 8 x 8 triangular solves); the stream is ~300 bytes
// an accepted step. Latency bounds them, not bandwidth: a forward thread
// holds ~200 (float32) to ~400 (float64) registers' worth of live state,
// more than the 255 a thread may hold, and spills; a smoother lane holds a
// row of each matrix. Built without FMA contraction (ops/_build.py:
// SOURCE_FLAGS): the loop turns a one-ulp difference into another accepted
// step sequence, so the kernels round op by op as their plain versions do
// on the card.

#include <cuda_runtime.h>

#include "ek1_adaptive.cuh"
#include "ek1_adaptive_group.cuh"
#include "fields.cuh"

using ek0::AdaptConsts;

namespace {

constexpr int THREADS = 64;

}  // namespace

// Adaptive filter of member b: us (S+1, D, B), stds (S+1, D, B) on the save
// grid (row 0 the exact initial state with std 0), lls (B,), counts (4, B).
template <typename S, int NQ, class F>
__global__ void __launch_bounds__(THREADS)
    ek1_adaptive_kernel(const S* __restrict__ m0, const S* __restrict__ ps,
                        const S* __restrict__ dt0s, S* __restrict__ us,
                        S* __restrict__ stds, S* __restrict__ lls,
                        int* __restrict__ counts, int B,
                        AdaptConsts<S, NQ> c) {
  constexpr int D = F::D;
  constexpr int N = NQ * D;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = (size_t)B;
  S p[F::NP];
  ek1a::Member<S, NQ, D> st;
  ek1a::start_member<S, NQ, F::NP, D>(m0, ps, dt0s, b, sB, c, p, st);
  auto emit = [&](int k) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      us[((size_t)k * D + j) * sB + b] = st.m[j];
      stds[((size_t)k * D + j) * sB + b] = ek1a::std_row<S, N, D>(st.L, j);
    }
  };
  emit(0);
  while (st.live(c)) {
    ek0::AttemptOut<S> o;
    ek1a::attempt<S, NQ, F>(c, p, st, o);
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
    ek1_adaptive_stream_kernel(const S* __restrict__ m0,
                               const S* __restrict__ ps,
                               const S* __restrict__ dt0s,
                               S* __restrict__ stream, S* __restrict__ lls,
                               int* __restrict__ counts, int B,
                               AdaptConsts<S, NQ> c) {
  constexpr int D = F::D;
  constexpr int N = NQ * D;
  constexpr int V = ek1a::Layout<N>::V;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = (size_t)B;
  S p[F::NP];
  ek1a::Member<S, NQ, D> st;
  ek1a::start_member<S, NQ, F::NP, D>(m0, ps, dt0s, b, sB, c, p, st);
  while (st.live(c)) {
    ek0::AttemptOut<S> o;
    ek1a::attempt<S, NQ, F>(c, p, st, o);
    if (o.accept)
      ek1a::store_row<S, N>(stream, (size_t)(st.nacc - 1) * V * sB + b, sB,
                            st.m, st.L, o.lh, o.s2,
                            o.reached ? S(o.seg_before + 1) : S(0));
  }
  lls[b] = st.ll;
  ek0::store_counts<S, D>(counts, b, sB, st, c.n_save);
}

// Backward pass over each member's rows nacc - 1 .. 0 of its stream, into
// us, stds (S+1, D, B): a group of NQ D lanes per member, MB members a CTA
// (ek1_adaptive_group.cuh). Two CTAs an SM (at most 128 registers a lane
// in float32): 8192 members then fit the card at once.
template <typename S, int NQ, int D, int MB>
__global__ void __launch_bounds__(MB * NQ * D, 2)
    ek1_adaptive_smoother_kernel(const S* __restrict__ stream,
                                 const int* __restrict__ counts,
                                 const S* __restrict__ m0,
                                 S* __restrict__ us, S* __restrict__ stds,
                                 int B, AdaptConsts<S, NQ> c) {
  ek1ag::smoother_group<S, NQ, D, MB>(c, stream, counts, m0, us, stds, B);
}

namespace {

inline int blocks_for(int B) { return (B + THREADS - 1) / THREADS; }

inline bool bad_sizes(int B, int n_save, int max_iters) {
  return B < 1 || n_save < 1 || max_iters < 1;
}

template <typename S, int NQ, class F>
int launch_filter(const void* m0, const void* ps, const void* dt0s, void* us,
                  void* stds, void* lls, void* counts, int B, int n_save,
                  int max_iters, const double* k, void* stream) {
  if (bad_sizes(B, n_save, max_iters)) return (int)cudaErrorInvalidValue;
  ek1_adaptive_kernel<S, NQ, F>
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
  ek1_adaptive_stream_kernel<S, NQ, F>
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
  constexpr int MB = ek1g::Tile<S>::MB;
  constexpr size_t sh = ek1ag::smoother_smem_bytes<S, NQ, D, MB>();
  const void* kern = (const void*)ek1_adaptive_smoother_kernel<S, NQ, D, MB>;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sh);
  if (e != cudaSuccess) return (int)e;
  ek1_adaptive_smoother_kernel<S, NQ, D, MB>
      <<<(B + MB - 1) / MB, MB * NQ * D, sh, (cudaStream_t)stream>>>(
          (const S*)st, (const int*)counts, (const S*)m0, (S*)us, (S*)stds, B,
          ek0::read_adapt_consts<S, NQ>(k, n_save, max_iters));
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, bound with ctypes (ops/_build.py: ENTRIES). Each
// launches on the given stream, does not synchronise, and returns
// cudaGetLastError() after the launch. Instantiated for q = 3 (NQ = 4),
// d = 2, and the FHN and LV fields (with their Jacobians) for the forwards.
// consts: those of ek0_adaptive.cu.
extern "C" {

#define EK1_ADAPTIVE_ENTRIES(NAME, FIELD, S, SUF)                             \
  int ek1_adaptive_##NAME##_##SUF(                                             \
      const void* m0, const void* ps, const void* dt0s, void* us,           \
      void* stds, void* lls, void* counts, int B, int n_save,               \
      int max_iters, const double* consts, void* stream) {                  \
    return launch_filter<S, 4, FIELD<S>>(m0, ps, dt0s, us, stds, lls,       \
                                         counts, B, n_save, max_iters,      \
                                         consts, stream);                   \
  }                                                                         \
  int ek1_adaptive_stream_##NAME##_##SUF(                                      \
      const void* m0, const void* ps, const void* dt0s, void* st,           \
      void* lls, void* counts, int B, int n_save, int max_iters,            \
      const double* consts, void* stream) {                                 \
    return launch_stream<S, 4, FIELD<S>>(m0, ps, dt0s, st, lls, counts, B,  \
                                         n_save, max_iters, consts,         \
                                         stream);                           \
  }

EK1_ADAPTIVE_ENTRIES(fhn, Fhn, float, f32)
EK1_ADAPTIVE_ENTRIES(fhn, Fhn, double, f64)
EK1_ADAPTIVE_ENTRIES(lv, LotkaVolterra, float, f32)
EK1_ADAPTIVE_ENTRIES(lv, LotkaVolterra, double, f64)

#undef EK1_ADAPTIVE_ENTRIES

int ek1_adaptive_smoother_f32(const void* st, const void* counts,
                              const void* m0, void* us, void* stds, int B,
                              int n_save, int max_iters, const double* consts,
                              void* stream) {
  return launch_smoother<float, 4, 2>(st, counts, m0, us, stds, B, n_save,
                                      max_iters, consts, stream);
}

int ek1_adaptive_smoother_f64(const void* st, const void* counts,
                              const void* m0, void* us, void* stds, int B,
                              int n_save, int max_iters, const double* consts,
                              void* stream) {
  return launch_smoother<double, 4, 2>(st, counts, m0, us, stds, B, n_save,
                                       max_iters, consts, stream);
}

}  // extern "C"
