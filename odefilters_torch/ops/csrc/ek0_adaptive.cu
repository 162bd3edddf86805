// Adaptive per-member EK0 ensemble solve and its joint posterior samples
// for Hopper (sm_90a): four kernels.
//
// Replaces the TPU kernels in odefilters/ops/pallas_kernels.py:
//   ek0_adaptive_kernel          <- _ek0_adaptive_kernel (the PI-controlled
//                                   EK0(dynamic) filter, outputs on the
//                                   save grid);
//   ek0_adaptive_stream_kernel   <- _ek0_adaptive_stream_kernel (the same
//                                   loop, streaming each accepted step);
//   ek0_adaptive_smoother_kernel <- _ek0_adaptive_smoother_kernel (the
//                                   square-root RTS pass over each member's
//                                   accepted steps);
//   ek0_adaptive_sampler_kernel  <- _ek0_adaptive_sampler_kernel (the
//                                   backward conditioning sampler over the
//                                   same rows, S samples a member).
// Their plain PyTorch versions, in the same order of operations, and the
// Python wrappers are in odefilters_torch/ops/ek0_adaptive.py and (the
// sampler) ek0_adaptive_sample.py; the per-member bodies are in
// ek0_adaptive.cuh.
//
// Design: one thread per ensemble member, its whole state in registers for
// the whole step loop, 64 threads a block, any B >= 1. The covariance is
// carried as a factor and re-triangularised by modified Gram-Schmidt at each
// prediction, where the TPU kernels carry it plain: in float32 the plain
// covariance loses its positive definiteness and the smoother's Cholesky
// factor of it blows up. The TPU kernels step a block of 1024 lanes in
// lockstep and emit a save row only when every lane has reached it (a lane
// that waits changes nothing); here each thread runs its own loop and writes
// its save row when its accepted step reaches the save time, so its result
// is the TPU lane's. The TPU forward streamed
// one row per block attempt, rejected and idle rows included; here a thread
// writes only its accepted steps, at row nacc - 1 of a (max_iters, V, B)
// stream (V = 27 at q = 3, d = 2: mean, factor, log dt_eff, s2, save index;
// B contiguous), and the backward thread walks rows nacc - 1 .. 0 of its
// member without masks, the factor preconditioned at the next step's size
// by scaling its rows (no Cholesky factorisation).
//
// What bounds them (8192 members over (0, 20), 20 save intervals, abstol
// 1e-6, reltol 1e-4, float32): the filter reads its inputs and writes the
// save grid, about 2 MB; the stream kernel writes its accepted rows (108 B
// each); the smoother reads them back. Each attempt is ~1,000 dependent
// operations with a dozen transcendentals, and members take different
// numbers of attempts, so a warp runs as long as its slowest member: the
// bound is the operations, at one thread per member about one block of 64
// per SM, and latency, not bandwidth or the operation rate, bounds them.
// The sampler walks the smoother's rows with S samples where the smoother
// carries one smoothed state: a thread keeps a chunk of SC samples in
// registers (1, 2, 4 or 8; up to 4 in float64) and the grid's y dimension
// runs over the chunks, each recomputing the shared gain and factor work.
// The normals are indexed by the member's accepted step, not by the TPU
// block's attempt row, which depended on the block's lockstep.
// Built without FMA contraction (ops/_build.py: SOURCE_FLAGS): the loop
// turns a one-ulp difference into another accepted step sequence, so the
// kernels round op by op as their plain versions do on the card.

#include <cuda_runtime.h>

#include "ek0_adaptive.cuh"
#include "fields.cuh"

using ek0::AdaptConsts;
using ek0::AdaptLayout;

namespace {

constexpr int THREADS = 64;

}  // namespace

// Adaptive filter of member b: us (S+1, D, B), stds (S+1, B) on the save
// grid (row 0 the exact initial state with std 0), lls (B,), counts (4, B).
template <typename S, int NQ, class F>
__global__ void __launch_bounds__(THREADS)
    ek0_adaptive_kernel(const S* __restrict__ m0, const S* __restrict__ ps,
                        const S* __restrict__ dt0s, S* __restrict__ us,
                        S* __restrict__ stds, S* __restrict__ lls,
                        int* __restrict__ counts, int B,
                        AdaptConsts<S, NQ> c) {
  constexpr int D = F::D;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = (size_t)B;
  S p[F::NP];
  ek0::Member<S, NQ, D> st;
  ek0::start_member<S, NQ, F::NP, D>(m0, ps, dt0s, b, sB, c, p, st);
  auto emit = [&](int k) {
#pragma unroll
    for (int j = 0; j < D; ++j) us[((size_t)k * D + j) * sB + b] = st.m[0][j];
    stds[(size_t)k * sB + b] = ek0::std_row0<S, NQ>(st.L);
  };
  emit(0);
  while (st.live(c)) {
    ek0::AttemptOut<S> o;
    ek0::attempt<S, NQ, F>(c, p, st, o);
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
    ek0_adaptive_stream_kernel(const S* __restrict__ m0,
                               const S* __restrict__ ps,
                               const S* __restrict__ dt0s,
                               S* __restrict__ stream, S* __restrict__ lls,
                               int* __restrict__ counts, int B,
                               AdaptConsts<S, NQ> c) {
  constexpr int D = F::D;
  constexpr int V = AdaptLayout<NQ, D>::V;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = (size_t)B;
  S p[F::NP];
  ek0::Member<S, NQ, D> st;
  ek0::start_member<S, NQ, F::NP, D>(m0, ps, dt0s, b, sB, c, p, st);
  while (st.live(c)) {
    ek0::AttemptOut<S> o;
    ek0::attempt<S, NQ, F>(c, p, st, o);
    if (o.accept)
      ek0::store_adapt_row<S, NQ, D>(
          stream, (size_t)(st.nacc - 1) * V * sB + b, sB, st.m, st.L, o.lh,
          o.s2, o.reached ? S(o.seg_before + 1) : S(0));
  }
  lls[b] = st.ll;
  ek0::store_counts<S, D>(counts, b, sB, st, c.n_save);
}

// Backward pass of member b over rows nacc - 1 .. 0 of its stream, into
// us (S+1, D, B) and stds (S+1, B) (ek0_adaptive.cuh: smooth_member).
template <typename S, int NQ, int D>
__global__ void __launch_bounds__(THREADS)
    ek0_adaptive_smoother_kernel(const S* __restrict__ stream,
                                 const int* __restrict__ counts,
                                 const S* __restrict__ m0,
                                 S* __restrict__ us, S* __restrict__ stds,
                                 int B, AdaptConsts<S, NQ> c) {
  constexpr int V = AdaptLayout<NQ, D>::V;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = (size_t)B;
  S first[D];
#pragma unroll
  for (int j = 0; j < D; ++j) first[j] = m0[j * sB + b];
  ek0::smooth_member<S, NQ, D>(
      c, counts[b], counts[3 * sB + b], first,
      [&](int k, ek0::AdaptRow<S, NQ, D>& r) {
        ek0::load_adapt_row<S, NQ, D>(stream, (size_t)k * V * sB + b, sB, r);
      },
      [&](int k, const S (&m0row)[D], S std) {
#pragma unroll
        for (int j = 0; j < D; ++j)
          us[((size_t)k * D + j) * sB + b] = m0row[j];
        stds[(size_t)k * sB + b] = std;
      });
}

// Backward sampler: samples s0 .. s0 + SC - 1 (s0 = blockIdx.y * SC, those
// below NS) of member b over rows nacc - 1 .. 0 of its stream, with the
// normals zn (max_iters, NS, NQ, D, B) (row k for the k-th accepted step),
// into out (S+1, NS, D, B). Row 0 is the exact initial state, each save row
// the samples at the step that reached it, the rows past the save points
// reached the terminal draw.
template <typename S, int NQ, int D, int SC>
__global__ void __launch_bounds__(THREADS)
    ek0_adaptive_sampler_kernel(const S* __restrict__ stream,
                                const int* __restrict__ counts,
                                const S* __restrict__ m0,
                                const S* __restrict__ zn, S* __restrict__ out,
                                int B, int NS, AdaptConsts<S, NQ> c) {
  constexpr int V = AdaptLayout<NQ, D>::V;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int s0 = blockIdx.y * SC;
  const int ns = NS - s0 < SC ? NS - s0 : SC;
  const size_t sB = (size_t)B;
  const int K = counts[b], segs = counts[3 * sB + b];
  S x[SC][NQ][D];
  auto emit = [&](int k) {
#pragma unroll
    for (int s = 0; s < SC; ++s) {
      if (s >= ns) continue;
      const size_t o = ((size_t)k * NS + s0 + s) * D * sB + b;
#pragma unroll
      for (int j = 0; j < D; ++j) out[o + j * sB] = x[s][0][j];
    }
  };
  auto z_of = [&](int k) {
    return [=](int s, int l, int j) {
      return zn[(((size_t)k * NS + s0 + s) * NQ * D + l * D + j) * sB + b];
    };
  };
#pragma unroll
  for (int s = 0; s < SC; ++s)
#pragma unroll
    for (int j = 0; j < D; ++j) x[s][0][j] = m0[j * sB + b];
  emit(0);
  if (K == 0) {
    for (int k = 1; k <= c.n_save; ++k) emit(k);
    return;
  }
  ek0::AdaptRow<S, NQ, D> r;
  ek0::load_adapt_row<S, NQ, D>(stream, (size_t)(K - 1) * V * sB + b, sB, r);
  ek0::terminal_draw<S, NQ, D, SC>(r.m, r.L, r.lh, ns, z_of(K - 1), x);
  for (int k = segs + 1; k <= c.n_save; ++k) emit(k);
  if (r.mark > S(0.5)) emit((int)r.mark);
  S pend_lh = r.lh, pend_s2 = r.s2;
  for (int k = K - 2; k >= 0; --k) {
    ek0::load_adapt_row<S, NQ, D>(stream, (size_t)k * V * sB + b, sB, r);
    ek0::sampler_step<S, NQ, D, SC>(c, r.m, r.L, pend_lh, pend_s2, ns,
                                    z_of(k), x);
    pend_lh = r.lh;
    pend_s2 = r.s2;
    if (r.mark > S(0.5)) emit((int)r.mark);
  }
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
  ek0_adaptive_kernel<S, NQ, F>
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
  ek0_adaptive_stream_kernel<S, NQ, F>
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
  ek0_adaptive_smoother_kernel<S, NQ, D>
      <<<blocks_for(B), THREADS, 0, (cudaStream_t)stream>>>(
          (const S*)st, (const int*)counts, (const S*)m0, (S*)us, (S*)stds, B,
          ek0::read_adapt_consts<S, NQ>(k, n_save, max_iters));
  return (int)cudaGetLastError();
}

template <typename S, int NQ, int D, int SC>
void launch_sampler_chunk(const void* st, const void* counts, const void* m0,
                          const void* zn, void* out, int B, int NS,
                          const AdaptConsts<S, NQ>& c, cudaStream_t stream) {
  const dim3 grid(blocks_for(B), (NS + SC - 1) / SC);
  ek0_adaptive_sampler_kernel<S, NQ, D, SC><<<grid, THREADS, 0, stream>>>(
      (const S*)st, (const int*)counts, (const S*)m0, (const S*)zn, (S*)out,
      B, NS, c);
}

// The chunk of samples a thread keeps in registers: the largest of
// 1, 2, 4, 8 not above NS, at most MAX_SC.
template <typename S, int NQ, int D, int MAX_SC>
int launch_sampler(const void* st, const void* counts, const void* m0,
                   const void* zn, void* out, int B, int NS, int n_save,
                   int max_iters, const double* k, void* stream) {
  if (bad_sizes(B, n_save, max_iters) || NS < 1)
    return (int)cudaErrorInvalidValue;
  const AdaptConsts<S, NQ> c =
      ek0::read_adapt_consts<S, NQ>(k, n_save, max_iters);
  const cudaStream_t s = (cudaStream_t)stream;
  if constexpr (MAX_SC >= 8) {
    if (NS >= 8) {
      launch_sampler_chunk<S, NQ, D, 8>(st, counts, m0, zn, out, B, NS, c, s);
      return (int)cudaGetLastError();
    }
  }
  if (NS >= 4)
    launch_sampler_chunk<S, NQ, D, 4>(st, counts, m0, zn, out, B, NS, c, s);
  else if (NS >= 2)
    launch_sampler_chunk<S, NQ, D, 2>(st, counts, m0, zn, out, B, NS, c, s);
  else
    launch_sampler_chunk<S, NQ, D, 1>(st, counts, m0, zn, out, B, NS, c, s);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, bound with ctypes (ops/_build.py: ENTRIES). Each
// launches on the given stream, does not synchronise, and returns
// cudaGetLastError() after the launch. Instantiated for d = 2, the filter
// at q = 1, 2, 3 (NQ = 2, 3, 4: the time-parallel solves' warm start runs
// it at min(q, 3), as the JAX package does), the other three kernels at
// q = 3, and the FHN and LV fields for the forwards. consts: At, QLt (NQ*NQ
// each), then qbx, t0, dt_save, abstol, reltol, dtmin, beta1, beta2.
extern "C" {

// the filter's arguments, and their names, in each order's entry
#define EK0_ADAPTIVE_FILTER_ARGS                                             \
  const void* m0, const void* ps, const void* dt0s, void* us, void* stds,   \
      void* lls, void* counts, int B, int n_save, int max_iters,            \
      const double* consts, void* stream
#define EK0_ADAPTIVE_FILTER_PASS                                             \
  m0, ps, dt0s, us, stds, lls, counts, B, n_save, max_iters, consts, stream

#define EK0_ADAPTIVE_ENTRIES(NAME, FIELD, S, SUF)                             \
  int ek0_adaptive_q1_##NAME##_##SUF(EK0_ADAPTIVE_FILTER_ARGS) {             \
    return launch_filter<S, 2, FIELD<S>>(EK0_ADAPTIVE_FILTER_PASS);         \
  }                                                                         \
  int ek0_adaptive_q2_##NAME##_##SUF(EK0_ADAPTIVE_FILTER_ARGS) {             \
    return launch_filter<S, 3, FIELD<S>>(EK0_ADAPTIVE_FILTER_PASS);         \
  }                                                                         \
  int ek0_adaptive_q3_##NAME##_##SUF(EK0_ADAPTIVE_FILTER_ARGS) {             \
    return launch_filter<S, 4, FIELD<S>>(EK0_ADAPTIVE_FILTER_PASS);         \
  }                                                                         \
  int ek0_adaptive_stream_##NAME##_##SUF(                                      \
      const void* m0, const void* ps, const void* dt0s, void* st,           \
      void* lls, void* counts, int B, int n_save, int max_iters,            \
      const double* consts, void* stream) {                                 \
    return launch_stream<S, 4, FIELD<S>>(m0, ps, dt0s, st, lls, counts, B,  \
                                         n_save, max_iters, consts,         \
                                         stream);                           \
  }

EK0_ADAPTIVE_ENTRIES(fhn, Fhn, float, f32)
EK0_ADAPTIVE_ENTRIES(fhn, Fhn, double, f64)
EK0_ADAPTIVE_ENTRIES(lv, LotkaVolterra, float, f32)
EK0_ADAPTIVE_ENTRIES(lv, LotkaVolterra, double, f64)

#undef EK0_ADAPTIVE_ENTRIES
#undef EK0_ADAPTIVE_FILTER_ARGS
#undef EK0_ADAPTIVE_FILTER_PASS

int ek0_adaptive_smoother_f32(const void* st, const void* counts,
                              const void* m0, void* us, void* stds, int B,
                              int n_save, int max_iters, const double* consts,
                              void* stream) {
  return launch_smoother<float, 4, 2>(st, counts, m0, us, stds, B, n_save,
                                      max_iters, consts, stream);
}

int ek0_adaptive_smoother_f64(const void* st, const void* counts,
                              const void* m0, void* us, void* stds, int B,
                              int n_save, int max_iters, const double* consts,
                              void* stream) {
  return launch_smoother<double, 4, 2>(st, counts, m0, us, stds, B, n_save,
                                       max_iters, consts, stream);
}

// the sampler: (stream, counts, m0, normals, out, B, n_samples, n_save,
// max_iters, consts, stream)
int ek0_adaptive_sampler_f32(const void* st, const void* counts,
                             const void* m0, const void* zn, void* out, int B,
                             int NS, int n_save, int max_iters,
                             const double* consts, void* stream) {
  return launch_sampler<float, 4, 2, 8>(st, counts, m0, zn, out, B, NS,
                                        n_save, max_iters, consts, stream);
}

int ek0_adaptive_sampler_f64(const void* st, const void* counts,
                             const void* m0, const void* zn, void* out, int B,
                             int NS, int n_save, int max_iters,
                             const double* consts, void* stream) {
  return launch_sampler<double, 4, 2, 4>(st, counts, m0, zn, out, B, NS,
                                         n_save, max_iters, consts, stream);
}

}  // extern "C"
