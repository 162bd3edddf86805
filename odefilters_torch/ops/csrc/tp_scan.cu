// The fused time-parallel scan for Hopper (sm_90a): three kernels.
//
// Replaces the TPU kernels in odefilters/parallel/pallas_scan.py:
//   tp_chunk_scan_kernel  <- _chunk_scan_kernel (the inclusive prefix within
//                            each of 1024 chunks);
//   tp_totals_scan_kernel <- _totals_scan_kernel (Hillis-Steele over the
//                            1024 chunk totals, then the exclusive shift);
//   tp_fixup_kernel       <- _fixup_kernel (each prefix combined with the
//                            total of the chunks before it).
// Their plain PyTorch versions, in the same order of operations, and the
// Python wrappers are in odefilters_torch/ops/tp_scan.py; the kernels and
// their combines in tp_scan.cuh. This unit instantiates them in float32,
// tp_scan_f64.cu in float64, so that nvcc builds the two in parallel.
//
// Design. Elements are packed (L, V, 1024): row k, value v, chunk c, the
// chunk contiguous. The chunk scan runs a thread per chunk over its L
// rows, the carry being the row it just wrote. The totals scan is one
// cooperative launch of a thread per chunk over a few CTAs (a combine needs
// far more than the 64 registers a thread of a 1024-thread CTA may hold):
// ten rounds of combine(x[i - shift], x[i]) where i >= shift, else a copy,
// through two ping-pong buffers with a grid barrier between rounds; the
// last round writes x[i] to entry (i + 1) mod 1024 of the output, which is
// the exclusive shift. The fixup runs a thread per element. The combines
// are built once per dtype (not inlined) and called by all three.
//
// What bounds them (N = 16384, D = 8): the chunk scan and the fixup each
// read and write the N elements once (13.6 MB of float32 filter elements
// each way) and do one combine per element (17,592 operations for a filter
// element as tp_scan.cuh runs them; chip_smoke.py: tp_combine_ops),
// ~0.3 GFLOP a kernel: a few microseconds on an H100. The totals scan's
// function, an inclusive scan of the 1024 totals, needs 1023 combines and
// moves 1.7 MB: a bound of half a microsecond, set by its bytes (its rounds
// run 9217 combines). A thread's combines run one after
// the other, with the working set spilled to local memory, so they are
// latency-bound (chip_smoke.py, phase 43). Built without FMA contraction
// (ops/_build.py: SOURCE_FLAGS): the kernels round op by op as their plain
// versions do on the card.

#include "tp_scan.cuh"

// Plain C entry points, bound with ctypes (ops/_build.py: ENTRIES). kind: 0
// filter elements (A, b, U, eta, Z), 1 smoothing elements (E, g, P), at
// D = 8. Each launches on the given stream, does not synchronise, and
// returns the CUDA error code of the launch (the totals scan
// cudaErrorCooperativeLaunchTooLarge when its grid cannot be co-resident).
extern "C" {

int tp_chunk_scan_f32(int kind, const void* elems, void* out, int L,
                      void* stream) {
  return tp::chunk_scan_kind<float>(kind, elems, out, L, stream);
}

int tp_totals_scan_f32(int kind, const void* totals, void* work, void* out,
                       void* stream) {
  return tp::totals_scan_kind<float>(kind, totals, work, out, stream);
}

int tp_fixup_f32(int kind, const void* prefixes, const void* t_excl,
                 void* out, int L, void* stream) {
  return tp::fixup_kind<float>(kind, prefixes, t_excl, out, L, stream);
}

}  // extern "C"
