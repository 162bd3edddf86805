// The fused time-parallel scan for Hopper (sm_90a) at D = 8: the
// one-thread chunk scan and fixup (the group kernels of tp_group.cu run
// every other D and the totals scan).
//
// Replaces the TPU kernels in odefilters/parallel/pallas_scan.py at D = 8:
//   tp_chunk_scan_kernel <- _chunk_scan_kernel (the inclusive prefix within
//                           each of 1024 chunks);
//   tp_fixup_kernel      <- _fixup_kernel (each prefix combined with the
//                           total of the chunks before it).
// (_totals_scan_kernel, the scan of the 1024 chunk totals, runs
// tp_group.cuh's group kernel at every D.) Their plain PyTorch versions, in
// the same order of operations, and the Python wrappers are in
// odefilters_torch/ops/tp_scan.py; the kernels and their combines in
// tp_scan.cuh. This unit instantiates them in float32, tp_scan_f64.cu in
// float64, so that nvcc builds the two in parallel.
//
// Design. Elements are packed (L, V, 1024): row k, value v, chunk c, the
// chunk contiguous. The chunk scan runs a thread per chunk over its L
// rows, the carry being the row it just wrote. The fixup runs a thread per
// element. The combines are built once per dtype (not inlined) and called
// by both.
//
// What bounds them (N = 16384, D = 8): each reads and writes the N
// elements once (13.6 MB of float32 filter elements each way) and does one
// combine per element (17,592 operations for a filter element as
// tp_scan.cuh runs them; chip_smoke.py: tp_combine_ops), ~0.3 GFLOP a
// kernel: a few microseconds on an H100. A thread's combine runs one
// operation after the other, with the working set spilled to local memory,
// so they are latency-bound (chip_smoke.py, phase 43). Built without FMA
// contraction (ops/_build.py: SOURCE_FLAGS): the kernels round op by op as
// their plain versions do on the card.

#include "tp_scan.cuh"

// Plain C entry points at D = 8, called by tp_group.cu's entries for the
// chunk scan and the fixup at that D. kind: 0 filter elements (A, b, U,
// eta, Z), 1 smoothing elements (E, g, P). Each launches on the given
// stream, does not synchronise, and returns the CUDA error code of the
// launch.
extern "C" {

int tp_chunk_scan_d8_f32(int kind, const void* elems, void* out, int L,
                      void* stream) {
  return tp::chunk_scan_kind<float>(kind, elems, out, L, stream);
}

int tp_fixup_d8_f32(int kind, const void* prefixes, const void* t_excl,
                 void* out, int L, void* stream) {
  return tp::fixup_kind<float>(kind, prefixes, t_excl, out, L, stream);
}

}  // extern "C"
