// The fused time-parallel scan kernels in float64 (tp_scan.cuh), a
// translation unit of its own so that nvcc builds the float32 (tp_scan.cu)
// and float64 instantiations in parallel.

#include "tp_scan.cuh"

// Plain C entry points, bound with ctypes (ops/_build.py: ENTRIES). kind: 0
// filter elements (A, b, U, eta, Z), 1 smoothing elements (E, g, P), at
// D = 8. Each launches on the given stream, does not synchronise, and
// returns the CUDA error code of the launch (the totals scan
// cudaErrorCooperativeLaunchTooLarge when its grid cannot be co-resident).
extern "C" {

int tp_chunk_scan_f64(int kind, const void* elems, void* out, int L,
                      void* stream) {
  return tp::chunk_scan_kind<double>(kind, elems, out, L, stream);
}

int tp_totals_scan_f64(int kind, const void* totals, void* work, void* out,
                       void* stream) {
  return tp::totals_scan_kind<double>(kind, totals, work, out, stream);
}

int tp_fixup_f64(int kind, const void* prefixes, const void* t_excl,
                 void* out, int L, void* stream) {
  return tp::fixup_kind<double>(kind, prefixes, t_excl, out, L, stream);
}

}  // extern "C"
