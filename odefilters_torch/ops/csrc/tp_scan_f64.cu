// The fused time-parallel scan kernels in float64 (tp_scan.cuh), a
// translation unit of its own so that nvcc builds the float32 (tp_scan.cu)
// and float64 instantiations in parallel.

#include "tp_scan.cuh"

// Plain C entry points at D = 8, as tp_scan.cu's (called by
// tp_group_f64.cu's entries).
extern "C" {

int tp_chunk_scan_d8_f64(int kind, const void* elems, void* out, int L,
                      void* stream) {
  return tp::chunk_scan_kind<double>(kind, elems, out, L, stream);
}

int tp_fixup_d8_f64(int kind, const void* prefixes, const void* t_excl,
                 void* out, int L, void* stream) {
  return tp::fixup_kind<double>(kind, prefixes, t_excl, out, L, stream);
}

}  // extern "C"
