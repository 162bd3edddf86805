// The fused time-parallel scan's group kernels in float64 (tp_group.cuh;
// tp_group.cu has the design), a translation unit of its own so that nvcc
// builds the float32 and float64 instantiations in parallel.

#include "tp_group.cuh"

// Group size 16 (9 <= D <= 16), built by tp_group16_f64.cu in parallel.
extern "C" int tp_group16_f64(int, int, int, const void*, const void*,
                              void*, void*, int, void*);
// Group size 32 (17 <= D <= 32), built by tp_group32_f64.cu in parallel.
extern "C" int tp_group32_f64(int, int, int, const void*, const void*,
                              void*, void*, int, void*);

// The D = 8 one-thread chunk scan and fixup (tp_scan_f64.cu).
extern "C" int tp_chunk_scan_d8_f64(int, const void*, void*, int, void*);
extern "C" int tp_fixup_d8_f64(int, const void*, const void*, void*, int,
                               void*);

// Plain C entry points, as tp_group.cu's.
extern "C" {

int tp_chunk_scan_f64(int kind, int D, const void* elems, void* out, int L,
                      void* stream) {
  if (D == 8) return tp_chunk_scan_d8_f64(kind, elems, out, L, stream);
  return tpg::run_for<double>(0, kind, D, elems, nullptr, nullptr, out, L,
                          stream, tp_group16_f64, tp_group32_f64);
}

int tp_totals_scan_f64(int kind, int D, const void* totals, void* work,
                       void* out, void* stream) {
  return tpg::run_for<double>(1, kind, D, totals, nullptr, work, out, 1, stream,
                          tp_group16_f64, tp_group32_f64);
}

int tp_fixup_f64(int kind, int D, const void* prefixes, const void* t_excl,
                 void* out, int L, void* stream) {
  if (D == 8) return tp_fixup_d8_f64(kind, prefixes, t_excl, out, L, stream);
  return tpg::run_for<double>(2, kind, D, prefixes, t_excl, nullptr, out, L,
                          stream, tp_group16_f64, tp_group32_f64);
}

}  // extern "C"
