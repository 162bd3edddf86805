// The fused time-parallel scan's kernels above state dimension 32 in
// float64 (tp_wide.cuh; tp_wide.cu has the design), a translation unit of
// its own so that nvcc builds the float32 and float64 instantiations in
// parallel.

#include "tp_wide.cuh"

// Plain C entry points, as tp_wide.cu's.
extern "C" {

int tp_wide_f64(int op, int kind, int D, const void* a, const void* b,
                void* w, void* o, int L, void* gws, void* stream) {
  return tpw::run<double>(op, kind, D, a, b, w, o, L, gws, stream);
}

int tp_wide_ws_f64(int op, int kind, int D, int L, void* values) {
  return tpw::workspace<double>(op, kind, D, L, (long long*)values);
}

}  // extern "C"
