#!/usr/bin/env python3
"""The fused EK1 smoother kernel at two launch bounds, side by side on one
card.

    python3 scripts/torch_smoother_bounds.py [--members 8192] [--steps 500]

``ops/csrc/ek1_fused.cu`` builds ``ekd_smoother_kernel`` (the body
``ek1g::smoother_group`` of ``ek1_group.cuh``: 8 lanes a member, 32 float32
members a CTA of 256 threads) with ``__launch_bounds__(256, 2)``: two CTAs
an SM, so that 8192 members fit the card at once, which caps a lane at 128
registers. This script compiles the same body at a minimum of 2 and of 1
CTA an SM into a library of its own under ``build/``, prints each build's
registers and spills from ``ptxas``, checks both bit for bit against the
package's kernel on the EK1 filter kernel's stream (FitzHugh-Nagumo, q = 3,
members x steps over (0, 20), float32; ``chip_smoke.EK1Case``), and times
them with CUDA events in the order 2, 1, 1, 2, 2, 1 (each the median of 20
after 3 warm-ups). The card's name and power limit come first. Needs a
CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from odefilters_torch.ops import _build, _launch  # noqa: E402

SOURCE = r"""
#include <cuda_runtime.h>
#include "ek1_group.cuh"

template <int MINB>
__global__ void __launch_bounds__(256, MINB)
    bounds_smoother_kernel(const float* st, float* us, float* stds, int B,
                           int T, ek1::Consts<float, 4, 2> c) {
  ek1g::smoother_group<float, 4, 2, 32>(c, st, us, stds, B, T);
}

template <int MINB>
int run(const void* st, void* us, void* stds, int B, int T, const double* k,
        void* stream) {
  ek1::Consts<float, 4, 2> c;
  int o = 0;
  for (int i = 0; i < 4; ++i)
    for (int l = 0; l < 4; ++l) c.At[i][l] = float(k[o++]);
  for (int i = 0; i < 4; ++i)
    for (int l = 0; l < 4; ++l) c.QLt[i][l] = float(k[o++]);
  c.pinv0 = float(k[o++]);
  constexpr size_t sh = ek1g::smoother_smem_bytes<float, 4, 2, 32>();
  const cudaError_t e = cudaFuncSetAttribute(
      (const void*)bounds_smoother_kernel<MINB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sh);
  if (e != cudaSuccess) return (int)e;
  bounds_smoother_kernel<MINB><<<(B + 31) / 32, 256, sh,
                                 (cudaStream_t)stream>>>(
      (const float*)st, (float*)us, (float*)stds, B, T, c);
  return (int)cudaGetLastError();
}

extern "C" int smoother_min2(const void* st, void* us, void* stds, int B,
                             int T, const double* k, void* s) {
  return run<2>(st, us, stds, B, T, k, s);
}
extern "C" int smoother_min1(const void* st, void* us, void* stds, int B,
                             int T, const double* k, void* s) {
  return run<1>(st, us, stds, B, T, k, s);
}
"""
ENTRIES = ("smoother_min2", "smoother_min1")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--members", type=int, default=8192)
    ap.add_argument("--steps", type=int, default=500)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("a CUDA card is required")
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    print(cs.card_line(), flush=True)

    out_dir = ROOT / "build" / "smoother_bounds"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib_path = out_dir / "bounds.cu", out_dir / "bounds.so"
    src.write_text(SOURCE)
    nvcc = subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-fmad=false", "-shared", "-I",
         str(ROOT / "odefilters_torch" / "ops" / "csrc"), "-o",
         str(lib_path), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _build.build()
    _build.load()
    log = nvcc.communicate()[0]
    if nvcc.returncode:
        print(log)
        return 1
    for line in log.splitlines():
        if "Compiling entry" in line or "spill" in line or "Used" in line:
            print("  ", line.strip())

    P, I = ctypes.c_void_p, ctypes.c_int
    lib = ctypes.CDLL(str(lib_path))
    for name in ENTRIES:
        getattr(lib, name).argtypes = (P, P, P, I, I,
                                       ctypes.POINTER(ctypes.c_double), P)
    B, T = args.members, args.steps
    c = cs.EK1Case(B, T, torch.float32, cs.TSPAN_MAIN)
    st = c.states_kernel()
    k = _launch.host_consts(c.skw["At"], c.skw["QLt"], scalars=(c.pinv0,))
    ref = c.smoother_kernel(st)

    def smooth(name):
        us, stds = torch.empty_like(ref[0]), torch.empty_like(ref[1])
        rc = getattr(lib, name)(st.data_ptr(), us.data_ptr(), stds.data_ptr(),
                                B, T, k,
                                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{name}: CUDA error {rc}")
        return us, stds

    ok = True
    for name in ENTRIES:
        us, stds = smooth(name)
        torch.cuda.synchronize()
        same = bool(torch.equal(us, ref[0]) and torch.equal(stds, ref[1]))
        ok &= same
        print(f"{name}: bit for bit with ekd_smoother_kernel: {same}")
    turns = [ENTRIES[i] for i in (0, 1, 1, 0, 0, 1)]
    times = [cs.time_ms(lambda n=n: smooth(n), warmup=3, iters=20)
             for n in turns]
    print(f"float32, {B} x {T}, in turns: "
          + ", ".join(f"{n} {t:.4f} ms" for n, t in zip(turns, times)))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
