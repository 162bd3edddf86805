#!/usr/bin/env python3
"""The float32 calibration of the time-parallel global EK1 solve against
float64's, over grid sizes.

    python3 scripts/torch_tp_f32_sigma2.py [--steps 256 512 ... 16384]
                                           [--device cpu]

FitzHugh-Nagumo over (0, 20), EK1(order=3), 2 sweeps, the fused scan
(its plain versions on the CPU, the kernels on a CUDA card) and the warm
start, as `solve_fixed_parallel` defaults on the card. For each N it prints
both sigma^2, their ratio, the largest |u_f32 - u_f64|, the largest std of
each and the largest |std_f32 - std_f64|. Where the float32 innovations
reach their rounding floor the ratio leaves 1 and grows with N. Runs on the
CPU by default (about 30 s for the default sizes); imports no JAX.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import odefilters_torch as odt  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, nargs="*",
                    default=[256, 512, 1024, 2048, 4096, 16384])
    ap.add_argument("--device", default="cpu")
    a = ap.parse_args()
    for N in a.steps:
        out = {}
        for dtype in (torch.float64, torch.float32):
            prob = odt.models.fitzhugh_nagumo(tspan=(0.0, 20.0),
                                              device=a.device, dtype=dtype)
            ts = torch.linspace(0.0, 20.0, N + 1, dtype=dtype,
                                device=a.device)
            out[dtype] = odt.solve_fixed_parallel(
                prob, odt.EK1(order=3), ts=ts, iterations=2, block="fused",
                warm_start=8)
        u64, s64 = out[torch.float64][0], out[torch.float64][1]
        u32, s32 = (out[torch.float32][0].double(),
                    out[torch.float32][1].double())
        q64, q32 = float(out[torch.float64][4]), float(out[torch.float32][4])
        print(f"N={N}: sigma2 f32 {q32:.6e}, f64 {q64:.6e}, ratio "
              f"{q32 / q64:.6g}; max |du| {float((u32 - u64).abs().max()):.3e}; "
              f"largest std f32 {float(s32.max()):.3e}, f64 "
              f"{float(s64.max()):.3e}; max |dstd| "
              f"{float((s32 - s64).abs().max()):.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
