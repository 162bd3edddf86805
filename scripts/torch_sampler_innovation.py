#!/usr/bin/env python3
"""The sampler's float32 paths against float64, with the filter's
measurement residual formed two ways, on the plain PyTorch versions.

    python3 scripts/torch_sampler_innovation.py [--members 8192]
                                                [--steps 500] [--device cpu]

FitzHugh-Nagumo, EK0(order=3), members x steps over (0, 20): the
headline ensemble (u0 perturbed by 0.1 N(0, 1) from numpy seed 0), two
normal draws per member (numpy seed 13) and one of zeros. For each form of the residual
``pb mp[1] - du`` in float32 it prints the count of filter steps that
stream s2 = 0, the largest |f32 - f64| over the sample paths, and the
members whose paths miss the f64 ones by more than 1e-4:

- ``rounded product``: ``pb * mp[1] - du`` in float32, each operation
  rounded;
- ``fused``: the exact product in float64 and one rounding
  (``ek0_sample.innovation``, what the port runs).

The float64 paths use the plain difference either way. Runs on the CPU by
default (about a minute at 8192 x 500); imports no JAX.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import odefilters_torch as odt  # noqa: E402
from odefilters_torch.ops import ek0_sample as es  # noqa: E402
from odefilters_torch.taylor import taylor_coefficients  # noqa: E402

Q, S = 3, 2


def rounded_product(pb, h, du):
    return pb * h - du


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--members", type=int, default=8192)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--device", default="cpu")
    a = ap.parse_args()
    B, T = a.members, a.steps
    prob = odt.models.fitzhugh_nagumo(device=a.device, tspan=(0.0, 20.0))
    rng = np.random.default_rng(0)
    u0s = torch.as_tensor(
        prob.u0.cpu().numpy() + 0.1 * rng.standard_normal((B, 2)),
        device=a.device)
    ps = prob.p[:, None].expand(4, B).contiguous()
    z = np.random.default_rng(13).standard_normal((T + 1, S, Q + 1, 2, B))
    z = np.concatenate([np.zeros_like(z[:, :1]), z], axis=1)
    fused = es.innovation

    def paths(dtype, residual):
        es.innovation = residual
        try:
            m0 = torch.stack(taylor_coefficients(
                prob.f, u0s.T.contiguous().to(dtype), ps.to(dtype), 0.0, Q))
            st = es.ek0_filter_state_stream(prob.f, m0, ps.to(dtype), 0.0,
                                            20.0 / T, T, Q)
            At, QLt, _, pinv0, _ = es._consts(Q, 20.0 / T)
            us = es.ek0_sampler(
                st, torch.as_tensor(z, dtype=dtype, device=a.device), At=At,
                QLt=QLt, pinv0=pinv0, nq=Q + 1, d=2)
        finally:
            es.innovation = fused
        return us.double(), int((st[1:, -1] == 0).sum())

    t = time.time()
    ref, _ = paths(torch.float64, fused)
    print(f"FitzHugh-Nagumo, EK0(order=3), {B} members x {T} steps, "
          f"{S} normal draws + zeros, device {a.device}; f64 in "
          f"{time.time() - t:.1f} s")
    for name, residual in (("rounded product", rounded_product),
                           ("fused", fused)):
        us, zero = paths(torch.float32, residual)
        e = (us - ref).abs()
        lane = e.amax(dim=(0, 1, 2))
        bad = torch.nonzero(lane > 1e-4).flatten().tolist()
        print(f"f32 residual {name}: {zero} of {B * T} steps stream s2 = 0; "
              f"max |f32 - f64| {float(e.max()):.3e} (zero normals "
              f"{float(e[:, 0].max()):.3e}); {len(bad)} members above 1e-4"
              + (f": {bad[:20]}" if bad else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
