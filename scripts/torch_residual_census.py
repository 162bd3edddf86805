#!/usr/bin/env python3
"""How often the float32 filters stream a zero diffusion, on the plain
PyTorch versions.

    python3 scripts/torch_residual_census.py [--members 8192] [--steps 500]
                                             [--device cpu] [--only NAME ...]

FitzHugh-Nagumo, IBM prior, order 3, members x steps over (0, 20): the
headline ensemble (u0 perturbed by 0.1 N(0, 1) from numpy seed 0). For each
filter below and each form of the float32 measurement residual (``rounded``:
the rounded product less ``du``; ``fused``: the exact product less ``du``,
rounded once, ``ek0_pair.innovation``, which the port runs) it runs
float64 and float32 from the same inputs and prints the count of steps
whose dynamic diffusion s2 is exactly 0 in float32, the largest
|us_f32 - us_f64| and the members whose float32 means miss the float64 ones
by more than 1e-4, and the largest |stds_f32 - stds_f64| with the count of
entries outside 1e-3 |std_f64| + 1e-6:

- ``pair``: the EK0 pair's forward (``ek0_pair.ek0_pair_fwd_plain``), its
  residual ``pb mp[1] - du`` a rounded product less ``du``; us and stds
  are the pair's smoothed ones;
- ``filter``: the EK0 filter with its log-likelihood (the step of
  ``ek0_filter.ek0_filter_plain``, streamed by its gradient's forward
  ``ek0_filter_fwd_stream_plain``), the same residual; us and stds are
  the filter's;
- ``ek1``: the EK1 filter (``ek1_fused.ek1_filter_states_plain``), its
  residual ``pinv1 mp[d + a] - du[a]`` and its diffusion
  ``z^T (H Q H^T)^-1 z / d``; us and stds are those of the EK1 plain
  smoother.

Runs on the CPU by default (about half an hour at 8192 x 500, most of it
the EK1 smoother); imports no JAX.
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
from odefilters_torch.ops import ek0_filter as ef  # noqa: E402
from odefilters_torch.ops import ek0_pair as ep  # noqa: E402
from odefilters_torch.taylor import taylor_coefficients  # noqa: E402

Q = 3


def pair(f, m0_p, ps, kw, consts):
    """(s2 per step (T, B), smoothed us, smoothed stds)"""
    At, Qt, QLt, _ = consts
    st = ep.ek0_pair_fwd_plain(f, m0_p, ps, At=At, Qt=Qt, **kw)
    jitter = 1e-6 if m0_p.dtype == torch.float32 else 1e-12
    out = ep.ek0_pair_bwd_plain(st, nq=Q + 1, d=2, At=At, Qt=Qt, QLt=QLt,
                                pinv0=kw["pinv0"], jitter=jitter)
    stds = kw["pinv0"] * torch.sqrt(torch.clamp(out[:, 2], min=0.0))
    return st[1:, -1], out[:, :2], stds


def filter_(f, m0_p, ps, kw, consts):
    At, Qt, _, _ = consts
    us, stds, _, st = ef.ek0_filter_fwd_stream_plain(f, m0_p, ps, At=At,
                                                     Qt=Qt, **kw)
    return st[1:, -1], us, stds


def ek1(f, m0_p, ps, kw, consts):
    from odefilters_torch.models.library import fitzhugh_nagumo_jac
    from odefilters_torch.ops import ek1_fused as e1

    At, _, QLt, _ = consts
    st = e1.ek1_filter_states_plain(f, fitzhugh_nagumo_jac, m0_p, ps, At=At,
                                    QLt=QLt, **kw)
    us, stds = e1.ekd_smoother_plain(st, At=At, QLt=QLt, pinv0=kw["pinv0"],
                                     nq=Q + 1, d=2)
    return st[1:, e1.stream_layout(Q + 1, 2, True)["s2"]], us, stds


FILTERS = {"pair": pair, "filter": filter_, "ek1": ek1}
RESIDUALS = {"rounded": lambda pb, h, du: pb * h - du,
             "fused": ep.innovation}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--members", type=int, default=8192)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--only", nargs="*", choices=sorted(FILTERS),
                    default=sorted(FILTERS))
    ap.add_argument("--residual", nargs="*", choices=sorted(RESIDUALS),
                    default=sorted(RESIDUALS, reverse=True))
    a = ap.parse_args()
    B, T = a.members, a.steps
    dt = 20.0 / T
    prob = odt.models.fitzhugh_nagumo(device=a.device, tspan=(0.0, 20.0))
    rng = np.random.default_rng(0)
    u0s = torch.as_tensor(
        prob.u0.cpu().numpy() + 0.1 * rng.standard_normal((B, 2)),
        device=a.device)
    ps = prob.p[:, None].expand(4, B).contiguous()
    consts = ep.pair_constants(Q, dt)
    p = consts[3]
    kw = dict(pinv0=float(1.0 / p[0]), pinv1=float(1.0 / p[1]), t0=0.0, dt=dt,
              n_steps=T)
    print(f"FitzHugh-Nagumo, order {Q}, {B} members x {T} steps, device "
          f"{a.device}", flush=True)
    for name in a.only:
        for form in a.residual:
            ep.innovation = RESIDUALS[form]
            run = FILTERS[name]
            out = {}
            t = time.time()
            for dtype in (torch.float64, torch.float32):
                m0 = torch.stack(taylor_coefficients(
                    prob.f, u0s.T.contiguous().to(dtype), ps.to(dtype), 0.0, Q))
                m0_p = torch.as_tensor(p, dtype=dtype, device=a.device)[:, None, None] * m0
                out[dtype] = run(prob.f, m0_p, ps.to(dtype), kw, consts)
            s2, us32, sd32 = out[torch.float32]
            sd64 = out[torch.float64][2]
            e = (us32.double() - out[torch.float64][1]).abs()
            esd = (sd32.double() - sd64).abs()
            n_sd = int((esd > 1e-3 * sd64.abs() + 1e-6).sum())
            lane = e.amax(dim=(0, 1))
            bad = torch.nonzero(lane > 1e-4).flatten().tolist()
            print(f"{name}, {form} residual: {int((s2 == 0).sum())} of "
                  f"{B * T} f32 steps stream s2 = 0 (f64: "
                  f"{int((out[torch.float64][0] == 0).sum())}); max "
                  f"|us_f32 - us_f64| {float(e.max()):.3e} (member "
                  f"{int(lane.argmax())}); {len(bad)} members above 1e-4"
                  + (f": {bad[:20]}" if bad else "")
                  + f"; max |stds_f32 - stds_f64| {float(esd.max()):.3e}, "
                  f"{n_sd} entries outside 1e-3 |std| + 1e-6"
                  + f"; {time.time() - t:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
