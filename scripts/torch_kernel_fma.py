#!/usr/bin/env python3
"""The port's CUDA kernels built with and without FMA contraction, side by
side on one card.

    python3 scripts/torch_kernel_fma.py [--members 8192] [--steps 500]
                                        [--file ek0_filter.cu ek0_pair.cu]

For each source file named (default: both), builds the kernels' library
twice: the file once with ``-fmad=false`` and once with nvcc's default
contraction, the other files with the flags of
``odefilters_torch.ops._build``. In one process it times the file's kernels
with CUDA events (median of 20 after 3 warm-ups) on FitzHugh-Nagumo at
members x steps over (0, 20), float32 and float64, in the order no-FMA,
FMA, FMA, no-FMA, and prints each build's largest difference from the
plain PyTorch versions on the same inputs, relative to each output's
largest |value|:

- ``ek0_filter.cu``: us, stds and lls of the primal and of the gradient's
  forward, and the adjoint's dm0 and dps on the plain stream (relative to
  the largest |value| of each (row, dim) over the members);
- ``ek0_pair.cu``: the pair's us and stds (forward kernel, then backward
  kernel) against the plain pair, and sigma^2 of the static forward, for
  the dynamic diffusion and each static one.

The card's name and power limit come first. Needs a CUDA card; imports no
JAX.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from odefilters_torch import convert, models  # noqa: E402
from odefilters_torch.ops import _build  # noqa: E402
from odefilters_torch.ops import ek0_filter as ef  # noqa: E402
from odefilters_torch.ops import ek0_pair as ep  # noqa: E402
from odefilters_torch.taylor import taylor_coefficients  # noqa: E402

Q, TSPAN = 3, (0.0, 20.0)
REPO_FLAGS = dict(_build.SOURCE_FLAGS)
FILES = ("ek0_filter.cu", "ek0_pair.cu")


def time_ms(fn, warmup=3, iters=20):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def setup(B, T, dtype):
    """Kernel arguments for a perturbed FHN ensemble (u0 + 0.1 N(0, 1),
    seed 0) and seeded output cotangents."""
    prob = models.fitzhugh_nagumo(tspan=TSPAN, device="cuda", dtype=dtype)
    rng = np.random.default_rng(0)
    u0 = prob.u0.cpu().numpy()
    u0s = u0 + 0.1 * rng.standard_normal((B, u0.shape[0]))
    ps = np.broadcast_to(prob.p.cpu().numpy(), (B, prob.p.shape[0])).copy()
    u0s, ps = convert.ensemble_inputs_from_numpy(u0s, ps, device="cuda",
                                                 dtype=dtype)
    dt = (TSPAN[1] - TSPAN[0]) / T
    At, Qt, QLt, p = ep.pair_constants(Q, dt)
    ps = ps.T.contiguous()
    m0 = torch.stack(taylor_coefficients(prob.f, u0s.T, ps, TSPAN[0], Q))
    m0_p = torch.as_tensor(p, dtype=dtype, device="cuda")[:, None, None] * m0
    kw = dict(At=At, Qt=Qt, pinv0=float(1 / p[0]), pinv1=float(1 / p[1]),
              t0=TSPAN[0], dt=dt)
    bkw = dict(nq=Q + 1, d=2, At=At, Qt=Qt, QLt=QLt, pinv0=kw["pinv0"],
               jitter=1e-6 if dtype == torch.float32 else 1e-12)
    cts = [torch.tensor(rng.standard_normal(s), dtype=dtype, device="cuda")
           for s in ((T + 1, 2, B), (T + 1, B), (B,))]
    return prob.f, m0_p, ps, kw, bkw, cts, T


def rel(got, ref, axis=None):
    got, ref = got.double(), ref.double()
    if axis is None:
        return float((got - ref).abs().max() / ref.abs().max())
    scale = ref.abs().amax(dim=axis, keepdim=True)
    return float(((got - ref).abs() / scale).max())


def filter_runs(f, m0_p, ps, kw, bkw, cts, T):
    """The filter's kernels to time, and a report of one build's outputs
    against the plain versions."""
    run = {
        "ek0_filter": lambda: ef.ek0_filter(f, "fhn", m0_p, ps, n_steps=T, **kw),
        "ek0_filter_grad_fwd": lambda: ef.ek0_filter_grad_fwd(
            f, "fhn", m0_p, ps, n_steps=T, **kw),
    }
    prim_p = ef.ek0_filter_plain(f, m0_p, ps, n_steps=T, **kw)
    fwd_p = ef.ek0_filter_fwd_stream_plain(f, m0_p, ps, n_steps=T, **kw)
    st = fwd_p[3]
    bwd_p = ef.ek0_filter_grad_bwd_plain(f, st, ps, *cts, nq=Q + 1, **kw)
    run["ek0_filter_grad_bwd"] = lambda: ef.ek0_filter_grad_bwd(
        f, "fhn", st, ps, *cts, nq=Q + 1, **kw)

    def report():
        prim, fwd = run["ek0_filter"](), run["ek0_filter_grad_fwd"]()
        dm0, dps = run["ek0_filter_grad_bwd"]()
        var_s = (prim[1].clamp(min=1e-30).sqrt(),
                 prim_p[1].clamp(min=1e-30).sqrt())
        return (f"primal us {rel(prim[0], prim_p[0]):.3e}, stds "
                f"{rel(*var_s):.3e}, lls {rel(prim[2], prim_p[2]):.3e}; "
                f"grad fwd us {rel(fwd[0], fwd_p[0]):.3e}, stds "
                f"{rel(fwd[1], fwd_p[1]):.3e}, lls {rel(fwd[2], fwd_p[2]):.3e}; "
                f"adjoint dm0 {rel(dm0, bwd_p[0], axis=2):.3e}, dps "
                f"{rel(dps, bwd_p[1], axis=1):.3e}")

    return run, report


def pair_runs(f, m0_p, ps, kw, bkw, cts, T):
    """The pair's kernels to time (the forward in each diffusion, the
    backward on the plain dynamic stream), and a report of one build's
    solutions against the plain pair's."""
    diffusions = (None,) + ep.STATIC_DIFFUSIONS

    def fwd(static, plain=False):
        call = ep.ek0_pair_fwd_plain if plain else ep.ek0_pair_fwd
        args = (f, m0_p, ps) if plain else (f, "fhn", m0_p, ps)
        out = call(*args, n_steps=T, static_diff=static, **kw)
        return (out, None) if static is None else out

    def solution(st, sig, bwd):
        out = bwd(st, **bkw)
        stds = kw["pinv0"] * torch.sqrt(torch.clamp(out[:, 2], min=0.0))
        if sig is not None:
            stds = (stds[:, None] if sig.ndim == 2 else stds) * torch.sqrt(sig)
        return out[:, :2], stds, sig

    plain = {s: solution(*fwd(s, plain=True), ep.ek0_pair_bwd_plain)
             for s in diffusions}
    st_dyn = fwd(None, plain=True)[0]
    run = {f"ek0_pair_fwd ({s or 'dynamic'})": (lambda s=s: fwd(s))
           for s in diffusions}
    run["ek0_pair_bwd"] = lambda: ep.ek0_pair_bwd(st_dyn, **bkw)

    def report():
        parts = []
        for s in diffusions:
            us, stds, sig = solution(*fwd(s), ep.ek0_pair_bwd)
            ref = plain[s]
            text = (f"{s or 'dynamic'}: us {rel(us, ref[0]):.3e}, stds "
                    f"{rel(stds, ref[1]):.3e}")
            if sig is not None:
                text += f", sigma^2 {rel(sig, ref[2]):.3e}"
            parts.append(text)
        return "; ".join(parts)

    return run, report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--members", type=int, default=8192)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--file", nargs="+", choices=FILES, default=list(FILES))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_fma: needs a CUDA card", flush=True)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    for src in args.file:
        builds = {"no-FMA": dict(REPO_FLAGS, **{src: ("-fmad=false",)}),
                  "FMA": {k: v for k, v in REPO_FLAGS.items() if k != src}}
        make = filter_runs if src == "ek0_filter.cu" else pair_runs
        for dtype in (torch.float32, torch.float64):
            run, report = make(*setup(args.members, args.steps, dtype))
            label = f"{src} {str(dtype).replace('torch.', '')}"
            times = {name: [] for name in builds}
            for name in ("no-FMA", "FMA", "FMA", "no-FMA"):
                _build.SOURCE_FLAGS = builds[name]
                _build.load.cache_clear()
                built = _build.build()
                times[name].append({k: time_ms(fn) for k, fn in run.items()})
                if len(times[name]) == 1:
                    print(f"{label} {name} ({built['path'].name}) vs plain: "
                          f"{report()}", flush=True)
            for name, runs in times.items():
                for k in run:
                    ms = [r[k] for r in runs]
                    print(f"{label} {name} {k}: {ms[0]:.4f} ms, {ms[1]:.4f} ms",
                          flush=True)
    _build.SOURCE_FLAGS = REPO_FLAGS
    return 0


if __name__ == "__main__":
    sys.exit(main())
