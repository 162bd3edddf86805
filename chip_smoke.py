#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``odefilters_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version on the card, drives the port's
paths through the front doors ``odefilters_torch.solve_ensemble``,
``odefilters_torch.sample_ensemble`` and ``odefilters_torch.ieks_ensemble``
at the headline width (FitzHugh-Nagumo, EK0(3) and EK1(3), IBM prior, 8192
members, 500 uniform steps over (0, 20)): with EK0 the filter + RTS
smoother pair (dynamic and static diffusions), the filter with its
per-member log-likelihood and that likelihood's gradient by
``torch.autograd``, and the joint-posterior sampler; with EK1 the filter
with and without the smoother (dynamic, fixed, fixedMAP), the sampler and
the ensemble IEKS. It checks float32 against float64 on the worst lanes, float64
against an independent high-accuracy integrator, the float64 gradient
against a finite difference, the sampler's calibration, and times each
path, each kernel and the plain versions with CUDA events.

Phases:
  1. environment: a CUDA card, its name and power limit, TF32 off;
  2. build: nvcc, sm_90a, from ``odefilters_torch/ops/csrc``, one nvcc per
     source in parallel;
  3. pair kernels vs plain in float64 (B = 1000, not a multiple of the
     block size, T = 60 at the headline step dt = 0.04);
  4. the same in float32;
  5. the pair's path through the front door, float32 and float64, with the
     kernels' launch counts;
  6. the pair's timings at 8192 x 500 in float32, each kernel also held
     against its plain version at that shape;
  7. filter kernels vs plain in float64 at the shape of phase 3: the
     primal kernel (dynamic and each static diffusion), the gradient's
     forward, and the adjoint sweep on the plain forward's stream with
     cotangents from a numpy seed;
  8. the same in float32 (gradients reported, not held);
  9. the filter's path through the front door at 8192 x 500, float32 and
     float64: the forward solve, then ``torch.autograd.grad`` of
     ``lls.sum() + 0.1 us[:, 0].sum() + 0.01 stds.sum()`` with respect to
     ``(u0s, ps)``, with the kernels' launch counts; float32 against
     float64, the float64 gradient against central differences, the
     adjoint kernel against the plain adjoint at this length in float64,
     and the float64 filter means against DOP853;
 10. the filter at 8192 x 500 in float32: the primal kernel (each
     diffusion) and the gradient's forward held against their plain
     versions at this shape, then the timings of each kernel, the forward
     solve, forward + backward, and each plain version once;
 11. sampler kernels vs plain in float64 at the shape of phase 3 with
     S = 3 numpy normals: the filter-states kernel (its means directly,
     its stream through the plain sampler) and the sampler kernel on the
     plain stream;
 12. the same in float32;
 13. the sampler's path through ``sample_ensemble`` at 8192 x 500, S = 1
     and 8, float32 and float64, with the kernels' launch counts; the
     kernels against their plain versions at this shape (float32); zero
     normals against the pair's smoothed means of phase 5; the
     calibration of one member's posterior tiled across the 8192 lanes
     (float64); float32 against float64 on the same normals; the timings
     of each kernel, of ``sample_ensemble`` and of each plain version once;
 14. the static pair (fixed, fixedMAP, fixedMV): the forward kernel's
     static mode against its plain version at 1000 x 60 (float64,
     float32) and 8192 x 500 (float32); ``solve_ensemble`` at 8192 x 500
     with ``diffusions``, float32 against float64 on the worst lane; the
     static forward's timing;
 15. the EK1 kernels vs plain in float64 at the shape of phase 3 with
     S = 3 numpy normals: the filter kernel (its means directly, its
     stream through the plain smoother; with a linearization trajectory;
     fixed and fixedMAP with their sigma^2), the smoother kernel and the
     sampler kernel on the plain stream;
 16. the same in float32;
 17. the EK1 paths at 8192 x 500, float32 and float64, with the kernels'
     launch counts: ``solve_ensemble`` with EK1 in each mode (smoother or
     filter only; dynamic, fixed, fixedMAP), ``sample_ensemble`` at S = 1
     and 8, ``ieks_ensemble`` at 1 sweep (the EK1 smoothed solution
     exactly) and 3; float32 against float64 (``EK1_F32_US_LIMIT``);
     float64 smoothed and IEKS means against DOP853; zero normals through
     the sampler kernel against the smoother kernel's means on the same
     stream (exactly); the calibration of one member tiled across the
     lanes (float64);
 18. the EK1 kernels against their plain versions at 8192 x 500 in
     float32 (S = 8 normals from ``torch.randn``), then the timings of each
     kernel, each EK1 front door and each plain version once.

The second-last line of the output names the card and its power limit;
the line before it lists the ten kernels with their launches on their
path, errors, times, plain times and bounds (``bound_ms``: the larger of
the bytes each must move over 3.35 TB/s and the operations its plain
version does, counted per step under a dispatch mode, over 67 TFLOP/s of
float32; H100 SXM data sheet). ``max_abs_err`` is kernel against plain at
8192 x 500: in float32 for the pair (phase 6), the primal filter and the
gradient's forward (phase 10) and the sampler's kernels (phase 13, S = 8;
the filter-states kernel's stream through the sampler kernel), in float64
for the adjoint (phase 9), in float32 for the EK1 kernels (phase 18,
S = 8; the filter kernel's means, and its stream through the smoother
kernel). The samplers' times, plain times and bounds are those at S = 8.
The EK1 launches are those of ``solve_ensemble(EK1)`` (filter, smoother)
and ``sample_ensemble(EK1, S=8)`` (sampler) in float32.

Tolerances. A kernel's output is held against the plain version in the
solution space: the forward kernel's stream goes through the plain
backward, the backward kernel reads the plain forward's stream, and the
smoothed means ``us`` and stds are compared. The raw stream is not held
to a relative tolerance: its diffusion and covariance entries carry the
innovation, a difference at the solver's accuracy floor, so one ulp of
rounding moves them by ~4e-7 relative in float64 and by O(1) in float32
(measured on the plain path; the kernels round differently, e.g. through
FMA contraction). Its largest scaled difference is printed.

The filter's kernels are built without FMA contraction and round op by
op as their plain versions do on the card (a division by a Python number
is a product with its reciprocal there), so their outputs (us, stds, lls and the
static sigma^2) are held directly: rtol 1e-10 / atol 1e-12 in float64,
1e-4 / 1e-6 in float32, at the check shape and at 8192 x 500. The adjoint
sweep's gradients are held in float64 at the check shape at the JAX
package's own gradient tolerances (rtol 1e-8, atol 1e-10): dps entry by
entry, each entry of dm0 against the largest |value| of its (row, dim)
over the members (a few entries are sums that cancel far below their
row's scale, where the hand adjoint's rounding order and autograd's
differ). At 8192 x 500 both are held so, each entry against its row's
scale, at the same tolerances. Float32 gradients of this likelihood
are ill-conditioned in the reference itself (benchmarks/grad_horizon.json:
3.27 relative error against float64 at 20 steps, 8.4e4 at 500), so they
are held finite and their largest relative difference is printed.

The sampler's kernels and the pair's file are built without FMA
contraction too. The filter-states kernel's means are held directly, its
stream through the sampler; the sampler's and the static pair's outputs
(samples; us, stds and sigma^2) directly, at the same tolerances. Zero
normals turn the sampler into the RTS mean recursion: its path is held
against the pair's smoothed means (``ZERO_NORMALS_LIMIT``). The
calibration holds the empirical mean of 8192 samples of one posterior
within 5 standard errors of the smoothed mean at every (t, dim), and the
empirical std within 5% of the smoothed std where that exceeds 1e-8 (the
standard error of a std estimated from 8192 samples is ~0.8%). The EK1
kernels are built without FMA contraction too and are held like the
sampler's: the filter's means, sigma^2 and filter stds directly, its
stream through the smoother, the smoother's and the sampler's outputs
directly.

Every phase that fails is reported; the script then exits nonzero and
prints no result. Without a CUDA card it exits nonzero at once. It never
imports JAX or the JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

B_MAIN, T_MAIN, TSPAN_MAIN = 8192, 500, (0.0, 20.0)
B_CHECK, T_CHECK = 1000, 60
TSPAN_CHECK = (0.0, T_CHECK * (TSPAN_MAIN[1] - TSPAN_MAIN[0]) / T_MAIN)
Q = 3
DEVICE = "cuda"
SOURCE = {
    "ek0_pair_fwd": "odefilters_torch/ops/csrc/ek0_pair.cu",
    "ek0_pair_bwd": "odefilters_torch/ops/csrc/ek0_pair.cu",
    "ek0_filter": "odefilters_torch/ops/csrc/ek0_filter.cu",
    "ek0_filter_grad_fwd": "odefilters_torch/ops/csrc/ek0_filter.cu",
    "ek0_filter_grad_bwd": "odefilters_torch/ops/csrc/ek0_filter.cu",
    "ek0_filter_states": "odefilters_torch/ops/csrc/ek0_sample.cu",
    "ek0_sampler": "odefilters_torch/ops/csrc/ek0_sample.cu",
    "ek1_filter_states": "odefilters_torch/ops/csrc/ek1_fused.cu",
    "ekd_smoother": "odefilters_torch/ops/csrc/ek1_fused.cu",
    "ekd_sampler": "odefilters_torch/ops/csrc/ek1_fused.cu",
}
REPLACES = {
    "ek0_pair_fwd": "odefilters/ops/pallas_kernels.py:3843",
    "ek0_pair_bwd": "odefilters/ops/pallas_kernels.py:4186",
    "ek0_filter": "odefilters/ops/pallas_kernels.py:360",
    "ek0_filter_grad_fwd": "odefilters/ops/pallas_kernels.py:534",
    "ek0_filter_grad_bwd": "odefilters/ops/pallas_kernels.py:586",
    "ek0_filter_states": "odefilters/ops/pallas_kernels.py:3679",
    "ek0_sampler": "odefilters/ops/pallas_kernels.py:4657",
    "ek1_filter_states": "odefilters/ops/pallas_kernels.py:5224",
    "ekd_smoother": "odefilters/ops/pallas_kernels.py:5338",
    "ekd_sampler": "odefilters/ops/pallas_kernels.py:5486",
}
STATIC = ("fixed", "fixedMAP", "fixedMV")
EK1_STATIC = ("fixed", "fixedMAP")
S_CHECK, S_MAIN = 3, 8
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores

failures: list[str] = []


def say(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    say(f"   {'ok  ' if ok else 'FAIL'} {what}")
    if not ok:
        failures.append(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def inputs(B, dtype, tspan):
    """FHN problem and a perturbed ensemble: u0 + 0.1 N(0, 1), seed 0."""
    from odefilters_torch import convert, models

    prob = models.fitzhugh_nagumo(tspan=tspan, device=DEVICE, dtype=dtype)
    rng = np.random.default_rng(0)
    u0 = prob.u0.cpu().numpy()
    u0s = u0 + 0.1 * rng.standard_normal((B, u0.shape[0]))
    ps = np.broadcast_to(prob.p.cpu().numpy(), (B, prob.p.shape[0])).copy()
    u0s_t, ps_t = convert.ensemble_inputs_from_numpy(u0s, ps, device=DEVICE,
                                                     dtype=dtype)
    return prob, u0s_t, ps_t


class Pair:
    """The pair's arguments for one ensemble, and both versions of it."""

    def __init__(self, B, T, dtype, tspan):
        from odefilters_torch.ops import ek0_pair as ep
        from odefilters_torch.taylor import taylor_coefficients

        self.ep = ep
        self.prob, u0s, ps = inputs(B, dtype, tspan)
        dt = (tspan[1] - tspan[0]) / T
        m0 = torch.stack(taylor_coefficients(self.prob.f, u0s.T, ps.T,
                                             tspan[0], Q))
        At, Qt, QLt, p = ep.pair_constants(Q, dt)
        self.pinv0 = float(1.0 / p[0])
        self.m0_p = torch.as_tensor(p, dtype=dtype, device=DEVICE)[:, None, None] * m0
        self.ps = ps.T.contiguous()
        self.fwd_kw = dict(At=At, Qt=Qt, pinv0=self.pinv0,
                           pinv1=float(1.0 / p[1]), t0=tspan[0], dt=dt,
                           n_steps=T)
        self.bwd_kw = dict(nq=Q + 1, d=2, At=At, Qt=Qt, QLt=QLt,
                           pinv0=self.pinv0,
                           jitter=1e-6 if dtype == torch.float32 else 1e-12)

    def fwd_kernel(self, static=None):
        return self.ep.ek0_pair_fwd(self.prob.f, self.prob.field, self.m0_p,
                                    self.ps, static_diff=static, **self.fwd_kw)

    def fwd_plain(self, static=None):
        return self.ep.ek0_pair_fwd_plain(self.prob.f, self.m0_p, self.ps,
                                          static_diff=static, **self.fwd_kw)

    def bwd_kernel(self, st):
        return self.ep.ek0_pair_bwd(st, **self.bwd_kw)

    def bwd_plain(self, st):
        return self.ep.ek0_pair_bwd_plain(st, **self.bwd_kw)

    def solution(self, out, sig=None):
        """(us, stds) from the backward's (us | raw variance) rows, the stds
        rescaled by sqrt(sig) under a static diffusion (sig (d, B): fixedMV,
        stds (T+1, d, B))."""
        stds = self.pinv0 * torch.sqrt(torch.clamp(out[:, 2], min=0.0))
        if sig is not None:
            stds = (stds[:, None] if sig.ndim == 2 else stds) * torch.sqrt(sig)
        return out[:, :2], stds


class Sampler:
    """The sampler's arguments for one ensemble (those of `Pair`), S
    standard normals, and both versions of its two kernels. The normals are
    drawn with numpy from a seed, or, at the headline size, with
    ``torch.randn`` from a seeded generator on the card."""

    def __init__(self, B, T, dtype, tspan, S=None, numpy_normals=True):
        from odefilters_torch import convert
        from odefilters_torch.ops import ek0_sample as es

        self.es = es
        pair = Pair(B, T, dtype, tspan)
        self.f, self.field = pair.prob.f, pair.prob.field
        self.m0_p, self.ps = pair.m0_p, pair.ps
        kw = pair.fwd_kw
        At, _, QLt, _ = pair.ep.pair_constants(Q, kw["dt"])
        self.kw = dict(At=At, QLt=QLt, pinv0=kw["pinv0"], pinv1=kw["pinv1"],
                       t0=kw["t0"], dt=kw["dt"], n_steps=T)
        self.skw = dict(At=At, QLt=QLt, pinv0=kw["pinv0"], nq=Q + 1, d=2)
        self.z = None
        shape = (T + 1, S, Q + 1, 2, B)
        if S is not None and numpy_normals:
            z = np.random.default_rng(2).standard_normal(shape)
            self.z = convert.normals_from_numpy(z, device=DEVICE, dtype=dtype)
        elif S is not None:
            g = torch.Generator(device=DEVICE).manual_seed(2)
            self.z = torch.randn(shape, generator=g, dtype=dtype, device=DEVICE)

    def states_kernel(self):
        return self.es.ek0_filter_states(self.f, self.field, self.m0_p,
                                         self.ps, **self.kw)

    def states_plain(self):
        return self.es.ek0_filter_states_plain(self.f, self.m0_p, self.ps,
                                               **self.kw)

    def sampler_kernel(self, st, z=None):
        return self.es.ek0_sampler(st, self.z if z is None else z, **self.skw)

    def sampler_plain(self, st, z=None):
        return self.es.ek0_sampler_plain(st, self.z if z is None else z,
                                         **self.skw)


class Filter:
    """The filter's arguments for one ensemble (those of `Pair`), seeded
    output cotangents, and both versions of each of its three kernels."""

    def __init__(self, B, T, dtype, tspan):
        from odefilters_torch.ops import ek0_filter as ef

        self.ef = ef
        pair = Pair(B, T, dtype, tspan)
        self.f, self.field = pair.prob.f, pair.prob.field
        self.m0_p, self.ps, self.pinv0 = pair.m0_p, pair.ps, pair.pinv0
        self.kw = pair.fwd_kw
        self.bkw = {k: v for k, v in pair.fwd_kw.items() if k != "n_steps"}
        self.bkw["nq"] = Q + 1
        rng = np.random.default_rng(1)
        self.cts = [torch.tensor(rng.standard_normal(shape), dtype=dtype,
                                 device=DEVICE)
                    for shape in ((T + 1, 2, B), (T + 1, B), (B,))]

    def primal(self, static=None):
        return self.ef.ek0_filter(self.f, self.field, self.m0_p, self.ps,
                                  static_diff=static, **self.kw)

    def primal_plain(self, static=None):
        return self.ef.ek0_filter_plain(self.f, self.m0_p, self.ps,
                                        static_diff=static, **self.kw)

    def grad_fwd(self):
        return self.ef.ek0_filter_grad_fwd(self.f, self.field, self.m0_p,
                                           self.ps, **self.kw)

    def grad_fwd_plain(self):
        return self.ef.ek0_filter_fwd_stream_plain(self.f, self.m0_p, self.ps,
                                                   **self.kw)

    def grad_bwd(self, st):
        return self.ef.ek0_filter_grad_bwd(self.f, self.field, st, self.ps,
                                           *self.cts, **self.bkw)

    def grad_bwd_plain(self, st):
        return self.ef.ek0_filter_grad_bwd_plain(self.f, st, self.ps,
                                                 *self.cts, **self.bkw)

    def stds(self, var):
        """The primal's epilogue: pinv0 sqrt(max(var, 1e-30))."""
        return self.pinv0 * torch.sqrt(torch.clamp(var, min=1e-30))


class EK1Case:
    """The EK1 kernels' arguments for one ensemble (the inputs of `Pair`),
    S standard normals ``(T+1, S, D, B)`` (numpy from a seed, or
    ``torch.randn`` on the card), and both versions of each kernel."""

    def __init__(self, B, T, dtype, tspan, S=None, numpy_normals=True):
        from odefilters_torch import convert
        from odefilters_torch.ops import ek1_fused as e1

        self.e1 = e1
        pair = Pair(B, T, dtype, tspan)
        self.prob, self.m0_p, self.ps = pair.prob, pair.m0_p, pair.ps
        kw = pair.fwd_kw
        At, QLt, _, pinv0, pinv1 = e1._consts(Q, kw["dt"])
        self.pinv0 = pinv0
        self.kw = dict(At=At, QLt=QLt, pinv0=pinv0, pinv1=pinv1, t0=kw["t0"],
                       dt=kw["dt"], n_steps=T)
        self.skw = dict(At=At, QLt=QLt, pinv0=pinv0, nq=Q + 1, d=2)
        self.lay = e1.stream_layout(Q + 1, 2)
        self.z = None
        shape = (T + 1, S, 2 * (Q + 1), B)
        if S is not None and numpy_normals:
            z = np.random.default_rng(2).standard_normal(shape)
            self.z = convert.ek1_normals_from_numpy(z, device=DEVICE, dtype=dtype)
        elif S is not None:
            g = torch.Generator(device=DEVICE).manual_seed(2)
            self.z = torch.randn(shape, generator=g, dtype=dtype, device=DEVICE)

    def states_kernel(self, **kw):
        return self.e1.ek1_filter_states(self.prob.f, self.prob.jac,
                                         self.prob.field, self.m0_p, self.ps,
                                         **self.kw, **kw)

    def states_plain(self, **kw):
        return self.e1.ek1_filter_states_plain(self.prob.f, self.prob.jac,
                                               self.m0_p, self.ps, **self.kw,
                                               **kw)

    def smoother_kernel(self, st):
        return self.e1.ekd_smoother(st, **self.skw)

    def smoother_plain(self, st):
        return self.e1.ekd_smoother_plain(st, **self.skw)

    def sampler_kernel(self, st, z=None):
        return self.e1.ekd_sampler(st, self.z if z is None else z, **self.skw)

    def sampler_plain(self, st, z=None):
        return self.e1.ekd_sampler_plain(st, self.z if z is None else z,
                                         **self.skw)

    def means(self, st):
        return st[:, self.lay["m"]]

    def filter_solution(self, st):
        """The filter-only epilogue of ``ek1_fused_solve``: the solution
        means and per-dimension stds from the stream's mean and L rows."""
        D = 2 * (Q + 1)
        L = st[:, self.lay["L"]].reshape(st.shape[0], D, D, -1)[:, :2]
        return (self.pinv0 * st[:, :2],
                self.pinv0 * torch.sqrt(torch.sum(L ** 2, dim=2)))


def counters():
    """Every kernel wrapper, by the name the kernels line uses."""
    from odefilters_torch.ops import ek0_filter as ef
    from odefilters_torch.ops import ek0_pair as ep
    from odefilters_torch.ops import ek0_sample as es
    from odefilters_torch.ops import ek1_fused as e1

    return {"ek0_pair_fwd": ep.ek0_pair_fwd, "ek0_pair_bwd": ep.ek0_pair_bwd,
            "ek0_filter": ef.ek0_filter,
            "ek0_filter_grad_fwd": ef.ek0_filter_grad_fwd,
            "ek0_filter_grad_bwd": ef.ek0_filter_grad_bwd,
            "ek0_filter_states": es.ek0_filter_states,
            "ek0_sampler": es.ek0_sampler,
            "ek1_filter_states": e1.ek1_filter_states,
            "ekd_smoother": e1.ekd_smoother,
            "ekd_sampler": e1.ekd_sampler}


def reset_counts():
    for wrapper in counters().values():
        wrapper.launches = 0


def read_counts(*names):
    c = counters()
    return {n: c[n].launches for n in names}


def close(name, got, ref, rtol, atol):
    """Check |got - ref| <= atol + rtol |ref| everywhere, all finite;
    returns the largest absolute difference."""
    got, ref = got.double(), ref.double()
    err = (got - ref).abs()
    finite = bool(torch.isfinite(got).all() and torch.isfinite(ref).all())
    worst = float(err.max())
    viol = int((err > atol + rtol * ref.abs()).sum())
    check(finite and viol == 0,
          f"{name}: max |diff| {worst:.3e}, {viol} entries outside "
          f"rtol={rtol:g} atol={atol:g}, finite={finite}")
    return worst


def close_rows(name, got, ref, rtol, atol):
    """Check |got - ref| <= atol + rtol max |ref| everywhere, the max taken
    over the members (the last axis) at each entry's row, all finite;
    returns the largest absolute difference."""
    got, ref = got.double(), ref.double()
    err = (got - ref).abs()
    scale = ref.abs().amax(dim=-1, keepdim=True)
    finite = bool(torch.isfinite(got).all() and torch.isfinite(ref).all())
    viol = int((err > atol + rtol * scale).sum())
    worst = float((err / scale.clamp(min=1e-300)).max())
    check(finite and viol == 0,
          f"{name}: max |diff| {float(err.max()):.3e}, largest |diff| / its "
          f"row's scale {worst:.3e}, {viol} entries outside rtol={rtol:g} "
          f"atol={atol:g} of their row's scale, finite={finite}")
    return float(err.max())


def once(fn):
    """``(fn(), milliseconds)`` of one call between CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def report_grad(name, got, ref):
    """Float32 gradients: held finite, largest relative difference printed."""
    got, ref = got.double(), ref.double()
    finite = bool(torch.isfinite(got).all())
    rel = float(((got - ref).abs() / ref.abs().clamp(min=1e-300)).max())
    norm = float((got - ref).norm() / ref.norm())
    check(finite, f"{name}: finite={finite}; largest relative difference "
          f"{rel:.3e}, relative norm difference {norm:.3e} (reported, not "
          "held)")


def count_ops(make):
    """Floating-point operations a plain version does per step and member:
    aten arithmetic calls, weighted by the elements they produce, counted
    under a dispatch mode for one member, over 2 steps less over 1 step.
    ``make(T)`` sets up the inputs for T steps (uncounted) and returns the
    call to count."""
    from torch.utils._python_dispatch import TorchDispatchMode

    arith = {"add", "sub", "rsub", "mul", "div", "neg", "sqrt", "rsqrt",
             "log", "clamp", "clamp_min", "where", "reciprocal", "pow",
             "maximum", "minimum", "eq", "ne", "gt", "lt", "ge", "le", "abs"}

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func._schema.name.split("::")[-1].split(".")[0].rstrip("_")
            if name in arith:
                Count.n += (out if isinstance(out, torch.Tensor)
                            else out[0]).numel()
            return out

    totals = []
    for T in (1, 2):
        call = make(T)
        Count.n = 0
        with Count():
            call()
        totals.append(Count.n)
    return totals[1] - totals[0]


def bound(nbytes, ops_per_step, B, T):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over the float32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops_per_step * B * T / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_bounds(B, T, dtype, S):
    """{name: (bound_ms, bound_by, operations per step and member)} of the
    ten kernels at (B, T), the samplers at S samples: each reads its
    inputs once and writes its outputs once."""
    from odefilters_torch.ops import ek0_filter as ef
    from odefilters_torch.ops import ek0_pair as ep
    from odefilters_torch.ops import ek0_sample as es

    nq, d, n_p, V = Q + 1, 2, 4, 15
    V_states = es.states_width(nq, d)
    one1 = EK1Case(1, 2, dtype, (0.0, 2 * (TSPAN_MAIN[1] - TSPAN_MAIN[0]) / T_MAIN))
    kw1 = {k: v for k, v in one1.kw.items() if k != "n_steps"}
    V_ek1, D = one1.lay["V"], nq * d

    def ek1_stream(T1):
        return one1.e1.ek1_filter_states_plain(one1.prob.f, one1.prob.jac,
                                               one1.m0_p, one1.ps,
                                               n_steps=T1, **kw1)

    def ekd_sampler(T1):
        st = ek1_stream(T1)
        z = torch.ones((T1 + 1, S, D, 1), dtype=dtype, device=DEVICE)
        return lambda: one1.sampler_plain(st, z)

    def ekd_smoother(T1):
        st = ek1_stream(T1)
        return lambda: one1.smoother_plain(st)
    one = Filter(1, 2, dtype, (0.0, 2 * (TSPAN_MAIN[1] - TSPAN_MAIN[0]) / T_MAIN))
    f, m0, ps = one.f, one.m0_p, one.ps
    kw = {k: v for k, v in one.kw.items() if k != "n_steps"}
    QLt = ep.pair_constants(Q, kw["dt"])[2]
    skw = dict(At=kw["At"], QLt=QLt, pinv0=kw["pinv0"], pinv1=kw["pinv1"],
               t0=kw["t0"], dt=kw["dt"])

    def sampler(T1):
        st = es.ek0_filter_states_plain(f, m0, ps, n_steps=T1, **skw)
        z = torch.ones((T1 + 1, S, nq, d, 1), dtype=dtype, device=DEVICE)
        return lambda: es.ek0_sampler_plain(st, z, At=kw["At"], QLt=QLt,
                                            pinv0=kw["pinv0"], nq=nq, d=d)

    def pair_bwd(T1):
        st = ep.ek0_pair_fwd_plain(f, m0, ps, n_steps=T1, **kw)
        return lambda: ep.ek0_pair_bwd_plain(
            st, nq=nq, d=d, At=kw["At"], Qt=kw["Qt"], QLt=QLt,
            pinv0=kw["pinv0"], jitter=1e-6)

    def grad_bwd(T1):
        st = ef.ek0_filter_fwd_stream_plain(f, m0, ps, n_steps=T1, **kw)[3]
        cts = [torch.ones(shape, dtype=dtype, device=DEVICE)
               for shape in ((T1 + 1, d, 1), (T1 + 1, 1), (1,))]
        return lambda: ef.ek0_filter_grad_bwd_plain(f, st, ps, *cts, nq=nq,
                                                    **kw)

    ops = {
        "ek0_pair_fwd": count_ops(lambda T1: lambda: ep.ek0_pair_fwd_plain(
            f, m0, ps, n_steps=T1, **kw)),
        "ek0_pair_bwd": count_ops(pair_bwd),
        "ek0_filter": count_ops(lambda T1: lambda: ef.ek0_filter_plain(
            f, m0, ps, n_steps=T1, **kw)),
        "ek0_filter_grad_fwd": count_ops(
            lambda T1: lambda: ef.ek0_filter_fwd_stream_plain(
                f, m0, ps, n_steps=T1, **kw)),
        "ek0_filter_grad_bwd": count_ops(grad_bwd),
        "ek0_filter_states": count_ops(
            lambda T1: lambda: es.ek0_filter_states_plain(
                f, m0, ps, n_steps=T1, **skw)),
        "ek0_sampler": count_ops(sampler),
        "ek1_filter_states": count_ops(lambda T1: lambda: ek1_stream(T1)),
        "ekd_smoother": count_ops(ekd_smoother),
        "ekd_sampler": count_ops(ekd_sampler),
    }
    # elements moved: initial state and parameters, stream, per-step rows
    init, stream, rows = (nq * d + n_p) * B, (T + 1) * V * B, (T + 1) * B
    states = (T + 1) * V_states * B
    ek1_states = (T + 1) * V_ek1 * B
    elems = {
        "ek0_pair_fwd": init + stream,
        "ek0_pair_bwd": stream + rows * (d + 1),
        "ek0_filter": init + rows * (d + 1) + B,
        "ek0_filter_grad_fwd": init + rows * (d + 1) + B + stream,
        "ek0_filter_grad_bwd": stream + n_p * B + rows * (d + 1) + B + init,
        "ek0_filter_states": init + states,
        "ek0_sampler": states + rows * S * nq * d + rows * S * d,
        "ek1_filter_states": init + ek1_states,
        "ekd_smoother": ek1_states + rows * 2 * d,
        "ekd_sampler": ek1_states + rows * S * D + rows * S * d,
    }
    item = torch.tensor([], dtype=dtype).element_size()
    return {name: bound(elems[name] * item, ops[name], B, T) + (ops[name],)
            for name in ops}


def worst_lane(name, us, stds, us_ref, std_ref):
    """The worst-lane criteria: max |dus| <= 1e-4 over all (t, dim, member),
    |dstd| <= 1e-3 |std_ref| + 1e-6 on every entry, all finite. Returns
    (max |dus|, max |dstd|, worst member)."""
    dus = (us.double() - us_ref.double()).abs()
    dsd = (stds.double() - std_ref.double()).abs()
    finite = bool(torch.isfinite(us).all() and torch.isfinite(stds).all())
    e_us, e_sd = float(dus.max()), float(dsd.max())
    member = int(dus.amax(dim=(0, 1)).argmax())
    check(finite and e_us <= 1e-4, f"{name}: max |dus| {e_us:.3e} <= 1e-4, "
          f"finite={finite} (worst member {member})")
    viol = int((dsd > 1e-3 * std_ref.double().abs() + 1e-6).sum())
    check(viol == 0, f"{name}: max |dstd| {e_sd:.3e}, {viol} entries outside "
          "1e-3 |std| + 1e-6")
    return e_us, e_sd, member


def scaled_stream_diff(st, st_ref):
    """Largest stream difference scaled by each row entry's largest |value|."""
    scale = st_ref.double().abs().amax(dim=(0, 2), keepdim=True).clamp(min=1e-300)
    return float(((st.double() - st_ref.double()).abs() / scale).max())


def kernel_vs_plain(label, pair, rtol, atol):
    st_p = pair.fwd_plain()
    out_p = pair.bwd_plain(st_p)
    st_k = pair.fwd_kernel()
    out_k = pair.bwd_kernel(st_p)
    torch.cuda.synchronize()
    say(f"   stream: largest scaled |kernel - plain| "
        f"{scaled_stream_diff(st_k, st_p):.3e} (reported, not held)")
    us_p, sd_p = pair.solution(out_p)
    us_f, sd_f = pair.solution(pair.bwd_plain(st_k))
    us_b, sd_b = pair.solution(out_k)
    err_f = close(f"{label} forward kernel, us", us_f, us_p, rtol, atol)
    close(f"{label} forward kernel, stds", sd_f, sd_p, rtol, atol)
    err_b = close(f"{label} backward kernel, us", us_b, us_p, rtol, atol)
    close(f"{label} backward kernel, stds", sd_b, sd_p, rtol, atol)
    return err_f, err_b


def time_ms(fn, warmup, iters):
    """Median milliseconds of ``fn`` between CUDA events."""
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


def reference_solution(u0, p, ts):
    """FitzHugh-Nagumo by scipy's DOP853 at rtol = atol = 1e-12."""
    from scipy.integrate import solve_ivp

    a, b, tinv, izero = p

    def f(t, y):
        v, w = y
        return [v - v ** 3 / 3 - w + izero, tinv * (v + a - b * w)]

    sol = solve_ivp(f, (ts[0], ts[-1]), u0, method="DOP853", t_eval=ts,
                    rtol=1e-12, atol=1e-12)
    return sol.y.T          # (T+1, d)


def plain_outputs(flt):
    """The plain primal (each diffusion) and gradient's forward outputs."""
    refs = {static: flt.primal_plain(static) for static in (None,) + STATIC}
    refs["grad_fwd"] = flt.grad_fwd_plain()
    return refs


def outputs_vs_plain(label, flt, refs, rtol, atol):
    """The primal kernel (dynamic and each static diffusion) and the
    gradient's forward against the plain outputs ``refs`` on the same
    inputs. Returns each kernel's largest |kernel - plain|."""
    err = {"ek0_filter": 0.0}
    for static in (None,) + STATIC:
        got, ref = flt.primal(static), refs[static]
        torch.cuda.synchronize()
        name = f"{label} ek0_filter_kernel ({static or 'dynamic'})"
        errs = [close(f"{name}, us", got[0], ref[0], rtol, atol),
                close(f"{name}, stds", flt.stds(got[1]), flt.stds(ref[1]),
                      rtol, atol),
                close(f"{name}, lls", got[2], ref[2], rtol, atol)]
        if static:
            errs.append(close(f"{name}, sigma^2", got[3], ref[3], rtol, atol))
        err["ek0_filter"] = max(err["ek0_filter"], *errs)
    got, ref = flt.grad_fwd(), refs["grad_fwd"]
    torch.cuda.synchronize()
    name = f"{label} ek0_filter_grad_fwd_kernel"
    err["ek0_filter_grad_fwd"] = max(
        close(f"{name}, us", got[0], ref[0], rtol, atol),
        close(f"{name}, stds", got[1], ref[1], rtol, atol),
        close(f"{name}, lls", got[2], ref[2], rtol, atol))
    check(not got[1][0].any(), f"{name}: stds at t0 exactly 0")
    say(f"   {name}: stream, largest scaled |kernel - plain| "
        f"{scaled_stream_diff(got[3], ref[3]):.3e} (reported, not held)")
    return err


def filter_vs_plain(label, flt, rtol, atol, hold_grads):
    """Phases 7-8: each filter kernel against its plain version on the same
    inputs; the adjoint on the plain forward's stream."""
    refs = plain_outputs(flt)
    outputs_vs_plain(label, flt, refs, rtol, atol)
    st = refs["grad_fwd"][3]
    (dm0, dps), (dm0_p, dps_p) = flt.grad_bwd(st), flt.grad_bwd_plain(st)
    torch.cuda.synchronize()
    name = f"{label} ek0_filter_grad_bwd_kernel (on the plain stream)"
    if hold_grads:
        close(f"{name}, dps", dps, dps_p, 1e-8, 1e-10)
        close_rows(f"{name}, dm0", dm0, dm0_p, 1e-8, 1e-10)
    else:
        report_grad(f"{name}, dm0", dm0, dm0_p)
        report_grad(f"{name}, dps", dps, dps_p)


def filter_loss(sol):
    return sol.lls.sum() + 0.1 * sol.us[:, 0].sum() + 0.01 * sol.stds.sum()


def filter_path(odt, dtype):
    """Phase 9 for one dtype: the forward solve, then the gradient of
    `filter_loss` through the front door, with the launches of each run."""
    prob, u0s, ps = inputs(B_MAIN, dtype, TSPAN_MAIN)
    alg = odt.EK0(order=Q, smooth=False)
    names = ("ek0_filter", "ek0_filter_grad_fwd", "ek0_filter_grad_bwd")
    reset_counts()
    with torch.no_grad():
        sol = odt.solve_ensemble(prob, alg, u0s, ps, n_save=T_MAIN)
    torch.cuda.synchronize()
    primal_counts = read_counts(*names)
    u, p = u0s.clone().requires_grad_(), ps.clone().requires_grad_()
    solg = odt.solve_ensemble(prob, alg, u, p, n_save=T_MAIN)
    g_u, g_p = torch.autograd.grad(filter_loss(solg), (u, p))
    torch.cuda.synchronize()
    counts = read_counts(*names)
    grad_counts = {n: counts[n] - primal_counts[n] for n in names}
    label = str(dtype).replace("torch.", "")
    say(f"   {label}: launches in the forward solve {primal_counts}, in the "
        f"gradient run {grad_counts}")
    check(primal_counts["ek0_filter"] >= 1,
          f"{label}: ek0_filter_kernel launched in the forward solve")
    check(grad_counts["ek0_filter_grad_fwd"] >= 1
          and grad_counts["ek0_filter_grad_bwd"] >= 1,
          f"{label}: both gradient kernels launched in the gradient run")
    shapes = (tuple(sol.us.shape), tuple(sol.stds.shape),
              tuple(sol.lls.shape), tuple(g_u.shape), tuple(g_p.shape))
    check(shapes == ((T_MAIN + 1, 2, B_MAIN), (T_MAIN + 1, B_MAIN),
                     (B_MAIN,), (B_MAIN, 2), (B_MAIN, 4)),
          f"{label}: shapes us, stds, lls, d/du0s, d/dps = {shapes}")
    finite = all(bool(torch.isfinite(x).all()) for x in
                 (sol.us, sol.stds, sol.lls, solg.us, solg.stds, solg.lls,
                  g_u, g_p))
    check(finite, f"{label}: outputs and gradients finite")
    # both forward kernels run the same step: their means and
    # log-likelihoods are the same numbers
    check(torch.equal(sol.us, solg.us) and torch.equal(sol.lls, solg.lls),
          f"{label}: the gradient's forward reproduces the forward solve's "
          "us and lls exactly")
    return counts, prob, u0s, ps, sol, (g_u, g_p)


def sampler_vs_plain(label, smp, rtol, atol):
    """Phases 11-12: the filter-states kernel against the plain filter (its
    means directly, its stream through the plain sampler) and the sampler
    kernel on the plain stream against the plain sampler."""
    st_p, st_k = smp.states_plain(), smp.states_kernel()
    torch.cuda.synchronize()
    name = f"{label} ek0_filter_states_kernel"
    close(f"{name}, means", st_k[:, :(Q + 1) * 2], st_p[:, :(Q + 1) * 2], rtol,
          atol)
    say(f"   {name}: stream, largest scaled |kernel - plain| "
        f"{scaled_stream_diff(st_k, st_p):.3e} (reported, not held)")
    us_p = smp.sampler_plain(st_p)
    close(f"{name}, samples through the plain sampler", smp.sampler_plain(st_k),
          us_p, rtol, atol)
    us_k = smp.sampler_kernel(st_p)
    torch.cuda.synchronize()
    close(f"{label} ek0_sampler_kernel on the plain stream, samples", us_k, us_p,
          rtol, atol)


def static_vs_plain(label, pair, static, rtol, atol, plain_bwd=True):
    """Phase 14: the pair's forward kernel in a static mode against its
    plain version: sigma^2 directly, the stream in the solution space
    through the backward (plain, or the kernel, already held against it,
    where ``plain_bwd`` is false), stds with the exit rescale. Returns the
    largest |kernel - plain| over us, stds and sigma^2."""
    (st_p, sig_p), (st_k, sig_k) = pair.fwd_plain(static), pair.fwd_kernel(static)
    torch.cuda.synchronize()
    bwd = pair.bwd_plain if plain_bwd else pair.bwd_kernel
    us_p, sd_p = pair.solution(bwd(st_p), sig_p)
    us_k, sd_k = pair.solution(bwd(st_k), sig_k)
    name = f"{label} ek0_pair_fwd_kernel ({static})"
    return max(close(f"{name}, sigma^2", sig_k, sig_p, rtol, atol),
               close(f"{name}, us", us_k, us_p, rtol, atol),
               close(f"{name}, stds", sd_k, sd_p, rtol, atol))


# Zero normals against the pair's smoothed means at 8192 x 500: the two
# forwards (square-root, collapsed plain covariance) round differently, and
# 500 steps amplify that through the innovation (CPU plain path, 256
# members: 2.2e-9 in float64; 60 steps: 4.2e-15). Limits: 10x the CPU
# figure in float64; in float32 the headline's us criterion.
ZERO_NORMALS_LIMIT = {torch.float64: 2.2e-8, torch.float32: 1e-4}


def sampler_path(odt, card, sol32, sol64):
    """Phase 13: ``sample_ensemble`` at 8192 x 500 with S = 1 and S_MAIN, in
    float32 and float64, with its launches; the kernels against their plain
    versions at this shape (float32); zero normals against the pair's
    smoothed means ``sol32``/``sol64`` of phase 5; the calibration of one
    member's posterior tiled across the lanes (float64); float32 against
    float64 on the same normals; then the timings. Returns the kernels'
    (ms, plain ms, max |kernel - plain|, launches in the main path's run)."""
    from odefilters_torch.ops import ek0_sample as es

    alg = odt.EK0(order=Q)
    names = ("ek0_filter_states", "ek0_sampler")
    launches = {}
    for dtype in (torch.float32, torch.float64):
        prob, u0s, ps = inputs(B_MAIN, dtype, TSPAN_MAIN)
        label = str(dtype).replace("torch.", "")
        for S in (1, S_MAIN):
            g = torch.Generator(device=DEVICE).manual_seed(S)
            reset_counts()
            us = odt.sample_ensemble(prob, alg, u0s, ps, generator=g,
                                     n_steps=T_MAIN, n_samples=S)
            torch.cuda.synchronize()
            counts = read_counts(*names)
            if dtype == torch.float32 and S == S_MAIN:
                launches = counts
            want = ((T_MAIN + 1, 2, B_MAIN) if S == 1
                    else (T_MAIN + 1, S, 2, B_MAIN))
            check(all(n == 1 for n in counts.values()),
                  f"{label} S={S}: launches in the run {counts}, one each")
            check(tuple(us.shape) == want and bool(torch.isfinite(us).all()),
                  f"{label} S={S}: samples {tuple(us.shape)}, finite")

    say("   the kernels vs plain at this shape, float32, S = "
        f"{S_MAIN} normals from torch.randn")
    smp = Sampler(B_MAIN, T_MAIN, torch.float32, TSPAN_MAIN, S_MAIN,
                  numpy_normals=False)
    st_p, states_plain_ms = once(smp.states_plain)
    us_pp, sampler_plain_ms = once(lambda: smp.sampler_plain(st_p))
    st_k = smp.states_kernel()
    us_kp, us_kk = smp.sampler_kernel(st_p), smp.sampler_kernel(st_k)
    torch.cuda.synchronize()
    head = f"f32 at {B_MAIN} x {T_MAIN}"
    close(f"{head} ek0_filter_states_kernel, means", st_k[:, :(Q + 1) * 2],
          st_p[:, :(Q + 1) * 2], 1e-4, 1e-6)
    err = {
        "ek0_filter_states": close(
            f"{head} ek0_filter_states_kernel, samples through the sampler "
            "kernel", us_kk, us_kp, 1e-4, 1e-6),
        "ek0_sampler": close(
            f"{head} ek0_sampler_kernel on the plain stream, samples", us_kp,
            us_pp, 1e-4, 1e-6),
    }
    del us_pp, us_kk

    for dtype, sol in ((torch.float64, sol64), (torch.float32, sol32)):
        s0 = smp if dtype == torch.float32 else Sampler(
            B_MAIN, T_MAIN, dtype, TSPAN_MAIN)
        zeros = torch.zeros((T_MAIN + 1, 1, Q + 1, 2, B_MAIN), dtype=dtype,
                            device=DEVICE)
        us0 = s0.sampler_kernel(s0.states_kernel(), zeros)[:, 0]
        torch.cuda.synchronize()
        e0 = float((us0.double() - sol.us.double()).abs().max())
        lim = ZERO_NORMALS_LIMIT[dtype]
        check(e0 <= lim, f"{str(dtype)[6:]} zero normals vs the pair's smoothed "
              f"means: max |dus| {e0:.3e} <= {lim:g}")

    # one member's posterior, tiled across the lanes: 8192 samples
    prob64, _, _ = inputs(1, torch.float64, TSPAN_MAIN)
    u0t = prob64.u0[None].expand(B_MAIN, 2).contiguous()
    pt = prob64.p[None].expand(B_MAIN, 4).contiguous()
    us = odt.sample_ensemble(prob64, alg, u0t, pt, n_steps=T_MAIN,
                             generator=torch.Generator(device=DEVICE).manual_seed(11))
    ref = odt.solve_ensemble(prob64, alg, u0t[:1], pt[:1], n_save=T_MAIN)
    mean_s, std_s = ref.us[:, :, 0], ref.stds[:, 0]
    se = std_s[:, None] / B_MAIN ** 0.5
    dmean = (us.mean(dim=2) - mean_s).abs()
    n_out = int((dmean >= 5.0 * se + 1e-12).sum())
    check(n_out == 0, f"calibration (f64, {B_MAIN} samples of one member): "
          f"empirical mean within 5 standard errors of the smoothed mean at "
          f"every (t, dim); {n_out} outside, largest |dmean| / se "
          f"{float((dmean / se.clamp(min=1e-300))[1:].max()):.3f}")
    mask = std_s > 1e-8
    ratio = us.std(dim=2, correction=0)[mask] / std_s[mask, None]
    worst = float((ratio - 1.0).abs().max())
    check(worst <= 0.05, f"calibration: |std ratio - 1| {worst:.4f} <= 0.05 "
          f"where the smoothed std > 1e-8 ({int(mask.sum())} times)")

    # float32 against float64 on the same normals
    z64 = torch.randn((T_MAIN + 1, S_MAIN, Q + 1, 2, B_MAIN), dtype=torch.float64,
                      device=DEVICE,
                      generator=torch.Generator(device=DEVICE).manual_seed(13))
    paths = {}
    for dtype in (torch.float64, torch.float32):
        s1 = Sampler(B_MAIN, T_MAIN, dtype, TSPAN_MAIN)
        paths[dtype] = s1.sampler_kernel(s1.states_kernel(), z64.to(dtype))
    d = (paths[torch.float32].double() - paths[torch.float64]).abs()
    del paths, z64
    worst = float(d.max())
    lane_max = d.amax(dim=(0, 1, 2))
    failing = torch.nonzero(lane_max > 1e-4).flatten().tolist()
    check(worst <= 1e-4, f"sampler f32 vs f64, same normals, S={S_MAIN}: max "
          f"|dx| {worst:.3e} <= 1e-4 on every entry; {len(failing)} lanes "
          f"outside, worst member {int(lane_max.argmax())}")
    for b in failing[:10]:
        t, s, j = np.unravel_index(int(d[..., b].argmax()), d.shape[:3])
        say(f"   lane {b}: |dx| {float(d[t, s, j, b]):.3e} at t index {t}, "
            f"sample {s}, dim {j}; smoothed std there "
            f"{float(sol64.stds[t, b]):.3e}")
    del d

    say(f"   timing, float32, B={B_MAIN}, T={T_MAIN}: CUDA events")
    say(f"   card: {card}")
    prob32, u0s32, ps32 = inputs(B_MAIN, torch.float32, TSPAN_MAIN)
    z1 = smp.z[:, :1].contiguous()
    ms = {"ek0_filter_states": time_ms(smp.states_kernel, warmup=3, iters=20),
          "ek0_sampler": time_ms(lambda: smp.sampler_kernel(st_p), warmup=3,
                                 iters=20)}
    ms_s1 = time_ms(lambda: smp.sampler_kernel(st_p, z1), warmup=3, iters=20)
    say(f"   ek0_filter_states kernel {ms['ek0_filter_states']:.4f} ms, plain "
        f"{states_plain_ms:.1f} ms")
    say(f"   ek0_sampler kernel S=1 {ms_s1:.4f} ms, S={S_MAIN} "
        f"{ms['ek0_sampler']:.4f} ms (ratio {ms['ek0_sampler'] / ms_s1:.2f}); "
        f"plain S={S_MAIN} {sampler_plain_ms:.1f} ms")
    for S in (1, S_MAIN):
        g = torch.Generator(device=DEVICE).manual_seed(3)
        s_ms = time_ms(lambda: odt.sample_ensemble(
            prob32, alg, u0s32, ps32, generator=g, n_steps=T_MAIN,
            n_samples=S), warmup=3, iters=20)
        say(f"   sample_ensemble S={S} (Taylor init + normals + both kernels): "
            f"{s_ms:.3f} ms = {B_MAIN * S / s_ms * 1e3:.0f} sample paths/s")
    plain_ms = {"ek0_filter_states": states_plain_ms,
                "ek0_sampler": sampler_plain_ms}
    return ms, plain_ms, err, launches


def static_path(odt, card):
    """Phase 14: the pair's forward kernel in each static mode against its
    plain version (1000 x 60 in float64 and float32, 8192 x 500 in float32),
    the front door at 8192 x 500 with ``diffusions``, float32 against float64
    on the worst lane, and the static forward's timing."""
    for static in STATIC:
        for dtype, rtol, atol in ((torch.float64, 1e-10, 1e-12),
                                  (torch.float32, 1e-4, 1e-6)):
            static_vs_plain(f"{str(dtype)[6:]} {B_CHECK} x {T_CHECK}",
                            Pair(B_CHECK, T_CHECK, dtype, TSPAN_CHECK), static,
                            rtol, atol)
    pair32 = Pair(B_MAIN, T_MAIN, torch.float32, TSPAN_MAIN)
    for static in STATIC:
        static_vs_plain(f"f32 {B_MAIN} x {T_MAIN} (backward kernel)", pair32,
                        static, 1e-4, 1e-6, plain_bwd=False)
    for static in STATIC:
        alg = odt.EK0(order=Q, diffusionmodel=static)
        sols = {}
        for dtype in (torch.float32, torch.float64):
            prob, u0s, ps = inputs(B_MAIN, dtype, TSPAN_MAIN)
            reset_counts()
            sol = odt.solve_ensemble(prob, alg, u0s, ps, n_save=T_MAIN)
            torch.cuda.synchronize()
            counts = read_counts("ek0_pair_fwd", "ek0_pair_bwd")
            shape = (2, B_MAIN) if static == "fixedMV" else (B_MAIN,)
            label = f"{static} {str(dtype)[6:]}"
            check(all(n == 1 for n in counts.values())
                  and tuple(sol.diffusions.shape) == shape
                  and tuple(sol.stds.shape) == (T_MAIN + 1,) + shape
                  and bool(torch.isfinite(sol.diffusions).all()),
                  f"{label}: launches {counts}, diffusions "
                  f"{tuple(sol.diffusions.shape)}, stds {tuple(sol.stds.shape)}")
            sols[dtype] = sol
        s32, s64 = sols[torch.float32], sols[torch.float64]
        worst_lane(f"{static} f32 vs f64", s32.us, s32.stds, s64.us, s64.stds)
        rel = (s32.diffusions.double() - s64.diffusions).abs() / s64.diffusions
        say(f"   {static}: sigma^2 f32 vs f64, largest relative difference "
            f"{float(rel.max()):.3e} (reported)")
    say(f"   timing of the pair's forward kernel, float32, B={B_MAIN}, "
        f"T={T_MAIN}: CUDA events; card: {card}")
    for static in (None,) + STATIC:
        f_ms = time_ms(lambda: pair32.fwd_kernel(static), warmup=3, iters=20)
        say(f"   ek0_pair_fwd ({static or 'dynamic'}) {f_ms:.4f} ms")


def ek1_vs_plain(label, c, rtol, atol):
    """Phases 15-16: the filter kernel against the plain filter (its means
    directly, its stream through the plain smoother; with a linearization
    trajectory; fixed and fixedMAP with their sigma^2), the smoother kernel
    and the sampler kernel on the plain stream against their plain
    versions."""
    st_p, st_k = c.states_plain(), c.states_kernel()
    torch.cuda.synchronize()
    name = f"{label} ek1_filter_states_kernel"
    close(f"{name}, means", c.means(st_k), c.means(st_p), rtol, atol)
    say(f"   {name}: stream, largest scaled |kernel - plain| "
        f"{scaled_stream_diff(st_k, st_p):.3e} (reported, not held)")
    st_f = c.states_kernel(smooth=False)
    torch.cuda.synchronize()
    check(torch.equal(st_f, st_k[:, :st_f.shape[1]]),
          f"{name}: the filter-only stream ({st_f.shape[1]} rows) is the "
          "smoothing stream's first rows exactly")
    us_p, sd_p = c.smoother_plain(st_p)
    us_f, sd_f = c.smoother_plain(st_k)
    close(f"{name}, us through the plain smoother", us_f, us_p, rtol, atol)
    close(f"{name}, stds through the plain smoother", sd_f, sd_p, rtol, atol)
    us_k, sd_k = c.smoother_kernel(st_p)
    torch.cuda.synchronize()
    close(f"{label} ekd_smoother_kernel on the plain stream, us", us_k, us_p,
          rtol, atol)
    close(f"{label} ekd_smoother_kernel on the plain stream, stds", sd_k, sd_p,
          rtol, atol)
    x_k = c.sampler_kernel(st_p)
    torch.cuda.synchronize()
    close(f"{label} ekd_sampler_kernel on the plain stream, samples (S="
          f"{c.z.shape[1]})", x_k, c.sampler_plain(st_p), rtol, atol)
    lin = us_p.contiguous()
    st_lp, st_lk = c.states_plain(lin=lin), c.states_kernel(lin=lin)
    torch.cuda.synchronize()
    for what, got, ref in zip(("us", "stds"), c.filter_solution(st_lk),
                              c.filter_solution(st_lp)):
        close(f"{name} with a linearization trajectory, filter {what}", got,
              ref, rtol, atol)
    for static in EK1_STATIC:
        (st_sp, sig_p), (st_sk, sig_k) = (
            c.states_plain(static_diff=static, smooth=False),
            c.states_kernel(static_diff=static, smooth=False))
        torch.cuda.synchronize()
        close(f"{name} ({static}), sigma^2", sig_k, sig_p, rtol, atol)
        for what, got, ref in zip(("us", "stds"), c.filter_solution(st_sk),
                                  c.filter_solution(st_sp)):
            close(f"{name} ({static}), filter {what}", got, ref, rtol, atol)


# EK1 float32 against float64 at 8192 x 500: the means are held at ten
# times the CPU plain path's figure (scripts/torch_residual_census.py
# --only ek1: smoothed means 9.966e-06, stds 2.979e-07 with no entry outside
# the worst-lane criterion of phase 5, at which the smoothed stds are held).
EK1_F32_US_LIMIT = 1e-4
# The EK1 modes the front door runs: (smooth, diffusion)
EK1_MODES = [(s, m) for m in ("dynamic",) + EK1_STATIC for s in (True, False)]


def ek1_front_doors(odt, dtype):
    """Phase 17 for one dtype: ``solve_ensemble`` in each EK1 mode,
    ``sample_ensemble`` at S = 1 and S_MAIN and ``ieks_ensemble`` (1 and 3
    sweeps), each with the counts set to 0 just before and read just after.
    Returns the solutions by mode, the IEKS solution and the launches of the
    main paths' runs (the smoothed dynamic solve, the sampler at S_MAIN)."""
    names = ("ek1_filter_states", "ekd_smoother", "ekd_sampler")
    label = str(dtype)[6:]
    prob, u0s, ps = inputs(B_MAIN, dtype, TSPAN_MAIN)
    sols, launches = {}, {}
    grid = (T_MAIN + 1, 2, B_MAIN)
    for smooth, model in EK1_MODES:
        alg = odt.EK1(order=Q, smooth=smooth, diffusionmodel=model)
        reset_counts()
        sol = odt.solve_ensemble(prob, alg, u0s, ps, n_save=T_MAIN)
        torch.cuda.synchronize()
        counts = read_counts(*names)
        if smooth and model == "dynamic":
            launches.update({n: counts[n] for n in names[:2]})
        static = model != "dynamic"
        ok = (counts == {"ek1_filter_states": 1, "ekd_smoother": int(smooth),
                         "ekd_sampler": 0}
              and tuple(sol.us.shape) == tuple(sol.stds.shape) == grid
              and sol.lls is None
              and (tuple(sol.diffusions.shape) == (B_MAIN,) if static
                   else sol.diffusions is None)
              and all(bool(torch.isfinite(x).all()) for x in
                      (sol.us, sol.stds) + ((sol.diffusions,) if static else ())))
        check(ok, f"{label} EK1(smooth={smooth}, {model}): launches {counts}, "
              f"us {tuple(sol.us.shape)}, stds {tuple(sol.stds.shape)}, "
              f"diffusions "
              f"{None if sol.diffusions is None else tuple(sol.diffusions.shape)}"
              ", finite")
        sols[(smooth, model)] = sol
    for S in (1, S_MAIN):
        g = torch.Generator(device=DEVICE).manual_seed(S)
        reset_counts()
        us = odt.sample_ensemble(prob, odt.EK1(order=Q), u0s, ps, generator=g,
                                 n_steps=T_MAIN, n_samples=S)
        torch.cuda.synchronize()
        counts = read_counts(*names)
        if S == S_MAIN:
            launches["ekd_sampler"] = counts["ekd_sampler"]
        want = grid if S == 1 else (T_MAIN + 1, S, 2, B_MAIN)
        check(counts == {"ek1_filter_states": 1, "ekd_smoother": 0,
                         "ekd_sampler": 1}
              and tuple(us.shape) == want and bool(torch.isfinite(us).all()),
              f"{label} sample_ensemble(EK1) S={S}: launches {counts}, "
              f"samples {tuple(us.shape)}, finite")
        del us
    ieks = {}
    for k in (1, 3):
        reset_counts()
        ieks[k] = odt.ieks_ensemble(prob, odt.IEKS(order=Q), u0s, ps,
                                    n_steps=T_MAIN, iterations=k)
        torch.cuda.synchronize()
        counts = read_counts(*names)
        check(counts == {"ek1_filter_states": k, "ekd_smoother": k,
                         "ekd_sampler": 0}
              and tuple(ieks[k].us.shape) == tuple(ieks[k].stds.shape) == grid
              and bool(torch.isfinite(ieks[k].us).all()
                       and torch.isfinite(ieks[k].stds).all()),
              f"{label} ieks_ensemble({k} sweeps): launches {counts}, finite")
    ref = sols[(True, "dynamic")]
    check(torch.equal(ieks[1].us, ref.us) and torch.equal(ieks[1].stds, ref.stds),
          f"{label} ieks_ensemble, one sweep: the EK1 smoothed solution exactly")
    say(f"   {label} ieks_ensemble: max |us(3 sweeps) - us(1 sweep)| "
        f"{float((ieks[3].us - ref.us).abs().max()):.3e} (reported)")
    return sols, ieks[3], launches


def ek1_path(odt, card):
    """Phase 17: the three EK1 front doors at 8192 x 500 in float32 and
    float64 with their launches; float32 against float64; float64 means
    against DOP853; zero normals against the smoothed means; the sampler's
    calibration. Returns the launches of the main paths' runs (float32)."""
    sols, ieks, launches = {}, {}, {}
    for dtype in (torch.float32, torch.float64):
        sols[dtype], ieks[dtype], counts = ek1_front_doors(odt, dtype)
        if dtype == torch.float32:
            launches = counts
    say(f"   launches in the main paths' runs (float32): {launches}")
    s32, s64 = sols[torch.float32], sols[torch.float64]
    worst = {}
    for mode in EK1_MODES:
        name = f"EK1(smooth={mode[0]}, {mode[1]}) f32 vs f64"
        if mode == (True, "dynamic"):
            worst[mode] = worst_lane(name, s32[mode].us, s32[mode].stds,
                                     s64[mode].us, s64[mode].stds)[2]
            continue
        dus = (s32[mode].us.double() - s64[mode].us).abs()
        dsd = (s32[mode].stds.double() - s64[mode].stds).abs()
        outside = int((dsd > 1e-3 * s64[mode].stds.abs() + 1e-6).sum())
        worst[mode] = int(dus.amax(dim=(0, 1)).argmax())
        check(float(dus.max()) <= EK1_F32_US_LIMIT,
              f"{name}: max |dus| {float(dus.max()):.3e} <= "
              f"{EK1_F32_US_LIMIT:g} (worst member {worst[mode]})")
        text = (f"max |dstd| {float(dsd.max()):.3e}, {outside} entries outside "
                "1e-3 |std| + 1e-6")
        if mode[1] != "dynamic":
            rel = (s32[mode].diffusions.double() - s64[mode].diffusions).abs()
            text += (f"; sigma^2 largest relative difference "
                     f"{float((rel / s64[mode].diffusions).max()):.3e}")
        say(f"   {name}: {text} (reported)")
    dus = float((ieks[torch.float32].us.double() - ieks[torch.float64].us)
                .abs().max())
    check(dus <= EK1_F32_US_LIMIT, f"ieks_ensemble (3 sweeps) f32 vs f64: max "
          f"|dus| {dus:.3e} <= {EK1_F32_US_LIMIT:g}")

    ts = np.linspace(*TSPAN_MAIN, T_MAIN + 1)
    prob64, u0s64, ps64 = inputs(B_MAIN, torch.float64, TSPAN_MAIN)
    u0_np, p_np = u0s64.cpu().numpy(), ps64.cpu().numpy()
    members = sorted({0, 17, worst[(True, "dynamic")], B_MAIN - 1})
    refs = {k: reference_solution(u0_np[k], p_np[k], ts) for k in members}

    def ref_err(us):
        us = us.cpu().numpy()
        return max(float(np.abs(us[:, :, k] - refs[k]).max()) for k in members)

    for what, us in (("EK1 smoothed", s64[(True, "dynamic")].us),
                     ("IEKS (3 sweeps)", ieks[torch.float64].us)):
        e = ref_err(us)
        check(e <= 1e-5, f"f64 {what} means vs DOP853 (members {members}): "
              f"max |dus| {e:.3e} <= 1e-5")
    say(f"   f64 vs DOP853 (reported): EK1 filter means "
        f"{ref_err(s64[(False, 'dynamic')].us):.3e}, fixedMAP smoothed means "
        f"{ref_err(s64[(True, 'fixedMAP')].us):.3e}")
    del sols, ieks, s32, s64

    # zero normals: the sampler is the smoother's mean recursion over the
    # same stream, operation for operation
    for dtype in (torch.float64, torch.float32):
        c = EK1Case(B_MAIN, T_MAIN, dtype, TSPAN_MAIN)
        st = c.states_kernel()
        zeros = torch.zeros((T_MAIN + 1, 1, 2 * (Q + 1), B_MAIN), dtype=dtype,
                            device=DEVICE)
        x0 = c.sampler_kernel(st, zeros)[:, 0]
        us = c.smoother_kernel(st)[0]
        torch.cuda.synchronize()
        check(torch.equal(x0, us), f"{str(dtype)[6:]} EK1 zero normals: the "
              f"sampler kernel's path equals the smoother kernel's means "
              f"exactly (max |dus| {float((x0 - us).abs().max()):.3e})")
        del c, st

    # one member's posterior, tiled across the lanes: 8192 samples
    prob1, _, _ = inputs(1, torch.float64, TSPAN_MAIN)
    u0t = prob1.u0[None].expand(B_MAIN, 2).contiguous()
    pt = prob1.p[None].expand(B_MAIN, 4).contiguous()
    alg = odt.EK1(order=Q)
    us = odt.sample_ensemble(prob1, alg, u0t, pt, n_steps=T_MAIN,
                             generator=torch.Generator(device=DEVICE).manual_seed(11))
    ref = odt.solve_ensemble(prob1, alg, u0t[:1], pt[:1], n_save=T_MAIN)
    mean_s, std_s = ref.us[:, :, 0], ref.stds[:, :, 0]
    se = std_s / B_MAIN ** 0.5
    dmean = (us.mean(dim=2) - mean_s).abs()
    n_out = int((dmean >= 5.0 * se + 1e-12).sum())
    check(n_out == 0, f"EK1 calibration (f64, {B_MAIN} samples of one member): "
          f"empirical mean within 5 standard errors of the smoothed mean at "
          f"every (t, dim); {n_out} outside, largest |dmean| / se "
          f"{float((dmean / se.clamp(min=1e-300))[1:].max()):.3f}")
    mask = std_s > 1e-8
    ratio = us.std(dim=2, correction=0)[mask] / std_s[mask]
    worst_ratio = float((ratio - 1.0).abs().max())
    check(worst_ratio <= 0.05, f"EK1 calibration: |std ratio - 1| "
          f"{worst_ratio:.4f} <= 0.05 where the smoothed std > 1e-8 "
          f"({int(mask.sum())} entries)")
    return launches


def ek1_timing(odt, card):
    """Phase 18: the EK1 kernels against their plain versions at 8192 x 500
    in float32 (normals from ``torch.randn``, S = S_MAIN), then the timings
    of each kernel, each front door and each plain version once. Returns
    the kernels' (ms, plain ms, max |kernel - plain|)."""
    c = EK1Case(B_MAIN, T_MAIN, torch.float32, TSPAN_MAIN, S_MAIN,
                numpy_normals=False)
    st_p, states_plain_ms = once(c.states_plain)
    (us_pp, sd_pp), smoother_plain_ms = once(lambda: c.smoother_plain(st_p))
    x_pp, sampler_plain_ms = once(lambda: c.sampler_plain(st_p))
    st_k = c.states_kernel()
    us_kp, sd_kp = c.smoother_kernel(st_p)
    us_kk, sd_kk = c.smoother_kernel(st_k)
    x_kp = c.sampler_kernel(st_p)
    torch.cuda.synchronize()
    head = f"f32 at {B_MAIN} x {T_MAIN}"
    rtol, atol = 1e-4, 1e-6
    err = {
        "ek1_filter_states": max(
            close(f"{head} ek1_filter_states_kernel, means", c.means(st_k),
                  c.means(st_p), rtol, atol),
            close(f"{head} ek1_filter_states_kernel, us through the smoother "
                  "kernel", us_kk, us_kp, rtol, atol),
            close(f"{head} ek1_filter_states_kernel, stds through the smoother "
                  "kernel", sd_kk, sd_kp, rtol, atol)),
        "ekd_smoother": max(
            close(f"{head} ekd_smoother_kernel on the plain stream, us", us_kp,
                  us_pp, rtol, atol),
            close(f"{head} ekd_smoother_kernel on the plain stream, stds",
                  sd_kp, sd_pp, rtol, atol)),
        "ekd_sampler": close(
            f"{head} ekd_sampler_kernel on the plain stream, samples (S="
            f"{S_MAIN})", x_kp, x_pp, rtol, atol),
    }
    del x_pp, x_kp, us_kk, sd_kk, us_pp, sd_pp

    say(f"   timing, float32, B={B_MAIN}, T={T_MAIN}: CUDA events; card: {card}")
    z1 = c.z[:, :1].contiguous()
    ms = {"ek1_filter_states": time_ms(c.states_kernel, warmup=3, iters=20),
          "ekd_smoother": time_ms(lambda: c.smoother_kernel(st_p), warmup=3,
                                  iters=20),
          "ekd_sampler": time_ms(lambda: c.sampler_kernel(st_p), warmup=3,
                                 iters=20)}
    extra = {
        "ek1_filter_states (filter only)": lambda: c.states_kernel(smooth=False),
        "ek1_filter_states (fixedMAP, filter only)":
            lambda: c.states_kernel(static_diff="fixedMAP", smooth=False),
        "ek1_filter_states (linearization trajectory)":
            lambda: c.states_kernel(lin=us_kp),
        "ekd_sampler S=1": lambda: c.sampler_kernel(st_p, z1),
    }
    for name, k_ms in ms.items():
        say(f"   {name} kernel {k_ms:.4f} ms")
    for name, fn in extra.items():
        say(f"   {name} kernel {time_ms(fn, warmup=3, iters=20):.4f} ms")
    say(f"   plain (once): ek1_filter_states {states_plain_ms:.1f} ms, "
        f"ekd_smoother {smoother_plain_ms:.1f} ms, ekd_sampler S={S_MAIN} "
        f"{sampler_plain_ms:.1f} ms")
    del c, st_p, st_k
    prob, u0s, ps = inputs(B_MAIN, torch.float32, TSPAN_MAIN)
    g = torch.Generator(device=DEVICE).manual_seed(3)
    doors = {
        "solve_ensemble(EK1)": lambda: odt.solve_ensemble(
            prob, odt.EK1(order=Q), u0s, ps, n_save=T_MAIN),
        "solve_ensemble(EK1(smooth=False))": lambda: odt.solve_ensemble(
            prob, odt.EK1(order=Q, smooth=False), u0s, ps, n_save=T_MAIN),
        "solve_ensemble(EK1(diffusionmodel='fixedMAP'))":
            lambda: odt.solve_ensemble(
                prob, odt.EK1(order=Q, diffusionmodel="fixedMAP"), u0s, ps,
                n_save=T_MAIN),
        "sample_ensemble(EK1) S=1": lambda: odt.sample_ensemble(
            prob, odt.EK1(order=Q), u0s, ps, generator=g, n_steps=T_MAIN),
        f"sample_ensemble(EK1) S={S_MAIN}": lambda: odt.sample_ensemble(
            prob, odt.EK1(order=Q), u0s, ps, generator=g, n_steps=T_MAIN,
            n_samples=S_MAIN),
        "ieks_ensemble(IEKS, 3 sweeps)": lambda: odt.ieks_ensemble(
            prob, odt.IEKS(order=Q), u0s, ps, n_steps=T_MAIN, iterations=3),
    }
    for name, fn in doors.items():
        d_ms = time_ms(fn, warmup=2, iters=10)
        say(f"   {name}: {d_ms:.3f} ms = {B_MAIN / d_ms * 1e3:.0f} members/s")
    plain_ms = {"ek1_filter_states": states_plain_ms,
                "ekd_smoother": smoother_plain_ms,
                "ekd_sampler": sampler_plain_ms}
    return ms, plain_ms, err


def main() -> int:
    say("== 1. environment")
    if not torch.cuda.is_available():
        say("chip_smoke: torch.cuda.is_available() is false; a CUDA card is "
            "required (there is no CPU fallback)")
        return 2
    import odefilters_torch as odt
    from odefilters_torch.ops import _build

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    say(f"   card: {card}")
    say(f"   torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 is off")

    say("== 2. build")
    t0 = time.perf_counter()
    built = _build.build()
    _build.load()
    say(f"   built {built['path'].name} in {built['seconds']:.1f} s of nvcc "
        f"({time.perf_counter() - t0:.1f} s in all)")
    for line in built["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            say(f"   {line.strip()}")

    say(f"== 3. kernel vs plain, float64, B={B_CHECK}, T={T_CHECK}, "
        f"tspan={TSPAN_CHECK}")
    kernel_vs_plain("f64", Pair(B_CHECK, T_CHECK, torch.float64, TSPAN_CHECK),
                    rtol=1e-10, atol=1e-12)

    say(f"== 4. kernel vs plain, float32, B={B_CHECK}, T={T_CHECK}")
    kernel_vs_plain("f32", Pair(B_CHECK, T_CHECK, torch.float32, TSPAN_CHECK),
                    rtol=1e-4, atol=1e-6)

    say(f"== 5. main path: solve_ensemble, B={B_MAIN}, T={T_MAIN}, "
        f"tspan={TSPAN_MAIN}")
    alg = odt.EK0(order=Q)
    prob32, u0s32, ps32 = inputs(B_MAIN, torch.float32, TSPAN_MAIN)
    reset_counts()
    sol32 = odt.solve_ensemble(prob32, alg, u0s32, ps32, n_save=T_MAIN,
                               adaptive=False)
    torch.cuda.synchronize()
    launches = read_counts("ek0_pair_fwd", "ek0_pair_bwd")
    say(f"   launches in the main path's run: {launches}")
    check(all(n >= 1 for n in launches.values()),
          "both kernels launched in the main path's run")
    check(tuple(sol32.us.shape) == (T_MAIN + 1, 2, B_MAIN)
          and tuple(sol32.stds.shape) == (T_MAIN + 1, B_MAIN),
          f"shapes us {tuple(sol32.us.shape)}, stds {tuple(sol32.stds.shape)}")
    prob64, u0s64, ps64 = inputs(B_MAIN, torch.float64, TSPAN_MAIN)
    sol64 = odt.solve_ensemble(prob64, alg, u0s64, ps64, n_save=T_MAIN,
                               adaptive=False)
    torch.cuda.synchronize()
    e_us, e_sd, member = worst_lane("f32 vs f64", sol32.us, sol32.stds,
                                    sol64.us, sol64.stds)
    say(f"   worst member {member}: max |dus| {e_us:.3e}, max |dstd| "
        f"{e_sd:.3e} (all members)")
    ts = np.linspace(*TSPAN_MAIN, T_MAIN + 1)
    u0_np, p_np = u0s64.cpu().numpy(), ps64.cpu().numpy()
    us64 = sol64.us.cpu().numpy()
    ref_err = max(
        float(np.abs(us64[:, :, k] - reference_solution(u0_np[k], p_np[k], ts)).max())
        for k in sorted({0, 17, member, B_MAIN - 1})
    )
    check(ref_err <= 1e-5, f"f64 main path vs DOP853 (members 0, 17, "
          f"{member}, {B_MAIN - 1}): max |dus| {ref_err:.3e} <= 1e-5")

    say(f"== 6. timing, float32, B={B_MAIN}, T={T_MAIN}: CUDA events")
    say(f"   card: {card}")
    pair = Pair(B_MAIN, T_MAIN, torch.float32, TSPAN_MAIN)
    st_p = pair.fwd_plain()          # also the plain forward's warm-up
    plain_fwd_ms = time_ms(pair.fwd_plain, warmup=0, iters=2)
    plain_bwd_ms = time_ms(lambda: pair.bwd_plain(st_p), warmup=1, iters=2)
    fwd_ms = time_ms(pair.fwd_kernel, warmup=3, iters=20)
    bwd_ms = time_ms(lambda: pair.bwd_kernel(st_p), warmup=3, iters=20)
    solve_ms = time_ms(
        lambda: odt.solve_ensemble(prob32, alg, u0s32, ps32, n_save=T_MAIN,
                                   adaptive=False),
        warmup=3, iters=20,
    )
    say(f"   solve_ensemble (Taylor init + both kernels + epilogue): "
        f"{solve_ms:.3f} ms = {B_MAIN / solve_ms * 1e3:.0f} solves/s")
    for name, k_ms, p_ms in (("forward", fwd_ms, plain_fwd_ms),
                             ("backward", bwd_ms, plain_bwd_ms)):
        say(f"   {name} kernel {k_ms:.3f} ms = {B_MAIN / k_ms * 1e3:.0f} "
            f"solves/s, plain {name} {p_ms:.1f} ms = "
            f"{B_MAIN / p_ms * 1e3:.0f} solves/s")
    say(f"   plain pair {plain_fwd_ms + plain_bwd_ms:.1f} ms = "
        f"{B_MAIN / (plain_fwd_ms + plain_bwd_ms) * 1e3:.0f} solves/s")
    say("   each kernel at this shape vs its plain version "
        "(worst-lane criteria of phase 5):")
    us_p, sd_p = pair.solution(pair.bwd_plain(st_p))
    us_f, sd_f = pair.solution(pair.bwd_plain(pair.fwd_kernel()))
    us_b, sd_b = pair.solution(pair.bwd_kernel(st_p))
    err_fwd = worst_lane("headline forward kernel", us_f, sd_f, us_p, sd_p)[0]
    err_bwd = worst_lane("headline backward kernel", us_b, sd_b, us_p, sd_p)[0]

    say(f"== 7. filter kernels vs plain, float64, B={B_CHECK}, T={T_CHECK}")
    filter_vs_plain(
        "f64", Filter(B_CHECK, T_CHECK, torch.float64, TSPAN_CHECK),
        rtol=1e-10, atol=1e-12, hold_grads=True)

    say(f"== 8. filter kernels vs plain, float32, B={B_CHECK}, T={T_CHECK}")
    filter_vs_plain("f32", Filter(B_CHECK, T_CHECK, torch.float32, TSPAN_CHECK),
                    rtol=1e-4, atol=1e-6, hold_grads=False)

    say(f"== 9. the filter's path: solve_ensemble(EK0(smooth=False)) and "
        f"its gradient, B={B_MAIN}, T={T_MAIN}, tspan={TSPAN_MAIN}")
    counts32, prob32f, u0s32f, ps32f, fsol32, _ = filter_path(odt, torch.float32)
    launches.update({n: counts32[n] for n in
                     ("ek0_filter", "ek0_filter_grad_fwd", "ek0_filter_grad_bwd")})
    _, prob64f, u0s64f, ps64f, fsol64, (g_u, g_p) = filter_path(odt, torch.float64)
    # f32 vs f64 under the pair's criteria on the worst member; the f32
    # filter stds of other members carry the f32 calibration noise (entries
    # of ~1e-6 off by up to 1.95 relative on the CPU plain path), so their
    # count outside the criterion is reported
    dus = (fsol32.us.double() - fsol64.us).abs()
    dsd = (fsol32.stds.double() - fsol64.stds).abs()
    member = int(dus.amax(dim=(0, 1)).argmax())
    e_us = float(dus.max())
    outside = dsd > 1e-3 * fsol64.stds.abs() + 1e-6
    check(e_us <= 1e-4, f"filter f32 vs f64: max |dus| {e_us:.3e} <= 1e-4 "
          f"(worst member {member})")
    check(not outside[:, member].any(),
          f"filter f32 vs f64, worst member {member}: max |dstd| "
          f"{float(dsd[:, member].max()):.3e}, every entry within "
          "1e-3 |std| + 1e-6")
    say(f"   all members: max |dstd| {float(dsd.max()):.3e}, "
        f"{int(outside.sum())} entries outside 1e-3 |std| + 1e-6 (reported); "
        f"worst member's lls f32 {float(fsol32.lls[member]):.6f} vs f64 "
        f"{float(fsol64.lls[member]):.6f} (reported)")
    # The float64 gradient against central differences along a seeded
    # direction. The log-likelihood term carries rounding noise (its
    # innovations sit at the accuracy floor): its difference quotient does
    # not converge at this grid, so the whole loss is reported. The means
    # and stds term is held at 1e-4: its quotient's own noise floor is
    # ~1.4e-5 (CPU plain path, these inputs: 1.04e-5, 1.36e-5, 4.2e-6,
    # 1.3e-5 at steps 1e-4 .. 1e-7; the whole loss 0.29, 2.44, 1.25, 5.87).
    rng = np.random.default_rng(7)
    v_u = torch.tensor(rng.standard_normal(u0s64f.shape), device=DEVICE)
    v_p = torch.tensor(rng.standard_normal(ps64f.shape), device=DEVICE) * ps64f
    alg_f = odt.EK0(order=Q, smooth=False)

    def smooth_part(sol):
        return 0.1 * sol.us[:, 0].sum() + 0.01 * sol.stds.sum()

    def losses64(eps):
        with torch.no_grad():
            sol = odt.solve_ensemble(prob64f, alg_f, u0s64f + eps * v_u,
                                     ps64f + eps * v_p, n_save=T_MAIN)
            return float(filter_loss(sol)), float(smooth_part(sol))

    u, p = u0s64f.clone().requires_grad_(), ps64f.clone().requires_grad_()
    gs_u, gs_p = torch.autograd.grad(
        smooth_part(odt.solve_ensemble(prob64f, alg_f, u, p, n_save=T_MAIN)),
        (u, p))
    ad = (float((g_u * v_u).sum() + (g_p * v_p).sum()),
          float((gs_u * v_u).sum() + (gs_p * v_p).sum()))
    for eps in (1e-4, 1e-5, 1e-6):
        plus, minus = losses64(eps), losses64(-eps)
        for i, what in enumerate(("whole loss", "0.1 us + 0.01 stds")):
            fd = (plus[i] - minus[i]) / (2 * eps)
            rel = abs(fd - ad[i]) / abs(ad[i])
            text = (f"f64 gradient vs central difference, {what}, step "
                    f"{eps:g}: autograd {ad[i]:.9e}, difference {fd:.9e}, "
                    f"relative {rel:.3e}")
            if eps == 1e-5 and i == 1:
                check(rel <= 1e-4, f"{text} <= 1e-4")
            else:
                say(f"   {text} (reported)")
    # the hand adjoint against the plain torch.func.vjp sweep at full
    # length, with seeded cotangents of us, stds and lls: this holds the
    # log-likelihood's cotangent path that the difference quotient above
    # cannot, at the gradient tolerances of the check shape
    flt64 = Filter(B_MAIN, T_MAIN, torch.float64, TSPAN_MAIN)
    st64 = flt64.grad_fwd_plain()[3]
    (dm0_k, dps_k), (dm0_p, dps_p) = flt64.grad_bwd(st64), flt64.grad_bwd_plain(st64)
    torch.cuda.synchronize()
    name = f"f64 ek0_filter_grad_bwd_kernel vs plain at {B_MAIN} x {T_MAIN}"
    err_adjoint = max(
        close_rows(f"{name}, dm0", dm0_k, dm0_p, 1e-8, 1e-10),
        close_rows(f"{name}, dps", dps_k, dps_p, 1e-8, 1e-10))
    ts = np.linspace(*TSPAN_MAIN, T_MAIN + 1)
    u0_np, p_np = u0s64f.cpu().numpy(), ps64f.cpu().numpy()
    us64 = fsol64.us.cpu().numpy()
    ref_err = max(
        float(np.abs(us64[:, :, k] - reference_solution(u0_np[k], p_np[k], ts)).max())
        for k in sorted({0, 17, member, B_MAIN - 1})
    )
    # filter means at dt = 0.04: 2.39e-6 at most over 32 members on the CPU
    # plain path
    check(ref_err <= 1e-5, f"f64 filter means vs DOP853 (members 0, 17, "
          f"{member}, {B_MAIN - 1}): max |dus| {ref_err:.3e} <= 1e-5")

    say(f"== 10. the filter's kernels vs plain and timing, float32, "
        f"B={B_MAIN}, T={T_MAIN}: CUDA events")
    say(f"   card: {card}")
    flt = Filter(B_MAIN, T_MAIN, torch.float32, TSPAN_MAIN)
    f_plain_ms = {}
    refs = {}
    refs[None], f_plain_ms["ek0_filter"] = once(flt.primal_plain)
    refs.update({static: flt.primal_plain(static) for static in STATIC})
    refs["grad_fwd"], f_plain_ms["ek0_filter_grad_fwd"] = once(flt.grad_fwd_plain)
    st32 = refs["grad_fwd"][3]
    _, f_plain_ms["ek0_filter_grad_bwd"] = once(lambda: flt.grad_bwd_plain(st32))
    err_filter = outputs_vs_plain(f"f32 at {B_MAIN} x {T_MAIN}", flt, refs,
                                  rtol=1e-4, atol=1e-6)
    err_filter["ek0_filter_grad_bwd"] = err_adjoint
    f_ms = {
        "ek0_filter": time_ms(flt.primal, warmup=3, iters=20),
        "ek0_filter_grad_fwd": time_ms(flt.grad_fwd, warmup=3, iters=20),
        "ek0_filter_grad_bwd": time_ms(lambda: flt.grad_bwd(st32), warmup=3,
                                       iters=20),
    }

    def solve_fwd():
        with torch.no_grad():
            odt.solve_ensemble(prob32f, alg_f, u0s32f, ps32f, n_save=T_MAIN)

    def solve_grad():
        u, p = u0s32f.clone().requires_grad_(), ps32f.clone().requires_grad_()
        sol = odt.solve_ensemble(prob32f, alg_f, u, p, n_save=T_MAIN)
        torch.autograd.grad(filter_loss(sol), (u, p))

    fwd_solve_ms = time_ms(solve_fwd, warmup=3, iters=20)
    grad_solve_ms = time_ms(solve_grad, warmup=3, iters=10)
    say(f"   forward solve (Taylor init + ek0_filter_kernel + epilogue): "
        f"{fwd_solve_ms:.3f} ms = {B_MAIN / fwd_solve_ms * 1e3:.0f} solves/s")
    say(f"   forward + backward (Taylor init, gradient forward, adjoint "
        f"sweep, autograd through the init): {grad_solve_ms:.3f} ms = "
        f"{B_MAIN / grad_solve_ms * 1e3:.0f} gradients/s")
    for name in f_ms:
        say(f"   {name} kernel {f_ms[name]:.4f} ms, plain {f_plain_ms[name]:.1f} ms")

    say(f"== 11. sampler kernels vs plain, float64, B={B_CHECK}, T={T_CHECK}, "
        f"S={S_CHECK}")
    sampler_vs_plain("f64", Sampler(B_CHECK, T_CHECK, torch.float64,
                                    TSPAN_CHECK, S_CHECK),
                     rtol=1e-10, atol=1e-12)

    say(f"== 12. sampler kernels vs plain, float32, B={B_CHECK}, T={T_CHECK}, "
        f"S={S_CHECK}")
    sampler_vs_plain("f32", Sampler(B_CHECK, T_CHECK, torch.float32,
                                    TSPAN_CHECK, S_CHECK),
                     rtol=1e-4, atol=1e-6)

    say(f"== 13. the sampler's path: sample_ensemble, B={B_MAIN}, T={T_MAIN}, "
        f"S = 1 and {S_MAIN}")
    s_ms, s_plain_ms, s_err, s_launches = sampler_path(odt, card, sol32, sol64)
    launches.update(s_launches)

    say(f"== 14. the static pair: solve_ensemble(EK0(diffusionmodel=...)), "
        f"B={B_MAIN}, T={T_MAIN}")
    static_path(odt, card)

    say(f"== 15. EK1 kernels vs plain, float64, B={B_CHECK}, T={T_CHECK}, "
        f"S={S_CHECK}")
    ek1_vs_plain("f64", EK1Case(B_CHECK, T_CHECK, torch.float64, TSPAN_CHECK,
                                S_CHECK), rtol=1e-10, atol=1e-12)

    say(f"== 16. EK1 kernels vs plain, float32, B={B_CHECK}, T={T_CHECK}, "
        f"S={S_CHECK}")
    ek1_vs_plain("f32", EK1Case(B_CHECK, T_CHECK, torch.float32, TSPAN_CHECK,
                                S_CHECK), rtol=1e-4, atol=1e-6)

    say(f"== 17. the EK1 paths: solve_ensemble(EK1), sample_ensemble(EK1), "
        f"ieks_ensemble, B={B_MAIN}, T={T_MAIN}, tspan={TSPAN_MAIN}")
    launches.update(ek1_path(odt, card))

    say(f"== 18. the EK1 kernels vs plain and timing, float32, B={B_MAIN}, "
        f"T={T_MAIN}, S={S_MAIN}")
    e_ms, e_plain_ms, e_err = ek1_timing(odt, card)

    say("== bounds at the timed shape (float32, B={}, T={}, S={})".format(
        B_MAIN, T_MAIN, S_MAIN))
    bounds = kernel_bounds(B_MAIN, T_MAIN, torch.float32, S_MAIN)
    for name, (b_ms, b_by, ops) in bounds.items():
        say(f"   {name}: {ops} operations per step and member; bound "
            f"{b_ms:.4f} ms by {b_by}")
    bounds1 = kernel_bounds(B_MAIN, T_MAIN, torch.float32, 1)
    for name in ("ek0_sampler", "ekd_sampler"):
        b_ms, b_by, ops = bounds1[name]
        say(f"   {name} at S=1: {ops} operations per step and member; bound "
            f"{b_ms:.4f} ms by {b_by}")

    if failures:
        say(f"chip_smoke: {len(failures)} check(s) failed:")
        for f in failures:
            say(f"  - {f}")
        return 1
    ms = {"ek0_pair_fwd": fwd_ms, "ek0_pair_bwd": bwd_ms, **f_ms, **s_ms,
          **e_ms}
    plain_ms = {"ek0_pair_fwd": plain_fwd_ms, "ek0_pair_bwd": plain_bwd_ms,
                **f_plain_ms, **s_plain_ms, **e_plain_ms}
    errs = {"ek0_pair_fwd": err_fwd, "ek0_pair_bwd": err_bwd, **err_filter,
            **s_err, **e_err}
    kernels = [
        {"name": name, "route": "cuda", "source": SOURCE[name],
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": errs[name], "ms": ms[name], "plain_ms": plain_ms[name],
         "bound_ms": bounds[name][0], "bound_by": bounds[name][1],
         "library_ms": None}
        for name in SOURCE
    ]
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
