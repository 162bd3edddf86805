#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``odefilters_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version on the card, drives the port's two
paths through the front door ``odefilters_torch.solve_ensemble`` at the
headline width (FitzHugh-Nagumo, EK0(3), IBM prior, 8192 members, 500
uniform steps over (0, 20)) through them: the filter + RTS smoother pair,
and the filter with its per-member log-likelihood and that likelihood's
gradient by ``torch.autograd``. It checks float32 against float64 on the
worst lanes, float64 against an independent high-accuracy integrator, the
float64 gradient against a finite difference, and times each path, each
kernel and the plain versions with CUDA events.

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
     solve, forward + backward, and each plain version once.

The second-last line of the output names the card and its power limit;
the line before it lists the five kernels with their launches on their
path, errors, times, plain times and bounds (``bound_ms``: the larger of
the bytes each must move over 3.35 TB/s and the operations its plain
version does, counted per step under a dispatch mode, over 67 TFLOP/s of
float32; H100 SXM data sheet). ``max_abs_err`` is kernel against plain at
8192 x 500: in float32 for the pair (phase 6), the primal filter and the
gradient's forward (phase 10), in float64 for the adjoint (phase 9).

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
}
REPLACES = {
    "ek0_pair_fwd": "odefilters/ops/pallas_kernels.py:3843",
    "ek0_pair_bwd": "odefilters/ops/pallas_kernels.py:4186",
    "ek0_filter": "odefilters/ops/pallas_kernels.py:360",
    "ek0_filter_grad_fwd": "odefilters/ops/pallas_kernels.py:534",
    "ek0_filter_grad_bwd": "odefilters/ops/pallas_kernels.py:586",
}
STATIC = ("fixed", "fixedMAP", "fixedMV")
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

    def fwd_kernel(self):
        return self.ep.ek0_pair_fwd(self.prob.f, self.prob.field, self.m0_p,
                                    self.ps, **self.fwd_kw)

    def fwd_plain(self):
        return self.ep.ek0_pair_fwd_plain(self.prob.f, self.m0_p, self.ps,
                                          **self.fwd_kw)

    def bwd_kernel(self, st):
        return self.ep.ek0_pair_bwd(st, **self.bwd_kw)

    def bwd_plain(self, st):
        return self.ep.ek0_pair_bwd_plain(st, **self.bwd_kw)

    def solution(self, out):
        """(us, stds) from the backward's (us | raw variance) rows."""
        return out[:, :2], self.pinv0 * torch.sqrt(torch.clamp(out[:, 2], min=0.0))


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


def counters():
    """Every kernel wrapper, by the name the kernels line uses."""
    from odefilters_torch.ops import ek0_filter as ef
    from odefilters_torch.ops import ek0_pair as ep

    return {"ek0_pair_fwd": ep.ek0_pair_fwd, "ek0_pair_bwd": ep.ek0_pair_bwd,
            "ek0_filter": ef.ek0_filter,
            "ek0_filter_grad_fwd": ef.ek0_filter_grad_fwd,
            "ek0_filter_grad_bwd": ef.ek0_filter_grad_bwd}


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


def kernel_bounds(B, T, dtype):
    """{name: (bound_ms, bound_by, operations per step and member)} of the
    five kernels at (B, T): each reads its inputs once and writes its
    outputs once."""
    from odefilters_torch.ops import ek0_filter as ef
    from odefilters_torch.ops import ek0_pair as ep

    nq, d, n_p, V = Q + 1, 2, 4, 15
    one = Filter(1, 2, dtype, (0.0, 2 * (TSPAN_MAIN[1] - TSPAN_MAIN[0]) / T_MAIN))
    f, m0, ps = one.f, one.m0_p, one.ps
    kw = {k: v for k, v in one.kw.items() if k != "n_steps"}
    QLt = ep.pair_constants(Q, kw["dt"])[2]

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
    }
    # elements moved: initial state and parameters, stream, per-step rows
    init, stream, rows = (nq * d + n_p) * B, (T + 1) * V * B, (T + 1) * B
    elems = {
        "ek0_pair_fwd": init + stream,
        "ek0_pair_bwd": stream + rows * (d + 1),
        "ek0_filter": init + rows * (d + 1) + B,
        "ek0_filter_grad_fwd": init + rows * (d + 1) + B + stream,
        "ek0_filter_grad_bwd": stream + n_p * B + rows * (d + 1) + B + init,
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

    say("== bounds at the timed shape (float32, B={}, T={})".format(B_MAIN, T_MAIN))
    bounds = kernel_bounds(B_MAIN, T_MAIN, torch.float32)
    for name, (b_ms, b_by, ops) in bounds.items():
        say(f"   {name}: {ops} operations per step and member; bound "
            f"{b_ms:.4f} ms by {b_by}")

    if failures:
        say(f"chip_smoke: {len(failures)} check(s) failed:")
        for f in failures:
            say(f"  - {f}")
        return 1
    ms = {"ek0_pair_fwd": fwd_ms, "ek0_pair_bwd": bwd_ms, **f_ms}
    plain_ms = {"ek0_pair_fwd": plain_fwd_ms, "ek0_pair_bwd": plain_bwd_ms,
                **f_plain_ms}
    errs = {"ek0_pair_fwd": err_fwd, "ek0_pair_bwd": err_bwd, **err_filter}
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
