#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``odefilters_torch``) on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version on the card, drives the main path
(``odefilters_torch.solve_ensemble``: FitzHugh-Nagumo, EK0(3), dynamic
diffusion, 8192 members, 500 uniform steps, filter + RTS smoother) through
them, checks float32 against float64 on the worst lanes and float64
against an independent high-accuracy integrator, and times the solve, each
kernel and the plain pair with CUDA events.

Phases:
  1. environment: a CUDA card, its name and power limit, TF32 off;
  2. build: nvcc, sm_90a, from ``odefilters_torch/ops/csrc``;
  3. kernel vs plain in float64 (B = 1000, not a multiple of the block
     size, T = 60 at the headline step dt = 0.04);
  4. the same in float32;
  5. the main path through the front door, float32 and float64, with the
     kernels' launch counts;
  6. timings at 8192 x 500 in float32, each kernel also held against its
     plain version at that shape.

Tolerances. A kernel's output is held against the plain version in the
solution space: the forward kernel's stream goes through the plain
backward, the backward kernel reads the plain forward's stream, and the
smoothed means ``us`` and stds are compared. The raw stream is not held
to a relative tolerance: its diffusion and covariance entries carry the
innovation, a difference at the solver's accuracy floor, so one ulp of
rounding moves them by ~4e-7 relative in float64 and by O(1) in float32
(measured on the plain path; the kernels round differently, e.g. through
FMA contraction). Its largest scaled difference is printed.

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
SOURCE = "odefilters_torch/ops/csrc/ek0_pair.cu"
REPLACES = {
    "ek0_pair_fwd": "odefilters/ops/pallas_kernels.py:3843",
    "ek0_pair_bwd": "odefilters/ops/pallas_kernels.py:4186",
}

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
    ps = np.broadcast_to(prob.p.cpu().numpy(), (B, prob.p.shape[0]))
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


def main() -> int:
    say("== 1. environment")
    if not torch.cuda.is_available():
        say("chip_smoke: torch.cuda.is_available() is false; a CUDA card is "
            "required (there is no CPU fallback)")
        return 2
    import odefilters_torch as odt
    from odefilters_torch.ops import _build
    from odefilters_torch.ops import ek0_pair as ep

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
    ep.ek0_pair_fwd.launches = 0
    ep.ek0_pair_bwd.launches = 0
    sol32 = odt.solve_ensemble(prob32, alg, u0s32, ps32, n_save=T_MAIN,
                               adaptive=False)
    torch.cuda.synchronize()
    launches = {"ek0_pair_fwd": ep.ek0_pair_fwd.launches,
                "ek0_pair_bwd": ep.ek0_pair_bwd.launches}
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

    if failures:
        say(f"chip_smoke: {len(failures)} check(s) failed:")
        for f in failures:
            say(f"  - {f}")
        return 1
    kernels = [
        {"name": "ek0_pair_fwd", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES["ek0_pair_fwd"],
         "launches": launches["ek0_pair_fwd"], "max_abs_err": err_fwd,
         "ms": fwd_ms, "plain_ms": plain_fwd_ms},
        {"name": "ek0_pair_bwd", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES["ek0_pair_bwd"],
         "launches": launches["ek0_pair_bwd"], "max_abs_err": err_bwd,
         "ms": bwd_ms, "plain_ms": plain_bwd_ms},
    ]
    say(card)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
