"""Adaptive per-member EK0 ensemble solves: plain PyTorch versions and the
wrappers of the three CUDA kernels that replace the JAX package's adaptive
EK0 filter and its attempt-stream filter + RTS smoother pair.

=====================================  =====================================
this module                            ``odefilters/ops/pallas_kernels.py``
=====================================  =====================================
``GAMMA``, ``QMIN``, ``QMAX``,         ``_GAMMA, _QMIN, _QMAX, _QOLDINIT``
``QOLDINIT``
``controller``                         the host constants of
                                       ``ek0_adaptive_filter`` (``dtmin``,
                                       ``beta1``, ``beta2``)
``attempt``                            one attempt of the loop body of
                                       ``_ek0_adaptive_kernel``
``begin``, ``control``, ``run``        its start, its error estimate, PI
                                       controller and commits, and the
                                       loop (shared with ``ek1d_adaptive``)
``smoother_step``                      one step of the loop body of
                                       ``_ek0_adaptive_smoother_kernel``
                                       (its shared part ``backward_shared``,
                                       ``conditioned_mean``: also the
                                       sampler's, `ek0_adaptive_sample`)
``walk_back``                          the walk over each member's accepted
                                       rows (the smoothers' and the
                                       sampler's)
``ek0_adaptive_plain`` /               ``_ek0_adaptive_kernel`` (CUDA:
``ek0_adaptive``                       ``csrc/ek0_adaptive.cu::
                                       ek0_adaptive_kernel``)
``ek0_adaptive_stream_plain`` /        ``_ek0_adaptive_stream_kernel``
``ek0_adaptive_stream``                (CUDA: ``ek0_adaptive_stream_kernel``)
``ek0_adaptive_smoother_plain`` /      ``_ek0_adaptive_smoother_kernel``
``ek0_adaptive_smoother``              (CUDA:
                                       ``ek0_adaptive_smoother_kernel``)
``ek0_adaptive_filter``                ``ek0_adaptive_filter``
``ek0_adaptive_fused_smooth``          ``ek0_adaptive_fused_smooth``
``solve_ensemble_ek0_adaptive``        ``solve_ensemble_ek0_adaptive_pallas``
``solve_ensemble_ek0_adaptive_smooth``  ``solve_ensemble_ek0_adaptive_smooth_
                                       pallas``
=====================================  =====================================

Each member runs its own PI-controlled step loop (OrdinaryDiffEq's
constants) of the EK0 with the dynamic diffusion, and lands exactly on
each point of the uniform save grid of ``n_save`` intervals (tstops). The
state is carried unpreconditioned and preconditioned afresh at each
attempt's step size, as in the JAX kernels.

**The covariance as a factor.** The JAX kernels carry the plain
covariance ``C`` and update it as ``Cp - k k^T s``; the backward pass
Cholesky-factors it at the next step's size. In float32 that ``C`` loses
its positive definiteness: at abstol 1e-6, reltol 1e-4 over (0, 20),
``C[0][0]`` of a member whose dynamic diffusion has fallen far comes out
negative, the guarded Cholesky divides by its 1e-15 floor, and the
smoothed means turn NaN. Here the forward
carries a factor ``L`` (``C = L L^T``, not triangular) and re-triangularises
the prediction by modified Gram-Schmidt, as the fixed-grid sampler's
forward does; the backward pass preconditions the streamed factor by
scaling its rows and needs no Cholesky factorisation.

**No barrier.** The JAX kernels step a block of 1024 lanes together and
emit a save row only when every lane of the block has reached it; a lane
that waits changes nothing, so each member's result does not depend on
its neighbours. Here each member keeps its own save counter and writes its
row when its accepted step reaches the save time. Two consequences differ
only where ``max_iters`` binds: the port counts ``max_iters`` per member
(``nacc + nrej``), the JAX kernels per block with the waits included; and
the port marks only an unfinished member failed, the JAX kernels every
lane of an unfinished block. A failed member's remaining save rows hold
its last committed state, as the JAX kernels' parked lanes write them.

**The compacted stream.** The JAX forward streams one row per block
attempt, rejected and idle rows included, because a lane-vectorized row
cannot be compacted per lane. Here each member writes only its accepted
steps, at row ``nacc - 1`` of a ``(max_iters, W, B)`` stream (B
contiguous), and the backward pass walks rows ``nacc - 1 .. 0`` of its
own member. A row holds ``[m (nq*d) | L (nq*nq, row-major) | log dt_eff |
s2 | save index]``, W = 27 at q = 3, d = 2; the save index is ``seg + 1``
where the step reached save point ``seg + 1``, else 0.

The plain versions run every member of the ensemble at once on lists of
``(B,)`` tensors, with per-member masks in place of the kernels' per-thread
control flow, in the kernels' order of operations, at any order q. The
filter's kernel is built for q = 1, 2, 3 (the time-parallel solves' warm
start runs it at min(q, 3), as the JAX package does; it also counts its
launches by order in ``ek0_adaptive.launches_by_order``), the other
kernels for q = 3 (``_launch.kernel_orders``). Dispatch: each wrapper
runs its plain version on CPU tensors, launches its CUDA kernel on CUDA
tensors, raises on any other device, and counts its launches in
``.launches``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from odefilters_torch.ops import _launch
from odefilters_torch.ops._blocks import _lists, _smul, _sreduce
from odefilters_torch.ops.ek0_filter import _LOG_2PI
from odefilters_torch.ops.ek0_pair import innovation
from odefilters_torch.ops.ek0_sample import (
    BX, list_cho_solve, list_mgs_tril, t_rows,
)
from odefilters_torch.priors import _ibm_small_np

GAMMA, QMIN, QMAX, QOLDINIT = 0.9, 0.2, 10.0, 1e-4
# the C entry points' per-member counts (int32 rows of one (N_COUNTS, B)
# tensor): accepted and rejected attempts, failed, save points reached
N_COUNTS = 4


@dataclasses.dataclass(frozen=True)
class Controller:
    """Host constants of the adaptive kernels: the IBM prior's
    preconditioned transition ``At``, its noise factor ``QLt``, its noise
    ``Qt = QLt QLt^T`` and that noise's measured entry ``qbx`` (values
    rounded to the working dtype, as the JAX kernels bake them in; the
    matrices as float64 numpy), the save grid, the tolerances, the attempt
    budget per member, the smallest step and the PI controller's
    exponents."""

    At: np.ndarray
    QLt: np.ndarray
    Qt: np.ndarray
    qbx: float
    t0: float
    dt_save: float
    n_save: int
    abstol: float
    reltol: float
    max_iters: int
    dtmin: float
    beta1: float
    beta2: float

    def host(self):
        """The C side's constants array (``csrc/ek0_adaptive.cuh``:
        ``read_adapt_consts``); the leading 2 x 2 block of ``Qt`` last,
        which the DiagonalEK1 kernels' measurement rows see."""
        return _launch.host_consts(
            self.At, self.QLt,
            scalars=(self.qbx, self.t0, self.dt_save, self.abstol,
                     self.reltol, self.dtmin, self.beta1, self.beta2,
                     *self.Qt[:2, :2].ravel()))


def default_dtmin(t0: float, t1: float, dtype: torch.dtype) -> float:
    """``max(1e-14 span, 4 eps span)``: below ~eps * span a step cannot
    advance t at all (t + dt == t)."""
    span = float(t1) - float(t0)
    return max(1e-14 * span, 4.0 * float(torch.finfo(dtype).eps) * span)


def controller(q: int, t0: float, t1: float, n_save: int, dtype: torch.dtype,
               *, abstol: float, reltol: float, max_iters: int,
               dtmin: Optional[float] = None) -> Controller:
    """The constants of an adaptive solve of order ``q`` over ``(t0, t1)``
    with ``n_save`` save intervals in ``dtype``."""
    At, _, QLt = _ibm_small_np(q)
    np_dtype = np.float32 if dtype == torch.float32 else np.float64

    def rounded(M):
        return np.asarray(M, dtype=np_dtype).astype(np.float64)

    nq = q + 1
    S = int(n_save)
    Qt = rounded(QLt @ QLt.T)
    return Controller(
        At=rounded(At), QLt=rounded(QLt), Qt=Qt, qbx=float(Qt[BX, BX]),
        t0=float(t0), dt_save=(float(t1) - float(t0)) / S, n_save=S,
        abstol=float(abstol), reltol=float(reltol), max_iters=int(max_iters),
        dtmin=float(default_dtmin(t0, t1, dtype) if dtmin is None else dtmin),
        beta1=7.0 / (10.0 * nq), beta2=2.0 / (5.0 * nq),
    )


def stream_width(nq: int, d: int) -> int:
    """Width of an accepted-step stream row (27 at q = 3, d = 2)."""
    return nq * d + nq * nq + 3


# --------------------------------------------------------------- forward


@dataclasses.dataclass
class Members:
    """Per-member loop state of the adaptive forward: the mean ``m``
    (nq x d) and a factor ``L`` (nq x nq, ``C = L L^T``, not triangular)
    of the covariance, lists of ``(B,)`` tensors, unpreconditioned; the
    previous accepted solution ``u_prev``; time, step, controller memory,
    log-likelihood; save points reached, accepted and rejected attempts
    (int64); ``failed`` (bool)."""

    m: list
    L: list
    u_prev: list
    t: torch.Tensor
    dt: torch.Tensor
    qold: torch.Tensor
    ll: torch.Tensor
    seg: torch.Tensor
    nacc: torch.Tensor
    nrej: torch.Tensor
    failed: torch.Tensor

    @classmethod
    def start(cls, m0: torch.Tensor, dt0s: torch.Tensor, t0: float):
        nq, d, _ = m0.shape
        zero = torch.zeros_like(dt0s)
        count = torch.zeros(dt0s.shape, dtype=torch.int64, device=dt0s.device)
        return cls(
            m=[[m0[i, j] for j in range(d)] for i in range(nq)],
            L=[[zero] * nq for _ in range(nq)],
            u_prev=[m0[0, j] for j in range(d)],
            t=zero + t0, dt=dt0s.clone(), qold=zero + QOLDINIT, ll=zero,
            seg=count, nacc=count, nrej=count,
            failed=torch.zeros(dt0s.shape, dtype=torch.bool,
                               device=dt0s.device),
        )

    def live(self, c: Controller) -> torch.Tensor:
        """Members still stepping: not failed, save points left, attempts
        left."""
        return (~self.failed & (self.seg < c.n_save)
                & (self.nacc + self.nrej < c.max_iters))


def attempt(st: Members, p, *, f: Callable, c: Controller,
            live: torch.Tensor) -> dict:
    """One attempt of every ``live`` member (the others change nothing):
    precondition at the attempt's step, one square-root EK0(dynamic) step,
    then `control`, in the order of the JAX kernel's loop body (with the
    factor in place of the plain covariance). Updates ``st`` in place (its
    fields are rebound, no tensor is written) and returns the attempt's
    ``accept``, ``lh`` (log dt_eff), ``s2`` and ``reached`` (an accepted
    step that reached save point ``seg_before + 1``) with
    ``seg_before``."""
    nq, d = len(st.m), len(st.m[0])
    At, QLt = _lists(c.At), _lists(c.QLt)
    a = begin(st, c, live)
    lh, ps_ = a["lh"], a["ps_"]
    mh = [[st.m[i][j] * ps_[i] for j in range(d)] for i in range(nq)]
    Lh = [[st.L[i][l] * ps_[i] for l in range(nq)] for i in range(nq)]
    q_half = nq - 1 + 0.5
    pinv0 = torch.exp(q_half * lh)
    pb = torch.exp((q_half - BX) * lh)
    hq = pb * pb * c.qbx

    # -- one EK0(dynamic) step in the member's preconditioned frame --
    mp = [[_sreduce([_smul(At[i][l], mh[l][j]) for l in range(nq)])
           for j in range(d)] for i in range(nq)]
    u_pred = torch.stack([pinv0 * mp[0][j] for j in range(d)])
    du = f(u_pred, p, a["t_new"])
    z = [innovation(pb, mp[BX][j], du[j]) for j in range(d)]
    zz = _sreduce([zj * zj for zj in z])
    s2 = zz / (d * hq)
    # the predicted factor: Lp Lp^T = At Ch At^T + s2 Qt
    Lp = predict_factor(At, QLt, Lh, torch.sqrt(s2), nq)
    s = pb * pb * _sreduce([Lp[BX][l] * Lp[BX][l] for l in range(nq)])
    inv_s = 1.0 / s
    kg = [pb * _sreduce([Lp[i][l] * Lp[BX][l] for l in range(nq)]) * inv_s
          for i in range(nq)]
    m_new = [[mp[i][j] - kg[i] * z[j] for j in range(d)] for i in range(nq)]
    zrow = [pb * Lp[BX][l] for l in range(nq)]
    L_new = [[Lp[i][l] - kg[i] * zrow[l] for l in range(nq)]
             for i in range(nq)]
    ll_inc = -0.5 * (zz * inv_s
                     + d * (torch.log(torch.clamp(s, min=1e-30)) + _LOG_2PI))
    u_filt = [pinv0 * m_new[0][j] for j in range(d)]

    # -- error estimate (EK0 dynamic: sqrt(s2 hq) == sqrt(zz/d)) --
    err = torch.sqrt(zz / d)
    accept, reached = control(st, c, a, errs=[err] * d, u_filt=u_filt,
                              m_new=m_new, ll_inc=ll_inc)
    st.L = [[torch.where(accept, L_new[i][l] / ps_[i], st.L[i][l])
             for l in range(nq)] for i in range(nq)]
    return dict(accept=accept, lh=lh, s2=s2, reached=reached,
                seg_before=a["seg"])


def begin(st: Members, c: Controller, live: torch.Tensor) -> dict:
    """The start of an attempt, shared by the EK0 and DiagonalEK1 loops:
    the next save time, which members are active, the attempt's step
    ``dt_eff`` (truncated to land on the save point), its log ``lh``, the
    preconditioner ``ps_`` at that step and the new time."""
    nq = len(st.m)
    q_half = nq - 1 + 0.5
    t, dt, seg = st.t, st.dt, st.seg
    dtype = t.dtype
    t_save = (torch.tensor(c.t0, dtype=dtype, device=t.device)
              + torch.tensor(c.dt_save, dtype=dtype, device=t.device)
              * (seg.to(dtype) + 1.0))
    active = live & (t < t_save)
    remaining = t_save - t
    hit_save = dt >= remaining
    dt_eff = torch.where(active, torch.where(hit_save, remaining, dt),
                         torch.ones_like(t))
    # -- precondition at this attempt's h (fresh from canonical) --
    lh = torch.log(dt_eff)
    ps_ = [torch.exp((i - q_half) * lh) for i in range(nq)]
    return dict(t_save=t_save, active=active, hit_save=hit_save,
                dt_eff=dt_eff, lh=lh, ps_=ps_, seg=seg,
                t_new=torch.where(hit_save, t_save, t + dt_eff))


def predict_factor(At, QLt, Lh, sq_s2, nq: int):
    """The lower factor ``Lp`` of ``At Lh Lh^T At^T + s2 QLt QLt^T`` by
    modified Gram-Schmidt on the stack ``[(At Lh)^T; (sq_s2 QLt)^T]``."""
    AtL = [[_sreduce([_smul(At[i][a], Lh[a][b]) for a in range(nq)])
            for b in range(nq)] for i in range(nq)]
    qT = [[_smul(sq_s2, QLt[i][a]) for i in range(nq)] for a in range(nq)]
    return list_mgs_tril(t_rows(AtL, nq) + qT, 2 * nq, nq)


def control(st: Members, c: Controller, a: dict, *, errs, u_filt, m_new,
            ll_inc):
    """The end of an attempt, shared by the EK0 and DiagonalEK1 loops: the
    error estimate from the per-dimension unscaled errors ``errs`` and the
    filtered solution ``u_filt``, the per-member PI controller, the failure
    checks, and the masked commits of everything but the covariance factor
    (the mean ``m_new`` un-preconditioned with ``a["ps_"]``), in the order
    of the JAX kernels' loop bodies. ``a``: what `begin` returned. Updates
    ``st`` in place and returns ``(accept, reached)``."""
    d, nq = len(u_filt), len(m_new)
    active, hit_save, dt_eff = a["active"], a["hit_save"], a["dt_eff"]
    t, dt, seg, t_new = st.t, st.dt, st.seg, a["t_new"]
    rr = []
    for j in range(d):
        sc = c.abstol + c.reltol * torch.maximum(torch.abs(st.u_prev[j]),
                                                 torch.abs(u_filt[j]))
        r = dt_eff * errs[j] / sc
        rr.append(r * r)
    EEst = torch.sqrt(_sreduce(rr) / d)
    EEst = torch.where(torch.isfinite(EEst), EEst, 1e10)
    accept = active & (EEst <= 1.0)

    # -- per-member PI controller (OrdinaryDiffEq constants) --
    leg = torch.log(torch.clamp(EEst, min=1e-35))
    q11 = torch.exp(c.beta1 * leg)
    qq = q11 * torch.exp(-c.beta2 * torch.log(torch.clamp(st.qold, min=1e-35)))
    # a division by a constant is a product with its reciprocal, folded in
    # double: XLA takes it so, and PyTorch on the card too
    qq = torch.clamp(qq * (1.0 / GAMMA), min=1.0 / QMAX, max=1.0 / QMIN)
    dt_acc = dt_eff / qq
    # a step truncated to land on a save point must not collapse the
    # controller's step size
    last_seg = seg >= c.n_save - 1
    dt_acc = torch.where(hit_save & ~last_seg, torch.maximum(dt_acc, dt),
                         dt_acc)
    qold_acc = torch.clamp(EEst, min=QOLDINIT)
    dt_rej = dt_eff / torch.clamp(q11 * (1.0 / GAMMA), max=1.0 / QMIN)
    dt_new = torch.where(accept, dt_acc, dt_rej)
    # a member fails when its next dt collapses below dtmin (accepted or
    # not) or when an accepted step makes no floating-point progress
    newly_failed = active & ~hit_save & (
        (dt_new < c.dtmin) | (accept & (t_new <= t)))
    failed = st.failed | newly_failed

    # -- un-precondition, then masked commits --
    ps_ = a["ps_"]
    st.m = [[torch.where(accept, m_new[i][j] / ps_[i], st.m[i][j])
             for j in range(d)] for i in range(nq)]
    st.t = torch.where(accept, t_new, t)
    st.dt = torch.where(active & ~failed, dt_new, dt)
    st.qold = torch.where(accept, qold_acc, st.qold)
    st.ll = torch.where(accept, st.ll + ll_inc, st.ll)
    st.u_prev = [torch.where(accept, u_filt[j], st.u_prev[j])
                 for j in range(d)]
    st.nacc = st.nacc + accept
    st.nrej = st.nrej + (active & ~accept)
    st.failed = failed
    reached = accept & (st.t >= a["t_save"])
    st.seg = seg + reached
    return accept, reached


def run(st: Members, c: Controller, step, on_attempt) -> Members:
    """Run the attempt loop from ``st`` until no member is live:
    ``step(st, live)`` makes one attempt (`attempt`, or the DiagonalEK1
    one) and returns its ``out``, then ``on_attempt(st, out)`` runs;
    returns the final state."""
    while True:
        live = st.live(c)
        if not bool(live.any()):
            return st
        on_attempt(st, step(st, live))


def _forward(f, m0, ps, dt0s, c: Controller, on_attempt):
    return run(Members.start(m0, dt0s, c.t0), c,
               lambda st, live: attempt(st, ps, f=f, c=c, live=live),
               on_attempt)


def _fill_tail(out_rows, seg, value):
    """Rows k > seg of each member (k = 1 .. S) take ``value``: a failed
    or unfinished member's remaining save rows hold its final state."""
    for k in range(1, out_rows.shape[0]):
        out_rows[k] = torch.where(seg < k, value, out_rows[k])


def _counts(st: Members, c: Controller) -> torch.Tensor:
    """``(N_COUNTS, B)`` int32: nacc, nrej, failed (a failure, or save
    points left), save points reached."""
    failed = st.failed | (st.seg < c.n_save)
    return torch.stack([st.nacc, st.nrej, failed.long(), st.seg]).int()


def ek0_adaptive_plain(f: Callable, m0: torch.Tensor, ps: torch.Tensor,
                       dt0s: torch.Tensor, c: Controller):
    """The adaptive filter from unpreconditioned initial means ``m0``
    ``(nq, d, B)``, parameters ``ps`` ``(n_params, B)`` and initial steps
    ``dt0s`` ``(B,)``: ``(us (S+1, d, B), stds (S+1, B), lls (B,),
    counts (N_COUNTS, B))``. Row 0 is the exact initial state with std 0;
    row k the filtered mean of block 0 and its std at save point k."""
    nq, d, B = m0.shape
    S = c.n_save
    us = torch.empty((S + 1, d, B), dtype=m0.dtype, device=m0.device)
    stds = torch.empty((S + 1, B), dtype=m0.dtype, device=m0.device)
    us[0] = m0[0]
    stds[0] = 0.0

    def emit(st, out):
        idx = torch.nonzero(out["reached"]).flatten()
        if idx.numel():
            k = out["seg_before"][idx] + 1
            for j in range(d):
                us[k, j, idx] = st.m[0][j][idx]
            stds[k, idx] = _std(st.L)[idx]

    st = _forward(f, m0, ps, dt0s, c, emit)
    for j in range(d):
        _fill_tail(us[:, j], st.seg, st.m[0][j])
    _fill_tail(stds, st.seg, _std(st.L))
    return us, stds, st.ll, _counts(st, c)


def ek0_adaptive_stream_plain(f: Callable, m0: torch.Tensor, ps: torch.Tensor,
                              dt0s: torch.Tensor, c: Controller):
    """The adaptive forward that streams each member's accepted steps:
    ``(st (max_iters, W, B), lls (B,), counts (N_COUNTS, B))``; row r of
    member b is its (r+1)-th accepted step (rows from ``nacc`` on are
    never written)."""
    nq, d, B = m0.shape
    st_out = torch.zeros((c.max_iters, stream_width(nq, d), B),
                         dtype=m0.dtype, device=m0.device)

    def emit(st, out):
        idx = torch.nonzero(out["accept"]).flatten()
        if not idx.numel():
            return
        mark = torch.where(out["reached"], out["seg_before"] + 1, 0)
        vals = ([x for mi in st.m for x in mi] + [x for Li in st.L for x in Li]
                + [out["lh"], out["s2"], mark.to(m0.dtype)])
        st_out[st.nacc[idx] - 1, :, idx] = torch.stack(vals)[:, idx].T

    st = _forward(f, m0, ps, dt0s, c, emit)
    return st_out, st.ll, _counts(st, c)


# -------------------------------------------------------------- backward


def backward_shared(m_f, L_f, lh, s2, *, At, QLt, nq: int, d: int):
    """The part of a backward step from the filtered state ``(m_f, L_f)``
    of an accepted step that the smoother and the sampler share, in the
    frame preconditioned at the next accepted step's ``lh`` (log dt_eff)
    with its ``s2``: the preconditioner ``ps_``, the preconditioned mean
    ``mh_f``, the gain ``G = Ch_f At^T (Lp Lp^T)^-1`` (``Lp`` recomputed by
    the forward's MGS; ``Lh_f``, the filtered factor with its rows scaled,
    needs no Cholesky factorisation), the predicted mean ``mp`` and the
    stack blocks ``b1 = (I - G At) Lh_f`` and ``GQ = sqrt(s2) G QLt``."""
    q_half = nq - 1 + 0.5
    ps_ = [torch.exp((i - q_half) * lh) for i in range(nq)]
    Lh_f = [[L_f[i][l] * ps_[i] for l in range(nq)] for i in range(nq)]
    mh_f = [[m_f[i][j] * ps_[i] for j in range(d)] for i in range(nq)]
    sq_s2 = torch.sqrt(s2)
    AtL = [[_sreduce([_smul(At[i][a], Lh_f[a][b]) for a in range(nq)])
            for b in range(nq)] for i in range(nq)]
    qT = [[_smul(sq_s2, QLt[i][a]) for i in range(nq)] for a in range(nq)]
    Lp = list_mgs_tril(t_rows(AtL, nq) + qT, 2 * nq, nq)
    M = [[_sreduce([Lh_f[i][b] * AtL[l][b] for b in range(nq)])
          for l in range(nq)] for i in range(nq)]
    G = [list_cho_solve(Lp, M[i], nq) for i in range(nq)]
    mp = [[_sreduce([_smul(At[i][l], mh_f[l][j]) for l in range(nq)])
           for j in range(d)] for i in range(nq)]
    GA = [[_sreduce([_smul(G[i][a], At[a][l]) for a in range(nq)])
           for l in range(nq)] for i in range(nq)]
    IGA = [[(1.0 if i == l else 0.0) - GA[i][l] for l in range(nq)]
           for i in range(nq)]
    b1 = [[_sreduce([IGA[i][a] * Lh_f[a][l] for a in range(nq)])
           for l in range(nq)] for i in range(nq)]
    GQ = [[sq_s2 * _sreduce([_smul(G[i][a], QLt[a][l]) for a in range(nq)])
           for l in range(nq)] for i in range(nq)]
    return dict(ps_=ps_, mh_f=mh_f, G=G, mp=mp, b1=b1, GQ=GQ)


def conditioned_mean(sh: dict, x, nq: int, d: int):
    """``mh_f + G (x ps_ - mp)``: the conditioned mean in the preconditioned
    frame, for the carried ``x`` (smoothed means, or samples)."""
    ps_, G, mp = sh["ps_"], sh["G"], sh["mp"]
    dm = [[x[i][j] * ps_[i] - mp[i][j] for j in range(d)] for i in range(nq)]
    return [[sh["mh_f"][i][j]
             + _sreduce([G[i][l] * dm[l][j] for l in range(nq)])
             for j in range(d)] for i in range(nq)]


def smoother_step(m_f, L_f, ms, Ls, lh, s2, *, At, QLt, nq: int, d: int):
    """One square-root RTS step from the filtered state ``(m_f, L_f)`` of
    an accepted step to the smoothed ``(ms, Ls)`` of the next one, with the
    next step's ``lh`` (log dt_eff) and ``s2``, in the frame preconditioned
    at the next step's size, where the filtered factor is ``ps L_f`` (rows
    scaled). Returns the unpreconditioned ``(ms, Ls)``."""
    q_half = nq - 1 + 0.5
    sh = backward_shared(m_f, L_f, lh, s2, At=At, QLt=QLt, nq=nq, d=d)
    ps_, G = sh["ps_"], sh["G"]
    pinv_ = [torch.exp((q_half - i) * lh) for i in range(nq)]
    ms_new = conditioned_mean(sh, ms, nq, d)
    Lsh = [[ps_[i] * Ls[i][l] for l in range(nq)] for i in range(nq)]
    b3 = [[_sreduce([G[i][a] * Lsh[a][l] for a in range(nq)])
           for l in range(nq)] for i in range(nq)]
    Ls_new = list_mgs_tril(t_rows(sh["b1"], nq) + t_rows(sh["GQ"], nq)
                           + t_rows(b3, nq), 3 * nq, nq)
    return ([[pinv_[i] * ms_new[i][j] for j in range(d)] for i in range(nq)],
            [[pinv_[i] * Ls_new[i][l] for l in range(nq)] for i in range(nq)])


def _unpack(row, nq: int, d: int):
    """``(m, L, lh, s2, save index)`` of a stream row."""
    m = [[row[i * d + j] for j in range(d)] for i in range(nq)]
    o = nq * d
    L = [[row[o + i * nq + l] for l in range(nq)] for i in range(nq)]
    o += nq * nq
    return m, L, row[o], row[o + 1], row[o + 2]


def _std(L):
    """The std of block 0: the norm of the factor's row 0."""
    return torch.sqrt(_sreduce([x * x for x in L[0]]))


def where(mask, a, b):
    """``torch.where`` over two nested lists of the same structure."""
    if isinstance(a, (list, tuple)):
        return [where(mask, x, y) for x, y in zip(a, b)]
    return torch.where(mask, a, b)


def walk_back(st: torch.Tensor, counts: torch.Tensor, outs, carry, *,
              unpack: Callable, start: Callable, step: Callable,
              value: Callable) -> None:
    """Each member's backward pass over its accepted rows ``nacc - 1 ..
    0`` of the stream ``st`` (the smoothers' and the sampler's), masked per
    member: the carry at a member's last accepted row k is ``start(k,
    row)``, one accepted step back ``step(k, row, carry, lh, s2)`` with the
    next step's ``lh`` (log dt_eff) and ``s2``; ``unpack(st[k])`` ends
    with ``(lh, s2, save index)``. ``value(carry)`` (a tuple of ``(...,
    B)`` tensors) is written into ``outs`` (``(S+1, ..., B)`` each; row 0
    is the caller's) at each row that reached a save point, and at the
    save points past those reached, the last accepted step's (``carry``'s
    when a member has none)."""
    nacc, segs = counts[0].long(), counts[3].long()
    final = value(carry)
    pend_lh = pend_s2 = None      # set at each member's last row first
    for k in range(int(nacc.max()) - 1, -1, -1):
        row = unpack(st[k])
        lh, s2, mark = row[-3:]
        last, inner = nacc - 1 == k, k < nacc - 1
        if bool(inner.any()):
            carry = where(inner, step(k, row, carry, pend_lh, pend_s2), carry)
        if bool(last.any()):
            carry = where(last, start(k, row), carry)
            final = where(last, value(carry), final)
        took = last | inner
        pend_lh = lh if pend_lh is None else torch.where(took, lh, pend_lh)
        pend_s2 = s2 if pend_s2 is None else torch.where(took, s2, pend_s2)
        idx = torch.nonzero(took & (mark > 0.5)).flatten()
        if idx.numel():
            r = mark[idx].long()
            for out, v in zip(outs, value(carry)):
                out[r, ..., idx] = v[..., idx].movedim(-1, 0)
    for out, v in zip(outs, final):
        _fill_tail(out, segs, v)


def ek0_adaptive_smoother_plain(st: torch.Tensor, counts: torch.Tensor,
                                m0: torch.Tensor, c: Controller):
    """The backward pass over each member's accepted steps: the smoothed
    means of block 0 ``(S+1, d, B)`` and stds ``(S+1, B)`` on the save
    grid, from the stream ``st`` and ``counts`` of
    `ek0_adaptive_stream_plain` and the initial means ``m0``. Row 0 is the
    exact initial state with std 0 (smoothing a point mass leaves it)."""
    nq, d, B = m0.shape
    S = c.n_save
    kw = dict(At=_lists(c.At), QLt=_lists(c.QLt), nq=nq, d=d)
    us = torch.empty((S + 1, d, B), dtype=m0.dtype, device=m0.device)
    stds = torch.empty((S + 1, B), dtype=m0.dtype, device=m0.device)
    us[0] = m0[0]
    stds[0] = 0.0
    zero = torch.zeros_like(m0[0, 0])
    carry = ([[m0[i, j] for j in range(d)] for i in range(nq)],
             [[zero] * nq for _ in range(nq)])
    walk_back(
        st, counts, (us, stds), carry,
        unpack=lambda row: _unpack(row, nq, d),
        start=lambda k, row: row[:2],
        step=lambda k, row, carry, lh, s2: smoother_step(
            row[0], row[1], *carry, lh, s2, **kw),
        value=lambda carry: (torch.stack(carry[0][0]), _std(carry[1])))
    return us, stds


# --------------------------------------------------------------- wrappers


def _check(name: str, field, m0, ps, dt0s):
    nq, d, B = m0.shape
    _launch.check_field(name, field, nq, d, B, ps)
    if tuple(dt0s.shape) != (B,):
        raise ValueError(f"{name}: dt0s must be ({B},), got {tuple(dt0s.shape)}")
    _launch.check_cuda_inputs(name, {"m0": m0, "ps": ps, "dt0s": dt0s},
                              m0.dtype)


def _new_counts(B, device):
    return torch.empty((N_COUNTS, B), dtype=torch.int32, device=device)


def ek0_adaptive(f: Callable, field: Optional[str], m0: torch.Tensor,
                 ps: torch.Tensor, dt0s: torch.Tensor, c: Controller):
    """The adaptive filter: `ek0_adaptive_plain` on CPU tensors, the CUDA
    kernel ``ek0_adaptive_kernel`` on CUDA tensors (vector field
    ``field``)."""
    if _launch.dispatch_device("ek0_adaptive", m0) == "cpu":
        return ek0_adaptive_plain(f, m0, ps, dt0s, c)
    _check("ek0_adaptive", field, m0, ps, dt0s)
    nq, d, B = m0.shape
    new = dict(dtype=m0.dtype, device=m0.device)
    us = torch.empty((c.n_save + 1, d, B), **new)
    stds = torch.empty((c.n_save + 1, B), **new)
    lls = torch.empty((B,), **new)
    counts = _new_counts(B, m0.device)
    _launch.launch(ek0_adaptive, m0.device,
                   f"ek0_adaptive_q{nq - 1}_{field}_{_launch.suffix(m0.dtype)}",
                   m0.data_ptr(), ps.data_ptr(), dt0s.data_ptr(),
                   us.data_ptr(), stds.data_ptr(), lls.data_ptr(),
                   counts.data_ptr(), B, c.n_save, c.max_iters, c.host())
    ek0_adaptive.launches_by_order[nq - 1] += 1
    return us, stds, lls, counts


ek0_adaptive.launches = 0
# its launches by order q (the kernel is built for several)
ek0_adaptive.launches_by_order = dict.fromkeys(
    _launch.kernel_orders("ek0_adaptive"), 0)


def ek0_adaptive_stream(f: Callable, field: Optional[str], m0: torch.Tensor,
                        ps: torch.Tensor, dt0s: torch.Tensor, c: Controller):
    """The streaming forward: `ek0_adaptive_stream_plain` on CPU tensors,
    the CUDA kernel ``ek0_adaptive_stream_kernel`` on CUDA tensors."""
    if _launch.dispatch_device("ek0_adaptive_stream", m0) == "cpu":
        return ek0_adaptive_stream_plain(f, m0, ps, dt0s, c)
    _check("ek0_adaptive_stream", field, m0, ps, dt0s)
    nq, d, B = m0.shape
    st = torch.empty((c.max_iters, stream_width(nq, d), B), dtype=m0.dtype,
                     device=m0.device)
    lls = torch.empty((B,), dtype=m0.dtype, device=m0.device)
    counts = _new_counts(B, m0.device)
    _launch.launch(ek0_adaptive_stream, m0.device,
                   f"ek0_adaptive_stream_{field}_{_launch.suffix(m0.dtype)}",
                   m0.data_ptr(), ps.data_ptr(), dt0s.data_ptr(),
                   st.data_ptr(), lls.data_ptr(), counts.data_ptr(), B,
                   c.n_save, c.max_iters, c.host())
    return st, lls, counts


ek0_adaptive_stream.launches = 0


def check_smoother_inputs(name: str, st, counts, m0, c: Controller,
                          width: int) -> None:
    """Raise unless a smoother kernel takes these inputs: order 3, d = 2, a
    ``(max_iters, width, B)`` stream, ``(N_COUNTS, B)`` int32 counts, all
    contiguous on one device."""
    nq, d, B = m0.shape
    _launch.check_order(name, nq)
    if (d != 2 or tuple(st.shape) != (c.max_iters, width, B)
            or tuple(counts.shape) != (N_COUNTS, B)
            or counts.dtype != torch.int32):
        raise ValueError(
            f"{name}: the kernel takes d = 2, a ({c.max_iters}, {width}, B) "
            f"stream and ({N_COUNTS}, B) "
            f"int32 counts; got nq={nq}, d={d}, {tuple(st.shape)}, "
            f"{tuple(counts.shape)} {counts.dtype}"
        )
    _launch.check_cuda_inputs(name, {"st": st, "m0": m0}, st.dtype)
    if not counts.is_contiguous() or counts.device != st.device:
        raise ValueError(f"{name}: counts must be contiguous and on the "
                         "stream's device")


def ek0_adaptive_smoother(st: torch.Tensor, counts: torch.Tensor,
                          m0: torch.Tensor, c: Controller):
    """The backward pass: `ek0_adaptive_smoother_plain` on CPU tensors, the
    CUDA kernel ``ek0_adaptive_smoother_kernel`` on CUDA tensors."""
    if _launch.dispatch_device("ek0_adaptive_smoother", st) == "cpu":
        return ek0_adaptive_smoother_plain(st, counts, m0, c)
    nq, d, B = m0.shape
    check_smoother_inputs("ek0_adaptive_smoother", st, counts, m0, c,
                          stream_width(nq, d))
    us = torch.empty((c.n_save + 1, d, B), dtype=st.dtype, device=st.device)
    stds = torch.empty((c.n_save + 1, B), dtype=st.dtype, device=st.device)
    _launch.launch(ek0_adaptive_smoother, st.device,
                   f"ek0_adaptive_smoother_{_launch.suffix(st.dtype)}",
                   st.data_ptr(), counts.data_ptr(), m0.data_ptr(),
                   us.data_ptr(), stds.data_ptr(), B, c.n_save, c.max_iters,
                   c.host())
    return us, stds


ek0_adaptive_smoother.launches = 0


# ----------------------------------------------------------- entry points


def _solution(counts, *outs):
    return (*outs, counts[0], counts[1], counts[2].bool())


def ek0_adaptive_filter(
    f: Callable,
    m0: torch.Tensor,
    ps: torch.Tensor,
    dt0s: torch.Tensor,
    t0: float,
    t1: float,
    n_save: int,
    q: int,
    abstol: float = 1e-6,
    reltol: float = 1e-3,
    max_iters: int = 100_000,
    dtmin: Optional[float] = None,
    prior=None,
    mesh=None,
    second_order: bool = False,
    *,
    field: Optional[str] = None,
):
    """Adaptive per-member EK0(dynamic) ensemble filter on the kernel
    ``ek0_adaptive``: each member runs its own PI-controlled step loop and
    lands exactly on each point of the uniform grid of ``n_save``
    intervals over ``[t0, t1]``; any B >= 1.

    ``m0``: ``(q+1, d, B)`` unpreconditioned Taylor initial means; ``ps``:
    ``(n_params, B)``; ``dt0s``: ``(B,)`` initial steps (`initial_dt`).
    ``max_iters`` bounds each member's attempts (``nacc + nrej``; the JAX
    kernel counts a block's loop iterations). Returns ``(us, stds, lls,
    nacc, nrej, failed)``: ``(S+1, d, B)``, ``(S+1, B)``, ``(B,)``, then
    ``(B,)`` int32 counts and a ``(B,)`` bool; a failed member's remaining
    save rows hold its last committed state.
    """
    _launch.check_ported(prior=prior, second_order=second_order, mesh=mesh)
    c = controller(q, t0, t1, n_save, m0.dtype, abstol=abstol, reltol=reltol,
                   max_iters=max_iters, dtmin=dtmin)
    us, stds, lls, counts = ek0_adaptive(f, field, m0, ps, dt0s.contiguous(), c)
    return _solution(counts, us, stds, lls)


def ek0_adaptive_fused_smooth(
    f: Callable,
    m0: torch.Tensor,
    ps: torch.Tensor,
    dt0s: torch.Tensor,
    t0: float,
    t1: float,
    n_save: int,
    q: int,
    abstol: float = 1e-6,
    reltol: float = 1e-3,
    max_iters: int = 1024,
    dtmin: Optional[float] = None,
    prior=None,
    mesh=None,
    second_order: bool = False,
    *,
    field: Optional[str] = None,
):
    """Adaptive per-member EK0(dynamic) filter + square-root RTS smoother
    (the reference's default solve, adaptive and smoothed) on the kernels
    ``ek0_adaptive_stream`` and ``ek0_adaptive_smoother``. Arguments as in
    `ek0_adaptive_filter`; ``max_iters`` also sizes the stream
    (``max_iters`` rows of `stream_width` per member). Returns the
    smoothed ``(us, stds)`` on the save grid with the filter's ``lls``,
    ``nacc``, ``nrej`` and ``failed``.
    """
    _launch.check_ported(prior=prior, second_order=second_order, mesh=mesh)
    c = controller(q, t0, t1, n_save, m0.dtype, abstol=abstol, reltol=reltol,
                   max_iters=max_iters, dtmin=dtmin)
    st, lls, counts = ek0_adaptive_stream(f, field, m0, ps, dt0s.contiguous(), c)
    us, stds = ek0_adaptive_smoother(st, counts, m0, c)
    return _solution(counts, us, stds, lls)


def _init(prob_f, u0s, ps, tspan, q, abstol, reltol):
    """Taylor init and the Hairer initial steps: ``(m0 (q+1, d, B),
    ps (n_params, B), dt0s (B,))``."""
    from odefilters_torch.solve import initial_dt
    from odefilters_torch.taylor import taylor_coefficients

    # contiguous copies: forward-mode AD refuses inputs whose elements
    # alias one another, as in an expanded (broadcast) ensemble
    u0_t, ps_t = u0s.T.contiguous(), ps.T.contiguous()
    m0 = torch.stack(taylor_coefficients(prob_f, u0_t, ps_t, tspan[0], q))
    return m0, ps_t, initial_dt(prob_f, u0_t, ps_t, tspan, q, abstol, reltol)


def solve_ensemble_ek0_adaptive(
    prob_f: Callable, u0s: torch.Tensor, ps: torch.Tensor, tspan,
    n_save: int, q: int = 3, abstol: float = 1e-6, reltol: float = 1e-3,
    max_iters: int = 100_000, prior=None, mesh=None,
    second_order: bool = False, *, field: Optional[str] = None,
):
    """Taylor init + `initial_dt` + the adaptive filter over an ensemble:
    ``u0s`` ``(B, d)``, ``ps`` ``(B, n_params)``. Returns what
    `ek0_adaptive_filter` returns."""
    m0, ps_t, dt0s = _init(prob_f, u0s, ps, tspan, q, abstol, reltol)
    return ek0_adaptive_filter(prob_f, m0, ps_t, dt0s, tspan[0], tspan[1],
                               n_save, q, abstol=abstol, reltol=reltol,
                               max_iters=max_iters, prior=prior, mesh=mesh,
                               second_order=second_order, field=field)


def solve_ensemble_ek0_adaptive_smooth(
    prob_f: Callable, u0s: torch.Tensor, ps: torch.Tensor, tspan,
    n_save: int, q: int = 3, abstol: float = 1e-6, reltol: float = 1e-3,
    max_iters: int = 1024, prior=None, mesh=None,
    second_order: bool = False, *, field: Optional[str] = None,
):
    """Taylor init + `initial_dt` + the adaptive filter and smoother over
    an ensemble; returns what `ek0_adaptive_fused_smooth` returns."""
    m0, ps_t, dt0s = _init(prob_f, u0s, ps, tspan, q, abstol, reltol)
    return ek0_adaptive_fused_smooth(prob_f, m0, ps_t, dt0s, tspan[0],
                                     tspan[1], n_save, q, abstol=abstol,
                                     reltol=reltol, max_iters=max_iters,
                                     prior=prior, mesh=mesh,
                                     second_order=second_order, field=field)
