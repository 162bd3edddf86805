"""Differentiable fused EK0 filter: per-member log-likelihood and its exact
gradient. Plain PyTorch versions and the wrappers of the three CUDA kernels
that replace the JAX package's Pallas filter and its custom VJP.

=====================================  ======================================
this module                            ``odefilters/ops/pallas_kernels.py``
=====================================  ======================================
``pair_constants`` (``ek0_pair``)      ``_ek0_consts`` (IBM prior)
``static_local_update``                ``_static_local_update``
``ek0_step_filter``                    ``_ek0_step_lists(collapsed=True,
                                       want_outputs=True)``
``ek0_step_filter_triu``               the same on the stream's covariance
                                       triangle (the target of the
                                       in-kernel ``jax.vjp``)
``ek0_filter_plain`` /                 ``_ek0_kernel`` via
``ek0_filter``                         ``_ek0_filter_blocked`` and
                                       ``_ek0_filter_blocked_static`` (CUDA:
                                       ``csrc/ek0_filter.cu::
                                       ek0_filter_kernel``)
``ek0_filter_fwd_stream_plain`` /      ``_ek0_grad_fwd_kernel`` via
``ek0_filter_grad_fwd``                ``_ek0_filter_blocked_fwd`` (CUDA:
                                       ``ek0_filter_grad_fwd_kernel``)
``ek0_filter_grad_bwd_plain`` /        ``_ek0_grad_bwd_kernel`` via
``ek0_filter_grad_bwd``                ``_ek0_filter_blocked_bwd`` (CUDA:
                                       ``ek0_filter_grad_bwd_kernel``)
``EK0FusedFilter``                     the ``jax.custom_vjp`` of
                                       ``_ek0_filter_blocked``
``ek0_fused_filter``                   ``ek0_fused_filter``
``solve_ensemble_ek0``                 ``solve_ensemble_ek0_pallas``
=====================================  ======================================

Every step body works on lists of per-member ``(B,)`` tensors in the JAX
bodies' order of operations, and shares the pair's collapsed step
(`ek0_pair.ek0_step_core`).

The gradient's forward streams the pair's packed rows ``(T+1, V, B)``
(`ek0_pair.pair_layout`: mean, active covariance triangle, s2; V = 15 at
q = 3) rather than the JAX kernel's full ``(nq, d+nq)`` carry: the
measured row and column of a committed covariance are exact zeros, and the
backward rebuilds them as such. The backward walks the stream in reverse
and applies the exact adjoint of each step, through the vector field and
the ``1/s2`` calibration: its plain version by ``torch.func.vjp`` of
`ek0_step_filter`, the CUDA kernel by a hand-written adjoint.

Dispatch: each wrapper runs its plain version on CPU tensors, launches its
CUDA kernel on CUDA tensors, raises on any other device, and counts its
launches in ``.launches``. `EK0FusedFilter` launches the primal kernel
when no input needs a gradient and the two gradient kernels otherwise.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from odefilters_torch.ops import _launch
from odefilters_torch.ops import ek0_pair as ep

_LOG_2PI = math.log(2.0 * math.pi)
STATIC_DIFFUSIONS = ("fixed", "fixedMAP", "fixedMV")
# static diffusion -> the C entry points' mode argument (0 is dynamic)
_MODES = {None: 0, "fixed": 1, "fixedMAP": 2, "fixedMV": 3}


def static_local_update(static_diff: str, calib, zz, z, inv_s, d: int):
    """Running update of a static diffusion's per-member estimate from one
    step's innovation statistic ``z^T S^-1 z`` (S = s I_d).

    ``calib = (sig, k)``: the running estimate (a ``(B,)`` tensor, or a
    list of d for ``fixedMV``) and the count of previous steps as a float
    tensor. Returns the updated ``(sig, k + 1)``."""
    sig, kf = calib

    def fixed_run(prev, local):
        cand = prev + (local - prev) / torch.clamp(kf, min=1.0)
        return torch.where(kf == 0.0, local, cand)

    if static_diff == "fixedMV":
        sig_new = [fixed_run(sig[j], z[j] * z[j] * inv_s) for j in range(d)]
    elif static_diff == "fixed":
        sig_new = fixed_run(sig, zz * inv_s / d)
    elif static_diff == "fixedMAP":
        # InverseGamma(1/2, 1/2) MAP, updated online
        local = zz * inv_s / d
        alpha, beta = 0.5, 0.5
        N = kf + 1.0
        first = (beta + 0.5 * local) / (alpha + N * d / 2 + 1)
        res_prev = (sig * (alpha + (N - 1.0) * d / 2 + 1) - beta) * 2.0
        later = (beta + 0.5 * (res_prev + local)) / (alpha + N * d / 2 + 1)
        sig_new = torch.where(kf == 0.0, first, later)
    else:
        raise ValueError(f"unknown static diffusion {static_diff!r}")
    return sig_new, kf + 1.0


def _filter_step(m, C, p, t_new, *, f, At, Qt, pinv0, pinv1, d, nq,
                 static_diff=None, calib=None, want_var=False):
    """`ek0_step_filter` that also returns the step's diffusion ``s2``:
    ``(m_new, C_new, s2, ll_inc, us_row, std_val, calib_new)``."""
    m_new, C_new, s2, zz, z, s, inv_s = ep.ek0_step_core(
        m, C, p, t_new, f=f, At=At, Qt=Qt, pinv0=pinv0, pinv1=pinv1, d=d,
        nq=nq, static=static_diff is not None,
    )
    # per-member data log-likelihood log N(z; 0, s I_d)
    ll_inc = -0.5 * (zz * inv_s
                     + d * (torch.log(torch.clamp(s, min=1e-30)) + _LOG_2PI))
    us_row = [pinv0 * m_new[0][j] for j in range(d)]
    if want_var:
        std_val = C_new[0][0]       # raw variance; the caller takes the sqrt
    else:
        # the 1e-30 floor keeps the sqrt's VJP finite where C_new[0][0] = 0
        std_val = pinv0 * torch.sqrt(torch.clamp(C_new[0][0], min=1e-30))
    calib_new = None
    if static_diff is not None:
        calib_new = static_local_update(static_diff, calib, zz, z, inv_s, d)
    return m_new, C_new, s2, ll_inc, us_row, std_val, calib_new


def ek0_step_filter(m, C, p, t_new, *, f: Callable, At, Qt, pinv0: float,
                    pinv1: float, d: int, nq: int, static_diff=None,
                    calib=None, want_var: bool = False):
    """One EK0 filter step with its outputs: ``(m_new, C_new, ll_inc,
    us_row, std_val)``, plus the updated ``calib`` carry under a static
    diffusion (the step then filters with the unscaled prior, s2 = 1).

    ``std_val`` is ``pinv0 sqrt(max(C_new[0][0], 1e-30))``, or the raw
    variance ``C_new[0][0]`` with ``want_var``."""
    m_new, C_new, _, ll_inc, us_row, std_val, calib_new = _filter_step(
        m, C, p, t_new, f=f, At=At, Qt=Qt, pinv0=pinv0, pinv1=pinv1, d=d,
        nq=nq, static_diff=static_diff, calib=calib, want_var=want_var,
    )
    if static_diff is not None:
        return m_new, C_new, ll_inc, us_row, std_val, calib_new
    return m_new, C_new, ll_inc, us_row, std_val


def _init_state(m0_p):
    nq, d, _ = m0_p.shape
    m = [[m0_p[i, j] for j in range(d)] for i in range(nq)]
    zero = torch.zeros_like(m[0][0])
    return m, [[zero] * nq for _ in range(nq)], zero


def ek0_filter_plain(
    f: Callable, m0_p: torch.Tensor, ps: torch.Tensor, *, At, Qt,
    pinv0: float, pinv1: float, t0: float, dt: float, n_steps: int,
    static_diff: Optional[str] = None,
):
    """The primal filter over ``n_steps`` steps from the preconditioned
    initial means ``m0_p`` ``(nq, d, B)`` and parameters ``ps``
    ``(n_params, B)``.

    Returns ``(us (T+1, d, B), var (T+1, B), lls (B,))``: filter means of
    the solution, the raw variances ``C[0][0]`` (0 at t0) and the summed
    log-likelihoods; under a static diffusion also ``sig``, the running
    estimate after the last step, ``(B,)`` or ``(d, B)`` for fixedMV."""
    nq, d, B = m0_p.shape
    T = int(n_steps)
    At, Qt = ep._lists(At), ep._lists(Qt)
    us = torch.empty((T + 1, d, B), dtype=m0_p.dtype, device=m0_p.device)
    var = torch.empty((T + 1, B), dtype=m0_p.dtype, device=m0_p.device)
    m, C, zero = _init_state(m0_p)
    us[0] = pinv0 * m0_p[0]
    var[0] = zero
    ll = zero
    calib = ([zero] * d if static_diff == "fixedMV" else zero, zero)
    ts = ep.step_times(t0, dt, T, m0_p.dtype, m0_p.device)
    for k in range(T):
        m, C, _, ll_inc, us_row, var_k, cal = _filter_step(
            m, C, ps, ts[k], f=f, At=At, Qt=Qt, pinv0=pinv0, pinv1=pinv1,
            d=d, nq=nq, static_diff=static_diff, calib=calib, want_var=True,
        )
        torch.stack(us_row, out=us[k + 1])
        var[k + 1] = var_k
        ll = ll + ll_inc
        if static_diff is not None:
            calib = cal
    if static_diff is None:
        return us, var, ll
    sig = calib[0]
    return us, var, ll, torch.stack(sig) if static_diff == "fixedMV" else sig


def ek0_filter_fwd_stream_plain(
    f: Callable, m0_p: torch.Tensor, ps: torch.Tensor, *, At, Qt,
    pinv0: float, pinv1: float, t0: float, dt: float, n_steps: int,
):
    """The gradient's forward: the dynamic filter with the std computed per
    step (``pinv0 sqrt(max(C00, 1e-30))``, exactly 0 at t0), streaming the
    state. Returns ``(us, stds, lls, st)`` with ``st`` ``(T+1, V, B)``
    packed rows (`ek0_pair.pair_layout`); row k holds the state before
    step k and the diffusion of step k-1 (row 0: s2 = 1)."""
    nq, d, B = m0_p.shape
    T = int(n_steps)
    triu, V = ep.pair_layout(nq, d, 1)
    At, Qt = ep._lists(At), ep._lists(Qt)
    dtype, device = m0_p.dtype, m0_p.device
    us = torch.empty((T + 1, d, B), dtype=dtype, device=device)
    stds = torch.empty((T + 1, B), dtype=dtype, device=device)
    st = torch.empty((T + 1, V, B), dtype=dtype, device=device)
    m, C, zero = _init_state(m0_p)
    us[0] = pinv0 * m0_p[0]
    stds[0] = zero
    ep.pack_row(st[0], m, C, zero + 1.0, triu)
    ll = zero
    ts = ep.step_times(t0, dt, T, dtype, device)
    for k in range(T):
        m, C, s2, ll_inc, us_row, std_k, _ = _filter_step(
            m, C, ps, ts[k], f=f, At=At, Qt=Qt, pinv0=pinv0, pinv1=pinv1,
            d=d, nq=nq,
        )
        torch.stack(us_row, out=us[k + 1])
        stds[k + 1] = std_k
        ep.pack_row(st[k + 1], m, C, s2, triu)
        ll = ll + ll_inc
    return us, stds, ll, st


def ek0_step_filter_triu(m, C_triu, p, t_new, *, f: Callable, At, Qt,
                         pinv0: float, pinv1: float, d: int, nq: int):
    """`ek0_step_filter` (dynamic diffusion) on the stream's covariance
    representation: ``C_triu`` and the returned ``C_new_triu`` list the
    active upper triangle (`ek0_pair.pair_layout`), each entry the one value
    that ``C[i][l]`` and ``C[l][i]`` share, so a cotangent of it is the sum
    of both. Returns ``(m_new, C_new_triu, ll_inc, us_row, std_val)``."""
    triu, _ = ep.pair_layout(nq, d, 1)
    C = [[0.0] * nq for _ in range(nq)]
    for (i, l), c in zip(triu, C_triu):
        C[i][l] = c
        C[l][i] = c
    m_new, C_new, ll_inc, us_row, std_val = ek0_step_filter(
        m, C, p, t_new, f=f, At=At, Qt=Qt, pinv0=pinv0, pinv1=pinv1, d=d,
        nq=nq,
    )
    return m_new, [C_new[i][l] for (i, l) in triu], ll_inc, us_row, std_val


def ek0_filter_grad_bwd_plain(
    f: Callable, st: torch.Tensor, ps: torch.Tensor, dus: torch.Tensor,
    dstds: torch.Tensor, dlls: torch.Tensor, *, nq: int, At, Qt,
    pinv0: float, pinv1: float, t0: float, dt: float,
):
    """The adjoint sweep: walks the stream ``st`` from step T-1 down to 0
    and applies ``torch.func.vjp`` of `ek0_step_filter_triu` at each step,
    with the cotangents ``dus[k+1]``, ``dstds[k+1]`` and ``dlls`` (the
    summed log-likelihood's, the same at every step). ``dstds[0]`` is
    dropped (std at t0 is the constant 0) and ``dus[0]`` adds
    ``pinv0 dus[0]`` to the cotangent of ``m0_p[0]``. Returns
    ``(dm0_p (nq, d, B), dps)``."""
    T = st.shape[0] - 1
    d = dus.shape[1]
    triu, _ = ep.pair_layout(nq, d, 1)
    kw = dict(f=f, At=ep._lists(At), Qt=ep._lists(Qt), pinv0=pinv0,
              pinv1=pinv1, d=d, nq=nq)
    ts = ep.step_times(t0, dt, T, st.dtype, st.device)
    zero = torch.zeros_like(dlls)
    dm = [[zero] * d for _ in range(nq)]
    dC = [zero] * len(triu)         # cotangents of the active triangle
    dp = torch.zeros_like(ps)
    for k in range(T - 1, -1, -1):
        m_k = [[st[k, i * d + j] for j in range(d)] for i in range(nq)]
        C_k = [st[k, nq * d + idx] for idx in range(len(triu))]
        _, vjp_fn = torch.func.vjp(
            lambda m, C, p, t=ts[k]: ek0_step_filter_triu(m, C, p, t, **kw),
            m_k, C_k, ps,
        )
        dm, dC, dp_k = vjp_fn(
            (dm, dC, dlls, [dus[k + 1, j] for j in range(d)], dstds[k + 1])
        )
        dp = dp + dp_k
    dm[0] = [dm[0][j] + pinv0 * dus[0, j] for j in range(d)]
    return torch.stack([torch.stack(row) for row in dm]), dp


def _check_filter_inputs(name, field, m0_p, ps):
    nq, d, B = m0_p.shape
    _launch.check_field(name, field, nq, d, B, ps)
    _launch.check_cuda_inputs(name, {"m0_p": m0_p, "ps": ps}, m0_p.dtype)


def ek0_filter(
    f: Callable, field: Optional[str], m0_p: torch.Tensor, ps: torch.Tensor,
    *, At, Qt, pinv0: float, pinv1: float, t0: float, dt: float,
    n_steps: int, static_diff: Optional[str] = None,
):
    """The primal filter: `ek0_filter_plain` on CPU tensors, the CUDA kernel
    ``ek0_filter_kernel`` on CUDA tensors (vector field ``field``)."""
    kw = dict(At=At, Qt=Qt, pinv0=pinv0, pinv1=pinv1, t0=t0, dt=dt,
              n_steps=n_steps)
    if _launch.dispatch_device("ek0_filter", m0_p) == "cpu":
        return ek0_filter_plain(f, m0_p, ps, static_diff=static_diff, **kw)
    _check_filter_inputs("ek0_filter", field, m0_p, ps)
    nq, d, B = m0_p.shape
    T = int(n_steps)
    new = dict(dtype=m0_p.dtype, device=m0_p.device)
    us = torch.empty((T + 1, d, B), **new)
    var = torch.empty((T + 1, B), **new)
    lls = torch.empty((B,), **new)
    sig = None
    if static_diff is not None:
        sig = torch.empty((d, B) if static_diff == "fixedMV" else (B,), **new)
    _launch.launch(ek0_filter, m0_p.device,
                   f"ek0_filter_{field}_{_launch.suffix(m0_p.dtype)}",
                   m0_p.data_ptr(), ps.data_ptr(), us.data_ptr(), var.data_ptr(),
                   lls.data_ptr(), None if sig is None else sig.data_ptr(), B, T,
                   _MODES[static_diff],
                   _launch.host_consts(At, Qt, scalars=(pinv0, pinv1, t0, dt)))
    if static_diff is None:
        return us, var, lls
    return us, var, lls, sig


ek0_filter.launches = 0


def ek0_filter_grad_fwd(
    f: Callable, field: Optional[str], m0_p: torch.Tensor, ps: torch.Tensor,
    *, At, Qt, pinv0: float, pinv1: float, t0: float, dt: float,
    n_steps: int,
):
    """The gradient's forward: `ek0_filter_fwd_stream_plain` on CPU
    tensors, the CUDA kernel ``ek0_filter_grad_fwd_kernel`` on CUDA
    tensors. Returns ``(us, stds, lls, st)``."""
    kw = dict(At=At, Qt=Qt, pinv0=pinv0, pinv1=pinv1, t0=t0, dt=dt,
              n_steps=n_steps)
    if _launch.dispatch_device("ek0_filter_grad_fwd", m0_p) == "cpu":
        return ek0_filter_fwd_stream_plain(f, m0_p, ps, **kw)
    _check_filter_inputs("ek0_filter_grad_fwd", field, m0_p, ps)
    nq, d, B = m0_p.shape
    T = int(n_steps)
    _, V = ep.pair_layout(nq, d, 1)
    new = dict(dtype=m0_p.dtype, device=m0_p.device)
    us = torch.empty((T + 1, d, B), **new)
    stds = torch.empty((T + 1, B), **new)
    lls = torch.empty((B,), **new)
    st = torch.empty((T + 1, V, B), **new)
    _launch.launch(ek0_filter_grad_fwd, m0_p.device,
                   f"ek0_filter_grad_fwd_{field}_{_launch.suffix(m0_p.dtype)}",
                   m0_p.data_ptr(), ps.data_ptr(), us.data_ptr(), stds.data_ptr(),
                   lls.data_ptr(), st.data_ptr(), B, T,
                   _launch.host_consts(At, Qt, scalars=(pinv0, pinv1, t0, dt)))
    return us, stds, lls, st


ek0_filter_grad_fwd.launches = 0


def ek0_filter_grad_bwd(
    f: Callable, field: Optional[str], st: torch.Tensor, ps: torch.Tensor,
    dus: torch.Tensor, dstds: torch.Tensor, dlls: torch.Tensor, *, nq: int,
    At, Qt, pinv0: float, pinv1: float, t0: float, dt: float,
):
    """The adjoint sweep: `ek0_filter_grad_bwd_plain` on CPU tensors, the
    CUDA kernel ``ek0_filter_grad_bwd_kernel`` (hand-written adjoint) on
    CUDA tensors. Returns ``(dm0_p, dps)``."""
    kw = dict(nq=nq, At=At, Qt=Qt, pinv0=pinv0, pinv1=pinv1, t0=t0, dt=dt)
    if _launch.dispatch_device("ek0_filter_grad_bwd", st) == "cpu":
        return ek0_filter_grad_bwd_plain(f, st, ps, dus, dstds, dlls, **kw)
    T1, V, B = st.shape
    d = dus.shape[1]
    _launch.check_field("ek0_filter_grad_bwd", field, nq, d, B, ps)
    _, V_want = ep.pair_layout(nq, d, 1)
    if (V != V_want or tuple(dus.shape) != (T1, d, B)
            or tuple(dstds.shape) != (T1, B) or tuple(dlls.shape) != (B,)):
        raise ValueError(
            f"ek0_filter_grad_bwd: takes st (T+1, {V_want}, B), dus "
            f"(T+1, {d}, B), dstds (T+1, B), dlls (B,); got {tuple(st.shape)}, "
            f"{tuple(dus.shape)}, {tuple(dstds.shape)}, {tuple(dlls.shape)}"
        )
    _launch.check_cuda_inputs(
        "ek0_filter_grad_bwd",
        {"st": st, "ps": ps, "dus": dus, "dstds": dstds, "dlls": dlls},
        st.dtype,
    )
    new = dict(dtype=st.dtype, device=st.device)
    dm0 = torch.empty((nq, d, B), **new)
    dps = torch.empty(tuple(ps.shape), **new)
    _launch.launch(ek0_filter_grad_bwd, st.device,
                   f"ek0_filter_grad_bwd_{field}_{_launch.suffix(st.dtype)}",
                   st.data_ptr(), ps.data_ptr(), dus.data_ptr(), dstds.data_ptr(),
                   dlls.data_ptr(), dm0.data_ptr(), dps.data_ptr(), B, T1 - 1,
                   _launch.host_consts(At, Qt, scalars=(pinv0, pinv1, t0, dt)))
    return dm0, dps


ek0_filter_grad_bwd.launches = 0


class EK0FusedFilter(torch.autograd.Function):
    """The dynamic-diffusion filter as an autograd node: ``(m0_p, ps) ->
    (us, stds, lls)``. Without a gradient to compute it runs the primal
    filter (stds from the raw variances, ``pinv0 sqrt(max(var, 1e-30))``);
    with one, the gradient's forward, saving the state stream for the
    adjoint sweep."""

    @staticmethod
    def forward(ctx, m0_p, ps, f, field, consts, n_steps, want_grad):
        kw = dict(consts, n_steps=n_steps)
        if not want_grad:
            us, var, lls = ek0_filter(f, field, m0_p, ps, **kw)
            stds = consts["pinv0"] * torch.sqrt(torch.clamp(var, min=1e-30))
            return us, stds, lls
        us, stds, lls, st = ek0_filter_grad_fwd(f, field, m0_p, ps, **kw)
        ctx.save_for_backward(st, ps)
        ctx.f, ctx.field, ctx.consts = f, field, consts
        ctx.nq = m0_p.shape[0]
        return us, stds, lls

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dus, dstds, dlls):
        # cotangents of unused outputs arrive as zeros (materialized grads)
        st, ps = ctx.saved_tensors
        dm0, dps = ek0_filter_grad_bwd(
            ctx.f, ctx.field, st, ps, dus.contiguous(), dstds.contiguous(),
            dlls.contiguous(), nq=ctx.nq, **ctx.consts,
        )
        return dm0, dps, None, None, None, None, None


def ek0_fused_filter(
    f: Callable,
    m0: torch.Tensor,
    ps: torch.Tensor,
    t0: float,
    dt: float,
    n_steps: int,
    q: int,
    *,
    field: Optional[str] = None,
    second_order: bool = False,
    prior=None,
    mesh=None,
    diffusion: str = "dynamic",
):
    """The fused EK0 filter over an ensemble of B members (any B >= 1).

    ``m0``: ``(q+1, d, B)`` unpreconditioned Taylor initial means; ``ps``:
    ``(n_params, B)``. Returns ``(us, stds, lls)``: filter means of the
    solution ``(T+1, d, B)``, their stds ``(T+1, B)`` and the per-member
    data log-likelihood ``(B,)``.

    Differentiable with respect to ``m0`` and ``ps`` under the dynamic
    diffusion: the backward is the adjoint sweep's kernel.

    ``diffusion``: ``"dynamic"``, or a static model ``"fixed"`` /
    ``"fixedMAP"`` / ``"fixedMV"``, which filters with the unscaled prior
    and returns ``(us, stds, lls, sigma2)``: ``lls`` all NaN, ``sigma2``
    the calibrated per-member diffusion ``(B,)`` (``(d, B)`` for fixedMV,
    whose stds are then ``(T+1, d, B)``), and the stds carry the exit
    rescale ``stds sqrt(sigma2)``. Static models are forward-only.
    """
    static = None if diffusion == "dynamic" else str(diffusion)
    if static is not None and static not in STATIC_DIFFUSIONS:
        raise NotImplementedError(
            f"diffusion={diffusion!r}: the fused fixed-grid filter supports "
            "dynamic / fixed / fixedMAP / fixedMV"
        )
    _launch.check_ported(prior=prior, second_order=second_order, mesh=mesh)
    T = int(n_steps)
    At, Qt, _, p = ep.pair_constants(q, dt)
    consts = dict(At=At, Qt=Qt, pinv0=float(1.0 / p[0]),
                  pinv1=float(1.0 / p[1]), t0=float(t0), dt=float(dt))
    m0_p = torch.as_tensor(p, dtype=m0.dtype, device=m0.device)[:, None, None] * m0
    want_grad = torch.is_grad_enabled() and (m0_p.requires_grad
                                             or ps.requires_grad)
    if static is None:
        return EK0FusedFilter.apply(m0_p, ps, f, field, consts, T, want_grad)
    if want_grad:
        raise NotImplementedError(
            f"diffusion={static!r} is forward-only, as in the JAX package: "
            "the static calibration has no gradient kernel; use the dynamic "
            "diffusion for gradients, or detach the inputs"
        )
    us, var, _, sig = ek0_filter(f, field, m0_p, ps, static_diff=static,
                                 n_steps=T, **consts)
    stds = consts["pinv0"] * torch.sqrt(torch.clamp(var, min=1e-30))
    lls = torch.full((m0.shape[2],), float("nan"), dtype=m0.dtype,
                     device=m0.device)
    if static == "fixedMV":
        stds = stds[:, None, :] * torch.sqrt(sig)[None]
    else:
        stds = stds * torch.sqrt(sig)[None]
    return us, stds, lls, sig


def solve_ensemble_ek0(
    prob_f: Callable,
    u0s: torch.Tensor,
    ps: torch.Tensor,
    tspan,
    n_steps: int,
    q: int = 3,
    *,
    field: Optional[str] = None,
    prior=None,
    mesh=None,
    diffusion: str = "dynamic",
):
    """Taylor init + the fused filter over an ensemble: ``u0s`` ``(B, d)``,
    ``ps`` ``(B, n_params)``. Returns what `ek0_fused_filter` returns;
    gradients reach ``u0s`` through the Taylor init by autograd."""
    from odefilters_torch.taylor import taylor_coefficients

    t0, t1 = tspan
    dt = (t1 - t0) / n_steps
    # contiguous copies: forward-mode AD refuses inputs whose elements
    # alias one another, as in an expanded (broadcast) ensemble
    ps_t = ps.T.contiguous()
    m0 = torch.stack(taylor_coefficients(prob_f, u0s.T.contiguous(), ps_t, t0, q))
    return ek0_fused_filter(prob_f, m0, ps_t, float(t0), float(dt), n_steps, q,
                            field=field, prior=prior, mesh=mesh,
                            diffusion=diffusion)
