"""Fixed-grid fused DiagonalEK1 ensemble filter: the plain PyTorch version and
the wrapper of the CUDA kernel that replace the JAX package's Pallas
``_ek1d_kernel``, with the Jacobian diagonal's sources.

==================================  =========================================
this module                         ``odefilters/ops/pallas_kernels.py`` and
                                    ``odefilters/ensemble.py``
==================================  =========================================
``auto_jac_diag``                   ``_auto_jac_diag``
``diag_from_full``                  ``ensemble._diag_from_full``
``jac_diag_of``                     the front door's choice of the Jacobian
                                    diagonal (``ensemble.py``)
``ek1d_pd_step``                    ``_ek1d_pd_step_lists`` (dynamic and
                                    static, ``stop_calib``; the f32
                                    residual rounded once)
``ek1d_filter_plain`` /             ``_ek1d_kernel`` (CUDA:
``ek1d_filter``                     ``csrc/ek1d.cu::ek1d_filter_kernel``)
``ek1d_fused_filter``               ``ek1d_fused_filter``
``solve_ensemble_ek1d``             ``solve_ensemble_ek1d_pallas``
==================================  =========================================

DiagonalEK1 linearizes the vector field at its Jacobian diagonal ``J_jj``,
so each member runs d independent ``(q+1) x (q+1)`` filters, dimension j
measuring ``h_j = pinv1 e_1 - J_jj pinv0 e_0`` in preconditioned
coordinates, with one dynamic diffusion shared by the dimensions
(``s2 = mean_j z_j^2 / (h_j Qt h_j^T)``). As in the JAX kernel, the
fixed grid carries each dimension's plain preconditioned covariance and
updates it as ``Cp - k k^T s``. Under a static diffusion (fixed, fixedMAP,
fixedMV) the filter runs with the unscaled prior and accumulates the
per-member sigma^2 from the per-dimension innovation variances (exact per
dimension under fixedMV); the stds are rescaled by it at exit and the
log-likelihoods are NaN.

The step body works on lists of per-member ``(B,)`` tensors in the JAX
body's order of operations, with one departure kept by every filter of the
port: the float32 residual ``pinv1 mp[1] - du`` is the exact double
product rounded once (`ek0_pair.innovation`). Dispatch: ``ek1d_filter``
runs its plain version on CPU tensors, launches its CUDA kernel on CUDA
tensors (which evaluates the CUDA field's own Jacobian diagonal,
``fields.cuh``), raises on any other device, and counts its launches in
``.launches``.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from odefilters_torch.ops import _launch
from odefilters_torch.ops import ek0_pair as ep
from odefilters_torch.ops._blocks import _lists, _sreduce
from odefilters_torch.ops.ek0_filter import _LOG_2PI


def auto_jac_diag(f: Callable) -> Callable:
    """The Jacobian diagonal of ``f`` in ``u`` from d forward-mode JVPs:
    the b-th one-hot tangent's b-th output component, ``(d[, B])``."""

    def jd(u, p, t):
        dd = u.shape[0]
        diag = []
        for b in range(dd):
            tangent = torch.stack([torch.ones_like(u[b]) if i == b
                                   else torch.zeros_like(u[b])
                                   for i in range(dd)])
            _, col = torch.func.jvp(lambda uu: f(uu, p, t), (u,), (tangent,))
            diag.append(col[b])
        return torch.stack(diag)

    return jd


def diag_from_full(jac: Callable, d: int) -> Callable:
    """The Jacobian diagonal from a full ``jac`` callable, by explicit
    ``[a, a]`` indexing of its ``(d, d[, B])`` result."""

    def jd(u, p, t):
        J = jac(u, p, t)
        return torch.stack([J[a, a] for a in range(d)])

    return jd


def jac_diag_of(prob) -> Optional[Callable]:
    """The front door's Jacobian diagonal of a first-order problem:
    ``prob.jac_diag``, else the diagonal of ``prob.jac``, else None (the
    plain versions then take d JVPs, `auto_jac_diag`)."""
    jd = getattr(prob, "jac_diag", None)
    if jd is None and getattr(prob, "jac", None) is not None:
        jd = diag_from_full(prob.jac, prob.d)
    return jd


def ek1d_pd_step(m, C, p, t_new, *, f: Callable, jac_diag: Callable, At, Qt,
                 pinv0: float, pinv1: float, d: int, nq: int,
                 static_diff: Optional[str] = None, calib=None,
                 stop_calib: bool = False):
    """One DiagonalEK1 step with per-dimension covariances. ``m``: nq x d
    and ``C``: d blocks of nq x nq, lists of ``(B,)`` tensors; ``At``,
    ``Qt``: nested Python floats. Returns ``(m_new, C_new, ll_inc)``, and
    the updated ``calib = (sig, k)`` under a static diffusion (which
    filters with the unscaled prior, s2 = 1). ``stop_calib``: the dynamic
    s2 is detached, so a gradient treats it as part of the model (the
    values are the same)."""
    mp = [[_sreduce([At[i][l] * m[l][j] for l in range(nq) if At[i][l] != 0.0])
           for j in range(d)] for i in range(nq)]
    u_pred = torch.stack([pinv0 * mp[0][j] for j in range(d)])
    du = f(u_pred, p, t_new)
    jd = jac_diag(u_pred, p, t_new)
    z = [ep.innovation(pinv1, mp[1][j], du[j]) for j in range(d)]

    def h_quad(M, j):
        # h_j M h_j^T for h_j = pinv1 e_1 - jd_j pinv0 e_0 (M symmetric)
        return (pinv1 * pinv1 * M[1][1]
                - 2.0 * jd[j] * (pinv0 * pinv1) * M[0][1]
                + jd[j] * jd[j] * (pinv0 * pinv0) * M[0][0])

    if static_diff is not None:
        s2 = 1.0
    else:
        hq = [h_quad(Qt, j) for j in range(d)]
        s2 = _sreduce([z[j] * z[j] / hq[j] for j in range(d)]) / d
        if stop_calib:
            s2 = s2.detach()

    m_new = [[None] * d for _ in range(nq)]
    C_new, inv_s_list, ll_inc = [], [], None
    for j in range(d):
        Cj = C[j]
        tmp = [[_sreduce([At[i][a] * Cj[a][b] for a in range(nq)
                          if At[i][a] != 0.0])
                for b in range(nq)] for i in range(nq)]
        Cp = [[_sreduce([tmp[i][b] * At[l][b] for b in range(nq)
                         if At[l][b] != 0.0]) + Qt[i][l] * s2
               for l in range(nq)] for i in range(nq)]
        s = h_quad(Cp, j)
        inv_s = 1.0 / s
        inv_s_list.append(inv_s)
        kg = [(pinv1 * Cp[i][1] - jd[j] * pinv0 * Cp[i][0]) * inv_s
              for i in range(nq)]
        for i in range(nq):
            m_new[i][j] = mp[i][j] - kg[i] * z[j]
        C_new.append([[Cp[i][l] - kg[i] * kg[l] * s for l in range(nq)]
                      for i in range(nq)])
        inc = -0.5 * (z[j] * z[j] * inv_s
                      + torch.log(torch.clamp(s, min=1e-30)) + _LOG_2PI)
        ll_inc = inc if ll_inc is None else ll_inc + inc
    if static_diff is not None:
        return m_new, C_new, ll_inc, ep.static_local_update(
            static_diff, calib, None, z, inv_s_list, d)
    return m_new, C_new, ll_inc


def ek1d_filter_plain(
    f: Callable, jac_diag: Optional[Callable], m0_p: torch.Tensor,
    ps: torch.Tensor, *, At, Qt, pinv0: float, pinv1: float, t0: float,
    dt: float, n_steps: int, static_diff: Optional[str] = None,
):
    """The filter over ``n_steps`` steps from the preconditioned initial
    means ``m0_p`` ``(nq, d, B)`` and parameters ``ps`` ``(n_params, B)``;
    ``jac_diag`` None takes d JVPs (`auto_jac_diag`).

    Returns ``(us, stds, lls)``: filter means of the solution and their
    per-dimension stds ``pinv0 sqrt(max(C_j[0][0], 0))`` (0 at t0), each
    ``(T+1, d, B)``, and the summed log-likelihoods ``(B,)``; under a
    static diffusion also ``sig``, the running estimate after the last
    step, ``(B,)`` or ``(d, B)`` for fixedMV (stds not yet rescaled)."""
    nq, d, B = m0_p.shape
    T = int(n_steps)
    jac_diag = auto_jac_diag(f) if jac_diag is None else jac_diag
    At, Qt = _lists(At), _lists(Qt)
    new = dict(dtype=m0_p.dtype, device=m0_p.device)
    us = torch.empty((T + 1, d, B), **new)
    stds = torch.empty((T + 1, d, B), **new)
    m = [[m0_p[i, j] for j in range(d)] for i in range(nq)]
    zero = torch.zeros_like(m[0][0])
    C = [[[zero] * nq for _ in range(nq)] for _ in range(d)]
    us[0] = pinv0 * m0_p[0]
    stds[0] = 0.0
    ll = zero
    calib = ([zero] * d if static_diff == "fixedMV" else zero, zero)
    ts = ep.step_times(t0, dt, T, m0_p.dtype, m0_p.device)
    for k in range(T):
        out = ek1d_pd_step(m, C, ps, ts[k], f=f, jac_diag=jac_diag, At=At,
                           Qt=Qt, pinv0=pinv0, pinv1=pinv1, d=d, nq=nq,
                           static_diff=static_diff, calib=calib)
        m, C, ll_inc = out[:3]
        if static_diff is not None:
            calib = out[3]
        for j in range(d):
            us[k + 1, j] = pinv0 * m[0][j]
            stds[k + 1, j] = pinv0 * torch.sqrt(torch.clamp(C[j][0][0],
                                                            min=0.0))
        ll = ll + ll_inc
    if static_diff is None:
        return us, stds, ll
    sig = calib[0]
    return us, stds, ll, torch.stack(sig) if static_diff == "fixedMV" else sig


def ek1d_filter(
    f: Callable, jac_diag: Optional[Callable], field: Optional[str],
    m0_p: torch.Tensor, ps: torch.Tensor, *, At, Qt, pinv0: float,
    pinv1: float, t0: float, dt: float, n_steps: int,
    static_diff: Optional[str] = None,
):
    """The filter: `ek1d_filter_plain` on CPU tensors, the CUDA kernel
    ``ek1d_filter_kernel`` on CUDA tensors (vector field ``field``, with
    its own Jacobian diagonal)."""
    kw = dict(At=At, Qt=Qt, pinv0=pinv0, pinv1=pinv1, t0=t0, dt=dt,
              n_steps=n_steps)
    if _launch.dispatch_device("ek1d_filter", m0_p) == "cpu":
        return ek1d_filter_plain(f, jac_diag, m0_p, ps,
                                 static_diff=static_diff, **kw)
    nq, d, B = m0_p.shape
    _launch.check_field("ek1d_filter", field, nq, d, B, ps,
                        need_jac_diag=True)
    _launch.check_cuda_inputs("ek1d_filter", {"m0_p": m0_p, "ps": ps},
                              m0_p.dtype)
    T = int(n_steps)
    new = dict(dtype=m0_p.dtype, device=m0_p.device)
    us = torch.empty((T + 1, d, B), **new)
    stds = torch.empty((T + 1, d, B), **new)
    lls = torch.empty((B,), **new)
    sig = None
    if static_diff is not None:
        sig = torch.empty((d, B) if static_diff == "fixedMV" else (B,), **new)
    _launch.launch(ek1d_filter, m0_p.device,
                   f"ek1d_filter_{field}_{_launch.suffix(m0_p.dtype)}",
                   m0_p.data_ptr(), ps.data_ptr(), us.data_ptr(),
                   stds.data_ptr(), lls.data_ptr(),
                   None if sig is None else sig.data_ptr(), B, T,
                   ep.MODES[static_diff],
                   _launch.host_consts(At, Qt, scalars=(pinv0, pinv1, t0, dt)))
    if static_diff is None:
        return us, stds, lls
    return us, stds, lls, sig


ek1d_filter.launches = 0


def filter_constants(q: int, dt: float, dtype: torch.dtype):
    """``(At, Qt, p)``: the IBM transition and noise rounded to ``dtype``
    (as float64 numpy, as the JAX kernel bakes them in) and the
    preconditioner ``p`` at step ``dt``."""
    At, Qt, _, p = ep.pair_constants(q, dt)
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    return (At.astype(np_dtype).astype(np.float64),
            Qt.astype(np_dtype).astype(np.float64), p)


def ek1d_fused_filter(
    f: Callable,
    jac_diag: Optional[Callable],
    m0: torch.Tensor,
    ps: torch.Tensor,
    t0: float,
    dt: float,
    n_steps: int,
    q: int,
    *,
    field: Optional[str] = None,
    prior=None,
    mesh=None,
    diffusion: str = "dynamic",
):
    """The fixed-grid DiagonalEK1 ensemble filter over B members (any
    B >= 1). ``m0``: ``(q+1, d, B)`` unpreconditioned Taylor initial
    means; ``ps``: ``(n_params, B)``; ``jac_diag`` None takes d JVPs in the
    plain version (the kernel evaluates the CUDA field's).

    Returns ``(us, stds, lls)``: filter means and per-dimension stds
    ``(T+1, d, B)`` and the per-member log-likelihood ``(B,)``. A static
    ``diffusion`` (fixed, fixedMAP, fixedMV) returns ``(us, stds, lls,
    sigma2)``: ``lls`` all NaN, ``sigma2`` the calibrated per-member
    diffusion ``(B,)`` (``(d, B)`` for fixedMV), the stds rescaled by it.
    """
    static = ep.check_diffusion(diffusion)
    _launch.check_ported(prior=prior, second_order=False, mesh=mesh)
    At, Qt, p = filter_constants(q, dt, m0.dtype)
    m0_p = torch.as_tensor(p, dtype=m0.dtype, device=m0.device)[:, None, None] * m0
    out = ek1d_filter(f, jac_diag, field, m0_p, ps, At=At, Qt=Qt,
                      pinv0=float(1.0 / p[0]), pinv1=float(1.0 / p[1]),
                      t0=float(t0), dt=float(dt), n_steps=int(n_steps),
                      static_diff=static)
    if static is None:
        return out
    us, stds, _, sig = out
    lls = torch.full((m0.shape[2],), float("nan"), dtype=m0.dtype,
                     device=m0.device)
    if static == "fixedMV":
        stds = stds * torch.sqrt(sig)[None]
    else:
        stds = stds * torch.sqrt(sig)[None, None]
    return us, stds, lls, sig


def solve_ensemble_ek1d(
    prob_f: Callable,
    prob_jac_diag: Optional[Callable],
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
    """Taylor init + the fixed-grid DiagonalEK1 filter over an ensemble:
    ``u0s`` ``(B, d)``, ``ps`` ``(B, n_params)``. Returns what
    `ek1d_fused_filter` returns."""
    from odefilters_torch.taylor import taylor_coefficients

    t0, t1 = tspan
    dt = (t1 - t0) / n_steps
    # contiguous copies: forward-mode AD refuses inputs whose elements
    # alias one another, as in an expanded (broadcast) ensemble
    ps_t = ps.T.contiguous()
    m0 = torch.stack(taylor_coefficients(prob_f, u0s.T.contiguous(), ps_t, t0,
                                         q))
    return ek1d_fused_filter(prob_f, prob_jac_diag, m0, ps_t, float(t0),
                             float(dt), n_steps, q, field=field, prior=prior,
                             mesh=mesh, diffusion=diffusion)
