"""Time-parallel fixed-grid ODE filtering and smoothing by associative scans
(counterpart of ``odefilters/parallel/associative.py``).

The measurement linearization point of an ODE filter depends on the unknown
solution, so the solve is iterated (parallel IEKS, Bosch et al.,
"Parallel-in-time probabilistic numerical ODE solvers"):

    1. a trajectory guess u_k (constant u0, or a coarse adaptive solve);
    2. the measurement 0 = E1 x - f(u) linearized at u_k:
       H_k = E1 - J_k E0,  y_k = f(u_k) - J_k u_k   (EK0: J_k = 0);
    3. a parallel filter and a parallel smoother (associative scans);
    4. u_k <- the smoothed means; repeat.

Calibration is the global MLE ``sigma^2 = (1/Nd) sum z_k^T S_k^-1 z_k`` of
the last sweep's innovations. The square-root form (the default) scans
`associative_sqrt`'s elements; the covariance form (``sqrt_form=False``)
scans the Sarkka & Garcia-Fernandez elements below, whose combination
solves a general system (``torch.linalg.solve``).

On the CUDA card, at more than 1024 grid points, the scans default to the
fused kernels (``block="fused"``, ``ops/tp_scan.py``) and the linearization
starts from a coarse adaptive EK0 solve (``warm_start=8``) on the adaptive
kernel of ``ops/ek0_adaptive.py``, as the JAX package defaults on an
accelerator. On the CPU the defaults are the JAX package's CPU defaults,
except that the coarse solve is the same adaptive solve (its plain
version), where the JAX package runs its Kronecker scan.
"""

from __future__ import annotations

import math
import types
from typing import Optional

import numpy as np
import torch

from odefilters_torch.algorithms import AbstractEK
from odefilters_torch.linalg import cholesky_psd
from odefilters_torch.linalg import matmul_unrolled as _bmm
from odefilters_torch.linalg import solve_triangular_unrolled
from odefilters_torch.parallel.associative_sqrt import (
    check_block,
    parallel_filter_sqrt,
    parallel_smoother_sqrt,
)
from odefilters_torch.parallel.blocked import (
    auto_block,
    blocked_associative_scan,
)
from odefilters_torch.priors import precond_full, transition_precond_full
from odefilters_torch.problem import ODEProblem
from odefilters_torch.taylor import taylor_coefficients


def _T(x):
    return x.transpose(-1, -2)


def _eye(D, like):
    return torch.eye(D, dtype=like.dtype, device=like.device)


def _solve(A, B):
    """``A^{-1} B`` (batched) for the general systems of the covariance-form
    combinations, where ``I + C_i J_j`` is not symmetric."""
    return torch.linalg.solve(A, B)


def _psd_solve(A, B):
    """``A^{-1} B`` for symmetric PSD A by Cholesky and two triangular
    solves."""
    L = cholesky_psd(A)
    B = B.expand(A.shape[:-2] + B.shape[-2:])
    y = solve_triangular_unrolled(L, B, lower=True)
    return solve_triangular_unrolled(_T(L), y, lower=False)


# --------------------------------------------------------------------------
# Covariance form (Sarkka & Garcia-Fernandez 2021, Lemmas 7-8)
# --------------------------------------------------------------------------


def _filter_element_first(m0, P0, F, Q, H, y):
    """Element e_1: the prior pushed through the first transition, then
    updated."""
    m_pred = F @ m0
    P_pred = F @ P0 @ _T(F) + Q
    S = H @ P_pred @ _T(H)
    K = _T(_psd_solve(S, H @ P_pred))      # P_pred H^T S^-1
    b = m_pred + K @ (y - H @ m_pred)
    C = P_pred - K @ S @ _T(K)
    return (torch.zeros_like(P_pred), b, C, torch.zeros_like(m0),
            torch.zeros_like(P_pred))


def _filter_elements_rest(F, Q, H, y):
    """Generic elements e_k, k >= 2, batched over time."""
    S = H @ Q @ _T(H)                      # R = 0
    K = _T(_psd_solve(S, H @ Q))           # Q H^T S^-1
    IKH = _eye(F.shape[-1], F) - K @ H
    A = IKH @ F
    b = (K @ y[..., None])[..., 0]
    C = IKH @ Q
    HtSi = _T(H) @ _psd_solve(S, _eye(S.shape[-1], F))
    eta = (_T(F) @ HtSi @ y[..., None])[..., 0]
    J = _T(F) @ HtSi @ H @ F
    return A, b, C, eta, J


def _filter_combine(ei, ej):
    """Associative combination of filtering elements (the paper's eq.
    (10))."""
    Ai, bi, Ci, etai, Ji = ei
    Aj, bj, Cj, etaj, Jj = ej
    I = _eye(Ai.shape[-1], Ai)
    AjE = _T(_solve(_T(I + Ci @ Jj), _T(Aj)))    # Aj (I + Ci Jj)^-1
    A = AjE @ Ai
    b = (AjE @ (bi[..., None] + Ci @ etaj[..., None]))[..., 0] + bj
    C = AjE @ Ci @ _T(Aj) + Cj
    AtiE = _T(_solve(_T(I + Jj @ Ci), Ai))       # Ai^T (I + Jj Ci)^-1
    eta = (AtiE @ (etaj[..., None] - Jj @ bi[..., None]))[..., 0] + etai
    J = AtiE @ Jj @ Ai + Ji
    return A, b, C, eta, J


def parallel_filter(m0, P0, F, Q, H, ys, block=None):
    """All-time filtered means and covariances ``(ms, Ps)`` of the N
    post-transition states, in O(log N) depth."""
    N = ys.shape[0]
    D = m0.shape[-1]
    F_ = F.expand(N, D, D)
    Q_ = Q.expand(N, D, D)
    e_rest = _filter_elements_rest(F_, Q_, H, ys)
    e1 = _filter_element_first(m0, P0, F_[0], Q_[0], H[0], ys[0])
    elems = tuple(torch.cat([a[None], rest[1:]], dim=0)
                  for a, rest in zip(e1, e_rest))
    _, b, C, _, _ = blocked_associative_scan(_filter_combine, elems, block)
    return b, C


def _smooth_combine(suffix, elem):
    """Combination for the reversed smoothing scan: the smoothed state
    obeys ``x^s_k = g_k + E_k x^s_{k+1}``; the first operand is the
    later-in-time suffix."""
    Ea, ga, La = suffix
    Eb, gb, Lb = elem
    return (Eb @ Ea, gb + (Eb @ ga[..., None])[..., 0],
            Lb + Eb @ La @ _T(Eb))


def parallel_smoother(ms, Ps, F, Q, block=None):
    """Smoothed means and covariances from the filtered ones."""
    N, D = ms.shape
    F_ = F.expand(N - 1, D, D)
    Q_ = Q.expand(N - 1, D, D)
    P_pred = F_ @ Ps[:-1] @ _T(F_) + Q_
    G = _T(_psd_solve(P_pred, F_ @ Ps[:-1]))    # P_k F^T P_pred^-1
    g = ms[:-1] - (G @ (F_ @ ms[:-1][..., None]))[..., 0]
    L = Ps[:-1] - G @ F_ @ Ps[:-1]
    E = torch.cat([G, G.new_zeros((1, D, D))], dim=0)
    elems = (E, torch.cat([g, ms[-1:]], dim=0), torch.cat([L, Ps[-1:]], dim=0))
    _, gr, Lr = blocked_associative_scan(_smooth_combine, elems, block,
                                         reverse=True)
    return gr, Lr


# --------------------------------------------------------------------------
# The iterated solve
# --------------------------------------------------------------------------


def _setup(prob: ODEProblem, alg: AbstractEK, ts: torch.Tensor):
    """What the global and the windowed solves share: the preconditioned
    transition ``A``, its noise factor ``QL``, the preconditioner, the
    Taylor-initialized ``m0``, and ``build_elements(u_lin, t_meas)``, the
    measurement ``(H (M, d, D), y (M, d))`` linearized along ``u_lin``
    ``(M, d)``."""
    d, q = prob.d, alg.order
    D = d * (q + 1)
    dtype, device = prob.u0.dtype, prob.u0.device
    N = ts.shape[0] - 1
    h = (float(ts[-1]) - float(ts[0])) / N

    def tensor(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    A_np, QL_np = transition_precond_full(alg.prior, d, q)
    p_np, pinv_np = precond_full(h, d, q)
    A, QL, p_full, pinv_full = map(tensor, (A_np, QL_np, p_np, pinv_np))
    derivs = taylor_coefficients(prob.f, prob.u0, prob.p, float(ts[0]), q)
    m0 = p_full * torch.cat(derivs)
    E0p = torch.zeros((d, D), dtype=dtype, device=device)
    E1p = torch.zeros((d, D), dtype=dtype, device=device)
    idx = torch.arange(d, device=device)
    E0p[idx, idx] = pinv_full[:d]
    E1p[idx, d + idx] = pinv_full[d:2 * d]

    if alg.is_diagonal_ek1:
        # J -> diag(J): the elements stay dense, only the linearization is
        # diagonal
        from odefilters_torch.jacobians import resolve_jac_diag

        jd = resolve_jac_diag(prob.f, prob.jac, prob.jac_diag)

        def jac_rows(u, t):
            return torch.diag_embed(jd(u.T, prob.p, t).T)
    elif alg.is_ek1:
        from odefilters_torch.ops.ek1_fused import auto_jac

        jac = prob.jac if prob.jac is not None else auto_jac(prob.f)

        def jac_rows(u, t):
            return jac(u.T, prob.p, t).permute(2, 0, 1)

    def build_elements(u_lin, t_meas):
        M = u_lin.shape[0]
        fu = prob.f(u_lin.T, prob.p, t_meas).T             # (M, d)
        if alg.is_ek1:
            J = jac_rows(u_lin, t_meas)                      # (M, d, d)
            H = E1p[None] - _bmm(J, E0p[None])
            y = fu - _bmm(J, u_lin[..., None])[..., 0]
        else:
            H = E1p.expand(M, d, D)
            y = fu
        return H, y

    return types.SimpleNamespace(
        d=d, D=D, N=N, dtype=dtype, device=device, A=A, QL=QL, Qm=QL @ QL.T,
        p_full=p_full, pinv_full=pinv_full, m0=m0,
        build_elements=build_elements)


def _solve_parallel_inner(prob, alg, ts, iterations, u_init, sqrt_form,
                          block):
    c = _setup(prob, alg, ts)
    d, D, N = c.d, c.D, c.N
    A, QL, Qm, m0, pinv = c.A, c.QL, c.Qm, c.m0, c.pinv_full
    P0 = torch.zeros((D, D), dtype=c.dtype, device=c.device)
    t_meas = ts[1:]

    if sqrt_form:
        def run_filter_smoother(H, y):
            ms, Us = parallel_filter_sqrt(m0, P0, A, QL, H, y, block=block)
            ms_s, Us_s = parallel_smoother_sqrt(
                torch.cat([m0[None], ms]), torch.cat([P0[None], Us]), A, QL,
                block=block)
            return ms, _bmm(Us, _T(Us)), ms_s, _bmm(Us_s, _T(Us_s))
    else:
        def run_filter_smoother(H, y):
            ms, Ps = parallel_filter(m0, P0, A, Qm, H, y, block=block)
            ms_s, Ps_s = parallel_smoother(
                torch.cat([m0[None], ms]), torch.cat([P0[None], Ps]), A, Qm,
                block=block)
            return ms, Ps, ms_s, Ps_s

    u_lin = (prob.u0.expand(N, d) if u_init is None
             else u_init.to(c.dtype))
    for _ in range(max(iterations - 1, 0)):
        _, _, ms_s, _ = run_filter_smoother(*c.build_elements(u_lin, t_meas))
        u_lin = pinv[None, :d] * ms_s[1:, :d]

    # the final sweep keeps the posterior and the calibration statistics
    H, y = c.build_elements(u_lin, t_meas)
    ms, Ps, ms_s, Ps_s = run_filter_smoother(H, y)
    sigma2 = global_mle(c, H, y, ms, Ps)
    return _outputs(pinv, d, ms_s, sigma2 * Ps_s, sigma2)


def global_mle(c, H, y, ms, Ps):
    """The global MLE diffusion ``mean_k z_k^T S_k^-1 z_k / d`` from the
    innovations ``z_k = H x_pred - y``, ``S_k = H P_pred H^T`` of the
    filtered states ``ms``, ``Ps`` (after the initial state)."""
    ms_all = torch.cat([c.m0[None], ms])
    Ps_all = torch.cat([Ps.new_zeros((1,) + Ps.shape[1:]), Ps])
    m_pred = _bmm(c.A[None], ms_all[:-1][..., None])[..., 0]
    P_pred = _bmm(_bmm(c.A[None], Ps_all[:-1]), _T(c.A)[None]) + c.Qm[None]
    z = _bmm(H, m_pred[..., None])[..., 0] - y
    S = _bmm(_bmm(H, P_pred), _T(H))
    return torch.mean(torch.sum(z * _psd_solve(S, z[..., None])[..., 0],
                                dim=-1)) / c.d


def _outputs(pinv, d, ms_s, Ps_cal, sigma2):
    """``(u, u_std, state_means, state_covs, sigma2)`` back in
    unpreconditioned coordinates."""
    mean_out = pinv[None, :] * ms_s
    cov_out = pinv[None, :, None] * Ps_cal * pinv[None, None, :]
    var = torch.diagonal(cov_out, dim1=-2, dim2=-1)[:, :d]
    return mean_out[:, :d], torch.sqrt(torch.clamp(var, min=0.0)), \
        mean_out, cov_out, sigma2


def _interp(x, xp, fp):
    """``jnp.interp(x, xp, fp)``: linear interpolation on the sorted grid
    ``xp``, constant beyond its ends."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(torch.finfo(xp.dtype).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, torch.ones_like(dx),
                                                     dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def warm_start_order(q: int, device: torch.device) -> int:
    """The order of the warm start's adaptive EK0 solve: min(q, 3), as in the
    JAX package, wherever the single solve runs that order on ``device``
    (``ek1_adaptive.runnable_order``: on the card the adaptive EK0 kernel is
    built for q = 1, 2, 3, so everywhere)."""
    from odefilters_torch.ops.ek1_adaptive import runnable_order

    return runnable_order(min(q, 3), device)


def warm_start_trajectory(prob: ODEProblem, ts: torch.Tensor, warm_start: int,
                          q: int) -> torch.Tensor:
    """The linearization trajectory ``(N, d)`` at ``ts[1:]``: an adaptive
    EK0 solve in float32 (order `warm_start_order`, abstol 1e-6, reltol
    1e-3) saved on ``ceil(N / warm_start)`` uniform intervals, by
    `odefilters_torch.solve_adaptive_single` (its kernel on the card),
    interpolated linearly. Entries that are not finite or exceed 1e6 (1 +
    max |u0|) fall back to u0."""
    from odefilters_torch.ops.ek1_adaptive import solve_adaptive_single

    N = ts.shape[0] - 1
    n_c = max(int(math.ceil(N / int(warm_start))), 1)
    t0f, t1f = float(ts[0]), float(ts[-1])
    p = (prob.p if prob.p is not None
         else prob.u0.new_zeros((0,)))
    us_c = solve_adaptive_single(
        prob.f, prob.u0.float(), torch.atleast_1d(p).float(), (t0f, t1f), n_c,
        q=warm_start_order(q, prob.u0.device), abstol=1e-6, reltol=1e-3,
        field=prob.field)[0]
    coarse_u = us_c.to(ts.dtype)                          # (n_c + 1, d)
    ts_c = torch.linspace(t0f, t1f, n_c + 1, dtype=ts.dtype, device=ts.device)
    u_init = torch.stack([_interp(ts[1:], ts_c, coarse_u[:, i])
                          for i in range(prob.d)], dim=-1)
    u0_row = prob.u0.to(u_init.dtype).expand(u_init.shape)
    scale = 1.0 + torch.max(torch.abs(prob.u0)).to(u_init.dtype)
    bad = ~torch.isfinite(u_init) | (torch.abs(u_init) > 1e6 * scale)
    return torch.where(bad, u0_row, u_init)


def _check_fused_dim(prob, alg, block, on_card):
    from odefilters_torch.ops.tp_scan import CUDA_D_MAX

    D = prob.d * (alg.order + 1)
    if on_card and block == "fused" and D > CUDA_D_MAX:
        raise NotImplementedError(
            f"the fused scan kernels take state dimensions D = d (q+1) <= "
            f"{CUDA_D_MAX}, and this solve has D = {D}: {CUDA_D_MAX} is the "
            "largest D at which the CTA-per-combine kernels "
            "(ops/csrc/tp_wide.cuh) are held on the card against their plain "
            "versions (ROADMAP queue 3); pass block= a chunk length (the "
            "blocked scan) or 0 (the plain scan)"
        )


def resolve_options(prob: ODEProblem, alg: AbstractEK, n_steps: int, *,
                    block=None, warm_start=None, sqrt_form: bool = True,
                    windows: Optional[int] = None):
    """The ``(block, warm_start)`` a solve of ``n_steps`` uniform steps runs
    with, from the caller's values and the JAX package's defaults: on the
    CUDA card the fused scan above 1024 grid points (windowed: at 1024
    steps a window or more) and a warm start; on the CPU the blocked scan
    at ``auto_block`` and a warm start for EK0 and DiagonalEK1 only
    (windowed: none). On the card the fused scan takes state dimensions
    D = d (q+1) up to ``tp_scan.CUDA_D_MAX`` (96, the largest held on the
    card); above it a solve that resolves to the fused scan raises."""
    check_block(block)
    on_card = prob.u0.device.type == "cuda"
    if windows:
        M = n_steps // int(windows)
        if block is None:
            block = "fused" if on_card and M >= 1024 else auto_block(M)
        if warm_start is None:
            warm_start = 8 if on_card else 0
        _check_fused_dim(prob, alg, block, on_card)
        return block or None, warm_start
    if block == "fused" and not sqrt_form:
        raise ValueError(
            "block='fused' runs the square-root fused scan kernels; pass "
            "sqrt_form=True (the covariance form runs the XLA-form scans)"
        )
    if block is None:
        block = ("fused" if sqrt_form and on_card and n_steps + 1 > 1024
                 else auto_block(n_steps))
    _check_fused_dim(prob, alg, block, on_card)
    block = block or None
    if warm_start is None:
        # EK0's relinearization is Picard-type (linear convergence), and so
        # are DiagonalEK1's off-diagonal couplings: warm-start them
        warm_start = 8 if (block == "fused" or on_card or not alg.is_ek1
                           or alg.is_diagonal_ek1) else 0
    return block, warm_start


def solve_fixed_parallel(
    prob: ODEProblem,
    alg: AbstractEK,
    *,
    dt: Optional[float] = None,
    ts=None,
    iterations: int = 4,
    taylor_method: str = "auto",
    warm_start: Optional[int] = None,
    sqrt_form: bool = True,
    time_shard_axis: Optional[str] = None,
    block=None,
    windows: Optional[int] = None,
):
    """Time-parallel fixed-grid solve on a uniform grid.

    Returns ``(u, u_std, state_means, state_covs, sigma2)``: the posterior
    means ``(N+1, d)`` and stds at the grid, the full smoothed states
    ``(N+1, D)``, ``(N+1, D, D)``, and the calibrated global diffusion. The
    grid is ``ts`` or ``dt`` over ``prob.tspan``, on the problem's device
    in its dtype.

    ``iterations``: linearization sweeps. ``warm_start``: the coarse grid
    factor of the warm start (`warm_start_trajectory`; 0 disables it).
    ``block``: ``"fused"`` (the CUDA scan kernels; their plain versions on
    the CPU), a chunk length for the blocked scan, or 0 for the plain
    associative scan; None picks as `resolve_options` does.
    ``sqrt_form=False`` runs the covariance form. ``windows=W``: the
    windowed solve (`odefilters_torch.parallel.windowed`) of N/W-step
    windows run one after the other, the linearization iterated within
    each; it needs the square-root form. ``taylor_method``: ``"auto"`` only
    (the port's Taylor init has one method). ``time_shard_axis`` is not
    ported (ROADMAP.md queue 1, item 11).
    """
    if time_shard_axis is not None:
        raise NotImplementedError(
            "time_shard_axis= (a time axis sharded over a mesh) is not ported "
            "yet (ROADMAP.md queue 1, item 11): the port runs on one card"
        )
    if taylor_method != "auto":
        raise ValueError(
            f"taylor_method={taylor_method!r}: the port's Taylor init has one "
            "method (nested forward-mode JVPs); pass 'auto'"
        )
    check_block(block)
    transition_precond_full(alg.prior, prob.d, alg.order)  # ported priors
    dtype, device = prob.u0.dtype, prob.u0.device
    t0, t1 = prob.tspan
    if ts is None:
        if dt is None:
            raise ValueError("solve_fixed_parallel requires dt or ts")
        n = max(int(round(float(t1 - t0) / float(dt))), 1)
        ts = torch.linspace(t0, t1, n + 1, dtype=dtype, device=device)
    else:
        ts = torch.as_tensor(ts, dtype=dtype, device=device)
    dts = np.diff(ts.cpu().numpy())
    if not np.allclose(dts, dts[0], rtol=1e-6):
        raise ValueError(
            "solve_fixed_parallel requires a uniform grid (constant "
            "preconditioned transition per step); the port's sequential "
            "solves take other grids"
        )
    n = ts.shape[0] - 1
    if windows:
        W = int(windows)
        if not sqrt_form:
            raise ValueError(
                "windows= runs the square-root windowed solver; the "
                "covariance form (sqrt_form=False) has no windowed path"
            )
        if n % W:
            raise ValueError(
                f"windows={W} must divide the number of grid steps ({n})")
    block, warm_start = resolve_options(
        prob, alg, n, block=block, warm_start=warm_start, sqrt_form=sqrt_form,
        windows=windows)
    u_init = (warm_start_trajectory(prob, ts, warm_start, alg.order)
              if warm_start else None)
    if windows:
        from odefilters_torch.parallel.windowed import solve_windowed

        return solve_windowed(prob, alg, ts, int(windows), int(iterations),
                              u_init, block)
    return _solve_parallel_inner(prob, alg, ts, int(iterations), u_init,
                                 bool(sqrt_form), block)
