"""Adaptive per-member DiagonalEK1 ensemble solves: plain PyTorch versions
and the wrappers of the three CUDA kernels that replace the JAX package's
adaptive DiagonalEK1 filter and its attempt-stream filter + RTS smoother
pair.

=======================================  ===================================
this module                              ``odefilters/ops/pallas_kernels.py``
=======================================  ===================================
``attempt``                              one attempt of the loop body of
                                         ``_ek1d_adaptive_kernel``
``ek1d_adaptive_plain`` /                ``_ek1d_adaptive_kernel`` (CUDA:
``ek1d_adaptive``                        ``csrc/ek1d.cu::
                                         ek1d_adaptive_kernel``)
``ek1d_adaptive_stream_plain`` /         ``_ek1d_adaptive_stream_kernel``
``ek1d_adaptive_stream``                 (CUDA:
                                         ``ek1d_adaptive_stream_kernel``)
``ek1d_adaptive_smoother_plain`` /       ``_ek1d_adaptive_smoother_kernel``
``ek1d_adaptive_smoother``               (CUDA:
                                         ``ek1d_adaptive_smoother_kernel``)
``ek1d_adaptive_filter``                 ``ek1d_adaptive_filter``
``ek1d_adaptive_fused_smooth``           ``ek1d_adaptive_fused_smooth``
``solve_ensemble_ek1d_adaptive``         ``solve_ensemble_ek1d_adaptive_
                                         pallas``
``solve_ensemble_ek1d_adaptive_smooth``  ``solve_ensemble_ek1d_adaptive_
                                         smooth_pallas``
=======================================  ===================================

Each member runs the adaptive EK0 solve's loop (`ek0_adaptive`: its
`Controller`, `begin`, `control`, `Members`, the save grid without a
barrier, the compacted stream) with the DiagonalEK1 step: d independent
``(q+1) x (q+1)`` filters, dimension j measuring ``h_j = pinv1 e_1 -
J_jj pinv0 e_0`` at the attempt's step, one dynamic diffusion
``s2 = mean_j z_j^2 / (h_j Qt h_j^T)``, the error estimate
``dt sqrt(s2 h_j Qt h_j^T)`` per dimension. The Jacobian diagonal comes
from ``jac_diag`` (None: d JVPs, `ek1d.auto_jac_diag`); the kernels
evaluate the CUDA field's own.

**The covariance as a factor (a departure from the JAX kernels).** The
JAX kernels carry each dimension's plain covariance, update it as
``Cp - k k^T s``, stream it with the committed Jacobian diagonal, and the
smoother factors it by a Householder reflection of the closed-form null
direction ``(-J_jj, 1)`` and a structural-zero Cholesky. In float32 the
plain covariance of the adaptive EK0 solve loses its positive definiteness
at abstol 1e-6, reltol 1e-4 and the smoothed means turn NaN (PERF.md
§6). Here each dimension carries a factor ``L_j`` (``C_j = L_j
L_j^T``, not triangular): the prediction is re-triangularised by modified
Gram-Schmidt (`ek0_adaptive.predict_factor`), and the R = 0 update is
``L_new = Lp - k (h_j^T Lp)`` with ``k = Lp (Lp^T h_j) / s``, exact for
any ``h_j``. The backward pass never sees ``h_j``: its step is the
adaptive EK0 smoother's (`ek0_adaptive.smoother_step`) on each
dimension's factor, so neither the Householder reflection, the Cholesky
nor a streamed Jacobian diagonal is needed. A stream row is ``[m (nq*d) |
L_0 ... L_{d-1} (d*nq*nq, row-major) | log dt_eff | s2 | save index]``,
W = 43 at q = 3, d = 2.

The plain versions run every member at once on lists of ``(B,)``
tensors, in the kernels' order of operations. Dispatch: each wrapper runs
its plain version on CPU tensors, launches its CUDA kernel on CUDA
tensors, raises on any other device, and counts its launches in
``.launches``. The second-order, diagonal-mass and Chebyshev-prior
branches of the JAX kernels are not ported (ROADMAP.md queue 1, items 3
and 5) and raise.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from odefilters_torch.ops import _launch
from odefilters_torch.ops import ek0_adaptive as ea
from odefilters_torch.ops._blocks import _lists, _smul, _sreduce
from odefilters_torch.ops.ek0_filter import _LOG_2PI
from odefilters_torch.ops.ek0_pair import innovation
from odefilters_torch.ops.ek1d import auto_jac_diag


def stream_width(nq: int, d: int) -> int:
    """Width of an accepted-step stream row (43 at q = 3, d = 2)."""
    return nq * d + d * nq * nq + 3


def start(m0: torch.Tensor, dt0s: torch.Tensor, c: ea.Controller) -> ea.Members:
    """The loop state of `ek0_adaptive.Members` with ``L`` a list of d
    zero factors, one per dimension."""
    st = ea.Members.start(m0, dt0s, c.t0)
    st.L = [st.L] * m0.shape[1]
    return st


def attempt(st: ea.Members, p, *, f: Callable, jac_diag: Callable,
            c: ea.Controller, live: torch.Tensor) -> dict:
    """One attempt of every ``live`` member (the others change nothing):
    precondition at the attempt's step, one square-root DiagonalEK1(dynamic)
    step per dimension, then `ek0_adaptive.control`, in the order of the
    JAX kernel's loop body (with the factors in place of the plain
    covariances). Updates ``st`` in place and returns what
    `ek0_adaptive.attempt` returns."""
    nq, d = len(st.m), len(st.m[0])
    q_half = nq - 1 + 0.5
    At, QLt, Qt = _lists(c.At), _lists(c.QLt), _lists(c.Qt)
    a = ea.begin(st, c, live)
    lh, ps_ = a["lh"], a["ps_"]
    mh = [[st.m[i][j] * ps_[i] for j in range(d)] for i in range(nq)]
    pinv0 = torch.exp(q_half * lh)
    pinv1 = torch.exp((q_half - 1.0) * lh)

    # -- predict the mean; linearize --
    mp = [[_sreduce([_smul(At[i][l], mh[l][j]) for l in range(nq)])
           for j in range(d)] for i in range(nq)]
    u_pred = torch.stack([pinv0 * mp[0][j] for j in range(d)])
    du = f(u_pred, p, a["t_new"])
    jd = jac_diag(u_pred, p, a["t_new"])
    z = [innovation(pinv1, mp[1][j], du[j]) for j in range(d)]
    # h_j = pinv1 e_1 - jd_j pinv0 e_0
    hc = [[-jd[j] * pinv0, pinv1] for j in range(d)]
    hq = [_sreduce([hc[j][i] * hc[j][l] * Qt[i][l]
                    for i in range(2) for l in range(2)]) for j in range(d)]
    # dynamic diffusion: sigma^2 = mean_j z_j^2 / (h_j Q h_j^T)
    s2 = _sreduce([z[j] * z[j] / hq[j] for j in range(d)]) / d
    sq_s2 = torch.sqrt(s2)

    # -- per dimension: predict the factor, the scalar R = 0 update --
    m_new = [[None] * d for _ in range(nq)]
    L_new, s_list = [], []
    for j in range(d):
        Lh = [[st.L[j][i][l] * ps_[i] for l in range(nq)] for i in range(nq)]
        Lp = ea.predict_factor(At, QLt, Lh, sq_s2, nq)
        w = [hc[j][0] * Lp[0][l] + hc[j][1] * Lp[1][l] for l in range(nq)]
        s = _sreduce([wl * wl for wl in w])
        s_list.append(s)
        inv_s = 1.0 / s
        kg = [_sreduce([Lp[i][l] * w[l] for l in range(nq)]) * inv_s
              for i in range(nq)]
        for i in range(nq):
            m_new[i][j] = mp[i][j] - kg[i] * z[j]
        L_new.append([[Lp[i][l] - kg[i] * w[l] for l in range(nq)]
                      for i in range(nq)])
    maha = _sreduce([z[j] * z[j] / s_list[j] for j in range(d)])
    logdet = _sreduce([torch.log(torch.clamp(s_list[j], min=1e-30))
                       for j in range(d)])
    ll_inc = -0.5 * (maha + logdet + d * _LOG_2PI)
    u_filt = [pinv0 * m_new[0][j] for j in range(d)]

    # -- error estimate: err_j = dt sqrt(s2 hq_j) / sc_j --
    errs = [torch.sqrt(torch.clamp(s2 * hq[j], min=0.0)) for j in range(d)]
    accept, reached = ea.control(st, c, a, errs=errs, u_filt=u_filt,
                                 m_new=m_new, ll_inc=ll_inc)
    st.L = [[[torch.where(accept, L_new[j][i][l] / ps_[i], st.L[j][i][l])
              for l in range(nq)] for i in range(nq)] for j in range(d)]
    return dict(accept=accept, lh=lh, s2=s2, reached=reached,
                seg_before=a["seg"])


def _stds(L):
    """Each dimension's std of block 0: ``(d, B)``."""
    return torch.stack([ea._std(Lj) for Lj in L])


def _forward(f, jac_diag, m0, ps, dt0s, c, on_attempt):
    jac_diag = auto_jac_diag(f) if jac_diag is None else jac_diag
    return ea.run(start(m0, dt0s, c), c,
                  lambda st, live: attempt(st, ps, f=f, jac_diag=jac_diag,
                                           c=c, live=live),
                  on_attempt)


def ek1d_adaptive_plain(f: Callable, jac_diag: Optional[Callable],
                        m0: torch.Tensor, ps: torch.Tensor,
                        dt0s: torch.Tensor, c: ea.Controller):
    """The adaptive filter from unpreconditioned initial means ``m0``
    ``(nq, d, B)``, parameters ``ps`` ``(n_params, B)`` and initial steps
    ``dt0s`` ``(B,)``: ``(us (S+1, d, B), stds (S+1, d, B), lls (B,),
    counts (N_COUNTS, B))``. Row 0 is the exact initial state with std 0;
    row k the filtered mean of block 0 and each dimension's std at save
    point k."""
    nq, d, B = m0.shape
    S = c.n_save
    us = torch.empty((S + 1, d, B), dtype=m0.dtype, device=m0.device)
    stds = torch.empty((S + 1, d, B), dtype=m0.dtype, device=m0.device)
    us[0] = m0[0]
    stds[0] = 0.0

    def emit(st, out):
        idx = torch.nonzero(out["reached"]).flatten()
        if idx.numel():
            k = out["seg_before"][idx] + 1
            for j in range(d):
                us[k, j, idx] = st.m[0][j][idx]
            stds[k, :, idx] = _stds(st.L)[:, idx].T

    st = _forward(f, jac_diag, m0, ps, dt0s, c, emit)
    final = _stds(st.L)
    for j in range(d):
        ea._fill_tail(us[:, j], st.seg, st.m[0][j])
        ea._fill_tail(stds[:, j], st.seg, final[j])
    return us, stds, st.ll, ea._counts(st, c)


def ek1d_adaptive_stream_plain(f: Callable, jac_diag: Optional[Callable],
                               m0: torch.Tensor, ps: torch.Tensor,
                               dt0s: torch.Tensor, c: ea.Controller):
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
        vals = ([x for mi in st.m for x in mi]
                + [x for Lj in st.L for Li in Lj for x in Li]
                + [out["lh"], out["s2"], mark.to(m0.dtype)])
        st_out[st.nacc[idx] - 1, :, idx] = torch.stack(vals)[:, idx].T

    st = _forward(f, jac_diag, m0, ps, dt0s, c, emit)
    return st_out, st.ll, ea._counts(st, c)


def dimension_stream(st: torch.Tensor, nq: int, d: int, j: int):
    """Dimension j's columns of a DiagonalEK1 stream as an EK0 stream of
    one dimension: ``[m[:, j] | L_j | log dt_eff | s2 | save index]``."""
    o = nq * d + j * nq * nq
    cols = ([i * d + j for i in range(nq)] + list(range(o, o + nq * nq))
            + [st.shape[1] - 3, st.shape[1] - 2, st.shape[1] - 1])
    return st[:, cols]


def ek1d_adaptive_smoother_plain(st: torch.Tensor, counts: torch.Tensor,
                                 m0: torch.Tensor, c: ea.Controller):
    """The backward pass over each member's accepted steps: the smoothed
    means of block 0 and each dimension's stds, ``(S+1, d, B)``, from the
    stream ``st`` and ``counts`` of `ek1d_adaptive_stream_plain` and the
    initial means ``m0``. Each dimension is the adaptive EK0 smoother's
    pass (`ek0_adaptive.ek0_adaptive_smoother_plain`) over its own
    columns."""
    nq, d, B = m0.shape
    us = torch.empty((c.n_save + 1, d, B), dtype=m0.dtype, device=m0.device)
    stds = torch.empty_like(us)
    K = max(int(counts[0].max()), 1)
    for j in range(d):
        us_j, stds[:, j] = ea.ek0_adaptive_smoother_plain(
            dimension_stream(st[:K], nq, d, j), counts, m0[:, j:j + 1], c)
        us[:, j] = us_j[:, 0]
    return us, stds


# --------------------------------------------------------------- wrappers


def _check(name: str, field, m0, ps, dt0s):
    nq, d, B = m0.shape
    _launch.check_field(name, field, nq, d, B, ps, need_jac_diag=True)
    if tuple(dt0s.shape) != (B,):
        raise ValueError(f"{name}: dt0s must be ({B},), got {tuple(dt0s.shape)}")
    _launch.check_cuda_inputs(name, {"m0": m0, "ps": ps, "dt0s": dt0s},
                              m0.dtype)


def ek1d_adaptive(f: Callable, jac_diag: Optional[Callable],
                  field: Optional[str], m0: torch.Tensor, ps: torch.Tensor,
                  dt0s: torch.Tensor, c: ea.Controller):
    """The adaptive filter: `ek1d_adaptive_plain` on CPU tensors, the CUDA
    kernel ``ek1d_adaptive_kernel`` on CUDA tensors (vector field
    ``field``, with its own Jacobian diagonal)."""
    if _launch.dispatch_device("ek1d_adaptive", m0) == "cpu":
        return ek1d_adaptive_plain(f, jac_diag, m0, ps, dt0s, c)
    _check("ek1d_adaptive", field, m0, ps, dt0s)
    nq, d, B = m0.shape
    new = dict(dtype=m0.dtype, device=m0.device)
    us = torch.empty((c.n_save + 1, d, B), **new)
    stds = torch.empty((c.n_save + 1, d, B), **new)
    lls = torch.empty((B,), **new)
    counts = ea._new_counts(B, m0.device)
    _launch.launch(ek1d_adaptive, m0.device,
                   f"ek1d_adaptive_{field}_{_launch.suffix(m0.dtype)}",
                   m0.data_ptr(), ps.data_ptr(), dt0s.data_ptr(),
                   us.data_ptr(), stds.data_ptr(), lls.data_ptr(),
                   counts.data_ptr(), B, c.n_save, c.max_iters, c.host())
    return us, stds, lls, counts


ek1d_adaptive.launches = 0


def ek1d_adaptive_stream(f: Callable, jac_diag: Optional[Callable],
                         field: Optional[str], m0: torch.Tensor,
                         ps: torch.Tensor, dt0s: torch.Tensor,
                         c: ea.Controller):
    """The streaming forward: `ek1d_adaptive_stream_plain` on CPU tensors,
    the CUDA kernel ``ek1d_adaptive_stream_kernel`` on CUDA tensors."""
    if _launch.dispatch_device("ek1d_adaptive_stream", m0) == "cpu":
        return ek1d_adaptive_stream_plain(f, jac_diag, m0, ps, dt0s, c)
    _check("ek1d_adaptive_stream", field, m0, ps, dt0s)
    nq, d, B = m0.shape
    st = torch.empty((c.max_iters, stream_width(nq, d), B), dtype=m0.dtype,
                     device=m0.device)
    lls = torch.empty((B,), dtype=m0.dtype, device=m0.device)
    counts = ea._new_counts(B, m0.device)
    _launch.launch(ek1d_adaptive_stream, m0.device,
                   f"ek1d_adaptive_stream_{field}_{_launch.suffix(m0.dtype)}",
                   m0.data_ptr(), ps.data_ptr(), dt0s.data_ptr(),
                   st.data_ptr(), lls.data_ptr(), counts.data_ptr(), B,
                   c.n_save, c.max_iters, c.host())
    return st, lls, counts


ek1d_adaptive_stream.launches = 0


def ek1d_adaptive_smoother(st: torch.Tensor, counts: torch.Tensor,
                           m0: torch.Tensor, c: ea.Controller):
    """The backward pass: `ek1d_adaptive_smoother_plain` on CPU tensors, the
    CUDA kernel ``ek1d_adaptive_smoother_kernel`` on CUDA tensors."""
    if _launch.dispatch_device("ek1d_adaptive_smoother", st) == "cpu":
        return ek1d_adaptive_smoother_plain(st, counts, m0, c)
    nq, d, B = m0.shape
    ea.check_smoother_inputs("ek1d_adaptive_smoother", st, counts, m0, c,
                             stream_width(nq, d))
    us = torch.empty((c.n_save + 1, d, B), dtype=st.dtype, device=st.device)
    stds = torch.empty_like(us)
    _launch.launch(ek1d_adaptive_smoother, st.device,
                   f"ek1d_adaptive_smoother_{_launch.suffix(st.dtype)}",
                   st.data_ptr(), counts.data_ptr(), m0.data_ptr(),
                   us.data_ptr(), stds.data_ptr(), B, c.n_save, c.max_iters,
                   c.host())
    return us, stds


ek1d_adaptive_smoother.launches = 0


# ----------------------------------------------------------- entry points


def _controller(q, m0, t0, t1, n_save, *, abstol, reltol, max_iters, dtmin,
                prior, mesh, second_order):
    _launch.check_ported(prior=prior, second_order=second_order, mesh=mesh)
    return ea.controller(q, t0, t1, n_save, m0.dtype, abstol=abstol,
                         reltol=reltol, max_iters=max_iters, dtmin=dtmin)


def ek1d_adaptive_filter(
    f: Callable,
    jac_diag: Optional[Callable],
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
    """Adaptive per-member DiagonalEK1(dynamic) ensemble filter on the
    kernel ``ek1d_adaptive``; arguments as in
    `ek0_adaptive.ek0_adaptive_filter`, with ``jac_diag`` (None: d JVPs in
    the plain version). Returns ``(us, stds, lls, nacc, nrej, failed)``
    with per-dimension stds ``(S+1, d, B)``."""
    c = _controller(q, m0, t0, t1, n_save, abstol=abstol, reltol=reltol,
                    max_iters=max_iters, dtmin=dtmin, prior=prior, mesh=mesh,
                    second_order=second_order)
    us, stds, lls, counts = ek1d_adaptive(f, jac_diag, field, m0, ps,
                                          dt0s.contiguous(), c)
    return ea._solution(counts, us, stds, lls)


def ek1d_adaptive_fused_smooth(
    f: Callable,
    jac_diag: Optional[Callable],
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
    """Adaptive per-member DiagonalEK1(dynamic) filter + square-root RTS
    smoother on the kernels ``ek1d_adaptive_stream`` and
    ``ek1d_adaptive_smoother``; ``max_iters`` also sizes the stream
    (``max_iters`` rows of `stream_width` per member). Returns the
    smoothed ``(us, stds)`` (per-dimension stds) with the filter's
    ``lls``, ``nacc``, ``nrej`` and ``failed``."""
    c = _controller(q, m0, t0, t1, n_save, abstol=abstol, reltol=reltol,
                    max_iters=max_iters, dtmin=dtmin, prior=prior, mesh=mesh,
                    second_order=second_order)
    st, lls, counts = ek1d_adaptive_stream(f, jac_diag, field, m0, ps,
                                           dt0s.contiguous(), c)
    us, stds = ek1d_adaptive_smoother(st, counts, m0, c)
    return ea._solution(counts, us, stds, lls)


def solve_ensemble_ek1d_adaptive(
    prob_f: Callable, prob_jac_diag: Optional[Callable], u0s: torch.Tensor,
    ps: torch.Tensor, tspan, n_save: int, q: int = 3, abstol: float = 1e-6,
    reltol: float = 1e-3, max_iters: int = 100_000, prior=None, mesh=None,
    second_order: bool = False, *, field: Optional[str] = None,
):
    """Taylor init + `initial_dt` + the adaptive DiagonalEK1 filter over an
    ensemble: ``u0s`` ``(B, d)``, ``ps`` ``(B, n_params)``."""
    m0, ps_t, dt0s = ea._init(prob_f, u0s, ps, tspan, q, abstol, reltol)
    return ek1d_adaptive_filter(prob_f, prob_jac_diag, m0, ps_t, dt0s,
                                tspan[0], tspan[1], n_save, q, abstol=abstol,
                                reltol=reltol, max_iters=max_iters,
                                prior=prior, mesh=mesh,
                                second_order=second_order, field=field)


def solve_ensemble_ek1d_adaptive_smooth(
    prob_f: Callable, prob_jac_diag: Optional[Callable], u0s: torch.Tensor,
    ps: torch.Tensor, tspan, n_save: int, q: int = 3, abstol: float = 1e-6,
    reltol: float = 1e-3, max_iters: int = 1024, prior=None, mesh=None,
    second_order: bool = False, *, field: Optional[str] = None,
):
    """Taylor init + `initial_dt` + the adaptive DiagonalEK1 filter and
    smoother over an ensemble."""
    m0, ps_t, dt0s = ea._init(prob_f, u0s, ps, tspan, q, abstol, reltol)
    return ek1d_adaptive_fused_smooth(prob_f, prob_jac_diag, m0, ps_t, dt0s,
                                      tspan[0], tspan[1], n_save, q,
                                      abstol=abstol, reltol=reltol,
                                      max_iters=max_iters, prior=prior,
                                      mesh=mesh, second_order=second_order,
                                      field=field)
