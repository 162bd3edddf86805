"""Adaptive per-member dense EK1 ensemble solves: plain PyTorch versions and
the wrappers of the three CUDA kernels that replace the JAX package's
adaptive EK1 filter and its attempt-stream filter + RTS smoother pair.

======================================  ====================================
this module                             ``odefilters/ops/pallas_kernels.py``
======================================  ====================================
``attempt``                             one attempt of the loop body of
                                        ``_ek1_adaptive_kernel``
``smoother_step``                       one step of the loop body of
                                        ``_ek1_adaptive_smoother_kernel``
``ek1_adaptive_plain`` /                ``_ek1_adaptive_kernel`` (CUDA:
``ek1_adaptive``                        ``csrc/ek1_adaptive.cu::
                                        ek1_adaptive_kernel``)
``ek1_adaptive_stream_plain`` /         ``_ek1_adaptive_stream_kernel``
``ek1_adaptive_stream``                 (CUDA: ``ek1_adaptive_stream_kernel``)
``ek1_adaptive_smoother_plain`` /       ``_ek1_adaptive_smoother_kernel``
``ek1_adaptive_smoother``               (CUDA:
                                        ``ek1_adaptive_smoother_kernel``)
``ek1_adaptive_filter``                 ``ek1_adaptive_filter``
``ek1_adaptive_fused_smooth``           ``ek1_adaptive_fused_smooth``
``solve_ensemble_ek1_adaptive``         ``solve_ensemble_ek1_adaptive_pallas``
``solve_ensemble_ek1_adaptive_smooth``  ``solve_ensemble_ek1_adaptive_smooth_
                                        pallas``
``solve_adaptive_single``               ``solve_adaptive_pallas_single``
======================================  ====================================

Each member runs the adaptive EK0 solve's loop (`ek0_adaptive`: its
`Controller`, `begin`, `control`, `Members`, the save grid without a
barrier, the compacted stream) with the fixed-grid EK1 step
(`ek1_fused.ek1_step`, the square-root EKF with the field's Jacobian) at
each attempt's preconditioner. The state is flat and derivative-major (``D
= d (q+1)``: entry r is derivative ``r // d`` of dimension ``r % d``) and
unpreconditioned; the covariance is carried as a ``D x D`` factor ``L``
(``C = L L^T``, not triangular), as in the JAX kernels, so preconditioning
scales its rows only: the JAX kernel's comment records that scaling the
factor's columns too shrank the stds about 1e-5x over ~100 steps. The
error estimate is ``dt sqrt(s2 (H Q H^T)_jj)`` per dimension, the
log-likelihood ``log N(z; 0, H Lp Lp^T H^T)``.

The stream holds each member's accepted steps only (the JAX forward streams
one row per block attempt), at row ``nacc - 1`` of a ``(max_iters, W, B)``
stream (B contiguous): ``[m (D) | L (D*D, row-major) | log dt_eff | s2 |
save index]``, W = 75 at q = 3, d = 2. The backward step recomputes the
interval's predicted factor by the forward's 2D x D Gram-Schmidt in the
frame preconditioned at the next accepted step's size, the gain by
Cholesky solves against it and the smoothed factor by a 3D x D
Gram-Schmidt, using the streamed factor directly (no re-factorisation).

The plain versions run every member at once on lists of ``(B,)`` tensors,
with per-member masks in place of the kernels' per-thread control flow, in
the kernels' order of operations, at any order q (the kernels are built
for q = 3). Dispatch: each wrapper runs its plain version on CPU tensors,
launches its CUDA kernel on CUDA tensors, raises on any other device, and
counts its launches in ``.launches``. The second-order and Chebyshev-prior
branches of the JAX kernels are not ported (ROADMAP.md queue 1, item 5) and
raise.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from odefilters_torch.ops import _launch
from odefilters_torch.ops import ek0_adaptive as ea
from odefilters_torch.ops.ek1_fused import (
    _backward_shared, _sum, auto_jac, ek1_step, kron_lists, predict_lp,
)
from odefilters_torch.ops.ek0_sample import list_mgs_tril, matmul_lists, t_rows
from odefilters_torch.ops.ek1d_adaptive import solve_ensemble_ek1d_adaptive


def stream_width(nq: int, d: int) -> int:
    """Width of an accepted-step stream row (75 at q = 3, d = 2)."""
    D = nq * d
    return D + D * D + 3


def start(m0: torch.Tensor, dt0s: torch.Tensor, c: ea.Controller) -> ea.Members:
    """The loop state of `ek0_adaptive.Members` with ``L`` a zero ``D x D``
    factor (``m`` stays ``nq x d``: entry ``[i][j]`` is flat entry
    ``i d + j``)."""
    st = ea.Members.start(m0, dt0s, c.t0)
    D = m0.shape[0] * m0.shape[1]
    zero = torch.zeros_like(dt0s)
    st.L = [[zero] * D for _ in range(D)]
    return st


def attempt(st: ea.Members, p, *, f: Callable, jac: Callable,
            c: ea.Controller, live: torch.Tensor) -> dict:
    """One attempt of every ``live`` member (the others change nothing):
    precondition at the attempt's step (the factor's rows only), one
    square-root EK1(dynamic) step, then `ek0_adaptive.control`, in the order
    of the JAX kernel's loop body. Updates ``st`` in place and returns what
    `ek0_adaptive.attempt` returns."""
    nq, d = len(st.m), len(st.m[0])
    D = nq * d
    q_half = nq - 1 + 0.5
    a = ea.begin(st, c, live)
    lh, ps_ = a["lh"], a["ps_"]
    mh = [st.m[r // d][r % d] * ps_[r // d] for r in range(D)]
    Lh = [[st.L[r][k] * ps_[r // d] for k in range(D)] for r in range(D)]
    pinv0 = torch.exp(q_half * lh)
    pinv1 = torch.exp((q_half - 1.0) * lh)
    m_new, L_new, s2, hqh, ll_inc = ek1_step(
        mh, Lh, p, a["t_new"], f=f, jac=jac, Af=kron_lists(c.At, d),
        QLf=kron_lists(c.QLt, d), pinv0=pinv0, pinv1=pinv1, d=d, D=D,
        want_stats=True)
    u_filt = [pinv0 * m_new[j] for j in range(d)]
    # -- error estimate: err_j = dt sqrt(s2 (H Q H^T)_jj) / sc_j --
    errs = [torch.sqrt(torch.clamp(s2 * hqh[j], min=0.0)) for j in range(d)]
    accept, reached = ea.control(
        st, c, a, errs=errs, u_filt=u_filt,
        m_new=[[m_new[i * d + j] for j in range(d)] for i in range(nq)],
        ll_inc=ll_inc)
    st.L = [[torch.where(accept, L_new[r][k] / ps_[r // d], st.L[r][k])
             for k in range(D)] for r in range(D)]
    return dict(accept=accept, lh=lh, s2=s2, reached=reached,
                seg_before=a["seg"])


def _stds(L, d: int):
    """Each dimension's std of block 0: ``(d, B)``, the norms of the
    factor's first d rows."""
    return torch.stack([torch.sqrt(_sum([x * x for x in L[j]]))
                        for j in range(d)])


def _forward(f, jac, m0, ps, dt0s, c, on_attempt):
    jac = auto_jac(f) if jac is None else jac
    return ea.run(start(m0, dt0s, c), c,
                  lambda st, live: attempt(st, ps, f=f, jac=jac, c=c,
                                           live=live),
                  on_attempt)


def ek1_adaptive_plain(f: Callable, jac: Optional[Callable],
                       m0: torch.Tensor, ps: torch.Tensor, dt0s: torch.Tensor,
                       c: ea.Controller):
    """The adaptive filter from unpreconditioned initial means ``m0``
    ``(nq, d, B)``, parameters ``ps`` ``(n_params, B)`` and initial steps
    ``dt0s`` ``(B,)``: ``(us (S+1, d, B), stds (S+1, d, B), lls (B,),
    counts (N_COUNTS, B))``. Row 0 is the exact initial state with std 0;
    row k the filtered mean of block 0 and each dimension's std at save
    point k. ``jac=None`` derives the Jacobian from JVP columns."""
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
            stds[k, :, idx] = _stds(st.L, d)[:, idx].T

    st = _forward(f, jac, m0, ps, dt0s, c, emit)
    final = _stds(st.L, d)
    for j in range(d):
        ea._fill_tail(us[:, j], st.seg, st.m[0][j])
        ea._fill_tail(stds[:, j], st.seg, final[j])
    return us, stds, st.ll, ea._counts(st, c)


def ek1_adaptive_stream_plain(f: Callable, jac: Optional[Callable],
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
        vals = ([x for mi in st.m for x in mi] + [x for Lr in st.L for x in Lr]
                + [out["lh"], out["s2"], mark.to(m0.dtype)])
        st_out[st.nacc[idx] - 1, :, idx] = torch.stack(vals)[:, idx].T

    st = _forward(f, jac, m0, ps, dt0s, c, emit)
    return st_out, st.ll, ea._counts(st, c)


def smoother_step(m_f, L_f, ms, Ls, lh, s2, *, Af, QLf, nq: int, d: int):
    """One square-root RTS step from the filtered state ``(m_f, L_f)`` of
    an accepted step (D-vector, D x D factor) to the smoothed ``(ms, Ls)``
    of the next one, with the next step's ``lh`` (log dt_eff) and ``s2``,
    in the frame preconditioned at the next step's size (rows scaled).
    Returns the unpreconditioned ``(ms, Ls)``."""
    D = nq * d
    q_half = nq - 1 + 0.5
    ps_ = [torch.exp((i - q_half) * lh) for i in range(nq)]
    mh = [m_f[r] * ps_[r // d] for r in range(D)]
    Lh = [[L_f[r][k] * ps_[r // d] for k in range(D)] for r in range(D)]
    sq = torch.sqrt(torch.clamp(s2, min=0.0))
    Lp = predict_lp(Af, QLf, Lh, sq, D)
    G, mp, b1, GQ = _backward_shared(mh, Lh, Lp, sq, Af=Af, QLf=QLf, D=D)
    dm = [ms[r] * ps_[r // d] - mp[r] for r in range(D)]
    ms_new = [mh[r] + _sum([G[r][l] * dm[l] for l in range(D)])
              for r in range(D)]
    Lsh = [[ps_[r // d] * Ls[r][k] for k in range(D)] for r in range(D)]
    b3 = matmul_lists(G, Lsh, D)
    Ls_new = list_mgs_tril(t_rows(b1, D) + t_rows(GQ, D) + t_rows(b3, D),
                           3 * D, D)
    pinv_ = [torch.exp((q_half - r // d) * lh) for r in range(D)]
    return ([pinv_[r] * ms_new[r] for r in range(D)],
            [[pinv_[r] * Ls_new[r][k] for k in range(D)] for r in range(D)])


def _unpack(row, D: int):
    """``(m, L, lh, s2, save index)`` of a stream row."""
    m = [row[r] for r in range(D)]
    L = [[row[D + r * D + k] for k in range(D)] for r in range(D)]
    o = D + D * D
    return m, L, row[o], row[o + 1], row[o + 2]


def ek1_adaptive_smoother_plain(st: torch.Tensor, counts: torch.Tensor,
                                m0: torch.Tensor, c: ea.Controller):
    """The backward pass over each member's accepted steps: the smoothed
    means of block 0 and each dimension's stds, ``(S+1, d, B)`` each, from
    the stream ``st`` and ``counts`` of `ek1_adaptive_stream_plain` and the
    initial means ``m0``. Row 0 is the exact initial state with std 0."""
    nq, d, B = m0.shape
    D = nq * d
    kw = dict(Af=kron_lists(c.At, d), QLf=kron_lists(c.QLt, d), nq=nq, d=d)
    us = torch.empty((c.n_save + 1, d, B), dtype=m0.dtype, device=m0.device)
    stds = torch.empty_like(us)
    us[0] = m0[0]
    stds[0] = 0.0
    zero = torch.zeros_like(m0[0, 0])
    ea.walk_back(
        st, counts, (us, stds),
        ([m0[r // d, r % d] for r in range(D)], [[zero] * D for _ in range(D)]),
        unpack=lambda row: _unpack(row, D),
        start=lambda k, row: row[:2],
        step=lambda k, row, carry, lh, s2: smoother_step(
            row[0], row[1], *carry, lh, s2, **kw),
        value=lambda carry: (torch.stack(carry[0][:d]), _stds(carry[1], d)))
    return us, stds


# --------------------------------------------------------------- wrappers


def _check(name: str, field, m0, ps, dt0s):
    nq, d, B = m0.shape
    _launch.check_field(name, field, nq, d, B, ps, need_jac=True)
    if tuple(dt0s.shape) != (B,):
        raise ValueError(f"{name}: dt0s must be ({B},), got {tuple(dt0s.shape)}")
    _launch.check_cuda_inputs(name, {"m0": m0, "ps": ps, "dt0s": dt0s},
                              m0.dtype)


def ek1_adaptive(f: Callable, jac: Optional[Callable], field: Optional[str],
                 m0: torch.Tensor, ps: torch.Tensor, dt0s: torch.Tensor,
                 c: ea.Controller):
    """The adaptive filter: `ek1_adaptive_plain` on CPU tensors, the CUDA
    kernel ``ek1_adaptive_kernel`` on CUDA tensors (vector field ``field``,
    with its own Jacobian)."""
    if _launch.dispatch_device("ek1_adaptive", m0) == "cpu":
        return ek1_adaptive_plain(f, jac, m0, ps, dt0s, c)
    _check("ek1_adaptive", field, m0, ps, dt0s)
    nq, d, B = m0.shape
    new = dict(dtype=m0.dtype, device=m0.device)
    us = torch.empty((c.n_save + 1, d, B), **new)
    stds = torch.empty((c.n_save + 1, d, B), **new)
    lls = torch.empty((B,), **new)
    counts = ea._new_counts(B, m0.device)
    _launch.launch(ek1_adaptive, m0.device,
                   f"ek1_adaptive_{field}_{_launch.suffix(m0.dtype)}",
                   m0.data_ptr(), ps.data_ptr(), dt0s.data_ptr(),
                   us.data_ptr(), stds.data_ptr(), lls.data_ptr(),
                   counts.data_ptr(), B, c.n_save, c.max_iters, c.host())
    return us, stds, lls, counts


ek1_adaptive.launches = 0


def ek1_adaptive_stream(f: Callable, jac: Optional[Callable],
                        field: Optional[str], m0: torch.Tensor,
                        ps: torch.Tensor, dt0s: torch.Tensor,
                        c: ea.Controller):
    """The streaming forward: `ek1_adaptive_stream_plain` on CPU tensors,
    the CUDA kernel ``ek1_adaptive_stream_kernel`` on CUDA tensors."""
    if _launch.dispatch_device("ek1_adaptive_stream", m0) == "cpu":
        return ek1_adaptive_stream_plain(f, jac, m0, ps, dt0s, c)
    _check("ek1_adaptive_stream", field, m0, ps, dt0s)
    nq, d, B = m0.shape
    st = torch.empty((c.max_iters, stream_width(nq, d), B), dtype=m0.dtype,
                     device=m0.device)
    lls = torch.empty((B,), dtype=m0.dtype, device=m0.device)
    counts = ea._new_counts(B, m0.device)
    _launch.launch(ek1_adaptive_stream, m0.device,
                   f"ek1_adaptive_stream_{field}_{_launch.suffix(m0.dtype)}",
                   m0.data_ptr(), ps.data_ptr(), dt0s.data_ptr(),
                   st.data_ptr(), lls.data_ptr(), counts.data_ptr(), B,
                   c.n_save, c.max_iters, c.host())
    return st, lls, counts


ek1_adaptive_stream.launches = 0


def ek1_adaptive_smoother(st: torch.Tensor, counts: torch.Tensor,
                          m0: torch.Tensor, c: ea.Controller):
    """The backward pass: `ek1_adaptive_smoother_plain` on CPU tensors, the
    CUDA kernel ``ek1_adaptive_smoother_kernel`` on CUDA tensors."""
    if _launch.dispatch_device("ek1_adaptive_smoother", st) == "cpu":
        return ek1_adaptive_smoother_plain(st, counts, m0, c)
    nq, d, B = m0.shape
    ea.check_smoother_inputs("ek1_adaptive_smoother", st, counts, m0, c,
                             stream_width(nq, d))
    us = torch.empty((c.n_save + 1, d, B), dtype=st.dtype, device=st.device)
    stds = torch.empty_like(us)
    _launch.launch(ek1_adaptive_smoother, st.device,
                   f"ek1_adaptive_smoother_{_launch.suffix(st.dtype)}",
                   st.data_ptr(), counts.data_ptr(), m0.data_ptr(),
                   us.data_ptr(), stds.data_ptr(), B, c.n_save, c.max_iters,
                   c.host())
    return us, stds


ek1_adaptive_smoother.launches = 0


# ----------------------------------------------------------- entry points


def _controller(q, m0, t0, t1, n_save, *, abstol, reltol, max_iters, dtmin,
                prior, mesh, second_order):
    _launch.check_ported(prior=prior, second_order=second_order, mesh=mesh)
    return ea.controller(q, t0, t1, n_save, m0.dtype, abstol=abstol,
                         reltol=reltol, max_iters=max_iters, dtmin=dtmin)


def ek1_adaptive_filter(
    f: Callable,
    jac: Optional[Callable],
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
    """Adaptive per-member EK1(dynamic) ensemble filter on the kernel
    ``ek1_adaptive``; arguments as in `ek0_adaptive.ek0_adaptive_filter`,
    with ``jac`` (None: JVP columns in the plain version; the kernel
    evaluates the CUDA field's). Returns ``(us, stds, lls, nacc, nrej,
    failed)`` with per-dimension stds ``(S+1, d, B)``."""
    c = _controller(q, m0, t0, t1, n_save, abstol=abstol, reltol=reltol,
                    max_iters=max_iters, dtmin=dtmin, prior=prior, mesh=mesh,
                    second_order=second_order)
    us, stds, lls, counts = ek1_adaptive(f, jac, field, m0, ps,
                                         dt0s.contiguous(), c)
    return ea._solution(counts, us, stds, lls)


def ek1_adaptive_fused_smooth(
    f: Callable,
    jac: Optional[Callable],
    m0: torch.Tensor,
    ps: torch.Tensor,
    dt0s: torch.Tensor,
    t0: float,
    t1: float,
    n_save: int,
    q: int,
    abstol: float = 1e-6,
    reltol: float = 1e-3,
    max_iters: int = 512,
    dtmin: Optional[float] = None,
    prior=None,
    mesh=None,
    second_order: bool = False,
    *,
    field: Optional[str] = None,
):
    """Adaptive per-member EK1(dynamic) filter + square-root RTS smoother
    (the reference's default configuration: EK1, adaptive, smoothed) on the
    kernels ``ek1_adaptive_stream`` and ``ek1_adaptive_smoother``;
    ``max_iters`` also sizes the stream (``max_iters`` rows of
    `stream_width` per member). Returns the smoothed ``(us, stds)``
    (per-dimension stds) with the filter's ``lls``, ``nacc``, ``nrej`` and
    ``failed``."""
    c = _controller(q, m0, t0, t1, n_save, abstol=abstol, reltol=reltol,
                    max_iters=max_iters, dtmin=dtmin, prior=prior, mesh=mesh,
                    second_order=second_order)
    st, lls, counts = ek1_adaptive_stream(f, jac, field, m0, ps,
                                          dt0s.contiguous(), c)
    us, stds = ek1_adaptive_smoother(st, counts, m0, c)
    return ea._solution(counts, us, stds, lls)


def solve_ensemble_ek1_adaptive(
    prob_f: Callable, prob_jac: Optional[Callable], u0s: torch.Tensor,
    ps: torch.Tensor, tspan, n_save: int, q: int = 3, abstol: float = 1e-6,
    reltol: float = 1e-3, max_iters: int = 100_000, prior=None, mesh=None,
    second_order: bool = False, *, field: Optional[str] = None,
):
    """Taylor init + `initial_dt` + the adaptive EK1 filter over an
    ensemble: ``u0s`` ``(B, d)``, ``ps`` ``(B, n_params)``."""
    m0, ps_t, dt0s = ea._init(prob_f, u0s, ps, tspan, q, abstol, reltol)
    return ek1_adaptive_filter(prob_f, prob_jac, m0, ps_t, dt0s, tspan[0],
                               tspan[1], n_save, q, abstol=abstol,
                               reltol=reltol, max_iters=max_iters,
                               prior=prior, mesh=mesh,
                               second_order=second_order, field=field)


def solve_ensemble_ek1_adaptive_smooth(
    prob_f: Callable, prob_jac: Optional[Callable], u0s: torch.Tensor,
    ps: torch.Tensor, tspan, n_save: int, q: int = 3, abstol: float = 1e-6,
    reltol: float = 1e-3, max_iters: int = 512, prior=None, mesh=None,
    second_order: bool = False, *, field: Optional[str] = None,
):
    """Taylor init + `initial_dt` + the adaptive EK1 filter and smoother
    over an ensemble."""
    m0, ps_t, dt0s = ea._init(prob_f, u0s, ps, tspan, q, abstol, reltol)
    return ek1_adaptive_fused_smooth(prob_f, prob_jac, m0, ps_t, dt0s,
                                     tspan[0], tspan[1], n_save, q,
                                     abstol=abstol, reltol=reltol,
                                     max_iters=max_iters, prior=prior,
                                     mesh=mesh, second_order=second_order,
                                     field=field)


def runnable_order(q: int, device: torch.device,
                   kernel: str = "ek0_adaptive") -> int:
    """The order `solve_adaptive_single` runs for order ``q`` on ``device``
    with the adaptive filter ``kernel`` (``"ek0_adaptive"``, the warm
    start's, by default; ``"ek1_adaptive"``, ``"ek1d_adaptive"``): ``q`` on
    the CPU and wherever the kernel is built for it; else, on the card, the
    largest order it is built for (``_launch.kernel_orders``; ROADMAP.md
    queue 1, item 5)."""
    orders = _launch.kernel_orders(kernel)
    if device.type == "cuda" and q not in orders:
        return max(orders)
    return q


def solve_adaptive_single(
    prob_f: Callable,
    u0: torch.Tensor,
    p: torch.Tensor,
    tspan,
    n_save: int,
    q: int = 3,
    abstol: float = 1e-6,
    reltol: float = 1e-3,
    max_iters: int = 100_000,
    jac: Optional[Callable] = None,
    ek1: bool = False,
    diagonal_ek1: bool = False,
    jac_diag: Optional[Callable] = None,
    second_order: bool = False,
    *,
    field: Optional[str] = None,
):
    """One adaptive filter solve on the per-member kernels: an ensemble of
    one member (the JAX package broadcasts the problem over a 1024-lane
    block; here no block exists). ``ek1`` / ``diagonal_ek1`` select the
    linearization (EK0 otherwise). Returns ``(us (S+1, d), stds, ll, nacc,
    nrej, failed)`` on the save grid; ``stds`` is ``(S+1,)`` from EK0 and
    ``(S+1, d)`` from EK1 and DiagonalEK1."""
    if ek1 and diagonal_ek1:
        raise ValueError("pass ek1=True OR diagonal_ek1=True, not both")
    kw = dict(q=q, abstol=abstol, reltol=reltol, max_iters=max_iters,
              second_order=second_order, field=field)
    u0s, ps = u0[None], p[None]
    if ek1:
        out = solve_ensemble_ek1_adaptive(prob_f, jac, u0s, ps, tspan, n_save,
                                          **kw)
    elif diagonal_ek1:
        out = solve_ensemble_ek1d_adaptive(prob_f, jac_diag, u0s, ps, tspan,
                                           n_save, **kw)
    else:
        out = ea.solve_ensemble_ek0_adaptive(prob_f, u0s, ps, tspan, n_save,
                                             **kw)
    return tuple(x[..., 0] for x in out)
