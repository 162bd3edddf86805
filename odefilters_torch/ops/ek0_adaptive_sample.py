"""Joint posterior samples of adaptive EK0 ensemble solves: the plain
PyTorch version and the wrapper of the CUDA kernel that replaces the JAX
package's backward conditioning sampler over the adaptive stream.

====================================  ======================================
this module                           ``odefilters/ops/pallas_kernels.py``
====================================  ======================================
``list_cholesky``                     ``_list_cholesky`` (structural-zero
                                      row)
``terminal_draw``                     the draw at the final row of
                                      ``_ek0_adaptive_sampler_kernel``
``sampler_step``                      one step of its loop body
``ek0_adaptive_sampler_plain`` /      ``_ek0_adaptive_sampler_kernel``
``ek0_adaptive_sampler``              (CUDA: ``csrc/ek0_adaptive.cu::
                                      ek0_adaptive_sampler_kernel``)
``ek0_adaptive_fused_sample``         ``ek0_adaptive_fused_sample``
``sample_ensemble_ek0_adaptive``      ``sample_ensemble_adaptive_pallas``
====================================  ======================================

The forward is the adaptive EK0 stream kernel (`ek0_adaptive`): each
member's accepted steps, one row each, ``[m | L | log dt_eff | s2 | save
index]`` with ``L`` a factor of the filtered covariance. The sampler walks
each member's rows ``nacc - 1 .. 0``: at the last accepted step it draws
``x = m + pinv chol0(P L L^T P) z`` (``P`` the preconditioner at that
step's ``log dt_eff``, ``chol0`` the Cholesky factor with the measured
block structurally zero, `list_cholesky`); at each earlier step it
conditions the S carried samples on the filtered state, in the frame
preconditioned at the *next* accepted step's ``log dt_eff`` and ``s2``, and
re-draws them from the conditional factor (the smoothing stack without its
``G L_s`` block): ``x = pinv ((mh_f + G (x P - mp)) + L_c z)``, ordered as
the smoother's mean recursion (`ek0_adaptive.smoother_step`), so zero
normals give the smoothed means bit for bit. At each row that reached a
save point it writes the samples' solution block there.

**Departures from the JAX kernels.** Their normals ``(max_iters, S, q+1, d,
B)`` are indexed by the block's attempt row, which depends on the 1024-lane
barrier the port dropped. Here row ``k`` of the normals belongs to the
member's ``k``-th accepted step (0-based): the terminal draw takes row
``nacc - 1``, the step from accepted row ``k`` row ``k``. Both packages
consume the same numbers when the normals are constant along the row axis.
The JAX terminal draw factors the streamed plain covariance at the
member's current ``log dt``; the port's row holds a factor that is not
triangular (``m + L z`` would be another draw from the same normals) and
only ``log dt_eff``, so it factors the Gram ``(P L)(P L)^T`` with the same
structural-zero Cholesky at ``log dt_eff``: the preconditioner cancels
(``pinv chol(P C P) = chol(C)``) up to rounding. A guarded Gram-Schmidt
factor would not do: the factor's measured row is rounding noise, about
1e-16 of its scale, and a guarded pivot turns it into an arbitrary
direction.

The plain sampler carries the S samples as a leading axis of each entry
(``(S, B)`` tensors). Dispatch: the wrapper runs the plain version on CPU
tensors, launches the CUDA kernel on CUDA tensors, raises on any other
device, and counts its launches in ``.launches``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from odefilters_torch.ops import _launch
from odefilters_torch.ops import ek0_adaptive as ea
from odefilters_torch.ops._blocks import _lists, _smul, _sreduce
from odefilters_torch.ops.ek0_sample import BX, list_mgs_tril, t_rows


def list_cholesky(C, nq: int, zero_row: int):
    """Lower Cholesky factor of the symmetric ``nq x nq`` list block ``C``
    with row and column ``zero_row`` structurally zero (Python 0.0 entries,
    every term through them skipped): pivots ``sqrt(max(s, 1e-30))``, the
    entries below times their reciprocals. Reads ``C[i][i]`` and ``C[l][i]``
    for ``l > i`` only."""
    L = [[0.0] * nq for _ in range(nq)]
    for i in range(nq):
        if i == zero_row:
            continue
        s = C[i][i]
        for k in range(i):
            s = s - _smul(L[i][k], L[i][k])
        L[i][i] = torch.sqrt(torch.clamp(s, min=1e-30))
        inv = 1.0 / L[i][i]
        for l in range(i + 1, nq):
            if l == zero_row:
                continue
            v = C[l][i]
            for k in range(i):
                v = v - _smul(L[l][k], L[i][k])
            L[l][i] = _smul(v, inv)
    return L


def terminal_draw(m, L, lh, z, *, nq: int, d: int):
    """The draw at a member's last accepted step ``(m, L, lh)``:
    ``x = m + pinv chol0(P L L^T P) z``; ``z``: nq x d lists of ``(S, B)``
    normals."""
    q_half = nq - 1 + 0.5
    ps_ = [torch.exp((i - q_half) * lh) for i in range(nq)]
    Lh = [[L[i][l] * ps_[i] for l in range(nq)] for i in range(nq)]
    C = [[None] * nq for _ in range(nq)]
    for i in range(nq):
        for l in range(i, nq):
            C[l][i] = _sreduce([Lh[l][b] * Lh[i][b] for b in range(nq)])
    Lc = list_cholesky(C, nq, zero_row=BX)
    return [[m[i][j] + torch.exp((q_half - i) * lh)
             * _sreduce([_smul(Lc[i][l], z[l][j]) for l in range(nq)])
             for j in range(d)] for i in range(nq)]


def sampler_step(m_f, L_f, xs, z, lh, s2, *, At, QLt, nq: int, d: int):
    """One backward conditioning step: the samples ``xs`` drawn at the next
    accepted step, conditioned on the filtered state ``(m_f, L_f)`` in the
    frame preconditioned at the next step's ``lh`` with its ``s2``, and
    re-drawn with the normals ``z`` (``xs``, ``z``: nq x d lists of ``(S,
    B)`` tensors; the gain and factor work is ``(B,)``, shared by the S
    samples). Returns the unpreconditioned samples."""
    q_half = nq - 1 + 0.5
    sh = ea.backward_shared(m_f, L_f, lh, s2, At=At, QLt=QLt, nq=nq, d=d)
    L_c = list_mgs_tril(t_rows(sh["b1"], nq) + t_rows(sh["GQ"], nq), 2 * nq,
                        nq)
    mean = ea.conditioned_mean(sh, xs, nq, d)
    return [[torch.exp((q_half - i) * lh)
             * (mean[i][j]
                + _sreduce([L_c[i][l] * z[l][j] for l in range(i + 1)]))
             for j in range(d)] for i in range(nq)]


def ek0_adaptive_sampler_plain(st: torch.Tensor, counts: torch.Tensor,
                               m0: torch.Tensor, normals: torch.Tensor,
                               c: ea.Controller) -> torch.Tensor:
    """Joint posterior samples ``(S+1, n_samples, d, B)`` on the save grid
    from the stream ``st`` and ``counts`` of
    `ek0_adaptive.ek0_adaptive_stream_plain`, the initial means ``m0`` and
    standard normals ``(max_iters, n_samples, nq, d, B)`` (row k for the
    member's k-th accepted step). Row 0 is the exact initial state; the
    save rows past those a failed member reached hold its terminal draw."""
    nq, d, B = m0.shape
    n_smp = normals.shape[1]
    kw = dict(At=_lists(c.At), QLt=_lists(c.QLt), nq=nq, d=d)
    out = torch.empty((c.n_save + 1, n_smp, d, B), dtype=m0.dtype,
                      device=m0.device)
    out[0] = m0[0]

    def zs(k):
        return [[normals[k, :, l, j] for j in range(d)] for l in range(nq)]

    ea.walk_back(
        st, counts, (out,),
        [[m0[i, j].expand(n_smp, B) for j in range(d)] for i in range(nq)],
        unpack=lambda row: ea._unpack(row, nq, d),
        start=lambda k, row: terminal_draw(row[0], row[1], row[2], zs(k),
                                           nq=nq, d=d),
        step=lambda k, row, xs, lh, s2: sampler_step(row[0], row[1], xs,
                                                     zs(k), lh, s2, **kw),
        value=lambda xs: (torch.stack(xs[0], dim=1),))
    return out


def _check_normals(name: str, normals: torch.Tensor, c: ea.Controller, nq: int,
                   d: int, B: int) -> None:
    if (normals.ndim != 5 or normals.shape[0] != c.max_iters
            or tuple(normals.shape[2:]) != (nq, d, B)):
        raise ValueError(
            f"{name}: normals must have shape {(c.max_iters, 'S', nq, d, B)}, "
            f"got {tuple(normals.shape)}"
        )


def ek0_adaptive_sampler(st: torch.Tensor, counts: torch.Tensor,
                         m0: torch.Tensor, normals: torch.Tensor,
                         c: ea.Controller) -> torch.Tensor:
    """The backward sampler: `ek0_adaptive_sampler_plain` on CPU tensors,
    the CUDA kernel ``ek0_adaptive_sampler_kernel`` on CUDA tensors."""
    if _launch.dispatch_device("ek0_adaptive_sampler", st) == "cpu":
        return ek0_adaptive_sampler_plain(st, counts, m0, normals, c)
    nq, d, B = m0.shape
    ea.check_smoother_inputs("ek0_adaptive_sampler", st, counts, m0, c,
                             ea.stream_width(nq, d))
    _check_normals("ek0_adaptive_sampler", normals, c, nq, d, B)
    _launch.check_cuda_inputs("ek0_adaptive_sampler",
                              {"st": st, "normals": normals}, st.dtype)
    n_smp = normals.shape[1]
    out = torch.empty((c.n_save + 1, n_smp, d, B), dtype=st.dtype,
                      device=st.device)
    _launch.launch(ek0_adaptive_sampler, st.device,
                   f"ek0_adaptive_sampler_{_launch.suffix(st.dtype)}",
                   st.data_ptr(), counts.data_ptr(), m0.data_ptr(),
                   normals.data_ptr(), out.data_ptr(), B, n_smp, c.n_save,
                   c.max_iters, c.host())
    return out


ek0_adaptive_sampler.launches = 0


def ek0_adaptive_fused_sample(
    f: Callable,
    m0: torch.Tensor,
    ps: torch.Tensor,
    dt0s: torch.Tensor,
    normals: torch.Tensor,
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
    """Joint smoothing-posterior sample paths of adaptive EK0 solves: the
    adaptive stream kernel (`ek0_adaptive.ek0_adaptive_stream`) and the
    backward sampler kernel over each member's accepted steps; any B >= 1.

    ``m0``: ``(q+1, d, B)`` unpreconditioned Taylor initial means; ``ps``:
    ``(n_params, B)``; ``dt0s``: ``(B,)`` initial steps; ``normals``:
    ``(max_iters, n_samples, q+1, d, B)`` i.i.d. standard normals, row k
    for each member's k-th accepted step (the JAX kernel indexes them by
    its block's attempt row; module docstring). Returns ``(us, lls, nacc,
    nrej, failed)`` with ``us`` ``(n_save+1, n_samples, d, B)``; zero
    normals give the smoothed means of `ek0_adaptive_fused_smooth`."""
    _launch.check_ported(prior=prior, second_order=second_order, mesh=mesh)
    c = ea.controller(q, t0, t1, n_save, m0.dtype, abstol=abstol,
                      reltol=reltol, max_iters=max_iters, dtmin=dtmin)
    nq, d, B = m0.shape
    _check_normals("ek0_adaptive_fused_sample", normals, c, nq, d, B)
    st, lls, counts = ea.ek0_adaptive_stream(f, field, m0, ps,
                                             dt0s.contiguous(), c)
    us = ek0_adaptive_sampler(st, counts, m0,
                              normals.to(m0.dtype).contiguous(), c)
    return ea._solution(counts, us, lls)


def sample_ensemble_ek0_adaptive(
    prob_f: Callable,
    u0s: torch.Tensor,
    ps: torch.Tensor,
    tspan,
    n_save: int,
    generator: torch.Generator,
    q: int = 3,
    n_samples: int = 1,
    abstol: float = 1e-6,
    reltol: float = 1e-3,
    max_iters: int = 1024,
    prior=None,
    mesh=None,
    second_order: bool = False,
    *,
    field: Optional[str] = None,
):
    """Taylor init + `initial_dt` + standard normals drawn from
    ``generator`` on the tensors' device + `ek0_adaptive_fused_sample`:
    ``u0s`` ``(B, d)``, ``ps`` ``(B, n_params)``. Returns ``(us, lls,
    nacc, nrej, failed)`` with ``us`` ``(n_save+1, d, B)`` for
    ``n_samples=1``, else ``(n_save+1, n_samples, d, B)``."""
    m0, ps_t, dt0s = ea._init(prob_f, u0s, ps, tspan, q, abstol, reltol)
    _, d, B = m0.shape
    normals = torch.randn((int(max_iters), int(n_samples), q + 1, d, B),
                          generator=generator, dtype=m0.dtype, device=m0.device)
    us, *rest = ek0_adaptive_fused_sample(
        prob_f, m0, ps_t, dt0s, normals, tspan[0], tspan[1], n_save, q,
        abstol=abstol, reltol=reltol, max_iters=max_iters, prior=prior,
        mesh=mesh, second_order=second_order, field=field)
    return (us[:, 0] if int(n_samples) == 1 else us, *rest)
