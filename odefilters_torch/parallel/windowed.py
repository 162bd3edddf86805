"""Windowed iterated time-parallel ODE filtering and smoothing (counterpart
of ``odefilters/parallel/windowed.py``).

The global solve relinearizes the whole trajectory every sweep; for EK0
that is a Picard map whose contraction constant grows with the span, and
over FitzHugh-Nagumo's t in [0, 20] it diverges. Here the N uniform steps
are split into W windows of M = N / W steps, run one after the other:

1. within a window the linearization iterates with the incoming filtered
   state held fixed, a contraction over (t1 - t0) / W;
2. inside the window the square-root associative scans run in parallel
   (the fused CUDA scans at M >= 1024 on the card);
3. each window keeps its cumulative map-to-terminal smoothing elements
   ``x^s_j = gc_j + Ec_j x^s_term`` (a reverse scan of the RTS gains), and
   a backward pass over the windows applies each incoming smoothed
   boundary state to them, which is exact fixed-interval smoothing.

Calibration is the global path's: one static MLE diffusion from the last
linearization's innovations, summed window by window.
"""

from __future__ import annotations

import torch

from odefilters_torch.linalg import matmul_unrolled as _bmm
from odefilters_torch.linalg import solve_triangular_unrolled
from odefilters_torch.linalg import tril_factor_mgs as tril_factor
from odefilters_torch.parallel.associative import _outputs, _setup
from odefilters_torch.parallel.associative_sqrt import (
    _scan,
    _sqrt_smooth_combine,
    parallel_filter_sqrt,
    smoother_gains,
)


def _T(x):
    return x.transpose(-1, -2)


def solve_windowed(prob, alg, ts, n_windows: int, iterations: int, u_init,
                   block):
    """The windowed solve of ``n_windows`` windows on the uniform grid
    ``ts``, ``iterations`` sweeps a window, linearized first along
    ``u_init`` ``(N, d)`` (None: the incoming state's solution held
    constant over the window). Returns what
    `associative.solve_fixed_parallel` returns."""
    c = _setup(prob, alg, ts)
    d, D, N = c.d, c.D, c.N
    W = n_windows
    M = N // W
    A, QL, pinv = c.A, c.QL, c.pinv_full
    A_ = A.expand(M, D, D)
    t_meas_w = ts[1:].reshape(W, M)
    u_init_w = None if u_init is None else u_init.to(c.dtype).reshape(W, M, d)

    def full_sweep(m_in, U_in, u_lin, t_w):
        """One linearize, filter, in-window smooth sweep."""
        H, y = c.build_elements(u_lin, t_w)
        ms, Us = parallel_filter_sqrt(m_in, U_in, A, QL, H, y, block=block)
        # filtered states at local j = 0..M-1 (j = 0 the incoming state)
        mf = torch.cat([m_in[None], ms[:-1]])
        Uf = torch.cat([U_in[None], Us[:-1]])
        G, g, P, U_pred = smoother_gains(mf, Uf, A, QL)
        # cumulative maps to the terminal state: x^s_j = gc_j + Ec_j x^s_M
        Ec, gc, Pc = _scan("smooth", _sqrt_smooth_combine, (G, g, P), block,
                           reverse=True)
        # this linearization's innovation statistic, for the global MLE
        m_pred = _bmm(A_, mf[..., None])[..., 0]
        S_chol = tril_factor(_T(_bmm(H, U_pred)))
        z = _bmm(H, m_pred[..., None])[..., 0] - y
        wvec = solve_triangular_unrolled(S_chol, z[..., None], lower=True)
        return ms, Us, Ec, gc, Pc, torch.sum(wvec * wvec)

    m_in = c.m0
    U_in = torch.zeros((D, D), dtype=c.dtype, device=c.device)
    kept, stats = [], []
    for w in range(W):
        t_w = t_meas_w[w]
        if u_init_w is not None:
            u_lin = u_init_w[w]
        else:
            # the incoming solution held constant over the window
            u_lin = (pinv[:d] * m_in[:d]).expand(M, d)
        for _ in range(max(iterations - 1, 0)):
            ms, _, Ec, gc, _, _ = full_sweep(m_in, U_in, u_lin, t_w)
            msm = gc + _bmm(Ec, ms[-1][None, :, None])[..., 0]
            u_all = torch.cat([msm[1:], ms[-1:]])
            u_lin = pinv[None, :d] * u_all[:, :d]
        ms, Us, Ec, gc, Pc, stat = full_sweep(m_in, U_in, u_lin, t_w)
        kept.append((Ec, gc, Pc))
        stats.append(stat)
        m_in, U_in = ms[-1], Us[-1]

    # Backward over the windows: the incoming smoothed boundary state is
    # the terminal suffix element (0, m_b, U_b) of each stored map; the new
    # carry is the window's smoothed left boundary.
    m_b, U_b = m_in, U_in
    gs_all, Ps_all = [None] * W, [None] * W
    for w in range(W - 1, -1, -1):
        Ec, gc, Pc = kept[w]
        suffix = (torch.zeros_like(Ec), m_b.expand(gc.shape),
                  U_b.expand(Pc.shape))
        _, gs_all[w], Ps_all[w] = _sqrt_smooth_combine(suffix, (Ec, gc, Pc))
        m_b, U_b = gs_all[w][0], Ps_all[w][0]

    ms_s = torch.cat(gs_all + [m_in[None]])
    Us_s = torch.cat(Ps_all + [U_in[None]])
    sigma2 = torch.sum(torch.stack(stats)) / (N * d)
    return _outputs(pinv, d, ms_s, _bmm(Us_s, _T(Us_s)) * sigma2, sigma2)
