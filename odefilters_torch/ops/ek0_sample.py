"""Fused EK0 joint-posterior sampler: plain PyTorch versions and the
wrappers of the two CUDA kernels that replace the JAX package's square-root
state-stream filter and its backward conditioning sampler.

=================================  ==========================================
this module                        ``odefilters/ops/pallas_kernels.py``
=================================  ==========================================
``pair_constants`` (``ek0_pair``)  ``_prior_consts_np`` (IBM prior)
``t_rows``                         ``_t_rows``
``matmul_lists``                   ``_matmul_lists``
``list_mgs_tril``                  ``_list_mgs_tril(rsqrt=False)``
``list_cho_solve``                 ``_list_cho_solve``
``states_hq``                      ``hq`` of ``_ek0_filter_states_kernel``
``innovation`` (``ek0_pair``)      its ``z = pb * mp[bx][j] - du[j]``
``filter_states_step``             the step body of
                                   ``_ek0_filter_states_kernel``
``ek0_filter_states_plain`` /      ``_ek0_filter_states_kernel`` (CUDA:
``ek0_filter_states``              ``csrc/ek0_sample.cu::
                                   ek0_filter_states_kernel``)
``sampler_step``                   the step body of ``_ek0_sampler_kernel``
``ek0_sampler_plain`` /            ``_ek0_sampler_kernel`` (CUDA:
``ek0_sampler``                    ``ek0_sampler_kernel``)
``ek0_filter_state_stream``        ``ek0_filter_state_stream``
``ek0_fused_sample``               ``ek0_fused_sample``
``sample_ensemble_ek0``            ``sample_ensemble_ek0_pallas``
=================================  ==========================================

The forward is the square-root EK0 filter with the dynamic diffusion: per
step it predicts the mean, evaluates ``f``, calibrates ``s2 = |z|^2 /
(d hq)``, re-triangularises the stack ``[(At L)^T; (sqrt(s2) QLt)^T]`` by
modified Gram-Schmidt and updates the mean and the full (not triangular)
factor ``L``. It streams ``(T+1, V, B)`` rows ``[mean (nq*d) | L (nq*nq,
row-major) | s2]``, V = 25 at q = 3, d = 2 (the JAX kernel's ``(nq, d+nq+1)``
row, 28 entries, without its unused s2 column entries).

The sampler walks the stream backwards and draws S joint samples per
member from the smoothing posterior: per step, shared by all samples, the
predicted factor ``Lp`` (MGS), the gain ``G`` (nq Cholesky solves), the
predicted mean and the conditional factor ``L_c`` (a second MGS); per
sample ``x = m + G (x' - mp) + L_c z``. The normals are an input
``(T+1, S, nq, d, B)`` in the JAX package's layout; its output is
``(T+1, S, d, B)``. The plain sampler carries the S samples as a leading
axis of each entry (``(S, B)`` tensors).

Dispatch: each wrapper runs its plain version on CPU tensors, launches its
CUDA kernel on CUDA tensors, raises on any other device, and counts its
launches in ``.launches``. The static-diffusion and second-order branches
of the JAX filter kernel are not ported (no caller of the JAX package
reaches the first; the port has no second-order problems yet).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from odefilters_torch.ops import _launch
from odefilters_torch.ops import ek0_pair as ep
from odefilters_torch.ops._blocks import _is0, _lists, _smul, _sreduce
from odefilters_torch.ops.ek0_pair import innovation

BX = 1  # the measured derivative block of a first-order problem


def t_rows(X, nq: int):
    """Transpose a list block (rows <-> columns)."""
    return [[X[i][b] for i in range(nq)] for b in range(nq)]


def matmul_lists(A, B, nq: int):
    """``A @ B`` for list blocks, every product taken (no structural skip)."""
    return [[_sreduce([A[i][k] * B[k][j] for k in range(nq)])
             for j in range(nq)] for i in range(nq)]


def list_mgs_tril(rows, K: int, nq: int):
    """Lower-triangular factor ``L`` with ``L L^T = M^T M`` by modified
    Gram-Schmidt on the ``K x nq`` block ``rows`` (M). Pivots are
    ``sqrt(max(ss, 1e-30))`` and their reciprocals ``1 / R``; Python 0.0
    entries are structural zeros and every term through them is skipped.
    The upper entries of the result are zero tensors."""
    v = [[rows[k][j] for j in range(nq)] for k in range(K)]
    zero = torch.zeros_like(next(x for r in rows for x in r if not _is0(x)))
    R = [[None] * nq for _ in range(nq)]
    qcol = [None] * K
    for j in range(nq):
        ss = _sreduce([_smul(v[k][j], v[k][j]) for k in range(K)])
        if _is0(ss):
            ss = zero
        R[j][j] = torch.sqrt(torch.clamp(ss, min=1e-30))
        inv = 1.0 / R[j][j]
        for k in range(K):
            qcol[k] = _smul(v[k][j], inv)
        for l in range(j + 1, nq):
            r = _sreduce([_smul(qcol[k], v[k][l]) for k in range(K)])
            R[j][l] = r
            if _is0(r):
                continue
            for k in range(K):
                if not _is0(qcol[k]):
                    v[k][l] = (-r * qcol[k] if _is0(v[k][l])
                               else v[k][l] - r * qcol[k])
    return [[(zero if _is0(R[l][i]) else R[l][i]) if l <= i else zero
             for l in range(nq)] for i in range(nq)]


def list_cho_solve(L, b, nq: int):
    """Solve ``L L^T x = b`` for one right-hand side: forward and back
    substitution dividing by the pivots."""
    y = [None] * nq
    for i in range(nq):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * nq
    for i in range(nq - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, nq):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return x


def states_hq(QLt, pinv1: float, dtype: torch.dtype) -> float:
    """``pinv1^2 Q[1, 1]`` as the JAX filter-states kernel forms it: the
    sum of squares of row 1 of the noise factor, taken in the working
    precision."""
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    return pinv1 * pinv1 * float((np.asarray(QLt).astype(np_dtype)[BX] ** 2).sum())


def _times_lists(At, X, nq: int, ncol: int):
    """``At @ X`` over At's nonzero entries (At upper triangular)."""
    return [[_sreduce([At[i][a] * X[a][c] for a in range(nq) if At[i][a] != 0.0])
             for c in range(ncol)] for i in range(nq)]


def filter_states_step(m, L, p, t_new, *, f: Callable, At, QLt, pinv0: float,
                       pinv1: float, hq: float, d: int, nq: int):
    """One square-root EK0 step with the dynamic diffusion. ``m``: nq x d
    and ``L``: nq x nq lists of ``(B,)`` tensors; ``At``, ``QLt``: nested
    Python floats. Returns ``(m_new, L_new, s2)``."""
    pb = pinv1
    mp = _times_lists(At, m, nq, d)
    u_pred = torch.stack([pinv0 * mp[0][j] for j in range(d)])
    du = f(u_pred, p, t_new)
    z = [innovation(pb, mp[BX][j], du[j]) for j in range(d)]
    zz = _sreduce([zj * zj for zj in z])
    s2 = zz / (d * hq)
    sq_s2 = torch.sqrt(s2)
    AtL = _times_lists(At, L, nq, nq)
    qT = [[sq_s2 * QLt[i][a] if QLt[i][a] != 0.0 else 0.0 for i in range(nq)]
          for a in range(nq)]
    Lp = list_mgs_tril(t_rows(AtL, nq) + qT, 2 * nq, nq)
    s = pb * pb * _sreduce([Lp[BX][l] * Lp[BX][l] for l in range(nq)])
    inv_s = 1.0 / s
    c_col = [_sreduce([Lp[i][l] * Lp[BX][l] for l in range(nq)])
             for i in range(nq)]
    kg = [pb * c_col[i] * inv_s for i in range(nq)]
    m_new = [[mp[i][j] - kg[i] * z[j] for j in range(d)] for i in range(nq)]
    Zrow = [pb * Lp[BX][l] for l in range(nq)]
    L_new = [[Lp[i][l] - kg[i] * Zrow[l] for l in range(nq)]
             for i in range(nq)]
    return m_new, L_new, s2


def states_width(nq: int, d: int) -> int:
    """Width of a filter-states stream row: ``nq*d + nq*nq + 1``."""
    return nq * d + nq * nq + 1


def _pack_states(row, m, L, s2):
    torch.stack([x for mi in m for x in mi] + [x for Li in L for x in Li]
                + [s2], out=row)


def _unpack_states(row, nq: int, d: int):
    m = [[row[i * d + j] for j in range(d)] for i in range(nq)]
    o = nq * d
    L = [[row[o + i * nq + l] for l in range(nq)] for i in range(nq)]
    return m, L, row[o + nq * nq]


def ek0_filter_states_plain(
    f: Callable, m0_p: torch.Tensor, ps: torch.Tensor, *, At, QLt,
    pinv0: float, pinv1: float, t0: float, dt: float, n_steps: int,
) -> torch.Tensor:
    """The square-root filter's stream ``(T+1, V, B)`` from the
    preconditioned initial means ``m0_p`` ``(nq, d, B)`` and parameters
    ``ps`` ``(n_params, B)``. Row 0 is the exact initial state (L = 0,
    s2 = 1); row k+1 holds the state after step k and that step's s2."""
    nq, d, B = m0_p.shape
    T = int(n_steps)
    dtype, device = m0_p.dtype, m0_p.device
    hq = states_hq(QLt, pinv1, dtype)
    At, QLt = _lists(At), _lists(QLt)
    st = torch.empty((T + 1, states_width(nq, d), B), dtype=dtype,
                     device=device)
    m = [[m0_p[i, j] for j in range(d)] for i in range(nq)]
    zero = torch.zeros_like(m[0][0])
    L = [[zero] * nq for _ in range(nq)]
    _pack_states(st[0], m, L, zero + 1.0)
    ts = ep.step_times(t0, dt, T, dtype, device)
    for k in range(T):
        m, L, s2 = filter_states_step(
            m, L, ps, ts[k], f=f, At=At, QLt=QLt, pinv0=pinv0, pinv1=pinv1,
            hq=hq, d=d, nq=nq,
        )
        _pack_states(st[k + 1], m, L, s2)
    return st


def sampler_step(m_f, L_f, xs, z, sq_s2, *, At, QLt, nq: int, d: int):
    """One backward conditioning step: the filtered state ``(m_f, L_f)`` at
    t_k conditioned on the samples ``xs`` drawn at t_{k+1} (the diffusion of
    interval k -> k+1 enters as ``sq_s2``), re-drawn with the normals
    ``z``. ``xs`` and ``z``: nq x d lists of ``(S, B)`` tensors; the
    gain and factor work is ``(B,)`` and shared by the S samples."""
    AtL = _times_lists(At, L_f, nq, nq)
    qT = [[sq_s2 * QLt[i][a] if QLt[i][a] != 0.0 else 0.0 for i in range(nq)]
          for a in range(nq)]
    Lp = list_mgs_tril(t_rows(AtL, nq) + qT, 2 * nq, nq)
    M = [[_sreduce([L_f[i][b] * AtL[l][b] for b in range(nq)])
          for l in range(nq)] for i in range(nq)]
    G = [list_cho_solve(Lp, M[i], nq) for i in range(nq)]
    mp = _times_lists(At, m_f, nq, d)
    # the conditional factor: the smoothing stack without its G L_s block
    # (the conditioning target has zero covariance)
    GA = matmul_lists(G, At, nq)
    IGA = [[(1.0 if i == l else 0.0) - GA[i][l] for l in range(nq)]
           for i in range(nq)]
    b1 = matmul_lists(IGA, L_f, nq)
    GQ = [[sq_s2 * _sreduce([G[i][a] * QLt[a][l] for a in range(l, nq)])
           for l in range(nq)] for i in range(nq)]
    L_c = list_mgs_tril(t_rows(b1, nq) + t_rows(GQ, nq), 2 * nq, nq)
    dm = [[xs[i][j] - mp[i][j] for j in range(d)] for i in range(nq)]
    return [[m_f[i][j]
             + _sreduce([G[i][l] * dm[l][j] for l in range(nq)])
             + _sreduce([L_c[i][l] * z[l][j] for l in range(i + 1)])
             for j in range(d)] for i in range(nq)]


def ek0_sampler_plain(st: torch.Tensor, normals: torch.Tensor, *, At, QLt,
                      pinv0: float, nq: int, d: int) -> torch.Tensor:
    """Joint posterior samples ``(T+1, S, d, B)`` of the solution from the
    filter-states stream ``st`` ``(T+1, V, B)`` and standard normals
    ``(T+1, S, nq, d, B)``. The step from t_k uses the diffusion of
    interval k -> k+1, stored in row k+1 and carried from the later row."""
    T = st.shape[0] - 1
    S, B = normals.shape[1], normals.shape[4]
    At, QLt = _lists(At), _lists(QLt)
    out = torch.empty((T + 1, S, d, B), dtype=st.dtype, device=st.device)

    def zs(k):
        return [[normals[k, :, l, j] for j in range(d)] for l in range(nq)]

    def emit(k, xs):
        torch.stack([pinv0 * xs[0][j] for j in range(d)], dim=1, out=out[k])

    m, L, s2 = _unpack_states(st[T], nq, d)
    z = zs(T)
    xs = [[m[i][j] + _sreduce([_smul(L[i][l], z[l][j]) for l in range(nq)])
           for j in range(d)] for i in range(nq)]
    emit(T, xs)
    for k in range(T - 1, -1, -1):
        m_f, L_f, s2_k = _unpack_states(st[k], nq, d)
        xs = sampler_step(m_f, L_f, xs, zs(k), torch.sqrt(s2), At=At, QLt=QLt,
                          nq=nq, d=d)
        emit(k, xs)
        s2 = s2_k
    return out


def ek0_filter_states(
    f: Callable, field: Optional[str], m0_p: torch.Tensor, ps: torch.Tensor,
    *, At, QLt, pinv0: float, pinv1: float, t0: float, dt: float,
    n_steps: int, static_diff: Optional[str] = None,
) -> torch.Tensor:
    """The filter-states stream: `ek0_filter_states_plain` on CPU tensors,
    the CUDA kernel ``ek0_filter_states_kernel`` on CUDA tensors (vector
    field ``field``)."""
    if static_diff is not None:
        raise NotImplementedError(
            "the filter-states kernel's static-diffusion branch is not ported "
            "(no sampler of the JAX package runs it; ROADMAP.md queue 2 item 5)"
        )
    kw = dict(At=At, QLt=QLt, pinv0=pinv0, pinv1=pinv1, t0=t0, dt=dt,
              n_steps=n_steps)
    if _launch.dispatch_device("ek0_filter_states", m0_p) == "cpu":
        return ek0_filter_states_plain(f, m0_p, ps, **kw)
    nq, d, B = m0_p.shape
    _launch.check_field("ek0_filter_states", field, nq, d, B, ps)
    _launch.check_cuda_inputs("ek0_filter_states", {"m0_p": m0_p, "ps": ps},
                              m0_p.dtype)
    T = int(n_steps)
    st = torch.empty((T + 1, states_width(nq, d), B), dtype=m0_p.dtype,
                     device=m0_p.device)
    _launch.launch(
        ek0_filter_states, m0_p.device,
        f"ek0_filter_states_{field}_{_launch.suffix(m0_p.dtype)}",
        m0_p.data_ptr(), ps.data_ptr(), st.data_ptr(), B, T,
        _launch.host_consts(At, QLt, scalars=(
            pinv0, pinv1, t0, dt, states_hq(QLt, pinv1, m0_p.dtype))))
    return st


ek0_filter_states.launches = 0


def ek0_sampler(st: torch.Tensor, normals: torch.Tensor, *, At, QLt,
                pinv0: float, nq: int, d: int) -> torch.Tensor:
    """The backward sampler: `ek0_sampler_plain` on CPU tensors, the CUDA
    kernel ``ek0_sampler_kernel`` on CUDA tensors."""
    if _launch.dispatch_device("ek0_sampler", st) == "cpu":
        return ek0_sampler_plain(st, normals, At=At, QLt=QLt, pinv0=pinv0,
                                 nq=nq, d=d)
    T1, V, B = st.shape
    if (nq - 1 not in _launch.CUDA_ORDERS or d != 2
            or V != states_width(nq, d) or normals.ndim != 5
            or normals.shape[0] != T1 or normals.shape[2:] != (nq, d, B)):
        raise ValueError(
            f"ek0_sampler: the kernel takes nq - 1 in {_launch.CUDA_ORDERS}, "
            f"d = 2, a (T+1, {states_width(nq, d)}, B) stream and "
            f"(T+1, S, {nq}, {d}, B) normals; got nq={nq}, d={d}, "
            f"{tuple(st.shape)}, {tuple(normals.shape)}"
        )
    _launch.check_cuda_inputs("ek0_sampler", {"st": st, "normals": normals},
                              st.dtype)
    S = normals.shape[1]
    out = torch.empty((T1, S, d, B), dtype=st.dtype, device=st.device)
    _launch.launch(ek0_sampler, st.device,
                   f"ek0_sampler_{_launch.suffix(st.dtype)}",
                   st.data_ptr(), normals.data_ptr(), out.data_ptr(), B,
                   T1 - 1, S, _launch.host_consts(At, QLt, scalars=(pinv0,)))
    return out


ek0_sampler.launches = 0


def _consts(q: int, dt: float):
    At, _, QLt, p = ep.pair_constants(q, dt)
    return At, QLt, p, float(1.0 / p[0]), float(1.0 / p[1])


def ek0_filter_state_stream(
    f: Callable, m0: torch.Tensor, ps: torch.Tensor, t0: float, dt: float,
    n_steps: int, q: int, *, field: Optional[str] = None, prior=None,
    second_order: bool = False, static_diff: Optional[str] = None,
) -> torch.Tensor:
    """The filter-states stream ``(T+1, V, B)`` of the sampler's forward,
    from unpreconditioned Taylor initial means ``m0`` ``(q+1, d, B)``: the
    test hook that exposes what `ek0_fused_sample` builds inline."""
    _launch.check_ported(prior=prior, second_order=second_order, mesh=None)
    At, QLt, p, pinv0, pinv1 = _consts(q, dt)
    m0_p = torch.as_tensor(p, dtype=m0.dtype, device=m0.device)[:, None, None] * m0
    return ek0_filter_states(f, field, m0_p, ps, At=At, QLt=QLt, pinv0=pinv0,
                             pinv1=pinv1, t0=float(t0), dt=float(dt),
                             n_steps=n_steps, static_diff=static_diff)


def ek0_fused_sample(
    f: Callable,
    m0: torch.Tensor,
    ps: torch.Tensor,
    normals: torch.Tensor,
    t0: float,
    dt: float,
    n_steps: int,
    q: int,
    *,
    field: Optional[str] = None,
    prior=None,
    mesh=None,
    second_order: bool = False,
) -> torch.Tensor:
    """Fused joint-posterior sampling: the filter-states kernel and the
    backward sampler kernel over an ensemble of B members (any B >= 1).

    ``m0``: ``(q+1, d, B)`` unpreconditioned Taylor initial means; ``ps``:
    ``(n_params, B)``; ``normals``: ``(T+1, S, q+1, d, B)`` i.i.d. standard
    normals. Returns ``(T+1, S, d, B)``: S joint samples of the solution
    path per member from the smoothing posterior, sharing one backward pass
    and its gain and factor work.
    """
    _launch.check_ported(prior=prior, second_order=second_order, mesh=mesh)
    nq = q + 1
    _, d, B = m0.shape
    T = int(n_steps)
    if (normals.ndim != 5 or normals.shape[0] != T + 1
            or tuple(normals.shape[2:]) != (nq, d, B)):
        raise ValueError(
            f"normals must have shape {(T + 1, 'S', nq, d, B)}, got "
            f"{tuple(normals.shape)}"
        )
    At, QLt, _, pinv0, _ = _consts(q, dt)
    st = ek0_filter_state_stream(f, m0, ps, t0, dt, T, q, field=field)
    return ek0_sampler(st, normals.to(m0.dtype).contiguous(), At=At, QLt=QLt,
                       pinv0=pinv0, nq=nq, d=d)


def sample_ensemble_ek0(
    prob_f: Callable,
    u0s: torch.Tensor,
    ps: torch.Tensor,
    tspan,
    n_steps: int,
    generator: torch.Generator,
    q: int = 3,
    n_samples: int = 1,
    *,
    field: Optional[str] = None,
    prior=None,
    mesh=None,
) -> torch.Tensor:
    """Joint posterior samples over an ensemble: Taylor init, standard
    normals drawn from ``generator`` on the tensors' device, then
    `ek0_fused_sample`. ``u0s``: ``(B, d)``; ``ps``: ``(B, n_params)``.
    Returns ``(T+1, d, B)`` for ``n_samples=1``, else
    ``(T+1, n_samples, d, B)``."""
    from odefilters_torch.taylor import taylor_coefficients

    t0, t1 = tspan
    dt = (t1 - t0) / n_steps
    B, d = u0s.shape
    ps_t = ps.T.contiguous()
    m0 = torch.stack(taylor_coefficients(prob_f, u0s.T.contiguous(), ps_t, t0, q))
    S = int(n_samples)
    normals = torch.randn((int(n_steps) + 1, S, q + 1, d, B),
                          generator=generator, dtype=m0.dtype, device=m0.device)
    us = ek0_fused_sample(prob_f, m0, ps_t, normals, float(t0), float(dt),
                          n_steps, q, field=field, prior=prior, mesh=mesh)
    return us[:, 0] if S == 1 else us
