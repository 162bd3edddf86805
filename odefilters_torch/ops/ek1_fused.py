"""Fused EK1 dense-factor kernels: plain PyTorch versions and the wrappers
of the three CUDA kernels that replace the JAX package's square-root EKF
filter (with its in-kernel Jacobian), its backward RTS smoother and its
joint-posterior sampler over the same ``D x D`` factor stream.

==================================  ==========================================
this module                         ``odefilters/ops/pallas_kernels.py``
==================================  ==========================================
``auto_jac``                        ``_auto_jac``
``list_chol``                       ``_list_chol``
``list_mgs_tril``,                  ``_list_mgs_tril(rsqrt=False)``,
``list_cho_solve`` (``ek0_sample``) ``_list_cho_solve``
``ek1_step``                        ``_ek1_step_lists`` (``want_ll``:
                                    ``want_stats``)
``stream_layout``                   the packed row of
                                    ``_ek1_filter_states_kernel``
``ek1_filter_states_plain`` /       ``_ek1_filter_states_kernel`` (CUDA:
``ek1_filter_states``               ``csrc/ek1_fused.cu::
                                    ek1_filter_states_kernel``)
``ekd_smoother_plain`` /            ``_ekd_smoother_kernel`` (CUDA:
``ekd_smoother``                    ``ekd_smoother_kernel``)
``ekd_sampler_plain`` /             ``_ekd_sampler_kernel`` (CUDA:
``ekd_sampler``                     ``ekd_sampler_kernel``)
``ek1_fused_solve``                 ``ek1_fused_solve``
``ek1_fused_sample``                ``ek1_fused_sample``
``solve_ensemble_ek1``              ``solve_ensemble_ek1_pallas``
``sample_ensemble_ek1``             ``sample_ensemble_ek1_pallas``
==================================  ==========================================

The state is flat and derivative-major, ``D = d (q+1)`` entries: ``m[i]``
is derivative ``i // d`` of dimension ``i % d``. The transition is
``A = kron(At, I_d)``, the noise factor ``QLf = kron(QLt, I_d)``, and the
measurement ``H = (E1 - J E0) P^-1`` with ``J`` the field's Jacobian at the
predicted solution (or at a given linearization point, the IEKS hook). The
step bodies work on lists of per-member ``(B,)`` tensors in the JAX
bodies' order of operations; a Python ``0.0`` entry is a structural zero
(`ops._blocks`).

The filter streams ``(T+1, V, B)`` rows ``[mean (D) | L (D*D, row-major) |
s2 | tril(Lp) (D(D+1)/2, row-major)]`` (`stream_layout`): the updated
factor ``L`` (full, not triangular), the step's diffusion and the
predicted factor ``Lp`` of the interval ``k-1 -> k``, which the smoother
and the sampler read instead of re-factoring. V = 109 at q = 3, d = 2; 73
without ``Lp`` when no backward pass follows (``smooth=False``).

Dispatch: each wrapper runs its plain version on CPU tensors, launches its
CUDA kernel on CUDA tensors, raises on any other device, and counts its
launches in ``.launches``. The kernels evaluate the CUDA field's own
Jacobian (``fields.cuh``); a field without one raises.
"""

from __future__ import annotations

import functools
import operator
from typing import Callable, Optional

import numpy as np
import torch

from odefilters_torch.ops import _launch
from odefilters_torch.ops import ek0_pair as ep
from odefilters_torch.ops._blocks import _is0, _lists, _smul, _sreduce
from odefilters_torch.ops.ek0_filter import _LOG_2PI
from odefilters_torch.ops.ek0_sample import (
    list_cho_solve, list_mgs_tril, matmul_lists, t_rows,
)

EK1_STATIC = ("fixed", "fixedMAP")


def _sum(terms):
    """Left-to-right sum of tensor terms, as ``functools.reduce`` forms it."""
    return functools.reduce(operator.add, terms)


def auto_jac(f: Callable) -> Callable:
    """The Jacobian of ``f`` in ``u`` from d forward-mode JVP columns, one
    one-hot tangent per column: ``(d, d[, B])``. The plain versions use it
    for a problem without ``jac``; the kernels need the CUDA field's."""

    def jac(u, p, t):
        u = u.contiguous()  # a dual tensor needs its own storage, not a view
        dd = u.shape[0]     # that broadcasts one row
        cols = []
        for b in range(dd):
            tangent = torch.stack([torch.ones_like(u[b]) if i == b
                                   else torch.zeros_like(u[b])
                                   for i in range(dd)])
            _, col = torch.func.jvp(lambda uu: f(uu, p, t), (u,), (tangent,))
            cols.append(col)
        return torch.stack(cols, dim=1)

    return jac


def kron_lists(M, d: int):
    """``kron(M, I_d)`` as nested Python floats."""
    return _lists(np.kron(np.asarray(M, dtype=np.float64), np.eye(d)))


def list_chol(C, n: int):
    """Cholesky factor of the symmetric ``n x n`` list block ``C``: pivots
    ``sqrt(max(s, 1e-30))``, the entries below divided by them. Only the
    lower triangle of the result is set."""
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = C[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp(s, min=1e-30))
            else:
                L[i][j] = s / L[j][j]
    return L


def _amul_vec(Af, v, D: int):
    """``A v`` over A's nonzero entries."""
    return [_sum([Af[r][c] * v[c] for c in range(D) if Af[r][c] != 0.0])
            for r in range(D)]


def _amul_mat(Af, M, D: int):
    """``A M`` over A's nonzero entries."""
    return [[_sum([Af[r][c] * M[c][k] for c in range(D) if Af[r][c] != 0.0])
             for k in range(D)] for r in range(D)]


def predict_lp(Af, QLf, L, sq_s2, D: int):
    """The predicted factor: MGS of ``[(A L)^T; (sq_s2 QLf)^T]`` (2D x D)."""
    AL = _amul_mat(Af, L, D)
    qT = [[sq_s2 * QLf[r][c] if QLf[r][c] != 0.0 else 0.0 for r in range(D)]
          for c in range(D)]
    return list_mgs_tril(t_rows(AL, D) + qT, 2 * D, D)


def ek1_step(m, L, p, t_new, *, f: Callable, jac: Callable, Af, QLf,
             pinv0, pinv1, d: int, D: int,
             want_Lp: bool = False, u_lin=None, static_diff=None,
             calib=None, want_stats: bool = False,
             stop_calib: bool = False):
    """One square-root EK1 step on the D-vector mean ``m`` and the D x D
    factor ``L`` (lists of ``(B,)`` tensors); ``Af``, ``QLf``: nested Python
    floats of ``kron(At, I_d)`` and ``kron(QLt, I_d)``; ``pinv0``,
    ``pinv1``: the preconditioner entries of blocks 0 and 1 (Python floats
    on a fixed grid, per-member tensors in the adaptive loop).

    Dynamic diffusion: ``s2 = z^T (H Q H^T)^-1 z / d``. A static model
    (``static_diff`` fixed or fixedMAP) filters with the unscaled prior,
    returns s2 = 1 and updates ``calib = (sig, k)`` from ``z^T S^-1 z / d``.
    ``u_lin``: a ``(d, B)`` linearization point for the Jacobian (the IEKS
    hook); ``f`` is still evaluated at the predicted mean. ``stop_calib``
    (dynamic only): ``s2`` is detached before ``sqrt(s2)`` scales the
    noise, so a gradient treats the calibration as part of the model (the
    values are the same). Returns ``(m_new, L_new, s2)``, then ``Lp`` with
    ``want_Lp``, then the new ``calib`` under a static model, then with
    ``want_stats`` (dynamic only) the diagonal of ``H Q H^T`` and the
    log-likelihood increment ``log N(z; 0, S)`` that an adaptive attempt
    and the data likelihood need."""
    zero = torch.zeros_like(m[0])
    mp = _amul_vec(Af, m, D)
    u_pred = torch.stack([pinv0 * mp[j] for j in range(d)])
    du = f(u_pred, p, t_new)
    J = jac(u_pred if u_lin is None else u_lin, p, t_new)
    Jl = [[J[a][b] for b in range(d)] for a in range(d)]
    z = [ep.innovation(pinv1, mp[d + a], du[a]) for a in range(d)]

    def hmul_cols(M):
        # H M for H = (E1 - J E0) P^-1, M a D x D list block
        out = []
        for a in range(d):
            row = []
            for kk in range(D):
                v = pinv1 * M[d + a][kk]
                for b in range(d):
                    v = v - Jl[a][b] * (pinv0 * M[b][kk])
                row.append(v)
            out.append(row)
        return out

    def gram(Z):
        return [[_sum([Z[a][c] * Z[b][c] for c in range(D)]) for b in range(d)]
                for a in range(d)]

    if static_diff is not None:
        sq_s2 = 1.0
    else:
        QL_lanes = [[torch.zeros_like(zero) if QLf[r][c] == 0.0
                     else QLf[r][c] + zero for c in range(D)] for r in range(D)]
        Sq = gram(hmul_cols(QL_lanes))
        Lq = list_chol(Sq, d)
        w = list_cho_solve(Lq, z, d)
        s2 = _sum([z[a] * w[a] for a in range(d)]) / d
        if stop_calib:
            s2 = s2.detach()
        sq_s2 = torch.sqrt(torch.clamp(s2, min=0.0))

    Lp = predict_lp(Af, QLf, L, sq_s2, D)

    # update: Z = H Lp, S = Z Z^T, K = Lp Z^T S^-1
    Z = hmul_cols(Lp)
    Ls = list_chol(gram(Z), d)
    LpZt = [[_sum([Lp[r][c] * Z[a][c] for c in range(D)]) for a in range(d)]
            for r in range(D)]
    Kg = [list_cho_solve(Ls, LpZt[r], d) for r in range(D)]
    m_new = [mp[r] - _sum([Kg[r][a] * z[a] for a in range(d)])
             for r in range(D)]
    L_new = [[Lp[r][c] - _sum([Kg[r][a] * Z[a][c] for a in range(d)])
              for c in range(D)] for r in range(D)]
    out = (m_new, L_new)
    if static_diff is None:
        out += (s2,)
    else:
        ws = list_cho_solve(Ls, z, d)
        local = _sum([z[a] * ws[a] for a in range(d)]) / d
        calib = ep.static_scalar_update(static_diff, calib, local, d)
        out += (zero + 1.0,)
    if want_Lp:
        out += (Lp,)
    if static_diff is not None:
        out += (calib,)
    if want_stats:
        wz = list_cho_solve(Ls, z, d)
        maha = _sum([z[a] * wz[a] for a in range(d)])
        logdet = 2.0 * _sum([torch.log(torch.clamp(Ls[a][a], min=1e-30))
                             for a in range(d)])
        out += ([Sq[a][a] for a in range(d)],
                -0.5 * (maha + logdet + d * _LOG_2PI))
    return out


def stream_layout(nq: int, d: int, smooth: bool = True) -> dict:
    """Offsets in a filter stream row: ``"m"`` (D entries), ``"L"`` (D*D,
    row-major), ``"s2"`` (one index), ``"Lp"`` (the lower triangle of the
    predicted factor, row by row; only when ``smooth``) and the width
    ``"V"``."""
    D = d * nq
    s2 = D + D * D
    V = s2 + 1 + (D * (D + 1) // 2 if smooth else 0)
    out = {"m": slice(0, D), "L": slice(D, s2), "s2": s2, "V": V}
    if smooth:
        out["Lp"] = slice(s2 + 1, V)
    return out


def _pack(row, m, L, s2, Lp, smooth: bool):
    vals = list(m) + [x for Lr in L for x in Lr] + [s2]
    if smooth:
        vals += [Lp[r][c] for r in range(len(m)) for c in range(r + 1)]
    torch.stack(vals, out=row)


def _unpack(row, D: int):
    """``(m, L, s2, Lp)`` of a stream row; Lp's upper entries are 0.0."""
    m = [row[r] for r in range(D)]
    L = [[row[D + r * D + c] for c in range(D)] for r in range(D)]
    o = D + D * D
    Lp = [[0.0] * D for _ in range(D)]
    idx = o + 1
    for r in range(D):
        for c in range(r + 1):
            Lp[r][c] = row[idx]
            idx += 1
    return m, L, row[o], Lp


def check_static(diffusion: str) -> Optional[str]:
    """The static model's name, or None for ``"dynamic"``; raise as the JAX
    package does for any other diffusion."""
    if diffusion == "dynamic":
        return None
    if diffusion not in EK1_STATIC:
        raise NotImplementedError(
            f"diffusion={diffusion!r}: the fused EK1 kernels support "
            "dynamic / fixed / fixedMAP (MV models require EK0 / "
            "DiagonalEK1 structure)"
        )
    return str(diffusion)


def ek1_filter_states_plain(
    f: Callable, jac: Optional[Callable], m0_p: torch.Tensor,
    ps: torch.Tensor, *, At, QLt, pinv0: float, pinv1: float, t0: float,
    dt: float, n_steps: int, smooth: bool = True,
    lin: Optional[torch.Tensor] = None, static_diff: Optional[str] = None,
):
    """The EK1 filter's stream ``(T+1, V, B)`` (`stream_layout`) from the
    preconditioned initial means ``m0_p`` ``(nq, d, B)`` and parameters
    ``ps`` ``(n_params, B)``. Row 0 is the exact initial state (L = 0,
    s2 = 1, Lp = 0); row k+1 holds the state after step k, that step's s2
    and its predicted factor. ``lin``: optional ``(T+1, d, B)``
    linearization points, row k+1 for step k (the IEKS hook; dynamic
    diffusion only). Under a static model returns ``(st, sig)``, ``sig``
    the calibrated sigma^2 ``(B,)``. ``jac=None`` derives the Jacobian
    from JVP columns (`auto_jac`)."""
    if static_diff is not None and lin is not None:
        raise NotImplementedError(
            "IEKS linearization streams require the dynamic model"
        )
    nq, d, B = m0_p.shape
    D = d * nq
    T = int(n_steps)
    dtype, device = m0_p.dtype, m0_p.device
    kw = dict(f=f, jac=auto_jac(f) if jac is None else jac,
              Af=kron_lists(At, d), QLf=kron_lists(QLt, d), pinv0=pinv0,
              pinv1=pinv1, d=d, D=D, want_Lp=True, static_diff=static_diff)
    st = torch.empty((T + 1, stream_layout(nq, d, smooth)["V"], B),
                     dtype=dtype, device=device)
    m = [m0_p[i // d, i % d] for i in range(D)]
    zero = torch.zeros_like(m[0])
    L = [[zero] * D for _ in range(D)]
    _pack(st[0], m, L, zero + 1.0, L, smooth)
    calib = (zero, zero)
    ts = ep.step_times(t0, dt, T, dtype, device)
    for k in range(T):
        u_lin = None if lin is None else lin[k + 1]
        if static_diff is None:
            m, L, s2, Lp = ek1_step(m, L, ps, ts[k], u_lin=u_lin, **kw)
        else:
            m, L, s2, Lp, calib = ek1_step(m, L, ps, ts[k], calib=calib, **kw)
        _pack(st[k + 1], m, L, s2, Lp, smooth)
    return st if static_diff is None else (st, calib[0])


def _block_std(pinv0: float, Lrow):
    return pinv0 * torch.sqrt(_sum([x * x for x in Lrow]))


def _backward_shared(m_f, L_f, Lp, sq, *, Af, QLf, D: int):
    """The work of a backward step from the filtered state ``(m_f, L_f)`` at
    t_k that does not depend on what is carried from t_{k+1}: the gain
    ``G = C_f A^T (Lp Lp^T)^-1``, the predicted mean and the stack blocks
    ``(I - G A) L_f`` and ``sq G QLf``."""
    AL = _amul_mat(Af, L_f, D)
    M = [[_sum([L_f[r][b] * AL[l][b] for b in range(D)]) for l in range(D)]
         for r in range(D)]
    G = [list_cho_solve(Lp, M[r], D) for r in range(D)]
    mp = _amul_vec(Af, m_f, D)
    GA = [[_sum([G[r][c] * Af[c][l] for c in range(D) if Af[c][l] != 0.0])
           for l in range(D)] for r in range(D)]
    IGA = [[(1.0 if r == l else 0.0) - GA[r][l] for l in range(D)]
           for r in range(D)]
    b1 = matmul_lists(IGA, L_f, D)
    GQ = [[sq * _sum([G[r][c] * QLf[c][l] for c in range(D)
                      if QLf[c][l] != 0.0])
           for l in range(D)] for r in range(D)]
    return G, mp, b1, GQ


def ekd_smoother_plain(st: torch.Tensor, *, At, QLt, pinv0: float, nq: int,
                       d: int):
    """Backward square-root RTS pass over the filter stream ``st``
    (`stream_layout` with ``Lp``): ``(us, stds)``, each ``(T+1, d, B)``,
    the smoothed means and per-dimension stds of the solution. The step
    from t_k uses the diffusion and predicted factor of interval
    k -> k+1, stored in row k+1 and carried from the later row; the stds at
    T use the filter's full factor."""
    D = d * nq
    T, B = st.shape[0] - 1, st.shape[2]
    Af, QLf = kron_lists(At, d), kron_lists(QLt, d)
    us = torch.empty((T + 1, d, B), dtype=st.dtype, device=st.device)
    stds = torch.empty_like(us)

    def emit(k, m, L):
        torch.stack([pinv0 * m[j] for j in range(d)], out=us[k])
        torch.stack([_block_std(pinv0, L[j]) for j in range(d)], out=stds[k])

    m_s, L_s, s2_next, Lp_next = _unpack(st[T], D)
    emit(T, m_s, L_s)
    for k in range(T - 1, -1, -1):
        m_f, L_f, s2_k, Lp_k = _unpack(st[k], D)
        sq = torch.sqrt(torch.clamp(s2_next, min=0.0))
        G, mp, b1, GQ = _backward_shared(m_f, L_f, Lp_next, sq, Af=Af,
                                         QLf=QLf, D=D)
        dm = [m_s[r] - mp[r] for r in range(D)]
        m_s = [m_f[r] + _sum([G[r][l] * dm[l] for l in range(D)])
               for r in range(D)]
        b3 = matmul_lists(G, L_s, D)
        L_s = list_mgs_tril(t_rows(b1, D) + t_rows(GQ, D) + t_rows(b3, D),
                            3 * D, D)
        emit(k, m_s, L_s)
        s2_next, Lp_next = s2_k, Lp_k
    return us, stds


def ekd_sampler_plain(st: torch.Tensor, normals: torch.Tensor, *, At, QLt,
                      pinv0: float, nq: int, d: int) -> torch.Tensor:
    """Joint posterior samples ``(T+1, S, d, B)`` of the solution from the
    filter stream ``st`` and standard normals ``(T+1, S, D, B)``: the
    smoother's recursion with the carried smoothed state replaced by S
    carried samples, each conditioned on its drawn next value and re-drawn
    from the conditional (the smoothing stack without its ``G L_s``
    block). The gain and factor work is ``(B,)`` and shared by the samples,
    which the plain version carries as ``(S, B)`` tensors."""
    D = d * nq
    T = st.shape[0] - 1
    S, B = normals.shape[1], normals.shape[3]
    Af, QLf = kron_lists(At, d), kron_lists(QLt, d)
    out = torch.empty((T + 1, S, d, B), dtype=st.dtype, device=st.device)

    def emit(k, xs):
        torch.stack([pinv0 * xs[j] for j in range(d)], dim=1, out=out[k])

    m_T, L_T, s2_next, Lp_next = _unpack(st[T], D)
    z = normals[T]
    # the streamed updated factor is a general (non-triangular) square root
    xs = [m_T[r] + _sreduce([_smul(L_T[r][c], z[:, c]) for c in range(D)])
          for r in range(D)]
    emit(T, xs)
    for k in range(T - 1, -1, -1):
        m_f, L_f, s2_k, Lp_k = _unpack(st[k], D)
        sq = torch.sqrt(torch.clamp(s2_next, min=0.0))
        G, mp, b1, GQ = _backward_shared(m_f, L_f, Lp_next, sq, Af=Af,
                                         QLf=QLf, D=D)
        # conditional factor: the smoothing stack without its G L_s block
        L_c = list_mgs_tril(t_rows(b1, D) + t_rows(GQ, D), 2 * D, D)
        z = normals[k]
        dm = [xs[r] - mp[r] for r in range(D)]
        xs = [m_f[r] + _sum([G[r][l] * dm[l] for l in range(D)])
              + _sreduce([_smul(L_c[r][c], z[:, c]) for c in range(r + 1)])
              for r in range(D)]
        emit(k, xs)
        s2_next, Lp_next = s2_k, Lp_k
    return out


def _check_kernel_shape(name: str, nq: int, d: int):
    _launch.check_order(name, nq)
    if d != 2:
        raise ValueError(f"{name}: the kernel is built for d = 2; got d={d}")


def ek1_filter_states(
    f: Callable, jac: Optional[Callable], field: Optional[str],
    m0_p: torch.Tensor, ps: torch.Tensor, *, At, QLt, pinv0: float,
    pinv1: float, t0: float, dt: float, n_steps: int, smooth: bool = True,
    lin: Optional[torch.Tensor] = None, static_diff: Optional[str] = None,
):
    """The EK1 filter's stream: `ek1_filter_states_plain` on CPU tensors,
    the CUDA kernel ``ek1_filter_states_kernel`` on CUDA tensors (vector
    field ``field`` and its Jacobian). Returns the stream, and
    ``(st, sig)`` under a static model."""
    kw = dict(At=At, QLt=QLt, pinv0=pinv0, pinv1=pinv1, t0=t0, dt=dt,
              n_steps=n_steps, smooth=smooth, lin=lin,
              static_diff=static_diff)
    if _launch.dispatch_device("ek1_filter_states", m0_p) == "cpu":
        return ek1_filter_states_plain(f, jac, m0_p, ps, **kw)
    if static_diff is not None and lin is not None:
        raise NotImplementedError(
            "IEKS linearization streams require the dynamic model"
        )
    nq, d, B = m0_p.shape
    T = int(n_steps)
    _launch.check_field("ek1_filter_states", field, nq, d, B, ps,
                        need_jac=True)
    tensors = {"m0_p": m0_p, "ps": ps}
    if lin is not None:
        if tuple(lin.shape) != (T + 1, d, B):
            raise ValueError(
                f"ek1_filter_states: lin must have shape {(T + 1, d, B)}, "
                f"got {tuple(lin.shape)}"
            )
        tensors["lin"] = lin
    _launch.check_cuda_inputs("ek1_filter_states", tensors, m0_p.dtype)
    new = dict(dtype=m0_p.dtype, device=m0_p.device)
    st = torch.empty((T + 1, stream_layout(nq, d, smooth)["V"], B), **new)
    sig = None if static_diff is None else torch.empty((B,), **new)
    _launch.launch(
        ek1_filter_states, m0_p.device,
        f"ek1_filter_states_{field}_{_launch.suffix(m0_p.dtype)}",
        m0_p.data_ptr(), ps.data_ptr(),
        None if lin is None else lin.data_ptr(), st.data_ptr(),
        None if sig is None else sig.data_ptr(), B, T, ep.MODES[static_diff],
        int(smooth), _launch.host_consts(At, QLt, scalars=(pinv0, pinv1, t0,
                                                           dt)))
    return st if sig is None else (st, sig)


ek1_filter_states.launches = 0


def _check_stream(name: str, st: torch.Tensor, nq: int, d: int):
    _check_kernel_shape(name, nq, d)
    V = stream_layout(nq, d, True)["V"]
    if st.ndim != 3 or st.shape[1] != V:
        raise ValueError(
            f"{name}: the kernel takes a (T+1, {V}, B) stream with the "
            f"predicted factors; got {tuple(st.shape)}"
        )


def ekd_smoother(st: torch.Tensor, *, At, QLt, pinv0: float, nq: int,
                 d: int):
    """The backward smoother: `ekd_smoother_plain` on CPU tensors, the CUDA
    kernel ``ekd_smoother_kernel`` on CUDA tensors. Returns ``(us, stds)``."""
    if _launch.dispatch_device("ekd_smoother", st) == "cpu":
        return ekd_smoother_plain(st, At=At, QLt=QLt, pinv0=pinv0, nq=nq, d=d)
    _check_stream("ekd_smoother", st, nq, d)
    _launch.check_cuda_inputs("ekd_smoother", {"st": st}, st.dtype)
    T1, _, B = st.shape
    us = torch.empty((T1, d, B), dtype=st.dtype, device=st.device)
    stds = torch.empty_like(us)
    _launch.launch(ekd_smoother, st.device,
                   f"ekd_smoother_{_launch.suffix(st.dtype)}",
                   st.data_ptr(), us.data_ptr(), stds.data_ptr(), B, T1 - 1,
                   _launch.host_consts(At, QLt, scalars=(pinv0,)))
    return us, stds


ekd_smoother.launches = 0


def ekd_sampler(st: torch.Tensor, normals: torch.Tensor, *, At, QLt,
                pinv0: float, nq: int, d: int) -> torch.Tensor:
    """The backward sampler: `ekd_sampler_plain` on CPU tensors, the CUDA
    kernel ``ekd_sampler_kernel`` on CUDA tensors."""
    if _launch.dispatch_device("ekd_sampler", st) == "cpu":
        return ekd_sampler_plain(st, normals, At=At, QLt=QLt, pinv0=pinv0,
                                 nq=nq, d=d)
    _check_stream("ekd_sampler", st, nq, d)
    T1, _, B = st.shape
    if (normals.ndim != 4 or normals.shape[0] != T1
            or tuple(normals.shape[2:]) != (d * nq, B)):
        raise ValueError(
            f"ekd_sampler: normals must have shape {(T1, 'S', d * nq, B)}, "
            f"got {tuple(normals.shape)}"
        )
    _launch.check_cuda_inputs("ekd_sampler", {"st": st, "normals": normals},
                              st.dtype)
    S = normals.shape[1]
    out = torch.empty((T1, S, d, B), dtype=st.dtype, device=st.device)
    _launch.launch(ekd_sampler, st.device,
                   f"ekd_sampler_{_launch.suffix(st.dtype)}",
                   st.data_ptr(), normals.data_ptr(), out.data_ptr(), B,
                   T1 - 1, S, _launch.host_consts(At, QLt, scalars=(pinv0,)))
    return out


ekd_sampler.launches = 0


def _consts(q: int, dt: float):
    At, _, QLt, p = ep.pair_constants(q, dt)
    return At, QLt, p, float(1.0 / p[0]), float(1.0 / p[1])


def ek1_fused_solve(
    f: Callable,
    jac: Optional[Callable],
    m0: torch.Tensor,
    ps: torch.Tensor,
    t0: float,
    dt: float,
    n_steps: int,
    q: int,
    *,
    smooth: bool = True,
    field: Optional[str] = None,
    prior=None,
    mesh=None,
    linearize_traj: Optional[torch.Tensor] = None,
    diffusion: str = "dynamic",
):
    """Fused EK1 solve over an ensemble: the D x D square-root extended
    Kalman filter kernel and, with ``smooth``, the backward RTS kernel.

    ``m0``: ``(q+1, d, B)`` unpreconditioned Taylor initial means; ``ps``:
    ``(n_params, B)``; ``jac``: the plain versions' Jacobian (None: JVP
    columns of ``f``). Returns ``(us, stds)``, shapes ``(T+1, d, B)`` each
    (per-dimension marginal stds: EK1's covariance is not isotropic);
    filter means and stds without ``smooth``. ``diffusion``: dynamic, or
    fixed / fixedMAP, which filter with the unscaled prior and return
    ``(us, stds, sigma2)`` with the stds rescaled by ``sqrt(sigma2)`` at
    exit. ``linearize_traj``: optional ``(T+1, d, B)`` Jacobian
    linearization points (the IEKS hook; row k+1 linearizes step
    k -> k+1)."""
    _launch.check_ported(prior=prior, second_order=False, mesh=mesh)
    static = check_static(diffusion)
    nq = q + 1
    _, d, _ = m0.shape
    T = int(n_steps)
    At, QLt, p, pinv0, pinv1 = _consts(q, dt)
    m0_p = torch.as_tensor(p, dtype=m0.dtype, device=m0.device)[:, None, None] * m0
    lin = None
    if linearize_traj is not None:
        lin = linearize_traj.to(m0.dtype).contiguous()
    st = ek1_filter_states(
        f, jac, field, m0_p, ps, At=At, QLt=QLt, pinv0=pinv0, pinv1=pinv1,
        t0=float(t0), dt=float(dt), n_steps=T, smooth=smooth, lin=lin,
        static_diff=static,
    )
    if static is not None:
        st, sig = st
    if smooth:
        us, stds = ekd_smoother(st, At=At, QLt=QLt, pinv0=pinv0, nq=nq, d=d)
    else:
        lay = stream_layout(nq, d, False)
        D = d * nq
        us = pinv0 * st[:, :d]
        Lrows = st[:, lay["L"]].reshape(T + 1, D, D, -1)[:, :d]
        stds = pinv0 * torch.sqrt(torch.sum(Lrows ** 2, dim=2))
    if static is None:
        return us, stds
    # exit rescale: uniform scaling commutes with the RTS recursion
    return us, stds * torch.sqrt(sig)[None, None], sig


def ek1_fused_sample(
    f: Callable,
    jac: Optional[Callable],
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
) -> torch.Tensor:
    """Fused EK1 joint-posterior sampling: the filter kernel and the
    backward dense-factor sampler kernel. ``normals``: ``(T+1, S, D, B)``
    i.i.d. standard normals, D = d(q+1). Returns ``(T+1, S, d, B)``: S
    joint solution paths per member from the smoothing posterior, sharing
    one backward pass and its gain and factor work."""
    _launch.check_ported(prior=prior, second_order=False, mesh=mesh)
    nq = q + 1
    _, d, B = m0.shape
    T = int(n_steps)
    if (normals.ndim != 4 or normals.shape[0] != T + 1
            or tuple(normals.shape[2:]) != (d * nq, B)):
        raise ValueError(
            f"normals must have shape {(T + 1, 'S', d * nq, B)}, got "
            f"{tuple(normals.shape)}"
        )
    At, QLt, p, pinv0, pinv1 = _consts(q, dt)
    m0_p = torch.as_tensor(p, dtype=m0.dtype, device=m0.device)[:, None, None] * m0
    st = ek1_filter_states(f, jac, field, m0_p, ps, At=At, QLt=QLt,
                           pinv0=pinv0, pinv1=pinv1, t0=float(t0),
                           dt=float(dt), n_steps=T)
    return ekd_sampler(st, normals.to(m0.dtype).contiguous(), At=At, QLt=QLt,
                       pinv0=pinv0, nq=nq, d=d)


def _taylor_init(prob_f, u0s, ps, t0, q):
    from odefilters_torch.taylor import taylor_coefficients

    # contiguous copies: forward-mode AD refuses inputs whose elements
    # alias one another, as in an expanded (broadcast) ensemble
    ps_t = ps.T.contiguous()
    return torch.stack(taylor_coefficients(prob_f, u0s.T.contiguous(), ps_t,
                                           t0, q)), ps_t


def solve_ensemble_ek1(
    prob_f: Callable,
    prob_jac: Optional[Callable],
    u0s: torch.Tensor,
    ps: torch.Tensor,
    tspan,
    n_steps: int,
    q: int = 3,
    *,
    smooth: bool = True,
    field: Optional[str] = None,
    prior=None,
    mesh=None,
    linearize_traj: Optional[torch.Tensor] = None,
    diffusion: str = "dynamic",
):
    """Taylor init + the fused EK1 filter (+ smoother) over an ensemble:
    ``u0s`` ``(B, d)``, ``ps`` ``(B, n_params)``. Returns what
    `ek1_fused_solve` returns."""
    t0, t1 = tspan
    dt = (t1 - t0) / n_steps
    m0, ps_t = _taylor_init(prob_f, u0s, ps, t0, q)
    return ek1_fused_solve(prob_f, prob_jac, m0, ps_t, float(t0), float(dt),
                           n_steps, q, smooth=smooth, field=field,
                           prior=prior, mesh=mesh,
                           linearize_traj=linearize_traj,
                           diffusion=diffusion)


def sample_ensemble_ek1(
    prob_f: Callable,
    prob_jac: Optional[Callable],
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
    """Joint EK1 posterior samples over an ensemble: Taylor init, standard
    normals ``(T+1, S, D, B)`` drawn from ``generator`` on the tensors'
    device, then `ek1_fused_sample`. Returns ``(T+1, d, B)`` for
    ``n_samples=1``, else ``(T+1, n_samples, d, B)``."""
    t0, t1 = tspan
    dt = (t1 - t0) / n_steps
    B, d = u0s.shape
    m0, ps_t = _taylor_init(prob_f, u0s, ps, t0, q)
    S = int(n_samples)
    normals = torch.randn((int(n_steps) + 1, S, d * (q + 1), B),
                          generator=generator, dtype=m0.dtype, device=m0.device)
    us = ek1_fused_sample(prob_f, prob_jac, m0, ps_t, normals, float(t0),
                          float(dt), n_steps, q, field=field, prior=prior,
                          mesh=mesh)
    return us[:, 0] if S == 1 else us
