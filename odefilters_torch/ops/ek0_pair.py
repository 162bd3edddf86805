"""Fused EK0 filter + RTS smoother pair: plain PyTorch versions and the
wrappers of the two CUDA kernels that replace the JAX package's Pallas pair.

==================================  =========================================
this module                         ``odefilters/ops/pallas_kernels.py``
==================================  =========================================
``pair_layout``                     ``_pair_layout``
``static_local_update``             ``_static_local_update``
``innovation``                      ``z = pb * mp[bx][j] - du[j]`` of
                                    ``_ek0_step_lists`` (float32: rounded
                                    once)
``ek0_step_core``                   ``_ek0_step_lists(collapsed=True)``
``list_chol_inv``                   ``_list_chol_inv``
``list_cho_solve_inv``              ``_list_cho_solve_inv``
``ek0_pair_bwd_step_plain``         ``_ek0_pair_bwd_step_plain``
``ek0_pair_fwd_plain`` /            ``_ek0_pair_fwd_kernel`` (CUDA:
``ek0_pair_fwd``                    ``csrc/ek0_pair.cu::ek0_pair_fwd_kernel``)
``ek0_pair_bwd_plain`` /            ``_ek0_pair_bwd_kernel(plain=True)`` (CUDA:
``ek0_pair_bwd``                    ``csrc/ek0_pair.cu::ek0_pair_bwd_kernel``)
``ek0_fused_solve``                 ``ek0_fused_solve``
``solve_ensemble_ek0_smooth``       ``solve_ensemble_ek0_pallas_smooth``
==================================  =========================================

The step bodies work on lists of per-member ``(B,)`` tensors, in the JAX
bodies' order of operations. A Python ``0.0`` entry is a structural zero:
the measured row/column ``bx`` of a committed EK0 covariance is exactly
zero after the R = 0 update, and every term through it is skipped.

Layouts follow the JAX package: the state stream is ``(T+1, V, B)`` rows
``[mean (nq*d) | active covariance upper triangle | s2]`` and the
backward's output ``(T+1, d+1, B)`` rows ``[us | raw variance]``, with the
ensemble axis last and contiguous so that a warp's accesses coalesce.

Dispatch: ``ek0_pair_fwd`` and ``ek0_pair_bwd`` run the plain version on
CPU tensors, launch the CUDA kernel on CUDA tensors, and raise on any
other device. Each counts its kernel launches in ``.launches``.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from odefilters_torch.ops._blocks import _is0, _lists, _smul, _sreduce
from odefilters_torch.ops._launch import (
    CUDA_ORDERS, check_cuda_inputs, check_field, check_ported,
    dispatch_device, host_consts, launch, suffix,
)
from odefilters_torch.priors import _ibm_small_np, precond_small

STATIC_DIFFUSIONS = ("fixed", "fixedMAP", "fixedMV")
# static diffusion -> the C entry points' mode argument (0 is dynamic)
MODES = {None: 0, "fixed": 1, "fixedMAP": 2, "fixedMV": 3}


def pair_layout(nq: int, d: int, bx: int):
    """Packed-row layout of the pair's state stream: the active upper
    triangle's ``(i, l)`` entries and the row width
    ``V = nq*d + len(triu) + 1`` (15 at q = 3, d = 2)."""
    triu = [(i, l) for i in range(nq) if i != bx
            for l in range(i, nq) if l != bx]
    return triu, nq * d + len(triu) + 1


def static_local_update(static_diff: str, calib, zz, z, inv_s, d: int):
    """Running update of a static diffusion's per-member estimate from one
    step's innovation statistic ``z^T S^-1 z`` (S = s I_d).

    ``calib = (sig, k)``: the running estimate (a ``(B,)`` tensor, or a
    list of d for ``fixedMV``) and the count of previous steps as a float
    tensor. Returns the updated ``(sig, k + 1)``."""
    sig, kf = calib
    if static_diff == "fixedMV":
        sig_new = [_fixed_run(sig[j], kf, z[j] * z[j] * inv_s)
                   for j in range(d)]
        return sig_new, kf + 1.0
    return static_scalar_update(static_diff, calib, zz * inv_s / d, d)


def _fixed_run(prev, kf, local):
    cand = prev + (local - prev) / torch.clamp(kf, min=1.0)
    return torch.where(kf == 0.0, local, cand)


def static_scalar_update(static_diff: str, calib, local, d: int):
    """The scalar models' running update from one step's statistic
    ``local`` (``z^T S^-1 z / d``): the running MLE (fixed) or the online
    InverseGamma(1/2, 1/2) MAP (fixedMAP). ``calib = (sig, k)`` as in
    `static_local_update`; returns ``(sig, k + 1)``."""
    sig, kf = calib
    if static_diff == "fixed":
        sig_new = _fixed_run(sig, kf, local)
    elif static_diff == "fixedMAP":
        alpha, beta = 0.5, 0.5
        N = kf + 1.0
        first = (beta + 0.5 * local) / (alpha + N * d / 2 + 1)
        res_prev = (sig * (alpha + (N - 1.0) * d / 2 + 1) - beta) * 2.0
        later = (beta + 0.5 * (res_prev + local)) / (alpha + N * d / 2 + 1)
        sig_new = torch.where(kf == 0.0, first, later)
    else:
        raise ValueError(f"unknown static diffusion {static_diff!r}")
    return sig_new, kf + 1.0


def innovation(pb: float, h, du):
    """The measurement residual ``pb h - du``. In float32 it is taken from
    the exact product in float64 and rounded once, as a fused multiply-add
    forms it: at the accuracy floor the rounded product cancels against
    ``du`` to exactly 0 now and then (579 of the headline ensemble's
    4,096,000 float32 steps in the pair's forward and in the filter;
    ``scripts/torch_residual_census.py``), and a step with s2 = 0 hands a
    backward pass a singular predicted factor: the backward sampler's f32
    paths of such a member then miss the f64 ones by up to O(1)
    (``scripts/torch_sampler_innovation.py``). In float64 it is the plain
    difference."""
    if h.dtype == torch.float32:
        return (float(np.float32(pb)) * h.double() - du.double()).float()
    return pb * h - du


def check_diffusion(diffusion: str) -> Optional[str]:
    """The static model's name, or None for ``"dynamic"``; raise as the JAX
    package does for any other diffusion."""
    if diffusion == "dynamic":
        return None
    if diffusion not in STATIC_DIFFUSIONS:
        raise NotImplementedError(
            f"diffusion={diffusion!r}: the fused fixed-grid kernels support "
            "dynamic / fixed / fixedMAP / fixedMV"
        )
    return str(diffusion)


def ek0_step_core(
    m, C, p, t_new, *, f: Callable, At, Qt, pinv0: float, pinv1: float,
    d: int, nq: int, static: bool = False,
):
    """One EK0 filter step on the committed covariance's active block:
    predict the mean, evaluate ``f`` at the predicted state, calibrate
    ``s2 = |z|^2 / (d hq)`` (the Python constant 1.0 under a static
    diffusion, which filters with the unscaled prior), predict the
    covariance's upper triangle, apply the R = 0 update. Measures block 1.

    ``m``: nq x d lists, ``C``: nq x nq lists of ``(B,)`` tensors (row and
    column 1 are never read); ``At``/``Qt``: nested Python floats.
    Returns ``(m_new, C_new, s2, zz, z, s, inv_s)``: the new state, with
    row/column 1 of ``C_new`` zero, the diffusion, and the innovation
    statistics that the filter's outputs are built from.
    """
    b = 1
    pb = pinv1
    hq = pb * pb * Qt[b][b]
    mp = [
        [_sreduce([_smul(At[i][l], m[l][j]) for l in range(nq)])
         for j in range(d)]
        for i in range(nq)
    ]
    u_pred = torch.stack([pinv0 * mp[0][j] for j in range(d)])
    du = f(u_pred, p, t_new)
    z = [innovation(pb, mp[b][j], du[j]) for j in range(d)]
    zz = _sreduce([zj * zj for zj in z])
    s2 = 1.0 if static else zz / (d * hq)
    act = [a for a in range(nq) if a != b]
    tmp_c = {
        (i, c): _sreduce([_smul(At[i][a], C[a][c]) for a in act])
        for i in range(nq) for c in act
    }
    Cp = [[None] * nq for _ in range(nq)]
    for i in range(nq):
        for l in range(i, nq):
            Cp[i][l] = _sreduce(
                [_smul(tmp_c[(i, c)], At[l][c]) for c in act]
                + [_smul(Qt[i][l], s2)]
            )
            Cp[l][i] = Cp[i][l]
    s = pb * pb * Cp[b][b]
    inv_s = 1.0 / s
    kg = [pb * Cp[i][b] * inv_s for i in range(nq)]
    m_new = [[mp[i][j] - kg[i] * z[j] for j in range(d)] for i in range(nq)]
    zero_c = torch.zeros_like(s)
    C_new = [[zero_c] * nq for _ in range(nq)]
    for i in act:
        for l in act:
            if l < i:
                continue
            C_new[i][l] = Cp[i][l] - kg[i] * kg[l] * s
            C_new[l][i] = C_new[i][l]
    return m_new, C_new, s2, zz, z, s, inv_s


def list_chol_inv(C, nq: int):
    """Unrolled Cholesky returning ``(L, inv_diag)``: one rsqrt per pivot,
    with the clamp inside the rsqrt only (a negative pivot gives a large
    negative factor entry, as in the JAX package)."""
    L = [[None] * nq for _ in range(nq)]
    invd = [None] * nq
    for i in range(nq):
        for j in range(i + 1):
            s = C[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                inv = torch.rsqrt(torch.clamp(s, min=1e-30))
                invd[i] = inv
                L[i][j] = s * inv
            else:
                L[i][j] = s * invd[j]
    return L, invd


def list_cho_solve_inv(L, invd, b, nq: int):
    """Solve ``L L^T x = b`` with the pivot reciprocals of `list_chol_inv`."""
    y = [None] * nq
    for i in range(nq):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s * invd[i]
    x = [None] * nq
    for i in range(nq - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, nq):
            s = s - L[k][i] * x[k]
        x[i] = s * invd[i]
    return x


def ek0_pair_bwd_step_plain(
    m_f, C_f, m_s, Cs, s2, *, At_st, QL_st, Q_st, nq: int, d: int, bx: int,
    jitter: float = 0.0,
):
    """One backward RTS step carrying the smoothed covariance plain, through
    the additive Joseph form

        C_s' = (I-GA) C_f (I-GA)^T + s2 (G QL)(G QL)^T + G C_s G^T,

    three PSD terms and no subtraction. ``Cp``'s diagonal is jittered
    relatively by ``jitter`` (1e-6 in float32, 1e-12 in float64): at steps
    whose diffusion collapses, the plain predicted covariance is
    ill-conditioned enough for an unjittered solve to amplify roundoff
    without bound. Row/column ``bx`` of ``C_f``, ``Cs`` and the result are
    structural zeros. Returns ``(m_new, Cs_new)``.
    """
    tmp = [
        [_sreduce([_smul(At_st[i][a], C_f[a][c]) for a in range(nq)])
         for c in range(nq)]
        for i in range(nq)
    ]
    Cp = [[None] * nq for _ in range(nq)]
    for i in range(nq):
        for l in range(i, nq):
            Cp[i][l] = _sreduce(
                [_smul(tmp[i][c], At_st[l][c]) for c in range(nq)]
                + [_smul(s2, Q_st[i][l])]
            )
            Cp[l][i] = Cp[i][l]
    if jitter:
        for i in range(nq):
            Cp[i][i] = Cp[i][i] * (1.0 + jitter)
    Lp, Lp_inv = list_chol_inv(Cp, nq)
    G = [[0.0] * nq for _ in range(nq)]
    for i in range(nq):
        if i == bx:
            continue
        G[i] = list_cho_solve_inv(Lp, Lp_inv, [tmp[l][i] for l in range(nq)],
                                  nq)
    mp = [
        [_sreduce([_smul(At_st[i][l], m_f[l][j]) for l in range(nq)])
         for j in range(d)]
        for i in range(nq)
    ]
    dm = [[m_s[i][j] - mp[i][j] for j in range(d)] for i in range(nq)]
    m_new = []
    for i in range(nq):
        rowm = []
        for j in range(d):
            inc = _sreduce([_smul(G[i][l], dm[l][j]) for l in range(nq)])
            rowm.append(m_f[i][j] if _is0(inc) else m_f[i][j] + inc)
        m_new.append(rowm)
    GA = [
        [_sreduce([_smul(G[i][a], At_st[a][l]) for a in range(nq)])
         for l in range(nq)]
        for i in range(nq)
    ]
    IGA = [
        [(1.0 - GA[i][l]) if i == l else
         (0.0 - GA[i][l] if not _is0(GA[i][l]) else 0.0)
         for l in range(nq)]
        for i in range(nq)
    ]
    Y = [
        [_sreduce([_smul(IGA[i][a], C_f[a][c]) for a in range(nq)])
         for c in range(nq)]
        for i in range(nq)
    ]
    GL = [
        [_sreduce([_smul(G[i][a], QL_st[a][l]) for a in range(nq)])
         for l in range(nq)]
        for i in range(nq)
    ]
    V = [
        [_sreduce([_smul(G[i][a], Cs[a][c]) for a in range(nq)])
         for c in range(nq)]
        for i in range(nq)
    ]
    Cs_new = [[0.0] * nq for _ in range(nq)]
    for i in range(nq):
        if i == bx:
            continue
        for l in range(i, nq):
            if l == bx:
                continue
            b1 = _sreduce([_smul(Y[i][c], IGA[l][c]) for c in range(nq)])
            b2 = _smul(s2, _sreduce(
                [_smul(GL[i][k], GL[l][k]) for k in range(nq)]
            ))
            b3 = _sreduce([_smul(V[i][c], G[l][c]) for c in range(nq)])
            Cs_new[i][l] = _sreduce([b1, b2, b3])
            Cs_new[l][i] = Cs_new[i][l]
    return m_new, Cs_new


def step_times(t0: float, dt: float, n_steps: int, dtype, device):
    """``t_{k+1} = t0 + dt (k+1)`` for k < n_steps in the working dtype,
    never accumulated."""
    return (torch.tensor(t0, dtype=dtype, device=device)
            + torch.tensor(dt, dtype=dtype, device=device)
            * torch.arange(1, n_steps + 1, dtype=dtype, device=device))


def pack_row(row: torch.Tensor, m, C, s2, triu) -> None:
    """Write one packed stream row ``[mean | active triangle | s2]``."""
    vals = [x for mi in m for x in mi] + [C[i][l] for (i, l) in triu] + [s2]
    torch.stack(vals, out=row)


def unpack_row(row: torch.Tensor, nq: int, d: int, triu):
    """``(m, C, s2)`` from a packed row; C's row/column 1 are Python 0.0."""
    m = [[row[i * d + j] for j in range(d)] for i in range(nq)]
    C = [[0.0] * nq for _ in range(nq)]
    for idx, (i, l) in enumerate(triu, start=nq * d):
        C[i][l] = row[idx]
        C[l][i] = C[i][l]
    return m, C, row[nq * d + len(triu)]


def ek0_pair_fwd_plain(
    f: Callable, m0_p: torch.Tensor, ps: torch.Tensor, *, At, Qt,
    pinv0: float, pinv1: float, t0: float, dt: float, n_steps: int,
    static_diff: Optional[str] = None,
):
    """Forward filter of the pair: ``(T+1, V, B)`` stream of packed rows
    ``[mean | active covariance triangle | s2]`` from the preconditioned
    initial means ``m0_p`` ``(nq, d, B)`` and parameters ``ps``
    ``(n_params, B)``. Row 0 is the exact initial state with s2 = 1.

    Under a static diffusion the filter runs with the unscaled prior and
    streams s2 = 1 rows; it returns ``(st, sig)`` with ``sig`` the
    calibrated sigma^2 after the last step, ``(B,)`` or ``(d, B)`` for
    fixedMV."""
    nq, d, B = m0_p.shape
    T = int(n_steps)
    triu, V = pair_layout(nq, d, 1)
    At, Qt = _lists(At), _lists(Qt)
    dtype, device = m0_p.dtype, m0_p.device
    st = torch.empty((T + 1, V, B), dtype=dtype, device=device)
    m = [[m0_p[i, j] for j in range(d)] for i in range(nq)]
    zero = torch.zeros_like(m[0][0])
    C = [[zero] * nq for _ in range(nq)]
    one = zero + 1.0
    pack_row(st[0], m, C, one, triu)
    calib = ([zero] * d if static_diff == "fixedMV" else zero, zero)
    ts = step_times(t0, dt, T, dtype, device)
    for k in range(T):
        m, C, s2, zz, z, _, inv_s = ek0_step_core(
            m, C, ps, ts[k], f=f, At=At, Qt=Qt, pinv0=pinv0, pinv1=pinv1,
            d=d, nq=nq, static=static_diff is not None,
        )
        if static_diff is not None:
            calib = static_local_update(static_diff, calib, zz, z, inv_s, d)
            s2 = one
        pack_row(st[k + 1], m, C, s2, triu)
    if static_diff is None:
        return st
    sig = calib[0]
    return st, torch.stack(sig) if static_diff == "fixedMV" else sig


def ek0_pair_bwd_plain(
    st: torch.Tensor, *, nq: int, d: int, At, Qt, QLt, pinv0: float,
    jitter: float,
) -> torch.Tensor:
    """Backward RTS pass of the pair over the stream ``st``: ``(T+1, d+1, B)``
    rows ``[pinv0 * smoothed mean of block 0 | raw smoothed variance]``.

    The step from t_k uses the diffusion of interval k -> k+1, which the
    forward stored in row k+1; it is carried over from the previous
    (later) row."""
    bx = 1
    T = st.shape[0] - 1
    B = st.shape[2]
    triu, _ = pair_layout(nq, d, bx)
    At_st, QL_st, Q_st = _lists(At), _lists(QLt), _lists(Qt)
    out = torch.empty((T + 1, d + 1, B), dtype=st.dtype, device=st.device)

    def read(k):
        return unpack_row(st[k], nq, d, triu)

    def emit(k, m, var):
        torch.stack([pinv0 * m[0][j] for j in range(d)] + [var], out=out[k])

    m_s, Cs, s2 = read(T)
    emit(T, m_s, Cs[0][0])
    for k in range(T - 1, -1, -1):
        m_f, C_f, s2_k = read(k)
        m_s, Cs = ek0_pair_bwd_step_plain(
            m_f, C_f, m_s, Cs, s2, At_st=At_st, QL_st=QL_st, Q_st=Q_st,
            nq=nq, d=d, bx=bx, jitter=jitter,
        )
        emit(k, m_s, Cs[0][0])
        s2 = s2_k
    return out


def ek0_pair_fwd(
    f: Callable, field: Optional[str], m0_p: torch.Tensor, ps: torch.Tensor,
    *, At, Qt, pinv0: float, pinv1: float, t0: float, dt: float,
    n_steps: int, static_diff: Optional[str] = None,
):
    """The pair's forward filter: `ek0_pair_fwd_plain` on CPU tensors, the
    CUDA kernel ``ek0_pair_fwd_kernel`` on CUDA tensors (vector field
    ``field``, see ``_launch.CUDA_FIELDS``). Returns the stream, and
    ``(st, sig)`` under a static diffusion."""
    if dispatch_device("ek0_pair_fwd", m0_p) == "cpu":
        return ek0_pair_fwd_plain(
            f, m0_p, ps, At=At, Qt=Qt, pinv0=pinv0, pinv1=pinv1, t0=t0,
            dt=dt, n_steps=n_steps, static_diff=static_diff,
        )
    nq, d, B = m0_p.shape
    check_field("ek0_pair_fwd", field, nq, d, B, ps)
    check_cuda_inputs("ek0_pair_fwd", {"m0_p": m0_p, "ps": ps}, m0_p.dtype)
    T = int(n_steps)
    _, V = pair_layout(nq, d, 1)
    new = dict(dtype=m0_p.dtype, device=m0_p.device)
    st = torch.empty((T + 1, V, B), **new)
    sig = None
    if static_diff is not None:
        sig = torch.empty((d, B) if static_diff == "fixedMV" else (B,), **new)
    launch(ek0_pair_fwd, m0_p.device,
           f"ek0_pair_fwd_{field}_{suffix(m0_p.dtype)}",
           m0_p.data_ptr(), ps.data_ptr(), st.data_ptr(),
           None if sig is None else sig.data_ptr(), B, T, MODES[static_diff],
           host_consts(At, Qt, scalars=(pinv0, pinv1, t0, dt)))
    return st if sig is None else (st, sig)


ek0_pair_fwd.launches = 0


def ek0_pair_bwd(
    st: torch.Tensor, *, nq: int, d: int, At, Qt, QLt, pinv0: float,
    jitter: float,
) -> torch.Tensor:
    """The pair's backward smoother: `ek0_pair_bwd_plain` on CPU tensors,
    the CUDA kernel ``ek0_pair_bwd_kernel`` on CUDA tensors."""
    if dispatch_device("ek0_pair_bwd", st) == "cpu":
        return ek0_pair_bwd_plain(
            st, nq=nq, d=d, At=At, Qt=Qt, QLt=QLt, pinv0=pinv0, jitter=jitter,
        )
    _, V = pair_layout(nq, d, 1)
    if (nq - 1 not in CUDA_ORDERS or d != 2 or st.ndim != 3
            or st.shape[1] != V):
        raise ValueError(
            f"ek0_pair_bwd: the kernel takes nq - 1 in {CUDA_ORDERS}, d = 2 "
            f"and a (T+1, {V}, B) stream; got nq={nq}, d={d}, "
            f"{tuple(st.shape)}"
        )
    check_cuda_inputs("ek0_pair_bwd", {"st": st}, st.dtype)
    T, B = st.shape[0] - 1, st.shape[2]
    out = torch.empty((T + 1, d + 1, B), dtype=st.dtype, device=st.device)
    launch(ek0_pair_bwd, st.device, f"ek0_pair_bwd_{suffix(st.dtype)}",
           st.data_ptr(), out.data_ptr(), B, T,
           host_consts(At, Qt, QLt, scalars=(pinv0, 1.0 + jitter)))
    return out


ek0_pair_bwd.launches = 0


def pair_constants(q: int, dt: float):
    """Host-side constants of the pair on a uniform grid of step ``dt``:
    ``(At, Qt, QLt, p)`` as float64 numpy, with ``Qt = QLt QLt^T`` and the
    preconditioner ``p``."""
    At, _, QLt = _ibm_small_np(q)
    p, _ = precond_small(dt, q)
    return At, QLt @ QLt.T, QLt, p


def ek0_fused_solve(
    f: Callable,
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
    second_order: bool = False,
    diffusion: str = "dynamic",
    _bwd_plain: bool = True,
):
    """Complete fused probabilistic solve: the pair's filter and RTS
    smoother.

    ``m0``: ``(q+1, d, B)`` unpreconditioned Taylor initial means; ``ps``:
    ``(n_params, B)``. Returns ``(us, stds)``, the smoothed posterior means
    and stds of the solution, shapes ``(T+1, d, B)`` and ``(T+1, B)``.

    ``diffusion``: ``"dynamic"``, or a static model ``"fixed"`` /
    ``"fixedMAP"`` / ``"fixedMV"``: the pair then runs on the unscaled prior
    and returns ``(us, stds, sigma2)``, the calibrated per-member diffusion
    ``(B,)`` (``(d, B)`` for fixedMV, whose stds are then
    ``(T+1, d, B)``), with the stds rescaled by ``sqrt(sigma2)`` at exit.
    """
    check_ported(prior=prior, second_order=second_order, mesh=mesh)
    static = check_diffusion(diffusion)
    if not _bwd_plain:
        raise NotImplementedError(
            "the square-root backward (_bwd_plain=False) is not ported yet "
            "(ROADMAP.md queue 1, the square-root pair backward)"
        )
    nq = q + 1
    _, d, _ = m0.shape
    T = int(n_steps)
    At, Qt, QLt, p = pair_constants(q, dt)
    pinv0 = float(1.0 / p[0])
    m0_p = torch.as_tensor(p, dtype=m0.dtype, device=m0.device)[:, None, None] * m0
    st = ek0_pair_fwd(
        f, field, m0_p, ps, At=At, Qt=Qt, pinv0=pinv0,
        pinv1=float(1.0 / p[1]), t0=float(t0), dt=float(dt), n_steps=T,
        static_diff=static,
    )
    if static is not None:
        st, sig = st
    jit_eps = 1e-6 if m0.dtype == torch.float32 else 1e-12
    out = ek0_pair_bwd(st, nq=nq, d=d, At=At, Qt=Qt, QLt=QLt, pinv0=pinv0,
                       jitter=jit_eps)
    us = out[:, :d]
    stds = pinv0 * torch.sqrt(torch.clamp(out[:, d], min=0.0))
    if static is None:
        return us, stds
    # exit rescale: the smoother ran on sigma^2 = 1 covariances, and a
    # uniform scale commutes with the RTS recursion (the gain is
    # scale-invariant), so scaling the stds is smoothing the rescaled states
    if static == "fixedMV":
        stds = stds[:, None, :] * torch.sqrt(sig)[None]
    else:
        stds = stds * torch.sqrt(sig)[None]
    return us, stds, sig


def solve_ensemble_ek0_smooth(
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
    """Taylor init + the fused filter + the fused RTS smoother over an
    ensemble: ``u0s`` ``(B, d)``, ``ps`` ``(B, n_params)``. Returns what
    `ek0_fused_solve` returns; it checks the options."""
    from odefilters_torch.taylor import taylor_coefficients

    t0, t1 = tspan
    dt = (t1 - t0) / n_steps
    # contiguous copies: forward-mode AD refuses inputs whose elements
    # alias one another, as in an expanded (broadcast) ensemble
    ps_t = ps.T.contiguous()
    m0 = torch.stack(taylor_coefficients(prob_f, u0s.T.contiguous(), ps_t, t0, q))
    return ek0_fused_solve(prob_f, m0, ps_t, float(t0), float(dt), n_steps, q,
                           field=field, prior=prior, mesh=mesh,
                           diffusion=diffusion)
