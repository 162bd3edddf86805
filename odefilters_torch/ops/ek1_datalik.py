"""Dense EK1 data likelihood: the per-member marginal log-likelihood of
observations of any linear map of the solution, and its exact gradient.
Plain PyTorch versions and the wrappers of the three CUDA kernels that
replace the JAX package's Pallas EK1 data-likelihood kernels and their
custom VJP.

=====================================  ======================================
this module                            ``odefilters/ops/pallas_kernels.py``
=====================================  ======================================
``ek1_step(want_stats=True)``          ``_ek1_step_lists(want_ll=True)``
(``ek1_fused``)
``ek1_data_update``                    ``_ek1_data_update_lists``
``layout`` / ``pack_state`` /          ``_ek1_pack_and_send``'s row (here
``unpack_state``                       ``[m | L]``; JAX: row r ``[L[r] |
                                       m[r]]``)
``ek1_datalik_plain`` /                ``_ek1_datalik_kernel`` via
``ek1_datalik``                        ``_ek1_datalik_blocked`` (CUDA:
                                       ``csrc/ek1_datalik.cu::
                                       ek1_datalik_kernel``)
``ek1_datalik_fwd_stream_plain`` /     ``_ek1_datalik_grad_fwd_kernel`` via
``ek1_datalik_grad_fwd``               ``_ek1_datalik_vjp_fwd`` (CUDA:
                                       ``ek1_datalik_grad_fwd_kernel``)
``ek1_datalik_grad_bwd_plain`` /       ``_ek1_datalik_grad_bwd_kernel`` via
``ek1_datalik_grad_bwd``               ``_ek1_datalik_vjp_bwd`` (CUDA:
                                       ``ek1_datalik_grad_bwd_kernel``)
``EK1DataLik``                         the ``jax.custom_vjp``
                                       ``_ek1_datalik_vjp``
``mgs_tril_vjp``                       (none: the reverse of
                                       ``_list_mgs_tril`` that the CUDA
                                       adjoint runs, for the tests)
=====================================  ======================================

The filter is the square-root EK1 filter with the dynamic diffusion
(`ek1_fused.ek1_step`) on the flat derivative-major state, ``D = d (q+1)``
entries, and its D x D factor ``L``. After the steps that end at an
observation time a second update conditions on ``y = C u(t) + e``, ``e ~
N(0, R R^T)``, ``C`` any ``(d_obs, d)`` matrix and ``R`` a lower factor,
in Joseph square-root form: the new factor is one modified Gram-Schmidt
(MGS) QR of the ``(D + d_obs) x D`` stack ``[L - K Z | K R]^T`` (``Z = C
P0 L``), and ``log N(y; C P0 m, Z Z^T + R R^T)`` is added to the data
log-likelihood. The schedule is the on-grid step table of
`ek0_datalik.step_table` (base steps only: the JAX package runs this path
on the grid only).

The gradient's forward streams the state at entry of every step, after any
data update, as rows ``(T, V, B)``, ``[m (D) | L (D*D, row-major)]`` (V =
72 at q = 3, d = 2; `layout`). The backward walks it in reverse: the
adjoint of the data update where one follows the step, then that of the
step, through the vector field, its Jacobian (``J`` enters ``H``, hence
the calibration, ``Z``, the gain and the new factor), both MGS QRs, the
Cholesky factors and, unless ``stop_calib``, ``s2``. Its plain version is
``torch.func.vjp`` of the composed step; the CUDA kernel is a hand-written
adjoint, a group of D lanes per member (`mgs_tril_vjp` is its MGS reverse,
which the kernel runs from each stage's kept state). The observations'
cotangent is written per member, ``(n_obs, d_obs, B)``, and summed over the
members by one ``torch.sum`` when they are shared.

Dispatch: each wrapper runs its plain version on CPU tensors, launches its
CUDA kernel on CUDA tensors (which evaluates the CUDA field and its own
Jacobian, ``fields.cuh``), raises on any other device, and counts its
launches in ``.launches``. `EK1DataLik` launches the primal kernel when no
input needs a gradient and the two gradient kernels otherwise.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional

import numpy as np
import torch

from odefilters_torch.ops import _launch
from odefilters_torch.ops._blocks import _is0, _smul, _sreduce
from odefilters_torch.ops.ek0_sample import list_cho_solve, list_mgs_tril
from odefilters_torch.ops.ek1_fused import (
    _sum, ek1_step, kron_lists, list_chol,
)

_LOG_2PI = math.log(2.0 * math.pi)
# The kernels hold the observation model in registers, unrolled over its
# rows: at most DOBS_MAX observed rows (``csrc/ek1_datalik.cuh``).
DOBS_MAX = 4


# -- the stream's row ------------------------------------------------------


def layout(D: int) -> int:
    """Values per stream row: the mean (D) and the factor (D*D), 72 at
    D = 8."""
    return D + D * D


def pack_state(m, L):
    """The state ``(m, L)`` as the stream row's values: ``m[0..D-1]``,
    then ``L`` row by row."""
    return list(m) + [x for row in L for x in row]


def unpack_state(row, D: int):
    """The inverse of `pack_state`: ``(m, L)`` from one step's row."""
    m = [row[r] for r in range(D)]
    L = [[row[D + r * D + c] for c in range(D)] for r in range(D)]
    return m, L


def stream_dims(V: int, nq: int) -> int:
    """The state dimension d of a stream of ``V = D + D*D`` values per
    step."""
    return (math.isqrt(4 * V + 1) - 1) // 2 // nq


# -- the data update -------------------------------------------------------


def ek1_data_update(m, L, y_row, *, C_obs, R_chol, pinv0: float, d: int,
                    D: int):
    """The joint noisy update on observation ``y_row`` (d_obs entries) in
    Joseph square-root form: ``(m_new, L_new, dll_inc)``. ``C_obs``
    ``(d_obs, d)`` acts on the solution block, ``R_chol`` ``(d_obs,
    d_obs)`` is the lower noise factor, both numpy arrays in the solve's
    dtype (their zero entries are skipped, ``R R^T`` is formed in that
    dtype, as the JAX kernel forms it). The inputs are left as they
    are."""
    d_obs = C_obs.shape[0]
    RRT = R_chol @ R_chol.T
    C = [[float(x) for x in row] for row in C_obs]
    R = [[float(x) for x in row] for row in R_chol]
    zero = torch.zeros_like(m[0])
    z = [y_row[a] - _sum([zero] + [C[a][j] * (pinv0 * m[j]) for j in range(d)
                                   if C[a][j] != 0.0])
         for a in range(d_obs)]
    Z = [[_sum([zero] + [C[a][j] * (pinv0 * L[j][c]) for j in range(d)
                         if C[a][j] != 0.0])
          for c in range(D)] for a in range(d_obs)]
    S = [[_sum([Z[a][c] * Z[b][c] for c in range(D)]) + float(RRT[a, b])
          for b in range(d_obs)] for a in range(d_obs)]
    Ls = list_chol(S, d_obs)
    w = list_cho_solve(Ls, z, d_obs)
    zSz = _sum([z[a] * w[a] for a in range(d_obs)])
    logdet = _sum([2.0 * torch.log(torch.clamp(Ls[a][a], min=1e-30))
                   for a in range(d_obs)])
    dll_inc = -0.5 * (zSz + logdet + d_obs * _LOG_2PI)
    LZt = [[_sum([L[r][c] * Z[a][c] for c in range(D)]) for a in range(d_obs)]
           for r in range(D)]
    Kg = [list_cho_solve(Ls, LZt[r], d_obs) for r in range(D)]
    m_new = [m[r] + _sum([Kg[r][a] * z[a] for a in range(d_obs)])
             for r in range(D)]
    # rows k < D: column k of L - K Z; rows D + a: column a of K R
    rows = [[L[r][k] - _sum([Kg[r][a] * Z[a][k] for a in range(d_obs)])
             for r in range(D)] for k in range(D)]
    rows += [[_sum([zero] + [Kg[r][b] * R[b][a] for b in range(d_obs)
                             if R[b][a] != 0.0])
              for r in range(D)] for a in range(d_obs)]
    return m_new, list_mgs_tril(rows, D + d_obs, D), dll_inc


# -- the MGS reverse -------------------------------------------------------


def mgs_tril_vjp(rows, K: int, nq: int, gL):
    """The cotangent of the ``K x nq`` stack ``rows`` given the cotangent
    ``gL`` of `list_mgs_tril`'s lower factor (its upper entries unread),
    as the CUDA adjoint reverses the MGS: column by column from the last,
    each stage's state recomputed from ``rows`` in the forward's order of
    operations (the kernel keeps each stage's state from its forward
    instead: the same values), then its products, the normalisation and
    the pivot ``sqrt(max(ss, 1e-30))`` reversed line by line. Python
    ``0.0`` entries of ``rows`` are structural zeros, skipped as the
    forward skips them; they get the cotangent ``0.0``.

    Line by line, not the closed form ``Q copyltu(R gR^T) R^-T``: after an
    EK1 step's R = 0 update the factor has rank D - d, so the data
    update's stack is singular."""
    zero = torch.zeros_like(next(x for r in rows for x in r if not _is0(x)))
    gv = [[zero] * nq for _ in range(K)]
    for j in range(nq - 1, -1, -1):
        # the state at stage j, recomputed as list_mgs_tril forms it
        v = [[rows[k][i] for i in range(nq)] for k in range(K)]
        for i in range(j + 1):
            ss = _sreduce([_smul(v[k][i], v[k][i]) for k in range(K)])
            if _is0(ss):
                ss = zero
            Rii = torch.sqrt(torch.clamp(ss, min=1e-30))
            inv = 1.0 / Rii
            q = [_smul(v[k][i], inv) for k in range(K)]
            if i == j:
                break
            for l in range(i + 1, nq):
                r = _sreduce([_smul(q[k], v[k][l]) for k in range(K)])
                if _is0(r):
                    continue
                for k in range(K):
                    if not _is0(q[k]):
                        v[k][l] = (-r * q[k] if _is0(v[k][l])
                                   else v[k][l] - r * q[k])
        ks = [k for k in range(K) if not _is0(q[k])]
        gq = [zero] * K
        for l in range(j + 1, nq):
            r = _sreduce([_smul(q[k], v[k][l]) for k in range(K)])
            if _is0(r):
                continue
            # v[k][l] -= r q[k]
            gr = gL[l][j] - _sum([gv[k][l] * q[k] for k in ks])
            for k in ks:
                gq[k] = gq[k] - r * gv[k][l]
            # r = sum_k q[k] v[k][l]
            for k in ks:
                if not _is0(v[k][l]):
                    gq[k] = gq[k] + gr * v[k][l]
                    gv[k][l] = gv[k][l] + gr * q[k]
        # q[k] = v[k][j] inv, inv = 1 / Rjj, Rjj = sqrt(max(ss, 1e-30))
        ginv = _sum([gq[k] * v[k][j] for k in ks])
        gRjj = gL[j][j] - ginv * inv * inv
        gss = torch.where(ss >= 1e-30, gRjj / (2.0 * Rii), zero)
        for k in ks:
            gv[k][j] = gv[k][j] + gq[k] * inv + 2.0 * gss * v[k][j]
    return [[0.0 if _is0(rows[k][i]) else gv[k][i] for i in range(nq)]
            for k in range(K)]


# -- the plain versions over the step table --------------------------------


def _fns(f, jac, consts, d, nq, stop_calib=False):
    """The step ``(m, L, p, t) -> (m, L, ll_inc)`` and the data update of
    ``consts`` (``At, QLt, pinv0, pinv1, C_obs, R_chol``)."""
    D = d * nq
    kw = dict(f=f, jac=jac, Af=kron_lists(consts["At"], d),
              QLf=kron_lists(consts["QLt"], d), pinv0=consts["pinv0"],
              pinv1=consts["pinv1"], d=d, D=D, want_stats=True,
              stop_calib=stop_calib)

    def step(m, L, p, t):
        m1, L1, _, _, ll_inc = ek1_step(m, L, p, t, **kw)
        return m1, L1, ll_inc

    dupd = functools.partial(ek1_data_update, C_obs=consts["C_obs"],
                             R_chol=consts["R_chol"], pinv0=consts["pinv0"],
                             d=d, D=D)
    return step, dupd


def _y_row(ys, r: int, d_obs: int):
    """Observation row ``r``: 0-dim tensors (shared) or ``(B,)`` ones."""
    return [ys[r, a] for a in range(d_obs)]


def _walk(f, jac, m0_p, ps, ys, table, consts, st=None):
    """The forward over the table; writes the stream ``st`` if given."""
    nq, d, _ = m0_p.shape
    D = d * nq
    d_obs = consts["C_obs"].shape[0]
    step, dupd = _fns(f, jac, consts, d, nq)
    m = [m0_p[i // d, i % d] for i in range(D)]
    zero = torch.zeros_like(m[0])
    L = [[zero] * D for _ in range(D)]
    ll = dll = zero
    for k in range(table.n_steps):
        if st is not None:
            torch.stack(pack_state(m, L), out=st[k])
        m, L, ll_inc = step(m, L, ps, table.times[k])
        ll = ll + ll_inc
        r = table.rows[k]
        if r >= 0:
            m, L, dll_inc = dupd(m, L, _y_row(ys, r, d_obs))
            dll = dll + dll_inc
    return dll, ll


def ek1_datalik_plain(f: Callable, jac: Callable, m0_p, ps, ys, table,
                      **consts):
    """The primal: ``(dll, ll)``, each ``(B,)``, from the preconditioned
    initial means ``m0_p`` ``(nq, d, B)``, the parameters ``ps``
    ``(n_params, B)`` and the observations ``ys`` ``(n_obs, d_obs)`` or
    ``(n_obs, d_obs, B)``; ``jac`` the Jacobian ``(u, p, t) -> (d, d,
    B)``."""
    return _walk(f, jac, m0_p, ps, ys, table, consts)


def ek1_datalik_fwd_stream_plain(f: Callable, jac: Callable, m0_p, ps, ys,
                                 table, **consts):
    """The gradient's forward: ``(dll, ll, st)`` with ``st`` ``(T, V, B)``
    the state at entry of every step (`layout`)."""
    nq, d, B = m0_p.shape
    st = torch.empty((table.n_steps, layout(d * nq), B), dtype=m0_p.dtype,
                     device=m0_p.device)
    dll, ll = _walk(f, jac, m0_p, ps, ys, table, consts, st=st)
    return dll, ll, st


def ek1_datalik_grad_bwd_plain(
    f: Callable, jac: Callable, st, ps, ys, ddll, dall, table, *, nq: int,
    stop_calib: bool = False, **consts,
):
    """The adjoint sweep: from step T-1 down to 0, ``torch.func.vjp`` of
    the step composed with the data update that follows it, with the
    cotangents ``ddll`` of the data log-likelihood and ``dall`` of the ODE
    one (each ``(B,)``). Returns ``(dm0_p (nq, d, B), dps, dy_part)`` with
    the observations' cotangent per member, ``(n_obs, d_obs, B)``."""
    T, V, B = st.shape
    d = stream_dims(V, nq)
    D = d * nq
    n_obs, d_obs = ys.shape[:2]
    step, dupd = _fns(f, jac, consts, d, nq, stop_calib)

    def step_data(m, L, p, y, t):
        m1, L1, ll_inc = step(m, L, p, t)
        m2, L2, dll_inc = dupd(m1, L1, y)
        return m2, L2, ll_inc, dll_inc

    zero = torch.zeros_like(ddll)
    dm = [zero] * D
    dL = [[zero] * D for _ in range(D)]
    dp = torch.zeros_like(ps)
    dy_part = torch.zeros((n_obs, d_obs, B), dtype=st.dtype, device=st.device)
    for k in range(T - 1, -1, -1):
        m_k, L_k = unpack_state(st[k], D)
        t, r = table.times[k], table.rows[k]
        if r >= 0:
            y_b = [y.expand(B).contiguous() for y in _y_row(ys, r, d_obs)]
            _, vjp_fn = torch.func.vjp(
                lambda m, L, p, y: step_data(m, L, p, y, t), m_k, L_k, ps, y_b)
            dm, dL, dp_k, dy_k = vjp_fn((dm, dL, dall, ddll))
            for a in range(d_obs):
                dy_part[r, a] = dy_k[a]
        else:
            _, vjp_fn = torch.func.vjp(lambda m, L, p: step(m, L, p, t),
                                       m_k, L_k, ps)
            dm, dL, dp_k = vjp_fn((dm, dL, dall))
        dp = dp + dp_k
    dm0 = torch.stack([torch.stack([dm[i * d + j] for j in range(d)])
                       for i in range(nq)])
    return dm0, dp, dy_part


# -- the kernels' wrappers -------------------------------------------------


def _host_consts(consts):
    """The kernels' constants: At, QLt, pinv0, pinv1, d_obs, then C_obs
    (d_obs x d), R_chol and R R^T (d_obs x d_obs each, formed in the
    solve's dtype as the plain version forms it), row-major."""
    C, R = consts["C_obs"], consts["R_chol"]
    return _launch.host_consts(
        consts["At"], consts["QLt"],
        scalars=(consts["pinv0"], consts["pinv1"], C.shape[0], *C.ravel(),
                 *R.ravel(), *(R @ R.T).ravel()))


def _check_inputs(name, field, shape, ps, ys, table, consts):
    """Raise unless the kernels take these inputs; ``shape``: the initial
    means' ``(nq, d, B)``."""
    nq, d, B = shape
    _launch.check_field(name, field, nq, d, B, ps, need_jac=True)
    d_obs = consts["C_obs"].shape[0]
    if not 1 <= d_obs <= DOBS_MAX:
        raise ValueError(f"{name}: the kernels take 1 to {DOBS_MAX} observed "
                         f"rows, got {d_obs}")
    np_dtype = np.float32 if ps.dtype == torch.float32 else np.float64
    for cname in ("C_obs", "R_chol"):
        if consts[cname].dtype != np_dtype:
            raise TypeError(f"{name}: {cname} is {consts[cname].dtype}, the "
                            f"inputs {ps.dtype}")
    n_obs = sum(r >= 0 for r in table.rows)
    want = ((n_obs, d_obs), (n_obs, d_obs, B))
    if tuple(ys.shape) not in want:
        raise ValueError(f"{name}: ys must be {want[0]} or {want[1]}, got "
                         f"{tuple(ys.shape)}")
    if any(s != 0 for s in table.sets):
        raise ValueError(f"{name}: the EK1 path runs on the grid only (base "
                         "steps)")
    _launch.check_cuda_inputs(name, {"ps": ps, "ys": ys, "times": table.times},
                              ps.dtype)
    _launch.check_cuda_inputs(name, {"codes": table.codes}, torch.int32)
    if table.codes.device != ps.device:
        raise ValueError(f"{name}: the step table is on {table.codes.device}, "
                         f"the inputs on {ps.device}")


def ek1_datalik(f: Callable, jac: Callable, field: Optional[str], m0_p, ps,
                ys, table, **consts):
    """The primal: `ek1_datalik_plain` on CPU tensors, the CUDA kernel
    ``ek1_datalik_kernel`` on CUDA tensors. Returns ``(dll, ll)``."""
    if _launch.dispatch_device("ek1_datalik", m0_p) == "cpu":
        return ek1_datalik_plain(f, jac, m0_p, ps, ys, table, **consts)
    _check_inputs("ek1_datalik", field, m0_p.shape, ps, ys, table, consts)
    _launch.check_cuda_inputs("ek1_datalik", {"m0_p": m0_p, "ps": ps},
                              m0_p.dtype)
    B = m0_p.shape[2]
    new = dict(dtype=m0_p.dtype, device=m0_p.device)
    dll, ll = torch.empty((B,), **new), torch.empty((B,), **new)
    _launch.launch(ek1_datalik, m0_p.device,
                   f"ek1_datalik_{field}_{_launch.suffix(m0_p.dtype)}",
                   m0_p.data_ptr(), ps.data_ptr(), ys.data_ptr(),
                   table.times.data_ptr(), table.codes.data_ptr(),
                   dll.data_ptr(), ll.data_ptr(), B, table.n_steps,
                   int(ys.ndim == 3), _host_consts(consts))
    return dll, ll


ek1_datalik.launches = 0


def ek1_datalik_grad_fwd(f: Callable, jac: Callable, field: Optional[str],
                         m0_p, ps, ys, table, **consts):
    """The gradient's forward: `ek1_datalik_fwd_stream_plain` on CPU
    tensors, the CUDA kernel ``ek1_datalik_grad_fwd_kernel`` on CUDA
    tensors. Returns ``(dll, ll, st)``."""
    if _launch.dispatch_device("ek1_datalik_grad_fwd", m0_p) == "cpu":
        return ek1_datalik_fwd_stream_plain(f, jac, m0_p, ps, ys, table,
                                            **consts)
    _check_inputs("ek1_datalik_grad_fwd", field, m0_p.shape, ps, ys, table,
                  consts)
    _launch.check_cuda_inputs("ek1_datalik_grad_fwd",
                              {"m0_p": m0_p, "ps": ps}, m0_p.dtype)
    nq, d, B = m0_p.shape
    new = dict(dtype=m0_p.dtype, device=m0_p.device)
    dll, ll = torch.empty((B,), **new), torch.empty((B,), **new)
    st = torch.empty((table.n_steps, layout(d * nq), B), **new)
    _launch.launch(
        ek1_datalik_grad_fwd, m0_p.device,
        f"ek1_datalik_grad_fwd_{field}_{_launch.suffix(m0_p.dtype)}",
        m0_p.data_ptr(), ps.data_ptr(), ys.data_ptr(), table.times.data_ptr(),
        table.codes.data_ptr(), dll.data_ptr(), ll.data_ptr(), st.data_ptr(),
        B, table.n_steps, int(ys.ndim == 3), _host_consts(consts))
    return dll, ll, st


ek1_datalik_grad_fwd.launches = 0


def ek1_datalik_grad_bwd(
    f: Callable, jac: Callable, field: Optional[str], st, ps, ys, ddll, dall,
    table, *, nq: int, stop_calib: bool = False, **consts,
):
    """The adjoint sweep: `ek1_datalik_grad_bwd_plain` on CPU tensors, the
    CUDA kernel ``ek1_datalik_grad_bwd_kernel`` (hand-written adjoint) on
    CUDA tensors. Returns ``(dm0_p, dps, dys)``: ``dys`` per member
    ``(n_obs, d_obs, B)`` for per-member observations, summed over the
    members ``(n_obs, d_obs)`` for shared ones."""
    if _launch.dispatch_device("ek1_datalik_grad_bwd", st) == "cpu":
        dm0, dps, dy_part = ek1_datalik_grad_bwd_plain(
            f, jac, st, ps, ys, ddll, dall, table, nq=nq,
            stop_calib=stop_calib, **consts)
    else:
        T, V, B = st.shape
        name = "ek1_datalik_grad_bwd"
        d = stream_dims(V, nq)
        _check_inputs(name, field, (nq, d, B), ps, ys, table, consts)
        if (V != layout(d * nq) or T != table.n_steps
                or tuple(ddll.shape) != (B,) or tuple(dall.shape) != (B,)):
            raise ValueError(
                f"{name}: takes st ({table.n_steps}, {layout(d * nq)}, B), "
                f"ddll (B,), dall (B,); got {tuple(st.shape)}, "
                f"{tuple(ddll.shape)}, {tuple(dall.shape)}")
        _launch.check_cuda_inputs(name, {"st": st, "ps": ps, "ddll": ddll,
                                         "dall": dall}, st.dtype)
        n_obs, d_obs = ys.shape[:2]
        new = dict(dtype=st.dtype, device=st.device)
        dm0 = torch.empty((nq, d, B), **new)
        dps = torch.empty(tuple(ps.shape), **new)
        dy_part = torch.zeros((n_obs, d_obs, B), **new)
        _launch.launch(
            ek1_datalik_grad_bwd, st.device,
            f"{name}_{field}_{_launch.suffix(st.dtype)}",
            st.data_ptr(), ps.data_ptr(), ys.data_ptr(),
            table.times.data_ptr(), table.codes.data_ptr(), ddll.data_ptr(),
            dall.data_ptr(), dm0.data_ptr(), dps.data_ptr(),
            dy_part.data_ptr(), B, T, int(ys.ndim == 3), int(stop_calib),
            _host_consts(consts))
    dys = dy_part if ys.ndim == 3 else torch.sum(dy_part, dim=-1)
    return dm0, dps, dys


ek1_datalik_grad_bwd.launches = 0


class EK1DataLik(torch.autograd.Function):
    """The dense EK1 data likelihood as an autograd node: ``(m0_p, ps, ys)
    -> (dll, ll)``. Without a gradient to compute it runs the primal
    kernel; with one, the gradient's forward, saving the state stream for
    the adjoint sweep."""

    @staticmethod
    def forward(ctx, m0_p, ps, ys, f, jac, field, table, consts, stop_calib,
                want_grad):
        if not want_grad:
            return ek1_datalik(f, jac, field, m0_p, ps, ys, table, **consts)
        dll, ll, st = ek1_datalik_grad_fwd(f, jac, field, m0_p, ps, ys, table,
                                           **consts)
        ctx.save_for_backward(st, ps, ys)
        ctx.f, ctx.jac, ctx.field = f, jac, field
        ctx.table, ctx.consts = table, consts
        ctx.stop_calib, ctx.nq = stop_calib, m0_p.shape[0]
        return dll, ll

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, ddll, dall):
        # cotangents of unused outputs arrive as zeros (materialized grads)
        st, ps, ys = ctx.saved_tensors
        dm0, dps, dys = ek1_datalik_grad_bwd(
            ctx.f, ctx.jac, ctx.field, st, ps, ys, ddll.contiguous(),
            dall.contiguous(), ctx.table, nq=ctx.nq,
            stop_calib=ctx.stop_calib, **ctx.consts)
        return (dm0, dps, dys) + (None,) * 7
