"""Per-dimension EK0 / DiagonalEK1 data likelihood: the per-member marginal
log-likelihood of partial observations and its exact gradient. Plain
PyTorch versions and the wrappers of the three CUDA kernels that replace
the JAX package's Pallas per-dimension data-likelihood kernels and their
custom VJP.

=====================================  ======================================
this module                            ``odefilters/ops/pallas_kernels.py``
=====================================  ======================================
``ek0_pd_step``                        ``_ek0_pd_step_lists`` (the f32
                                       residual rounded once)
``pd_step_fn``                         ``_pd_step_fn`` (EK0, or DiagonalEK1:
                                       ``ek1d.ek1d_pd_step``)
``ek0_pd_data_update``                 ``_ek0_pd_data_update`` (on copies of
                                       its inputs)
``pd_layout`` / ``pack_state`` /       ``_pd_pack_and_send``'s row layout
``unpack_state``
``ek0_datalik_pd_plain`` /             ``_ek0_datalik_pd_kernel`` via
``ek0_datalik_pd``                     ``_ek0_datalik_pd_blocked`` (CUDA:
                                       ``csrc/ek0_datalik_pd.cu::
                                       ek0_datalik_pd_kernel``)
``ek0_datalik_pd_fwd_stream_plain`` /  ``_ek0_datalik_pd_grad_fwd_kernel``
``ek0_datalik_pd_grad_fwd``            via ``_ek0_datalik_pd_vjp_fwd``
                                       (CUDA: ``ek0_datalik_pd_grad_fwd_
                                       kernel``)
``ek0_datalik_pd_grad_bwd_plain`` /    ``_ek0_datalik_pd_grad_bwd_kernel``
``ek0_datalik_pd_grad_bwd``            via ``_ek0_datalik_pd_vjp_bwd``
                                       (CUDA: ``ek0_datalik_pd_grad_bwd_
                                       kernel``)
``EK0DataLikPD``                       the ``jax.custom_vjp``
                                       ``_ek0_datalik_pd_vjp``
``obs_rows``                           the front door's parse of the
                                       one-hot observation rows
=====================================  ======================================

Observation row a measures ``y_a = c_a u_{dim_a} + e_a``, ``e_a ~ N(0,
r2_a)``: a (scaled) one-hot row of the observation matrix with its own
noise variance. Conditioning on such a row touches one state dimension, so
the covariance is d independent ``nq x nq`` blocks, one per dimension
(the EK0 step and the IWP prior keep that structure). The ODE step is EK0
(``jac_diag`` None: ``s2 = |z|^2 / (d hq)``) or DiagonalEK1 (``h_j = pinv1
e_1 - J_jj pinv0 e_0``). After the steps that end at an observation time
the rows are conditioned on one scalar at a time, which equals the joint
update for diagonal noise; each adds ``log N(y_a; c_a pinv0 m[0][dim_a],
s_a)`` to the data log-likelihood. The observations are shared by every
member, ``(n_obs, d_obs)``, or per member, ``(n_obs, d_obs, B)``. The
schedule is the on-grid step table of `ek0_datalik.step_table` (base
steps only: the JAX package runs this path on the grid only).

The gradient's forward streams the state at entry of every step, after
any data update, as rows ``(T, V, B)`` in the JAX kernels' layout: per
derivative row i, ``[m[i][0..d-1] | C_0[i][:] | ... | C_{d-1}[i][:]]``,
``V = nq (d + d nq)`` (40 at q = 3, d = 2). The covariance blocks are
streamed whole: the step rounds ``Cp[i][l]`` and ``Cp[l][i]`` apart, so
they are not symmetric bit for bit. The backward walks the stream in
reverse: the adjoint of the data update where one follows the step, then
that of the step, through the vector field, the Jacobian diagonal
(DiagonalEK1) and, unless ``stop_calib``, ``s2``. Its plain version is
``torch.func.vjp`` of the composed step; the CUDA kernel is a hand-written
adjoint. The observations' cotangent is written per member, ``(n_obs,
d_obs, B)``, and summed over the members by one ``torch.sum`` when they
are shared.

Dispatch: each wrapper runs its plain version on CPU tensors, launches its
CUDA kernel on CUDA tensors (which evaluates the CUDA field and its own
Jacobian diagonal, ``fields.cuh``), raises on any other device, and counts
its launches in ``.launches``. `EK0DataLikPD` launches the primal kernel
when no input needs a gradient and the two gradient kernels otherwise.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional

import numpy as np
import torch

from odefilters_torch.ops import _launch
from odefilters_torch.ops import ek0_pair as ep
from odefilters_torch.ops._blocks import _sreduce
from odefilters_torch.ops.ek1d import ek1d_pd_step

_LOG_2PI = math.log(2.0 * math.pi)
# The kernels hold the observation model in registers, unrolled over its
# rows: at most DOBS_MAX observed rows (``csrc/ek0_datalik_pd.cuh``).
DOBS_MAX = 4


def pd_layout(nq: int, d: int):
    """``(W, V)``: the stream's values per derivative row, ``d + d nq``,
    and per step, ``nq W`` (40 at q = 3, d = 2)."""
    W = d + d * nq
    return W, nq * W


def pd_dims(V: int, nq: int) -> int:
    """The state dimension d of a stream of ``V`` values per step."""
    return V // (nq * (1 + nq))


def pack_state(m, C):
    """The state ``(m, C)`` as the stream's ``V`` rows, in order: per
    derivative row i, ``m[i][0..d-1] | C_0[i][:] | ... | C_{d-1}[i][:]``."""
    nq, d = len(m), len(C)
    return [x for i in range(nq)
            for x in m[i] + [C[j][i][l] for j in range(d) for l in range(nq)]]


def unpack_state(rows, nq: int, d: int):
    """The inverse of `pack_state`: ``(m, C)`` from one step's rows."""
    W = pd_layout(nq, d)[0]
    m = [[rows[i * W + j] for j in range(d)] for i in range(nq)]
    C = [[[rows[i * W + d + j * nq + l] for l in range(nq)]
          for i in range(nq)] for j in range(d)]
    return m, C


def obs_rows(C_sel):
    """``(obs_dims, obs_scales)`` of a ``(d_obs, d)`` observation matrix of
    (scaled) one-hot rows; ``ValueError`` for any other row, as the JAX
    front door."""
    obs_dims, obs_scales = [], []
    for a in range(C_sel.shape[0]):
        nz = np.nonzero(C_sel[a])[0]
        if nz.size != 1:
            raise ValueError(
                "EK0/DiagonalEK1 partial observations require (scaled) "
                "one-hot obs_matrix rows (each row observes one state "
                "dimension); use ek1=True for dense observation operators"
            )
        obs_dims.append(int(nz[0]))
        obs_scales.append(float(C_sel[a, nz[0]]))
    return tuple(obs_dims), tuple(obs_scales)


# -- the step bodies on lists of (B,) tensors ------------------------------


def ek0_pd_step(m, C, p, t_new, *, f: Callable, At, Qt, pinv0: float,
                pinv1: float, d: int, nq: int, stop_calib: bool = False):
    """One EK0(dynamic) step with per-dimension covariances. ``m``: nq x d
    and ``C``: d blocks of nq x nq, lists of ``(B,)`` tensors; ``At``,
    ``Qt``: nested Python floats. ``s2 = |z|^2 / (d hq)``, detached under
    ``stop_calib``. Returns ``(m_new, C_new, ll_inc)``."""
    hq = pinv1 * pinv1 * Qt[1][1]
    mp = [[_sreduce([At[i][l] * m[l][j] for l in range(nq) if At[i][l] != 0.0])
           for j in range(d)] for i in range(nq)]
    u_pred = torch.stack([pinv0 * mp[0][j] for j in range(d)])
    du = f(u_pred, p, t_new)
    z = [ep.innovation(pinv1, mp[1][j], du[j]) for j in range(d)]
    zz = _sreduce([zj * zj for zj in z])
    s2 = zz / (d * hq)
    if stop_calib:
        s2 = s2.detach()
    m_new = [[None] * d for _ in range(nq)]
    C_new, ll_inc = [], None
    for j in range(d):
        Cj = C[j]
        tmp = [[_sreduce([At[i][a] * Cj[a][b] for a in range(nq)
                          if At[i][a] != 0.0])
                for b in range(nq)] for i in range(nq)]
        Cp = [[_sreduce([tmp[i][b] * At[l][b] for b in range(nq)
                         if At[l][b] != 0.0]) + Qt[i][l] * s2
               for l in range(nq)] for i in range(nq)]
        s = pinv1 * pinv1 * Cp[1][1]
        inv_s = 1.0 / s
        kg = [pinv1 * Cp[i][1] * inv_s for i in range(nq)]
        for i in range(nq):
            m_new[i][j] = mp[i][j] - kg[i] * z[j]
        C_new.append([[Cp[i][l] - kg[i] * kg[l] * s for l in range(nq)]
                      for i in range(nq)])
        inc = -0.5 * (z[j] * z[j] * inv_s
                      + torch.log(torch.clamp(s, min=1e-30)) + _LOG_2PI)
        ll_inc = inc if ll_inc is None else ll_inc + inc
    return m_new, C_new, ll_inc


def pd_step_fn(jac_diag: Optional[Callable], f: Callable, At, Qt,
               pinv0: float, pinv1: float, d: int, nq: int,
               stop_calib: bool = False):
    """The per-dimension step ``(m, C, p, t) -> (m_new, C_new, ll_inc)``:
    EK0 with ``jac_diag`` None, else DiagonalEK1 at that Jacobian
    diagonal."""
    kw = dict(f=f, At=At, Qt=Qt, pinv0=pinv0, pinv1=pinv1, d=d, nq=nq,
              stop_calib=stop_calib)
    if jac_diag is None:
        return functools.partial(ek0_pd_step, **kw)
    return functools.partial(ek1d_pd_step, jac_diag=jac_diag, **kw)


def ek0_pd_data_update(m, C, y_row, *, obs_dims, obs_scales, r2s,
                       pinv0: float, nq: int):
    """Sequential scalar conditioning on one observation row ``y_row``
    (``d_obs`` entries): row a observes ``c_a u[dim_a]`` with noise
    variance ``r2_a``. Returns new lists ``(m_new, C_new, dll_inc)``; the
    inputs are left as they are."""
    m = [list(row) for row in m]
    C = list(C)
    dll = None
    for a, jd in enumerate(obs_dims):
        c, r2 = float(obs_scales[a]), float(r2s[a])
        Cj = C[jd]
        z = y_row[a] - c * pinv0 * m[0][jd]
        s_d = c * c * pinv0 * pinv0 * Cj[0][0] + r2
        inv_sd = 1.0 / s_d
        kg = [c * pinv0 * Cj[i][0] * inv_sd for i in range(nq)]
        for i in range(nq):
            m[i][jd] = m[i][jd] + kg[i] * z
        C[jd] = [[Cj[i][l] - kg[i] * kg[l] * s_d for l in range(nq)]
                 for i in range(nq)]
        inc = -0.5 * (z * z * inv_sd + torch.log(s_d) + _LOG_2PI)
        dll = inc if dll is None else dll + inc
    return m, C, dll


# -- the plain versions over the step table --------------------------------


def _fns(f, jac_diag, consts, d, nq, stop_calib=False):
    """The step and the data update of ``consts`` (``At, Qt, pinv0,
    pinv1, obs_dims, obs_scales, r2s``)."""
    At = [[float(x) for x in row] for row in np.asarray(consts["At"])]
    Qt = [[float(x) for x in row] for row in np.asarray(consts["Qt"])]
    step = pd_step_fn(jac_diag, f, At, Qt, consts["pinv0"], consts["pinv1"],
                      d, nq, stop_calib)
    dupd = functools.partial(
        ek0_pd_data_update, obs_dims=consts["obs_dims"],
        obs_scales=consts["obs_scales"], r2s=consts["r2s"],
        pinv0=consts["pinv0"], nq=nq)
    return step, dupd


def _y_row(ys, r: int, d_obs: int):
    """Observation row ``r``: 0-dim tensors (shared) or ``(B,)`` ones."""
    return [ys[r, a] for a in range(d_obs)]


def _walk(f, jac_diag, m0_p, ps, ys, table, consts, st=None):
    """The forward over the table; writes the stream ``st`` if given."""
    nq, d, _ = m0_p.shape
    d_obs = len(consts["obs_dims"])
    step, dupd = _fns(f, jac_diag, consts, d, nq)
    m = [[m0_p[i, j] for j in range(d)] for i in range(nq)]
    zero = torch.zeros_like(m[0][0])
    C = [[[zero] * nq for _ in range(nq)] for _ in range(d)]
    ll = dll = zero
    for k in range(table.n_steps):
        if st is not None:
            torch.stack(pack_state(m, C), out=st[k])
        m, C, ll_inc = step(m, C, ps, table.times[k])
        ll = ll + ll_inc
        r = table.rows[k]
        if r >= 0:
            m, C, dll_inc = dupd(m, C, _y_row(ys, r, d_obs))
            dll = dll + dll_inc
    return dll, ll


def ek0_datalik_pd_plain(f: Callable, jac_diag: Optional[Callable], m0_p, ps,
                         ys, table, **consts):
    """The primal: ``(dll, ll)``, each ``(B,)``, from the preconditioned
    initial means ``m0_p`` ``(nq, d, B)``, the parameters ``ps``
    ``(n_params, B)`` and the observations ``ys`` ``(n_obs, d_obs)`` or
    ``(n_obs, d_obs, B)``; EK0 steps with ``jac_diag`` None, else
    DiagonalEK1."""
    return _walk(f, jac_diag, m0_p, ps, ys, table, consts)


def ek0_datalik_pd_fwd_stream_plain(f: Callable, jac_diag: Optional[Callable],
                                    m0_p, ps, ys, table, **consts):
    """The gradient's forward: ``(dll, ll, st)`` with ``st`` ``(T, V, B)``
    the state at entry of every step (`pd_layout`)."""
    nq, d, B = m0_p.shape
    st = torch.empty((table.n_steps, pd_layout(nq, d)[1], B),
                     dtype=m0_p.dtype, device=m0_p.device)
    dll, ll = _walk(f, jac_diag, m0_p, ps, ys, table, consts, st=st)
    return dll, ll, st


def ek0_datalik_pd_grad_bwd_plain(
    f: Callable, jac_diag: Optional[Callable], st, ps, ys, ddll, dall, table,
    *, nq: int, stop_calib: bool = False, **consts,
):
    """The adjoint sweep: from step T-1 down to 0, ``torch.func.vjp`` of
    the step composed with the data update that follows it, with the
    cotangents ``ddll`` of the data log-likelihood and ``dall`` of the ODE
    one (each ``(B,)``). Returns ``(dm0_p (nq, d, B), dps, dy_part)`` with
    the observations' cotangent per member, ``(n_obs, d_obs, B)``."""
    T, V, B = st.shape
    d = pd_dims(V, nq)
    n_obs, d_obs = ys.shape[:2]
    step, dupd = _fns(f, jac_diag, consts, d, nq, stop_calib)

    def step_data(m, C, p, y, t):
        m1, C1, ll_inc = step(m, C, p, t)
        m2, C2, dll_inc = dupd(m1, C1, y)
        return m2, C2, ll_inc, dll_inc

    zero = torch.zeros_like(ddll)
    dm = [[zero] * d for _ in range(nq)]
    dC = [[[zero] * nq for _ in range(nq)] for _ in range(d)]
    dp = torch.zeros_like(ps)
    dy_part = torch.zeros((n_obs, d_obs, B), dtype=st.dtype, device=st.device)
    for k in range(T - 1, -1, -1):
        m_k, C_k = unpack_state(st[k], nq, d)
        t, r = table.times[k], table.rows[k]
        if r >= 0:
            y_b = [y.expand(B).contiguous() for y in _y_row(ys, r, d_obs)]
            _, vjp_fn = torch.func.vjp(
                lambda m, C, p, y: step_data(m, C, p, y, t), m_k, C_k, ps, y_b)
            dm, dC, dp_k, dy_k = vjp_fn((dm, dC, dall, ddll))
            for a in range(d_obs):
                dy_part[r, a] = dy_k[a]
        else:
            _, vjp_fn = torch.func.vjp(lambda m, C, p: step(m, C, p, t),
                                       m_k, C_k, ps)
            dm, dC, dp_k = vjp_fn((dm, dC, dall))
        dp = dp + dp_k
    return torch.stack([torch.stack(row) for row in dm]), dp, dy_part


# -- the kernels' wrappers -------------------------------------------------


def _host_consts(consts):
    """The kernels' constants: At, Qt, pinv0, pinv1, t0 and dt (unused: the
    table holds the step times), then (dim, scale, r2) per observed row."""
    obs = [x for row in zip(consts["obs_dims"], consts["obs_scales"],
                            consts["r2s"]) for x in row]
    return _launch.host_consts(
        consts["At"], consts["Qt"],
        scalars=(consts["pinv0"], consts["pinv1"], 0.0, 0.0, *obs))


def _check_inputs(name, field, jac_diag, shape, ps, ys, table, consts):
    """Raise unless the kernels take these inputs; ``shape``: the initial
    means' ``(nq, d, B)``."""
    nq, d, B = shape
    _launch.check_field(name, field, nq, d, B, ps,
                        need_jac_diag=jac_diag is not None)
    d_obs = len(consts["obs_dims"])
    if not 1 <= d_obs <= DOBS_MAX:
        raise ValueError(f"{name}: the kernels take 1 to {DOBS_MAX} observed "
                         f"rows, got {d_obs}")
    n_obs = sum(r >= 0 for r in table.rows)
    want = ((n_obs, d_obs), (n_obs, d_obs, B))
    if tuple(ys.shape) not in want:
        raise ValueError(f"{name}: ys must be {want[0]} or {want[1]}, got "
                         f"{tuple(ys.shape)}")
    if any(s != 0 for s in table.sets):
        raise ValueError(f"{name}: the per-dimension path runs on the grid "
                         "only (base steps)")
    _launch.check_cuda_inputs(name, {"ps": ps, "ys": ys, "times": table.times},
                              ps.dtype)
    _launch.check_cuda_inputs(name, {"codes": table.codes}, torch.int32)
    if table.codes.device != ps.device:
        raise ValueError(f"{name}: the step table is on {table.codes.device}, "
                         f"the inputs on {ps.device}")


def _flags(jac_diag, ys):
    return int(jac_diag is not None), int(ys.ndim == 3)


def ek0_datalik_pd(f: Callable, jac_diag: Optional[Callable],
                   field: Optional[str], m0_p, ps, ys, table, **consts):
    """The primal: `ek0_datalik_pd_plain` on CPU tensors, the CUDA kernel
    ``ek0_datalik_pd_kernel`` on CUDA tensors. Returns ``(dll, ll)``."""
    if _launch.dispatch_device("ek0_datalik_pd", m0_p) == "cpu":
        return ek0_datalik_pd_plain(f, jac_diag, m0_p, ps, ys, table, **consts)
    _check_inputs("ek0_datalik_pd", field, jac_diag, m0_p.shape, ps, ys,
                  table, consts)
    _launch.check_cuda_inputs("ek0_datalik_pd", {"m0_p": m0_p, "ps": ps},
                              m0_p.dtype)
    B = m0_p.shape[2]
    new = dict(dtype=m0_p.dtype, device=m0_p.device)
    dll, ll = torch.empty((B,), **new), torch.empty((B,), **new)
    _launch.launch(ek0_datalik_pd, m0_p.device,
                   f"ek0_datalik_pd_{field}_{_launch.suffix(m0_p.dtype)}",
                   m0_p.data_ptr(), ps.data_ptr(), ys.data_ptr(),
                   table.times.data_ptr(), table.codes.data_ptr(),
                   dll.data_ptr(), ll.data_ptr(), B, table.n_steps,
                   ys.shape[1], *_flags(jac_diag, ys), _host_consts(consts))
    return dll, ll


ek0_datalik_pd.launches = 0


def ek0_datalik_pd_grad_fwd(f: Callable, jac_diag: Optional[Callable],
                            field: Optional[str], m0_p, ps, ys, table,
                            **consts):
    """The gradient's forward: `ek0_datalik_pd_fwd_stream_plain` on CPU
    tensors, the CUDA kernel ``ek0_datalik_pd_grad_fwd_kernel`` on CUDA
    tensors. Returns ``(dll, ll, st)``."""
    if _launch.dispatch_device("ek0_datalik_pd_grad_fwd", m0_p) == "cpu":
        return ek0_datalik_pd_fwd_stream_plain(f, jac_diag, m0_p, ps, ys,
                                               table, **consts)
    _check_inputs("ek0_datalik_pd_grad_fwd", field, jac_diag, m0_p.shape, ps,
                  ys, table, consts)
    _launch.check_cuda_inputs("ek0_datalik_pd_grad_fwd",
                              {"m0_p": m0_p, "ps": ps}, m0_p.dtype)
    nq, d, B = m0_p.shape
    new = dict(dtype=m0_p.dtype, device=m0_p.device)
    dll, ll = torch.empty((B,), **new), torch.empty((B,), **new)
    st = torch.empty((table.n_steps, pd_layout(nq, d)[1], B), **new)
    _launch.launch(
        ek0_datalik_pd_grad_fwd, m0_p.device,
        f"ek0_datalik_pd_grad_fwd_{field}_{_launch.suffix(m0_p.dtype)}",
        m0_p.data_ptr(), ps.data_ptr(), ys.data_ptr(), table.times.data_ptr(),
        table.codes.data_ptr(), dll.data_ptr(), ll.data_ptr(), st.data_ptr(),
        B, table.n_steps, ys.shape[1], *_flags(jac_diag, ys),
        _host_consts(consts))
    return dll, ll, st


ek0_datalik_pd_grad_fwd.launches = 0


def ek0_datalik_pd_grad_bwd(
    f: Callable, jac_diag: Optional[Callable], field: Optional[str], st, ps,
    ys, ddll, dall, table, *, nq: int, stop_calib: bool = False, **consts,
):
    """The adjoint sweep: `ek0_datalik_pd_grad_bwd_plain` on CPU tensors,
    the CUDA kernel ``ek0_datalik_pd_grad_bwd_kernel`` (hand-written
    adjoint) on CUDA tensors. Returns ``(dm0_p, dps, dys)``: ``dys`` per
    member ``(n_obs, d_obs, B)`` for per-member observations, summed over
    the members ``(n_obs, d_obs)`` for shared ones."""
    if _launch.dispatch_device("ek0_datalik_pd_grad_bwd", st) == "cpu":
        dm0, dps, dy_part = ek0_datalik_pd_grad_bwd_plain(
            f, jac_diag, st, ps, ys, ddll, dall, table, nq=nq,
            stop_calib=stop_calib, **consts)
    else:
        T, V, B = st.shape
        name = "ek0_datalik_pd_grad_bwd"
        d = pd_dims(V, nq)
        _check_inputs(name, field, jac_diag, (nq, d, B), ps, ys, table, consts)
        if (V != pd_layout(nq, d)[1] or T != table.n_steps
                or tuple(ddll.shape) != (B,) or tuple(dall.shape) != (B,)):
            raise ValueError(
                f"{name}: takes st ({table.n_steps}, {pd_layout(nq, d)[1]}, "
                f"B), ddll (B,), dall (B,); got {tuple(st.shape)}, "
                f"{tuple(ddll.shape)}, {tuple(dall.shape)}")
        _launch.check_cuda_inputs(name, {"st": st, "ps": ps, "ddll": ddll,
                                         "dall": dall}, st.dtype)
        n_obs, d_obs = ys.shape[:2]
        new = dict(dtype=st.dtype, device=st.device)
        dm0 = torch.empty((nq, d, B), **new)
        dps = torch.empty(tuple(ps.shape), **new)
        dy_part = torch.zeros((n_obs, d_obs, B), **new)
        _launch.launch(
            ek0_datalik_pd_grad_bwd, st.device,
            f"{name}_{field}_{_launch.suffix(st.dtype)}",
            st.data_ptr(), ps.data_ptr(), ys.data_ptr(),
            table.times.data_ptr(), table.codes.data_ptr(), ddll.data_ptr(),
            dall.data_ptr(), dm0.data_ptr(), dps.data_ptr(),
            dy_part.data_ptr(), B, T, d_obs, *_flags(jac_diag, ys),
            int(stop_calib), _host_consts(consts))
    dys = dy_part if ys.ndim == 3 else torch.sum(dy_part, dim=-1)
    return dm0, dps, dys


ek0_datalik_pd_grad_bwd.launches = 0


class EK0DataLikPD(torch.autograd.Function):
    """The per-dimension data likelihood as an autograd node: ``(m0_p, ps,
    ys) -> (dll, ll)``. Without a gradient to compute it runs the primal
    kernel; with one, the gradient's forward, saving the state stream for
    the adjoint sweep."""

    @staticmethod
    def forward(ctx, m0_p, ps, ys, f, jac_diag, field, table, consts,
                stop_calib, want_grad):
        if not want_grad:
            return ek0_datalik_pd(f, jac_diag, field, m0_p, ps, ys, table,
                                  **consts)
        dll, ll, st = ek0_datalik_pd_grad_fwd(f, jac_diag, field, m0_p, ps,
                                              ys, table, **consts)
        ctx.save_for_backward(st, ps, ys)
        ctx.f, ctx.jac_diag, ctx.field = f, jac_diag, field
        ctx.table, ctx.consts = table, consts
        ctx.stop_calib, ctx.nq = stop_calib, m0_p.shape[0]
        return dll, ll

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, ddll, dall):
        # cotangents of unused outputs arrive as zeros (materialized grads)
        st, ps, ys = ctx.saved_tensors
        dm0, dps, dys = ek0_datalik_pd_grad_bwd(
            ctx.f, ctx.jac_diag, ctx.field, st, ps, ys, ddll.contiguous(),
            dall.contiguous(), ctx.table, nq=ctx.nq,
            stop_calib=ctx.stop_calib, **ctx.consts)
        return (dm0, dps, dys) + (None,) * 7
