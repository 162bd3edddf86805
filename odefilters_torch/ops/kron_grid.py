"""Single-trajectory Kron-grid PDE solves: the plain PyTorch versions and the
wrappers of the CUDA kernels (cooperative grids, and for DiagonalEK1 a
thread-block cluster up to 24,576 grid points) that
replace the JAX package's Pallas ``_ek0_kron_grid_kernel`` and
``_ek1d_kron_grid_kernel``, and the 2-D Brusselator front doors.

===================================  =========================================
this module                          ``odefilters/ops/pallas_kernels.py``
===================================  =========================================
``grid_sum``                         the grid-wide ``jnp.sum`` of the step
                                     bodies, in the kernels' fixed order
``ek0_kron_step``                    ``_ek0_kron_step_lists``
``ek1d_kron_step``                   ``_ek1d_kron_step_lists``
``ek0_kron_grid_solve_plain`` /      ``_ek0_kron_grid_kernel`` (CUDA:
``ek0_kron_grid_solve``              ``csrc/kron_grid.cu::
                                     ek0_kron_grid_kernel``) /
                                     ``ek0_kron_grid_solve``
``ek1d_kron_grid_solve_plain`` /     ``_ek1d_kron_grid_kernel`` (CUDA:
``ek1d_kron_grid_solve``             ``csrc/kron_grid.cu::
                                     ek1d_kron_cluster_kernel``,
                                     ``ek1d_kron_grid_kernel``) /
                                     ``ek1d_kron_grid_solve``
``solve_brusselator_ek0``            ``solve_brusselator_ek0_pallas``
``solve_brusselator_ek1d``           ``solve_brusselator_ek1d_pallas``
===================================  =========================================

One trajectory of a semi-discretized PDE whose state is ``ns`` grids of
``(N, M)`` points. EK0 with a scalar dynamic diffusion and a zero initial
covariance keeps the covariance ``C (x) I_d``: the state is the ``nq x ns``
grid means and one shared ``(nq, nq)`` scalar covariance. DiagonalEK1 runs
one ``(nq, nq)`` filter per point, measuring ``h = pinv1 e1 - J_pp pinv0
e0`` with the point's Jacobian diagonal, and carries the plain covariance's
upper triangle per point (the lower mirror aliased), as the JAX kernel
does. Both calibrate one dynamic diffusion from a grid-wide sum, ``s2 =
sum z^2 / (d hq)`` (EK0) or ``sum (z^2 / hq) / d`` (DiagonalEK1), which feeds
every later step.

Rounding, decided once for the plain versions and the kernels alike:

* The grid-wide sums run in the kernels' fixed order (`grid_sum`): each
  CTA's ``KRON_BLOCK`` points, zero-padded, by a halving tree
  ``x[:w/2] + x[w/2:]``, then the CTAs' partials, zero-padded to a power of
  two, by the same tree. Species are summed apart and added in species
  order, as the JAX body's ``functools.reduce``.
* Host constants are products of Python floats folded in float64 and
  rounded once to the solve's dtype, as the JAX body's Python-level
  products are: ``pinv1^2``, ``pinv0^2``, and DiagonalEK1's ``pinv1^2
  q11`` and ``2 pinv1 q01`` (with ``At``, ``Qt`` already rounded to the
  dtype, as the JAX wrapper casts them). Each division by a constant is a
  product with its reciprocal folded in float64: EK0's ``s2 = zz * (1 /
  (d hq))`` with ``hq = pinv1^2 Qt[1][1]``, DiagonalEK1's ``s2 = zz_hq *
  (1 / d)``. The JAX body divides there (within an ulp in float64).
* The residual ``pinv1 mp[1] - du`` is, in float32, the exact product
  rounded once, as in every filter of the port (`ek0_pair.innovation`).
* ``log(max(sc, 1e-30))`` in both kernels, as in the JAX bodies.

Dispatch: ``ek0_kron_grid_solve`` / ``ek1d_kron_grid_solve`` run the plain
version on CPU tensors, launch the CUDA kernel on CUDA tensors (the field's
own stencil, ``BrusselatorGrid`` in ``csrc/kron_grid.cuh``), raise on any
other device, and count their launches in ``.launches``.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import numpy as np
import torch

from odefilters_torch.ops import _launch
from odefilters_torch.ops import ek0_pair as ep
from odefilters_torch.ops._blocks import _lists, _sreduce
from odefilters_torch.ops.ek0_filter import _LOG_2PI

# CTA width of the kernels (one thread per grid point), and so the width of
# the first level of `grid_sum`'s tree; a power of two.
KRON_BLOCK = 128
# CTAs in the DiagonalEK1 kernel's thread-block cluster (csrc/kron_grid.cuh:
# CLUSTER; 16 is a non-portable cluster size, which the H100 schedules). The
# cluster holds up to 16 x 3 KRON_BLOCK x 4 = 24,576 grid points (CTAs of
# at most 3 KRON_BLOCK threads, at most 4 points a thread); larger grids run
# on a cooperative kernel (the C entry ek1d_kron_grid_on_cluster says which).
KRON_CLUSTER = 16


def _halve(x: torch.Tensor) -> torch.Tensor:
    """Sum the last axis (a power of two wide) by the halving tree."""
    w = x.shape[-1]
    while w > 1:
        w //= 2
        x = x[..., :w] + x[..., w:]
    return x[..., 0]


def grid_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of every entry of ``x`` (flattened row-major), 0-d, in the
    kernels' order: blocks of ``KRON_BLOCK`` entries, the last
    zero-padded, each by the halving tree; then the block partials,
    zero-padded to a power of two, by the same tree."""
    v = x.reshape(-1)
    n = v.numel()
    nb = max(1, -(-n // KRON_BLOCK))
    v = torch.cat([v, v.new_zeros(nb * KRON_BLOCK - n)]).reshape(
        nb, KRON_BLOCK)
    parts = _halve(v)
    P = 1 << (nb - 1).bit_length()
    return _halve(torch.cat([parts, parts.new_zeros(P - nb)]))


def _predict_means(m, At, nq: int, ns: int):
    """``mp[i][s] = sum_l At[i][l] m[l][s]`` over the nonzero ``At[i][l]``."""
    return [[_sreduce([At[i][l] * m[l][s] for l in range(nq)
                       if At[i][l] != 0.0])
             for s in range(ns)] for i in range(nq)]


def _predict_cov(C, At, Qt, s2, nq: int, pairs):
    """``Cp[i][l] = (At C At^T)[i][l] + Qt[i][l] s2`` for ``(i, l)`` in
    ``pairs``, in the JAX body's order (``tmp = At C`` first, every entry).
    ``C[a][b]``: a 0-d tensor, or a list of per-species grids (then each
    computed ``Cp`` entry is such a list)."""

    def one(get):
        tmp = [[_sreduce([At[i][a] * get(a, b) for a in range(nq)
                          if At[i][a] != 0.0])
                 for b in range(nq)] for i in range(nq)]
        Cp = [[None] * nq for _ in range(nq)]
        for i, l in pairs:
            Cp[i][l] = _sreduce([tmp[i][b] * At[l][b] for b in range(nq)
                                 if At[l][b] != 0.0]) + Qt[i][l] * s2
        return Cp

    if not isinstance(C[0][0], list):
        return one(lambda a, b: C[a][b])
    per = [one(lambda a, b, s=s: C[a][b][s]) for s in range(len(C[0][0]))]
    Cp = [[None] * nq for _ in range(nq)]
    for i, l in pairs:
        Cp[i][l] = [ps[i][l] for ps in per]
    return Cp


def ek0_kron_step(m, C, t_new, *, f_grids: Callable, p, At, Qt, pinv0: float,
                  pinv1: float, d: int, ns: int, nq: int):
    """One EK0 step on the Kron-grid state: ``m[i][s]`` the ``(N, M)`` grid
    means, ``C`` the shared ``(nq, nq)`` covariance (0-d tensors); ``At``,
    ``Qt``: nested Python floats rounded to the dtype. Returns ``(m_new,
    C_new, ll_inc)``."""
    hq = pinv1 * pinv1 * Qt[1][1]
    mp = _predict_means(m, At, nq, ns)
    u_pred = [pinv0 * mp[0][s] for s in range(ns)]
    du = f_grids(u_pred, p, t_new)
    z = [ep.innovation(pinv1, mp[1][s], du[s]) for s in range(ns)]
    zz = _sreduce([grid_sum(zs * zs) for zs in z])
    s2 = zz * (1.0 / (d * hq))
    Cp = _predict_cov(C, At, Qt, s2, nq,
                      [(i, l) for i in range(nq) for l in range(nq)])
    sc = (pinv1 * pinv1) * Cp[1][1]
    inv_s = 1.0 / sc
    kg = [pinv1 * Cp[i][1] * inv_s for i in range(nq)]
    m_new = [[mp[i][s] - kg[i] * z[s] for s in range(ns)] for i in range(nq)]
    C_new = [[Cp[i][l] - kg[i] * kg[l] * sc for l in range(nq)]
             for i in range(nq)]
    ll_inc = -0.5 * (zz * inv_s
                     + d * (torch.log(torch.clamp(sc, min=1e-30)) + _LOG_2PI))
    return m_new, C_new, ll_inc


def ek1d_kron_step(m, C, t_new, *, f_grids: Callable, jd_grids: Callable, p,
                   At, Qt, pinv0: float, pinv1: float, d: int, ns: int,
                   nq: int):
    """One DiagonalEK1 step on per-point covariance fields: ``C[i][l][s]`` an
    ``(N, M)`` grid, the upper triangle computed and ``C[l][i]`` the same
    list (aliased), as in the JAX body. Returns ``(m_new, C_new,
    ll_inc)``."""
    q00, q01, q11 = Qt[0][0], Qt[0][1], Qt[1][1]
    mp = _predict_means(m, At, nq, ns)
    u_pred = [pinv0 * mp[0][s] for s in range(ns)]
    du = f_grids(u_pred, p, t_new)
    jd = jd_grids(u_pred, p, t_new)
    z = [ep.innovation(pinv1, mp[1][s], du[s]) for s in range(ns)]
    a = [jd[s] * pinv0 for s in range(ns)]
    hq = [(pinv1 * pinv1 * q11) - (2.0 * pinv1 * q01) * a[s]
          + q00 * a[s] * a[s] for s in range(ns)]
    zz_hq = _sreduce([grid_sum(z[s] * z[s] / hq[s])
                      for s in range(ns)])
    s2 = zz_hq * (1.0 / d)
    upper = [(i, l) for i in range(nq) for l in range(i, nq)]
    Cp = _predict_cov(C, At, Qt, s2, nq, upper)
    for i, l in upper:
        Cp[l][i] = Cp[i][l]                     # aliased mirror
    hC = [[pinv1 * Cp[1][i][s] - a[s] * Cp[0][i][s] for s in range(ns)]
          for i in range(nq)]
    sc = [pinv1 * hC[1][s] - a[s] * hC[0][s] for s in range(ns)]
    inv_s = [1.0 / sc[s] for s in range(ns)]
    kg = [[hC[i][s] * inv_s[s] for s in range(ns)] for i in range(nq)]
    m_new = [[mp[i][s] - kg[i][s] * z[s] for s in range(ns)]
             for i in range(nq)]
    C_new = [[None] * nq for _ in range(nq)]
    for i, l in upper:
        C_new[i][l] = [Cp[i][l][s] - kg[i][s] * kg[l][s] * sc[s]
                       for s in range(ns)]
        C_new[l][i] = C_new[i][l]               # aliased mirror
    ll_inc = -0.5 * (
        _sreduce([grid_sum(z[s] * z[s] * inv_s[s])
                  + grid_sum(torch.log(torch.clamp(sc[s], min=1e-30)))
                  for s in range(ns)])
        + d * _LOG_2PI
    )
    return m_new, C_new, ll_inc


def _solve_plain(step, m0_p, t0: float, dt: float, T: int, save_every: int,
                 pinv0: float, ek1d: bool):
    """The time loop of both plain solves from a zero covariance (shared
    scalars, or per-point grids): ``step(m, C, t_new)`` at ``t_new = t0 +
    dt (k+1)`` in the solve's dtype, the ll summed, the solution and
    ``pinv0^2 max(C[0][0], 0)`` saved every ``save_every`` steps."""
    nq, ns, N, M = m0_p.shape
    new = dict(dtype=m0_p.dtype, device=m0_p.device)
    us = torch.empty((T // save_every + 1, ns, N, M), **new)
    var = torch.empty(us.shape if ek1d else us.shape[:1], **new)
    m = [[m0_p[i, s] for s in range(ns)] for i in range(nq)]
    ll = torch.zeros((), **new)
    zero = torch.zeros((N, M), **new) if ek1d else ll
    C = [[[zero] * ns if ek1d else zero for _ in range(nq)]
         for _ in range(nq)]
    us[0] = pinv0 * m0_p[0]
    var[0] = 0.0
    ts = ep.step_times(t0, dt, T, m0_p.dtype, m0_p.device)
    for k in range(T):
        m, C, ll_inc = step(m, C, ts[k])
        ll = ll + ll_inc
        if (k + 1) % save_every == 0:
            row = (k + 1) // save_every
            for s in range(ns):
                us[row, s] = pinv0 * m[0][s]
            if ek1d:
                for s in range(ns):
                    var[row, s] = (pinv0 * pinv0) * torch.clamp(C[0][0][s],
                                                                 min=0.0)
            else:
                var[row] = (pinv0 * pinv0) * torch.clamp(C[0][0], min=0.0)
    return us, var, ll


def ek0_kron_grid_solve_plain(
    f_grids: Callable, m0_p: torch.Tensor, p, *, At, Qt, pinv0: float,
    pinv1: float, t0: float, dt: float, n_steps: int, save_every: int
):
    """The EK0 Kron-grid filter from the preconditioned initial means
    ``m0_p`` ``(nq, ns, N, M)`` over ``n_steps`` steps of ``dt``. Returns
    ``(us, var, ll)``: the means of the solution every ``save_every`` steps
    ``(S+1, ns, N, M)`` (row 0 ``pinv0 m0_p[0]``), the isotropic marginal
    variance ``pinv0^2 max(C[0][0], 0)`` per row ``(S+1,)`` and the summed
    log-likelihood (0-d)."""
    nq, ns, N, M = m0_p.shape
    step = functools.partial(ek0_kron_step, f_grids=f_grids, p=p,
                             At=_lists(At), Qt=_lists(Qt), pinv0=pinv0,
                             pinv1=pinv1, d=ns * N * M, ns=ns, nq=nq)
    return _solve_plain(step, m0_p, t0, dt, int(n_steps), save_every, pinv0,
                        False)


def ek1d_kron_grid_solve_plain(
    f_grids: Callable, jd_grids: Callable, m0_p: torch.Tensor, p, *, At, Qt,
    pinv0: float, pinv1: float, t0: float, dt: float, n_steps: int,
    save_every: int
):
    """The DiagonalEK1 Kron-grid filter, as `ek0_kron_grid_solve_plain`;
    ``var`` is per point, ``pinv0^2 max(C[0][0], 0)``, ``(S+1, ns, N,
    M)``."""
    nq, ns, N, M = m0_p.shape
    step = functools.partial(ek1d_kron_step, f_grids=f_grids,
                             jd_grids=jd_grids, p=p, At=_lists(At),
                             Qt=_lists(Qt), pinv0=pinv0, pinv1=pinv1,
                             d=ns * N * M, ns=ns, nq=nq)
    return _solve_plain(step, m0_p, t0, dt, int(n_steps), save_every, pinv0,
                        True)


def kron_constants(q: int, dt: float, dtype: torch.dtype, prior=None):
    """``(At, Qt, p)``: the IBM transition and ``Qt = QLt QLt^T`` rounded to
    ``dtype`` (as float64 numpy, as the JAX wrapper casts them) and the
    preconditioner ``p`` at step ``dt``. Any other prior raises."""
    _launch.check_ported(prior=prior, second_order=False, mesh=None)
    At, Qt, _, p = ep.pair_constants(q, dt)
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    return (At.astype(np_dtype).astype(np.float64),
            Qt.astype(np_dtype).astype(np.float64), p)


def _grid_consts(field: Optional[str], p, N: int, M: int, ns: int,
                 nq: int) -> tuple:
    """The CUDA stencil's constants ``(alpha, scale, A, A + 1, B, -4 alpha
    scale)`` for ``field``, folded in float64 as the model's Python floats
    are; raise unless the kernels are built for it."""
    from odefilters_torch.models.library import BRUSSELATOR_A, BRUSSELATOR_B

    if field not in _launch.CUDA_GRID_FIELDS:
        raise NotImplementedError(
            f"no CUDA grid field {field!r}; the Kron-grid kernels are built "
            f"for {sorted(_launch.CUDA_GRID_FIELDS)}"
        )
    _launch.check_order("kron_grid", nq)
    if ns != _launch.CUDA_GRID_FIELDS[field] or N != M:
        raise ValueError(
            f"field {field!r} takes m0 (nq, {_launch.CUDA_GRID_FIELDS[field]}, "
            f"N, N); got ({nq}, {ns}, {N}, {M})"
        )
    if isinstance(p, torch.Tensor) or not isinstance(p, (int, float)):
        raise TypeError(
            f"the CUDA field {field!r} takes its diffusivity as p, a Python "
            f"number; got {type(p).__name__}"
        )
    alpha, scale = float(p), float((N - 1) ** 2)
    return (alpha, scale, BRUSSELATOR_A, BRUSSELATOR_A + 1.0, BRUSSELATOR_B,
            -4.0 * alpha * scale)


def _launch_grid(wrapper, name: str, m0_p, p, field, *, At, Qt,
                 pinv0, pinv1, T, save_every, var_shape):
    """Launch the kernel ``name`` on ``m0_p``'s card: EK0's cooperative one
    (its C entry refuses a grid whose CTAs are not all co-resident,
    ``cudaErrorCooperativeLaunchTooLarge``, which raises here) or
    DiagonalEK1's, on one thread-block cluster up to 24,576 grid points
    (refused, and raising, when the card cannot schedule the cluster) and
    cooperative above."""
    nq, ns, N, M = m0_p.shape
    consts = _grid_consts(field, p, N, M, ns, nq)
    _launch.check_cuda_inputs(name, {"m0_p": m0_p}, m0_p.dtype)
    nb = -(-N * M // KRON_BLOCK)
    S = T // save_every
    new = dict(dtype=m0_p.dtype, device=m0_p.device)
    us = torch.empty((S + 1, ns, N, M), **new)
    var = torch.empty(var_shape, **new)
    ll = torch.empty((), **new)
    # the scratch grid, then the s2 partials (ns nb) and DiagonalEK1's ll
    # partials (2 ns nb): the cooperative kernels' (the cluster kernel keeps
    # them in shared memory)
    work = torch.empty((ns * (N * M + 3 * nb),), **new)
    _launch.launch(wrapper, m0_p.device,
                   f"{name}_{_launch.suffix(m0_p.dtype)}", m0_p.data_ptr(),
                   us.data_ptr(), var.data_ptr(), ll.data_ptr(),
                   work.data_ptr(), N, M, T, save_every,
                   _launch.host_consts(At, Qt, scalars=kernel_scalars(
                       Qt, pinv0, pinv1, ns * N * M) + consts))
    return us, var, ll


def kernel_scalars(Qt, pinv0: float, pinv1: float, d: int) -> tuple:
    """The kernels' scalar constants after ``At``, ``Qt``, folded in float64
    exactly as the plain step bodies' Python floats are (the C side rounds
    each once to the dtype): ``pinv0, pinv1, pinv0^2, pinv1^2, 1 / (d hq),
    1 / d, pinv1^2 Qt[1][1], 2 pinv1 Qt[0][1], d, log(2 pi), d log(2
    pi)``."""
    Qt = _lists(Qt)
    hq = pinv1 * pinv1 * Qt[1][1]
    return (pinv0, pinv1, pinv0 * pinv0, pinv1 * pinv1,
            1.0 / (d * hq), 1.0 / d, pinv1 * pinv1 * Qt[1][1],
            2.0 * pinv1 * Qt[0][1], float(d), _LOG_2PI, d * _LOG_2PI)


def kron_inputs(m0, dt, n_steps, q, save_every, prior=None):
    """What the wrappers hand their plain version and kernel: ``(T, At, Qt,
    m0_p, pinv0, pinv1)`` with the preconditioned init ``m0_p = p m0`` (``p``
    rounded to the dtype first, as the JAX wrapper does). Raises unless
    ``save_every`` divides ``n_steps`` and the prior is the IBM one."""
    T = int(n_steps)
    if save_every < 1 or T % save_every:
        raise ValueError("save_every must divide n_steps")
    At, Qt, p_np = kron_constants(q, dt, m0.dtype, prior)
    np_dtype = np.float32 if m0.dtype == torch.float32 else np.float64
    m0_p = torch.as_tensor(p_np.astype(np_dtype), dtype=m0.dtype,
                           device=m0.device)[:, None, None, None] * m0
    return T, At, Qt, m0_p, float(1.0 / p_np[0]), float(1.0 / p_np[1])


def ek0_kron_grid_solve(
    f_grids: Callable,
    m0: torch.Tensor,
    p,
    t0: float,
    dt: float,
    n_steps: int,
    q: int,
    save_every: int = 1,
    prior=None,
    *,
    field: Optional[str] = None,
):
    """Fused single-trajectory EK0(dynamic) filter for grid-shaped states.

    ``m0``: the ``(q+1, ns, N, M)`` unpreconditioned Taylor init;
    ``f_grids(fields, p, t)`` maps ``ns`` ``(N, M)`` grids to their time
    derivatives (the plain version); ``field`` names its CUDA stencil and
    ``p`` its parameter (the Brusselator's diffusivity, a Python number).
    Returns ``(us, var, ll)``: saved means ``(S+1, ns, N, M)`` every
    ``save_every`` steps, the isotropic marginal variance ``(S+1,)``, the
    log-likelihood (0-d). On CPU tensors the plain version runs; on CUDA
    tensors the cooperative kernel ``ek0_kron_grid_kernel``."""
    T, At, Qt, m0_p, pinv0, pinv1 = kron_inputs(m0, dt, n_steps, q,
                                                save_every, prior)
    kw = dict(At=At, Qt=Qt, pinv0=pinv0, pinv1=pinv1)
    if _launch.dispatch_device("ek0_kron_grid_solve", m0_p) == "cpu":
        return ek0_kron_grid_solve_plain(f_grids, m0_p, p, t0=float(t0),
                                         dt=float(dt), n_steps=T,
                                         save_every=save_every, **kw)
    return _launch_grid(ek0_kron_grid_solve, "ek0_kron_grid", m0_p, p,
                        field, T=T, save_every=save_every,
                        var_shape=(T // save_every + 1,), **kw)


ek0_kron_grid_solve.launches = 0


def ek1d_kron_grid_solve(
    f_grids: Callable,
    jd_grids: Callable,
    m0: torch.Tensor,
    p,
    t0: float,
    dt: float,
    n_steps: int,
    q: int,
    save_every: int = 1,
    prior=None,
    *,
    field: Optional[str] = None,
):
    """Fused single-trajectory DiagonalEK1(dynamic) filter on grid states,
    as `ek0_kron_grid_solve`; ``jd_grids`` gives the per-point Jacobian
    diagonal (the plain version) and ``var`` is per point, ``(S+1, ns, N,
    M)``. CUDA: ``ek1d_kron_cluster_kernel`` on one thread-block cluster of
    ``KRON_CLUSTER`` CTAs up to 24,576 grid points (N <= 156 on a square
    grid), ``ek1d_kron_grid_kernel`` (cooperative, a CTA per 128 points)
    above."""
    T, At, Qt, m0_p, pinv0, pinv1 = kron_inputs(m0, dt, n_steps, q,
                                                save_every, prior)
    kw = dict(At=At, Qt=Qt, pinv0=pinv0, pinv1=pinv1)
    if _launch.dispatch_device("ek1d_kron_grid_solve", m0_p) == "cpu":
        return ek1d_kron_grid_solve_plain(f_grids, jd_grids, m0_p, p,
                                          t0=float(t0), dt=float(dt),
                                          n_steps=T, save_every=save_every,
                                          **kw)
    return _launch_grid(ek1d_kron_grid_solve, "ek1d_kron_grid", m0_p, p,
                        field, T=T, save_every=save_every,
                        var_shape=(T // save_every + 1,) + tuple(m0_p.shape[1:]),
                        **kw)


ek1d_kron_grid_solve.launches = 0


def brusselator_init(N: int, tspan, q: int = 3, alpha: float = 0.1,
                     dtype=None, *, device="cuda"):
    """The Taylor init of the 2-D Brusselator as the doors make it: the
    ``(q+1, 2N^2)`` derivatives of the flat float64 problem (nested
    ``torch.func.jvp``), reshaped to ``(q+1, 2, N, N)``, then cast to
    ``dtype`` (float64 unless given)."""
    from odefilters_torch.models.library import brusselator_2d
    from odefilters_torch.taylor import taylor_coefficients

    prob = brusselator_2d(N=N, tspan=tspan, alpha=alpha, device=device,
                          dtype=torch.float64)
    m0 = torch.stack(taylor_coefficients(prob.f, prob.u0, prob.p, tspan[0], q))
    return m0.reshape(q + 1, 2, N, N).to(
        torch.float64 if dtype is None else dtype)


def _door(N, tspan, n_steps, q, alpha, save_every, dtype, prior, device):
    from odefilters_torch.models.library import (
        brusselator_2d_f_grids,
        brusselator_2d_jd_grids,
    )

    _launch.check_ported(prior=prior, second_order=False, mesh=None)
    t0, t1 = tspan
    if save_every is None:
        save_every = max(1, n_steps // 20)
    m0 = brusselator_init(N, tspan, q, alpha, dtype, device=device)
    args = (m0, float(alpha), float(t0), float((t1 - t0) / n_steps), n_steps,
            q, save_every)
    return brusselator_2d_f_grids(N), brusselator_2d_jd_grids(N), args


def solve_brusselator_ek0(N: int, tspan, n_steps: int, q: int = 3,
                          alpha: float = 0.1, save_every: Optional[int] = None,
                          dtype=None, prior=None, *, device="cuda"):
    """Taylor init + the fused Kron-grid EK0 solve of the 2-D Brusselator
    (d = 2 N^2 states, one trajectory) on ``n_steps`` uniform steps over
    ``tspan``, saving every ``save_every`` steps (default ``n_steps // 20``).
    ``dtype``: the solve's precision (float64 unless given); the Taylor
    init is taken in float64 and cast. Returns ``(us (S+1, 2, N, N), var
    (S+1,), ll)``. Runs on the CUDA card unless ``device="cpu"``."""
    f_grids, _, args = _door(N, tspan, n_steps, q, alpha, save_every, dtype,
                             prior, device)
    return ek0_kron_grid_solve(f_grids, *args, field="brusselator_2d")


def solve_brusselator_ek1d(N: int, tspan, n_steps: int, q: int = 3,
                           alpha: float = 0.1,
                           save_every: Optional[int] = None, dtype=None,
                           prior=None, *, device="cuda"):
    """The DiagonalEK1 counterpart of `solve_brusselator_ek0` (the diagonal
    gain sees each point's own reaction and diffusion rate). Returns ``(us,
    var, ll)`` with the per-point variance ``(S+1, 2, N, N)``."""
    f_grids, jd_grids, args = _door(N, tspan, n_steps, q, alpha, save_every,
                                    dtype, prior, device)
    return ek1d_kron_grid_solve(f_grids, jd_grids, *args,
                                field="brusselator_2d")
