"""Fused EK0 data likelihood: the per-member marginal log-likelihood of
observations and its exact gradient. Plain PyTorch versions and the
wrappers of the three CUDA kernels that replace the JAX package's Pallas
data-likelihood kernels and their custom VJP.

=====================================  ======================================
this module                            ``odefilters/ops/pallas_kernels.py``
=====================================  ======================================
``ek0_data_update``                    ``_ek0_data_update_lists``
``ek0_odd_step``                       ``_odd_step_lists``
``_seg_offsets``,                      the same names (the schedule of
``_sched_total_steps``,                observation times on and off the
``_build_offgrid_sched``,              uniform grid)
``_sched_odd_consts``
``step_table``                         (none: the schedule as data)
``ek0_datalik_plain`` /                ``_ek0_datalik_kernel`` via
``ek0_datalik``                        ``_ek0_datalik_blocked`` (CUDA:
                                       ``csrc/ek0_datalik.cu::
                                       ek0_datalik_kernel``)
``ek0_datalik_fwd_stream_plain`` /     ``_ek0_datalik_grad_fwd_kernel`` via
``ek0_datalik_grad_fwd``               ``_ek0_datalik_vjp_fwd`` (CUDA:
                                       ``ek0_datalik_grad_fwd_kernel``)
``ek0_datalik_grad_bwd_plain`` /       ``_ek0_datalik_grad_bwd_kernel`` via
``ek0_datalik_grad_bwd``               ``_ek0_datalik_vjp_bwd`` (CUDA:
                                       ``ek0_datalik_grad_bwd_kernel``)
``EK0DataLik``                         the ``jax.custom_vjp``
                                       ``_ek0_datalik_vjp``
``kernel_inputs``,                     its Taylor init, preconditioning
``pd_kernel_inputs``,                  and schedule (isotropic; per
``ek1_kernel_inputs``                  dimension: its one-hot rows and
                                       noise vector; EK1: its dense
                                       observation matrix and noise
                                       factor)
``ensemble_data_loglik``               ``ensemble_data_loglik_pallas``
                                       (its isotropic EK0 path here, its
                                       per-dimension EK0 / DiagonalEK1
                                       path in `ek0_datalik_pd`, its dense
                                       EK1 path in `ek1_datalik`)
=====================================  ======================================

The filter is the EK0 filter with the dynamic diffusion
(`ek0_pair.ek0_step_core`). After the steps that end at an observation
time a second, noisy update conditions on the observation
``y = u(t) + e``, ``e ~ N(0, r2 I_d)``, shared by every member, and adds
``log N(y; pinv0 m[0], s_d I_d)`` to the data log-likelihood. Observation
times off the uniform grid are merged into it on the host
(`odefilters_torch.datalik._merged_grid`); the steps of other lengths
around them rescale the state into their own preconditioned frame
(`ek0_odd_step`).

The schedule is data (`step_table`), not code: per step its time in the
solve's dtype, its constants set (0 the base step, i > 0 the i-th odd step
length) and the observation row applied after it (-1: none). The JAX
kernels unroll it at trace time instead (a dynamic read per step compiled
~100x slower in Mosaic). The step times follow the JAX kernels': a step
of a base-lattice run at lattice index k has the time ``t0 + dt (k+1)`` in
the dtype, every other step the merged grid's time in the dtype.

The gradient's forward streams the state at entry of every step, after any
data update, as packed rows ``(T, V, B)``: the means and the active upper
covariance triangle (`ek0_pair.pair_layout` without its s2 entry; V = 14
at q = 3, d = 2). The backward walks it in reverse: the adjoint of the
data update (where one follows the step), then that of the step, through
the vector field and, unless ``stop_calib``, the ``1/s2`` calibration. Its
plain version is ``torch.func.vjp`` of the composed step; the CUDA kernel
is a hand-written adjoint. The observations' cotangent is written per
member, ``(n_obs, d, B)``, and summed over the members by one
``torch.sum`` in both versions.

Dispatch: each wrapper runs its plain version on CPU tensors, launches its
CUDA kernel on CUDA tensors, raises on any other device, and counts its
launches in ``.launches``. `EK0DataLik` launches the primal kernel when no
input needs a gradient and the two gradient kernels otherwise.
"""

from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace
from typing import Callable, Optional

import numpy as np
import torch

from odefilters_torch.ops import _launch
from odefilters_torch.ops import ek0_datalik_pd as edp
from odefilters_torch.ops import ek0_pair as ep
from odefilters_torch.ops import ek1_datalik as e1d
from odefilters_torch.ops._blocks import _lists, _sreduce
from odefilters_torch.ops.ek0_filter import ll_increment
from odefilters_torch.ops.ek1_fused import auto_jac
from odefilters_torch.ops.ek1d import auto_jac_diag

_LOG_2PI = math.log(2.0 * math.pi)
BX = 1  # the measured derivative block


def datalik_layout(nq: int, d: int):
    """The stream row's active triangle ``(i, l)`` entries and its width
    ``V = nq*d + len(triu)`` (14 at q = 3, d = 2)."""
    triu, V = ep.pair_layout(nq, d, BX)
    return triu, V - 1


# -- the host-side schedule (ports of the JAX package's helpers) ----------


def _seg_offsets(seg_lens):
    offs = [0]
    for L in seg_lens:
        offs.append(offs[-1] + L)
    return offs


def _sched_total_steps(sched) -> int:
    """Total ODE steps of an off-grid schedule (= stream length)."""
    T = 0
    for it in sched:
        T += (it[2] - it[1]) if it[0] == "run" else 1
    return T


def _build_offgrid_sched(ts_np, is_data, dt: float, t0: float, tol: float):
    """Step schedule from a merged (base grid + observation times) grid.

    Items:

    * ``("run", k0, k1, off)``: a maximal run of base-lattice uniform steps
      with lattice indices k in [k0, k1) (step time t0 + dt (k+1)); stream
      position k + off.
    * ``("one", pos, t_b, dtp, si)``: a single step to the time ``t_b``
      with step size ``dtp`` (``dt`` for a lattice step that ends at an
      observation); ``si >= 0`` applies observation ``si`` after the step
      (-1: none); stream position ``pos``.
    """
    items = []
    T = len(ts_np) - 1
    run = None  # [k0, k1, off]
    si_counter = 0
    for i in range(T):
        t_b = float(ts_np[i + 1])
        dti = float(ts_np[i + 1] - ts_np[i])
        m_lat = int(round((t_b - t0) / dt))
        uniform = (
            abs(dti - dt) <= tol
            and abs(t_b - (t0 + m_lat * dt)) <= tol
        )
        data_after = bool(is_data[i + 1])
        if uniform and not data_after:
            k = m_lat - 1
            if run is not None and run[1] == k and run[2] == i - k:
                run[1] = k + 1
            else:
                if run is not None:
                    items.append(("run", run[0], run[1], run[2]))
                run = [k, k + 1, i - k]
        else:
            if run is not None:
                items.append(("run", run[0], run[1], run[2]))
                run = None
            si = si_counter if data_after else -1
            if data_after:
                si_counter += 1
            items.append((
                "one", i, t_b, float(dt) if uniform else dti, si
            ))
    if run is not None:
        items.append(("run", run[0], run[1], run[2]))
    assert _sched_total_steps(items) == T
    return tuple(items)


def _sched_odd_consts(sched, q: int, dt: float):
    """Per odd step size ``dtp != dt`` of ``sched``, in order of first use:
    ``(At', Qt', pinv0', pinv1', pinv_b', r)``, with ``r`` the rescale
    factors ``p_i(dtp) / p_i(dt)`` that take a state preconditioned at the
    base ``dt`` into the ``dtp`` frame (and back by division). Host floats
    (float64 numpy matrices)."""
    out = {}
    nq = q + 1
    for it in sched:
        if it[0] == "one":
            dtp = it[3]
            if dtp != dt and dtp not in out:
                At_o, Qt_o, _, p_o = ep.pair_constants(q, dtp)
                jj = np.arange(nq, dtype=np.float64)
                r = tuple(
                    float(v) for v in
                    (float(dtp) ** (jj - q - 0.5))
                    / (float(dt) ** (jj - q - 0.5))
                )
                out[dtp] = (At_o, Qt_o, float(1.0 / p_o[0]),
                            float(1.0 / p_o[1]), float(1.0 / p_o[2]), r)
    return out


@dataclasses.dataclass(frozen=True)
class StepTable:
    """The schedule as data, for T steps.

    ``times``: ``(T,)`` step times in the solve's dtype; ``codes``: int32
    ``(2, T)``, row 0 the constants set (0 base, i > 0 ``odd[i-1]``) and
    row 1 the observation row applied after the step (-1: none); ``odd``:
    the odd sets' ``(At', Qt', pinv0', pinv1', pinv_b', r)``; ``odd_flat``:
    float64 ``(n_odd, odd_width(nq))`` rows ``[At' | Qt' | pinv0' | pinv1'
    | 0 | 0 | r]`` for the kernels. ``sets``, ``rows``: host copies of
    ``codes``."""

    times: torch.Tensor
    codes: torch.Tensor
    odd: tuple
    odd_flat: torch.Tensor
    sets: tuple
    rows: tuple

    @property
    def n_steps(self) -> int:
        return len(self.sets)


def odd_width(nq: int) -> int:
    """Doubles per odd set in ``StepTable.odd_flat``."""
    return 2 * nq * nq + 4 + nq


def step_table(t0: float, dt: float, q: int, dtype, device, *,
               seg_lens=None, sched=None) -> StepTable:
    """The step table of an on-grid segmentation ``seg_lens`` (steps
    between observations; observation si after the last step of segment
    si) or of an off-grid schedule ``sched`` (`_build_offgrid_sched`)."""
    if (seg_lens is None) == (sched is None):
        raise ValueError("pass seg_lens or sched")
    nq = q + 1
    if sched is None:
        offs = _seg_offsets(seg_lens)
        T = offs[-1]
        times = ep.step_times(t0, dt, T, dtype, "cpu")
        sets, rows = [0] * T, [-1] * T
        for si in range(len(seg_lens) - 1):
            rows[offs[si + 1] - 1] = si
        odd = {}
    else:
        odd = _sched_odd_consts(sched, q, dt)
        index = {dtp: i + 1 for i, dtp in enumerate(odd)}
        T = _sched_total_steps(sched)
        K = max([it[2] for it in sched if it[0] == "run"], default=0)
        lattice = ep.step_times(t0, dt, K, dtype, "cpu")
        times = torch.empty(T, dtype=dtype)
        sets, rows = [0] * T, [-1] * T
        for it in sched:
            if it[0] == "run":
                _, k0, k1, off = it
                times[k0 + off:k1 + off] = lattice[k0:k1]
            else:
                _, pos, t_b, dtp, si = it
                times[pos] = torch.tensor(t_b, dtype=dtype)
                sets[pos] = 0 if dtp == dt else index[dtp]
                rows[pos] = si
    # the kernels' row: At', Qt', pinv0', pinv1', t0 and dt (unused: the
    # table holds the times), r
    flat = [list(np.asarray(c[0]).ravel()) + list(np.asarray(c[1]).ravel())
            + [c[2], c[3], 0.0, 0.0] + list(c[5]) for c in odd.values()]
    return StepTable(
        times=times.to(device),
        codes=torch.tensor([sets, rows], dtype=torch.int32, device=device),
        odd=tuple(odd.values()),
        odd_flat=torch.tensor(flat, dtype=torch.float64,
                              device=device).reshape(len(odd), odd_width(nq)),
        sets=tuple(sets), rows=tuple(rows),
    )


# -- the step bodies on lists of (B,) tensors ------------------------------


def ek0_data_update(m, C, y_row, *, pinv0: float, r2: float, d: int,
                    nq: int):
    """The isotropic noisy update on derivative block 0 with observation
    ``y_row`` (d entries) and noise variance ``r2``: ``(m_new, C_new,
    dll_inc)``.

    Row and column BX of ``C`` are zeros (structural or exact) and stay so:
    the gain ``kgd[BX] = pinv0 C[BX][0] / s_d`` is 0, so block BX of the
    mean is unchanged and the active triangle alone is updated (mirrored)."""
    act = [a for a in range(nq) if a != BX]
    zd = [y_row[j] - pinv0 * m[0][j] for j in range(d)]
    s_d = pinv0 * pinv0 * C[0][0] + r2
    inv_sd = 1.0 / s_d
    kgd = {i: pinv0 * C[i][0] * inv_sd for i in act}
    m_new = [[m[i][j] + kgd[i] * zd[j] for j in range(d)] if i != BX
             else list(m[i]) for i in range(nq)]
    C_new = [list(row) for row in C]
    for i in act:
        for l in act:
            if l < i:
                continue
            C_new[i][l] = C[i][l] - kgd[i] * kgd[l] * s_d
            C_new[l][i] = C_new[i][l]
    zzd = _sreduce([z * z for z in zd])
    dll_inc = -0.5 * (zzd * inv_sd + d * (torch.log(s_d) + _LOG_2PI))
    return m_new, C_new, dll_inc


def _base_step(m, C, p, t_new, *, f, base, d, nq, stop_calib):
    m_new, C_new, _, zz, _, s, inv_s = ep.ek0_step_core(
        m, C, p, t_new, f=f, At=base["At"], Qt=base["Qt"],
        pinv0=base["pinv0"], pinv1=base["pinv1"], d=d, nq=nq,
        stop_calib=stop_calib,
    )
    return m_new, C_new, ll_increment(zz, s, inv_s, d)


def ek0_odd_step(m, C, p, t_new, oc, *, f: Callable, d: int, nq: int,
                 stop_calib: bool = False):
    """One EK0 step of another length: rescale the state, preconditioned at
    the base step, into the odd set ``oc``'s frame by ``r``, step with its
    constants, rescale back. Returns ``(m_new, C_new, ll_inc)``."""
    At_o, Qt_o, pinv0_o, pinv1_o, _, r = oc
    act = [a for a in range(nq) if a != BX]
    mh = [[m[i][j] * r[i] for j in range(d)] for i in range(nq)]
    Ch = [[0.0] * nq for _ in range(nq)]
    for i in act:
        for l in act:
            if l >= i:
                Ch[i][l] = C[i][l] * (r[i] * r[l])
                Ch[l][i] = Ch[i][l]
    m1, C1, ll_inc = _base_step(
        mh, Ch, p, t_new, f=f,
        base=dict(At=_lists(At_o), Qt=_lists(Qt_o), pinv0=pinv0_o,
                  pinv1=pinv1_o),
        d=d, nq=nq, stop_calib=stop_calib,
    )
    m_new = [[m1[i][j] / r[i] for j in range(d)] for i in range(nq)]
    C_new = [list(row) for row in C1]
    for i in act:
        for l in act:
            if l >= i:
                C_new[i][l] = C1[i][l] / (r[i] * r[l])
                C_new[l][i] = C_new[i][l]
    return m_new, C_new, ll_inc


def _step(m, C, p, t_new, k_set, *, f, base, odd, d, nq, stop_calib=False):
    """Step with constants set ``k_set`` of a `StepTable`."""
    if k_set == 0:
        return _base_step(m, C, p, t_new, f=f, base=base, d=d, nq=nq,
                          stop_calib=stop_calib)
    return ek0_odd_step(m, C, p, t_new, odd[k_set - 1], f=f, d=d, nq=nq,
                        stop_calib=stop_calib)


def _base(At, Qt, pinv0, pinv1):
    return dict(At=_lists(At), Qt=_lists(Qt), pinv0=pinv0, pinv1=pinv1)


def _walk(f, m0_p, ps, ys, table, *, At, Qt, pinv0, pinv1, r2, st=None):
    """The forward over the table; writes the stream ``st`` if given."""
    nq, d, _ = m0_p.shape
    triu, _ = datalik_layout(nq, d)
    base = _base(At, Qt, pinv0, pinv1)
    m = [[m0_p[i, j] for j in range(d)] for i in range(nq)]
    zero = torch.zeros_like(m[0][0])
    C = [[zero] * nq for _ in range(nq)]
    ll = dll = zero
    for k in range(table.n_steps):
        if st is not None:
            torch.stack([x for mi in m for x in mi]
                        + [C[i][l] for (i, l) in triu], out=st[k])
        m, C, ll_inc = _step(m, C, ps, table.times[k], table.sets[k], f=f,
                             base=base, odd=table.odd, d=d, nq=nq)
        ll = ll + ll_inc
        r = table.rows[k]
        if r >= 0:
            m, C, dll_inc = ek0_data_update(
                m, C, [ys[r, j] for j in range(d)], pinv0=pinv0, r2=r2, d=d,
                nq=nq)
            dll = dll + dll_inc
    return dll, ll


def ek0_datalik_plain(f: Callable, m0_p, ps, ys, table: StepTable, *, At, Qt,
                      pinv0: float, pinv1: float, r2: float):
    """The primal: ``(dll, ll)``, each ``(B,)``, from the preconditioned
    initial means ``m0_p`` ``(nq, d, B)``, the parameters ``ps``
    ``(n_params, B)`` and the observations ``ys`` ``(n_obs, d)``."""
    return _walk(f, m0_p, ps, ys, table, At=At, Qt=Qt, pinv0=pinv0,
                 pinv1=pinv1, r2=r2)


def ek0_datalik_fwd_stream_plain(f: Callable, m0_p, ps, ys, table: StepTable,
                                 *, At, Qt, pinv0: float, pinv1: float,
                                 r2: float):
    """The gradient's forward: ``(dll, ll, st)`` with ``st`` ``(T, V, B)``
    the packed state at entry of every step (`datalik_layout`)."""
    nq, d, B = m0_p.shape
    _, V = datalik_layout(nq, d)
    st = torch.empty((table.n_steps, V, B), dtype=m0_p.dtype,
                     device=m0_p.device)
    dll, ll = _walk(f, m0_p, ps, ys, table, At=At, Qt=Qt, pinv0=pinv0,
                    pinv1=pinv1, r2=r2, st=st)
    return dll, ll, st


def ek0_datalik_grad_bwd_plain(
    f: Callable, st, ps, ys, ddll, dall, table: StepTable, *, nq: int, At, Qt,
    pinv0: float, pinv1: float, r2: float, stop_calib: bool = False,
):
    """The adjoint sweep: from step T-1 down to 0, ``torch.func.vjp`` of
    the step composed with the data update that follows it, with the
    cotangents ``ddll`` of the data log-likelihood and ``dall`` of the ODE
    one (each ``(B,)``). Returns ``(dm0_p (nq, d, B), dps, dy_part)`` with
    the observations' cotangent per member, ``(n_obs, d, B)``."""
    T, _, B = st.shape
    n_obs, d = ys.shape
    triu, _ = datalik_layout(nq, d)
    base = _base(At, Qt, pinv0, pinv1)
    kw = dict(f=f, base=base, odd=table.odd, d=d, nq=nq, stop_calib=stop_calib)

    def full(C_tri):
        C = [[0.0] * nq for _ in range(nq)]
        for (i, l), c in zip(triu, C_tri):
            C[i][l] = c
            C[l][i] = c
        return C

    def step_only(m, C_tri, p, t, k_set):
        m1, C1, ll_inc = _step(m, full(C_tri), p, t, k_set, **kw)
        return m1, [C1[i][l] for (i, l) in triu], ll_inc

    def step_data(m, C_tri, p, y, t, k_set):
        m1, C1, ll_inc = _step(m, full(C_tri), p, t, k_set, **kw)
        m2, C2, dll_inc = ek0_data_update(m1, C1, y, pinv0=pinv0, r2=r2, d=d,
                                          nq=nq)
        return m2, [C2[i][l] for (i, l) in triu], ll_inc, dll_inc

    zero = torch.zeros_like(ddll)
    dm = [[zero] * d for _ in range(nq)]
    dC = [zero] * len(triu)
    dp = torch.zeros_like(ps)
    dy_part = torch.zeros((n_obs, d, B), dtype=st.dtype, device=st.device)
    for k in range(T - 1, -1, -1):
        m_k = [[st[k, i * d + j] for j in range(d)] for i in range(nq)]
        C_k = [st[k, nq * d + idx] for idx in range(len(triu))]
        t, k_set, r = table.times[k], table.sets[k], table.rows[k]
        if r >= 0:
            y_b = [ys[r, j].expand(B).contiguous() for j in range(d)]
            _, vjp_fn = torch.func.vjp(
                lambda m, C, p, y: step_data(m, C, p, y, t, k_set),
                m_k, C_k, ps, y_b)
            dm, dC, dp_k, dy_k = vjp_fn((dm, dC, dall, ddll))
            for j in range(d):
                dy_part[r, j] = dy_k[j]
        else:
            _, vjp_fn = torch.func.vjp(
                lambda m, C, p: step_only(m, C, p, t, k_set), m_k, C_k, ps)
            dm, dC, dp_k = vjp_fn((dm, dC, dall))
        dp = dp + dp_k
    return torch.stack([torch.stack(row) for row in dm]), dp, dy_part


# -- the kernels' wrappers -------------------------------------------------


def _check_table(name, table: StepTable, device):
    for tname, t, dtype in (("codes", table.codes, torch.int32),
                            ("odd_flat", table.odd_flat, torch.float64)):
        _launch.check_cuda_inputs(name, {tname: t}, dtype)
        if t.device != device:
            raise ValueError(f"{name}: the step table's {tname} is on "
                             f"{t.device}, the inputs on {device}")


def _check_inputs(name, field, m0_p, ps, ys, table):
    nq, d, B = m0_p.shape
    _launch.check_field(name, field, nq, d, B, ps)
    if ys.ndim != 2 or ys.shape[1] != d:
        raise ValueError(f"{name}: ys must be (n_obs, {d}), got {tuple(ys.shape)}")
    _launch.check_cuda_inputs(name, {"m0_p": m0_p, "ps": ps, "ys": ys,
                                     "times": table.times}, m0_p.dtype)
    _check_table(name, table, m0_p.device)


def _table_args(table: StepTable):
    n_odd = len(table.odd)
    return (table.times.data_ptr(), table.codes.data_ptr(),
            table.odd_flat.data_ptr() if n_odd else None)


def _host_consts(At, Qt, pinv0, pinv1, r2):
    """The kernels' constants: At, Qt, pinv0, pinv1, t0 and dt (unused: the
    table holds the step times), r2."""
    return _launch.host_consts(At, Qt, scalars=(pinv0, pinv1, 0.0, 0.0, r2))


def ek0_datalik(f: Callable, field: Optional[str], m0_p, ps, ys,
                table: StepTable, *, At, Qt, pinv0: float, pinv1: float,
                r2: float):
    """The primal: `ek0_datalik_plain` on CPU tensors, the CUDA kernel
    ``ek0_datalik_kernel`` on CUDA tensors. Returns ``(dll, ll)``."""
    kw = dict(At=At, Qt=Qt, pinv0=pinv0, pinv1=pinv1, r2=r2)
    if _launch.dispatch_device("ek0_datalik", m0_p) == "cpu":
        return ek0_datalik_plain(f, m0_p, ps, ys, table, **kw)
    _check_inputs("ek0_datalik", field, m0_p, ps, ys, table)
    B = m0_p.shape[2]
    new = dict(dtype=m0_p.dtype, device=m0_p.device)
    dll, ll = torch.empty((B,), **new), torch.empty((B,), **new)
    _launch.launch(ek0_datalik, m0_p.device,
                   f"ek0_datalik_{field}_{_launch.suffix(m0_p.dtype)}",
                   m0_p.data_ptr(), ps.data_ptr(), ys.data_ptr(),
                   *_table_args(table), dll.data_ptr(), ll.data_ptr(), B,
                   table.n_steps, ys.shape[0], len(table.odd),
                   _host_consts(At, Qt, pinv0, pinv1, r2))
    return dll, ll


ek0_datalik.launches = 0


def ek0_datalik_grad_fwd(f: Callable, field: Optional[str], m0_p, ps, ys,
                         table: StepTable, *, At, Qt, pinv0: float,
                         pinv1: float, r2: float):
    """The gradient's forward: `ek0_datalik_fwd_stream_plain` on CPU
    tensors, the CUDA kernel ``ek0_datalik_grad_fwd_kernel`` on CUDA
    tensors. Returns ``(dll, ll, st)``."""
    kw = dict(At=At, Qt=Qt, pinv0=pinv0, pinv1=pinv1, r2=r2)
    if _launch.dispatch_device("ek0_datalik_grad_fwd", m0_p) == "cpu":
        return ek0_datalik_fwd_stream_plain(f, m0_p, ps, ys, table, **kw)
    _check_inputs("ek0_datalik_grad_fwd", field, m0_p, ps, ys, table)
    nq, d, B = m0_p.shape
    _, V = datalik_layout(nq, d)
    new = dict(dtype=m0_p.dtype, device=m0_p.device)
    dll, ll = torch.empty((B,), **new), torch.empty((B,), **new)
    st = torch.empty((table.n_steps, V, B), **new)
    _launch.launch(ek0_datalik_grad_fwd, m0_p.device,
                   f"ek0_datalik_grad_fwd_{field}_{_launch.suffix(m0_p.dtype)}",
                   m0_p.data_ptr(), ps.data_ptr(), ys.data_ptr(),
                   *_table_args(table), dll.data_ptr(), ll.data_ptr(),
                   st.data_ptr(), B, table.n_steps, ys.shape[0],
                   len(table.odd),
                   _host_consts(At, Qt, pinv0, pinv1, r2))
    return dll, ll, st


ek0_datalik_grad_fwd.launches = 0


def ek0_datalik_grad_bwd(
    f: Callable, field: Optional[str], st, ps, ys, ddll, dall,
    table: StepTable, *, nq: int, At, Qt, pinv0: float, pinv1: float,
    r2: float, stop_calib: bool = False,
):
    """The adjoint sweep: `ek0_datalik_grad_bwd_plain` on CPU tensors, the
    CUDA kernel ``ek0_datalik_grad_bwd_kernel`` (hand-written adjoint) on
    CUDA tensors. Returns ``(dm0_p, dps, dys)``, ``dys`` the per-member
    cotangents of the observations summed over the members."""
    kw = dict(nq=nq, At=At, Qt=Qt, pinv0=pinv0, pinv1=pinv1, r2=r2,
              stop_calib=stop_calib)
    if _launch.dispatch_device("ek0_datalik_grad_bwd", st) == "cpu":
        dm0, dps, dy_part = ek0_datalik_grad_bwd_plain(
            f, st, ps, ys, ddll, dall, table, **kw)
        return dm0, dps, torch.sum(dy_part, dim=-1)
    T, V, B = st.shape
    n_obs, d = ys.shape
    _launch.check_field("ek0_datalik_grad_bwd", field, nq, d, B, ps)
    _, V_want = datalik_layout(nq, d)
    if (V != V_want or T != table.n_steps or tuple(ddll.shape) != (B,)
            or tuple(dall.shape) != (B,)):
        raise ValueError(
            f"ek0_datalik_grad_bwd: takes st ({table.n_steps}, {V_want}, B), "
            f"ddll (B,), dall (B,); got {tuple(st.shape)}, "
            f"{tuple(ddll.shape)}, {tuple(dall.shape)}"
        )
    _launch.check_cuda_inputs(
        "ek0_datalik_grad_bwd",
        {"st": st, "ps": ps, "ys": ys, "ddll": ddll, "dall": dall,
         "times": table.times}, st.dtype)
    _check_table("ek0_datalik_grad_bwd", table, st.device)
    new = dict(dtype=st.dtype, device=st.device)
    dm0 = torch.empty((nq, d, B), **new)
    dps = torch.empty(tuple(ps.shape), **new)
    dy_part = torch.zeros((n_obs, d, B), **new)
    _launch.launch(ek0_datalik_grad_bwd, st.device,
                   f"ek0_datalik_grad_bwd_{field}_{_launch.suffix(st.dtype)}",
                   st.data_ptr(), ps.data_ptr(), ys.data_ptr(),
                   *_table_args(table), ddll.data_ptr(), dall.data_ptr(),
                   dm0.data_ptr(), dps.data_ptr(), dy_part.data_ptr(), B, T,
                   n_obs, len(table.odd), int(stop_calib),
                   _host_consts(At, Qt, pinv0, pinv1, r2))
    return dm0, dps, torch.sum(dy_part, dim=-1)


ek0_datalik_grad_bwd.launches = 0


class EK0DataLik(torch.autograd.Function):
    """The data likelihood as an autograd node: ``(m0_p, ps, ys) -> (dll,
    ll)``. Without a gradient to compute it runs the primal kernel; with
    one, the gradient's forward, saving the state stream for the adjoint
    sweep."""

    @staticmethod
    def forward(ctx, m0_p, ps, ys, f, field, table, consts, stop_calib,
                want_grad):
        if not want_grad:
            return ek0_datalik(f, field, m0_p, ps, ys, table, **consts)
        dll, ll, st = ek0_datalik_grad_fwd(f, field, m0_p, ps, ys, table,
                                           **consts)
        ctx.save_for_backward(st, ps, ys)
        ctx.f, ctx.field, ctx.table, ctx.consts = f, field, table, consts
        ctx.stop_calib, ctx.nq = stop_calib, m0_p.shape[0]
        return dll, ll

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, ddll, dall):
        # cotangents of unused outputs arrive as zeros (materialized grads)
        st, ps, ys = ctx.saved_tensors
        dm0, dps, dys = ek0_datalik_grad_bwd(
            ctx.f, ctx.field, st, ps, ys, ddll.contiguous(), dall.contiguous(),
            ctx.table, nq=ctx.nq, stop_calib=ctx.stop_calib, **ctx.consts,
        )
        return dm0, dps, dys, None, None, None, None, None, None


def _schedule(tspan, n_steps: int, ts_data, dtype):
    """``(seg_lens, sched)``, one of them None: the steps between
    observations on the uniform grid, or the off-grid schedule of the grid
    merged with the observation times (in the solve's ``dtype``, whose ULP
    sets the merge's tolerance). Raises ``ValueError`` for times outside
    ``(t0, t1]`` or not strictly increasing, as the JAX package does."""
    t0, t1 = float(tspan[0]), float(tspan[1])
    T = int(n_steps)
    dt = (t1 - t0) / T
    td = np.asarray(ts_data, dtype=np.float64)
    kidx = np.round((td - t0) / dt).astype(int)
    if not np.any(np.abs(td - (t0 + kidx * dt)) > 1e-6 * dt):
        if np.any(kidx < 1) or np.any(kidx > T):
            raise ValueError("ts_data must be in (t0, t1]")
        if np.any(np.diff(kidx) <= 0):
            raise ValueError("ts_data must be strictly increasing (unique rows)")
        bounds = np.concatenate([[0], kidx, [T]])
        return tuple(int(x) for x in np.diff(bounds)), None
    from odefilters_torch.datalik import _merged_grid

    ts_m, is_data, _ = _merged_grid(SimpleNamespace(tspan=(t0, t1)), td, T,
                                    dtype)
    if is_data[0]:
        raise ValueError("ts_data must be strictly after t0")
    eps_span = (t1 - t0) * float(np.finfo(ts_m.dtype).eps)
    tol = max(dt * 1e-6, 64.0 * eps_span)
    return None, _build_offgrid_sched(ts_m.astype(np.float64), is_data, dt,
                                      t0, tol)


def data_table(tspan, n_steps: int, ts_data, q: int, dtype, device,
               schedule=None) -> StepTable:
    """The `StepTable` of ``n_steps`` uniform steps of ``tspan`` with
    observations at ``ts_data``, built on the host. ``schedule``:
    `_schedule`'s ``(seg_lens, sched)`` where the caller has it."""
    t0, t1 = float(tspan[0]), float(tspan[1])
    if schedule is None:
        schedule = _schedule(tspan, n_steps, ts_data, dtype)
    seg_lens, sched = schedule
    return step_table(t0, (t1 - t0) / int(n_steps), q, dtype, device,
                      seg_lens=seg_lens, sched=sched)


def initial_means(prob_f: Callable, u0s, ps, tspan, n_steps: int, q: int):
    """``(m0_p, ps_t)``: the preconditioned Taylor initial means
    ``(q+1, d, B)`` of ``u0s`` ``(B, d)`` and the parameters
    ``(n_params, B)``, differentiable in ``u0s`` and ``ps``."""
    from odefilters_torch.taylor import taylor_coefficients

    t0, t1 = float(tspan[0]), float(tspan[1])
    # contiguous copies: forward-mode AD refuses inputs whose elements
    # alias one another, as in an expanded (broadcast) ensemble
    ps_t = ps.T.contiguous()
    m0 = torch.stack(taylor_coefficients(prob_f, u0s.T.contiguous(), ps_t,
                                         t0, q))
    p = ep.pair_constants(q, (t1 - t0) / int(n_steps))[3]
    m0_p = torch.as_tensor(p, dtype=u0s.dtype,
                           device=m0.device)[:, None, None] * m0
    return m0_p, ps_t


def kernel_inputs(prob_f: Callable, u0s, ps, tspan, n_steps: int, ts_data,
                  ys, obs_noise_std: float, q: int = 3, schedule=None):
    """What `ensemble_data_loglik` hands the kernels for an ensemble ``u0s``
    ``(B, d)``, ``ps`` ``(B, n_params)`` and observations ``ys``
    ``(n_obs, d)`` with scalar noise std: ``(m0_p, ps_t, ys, table,
    consts)``, `initial_means`, the observations in the solve's dtype,
    `data_table` (``schedule`` as there) and the constants ``At, Qt, pinv0,
    pinv1, r2``. Differentiable in ``u0s``, ``ps`` and ``ys``."""
    dt = (float(tspan[1]) - float(tspan[0])) / int(n_steps)
    m0_p, ps_t = initial_means(prob_f, u0s, ps, tspan, n_steps, q)
    table = data_table(tspan, n_steps, ts_data, q, u0s.dtype, u0s.device,
                       schedule)
    At, Qt, _, p = ep.pair_constants(q, dt)
    consts = dict(At=At, Qt=Qt, pinv0=float(1.0 / p[0]),
                  pinv1=float(1.0 / p[1]), r2=float(obs_noise_std) ** 2)
    return m0_p, ps_t, torch.as_tensor(ys, device=u0s.device).to(u0s.dtype), \
        table, consts


def pd_kernel_inputs(prob_f: Callable, u0s, ps, tspan, n_steps: int, ts_data,
                     ys, obs_noise_std, q: int = 3, *, obs_matrix=None,
                     schedule=None):
    """What `ensemble_data_loglik` hands the per-dimension kernels for an
    ensemble ``u0s`` ``(B, d)``, ``ps`` ``(B, n_params)``, observations
    ``ys`` ``(n_obs, d_obs)`` or ``(B, n_obs, d_obs)`` of the (scaled)
    one-hot rows ``obs_matrix`` (None: the identity) with noise std
    ``obs_noise_std`` (a scalar or ``(d_obs,)``): ``(m0_p, ps_t, ys,
    table, consts)``, `initial_means`, the observations in the solve's
    dtype (per member as ``(n_obs, d_obs, B)``, so that the kernels' reads
    coalesce over the members), `data_table` (on the grid; ``schedule`` as
    there) and the constants ``At, Qt, pinv0, pinv1, obs_dims, obs_scales,
    r2s``. Differentiable in ``u0s``, ``ps`` and ``ys``."""
    d = u0s.shape[1]
    C_sel = np.eye(d) if obs_matrix is None else np.asarray(obs_matrix,
                                                            np.float64)
    obs_dims, obs_scales = edp.obs_rows(C_sel)
    r_std = np.asarray(obs_noise_std, np.float64)
    r2s = np.full(len(obs_dims), float(r_std) ** 2) if r_std.ndim == 0 \
        else r_std ** 2
    dt = (float(tspan[1]) - float(tspan[0])) / int(n_steps)
    m0_p, ps_t = initial_means(prob_f, u0s, ps, tspan, n_steps, q)
    table = data_table(tspan, n_steps, ts_data, q, u0s.dtype, u0s.device,
                       schedule)
    At, Qt, _, p = ep.pair_constants(q, dt)
    consts = dict(At=At, Qt=Qt, pinv0=float(1.0 / p[0]),
                  pinv1=float(1.0 / p[1]), obs_dims=obs_dims,
                  obs_scales=obs_scales, r2s=tuple(float(r) for r in r2s))
    return m0_p, ps_t, _kernel_ys(ys, u0s), table, consts


def _kernel_ys(ys, u0s):
    """The observations in the solve's dtype on ``u0s``' device, per member
    as ``(n_obs, d_obs, B)`` so that the kernels' reads coalesce over the
    members."""
    ys = torch.as_tensor(ys, device=u0s.device).to(u0s.dtype)
    return ys.permute(1, 2, 0).contiguous() if ys.ndim == 3 else ys


def ek1_kernel_inputs(prob_f: Callable, u0s, ps, tspan, n_steps: int, ts_data,
                      ys, obs_noise_std, q: int = 3, *, obs_matrix=None,
                      schedule=None):
    """What `ensemble_data_loglik` hands the dense EK1 kernels for an
    ensemble ``u0s`` ``(B, d)``, ``ps`` ``(B, n_params)``, observations
    ``ys`` ``(n_obs, d_obs)`` or ``(B, n_obs, d_obs)`` of ``obs_matrix @
    u(t)`` (any ``(d_obs, d)`` matrix; None: the identity) with noise std
    ``obs_noise_std`` (a scalar or ``(d_obs,)``): ``(m0_p, ps_t, ys,
    table, consts)``, `initial_means`, the observations in the solve's
    dtype (per member as ``(n_obs, d_obs, B)``), `data_table` (on the
    grid; ``schedule`` as there) and the constants ``At, QLt, pinv0,
    pinv1, C_obs, R_chol``: the observation matrix and the diagonal noise
    factor ``diag(obs_noise_std)`` as numpy arrays in the solve's dtype,
    as the JAX kernels cast them. Differentiable in ``u0s``, ``ps`` and
    ``ys``."""
    d = u0s.shape[1]
    C_full = np.eye(d) if obs_matrix is None else np.asarray(obs_matrix,
                                                             np.float64)
    r_std = np.asarray(obs_noise_std, np.float64)
    r2_vec = np.full(C_full.shape[0], float(r_std) ** 2) if r_std.ndim == 0 \
        else r_std ** 2
    np_dtype = np.float32 if u0s.dtype == torch.float32 else np.float64
    dt = (float(tspan[1]) - float(tspan[0])) / int(n_steps)
    m0_p, ps_t = initial_means(prob_f, u0s, ps, tspan, n_steps, q)
    table = data_table(tspan, n_steps, ts_data, q, u0s.dtype, u0s.device,
                       schedule)
    At, _, QLt, p = ep.pair_constants(q, dt)
    consts = dict(At=At, QLt=QLt, pinv0=float(1.0 / p[0]),
                  pinv1=float(1.0 / p[1]), C_obs=C_full.astype(np_dtype),
                  R_chol=np.diag(np.sqrt(r2_vec)).astype(np_dtype))
    return m0_p, ps_t, _kernel_ys(ys, u0s), table, consts


def _wants_grad(*xs) -> bool:
    """Whether autograd will ask for a gradient of any of ``xs``."""
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def ensemble_data_loglik(
    prob_f: Callable,
    u0s: torch.Tensor,
    ps: torch.Tensor,
    tspan,
    n_steps: int,
    ts_data,
    ys,
    obs_noise_std,
    q: int = 3,
    *,
    field: Optional[str] = None,
    prior=None,
    mesh=None,
    obs_matrix=None,
    ek1: bool = False,
    jac=None,
    second_order: bool = False,
    calib_grad: bool = True,
    diagonal_ek1: bool = False,
    jac_diag=None,
):
    """Per-member marginal data log-likelihood of an ensemble of B
    candidates ``(u0, p)`` (``u0s`` ``(B, d)``, ``ps`` ``(B, n_params)``,
    any B) from the fused EK0 (with ``diagonal_ek1``, DiagonalEK1; with
    ``ek1``, dense EK1) filter over ``n_steps`` uniform steps of
    ``tspan``, with dynamic diffusion.

    ``ts_data``: strictly increasing observation times in ``(t0, t1]``;
    ``ys``: the observations, ``(n_obs, d_obs)`` shared by all members or
    ``(B, n_obs, d_obs)`` per member, of ``obs_matrix @ u(t)`` (``(d_obs,
    d)``: (scaled) one-hot rows, or with ``ek1`` any matrix; None: the
    full state) with noise std ``obs_noise_std`` (a scalar or a
    ``(d_obs,)`` vector). ``jac_diag``: the Jacobian diagonal ``(u, p, t)
    -> (d, B)`` for ``diagonal_ek1``, ``jac`` the Jacobian ``(u, p, t) ->
    (d, d, B)`` for ``ek1`` (None: d JVPs of ``prob_f``; the card's
    kernels evaluate the CUDA field's own). ``field``: the CUDA vector
    field of ``prob_f`` (``ODEProblem.field``), which the kernels need on
    the card.

    Full-state observations with scalar noise shared by all members run
    the isotropic EK0 kernels, with the observation times on the uniform
    grid or off it (merged into it on the host, as
    `odefilters_torch.datalik._merged_grid` does); every other observation
    model runs the per-dimension kernels (`ek0_datalik_pd`), and ``ek1``
    the dense EK1 kernels with joint noisy updates in square-root form
    (`ek1_datalik`), on the grid only, as in the JAX package.

    Returns ``(data_ll, ode_ll)``, each ``(B,)``, differentiable in
    ``u0s``, ``ps`` and ``ys``. ``calib_grad=False`` treats the per-step
    calibration as part of the model in the gradient (the values are the
    same): the float32 gradient then stays accurate at long horizons,
    where the full one is dominated by innovations at the solver's
    accuracy floor.

    Raises as the JAX package does: ``ValueError`` for dense observation
    rows without ``ek1`` ("one-hot") and for ``ek1`` with
    ``diagonal_ek1``, ``NotImplementedError`` for off-grid times outside
    the isotropic path and for ``second_order`` outside it. Not ported yet
    (``NotImplementedError``): ``second_order`` and ``prior`` (ROADMAP.md
    queue 1, item 5); ``mesh``.
    """
    if mesh is not None:
        raise NotImplementedError(
            "mesh= is not supported: the port runs on one card")
    B, d_in = u0s.shape
    if second_order and d_in % 2:
        raise ValueError(
            f"second_order expects u0s = [u0 | du0] with even width, got {d_in}"
        )
    if second_order and q < 2:
        raise ValueError("second_order needs q >= 2 (measures block 2)")
    d = d_in // 2 if second_order else d_in
    n_obs = np.asarray(ts_data).shape[0]
    ys = torch.as_tensor(ys, device=u0s.device)
    C_np = None if obs_matrix is None else np.asarray(obs_matrix, np.float64)
    if C_np is not None and (C_np.ndim != 2 or C_np.shape[1] != d):
        raise ValueError(f"obs_matrix must have shape (d_obs, {d})")
    d_obs = d if C_np is None else C_np.shape[0]
    y_batched = ys.ndim == 3
    expect = (B, n_obs, d_obs) if y_batched else (n_obs, d_obs)
    if tuple(ys.shape) != expect:
        raise ValueError(f"ys must have shape {expect}, got {tuple(ys.shape)}")
    r_std = np.asarray(obs_noise_std, np.float64)
    if r_std.ndim != 0 and r_std.shape != (d_obs,):
        raise ValueError(
            f"obs_noise_std must be a scalar or ({d_obs},) vector"
        )
    schedule = _schedule(tspan, n_steps, ts_data, u0s.dtype)
    sched = schedule[1]
    if ek1 and diagonal_ek1:
        raise ValueError("pass ek1=True OR diagonal_ek1=True, not both")
    iso = (not ek1 and not diagonal_ek1 and not y_batched and C_np is None
           and r_std.ndim == 0)
    if second_order and not iso:
        raise NotImplementedError(
            "second_order data likelihood supports full-state "
            "observations with scalar noise shared by all members"
        )
    if sched is not None and not iso:
        raise NotImplementedError(
            "off-grid ts_data on the fused kernels is supported for the "
            "isotropic EK0 path (full-state obs, scalar noise, shared data)"
        )
    _launch.check_ported(prior=prior, second_order=second_order, mesh=None)
    if ek1:
        m0_p, ps_t, ys, table, consts = ek1_kernel_inputs(
            prob_f, u0s, ps, tspan, n_steps, ts_data, ys, r_std, q,
            obs_matrix=C_np, schedule=schedule)
        jac = jac if jac is not None else auto_jac(prob_f)
        return e1d.EK1DataLik.apply(m0_p, ps_t, ys, prob_f, jac, field, table,
                                    consts, not calib_grad,
                                    _wants_grad(m0_p, ps_t, ys))
    if iso:
        m0_p, ps_t, ys, table, consts = kernel_inputs(
            prob_f, u0s, ps, tspan, n_steps, ts_data, ys, float(r_std), q,
            schedule)
    else:
        m0_p, ps_t, ys, table, consts = pd_kernel_inputs(
            prob_f, u0s, ps, tspan, n_steps, ts_data, ys, r_std, q,
            obs_matrix=C_np, schedule=schedule)
    want_grad = _wants_grad(m0_p, ps_t, ys)
    if iso:
        return EK0DataLik.apply(m0_p, ps_t, ys, prob_f, field, table, consts,
                                not calib_grad, want_grad)
    jd = None
    if diagonal_ek1:
        jd = jac_diag if jac_diag is not None else auto_jac_diag(prob_f)
    return edp.EK0DataLikPD.apply(m0_p, ps_t, ys, prob_f, jd, field, table,
                                  consts, not calib_grad, want_grad)
