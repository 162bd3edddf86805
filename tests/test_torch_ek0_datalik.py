"""The PyTorch port's fused EK0 data likelihood against the JAX package, on
the CPU in f64: the host-side grid and schedule, the data update, the step
of another length and the stop-calibration step with their VJPs, the whole
walk over a schedule with a time-dependent field, and the front door
``ensemble_data_loglik`` against ``ensemble_data_loglik_pallas`` in
interpret mode, on and off the grid, with ``calib_grad`` both ways.

Inputs are made with numpy from a seed and fed to both packages. The front
door's ODE log-likelihood is a sum of per-step terms that cancel near 0 for
some members, and its gradients through the calibration carry the
innovations at the solver's accuracy floor: each is held at its tolerance
against the ensemble's scale (the largest |value| over the members), as
the card's adjoint checks hold them (chip_smoke.py); the data
log-likelihood and the observations' gradient entry by entry."""

import functools
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import odefilters as odf
import odefilters_torch as odt
from odefilters import datalik as jdl
from odefilters.ops import pallas_kernels as pk
from odefilters_torch import convert
from odefilters_torch import datalik as tdl
from odefilters_torch.ops import _build, _launch
from odefilters_torch.ops import ek0_datalik as ed
from odefilters_torch.ops import ek0_pair as ep

Q, NQ, D, BX = 3, 4, 2, 1
B_JAX = 1024           # the JAX kernels' smallest ensemble (one block)
TRIU, V = ed.datalik_layout(NQ, D)
REPO = Path(__file__).resolve().parents[1]

# (tspan, n_grid, ts_data)
GRIDS = {
    "on_grid": ((0.0, 3.0), 40, np.array([8, 20, 32]) * 3.0 / 40),
    "off_grid": ((0.0, 1.0), 10, np.array([0.137, 0.33, 0.55, 0.777])),
    "endpoints": ((0.0, 3.0), 12, np.array([0.25, 1.3, 3.0])),
    "near_ulp": ((0.0, 1.0), 10, np.array([0.1 + 1e-9, 0.5, 0.7 - 3e-15])),
    "shifted": ((0.3, 3.3), 40, np.array([0.31, 1.0, 2.7, 3.3])),
}
DTYPES = {"f32": (jnp.float32, torch.float32), "f64": (jnp.float64, torch.float64)}


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _sched(grid, dtype):
    """Both packages' merged grid and schedule of a `GRIDS` case."""
    tspan, n, ts = GRIDS[grid]
    jd, td = DTYPES[dtype]
    ref = jdl._merged_grid(SimpleNamespace(tspan=tspan), ts, n, jd)
    got = tdl._merged_grid(SimpleNamespace(tspan=tspan), ts, n, td)
    t0, t1 = tspan
    dt = (t1 - t0) / n
    tol = max(dt * 1e-6, 64.0 * (t1 - t0) * float(np.finfo(np.dtype(jd)).eps))
    args = (dt, t0, tol)
    s_ref = pk._build_offgrid_sched(np.asarray(ref[0], np.float64),
                                    np.asarray(ref[1]), *args)
    s_got = ed._build_offgrid_sched(got[0].astype(np.float64), got[1], *args)
    return ref, got, s_ref, s_got, dt, t0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("grid", GRIDS)
def test_merged_grid_and_schedule_match_jax(grid, dtype):
    ref, got, s_ref, s_got, dt, _ = _sched(grid, dtype)
    assert got[0].dtype == np.dtype(DTYPES[dtype][0])
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert s_got == s_ref
    assert ed._sched_total_steps(s_got) == pk._sched_total_steps(s_ref)
    odd_ref = pk._sched_odd_consts(s_ref, Q, dt, None, np.float64)
    odd_got = ed._sched_odd_consts(s_got, Q, dt)
    assert list(odd_got) == list(odd_ref)
    for key in odd_ref:
        r, g = odd_ref[key], odd_got[key]
        np.testing.assert_array_equal(g[0], r[0])
        np.testing.assert_array_equal(g[1], r[1])
        assert g[2:] == r[2:]
    seg = (3, 0, 7, 2)
    assert ed._seg_offsets(seg) == pk._seg_offsets(seg)


@pytest.mark.parametrize("dtype", DTYPES)
def test_merged_grid_rejects_what_jax_rejects(dtype):
    jd, td = DTYPES[dtype]
    prob = SimpleNamespace(tspan=(0.0, 3.0))
    bad = [np.array([0.5, 1.0, 1.0 + 1e-8]),   # closer than 64 ULP in f32
           np.array([0.5, 0.4]), np.array([-0.1, 1.0]), np.array([1.0, 3.5])]
    for ts in bad:
        try:
            jdl._merged_grid(prob, ts, 10, jd)
        except ValueError as e:
            with pytest.raises(ValueError, match=re.escape(str(e)[:20])):
                tdl._merged_grid(prob, ts, 10, td)
        else:
            tdl._merged_grid(prob, ts, 10, td)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("grid", ["off_grid", "shifted", "endpoints"])
def test_step_table_times_follow_the_jax_kernels(grid, dtype):
    """A base-lattice run step at lattice index k has the time t0 + dt (k+1)
    in the dtype (`_step_time`), every other step the merged grid's time
    cast to the dtype, even where its length is the base one."""
    _, _, s_ref, s_got, dt, t0 = _sched(grid, dtype)
    jd, td = DTYPES[dtype]
    table = ed.step_table(t0, dt, Q, td, "cpu", sched=s_got)
    want = np.empty(table.n_steps, np.dtype(jd))
    for it in s_ref:
        if it[0] == "run":
            _, k0, k1, off = it
            for k in range(k0, k1):
                want[k + off] = pk._step_time(jnp.int32(k), t0, dt, jd)
        else:
            want[it[1]] = jnp.asarray(it[2], jd)
    np.testing.assert_array_equal(_np(table.times), want)
    rows = [it[4] for it in s_ref if it[0] == "one" and it[4] >= 0]
    assert [r for r in table.rows if r >= 0] == rows == list(range(len(rows)))


def _forced_fhn_jax(u, p, t):
    return odf.models.fitzhugh_nagumo().f(u, p, t) + jnp.stack(
        [0.3 * jnp.sin(2.0 * t) + 0.0 * u[0], 0.0 * u[1]])


def _forced_fhn_torch(u, p, t):
    return odt.models.library.fitzhugh_nagumo_f(u, p, t) + torch.stack(
        [0.3 * torch.sin(2.0 * t) + 0.0 * u[0], 0.0 * u[1]])


@pytest.mark.parametrize("grid", ["off_grid", "shifted"])
def test_plain_walk_with_time_dependent_field_matches_jax_bodies(grid):
    """The plain primal over a schedule against the JAX kernel's body run
    eagerly over the same schedule (its steps, odd steps and data updates
    at its step times), with a time-dependent field so that every step
    time counts."""
    tspan, n, ts = GRIDS[grid]
    _, _, s_ref, s_got, dt, t0 = _sched(grid, "f64")
    rng = np.random.default_rng(4)
    B = 16
    p = np.array([0.7, 0.8, 1 / 12.5, 0.5])[:, None] * (
        1 + 0.05 * rng.standard_normal((4, B)))
    m0 = rng.standard_normal((NQ, D, B)) * np.array([1e-2, 1e-3, 1e-4, 1e-5])[
        :, None, None]
    ys = 0.5 + 0.1 * rng.standard_normal((len(ts), D))
    At, Qt, _, pp = ep.pair_constants(Q, dt)
    kw = dict(At=At, Qt=Qt, pinv0=float(1 / pp[0]), pinv1=float(1 / pp[1]),
              d=D, nq=NQ)
    r2 = 0.1 ** 2
    odd = pk._sched_odd_consts(s_ref, Q, dt, None, np.float64)
    m = [[jnp.asarray(m0[i, j]) for j in range(D)] for i in range(NQ)]
    zero = jnp.zeros(B)
    C = [[zero] * NQ for _ in range(NQ)]
    ll = dll = zero
    pj = jnp.asarray(p)

    def one_step(m, C, t, dtp):
        if dtp == dt:
            out = pk._ek0_step_lists(m, C, pj, t, f=_forced_fhn_jax,
                                     collapsed=True, **kw)
            return out[:3]
        return pk._odd_step_lists(m, C, pj, t, odd[dtp], f=_forced_fhn_jax,
                                  d=D, nq=NQ, so=False, stop_calib=False)

    for it in s_ref:
        if it[0] == "run":
            for k in range(it[1], it[2]):
                m, C, inc = one_step(m, C, pk._step_time(jnp.int32(k), t0, dt,
                                                         jnp.float64), dt)
                ll = ll + inc
        else:
            _, _, t_b, dtp, si = it
            m, C, inc = one_step(m, C, zero + jnp.asarray(t_b), dtp)
            ll = ll + inc
            if si >= 0:
                m, C, inc = pk._ek0_data_update_lists(
                    m, C, [ys[si, j] for j in range(D)], zero + 1.0,
                    pinv0=kw["pinv0"], r2=r2, d=D, nq=NQ)
                dll = dll + inc
    table = ed.step_table(t0, dt, Q, torch.float64, "cpu", sched=s_got)
    got = ed.ek0_datalik_plain(
        _forced_fhn_torch, torch.from_numpy(m0), torch.from_numpy(p),
        torch.from_numpy(ys), table, At=At, Qt=Qt, pinv0=kw["pinv0"],
        pinv1=kw["pinv1"], r2=r2)
    np.testing.assert_allclose(_np(got[0]), _np(dll), rtol=1e-12)
    np.testing.assert_allclose(_np(got[1]), _np(ll), rtol=1e-12)
    # the forcing matters: a time shift of one step changes the result
    shifted = ed.StepTable(table.times + dt, table.codes, table.odd,
                           table.odd_flat, table.sets, table.rows)
    moved = ed.ek0_datalik_plain(
        _forced_fhn_torch, torch.from_numpy(m0), torch.from_numpy(p),
        torch.from_numpy(ys), shifted, At=At, Qt=Qt, pinv0=kw["pinv0"],
        pinv1=kw["pinv1"], r2=r2)
    assert not np.allclose(_np(moved[1]), _np(ll), rtol=1e-6)


def _state(seed, n=32, dt=0.1):
    """Random lanes of a committed state: m on the preconditioned scales,
    C symmetric PSD with row/column BX exactly zero, perturbed FHN p."""
    rng = np.random.default_rng(seed)
    At, Qt, _, p = ep.pair_constants(Q, dt)
    pp = np.array([0.7, 0.8, 1 / 12.5, 0.5])[:, None] * (
        1 + 0.05 * rng.standard_normal((4, n)))
    m = rng.standard_normal((NQ, D, n)) * np.array([1e-1, 1e-2, 1e-3, 1e-4])[
        :, None, None]
    act = [a for a in range(NQ) if a != BX]
    A = rng.standard_normal((len(act), len(act), n))
    S = np.einsum("ikn,jkn->ijn", A, A) * 1e-3
    C = np.zeros((NQ, NQ, n))
    for ii, i in enumerate(act):
        for jj, j in enumerate(act):
            C[i, j] = S[ii, jj]
    consts = dict(At=At, Qt=Qt, pinv0=float(1 / p[0]), pinv1=float(1 / p[1]))
    return rng, consts, pp, m, C


def _full_jax(C_tri):
    """The JAX full covariance list from triangle entries (mirror aliased,
    BX zero)."""
    z = jnp.zeros_like(C_tri[0])
    C = [[z] * NQ for _ in range(NQ)]
    for (i, l), c in zip(TRIU, C_tri):
        C[i][l] = c
        C[l][i] = c
    return C


def _full_torch(C_tri):
    C = [[0.0] * NQ for _ in range(NQ)]
    for (i, l), c in zip(TRIU, C_tri):
        C[i][l] = c
        C[l][i] = c
    return C


def _tri(C):
    return [C[i][l] for (i, l) in TRIU]


def _assert_lists_close(got, ref, rtol):
    for g, r in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(ref)):
        np.testing.assert_allclose(_np(g), _np(r), rtol=rtol, atol=0)


def test_data_update_and_its_vjp_match_jax():
    """`ek0_data_update` == `_ek0_data_update_lists` (mask 1) in value and
    VJP, on the triangle representation (a function of the triangle whose
    mirror entries are one value in both packages)."""
    rng, consts, _, m, C = _state(1)
    n = m.shape[-1]
    y = 0.3 * rng.standard_normal((D, n))
    C_tri = [C[i, l] for (i, l) in TRIU]
    r2 = 0.05 ** 2

    def jfun(m, C_tri, y):
        mn, Cn, inc = pk._ek0_data_update_lists(
            m, _full_jax(C_tri), y, 1.0, pinv0=consts["pinv0"], r2=r2, d=D,
            nq=NQ)
        return mn, _tri(Cn), inc

    def tfun(m, C_tri, y):
        mn, Cn, inc = ed.ek0_data_update(
            m, _full_torch(C_tri), y, pinv0=consts["pinv0"], r2=r2, d=D,
            nq=NQ)
        return mn, _tri(Cn), inc

    jin = ([[jnp.asarray(m[i, j]) for j in range(D)] for i in range(NQ)],
           [jnp.asarray(c) for c in C_tri], [jnp.asarray(v) for v in y])
    tin = ([[torch.from_numpy(m[i, j]) for j in range(D)] for i in range(NQ)],
           [torch.from_numpy(c) for c in C_tri], [torch.from_numpy(v) for v in y])
    jout, jvjp = jax.vjp(jfun, *jin)
    tout, tvjp = torch.func.vjp(tfun, *tin)
    _assert_lists_close(tout, jout, 1e-12)
    ct = (rng.standard_normal((NQ, D, n)), rng.standard_normal((len(TRIU), n)),
          rng.standard_normal(n))
    jct = ([[jnp.asarray(ct[0][i, j]) for j in range(D)] for i in range(NQ)],
           [jnp.asarray(c) for c in ct[1]], jnp.asarray(ct[2]))
    tct = ([[torch.from_numpy(ct[0][i, j]) for j in range(D)] for i in range(NQ)],
           [torch.from_numpy(c) for c in ct[1]], torch.from_numpy(ct[2]))
    _assert_lists_close(tvjp(tct), jvjp(jct), 1e-12)
    # the measured row and column stay exactly zero, block BX of the mean
    # unchanged
    mn, Cn, _ = ed.ek0_data_update(tin[0], _full_torch(tin[1]), tin[2],
                                   pinv0=consts["pinv0"], r2=r2, d=D, nq=NQ)
    assert all(isinstance(Cn[BX][l], float) and Cn[BX][l] == 0.0
               for l in range(NQ))
    assert all(mn[BX][j] is tin[0][BX][j] for j in range(D))


@pytest.mark.parametrize("stop_calib", [False, True])
@pytest.mark.parametrize("kind", ["base", "odd"])
def test_step_and_its_vjp_match_jax(kind, stop_calib):
    """The base step (`_ek0_step_lists(collapsed=True)`) and the step of
    another length (`_odd_step_lists`), with and without ``stop_calib``:
    values to rtol 1e-12 and the VJP of ``(m_new, C_new, ll_inc)``; the
    flag leaves the values alone and changes the VJP."""
    dt, dtp = 0.1, 0.0637
    rng, consts, pp, m, C = _state(2, dt=dt)
    n = m.shape[-1]
    t = 0.37
    jf, tf = odf.models.fitzhugh_nagumo().f, odt.models.library.fitzhugh_nagumo_f
    sched = (("one", 0, t, dtp, -1),)
    odd_j = pk._sched_odd_consts(sched, Q, dt, None, np.float64)[dtp]
    odd_t = ed._sched_odd_consts(sched, Q, dt)[dtp]
    kw = dict(consts, d=D, nq=NQ)

    def jfun(m, C_tri, p, stop=stop_calib):
        if kind == "base":
            mn, Cn, inc, _, _ = pk._ek0_step_lists(
                m, _full_jax(C_tri), p, jnp.float64(t), f=jf, collapsed=True,
                stop_calib=stop, **kw)
        else:
            mn, Cn, inc = pk._odd_step_lists(
                m, _full_jax(C_tri), p, jnp.float64(t), odd_j, f=jf, d=D,
                nq=NQ, so=False, stop_calib=stop)
        return mn, _tri(Cn), inc

    def tfun(m, C_tri, p, stop=stop_calib):
        tt = torch.tensor(t, dtype=torch.float64)
        if kind == "base":
            mn, Cn, inc = ed._base_step(
                m, _full_torch(C_tri), p, tt, f=tf, base=ed._base(
                    consts["At"], consts["Qt"], consts["pinv0"],
                    consts["pinv1"]), d=D, nq=NQ, stop_calib=stop)
        else:
            mn, Cn, inc = ed.ek0_odd_step(m, _full_torch(C_tri), p, tt, odd_t,
                                          f=tf, d=D, nq=NQ, stop_calib=stop)
        return mn, _tri(Cn), inc

    C_tri = [C[i, l] for (i, l) in TRIU]
    jin = ([[jnp.asarray(m[i, j]) for j in range(D)] for i in range(NQ)],
           [jnp.asarray(c) for c in C_tri], jnp.asarray(pp))
    tin = ([[torch.from_numpy(m[i, j]) for j in range(D)] for i in range(NQ)],
           [torch.from_numpy(c) for c in C_tri], torch.from_numpy(pp))
    jout, jvjp = jax.vjp(jfun, *jin)
    tout, tvjp = torch.func.vjp(tfun, *tin)
    _assert_lists_close(tout, jout, 1e-12)
    ct = (rng.standard_normal((NQ, D, n)), rng.standard_normal((len(TRIU), n)),
          rng.standard_normal(n))
    jct = ([[jnp.asarray(ct[0][i, j]) for j in range(D)] for i in range(NQ)],
           [jnp.asarray(c) for c in ct[1]], jnp.asarray(ct[2]))
    tct = ([[torch.from_numpy(ct[0][i, j]) for j in range(D)] for i in range(NQ)],
           [torch.from_numpy(c) for c in ct[1]], torch.from_numpy(ct[2]))
    got = tvjp(tct)
    _assert_lists_close(got, jvjp(jct), 1e-10)
    other_out, other_vjp = torch.func.vjp(
        functools.partial(tfun, stop=not stop_calib), *tin)
    for a, b in zip(jax.tree_util.tree_leaves(other_out),
                    jax.tree_util.tree_leaves(tout)):
        assert torch.equal(a, b)
    assert not np.allclose(_np(other_vjp(tct)[2]), _np(got[2]), rtol=1e-6)


def test_lotka_volterra_field_and_jacobian_match_jax():
    ref = odf.models.lotka_volterra()
    prob = odt.models.lotka_volterra(device="cpu")
    assert prob.field == "lv" and prob.tspan == ref.tspan
    np.testing.assert_array_equal(_np(prob.u0), np.asarray(ref.u0))
    np.testing.assert_array_equal(_np(prob.p), np.asarray(ref.p))
    rng = np.random.default_rng(5)
    u = rng.uniform(0.2, 3.0, (D, 64))
    p = np.asarray(ref.p)[:, None] * rng.uniform(0.8, 1.2, (4, 64))
    for a, b in ((prob.f, ref.f), (prob.jac, ref.jac)):
        np.testing.assert_allclose(
            _np(a(torch.from_numpy(u), torch.from_numpy(p), 0.0)),
            np.asarray(b(jnp.asarray(u), jnp.asarray(p), 0.0)), rtol=1e-15)
    got = convert.problem_from_numpy("lotka_volterra", np.asarray(ref.u0),
                                     np.asarray(ref.p), (0.0, 3.0),
                                     device="cpu")
    assert got.field == "lv" and got.tspan == (0.0, 3.0)


# -- the front door against the Pallas kernels in interpret mode -----------


def _front_inputs(case):
    """(JAX problem, port problem, T, ts_data, u0s, ps, ys) of a case:
    on_grid is the JAX package's LV gradient test's setting
    (tests/test_pallas_and_extras.py), off_grid its FHN off-grid one's, at
    q = 3; both with parameters scaled per member by U(0.8, 1.2)."""
    rng = np.random.default_rng(3)
    if case == "on_grid":
        jprob = odf.models.lotka_volterra(tspan=(0.0, 3.0))
        tprob = odt.models.lotka_volterra(tspan=(0.0, 3.0), device="cpu")
        u0s = np.asarray(jprob.u0) * (1 + 0.05 * rng.standard_normal((B_JAX, D)))
        ys = np.abs(rng.normal(1.5, 0.5, (3, D)))
    else:
        jprob = odf.models.fitzhugh_nagumo(tspan=(0.0, 1.0))
        tprob = odt.models.fitzhugh_nagumo(tspan=(0.0, 1.0), device="cpu")
        u0s = np.asarray(jprob.u0) + 0.05 * rng.standard_normal((B_JAX, D))
        ys = 0.5 + 0.1 * rng.standard_normal((4, D))
    ps = np.asarray(jprob.p) * rng.uniform(0.8, 1.2, (B_JAX, 4))
    _, T, ts = GRIDS[case]
    return jprob, tprob, T, ts, u0s, ps, ys


def _loss(dll, ll):
    return dll.sum() + 0.5 * ll.sum()


@functools.cache
def _jax_reference(case, calib_grad):
    """``(dll, ll, d/du0s, d/dps, d/dys)`` of the JAX front door in
    interpret mode: one compile of the kernel pair per (case, calib_grad),
    shared by the tests of this module."""
    from jax.experimental.pallas import tpu as pltpu

    jprob, _, T, ts, u0s, ps, ys = _front_inputs(case)

    def loss(u, p, y):
        dll, ll = pk.ensemble_data_loglik_pallas(
            jprob.f, u, p, jprob.tspan, T, ts, y, 0.1, q=Q,
            calib_grad=calib_grad)
        return _loss(dll, ll), (dll, ll)

    with pltpu.force_tpu_interpret_mode():
        (_, (dll, ll)), grads = jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True)(
                jnp.asarray(u0s), jnp.asarray(ps), jnp.asarray(ys))
    return tuple(np.asarray(x) for x in (dll, ll) + tuple(grads))


@functools.cache
def _port(case, calib_grad):
    """The port's primal (no gradient), its gradient run's values and its
    gradients, on the CPU."""
    _, tprob, T, ts, u0s, ps, ys = _front_inputs(case)
    kw = dict(q=Q, field=tprob.field, calib_grad=calib_grad)
    with torch.no_grad():
        primal = odt.ensemble_data_loglik(
            tprob.f, torch.from_numpy(u0s), torch.from_numpy(ps), tprob.tspan,
            T, ts, torch.from_numpy(ys), 0.1, **kw)
    args = [torch.from_numpy(x).requires_grad_() for x in (u0s, ps, ys)]
    dll, ll = odt.ensemble_data_loglik(tprob.f, args[0], args[1], tprob.tspan,
                                       T, ts, args[2], 0.1, **kw)
    grads = torch.autograd.grad(_loss(dll, ll), args)
    return primal, (dll.detach(), ll.detach()), grads


@pytest.fixture(scope="module")
def jax_reference():
    return _jax_reference


# The off-grid stop-calibration case compiles its own interpret-mode pair
# (~15 s on one CPU core) and runs outside tier 1 (``-m slow``); tier 1
# holds stop_calib through the odd steps at the step level
# (test_step_and_its_vjp_match_jax) and on the grid at the front door.
FRONT = [("on_grid", True), ("on_grid", False), ("off_grid", True),
         pytest.param("off_grid", False, marks=pytest.mark.slow)]


def _close_to_scale(got, ref, rtol, atol):
    """|got - ref| <= atol + rtol max |ref| over the members (axis 0)."""
    got, ref = _np(got), np.asarray(ref)
    scale = np.abs(ref).max(axis=0, keepdims=True)
    bad = np.abs(got - ref) > atol + rtol * scale
    assert not bad.any(), (f"{int(bad.sum())} entries off; largest |diff| / "
                           f"scale {float((np.abs(got - ref) / scale).max()):.3e}")


@pytest.mark.parametrize("case,calib_grad", FRONT)
def test_front_door_values_match_jax(case, calib_grad, jax_reference):
    """dll and ll of the primal kernel's path (no gradient) and of the
    gradient's forward against the JAX kernels: dll to rtol 1e-10, ll to
    1e-10 of the ensemble's scale; the two paths equal bit for bit."""
    ref = jax_reference(case, calib_grad)
    primal, fwd, _ = _port(case, calib_grad)
    np.testing.assert_allclose(_np(primal[0]), ref[0], rtol=1e-10)
    _close_to_scale(primal[1], ref[1], 1e-10, 0.0)
    assert torch.equal(primal[0], fwd[0]) and torch.equal(primal[1], fwd[1])


@pytest.mark.parametrize("case,calib_grad", FRONT)
def test_front_door_gradients_match_jax(case, calib_grad, jax_reference):
    """Gradients of ``sum(dll) + 0.5 sum(ll)`` in u0s, ps (rtol 1e-8 of
    each column's scale over the members, atol 1e-10) and ys (entry by
    entry)."""
    ref = jax_reference(case, calib_grad)
    _, _, (gu, gp, gy) = _port(case, calib_grad)
    _close_to_scale(gu, ref[2], 1e-8, 1e-10)
    _close_to_scale(gp, ref[3], 1e-8, 1e-10)
    np.testing.assert_allclose(_np(gy), ref[4], rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("case", ["on_grid", "off_grid"])
def test_calib_grad_false_changes_only_the_gradient(case, jax_reference):
    """As tests/test_datalik.py holds the JAX package: the values are
    identical and the gradient differs (the JAX kernels too, on the
    grid)."""
    full, stop = _port(case, True), _port(case, False)
    for a, b in zip(full[0] + full[1], stop[0] + stop[1]):
        assert torch.equal(a, b)
    assert not np.allclose(_np(full[2][1]), _np(stop[2][1]), rtol=1e-6)
    if case == "on_grid":
        j_full, j_stop = jax_reference(case, True), jax_reference(case, False)
        np.testing.assert_array_equal(j_full[0], j_stop[0])
        assert not np.allclose(j_full[3], j_stop[3], rtol=1e-6)


# -- what the front door refuses, and the port's plumbing ------------------


def _door_args(**over):
    prob = odt.models.lotka_volterra(tspan=(0.0, 3.0), device="cpu")
    rng = np.random.default_rng(0)
    args = dict(prob_f=prob.f, u0s=torch.ones(4, D, dtype=torch.float64),
                ps=prob.p[None].expand(4, 4).contiguous(), tspan=prob.tspan,
                n_steps=30, ts_data=np.array([0.5, 1.5]),
                ys=torch.from_numpy(rng.standard_normal((2, D))),
                obs_noise_std=0.1)
    args.update(over)
    return args


# The per-dimension path (obs_matrix, a noise vector, per-member ys,
# DiagonalEK1) runs on the grid only, as in the JAX package: off the grid
# it raises.
OFF = np.array([0.55, 1.5])


@pytest.mark.parametrize("over,item", [
    (dict(obs_matrix=np.eye(D), ts_data=OFF), "off-grid"),
    (dict(obs_noise_std=np.array([0.1, 0.2]), ts_data=OFF), "off-grid"),
    (dict(ys=torch.zeros(4, 2, D, dtype=torch.float64), ts_data=OFF),
     "off-grid"),
    (dict(diagonal_ek1=True, ts_data=OFF), "off-grid"),
    (dict(ek1=True, ts_data=OFF), "off-grid"),
    (dict(second_order=True, u0s=torch.ones(4, 2 * D, dtype=torch.float64)),
     "item 5"),
    (dict(prior="ioup"), "item 5"),
    (dict(mesh=object()), "one card"),
], ids=["obs_matrix", "vector_noise", "per_member_ys", "diagonal_ek1", "ek1",
        "second_order", "prior", "mesh"])
def test_unported_branches_raise(over, item):
    with pytest.raises(NotImplementedError, match=item):
        odt.ensemble_data_loglik(**_door_args(**over))


@pytest.mark.parametrize("over,match", [
    (dict(ts_data=np.array([0.0, 1.5])), r"\(t0, t1\]"),
    (dict(ts_data=np.array([1.5, 1.5])), "strictly increasing"),
    (dict(ts_data=np.array([1.5, 0.5])), "strictly increasing"),
    (dict(ts_data=np.array([0.51, 3.5])), "within prob.tspan"),
    (dict(ys=torch.zeros(3, D, dtype=torch.float64)), "ys must have shape"),
    (dict(obs_noise_std=np.ones((2, 2))), "obs_noise_std"),
    (dict(obs_matrix=np.ones((2, 3))), "obs_matrix"),
    (dict(ek1=True, diagonal_ek1=True), "not both"),
], ids=["at_t0", "duplicate", "decreasing", "off_grid_outside", "ys_shape",
        "noise_shape", "obs_matrix_shape", "ek1_and_diagonal"])
def test_bad_inputs_raise_value_errors_as_in_jax(over, match):
    with pytest.raises(ValueError, match=match):
        odt.ensemble_data_loglik(**_door_args(**over))
    jargs = {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
             for k, v in _door_args(**over).items()}
    jargs["prob_f"] = odf.models.lotka_volterra().f
    with pytest.raises(ValueError):
        pk.ensemble_data_loglik_pallas(**jargs)


def test_cpu_wrappers_run_the_plain_versions_and_other_devices_raise():
    _, tprob, T, ts, u0s, ps, ys = _front_inputs("off_grid")
    B = 8
    At, Qt, _, p = ep.pair_constants(Q, 0.1)
    consts = dict(At=At, Qt=Qt, pinv0=float(1 / p[0]), pinv1=float(1 / p[1]),
                  r2=0.01)
    _, _, _, s_got, dt, t0 = _sched("off_grid", "f64")
    table = ed.step_table(t0, dt, Q, torch.float64, "cpu", sched=s_got)
    assert table.odd_flat.shape == (len(table.odd), ed.odd_width(NQ))
    rng = np.random.default_rng(6)
    m0 = torch.from_numpy(rng.standard_normal((NQ, D, B)) * 1e-2)
    pt = torch.from_numpy(ps[:B].T.copy())
    yt = torch.from_numpy(ys)
    got = ed.ek0_datalik(tprob.f, "fhn", m0, pt, yt, table, **consts)
    want = ed.ek0_datalik_plain(tprob.f, m0, pt, yt, table, **consts)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    dll, ll, st = ed.ek0_datalik_grad_fwd(tprob.f, "fhn", m0, pt, yt, table,
                                          **consts)
    assert st.shape == (table.n_steps, V, B) and V == 14
    assert torch.equal(dll, want[0]) and torch.equal(ll, want[1])
    cts = [torch.from_numpy(rng.standard_normal(B)) for _ in range(2)]
    dm0, dps, dys = ed.ek0_datalik_grad_bwd(tprob.f, "fhn", st, pt, yt, *cts,
                                            table, nq=NQ, **consts)
    part = ed.ek0_datalik_grad_bwd_plain(tprob.f, st, pt, yt, *cts, table,
                                         nq=NQ, **consts)
    assert torch.equal(dm0, part[0]) and torch.equal(dps, part[1])
    assert torch.equal(dys, torch.sum(part[2], dim=-1))
    before = (ed.ek0_datalik.launches, ed.ek0_datalik_grad_fwd.launches,
              ed.ek0_datalik_grad_bwd.launches)
    meta = [x.to("meta") for x in (m0, pt, yt, st)]
    with pytest.raises(ValueError, match="meta"):
        ed.ek0_datalik(tprob.f, "fhn", *meta[:3], table, **consts)
    with pytest.raises(ValueError, match="meta"):
        ed.ek0_datalik_grad_fwd(tprob.f, "fhn", *meta[:3], table, **consts)
    with pytest.raises(ValueError, match="meta"):
        ed.ek0_datalik_grad_bwd(tprob.f, "fhn", meta[3], meta[1], meta[2],
                                *[c.to("meta") for c in cts], table, nq=NQ,
                                **consts)
    assert before == (ed.ek0_datalik.launches, ed.ek0_datalik_grad_fwd.launches,
                      ed.ek0_datalik_grad_bwd.launches)


def test_every_field_entry_point_exists_for_both_fields():
    """LV joins FHN in every kernel family: each entry of the library that
    evaluates the field is defined for both fields and both dtypes."""
    assert set(_launch.CUDA_FIELDS) == {"fhn", "lv"}
    assert _launch.CUDA_JAC_FIELDS == _launch.CUDA_JAC_DIAG_FIELDS == {"fhn", "lv"}
    src = "".join((_build.CSRC / s).read_text().split('extern "C" {', 1)[1]
                  for s in _build.SOURCES)
    defined = set(re.findall(r"^int (\w+)\(", src, flags=re.M))
    # the entries a macro defines once per (field, dtype)
    for macro, body in re.findall(
            r"^#define (\w+)\(NAME, FIELD, S, SUF\)(.*?)\n\n", src,
            flags=re.M | re.S):
        stems = re.findall(r"int (\w+)_##NAME##_##SUF\(", body)
        assert stems, macro
        for name, _, _, suf in re.findall(
                rf"^{macro}\((\w+), (\w+), (\w+), (\w+)\)", src, flags=re.M):
            defined |= {f"{stem}_{name}_{suf}" for stem in stems}
    assert set(_build.ENTRIES) == defined
    for name in _build.FIELD_ENTRIES:
        for field in _launch.CUDA_FIELDS:
            for suf in ("f32", "f64"):
                assert f"{name}_{field}_{suf}" in _build.ENTRIES
    assert "struct LotkaVolterra" in (_build.CSRC / "fields.cuh").read_text()


def test_new_modules_import_no_jax():
    code = (
        "import sys, odefilters_torch.datalik, odefilters_torch.ops.ek0_datalik; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'odefilters' or m.startswith('odefilters.')]; "
        "assert not bad, bad"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_sequential_datalik_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="item 8"):
        tdl.filter_with_data()
    with pytest.raises(NotImplementedError, match="item 8"):
        tdl.data_loglik()
