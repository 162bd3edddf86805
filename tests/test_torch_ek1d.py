"""The PyTorch port's DiagonalEK1 ensemble solves against the JAX package, on
the CPU in f64: the Jacobian diagonal's three sources, the per-dimension
step, the fixed-grid filter in each diffusion mode against the Pallas
kernel in interpret mode (FitzHugh-Nagumo, 1024 members, 60 steps at
dt = 0.04), its exactness on a decoupled linear field, the adaptive filter
and the streamed filter + RTS smoother pair against the Pallas kernels in
interpret mode (over (0, 2), 8 save intervals, q = 3, abstol 1e-8, reltol
1e-6, the setting of the JAX package's own tests), the float32 pair
against DOP853, and the front door. Inputs are made with numpy from a seed
and fed to both packages.

The adaptive comparisons are statistical, for the reasons of
``tests/test_torch_ek0_adaptive.py``: one rounding step anywhere turns
into another accepted-step sequence on about one member in a hundred,
XLA's CPU code rounds differently from the port's plain versions, and the
port carries each dimension's covariance as a factor where the JAX kernels
carry it plain. They hold ``failed`` on every member; ``nacc`` and
``nrej`` on all but 5% of the members; the lls on the members whose counts
agree at the 99th percentile to 1e-3 relative and everywhere to 1e-2; and
every member's means to 1e-5 absolute where the JAX result is finite (the
members it returns non-finite are counted and excluded), as that file
does. The means and stds of the members whose counts agree are held at
each package's own sensitivity to one rounding step of its inputs, which
is larger here than for EK0: moving every initial step by one rounding
step moves the JAX filter's means by up to 7.5e-9 relative and its
filtered stds by up to 0.37 relative (99th percentile 1.3e-3), the port's
by 8.6e-9 and 0.41 (1.3e-3) (`test_adaptive_stds_are_rounding_sensitive`).
The stds sit at the accuracy floor: each step's dynamic diffusion is a
squared innovation there, the differences grow along the save grid, and
the JAX kernel itself misses its own sequential solver
(``odefilters.solve``) by up to 1.4 relative on a member's filtered std.
So the means are held to rtol 2e-8 / atol 1e-11
and the stds at the 99th percentile to 1e-2 relative and everywhere to
1 (measured against the JAX kernels: 1.5e-8; 3.6e-3 and 0.60).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import odefilters as odf
import odefilters_torch as odt
from odefilters.ensemble import _diag_from_full
from odefilters.ops import pallas_kernels as pk
from odefilters_torch.ops import ek0_adaptive as ea
from odefilters_torch.ops import ek1d
from odefilters_torch.ops import ek1d_adaptive as eda

Q, NQ, D = 3, 4, 2
B_JAX = 1024           # the JAX kernels' smallest ensemble (one block)
STATIC = ("fixed", "fixedMAP", "fixedMV")
MODES = ("dynamic",) + STATIC
# the fixed grid: the card's check shape (60 steps at the headline dt)
T_FIX, DT_FIX = 60, 0.04
TSPAN_FIX = (0.0, T_FIX * DT_FIX)
# the adaptive setting of the JAX package's own tests
TSPAN = (0.0, 2.0)
S = 8
TOL = dict(abstol=1e-8, reltol=1e-6)
MAX_ITERS_PAIR = 256


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def fhn_jac_diag(u, p, t):
    """The FHN Jacobian diagonal in the op order of `fitzhugh_nagumo_jac`
    (and of ``Fhn::jac_diag`` in ``fields.cuh``)."""
    a, b, tinv, izero = p
    v = u[0]
    return torch.stack([1 - v * v, -tinv * b * torch.ones_like(v)])


def _ensemble(tspan, seed=0, scale=0.05):
    jprob = odf.models.fitzhugh_nagumo(tspan=tspan)
    rng = np.random.default_rng(seed)
    u0s = np.asarray(jprob.u0)[None] + scale * rng.standard_normal((B_JAX, D))
    ps = np.broadcast_to(np.asarray(jprob.p), (B_JAX, 4)).copy()
    return jprob, u0s, ps


def _jax_taylor(jprob, u0s, ps, t0):
    from odefilters.taylor import taylor_coefficients

    m0 = jax.vmap(
        lambda u, p: jnp.stack(taylor_coefficients(jprob.f, u, p, t0, Q))
    )(jnp.asarray(u0s), jnp.asarray(ps))
    return np.asarray(m0.transpose(1, 2, 0))


def _jax_jac_diag(jprob):
    return _diag_from_full(jprob.jac, D)


# ------------------------------------------------------------ Jacobian


def test_jac_diag_sources_agree():
    """``prob.jac_diag``, the diagonal of ``prob.jac`` and d JVP columns
    (`auto_jac_diag`) give one diagonal to 1e-12, and the JAX package's
    in-kernel JVPs the same."""
    prob = odt.models.fitzhugh_nagumo(device="cpu")
    rng = np.random.default_rng(1)
    u = _t(rng.standard_normal((D, 64)))
    p = prob.p[:, None].expand(4, 64) * (1 + 0.05 * _t(rng.standard_normal((4, 64))))
    got = [fhn_jac_diag(u, p, 0.0), ek1d.diag_from_full(prob.jac, D)(u, p, 0.0),
           ek1d.auto_jac_diag(prob.f)(u, p, 0.0)]
    jprob = odf.models.fitzhugh_nagumo()
    ref = pk._auto_jac_diag(jprob.f)(jnp.asarray(_np(u)), jnp.asarray(_np(p)),
                                     0.0)
    for g in got:
        np.testing.assert_allclose(_np(g), np.asarray(ref), rtol=1e-12,
                                   atol=1e-12)
    assert torch.equal(got[0], got[1])


def test_front_door_takes_the_jacobian_diagonal_in_order():
    """`jac_diag_of`: ``prob.jac_diag`` first, then the diagonal of
    ``prob.jac``, then None (d JVPs), as the JAX front door."""
    prob = odt.models.fitzhugh_nagumo(device="cpu")
    assert ek1d.jac_diag_of(odt.remake(prob, jac_diag=fhn_jac_diag)) is fhn_jac_diag
    u = prob.u0[:, None]
    torch.testing.assert_close(ek1d.jac_diag_of(prob)(u, prob.p, 0.0),
                               fhn_jac_diag(u, prob.p, 0.0), rtol=0, atol=0)
    assert ek1d.jac_diag_of(odt.remake(prob, jac=None)) is None


# ---------------------------------------------------------------- step


def _conditioned_state(n=64, k_steps=10):
    """A filter-conditioned per-member state: the port's plain step chained
    ``k_steps`` times from the Taylor init of a perturbed ensemble, as
    numpy ``(m (nq, d, n), C (d, nq, nq, n), ps (4, n))``."""
    from odefilters_torch.taylor import taylor_coefficients

    prob = odt.models.fitzhugh_nagumo(device="cpu")
    rng = np.random.default_rng(2)
    u0s = prob.u0[:, None] + 0.1 * _t(rng.standard_normal((D, n)))
    ps = prob.p[:, None] * (1 + 0.05 * _t(rng.standard_normal((4, n))))
    At, Qt, p = ek1d.filter_constants(Q, DT_FIX, torch.float64)
    m0 = torch.stack(taylor_coefficients(prob.f, u0s, ps, 0.0, Q))
    m0_p = _t(p)[:, None, None] * m0
    m = [[m0_p[i, j] for j in range(D)] for i in range(NQ)]
    zero = torch.zeros(n, dtype=torch.float64)
    C = [[[zero] * NQ for _ in range(NQ)] for _ in range(D)]
    kw = _step_consts()
    for k in range(k_steps):
        m, C, _ = ek1d.ek1d_pd_step(m, C, ps, DT_FIX * (k + 1), f=prob.f,
                                    jac_diag=fhn_jac_diag, **kw)
    return (np.stack([np.stack([_np(x) for x in r]) for r in m]),
            np.stack([np.stack([np.stack([_np(x) for x in r]) for r in Cj])
                      for Cj in C]), _np(ps))


def _step_consts():
    At, Qt, p = ek1d.filter_constants(Q, DT_FIX, torch.float64)
    return dict(At=ek1d._lists(At), Qt=ek1d._lists(Qt),
                pinv0=float(1 / p[0]), pinv1=float(1 / p[1]), d=D, nq=NQ)


@pytest.mark.parametrize("diffusion", MODES)
def test_step_matches_jax_over_chained_steps(diffusion):
    """`ek1d_pd_step` == `_ek1d_pd_step_lists` (with the static
    calibration carry), each package chaining its own outputs over 5 steps
    from a filter-conditioned state; rtol 1e-12."""
    m, C, ps = _conditioned_state()
    static = None if diffusion == "dynamic" else diffusion
    n = m.shape[-1]
    kw = _step_consts()
    At, Qt, _ = ek1d.filter_constants(Q, DT_FIX, torch.float64)
    jkw = dict(At=At, Qt=Qt, pinv0=kw["pinv0"], pinv1=kw["pinv1"], d=D, nq=NQ)
    jprob = odf.models.fitzhugh_nagumo()
    prob = odt.models.fitzhugh_nagumo(device="cpu")
    mj = [[jnp.asarray(m[i, j]) for j in range(D)] for i in range(NQ)]
    Cj = [[[jnp.asarray(C[j, i, l]) for l in range(NQ)] for i in range(NQ)]
          for j in range(D)]
    mt = [[_t(m[i, j]) for j in range(D)] for i in range(NQ)]
    Ct = [[[_t(C[j, i, l]) for l in range(NQ)] for i in range(NQ)]
          for j in range(D)]
    zj, zt = jnp.zeros(n), torch.zeros(n, dtype=torch.float64)
    calj = ([zj] * D if static == "fixedMV" else zj, zj)
    calt = ([zt] * D if static == "fixedMV" else zt, zt)
    for k in range(5):
        t_new = 0.44 + DT_FIX * k
        outj = pk._ek1d_pd_step_lists(
            mj, Cj, jnp.asarray(ps), jnp.float64(t_new), f=jprob.f,
            jac_diag=_jax_jac_diag(jprob), static_diff=static,
            calib=calj if static else None, **jkw)
        outt = ek1d.ek1d_pd_step(
            mt, Ct, _t(ps), torch.tensor(t_new, dtype=torch.float64),
            f=prob.f, jac_diag=fhn_jac_diag, static_diff=static,
            calib=calt if static else None, **kw)
        mj, Cj, mt, Ct = outj[0], outj[1], outt[0], outt[1]
        np.testing.assert_allclose(_np(outt[2]), np.asarray(outj[2]),
                                   rtol=1e-12)
        if static:
            calj, calt = outj[3], outt[3]
            sj = calj[0] if static == "fixedMV" else [calj[0]]
            st_ = calt[0] if static == "fixedMV" else [calt[0]]
            for a, b in zip(st_, sj):
                np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-12)
    for i in range(NQ):
        for j in range(D):
            np.testing.assert_allclose(_np(mt[i][j]), np.asarray(mj[i][j]),
                                       rtol=1e-12, atol=1e-14)
    for j in range(D):
        for i in range(NQ):
            for l in range(NQ):
                scale = np.abs(np.asarray(Cj[j][i][i])) + 1e-300
                np.testing.assert_allclose(_np(Ct[j][i][l]),
                                           np.asarray(Cj[j][i][l]),
                                           rtol=1e-12, atol=1e-12 * scale.max())


@pytest.mark.parametrize("stop_calib", [False, True])
def test_step_stop_calib_matches_jax(stop_calib):
    """`ek1d_pd_step(stop_calib=...)` == `_ek1d_pd_step_lists(stop_calib=
    ...)` in value (rtol 1e-12) and VJP (1e-10 of the scale over the
    members); the values equal the default's bit for bit, and the
    ``stop_calib=True`` VJP is the default's without the s2 path."""
    m, C, ps = _conditioned_state(n=32)
    kw = _step_consts()
    At, Qt, _ = ek1d.filter_constants(Q, DT_FIX, torch.float64)
    jkw = dict(At=At, Qt=Qt, pinv0=kw["pinv0"], pinv1=kw["pinv1"], d=D, nq=NQ)
    jprob = odf.models.fitzhugh_nagumo()
    prob = odt.models.fitzhugh_nagumo(device="cpu")
    t = 0.52

    def jfun(m, C, p):
        return pk._ek1d_pd_step_lists(
            m, C, p, jnp.float64(t), f=jprob.f, jac_diag=_jax_jac_diag(jprob),
            stop_calib=stop_calib, **jkw)

    def tfun(m, C, p, **over):
        return ek1d.ek1d_pd_step(m, C, p, torch.tensor(t, dtype=torch.float64),
                                 f=prob.f, jac_diag=fhn_jac_diag, **kw, **over)

    jin = ([[jnp.asarray(m[i, j]) for j in range(D)] for i in range(NQ)],
           [[[jnp.asarray(C[j, i, l]) for l in range(NQ)] for i in range(NQ)]
            for j in range(D)], jnp.asarray(ps))
    tin = ([[_t(m[i, j]) for j in range(D)] for i in range(NQ)],
           [[[_t(C[j, i, l]) for l in range(NQ)] for i in range(NQ)]
            for j in range(D)], _t(ps))
    jout, jvjp = jax.vjp(jfun, *jin)
    tout, tvjp = torch.func.vjp(
        lambda *a: tfun(*a, stop_calib=stop_calib), *tin)
    dout, dvjp = torch.func.vjp(tfun, *tin)
    leaves = jax.tree_util.tree_leaves
    for g, r, dflt in zip(leaves(tout), leaves(jout), leaves(dout)):
        np.testing.assert_allclose(_np(g), np.asarray(r), rtol=1e-12,
                                   atol=1e-300)
        assert torch.equal(g, dflt)
    rng = np.random.default_rng(9)
    cm, cC, ci = (rng.standard_normal((NQ, D, 32)),
                  rng.standard_normal((D, NQ, NQ, 32)), rng.standard_normal(32))
    jct = ([[jnp.asarray(cm[i, j]) for j in range(D)] for i in range(NQ)],
           [[[jnp.asarray(cC[j, i, l]) for l in range(NQ)] for i in range(NQ)]
            for j in range(D)], jnp.asarray(ci))
    tct = ([[_t(cm[i, j]) for j in range(D)] for i in range(NQ)],
           [[[_t(cC[j, i, l]) for l in range(NQ)] for i in range(NQ)]
            for j in range(D)], _t(ci))
    got = tvjp(tct)
    for g, r in zip(leaves(got), leaves(jvjp(jct))):
        g, r = _np(g), np.asarray(r)
        scale = np.abs(r).max(axis=-1, keepdims=True)
        assert np.all(np.abs(g - r) <= 1e-10 * scale)
    same = all(torch.equal(a, b) for a, b in zip(leaves(got), leaves(dvjp(tct))))
    assert same != stop_calib


# ---------------------------------------------------------- fixed grid


@pytest.fixture(scope="module")
def fixed_inputs():
    """Perturbed FHN ensemble: numpy u0s, ps and the JAX Taylor init m0."""
    jprob, u0s, ps = _ensemble(TSPAN_FIX)
    return jprob, u0s, ps, _jax_taylor(jprob, u0s, ps, TSPAN_FIX[0])


@pytest.fixture(scope="module")
def jax_fixed(fixed_inputs):
    """`pk.ek1d_fused_filter` in interpret mode in each diffusion mode."""
    jprob, _, ps, m0 = fixed_inputs
    out = {}
    with pltpu.force_tpu_interpret_mode():
        for diffusion in MODES:
            res = pk.ek1d_fused_filter(
                jprob.f, _jax_jac_diag(jprob), jnp.asarray(m0),
                jnp.asarray(ps.T), TSPAN_FIX[0], DT_FIX, T_FIX, Q,
                diffusion=diffusion)
            out[diffusion] = [np.asarray(x) for x in res]
    return out


@pytest.fixture(scope="module")
def jax_fixed_eager(fixed_inputs):
    """The JAX kernel's step body `_ek1d_pd_step_lists` (dynamic) chained
    op by op without XLA's compile, from the kernel's preconditioned
    init: ``(stds (T, d, B), lls (B,))`` as the kernel forms them."""
    jprob, _, ps, m0 = fixed_inputs
    At, Qt, p = ek1d.filter_constants(Q, DT_FIX, torch.float64)
    pinv0, pinv1 = float(1 / p[0]), float(1 / p[1])
    m0_p = p[:, None, None] * m0
    m = [[jnp.asarray(m0_p[i, j]) for j in range(D)] for i in range(NQ)]
    zero = jnp.zeros(B_JAX)
    C = [[[zero] * NQ for _ in range(NQ)] for _ in range(D)]
    jd = _jax_jac_diag(jprob)
    ll, stds = zero, []
    for k in range(T_FIX):
        t_new = jnp.float64(TSPAN_FIX[0]) + jnp.float64(DT_FIX) * (k + 1.0)
        m, C, ll_inc = pk._ek1d_pd_step_lists(
            m, C, jnp.asarray(ps.T), t_new, f=jprob.f, jac_diag=jd, At=At,
            Qt=Qt, pinv0=pinv0, pinv1=pinv1, d=D, nq=NQ)
        ll = ll + ll_inc
        stds.append(np.stack([np.asarray(pinv0 * jnp.sqrt(jnp.maximum(
            C[j][0][0], 0.0))) for j in range(D)]))
    return np.stack(stds), np.asarray(ll)


def _port_fixed(fixed_inputs, diffusion):
    _, _, ps, m0 = fixed_inputs
    prob = odt.models.fitzhugh_nagumo(device="cpu")
    before = ek1d.ek1d_filter.launches
    out = ek1d.ek1d_fused_filter(prob.f, ek1d.jac_diag_of(prob), _t(m0),
                                 _t(ps.T), TSPAN_FIX[0], DT_FIX, T_FIX, Q,
                                 field="fhn", diffusion=diffusion)
    assert ek1d.ek1d_filter.launches == before
    return [_np(x) for x in out]


def _outside(got, ref, rtol, atol):
    return np.abs(got - ref) > atol + rtol * np.abs(ref)


@pytest.mark.parametrize("diffusion", MODES)
def test_fixed_grid_filter_matches_jax(fixed_inputs, jax_fixed,
                                       jax_fixed_eager, diffusion):
    """`ek1d_fused_filter` (plain) against the JAX `ek1d_fused_filter`
    (interpret mode), 1024 members, 60 steps at dt = 0.04: us rtol 1e-10 /
    atol 1e-12, stds rtol 1e-8 / atol 1e-12, lls rtol 1e-10 / atol 1e-12,
    sigma^2 rtol 1e-9.

    Under the dynamic diffusion the JAX kernel, compiled by XLA for the
    CPU, misses its own step body run op by op at these tolerances on 57
    stds entries (dimension 0, steps 56-60, by up to 1.9e-12 absolute) and
    on 358 members' lls (by up to 4.6e-9 relative): the plain covariance's
    update ``Cp - k k^T s`` cancels there, and XLA's rounding (fused
    multiply-adds) differs from the step body's. The port equals the step
    body to rounding (`test_fixed_grid_filter_is_the_jax_step_body`), so
    there the port is held on every entry where the JAX kernel agrees with
    its own step body, and misses the kernel nowhere else."""
    out = _port_fixed(fixed_inputs, diffusion)
    ref = jax_fixed[diffusion]
    assert out[0].shape == out[1].shape == (T_FIX + 1, D, B_JAX)
    np.testing.assert_allclose(out[0], ref[0], rtol=1e-10, atol=1e-12)
    if diffusion == "dynamic":
        e_std, e_ll = jax_fixed_eager
        own = (np.concatenate([np.zeros((1, D, B_JAX), bool),
                               _outside(e_std, ref[1][1:], 1e-8, 1e-12)]),
               _outside(e_ll, ref[2], 1e-10, 1e-12))
        assert own[0].sum() <= 57 and own[1].sum() <= 358
        for got, want, jax_own, rtol in ((out[1], ref[1], own[0], 1e-8),
                                         (out[2], ref[2], own[1], 1e-10)):
            assert not (_outside(got, want, rtol, 1e-12) & ~jax_own).any()
        return
    np.testing.assert_allclose(out[1], ref[1], rtol=1e-8, atol=1e-12)
    assert np.isnan(out[2]).all() and np.isnan(ref[2]).all()
    assert out[3].shape == ((D, B_JAX) if diffusion == "fixedMV" else (B_JAX,))
    np.testing.assert_allclose(out[3], ref[3], rtol=1e-9)


def test_fixed_grid_filter_is_the_jax_step_body(fixed_inputs,
                                                jax_fixed_eager):
    """The dynamic fixed-grid filter equals the JAX kernel's step body run
    op by op to rtol 1e-12 (measured: 4e-22 absolute on the stds)."""
    out = _port_fixed(fixed_inputs, "dynamic")
    e_std, e_ll = jax_fixed_eager
    np.testing.assert_allclose(out[1][1:], e_std, rtol=1e-12, atol=1e-20)
    np.testing.assert_allclose(out[2], e_ll, rtol=1e-12)


def test_fixed_grid_is_exact_on_a_decoupled_linear_field():
    """On ``u' = -diag(k) u`` the Jacobian is diagonal, so DiagonalEK1 is
    EK1: the fixed-grid DiagonalEK1 filter's means equal the port's EK1
    filter's to 1e-10 (the port's counterpart of
    ``tests/test_diagonal_ek1.py``'s exactness test)."""

    def f(u, p, t):
        return torch.stack([-p[0] * u[0], -p[1] * u[1]])

    def jac(u, p, t):
        z = torch.zeros_like(u[0])
        return torch.stack([torch.stack([-p[0] + z, z]),
                            torch.stack([z, -p[1] + z])])

    prob = odt.ode_problem(f, [1.0, -0.5], (0.0, 2.0), p=[0.7, 3.0], jac=jac,
                           device="cpu")
    rng = np.random.default_rng(4)
    n = 12
    u0s = prob.u0[None] + 0.2 * _t(rng.standard_normal((n, D)))
    ps = prob.p[None] * (1 + 0.1 * _t(rng.standard_normal((n, 2))))
    d1 = odt.solve_ensemble(prob, odt.DiagonalEK1(order=Q, smooth=False), u0s,
                            ps, n_save=40, adaptive=False)
    e1 = odt.solve_ensemble(prob, odt.EK1(order=Q, smooth=False), u0s, ps,
                            n_save=40, adaptive=False)
    np.testing.assert_allclose(_np(d1.us), _np(e1.us), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(_np(d1.stds), _np(e1.stds), rtol=1e-8,
                               atol=1e-12)


# ------------------------------------------------------------ adaptive


@pytest.fixture(scope="module")
def ada_inputs():
    """Perturbed FHN ensemble over TSPAN: numpy u0s, ps, and the JAX
    package's Taylor init m0 and initial steps dt0s."""
    from odefilters.solve import initial_dt as jinitial_dt

    jprob, u0s, ps = _ensemble(TSPAN)
    m0 = _jax_taylor(jprob, u0s, ps, TSPAN[0])
    dt0s = jax.vmap(lambda u, p: jinitial_dt(
        odf.ode_problem(jprob.f, u, TSPAN, p=p), Q, TOL["abstol"],
        TOL["reltol"]))(jnp.asarray(u0s), jnp.asarray(ps))
    return jprob, u0s, ps, m0, np.asarray(dt0s)


def _run_jax(fn, ada_inputs, **kw):
    jprob, _, ps, m0, dt0s = ada_inputs
    with pltpu.force_tpu_interpret_mode():
        out = fn(jprob.f, _jax_jac_diag(jprob), jnp.asarray(m0),
                 jnp.asarray(ps.T), jnp.asarray(dt0s), *TSPAN, S, Q, **TOL,
                 **kw)
    return [np.asarray(x) for x in out]


@pytest.fixture(scope="module")
def jax_ada_filter(ada_inputs):
    return _run_jax(pk.ek1d_adaptive_filter, ada_inputs)


@pytest.fixture(scope="module")
def jax_ada_pair(ada_inputs):
    return _run_jax(pk.ek1d_adaptive_fused_smooth, ada_inputs,
                    max_iters=MAX_ITERS_PAIR)


def _controller(max_iters, dtype=torch.float64):
    return ea.controller(Q, *TSPAN, S, dtype, max_iters=max_iters, **TOL)


def _args(ada_inputs, n=B_JAX):
    _, _, ps, m0, dt0s = ada_inputs
    return _t(m0[:, :, :n]), _t(ps[:n].T), _t(dt0s[:n])


@pytest.fixture(scope="module")
def port_ada_filter(ada_inputs):
    prob = odt.models.fitzhugh_nagumo(device="cpu", tspan=TSPAN)
    return eda.ek1d_adaptive_plain(prob.f, ek1d.jac_diag_of(prob),
                                   *_args(ada_inputs), _controller(100_000))


@pytest.fixture(scope="module")
def port_ada_pair(ada_inputs):
    prob = odt.models.fitzhugh_nagumo(device="cpu", tspan=TSPAN)
    c = _controller(MAX_ITERS_PAIR)
    m0, ps, dt0s = _args(ada_inputs)
    st, lls, counts = eda.ek1d_adaptive_stream_plain(
        prob.f, ek1d.jac_diag_of(prob), m0, ps, dt0s, c)
    us, stds = eda.ek1d_adaptive_smoother_plain(st, counts, m0, c)
    return us, stds, lls, counts


def _hold(us, stds, lls, nacc, nrej, failed, ref):
    """Hold one port result against a JAX result (module docstring);
    returns the numbers the docstrings quote."""
    us, stds, lls = _np(us), _np(stds), _np(lls)
    nacc, nrej, failed = _np(nacc), _np(nrej), _np(failed)
    r_us, r_std, r_ll, r_nacc, r_nrej, r_fail = ref
    assert np.isfinite(us).all() and np.isfinite(stds).all()
    assert (failed == (r_fail > 0.5)).all() and not failed.any()
    same = (nacc == r_nacc) & (nrej == r_nrej)
    assert (~same).sum() <= 0.05 * len(same), int((~same).sum())
    fin = np.isfinite(r_us).all(axis=(0, 1)) & np.isfinite(r_std).all(axis=(0, 1))
    keep = same & fin
    np.testing.assert_allclose(us[..., keep], r_us[..., keep], rtol=2e-8,
                               atol=1e-11)
    rel_std = (np.abs(stds - r_std)[1:] / np.abs(r_std[1:]))[..., keep]
    rel_ll = (np.abs(lls - r_ll) / np.abs(r_ll))[keep]
    assert np.quantile(rel_std, 0.99) <= 1e-2 and rel_std.max() <= 1.0
    assert np.quantile(rel_ll, 0.99) <= 1e-3 and rel_ll.max() <= 1e-2
    assert np.abs(us - r_us)[..., fin].max() <= 1e-5
    assert (stds[0] == 0).all() and (us[0] == r_us[0]).all()
    return dict(differ=int((~same).sum()), nonfinite=int((~fin).sum()),
                us=float((np.abs(us - r_us) / (np.abs(r_us) + 1e-11))[..., keep].max()),
                std=float(rel_std.max()), ll=float(rel_ll.max()))


def test_adaptive_stds_are_rounding_sensitive(ada_inputs, port_ada_filter):
    """The reason the adaptive stds are held loosely: moving every member's
    initial step by one rounding step changes the counts of 20 of the 1024
    members (measured) and, on the others, the filtered stds by up to 0.41
    relative and the means by up to 8.6e-9 relative."""
    prob = odt.models.fitzhugh_nagumo(device="cpu", tspan=TSPAN)
    m0, ps, dt0s = _args(ada_inputs)
    us1, stds1, _, counts1 = eda.ek1d_adaptive_plain(
        prob.f, ek1d.jac_diag_of(prob), m0, ps,
        torch.from_numpy(np.nextafter(_np(dt0s), 1.0)), _controller(100_000))
    us, stds, _, counts = port_ada_filter
    same = (counts[:2] == counts1[:2]).all(dim=0)
    assert 1 <= int((~same).sum()) <= 0.05 * B_JAX
    rel = ((stds1 - stds).abs()[1:] / stds[1:].abs())[..., same]
    assert float(rel.max()) >= 0.1
    assert float(((us1 - us).abs() / us.abs())[..., same].max()) <= 2e-8


def test_adaptive_filter_matches_jax(port_ada_filter, jax_ada_filter):
    """`ek1d_adaptive_plain` on the JAX package's init against
    `ek1d_adaptive_filter` (interpret mode), held as the module docstring
    says. Measured: counts differ on 34 of 1024 members; on the others
    means 1.5e-8, stds 0.60 (99th percentile 3.6e-3), lls 2.4e-3 relative
    (99th percentile 3.8e-4); every member's means 3.0e-8."""
    us, stds, lls, counts = port_ada_filter
    assert stds.shape == (S + 1, D, B_JAX)
    _hold(us, stds, lls, counts[0], counts[1], counts[2].bool(),
          jax_ada_filter)


def test_adaptive_pair_matches_jax(port_ada_pair, jax_ada_pair):
    """The streaming forward and the smoother (plain) against
    `ek1d_adaptive_fused_smooth` (interpret mode, max_iters 256): the
    smoothed save-grid means and per-dimension stds and the filter's
    lls."""
    us, stds, lls, counts = port_ada_pair
    _hold(us, stds, lls, counts[0], counts[1], counts[2].bool(), jax_ada_pair)


def test_adaptive_pair_and_filter_share_their_forward(port_ada_filter,
                                                     port_ada_pair):
    """The streaming forward runs the filter's loop: the same counts and
    lls, bit for bit; the smoother's last save row is the filter's."""
    assert torch.equal(port_ada_filter[3], port_ada_pair[3])
    assert torch.equal(port_ada_filter[2], port_ada_pair[2])
    assert torch.equal(port_ada_filter[0][-1], port_ada_pair[0][-1])
    assert torch.equal(port_ada_filter[1][-1], port_ada_pair[1][-1])


def test_smoother_is_the_ek0_smoother_per_dimension(ada_inputs, port_ada_pair):
    """Each dimension's smoothed means and stds are the adaptive EK0
    smoother's pass over that dimension's stream columns, bit for bit; the
    stream row holds the mean, d factors, log dt, s2 and the save index
    (W = 43)."""
    prob = odt.models.fitzhugh_nagumo(device="cpu", tspan=TSPAN)
    c = _controller(MAX_ITERS_PAIR)
    m0, ps, dt0s = _args(ada_inputs, n=32)
    st, _, counts = eda.ek1d_adaptive_stream_plain(
        prob.f, ek1d.jac_diag_of(prob), m0, ps, dt0s, c)
    assert st.shape == (MAX_ITERS_PAIR, 43, 32)
    us, stds = eda.ek1d_adaptive_smoother_plain(st, counts, m0, c)
    for j in range(D):
        us_j, stds_j = ea.ek0_adaptive_smoother_plain(
            eda.dimension_stream(st, NQ, D, j), counts, m0[:, j:j + 1], c)
        assert torch.equal(us[:, j], us_j[:, 0])
        assert torch.equal(stds[:, j], stds_j)
    assert torch.equal(us, port_ada_pair[0][..., :32])


@pytest.mark.parametrize("smooth", [True, False], ids=["smoother", "filter"])
def test_adaptive_any_ensemble_size(ada_inputs, port_ada_filter, port_ada_pair,
                                    smooth):
    """1000 members: each member is its own loop, so they equal the same
    members of the 1024-member run bit for bit."""
    prob = odt.models.fitzhugh_nagumo(device="cpu", tspan=TSPAN)
    n = 1000
    fn = (eda.ek1d_adaptive_fused_smooth if smooth
          else eda.ek1d_adaptive_filter)
    out = fn(prob.f, ek1d.jac_diag_of(prob), *_args(ada_inputs, n), *TSPAN, S,
             Q, **TOL, max_iters=MAX_ITERS_PAIR if smooth else 100_000)
    us, stds, lls, counts = port_ada_pair if smooth else port_ada_filter
    for got, want in zip(out, (us, stds, lls, counts[0], counts[1],
                               counts[2].bool())):
        assert torch.equal(got, want[..., :n])


def _fhn_dop853(u0s, ps, tspan, n_eval):
    from scipy.integrate import solve_ivp

    n = u0s.shape[0]
    a, b, tinv, izero = ps.T.astype(np.float64)

    def fhn(t, y):       # all members as one system
        v, w = y[:n], y[n:]
        return np.concatenate([v - v ** 3 / 3 - w + izero,
                               tinv * (v + a - b * w)])

    return solve_ivp(fhn, tspan, u0s.T.ravel().astype(np.float64),
                     method="DOP853", t_eval=np.linspace(*tspan, n_eval),
                     rtol=1e-12, atol=1e-12).y.reshape(D, n, -1).transpose(2, 0, 1)


def test_float32_smoother_holds_against_dop853():
    """16 members over (0, 10) at abstol 1e-6, reltol 1e-4 (the card's
    tolerances), 10 save intervals, through the front door's default: the
    float32 pair is finite, fails no member, and its smoothed means are
    within 1e-4 of DOP853 on every member."""
    tspan, n = (0.0, 10.0), 16
    prob = odt.models.fitzhugh_nagumo(device="cpu", tspan=tspan,
                                      dtype=torch.float32)
    rng = np.random.default_rng(7)
    u0s = (_np(prob.u0)[None] + 0.1 * rng.standard_normal((n, D))).astype(
        np.float32)
    ps = np.broadcast_to(_np(prob.p), (n, 4)).copy()
    ref = _fhn_dop853(u0s, ps, tspan, 11)
    sol = odt.solve_ensemble(prob, odt.DiagonalEK1(order=Q), _t(u0s), _t(ps),
                             n_save=10, abstol=1e-6, reltol=1e-4,
                             max_iters=4096)
    assert torch.isfinite(sol.us).all() and torch.isfinite(sol.stds).all()
    assert sol.stds.shape == (11, D, n) and not sol.failed.any()
    assert np.abs(_np(sol.us).astype(np.float64) - ref).max() <= 1e-4


# ---------------------------------------------------------- front door


def _door(n, tspan=TSPAN_FIX, seed=3):
    prob = odt.models.fitzhugh_nagumo(device="cpu", tspan=tspan)
    rng = np.random.default_rng(seed)
    u0s = prob.u0[None] + 0.05 * _t(rng.standard_normal((n, D)))
    return prob, u0s, prob.p[None].expand(n, 4)


@pytest.mark.parametrize("diffusion", MODES)
def test_front_door_fixed_grid(diffusion):
    """`solve_ensemble(DiagonalEK1(smooth=False), adaptive=False)` at 100
    members (not a multiple of 1024 or of the 64-thread block) equals
    `ek1d_fused_filter` on the port's own Taylor init, bit for bit, in
    each diffusion mode, with ``diffusions`` and NaN ``lls`` under a static
    one."""
    from odefilters_torch.taylor import taylor_coefficients

    n = 100
    prob, u0s, ps = _door(n)
    sol = odt.solve_ensemble(
        prob, odt.DiagonalEK1(order=Q, smooth=False, diffusionmodel=diffusion),
        u0s, ps, n_save=T_FIX, adaptive=False)
    pt = ps.T.contiguous()
    m0 = torch.stack(taylor_coefficients(prob.f, u0s.T.contiguous(), pt,
                                         TSPAN_FIX[0], Q))
    ref = ek1d.ek1d_fused_filter(prob.f, ek1d.jac_diag_of(prob), m0, pt,
                                 TSPAN_FIX[0], DT_FIX, T_FIX, Q, field="fhn",
                                 diffusion=diffusion)
    assert sol.nacc is None and sol.us.shape == sol.stds.shape == (T_FIX + 1, D, n)
    for got, want in zip((sol.us, sol.stds, sol.lls, sol.diffusions), ref):
        assert torch.equal(got, want) or (torch.isnan(got).all()
                                          and torch.isnan(want).all())
    if diffusion == "dynamic":
        assert sol.diffusions is None and torch.isfinite(sol.lls).all()
    else:
        assert torch.isnan(sol.lls).all() and (sol.diffusions > 0).all()


def test_front_door_default_is_adaptive_and_smoothed():
    """`solve_ensemble(prob, DiagonalEK1(), u0s, ps)` runs the adaptive
    smoothed pair with 20 save intervals and max_iters 1024, as the JAX
    front door does; ``smooth=False`` runs the adaptive filter (its
    default max_iters 100 000), on 6 members; the smoothed and filtered
    solutions share the last save row, and neither is the fixed grid's."""
    prob, u0s, ps = _door(6, tspan=(0.0, 1.0), seed=6)
    alg = odt.DiagonalEK1()
    sol = odt.solve_ensemble(prob, alg, u0s, ps)
    ada = odt.solve_ensemble(prob, alg, u0s, ps, n_save=20, adaptive=True,
                             abstol=1e-6, reltol=1e-3, max_iters=1024)
    fil = odt.solve_ensemble(prob, odt.DiagonalEK1(smooth=False), u0s, ps)
    assert sol.us.shape == sol.stds.shape == (21, D, 6)
    for a, b in zip((sol.us, sol.stds, sol.lls, sol.nacc, sol.nrej,
                     sol.failed), (ada.us, ada.stds, ada.lls, ada.nacc,
                                   ada.nrej, ada.failed)):
        assert torch.equal(a, b)
    assert torch.equal(sol.us[-1], fil.us[-1]) and torch.equal(sol.lls, fil.lls)
    assert not torch.equal(sol.us, fil.us)


@pytest.mark.parametrize(
    "alg, kwargs, match",
    [
        # the fixed-grid kernel is a filter, as in the JAX package
        (odt.DiagonalEK1(order=Q), dict(adaptive=False), "first-order filter"),
        (odt.DiagonalEK1(order=Q, smooth=False, diffusionmodel="dynamicMV"),
         dict(adaptive=False), "dynamicMV"),
        # the adaptive kernels take the dynamic diffusion only
        (odt.DiagonalEK1(order=Q, diffusionmodel="fixedMV"), {}, "'fixedMV'"),
        (odt.DiagonalEK1(order=Q, prior="ioup"), {}, "IOUP"),
        (odt.DiagonalEK1(order=Q, smooth=False, prior="matern"),
         dict(adaptive=False), "IOUP / Matern"),
        (odt.DiagonalEK1(order=Q, smooth=False), dict(mesh=object()), "mesh"),
    ],
    ids=["fixed_grid_smoother", "dynamic_mv", "adaptive_static", "prior",
         "fixed_grid_prior", "mesh"],
)
def test_unported_configurations_raise(alg, kwargs, match):
    prob, u0s, ps = _door(4)
    with pytest.raises(NotImplementedError, match=match):
        odt.solve_ensemble(prob, alg, u0s, ps, n_save=5, **kwargs)


def test_mass_matrix_names_its_roadmap_item():
    """The JAX package runs a diagonal mass on the adaptive DiagonalEK1
    filter; the port refuses a mass matrix when the problem is built and
    at the front door, naming the roadmap item."""
    import types

    prob, u0s, ps = _door(4)
    with pytest.raises(NotImplementedError, match="item 3"):
        odt.remake(prob, mass_matrix=torch.ones(D))
    masked = types.SimpleNamespace(**dict(vars(prob), mass_matrix=torch.ones(D)))
    with pytest.raises(NotImplementedError, match="item 3"):
        odt.solve_ensemble(masked, odt.DiagonalEK1(smooth=False), u0s, ps)


def test_algorithm_matches_jax():
    """`DiagonalEK1` validates as the JAX package's: the MV diffusions are
    allowed (EK1 refuses them), and only it is ``is_diagonal_ek1``."""
    for mv in ("fixedMV", "dynamicMV"):
        assert odt.DiagonalEK1(diffusionmodel=mv).is_diagonal_ek1
        assert odf.DiagonalEK1(diffusionmodel=mv).is_diagonal_ek1
    assert isinstance(odt.DiagonalEK1(), odt.EK1) and odt.DiagonalEK1().is_ek1
    assert not odt.EK0().is_diagonal_ek1 and not odt.EK1().is_diagonal_ek1
    with pytest.raises(ValueError):
        odt.DiagonalEK1(diffusionmodel="nope")


def test_wrappers_dispatch_on_device(fixed_inputs, ada_inputs):
    """The wrappers run the plain versions on CPU tensors (no launch is
    counted) and raise on any other device."""
    prob = odt.models.fitzhugh_nagumo(device="cpu", tspan=TSPAN)
    c = _controller(16)
    args = _args(ada_inputs, n=4)
    before = (eda.ek1d_adaptive_stream.launches,
              eda.ek1d_adaptive_smoother.launches)
    st, _, counts = eda.ek1d_adaptive_stream(prob.f, None, "fhn", *args, c)
    us, _ = eda.ek1d_adaptive_smoother(st, counts, args[0], c)
    assert before == (eda.ek1d_adaptive_stream.launches,
                      eda.ek1d_adaptive_smoother.launches)
    assert st.shape == (16, eda.stream_width(NQ, D), 4) and us.shape == (S + 1, D, 4)
    meta = [x.to("meta") for x in args]
    with pytest.raises(ValueError, match="meta"):
        eda.ek1d_adaptive(prob.f, None, "fhn", *meta, c)
    with pytest.raises(ValueError, match="meta"):
        eda.ek1d_adaptive_smoother(st.to("meta"), counts, args[0], c)
    At, Qt, p = ek1d.filter_constants(Q, DT_FIX, torch.float64)
    with pytest.raises(ValueError, match="meta"):
        ek1d.ek1d_filter(prob.f, None, "fhn", meta[0], meta[1], At=At, Qt=Qt,
                         pinv0=1.0, pinv1=1.0, t0=0.0, dt=DT_FIX, n_steps=2)
