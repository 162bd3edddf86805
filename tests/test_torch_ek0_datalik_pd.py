"""The PyTorch port's per-dimension data likelihood (partial one-hot
observations, per-dimension noise, per-member data, EK0 and DiagonalEK1)
against the JAX package, on the CPU in f64: the EK0 per-dimension step and
the sequential data update with their VJPs (eagerly, no interpret mode),
the front door ``ensemble_data_loglik`` against
``ensemble_data_loglik_pallas`` in interpret mode (Lotka-Volterra, 1024
members, 40 steps over (0, 3), 3 observations on the grid, as the JAX
package's own tests run it), the plain adjoint on the JAX forward's own
stream, and what the front door refuses.

Inputs are made with numpy from a seed and fed to both packages. The
tolerances are the JAX package's own tests' for these models
(tests/test_pallas_and_extras.py): values to rtol 1e-9 and gradients to
rtol 1e-8 / atol 1e-10 for EK0, 1e-6 / atol 1e-9 for DiagonalEK1 (whose
gain depends on the state through the Jacobian diagonal). The ODE
log-likelihood and the gradients in u0s and ps are held against the
ensemble's scale (the largest |value| over the members), as
``tests/test_torch_ek0_datalik.py`` holds them: a member's ODE
log-likelihood sums terms that cancel near 0.

About 61 s on one CPU worker, ~40 s of it four interpret-mode calls of the
JAX kernels (three front-door gradients and one forward), each cached for
the module. One test is marked slow (``-m slow``, about 16 s): the
DiagonalEK1 row's float32 members in both packages at 8192 x 120."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import odefilters as odf
import odefilters_torch as odt
from odefilters.ops import pallas_kernels as pk
from odefilters_torch import convert
from odefilters_torch.ops import ek0_datalik as ed
from odefilters_torch.ops import ek0_datalik_pd as edp
from odefilters_torch.ops import ek0_pair as ep
from odefilters_torch.ops import ek1d

Q, NQ, D = 3, 4, 2
B_JAX = 1024           # the JAX kernels' smallest ensemble (one block)
T = 40
TSPAN = (0.0, 3.0)
TS = np.array([8, 20, 32]) * (TSPAN[1] - TSPAN[0]) / T
SEG = (8, 12, 12, 8)   # the steps between the observations of TS
C2 = np.array([[2.0, 0.0]])
R_VEC = np.array([0.1, 0.3])


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close_to_scale(got, ref, rtol, atol):
    """|got - ref| <= atol + rtol max |ref| over the members (axis 0)."""
    got, ref = _np(got), np.asarray(ref)
    scale = np.abs(ref).max(axis=0, keepdims=True)
    bad = np.abs(got - ref) > atol + rtol * scale
    assert not bad.any(), (f"{int(bad.sum())} entries off; largest |diff| / "
                           f"scale {float((np.abs(got - ref) / scale).max()):.3e}")


# ------------------------------------------------------- the step bodies


def _pd_state(seed, n=32, dt=3.0 / T):
    """A per-dimension state reached by the port's plain EK0 step and data
    update from a perturbed LV ensemble (so that the blocks differ), as
    numpy ``(m (nq, d, n), C (d, nq, nq, n), p (4, n))``."""
    rng = np.random.default_rng(seed)
    prob = odt.models.lotka_volterra(device="cpu")
    p = _t(np.asarray(prob.p)[:, None] * rng.uniform(0.9, 1.1, (4, n)))
    u0 = _t(1.0 + 0.05 * rng.standard_normal((D, n)))
    from odefilters_torch.taylor import taylor_coefficients

    At, Qt, _, pp = ep.pair_constants(Q, dt)
    m0 = torch.stack(taylor_coefficients(prob.f, u0, p, 0.0, Q))
    m = [[_t(pp)[i] * m0[i, j] for j in range(D)] for i in range(NQ)]
    zero = torch.zeros(n, dtype=torch.float64)
    C = [[[zero] * NQ for _ in range(NQ)] for _ in range(D)]
    kw = dict(f=prob.f, At=ek1d._lists(At), Qt=ek1d._lists(Qt),
              pinv0=float(1 / pp[0]), pinv1=float(1 / pp[1]), d=D, nq=NQ)
    for k in range(6):
        m, C, _ = edp.ek0_pd_step(m, C, p, dt * (k + 1), **kw)
        if k == 3:
            m, C, _ = edp.ek0_pd_data_update(
                m, C, [_t(1.0 + 0.1 * rng.standard_normal(n))], obs_dims=(0,),
                obs_scales=(2.0,), r2s=(0.01,), pinv0=kw["pinv0"], nq=NQ)
    return (np.stack([np.stack([_np(x) for x in r]) for r in m]),
            np.stack([np.stack([np.stack([_np(x) for x in r]) for r in Cj])
                      for Cj in C]), _np(p), kw)


def _lists_jax(m, C):
    return ([[jnp.asarray(m[i, j]) for j in range(D)] for i in range(NQ)],
            [[[jnp.asarray(C[j, i, l]) for l in range(NQ)] for i in range(NQ)]
             for j in range(D)])


def _lists_torch(m, C):
    return ([[_t(m[i, j]) for j in range(D)] for i in range(NQ)],
            [[[_t(C[j, i, l]) for l in range(NQ)] for i in range(NQ)]
             for j in range(D)])


def _assert_trees_close(got, ref, rtol, atol=0.0):
    for g, r in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(ref)):
        np.testing.assert_allclose(_np(g), np.asarray(r), rtol=rtol, atol=atol)


def _cotangent(rng, n):
    """A random cotangent of ``(m, C, inc)``, in both packages' lists."""
    cm = rng.standard_normal((NQ, D, n))
    cC = rng.standard_normal((D, NQ, NQ, n))
    ci = rng.standard_normal(n)
    return ((*_lists_jax(cm, cC), jnp.asarray(ci)),
            (*_lists_torch(cm, cC), _t(ci)))


@pytest.mark.parametrize("stop_calib", [False, True])
def test_ek0_pd_step_and_its_vjp_match_jax(stop_calib):
    """`ek0_pd_step` == `_ek0_pd_step_lists` in value (rtol 1e-12) and VJP
    (1e-10 of the scale); ``stop_calib`` leaves the values alone and
    changes the VJP."""
    m, C, p, kw = _pd_state(1)
    prob = odf.models.lotka_volterra()
    At, Qt, _, _ = ep.pair_constants(Q, 3.0 / T)
    jkw = dict(f=prob.f, At=At, Qt=Qt, pinv0=kw["pinv0"], pinv1=kw["pinv1"],
               d=D, nq=NQ)
    t = 1.3

    def jfun(m, C, p):
        return pk._ek0_pd_step_lists(m, C, p, jnp.float64(t),
                                     stop_calib=stop_calib, **jkw)

    def tfun(m, C, p, stop=stop_calib):
        return edp.ek0_pd_step(m, C, p, torch.tensor(t, dtype=torch.float64),
                               stop_calib=stop, **kw)

    jout, jvjp = jax.vjp(jfun, *_lists_jax(m, C), jnp.asarray(p))
    tin = (*_lists_torch(m, C), _t(p))
    tout, tvjp = torch.func.vjp(tfun, *tin)
    _assert_trees_close(tout, jout, 1e-12, 1e-300)
    jct, tct = _cotangent(np.random.default_rng(2), m.shape[-1])
    for g, r in zip(jax.tree_util.tree_leaves(tvjp(tct)),
                    jax.tree_util.tree_leaves(jvjp(jct))):
        _close_to_scale(_np(g).T, np.asarray(r).T, 1e-10, 0.0)
    other_out, other_vjp = torch.func.vjp(
        functools.partial(tfun, stop=not stop_calib), *tin)
    for a, b in zip(jax.tree_util.tree_leaves(other_out),
                    jax.tree_util.tree_leaves(tout)):
        assert torch.equal(a, b)
    assert not np.allclose(_np(other_vjp(tct)[2]), _np(tvjp(tct)[2]),
                           rtol=1e-6)


# rows: (obs_dims, obs_scales, r2s): a scaled partial row; per-dimension
# noise on both dimensions; a dimension observed twice
UPDATES = {"partial": ((0,), (2.0,), (0.01,)),
           "per_dim_noise": ((0, 1), (1.0, 0.5), (0.01, 0.09)),
           "repeated": ((1, 0, 1), (1.5, 1.0, 0.7), (0.04, 0.01, 0.09))}


@pytest.mark.parametrize("rows", UPDATES)
@pytest.mark.parametrize("per_member", [False, True])
def test_data_update_and_its_vjp_match_jax(rows, per_member):
    """`ek0_pd_data_update` == `_ek0_pd_data_update` in value (rtol 1e-12)
    and VJP, with scales != 1, per-row noise and d_obs != d; the port
    leaves its inputs as they are (the JAX function mutates them)."""
    obs_dims, obs_scales, r2s = UPDATES[rows]
    m, C, _, kw = _pd_state(3)
    n = m.shape[-1]
    rng = np.random.default_rng(4)
    y = 1.0 + 0.1 * rng.standard_normal((len(obs_dims), n))
    if not per_member:
        y = y[:, 0]
    ukw = dict(obs_dims=obs_dims, obs_scales=obs_scales, r2s=r2s,
               pinv0=kw["pinv0"], nq=NQ)

    def jfun(m, C, y):
        # the JAX update writes into its lists: hand it copies
        return pk._ek0_pd_data_update([list(r) for r in m], list(C), y, **ukw)

    def tfun(m, C, y):
        return edp.ek0_pd_data_update(m, C, y, **ukw)

    jy = [jnp.asarray(v) for v in y]
    ty = [_t(np.asarray(v)) for v in y]
    jout, jvjp = jax.vjp(jfun, *_lists_jax(m, C), jy)
    tm, tC = _lists_torch(m, C)
    before = ([list(r) for r in tm], [[list(r) for r in Cj] for Cj in tC])
    tout, tvjp = torch.func.vjp(tfun, tm, tC, ty)
    assert all(a is b for ra, rb in zip(tm, before[0]) for a, b in zip(ra, rb))
    assert all(a is b for Ca, Cb in zip(tC, before[1]) for ra, rb in zip(Ca, Cb)
               for a, b in zip(ra, rb))
    _assert_trees_close(tout, jout, 1e-12, 1e-300)
    jct, tct = _cotangent(rng, n)
    _assert_trees_close(tvjp(tct), jvjp(jct), 1e-10, 1e-300)


def test_pd_step_fn_picks_the_step():
    kw = dict(f=None, At=None, Qt=None, pinv0=1.0, pinv1=1.0, d=D, nq=NQ)
    assert edp.pd_step_fn(None, **kw).func is edp.ek0_pd_step
    jd = ek1d.auto_jac_diag(None)
    step = edp.pd_step_fn(jd, stop_calib=True, **kw)
    assert step.func is ek1d.ek1d_pd_step
    assert step.keywords["jac_diag"] is jd and step.keywords["stop_calib"]


def test_obs_rows_parse_one_hot_rows_as_jax():
    assert edp.obs_rows(np.array([[2.0, 0.0], [0.0, -0.5], [1.0, 0.0]])) == (
        (0, 1, 0), (2.0, -0.5, 1.0))
    with pytest.raises(ValueError, match="one-hot"):
        edp.obs_rows(np.array([[1.0, 0.5]]))
    with pytest.raises(ValueError, match="one-hot"):
        edp.obs_rows(np.zeros((1, 2)))


# -------------------------------------------- the front door, interpret mode

# case: (obs_matrix, noise std, per-member ys, DiagonalEK1)
FRONT = {
    "partial": (C2, 0.1, False, False),
    "per_dim_noise_per_member": (None, R_VEC, True, False),
    "diagonal_ek1": (C2, 0.1, False, True),
}
# (values rtol, gradients rtol, gradients atol): the JAX package's tests'
TOL = {False: (1e-9, 1e-8, 1e-10), True: (1e-6, 1e-6, 1e-9)}


def _front_inputs(case):
    """(JAX problem, port problem, u0s, ps, ys, noise) of a case: LV with
    initial values and parameters scaled per member (U(0.8, 1.2) on p)."""
    C, noise, per_member, _ = FRONT[case]
    rng = np.random.default_rng(5)
    jprob = odf.models.lotka_volterra(tspan=TSPAN)
    tprob = odt.models.lotka_volterra(tspan=TSPAN, device="cpu")
    u0s = np.asarray(jprob.u0) * (1 + 0.05 * rng.standard_normal((B_JAX, D)))
    ps = np.asarray(jprob.p) * rng.uniform(0.8, 1.2, (B_JAX, 4))
    d_obs = D if C is None else C.shape[0]
    shape = (B_JAX, len(TS), d_obs) if per_member else (len(TS), d_obs)
    ys = np.abs(rng.normal(1.5, 0.5, shape))
    return jprob, tprob, u0s, ps, ys, noise


def _kw(case):
    C, _, _, diagonal = FRONT[case]
    return dict(obs_matrix=C, diagonal_ek1=diagonal)


def _loss(dll, ll):
    return dll.sum() + 0.5 * ll.sum()


@functools.cache
def _jax_reference(case):
    """``(dll, ll, d/du0s, d/dps, d/dys)`` of the JAX front door in
    interpret mode."""
    jprob, _, u0s, ps, ys, noise = _front_inputs(case)

    def loss(u, p, y):
        dll, ll = pk.ensemble_data_loglik_pallas(
            jprob.f, u, p, TSPAN, T, TS, y, noise, q=Q, **_kw(case))
        return _loss(dll, ll), (dll, ll)

    with pltpu.force_tpu_interpret_mode():
        (_, (dll, ll)), grads = jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True)(
                jnp.asarray(u0s), jnp.asarray(ps), jnp.asarray(ys))
    return tuple(np.asarray(x) for x in (dll, ll) + tuple(grads))


@functools.cache
def _port(case, calib_grad=True):
    """The port's primal (no gradient), its gradient run's values and its
    gradients, on the CPU."""
    _, tprob, u0s, ps, ys, noise = _front_inputs(case)
    kw = dict(q=Q, field=tprob.field, calib_grad=calib_grad, **_kw(case))
    with torch.no_grad():
        primal = odt.ensemble_data_loglik(tprob.f, _t(u0s), _t(ps), TSPAN, T,
                                          TS, _t(ys), noise, **kw)
    args = [_t(x).requires_grad_() for x in (u0s, ps, ys)]
    dll, ll = odt.ensemble_data_loglik(tprob.f, args[0], args[1], TSPAN, T,
                                       TS, args[2], noise, **kw)
    grads = torch.autograd.grad(_loss(dll, ll), args)
    return primal, (dll.detach(), ll.detach()), grads


@pytest.fixture(scope="module")
def jax_reference():
    return _jax_reference


@pytest.mark.parametrize("case", FRONT)
def test_front_door_values_match_jax(case, jax_reference):
    """dll to the values' rtol, ll to it of the ensemble's scale; the primal
    kernel's path and the gradient's forward equal bit for bit."""
    ref = jax_reference(case)
    primal, fwd, _ = _port(case)
    rtol = TOL[FRONT[case][3]][0]
    np.testing.assert_allclose(_np(primal[0]), ref[0], rtol=rtol)
    _close_to_scale(primal[1], ref[1], rtol, 0.0)
    assert torch.equal(primal[0], fwd[0]) and torch.equal(primal[1], fwd[1])


@pytest.mark.parametrize("case", FRONT)
def test_front_door_gradients_match_jax(case, jax_reference):
    """Gradients of ``sum(dll) + 0.5 sum(ll)`` in u0s, ps (of each
    column's scale over the members) and ys (entry by entry; per member
    in the caller's (B, n_obs, d_obs) layout)."""
    ref = jax_reference(case)
    _, _, (gu, gp, gy) = _port(case)
    _, rtol, atol = TOL[FRONT[case][3]]
    _close_to_scale(gu, ref[2], rtol, atol)
    _close_to_scale(gp, ref[3], rtol, atol)
    assert gy.shape == ref[4].shape
    np.testing.assert_allclose(_np(gy), ref[4], rtol=rtol, atol=atol)


def test_calib_grad_false_changes_only_the_gradient():
    """The values are identical, the gradient differs (DiagonalEK1, 64
    members)."""
    _, tprob, u0s, ps, ys, noise = _front_inputs("diagonal_ek1")
    out = []
    for calib_grad in (True, False):
        args = [_t(x[:64]).requires_grad_() for x in (u0s, ps)]
        dll, ll = odt.ensemble_data_loglik(
            tprob.f, *args, TSPAN, T, TS, _t(ys), noise, field="lv",
            calib_grad=calib_grad, **_kw("diagonal_ek1"))
        out.append((dll, ll, torch.autograd.grad(_loss(dll, ll), args)[1]))
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1],
                                                             out[1][1])
    assert not np.allclose(_np(out[0][2]), _np(out[1][2]), rtol=1e-6)


def test_per_member_data_condition_each_member_on_its_own():
    """Per-member ys equal to the shared ones on every member give the
    shared run's values, and the shared gradient is the per-member one
    summed over the members."""
    _, tprob, u0s, ps, ys, noise = _front_inputs("partial")
    ys_b = np.broadcast_to(ys, (B_JAX,) + ys.shape).copy()
    out = []
    for y in (ys, ys_b):
        args = [_t(x).requires_grad_() for x in (u0s[:64], ps[:64],
                                                 y if y.ndim == 2 else y[:64])]
        dll, ll = odt.ensemble_data_loglik(
            tprob.f, args[0], args[1], TSPAN, T, TS, args[2], noise,
            field="lv", obs_matrix=C2)
        out.append((dll, ll, torch.autograd.grad(dll.sum(), args)[2]))
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])
    torch.testing.assert_close(out[1][2].sum(0), out[0][2], rtol=1e-12,
                               atol=1e-12)


# ------------------------------------- the plain adjoint on the JAX stream


@functools.cache
def _jax_stream():
    """The JAX gradient's forward (DiagonalEK1, C = [[2, 0]]) in interpret
    mode on the port's preconditioned inputs: ``(dll, ll, stream)``. The
    parameters are scaled by U(0.95, 1.05): at the front door's spread the
    two packages' roundings part by up to 3.4e-10 of an entry's scale by
    the last steps, at this one by 6e-12."""
    _, tprob, u0s, _, ys, noise = _front_inputs("diagonal_ek1")
    ps = np.asarray(tprob.p) * np.random.default_rng(8).uniform(
        0.95, 1.05, (B_JAX, 4))
    m0_p, ps_t, ys_t, table, consts = ed.pd_kernel_inputs(
        tprob.f, _t(u0s), _t(ps), TSPAN, T, TS, _t(ys), noise, obs_matrix=C2)
    jprob = odf.models.lotka_volterra(tspan=TSPAN)
    blk = lambda x: np.asarray(x).reshape(x.shape[:-1] + (1, 8, 128))
    with pltpu.force_tpu_interpret_mode():
        (dll, ll), (st, _, _) = pk._ek0_datalik_pd_vjp_fwd(
            jprob.f, Q, (TSPAN[1] - TSPAN[0]) / T, TSPAN[0], None, SEG,
            consts["obs_dims"], consts["obs_scales"], consts["r2s"], False,
            False, pk._auto_jac_diag(jprob.f),
            jnp.asarray(np.moveaxis(blk(_np(m0_p)), 2, 0)),
            jnp.asarray(np.moveaxis(blk(_np(ps_t)), 1, 0)),
            jnp.asarray(_np(ys_t)))
    return (np.asarray(dll).reshape(-1), np.asarray(ll).reshape(-1),
            np.asarray(st), (tprob, ps_t, ys_t, table, consts, m0_p))


def test_plain_adjoint_on_the_jax_stream():
    """The JAX forward's stream, through `convert.pd_stream_from_numpy`,
    is the port's plain forward's (non-finite on the same members, whose
    filters diverge at this step; elsewhere the means to 1e-10 of their
    scale, the covariance blocks to 1e-10 of their largest entry: their
    measured rows are rounding noise), and on the finite members the
    port's plain adjoint on it gives the adjoint on the port's own stream
    to 1e-8 of each row's scale."""
    dll_j, ll_j, st_j, (tprob, ps_t, ys_t, table, consts, m0_p) = _jax_stream()
    jd = ek1d.auto_jac_diag(tprob.f)
    dll, ll, st = edp.ek0_datalik_pd_fwd_stream_plain(
        tprob.f, jd, m0_p, ps_t, ys_t, table, **consts)
    got = convert.pd_stream_from_numpy(st_j, nq=NQ, d=D, device="cpu")
    W, V = edp.pd_layout(NQ, D)
    assert got.shape == st.shape == (T, V, B_JAX)
    keep = torch.isfinite(st).all(dim=(0, 1))
    assert torch.equal(torch.isfinite(got).all(dim=(0, 1)), keep)
    assert int(keep.sum()) > B_JAX // 2
    np.testing.assert_allclose(_np(dll[keep]), dll_j[_np(keep)], rtol=1e-9)
    got, st = got[..., keep], st[..., keep].contiguous()
    is_m = torch.tensor([v % W < D for v in range(V)])
    diff = (got - st).abs()
    m_scale = st[:, is_m].abs().amax(dim=(0, 2), keepdim=True)
    assert bool((diff[:, is_m] <= 1e-10 * m_scale).all())
    assert float(diff[:, ~is_m].max()) <= 1e-10 * float(st[:, ~is_m].abs().max())
    ps_t = ps_t[:, keep].contiguous()
    n = int(keep.sum())
    rng = np.random.default_rng(6)
    cts = [_t(rng.standard_normal(n)) for _ in range(2)]
    kw = dict(nq=NQ, stop_calib=False, **consts)
    on_j = edp.ek0_datalik_pd_grad_bwd_plain(tprob.f, jd, got, ps_t, ys_t,
                                             *cts, table, **kw)
    on_p = edp.ek0_datalik_pd_grad_bwd_plain(tprob.f, jd, st, ps_t, ys_t,
                                             *cts, table, **kw)
    for a, b in zip(on_j, on_p):
        _close_to_scale(_np(a).reshape(-1, n).T, _np(b).reshape(-1, n).T,
                        1e-8, 0.0)


def test_pd_stream_from_numpy_checks_its_shape():
    with pytest.raises(ValueError, match="stream"):
        convert.pd_stream_from_numpy(np.zeros((1, 3, NQ, 9, 8, 128)), nq=NQ,
                                     d=D, device="cpu")


# --------------------------------------- what the door refuses, plumbing


def _door_args(**over):
    prob = odt.models.lotka_volterra(tspan=TSPAN, device="cpu")
    rng = np.random.default_rng(0)
    args = dict(prob_f=prob.f, u0s=torch.ones(4, D, dtype=torch.float64),
                ps=prob.p[None].expand(4, 4).contiguous(), tspan=TSPAN,
                n_steps=30, ts_data=np.array([0.5, 1.5]),
                ys=torch.from_numpy(rng.standard_normal((2, 1))),
                obs_noise_std=0.1, obs_matrix=np.array([[1.0, 0.0]]))
    args.update(over)
    return args


@pytest.mark.parametrize("over,exc,match", [
    (dict(obs_matrix=np.array([[1.0, 0.5]])), ValueError, "one-hot"),
    (dict(ek1=True, diagonal_ek1=True), ValueError, "not both"),
    (dict(ts_data=np.array([0.55, 1.5])), NotImplementedError, "off-grid"),
    (dict(diagonal_ek1=True, obs_matrix=None,
          ys=torch.zeros(4, 2, D, dtype=torch.float64),
          ts_data=np.array([0.55, 1.5])), NotImplementedError, "off-grid"),
    (dict(ek1=True, ts_data=np.array([0.55, 1.5])), NotImplementedError,
     "off-grid"),
], ids=["dense_row", "ek1_and_diagonal", "off_grid_partial",
        "off_grid_diagonal_per_member", "ek1"])
def test_refusals_and_their_messages(over, exc, match):
    """As the JAX front door refuses them, with its messages; JAX raises the
    same class."""
    with pytest.raises(exc, match=match):
        odt.ensemble_data_loglik(**_door_args(**over))
    # the JAX kernels take whole blocks of 1024 members
    jargs = {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
             for k, v in _door_args(**over).items()}
    for k in ("u0s", "ps") + (("ys",) if jargs["ys"].ndim == 3 else ()):
        jargs[k] = np.repeat(jargs[k][:1], B_JAX, axis=0)
    jargs["prob_f"] = odf.models.lotka_volterra().f
    with pytest.raises(exc, match=match):
        pk.ensemble_data_loglik_pallas(**jargs)


def _small(case="partial", B=8):
    _, tprob, u0s, ps, ys, noise = _front_inputs(case)
    return (tprob,) + ed.pd_kernel_inputs(
        tprob.f, _t(u0s[:B]), _t(ps[:B]), TSPAN, T, TS,
        _t(ys[:B] if ys.ndim == 3 else ys), noise, **{
            k: v for k, v in _kw(case).items() if k == "obs_matrix"})


@pytest.mark.parametrize("case", FRONT)
def test_cpu_wrappers_run_the_plain_versions_and_other_devices_raise(case):
    tprob, m0, pt, yt, table, consts = _small(case)
    jd = ek1d.jac_diag_of(tprob) if FRONT[case][3] else None
    args = (tprob.f, jd, "lv", m0, pt, yt, table)
    got = edp.ek0_datalik_pd(*args, **consts)
    want = edp.ek0_datalik_pd_plain(tprob.f, jd, m0, pt, yt, table, **consts)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    dll, ll, st = edp.ek0_datalik_pd_grad_fwd(*args, **consts)
    assert st.shape == (T, 40, 8)
    assert torch.equal(dll, want[0]) and torch.equal(ll, want[1])
    rng = np.random.default_rng(6)
    cts = [_t(rng.standard_normal(8)) for _ in range(2)]
    dm0, dps, dys = edp.ek0_datalik_pd_grad_bwd(tprob.f, jd, "lv", st, pt, yt,
                                                *cts, table, nq=NQ, **consts)
    part = edp.ek0_datalik_pd_grad_bwd_plain(tprob.f, jd, st, pt, yt, *cts,
                                             table, nq=NQ, **consts)
    assert torch.equal(dm0, part[0]) and torch.equal(dps, part[1])
    assert torch.equal(dys, part[2] if yt.ndim == 3 else part[2].sum(-1))
    wrappers = (edp.ek0_datalik_pd, edp.ek0_datalik_pd_grad_fwd,
                edp.ek0_datalik_pd_grad_bwd)
    before = [w.launches for w in wrappers]
    meta = [x.to("meta") for x in (m0, pt, yt, st)]
    with pytest.raises(ValueError, match="meta"):
        edp.ek0_datalik_pd(tprob.f, jd, "lv", *meta[:3], table, **consts)
    with pytest.raises(ValueError, match="meta"):
        edp.ek0_datalik_pd_grad_fwd(tprob.f, jd, "lv", *meta[:3], table,
                                    **consts)
    with pytest.raises(ValueError, match="meta"):
        edp.ek0_datalik_pd_grad_bwd(tprob.f, jd, "lv", meta[3], meta[1],
                                    meta[2], *[c.to("meta") for c in cts],
                                    table, nq=NQ, **consts)
    assert before == [w.launches for w in wrappers]


def test_kernel_checks_refuse_what_the_kernels_do_not_take():
    """The CUDA launch's argument checks: at most DOBS_MAX observed rows,
    on-grid tables, ys of the table's observations."""
    tprob, m0, pt, yt, table, consts = _small()
    check = functools.partial(edp._check_inputs, "k", "lv", None, m0.shape,
                              pt)
    check(yt, table, consts)
    many = dict(consts, obs_dims=(0,) * 5, obs_scales=(1.0,) * 5,
                r2s=(0.01,) * 5)
    with pytest.raises(ValueError, match="1 to 4 observed rows"):
        check(torch.zeros(3, 5, dtype=torch.float64), table, many)
    with pytest.raises(ValueError, match="ys must be"):
        check(yt[:2], table, consts)
    off = ed.data_table(TSPAN, T, np.array([0.55, 1.5]), Q, torch.float64,
                        "cpu")
    with pytest.raises(ValueError, match="on the grid only"):
        check(torch.zeros(2, 1, dtype=torch.float64), off, consts)
    with pytest.raises(NotImplementedError, match="no CUDA vector field"):
        edp._check_inputs("k", None, None, m0.shape, pt, yt, table, consts)


# ------------------------------- float32 on the DiagonalEK1 row, both packages


def _ek1d_row_inputs():
    """The JAX package's DiagonalEK1 data-likelihood row
    (benchmarks/run_all.py, tpu_datalik_ek1d_pallas): LV over (0, 3), u0 =
    (1, 1), 8192 candidates with parameters scaled by U(0.8, 1.2), 120
    steps, 9 full-state observations on the grid of DOP853 truth plus
    noise std 0.05; seeded as chip_smoke.py's phase 32 seeds it."""
    from scipy.integrate import solve_ivp

    steps, n = 120, 8192
    ts = np.array([12, 40, 52, 64, 80, 96, 104, 112, 116]) * 3.0 / steps
    truth = solve_ivp(lambda t, y: [1.5 * y[0] - y[0] * y[1],
                                    -3.0 * y[1] + y[0] * y[1]],
                      (0.0, 3.0), [1.0, 1.0], method="DOP853", t_eval=ts,
                      rtol=1e-12, atol=1e-12).y.T
    rng = np.random.default_rng(7)
    ys = truth + 0.05 * rng.standard_normal(truth.shape)
    ps = np.array([1.5, 1.0, 3.0, 1.0]) * rng.uniform(0.8, 1.2, (n, 4))
    return steps, ts, np.ones((n, D)), ps, ys


@pytest.mark.slow
def test_float32_diagonal_ek1_row_against_jax_float32(capsys):
    """The DiagonalEK1 row in float32 against the port's float64, member by
    member, at the limit chip_smoke.py holds the card to (0.01 nats + 1e-3
    |dll64|): the port's float32 (its plain versions, which the kernel
    equals bit for bit) keeps all but a few members within it, and the JAX
    kernel's own float32 run (interpret mode) on the same inputs also puts
    members over it, other ones: its plain covariance update loses
    definiteness on badly fitting members in float32 in both packages,
    where rounding decides which. Marked slow (about 16 s on one CPU worker,
    beyond the file's budget)."""
    steps, ts, u0s, ps, ys = _ek1d_row_inputs()
    jprob = odf.models.lotka_volterra(tspan=TSPAN)
    tprob = odt.models.lotka_volterra(tspan=TSPAN, device="cpu")
    f32 = lambda x: x.astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        dll_j, _ = pk.ensemble_data_loglik_pallas(
            jprob.f, jnp.asarray(f32(u0s)), jnp.asarray(f32(ps)), TSPAN,
            steps, ts, jnp.asarray(f32(ys)), 0.05, q=Q, diagonal_ek1=True)
    dll = {}
    for dtype in (torch.float32, torch.float64):
        with torch.no_grad():
            dll[dtype] = odt.ensemble_data_loglik(
                tprob.f, torch.tensor(u0s, dtype=dtype),
                torch.tensor(ps, dtype=dtype), TSPAN, steps, ts,
                torch.tensor(ys, dtype=dtype), 0.05, q=Q, field="lv",
                diagonal_ek1=True)[0].double().numpy()
    dll64 = dll[torch.float64]
    limit = 0.01 + 1e-3 * np.abs(dll64)
    over = {}
    for name, got in (("port", dll[torch.float32]),
                      ("JAX", np.asarray(dll_j, np.float64))):
        assert np.isfinite(got).all()
        ratio = np.abs(got - dll64) / limit
        over[name] = np.flatnonzero(ratio > 1)
        worst = [(int(k), round(float(ratio[k]), 3))
                 for k in np.argsort(-ratio)[:5]]
        with capsys.disabled():
            print(f"\n{name} float32 vs the port's float64, {len(ratio)} "
                  f"members: {len(over[name])} over the limit "
                  f"{over[name].tolist()}; worst (member, share of the "
                  f"limit) {worst}")
    assert len(over["port"]) <= 8
    assert len(over["JAX"]) >= 1
