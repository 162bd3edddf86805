"""The PyTorch port's fused EK0 filter + smoother pair against the JAX
package, on the CPU in f64: the step bodies one by one, the whole pair
against the Pallas pair in interpret mode, members against the sequential
Kronecker solver, and the front door. Inputs are made with numpy from a
seed and fed to both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import odefilters as odf
import odefilters_torch as odt
from odefilters.kronsolve import solve_fixed_kron
from odefilters.ops import pallas_kernels as pk
from odefilters_torch.ops import ek0_pair as ep

Q, NQ, D, BX = 3, 4, 2, 1
TSPAN = (0.0, 2.0)
N_STEPS = 30
B_PAIR = 1024          # the JAX pair's smallest ensemble (one block)


def _consts(dt):
    At, Qt, QLt, p = ep.pair_constants(Q, dt)
    return At, Qt, QLt, float(1.0 / p[0]), float(1.0 / p[1])


def _random_collapsed_cov(rng, n, scale):
    """n lanes of symmetric PSD nq x nq covariances whose row/column BX is
    exactly zero, as numpy (nq, nq, n)."""
    act = [a for a in range(NQ) if a != BX]
    A = rng.standard_normal((len(act), len(act), n))
    S = np.einsum("ikn,jkn->ijn", A, A) * scale
    C = np.zeros((NQ, NQ, n))
    for ii, i in enumerate(act):
        for jj, j in enumerate(act):
            C[i, j] = S[ii, jj]
    return C


def _lists(arr, wrap, zero_rows=()):
    """(r, c, n) numpy -> r x c lists of wrapped (n,) lanes; entries in
    ``zero_rows`` rows/columns become the structural Python 0.0."""
    return [
        [0.0 if (i in zero_rows or j in zero_rows) else wrap(arr[i, j])
         for j in range(arr.shape[1])]
        for i in range(arr.shape[0])
    ]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_forward_step_matches_jax_over_chained_steps():
    """`ek0_step_core` == `_ek0_step_lists(collapsed=True,
    want_outputs=False)` on 64 random lanes, each package chaining its own
    outputs over 5 steps."""
    rng = np.random.default_rng(0)
    n, dt = 64, 0.1
    At, Qt, _, pinv0, pinv1 = _consts(dt)
    jprob = odf.models.fitzhugh_nagumo()
    p = np.asarray(jprob.p)[:, None] * (1 + 0.05 * rng.standard_normal((4, n)))
    m = rng.standard_normal((NQ, D, n)) * np.array([1e3, 1e2, 1e1, 1.0])[:, None, None]
    C = _random_collapsed_cov(rng, n, 1e-3)
    mj, Cj = _lists(m, jnp.asarray), _lists(C, jnp.asarray)
    mt, Ct = _lists(m, torch.from_numpy), _lists(C, torch.from_numpy)
    f_t = odt.models.fitzhugh_nagumo(device="cpu").f
    for k in range(5):
        t_new = dt * (k + 1)
        mj, Cj, s2j = pk._ek0_step_lists(
            mj, Cj, jnp.asarray(p), jnp.float64(t_new), f=jprob.f, At=At,
            Qt=Qt, pinv0=pinv0, pinv1=pinv1, d=D, nq=NQ, collapsed=True,
            want_outputs=False,
        )
        mt, Ct, s2t = ep.ek0_step_core(
            mt, Ct, torch.from_numpy(p), torch.tensor(t_new, dtype=torch.float64),
            f=f_t, At=ep._lists(At), Qt=ep._lists(Qt), pinv0=pinv0,
            pinv1=pinv1, d=D, nq=NQ,
        )[:3]
        np.testing.assert_allclose(_np(s2t), _np(s2j), rtol=1e-12)
        for i in range(NQ):
            for j in range(D):
                np.testing.assert_allclose(_np(mt[i][j]), _np(mj[i][j]),
                                           rtol=1e-12)
            for l in range(NQ):
                if BX in (i, l):
                    assert not _np(Ct[i][l]).any()
                    continue
                np.testing.assert_allclose(_np(Ct[i][l]), _np(Cj[i][l]),
                                           rtol=1e-12)


def test_backward_step_matches_jax():
    """`ek0_pair_bwd_step_plain` == `_ek0_pair_bwd_step_plain` (jitter
    1e-12) on 64 random lanes."""
    rng = np.random.default_rng(1)
    n = 64
    At, Qt, QLt, _, _ = _consts(0.1)
    m_f = rng.standard_normal((NQ, D, n))
    m_s = m_f + 0.01 * rng.standard_normal((NQ, D, n))
    # covariances on the diffusion's scale, as a filter produces them: the
    # gain is scale-invariant, and Cp's conditioning stays that of the
    # prior's Qt (about 1e5) rather than of an arbitrary mix of scales
    s2 = np.exp(rng.uniform(-20.0, 0.0, n))
    C_f = _random_collapsed_cov(rng, n, 1e-2) * s2
    Cs = _random_collapsed_cov(rng, n, 1e-2) * s2
    kw = dict(At_st=ep._lists(At), QL_st=ep._lists(QLt), Q_st=ep._lists(Qt),
              nq=NQ, d=D, bx=BX, jitter=1e-12)
    mj, Csj = pk._ek0_pair_bwd_step_plain(
        _lists(m_f, jnp.asarray), _lists(C_f, jnp.asarray, (BX,)),
        _lists(m_s, jnp.asarray), _lists(Cs, jnp.asarray, (BX,)),
        jnp.asarray(s2), **kw,
    )
    mt, Cst = ep.ek0_pair_bwd_step_plain(
        _lists(m_f, torch.from_numpy), _lists(C_f, torch.from_numpy, (BX,)),
        _lists(m_s, torch.from_numpy), _lists(Cs, torch.from_numpy, (BX,)),
        torch.from_numpy(s2), **kw,
    )
    for i in range(NQ):
        for j in range(D):
            np.testing.assert_allclose(_np(mt[i][j]), _np(mj[i][j]), rtol=1e-12)
        for l in range(NQ):
            if BX in (i, l):
                assert Cst[i][l] == 0.0 and Csj[i][l] == 0.0
                continue
            np.testing.assert_allclose(_np(Cst[i][l]), _np(Csj[i][l]),
                                       rtol=1e-12)


@pytest.fixture(scope="module")
def pair_inputs():
    """Perturbed FHN ensemble: numpy u0s, ps and the JAX Taylor init m0."""
    import jax

    from odefilters.taylor import taylor_coefficients

    jprob = odf.models.fitzhugh_nagumo(tspan=TSPAN)
    rng = np.random.default_rng(0)
    u0s = np.asarray(jprob.u0)[None] + 0.05 * rng.standard_normal((B_PAIR, 2))
    ps = np.broadcast_to(np.asarray(jprob.p), (B_PAIR, 4)).copy()
    m0 = jax.vmap(
        lambda u, p: jnp.stack(taylor_coefficients(jprob.f, u, p, 0.0, Q))
    )(jnp.asarray(u0s), jnp.asarray(ps)).transpose(1, 2, 0)
    return jprob, u0s, ps, np.asarray(m0)


@pytest.fixture(scope="module")
def pallas_pair(pair_inputs):
    """The JAX pair (`pk.ek0_fused_solve`) in Pallas interpret mode."""
    from jax.experimental.pallas import tpu as pltpu

    jprob, _, ps, m0 = pair_inputs
    dt = (TSPAN[1] - TSPAN[0]) / N_STEPS
    with pltpu.force_tpu_interpret_mode():
        us, stds = pk.ek0_fused_solve(jprob.f, jnp.asarray(m0),
                                      jnp.asarray(ps.T), TSPAN[0], dt,
                                      N_STEPS, Q)
    return np.asarray(us), np.asarray(stds)


def test_fused_solve_matches_pallas_interpret(pair_inputs, pallas_pair):
    _, _, ps, m0 = pair_inputs
    dt = (TSPAN[1] - TSPAN[0]) / N_STEPS
    us, stds = ep.ek0_fused_solve(
        odt.models.fitzhugh_nagumo(device="cpu").f, torch.from_numpy(m0),
        torch.from_numpy(np.ascontiguousarray(ps.T)), TSPAN[0], dt, N_STEPS, Q,
    )
    assert us.shape == (N_STEPS + 1, D, B_PAIR)
    assert stds.shape == (N_STEPS + 1, B_PAIR)
    np.testing.assert_allclose(us.numpy(), pallas_pair[0], rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(stds.numpy(), pallas_pair[1], rtol=1e-8, atol=1e-12)


STATIC = ("fixed", "fixedMAP", "fixedMV")


@pytest.fixture(scope="module")
def pallas_static_pair(pair_inputs):
    """The JAX pair under each static diffusion, in interpret mode:
    ``{diffusion: (us, stds, sigma2)}``."""
    from jax.experimental.pallas import tpu as pltpu

    jprob, _, ps, m0 = pair_inputs
    dt = (TSPAN[1] - TSPAN[0]) / N_STEPS
    out = {}
    with pltpu.force_tpu_interpret_mode():
        for diffusion in STATIC:
            res = pk.ek0_fused_solve(jprob.f, jnp.asarray(m0),
                                     jnp.asarray(ps.T), TSPAN[0], dt, N_STEPS,
                                     Q, diffusion=diffusion)
            out[diffusion] = [np.asarray(x) for x in res]
    return out


@pytest.mark.parametrize("diffusion", STATIC)
def test_static_fused_solve_matches_pallas_interpret(pair_inputs,
                                                     pallas_static_pair,
                                                     diffusion):
    """The static pair (unscaled-prior filter streaming s2 = 1, smoother,
    exit rescale by sqrt(sigma^2)) against the JAX pair, at the dynamic
    pair's tolerances for us and stds and rtol 1e-9 for sigma^2 (measured
    2.7e-15, 5.8e-13 and 8.4e-13 relative at most)."""
    _, _, ps, m0 = pair_inputs
    dt = (TSPAN[1] - TSPAN[0]) / N_STEPS
    us, stds, sig = ep.ek0_fused_solve(
        odt.models.library.fitzhugh_nagumo_f, torch.from_numpy(m0),
        torch.from_numpy(np.ascontiguousarray(ps.T)), TSPAN[0], dt, N_STEPS, Q,
        diffusion=diffusion,
    )
    ref = pallas_static_pair[diffusion]
    shape = (D, B_PAIR) if diffusion == "fixedMV" else (B_PAIR,)
    assert sig.shape == shape and stds.shape == (N_STEPS + 1,) + shape
    np.testing.assert_allclose(us.numpy(), ref[0], rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(stds.numpy(), ref[1], rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(sig.numpy(), ref[2], rtol=1e-9)


@pytest.mark.parametrize("diffusion", STATIC)
def test_static_pair_forward_calibrates_as_the_filter(diffusion):
    """The pair's static forward runs the filter's step and running
    estimate: its sigma^2 equals the filter's bit for bit, and its stream
    carries s2 = 1 on every row."""
    from odefilters_torch.ops import ek0_filter as ef

    rng = np.random.default_rng(6)
    prob = odt.models.fitzhugh_nagumo(device="cpu")
    At, Qt, _, p = ep.pair_constants(Q, 0.04)
    kw = dict(At=At, Qt=Qt, pinv0=float(1 / p[0]), pinv1=float(1 / p[1]),
              t0=0.0, dt=0.04, n_steps=20, static_diff=diffusion)
    m0 = torch.from_numpy(rng.standard_normal((NQ, D, 16)) * 1e-2)
    ps = prob.p[:, None].expand(4, 16).contiguous()
    st, sig = ep.ek0_pair_fwd(prob.f, "fhn", m0, ps, **kw)
    sig_f = ef.ek0_filter_plain(prob.f, m0, ps, **kw)[3]
    assert torch.equal(sig, sig_f)
    assert (st[:, -1] == 1.0).all()


@pytest.mark.parametrize("diffusion", STATIC)
def test_front_door_static_smoother(diffusion):
    """``solve_ensemble`` with a static model on the pair: ``diffusions``
    ``(B,)`` or ``(d, B)`` (fixedMV, whose stds are ``(T+1, d, B)``), no
    lls, stds 0 at t0 and positive after."""
    prob, u0s, ps = _ensemble(B=10)
    u0s = u0s + 0.05 * torch.from_numpy(
        np.random.default_rng(7).standard_normal((10, D)))
    sol = odt.solve_ensemble(prob, odt.EK0(order=Q, diffusionmodel=diffusion),
                             u0s, ps, n_save=N_STEPS)
    shape = (D, 10) if diffusion == "fixedMV" else (10,)
    assert sol.lls is None
    assert sol.diffusions.shape == shape and (sol.diffusions > 0).all()
    assert sol.us.shape == (N_STEPS + 1, D, 10)
    assert sol.stds.shape == (N_STEPS + 1,) + shape
    assert torch.isfinite(sol.us).all() and torch.isfinite(sol.stds).all()
    assert (sol.stds[0] == 0).all() and (sol.stds[1:] > 0).all()


@pytest.fixture(scope="module")
def port_solution(pair_inputs):
    """The port's front door on the perturbed ensemble (CPU, f64)."""
    _, u0s, ps, _ = pair_inputs
    prob = odt.models.fitzhugh_nagumo(device="cpu", tspan=TSPAN)
    launches = (ep.ek0_pair_fwd.launches, ep.ek0_pair_bwd.launches)
    sol = odt.solve_ensemble(prob, odt.EK0(order=Q), torch.from_numpy(u0s),
                             torch.from_numpy(ps), n_save=N_STEPS)
    # CPU tensors take the plain versions: no kernel launch is counted
    assert (ep.ek0_pair_fwd.launches, ep.ek0_pair_bwd.launches) == launches
    return sol


@pytest.mark.parametrize("idx", [0, 17])
def test_members_match_kron_oracle(pair_inputs, port_solution, idx):
    """Members vs the sequential XLA Kronecker solver, at the tolerances of
    the JAX pair's own test against it."""
    jprob, u0s, ps, _ = pair_inputs
    sk = solve_fixed_kron(
        odf.remake(jprob, u0=jnp.asarray(u0s[idx]), p=jnp.asarray(ps[idx])),
        odf.EK0(order=Q), ts=jnp.linspace(*TSPAN, N_STEPS + 1),
    )
    np.testing.assert_allclose(port_solution.us[:, :, idx].numpy(),
                               np.asarray(sk.u), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(port_solution.stds[:, idx].numpy(),
                               np.asarray(sk.u_std[:, 0]), rtol=1e-7,
                               atol=1e-12)


def test_front_door_equals_fused_solve(pair_inputs, port_solution):
    from odefilters_torch.taylor import taylor_coefficients

    _, u0s, ps, _ = pair_inputs
    f = odt.models.fitzhugh_nagumo(device="cpu").f
    u0 = torch.from_numpy(np.ascontiguousarray(u0s.T))
    pt = torch.from_numpy(np.ascontiguousarray(ps.T))
    m0 = torch.stack(taylor_coefficients(f, u0, pt, TSPAN[0], Q))
    dt = (TSPAN[1] - TSPAN[0]) / N_STEPS
    us, stds = ep.ek0_fused_solve(f, m0, pt, TSPAN[0], dt, N_STEPS, Q)
    assert torch.equal(port_solution.us, us)
    assert torch.equal(port_solution.stds, stds)


def test_front_door_any_ensemble_size():
    rng = np.random.default_rng(2)
    prob = odt.models.fitzhugh_nagumo(device="cpu", tspan=TSPAN)
    B = 100
    u0s = prob.u0[None] + 0.1 * torch.from_numpy(rng.standard_normal((B, 2)))
    ps = prob.p[None].expand(B, 4)
    sol = odt.solve_ensemble(prob, odt.EK0(order=Q), u0s, ps, n_save=N_STEPS)
    assert sol.us.shape == (N_STEPS + 1, D, B)
    assert sol.stds.shape == (N_STEPS + 1, B)
    assert torch.isfinite(sol.us).all() and torch.isfinite(sol.stds).all()
    assert (sol.stds[0] == 0).all() and (sol.stds[1:] > 0).all()


def test_float32_plain_pair_close_to_float64():
    """The f32 pair (jitter 1e-6) against the f64 pair on the worst lanes
    of a perturbed ensemble, on the CPU plain path, at the headline grid
    (500 steps over (0, 20)). On coarser grids f32 lanes drift further
    from f64, in the JAX pair as much as here (dt = 0.1: ~4e-2)."""
    rng = np.random.default_rng(3)
    B = 256
    u0s = np.array([-1.0, 1.0]) + 0.1 * rng.standard_normal((B, 2))
    ps = np.broadcast_to(np.array([0.7, 0.8, 1 / 12.5, 0.5]), (B, 4)).copy()
    out = {}
    for dtype in (torch.float32, torch.float64):
        prob = odt.models.fitzhugh_nagumo(device="cpu", dtype=dtype)
        sol = odt.solve_ensemble(prob, odt.EK0(order=Q),
                                 torch.tensor(u0s, dtype=dtype),
                                 torch.tensor(ps, dtype=dtype), n_save=500)
        out[dtype] = (sol.us.double(), sol.stds.double())
    us32, sd32 = out[torch.float32]
    us64, sd64 = out[torch.float64]
    assert torch.isfinite(us32).all() and torch.isfinite(sd32).all()
    assert (us32 - us64).abs().max() <= 1e-4
    assert ((sd32 - sd64).abs() <= 1e-3 * sd64.abs() + 1e-6).all()


def _ensemble(B=8):
    prob = odt.models.fitzhugh_nagumo(device="cpu", tspan=TSPAN)
    return prob, prob.u0[None].expand(B, 2), prob.p[None].expand(B, 4)


class _DiagonalEK1(odt.EK1):
    is_diagonal_ek1 = True


@pytest.mark.parametrize(
    "alg, kwargs, match",
    [
        (odt.EK0(order=Q), dict(adaptive=True), "adaptive"),
        # EK1 runs on its own kernels; DiagonalEK1 is not ported yet
        (_DiagonalEK1(order=Q), {}, "DiagonalEK1"),
        # the fixed-grid pair runs the static models; the adaptive kernels
        # never take them, as in the JAX package
        (odt.EK0(order=Q, diffusionmodel="fixed"), dict(adaptive=True),
         "'fixed'"),
        (odt.EK0(order=Q, smooth=False, diffusionmodel="dynamicMV"), {},
         "dynamicMV"),
        (odt.EK0(order=Q), dict(mesh=object()), "mesh"),
        (odt.EK0(order=Q, prior="ioup"), {}, "IOUP"),
    ],
    ids=["adaptive", "ek1", "fixed_diffusion", "filter_only", "mesh", "prior"],
)
def test_front_door_unported_configurations_raise(alg, kwargs, match):
    prob, u0s, ps = _ensemble()
    with pytest.raises(NotImplementedError, match=match):
        odt.solve_ensemble(prob, alg, u0s, ps, n_save=10, **kwargs)


def test_second_order_problem_raises():
    prob, _, _ = _ensemble()
    with pytest.raises(NotImplementedError, match="second-order"):
        odt.remake(prob, second_order=True)


@pytest.mark.parametrize(
    "kwargs",
    # static_diffusion: the pair runs fixed / fixedMAP / fixedMV; any other
    # diffusion raises, as in the JAX package
    [dict(prior="ioup"), dict(second_order=True), dict(diffusion="dynamicMV"),
     dict(mesh=object()), dict(_bwd_plain=False)],
    ids=["prior", "second_order", "static_diffusion", "mesh", "sqrt_backward"],
)
def test_fused_solve_unported_options_raise(kwargs):
    m0 = torch.zeros((NQ, D, 4), dtype=torch.float64)
    ps = torch.zeros((4, 4), dtype=torch.float64)
    with pytest.raises(NotImplementedError):
        ep.ek0_fused_solve(odt.models.fitzhugh_nagumo(device="cpu").f, m0, ps,
                           0.0, 0.1, 5, Q, **kwargs)


@pytest.mark.parametrize("path", ["pair", "filter"])
def test_float32_residual_rounded_once(monkeypatch, path):
    """Member 3612 of the headline ensemble (u0 + 0.1 N(0, 1), numpy seed
    0; FHN at dt = 0.04, Taylor init in f32), 80 steps. With the residual
    taken as the rounded product less du, the f32 forward (the pair's, and
    the filter's, which shares its step) streams s2 = 0 at step 78, the
    earliest of the 579 such steps of the 8192 x 500 ensemble
    (scripts/torch_residual_census.py); with the residual rounded once
    (`ek0_pair.innovation`) no step does. The f32 means stay within 1e-4
    of f64 either way (measured 5.1e-7 and 8.7e-7 for the pair, 6.3e-7 and
    5.2e-7 for the filter): the pair's backward adds a jitter and the filter
    has no backward pass, so a singular predicted factor does not hurt
    them as it hurts the sampler's."""
    from odefilters_torch.ops import ek0_filter as ef
    from odefilters_torch.taylor import taylor_coefficients

    T, dt = 80, 20.0 / 500
    prob = odt.models.fitzhugh_nagumo(device="cpu", tspan=(0.0, T * dt))
    u0 = prob.u0 + 0.1 * torch.from_numpy(
        np.random.default_rng(0).standard_normal((8192, D))[3612])
    At, Qt, _, p = ep.pair_constants(Q, dt)
    kw = dict(At=At, Qt=Qt, pinv0=float(1 / p[0]), pinv1=float(1 / p[1]),
              t0=0.0, dt=dt, n_steps=T)

    def run(dtype):
        ps = prob.p[:, None].to(dtype)
        m0 = torch.stack(taylor_coefficients(prob.f, u0[:, None].to(dtype), ps,
                                             0.0, Q))
        m0_p = torch.as_tensor(p, dtype=dtype)[:, None, None] * m0
        if path == "pair":
            st = ep.ek0_pair_fwd_plain(prob.f, m0_p, ps, **kw)
            us = ep.ek0_pair_bwd_plain(
                st, nq=NQ, d=D, At=At, Qt=Qt, QLt=ep.pair_constants(Q, dt)[2],
                pinv0=kw["pinv0"],
                jitter=1e-6 if dtype == torch.float32 else 1e-12)[:, :D]
        else:
            us, _, _, st = ef.ek0_filter_fwd_stream_plain(prob.f, m0_p, ps, **kw)
        return st[1:, -1], us.double()

    _, us64 = run(torch.float64)
    s2, us32 = run(torch.float32)
    assert (s2 > 0).all() and float((us32 - us64).abs().max()) <= 1e-4
    monkeypatch.setattr(ep, "innovation", lambda pb, h, du: pb * h - du)
    s2, us32 = run(torch.float32)
    assert int(torch.nonzero(s2 == 0)[0, 0]) == 77
    assert float((us32 - us64).abs().max()) <= 1e-4
