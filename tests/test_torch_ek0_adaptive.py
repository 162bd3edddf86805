"""The PyTorch port's adaptive per-member EK0 ensemble solve against the JAX
package, on the CPU in f64: the Hairer initial step against the JAX
package's, the adaptive filter and the streamed
filter + RTS smoother pair against the Pallas kernels in interpret mode
(FitzHugh-Nagumo over (0, 2), 1024 members, 8 save intervals, q = 3,
abstol 1e-8, reltol 1e-6, the setting of the JAX package's own tests), the
front door, a ``max_iters`` that binds, an ensemble of any size, the
front door's default, and the float32 pair against DOP853.
Inputs are made with numpy from a seed and fed to both packages.

**How closely the two can agree.** The adaptive loop turns a difference of
one rounding step anywhere into another accepted-step sequence on about one
member in a hundred
(`test_step_sequences_are_rounding_sensitive`). The port's plain versions
round differently from XLA's CPU code (which contracts products and sums
into fused multiply-adds and has its own exp), and carry the covariance as
a square-root factor where the JAX kernels carry it plain (the float32
plain covariance loses its positive definiteness:
`test_float32_smoother_holds_against_dop853`), so a few
percent of the members take other step sequences in the two packages, as
they do in the JAX package itself when one input moves by one rounding
step. The JAX
comparisons therefore hold: ``failed`` on every member; ``nacc`` and
``nrej`` on all but 5% of the members; on the members whose counts agree,
the save-grid means to rtol 1e-8 / atol 1e-11 and the stds and lls at the
99th percentile to 2e-3 and 1e-3 relative (the JAX package's own rtol
1e-3) and everywhere to 5e-2 and 1e-2; and every member's means to 1e-5
absolute, where both are accurate solutions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import odefilters as odf
import odefilters_torch as odt
from odefilters.ops import pallas_kernels as pk
from odefilters_torch.ops import ek0_adaptive as ea
from odefilters_torch.ops import ek0_pair as ep
from odefilters_torch.solve import initial_dt

Q, NQ, D = 3, 4, 2
TSPAN = (0.0, 2.0)
S = 8
B_JAX = 1024           # the JAX kernels' smallest ensemble (one block)
TOL = dict(abstol=1e-8, reltol=1e-6)
MAX_ITERS_PAIR = 256


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _jax_init(jprob, u0s, ps):
    """The JAX front doors' per-member Taylor init and initial step, as
    numpy ``(m0 (nq, d, B), dt0s (B,))``."""
    from odefilters.solve import initial_dt as jinitial_dt
    from odefilters.taylor import taylor_coefficients

    def init_one(u0, p):
        m = jnp.stack(taylor_coefficients(jprob.f, u0, p, TSPAN[0], Q))
        pr = odf.ode_problem(jprob.f, u0, TSPAN, p=p)
        return m, jinitial_dt(pr, Q, TOL["abstol"], TOL["reltol"])

    m0, dt0 = jax.vmap(init_one)(jnp.asarray(u0s), jnp.asarray(ps))
    return np.array(m0.transpose(1, 2, 0)), np.array(dt0)


@pytest.fixture(scope="module")
def inputs():
    """Perturbed FHN ensemble: numpy u0s (B, d), ps (B, n_params), and the
    JAX package's Taylor init m0 and initial steps dt0s."""
    jprob = odf.models.fitzhugh_nagumo(tspan=TSPAN)
    rng = np.random.default_rng(0)
    u0s = np.asarray(jprob.u0)[None] + 0.05 * rng.standard_normal((B_JAX, D))
    ps = np.broadcast_to(np.asarray(jprob.p), (B_JAX, 4)).copy()
    m0, dt0s = _jax_init(jprob, u0s, ps)
    return jprob, u0s, ps, m0, dt0s


def _controller(max_iters, dtype=torch.float64):
    return ea.controller(Q, *TSPAN, S, dtype, max_iters=max_iters, **TOL)


def _args(m0, ps, dt0s):
    return (torch.from_numpy(np.ascontiguousarray(m0)),
            torch.from_numpy(np.ascontiguousarray(ps.T)),
            torch.from_numpy(np.ascontiguousarray(dt0s)))


def _run_jax(fn, jprob, m0, ps, dt0s, **kw):
    with pltpu.force_tpu_interpret_mode():
        out = fn(jprob.f, jnp.asarray(m0), jnp.asarray(ps.T), jnp.asarray(dt0s),
                 *TSPAN, S, Q, **TOL, **kw)
    return [np.asarray(x) for x in out]


@pytest.fixture(scope="module")
def jax_filter(inputs):
    jprob, _, ps, m0, dt0s = inputs
    return _run_jax(pk.ek0_adaptive_filter, jprob, m0, ps, dt0s)


@pytest.fixture(scope="module")
def jax_pair(inputs):
    jprob, _, ps, m0, dt0s = inputs
    return _run_jax(pk.ek0_adaptive_fused_smooth, jprob, m0, ps, dt0s,
                    max_iters=MAX_ITERS_PAIR)


@pytest.fixture(scope="module")
def port_filter(inputs):
    jprob, _, ps, m0, dt0s = inputs
    prob = odt.models.fitzhugh_nagumo(device="cpu", tspan=TSPAN)
    return ea.ek0_adaptive_plain(prob.f, *_args(m0, ps, dt0s),
                                 _controller(100_000))


@pytest.fixture(scope="module")
def port_pair(inputs):
    jprob, _, ps, m0, dt0s = inputs
    prob = odt.models.fitzhugh_nagumo(device="cpu", tspan=TSPAN)
    c = _controller(MAX_ITERS_PAIR)
    m0_t, ps_t, dt0_t = _args(m0, ps, dt0s)
    st, lls, counts = ea.ek0_adaptive_stream_plain(prob.f, m0_t, ps_t, dt0_t, c)
    us, stds = ea.ek0_adaptive_smoother_plain(st, counts, m0_t, c)
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
    np.testing.assert_allclose(us[..., same], r_us[..., same], rtol=1e-8,
                               atol=1e-11)
    rel_std = (np.abs(stds - r_std)[1:] / np.abs(r_std[1:]))[..., same]
    rel_ll = (np.abs(lls - r_ll) / np.abs(r_ll))[same]
    assert np.quantile(rel_std, 0.99) <= 2e-3 and rel_std.max() <= 5e-2
    assert np.quantile(rel_ll, 0.99) <= 1e-3 and rel_ll.max() <= 1e-2
    # the JAX smoother's means are not finite on some members whose step
    # sequences are long; each finite member is held
    fin = np.isfinite(r_us).all(axis=(0, 1))
    assert np.abs(us - r_us)[..., fin].max() <= 1e-5
    assert (stds[0] == 0).all() and (us[0] == r_us[0]).all()
    return dict(differ=int((~same).sum()),
                us=float((np.abs(us - r_us) / (np.abs(r_us) + 1e-11))[..., same].max()),
                std=float(rel_std.max()), ll=float(rel_ll.max()))


def test_initial_dt_matches_jax(inputs):
    """`initial_dt` against the JAX package's (vmapped) on the ensemble and
    on a member at u0 = 0 (its d0 < 1e-5 branch): measured 1.7e-16
    relative."""
    jprob, u0s, ps, _, dt0s = inputs
    prob = odt.models.fitzhugh_nagumo(device="cpu", tspan=TSPAN)
    got = initial_dt(prob.f, torch.from_numpy(u0s.T.copy()),
                     torch.from_numpy(ps.T.copy()), TSPAN, Q, **TOL)
    np.testing.assert_allclose(_np(got), dt0s, rtol=1e-15)
    from odefilters.solve import initial_dt as jinitial_dt

    z = np.zeros(D)
    want = jax.jit(lambda u, p: jinitial_dt(
        odf.ode_problem(jprob.f, u, TSPAN, p=p), Q, TOL["abstol"],
        TOL["reltol"]))(jnp.asarray(z), jnp.asarray(ps[0]))
    got0 = initial_dt(prob.f, torch.from_numpy(z[:, None].copy()),
                      torch.from_numpy(ps[:1].T.copy()), TSPAN, Q, **TOL)
    np.testing.assert_allclose(_np(got0), [float(want)], rtol=1e-15)


def test_float32_smoother_holds_against_dop853():
    """16 members over (0, 10) at abstol 1e-6, reltol 1e-4 (the card's
    phase-20 tolerances), 10 save intervals: the float32 pair is finite,
    fails no member, and its smoothed means are within 1e-4 of DOP853 on
    every member (measured 2.5e-5). With the JAX kernels' plain covariance
    in place of the factor, float32 C[0][0] turns negative over (0, 20)
    and the smoother's means turn NaN."""
    from scipy.integrate import solve_ivp

    tspan, n = (0.0, 10.0), 16
    prob = odt.models.fitzhugh_nagumo(device="cpu", tspan=tspan,
                                      dtype=torch.float32)
    rng = np.random.default_rng(7)
    u0s = (_np(prob.u0)[None] + 0.1 * rng.standard_normal((n, D))).astype(
        np.float32)
    ps = np.broadcast_to(_np(prob.p), (n, 4)).copy()
    a, b, tinv, izero = ps.T.astype(np.float64)

    def fhn(t, y):       # all members as one system
        v, w = y[:n], y[n:]
        return np.concatenate([v - v ** 3 / 3 - w + izero,
                               tinv * (v + a - b * w)])

    ref = solve_ivp(fhn, tspan, u0s.T.ravel().astype(np.float64),
                    method="DOP853", t_eval=np.linspace(*tspan, 11),
                    rtol=1e-12, atol=1e-12).y.reshape(D, n, -1).transpose(2, 0, 1)
    sol = odt.solve_ensemble(prob, odt.EK0(order=Q), torch.from_numpy(u0s),
                             torch.from_numpy(ps), n_save=10, abstol=1e-6,
                             reltol=1e-4, max_iters=4096)
    assert torch.isfinite(sol.us).all() and torch.isfinite(sol.stds).all()
    assert not sol.failed.any()
    assert np.abs(_np(sol.us).astype(np.float64) - ref).max() <= 1e-4


def test_innovation_takes_a_per_member_preconditioner():
    """The f32 residual with a tensor ``pb`` (the adaptive kernels' per
    member preconditioner) is the double product less du, rounded once."""
    rng = np.random.default_rng(5)
    pb, h, du = (torch.from_numpy(rng.uniform(0.5, 2.0, 256)).float()
                 for _ in range(3))
    want = (pb.double() * h.double() - du.double()).float()
    assert torch.equal(ep.innovation(pb, h, du), want)
    assert torch.equal(ep.innovation(pb.double(), h.double(), du.double()),
                       pb.double() * h.double() - du.double())


def test_step_sequences_are_rounding_sensitive(inputs, port_filter):
    """The reason the JAX comparisons cannot be exact: moving every
    member's initial step by one rounding step changes the accepted and
    rejected counts of 11 of the 1024 members (measured) and the lls by up
    to 0.13 relative, while the means stay within 7.3e-8."""
    jprob, _, ps, m0, dt0s = inputs
    prob = odt.models.fitzhugh_nagumo(device="cpu", tspan=TSPAN)
    us, _, lls, counts = port_filter
    us1, _, lls1, counts1 = ea.ek0_adaptive_plain(
        prob.f, *_args(m0, ps, np.nextafter(dt0s, 1.0)), _controller(100_000))
    differ = int((counts[:2] != counts1[:2]).any(dim=0).sum())
    assert 1 <= differ <= 0.05 * B_JAX
    assert float((us1 - us).abs().max()) <= 1e-6


def test_adaptive_filter_matches_jax(port_filter, jax_filter):
    """`ek0_adaptive_plain` on the JAX package's init against
    `ek0_adaptive_filter` (interpret mode), held as the module docstring
    says. Measured: counts differ on 29 of 1024 members (the JAX package
    itself, dt0 moved by one rounding step: 11); on the others means
    2.8e-9, stds 1.6e-2 (99th percentile 8.6e-4), lls 5.1e-4 relative;
    every member's means 1.9e-6."""
    us, stds, lls, counts = port_filter
    _hold(us, stds, lls, counts[0], counts[1], counts[2].bool(), jax_filter)


def test_adaptive_pair_matches_jax(port_pair, jax_pair):
    """The streaming forward and the smoother (plain) against
    `ek0_adaptive_fused_smooth` (interpret mode, max_iters 256): the
    smoothed save-grid means and stds and the filter's lls. Measured:
    counts differ on 29 members; on the others means 3.8e-9, stds
    1.6e-2 (99th percentile 9.1e-4), lls 5.1e-4 relative. The JAX
    smoother's means are NaN and 1e247 on member 329, whose JAX forward
    took 164 accepted and 25 rejected attempts (the port's: 111 and 7)."""
    us, stds, lls, counts = port_pair
    _hold(us, stds, lls, counts[0], counts[1], counts[2].bool(), jax_pair)


def test_pair_and_filter_share_their_forward(port_filter, port_pair):
    """The streaming forward runs the filter's loop: the same counts and
    lls, bit for bit."""
    assert torch.equal(port_filter[3], port_pair[3])
    assert torch.equal(port_filter[2], port_pair[2])


@pytest.mark.parametrize("smooth", [True, False], ids=["smoother", "filter"])
def test_front_door_matches_jax(inputs, jax_filter, jax_pair, smooth):
    """`solve_ensemble(prob, EK0(smooth=...))` with the port's own Taylor
    init and initial steps on the first 256 members, against the JAX
    kernels on the JAX init: the second Taylor coefficients differ in the
    last bits (up to 1.4e-12 relative), so the comparison is the module
    docstring's. Measured on all 1024 members: counts differ on 30; on the
    others means 7.6e-9, stds 1.5e-2, lls 3.1e-3 relative (99th percentile
    1.9e-4)."""
    n = 256
    _, u0s, ps, _, _ = inputs
    u0s, ps = u0s[:n], ps[:n]
    prob = odt.models.fitzhugh_nagumo(device="cpu", tspan=TSPAN)
    launches = (ea.ek0_adaptive.launches, ea.ek0_adaptive_stream.launches,
                ea.ek0_adaptive_smoother.launches)
    sol = odt.solve_ensemble(
        prob, odt.EK0(order=Q, smooth=smooth), torch.from_numpy(u0s),
        torch.from_numpy(ps), n_save=S, **TOL,
        max_iters=MAX_ITERS_PAIR if smooth else None)
    # CPU tensors take the plain versions: no kernel launch is counted
    assert launches == (ea.ek0_adaptive.launches,
                        ea.ek0_adaptive_stream.launches,
                        ea.ek0_adaptive_smoother.launches)
    assert sol.nacc.dtype == torch.int32 and sol.failed.dtype == torch.bool
    assert sol.diffusions is None
    ref = jax_pair if smooth else jax_filter
    _hold(sol.us, sol.stds, sol.lls, sol.nacc, sol.nrej, sol.failed,
          [x[..., :n] for x in ref])


def _port_run(smooth, prob, m0, ps, dt0s, c):
    """The plain forward (and smoother): ``(us, stds, lls, counts)``."""
    if not smooth:
        return ea.ek0_adaptive_plain(prob.f, m0, ps, dt0s, c)
    st, lls, counts = ea.ek0_adaptive_stream_plain(prob.f, m0, ps, dt0s, c)
    return (*ea.ek0_adaptive_smoother_plain(st, counts, m0, c), lls, counts)


@pytest.fixture(scope="module")
def binding(inputs):
    """Identical members (member 0 repeated) and the JAX filter's result
    with a ``max_iters`` of 40 (a member needs ~100 attempts)."""
    jprob, _, ps, m0, dt0s = inputs
    args = (np.repeat(m0[:, :, :1], B_JAX, axis=2),
            np.repeat(ps[:1], B_JAX, axis=0), np.repeat(dt0s[:1], B_JAX))
    return args, _run_jax(pk.ek0_adaptive_filter, jprob, *args, max_iters=40)


@pytest.mark.parametrize("smooth", [True, False], ids=["smoother", "filter"])
def test_max_iters_binds_on_identical_members(binding, smooth):
    """Where ``max_iters`` binds, the JAX block counts its loop iterations
    and the port each member's attempts; on identical members these are
    one count, so ``nacc``, ``nrej`` and ``failed`` agree exactly with the
    JAX filter's (the JAX pair runs the same forward), and so do the lls
    and, for the filter, the save rows reached (rtol 1e-10). The port's
    later rows hold the last committed state (the JAX kernels leave them
    unwritten)."""
    args, ref = binding
    prob = odt.models.fitzhugh_nagumo(device="cpu", tspan=TSPAN)
    us, stds, lls, counts = _port_run(smooth, prob, *_args(*args),
                                      _controller(40))
    np.testing.assert_array_equal(_np(counts[0]), ref[3])
    np.testing.assert_array_equal(_np(counts[1]), ref[4])
    np.testing.assert_array_equal(_np(counts[2]) == 1, ref[5] > 0.5)
    assert (counts[2] == 1).all() and (counts[0] + counts[1] == 40).all()
    np.testing.assert_allclose(_np(lls), ref[2], rtol=1e-10)
    seg = int(counts[3, 0])
    assert (counts[3] == seg).all() and 1 <= seg < S
    assert torch.isfinite(us).all() and torch.isfinite(stds).all()
    if not smooth:
        np.testing.assert_allclose(_np(us[:seg + 1]), ref[0][:seg + 1],
                                   rtol=1e-10, atol=1e-14)
        np.testing.assert_allclose(_np(stds[:seg + 1]), ref[1][:seg + 1],
                                   rtol=1e-10, atol=1e-14)
    for k in range(seg + 2, S + 1):
        assert torch.equal(us[k], us[seg + 1])
        assert torch.equal(stds[k], stds[seg + 1])


@pytest.mark.parametrize("smooth", [True, False], ids=["smoother", "filter"])
def test_any_ensemble_size(inputs, port_filter, port_pair, smooth):
    """1000 members (not a multiple of anything): each member is its own
    loop, so they equal the same members of the 1024-member run bit for
    bit."""
    _, _, ps, m0, dt0s = inputs
    prob = odt.models.fitzhugh_nagumo(device="cpu", tspan=TSPAN)
    n = 1000
    fn = ea.ek0_adaptive_fused_smooth if smooth else ea.ek0_adaptive_filter
    out = fn(prob.f, *_args(m0[:, :, :n], ps[:n], dt0s[:n]), *TSPAN, S, Q,
             **TOL, max_iters=MAX_ITERS_PAIR if smooth else 100_000)
    us, stds, lls, counts = port_pair if smooth else port_filter
    for got, want in zip(out, (us, stds, lls, counts[0], counts[1],
                               counts[2].bool())):
        assert torch.equal(got, want[..., :n])


def test_default_is_adaptive():
    """`solve_ensemble(prob, EK0(), u0s, ps)` runs the adaptive smoothed
    pair with 20 save intervals, as the JAX package's front door does: it
    equals the explicit adaptive call and not the fixed-grid one."""
    prob = odt.models.fitzhugh_nagumo(device="cpu", tspan=(0.0, 1.0))
    rng = np.random.default_rng(6)
    u0s = prob.u0[None] + 0.05 * torch.from_numpy(rng.standard_normal((6, D)))
    ps = prob.p[None].expand(6, 4).contiguous()
    sol = odt.solve_ensemble(prob, odt.EK0(), u0s, ps)
    ada = odt.solve_ensemble(prob, odt.EK0(), u0s, ps, n_save=20,
                             adaptive=True, abstol=1e-6, reltol=1e-3,
                             max_iters=1024)
    fix = odt.solve_ensemble(prob, odt.EK0(), u0s, ps, n_save=20,
                             adaptive=False)
    assert sol.us.shape == (21, D, 6) and sol.nacc is not None
    for a, b in zip((sol.us, sol.stds, sol.lls, sol.nacc, sol.nrej,
                     sol.failed), (ada.us, ada.stds, ada.lls, ada.nacc,
                                   ada.nrej, ada.failed)):
        assert torch.equal(a, b)
    assert not torch.equal(sol.us, fix.us)
    assert fix.nacc is None and fix.nrej is None and fix.failed is None


@pytest.mark.parametrize(
    "alg, kwargs, match",
    [
        # adaptive EK1 and DiagonalEK1 run on their own kernels, with the
        # IBM prior
        (odt.EK1(order=Q, prior="ioup"), {}, "IOUP"),
        (odt.DiagonalEK1(order=Q, prior="ioup"), {}, "IOUP"),
        (odt.EK0(order=Q, smooth=False, prior="ioup"), {}, "IOUP"),
        (odt.EK0(order=Q), dict(mesh=object()), "mesh"),
        (odt.EK0(order=Q, diffusionmodel="fixedMAP"), {}, "'fixedMAP'"),
    ],
    ids=["ek1", "diagonal_ek1", "prior", "mesh", "static_diffusion"],
)
def test_adaptive_unported_configurations_raise(alg, kwargs, match):
    prob = odt.models.fitzhugh_nagumo(device="cpu")
    u0s, ps = prob.u0[None].expand(4, 2), prob.p[None].expand(4, 4)
    with pytest.raises(NotImplementedError, match=match):
        odt.solve_ensemble(prob, alg, u0s, ps, **kwargs)


def test_wrappers_dispatch_on_device(inputs):
    """The wrappers run the plain versions on CPU tensors (no launch is
    counted) and raise on any other device."""
    _, _, ps, m0, dt0s = inputs
    prob = odt.models.fitzhugh_nagumo(device="cpu", tspan=TSPAN)
    c = _controller(16)
    args = _args(m0[:, :, :4], ps[:4], dt0s[:4])
    before = ea.ek0_adaptive_stream.launches
    st, _, counts = ea.ek0_adaptive_stream(prob.f, "fhn", *args, c)
    assert ea.ek0_adaptive_stream.launches == before
    assert st.shape == (16, ea.stream_width(NQ, D), 4)
    meta = [x.to("meta") for x in args]
    with pytest.raises(ValueError, match="meta"):
        ea.ek0_adaptive(prob.f, "fhn", *meta, c)
    with pytest.raises(ValueError, match="meta"):
        ea.ek0_adaptive_smoother(st.to("meta"), counts, args[0], c)
