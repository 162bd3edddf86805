"""The PyTorch port's adaptive dense EK1 ensemble filter against the JAX
package, on the CPU in f64: the plain filter against ``ek1_adaptive_filter``
in interpret mode (FitzHugh-Nagumo over (0, 2), 1024 members, 8 save
intervals, q = 3, abstol 1e-8, reltol 1e-6, the setting of the JAX
package's own test of this kernel), the front door's default, a
``max_iters`` that binds, an ensemble of any size, and the single solve.
Inputs are made with numpy from a seed and fed to both packages.

**How closely the two can agree.** As in ``test_torch_ek0_adaptive.py``,
whose standard this file keeps where the dense EK1 step allows it: the
adaptive loop turns a difference of one rounding step into another
accepted-step sequence on a few members, and the port's plain versions
round differently from XLA's CPU code, which contracts products and sums
into fused multiply-adds in every step (the JAX adaptive EK1 kernel also
drifts from its own sequential driver at about 1e-12, Gram-Schmidt
against QR, ``docs/kernels.md``). So: ``failed`` on every member; ``nacc``
and ``nrej`` on all but 5% of the members; the lls at the 99th percentile
to 1e-3 relative and everywhere to 1e-2, the stds at the 99th percentile
to 2e-3, every member's means to 1e-5 absolute, as that file holds them.
Two bounds need more room, and `test_adaptive_stds_are_rounding_sensitive`
shows why: the dense step's stds sit at the accuracy floor, where one
rounding step of every dt0 moves the port's filtered stds by up to 0.050
relative on members whose counts do not change and the JAX kernel's by up
to 0.088 (measured on the CPU, interpret mode), and the means by 3.0e-9
and 3.6e-9. The two packages differ by many rounding steps, so the stds
are held everywhere to 0.5 and the means of the members whose counts
agree to rtol 2e-8 / atol 1e-11, as the DiagonalEK1 file holds them
(measured against the JAX kernel: 33 of 1024 members' counts differ; on
the others the means 1.1e-8, the stds 0.19 (99th percentile 1.6e-3), the
lls 2.1e-3 (99th percentile 2.6e-4)).
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
from odefilters_torch.ops import ek1_adaptive as e1a
from odefilters_torch.ops.ek1d import jac_diag_of

Q, NQ, D = 3, 4, 2
TSPAN = (0.0, 2.0)
S = 8
B_JAX = 1024           # the JAX kernels' smallest ensemble (one block)
TOL = dict(abstol=1e-8, reltol=1e-6)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _jax_init(jprob, u0s, ps):
    """The JAX front door's per-member Taylor init and initial step, as
    numpy ``(m0 (nq, d, B), dt0s (B,))``."""
    from odefilters.solve import initial_dt as jinitial_dt
    from odefilters.taylor import taylor_coefficients

    def init_one(u0, p):
        m = jnp.stack(taylor_coefficients(jprob.f, u0, p, TSPAN[0], Q))
        pr = odf.ode_problem(jprob.f, u0, TSPAN, p=p)
        return m, jinitial_dt(pr, Q, TOL["abstol"], TOL["reltol"])

    m0, dt0 = jax.vmap(init_one)(jnp.asarray(u0s), jnp.asarray(ps))
    return np.array(m0.transpose(1, 2, 0)), np.array(dt0)


def _args(m0, ps, dt0s):
    return (torch.from_numpy(np.ascontiguousarray(m0)),
            torch.from_numpy(np.ascontiguousarray(ps.T)),
            torch.from_numpy(np.ascontiguousarray(dt0s)))


def _controller(max_iters=100_000):
    return ea.controller(Q, *TSPAN, S, torch.float64, max_iters=max_iters,
                         **TOL)


def _hold(us, stds, lls, nacc, nrej, failed, ref):
    """Hold one port result against a JAX result (module docstring)."""
    us, stds, lls = _np(us), _np(stds), _np(lls)
    nacc, nrej, failed = _np(nacc), _np(nrej), _np(failed)
    r_us, r_std, r_ll, r_nacc, r_nrej, r_fail = ref
    assert np.isfinite(us).all() and np.isfinite(stds).all()
    assert (failed == (r_fail > 0.5)).all() and not failed.any()
    same = (nacc == r_nacc) & (nrej == r_nrej)
    assert (~same).sum() <= 0.05 * len(same), int((~same).sum())
    np.testing.assert_allclose(us[..., same], r_us[..., same], rtol=2e-8,
                               atol=1e-11)
    rel_std = (np.abs(stds - r_std)[1:] / np.abs(r_std[1:]))[..., same]
    rel_ll = (np.abs(lls - r_ll) / np.abs(r_ll))[same]
    assert np.quantile(rel_std, 0.99) <= 2e-3 and rel_std.max() <= 0.5
    assert np.quantile(rel_ll, 0.99) <= 1e-3 and rel_ll.max() <= 1e-2
    assert np.abs(us - r_us).max() <= 1e-5
    assert (stds[0] == 0).all() and (us[0] == r_us[0]).all()


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


@pytest.fixture(scope="module")
def jax_filter(inputs):
    jprob, _, ps, m0, dt0s = inputs
    with pltpu.force_tpu_interpret_mode():
        out = pk.ek1_adaptive_filter(
            jprob.f, jprob.jac, jnp.asarray(m0), jnp.asarray(ps.T),
            jnp.asarray(dt0s), *TSPAN, S, Q, **TOL)
    return [np.asarray(x) for x in out]


@pytest.fixture(scope="module")
def port_filter(inputs):
    _, _, ps, m0, dt0s = inputs
    prob = odt.models.fitzhugh_nagumo(device="cpu", tspan=TSPAN)
    return e1a.ek1_adaptive_plain(prob.f, prob.jac, *_args(m0, ps, dt0s),
                                  _controller())


def test_filter_matches_jax(port_filter, jax_filter):
    """The plain filter against the JAX kernel, as the module docstring
    says."""
    us, stds, lls, counts = port_filter
    assert tuple(stds.shape) == (S + 1, D, B_JAX)
    assert counts.dtype == torch.int32
    _hold(us, stds, lls, counts[0], counts[1], counts[2].bool(), jax_filter)


def test_adaptive_stds_are_rounding_sensitive(inputs, port_filter):
    """The reason the stds and means are held as the module docstring says:
    moving every member's initial step by one rounding step changes the
    counts of 12 of the 1024 members (measured) and, on the others, the
    filtered stds by up to 0.050 relative and the means by up to 3.0e-9
    relative."""
    _, _, ps, m0, dt0s = inputs
    prob = odt.models.fitzhugh_nagumo(device="cpu", tspan=TSPAN)
    us1, stds1, _, counts1 = e1a.ek1_adaptive_plain(
        prob.f, prob.jac, *_args(m0, ps, np.nextafter(dt0s, 1.0)),
        _controller())
    us, stds, _, counts = port_filter
    same = (counts[:2] == counts1[:2]).all(dim=0)
    assert 1 <= int((~same).sum()) <= 0.05 * B_JAX
    rel = ((stds1 - stds).abs()[1:] / stds[1:].abs())[..., same]
    assert float(rel.max()) >= 0.02
    assert float(((us1 - us).abs() / us.abs())[..., same].max()) <= 1e-8


def test_counts_are_the_jax_kernels(port_filter, jax_filter):
    """Step counts: about 95 accepted attempts a member in both packages,
    the same total within 0.1%."""
    _, _, _, counts = port_filter
    nacc = _np(counts[0])
    assert 60 < nacc.mean() < 140
    assert abs(nacc.sum() - jax_filter[3].sum()) <= 1e-3 * nacc.sum()


def test_any_ensemble_size(inputs, port_filter):
    """Members are independent: the first 5 members alone (an ensemble
    that is not a multiple of the JAX block) give the same results, bit for
    bit."""
    _, _, ps, m0, dt0s = inputs
    prob = odt.models.fitzhugh_nagumo(device="cpu", tspan=TSPAN)
    got = e1a.ek1_adaptive_plain(prob.f, prob.jac,
                                 *_args(m0[..., :5], ps[:5], dt0s[:5]),
                                 _controller())
    for g, r in zip(got, port_filter):
        assert torch.equal(g, r[..., :5])


def test_max_iters_binds(inputs):
    """A budget of 12 attempts per member: every member fails with exactly
    12 attempts, and its save rows past those it reached hold its last
    committed state (finite)."""
    _, _, ps, m0, dt0s = inputs
    prob = odt.models.fitzhugh_nagumo(device="cpu", tspan=TSPAN)
    us, stds, lls, counts = e1a.ek1_adaptive_plain(
        prob.f, prob.jac, *_args(m0[..., :8], ps[:8], dt0s[:8]),
        _controller(max_iters=12))
    assert bool(counts[2].all())
    assert torch.equal(counts[0] + counts[1], torch.full((8,), 12,
                                                         dtype=torch.int32))
    assert torch.isfinite(us).all() and torch.isfinite(stds).all()
    segs = counts[3].long()
    for b in range(8):
        k = int(segs[b])
        assert k < S
        assert torch.equal(us[k + 1:, :, b], us[S:, :, b].expand(S - k, D))


def _small_ensemble(B=3, tspan=(0.0, 1.0)):
    prob = odt.models.fitzhugh_nagumo(device="cpu", tspan=tspan)
    rng = np.random.default_rng(4)
    u0s = torch.from_numpy(_np(prob.u0)[None] + 0.05 * rng.standard_normal((B, D)))
    ps = prob.p[None].expand(B, 4).contiguous()
    return prob, u0s, ps


def test_front_door_default_is_adaptive_and_smoothed():
    """``solve_ensemble(prob, EK1(), u0s, ps)`` runs the adaptive filter +
    RTS smoother (20 save intervals, ``max_iters`` 512) as the JAX front
    door does; with ``smooth=False`` the adaptive filter. Shapes as the JAX
    package's, per-dimension stds."""
    prob, u0s, ps = _small_ensemble()
    sol = odt.solve_ensemble(prob, odt.EK1(order=Q), u0s, ps)
    ref = e1a.solve_ensemble_ek1_adaptive_smooth(prob.f, prob.jac, u0s, ps,
                                                 prob.tspan, 20, q=Q,
                                                 max_iters=512)
    fil = odt.solve_ensemble(prob, odt.EK1(order=Q, smooth=False), u0s, ps)
    ref_f = e1a.solve_ensemble_ek1_adaptive(prob.f, prob.jac, u0s, ps,
                                            prob.tspan, 20, q=Q)
    for got, want in ((sol, ref), (fil, ref_f)):
        assert tuple(got.us.shape) == (21, D, 3) == tuple(got.stds.shape)
        for a, b in zip((got.us, got.stds, got.lls, got.nacc, got.nrej,
                         got.failed), want):
            assert torch.equal(a, b)
        assert not got.failed.any()
    assert torch.equal(sol.lls, fil.lls) and torch.equal(sol.nacc, fil.nacc)
    # smoothing changes the interior rows, not the last
    assert torch.equal(sol.us[-1], fil.us[-1])
    assert (sol.us[1:-1] != fil.us[1:-1]).any()


@pytest.mark.parametrize("kind", ["ek0", "ek1", "diagonal_ek1"])
def test_solve_adaptive_single(kind):
    """One solve on the per-member kernels: member 0 of an ensemble solve,
    bit for bit; shapes without the member axis."""
    prob, u0s, ps = _small_ensemble()
    kw = dict(abstol=1e-6, reltol=1e-4)
    one = odt.solve_adaptive_single(
        prob.f, u0s[0], ps[0], prob.tspan, 6, q=Q, jac=prob.jac,
        jac_diag=jac_diag_of(prob), ek1=kind == "ek1", diagonal_ek1=kind == "diagonal_ek1",
        **kw)
    alg = {"ek0": odt.EK0, "ek1": odt.EK1, "diagonal_ek1": odt.DiagonalEK1}
    sol = odt.solve_ensemble(prob, alg[kind](order=Q, smooth=False), u0s, ps,
                             n_save=6, **kw)
    assert one[0].shape == (7, D) and one[2].shape == ()
    for a, b in zip(one, (sol.us, sol.stds, sol.lls, sol.nacc, sol.nrej,
                          sol.failed)):
        assert torch.equal(a, b[..., 0])


def test_solve_adaptive_single_rejects_two_linearizations():
    prob, u0s, ps = _small_ensemble()
    with pytest.raises(ValueError, match="not both"):
        odt.solve_adaptive_single(prob.f, u0s[0], ps[0], prob.tspan, 4,
                                  ek1=True, diagonal_ek1=True)


@pytest.mark.parametrize(
    "alg, match",
    [(odt.EK1(order=Q, prior="ioup"), "IOUP"),
     (odt.EK1(order=Q, diffusionmodel="fixed"), "dynamic diffusion")],
    ids=["prior", "static_diffusion"])
def test_adaptive_unported_branches_raise(alg, match):
    """The adaptive EK1 kernels run the IBM prior and the dynamic
    diffusion, as the port's other adaptive kernels do."""
    prob, u0s, ps = _small_ensemble()
    with pytest.raises(NotImplementedError, match=match):
        odt.solve_ensemble(prob, alg, u0s, ps, n_save=4)
