"""The PyTorch port's adaptive EK0 joint-posterior sampler against the JAX
package, on the CPU in f64: the plain sampler over the port's adaptive
stream against ``ek0_adaptive_fused_sample`` in interpret mode
(FitzHugh-Nagumo over (0, 2), 1024 members, 6 save intervals, q = 3,
abstol 1e-6, reltol 1e-4, max_iters 192, the setting of the JAX package's
own sampler test), the calibration of the port's samples, and the front
door ``sample_ensemble(adaptive=True)``. Inputs are made with numpy from a
seed and fed to both packages.

**Which normals both packages consume alike.** The JAX kernel indexes its
normals by the 1024-lane block's attempt row, the port by the member's
accepted step (`ek0_adaptive_sample` docstring), so the two consume the
same numbers only when the normals are constant along the row axis. One
JAX call holds two samples: sample 0 with zero normals, sample 1 with the
same numpy normals ``z0`` at every row.

**How closely the two can agree.** As in ``test_torch_ek0_adaptive.py``:
a few percent of the members take other step sequences in the two
packages from rounding alone, so ``failed`` is held on every member,
``nacc`` and ``nrej`` on all but 5%; on the members whose counts agree,
the zero-normal samples (the smoothed means) at the reference's own
sensitivity, and every finite member's to 1e-5 absolute. At this
setting's looser tolerances that sensitivity is wider than at the
adaptive EK0 file's abstol 1e-8: one rounding step of every dt0 moves the
JAX package's own smoothed means by up to 3.0e-8 relative on members whose
counts do not change (99th percentile 1.0e-11; measured on the CPU with
``ek0_adaptive_fused_smooth`` in interpret mode), so they are held to rtol
5e-8 / atol 1e-11, and to 1e-10 at the 99th percentile. With constant normals the
sample's deviation from its smoothed mean, ``x - m``, is a factor of the
smoothed covariance applied to the normals: it sits at the accuracy floor
of the stds, and the two packages form its factor differently (JAX:
Cholesky of the streamed plain covariance at ``log dt_cur``; the port:
Cholesky of its streamed factor's Gram at ``log dt_eff``, and
Gram-Schmidt of stacks built from a non-triangular factor), which changes
the result only by rounding. It is held, relative to the smoothed std at
each save point, at the stds standard of ``test_torch_ek0_adaptive.py``:
2e-3 at the 99th percentile and 5e-2 everywhere.
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
from odefilters_torch.ops import ek0_adaptive_sample as eas

Q, NQ, D = 3, 4, 2
TSPAN = (0.0, 2.0)
S = 6
B_JAX = 1024           # the JAX kernels' smallest ensemble (one block)
TOL = dict(abstol=1e-6, reltol=1e-4)
MAX_ITERS = 192


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


def _controller():
    return ea.controller(Q, *TSPAN, S, torch.float64, max_iters=MAX_ITERS,
                         **TOL)


def _port_stream(prob, m0, ps, dt0s):
    """The port's plain adaptive stream for numpy inputs: ``(m0, stream,
    counts)`` as tensors."""
    m0_t = torch.from_numpy(np.ascontiguousarray(m0))
    st, _, counts = ea.ek0_adaptive_stream_plain(
        prob.f, m0_t, torch.from_numpy(np.ascontiguousarray(ps.T)),
        torch.from_numpy(np.ascontiguousarray(dt0s)), _controller())
    return m0_t, st, counts


@pytest.fixture(scope="module")
def case():
    """One perturbed FHN ensemble through both packages with two samples:
    zero normals and numpy normals constant along the row axis."""
    jprob = odf.models.fitzhugh_nagumo(tspan=TSPAN)
    rng = np.random.default_rng(0)
    u0s = np.asarray(jprob.u0)[None] + 0.05 * rng.standard_normal((B_JAX, D))
    ps = np.broadcast_to(np.asarray(jprob.p), (B_JAX, 4)).copy()
    m0, dt0s = _jax_init(jprob, u0s, ps)
    z = np.zeros((MAX_ITERS, 2, NQ, D, B_JAX))
    z[:, 1] = rng.standard_normal((NQ, D, B_JAX))[None]
    with pltpu.force_tpu_interpret_mode():
        out = pk.ek0_adaptive_fused_sample(
            jprob.f, jnp.asarray(m0), jnp.asarray(ps.T), jnp.asarray(dt0s),
            jnp.asarray(z), *TSPAN, S, Q, max_iters=MAX_ITERS, **TOL)
    jax_out = [np.asarray(x) for x in out]
    prob = odt.models.fitzhugh_nagumo(device="cpu", tspan=TSPAN)
    m0_t, st, counts = _port_stream(prob, m0, ps, dt0s)
    c = _controller()
    x = eas.ek0_adaptive_sampler_plain(st, counts, m0_t, torch.from_numpy(z), c)
    us, stds = ea.ek0_adaptive_smoother_plain(st, counts, m0_t, c)
    return dict(jax=jax_out, x=_np(x), us=_np(us), stds=_np(stds),
                counts=_np(counts))


def _agree(case):
    """Members whose nacc and nrej agree in the two packages; ``failed``
    held on every member."""
    _, _, j_nacc, j_nrej, j_fail = case["jax"]
    nacc, nrej, failed = case["counts"][:3]
    assert (failed.astype(bool) == (j_fail > 0.5)).all() and not failed.any()
    same = (nacc == j_nacc) & (nrej == j_nrej)
    assert (~same).sum() <= 0.05 * len(same), int((~same).sum())
    return same


def test_zero_normals_give_the_smoothed_means_bit_for_bit(case):
    """Zero normals turn the port's sampler into its smoother's mean
    recursion, bit for bit: both samples (the second one's normals are not
    zero, so only the first is held)."""
    np.testing.assert_array_equal(case["x"][:, 0], case["us"])


def test_zero_normals_match_jax(case):
    """The zero-normal samples against the JAX kernel's, at the standard of
    the module docstring (measured: no member's counts differ; 2.0e-8
    relative at most, 9.4e-12 at the 99th percentile)."""
    same = _agree(case)
    got, ref = case["x"][:, 0], case["jax"][0][:, 0]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[..., same], ref[..., same], rtol=5e-8,
                               atol=1e-11)
    rel = (np.abs(got - ref) / (np.abs(ref) + 1e-11))[..., same]
    assert np.quantile(rel, 0.99) <= 1e-10
    fin = np.isfinite(ref).all(axis=(0, 1))
    assert np.abs(got - ref)[..., fin].max() <= 1e-5
    assert (got[0] == ref[0]).all()


def test_constant_normals_match_jax(case):
    """With the same normals at every row, each sample's deviation from its
    smoothed mean against the JAX kernel's, relative to the smoothed std,
    on the members whose counts agree (module docstring; measured: 99th
    percentile 1.8e-4, largest 3.2e-2)."""
    same = _agree(case)
    dev = case["x"][:, 1] - case["x"][:, 0]
    ref = case["jax"][0][:, 1] - case["jax"][0][:, 0]
    assert np.isfinite(dev).all()
    assert (dev[0] == 0).all() and (ref[0] == 0).all()
    rel = (np.abs(dev - ref)[1:] / case["stds"][1:, None])[..., same]
    assert np.quantile(rel, 0.99) <= 2e-3 and rel.max() <= 5e-2
    # the deviations are draws at the smoothed stds' scale, not rounding
    scale = np.abs(ref[1:])[..., same] / case["stds"][1:, None][..., same]
    assert np.median(scale) > 0.1


def test_calibration_on_identical_members():
    """1024 identical members: the cross-member spread of one sample at
    each save point against the smoothed std, at rtol 0.10 as the JAX
    package's own test holds it, and the empirical mean within 5 standard
    errors of the smoothed mean."""
    prob = odt.models.fitzhugh_nagumo(device="cpu", tspan=TSPAN)
    u0s = prob.u0[None].expand(B_JAX, D).contiguous()
    ps = prob.p[None].expand(B_JAX, 4).contiguous()
    m0, ps_t, dt0s = ea._init(prob.f, u0s, ps, TSPAN, Q, **TOL)
    c = _controller()
    st, _, counts = ea.ek0_adaptive_stream_plain(prob.f, m0, ps_t, dt0s, c)
    z = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (MAX_ITERS, 1, NQ, D, B_JAX)))
    x = _np(eas.ek0_adaptive_sampler_plain(st, counts, m0, z, c))[:, 0]
    us, stds = (_np(t) for t in ea.ek0_adaptive_smoother_plain(st, counts, m0,
                                                               c))
    assert not _np(counts[2]).any()
    spread = x[1:].std(axis=-1)                     # (S, d)
    np.testing.assert_allclose(spread, np.broadcast_to(stds[1:, :1],
                                                       spread.shape), rtol=0.10)
    se = stds[1:, None, 0] / np.sqrt(B_JAX)
    assert (np.abs(x[1:].mean(axis=-1) - us[1:, :, 0]) < 5 * se).all()


@pytest.mark.parametrize("n_samples", [1, 3])
def test_front_door_shapes(n_samples):
    """``sample_ensemble(EK0(), adaptive=True)``: ``n_steps`` save
    intervals, ``(n_steps+1, d, B)`` for one sample and ``(n_steps+1, S,
    d, B)`` for more; row 0 is the initial value; the zero-normal path of
    the same call is the smoothed solution of ``solve_ensemble``."""
    prob = odt.models.fitzhugh_nagumo(device="cpu", tspan=(0.0, 1.0))
    rng = np.random.default_rng(2)
    B = 5
    u0s = torch.from_numpy(_np(prob.u0)[None] + 0.05 * rng.standard_normal((B, D)))
    ps = prob.p[None].expand(B, 4).contiguous()
    kw = dict(abstol=1e-6, reltol=1e-4, max_iters=128)
    us = odt.sample_ensemble(prob, odt.EK0(order=Q), u0s, ps, n_steps=4,
                             n_samples=n_samples, adaptive=True,
                             generator=torch.Generator().manual_seed(0), **kw)
    want = (5, D, B) if n_samples == 1 else (5, n_samples, D, B)
    assert tuple(us.shape) == want and torch.isfinite(us).all()
    first = us[0] if n_samples == 1 else us[0, 0]
    torch.testing.assert_close(first, u0s.T, rtol=0, atol=0)
    m0, ps_t, dt0s = ea._init(prob.f, u0s, ps, prob.tspan, Q, 1e-6, 1e-4)
    zeros = torch.zeros((128, n_samples, NQ, D, B), dtype=torch.float64)
    x0 = eas.ek0_adaptive_fused_sample(prob.f, m0, ps_t, dt0s, zeros, 0.0,
                                       1.0, 4, Q, **kw)[0]
    sol = odt.solve_ensemble(prob, odt.EK0(order=Q), u0s, ps, n_save=4, **kw)
    assert torch.equal(x0[:, 0], sol.us)


@pytest.mark.parametrize(
    "alg, match",
    [(odt.EK1(order=Q), "EK0"), (odt.DiagonalEK1(order=Q), "DiagonalEK1"),
     (odt.EK0(order=Q, smooth=False), "non-smoothed"),
     (odt.EK0(order=Q, diffusionmodel="fixed"), "dynamic diffusion")],
    ids=["ek1", "diagonal_ek1", "not_smoothed", "static_diffusion"],
)
def test_front_door_raises(alg, match):
    """As in the JAX package: the adaptive sampler runs EK0 with the
    dynamic diffusion on a smoothed posterior."""
    prob = odt.models.fitzhugh_nagumo(device="cpu", tspan=(0.0, 1.0))
    u0s = prob.u0[None].expand(4, D).contiguous()
    ps = prob.p[None].expand(4, 4).contiguous()
    exc = ValueError if match == "non-smoothed" else NotImplementedError
    with pytest.raises(exc, match=match):
        odt.sample_ensemble(prob, alg, u0s, ps, n_steps=4, adaptive=True,
                            generator=torch.Generator())


def test_normals_shape_is_checked():
    prob = odt.models.fitzhugh_nagumo(device="cpu", tspan=(0.0, 1.0))
    u0s = prob.u0[None].expand(4, D).contiguous()
    ps = prob.p[None].expand(4, 4).contiguous()
    m0, ps_t, dt0s = ea._init(prob.f, u0s, ps, prob.tspan, Q, 1e-6, 1e-4)
    with pytest.raises(ValueError, match="normals must have shape"):
        eas.ek0_adaptive_fused_sample(
            prob.f, m0, ps_t, dt0s, torch.zeros((64, 1, NQ, D, 4)), 0.0, 1.0,
            4, Q, max_iters=128)
