"""The PyTorch port's fused EK0 joint-posterior sampler against the JAX
package, on the CPU in f64: the Gram-Schmidt factor and the Cholesky solve
against the JAX list helpers, the filter-states stream and the sampler
against the Pallas kernels in interpret mode (the sampler also on the JAX
filter's own stream), the zero-normals and calibration properties, the
front door and the conversions. Inputs and normals are made with numpy from
a seed and fed to both packages."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import odefilters as odf
import odefilters_torch as odt
from odefilters.ops import pallas_kernels as pk
from odefilters_torch import convert
from odefilters_torch.ops import ek0_pair as ep
from odefilters_torch.ops import ek0_sample as es

Q, NQ, D = 3, 4, 2
TSPAN = (0.0, 1.0)
N_STEPS = 12
B_JAX = 1024           # the JAX kernels' smallest ensemble (one block)
S_JAX = 2
V = NQ * D + NQ * NQ + 1


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _dt():
    return (TSPAN[1] - TSPAN[0]) / N_STEPS


def _consts(dt):
    At, _, QLt, p = ep.pair_constants(Q, dt)
    return At, QLt, p, float(1.0 / p[0])


def _stack(rng, n, tri):
    """A 2nq x nq stack of n random lanes as numpy (2nq, nq, n); with
    ``tri``, row nq + a is zero in the columns i < a, as in the filter's
    ``[(At L)^T; (sqrt(s2) QLt)^T]``."""
    M = rng.standard_normal((2 * NQ, NQ, n))
    if tri:
        for a in range(NQ):
            M[NQ + a, :a] = 0.0
    return M


def _blocks(arr, wrap, zero):
    return [[0.0 if zero(k, j) else wrap(arr[k, j]) for j in range(arr.shape[1])]
            for k in range(arr.shape[0])]


@pytest.mark.parametrize("tri", [True, False], ids=["filter_stack", "dense"])
def test_mgs_tril_matches_jax(tri):
    """`list_mgs_tril` == `_list_mgs_tril(rsqrt=False)` on 64 random lanes,
    with the filter stack's structural zeros as Python 0.0 in both."""
    rng = np.random.default_rng(0)
    M = _stack(rng, 64, tri)

    def zero(k, j):
        return tri and k >= NQ and j < k - NQ

    Lj = pk._list_mgs_tril(_blocks(M, jnp.asarray, zero), 2 * NQ, NQ)
    Lt = es.list_mgs_tril(_blocks(M, torch.from_numpy, zero), 2 * NQ, NQ)
    for i in range(NQ):
        for l in range(NQ):
            if l > i:
                assert not _np(Lt[i][l]).any()
            np.testing.assert_allclose(_np(Lt[i][l]), _np(Lj[i][l]), rtol=1e-12)
    # and it is a factor of M^T M
    L = np.stack([np.stack([_np(x) for x in row]) for row in Lt])
    np.testing.assert_allclose(np.einsum("ikn,jkn->ijn", L, L),
                               np.einsum("kin,kjn->ijn", M, M), rtol=1e-12,
                               atol=1e-12)


def test_cho_solve_matches_jax():
    """`list_cho_solve` == `_list_cho_solve` on a factor from
    `list_mgs_tril` and a random right-hand side."""
    rng = np.random.default_rng(1)
    M = _stack(rng, 64, True)
    b = rng.standard_normal((NQ, 64))
    L = es.list_mgs_tril(_blocks(M, torch.from_numpy, lambda k, j: False),
                         2 * NQ, NQ)
    Lnp = [[_np(x) for x in row] for row in L]
    xj = pk._list_cho_solve([[jnp.asarray(x) for x in row] for row in Lnp],
                            list(jnp.asarray(b)), NQ)
    xt = es.list_cho_solve(L, list(torch.from_numpy(b)), NQ)
    for i in range(NQ):
        np.testing.assert_allclose(_np(xt[i]), _np(xj[i]), rtol=1e-12)


@pytest.fixture(scope="module")
def sample_inputs():
    """Perturbed FHN ensemble: numpy u0s, ps, the JAX Taylor init m0 and
    standard normals (T+1, S, nq, d, B)."""
    import jax

    from odefilters.taylor import taylor_coefficients

    jprob = odf.models.fitzhugh_nagumo(tspan=TSPAN)
    rng = np.random.default_rng(0)
    u0s = np.asarray(jprob.u0)[None] + 0.05 * rng.standard_normal((B_JAX, D))
    ps = np.asarray(jprob.p)[None] * (1 + 0.02 * rng.standard_normal((B_JAX, 4)))
    m0 = jax.vmap(
        lambda u, p: jnp.stack(taylor_coefficients(jprob.f, u, p, 0.0, Q))
    )(jnp.asarray(u0s), jnp.asarray(ps)).transpose(1, 2, 0)
    z = rng.standard_normal((N_STEPS + 1, S_JAX, NQ, D, B_JAX))
    return jprob, np.asarray(m0), np.ascontiguousarray(ps.T), z


@pytest.fixture(scope="module")
def pallas_sample(sample_inputs):
    """The JAX sampler `pk.ek0_fused_sample` and the stream of its filter,
    `pk.ek0_filter_state_stream`, in Pallas interpret mode."""
    from jax.experimental.pallas import tpu as pltpu

    jprob, m0, ps, z = sample_inputs
    args = (jprob.f, jnp.asarray(m0), jnp.asarray(ps))
    with pltpu.force_tpu_interpret_mode():
        us = pk.ek0_fused_sample(*args, jnp.asarray(z), TSPAN[0], _dt(),
                                 N_STEPS, Q)
        st = pk.ek0_filter_state_stream(*args, TSPAN[0], _dt(), N_STEPS, Q)
    return np.asarray(us), np.asarray(st)


def _port_stream(sample_inputs):
    _, m0, ps, _ = sample_inputs
    return es.ek0_filter_state_stream(
        odt.models.library.fitzhugh_nagumo_f, torch.from_numpy(m0),
        torch.from_numpy(ps), TSPAN[0], _dt(), N_STEPS, Q)


def test_filter_state_stream_matches_jax(sample_inputs, pallas_sample):
    """The plain filter-states stream against the JAX stream. Means: each
    entry within 1e-10 of its row's largest |value| over (t, member) (the
    preconditioned derivative rows carry the innovation's rounding: the
    JAX CPU kernel contracts multiply-adds, measured 3.9e-11 on row
    m[3]), and the solution block m[0] entry by entry at rtol 1e-10. The
    factor and s2 carry the innovation too: they are held through the
    sampler (`test_sampler_on_jax_stream_matches_jax`)."""
    st = _port_stream(sample_inputs)
    ref = convert.state_stream_from_numpy(pallas_sample[1], nq=NQ, d=D,
                                          device="cpu")
    assert st.shape == ref.shape == (N_STEPS + 1, V, B_JAX)
    m, m_ref = _np(st[:, :NQ * D]), _np(ref[:, :NQ * D])
    scale = np.abs(m_ref).max(axis=(0, 2), keepdims=True)
    assert (np.abs(m - m_ref) <= 1e-10 * scale).all()
    np.testing.assert_allclose(m[:, :D], m_ref[:, :D], rtol=1e-10, atol=1e-12)
    # row 0: the exact initial state, L = 0, s2 = 1
    assert not _np(st[0, NQ * D:-1]).any() and (_np(st[0, -1]) == 1.0).all()
    assert (_np(st[1:, -1]) > 0).all()


def test_sampler_on_jax_stream_matches_jax(sample_inputs, pallas_sample):
    """The plain sampler on the JAX filter's own stream, with the same
    normals, against JAX's `ek0_fused_sample` at every (t, s, dim, member):
    measured 4.4e-16 absolute; held at rtol 1e-12, atol 1e-14 (the JAX
    package holds its kernel to a numpy replica at rtol 1e-7)."""
    _, _, _, z = sample_inputs
    st = convert.state_stream_from_numpy(pallas_sample[1], nq=NQ, d=D,
                                         device="cpu")
    At, QLt, _, pinv0 = _consts(_dt())
    us = es.ek0_sampler_plain(st, convert.normals_from_numpy(z, device="cpu"),
                              At=At, QLt=QLt, pinv0=pinv0, nq=NQ, d=D)
    assert us.shape == (N_STEPS + 1, S_JAX, D, B_JAX)
    np.testing.assert_allclose(_np(us), pallas_sample[0], rtol=1e-12,
                               atol=1e-14)


def test_fused_sample_matches_jax(sample_inputs, pallas_sample):
    """The whole plain sample (filter-states + sampler) against JAX's
    `ek0_fused_sample` on the same inputs and normals: measured 1.2e-14
    absolute, 8.7e-15 relative; held at rtol 1e-11, atol 1e-12."""
    _, m0, ps, z = sample_inputs
    us = es.ek0_fused_sample(
        odt.models.library.fitzhugh_nagumo_f, torch.from_numpy(m0),
        torch.from_numpy(ps), convert.normals_from_numpy(z, device="cpu"),
        TSPAN[0], _dt(), N_STEPS, Q)
    np.testing.assert_allclose(_np(us), pallas_sample[0], rtol=1e-11,
                               atol=1e-12)


def _fhn_ensemble(B, tspan, seed=3, spread=0.1):
    prob = odt.models.fitzhugh_nagumo(device="cpu", tspan=tspan)
    rng = np.random.default_rng(seed)
    u0s = prob.u0[None] + spread * torch.from_numpy(rng.standard_normal((B, D)))
    return prob, u0s, prob.p[None].expand(B, 4).contiguous()


def _taylor(prob, u0s, ps):
    from odefilters_torch.taylor import taylor_coefficients

    pt = ps.T.contiguous()
    return torch.stack(taylor_coefficients(prob.f, u0s.T.contiguous(), pt,
                                           prob.tspan[0], Q)), pt


def test_zero_normals_give_the_smoothed_means():
    """With zero normals the sampler is the RTS mean recursion: its path
    is the pair's smoothed mean (64 members, 60 steps at dt = 0.04). The
    two forwards differ (square-root vs collapsed plain covariance), so
    they agree to rounding: measured 4.2e-15; held at 10x, 4.2e-14."""
    T, dt = 60, 0.04
    prob, u0s, ps = _fhn_ensemble(64, (0.0, T * dt))
    m0, pt = _taylor(prob, u0s, ps)
    z = torch.zeros((T + 1, 1, NQ, D, 64), dtype=torch.float64)
    us = es.ek0_fused_sample(prob.f, m0, pt, z, 0.0, dt, T, Q)[:, 0]
    us_pair, _ = ep.ek0_fused_solve(prob.f, m0, pt, 0.0, dt, T, Q)
    assert float((us - us_pair).abs().max()) <= 4.2e-14


def test_samples_calibrated():
    """1024 joint samples of one posterior, carried as the plain sampler's
    sample axis (FHN, 40 steps over (0, 4)): at every (t, dim) the
    empirical mean lies within 5 standard errors of the pair's smoothed
    mean, and the empirical std within 0.2 of the smoothed std where it
    exceeds 1e-8 (the JAX package's own criteria)."""
    S, T = 1024, 40
    prob = odt.models.fitzhugh_nagumo(device="cpu", tspan=(0.0, 4.0))
    u0s, ps = prob.u0[None], prob.p[None]
    m0, pt = _taylor(prob, u0s, ps)
    dt = 4.0 / T
    rng = np.random.default_rng(4)
    z = torch.from_numpy(rng.standard_normal((T + 1, S, NQ, D, 1)))
    us = _np(es.ek0_fused_sample(prob.f, m0, pt, z, 0.0, dt, T, Q)[..., 0])
    us_s, stds_s = ep.ek0_fused_solve(prob.f, m0, pt, 0.0, dt, T, Q)
    mean_s, std_s = _np(us_s[:, :, 0]), _np(stds_s[:, 0])
    se = std_s[:, None] / np.sqrt(S)
    assert (np.abs(us.mean(axis=1) - mean_s) < 5.0 * se + 1e-12).all()
    mask = std_s > 1e-8
    ratio = us.std(axis=1)[mask] / std_s[mask, None]
    assert float(np.abs(ratio - 1.0).max()) < 0.2


def test_innovation_float32_rounds_the_exact_residual_once():
    """In float32 the residual ``pb h - du`` is the exact product less du,
    rounded once: where the rounded product equals du (the plain f32
    difference is 0) it keeps the sub-ulp remainder. In float64 it is the
    plain difference."""
    rng = np.random.default_rng(7)
    pb = float(1.0 / (0.04 ** -2.5))
    h = torch.from_numpy(rng.standard_normal(4096).astype(np.float32) * 1e3)
    du = (float(np.float32(pb)) * h).float()      # the rounded product
    z = es.innovation(pb, h, du)
    exact = np.float32(pb).astype(np.float64) * _np(h).astype(np.float64) - _np(du)
    np.testing.assert_array_equal(_np(z), exact.astype(np.float32))
    assert not _np(pb * h - du).any() and _np(z).any()
    h64 = h.double()
    assert torch.equal(es.innovation(pb, h64, du.double()), pb * h64 - du.double())


def test_float32_paths_hold_where_the_rounded_residual_cancels(monkeypatch):
    """Member 4675 of the headline ensemble (u0 + 0.1 N(0, 1), numpy seed
    0; FHN at dt = 0.04, Taylor init in f32), 220 steps: with the plain f32
    difference its filter-states stream hits s2 = 0 at step 218 and the f32
    paths with zero normals miss the f64 ones by far more than the
    headline's 1e-4 us criterion (measured 0.62); with the residual rounded
    once no step streams s2 = 0 and they stay within 1e-4 (measured
    5.5e-7)."""
    T, dt = 220, 20.0 / 500
    prob = odt.models.fitzhugh_nagumo(device="cpu", tspan=(0.0, 20.0))
    u0 = prob.u0 + 0.1 * torch.from_numpy(
        np.random.default_rng(0).standard_normal((8192, D))[4675])
    u0s, ps = u0[None], prob.p[None]
    m0, pt = _taylor(prob, u0s, ps)
    z = torch.zeros((T + 1, 1, NQ, D, 1), dtype=torch.float64)
    ref = es.ek0_fused_sample(prob.f, m0, pt, z, 0.0, dt, T, Q)
    m32, p32 = _taylor(prob, u0s.float(), ps.float())
    At, QLt, _, pinv0 = _consts(dt)

    def run():
        st = es.ek0_filter_state_stream(prob.f, m32, p32, 0.0, dt, T, Q)
        us = es.ek0_sampler(st, z.float(), At=At, QLt=QLt, pinv0=pinv0,
                            nq=NQ, d=D)
        return st[1:, -1], float((us.double() - ref).abs().max())

    s2, err = run()
    assert (s2 > 0).all() and err <= 1e-4
    monkeypatch.setattr(es, "innovation", lambda pb, h, du: pb * h - du)
    s2, err = run()
    assert (s2 == 0).any() and err > 1e-3


@pytest.mark.parametrize("n_samples", [1, 3])
def test_sample_ensemble_shapes(n_samples):
    B, T = 8, 10
    prob, u0s, ps = _fhn_ensemble(B, (0.0, 0.4))
    g = torch.Generator().manual_seed(0)
    us = odt.sample_ensemble(prob, odt.EK0(order=Q), u0s, ps, generator=g,
                             n_steps=T, n_samples=n_samples)
    want = (T + 1, D, B) if n_samples == 1 else (T + 1, n_samples, D, B)
    assert us.shape == want and torch.isfinite(us).all()


def test_sample_ensemble_seeded_generator_repeats():
    """The same generator seed gives the same paths; another seed does
    not; and the paths are `ek0_fused_sample` on ``torch.randn`` normals
    drawn from that generator."""
    prob, u0s, ps = _fhn_ensemble(8, (0.0, 0.4))
    alg, T = odt.EK0(order=Q), 10

    def draw(seed):
        return odt.sample_ensemble(prob, alg, u0s, ps, n_steps=T, n_samples=2,
                                   generator=torch.Generator().manual_seed(seed))

    a, b, c = draw(5), draw(5), draw(6)
    assert torch.equal(a, b) and not torch.equal(a, c)
    z = torch.randn((T + 1, 2, NQ, D, 8), generator=torch.Generator().manual_seed(5),
                    dtype=torch.float64)
    m0, pt = _taylor(prob, u0s, ps)
    assert torch.equal(a, es.ek0_fused_sample(prob.f, m0, pt, z, 0.0, 0.4 / T,
                                              T, Q))


def test_sample_ensemble_any_ensemble_size():
    B, T = 1000, 10
    prob, u0s, ps = _fhn_ensemble(B, (0.0, 0.4))
    us = odt.sample_ensemble(prob, odt.EK0(order=Q), u0s, ps, n_steps=T,
                             generator=torch.Generator().manual_seed(1))
    assert us.shape == (T + 1, D, B) and torch.isfinite(us).all()
    # at t0 the posterior is the exact initial value
    torch.testing.assert_close(us[0], u0s.T, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize(
    "alg, kwargs, exc, match",
    [
        (odt.EK0(order=Q), dict(mass=True), NotImplementedError, "mass"),
        (odt.EK0(order=Q, diffusionmodel="fixed"), {}, NotImplementedError,
         "dynamic diffusion"),
        (odt.DiagonalEK1(order=Q), {}, NotImplementedError, "DiagonalEK1"),
        (odt.EK0(order=Q, smooth=False), {}, ValueError, "non-smoothed"),
        # the adaptive sampler runs on the EK0 stream pair only, as in JAX
        (odt.EK1(order=Q), dict(adaptive=True), NotImplementedError, "EK0"),
        # EK1 samples on its own kernels; a non-IBM prior is not ported
        (odt.EK1(order=Q, prior="ioup"), {}, NotImplementedError, "IOUP"),
        (odt.EK0(order=Q, prior="ioup"), {}, NotImplementedError, "IOUP"),
        (odt.EK0(order=Q), dict(mesh=object()), NotImplementedError, "mesh"),
    ],
    ids=["mass_matrix", "static_diffusion", "diagonal_ek1", "not_smoothed",
         "adaptive", "ek1", "prior", "mesh"],
)
def test_sample_ensemble_raises(alg, kwargs, exc, match):
    prob, u0s, ps = _fhn_ensemble(4, (0.0, 0.4))
    if kwargs.pop("mass", False):
        # the port's problems refuse a mass matrix when built; the front
        # door checks any problem-like object as the JAX package does
        prob = types.SimpleNamespace(**dict(vars(prob),
                                            mass_matrix=torch.eye(D)))
    with pytest.raises(exc, match=match):
        odt.sample_ensemble(prob, alg, u0s, ps, n_steps=5,
                            generator=torch.Generator(), **kwargs)


def test_sample_ensemble_takes_the_jax_keywords():
    """``abstol``, ``reltol`` and ``max_iters`` of the JAX signature: the
    fixed grid does not use them (the same paths as without them), and with
    ``adaptive=True`` they set the adaptive sampler, whose ``n_steps`` save
    intervals give ``(n_steps+1, d, B)`` samples starting at the initial
    values."""
    prob, u0s, ps = _fhn_ensemble(4, (0.0, 0.4))
    kw = dict(abstol=1e-6, reltol=1e-3, max_iters=1024)
    a = odt.sample_ensemble(prob, odt.EK0(order=Q), u0s, ps, n_steps=5,
                            generator=torch.Generator().manual_seed(3), **kw)
    b = odt.sample_ensemble(prob, odt.EK0(order=Q), u0s, ps, n_steps=5,
                            generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    ada = odt.sample_ensemble(prob, odt.EK0(order=Q), u0s, ps, n_steps=5,
                              generator=torch.Generator().manual_seed(3),
                              adaptive=True, **kw)
    assert ada.shape == (6, D, 4) and torch.isfinite(ada).all()
    assert torch.equal(ada[0], u0s.T)


@pytest.mark.parametrize(
    "shape",
    [(6, 1, NQ, D, 4), (7, 1, NQ + 1, D, 4), (7, 1, NQ, D, 5), (7, NQ, D, 4)],
    ids=["steps", "order", "members", "no_sample_axis"],
)
def test_fused_sample_rejects_misshaped_normals(shape):
    prob, u0s, ps = _fhn_ensemble(4, (0.0, 0.24))
    m0, pt = _taylor(prob, u0s, ps)
    with pytest.raises(ValueError, match="normals must have shape"):
        es.ek0_fused_sample(prob.f, m0, pt, torch.zeros(shape, dtype=torch.float64),
                            0.0, 0.04, 6, Q)


@pytest.mark.parametrize(
    "kwargs", [dict(static_diff="fixed"), dict(second_order=True)],
    ids=["static_diffusion", "second_order"])
def test_filter_state_stream_unported_branches_raise(kwargs):
    prob, u0s, ps = _fhn_ensemble(4, (0.0, 0.2))
    m0, pt = _taylor(prob, u0s, ps)
    with pytest.raises(NotImplementedError):
        es.ek0_filter_state_stream(prob.f, m0, pt, 0.0, 0.04, 5, Q, **kwargs)


def _wrapper_args(device, B=8, T=5, S=3):
    rng = np.random.default_rng(5)
    At, QLt, p, pinv0 = _consts(0.04)
    kw = dict(At=At, QLt=QLt, pinv0=pinv0, pinv1=float(1 / p[1]), t0=0.0,
              dt=0.04, n_steps=T)
    m0 = torch.from_numpy(rng.standard_normal((NQ, D, B)) * 1e-3).to(device)
    ps = torch.tensor([0.7, 0.8, 1 / 12.5, 0.5], dtype=torch.float64)[:, None]
    ps = ps.expand(4, B).contiguous().to(device)
    z = torch.from_numpy(rng.standard_normal((T + 1, S, NQ, D, B))).to(device)
    return kw, m0, ps, z


def test_wrappers_reject_other_devices():
    kw, m0, ps, z = _wrapper_args("meta")
    before = (es.ek0_filter_states.launches, es.ek0_sampler.launches)
    f = odt.models.library.fitzhugh_nagumo_f
    with pytest.raises(ValueError, match="meta"):
        es.ek0_filter_states(f, "fhn", m0, ps, **kw)
    st = torch.zeros((kw["n_steps"] + 1, V, 8), dtype=torch.float64,
                     device="meta")
    with pytest.raises(ValueError, match="meta"):
        es.ek0_sampler(st, z, At=kw["At"], QLt=kw["QLt"], pinv0=kw["pinv0"],
                       nq=NQ, d=D)
    assert (es.ek0_filter_states.launches, es.ek0_sampler.launches) == before


def test_cpu_wrappers_run_the_plain_versions():
    kw, m0, ps, z = _wrapper_args("cpu")
    f = odt.models.library.fitzhugh_nagumo_f
    before = (es.ek0_filter_states.launches, es.ek0_sampler.launches)
    st = es.ek0_filter_states(f, "fhn", m0, ps, **kw)
    assert torch.equal(st, es.ek0_filter_states_plain(f, m0, ps, **kw))
    skw = dict(At=kw["At"], QLt=kw["QLt"], pinv0=kw["pinv0"], nq=NQ, d=D)
    assert torch.equal(es.ek0_sampler(st, z, **skw),
                       es.ek0_sampler_plain(st, z, **skw))
    # CPU tensors take the plain versions: no kernel launch is counted
    assert (es.ek0_filter_states.launches, es.ek0_sampler.launches) == before


def test_state_stream_from_numpy_reorders_the_jax_layout():
    """A synthetic (nb, T+1, nq, d+nq+1, 8, 128) stream whose entries name
    their (t, row, column, member) comes out as (T+1, V, B) rows
    [m (i*d + j) | L (i*nq + l) | s2 from row 0's last column]."""
    nb, T1, W = 2, 3, D + NQ + 1
    t, i, w, blk, sub, lane = np.meshgrid(
        np.arange(T1), np.arange(NQ), np.arange(W), np.arange(nb),
        np.arange(8), np.arange(128), indexing="ij")
    member = blk * 1024 + sub * 128 + lane
    code = ((t * 10 + i) * 10 + w) * 10000.0 + member     # (T1, nq, W, nb, 8, 128)
    st = code.transpose(3, 0, 1, 2, 4, 5)
    out = _np(convert.state_stream_from_numpy(st, nq=NQ, d=D, device="cpu"))
    assert out.shape == (T1, V, nb * 1024)
    b = np.arange(nb * 1024)
    for tt in range(T1):
        for ii in range(NQ):
            for j in range(D):
                np.testing.assert_array_equal(
                    out[tt, ii * D + j], ((tt * 10 + ii) * 10 + j) * 10000.0 + b)
            for l in range(NQ):
                np.testing.assert_array_equal(
                    out[tt, NQ * D + ii * NQ + l],
                    ((tt * 10 + ii) * 10 + D + l) * 10000.0 + b)
        np.testing.assert_array_equal(out[tt, -1],
                                      (tt * 100 + D + NQ) * 10000.0 + b)
    with pytest.raises(ValueError, match="stream"):
        convert.state_stream_from_numpy(st[:, :, :, :-1], nq=NQ, d=D,
                                        device="cpu")


def test_normals_from_numpy():
    z = np.asfortranarray(np.random.default_rng(6).standard_normal((3, 2, NQ, D, 5)))
    zt = convert.normals_from_numpy(z, device="cpu", dtype=torch.float32)
    assert zt.dtype == torch.float32 and zt.is_contiguous()
    np.testing.assert_array_equal(_np(zt), z.astype(np.float32))
    with pytest.raises(ValueError, match="normals"):
        convert.normals_from_numpy(z[0], device="cpu")


@pytest.mark.parametrize(
    "make",
    [lambda: convert.normals_from_numpy(np.zeros((2, 1, NQ, D, 3))),
     lambda: convert.state_stream_from_numpy(
         np.zeros((1, 2, NQ, D + NQ + 1, 8, 128)), nq=NQ, d=D)],
    ids=["normals_from_numpy", "state_stream_from_numpy"],
)
def test_convert_helpers_default_to_cuda(make):
    """With no device named the new helpers build on the CUDA card; without
    CUDA they raise instead of returning CPU tensors."""
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
