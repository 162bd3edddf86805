"""The PyTorch port's fused EK1 kernels against the JAX package, on the CPU
in f64: the EK1 step, the Cholesky and the Gram-Schmidt factors against the
JAX list helpers, the Jacobians, the filter, smoother and sampler against
the Pallas kernels in interpret mode (each alone on the JAX filter's own
stream, and end to end), a static diffusion, the zero-normals property, the
ensemble IEKS against the JAX fixed-grid IEKS, the front doors and the
conversions. Inputs and normals are made with numpy from a seed and fed to
both packages; the JAX calls are shared through module fixtures.

Tolerances are ~10x the differences measured on these inputs. The port's
plain versions follow the JAX bodies' order of operations; what remains is
rounding: XLA on the CPU contracts multiply-adds, and PyTorch's CPU square
root is not correctly rounded on about 1% of float64 inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import odefilters as odf
import odefilters_torch as odt
from odefilters.ops import pallas_kernels as pk
from odefilters_torch import convert
from odefilters_torch.models.library import fitzhugh_nagumo_f, fitzhugh_nagumo_jac
from odefilters_torch.ops import _launch
from odefilters_torch.ops import ek0_sample as es
from odefilters_torch.ops import ek1_fused as e1

Q, NQ, D = 3, 4, 2
N = NQ * D
TSPAN = (0.0, 1.0)
N_STEPS = 20
B_JAX = 1024           # the JAX kernels' smallest ensemble (one block)
S_JAX = 2


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _dt():
    return (TSPAN[1] - TSPAN[0]) / N_STEPS


@pytest.fixture(scope="module")
def inputs():
    """Perturbed FHN ensemble: u0 + 0.1 N(0, 1), p by 2%; the JAX Taylor
    init m0 (q+1, d, B), ps (n_params, B) and standard normals
    (T+1, S, D, B), all numpy."""
    from odefilters.taylor import taylor_coefficients

    jprob = odf.models.fitzhugh_nagumo(tspan=TSPAN)
    rng = np.random.default_rng(0)
    u0s = np.asarray(jprob.u0)[None] + 0.1 * rng.standard_normal((B_JAX, D))
    ps = np.asarray(jprob.p)[None] * (1 + 0.02 * rng.standard_normal((B_JAX, 4)))
    m0 = jax.vmap(
        lambda u, p: jnp.stack(taylor_coefficients(jprob.f, u, p, 0.0, Q))
    )(jnp.asarray(u0s), jnp.asarray(ps)).transpose(1, 2, 0)
    z = rng.standard_normal((N_STEPS + 1, S_JAX, N, B_JAX))
    return jprob, u0s, ps, np.asarray(m0), np.ascontiguousarray(ps.T), z


def _jax_args(inputs):
    jprob, _, _, m0, ps, _ = inputs
    return jprob.f, jprob.jac, jnp.asarray(m0), jnp.asarray(ps)


@pytest.fixture(scope="module")
def pallas_solve(inputs):
    """JAX `ek1_fused_solve(smooth=True, _debug=True)` in interpret mode:
    smoothed us, stds and the filter's stream, as numpy."""
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        out = pk.ek1_fused_solve(*_jax_args(inputs), TSPAN[0], _dt(), N_STEPS,
                                 Q, smooth=True, _debug=True)
    return tuple(np.asarray(x) for x in out)


@pytest.fixture(scope="module")
def pallas_static(inputs):
    """JAX `ek1_fused_solve(smooth=False, diffusion="fixedMAP")`."""
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        out = pk.ek1_fused_solve(*_jax_args(inputs), TSPAN[0], _dt(), N_STEPS,
                                 Q, smooth=False, diffusion="fixedMAP")
    return tuple(np.asarray(x) for x in out)


@pytest.fixture(scope="module")
def pallas_sample(inputs):
    """JAX `ek1_fused_sample` with the fixture's normals (S = 2)."""
    from jax.experimental.pallas import tpu as pltpu

    z = inputs[5]
    with pltpu.force_tpu_interpret_mode():
        us = pk.ek1_fused_sample(*_jax_args(inputs), jnp.asarray(z), TSPAN[0],
                                 _dt(), N_STEPS, Q)
    return np.asarray(us)


def _port(inputs):
    _, _, _, m0, ps, _ = inputs
    return (fitzhugh_nagumo_f, fitzhugh_nagumo_jac, torch.from_numpy(m0),
            torch.from_numpy(ps))


def _consts():
    return e1._consts(Q, _dt())


# ---------------------------------------------------------------- pieces


def _filtered_state(B=64, steps=3):
    """A filter-conditioned EK1 state (m, L) after ``steps`` steps of the
    port's plain filter from a perturbed FHN init, as numpy, with the
    ensemble's parameters: a fresh state's factor is exactly zero, and the
    step of a random one amplifies single-ulp differences."""
    from odefilters_torch.taylor import taylor_coefficients

    rng = np.random.default_rng(3)
    prob = odt.models.fitzhugh_nagumo(device="cpu", tspan=TSPAN)
    u0s = prob.u0[:, None] + 0.1 * torch.from_numpy(rng.standard_normal((D, B)))
    ps = prob.p[:, None] * (1 + 0.02 * torch.from_numpy(rng.standard_normal((4, B))))
    m0 = torch.stack(taylor_coefficients(prob.f, u0s, ps, 0.0, Q))
    At, QLt, p, pinv0, pinv1 = _consts()
    m0_p = torch.as_tensor(p)[:, None, None] * m0
    st = e1.ek1_filter_states_plain(prob.f, prob.jac, m0_p, ps, At=At, QLt=QLt,
                                    pinv0=pinv0, pinv1=pinv1, t0=0.0, dt=_dt(),
                                    n_steps=steps)
    lay = e1.stream_layout(NQ, D)
    return (_np(st[steps, lay["m"]]),
            _np(st[steps, lay["L"]]).reshape(N, N, B), _np(ps), rng)


@pytest.mark.parametrize(
    "static, lin, want_Lp",
    [(None, False, False), (None, False, True), (None, True, True),
     ("fixed", False, True), ("fixedMAP", False, False)],
    ids=["dynamic", "dynamic_Lp", "u_lin", "fixed", "fixedMAP"])
def test_ek1_step_matches_jax(static, lin, want_Lp):
    """`ek1_step` against `pk._ek1_step_lists` on the same filter-conditioned
    (B,) lanes: every output at rtol 1e-10 of its entry's largest |value|
    over the members (measured at most 1.4e-13)."""
    m, L, ps, rng = _filtered_state()
    B = m.shape[1]
    At, QLt, _, pinv0, pinv1 = _consts()
    t = 4 * _dt()
    u_lin = (np.array([-1.0, 1.0])[:, None]
             + 0.05 * rng.standard_normal((D, B))) if lin else None
    calib = (np.abs(rng.standard_normal(B)) + 0.5, np.full(B, 3.0))
    kw = dict(pinv0=pinv0, pinv1=pinv1, d=D, D=N, want_Lp=want_Lp,
              static_diff=static)
    jprob = odf.models.fitzhugh_nagumo(tspan=TSPAN)
    ref = pk._ek1_step_lists(
        [jnp.asarray(x) for x in m], [[jnp.asarray(x) for x in r] for r in L],
        jnp.asarray(ps), jnp.asarray(t), f=jprob.f, jac=jprob.jac,
        Af=np.kron(At, np.eye(D)), QLf=np.kron(QLt, np.eye(D)),
        u_lin=None if u_lin is None else jnp.asarray(u_lin),
        calib=tuple(jnp.asarray(c) for c in calib) if static else None, **kw)
    got = e1.ek1_step(
        [torch.from_numpy(x) for x in m],
        [[torch.from_numpy(x) for x in r] for r in L], torch.from_numpy(ps),
        torch.tensor(t, dtype=torch.float64), f=fitzhugh_nagumo_f,
        jac=fitzhugh_nagumo_jac, Af=e1.kron_lists(At, D),
        QLf=e1.kron_lists(QLt, D),
        u_lin=None if u_lin is None else torch.from_numpy(u_lin),
        calib=tuple(torch.from_numpy(c) for c in calib) if static else None,
        **kw)
    # JAX: (m, L, s2, ll[, Lp][, calib]); the port drops the unported ll
    ref = ref[:3] + ref[4:]
    assert len(got) == len(ref) == 3 + want_Lp + (static is not None)

    def flat(x):
        if isinstance(x, (list, tuple)):
            return [y for e in x for y in flat(e)]
        return [_np(x)]

    for g, r in zip(flat(got), flat(ref)):
        r = np.broadcast_to(r, g.shape)
        scale = max(float(np.abs(r).max()), 1e-300)
        assert np.abs(g - r).max() <= 1e-10 * scale


def test_list_chol_matches_jax():
    """`list_chol` == `_list_chol` on random symmetric positive definite
    2 x 2 and 8 x 8 lanes (measured 0 and 4.4e-16 relative)."""
    rng = np.random.default_rng(1)
    for n in (D, N):
        X = rng.standard_normal((n, n + 2, 64))
        C = np.einsum("ikb,jkb->ijb", X, X)
        Lj = pk._list_chol([[jnp.asarray(C[i, j]) for j in range(n)]
                            for i in range(n)], n)
        Lt = e1.list_chol([[torch.from_numpy(C[i, j]) for j in range(n)]
                           for i in range(n)], n)
        for i in range(n):
            for j in range(i + 1):
                np.testing.assert_allclose(_np(Lt[i][j]), _np(Lj[i][j]),
                                           rtol=1e-12)


def _kron_stack(rng, K, lanes):
    """A K x N stack of random lanes as numpy; for K = 2N the lower N rows
    have the structural zeros of the filter's ``(sqrt(s2) QLf)^T`` block
    (QLf = kron(QLt, I_d): row N + c is zero where QLf[r][c] is)."""
    M = rng.standard_normal((K, N, lanes))
    zero = np.zeros((K, N), bool)
    if K == 2 * N:
        for c in range(N):
            for r in range(N):
                zero[N + c, r] = not (r % D == c % D and r // D >= c // D)
    M[zero] = 0.0
    return M, zero


@pytest.mark.parametrize("K", [2 * N, 3 * N], ids=["filter_stack", "smoother_stack"])
def test_mgs_tril_matches_jax_at_ek1_shapes(K):
    """`list_mgs_tril` == `_list_mgs_tril` on the EK1 stacks (16 x 8 with
    the Kronecker zeros as Python 0.0, 24 x 8 dense), and it factors
    M^T M (measured 1.1e-15 relative)."""
    rng = np.random.default_rng(2)
    M, zero = _kron_stack(rng, K, 64)

    def blocks(wrap):
        return [[0.0 if zero[k, j] else wrap(M[k, j]) for j in range(N)]
                for k in range(K)]

    Lj = pk._list_mgs_tril(blocks(jnp.asarray), K, N)
    Lt = es.list_mgs_tril(blocks(torch.from_numpy), K, N)
    L = np.stack([np.stack([_np(x) for x in row]) for row in Lt])
    for i in range(N):
        for l in range(N):
            np.testing.assert_allclose(L[i, l], _np(Lj[i][l]), rtol=1e-12,
                                       atol=1e-14)
    np.testing.assert_allclose(np.einsum("ikn,jkn->ijn", L, L),
                               np.einsum("kin,kjn->ijn", M, M), rtol=1e-12,
                               atol=1e-12)


def test_fhn_jacobians_agree():
    """The analytic FHN Jacobian against the port's JVP columns and JAX's
    `_auto_jac` on random states and parameters, (d, d, B): equal to
    1e-15 (measured 0)."""
    rng = np.random.default_rng(4)
    u = rng.standard_normal((D, 32))
    p = np.array([0.7, 0.8, 1 / 12.5, 0.5])[:, None] * (1 + 0.1 * rng.standard_normal((4, 32)))
    ut, pt = torch.from_numpy(u), torch.from_numpy(p)
    J = _np(fitzhugh_nagumo_jac(ut, pt, 0.0))
    assert J.shape == (D, D, 32)
    np.testing.assert_allclose(_np(e1.auto_jac(fitzhugh_nagumo_f)(ut, pt, 0.0)),
                               J, rtol=1e-15, atol=1e-15)
    jprob = odf.models.fitzhugh_nagumo()
    Jj = pk._auto_jac(jprob.f)(jnp.asarray(u), jnp.asarray(p), 0.0)
    np.testing.assert_allclose(np.asarray(Jj), J, rtol=1e-15, atol=1e-15)
    prob = odt.models.fitzhugh_nagumo(device="cpu")
    assert prob.jac is fitzhugh_nagumo_jac and prob.field == "fhn"


# ------------------------------------------------- kernels against JAX


def test_fused_solve_matches_jax(inputs, pallas_solve):
    """The port's filter + smoother (`ek1_fused_solve`) against JAX's on the
    same inputs: means measured 2.0e-15 relative, held at rtol 2e-14; stds
    1.8e-3 relative, held at 2e-2. The smoothed stds are that sensitive to
    rounding in both packages (the JAX package holds its kernel against its
    own dense path at 1e-3): on the same stream the two smoothers already
    differ by 1.3e-3 (`test_smoother_on_jax_stream_matches_jax`), from
    XLA's contracted multiply-adds. Without ``jac`` the JVP columns give
    the same solution."""
    us, stds = e1.ek1_fused_solve(*_port(inputs), TSPAN[0], _dt(), N_STEPS, Q)
    assert us.shape == stds.shape == (N_STEPS + 1, D, B_JAX)
    np.testing.assert_allclose(_np(us), pallas_solve[0], rtol=2e-14, atol=1e-14)
    np.testing.assert_allclose(_np(stds), pallas_solve[1], rtol=2e-2, atol=1e-14)
    f, _, m0, ps = _port(inputs)
    us_a, _ = e1.ek1_fused_solve(f, None, m0[..., :8], ps[:, :8], TSPAN[0],
                                 _dt(), N_STEPS, Q)
    np.testing.assert_allclose(_np(us_a), _np(us[..., :8]), rtol=1e-13,
                               atol=1e-15)


def test_smoother_on_jax_stream_matches_jax(pallas_solve):
    """The plain smoother alone on the JAX filter's own stream: us equal
    (measured 0), held at rtol 1e-14; stds measured 1.3e-3 relative, held
    at 1.5e-2."""
    st = convert.ek1_stream_from_numpy(pallas_solve[2], nq=NQ, d=D, device="cpu")
    assert st.shape == (N_STEPS + 1, e1.stream_layout(NQ, D)["V"], B_JAX)
    At, QLt, _, pinv0, _ = _consts()
    us, stds = e1.ekd_smoother_plain(st, At=At, QLt=QLt, pinv0=pinv0, nq=NQ, d=D)
    np.testing.assert_allclose(_np(us), pallas_solve[0], rtol=1e-14, atol=1e-14)
    np.testing.assert_allclose(_np(stds), pallas_solve[1], rtol=1.5e-2, atol=1e-14)


def test_filter_stream_matches_jax(inputs, pallas_solve):
    """The plain filter's stream against the JAX stream: row 0 is the exact
    initial state; the solution means entry by entry at rtol 2e-14
    (measured 1.6e-15), every mean row within 1e-9 of its row's largest
    |value| (measured 1.1e-10: the derivative rows carry the innovation's
    rounding) and the filter stds within rtol 2e-8 (measured 1.9e-9). The
    filter-only solve's outputs are these means and stds."""
    At, QLt, p, pinv0, pinv1 = _consts()
    f, jac, m0, ps = _port(inputs)
    m0_p = torch.as_tensor(p)[:, None, None] * m0
    st = e1.ek1_filter_states_plain(f, jac, m0_p, ps, At=At, QLt=QLt,
                                    pinv0=pinv0, pinv1=pinv1, t0=TSPAN[0],
                                    dt=_dt(), n_steps=N_STEPS)
    ref = convert.ek1_stream_from_numpy(pallas_solve[2], nq=NQ, d=D, device="cpu")
    lay = e1.stream_layout(NQ, D)
    assert not _np(st[0, lay["L"]]).any() and (_np(st[0, lay["s2"]]) == 1).all()
    m, m_ref = _np(st[:, lay["m"]]), _np(ref[:, lay["m"]])
    np.testing.assert_allclose(m[:, :D], m_ref[:, :D], rtol=2e-14, atol=1e-14)
    scale = np.abs(m_ref).max(axis=(0, 2), keepdims=True)
    assert (np.abs(m - m_ref) <= 1e-9 * scale).all()

    def stds(s):
        L = _np(s[:, lay["L"]]).reshape(N_STEPS + 1, N, N, -1)[:, :D]
        return pinv0 * np.sqrt((L ** 2).sum(axis=2))

    np.testing.assert_allclose(stds(st), stds(ref), rtol=2e-8, atol=1e-14)
    uf, sf = e1.ek1_fused_solve(f, jac, m0, ps, TSPAN[0], _dt(), N_STEPS, Q,
                                smooth=False)
    np.testing.assert_allclose(_np(uf), pinv0 * m[:, :D], rtol=1e-15)
    np.testing.assert_allclose(_np(sf), stds(st), rtol=1e-14)


def test_static_filter_matches_jax(inputs, pallas_static):
    """fixedMAP, filter only: us, stds (exit-rescaled) and sigma^2 against
    JAX's; measured 8.0e-16, 1.6e-13 and 3.2e-13 relative, held at rtol
    1e-14, 2e-12, 3e-12."""
    us, stds, sig = e1.ek1_fused_solve(*_port(inputs), TSPAN[0], _dt(),
                                       N_STEPS, Q, smooth=False,
                                       diffusion="fixedMAP")
    assert sig.shape == (B_JAX,) and (sig > 0).all()
    np.testing.assert_allclose(_np(us), pallas_static[0], rtol=1e-14, atol=1e-14)
    np.testing.assert_allclose(_np(stds), pallas_static[1], rtol=2e-12, atol=1e-20)
    np.testing.assert_allclose(_np(sig), pallas_static[2], rtol=3e-12)


def test_sampler_on_jax_stream_matches_jax(inputs, pallas_sample, pallas_solve):
    """The plain sampler alone on the JAX filter's stream with the same
    normals (S = 2) against JAX's `ek1_fused_sample`: measured 1.1e-8
    absolute (the conditional factor has the smoothed stds' sensitivity to
    rounding, above); held at atol 1e-7."""
    st = convert.ek1_stream_from_numpy(pallas_solve[2], nq=NQ, d=D, device="cpu")
    At, QLt, _, pinv0, _ = _consts()
    us = e1.ekd_sampler_plain(st, convert.ek1_normals_from_numpy(inputs[5], device="cpu"),
                              At=At, QLt=QLt, pinv0=pinv0, nq=NQ, d=D)
    assert us.shape == (N_STEPS + 1, S_JAX, D, B_JAX)
    np.testing.assert_allclose(_np(us), pallas_sample, rtol=0, atol=1e-7)


def test_fused_sample_matches_jax(inputs, pallas_sample):
    """The whole plain sample (filter + sampler) against JAX's: measured
    9.7e-9 absolute; held at atol 1e-7."""
    us = e1.ek1_fused_sample(*_port(inputs),
                             convert.ek1_normals_from_numpy(inputs[5], device="cpu"),
                             TSPAN[0], _dt(), N_STEPS, Q)
    np.testing.assert_allclose(_np(us), pallas_sample, rtol=0, atol=1e-7)


def test_zero_normals_give_the_smoothed_means(inputs):
    """With zero normals the sampler is the smoother's mean recursion over
    the same stream: its path equals the smoothed means exactly (the JAX
    package holds its kernels so)."""
    f, jac, m0, ps = _port(inputs)
    m0, ps = m0[..., :16].contiguous(), ps[:, :16].contiguous()
    z = torch.zeros((N_STEPS + 1, 1, N, 16), dtype=torch.float64)
    us0 = e1.ek1_fused_sample(f, jac, m0, ps, z, TSPAN[0], _dt(), N_STEPS, Q)
    us, _ = e1.ek1_fused_solve(f, jac, m0, ps, TSPAN[0], _dt(), N_STEPS, Q)
    np.testing.assert_array_equal(_np(us0[:, 0]), _np(us))


def test_ieks_matches_jax_and_converges(inputs, monkeypatch):
    """`ieks_ensemble` on two members against the JAX fixed-grid IEKS
    (`solve_ieks_fixed`, 3 sweeps): means measured 1.3e-15, stds 1.9e-4
    relative; held at rtol 2e-14 / 2e-3 (the JAX package holds its kernel
    at 1e-8 / 1e-3). Each sweep linearizes at the previous sweep's smoothed
    means, and later sweeps change less."""
    from odefilters.ieks import solve_ieks_fixed
    from odefilters_torch import ensemble

    jprob, u0s_np, ps_np, _, _, _ = inputs
    idx = [0, 41]
    prob = odt.models.fitzhugh_nagumo(device="cpu", tspan=TSPAN)
    u0s, ps = torch.from_numpy(u0s_np[idx]), torch.from_numpy(ps_np[idx])
    sweeps, lins = [], []

    def solve(*args, linearize_traj=None, **kw):
        lins.append(linearize_traj)
        sweeps.append(e1.solve_ensemble_ek1(*args, linearize_traj=linearize_traj,
                                            **kw))
        return sweeps[-1]

    monkeypatch.setattr(ensemble, "solve_ensemble_ek1", solve)
    sol = odt.ieks_ensemble(prob, odt.IEKS(order=Q), u0s, ps, n_steps=N_STEPS,
                            iterations=4)
    assert len(sweeps) == 4 and lins[0] is None
    assert all(lin is us for lin, (us, _) in zip(lins[1:], sweeps))
    assert sol.us is sweeps[3][0] and sol.stds is sweeps[3][1]
    ts = jnp.linspace(*TSPAN, N_STEPS + 1)
    us3, stds3 = sweeps[2]
    for k, i in enumerate(idx):
        sx = solve_ieks_fixed(
            odf.remake(jprob, u0=jnp.asarray(u0s_np[i]), p=jnp.asarray(ps_np[i])),
            odf.IEKS(order=Q), ts=ts, iterations=3)
        np.testing.assert_allclose(_np(us3[:, :, k]), np.asarray(sx.u),
                                   rtol=2e-14, atol=1e-14)
        np.testing.assert_allclose(_np(stds3[1:, :, k]),
                                   np.asarray(sx.pu.std)[1:], rtol=2e-3,
                                   atol=1e-14)
    d12 = float((sweeps[1][0] - sweeps[0][0]).abs().max())
    d34 = float((sweeps[3][0] - sweeps[2][0]).abs().max())
    assert d34 < 0.1 * max(d12, 1e-12), (d12, d34)


# --------------------------------------------------------- front doors


def _fhn_ensemble(B, T, seed=5):
    prob = odt.models.fitzhugh_nagumo(device="cpu", tspan=(0.0, T * 0.04))
    rng = np.random.default_rng(seed)
    u0s = prob.u0[None] + 0.1 * torch.from_numpy(rng.standard_normal((B, D)))
    return prob, u0s, prob.p[None].expand(B, 4).contiguous()


@pytest.mark.parametrize(
    "smooth, model",
    [(True, "dynamic"), (False, "dynamic"), (False, "fixed"), (True, "fixedMAP")],
    ids=["smoother", "filter", "fixed_filter", "fixedMAP_smoother"])
def test_solve_ensemble_ek1(smooth, model):
    """The EK1 front door: per-dimension stds (T+1, d, B), no lls; sigma^2
    (B,) under a static model; any B. At t0 the filter's std is exactly 0
    and the smoother's below 1e-18 (its factor keeps rounding residue)."""
    B, T = 5, 8
    prob, u0s, ps = _fhn_ensemble(B, T)
    sol = odt.solve_ensemble(prob, odt.EK1(order=Q, smooth=smooth,
                                           diffusionmodel=model),
                             u0s, ps, n_save=T)
    assert sol.us.shape == sol.stds.shape == (T + 1, D, B)
    assert torch.isfinite(sol.us).all() and torch.isfinite(sol.stds).all()
    assert (sol.stds[0] <= (1e-18 if smooth else 0.0)).all()
    assert (sol.stds[1:] > 0).all()
    torch.testing.assert_close(sol.us[0], u0s.T, rtol=1e-12, atol=1e-12)
    assert sol.lls is None
    if model == "dynamic":
        assert sol.diffusions is None
    else:
        assert sol.diffusions.shape == (B,) and (sol.diffusions > 0).all()


@pytest.mark.parametrize("n_samples", [1, 3])
def test_sample_ensemble_ek1(n_samples):
    """The EK1 sampler's front door: shapes, and the same seed gives the
    `ek1_fused_sample` paths on ``torch.randn`` normals (T+1, S, D, B) from
    that generator."""
    B, T = 4, 6
    prob, u0s, ps = _fhn_ensemble(B, T)
    us = odt.sample_ensemble(prob, odt.EK1(order=Q), u0s, ps, n_steps=T,
                             n_samples=n_samples,
                             generator=torch.Generator().manual_seed(7))
    want = (T + 1, D, B) if n_samples == 1 else (T + 1, n_samples, D, B)
    assert us.shape == want and torch.isfinite(us).all()
    z = torch.randn((T + 1, n_samples, N, B), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(7))
    m0, pt = e1._taylor_init(prob.f, u0s, ps, 0.0, Q)
    ref = e1.ek1_fused_sample(prob.f, prob.jac, m0, pt, z, 0.0, 0.04, T, Q)
    assert torch.equal(us, ref[:, 0] if n_samples == 1 else ref)


class _DiagonalEK1(odt.EK1):
    is_diagonal_ek1 = True


@pytest.mark.parametrize(
    "call, alg, kwargs, exc, match",
    [
        ("solve", _DiagonalEK1(order=Q), {}, NotImplementedError, "DiagonalEK1"),
        ("solve", odt.EK1(order=Q, prior="ioup"), {}, NotImplementedError, "IOUP"),
        ("solve", odt.EK1(order=Q), dict(mesh=object()), NotImplementedError, "mesh"),
        ("solve", odt.EK1(order=Q), dict(adaptive=True), NotImplementedError,
         "adaptive"),
        ("sample", odt.EK1(order=Q, prior="ioup"), {}, NotImplementedError, "IOUP"),
        ("sample", odt.EK1(order=Q, diffusionmodel="fixed"), {},
         NotImplementedError, "dynamic diffusion"),
        ("ieks", odt.EK0(order=Q), {}, NotImplementedError, "EK1"),
        ("ieks", _DiagonalEK1(order=Q), {}, NotImplementedError, "EK1"),
        ("ieks", odt.IEKS(order=Q, diffusionmodel="fixed"), {},
         NotImplementedError, "dynamic"),
        ("ieks", odt.IEKS(order=Q, prior="ioup"), {}, NotImplementedError, "IOUP"),
    ],
    ids=["solve_diagonal_ek1", "solve_prior", "solve_mesh", "solve_adaptive",
         "sample_prior", "sample_static", "ieks_ek0", "ieks_diagonal_ek1",
         "ieks_static", "ieks_prior"],
)
def test_ek1_front_doors_raise(call, alg, kwargs, exc, match):
    prob, u0s, ps = _fhn_ensemble(4, 5)
    with pytest.raises(exc, match=match):
        if call == "solve":
            odt.solve_ensemble(prob, alg, u0s, ps, n_save=5, **kwargs)
        elif call == "sample":
            odt.sample_ensemble(prob, alg, u0s, ps, n_steps=5,
                                generator=torch.Generator(), **kwargs)
        else:
            odt.ieks_ensemble(prob, alg, u0s, ps, n_steps=5, iterations=2)


def test_ieks_config_validates():
    assert odt.IEKS().order == 1 and odt.IEKS().smooth and odt.IEKS().is_ek1
    with pytest.raises(ValueError, match="smooth"):
        odt.IEKS(smooth=False)
    with pytest.raises(ValueError, match="EK0"):
        odt.IEKS(diffusionmodel="fixedMV")


def test_fused_solve_unported_options_raise():
    m0 = torch.zeros((NQ, D, 4), dtype=torch.float64)
    ps = torch.zeros((4, 4), dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="fixed / fixedMAP"):
        e1.ek1_fused_solve(fitzhugh_nagumo_f, None, m0, ps, 0.0, 0.1, 5, Q,
                           diffusion="fixedMV")
    with pytest.raises(NotImplementedError, match="dynamic model"):
        e1.ek1_fused_solve(fitzhugh_nagumo_f, None, m0, ps, 0.0, 0.1, 5, Q,
                           diffusion="fixed",
                           linearize_traj=torch.zeros((6, D, 4), dtype=torch.float64))
    with pytest.raises(ValueError, match="normals must have shape"):
        e1.ek1_fused_sample(fitzhugh_nagumo_f, None, m0, ps,
                            torch.zeros((6, 1, NQ, D, 4), dtype=torch.float64),
                            0.0, 0.1, 5, Q)


def _wrapper_args(device, B=8, T=4, S=3):
    rng = np.random.default_rng(6)
    At, QLt, p, pinv0, pinv1 = e1._consts(Q, 0.04)
    kw = dict(At=At, QLt=QLt, pinv0=pinv0, pinv1=pinv1, t0=0.0, dt=0.04,
              n_steps=T)
    m0 = torch.from_numpy(rng.standard_normal((NQ, D, B)) * 1e-3).to(device)
    ps = torch.tensor([0.7, 0.8, 1 / 12.5, 0.5], dtype=torch.float64)[:, None]
    ps = ps.expand(4, B).contiguous().to(device)
    z = torch.from_numpy(rng.standard_normal((T + 1, S, N, B))).to(device)
    return kw, m0, ps, z


def _launches():
    return (e1.ek1_filter_states.launches, e1.ekd_smoother.launches,
            e1.ekd_sampler.launches)


def test_cpu_wrappers_run_the_plain_versions():
    kw, m0, ps, z = _wrapper_args("cpu")
    before = _launches()
    st = e1.ek1_filter_states(fitzhugh_nagumo_f, fitzhugh_nagumo_jac, "fhn",
                              m0, ps, **kw)
    assert torch.equal(st, e1.ek1_filter_states_plain(
        fitzhugh_nagumo_f, fitzhugh_nagumo_jac, m0, ps, **kw))
    skw = dict(At=kw["At"], QLt=kw["QLt"], pinv0=kw["pinv0"], nq=NQ, d=D)
    for a, b in zip(e1.ekd_smoother(st, **skw), e1.ekd_smoother_plain(st, **skw)):
        assert torch.equal(a, b)
    assert torch.equal(e1.ekd_sampler(st, z, **skw),
                       e1.ekd_sampler_plain(st, z, **skw))
    assert _launches() == before


def test_wrappers_reject_other_devices():
    kw, m0, ps, z = _wrapper_args("meta")
    before = _launches()
    with pytest.raises(ValueError, match="meta"):
        e1.ek1_filter_states(fitzhugh_nagumo_f, None, "fhn", m0, ps, **kw)
    st = torch.zeros((kw["n_steps"] + 1, e1.stream_layout(NQ, D)["V"], 8),
                     dtype=torch.float64, device="meta")
    skw = dict(At=kw["At"], QLt=kw["QLt"], pinv0=kw["pinv0"], nq=NQ, d=D)
    with pytest.raises(ValueError, match="meta"):
        e1.ekd_smoother(st, **skw)
    with pytest.raises(ValueError, match="meta"):
        e1.ekd_sampler(st, z, **skw)
    assert _launches() == before


@pytest.mark.parametrize("field", ["nojac", None], ids=["no_jacobian", "no_field"])
def test_kernel_path_needs_a_cuda_jacobian(monkeypatch, field):
    """On CUDA tensors the filter wrapper raises, before any launch, for a
    field whose CUDA functor has no Jacobian (or no field at all); the
    plain version would have derived one from JVP columns."""
    kw, m0, ps, _ = _wrapper_args("cpu")
    monkeypatch.setitem(_launch.CUDA_FIELDS, "nojac", (D, 4))
    monkeypatch.setattr(_launch, "dispatch_device", lambda name, t: "cuda")
    before = _launches()
    with pytest.raises(NotImplementedError, match="Jacobian" if field else "field"):
        e1.ek1_filter_states(fitzhugh_nagumo_f, None, field, m0, ps, **kw)
    assert _launches() == before


def test_stream_layout():
    lay = e1.stream_layout(NQ, D)
    assert lay["V"] == 109 and lay["s2"] == N + N * N
    assert (lay["m"].stop, lay["L"].start, lay["Lp"].start) == (N, N, lay["s2"] + 1)
    assert e1.stream_layout(NQ, D, smooth=False)["V"] == 73
    assert "Lp" not in e1.stream_layout(NQ, D, smooth=False)


@pytest.mark.parametrize("smooth", [True, False], ids=["with_Lp", "filter_only"])
def test_ek1_stream_from_numpy_reorders_the_jax_layout(smooth):
    """A synthetic (nb, T+1, D, W, 8, 128) stream whose entries name their
    (t, row, column, member) comes out as (T+1, V, B) rows [m (row r's
    column D) | L (r, c) | s2 (row 0's column D+1) | tril(Lp) (row r's
    column D+2+c, c <= r)]."""
    nb, T1 = 2, 2
    W = 2 * N + 2 if smooth else N + 2
    t, r, w, blk, sub, lane = np.meshgrid(
        np.arange(T1), np.arange(N), np.arange(W), np.arange(nb),
        np.arange(8), np.arange(128), indexing="ij")
    member = blk * 1024 + sub * 128 + lane
    code = ((t * 100 + r) * 100 + w) * 10000.0 + member
    out = _np(convert.ek1_stream_from_numpy(code.transpose(3, 0, 1, 2, 4, 5),
                                            nq=NQ, d=D, device="cpu"))
    lay = e1.stream_layout(NQ, D, smooth)
    assert out.shape == (T1, lay["V"], nb * 1024)
    b = np.arange(nb * 1024)

    def want(tt, rr, ww):
        return ((tt * 100 + rr) * 100 + ww) * 10000.0 + b

    for tt in range(T1):
        for rr in range(N):
            np.testing.assert_array_equal(out[tt, rr], want(tt, rr, N))
            for c in range(N):
                np.testing.assert_array_equal(out[tt, N + rr * N + c], want(tt, rr, c))
        np.testing.assert_array_equal(out[tt, lay["s2"]], want(tt, 0, N + 1))
        if smooth:
            idx = lay["Lp"].start
            for rr in range(N):
                for c in range(rr + 1):
                    np.testing.assert_array_equal(out[tt, idx], want(tt, rr, N + 2 + c))
                    idx += 1
    with pytest.raises(ValueError, match="EK1 stream"):
        convert.ek1_stream_from_numpy(np.zeros((1, 2, N, N + 1, 8, 128)), nq=NQ,
                                      d=D, device="cpu")


def test_ek1_normals_from_numpy():
    z = np.asfortranarray(np.random.default_rng(8).standard_normal((3, 2, N, 5)))
    zt = convert.ek1_normals_from_numpy(z, device="cpu", dtype=torch.float32)
    assert zt.dtype == torch.float32 and zt.is_contiguous()
    np.testing.assert_array_equal(_np(zt), z.astype(np.float32))
    with pytest.raises(ValueError, match="normals"):
        convert.ek1_normals_from_numpy(z[0], device="cpu")
