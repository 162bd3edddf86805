"""The time-parallel solves of the PyTorch port (``odefilters_torch/
parallel``, ``odefilters_torch/ops/tp_scan.py``) against the JAX package,
on the CPU in float64.

The JAX fused scan's kernels in interpret mode do not finish at the solver's
D = 8 on a CPU (D = 3 takes ~35 s at N = 40, D = 8 over 7 minutes), so
the scans are held at D = 8 against a sequential fold of the JAX package's
own jitted combines, ``r_k = combine(r_{k-1}, e_k)`` (reversed for the
smoother): the inclusive scan, up to reassociation, which the Pallas scan's
contract names (``pallas_scan.py``: exactly ``lax.associative_scan(combine,
elems)`` up to reassociation). One D = 2 case of each kind runs against
``pallas_associative_scan(..., interpret=True)``. The fused combines (the
kernels' plain versions) are held against the JAX list combines called
eagerly on ``(n,)`` arrays. The whole solve is held at its fixed point
against the port's sequential fixed-grid smoothers, which earlier test
files hold against the JAX package; the port's solve against the JAX
solve end to end is marked ``slow``. Factors compare as ``U U^T``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import odefilters as odf
import odefilters_torch as odt
from odefilters import linalg as jlinalg
from odefilters.parallel import associative as jassoc
from odefilters.parallel import associative_sqrt as jasq
from odefilters.parallel import pallas_scan as jps
from odefilters_torch import convert
from odefilters_torch import linalg as tlinalg
from odefilters_torch.ops import tp_scan as ts
from odefilters_torch.parallel import associative as pa
from odefilters_torch.parallel import associative_sqrt as asq
from odefilters_torch.parallel import blocked

D = 8
FAC = {"filter": (2, 4), "smooth": (2,)}


def _cov(x):
    x = np.asarray(x)
    return x @ np.swapaxes(x, -1, -2)


def _hold(got, ref, kind, rtol, atol):
    """Leaf by leaf, factors as covariances."""
    for i, (g, r) in enumerate(zip(got, ref)):
        g, r = np.asarray(g), np.asarray(r)
        if i in FAC[kind]:
            g, r = _cov(g), _cov(r)
        np.testing.assert_allclose(g, r, rtol=rtol, atol=atol,
                                   err_msg=f"leaf {i}")


def _elements(kind, n, seed, d=D):
    """Conditioned elements: transitions near 0.5 I, factors and vectors
    of scale 0.3, as the JAX package's scan test draws them."""
    rng = np.random.default_rng(seed)

    def mk(*s):
        return rng.standard_normal(s) * 0.3

    if kind == "filter":
        return (mk(n, d, d) + 0.5 * np.eye(d), mk(n, d), mk(n, d, d),
                mk(n, d), mk(n, d, d))
    return (mk(n, d, d) + 0.5 * np.eye(d), mk(n, d), mk(n, d, d))


def _solver_elements(N=24):
    """Rank-deficient filtering elements as the solver builds them: EK1 on
    FitzHugh-Nagumo linearized along a perturbed constant trajectory."""
    prob = odt.models.fitzhugh_nagumo(tspan=(0.0, 2.0), device="cpu")
    ts_ = torch.linspace(0.0, 2.0, N + 1, dtype=torch.float64)
    c = pa._setup(prob, odt.EK1(order=3), ts_)
    rng = np.random.default_rng(5)
    u_lin = prob.u0 + torch.tensor(rng.standard_normal((N, 2)) * 0.1)
    H, y = c.build_elements(u_lin, ts_[1:])
    return tuple(e.numpy() for e in asq.filter_elements(
        c.m0, torch.zeros((D, D), dtype=torch.float64), c.A, c.QL, H, y))


_JIT = {"filter": jax.jit(jasq._sqrt_filter_combine),
        "smooth": jax.jit(jasq._sqrt_smooth_combine)}
_TCOMB = {"filter": asq._sqrt_filter_combine,
          "smooth": asq._sqrt_smooth_combine}


def _jax_fold(kind, elems, reverse=False):
    """The inclusive scan as a sequential fold of the jitted JAX combine."""
    leaves = [np.asarray(e) for e in elems]
    N = leaves[0].shape[0]
    order = range(N - 1, -1, -1) if reverse else range(N)
    out = [None] * N
    acc = None
    for k in order:
        e = tuple(jnp.asarray(x[k]) for x in leaves)
        acc = e if acc is None else _JIT[kind](acc, e)
        out[k] = tuple(np.asarray(a) for a in acc)
    return tuple(np.stack([o[i] for o in out]) for i in range(len(leaves)))


# --------------------------------------------------------------------------
# linalg
# --------------------------------------------------------------------------


def test_linalg_pieces_match_jax():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((4, 2 * D, D))
    np.testing.assert_allclose(tlinalg.tril_factor_mgs(torch.tensor(X)),
                               jlinalg.tril_factor_mgs(jnp.asarray(X)),
                               rtol=1e-12, atol=1e-13)
    # a rank-deficient stack: the column left with rounding noise only
    # points anywhere in both packages, so the factors agree as L L^T
    Xr = X.copy()
    Xr[..., 3] = Xr[..., 1]
    np.testing.assert_allclose(_cov(tlinalg.tril_factor_mgs(torch.tensor(Xr))),
                               _cov(jlinalg.tril_factor_mgs(jnp.asarray(Xr))),
                               rtol=1e-12, atol=1e-12)
    L = np.tril(rng.standard_normal((4, D, D))) + 3 * np.eye(D)
    B = rng.standard_normal((4, D, 3))
    for lower, A in ((True, L), (False, np.swapaxes(L, -1, -2))):
        got = tlinalg.solve_triangular_unrolled(torch.tensor(A),
                                                torch.tensor(B), lower=lower)
        ref = jlinalg.solve_triangular_unrolled(jnp.asarray(A),
                                                jnp.asarray(B), lower=lower)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    a, b = rng.standard_normal((4, 3, D)), rng.standard_normal((1, D, D))
    np.testing.assert_array_equal(
        tlinalg.matmul_unrolled(torch.tensor(a), torch.tensor(b)).numpy(),
        np.asarray(jlinalg.matmul_unrolled(jnp.asarray(a), jnp.asarray(b))))
    M = rng.standard_normal((4, D, 5))
    S = M @ np.swapaxes(M, -1, -2)          # rank 5 of 8
    np.testing.assert_allclose(tlinalg.cholesky_psd(torch.tensor(S)),
                               jlinalg.cholesky_psd(jnp.asarray(S)),
                               rtol=1e-10, atol=1e-12)


def test_priors_and_jacobian_diagonal_match_jax():
    from odefilters import priors as jpriors
    from odefilters.jacobians import resolve_jac_diag as jresolve
    from odefilters_torch import priors as tpriors
    from odefilters_torch.jacobians import resolve_jac_diag

    A, QL = tpriors.transition_precond_full(None, 2, 3)
    jA, jQL = jpriors.transition_precond_full(jpriors.IWP(), 2, 3, 0.01)
    np.testing.assert_array_equal(A, np.asarray(jA))
    np.testing.assert_array_equal(QL, np.asarray(jQL))
    p, pinv = tpriors.precond_full(0.01, 2, 3)
    jp, jpinv = jpriors.precond_full(jnp.asarray(0.01), 2, 3)
    np.testing.assert_allclose(p, jp, rtol=1e-14)
    np.testing.assert_allclose(pinv, jpinv, rtol=1e-14)
    with pytest.raises(NotImplementedError, match="item 5"):
        tpriors.transition_precond_full(jpriors.IOUP(rate=1.0), 2, 3)
    prob = odt.models.fitzhugh_nagumo(device="cpu")
    jprob = odf.models.fitzhugh_nagumo()
    u = torch.tensor([0.3, -0.7], dtype=torch.float64)
    ref = jresolve(jprob.f, jprob.jac)(jnp.asarray(u.numpy()), jprob.p, 0.0)
    for jd in (resolve_jac_diag(prob.f, prob.jac),
               resolve_jac_diag(prob.f)):
        np.testing.assert_allclose(jd(u, prob.p, 0.0), ref, rtol=1e-15)


# --------------------------------------------------------------------------
# combines and element builders
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["filter", "smooth"])
def test_xla_form_combines_match_jax(kind):
    a, b = _elements(kind, 5, 1), _elements(kind, 5, 2)
    got = _TCOMB[kind](tuple(map(torch.tensor, a)), tuple(map(torch.tensor, b)))
    ref = _JIT[kind](tuple(map(jnp.asarray, a)), tuple(map(jnp.asarray, b)))
    _hold(got, ref, kind, rtol=1e-11, atol=1e-13)


def _as_lists(kind, elems):
    return tuple(
        [[jnp.asarray(e[:, i, j]) for j in range(D)] for i in range(D)]
        if k == "mat" else [jnp.asarray(e[:, i]) for i in range(D)]
        for k, e in zip(ts.KINDS[kind], elems))


def _from_lists(kind, out):
    return tuple(
        np.stack([np.stack([np.asarray(x[i][j]) for j in range(D)], -1)
                  for i in range(D)], -2)
        if k == "mat" else np.stack([np.asarray(x[i]) for i in range(D)], -1)
        for k, x in zip(ts.KINDS[kind], out))


@pytest.mark.parametrize("kind, case", [("filter", "conditioned"),
                                        ("smooth", "conditioned"),
                                        ("filter", "solver")])
def test_fused_combines_match_jax_list_combines(kind, case):
    """The kernels' plain combines against ``_filter_combine_lists`` /
    ``_smooth_combine_lists``, eager on (n,) arrays. The solver's elements
    are rank-deficient: both list combines floor the Gram-Schmidt pivots
    at sqrt(1e-30), so they agree with each other there, not with the XLA
    combine (1.2e-5 apart on the first two, the same in both packages)."""
    if case == "conditioned":
        a, b = _elements(kind, 4, 3), _elements(kind, 4, 4)
    else:
        e = _solver_elements()
        a, b = tuple(x[:4] for x in e), tuple(x[4:8] for x in e)
    fn = jps._filter_combine_lists if kind == "filter" else jps._smooth_combine_lists
    ref = _from_lists(kind, fn(_as_lists(kind, a), _as_lists(kind, b)))
    got = ts._COMBINES[kind](tuple(map(torch.tensor, a)),
                             tuple(map(torch.tensor, b)))
    _hold(got, ref, kind, rtol=1e-9, atol=1e-12)


def test_element_builders_match_jax():
    rng = np.random.default_rng(6)
    N, d = 12, 2
    from odefilters import priors as jpriors

    A, QL = jpriors.ibm(d, 3)
    F = np.broadcast_to(np.asarray(A), (N, D, D))
    Q = np.broadcast_to(np.asarray(QL), (N, D, D))
    H = rng.standard_normal((N, d, D))
    y = rng.standard_normal((N, d))
    # eager: a jit of these unrolled builders compiles for ~20 s on a CPU
    ref = jasq.sqrt_filter_elements_rest(F, Q, H, y)
    got = asq.sqrt_filter_elements_rest(*map(torch.tensor, (F, Q, H, y)))
    _hold(got, ref, "filter", rtol=1e-10, atol=1e-12)
    m0 = rng.standard_normal(D)
    U0 = np.tril(rng.standard_normal((D, D))) * 0.1
    ref = jasq.sqrt_filter_element_first(m0, U0, F[0], Q[0], H[0], y[0])
    got = asq.sqrt_filter_element_first(*map(torch.tensor, (
        m0, U0, F[0], Q[0], H[0], y[0])))
    _hold(got, ref, "filter", rtol=1e-10, atol=1e-12)

    # the smoother's elements: the JAX package builds them inside
    # parallel_smoother_sqrt; the same lines, jitted
    def jax_smoother_elements(ms, Us, F, QL):
        bmm, T = jlinalg.matmul_unrolled, lambda x: jnp.swapaxes(x, -1, -2)
        st = jlinalg.solve_triangular_unrolled
        F_, QL_, Uf = F[1:], QL[1:], Us[:-1]
        FUf = bmm(F_, Uf)
        U_pred = jlinalg.tril_factor_mgs(jnp.concatenate([T(FUf), T(QL_)], -2))
        Gt = st(T(U_pred), st(U_pred, T(bmm(Uf, T(FUf))), lower=True),
                lower=False)
        G = T(Gt)
        g = ms[:-1] - bmm(G, bmm(F_, ms[:-1][..., None]))[..., 0]
        P = jlinalg.tril_factor_mgs(jnp.concatenate(
            [T(bmm(jnp.eye(D) - bmm(G, F_), Uf)), T(bmm(G, QL_))], -2))
        return (jnp.concatenate([G, jnp.zeros((1, D, D))]),
                jnp.concatenate([g, ms[-1:]]), jnp.concatenate([P, Us[-1:]]))

    ms = rng.standard_normal((N, D))
    Us = np.tril(rng.standard_normal((N, D, D))) * 0.2
    ref = jax_smoother_elements(ms, Us, F, Q)
    got = asq.smoother_elements(torch.tensor(ms), torch.tensor(Us),
                                torch.tensor(np.asarray(A)),
                                torch.tensor(np.asarray(QL)))
    _hold(got, ref, "smooth", rtol=1e-10, atol=1e-12)


# --------------------------------------------------------------------------
# scans
# --------------------------------------------------------------------------


@pytest.mark.parametrize("N", [200, 1500])
@pytest.mark.parametrize("kind", ["filter", "smooth"])
def test_scans_match_jax_fold(kind, N):
    """The fused scan's plain versions (1024 chunks; N = 1500 pads and runs
    two chunk rows), the associative scan and the blocked scan, each against
    the fold of the jitted JAX combine; the smoother reversed."""
    rev = kind == "smooth"
    elems = _elements(kind, N, 10 + N)
    ref = _jax_fold(kind, elems, reverse=rev)
    tel = convert.scan_elements_from_numpy(elems, device="cpu")
    outs = [ts.fused_associative_scan(kind, tel, reverse=rev),
            blocked.blocked_associative_scan(_TCOMB[kind], tel, 64, reverse=rev)]
    if N == 200:
        outs.append(blocked.associative_scan(_TCOMB[kind], tel, reverse=rev))
    for got in outs:
        _hold(got, ref, kind, rtol=1e-9, atol=1e-12)


@pytest.fixture(scope="module")
def interpret_scans():
    """The JAX fused scan in interpret mode at D = 2, N = 40, both kinds."""
    out = {}
    for kind in ("filter", "smooth"):
        elems = _elements(kind, 40, 20, d=2)
        res = jps.pallas_associative_scan(
            kind, tuple(map(jnp.asarray, elems)), reverse=kind == "smooth",
            interpret=True)
        out[kind] = (elems, tuple(np.asarray(r) for r in res))
    return out


@pytest.mark.parametrize("kind", ["filter", "smooth"])
def test_fused_scan_matches_jax_interpret(kind, interpret_scans):
    elems, ref = interpret_scans[kind]
    got = ts.fused_associative_scan(
        kind, convert.scan_elements_from_numpy(elems, device="cpu"),
        reverse=kind == "smooth")
    _hold(got, ref, kind, rtol=1e-10, atol=1e-13)


def test_packing_round_trips_and_phases_compose():
    """pack / unpack invert each other with identity padding, and the three
    plain phases chained are the fused scan."""
    el = convert.scan_elements_from_numpy(_elements("smooth", 1100, 30),
                                          device="cpu")
    packed = ts.pack("smooth", el)
    assert tuple(packed.shape) == (2, ts.width("smooth", D), ts.NC)
    for a, b in zip(ts.unpack("smooth", packed, 1100), el):
        assert torch.equal(a, b)
    pad = ts.unpack("smooth", packed, 2048)[0][1100:]
    assert torch.equal(pad, torch.eye(D, dtype=pad.dtype).expand_as(pad))
    pre = ts.tp_chunk_scan("smooth", packed)
    out = ts.tp_fixup("smooth", pre, ts.tp_totals_scan("smooth", pre))
    for a, b in zip(ts.unpack("smooth", out, 1100),
                    ts.fused_associative_scan("smooth", el)):
        assert torch.equal(a, b)


def test_wrappers_dispatch_by_device():
    packed = torch.zeros((1, ts.width("smooth", D), ts.NC),
                         dtype=torch.float64, device="meta")
    for call in (lambda: ts.tp_chunk_scan("smooth", packed),
                 lambda: ts.tp_totals_scan("smooth", packed),
                 lambda: ts.tp_fixup("smooth", packed, packed[0])):
        with pytest.raises(ValueError, match="not supported"):
            call()
    with pytest.raises(ValueError, match="'filter' or 'smooth'"):
        ts.chunk_scan_plain("other", packed)


# --------------------------------------------------------------------------
# the solve
# --------------------------------------------------------------------------


def _sequential(prob, alg, n):
    sol = odt.solve_ensemble(prob, alg, prob.u0[None].clone(),
                             prob.p[None].clone(), n_save=n, adaptive=False)
    return sol.us[..., 0], float(sol.diffusions[0])


@pytest.fixture(scope="module")
def ek1_reference():
    prob = odt.models.fitzhugh_nagumo(tspan=(0.0, 2.0), device="cpu")
    return prob, _sequential(prob, odt.EK1(order=3, diffusionmodel="fixed"), 50)


@pytest.mark.parametrize("windows", [None, 5], ids=["global", "windows5"])
def test_ek1_fixed_point_matches_sequential(windows, ek1_reference):
    """The JAX package's cases (tests/test_parallel.py): EK1 on FHN (0, 2),
    dt = 0.04, 8 sweeps, global and in 5 windows, against the sequential
    fixed-grid EK1 smoother with the fixed diffusion: u rtol 1e-8, sigma2
    rtol 0.05."""
    prob, (u_ref, s2_ref) = ek1_reference
    u, u_std, means, covs, s2 = odt.solve_fixed_parallel(
        prob, odt.EK1(order=3), dt=0.04, iterations=8, windows=windows)
    assert u.shape == (51, 2) and covs.shape == (51, D, D)
    np.testing.assert_allclose(u, u_ref, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(float(s2), s2_ref, rtol=0.05)
    if windows is None:
        # the covariance form (its solves by LU) at the same fixed point
        u_c, std_c, *_ = odt.solve_fixed_parallel(
            prob, odt.EK1(order=3), dt=0.04, iterations=8, sqrt_form=False)
        np.testing.assert_allclose(u_c, u, rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(std_c, u_std, rtol=1e-6, atol=1e-12)


def test_windowed_ek0_matches_sequential():
    """EK0 on FHN (0, 5), dt = 0.04, 25 windows, 6 sweeps (the JAX
    package's case): u rtol 1e-4, sigma2 rtol 0.05 against the sequential
    EK0 smoother with the fixed diffusion."""
    prob = odt.models.fitzhugh_nagumo(tspan=(0.0, 5.0), device="cpu")
    u_ref, s2_ref = _sequential(prob, odt.EK0(order=3, diffusionmodel="fixed"),
                                125)
    u, _, _, _, s2 = odt.solve_fixed_parallel(
        prob, odt.EK0(order=3), dt=0.04, iterations=6, windows=25)
    np.testing.assert_allclose(u, u_ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(s2), s2_ref, rtol=0.05)


def test_scan_choices_agree():
    """block=None (the plain associative scan), a chunk length and 'fused'
    agree at reassociation level (2 sweeps from the same start: 'fused'
    would otherwise default to the warm start, as in the JAX package)."""
    prob = odt.models.fitzhugh_nagumo(tspan=(0.0, 1.0), device="cpu")
    outs = [odt.solve_fixed_parallel(prob, odt.EK1(order=3), dt=0.04,
                                     iterations=2, block=block, warm_start=0)
            for block in (None, 8, "fused")]
    # the fused combines floor the Gram-Schmidt pivots at sqrt(1e-30), as
    # the JAX kernels do: on the solver's rank-deficient factors the
    # covariances then differ from the XLA-form scans' by ~1e-5 relative
    # (test_fused_combines_match_jax_list_combines), the stds of this
    # unconverged 2-sweep solve by up to 2.8e-4, its sigma2 by 2.9e-5
    for out, std_rtol, s2_rtol in zip(outs[1:], (1e-6, 1e-3), (1e-8, 1e-4)):
        np.testing.assert_allclose(out[0], outs[0][0], rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(out[1], outs[0][1], rtol=std_rtol,
                                   atol=1e-12)
        np.testing.assert_allclose(float(out[4]), float(outs[0][4]),
                                   rtol=s2_rtol)


def test_warm_start_is_the_adaptive_single_solve_interpolated(monkeypatch):
    """The warm start: the adaptive single solve (held against the JAX
    kernels by tests/test_torch_ek1_adaptive.py) on ceil(N / 8) save
    intervals in float32, interpolated linearly onto the grid; non-finite
    or outsized entries fall back to u0."""
    from odefilters_torch.ops import ek1_adaptive

    prob = odt.models.fitzhugh_nagumo(tspan=(0.0, 2.0), device="cpu")
    ts_ = torch.linspace(0.0, 2.0, 51, dtype=torch.float64)
    got = pa.warm_start_trajectory(prob, ts_, 8, 3)
    us = odt.solve_adaptive_single(prob.f, prob.u0.float(), prob.p.float(),
                                   (0.0, 2.0), 7, q=3, abstol=1e-6,
                                   reltol=1e-3, field="fhn")[0].double()
    grid = np.linspace(0.0, 2.0, 8)
    ref = np.stack([np.interp(ts_[1:].numpy(), grid, us[:, i].numpy())
                    for i in range(2)], -1)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-14, atol=1e-15)
    assert float((got - torch.tensor(ref)).abs().max()) < 1e-6

    def poisoned(*args, **kw):
        us = torch.full((8, 2), 3.0e6, dtype=torch.float32)
        us[2, 1] = float("nan")
        return (us,)

    monkeypatch.setattr(ek1_adaptive, "solve_adaptive_single", poisoned)
    got = pa.warm_start_trajectory(prob, ts_, 8, 3)
    assert torch.equal(got, prob.u0.expand(50, 2))


def test_defaults_resolve_as_the_jax_package():
    prob = odt.models.fitzhugh_nagumo(device="cpu")
    EK0, EK1 = odt.EK0(order=3), odt.EK1(order=3)
    # on the CPU: the blocked scan at auto_block, warm start for EK0 and
    # DiagonalEK1 only; windowed: no warm start
    assert pa.resolve_options(prob, EK1, 16384) == (128, 0)
    assert pa.resolve_options(prob, EK0, 16384) == (128, 8)
    assert pa.resolve_options(prob, odt.DiagonalEK1(order=3), 100) == (None, 8)
    assert pa.resolve_options(prob, EK0, 16384, windows=16) == (None, 0)
    assert pa.resolve_options(prob, EK1, 100, block="fused") == ("fused", 8)


def test_card_fused_default_needs_the_kernels_state_dimension():
    """On the card the fused scan's kernels take D = d (q+1) up to 96: a
    default resolves to them at D = 6, 12 and 18 as at 8, and at D = 33, 34
    and 96 (a CTA per combine), and above 96 it raises at once, naming why;
    a block length, or a short grid, runs the blocked scan."""
    import types

    def card(d):
        return types.SimpleNamespace(
            d=d, u0=types.SimpleNamespace(device=torch.device("cuda", 0)))

    EK1 = odt.EK1(order=3)
    assert pa.resolve_options(card(2), EK1, 16384) == ("fused", 8)
    for prob, alg, kw in ((card(2), odt.EK1(order=2), {}),
                          (card(3), EK1, {}),
                          (card(3), EK1, {"block": "fused"}),
                          (card(3), odt.EK0(order=3), {"windows": 16}),
                          (card(3), odt.EK1(order=5), {}),
                          (card(3), odt.EK1(order=10), {}),
                          (card(3), odt.EK1(order=10), {"block": "fused"}),
                          (card(2), odt.EK0(order=16), {"windows": 16}),
                          (card(8), odt.EK1(order=11), {})):
        assert pa.resolve_options(prob, alg, 16384, **kw) == ("fused", 8)
    for prob, alg, kw in ((card(14), odt.EK1(order=6), {}),
                          (card(14), odt.EK1(order=6), {"block": "fused"}),
                          (card(49), odt.EK0(order=1), {"windows": 16})):
        with pytest.raises(NotImplementedError,
                           match="D = 98: 96 is the largest D .*held on the "
                                 "card"):
            pa.resolve_options(prob, alg, 16384, **kw)
    assert pa.resolve_options(card(14), odt.EK1(order=6), 16384,
                              block=128) == (128, 8)
    assert pa.resolve_options(card(14), odt.EK1(order=6), 1000)[0] == (
        blocked.auto_block(1000))


def test_argument_errors():
    from odefilters.priors import IOUP

    prob = odt.models.fitzhugh_nagumo(tspan=(0.0, 1.0), device="cpu")
    EK0 = odt.EK0(order=2)
    solve = odt.solve_fixed_parallel
    with pytest.raises(ValueError, match="must divide"):
        solve(prob, EK0, dt=0.02, windows=7)
    with pytest.raises(ValueError, match="square-root"):
        solve(prob, EK0, dt=0.02, windows=5, sqrt_form=False)
    with pytest.raises(NotImplementedError, match="item 11"):
        solve(prob, EK0, dt=0.02, time_shard_axis="time")
    with pytest.raises(ValueError, match="'fused'"):
        solve(prob, EK0, dt=0.02, block="pallas")
    with pytest.raises(ValueError, match="'fused'"):
        solve(prob, EK0, dt=0.02, block="pallas_interpret")
    with pytest.raises(ValueError, match="sqrt_form=True"):
        solve(prob, odt.EK1(order=2), dt=0.02, block="fused", sqrt_form=False)
    with pytest.raises(ValueError, match="uniform"):
        solve(prob, EK0, ts=np.array([0.0, 0.1, 0.3, 1.0]))
    with pytest.raises(ValueError, match="dt or ts"):
        solve(prob, EK0)
    with pytest.raises(ValueError, match="auto"):
        solve(prob, EK0, dt=0.02, taylor_method="jet")
    with pytest.raises(NotImplementedError, match="item 5"):
        solve(prob, odt.EK0(prior=IOUP(rate=1.0), order=2), dt=0.02)


def test_new_modules_import_no_jax():
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import sys, odefilters_torch.parallel.windowed, "
        "odefilters_torch.ops.tp_scan, odefilters_torch.jacobians, "
        "odefilters_torch.linalg; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'odefilters' or m.startswith('odefilters.')]; "
        "assert not bad, bad"
    )
    proc = subprocess.run([sys.executable, "-c", code],
                          cwd=Path(__file__).resolve().parents[1],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for make in (odt.models.fitzhugh_nagumo,
                 lambda: convert.scan_elements_from_numpy(
                     _elements("smooth", 3, 0)),
                 lambda: convert.trajectory_from_numpy(np.zeros((4, 2)))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


# --------------------------------------------------------------------------
# end to end against the JAX solve (slow: one JAX solve each, minutes)
# --------------------------------------------------------------------------


@pytest.mark.slow
@pytest.mark.parametrize("case", ["ek1", "ek0_windowed", "diagonal_ek1",
                                  "covariance"])
def test_solve_matches_jax_solve(case):
    """The port's solve against the JAX package's, both without a warm
    start (their CPU warm starts differ): u, u_std, the states, sigma2."""
    span, dt, iters, kw = (0.0, 2.0), 0.04, 4, {}
    alg = {"ek1": "EK1", "covariance": "EK1", "ek0_windowed": "EK0",
           "diagonal_ek1": "DiagonalEK1"}[case]
    if case == "ek0_windowed":
        kw = {"windows": 5}
    if case == "covariance":
        kw = {"sqrt_form": False}
    jprob = odf.models.fitzhugh_nagumo(tspan=span)
    ref = jassoc.solve_fixed_parallel(jprob, getattr(odf, alg)(order=3),
                                      dt=dt, iterations=iters, warm_start=0,
                                      **kw)
    prob = odt.models.fitzhugh_nagumo(tspan=span, device="cpu")
    got = odt.solve_fixed_parallel(prob, getattr(odt, alg)(order=3), dt=dt,
                                   iterations=iters, warm_start=0, **kw)
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-6, atol=1e-12)
    # the covariance form's general solves (LU) pivot differently in the
    # two packages: its states agree to 1.7e-8 relative
    np.testing.assert_allclose(got[2], ref[2],
                               rtol=1e-7 if case == "covariance" else 1e-8,
                               atol=1e-10)
    np.testing.assert_allclose(got[3], ref[3], rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(float(got[4]), float(ref[4]), rtol=1e-8)


# the float32 witness below: its means against JAX's float32 means (a
# 2-sweep solve's float32 rounding in two packages; 2.5e-4 measured at N =
# 16384, the f32 vs f64 limit on the card is 1e-3); at the float32 floor the
# two packages' sigma2 and largest std within this factor of each other
# (measured 1.03 and ~1.02 at N = 16384)
S32_U_ATOL, S32_FLOOR_FACTOR = 1e-3, 3.0


@pytest.mark.slow
@pytest.mark.parametrize("N", [512, 16384])
def test_float32_calibration_matches_jax_float32(N):
    """The float32 global EK1 solve's sigma2 and stds against the JAX
    package's float32 solve from the same linearization (the port's float32
    warm start; the blocked scan in both), FitzHugh-Nagumo over (0, 20), 2
    sweeps. At N = 512 both agree with float64; at N = 16384 the float32
    innovations sit at their rounding floor in both packages, and sigma2
    is ~1e6 times float64's in both (ROADMAP.md queue 3)."""
    alg, blk = odt.EK1(order=3), blocked.auto_block(N)
    out = {}
    for dtype in (torch.float64, torch.float32):
        prob = odt.models.fitzhugh_nagumo(tspan=(0.0, 20.0), device="cpu",
                                          dtype=dtype)
        ts_ = torch.linspace(0.0, 20.0, N + 1, dtype=dtype)
        u_init = pa.warm_start_trajectory(prob, ts_, 8, 3)
        out[dtype] = pa._solve_parallel_inner(prob, alg, ts_, 2, u_init, True,
                                              blk)
    f32 = jnp.float32
    jprob = odf.models.fitzhugh_nagumo(
        u0=jnp.array([-1.0, 1.0], f32),
        p=jnp.array([0.7, 0.8, 1 / 12.5, 0.5], f32), tspan=(0.0, 20.0))
    ref = jassoc._solve_parallel_jit(
        jprob, odf.EK1(order=3), jnp.asarray(ts_.numpy()), N, 2, "auto",
        jnp.asarray(u_init.numpy()), True, None, blk)
    assert ref[0].dtype == jnp.float32
    s64, s32, sj = (float(out[torch.float64][4]), float(out[torch.float32][4]),
                    float(ref[4]))
    std32, stdj = out[torch.float32][1].numpy(), np.asarray(ref[1])
    print(f"N={N}: sigma2 f64 {s64:.6e}, f32 {s32:.6e}, JAX f32 {sj:.6e}; "
          f"largest std f64 {float(out[torch.float64][1].max()):.3e}, f32 "
          f"{std32.max():.3e}, JAX f32 {stdj.max():.3e}")
    # the means: float32 rounding of a 2-sweep solve, both packages
    np.testing.assert_allclose(out[torch.float32][0].numpy(),
                               np.asarray(ref[0]), rtol=0, atol=S32_U_ATOL)
    if N == 512:
        # above the floor: sigma2 within 5 % of float64's in both packages
        # (the card's hold, chip_smoke.py TP_S2_RTOL)
        assert abs(s32 / s64 - 1) < 0.05 and abs(sj / s64 - 1) < 0.05
    else:
        # at the floor: both float32 sigma2 over 1e5 x float64's (~3e6
        # measured), within a factor S32_FLOOR_FACTOR of each other, and so
        # the stds
        assert s32 > 1e5 * s64 and sj > 1e5 * s64
        assert 1 / S32_FLOOR_FACTOR < s32 / sj < S32_FLOOR_FACTOR
        assert (1 / S32_FLOOR_FACTOR < std32.max() / stdj.max()
                < S32_FLOOR_FACTOR)


def test_ek1_torch_field_without_jacobian_starts_from_u0():
    """An EK1 solve of a field given without ``jac`` and without the warm
    start linearizes first at u0 broadcast over the grid, a view; the
    forward-mode Jacobian (`ek1_fused.auto_jac`) takes a contiguous copy of
    it, and the solve equals the one with the field's own Jacobian."""
    from odefilters_torch.models import library

    ref = odt.models.fitzhugh_nagumo(tspan=(0.0, 1.0), device="cpu")
    nojac = odt.ode_problem(library.fitzhugh_nagumo_f, ref.u0, ref.tspan,
                            ref.p, device="cpu")
    assert nojac.jac is None and ref.jac is not None
    ts_ = torch.linspace(0.0, 1.0, 17, dtype=torch.float64)
    got, want = (odt.solve_fixed_parallel(prob, odt.EK1(order=3), ts=ts_,
                                          warm_start=0, iterations=2)
                 for prob in (nojac, ref))
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-9, atol=1e-14)
