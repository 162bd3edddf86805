"""The Kron-grid PDE solves of the PyTorch port (``odefilters_torch/ops/
kron_grid.py``) against the JAX package, on the CPU in float64: the 2-D
Brusselator's grid field, its Jacobian diagonal and flat field, the EK0 and
DiagonalEK1 step bodies, the fixed-order grid sum, and both front doors
against the JAX Pallas kernels (interpret mode) and the XLA Kronecker path
``solve_fixed_kron``, fed the same Taylor init, at the tolerances of the JAX
package's own Kron-grid tests (N = 8, T = 20, save_every = 5)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import odefilters as odf
import odefilters_torch as odt
from odefilters.models import library as jlib
from odefilters.ops import pallas_kernels as pk
from odefilters_torch import convert
from odefilters_torch.models import library as tlib
from odefilters_torch.ops import kron_grid as kg

N, T, SE, Q = 8, 20, 5, 3
TSPAN = (0.0, 0.001)
DT = (TSPAN[1] - TSPAN[0]) / T
ALPHA = 0.1


def _grids(seed, n=N, m=N):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0.5, 3.0, (n, m)) for _ in range(2)]


def test_models_export_the_brusselator():
    assert (odt.models.BRUSSELATOR_A, odt.models.BRUSSELATOR_B) == (
        jlib.BRUSSELATOR_A, jlib.BRUSSELATOR_B)
    prob = odt.models.brusselator_2d(N=N, device="cpu")
    assert prob.field == "brusselator_2d" and prob.d == 2 * N * N
    assert float(prob.p) == 0.1 and prob.tspan == (0.0, 1.0)


@pytest.mark.parametrize("alpha", [None, ALPHA], ids=["p", "baked"])
def test_f_grids_and_jd_grids_match_jax(alpha):
    a, b = _grids(0)
    p = ALPHA
    ref = jlib.brusselator_2d_f_grids(N, alpha)([jnp.asarray(a),
                                                 jnp.asarray(b)], p, 0.0)
    got = tlib.brusselator_2d_f_grids(N, alpha)([torch.tensor(a),
                                                 torch.tensor(b)], p, 0.0)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-15,
                                   atol=1e-12)
    ref = jlib.brusselator_2d_jd_grids(N, alpha)([jnp.asarray(a),
                                                  jnp.asarray(b)], p, 0.0)
    got = tlib.brusselator_2d_jd_grids(N, alpha)([torch.tensor(a),
                                                  torch.tensor(b)], p, 0.0)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("edge", ["row0", "rowN", "col0", "colN", "corner"])
def test_periodic_stencil_at_the_edges(edge):
    """The Laplacian wraps at both edges of both axes: a bump at one edge
    point moves exactly the four periodic neighbours (and the point)."""
    i, j = {"row0": (0, 3), "rowN": (N - 1, 3), "col0": (4, 0),
            "colN": (4, N - 1), "corner": (N - 1, N - 1)}[edge]
    a, b = _grids(1)
    f = tlib.brusselator_2d_f_grids(N)
    base = f([torch.tensor(a), torch.tensor(b)], ALPHA, 0.0)
    a2 = a.copy()
    a2[i, j] += 1.0
    bumped = f([torch.tensor(a2), torch.tensor(b)], ALPHA, 0.0)
    moved = {(int(x), int(y)) for x, y in
             zip(*np.nonzero((bumped[0] - base[0]).numpy()))}
    assert moved == {(i, j), ((i - 1) % N, j), ((i + 1) % N, j),
                     (i, (j - 1) % N), (i, (j + 1) % N)}
    scale = (N - 1) ** 2
    for (x, y) in moved - {(i, j)}:
        np.testing.assert_allclose(float(bumped[0][x, y] - base[0][x, y]),
                                   ALPHA * scale, rtol=1e-9)
    # and the JAX field agrees at every edge row and column
    ref = jlib.brusselator_2d_f_grids(N)([jnp.asarray(a2), jnp.asarray(b)],
                                         ALPHA, 0.0)
    for g, r in zip(bumped, ref):
        r = np.asarray(r)
        for sl in (np.s_[0, :], np.s_[-1, :], np.s_[:, 0], np.s_[:, -1]):
            np.testing.assert_allclose(g.numpy()[sl], r[sl], rtol=1e-15,
                                       atol=1e-12)


def test_flat_field_matches_jax():
    ref = odf.models.brusselator_2d(N=N, tspan=TSPAN)
    prob = convert.problem_from_numpy("brusselator_2d", np.asarray(ref.u0),
                                      np.asarray(ref.p), ref.tspan,
                                      device="cpu")
    np.testing.assert_array_equal(prob.u0.numpy(), np.asarray(ref.u0))
    assert float(prob.p) == float(ref.p) and prob.field == "brusselator_2d"
    u = np.random.default_rng(2).uniform(0.5, 3.0, 2 * N * N)
    np.testing.assert_allclose(
        prob.f(torch.tensor(u), prob.p, 0.0).numpy(),
        np.asarray(ref.f(jnp.asarray(u), ref.p, 0.0)), rtol=1e-15, atol=1e-12)
    np.testing.assert_array_equal(
        prob.jac_diag(torch.tensor(u), prob.p, 0.0).numpy(),
        np.asarray(ref.jac_diag(jnp.asarray(u), ref.p, 0.0)))
    # the port's own initial state: the same grid, ** to the last bit or so
    np.testing.assert_allclose(
        odt.models.brusselator_2d(N=N, device="cpu").u0.numpy(),
        np.asarray(ref.u0), rtol=0, atol=1e-14)


@pytest.mark.parametrize("n", [1, 100, 128, 512, 1369, 4900])
def test_grid_sum_matches_sum(n):
    x = torch.tensor(np.random.default_rng(n).standard_normal(n))
    got = kg.grid_sum(x)
    assert got.ndim == 0
    np.testing.assert_allclose(float(got), float(x.sum()), rtol=1e-14,
                               atol=1e-14 * float(x.abs().sum()))


def _tree(vals):
    """The halving tree on Python floats: v[i] + v[i + w/2] until one."""
    while len(vals) > 1:
        w = len(vals) // 2
        vals = [vals[i] + vals[i + w] for i in range(w)]
    return vals[0]


@pytest.mark.parametrize("n", [1, 200, 5 * 128 + 7])
def test_grid_sum_order_is_the_halving_tree(n):
    """Blocks of KRON_BLOCK values, the tail zero-padded, each by the halving
    tree, then the partials zero-padded to a power of two by the same tree,
    on values spread over 16 decades (so the order shows in the bits)."""
    B = kg.KRON_BLOCK
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n) * 10.0 ** rng.integers(-8, 8, n)
    nb = -(-n // B)
    padded = list(x) + [0.0] * (nb * B - n)
    parts = [_tree(padded[k * B:(k + 1) * B]) for k in range(nb)]
    P = 1 << (nb - 1).bit_length()
    want = _tree(parts + [0.0] * (P - nb))
    assert float(kg.grid_sum(torch.tensor(x))) == want
    # the padding is exact: the same values filling their blocks sum alike
    y = torch.tensor(padded)
    assert float(kg.grid_sum(y)) == want


def _consts():
    At, Qt, p = kg.kron_constants(Q, DT, torch.float64)
    return At, Qt, float(1.0 / p[0]), float(1.0 / p[1]), p


def _jax_init():
    from odefilters.taylor import taylor_coefficients

    prob = odf.models.brusselator_2d(N=N, tspan=TSPAN)
    return np.asarray(jnp.stack(taylor_coefficients(prob.f, prob.u0, prob.p,
                                                    0.0, Q))
                      ).reshape(Q + 1, 2, N, N)


def _state(seed, ek1d):
    """A seeded step input: the Taylor init's preconditioned means with a
    small perturbation, and a seeded SPD covariance (shared, or per point)."""
    rng = np.random.default_rng(seed)
    p = _consts()[4]
    m = p[:, None, None, None] * _jax_init()
    m = m * (1 + 1e-3 * rng.standard_normal(m.shape))
    L = np.tril(rng.standard_normal((Q + 1, Q + 1))) * 0.1
    if not ek1d:
        return m, L @ L.T
    Ls = L[..., None, None, None] * (1 + 0.1 * rng.standard_normal(
        (Q + 1, Q + 1, 2, N, N)))
    return m, np.einsum("iksnm,lksnm->ilsnm", Ls, Ls)


@pytest.mark.parametrize("ek1d", [False, True], ids=["ek0", "ek1d"])
def test_step_bodies_match_jax(ek1d):
    m, C = _state(3, ek1d)
    At, Qt, pinv0, pinv1, _ = _consts()
    nq, ns, d = Q + 1, 2, 2 * N * N
    jm = [[jnp.asarray(m[i, s]) for s in range(ns)] for i in range(nq)]
    tm = [[torch.tensor(m[i, s]) for s in range(ns)] for i in range(nq)]
    kw = dict(pinv0=pinv0, pinv1=pinv1, d=d, ns=ns, nq=nq)
    t = DT
    if ek1d:
        jC = [[[jnp.asarray(C[i, l, s]) for s in range(ns)] for l in range(nq)]
              for i in range(nq)]
        tC = [[[torch.tensor(C[i, l, s]) for s in range(ns)]
               for l in range(nq)] for i in range(nq)]
        ref = pk._ek1d_kron_step_lists(
            jm, jC, jnp.asarray(t), f_grids=jlib.brusselator_2d_f_grids(N, ALPHA),
            jd_grids=jlib.brusselator_2d_jd_grids(N, ALPHA), p=None, At=At,
            Qt=Qt, **kw)
        got = kg.ek1d_kron_step(
            tm, tC, torch.tensor(t), f_grids=tlib.brusselator_2d_f_grids(N),
            jd_grids=tlib.brusselator_2d_jd_grids(N), p=ALPHA,
            At=At.tolist(), Qt=Qt.tolist(), **kw)
        pairs = [(i, l, s) for i in range(nq) for l in range(i, nq)
                 for s in range(ns)]
        c_got = [got[1][i][l][s] for i, l, s in pairs]
        c_ref = [ref[1][i][l][s] for i, l, s in pairs]
    else:
        jC = [[jnp.asarray(C[i, l]) for l in range(nq)] for i in range(nq)]
        tC = [[torch.tensor(C[i, l]) for l in range(nq)] for i in range(nq)]
        ref = pk._ek0_kron_step_lists(
            jm, jC, jnp.asarray(t), f_grids=jlib.brusselator_2d_f_grids(N, ALPHA),
            p=None, At=At, Qt=Qt, **kw)
        got = kg.ek0_kron_step(
            tm, tC, torch.tensor(t), f_grids=tlib.brusselator_2d_f_grids(N),
            p=ALPHA, At=At.tolist(), Qt=Qt.tolist(), **kw)
        c_got = [got[1][i][l] for i in range(nq) for l in range(nq)]
        c_ref = [ref[1][i][l] for i in range(nq) for l in range(nq)]
    for i in range(nq):
        for s in range(ns):
            np.testing.assert_allclose(got[0][i][s].numpy(),
                                       np.asarray(ref[0][i][s]), rtol=1e-12)
    for g, r in zip(c_got, c_ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12)
    np.testing.assert_allclose(float(got[2]), float(ref[2]), rtol=1e-12)


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's Taylor init at N = 8, and its interpret-mode Pallas
    kernels and XLA Kronecker solves from it."""
    from jax.experimental.pallas import tpu as pltpu

    from odefilters.kronsolve import solve_fixed_kron

    prob = odf.models.brusselator_2d(N=N, tspan=TSPAN)
    out = {"m0": _jax_init()}
    m0 = jnp.asarray(out["m0"])
    with pltpu.force_tpu_interpret_mode():
        out["ek0"] = pk.ek0_kron_grid_solve(
            jlib.brusselator_2d_f_grids(N, ALPHA), m0, None, 0.0, DT, T, Q,
            save_every=SE)
        out["ek1d"] = pk.ek1d_kron_grid_solve(
            jlib.brusselator_2d_f_grids(N, ALPHA),
            jlib.brusselator_2d_jd_grids(N, ALPHA), m0, None, 0.0, DT, T, Q,
            save_every=SE)
    out["kron_ek0"] = solve_fixed_kron(prob, odf.EK0(order=Q, smooth=False),
                                       dt=DT)
    out["kron_ek1d"] = solve_fixed_kron(
        prob, odf.DiagonalEK1(order=Q, smooth=False), dt=DT)
    return out


def _hold(got, ref_us, ref_std, ref_ll):
    us, var, ll = (x.numpy() for x in got)
    assert np.isfinite(us).all() and np.isfinite(var).all()
    for r in range(T // SE + 1):
        np.testing.assert_allclose(us[r].reshape(-1), ref_us[r], rtol=1e-9,
                                   atol=1e-12)
    # stds at ~1e-14 sit on the f64 roundoff floor of the variance
    np.testing.assert_allclose(var[1:].reshape(T // SE, -1) ** 0.5,
                               ref_std, rtol=1e-4)
    np.testing.assert_allclose(float(ll), ref_ll, rtol=1e-6)


def _solve(ek1d, m0):
    f_grids = tlib.brusselator_2d_f_grids(N)
    if ek1d:
        return kg.ek1d_kron_grid_solve(
            f_grids, tlib.brusselator_2d_jd_grids(N), m0, ALPHA, 0.0, DT, T,
            Q, save_every=SE, field="brusselator_2d")
    return kg.ek0_kron_grid_solve(f_grids, m0, ALPHA, 0.0, DT, T, Q,
                                  save_every=SE, field="brusselator_2d")


@pytest.mark.parametrize("ek1d", [False, True], ids=["ek0", "ek1d"])
def test_solve_matches_jax_kernel_on_the_same_init(jax_runs, ek1d):
    m0 = convert.grid_init_from_numpy(jax_runs["m0"], device="cpu")
    us, var, ll = jax_runs["ek1d" if ek1d else "ek0"]
    us = np.asarray(us).reshape(T // SE + 1, -1)
    std = np.asarray(var[1:]).reshape(T // SE, -1) ** 0.5
    _hold(_solve(ek1d, m0), us, std, float(ll))


@pytest.mark.parametrize("ek1d", [False, True], ids=["ek0", "ek1d"])
def test_solve_matches_kronsolve_on_the_same_init(jax_runs, ek1d):
    m0 = convert.grid_init_from_numpy(jax_runs["m0"], device="cpu")
    sk = jax_runs["kron_ek1d" if ek1d else "kron_ek0"]
    us = np.asarray(sk.u)[::SE]
    std = np.asarray(sk.u_std)[SE::SE]
    # EK0: one isotropic variance a row
    _hold(_solve(ek1d, m0), us, std if ek1d else std[:, :1],
          float(sk.log_likelihood))


@pytest.mark.parametrize("ek1d", [False, True], ids=["ek0", "ek1d"])
def test_front_doors_match_jax_doors(jax_runs, ek1d):
    """The doors make their own Taylor init (their u0 agrees with the JAX
    package's to ~1e-16); the outputs hold at the same tolerances."""
    door = odt.solve_brusselator_ek1d if ek1d else odt.solve_brusselator_ek0
    got = door(N, TSPAN, T, q=Q, save_every=SE, device="cpu")
    assert tuple(got[0].shape) == (T // SE + 1, 2, N, N)
    assert tuple(got[1].shape) == ((T // SE + 1, 2, N, N) if ek1d
                                   else (T // SE + 1,))
    assert got[0].dtype == torch.float64 and got[2].ndim == 0
    us, var, ll = jax_runs["ek1d" if ek1d else "ek0"]
    _hold(got, np.asarray(us).reshape(T // SE + 1, -1),
          np.asarray(var[1:]).reshape(T // SE, -1) ** 0.5, float(ll))


@pytest.mark.parametrize("ek1d", [False, True], ids=["ek0", "ek1d"])
def test_door_float32_casts_the_float64_init(ek1d):
    """dtype=float32 runs the solve in float32 from the float64 Taylor init
    cast once, as the JAX door does; its means stay close to float64's."""
    door = odt.solve_brusselator_ek1d if ek1d else odt.solve_brusselator_ek0
    us32, var32, ll32 = door(N, TSPAN, T, save_every=SE, dtype=torch.float32,
                             device="cpu")
    us64, _, _ = door(N, TSPAN, T, save_every=SE, device="cpu")
    assert us32.dtype == var32.dtype == ll32.dtype == torch.float32
    torch.testing.assert_close(
        kg.brusselator_init(N, TSPAN, dtype=torch.float32, device="cpu"),
        kg.brusselator_init(N, TSPAN, device="cpu").float(), rtol=0, atol=0)
    np.testing.assert_allclose(us32.double().numpy(), us64.numpy(),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("door", ["ek0", "ek1d"])
@pytest.mark.parametrize("bad, exc, match", [
    (dict(prior="ioup"), NotImplementedError, "item 5"),
    (dict(save_every=3), ValueError, "divide"),
    (dict(device="cuda"), RuntimeError, "device='cpu'"),
], ids=["prior", "save_every", "device"])
def test_doors_refuse(door, bad, exc, match):
    if bad.get("device") == "cuda" and torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    fn = odt.solve_brusselator_ek1d if door == "ek1d" else odt.solve_brusselator_ek0
    kw = dict(save_every=SE, device="cpu")
    kw.update(bad)
    with pytest.raises(exc, match=match):
        fn(N, TSPAN, T, **kw)


@pytest.mark.parametrize("ek1d", [False, True], ids=["ek0", "ek1d"])
def test_wrappers_dispatch_by_device(ek1d):
    """CPU tensors run the plain version (no launch counted); any device but
    'cpu' and 'cuda' raises without launching."""
    wrapper = kg.ek1d_kron_grid_solve if ek1d else kg.ek0_kron_grid_solve
    m0 = kg.brusselator_init(N, TSPAN, device="cpu")
    before = wrapper.launches
    got = _solve(ek1d, m0)
    At, Qt, pinv0, pinv1, p = _consts()
    m0_p = torch.tensor(p)[:, None, None, None] * m0
    kw = dict(At=At, Qt=Qt, pinv0=pinv0, pinv1=pinv1, t0=0.0, dt=DT,
              n_steps=T, save_every=SE)
    if ek1d:
        ref = kg.ek1d_kron_grid_solve_plain(
            tlib.brusselator_2d_f_grids(N), tlib.brusselator_2d_jd_grids(N),
            m0_p, ALPHA, **kw)
    else:
        ref = kg.ek0_kron_grid_solve_plain(tlib.brusselator_2d_f_grids(N),
                                           m0_p, ALPHA, **kw)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    with pytest.raises(ValueError, match="meta"):
        _solve(ek1d, m0.to("meta"))
    assert wrapper.launches == before


def test_grid_init_from_numpy_checks_shape():
    m0 = np.zeros((4, 2, 5, 6))
    t = convert.grid_init_from_numpy(m0, device="cpu", dtype=torch.float32)
    assert t.dtype == torch.float32 and tuple(t.shape) == (4, 2, 5, 6)
    with pytest.raises(ValueError, match="q\\+1, ns, N, M"):
        convert.grid_init_from_numpy(np.zeros((4, 50)), device="cpu")
