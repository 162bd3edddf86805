"""The PyTorch port's dense EK1 data likelihood (any observation matrix,
joint noisy square-root updates, per-member data, the stop-calibration
gradient) against the JAX package, on the CPU in f64: the EK1 step with
its log-likelihood increment and ``stop_calib``, the joint data update and
the MGS reverse that the CUDA adjoint runs, with their VJPs (eagerly, no
interpret mode); the front door ``ensemble_data_loglik(ek1=True)`` against
one interpret-mode call of the JAX gradient's forward (Lotka-Volterra,
1024 members, 40 steps over (0, 3), 3 observations on the grid of a dense
observation matrix with noise (0.1, 0.2), per-member data), the port's
plain adjoint on that call's stream, the front door's gradient against
the JAX kernel's own on the JAX package's test problem (logistic, q = 2,
16 steps: the JAX package's tests note that its d = 2 adjoint takes more
than an hour in interpret mode), and what the front door refuses.

Inputs are made with numpy from a seed and fed to both packages. The
tolerances are the JAX package's own tests' for this path
(tests/test_pallas_and_extras.py): values to rtol 1e-8, gradients to rtol
1e-6 / atol 1e-9; the step bodies to 1e-10 of their scale. The ODE
log-likelihood and the LV gradients are held against the ensemble's scale
(the largest |value| over the members), as the other data-likelihood test
files hold them.

About 70-85 s on one CPU worker (69 s and 83 s measured), ~40 s of it
two interpret-mode calls of the JAX kernels, each cached for the module,
and ~16 s the eager JAX step and update VJPs."""

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
from odefilters_torch.ops import ek0_pair as ep
from odefilters_torch.ops import ek0_sample as es
from odefilters_torch.ops import ek1_datalik as e1d
from odefilters_torch.ops import ek1_fused as e1

Q, NQ, D = 3, 4, 2
N = NQ * D
B_JAX = 1024           # the JAX kernels' smallest ensemble (one block)
T = 40
TSPAN = (0.0, 3.0)
DT = (TSPAN[1] - TSPAN[0]) / T
TS = np.array([8, 20, 32]) * DT
SEG = (8, 12, 12, 8)   # the steps between the observations of TS
# a shorter schedule for the plain versions' plumbing (they cost per step)
T_SHORT = 12
TS_SHORT = np.array([4, 8]) * (TSPAN[1] - TSPAN[0]) / T_SHORT
C_DENSE = np.array([[1.0, 0.0], [1.0, 1.0]])
R_VEC = np.array([0.1, 0.2])


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close_to_scale(got, ref, rtol, atol=0.0):
    """|got - ref| <= atol + rtol max |ref| over the members (axis 0)."""
    got, ref = _np(got), np.asarray(ref)
    scale = np.abs(ref).max(axis=0, keepdims=True)
    bad = np.abs(got - ref) > atol + rtol * scale
    worst = float((np.abs(got - ref) / scale).max())
    assert not bad.any(), (f"{int(bad.sum())} entries off; largest |diff| / "
                           f"scale {worst:.3e}")


def _group_close(got, ref, rtol):
    """Every leaf of ``got`` within ``rtol`` of the largest |value| of all
    the leaves of ``ref`` (one output: a mean, a factor, a cotangent)."""
    g = [np.broadcast_to(_np(x), np.shape(np.asarray(r)))
         for x, r in zip(jax.tree_util.tree_leaves(got),
                         jax.tree_util.tree_leaves(ref))]
    r = [np.asarray(x) for x in jax.tree_util.tree_leaves(ref)]
    assert len(g) == len(r)
    scale = max(float(np.abs(x).max()) for x in r)
    worst = max(float(np.abs(a - b).max()) for a, b in zip(g, r))
    assert worst <= rtol * scale, f"largest |diff| / scale {worst / scale:.3e}"


# ------------------------------------------------------- the step bodies


def _consts():
    At, _, QLt, p = ep.pair_constants(Q, DT)
    return At, QLt, p, float(1.0 / p[0]), float(1.0 / p[1])


@functools.cache
def _ek1_state(n=32):
    """An EK1 state reached by the port's plain step and data update from a
    perturbed LV ensemble (its factor has rank N - D after the step's R = 0
    update), as numpy ``(m (N, n), L (N, N, n), p (4, n))``."""
    from odefilters_torch.taylor import taylor_coefficients

    rng = np.random.default_rng(0)
    prob = odt.models.lotka_volterra(device="cpu")
    p = np.asarray(prob.p)[:, None] * rng.uniform(0.9, 1.1, (4, n))
    u0 = 1.0 + 0.05 * rng.standard_normal((D, n))
    At, QLt, pp, pinv0, pinv1 = _consts()
    m0 = torch.stack(taylor_coefficients(prob.f, _t(u0), _t(p), 0.0, Q))
    m = [float(pp[i // D]) * m0[i // D, i % D] for i in range(N)]
    zero = torch.zeros(n, dtype=torch.float64)
    L = [[zero] * N for _ in range(N)]
    kw = dict(f=prob.f, jac=prob.jac, Af=e1.kron_lists(At, D),
              QLf=e1.kron_lists(QLt, D), pinv0=pinv0, pinv1=pinv1, d=D, D=N)
    for k in range(6):
        m, L, _ = e1.ek1_step(m, L, _t(p), torch.tensor(DT * (k + 1)), **kw)
        if k == 3:
            m, L, _ = e1d.ek1_data_update(
                m, L, [_t(1.0 + 0.1 * rng.standard_normal(n))
                       for _ in range(2)],
                C_obs=C_DENSE, R_chol=np.diag(R_VEC), pinv0=pinv0, d=D, D=N)
    return (np.stack([_np(x) for x in m]),
            np.stack([np.stack([_np(x) for x in r]) for r in L]), p)


def _lists(wrap, m, L):
    return [wrap(x) for x in m], [[wrap(x) for x in r] for r in L]


@pytest.mark.parametrize("stop_calib", [False, True])
def test_ek1_step_and_its_vjp_match_jax(stop_calib):
    """`ek1_step(want_stats=True)` == `_ek1_step_lists(want_ll=True)` in
    value (1e-12 of each output's scale) and VJP (1e-10) on a
    filter-reached LV state, where J depends on u and p; ``stop_calib``
    leaves the values (and the default call's) bit for bit as they are and
    changes the VJP."""
    m, L, p = _ek1_state()
    n = m.shape[-1]
    At, QLt, _, pinv0, pinv1 = _consts()
    jprob = odf.models.lotka_volterra()
    tprob = odt.models.lotka_volterra(device="cpu")
    t = 0.6
    kw = dict(pinv0=pinv0, pinv1=pinv1, d=D, D=N)

    def jfun(m, L, p):
        return pk._ek1_step_lists(
            m, L, p, jnp.float64(t), f=jprob.f, jac=jprob.jac,
            Af=np.kron(At, np.eye(D)), QLf=np.kron(QLt, np.eye(D)),
            want_ll=True, stop_calib=stop_calib, **kw)

    def tfun(m, L, p, stop=stop_calib):
        m1, L1, s2, _, ll = e1.ek1_step(
            m, L, p, torch.tensor(t), f=tprob.f, jac=tprob.jac,
            Af=e1.kron_lists(At, D), QLf=e1.kron_lists(QLt, D),
            want_stats=True, stop_calib=stop, **kw)
        return m1, L1, s2, ll

    jout, jvjp = jax.vjp(jfun, *_lists(jnp.asarray, m, L), jnp.asarray(p))
    tin = (*_lists(_t, m, L), _t(p))
    tout, tvjp = torch.func.vjp(tfun, *tin)
    for g, r in zip(tout, jout):      # m, L, s2, ll
        _group_close(g, r, 1e-12)
    rng = np.random.default_rng(2)
    cm, cL, cl = (rng.standard_normal((N, n)), rng.standard_normal((N, N, n)),
                  rng.standard_normal(n))
    jg = jvjp((*_lists(jnp.asarray, cm, cL), jnp.zeros(n), jnp.asarray(cl)))
    tg = tvjp((*_lists(_t, cm, cL), torch.zeros(n, dtype=torch.float64),
               _t(cl)))
    for g, r in zip(tg, jg):          # m, L, p
        _group_close(g, r, 1e-10)
    other_out, other_vjp = torch.func.vjp(
        functools.partial(tfun, stop=not stop_calib), *tin)
    default = e1.ek1_step(*tin, torch.tensor(t), f=tprob.f, jac=tprob.jac,
                          Af=e1.kron_lists(At, D), QLf=e1.kron_lists(QLt, D),
                          **kw)
    for a, b in zip(jax.tree_util.tree_leaves(other_out),
                    jax.tree_util.tree_leaves(tout)):
        assert torch.equal(a, b)
    for a, b in zip(jax.tree_util.tree_leaves(default),
                    jax.tree_util.tree_leaves(tout[:3])):
        assert torch.equal(a, b)
    other = other_vjp((*_lists(_t, cm, cL),
                       torch.zeros(n, dtype=torch.float64), _t(cl)))
    assert not np.allclose(_np(other[2]), _np(tg[2]), rtol=1e-6)


# observation models: (C, R_chol, per-member observations): the dense C with
# noise (0.1, 0.2); d_obs = 1 with a scale != 1; d_obs = 3 > d with a full
# lower noise factor (a transposed R shows)
UPDATES = {
    "dense": (C_DENSE, np.diag(R_VEC), True),
    "scaled_row": (np.array([[2.0, 0.0]]), np.array([[0.1]]), False),
    "three_rows_lower_R": (np.array([[1.0, 0.0], [0.0, 1.0], [1.0, -1.0]]),
                           np.array([[0.1, 0.0, 0.0], [0.05, 0.2, 0.0],
                                     [-0.03, 0.02, 0.3]]), True),
}


@pytest.mark.parametrize("case", UPDATES)
def test_data_update_and_its_vjp_match_jax(case):
    """`ek1_data_update` == `_ek1_data_update_lists` in value (1e-12 of each
    output's scale, on the filter-reached state) and VJP (1e-10, on a
    state with a full-rank factor: on the filter-reached one the factor's
    cotangent runs through MGS pivots at rounding level and carries that
    noise, 5e-5 of its scale between the two packages, which the step
    before the update projects out; the sweep's composed step is held in
    the front-door tests); the inputs are left as they are."""
    C, R, per_member = UPDATES[case]
    m, L, _ = _ek1_state()
    n = m.shape[-1]
    pinv0 = _consts()[3]
    rng = np.random.default_rng(4)
    L_full = 0.3 * np.tril(rng.standard_normal((n, N, N))).transpose(1, 2, 0)
    y = 1.0 + 0.1 * rng.standard_normal((C.shape[0], n))
    if not per_member:
        y = y[:, 0]
    ukw = dict(C_obs=C, R_chol=R, pinv0=pinv0, d=D, D=N)
    jy, ty = [jnp.asarray(v) for v in y], [_t(v) for v in y]
    # values on the filter-reached state
    jout = pk._ek1_data_update_lists(*_lists(jnp.asarray, m, L), jy, **ukw)
    tm, tL = _lists(_t, m, L)
    before = ([x for x in tm], [list(r) for r in tL])
    tout = e1d.ek1_data_update(tm, tL, ty, **ukw)
    assert all(a is b for a, b in zip(tm, before[0]))
    assert all(a is b for ra, rb in zip(tL, before[1]) for a, b in zip(ra, rb))
    for g, r in zip(tout, jout):        # m, L, dll
        _group_close(g, r, 1e-12)
    # values and VJP on the full-rank state
    jout, jvjp = jax.vjp(
        lambda m, L, y: pk._ek1_data_update_lists(m, L, y, **ukw),
        *_lists(jnp.asarray, m, L_full), jy)
    tout, tvjp = torch.func.vjp(
        lambda m, L, y: e1d.ek1_data_update(m, L, y, **ukw),
        *_lists(_t, m, L_full), ty)
    for g, r in zip(tout, jout):
        _group_close(g, r, 1e-12)
    cm, cL, cd = (rng.standard_normal((N, n)), rng.standard_normal((N, N, n)),
                  rng.standard_normal(n))
    jg = jvjp((*_lists(jnp.asarray, cm, cL), jnp.asarray(cd)))
    tg = tvjp((*_lists(_t, cm, cL), _t(cd)))
    for g, r in zip(tg, jg):            # m, L, y
        _group_close(g, r, 1e-10)


@functools.cache
def _stacks():
    """The MGS stacks of the adjoint as numpy ``(K, N, n)`` with a mask of
    the structural zeros: the prediction's ``[(A L)^T; (sq QLf)^T]`` (the
    Kronecker zeros of QLf structural), and the data update's ``[L - K Z |
    K R]^T`` at the filter-reached state (singular: rank N - D) and at a
    full-rank factor."""
    m, L, _ = _ek1_state()
    n = m.shape[-1]
    At, QLt, _, pinv0, _ = _consts()
    Af, QLf = np.kron(At, np.eye(D)), np.kron(QLt, np.eye(D))
    AL = np.einsum("rc,ckn->rkn", Af, L)
    pred = np.concatenate([AL.transpose(1, 0, 2), 0.3 * np.broadcast_to(
        QLf.T[:, :, None], (N, N, n))])
    zero = np.zeros((2 * N, N), bool)
    zero[N:] = QLf.T == 0.0
    rng = np.random.default_rng(5)
    L_full = 0.3 * np.tril(rng.standard_normal((n, N, N))).transpose(1, 2, 0)
    out = {"predict": (pred, zero)}
    for name, state in (("update_singular", L), ("update_full_rank", L_full)):
        captured = {}

        def capture(rows, K, nq):
            captured["rows"] = rows
            return es.list_mgs_tril(rows, K, nq)

        orig = e1d.list_mgs_tril
        e1d.list_mgs_tril = capture
        try:
            e1d.ek1_data_update(
                *_lists(_t, m, state), [_t(1.0 + 0.1 * rng.standard_normal(n))
                                        for _ in range(2)],
                C_obs=C_DENSE, R_chol=np.diag(R_VEC), pinv0=pinv0, d=D, D=N)
        finally:
            e1d.list_mgs_tril = orig
        rows = np.stack([np.stack([_np(x) for x in r])
                         for r in captured["rows"]])
        out[name] = (rows, np.zeros(rows.shape[:2], bool))
    return out


@pytest.mark.parametrize("stack", ["predict", "update_singular",
                                   "update_full_rank"])
def test_mgs_reverse_matches_both_vjps(stack):
    """`mgs_tril_vjp` (the CUDA adjoint's MGS reverse, transcribed) against
    ``torch.func.vjp`` of `list_mgs_tril` (1e-12 of the cotangent's scale;
    measured 4e-16) and ``jax.vjp`` of ``_list_mgs_tril`` (1e-12 where the
    stack has full rank; on the singular stack 1e-3: XLA's forward
    contracts multiply-adds, which moves the rounding-level pivots that
    the cotangent runs through, measured 3.2e-5)."""
    M, zero = _stacks()[stack]
    K, n = M.shape[0], M.shape[-1]
    live = [(k, i) for k in range(K) for i in range(N) if not zero[k, i]]
    gL = np.tril(np.random.default_rng(6).standard_normal((n, N, N))
                 ).transpose(1, 2, 0)

    def build(vals):
        rows = [[0.0] * N for _ in range(K)]
        for (k, i), v in zip(live, vals):
            rows[k][i] = v
        return rows

    _, tvjp = torch.func.vjp(lambda *v: es.list_mgs_tril(build(v), K, N),
                             *[_t(M[k, i]) for k, i in live])
    auto = tvjp([[_t(gL[i, j]) for j in range(N)] for i in range(N)])
    _, jvjp = jax.vjp(lambda *v: pk._list_mgs_tril(build(v), K, N),
                      *[jnp.asarray(M[k, i]) for k, i in live])
    ref_j = jvjp([[jnp.asarray(gL[i, j]) for j in range(N)]
                  for i in range(N)])
    got = e1d.mgs_tril_vjp(build([_t(M[k, i]) for k, i in live]), K, N,
                           [[_t(gL[i, j]) for j in range(N)]
                            for i in range(N)])
    assert all(isinstance(got[k][i], float) and got[k][i] == 0.0
               for k in range(K) for i in range(N) if zero[k, i])
    mine = [got[k][i] for k, i in live]
    _group_close(mine, [_np(x) for x in auto], 1e-12)
    _group_close(mine, ref_j, 1e-3 if stack == "update_singular" else 1e-12)


# ------------------------------------------- the front door, interpret mode


def _front_inputs():
    """(port problem, u0s, ps, ys) of the LV case: initial values (1, 1),
    parameters scaled per member by 1 + 0.05 N(0, 1) (the JAX package's
    test), per-member observations of C_DENSE u."""
    rng = np.random.default_rng(3)
    tprob = odt.models.lotka_volterra(tspan=TSPAN, device="cpu")
    u0s = np.ones((B_JAX, D))
    ps = np.asarray(tprob.p) * (1 + 0.05 * rng.standard_normal((B_JAX, 4)))
    ys = np.abs(rng.normal(1.5, 0.5, (B_JAX, len(TS), D))) @ C_DENSE.T
    return tprob, u0s, ps, ys


@functools.cache
def _jax_forward():
    """The JAX gradient's forward `_ek1_datalik_vjp_fwd` in interpret mode
    on the port's preconditioned inputs: ``(dll, ll, stream)`` and the
    port's kernel inputs."""
    tprob, u0s, ps, ys = _front_inputs()
    m0_p, ps_t, ys_t, table, consts = ed.ek1_kernel_inputs(
        tprob.f, _t(u0s), _t(ps), TSPAN, T, TS, _t(ys), R_VEC,
        obs_matrix=C_DENSE)
    jprob = odf.models.lotka_volterra(tspan=TSPAN)
    blk = lambda x: np.asarray(x).reshape(x.shape[:-1] + (1, 8, 128))
    key = lambda M: tuple(tuple(float(v) for v in row) for row in M)
    with pltpu.force_tpu_interpret_mode():
        (dll, ll), (st, _, _) = pk._ek1_datalik_vjp_fwd(
            jprob.f, jprob.jac, Q, DT, TSPAN[0], None, SEG,
            key(consts["C_obs"]), key(consts["R_chol"]), True, False,
            jnp.asarray(np.moveaxis(blk(_np(m0_p)), 2, 0)),
            jnp.asarray(np.moveaxis(blk(_np(ps_t)), 1, 0)),
            jnp.asarray(np.moveaxis(blk(_np(ys_t)), 2, 0)))
    return (np.asarray(dll).reshape(-1), np.asarray(ll).reshape(-1),
            np.asarray(st), (tprob, ps_t, ys_t, table, consts))


@pytest.fixture(scope="module")
def jax_forward():
    return _jax_forward()


def test_front_door_values_match_jax(jax_forward):
    """The front door's dll to rtol 1e-8 (the JAX package's test of this
    kernel) and ll to 1e-8 of the ensemble's scale, against the JAX
    kernel's on the same inputs; the primal kernel's path and the
    gradient's forward equal bit for bit."""
    dll_j, ll_j, _, _ = jax_forward
    tprob, u0s, ps, ys = _front_inputs()
    kw = dict(q=Q, field=tprob.field, obs_matrix=C_DENSE, ek1=True)
    with torch.no_grad():
        dll, ll = odt.ensemble_data_loglik(tprob.f, _t(u0s), _t(ps), TSPAN, T,
                                           TS, _t(ys), R_VEC, **kw)
    assert np.isfinite(dll_j).all() and torch.isfinite(dll).all()
    np.testing.assert_allclose(_np(dll), dll_j, rtol=1e-8)
    _close_to_scale(ll, ll_j, 1e-8)
    args = [_t(x[:16]).requires_grad_() for x in (u0s, ps, ys)]
    g_dll, g_ll = odt.ensemble_data_loglik(tprob.f, *args[:2], TSPAN, T, TS,
                                           args[2], R_VEC, **kw)
    assert torch.equal(g_dll.detach(), dll[:16])
    assert torch.equal(g_ll.detach(), ll[:16])


def test_plain_adjoint_on_the_jax_stream(jax_forward):
    """The JAX forward's stream, through
    `convert.ek1_datalik_stream_from_numpy`, is the port's plain forward's
    (the means to 1e-10 of their scale, the factors to 1e-10 of the
    largest entry), and on 64 members the port's plain adjoint on it gives
    the adjoint on the port's own stream to 1e-8 of each row's scale."""
    dll_j, _, st_j, (tprob, ps_t, ys_t, table, consts) = jax_forward
    got = convert.ek1_datalik_stream_from_numpy(st_j, nq=NQ, d=D,
                                                device="cpu")
    keep = slice(0, 64)
    m0 = got[0, :N, keep].reshape(NQ, D, -1).contiguous()
    ps_k, ys_k = ps_t[:, keep].contiguous(), ys_t[..., keep].contiguous()
    dll, _, st = e1d.ek1_datalik_fwd_stream_plain(
        tprob.f, tprob.jac, m0, ps_k, ys_k, table, **consts)
    assert got.shape == (T, e1d.layout(N), B_JAX) and st.shape[1] == 72
    np.testing.assert_allclose(_np(dll), dll_j[keep], rtol=1e-9)
    got = got[..., keep].contiguous()
    diff = (got - st).abs()
    m_scale = st[:, :N].abs().amax(dim=(0, 2), keepdim=True)
    assert bool((diff[:, :N] <= 1e-10 * m_scale).all())
    assert float(diff[:, N:].max()) <= 1e-10 * float(st[:, N:].abs().max())
    # the adjoint over the first 16 steps and the observation after step 8
    # (the sweep costs per step; the whole stream is held above)
    rng = np.random.default_rng(6)
    cts = [_t(rng.standard_normal(64)) for _ in range(2)]
    kw = dict(nq=NQ, stop_calib=False, **consts)
    head = ed.step_table(TSPAN[0], DT, Q, torch.float64, "cpu",
                         seg_lens=(SEG[0], 16 - SEG[0]))
    on_j, on_p = (e1d.ek1_datalik_grad_bwd_plain(
        tprob.f, tprob.jac, x[:16].contiguous(), ps_k, ys_k[:1], *cts, head,
        **kw) for x in (got, st))
    for a, b in zip(on_j, on_p):
        _close_to_scale(_np(a).reshape(-1, 64).T, _np(b).reshape(-1, 64).T,
                        1e-8)


def _logistic_f(u, p, t):
    """The JAX package's logistic field ``p u (1 - u)``, in its order of
    operations."""
    return p[0] * u * (1 - u)


@functools.cache
def _logistic_grads():
    """Gradients of ``sum(dll[:1]) + 0.25 sum(ll[:1])`` in (u0s, ps, ys) of
    the JAX package's EK1 data-likelihood gradient test (logistic over
    (0, 2), q = 2, 16 steps, C = [[1.5]], noise 0.1): the JAX kernel's in
    interpret mode and the port's front door's."""
    jprob = odf.models.logistic(tspan=(0.0, 2.0))
    steps, dt = 16, 2.0 / 16
    ts = np.array([5, 9, 13]) * dt
    rng = np.random.default_rng(7)
    u0s = np.full((B_JAX, 1), float(jprob.u0[0]))
    ps = np.full((B_JAX, 1), float(jprob.p[0]))
    ys = 0.5 + 0.2 * rng.standard_normal((3, 1))
    kw = dict(obs_noise_std=np.array([0.1]), q=2, obs_matrix=np.array([[1.5]]),
              ek1=True)

    def loss(u, p, y):
        dll, oll = pk.ensemble_data_loglik_pallas(
            jprob.f, u, p, (0.0, 2.0), steps, ts, y, **kw)
        return jnp.sum(dll[:1]) + 0.25 * jnp.sum(oll[:1])

    with pltpu.force_tpu_interpret_mode():
        ref = jax.grad(loss, argnums=(0, 1, 2))(
            jnp.asarray(u0s), jnp.asarray(ps), jnp.asarray(ys))
    args = [_t(x).requires_grad_() for x in (u0s, ps, ys)]
    dll, oll = odt.ensemble_data_loglik(_logistic_f, args[0], args[1],
                                        (0.0, 2.0), steps, ts, args[2], **kw)
    got = torch.autograd.grad(dll[:1].sum() + 0.25 * oll[:1].sum(), args)
    return [np.asarray(x) for x in ref], [_np(x) for x in got]


@pytest.fixture(scope="module")
def logistic_grads():
    return _logistic_grads()


@pytest.mark.parametrize("wrt", ["u0s", "ps", "ys"])
def test_front_door_gradient_matches_jax(wrt, logistic_grads):
    """The front door's gradient against the JAX kernel's own, at the JAX
    package's tolerance (rtol 1e-6, atol 1e-9), member by member."""
    ref, got = logistic_grads
    i = ("u0s", "ps", "ys").index(wrt)
    assert got[i].shape == ref[i].shape
    np.testing.assert_allclose(got[i], ref[i], rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("calib_grad", [True, False])
def test_lv_gradient_against_central_differences(calib_grad):
    """On LV (d = 2, where J depends on u and p) the port's gradient of
    sum(dll) in ps against central differences of its plain primal along a
    seeded direction, on 4 members over 12 steps (rtol 1e-6, step 1e-6);
    with
    ``calib_grad=False`` the values are the same and the gradient is
    another one (the calibration is held fixed)."""
    tprob, u0s, ps, ys = _front_inputs()
    kw = dict(q=Q, field=tprob.field, obs_matrix=C_DENSE, ek1=True)
    u, p, y = (_t(x[:4]) for x in (u0s, ps, ys[:, :2]))
    pg = p.clone().requires_grad_()
    dll, _ = odt.ensemble_data_loglik(tprob.f, u, pg, TSPAN, T_SHORT,
                                      TS_SHORT, y, R_VEC,
                                      calib_grad=calib_grad, **kw)
    (g,) = torch.autograd.grad(dll.sum(), pg)
    v = _t(np.random.default_rng(8).standard_normal((4, 4))) * p
    ad = float((g * v).sum())
    eps = 1e-6
    with torch.no_grad():
        plus, minus = (float(odt.ensemble_data_loglik(
            tprob.f, u, p + s * v, TSPAN, T_SHORT, TS_SHORT, y, R_VEC,
            **kw)[0].sum()) for s in (eps, -eps))
    fd = (plus - minus) / (2 * eps)
    if calib_grad:
        assert abs(fd - ad) <= 1e-6 * abs(ad)
    else:
        assert abs(fd - ad) > 1e-6 * abs(ad)


def test_shared_data_as_per_member_data():
    """Per-member ys equal to the shared ones on every member give the
    shared run's values bit for bit, and the shared gradient is the
    per-member one summed over the members."""
    tprob, u0s, ps, _ = _front_inputs()
    ys = np.abs(np.random.default_rng(9).normal(1.5, 0.5, (len(TS_SHORT), D)))
    ys_b = np.broadcast_to(ys, (16,) + ys.shape).copy()
    out = []
    for y in (ys, ys_b):
        args = [_t(x).requires_grad_() for x in (u0s[:16], ps[:16], y)]
        dll, ll = odt.ensemble_data_loglik(
            tprob.f, args[0], args[1], TSPAN, T_SHORT, TS_SHORT, args[2],
            0.05, field="lv", ek1=True)
        out.append((dll, ll, torch.autograd.grad(dll.sum(), args)[2]))
    assert torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1],
                                                             out[1][1])
    torch.testing.assert_close(out[1][2].sum(0), out[0][2], rtol=1e-12,
                               atol=1e-12)


# --------------------------------------- what the door refuses, plumbing


def _door_args(**over):
    prob = odt.models.lotka_volterra(tspan=TSPAN, device="cpu")
    rng = np.random.default_rng(0)
    args = dict(prob_f=prob.f, u0s=torch.ones(4, D, dtype=torch.float64),
                ps=prob.p[None].expand(4, 4).contiguous(), tspan=TSPAN,
                n_steps=30, ts_data=np.array([0.5, 1.5]),
                ys=torch.from_numpy(rng.standard_normal((2, 2))),
                obs_noise_std=0.1, obs_matrix=C_DENSE, ek1=True)
    args.update(over)
    return args


@pytest.mark.parametrize("over,exc,match,jax_too", [
    (dict(diagonal_ek1=True), ValueError, "not both", True),
    (dict(ts_data=np.array([0.55, 1.5])), NotImplementedError, "off-grid",
     True),
    (dict(second_order=True, u0s=torch.ones(4, 2 * D, dtype=torch.float64),
          obs_matrix=None), NotImplementedError, "second_order", False),
    (dict(prior="ioup"), NotImplementedError, "item 5", False),
    (dict(mesh=object()), NotImplementedError, "one card", False),
], ids=["ek1_and_diagonal", "off_grid", "second_order", "prior", "mesh"])
def test_refusals_and_their_messages(over, exc, match, jax_too):
    """As the JAX front door refuses them, with its messages (``prior`` and
    ``mesh``: the port's own, not ported)."""
    with pytest.raises(exc, match=match):
        odt.ensemble_data_loglik(**_door_args(**over))
    if not jax_too:
        return
    # the JAX kernels take whole blocks of 1024 members
    jargs = {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
             for k, v in _door_args(**over).items()}
    for k in ("u0s", "ps"):
        jargs[k] = np.repeat(jargs[k][:1], B_JAX, axis=0)
    jargs["prob_f"] = odf.models.lotka_volterra().f
    with pytest.raises(exc, match=match):
        pk.ensemble_data_loglik_pallas(**jargs)


def _small(B=8, per_member=True):
    tprob, u0s, ps, ys = _front_inputs()
    y = ys[:B, :2] if per_member else ys[0, :2]
    return (tprob,) + ed.ek1_kernel_inputs(
        tprob.f, _t(u0s[:B]), _t(ps[:B]), TSPAN, T_SHORT, TS_SHORT, _t(y),
        R_VEC, obs_matrix=C_DENSE)


@pytest.mark.parametrize("per_member", [True, False])
def test_cpu_wrappers_run_the_plain_versions_and_other_devices_raise(
        per_member):
    tprob, m0, pt, yt, table, consts = _small(per_member=per_member)
    args = (tprob.f, tprob.jac, "lv", m0, pt, yt, table)
    got = e1d.ek1_datalik(*args, **consts)
    want = e1d.ek1_datalik_plain(tprob.f, tprob.jac, m0, pt, yt, table,
                                 **consts)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    dll, ll, st = e1d.ek1_datalik_grad_fwd(*args, **consts)
    assert st.shape == (T_SHORT, 72, 8)
    assert torch.equal(dll, want[0]) and torch.equal(ll, want[1])
    assert torch.equal(st[0, :N], m0.reshape(N, 8))
    rng = np.random.default_rng(6)
    cts = [_t(rng.standard_normal(8)) for _ in range(2)]
    dm0, dps, dys = e1d.ek1_datalik_grad_bwd(tprob.f, tprob.jac, "lv", st, pt,
                                             yt, *cts, table, nq=NQ, **consts)
    part = e1d.ek1_datalik_grad_bwd_plain(tprob.f, tprob.jac, st, pt, yt,
                                          *cts, table, nq=NQ, **consts)
    assert torch.equal(dm0, part[0]) and torch.equal(dps, part[1])
    assert torch.equal(dys, part[2] if yt.ndim == 3 else part[2].sum(-1))
    wrappers = (e1d.ek1_datalik, e1d.ek1_datalik_grad_fwd,
                e1d.ek1_datalik_grad_bwd)
    before = [w.launches for w in wrappers]
    meta = [x.to("meta") for x in (m0, pt, yt, st)]
    with pytest.raises(ValueError, match="meta"):
        e1d.ek1_datalik(tprob.f, tprob.jac, "lv", *meta[:3], table, **consts)
    with pytest.raises(ValueError, match="meta"):
        e1d.ek1_datalik_grad_fwd(tprob.f, tprob.jac, "lv", *meta[:3], table,
                                 **consts)
    with pytest.raises(ValueError, match="meta"):
        e1d.ek1_datalik_grad_bwd(tprob.f, tprob.jac, "lv", meta[3], meta[1],
                                 meta[2], *[c.to("meta") for c in cts], table,
                                 nq=NQ, **consts)
    assert before == [w.launches for w in wrappers]


def test_kernel_checks_refuse_what_the_kernels_do_not_take():
    """The CUDA launch's argument checks: at most DOBS_MAX observed rows,
    constants in the inputs' dtype, ys of the table's observations,
    on-grid tables, a field with a CUDA Jacobian."""
    tprob, m0, pt, yt, table, consts = _small()
    check = lambda y, tab, c, field="lv": e1d._check_inputs(
        "k", field, m0.shape, pt, y, tab, c)
    check(yt, table, consts)
    many = dict(consts, C_obs=np.ones((5, D)), R_chol=np.eye(5))
    with pytest.raises(ValueError, match="1 to 4 observed rows"):
        check(torch.zeros(3, 5, dtype=torch.float64), table, many)
    with pytest.raises(TypeError, match="C_obs"):
        check(yt, table, dict(consts, C_obs=C_DENSE.astype(np.float32)))
    with pytest.raises(ValueError, match="ys must be"):
        check(yt[:1], table, consts)
    off = ed.data_table(TSPAN, T_SHORT, np.array([0.55, 1.5]), Q,
                        torch.float64, "cpu")
    with pytest.raises(ValueError, match="on the grid only"):
        check(torch.zeros(2, 2, dtype=torch.float64), off, consts)
    with pytest.raises(NotImplementedError, match="no CUDA vector field"):
        check(yt, table, consts, field=None)


def test_stream_layout_and_its_converter():
    m = [torch.tensor(float(r)) for r in range(N)]
    L = [[torch.tensor(100.0 + r * N + c) for c in range(N)] for r in range(N)]
    row = torch.stack(e1d.pack_state(m, L))
    assert row.shape == (e1d.layout(N),) == (72,)
    m2, L2 = e1d.unpack_state(row, N)
    assert all(torch.equal(a, b) for a, b in zip(m, m2))
    assert all(torch.equal(a, b)
               for ra, rb in zip(L, L2) for a, b in zip(ra, rb))
    assert e1d.stream_dims(72, NQ) == D
    # the JAX stream (nb, T, D, D+1, 8, 128): row r [L[r] | m[r]]
    st = np.zeros((1, 2, N, N + 1, 8, 128))
    for r in range(N):
        st[:, :, r, N] = r
        for c in range(N):
            st[:, :, r, c] = 100.0 + r * N + c
    got = convert.ek1_datalik_stream_from_numpy(st, nq=NQ, d=D, device="cpu")
    assert got.shape == (2, 72, 1024)
    assert torch.equal(got[1, :, 5], row.double())
    with pytest.raises(ValueError, match="stream"):
        convert.ek1_datalik_stream_from_numpy(np.zeros((1, 2, N, N, 8, 128)),
                                              nq=NQ, d=D, device="cpu")
