"""The PyTorch port's differentiable fused EK0 filter against the JAX
package, on the CPU in f64: the step body, its static-diffusion update and
its VJP one by one; the whole filter, its gradient's outputs and its
gradients against the Pallas kernels in interpret mode; and the front door.
Inputs are made with numpy from a seed and fed to both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import odefilters as odf
import odefilters_torch as odt
from odefilters.ops import pallas_kernels as pk
from odefilters_torch.ops import ek0_filter as ef
from odefilters_torch.ops import ek0_pair as ep

Q, NQ, D, BX = 3, 4, 2, 1
TSPAN = (0.0, 1.0)
N_STEPS = 12
B_JAX = 1024           # the JAX kernels' smallest ensemble (one block)
STATIC = ("fixed", "fixedMAP", "fixedMV")
TRIU, _ = ep.pair_layout(NQ, D, BX)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _step_inputs(seed, n=64, dt=0.1):
    """Random lanes of a committed state: m on the preconditioned scales,
    C symmetric PSD with row/column BX exactly zero, perturbed FHN p."""
    rng = np.random.default_rng(seed)
    At, Qt, _, p = ep.pair_constants(Q, dt)
    consts = dict(At=At, Qt=Qt, pinv0=float(1 / p[0]), pinv1=float(1 / p[1]),
                  d=D, nq=NQ)
    pp = np.array([0.7, 0.8, 1 / 12.5, 0.5])[:, None] * (
        1 + 0.05 * rng.standard_normal((4, n)))
    m = rng.standard_normal((NQ, D, n)) * np.array([1e3, 1e2, 1e1, 1.0])[:, None, None]
    act = [a for a in range(NQ) if a != BX]
    A = rng.standard_normal((len(act), len(act), n))
    S = np.einsum("ikn,jkn->ijn", A, A) * 1e-3
    C = np.zeros((NQ, NQ, n))
    for ii, i in enumerate(act):
        for jj, j in enumerate(act):
            C[i, j] = S[ii, jj]
    return rng, consts, pp, m, C


def _lists(arr, wrap):
    return [[wrap(arr[i, j]) for j in range(arr.shape[1])]
            for i in range(arr.shape[0])]


@pytest.mark.parametrize("diffusion", ("dynamic",) + STATIC)
def test_step_filter_matches_jax_over_chained_steps(diffusion):
    """`ek0_step_filter` == `_ek0_step_lists(collapsed=True)` with its
    outputs (and the static calibration carry), each package chaining its
    own outputs over 5 steps."""
    _, consts, pp, m, C = _step_inputs(0)
    static = None if diffusion == "dynamic" else diffusion
    jf, tf = odf.models.fitzhugh_nagumo().f, odt.models.library.fitzhugh_nagumo_f
    mj, Cj = _lists(m, jnp.asarray), _lists(C, jnp.asarray)
    mt, Ct = _lists(m, torch.from_numpy), _lists(C, torch.from_numpy)
    n = m.shape[-1]
    zj, zt = jnp.zeros(n), torch.zeros(n, dtype=torch.float64)
    calj = ([zj] * D if static == "fixedMV" else zj, zj)
    calt = ([zt] * D if static == "fixedMV" else zt, zt)
    kw_t = dict(consts, At=ep._lists(consts["At"]), Qt=ep._lists(consts["Qt"]))
    for k in range(5):
        t_new = 0.1 * (k + 1)
        outj = pk._ek0_step_lists(
            mj, Cj, jnp.asarray(pp), jnp.float64(t_new), f=jf, collapsed=True,
            static_diff=static, calib=calj if static else None, **consts,
        )
        outt = ef.ek0_step_filter(
            mt, Ct, torch.from_numpy(pp), torch.tensor(t_new, dtype=torch.float64),
            f=tf, static_diff=static, calib=calt if static else None, **kw_t,
        )
        mj, Cj, llj, usj, sdj = outj[:5]
        mt, Ct, llt, ust, sdt = outt[:5]
        for got, ref in [(llt, llj), (sdt, sdj)] + list(zip(ust, usj)):
            np.testing.assert_allclose(_np(got), _np(ref), rtol=1e-12)
        for i in range(NQ):
            for j in range(D):
                np.testing.assert_allclose(_np(mt[i][j]), _np(mj[i][j]),
                                           rtol=1e-12)
            for l in range(NQ):
                if BX in (i, l):
                    assert not _np(Ct[i][l]).any()
                else:
                    np.testing.assert_allclose(_np(Ct[i][l]), _np(Cj[i][l]),
                                               rtol=1e-12)
        if static:
            calj, calt = outj[5], outt[5]
            np.testing.assert_allclose(_np(torch.stack(list(calt[0])) if
                                           static == "fixedMV" else calt[0]),
                                       _np(jnp.stack(calj[0]) if static ==
                                           "fixedMV" else calj[0]),
                                       rtol=1e-12)


@pytest.mark.parametrize("static", STATIC)
def test_static_local_update_matches_jax(static):
    """The running estimate at its first step (k = 0), the second (k = 1,
    where the MLE's divisor is clamped) and a later one."""
    rng = np.random.default_rng(1)
    n = 32
    z = rng.standard_normal((D, n))
    zz = (z * z).sum(0)
    inv_s = np.exp(rng.uniform(-3, 3, n))
    for k in (0.0, 1.0, 7.0):
        sig = (np.abs(rng.standard_normal((D, n))) if static == "fixedMV"
               else np.abs(rng.standard_normal(n)))
        kf = np.full(n, k)
        ref = pk._static_local_update(
            static, (list(jnp.asarray(sig)) if static == "fixedMV"
                     else jnp.asarray(sig), jnp.asarray(kf)),
            jnp.asarray(zz), list(jnp.asarray(z)), jnp.asarray(inv_s), D)
        t = torch.from_numpy
        got = ef.static_local_update(
            static, (list(t(sig)) if static == "fixedMV" else t(sig), t(kf)),
            t(zz), list(t(z)), t(inv_s), D)
        if static == "fixedMV":
            np.testing.assert_allclose(np.stack([_np(x) for x in got[0]]),
                                       np.stack([_np(x) for x in ref[0]]),
                                       rtol=1e-13)
        else:
            np.testing.assert_allclose(_np(got[0]), _np(ref[0]), rtol=1e-13)
        np.testing.assert_array_equal(_np(got[1]), _np(ref[1]))


def test_step_vjp_matches_jax_vjp():
    """``torch.func.vjp`` of the port's step (on the stream's covariance
    triangle) against ``jax.vjp`` of `_ek0_step_lists(collapsed=True)`, the
    function the JAX backward kernel differentiates, on the same
    cotangents. The port's triangle cotangent is JAX's ``dC[i][l] +
    dC[l][i]``."""
    rng, consts, pp, m, C = _step_inputs(2)
    n = m.shape[-1]
    g_m = rng.standard_normal((NQ, D, n))
    g_tri = rng.standard_normal((len(TRIU), n))
    g_ll, g_std = rng.standard_normal(n), rng.standard_normal(n)
    g_us = rng.standard_normal((D, n))
    t_new = 0.3
    jf = odf.models.fitzhugh_nagumo().f

    def jstep(m_, C_, p_):
        return pk._ek0_step_lists(m_, C_, p_, jnp.float64(t_new), f=jf,
                                  collapsed=True, **consts)

    # JAX's output C_new aliases C_new[l][i] to C_new[i][l]: its cotangent
    # is the sum of the two positions', so half of the triangle's each
    g_C = np.zeros((NQ, NQ, n))
    for (i, l), g in zip(TRIU, g_tri):
        g_C[i, l] += g / (1 if i == l else 2)
        g_C[l, i] += 0 if i == l else g / 2
    @jax.jit
    def jvjp(primals, cts):
        return jax.vjp(jstep, *primals)[1](cts)

    dm_j, dC_j, dp_j = jvjp(
        (_lists(m, jnp.asarray), _lists(C, jnp.asarray), jnp.asarray(pp)),
        (_lists(g_m, jnp.asarray), _lists(g_C, jnp.asarray), jnp.asarray(g_ll),
         list(jnp.asarray(g_us)), jnp.asarray(g_std)))

    t = torch.from_numpy
    kw = dict(consts, At=ep._lists(consts["At"]), Qt=ep._lists(consts["Qt"]))
    _, vjp_t = torch.func.vjp(
        lambda m_, C_, p_: ef.ek0_step_filter_triu(
            m_, C_, p_, torch.tensor(t_new, dtype=torch.float64),
            f=odt.models.library.fitzhugh_nagumo_f, **kw),
        _lists(m, t), [t(C[i, l]) for (i, l) in TRIU], t(pp))
    dm_t, dC_t, dp_t = vjp_t((_lists(g_m, t), list(t(g_tri)), t(g_ll),
                              list(t(g_us)), t(g_std)))
    for i in range(NQ):
        for j in range(D):
            np.testing.assert_allclose(_np(dm_t[i][j]), _np(dm_j[i][j]),
                                       rtol=1e-10, atol=1e-12)
    for (i, l), got in zip(TRIU, dC_t):
        ref = _np(dC_j[i][l]) + (_np(dC_j[l][i]) if i != l else 0.0)
        np.testing.assert_allclose(_np(got), ref, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(_np(dp_t), _np(dp_j), rtol=1e-10, atol=1e-12)


@pytest.fixture(scope="module")
def filter_inputs():
    """Perturbed FHN ensemble at the JAX kernels' smallest size: numpy u0s,
    ps, the JAX Taylor init m0 and numpy-seeded output cotangents."""
    from odefilters.taylor import taylor_coefficients

    jprob = odf.models.fitzhugh_nagumo(tspan=TSPAN)
    rng = np.random.default_rng(0)
    u0s = np.asarray(jprob.u0)[None] + 0.05 * rng.standard_normal((B_JAX, 2))
    ps = np.broadcast_to(np.asarray(jprob.p), (B_JAX, 4)).copy()
    m0 = jax.vmap(
        lambda u, p: jnp.stack(taylor_coefficients(jprob.f, u, p, 0.0, Q))
    )(jnp.asarray(u0s), jnp.asarray(ps)).transpose(1, 2, 0)
    cts = (rng.standard_normal((N_STEPS + 1, D, B_JAX)),
           rng.standard_normal((N_STEPS + 1, B_JAX)),
           rng.standard_normal(B_JAX))
    return jprob, u0s, ps, np.asarray(m0), cts


def _dt():
    return (TSPAN[1] - TSPAN[0]) / N_STEPS


@pytest.fixture(scope="module")
def pallas_vjp(filter_inputs):
    """``jax.vjp`` of `pk.ek0_fused_filter` in Pallas interpret mode: the
    gradient forward's outputs and, on the seeded cotangents, dm0, dps."""
    from jax.experimental.pallas import tpu as pltpu

    jprob, _, ps, m0, cts = filter_inputs
    with pltpu.force_tpu_interpret_mode():
        outs, vjp_fn = jax.vjp(
            lambda m, p: pk.ek0_fused_filter(jprob.f, m, p, TSPAN[0], _dt(),
                                             N_STEPS, Q),
            jnp.asarray(m0), jnp.asarray(ps.T))
        grads = vjp_fn(tuple(jnp.asarray(c) for c in cts))
    return [np.asarray(x) for x in outs], [np.asarray(g) for g in grads]


@pytest.fixture(scope="module")
def pallas_primal(filter_inputs):
    """The primal kernel `_ek0_kernel` in interpret mode, dynamic and
    fixedMV."""
    from jax.experimental.pallas import tpu as pltpu

    jprob, _, ps, m0, _ = filter_inputs
    out = {}
    with pltpu.force_tpu_interpret_mode():
        for diffusion in ("dynamic", "fixedMV"):
            res = pk.ek0_fused_filter(jprob.f, jnp.asarray(m0),
                                      jnp.asarray(ps.T), TSPAN[0], _dt(),
                                      N_STEPS, Q, diffusion=diffusion)
            out[diffusion] = [np.asarray(x) for x in res]
    return out


def _port_filter(filter_inputs, **kw):
    _, _, ps, m0, _ = filter_inputs
    m0_t = torch.tensor(m0).requires_grad_(kw.pop("grad", False))
    ps_t = torch.from_numpy(np.ascontiguousarray(ps.T)).requires_grad_(
        m0_t.requires_grad)
    out = ef.ek0_fused_filter(odt.models.library.fitzhugh_nagumo_f, m0_t, ps_t,
                              TSPAN[0], _dt(), N_STEPS, Q, field="fhn", **kw)
    return out, (m0_t, ps_t)


def _assert_outputs(got, ref, std_rtol=1e-8):
    us, stds, lls = got
    np.testing.assert_allclose(_np(us), ref[0], rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(_np(stds), ref[1], rtol=std_rtol, atol=1e-12)
    np.testing.assert_allclose(_np(lls), ref[2], rtol=1e-10, atol=1e-12)


def test_primal_filter_matches_pallas_interpret(filter_inputs, pallas_primal):
    """No input needs a gradient: the primal filter, whose stds come from
    the raw variances (pinv0 sqrt(1e-30) at t0, as in the JAX kernel)."""
    with torch.no_grad():
        out, _ = _port_filter(filter_inputs)
    assert out[0].shape == (N_STEPS + 1, D, B_JAX)
    _assert_outputs(out, pallas_primal["dynamic"])


def test_gradient_forward_matches_pallas_vjp(filter_inputs, pallas_vjp):
    """With gradients on, the gradient's forward (std exactly 0 at t0)."""
    out, _ = _port_filter(filter_inputs, grad=True)
    _assert_outputs(out, pallas_vjp[0])
    assert not out[1][0].detach().any()


def test_gradients_match_pallas_vjp(filter_inputs, pallas_vjp):
    """``torch.autograd.grad`` through `EK0FusedFilter` (the plain adjoint
    sweep on the CPU) against ``jax.vjp`` of the Pallas kernels, at the
    tolerances of the JAX package's own gradient test (rtol 1e-8, atol
    1e-10). dps is held entry by entry. Each entry of dm0 is held against
    the largest |entry| of its (row, dim) over the members: a few entries
    are sums that cancel far below their neighbours', where the two
    adjoints' rounding orders differ by ~1e-10 of the row's scale."""
    _, _, _, _, cts = filter_inputs
    out, inputs = _port_filter(filter_inputs, grad=True)
    dm0, dps = torch.autograd.grad(out, inputs,
                                   [torch.from_numpy(c) for c in cts])
    ref_dm0, ref_dps = pallas_vjp[1]
    assert np.isfinite(_np(dm0)).all() and np.isfinite(_np(dps)).all()
    np.testing.assert_allclose(_np(dps), ref_dps, rtol=1e-8, atol=1e-10)
    scale = np.abs(ref_dm0).max(axis=2, keepdims=True)
    err = np.abs(_np(dm0) - ref_dm0)
    assert (err <= 1e-10 + 1e-8 * scale).all(), float((err / scale).max())


def test_static_fixedmv_matches_pallas_interpret(filter_inputs, pallas_primal):
    """fixedMV, the static model whose outputs differ most in shape:
    per-dimension stds (T+1, d, B) and sigma^2 (d, B); lls all NaN."""
    with torch.no_grad():
        (us, stds, lls, sig), _ = _port_filter(filter_inputs,
                                               diffusion="fixedMV")
    ref = pallas_primal["fixedMV"]
    assert stds.shape == (N_STEPS + 1, D, B_JAX) and sig.shape == (D, B_JAX)
    np.testing.assert_allclose(_np(us), ref[0], rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(_np(stds), ref[1], rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(_np(sig), ref[3], rtol=1e-9)
    assert np.isnan(_np(lls)).all() and np.isnan(ref[2]).all()


B_DOOR = 100           # not a multiple of the 64-thread block


def _door_inputs(B=B_DOOR, seed=3):
    rng = np.random.default_rng(seed)
    prob = odt.models.fitzhugh_nagumo(device="cpu", tspan=TSPAN)
    u0s = prob.u0[None] + 0.05 * torch.from_numpy(rng.standard_normal((B, 2)))
    return prob, u0s, prob.p[None].expand(B, 4)


def test_front_door_filter_equals_fused_filter():
    from odefilters_torch.taylor import taylor_coefficients

    prob, u0s, ps = _door_inputs()
    sol = odt.solve_ensemble(prob, odt.EK0(order=Q, smooth=False), u0s, ps,
                             n_save=N_STEPS, adaptive=False)
    assert sol.diffusions is None
    pt = ps.T.contiguous()
    m0 = torch.stack(taylor_coefficients(prob.f, u0s.T.contiguous(), pt,
                                         TSPAN[0], Q))
    ref = ef.ek0_fused_filter(prob.f, m0, pt, TSPAN[0], _dt(), N_STEPS, Q,
                              field="fhn")
    for got, want in zip((sol.us, sol.stds, sol.lls), ref):
        assert torch.equal(got, want)


def test_front_door_gradient_matches_central_difference():
    """Gradients reach u0s through the Taylor init and ps through both the
    init and the filter; held against a central difference along a seeded
    direction (f64, step 3e-7: truncation and rounding both stay below
    1e-6 relative here; steps 1e-5 and 3e-8 miss by 1e-4 and 2e-5)."""
    prob, u0s, ps = _door_inputs(B=8)
    ps = ps.clone()
    rng = np.random.default_rng(4)
    v_u = torch.from_numpy(rng.standard_normal(u0s.shape))
    v_p = torch.from_numpy(rng.standard_normal(ps.shape)) * 1e-2
    alg = odt.EK0(order=Q, smooth=False)

    def loss(u, p):
        sol = odt.solve_ensemble(prob, alg, u, p, n_save=N_STEPS,
                                 adaptive=False)
        return sol.lls.sum() + 0.1 * sol.us[:, 0].sum() + 0.01 * sol.stds.sum()

    u_r, p_r = u0s.clone().requires_grad_(), ps.clone().requires_grad_()
    g_u, g_p = torch.autograd.grad(loss(u_r, p_r), (u_r, p_r))
    assert torch.isfinite(g_u).all() and torch.isfinite(g_p).all()
    with torch.no_grad():
        eps = 3e-7
        fd = (loss(u0s + eps * v_u, ps + eps * v_p)
              - loss(u0s - eps * v_u, ps - eps * v_p)) / (2 * eps)
    dd = (g_u * v_u).sum() + (g_p * v_p).sum()
    assert abs(float(fd - dd)) <= 1e-5 * abs(float(dd)), float(fd / dd - 1)


@pytest.mark.parametrize("static", STATIC)
def test_front_door_static_models(static):
    prob, u0s, ps = _door_inputs(B=10)
    sol = odt.solve_ensemble(
        prob, odt.EK0(order=Q, smooth=False, diffusionmodel=static), u0s, ps,
        n_save=N_STEPS, adaptive=False)
    shape = (D, 10) if static == "fixedMV" else (10,)
    assert sol.diffusions.shape == shape and (sol.diffusions > 0).all()
    assert torch.isnan(sol.lls).all()
    assert sol.stds.shape == ((N_STEPS + 1,) + shape)
    assert torch.isfinite(sol.us).all() and torch.isfinite(sol.stds).all()
    # a static model is forward-only, as in the JAX package
    with pytest.raises(NotImplementedError, match="forward-only"):
        odt.solve_ensemble(
            prob, odt.EK0(order=Q, smooth=False, diffusionmodel=static),
            u0s.clone().requires_grad_(), ps, n_save=N_STEPS, adaptive=False)


def test_smoothing_static_model_names_the_pair_variant():
    """``smooth=True`` with a static model runs the pair's static variant,
    not the filter: the front door returns exactly what
    ``ek0_fused_solve(diffusion=...)`` returns, and no lls."""
    from odefilters_torch.taylor import taylor_coefficients

    prob, u0s, ps = _door_inputs(B=4)
    sol = odt.solve_ensemble(prob, odt.EK0(order=Q, diffusionmodel="fixedMAP"),
                             u0s, ps, n_save=N_STEPS, adaptive=False)
    pt = ps.T.contiguous()
    m0 = torch.stack(taylor_coefficients(prob.f, u0s.T.contiguous(), pt,
                                         TSPAN[0], Q))
    us, stds, sig = ep.ek0_fused_solve(prob.f, m0, pt, TSPAN[0], _dt(),
                                       N_STEPS, Q, diffusion="fixedMAP")
    assert sol.lls is None
    for got, want in zip((sol.us, sol.stds, sol.diffusions), (us, stds, sig)):
        assert torch.equal(got, want)


def _wrapper_args(device, B=8, T=5):
    rng = np.random.default_rng(5)
    At, Qt, _, p = ep.pair_constants(Q, 0.1)
    kw = dict(At=At, Qt=Qt, pinv0=float(1 / p[0]), pinv1=float(1 / p[1]),
              t0=0.0, dt=0.1)
    m0 = torch.from_numpy(rng.standard_normal((NQ, D, B)) * 1e-3).to(device)
    ps = torch.tensor([0.7, 0.8, 1 / 12.5, 0.5], dtype=torch.float64)[:, None]
    ps = ps.expand(4, B).contiguous().to(device)
    cts = [torch.from_numpy(rng.standard_normal(s)).to(device)
           for s in ((T + 1, D, B), (T + 1, B), (B,))]
    return kw, m0, ps, cts, T


def _counts():
    return (ef.ek0_filter.launches, ef.ek0_filter_grad_fwd.launches,
            ef.ek0_filter_grad_bwd.launches)


def test_cpu_wrappers_run_the_plain_versions():
    """On CPU tensors each wrapper returns its plain version's result and
    counts no launch; `EK0FusedFilter` picks the primal filter without a
    gradient and the gradient's forward with one, as on the card."""
    kw, m0, ps, cts, T = _wrapper_args("cpu")
    f = odt.models.library.fitzhugh_nagumo_f
    before = _counts()
    for static in (None,) + STATIC:
        got = ef.ek0_filter(f, "fhn", m0, ps, n_steps=T, static_diff=static, **kw)
        ref = ef.ek0_filter_plain(f, m0, ps, n_steps=T, static_diff=static, **kw)
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    fwd = ef.ek0_filter_grad_fwd(f, "fhn", m0, ps, n_steps=T, **kw)
    for a, b in zip(fwd, ef.ek0_filter_fwd_stream_plain(f, m0, ps, n_steps=T,
                                                        **kw)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    st = fwd[3]
    bkw = dict(kw, nq=NQ)
    for a, b in zip(ef.ek0_filter_grad_bwd(f, "fhn", st, ps, *cts, **bkw),
                    ef.ek0_filter_grad_bwd_plain(f, st, ps, *cts, **bkw)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert _counts() == before


@pytest.mark.parametrize("which", ["primal", "grad_fwd", "grad_bwd"])
def test_wrappers_reject_other_devices(which):
    kw, m0, ps, cts, T = _wrapper_args("meta")
    f = odt.models.library.fitzhugh_nagumo_f
    before = _counts()
    st = torch.zeros((T + 1, 15, 8), dtype=torch.float64, device="meta")
    call = {
        "primal": lambda: ef.ek0_filter(f, "fhn", m0, ps, n_steps=T, **kw),
        "grad_fwd": lambda: ef.ek0_filter_grad_fwd(f, "fhn", m0, ps,
                                                   n_steps=T, **kw),
        "grad_bwd": lambda: ef.ek0_filter_grad_bwd(f, "fhn", st, ps, *cts,
                                                   nq=NQ, **kw),
    }[which]
    with pytest.raises(ValueError, match="meta"):
        call()
    assert _counts() == before
