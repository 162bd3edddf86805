"""The PyTorch port's host-side pieces against the JAX package: prior
constants, the FitzHugh-Nagumo field and the Taylor initialization.
Inputs are made with numpy from a seed and fed to both packages; f64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import odefilters as odf
import odefilters_torch as odt
from odefilters import priors as jpriors
from odefilters.taylor import taylor_coefficients as jax_taylor
from odefilters_torch import priors as tpriors
from odefilters_torch.taylor import taylor_coefficients


@pytest.mark.parametrize("q", [1, 2, 3, 4, 5])
def test_ibm_small_np_equals_jax_bitwise(q):
    for ours, ref in zip(tpriors._ibm_small_np(q), jpriors._ibm_small_np(q)):
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("h", [0.04, 0.5, 3.0])
def test_precond_small_matches_jax(h):
    p, pinv = tpriors.precond_small(h, 3)
    p_j, pinv_j = jpriors.precond_small(jnp.float64(h), 3)
    np.testing.assert_allclose(p, np.asarray(p_j), rtol=1e-15)
    np.testing.assert_allclose(pinv, np.asarray(pinv_j), rtol=1e-15)


def _fhn_inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    prob = odf.models.fitzhugh_nagumo()
    u = np.asarray(prob.u0)[:, None] + 0.3 * rng.standard_normal((2, n))
    p = np.asarray(prob.p)[:, None] * (1.0 + 0.05 * rng.standard_normal((4, n)))
    return prob, u, p


def test_fhn_field_matches_jax():
    prob, u, p = _fhn_inputs(16)
    ref = np.asarray(prob.f(jnp.asarray(u), jnp.asarray(p), 0.0))
    ours = odt.models.fitzhugh_nagumo(device="cpu").f(
        torch.from_numpy(u), torch.from_numpy(p), 0.0
    ).numpy()
    assert ours.shape == (2, 16)
    np.testing.assert_allclose(ours, ref, rtol=1e-15)


def test_fhn_problem_defaults_match_jax():
    ref = odf.models.fitzhugh_nagumo()
    ours = odt.models.fitzhugh_nagumo(device="cpu")
    np.testing.assert_array_equal(ours.u0.numpy(), np.asarray(ref.u0))
    np.testing.assert_array_equal(ours.p.numpy(), np.asarray(ref.p))
    assert ours.tspan == tuple(float(t) for t in ref.tspan)
    assert ours.field == "fhn" and ours.d == 2 and ours.dtype == torch.float64


def test_taylor_coefficients_match_vmapped_jax():
    prob, u, p = _fhn_inputs(16, seed=1)
    ref = jax.vmap(
        lambda u0, pp: jnp.stack(jax_taylor(prob.f, u0, pp, 0.0, 3))
    )(jnp.asarray(u.T), jnp.asarray(p.T))
    ref = np.asarray(ref).transpose(1, 2, 0)          # (q+1, d, B)
    ours = torch.stack(taylor_coefficients(
        odt.models.fitzhugh_nagumo(device="cpu").f, torch.from_numpy(u),
        torch.from_numpy(p), 0.0, 3,
    )).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-13)


def test_taylor_high_order_raises():
    prob = odt.models.fitzhugh_nagumo(device="cpu")
    with pytest.raises(NotImplementedError, match="jet"):
        taylor_coefficients(prob.f, prob.u0, prob.p, 0.0, 6)
