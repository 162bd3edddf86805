"""The fused time-parallel scan of the PyTorch port at state dimensions
other than 8 (``odefilters_torch/ops/tp_scan.py``; on the card its group
kernels, ``ops/csrc/tp_group.cuh``, take any 2 <= D <= 16), against the JAX
package on the CPU in float64.

As in ``test_torch_time_parallel.py``, the scans are held against a
sequential fold of the JAX package's jitted XLA combines (the JAX Pallas
scan in interpret mode takes minutes at these D on a CPU), at the fused
plain path's padded lengths; the solve at D = 6 is held at its fixed point
against the port's sequential fixed-grid EK1 smoother, which earlier test
files hold against the JAX package. Factors compare as ``U U^T``.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import odefilters_torch as odt
from odefilters.parallel import associative_sqrt as jasq
from odefilters_torch import convert
from odefilters_torch.ops import tp_scan as ts
from odefilters_torch.parallel import associative as pa

FAC = {"filter": (2, 4), "smooth": (2,)}
_COMBINE = {"filter": jasq._sqrt_filter_combine,
            "smooth": jasq._sqrt_smooth_combine}


def _elements(kind, n, d, seed):
    """Conditioned elements: transitions 0.5 I plus noise of spectral radius
    ~0.3 whatever d (entries of scale 0.3 sqrt(2 / d)), factors and vectors
    of that scale, so that a product of 1025 transitions stays bounded."""
    rng = np.random.default_rng(seed)
    scale = 0.3 * (2.0 / d) ** 0.5

    def mk(*s):
        return rng.standard_normal(s) * scale

    if kind == "filter":
        return (mk(n, d, d) + 0.5 * np.eye(d), mk(n, d), mk(n, d, d),
                mk(n, d), mk(n, d, d))
    return (mk(n, d, d) + 0.5 * np.eye(d), mk(n, d), mk(n, d, d))


def _jax_fold(kind, elems, reverse=False):
    """The inclusive scan as a sequential fold of the JAX combine, jitted as
    one ``lax.scan`` (the same XLA combine element after element)."""
    combine = _COMBINE[kind]

    @jax.jit
    def fold(leaves):
        first = tuple(x[0] for x in leaves)

        def step(acc, e):
            acc = combine(acc, e)
            return acc, acc

        _, rest = jax.lax.scan(step, first, tuple(x[1:] for x in leaves))
        return tuple(jnp.concatenate([f[None], r]) for f, r in zip(first, rest))

    leaves = [np.asarray(e) for e in elems]
    if reverse:
        leaves = [x[::-1] for x in leaves]
    out = [np.asarray(x) for x in fold(tuple(jnp.asarray(x) for x in leaves))]
    return tuple(x[::-1] for x in out) if reverse else tuple(out)


def _hold(got, ref, kind, rtol, atol):
    for i, (g, r) in enumerate(zip(got, ref)):
        g, r = np.asarray(g), np.asarray(r)
        if i in FAC[kind]:
            g, r = g @ np.swapaxes(g, -1, -2), r @ np.swapaxes(r, -1, -2)
        np.testing.assert_allclose(g, r, rtol=rtol, atol=atol,
                                   err_msg=f"leaf {i}")


@pytest.mark.parametrize("D", [4, 6, 12])
@pytest.mark.parametrize("kind", ["filter", "smooth"])
def test_scans_match_jax_fold_at_other_dims(kind, D):
    """The fused scan's plain versions at N = 1025 (1024 chunks of two rows,
    the tail padded with identities) against the fold of the jitted JAX
    combine at D = 4, 6, 12; the smoother reversed."""
    rev = kind == "smooth"
    elems = _elements(kind, 1025, D, 100 + D)
    ref = _jax_fold(kind, elems, reverse=rev)
    tel = convert.scan_elements_from_numpy(elems, device="cpu")
    assert ts.pack(kind, tel).shape == (2, ts.width(kind, D), ts.NC)
    _hold(ts.fused_associative_scan(kind, tel, reverse=rev), ref, kind,
          rtol=1e-9, atol=1e-12)


def test_ek1_order2_fixed_point_matches_sequential():
    """EK1(order=2) (D = 6) on FitzHugh-Nagumo over (0, 20) on N = 1025
    steps (two chunk rows), the fused scan's plain path with its defaults
    (the warm start) and 2 sweeps, against the sequential fixed-grid
    EK1(order=2) smoother with the fixed diffusion: u within 1e-8 relative
    (the iterated smoother's fixed point against the one-pass smoother:
    ~4e-10 here), sigma2 within 0.05 relative. The sequential smoother's
    plain version takes ~20 ms a step at q = 2: most of this test."""
    N = 1025
    prob = odt.models.fitzhugh_nagumo(tspan=(0.0, 20.0), device="cpu")
    sol = odt.solve_ensemble(prob, odt.EK1(order=2, diffusionmodel="fixed"),
                             prob.u0[None].clone(), prob.p[None].clone(),
                             n_save=N, adaptive=False)
    ts_ = torch.linspace(0.0, 20.0, N + 1, dtype=torch.float64)
    assert pa.resolve_options(prob, odt.EK1(order=2), N,
                              block="fused") == ("fused", 8)
    u, u_std, means, covs, s2 = odt.solve_fixed_parallel(
        prob, odt.EK1(order=2), ts=ts_, block="fused", iterations=2)
    assert u.shape == (N + 1, 2) and covs.shape == (N + 1, 6, 6)
    assert bool(torch.isfinite(u_std).all())
    np.testing.assert_allclose(u, sol.us[..., 0], rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(float(s2), float(sol.diffusions[0]),
                               rtol=0.05)


def _card(d):
    return types.SimpleNamespace(
        d=d, u0=types.SimpleNamespace(device=torch.device("cuda", 0)))


def test_card_warm_start_runs_the_kernels_order(monkeypatch):
    """The warm start's adaptive EK0 solve runs at min(q, 3) on the CPU, as
    in the JAX package, and on the card at the order the ops layer reports
    its kernel runs (3) whatever q; warm_start_trajectory passes that order
    on."""
    from odefilters_torch.ops import ek1_adaptive

    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    assert [ek1_adaptive.runnable_order(q, cpu) for q in (1, 2, 3)] == [1, 2, 3]
    assert [ek1_adaptive.runnable_order(q, cuda) for q in (1, 2, 3)] == [3] * 3
    assert [pa.warm_start_order(q, cpu) for q in (1, 2, 3, 5)] == [1, 2, 3, 3]
    assert [pa.warm_start_order(q, cuda) for q in (1, 2, 3, 5)] == [3, 3, 3, 3]
    seen = []

    def fake(f, u0, p, tspan, n_save, q, **kw):
        seen.append(q)
        return (torch.zeros((n_save + 1, 2), dtype=torch.float32),)

    monkeypatch.setattr(ek1_adaptive, "solve_adaptive_single", fake)
    prob = odt.models.fitzhugh_nagumo(tspan=(0.0, 2.0), device="cpu")
    ts_ = torch.linspace(0.0, 2.0, 51, dtype=torch.float64)
    for q in (1, 2, 5):
        pa.warm_start_trajectory(prob, ts_, 8, q)
    assert seen == [1, 2, 3]


@pytest.mark.parametrize("D, q, d", [(6, 2, 2), (12, 3, 3), (16, 3, 4)])
def test_card_fused_default_runs_up_to_the_kernels_largest_dimension(D, q, d):
    """On the card the fused scan is the default above 1024 grid points at
    every D = d (q+1) up to tp_scan.CUDA_D_MAX = 16, global and windowed."""
    alg = odt.EK1(order=q)
    assert d * (q + 1) == D <= ts.CUDA_D_MAX
    assert pa.resolve_options(_card(d), alg, 16384) == ("fused", 8)
    assert pa.resolve_options(_card(d), odt.EK0(order=q), 16384,
                              windows=16) == ("fused", 8)


def test_cuda_inputs_take_the_state_dimension_from_the_elements():
    """The kernels' input check reads D from the packed width and refuses
    D above 16, naming the ROADMAP item; widths that are no element's, or
    inputs of two widths, raise ValueError."""
    for kind, D in (("filter", 6), ("smooth", 12), ("filter", 2)):
        packed = torch.zeros((1, ts.width(kind, D), ts.NC),
                             dtype=torch.float64)
        assert ts._check_cuda("tp_chunk_scan", kind, {"packed": packed}) == D
    big = torch.zeros((1, ts.width("filter", 18), ts.NC), dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="item 5"):
        ts._check_cuda("tp_chunk_scan", "filter", {"packed": big})
    odd = torch.zeros((1, ts.width("smooth", 6) + 1, ts.NC),
                      dtype=torch.float64)
    with pytest.raises(ValueError, match="element width"):
        ts._check_cuda("tp_chunk_scan", "smooth", {"packed": odd})
    a = torch.zeros((1, ts.width("smooth", 6), ts.NC), dtype=torch.float64)
    b = torch.zeros((ts.width("smooth", 4), ts.NC), dtype=torch.float64)
    with pytest.raises(ValueError, match="every input"):
        ts._check_cuda("tp_fixup", "smooth", {"prefixes": a, "t_excl": b})
