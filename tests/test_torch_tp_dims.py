"""The fused time-parallel scan of the PyTorch port at state dimensions
other than 8 (``odefilters_torch/ops/tp_scan.py``; on the card its group
kernels, ``ops/csrc/tp_group.cuh``, take any 2 <= D <= 32, and its
CTA-per-combine kernels, ``ops/csrc/tp_wide.cuh``, any 32 < D <= 96),
against the JAX package on the CPU in float64.

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


@pytest.mark.parametrize("kind, D", [(k, D) for D in (4, 6, 12, 18, 40)
                                     for k in ("filter", "smooth")]
                         + [("smooth", 32)])
def test_scans_match_jax_fold_at_other_dims(kind, D):
    """The fused scan's plain versions at N = 1025 (1024 chunks of two rows,
    the tail padded with identities) against the fold of the jitted JAX
    combine at D = 4, 6, 12, 18, 40 (above 32: the card's CTA-per-combine
    kernels), and 32 for the smoothing elements; the smoother reversed.
    (`test_filter_combine_matches_jax_at_32` holds the filtering combine at
    D = 32.)"""
    rev = kind == "smooth"
    elems = _elements(kind, 1025, D, 100 + D)
    ref = _jax_fold(kind, elems, reverse=rev)
    tel = convert.scan_elements_from_numpy(elems, device="cpu")
    assert ts.pack(kind, tel).shape == (2, ts.width(kind, D), ts.NC)
    _hold(ts.fused_associative_scan(kind, tel, reverse=rev), ref, kind,
          rtol=1e-9, atol=1e-12)


def test_filter_combine_matches_jax_at_32():
    """The fused scan's plain filtering combine at D = 32, the largest the
    card's kernels take, on four element pairs against the JAX combine
    called eagerly (the JAX list combines take ~18 s a call at this D, and
    their jitted fold does not compile within minutes), at the scans'
    tolerances."""
    a, b = _elements("filter", 4, 32, 7), _elements("filter", 4, 32, 8)
    ref = jasq._sqrt_filter_combine(tuple(map(jnp.asarray, a)),
                                    tuple(map(jnp.asarray, b)))
    got = ts._COMBINES["filter"](tuple(map(torch.tensor, a)),
                                 tuple(map(torch.tensor, b)))
    _hold(got, ref, "filter", rtol=1e-9, atol=1e-12)


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
    """The warm start's adaptive EK0 solve runs at min(q, 3), as in the JAX
    package, on the CPU and on the card alike: the ops layer reports that
    the card's adaptive EK0 kernel runs each of those orders (the other
    adaptive filters q = 3 only); warm_start_trajectory passes that order
    on."""
    from odefilters_torch.ops import ek1_adaptive

    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    assert [ek1_adaptive.runnable_order(q, cpu) for q in (1, 2, 3)] == [1, 2, 3]
    assert [ek1_adaptive.runnable_order(q, cuda) for q in (1, 2, 3)] == [1, 2, 3]
    assert [ek1_adaptive.runnable_order(q, cuda, "ek1_adaptive")
            for q in (1, 2, 3)] == [3, 3, 3]
    assert [pa.warm_start_order(q, cpu) for q in (1, 2, 3, 5)] == [1, 2, 3, 3]
    assert [pa.warm_start_order(q, cuda) for q in range(1, 6)] == [1, 2, 3, 3, 3]
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


@pytest.mark.parametrize("D, q, d", [(6, 2, 2), (12, 3, 3), (16, 3, 4),
                                     (18, 5, 3), (24, 5, 4), (32, 7, 4)])
def test_card_fused_default_runs_up_to_the_kernels_largest_dimension(D, q, d):
    """On the card the fused scan is the default above 1024 grid points at
    every D = d (q+1) up to tp_scan.CUDA_D_MAX (the group kernels' D <= 32
    here; `test_card_fused_default_runs_above_32` the rest), global and
    windowed (Lorenz-63 and SEIR at q = 5 among them)."""
    alg = odt.EK1(order=q)
    assert d * (q + 1) == D <= ts.CUDA_D_MAX
    assert pa.resolve_options(_card(d), alg, 16384) == ("fused", 8)
    assert pa.resolve_options(_card(d), odt.EK0(order=q), 16384,
                              windows=16) == ("fused", 8)


def test_cuda_inputs_take_the_state_dimension_from_the_elements():
    """The kernels' input check reads D from the packed width and takes
    every D up to 96 (the group kernels to 32, a CTA per combine above),
    refusing D above it, naming the reason (96 is the largest D held on the
    card); widths that are no element's, or inputs of two widths, raise
    ValueError. (The inputs are meta tensors: nothing is allocated.)"""
    for kind, D in (("filter", 6), ("smooth", 12), ("filter", 2),
                    ("filter", 18), ("smooth", 32), ("filter", 33),
                    ("smooth", 40), ("filter", 96)):
        packed = torch.empty((1, ts.width(kind, D), ts.NC),
                             dtype=torch.float64, device="meta")
        assert ts._check_cuda("tp_chunk_scan", kind, {"packed": packed}) == D
    assert ts.CUDA_D_MAX == 96 and ts.GROUP_D_MAX == 32
    big = torch.empty((1, ts.width("filter", 97), ts.NC),
                      dtype=torch.float64, device="meta")
    with pytest.raises(NotImplementedError,
                       match="D = 97: 96 is the largest D at which the "
                             "CTA-per-combine kernels .* are held on the "
                             "card"):
        ts._check_cuda("tp_chunk_scan", "filter", {"packed": big})
    odd = torch.zeros((1, ts.width("smooth", 6) + 1, ts.NC),
                      dtype=torch.float64)
    with pytest.raises(ValueError, match="element width"):
        ts._check_cuda("tp_chunk_scan", "smooth", {"packed": odd})
    a = torch.zeros((1, ts.width("smooth", 6), ts.NC), dtype=torch.float64)
    b = torch.zeros((ts.width("smooth", 4), ts.NC), dtype=torch.float64)
    with pytest.raises(ValueError, match="every input"):
        ts._check_cuda("tp_fixup", "smooth", {"prefixes": a, "t_excl": b})


def test_check_fused_dim_takes_up_to_32():
    """``solve_fixed_parallel``'s check on the card: D = d (q+1) <= 32 runs
    the fused scan (the group kernels), and so do D = 33, 40 and 96 (a CTA
    per combine); D = 98 raises NotImplementedError naming why (96 is the
    largest D held on the card); the CPU and the blocked scan are not
    refused."""
    for d, q in ((3, 5), (4, 5), (4, 7), (8, 3), (3, 10), (10, 3),
                 (8, 11)):
        pa._check_fused_dim(_card(d), odt.EK1(order=q), "fused", True)
    with pytest.raises(NotImplementedError,
                       match="D = 98: 96 is the largest D at which the "
                             "CTA-per-combine kernels .* are held on the "
                             "card"):
        pa._check_fused_dim(_card(14), odt.EK1(order=6), "fused", True)
    pa._check_fused_dim(_card(14), odt.EK1(order=6), "fused", False)
    pa._check_fused_dim(_card(14), odt.EK1(order=6), 128, True)


@pytest.mark.parametrize("windows", [None, 16])
def test_card_fused_default_runs_above_32(windows):
    """On the card the fused scan is the default above 1024 grid points at
    D = 40 too: a d = 10 torch field (a damped linear oscillator chain) at
    q = 3, with ``warm_start=0`` (no CUDA field of d >= 9 exists for the
    warm start's adaptive kernel), global and windowed; the problem runs
    on the CPU here, so the card is a stand-in with its device."""

    def chain(u, p, t):
        return -0.1 * u + torch.roll(u, 1, 0) - torch.roll(u, -1, 0)

    prob = odt.ode_problem(chain, torch.linspace(0.0, 1.0, 10,
                                                 dtype=torch.float64),
                           (0.0, 1.0), device="cpu")
    card = types.SimpleNamespace(
        d=prob.d, u0=types.SimpleNamespace(device=torch.device("cuda", 0)))
    alg = odt.EK1(order=3)
    assert card.d * (alg.order + 1) == 40
    assert pa.resolve_options(card, alg, 16384, warm_start=0,
                              windows=windows) == ("fused", 0)
    assert pa.resolve_options(card, alg, 16384, windows=windows) == (
        "fused", 8)
    # on the CPU the same problem resolves to the blocked scan
    assert pa.resolve_options(prob, alg, 16384, warm_start=0,
                              windows=windows)[0] != "fused"


def test_kernel_families_take_their_orders():
    """The orders each CUDA kernel family is built for: the adaptive EK0
    filter (the warm start's) at q = 1, 2, 3; every other family at q = 3,
    refusing q = 2 with NotImplementedError naming ROADMAP queue 1 item 5.
    The checks run before any launch, on CPU tensors too."""
    from odefilters_torch.ops import _launch, ek0_adaptive, ek1_fused

    assert _launch.kernel_orders("ek0_adaptive") == (1, 2, 3)
    ps = torch.zeros((4, 5), dtype=torch.float64)
    for q in (1, 2, 3):
        _launch.check_field("ek0_adaptive", "fhn", q + 1, 2, 5, ps)
    for name in ("ek0_adaptive_stream", "ek1_adaptive", "ek1d_adaptive",
                 "ek0_filter", "ek0_pair_fwd", "ek1_filter_states"):
        _launch.check_field(name, "fhn", 4, 2, 5, ps)
        with pytest.raises(NotImplementedError, match="item 5"):
            _launch.check_field(name, "fhn", 3, 2, 5, ps)
    for name in ("ekd_smoother", "ekd_sampler"):
        with pytest.raises(NotImplementedError, match="item 5"):
            ek1_fused._check_kernel_shape(name, 3, 2)
    c = ek0_adaptive.controller(2, 0.0, 1.0, 4, torch.float64, abstol=1e-6,
                                reltol=1e-4, max_iters=8)
    m0 = torch.zeros((3, 2, 5), dtype=torch.float64)
    st = torch.zeros((8, ek0_adaptive.stream_width(3, 2), 5),
                     dtype=torch.float64)
    counts = torch.zeros((ek0_adaptive.N_COUNTS, 5), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="item 5"):
        ek0_adaptive.check_smoother_inputs(
            "ek0_adaptive_smoother", st, counts, m0, c,
            ek0_adaptive.stream_width(3, 2))
