"""The PyTorch port's adaptive dense EK1 stream + RTS smoother pair against
the JAX package, on the CPU in f64: the plain streaming forward and the
plain smoother against ``ek1_adaptive_fused_smooth`` in interpret mode
(FitzHugh-Nagumo over (0, 2), 1024 members, 8 save intervals, abstol 1e-6,
reltol 1e-4, max_iters 128), held as ``test_torch_ek1_adaptive.py`` holds
the filter (its module docstring; `_hold`).

**Why q = 2 (D = 6).** In interpret mode the JAX smoother's time is the
compile of its unrolled D x D body, not the step count: at q = 3 it took
125 s at abstol 1e-8, reltol 1e-6 and 114 s at this setting on the CPU,
at q = 2 34 s. The plain versions take any order, as the port's other
plain versions do; the CUDA kernels are built for q = 3 and are held
against the plain versions there on the card (``chip_smoke.py``, phase
25). The q = 3 comparison is the one test here marked ``slow``, run by
hand (``pytest -m slow``).
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
from odefilters_torch.ops import ek1_adaptive as e1a
from test_torch_ek1_adaptive import _hold

D = 2
TSPAN = (0.0, 2.0)
S = 8
B_JAX = 1024           # the JAX kernels' smallest ensemble (one block)
TOL = dict(abstol=1e-6, reltol=1e-4)
MAX_ITERS = 128


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _jax_init(jprob, u0s, ps, q):
    """The JAX front door's per-member Taylor init and initial step, as
    numpy ``(m0 (q+1, d, B), dt0s (B,))``."""
    from odefilters.solve import initial_dt as jinitial_dt
    from odefilters.taylor import taylor_coefficients

    def init_one(u0, p):
        m = jnp.stack(taylor_coefficients(jprob.f, u0, p, TSPAN[0], q))
        pr = odf.ode_problem(jprob.f, u0, TSPAN, p=p)
        return m, jinitial_dt(pr, q, TOL["abstol"], TOL["reltol"])

    m0, dt0 = jax.vmap(init_one)(jnp.asarray(u0s), jnp.asarray(ps))
    return np.array(m0.transpose(1, 2, 0)), np.array(dt0)


def _both(q):
    """One perturbed FHN ensemble through the JAX pair (interpret mode) and
    the port's plain stream and smoother at order q: ``(port (us, stds,
    lls, counts), jax (us, stds, lls, nacc, nrej, failed))``."""
    jprob = odf.models.fitzhugh_nagumo(tspan=TSPAN)
    rng = np.random.default_rng(0)
    u0s = np.asarray(jprob.u0)[None] + 0.05 * rng.standard_normal((B_JAX, D))
    ps = np.broadcast_to(np.asarray(jprob.p), (B_JAX, 4)).copy()
    m0, dt0s = _jax_init(jprob, u0s, ps, q)
    with pltpu.force_tpu_interpret_mode():
        out = pk.ek1_adaptive_fused_smooth(
            jprob.f, jprob.jac, jnp.asarray(m0), jnp.asarray(ps.T),
            jnp.asarray(dt0s), *TSPAN, S, q, max_iters=MAX_ITERS, **TOL)
    ref = [np.asarray(x) for x in out]
    prob = odt.models.fitzhugh_nagumo(device="cpu", tspan=TSPAN)
    c = ea.controller(q, *TSPAN, S, torch.float64, max_iters=MAX_ITERS, **TOL)
    m0_t = torch.from_numpy(np.ascontiguousarray(m0))
    st, lls, counts = e1a.ek1_adaptive_stream_plain(
        prob.f, prob.jac, m0_t, torch.from_numpy(np.ascontiguousarray(ps.T)),
        torch.from_numpy(np.ascontiguousarray(dt0s)), c)
    us, stds = e1a.ek1_adaptive_smoother_plain(st, counts, m0_t, c)
    return (us, stds, lls, counts), ref


@pytest.fixture(scope="module")
def pair_q2():
    return _both(2)


def test_pair_matches_jax(pair_q2):
    """The smoothed save-grid means and per-dimension stds and the filter's
    lls against the JAX pair at q = 2 (measured: no member's counts
    differ; the means agree to 1.2e-14 relative, the stds to 3.1e-5 (99th
    percentile 8.1e-7), the lls to 1.2e-9)."""
    (us, stds, lls, counts), ref = pair_q2
    assert tuple(us.shape) == (S + 1, D, B_JAX) == tuple(stds.shape)
    _hold(us, stds, lls, counts[0], counts[1], counts[2].bool(), ref)


def test_smoothing_moves_the_interior(pair_q2):
    """The step counts lie inside the stream (about 65 accepted steps a
    member of 128 rows), and smoothing shrinks the interior stds: most lie
    below the last save point's, where smoothed = filtered (measured:
    63%)."""
    (us, stds, _, counts), _ = pair_q2
    nacc = counts[0].long()
    assert int(nacc.min()) > S and int(nacc.max()) < MAX_ITERS
    assert (stds[1:] > 0).all()
    assert (stds[1:-1] < stds[-1]).float().mean() > 0.5


@pytest.mark.slow
def test_pair_matches_jax_at_q3():
    """The same at q = 3 (the kernels' order): 91 s on one worker, most
    of it the JAX smoother's interpret-mode compile."""
    port, ref = _both(3)
    _hold(*port[:3], port[3][0], port[3][1], port[3][2].bool(), ref)
