"""Package-level checks of the PyTorch port: it never imports JAX, its
kernel wrappers dispatch by device without falling back, problem inputs
convert from numpy, and configurations validate as in the JAX package."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import odefilters as odf
import odefilters_torch as odt
from odefilters_torch import convert
from odefilters_torch.ops import _build
from odefilters_torch.ops import ek0_pair as ep

REPO = Path(__file__).resolve().parents[1]


def test_port_imports_no_jax():
    code = (
        "import sys, odefilters_torch, odefilters_torch.convert, "
        "odefilters_torch.ops.ek0_pair, odefilters_torch.ops.ek0_filter, "
        "odefilters_torch.ops._build, odefilters_torch.ops._launch; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'odefilters' or m.startswith('odefilters.')]; "
        "assert not bad, bad"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_import_disables_tf32():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def _pair_args(device):
    At, Qt, QLt, p = ep.pair_constants(3, 0.1)
    m0 = torch.zeros((4, 2, 8), dtype=torch.float64, device=device)
    ps = torch.zeros((4, 8), dtype=torch.float64, device=device)
    st = torch.zeros((6, 15, 8), dtype=torch.float64, device=device)
    return At, Qt, QLt, p, m0, ps, st


def test_forward_wrapper_rejects_other_devices():
    At, Qt, _, p, m0, ps, _ = _pair_args("meta")
    before = ep.ek0_pair_fwd.launches
    with pytest.raises(ValueError, match="meta"):
        ep.ek0_pair_fwd(odt.models.fitzhugh_nagumo(device="cpu").f, "fhn", m0,
                        ps, At=At, Qt=Qt, pinv0=1 / p[0], pinv1=1 / p[1],
                        t0=0.0, dt=0.1, n_steps=5)
    assert ep.ek0_pair_fwd.launches == before


def test_backward_wrapper_rejects_other_devices():
    At, Qt, QLt, p, _, _, st = _pair_args("meta")
    before = ep.ek0_pair_bwd.launches
    with pytest.raises(ValueError, match="meta"):
        ep.ek0_pair_bwd(st, nq=4, d=2, At=At, Qt=Qt, QLt=QLt, pinv0=1 / p[0],
                        jitter=1e-12)
    assert ep.ek0_pair_bwd.launches == before


def test_cpu_wrappers_run_the_plain_versions():
    At, Qt, QLt, p, _, _, _ = _pair_args("cpu")
    rng = np.random.default_rng(0)
    prob = odt.models.fitzhugh_nagumo(device="cpu")
    m0 = torch.from_numpy(rng.standard_normal((4, 2, 8)))
    ps = prob.p[:, None].expand(4, 8).contiguous()
    kw = dict(At=At, Qt=Qt, pinv0=float(1 / p[0]), pinv1=float(1 / p[1]),
              t0=0.0, dt=0.1, n_steps=5)
    st = ep.ek0_pair_fwd(prob.f, "fhn", m0, ps, **kw)
    torch.testing.assert_close(st, ep.ek0_pair_fwd_plain(prob.f, m0, ps, **kw),
                               rtol=0, atol=0)
    bkw = dict(nq=4, d=2, At=At, Qt=Qt, QLt=QLt, pinv0=float(1 / p[0]),
               jitter=1e-12)
    torch.testing.assert_close(ep.ek0_pair_bwd(st, **bkw),
                               ep.ek0_pair_bwd_plain(st, **bkw), rtol=0, atol=0)


def test_pair_layout_headline_row_width():
    triu, V = ep.pair_layout(4, 2, 1)
    assert triu == [(0, 0), (0, 2), (0, 3), (2, 2), (2, 3), (3, 3)]
    assert V == 15


def test_build_library_name_follows_sources():
    path = _build.library_path()
    assert path.parent == REPO / "build" / "odefilters_torch"
    assert path == _build.library_path()
    for name in _build.SOURCES + _build.HEADERS:
        assert (_build.CSRC / name).is_file()


def test_problem_from_numpy_round_trips_fhn():
    ref = odf.models.fitzhugh_nagumo(u0=(-0.5, 1.2), tspan=(0.0, 5.0))
    prob = convert.problem_from_numpy("fitzhugh_nagumo", np.asarray(ref.u0),
                                      np.asarray(ref.p), ref.tspan,
                                      device="cpu")
    np.testing.assert_array_equal(prob.u0.numpy(), np.asarray(ref.u0))
    np.testing.assert_array_equal(prob.p.numpy(), np.asarray(ref.p))
    assert prob.tspan == (0.0, 5.0) and prob.field == "fhn"
    np.testing.assert_array_equal(
        prob.f(prob.u0, prob.p, 0.0).numpy(),
        np.asarray(ref.f(ref.u0, ref.p, 0.0)),
    )
    with pytest.raises(NotImplementedError, match="not ported"):
        convert.problem_from_numpy("lorenz63", np.zeros(3), np.zeros(3), (0, 1),
                                   device="cpu")


def test_ensemble_inputs_from_numpy():
    u0s = np.asfortranarray(np.arange(12.0).reshape(6, 2))
    ps = np.ones((6, 4))
    u, p = convert.ensemble_inputs_from_numpy(u0s, ps, device="cpu",
                                              dtype=torch.float32)
    assert u.dtype == p.dtype == torch.float32
    assert u.is_contiguous() and p.is_contiguous()
    np.testing.assert_array_equal(u.numpy(), u0s.astype(np.float32))


@pytest.mark.parametrize(
    "make",
    [lambda: odt.models.fitzhugh_nagumo(),
     lambda: odt.ode_problem(odt.models.library.fitzhugh_nagumo_f, [0.0, 1.0],
                             (0, 1)),
     lambda: convert.problem_from_numpy("fitzhugh_nagumo", np.zeros(2),
                                        np.ones(4), (0, 1)),
     lambda: convert.ensemble_inputs_from_numpy(np.zeros((3, 2)),
                                                np.ones((3, 4)))],
    ids=["fitzhugh_nagumo", "ode_problem", "problem_from_numpy",
         "ensemble_inputs_from_numpy"],
)
def test_constructors_default_to_cuda_and_never_fall_back(make):
    """With no device named, the constructors build on the CUDA card; on a
    machine without CUDA they raise instead of returning CPU tensors."""
    if torch.cuda.is_available():
        out = make()
        tensors = out if isinstance(out, tuple) else (out.u0, out.p)
        assert all(t.device.type == "cuda" for t in tensors)
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()


def test_problem_rejects_what_is_not_ported():
    with pytest.raises(NotImplementedError, match="mass"):
        odt.ode_problem(odt.models.fitzhugh_nagumo(device="cpu").f, [0.0, 1.0],
                        (0, 1), mass_matrix=torch.eye(2), device="cpu")
    with pytest.raises(ValueError, match="vector-valued"):
        odt.ode_problem(odt.models.fitzhugh_nagumo(device="cpu").f, 1.0, (0, 1),
                        device="cpu")


def test_algorithm_validation_matches_jax():
    for bad in (dict(diffusionmodel="nope"), dict(order=0)):
        with pytest.raises(ValueError):
            odt.EK0(**bad)
        with pytest.raises(ValueError):
            odf.EK0(**bad)
    with pytest.raises(ValueError, match="MV"):
        odt.EK1(diffusionmodel="fixedMV")
    assert odt.EK0(prior="ibm").prior is None
