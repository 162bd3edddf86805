#!/usr/bin/env python3
"""Two kernels of two source trees side by side on one card: the dense EK1
data likelihood's adjoint (``ek1_datalik.cu``) and the Kron-grid
DiagonalEK1 solve (``kron_grid.cu``) of an earlier commit's tree and of
this one.

    git archive <commit> | tar -x -C build/parent
    python3 scripts/torch_redesign_ab.py --parent build/parent

Builds both trees' ``odefilters_torch/ops/csrc/kron_grid.cu`` and
``ek1_datalik.cu`` with the flags of ``ops/_build.py`` (``-fmad=false``)
into libraries of their own under ``build/redesign_ab/``, prints each
build's registers and spills from ``ptxas``, and runs both builds' C entry
points on the same inputs, at the main shapes of ``chip_smoke.py``:
``ek1_datalik_grad_bwd`` on the full-state row of phase 36 (8192
Lotka-Volterra members over 120 steps, 9 observations; its gradient
forward's stream; ``yb`` and ``stop_calib`` both ways; float32 and
float64) and ``ek1d_kron_grid`` on phase 38's Brusselator (N = 70, 1000
steps, float32 and float64) and on phase 37's grid larger than a cluster
holds (N = 160, 40 steps, where both trees run the cooperative kernel).
Also builds this tree's ``kron_grid.cu`` a second time with
``-DKRON_CLUSTER=8``, so that the DiagonalEK1 cluster of 8 CTAs (portable)
is held and timed against the package's 16. Checks each pair of builds'
outputs bit for bit against each other, then times them with CUDA events
in the order a, b, b, a (each the median of 20 after 3 warm-ups). The
card's name and power limit come first, a JSON line of the times last.
Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from odefilters_torch.ops import _build, _launch  # noqa: E402

LIBS = {"kron_grid": ("kron_grid.cu",), "ek1_datalik": ("ek1_datalik.cu",)}
# this tree's DiagonalEK1 cluster at 8 CTAs (the package's is 16)
EIGHT = "this tree at 8 CTAs"
KERNELS = ("ek1d_kron_grid_kernel", "ek1d_kron_cluster_kernel",
           "ek1_datalik_grad_bwd_kernel")


def nvcc(args):
    proc = subprocess.run([_build._nvcc(), *args], capture_output=True,
                          text=True)
    return proc.stdout + proc.stderr, proc.returncode


def build_lib(tree: Path, units, out: Path, pool, defines=()):
    """The units of ``tree`` compiled in parallel on ``pool`` (with the
    macros ``defines``) and linked into the library ``out``: (log, rc)."""
    csrc = tree / "odefilters_torch" / "ops" / "csrc"
    srcs = [csrc / u for u in units]
    objs = [out.with_name(f"{out.stem}.{s.stem}.o") for s in srcs]
    flags = [*_build.NVCC_FLAGS, "-fmad=false", *defines, "-I", str(csrc),
             "-c"]
    done = list(pool.map(lambda so: nvcc([*flags, "-o", str(so[1]),
                                          str(so[0])]), zip(srcs, objs)))
    log = "".join(text for text, _ in done)
    if any(rc for _, rc in done):
        return log, 1
    link, rc = nvcc([*_build.ARCH, "-shared", "-o", str(out),
                     *map(str, objs)])
    return log + link, rc


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="the other source tree (an unpacked git archive)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("a CUDA card is required")
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    print(cs.card_line(), flush=True)

    out_dir = ROOT / "build" / "redesign_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    trees = {"parent": args.parent.resolve(), "this tree": ROOT}
    jobs = {(who, lib): out_dir / f"{who.replace(' ', '_')}_{lib}.so"
            for who in trees for lib in LIBS}
    jobs[EIGHT, "kron_grid"] = out_dir / "this_tree_8_kron_grid.so"
    libs = {}
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as outer, \
            concurrent.futures.ThreadPoolExecutor(8) as inner:
        futs = {key: outer.submit(
                    build_lib, trees.get(key[0], ROOT), LIBS[key[1]], path,
                    inner, ("-DKRON_CLUSTER=8",) if key[0] == EIGHT else ())
                for key, path in jobs.items()}
        _build.load()  # the package's, for the inputs
        for (who, lib), fut in futs.items():
            log, rc = fut.result()
            if rc:
                print(f"nvcc failed on {who}'s {lib}:\n{log}")
                return 1
            libs[who, lib] = ctypes.CDLL(str(jobs[who, lib]))
            entry = None
            for line in log.splitlines():
                if "Compiling entry" in line:
                    entry = next((k for k in KERNELS if k in line), None)
                    if entry:
                        print(f"{who}: {line.split('function')[1].strip()}")
                elif entry and ("Used" in line or "spill" in line):
                    print("    " + line.split("ptxas info    :")[-1].strip())

    P, I = ctypes.c_void_p, ctypes.c_int
    D_ = ctypes.POINTER(ctypes.c_double)

    def fn(who, lib, name, types):
        f = getattr(libs[who, lib], name)
        f.argtypes, f.restype = types, ctypes.c_int
        return f

    def call(f, *a):
        rc = f(*a, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{f.__name__}: CUDA error {rc}")

    cases, pairs = {}, {}
    # the dense EK1 adjoint, phase 36's full-state row (and per-member data)
    from odefilters_torch.ops import ek1_datalik as e1d

    ts = cs.dl_times(cs.DL_T_MAIN, "on")
    for dtype in (torch.float32, torch.float64):
        sfx = _launch.suffix(dtype)
        bwd = {who: fn(who, "ek1_datalik", f"ek1_datalik_grad_bwd_lv_{sfx}",
                       (P,) * 10 + (I,) * 4 + (D_, P)) for who in trees}
        for per_member in (False, True):
            case = cs.DataLikEK1(cs.B_MAIN, cs.DL_T_MAIN, dtype, ts,
                                 cs.DL_SPREAD, None, cs.DL_NOISE,
                                 per_member)
            st = case.grad_fwd()[2]
            T, V, B = st.shape
            n_obs, d_obs = case.ys.shape[:2]
            consts = e1d._host_consts(case.consts)
            ddll, dall = case.cts

            def adjoint(who, stop, case=case, st=st, consts=consts,
                        ddll=ddll, dall=dall, f=bwd, B=B, T=T, n_obs=n_obs,
                        d_obs=d_obs):
                new = dict(dtype=st.dtype, device=st.device)
                dm0 = torch.empty((cs.Q + 1, 2, B), **new)
                dps = torch.empty(tuple(case.ps.shape), **new)
                dy = torch.zeros((n_obs, d_obs, B), **new)
                call(f[who], st.data_ptr(), case.ps.data_ptr(),
                     case.ys.data_ptr(), case.table.times.data_ptr(),
                     case.table.codes.data_ptr(), ddll.data_ptr(),
                     dall.data_ptr(), dm0.data_ptr(), dps.data_ptr(),
                     dy.data_ptr(), B, T, int(case.ys.ndim == 3), int(stop),
                     consts)
                return torch.cat([dm0.reshape(-1), dps.reshape(-1),
                                  dy.reshape(-1)])

            for stop in (True, False):
                data = "per-member data" if per_member else "shared data"
                cases[f"{sfx} ek1_datalik_grad_bwd, {data}, calib_grad="
                      f"{not stop}"] = (lambda who, a=adjoint, s=stop:
                                        a(who, s))
    # the Kron-grid DiagonalEK1 solve: phase 38's Brusselator and phase
    # 37's grid larger than a cluster holds
    from odefilters_torch.ops import kron_grid as kg

    grids = ((cs.KG_N, cs.KG_T, cs.KG_SE,
              (cs.KG_TSPAN[1] - cs.KG_TSPAN[0]) / cs.KG_T),
             (cs.KG_N_COOP, cs.KG_T_BIG, cs.KG_SE_CHECK, cs.KG_DT_CHECK))
    for dtype in (torch.float32, torch.float64):
        sfx = _launch.suffix(dtype)
        solve_f = {who: fn(who, "kron_grid", f"ek1d_kron_grid_{sfx}",
                           (P,) * 5 + (I,) * 4 + (D_, P))
                   for who in (*trees, EIGHT)}
        for N, T, se, dt in grids:
            kc = cs.KronGrid(True, N, T, se, dtype, dt)
            kw = kc.plain_kw
            consts = _launch.host_consts(
                kw["At"], kw["Qt"], scalars=kg.kernel_scalars(
                    kw["Qt"], kw["pinv0"], kw["pinv1"], 2 * N * N)
                + kg._grid_consts("brusselator_2d", cs.KG_ALPHA, N, N, 2,
                                  cs.Q + 1))
            nb = -(-N * N // kg.KRON_BLOCK)

            def solve(who, m0_p=kc.m0_p, N=N, T=T, se=se, consts=consts,
                      nb=nb, f=solve_f):
                S1 = T // se + 1
                new = dict(dtype=m0_p.dtype, device=m0_p.device)
                us = torch.empty((S1, 2, N, N), **new)
                var = torch.empty((S1, 2, N, N), **new)
                ll = torch.empty((1,), **new)
                work = torch.empty((2 * (N * N + 3 * nb),), **new)
                call(f[who], m0_p.data_ptr(), us.data_ptr(),
                     var.data_ptr(), ll.data_ptr(), work.data_ptr(), N, N, T,
                     se, consts)
                return torch.cat([us.reshape(-1), var.reshape(-1), ll])

            name = f"{sfx} ek1d_kron_grid N={N} x {T}"
            cases[name] = solve
            if N == cs.KG_N:
                pairs[f"{name}, 16 against 8 CTAs"] = (solve, ("this tree",
                                                               EIGHT))
    pairs = {**{name: (run, ("parent", "this tree"))
                for name, run in cases.items()}, **pairs}
    good = True
    for name, (run, (a, b)) in pairs.items():
        same = torch.equal(run(a), run(b))
        torch.cuda.synchronize()
        good &= same
        print(f"{name}: {a} and {b} bit for bit: {same}", flush=True)
    times = {}
    for name, (run, (a, b)) in pairs.items():
        order = (a, b, b, a)
        times[name] = {"order": order,
                       "ms": [cs.time_ms(lambda who=who: run(who), warmup=3,
                                         iters=20) for who in order]}
        print(f"{name}, in turns: "
              + ", ".join(f"{w} {t:.4f} ms"
                          for w, t in zip(order, times[name]["ms"])),
              flush=True)
    print(json.dumps({"card": cs.card_line(), "cases": times}))
    return 0 if good else 1


if __name__ == "__main__":
    sys.exit(main())
