#!/usr/bin/env python3
"""The group-of-lanes kernels of two source trees side by side on one card:
an earlier commit's (there the EK1 sampler and the adaptive EK1 smoother
run one thread per member) and this tree's.

    git archive <commit> | tar -x -C build/parent
    python3 scripts/torch_group_ab.py --parent build/parent

Builds, from both trees and with the flags of ``ops/_build.py``
(``-fmad=false``), ``odefilters_torch/ops/csrc/ek1_fused.cu``,
``ek1_adaptive.cu`` and the float32 time-parallel scan units
(``tp_scan.cu``, ``tp_group*.cu``, those the tree has) into libraries of
their own under ``build/group_ab/``, prints each build's registers and
spills from ``ptxas``, and runs both builds' C entry points on the same
inputs, at the main shapes of ``chip_smoke.py``, float32: ``ekd_sampler``
(S = 1 and 8) and ``ekd_smoother`` on the fused EK1 filter kernel's stream
of 8192 FitzHugh-Nagumo members over 500 steps (``chip_smoke.EK1Case``);
``ek1_adaptive_smoother`` on the adaptive EK1 stream of 8192 members over
(0, 20), abstol 1e-6, reltol 1e-4 (``chip_smoke.EK1AdaptiveCase``); and
the scan kernels on synthetic elements at N = 16384 (the totals scan at D =
8; all three at D = 6). Checks the two builds' outputs bit for bit against
each other, then times them with CUDA events in the order parent, this
tree, this tree, parent (each the median of 20 after 3 warm-ups). The
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
from odefilters_torch.ops import tp_scan as ts  # noqa: E402

LIBS = {"ek1_fused": ("ek1_fused.cu",),
        "ek1_adaptive": ("ek1_adaptive.cu",),
        "tp": ("tp_scan.cu", "tp_group.cu", "tp_group16.cu", "tp_group32.cu")}
KERNELS = ("ekd_sampler_kernel", "ekd_smoother_kernel",
           "ek1_adaptive_smoother_kernel", "tp_totals_scan_group_kernelIfLi8",
           "tp_chunk_scan_group_kernelIfLi8", "tp_fixup_group_kernelIfLi8")


def nvcc(args):
    proc = subprocess.run([_build._nvcc(), *args], capture_output=True,
                          text=True)
    return proc.stdout + proc.stderr, proc.returncode


def build_lib(tree: Path, units, out: Path, pool):
    """The units of ``tree`` that it has, compiled in parallel on ``pool``
    and linked into the library ``out``: (log, rc)."""
    csrc = tree / "odefilters_torch" / "ops" / "csrc"
    srcs = [csrc / u for u in units if (csrc / u).is_file()]
    objs = [out.with_name(f"{out.stem}.{s.stem}.o") for s in srcs]
    flags = [*_build.NVCC_FLAGS, "-fmad=false", "-I", str(csrc), "-c"]
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

    out_dir = ROOT / "build" / "group_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    trees = {"parent": args.parent.resolve(), "this tree": ROOT}
    jobs = {(who, lib): out_dir / f"{who.replace(' ', '_')}_{lib}.so"
            for who in trees for lib in LIBS}
    libs = {}
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as outer, \
            concurrent.futures.ThreadPoolExecutor(16) as inner:
        futs = {key: outer.submit(build_lib, trees[key[0]], LIBS[key[1]],
                                  path, inner)
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
                    entry = next((k for k in KERNELS if k in line
                                  and "If" in line), None)
                    if entry:
                        print(f"{who}: {line.split('function')[1].strip()}")
                elif entry and ("Used" in line or "spill" in line):
                    print("    " + line.split("ptxas info    :")[-1].strip())

    P, I = ctypes.c_void_p, ctypes.c_int
    D_ = ctypes.POINTER(ctypes.c_double)
    argtypes = {"ekd_sampler_f32": (P, P, P, I, I, I, D_, P),
                "ekd_smoother_f32": (P, P, P, I, I, D_, P),
                "ek1_adaptive_smoother_f32": (P,) * 5 + (I, I, I, D_, P),
                "tp_chunk_scan_f32": (I, I, P, P, I, P),
                "tp_totals_scan_f32": (I, I, P, P, P, P),
                "tp_fixup_f32": (I, I, P, P, P, I, P)}
    home = {"ekd_sampler_f32": "ek1_fused", "ekd_smoother_f32": "ek1_fused",
            "ek1_adaptive_smoother_f32": "ek1_adaptive"}
    fns = {}
    for name, types in argtypes.items():
        for who in trees:
            fn = getattr(libs[who, home.get(name, "tp")], name)
            fn.argtypes, fn.restype = types, ctypes.c_int
            fns[who, name] = fn

    def call(who, name, *a):
        rc = fns[who, name](*a, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{who} {name}: CUDA error {rc}")

    B, T = cs.B_MAIN, cs.T_MAIN
    c = cs.EK1Case(B, T, torch.float32, cs.TSPAN_MAIN, cs.S_MAIN,
                   numpy_normals=False)
    st = c.states_kernel()
    k_s = _launch.host_consts(c.skw["At"], c.skw["QLt"], scalars=(c.pinv0,))
    z1 = c.z[:, :1].contiguous()

    def sample(who, z):
        out = torch.empty((T + 1, z.shape[1], 2, B), device=st.device)
        call(who, "ekd_sampler_f32", st.data_ptr(), z.data_ptr(),
             out.data_ptr(), B, T, z.shape[1], k_s)
        return out

    def smooth_fixed(who):
        us = torch.empty((T + 1, 2, B), device=st.device)
        sd = torch.empty_like(us)
        call(who, "ekd_smoother_f32", st.data_ptr(), us.data_ptr(),
             sd.data_ptr(), B, T, k_s)
        return torch.cat([us, sd])

    ac = cs.EK1AdaptiveCase(B, torch.float32)
    ast, _, counts = ac.stream_kernel()
    cp = ac.c_pair
    k_a = cp.host()

    def smooth_adaptive(who):
        us = torch.empty((cp.n_save + 1, 2, B), device=ast.device)
        sd = torch.empty_like(us)
        call(who, "ek1_adaptive_smoother_f32", ast.data_ptr(),
             counts.data_ptr(), ac.m0.data_ptr(), us.data_ptr(),
             sd.data_ptr(), B, cp.n_save, cp.max_iters, k_a)
        return torch.cat([us, sd])

    def scans(kind, D):
        """The three phases' runs on one kind's elements at dimension D."""
        code = {"filter": 0, "smooth": 1}[kind]
        el = cs.tp_synth_elements(kind, cs.TP_N, D, torch.float32, 300 + D)
        packed = ts.pack(kind, el)
        pre = ts.tp_chunk_scan(kind, packed)
        tex = ts.tp_totals_scan(kind, pre)
        L, V, _ = pre.shape

        def chunk(who):
            out = torch.empty_like(packed)
            call(who, "tp_chunk_scan_f32", code, D, packed.data_ptr(),
                 out.data_ptr(), L)
            return out

        def totals(who):
            work = pre.new_empty((2, V, ts.NC))
            out = pre.new_empty((V, ts.NC))
            call(who, "tp_totals_scan_f32", code, D, pre[-1].data_ptr(),
                 work.data_ptr(), out.data_ptr())
            return out

        def fixup(who):
            out = torch.empty_like(pre)
            call(who, "tp_fixup_f32", code, D, pre.data_ptr(),
                 tex.data_ptr(), out.data_ptr(), L)
            return out

        return {"chunk": chunk, "totals": totals, "fixup": fixup}

    cases = {"ekd_sampler S=1": lambda who: sample(who, z1),
             f"ekd_sampler S={cs.S_MAIN}": lambda who: sample(who, c.z),
             "ekd_smoother": smooth_fixed,
             "ek1_adaptive_smoother": smooth_adaptive}
    for kind in ("filter", "smooth"):
        cases[f"tp totals D=8 {kind}"] = scans(kind, 8)["totals"]
        for phase, run in scans(kind, 6).items():
            cases[f"tp {phase} D=6 {kind}"] = run
    good = True
    for name, run in cases.items():
        a, b = run("parent"), run("this tree")
        torch.cuda.synchronize()
        same = torch.equal(a, b)
        good &= same
        print(f"{name}: the two builds bit for bit: {same}", flush=True)
    order = ("parent", "this tree", "this tree", "parent")
    times = {}
    for name, run in cases.items():
        times[name] = [cs.time_ms(lambda who=who: run(who), warmup=3,
                                  iters=20) for who in order]
        print(f"float32, {name}, in turns: "
              + ", ".join(f"{w} {t:.4f} ms" for w, t in zip(order,
                                                             times[name])),
              flush=True)
    print(json.dumps({"card": cs.card_line(), "order": order,
                      "ms": times}))
    return 0 if good else 1


if __name__ == "__main__":
    sys.exit(main())
