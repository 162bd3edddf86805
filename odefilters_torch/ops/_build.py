"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

The sources under ``csrc/`` are compiled for Hopper (``sm_90a``) into one
shared library with a plain C interface, at first use, into
``build/odefilters_torch/`` beside the package: one ``nvcc`` per source,
all started together, then one link. The library's name carries a hash of
the sources and flags, so an edited source builds anew and an unchanged
one is reused. Nothing here runs at import time.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "odefilters_torch"
SOURCES = ("ek1_datalik.cu", "ek1_adaptive.cu", "ek1_fused.cu",
           "ek0_datalik_pd.cu", "ek1d.cu", "ek0_adaptive.cu", "ek0_datalik.cu",
           "ek0_pair.cu", "ek0_filter.cu", "ek0_sample.cu", "kron_grid.cu",
           "tp_scan.cu", "tp_scan_f64.cu", "tp_group.cu", "tp_group_f64.cu",
           "tp_group16.cu", "tp_group16_f64.cu", "tp_group32.cu",
           "tp_group32_f64.cu", "tp_wide.cu", "tp_wide_f64.cu")
HEADERS = ("fields.cuh", "ek0_common.cuh", "ek0_filter.cuh", "ek0_sample.cuh",
           "ek1_fused.cuh", "ek0_adaptive.cuh", "ek1d.cuh", "ek1_adaptive.cuh",
           "ek0_datalik.cuh", "ek0_datalik_pd.cuh", "ek1_datalik.cuh",
           "cooperative.cuh", "kron_grid.cuh", "tp_scan.cuh", "group_mgs.cuh",
           "tp_group.cuh", "ek1_group.cuh", "ek1_adaptive_group.cuh",
           "tp_wide.cuh", "ek1dl_group.cuh")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Per-source flags. The filter's kernels round op by op as their plain
# versions do on the card (no FMA contraction): their log-likelihoods and
# stds carry the innovation at the solver's accuracy floor. Built with
# contraction, at 8192 members x 500 steps they miss the plain lls by
# 1.8e-5 relative in float64 and 2.3e-2 in float32, the stds by 7.5e-4 and
# 0.24, and run no faster on an H100 (scripts/torch_kernel_fma.py).
#
# The sampler's kernels likewise: the stream's s2 carries the innovation and
# scales the noise factor in both, so the sample paths inherit its rounding.
# The pair's too: a static diffusion's sigma^2 is an average of the same
# innovation statistic. Built with contraction, the pair misses its plain
# version at 8192 x 500 by up to 1.1e-4 relative on sigma^2 and 0.18 on the
# dynamic stds in float32 (1.4e-3 in float64), against 0 without. On an H100
# the two builds' float32 times overlap; only the float64 backward is 10-15%
# faster with contraction, about 1% of a solve there
# (scripts/torch_kernel_fma.py --file ek0_pair.cu).
#
# The EK1 kernels likewise: their stream's s2 and the static models'
# sigma^2 are the same innovation statistic. And the adaptive kernels, EK0,
# DiagonalEK1 and EK1: their step loop turns a one-ulp difference into
# another accepted step sequence (the DiagonalEK1 file also holds the
# fixed-grid filter, whose lls and sigma^2 carry the innovation). And the
# data likelihood's, isotropic, per dimension and dense EK1: its ODE
# log-likelihood is the filter's. And the Kron-grid solves': their grid-wide
# sums feed s2, and through it every later step, so they are held to their
# plain versions bit for bit. And the time-parallel scans': a solve's
# sweeps relinearize at the scans' smoothed means, and the kernels are held
# to their plain versions bit for bit (their group kernels too).
SOURCE_FLAGS = {"ek0_filter.cu": ("-fmad=false",),
                "ek0_sample.cu": ("-fmad=false",),
                "ek0_pair.cu": ("-fmad=false",),
                "ek1_fused.cu": ("-fmad=false",),
                "ek0_adaptive.cu": ("-fmad=false",),
                "ek1d.cu": ("-fmad=false",),
                "ek1_adaptive.cu": ("-fmad=false",),
                "ek0_datalik.cu": ("-fmad=false",),
                "ek0_datalik_pd.cu": ("-fmad=false",),
                "ek1_datalik.cu": ("-fmad=false",),
                "kron_grid.cu": ("-fmad=false",),
                "tp_scan.cu": ("-fmad=false",),
                "tp_scan_f64.cu": ("-fmad=false",),
                "tp_group.cu": ("-fmad=false",),
                "tp_group_f64.cu": ("-fmad=false",),
                "tp_group16.cu": ("-fmad=false",),
                "tp_group16_f64.cu": ("-fmad=false",),
                "tp_group32.cu": ("-fmad=false",),
                "tp_group32_f64.cu": ("-fmad=false",),
                "tp_wide.cu": ("-fmad=false",),
                "tp_wide_f64.cu": ("-fmad=false",)}

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.POINTER(ctypes.c_double)
# C entry points and their argument types; the last is the CUDA stream.
# Those that evaluate the vector field exist once per CUDA field
# (_launch.CUDA_FIELDS), named ``<kernel>_<field>_<dtype>``.
# ek0_pair_fwd: (m0_p, ps, stream_out, sig, B, T, mode, consts)
# ek0_pair_bwd: (stream_in, out, B, T, consts)
# ek0_filter: (m0_p, ps, us, var, lls, sig, B, T, mode, consts)
# ek0_filter_grad_fwd: (m0_p, ps, us, stds, lls, stream_out, B, T, consts)
# ek0_filter_grad_bwd: (stream_in, ps, dus, dstds, dlls, dm0_p, dps, B, T,
#                       consts)
# ek0_filter_states: (m0_p, ps, stream_out, B, T, consts)
# ek0_sampler: (stream_in, normals, out, B, T, S, consts)
# ek1_filter_states: (m0_p, ps, lin, stream_out, sig, B, T, mode, smooth,
#                     consts)
# ekd_smoother: (stream_in, us, stds, B, T, consts)
# ekd_sampler: (stream_in, normals, out, B, T, S, consts)
# ek0_adaptive (per order, ORDER_FIELD_ENTRIES): (m0, ps, dt0s, us, stds,
#                lls, counts, B, n_save, max_iters, consts)
# ek0_adaptive_stream: (m0, ps, dt0s, stream_out, lls, counts, B, n_save,
#                       max_iters, consts)
# ek0_adaptive_smoother: (stream_in, counts, m0, us, stds, B, n_save,
#                         max_iters, consts)
# ek0_adaptive_sampler: (stream_in, counts, m0, normals, out, B, S, n_save,
#                        max_iters, consts)
# ek1d_filter: (m0_p, ps, us, stds, lls, sig, B, T, mode, consts)
# ek1d_adaptive, ek1d_adaptive_stream, ek1d_adaptive_smoother,
# ek1_adaptive, ek1_adaptive_stream, ek1_adaptive_smoother: as the
#   ek0_adaptive entries
# ek0_datalik: (m0_p, ps, ys, times, codes, odd, dll, ll, B, T, n_obs,
#               n_odd, consts)
# ek0_datalik_grad_fwd: (m0_p, ps, ys, times, codes, odd, dll, ll,
#                        stream_out, B, T, n_obs, n_odd, consts)
# ek0_datalik_grad_bwd: (stream_in, ps, ys, times, codes, odd, ddll, dall,
#                        dm0_p, dps, dys, B, T, n_obs, n_odd, stop_calib,
#                        consts)
# ek0_datalik_pd: (m0_p, ps, ys, times, codes, dll, ll, B, T, n_rows, jd, yb,
#                  consts)
# ek0_datalik_pd_grad_fwd: (m0_p, ps, ys, times, codes, dll, ll, stream_out,
#                           B, T, n_rows, jd, yb, consts)
# ek0_datalik_pd_grad_bwd: (stream_in, ps, ys, times, codes, ddll, dall,
#                           dm0_p, dps, dys, B, T, n_rows, jd, yb,
#                           stop_calib, consts)
# ek1_datalik: (m0_p, ps, ys, times, codes, dll, ll, B, T, yb, consts)
# ek1_datalik_grad_fwd: (m0_p, ps, ys, times, codes, dll, ll, stream_out, B,
#                        T, yb, consts)
# ek1_datalik_grad_bwd: (stream_in, ps, ys, times, codes, ddll, dall, dm0_p,
#                        dps, dys, B, T, yb, stop_calib, consts)
# ek0_kron_grid: (m0_p, us, var, ll, work, N, M, T, save_every, consts)
#                (the Brusselator stencil, cooperative)
# ek1d_kron_grid: (m0_p, us, var, ll, work, N, M, T, save_every, consts)
#                 (one thread-block cluster, or cooperative above a
#                 cluster's points; ek1d_kron_grid_on_cluster(N, M) says
#                 which, without a stream)
# kron_grid_sync_probe: (blocks, n_barriers); kron_cluster_sync_probe:
#                       (threads, n_barriers)
# tp_chunk_scan: (kind, D, elems, out, L); tp_totals_scan: (kind, D,
#                totals, work, out) (cooperative); tp_fixup: (kind, D,
#                prefixes, t_excl, out, L); tp_chunk_scan_d8,
#                tp_fixup_d8: as those without D, the one-thread kernels
#                at D = 8;
#                tp_group16, tp_group32: (op, kind, D, a, b, work, out,
#                L), the three group kernels at group size 16, 32;
#                tp_wide: (op, kind, D, a, b, work, out, L, workspace),
#                the three kernels above D = 32 (a CTA per combine)
# tp_wide_ws (no stream, no launch): (op, kind, D, L, &values), the values
#             of global workspace that tp_wide needs, as a long long
FIELD_ENTRIES = {
    "ek0_pair_fwd": (_P,) * 4 + (_I, _I, _I, _D, _P),
    "ek0_filter": (_P,) * 6 + (_I, _I, _I, _D, _P),
    "ek0_filter_grad_fwd": (_P,) * 6 + (_I, _I, _D, _P),
    "ek0_filter_grad_bwd": (_P,) * 7 + (_I, _I, _D, _P),
    "ek0_filter_states": (_P, _P, _P, _I, _I, _D, _P),
    "ek1_filter_states": (_P,) * 5 + (_I,) * 4 + (_D, _P),
    "ek0_adaptive_stream": (_P,) * 6 + (_I, _I, _I, _D, _P),
    "ek1d_filter": (_P,) * 6 + (_I, _I, _I, _D, _P),
    "ek1d_adaptive": (_P,) * 7 + (_I, _I, _I, _D, _P),
    "ek1d_adaptive_stream": (_P,) * 6 + (_I, _I, _I, _D, _P),
    "ek1_adaptive": (_P,) * 7 + (_I, _I, _I, _D, _P),
    "ek1_adaptive_stream": (_P,) * 6 + (_I, _I, _I, _D, _P),
    "ek0_datalik": (_P,) * 8 + (_I,) * 4 + (_D, _P),
    "ek0_datalik_grad_fwd": (_P,) * 9 + (_I,) * 4 + (_D, _P),
    "ek0_datalik_grad_bwd": (_P,) * 11 + (_I,) * 5 + (_D, _P),
    "ek0_datalik_pd": (_P,) * 7 + (_I,) * 5 + (_D, _P),
    "ek0_datalik_pd_grad_fwd": (_P,) * 8 + (_I,) * 5 + (_D, _P),
    "ek0_datalik_pd_grad_bwd": (_P,) * 10 + (_I,) * 6 + (_D, _P),
    "ek1_datalik": (_P,) * 7 + (_I,) * 3 + (_D, _P),
    "ek1_datalik_grad_fwd": (_P,) * 8 + (_I,) * 3 + (_D, _P),
    "ek1_datalik_grad_bwd": (_P,) * 10 + (_I,) * 4 + (_D, _P),
}
PLAIN_ENTRIES = {
    "ek0_pair_bwd": (_P, _P, _I, _I, _D, _P),
    "ek0_sampler": (_P, _P, _P, _I, _I, _I, _D, _P),
    "ekd_smoother": (_P, _P, _P, _I, _I, _D, _P),
    "ekd_sampler": (_P, _P, _P, _I, _I, _I, _D, _P),
    "ek0_adaptive_smoother": (_P,) * 5 + (_I, _I, _I, _D, _P),
    "ek1d_adaptive_smoother": (_P,) * 5 + (_I, _I, _I, _D, _P),
    "ek0_adaptive_sampler": (_P,) * 5 + (_I,) * 4 + (_D, _P),
    "ek1_adaptive_smoother": (_P,) * 5 + (_I, _I, _I, _D, _P),
    "ek0_kron_grid": (_P,) * 5 + (_I,) * 4 + (_D, _P),
    "ek1d_kron_grid": (_P,) * 5 + (_I,) * 4 + (_D, _P),
    "tp_chunk_scan": (_I, _I, _P, _P, _I, _P),
    "tp_totals_scan": (_I, _I, _P, _P, _P, _P),
    "tp_fixup": (_I, _I, _P, _P, _P, _I, _P),
    "tp_chunk_scan_d8": (_I, _P, _P, _I, _P),
    "tp_fixup_d8": (_I, _P, _P, _P, _I, _P),
    "tp_group16": (_I, _I, _I, _P, _P, _P, _P, _I, _P),
    "tp_group32": (_I, _I, _I, _P, _P, _P, _P, _I, _P),
    "tp_wide": (_I, _I, _I, _P, _P, _P, _P, _I, _P, _P),
    "tp_wide_ws": (_I, _I, _I, _I, _P),
}
# Those built at several orders q, once per order and field, named
# ``<kernel>_q<q>_<field>_<dtype>``: the adaptive EK0 filter at q = 1, 2, 3
# (the time-parallel solves' warm start runs it at min(q, 3)); every other
# kernel is built at q = 3 only (_launch.kernel_orders).
ORDER_FIELD_ENTRIES = {
    "ek0_adaptive": ((1, 2, 3), (_P,) * 7 + (_I, _I, _I, _D, _P)),
}
ENTRIES = {"kron_grid_sync_probe": (_I, _I, _P),
           "kron_cluster_sync_probe": (_I, _I, _P),
           "ek1d_kron_grid_on_cluster": (_I, _I)}
for _s in ("f32", "f64"):
    for _name, _args in FIELD_ENTRIES.items():
        for _field in ("fhn", "lv"):
            ENTRIES[f"{_name}_{_field}_{_s}"] = _args
    for _name, (_orders, _args) in ORDER_FIELD_ENTRIES.items():
        for _q in _orders:
            for _field in ("fhn", "lv"):
                ENTRIES[f"{_name}_q{_q}_{_field}_{_s}"] = _args
    for _name, _args in PLAIN_ENTRIES.items():
        ENTRIES[f"{_name}_{_s}"] = _args


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cands.append(str(Path(root) / "bin" / "nvcc"))
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels are built from source at first use"
    )


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted(SOURCE_FLAGS.items())).encode())
    return BUILD_DIR / f"libodefilters_torch_{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile the kernels unless the library for these sources exists.

    Returns ``{"path", "seconds", "log"}``: wall seconds spent in ``nvcc``
    (0.0 when the library was already there) and its output, which names
    each unit's wall seconds and, with ``-Xptxas -v``, lists each kernel's
    registers and spills.
    """
    path = library_path()
    log_path = path.with_suffix(".log")
    if path.is_file():
        log = log_path.read_text() if log_path.is_file() else ""
        return {"path": path, "seconds": 0.0, "log": log}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{path.stem}.{os.getpid()}"
    nvcc = _nvcc()
    objs = [BUILD_DIR / f"{tag}.{Path(src).stem}.o" for src in SOURCES]
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(src, ()), "-I", str(CSRC),
             "-c", "-o", str(obj), str(CSRC / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(SOURCES, objs)
    ]
    def finish(proc):
        out = proc.communicate()[0]
        return out, time.perf_counter() - t0

    # each unit's output read on a thread of its own, so that its wall time
    # ends when it does (the log names each unit's seconds)
    with concurrent.futures.ThreadPoolExecutor(len(procs)) as pool:
        done = list(pool.map(finish, procs))
    log = "".join(f"== {src} ({sec:.1f} s)\n{out}"
                  for src, (out, sec) in zip(SOURCES, done))
    tmp = path.with_name(f"{tag}.tmp.so")
    try:
        failed = [src for src, proc in zip(SOURCES, procs) if proc.returncode]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True,
        )
        log += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{log}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    log_path.write_text(log)
    os.replace(tmp, path)
    return {"path": path, "seconds": seconds, "log": log}


@functools.cache
def load() -> ctypes.CDLL:
    """The kernels' library, built if needed, with every entry's argument
    types declared."""
    lib = ctypes.CDLL(str(build()["path"]))
    for name, argtypes in ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
