"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

The sources under ``csrc/`` are compiled for Hopper (``sm_90a``) into one
shared library with a plain C interface, at first use, into
``build/odefilters_torch/`` beside the package: one ``nvcc`` per source,
all started together, then one link. The library's name carries a hash of
the sources and flags, so an edited source builds anew and an unchanged
one is reused. Nothing here runs at import time.
"""

from __future__ import annotations

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
SOURCES = ("ek1_fused.cu", "ek0_pair.cu", "ek0_filter.cu", "ek0_sample.cu")
HEADERS = ("fields.cuh", "ek0_common.cuh", "ek0_filter.cuh", "ek0_sample.cuh",
           "ek1_fused.cuh")
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
# sigma^2 are the same innovation statistic.
SOURCE_FLAGS = {"ek0_filter.cu": ("-fmad=false",),
                "ek0_sample.cu": ("-fmad=false",),
                "ek0_pair.cu": ("-fmad=false",),
                "ek1_fused.cu": ("-fmad=false",)}

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.POINTER(ctypes.c_double)
# C entry points and their argument types; the last is the CUDA stream.
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
ENTRIES = {}
for _s in ("f32", "f64"):
    ENTRIES.update({
        f"ek0_pair_fwd_fhn_{_s}": (_P,) * 4 + (_I, _I, _I, _D, _P),
        f"ek0_pair_bwd_{_s}": (_P, _P, _I, _I, _D, _P),
        f"ek0_filter_fhn_{_s}": (_P,) * 6 + (_I, _I, _I, _D, _P),
        f"ek0_filter_grad_fwd_fhn_{_s}": (_P,) * 6 + (_I, _I, _D, _P),
        f"ek0_filter_grad_bwd_fhn_{_s}": (_P,) * 7 + (_I, _I, _D, _P),
        f"ek0_filter_states_fhn_{_s}": (_P, _P, _P, _I, _I, _D, _P),
        f"ek0_sampler_{_s}": (_P, _P, _P, _I, _I, _I, _D, _P),
        f"ek1_filter_states_fhn_{_s}": (_P,) * 5 + (_I,) * 4 + (_D, _P),
        f"ekd_smoother_{_s}": (_P, _P, _P, _I, _I, _D, _P),
        f"ekd_sampler_{_s}": (_P, _P, _P, _I, _I, _I, _D, _P),
    })


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
    (0.0 when the library was already there) and its output, which with
    ``-Xptxas -v`` lists each kernel's registers and spills.
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
    outs = [proc.communicate()[0] for proc in procs]
    log = "".join(f"== {src}\n{out}" for src, out in zip(SOURCES, outs))
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
