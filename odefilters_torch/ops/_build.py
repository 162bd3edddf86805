"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

The sources under ``csrc/`` are compiled for Hopper (``sm_90a``) into one
shared library with a plain C interface, at first use, into
``build/odefilters_torch/`` beside the package. The library's name carries
a hash of the sources and flags, so an edited source builds anew and an
unchanged one is reused. Nothing here runs at import time.
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
SOURCES = ("ek0_pair.cu",)
HEADERS = ("fields.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.POINTER(ctypes.c_double)
# C entry points and their argument types: the forward takes
# (m0_p, ps, stream_out, B, T, consts, cuda_stream), the backward
# (stream_in, out, B, T, consts, cuda_stream).
ENTRIES = {
    "ek0_pair_fwd_fhn_f32": (_P, _P, _P, _I, _I, _D, _P),
    "ek0_pair_fwd_fhn_f64": (_P, _P, _P, _I, _I, _D, _P),
    "ek0_pair_bwd_f32": (_P, _P, _I, _I, _D, _P),
    "ek0_pair_bwd_f64": (_P, _P, _I, _I, _D, _P),
}


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
    return BUILD_DIR / f"libodefilters_torch_{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile the kernels unless the library for these sources exists.

    Returns ``{"path", "seconds", "log"}``: seconds spent in ``nvcc`` (0.0
    when the library was already there) and its output, which with
    ``-Xptxas -v`` lists each kernel's registers and spills.
    """
    path = library_path()
    log_path = path.with_suffix(".log")
    if path.is_file():
        log = log_path.read_text() if log_path.is_file() else ""
        return {"path": path, "seconds": 0.0, "log": log}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
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
