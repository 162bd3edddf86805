"""What every kernel wrapper of the port shares: the device dispatch, the
checks of a CUDA launch's inputs, the host constants, and the launch of a C
entry point with its count.

Dispatch: a wrapper runs its plain version on CPU tensors, launches its CUDA
kernel on CUDA tensors, and raises on any other device.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from odefilters_torch.ops import _build

# CUDA vector fields the kernels are instantiated for: name -> (d, n_params).
CUDA_FIELDS = {"fhn": (2, 4), "lv": (2, 4)}
# The fields whose functor also has a Jacobian ``jac`` (the EK1 kernels
# evaluate it in the kernel).
CUDA_JAC_FIELDS = frozenset({"fhn", "lv"})
# The fields whose functor also has a Jacobian diagonal ``jac_diag`` (the
# DiagonalEK1 kernels evaluate it in the kernel).
CUDA_JAC_DIAG_FIELDS = frozenset({"fhn", "lv"})
# CUDA grid stencils of the Kron-grid kernels: name -> species ns (square
# (N, N) grids; the diffusivity is the solve's p).
CUDA_GRID_FIELDS = {"brusselator_2d": 2}
# The orders q (nq = q + 1) each kernel family is instantiated for, by its
# wrapper's name (_build.ORDER_FIELD_ENTRIES): the adaptive EK0 filter,
# which the time-parallel solves' warm start runs at min(q, 3) as the JAX
# package does, at q = 1, 2, 3; every other family at q = 3 only
# (ROADMAP.md queue 1, item 5).
CUDA_ORDERS = {name: orders
               for name, (orders, _) in _build.ORDER_FIELD_ENTRIES.items()}
DEFAULT_ORDERS = (3,)


def kernel_orders(name: str) -> tuple:
    """The orders q that the kernel family of wrapper ``name`` is built
    for."""
    return CUDA_ORDERS.get(name, DEFAULT_ORDERS)


def check_order(name: str, nq: int) -> None:
    """Raise ``NotImplementedError`` unless the kernel family of wrapper
    ``name`` is built for order ``nq - 1``."""
    if nq - 1 not in kernel_orders(name):
        raise NotImplementedError(
            f"{name}: the CUDA kernel is built for the orders q in "
            f"{kernel_orders(name)}, got q = {nq - 1} (ROADMAP.md queue 1, "
            "item 5, 'Widen every kernel family')"
        )


def dispatch_device(name: str, t: torch.Tensor) -> str:
    """``"cpu"`` (the plain version runs) or ``"cuda"`` (the kernel
    launches); any other device raises."""
    kind = t.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(
            f"{name}: tensors on device {t.device} are not supported; it "
            "runs its plain PyTorch version on 'cpu' and its CUDA kernel on "
            "'cuda'"
        )
    return kind


def check_cuda_inputs(name: str, tensors: dict, dtype: torch.dtype):
    """Raise unless every tensor has ``dtype``, is contiguous, and all lie
    on one device."""
    for tname, t in tensors.items():
        if t.dtype != dtype:
            raise TypeError(f"{name}: {tname} is {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} must be contiguous")
        if t.device != next(iter(tensors.values())).device:
            raise ValueError(f"{name}: all tensors must be on one device")


def check_field(name: str, field: Optional[str], nq: int, d: int, B: int,
                ps: torch.Tensor, need_jac: bool = False,
                need_jac_diag: bool = False) -> None:
    """Raise unless the kernels of wrapper ``name`` are built for vector
    field ``field`` at order ``nq - 1`` (`check_order`), with ``ps`` of
    shape ``(n_params, B)``, and (with ``need_jac`` / ``need_jac_diag``)
    the field has a CUDA Jacobian / a CUDA Jacobian diagonal."""
    if field not in CUDA_FIELDS:
        raise NotImplementedError(
            f"no CUDA vector field {field!r}; the kernels are built for "
            f"{sorted(CUDA_FIELDS)}"
        )
    if need_jac and field not in CUDA_JAC_FIELDS:
        raise NotImplementedError(
            f"{name}: the CUDA vector field {field!r} has no Jacobian; the "
            f"EK1 kernels evaluate one in the kernel ({sorted(CUDA_JAC_FIELDS)})"
        )
    if need_jac_diag and field not in CUDA_JAC_DIAG_FIELDS:
        raise NotImplementedError(
            f"{name}: the CUDA vector field {field!r} has no Jacobian "
            f"diagonal; the DiagonalEK1 kernels evaluate one in the kernel "
            f"({sorted(CUDA_JAC_DIAG_FIELDS)})"
        )
    check_order(name, nq)
    d_f, n_params = CUDA_FIELDS[field]
    if d != d_f or tuple(ps.shape) != (n_params, B):
        raise ValueError(
            f"{name}: field {field!r} takes m0_p (nq, {d_f}, B) and ps "
            f"({n_params}, B); got nq={nq}, d={d}, B={B} and ps "
            f"{tuple(ps.shape)}"
        )


def suffix(dtype: torch.dtype) -> str:
    """The C entry points' dtype suffix."""
    if dtype == torch.float32:
        return "f32"
    if dtype == torch.float64:
        return "f64"
    raise TypeError(f"the kernels take float32 or float64, got {dtype}")


def host_consts(*mats, scalars) -> ctypes.Array:
    """Matrices (row-major) then scalars, as the C side's double array."""
    vals = [float(x) for M in mats for x in np.asarray(M).ravel()]
    vals += [float(x) for x in scalars]
    return (ctypes.c_double * len(vals))(*vals)


def launch(wrapper, device: torch.device, entry: str, *args) -> None:
    """Call C entry point ``entry`` with ``args`` and PyTorch's current
    stream on ``device``; raise if the launch failed, else count it on
    ``wrapper.launches``."""
    fn = getattr(_build.load(), entry)
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}"
                           + _CUDA_ERRORS.get(rc, ""))
    wrapper.launches += 1


# what a code that an entry's own checks return means
_CUDA_ERRORS = {720: " (cudaErrorCooperativeLaunchTooLarge: the cooperative "
                     "grid's CTAs are not all co-resident on this card)"}


def check_ported(*, prior, second_order: bool, mesh) -> None:
    """Raise ``NotImplementedError`` for the fused solves' options that the
    port does not run yet."""
    if prior is not None:
        raise NotImplementedError(
            "IOUP / Matern priors are not ported yet "
            "(ROADMAP.md queue 1, item 5, 'Widen the pair')"
        )
    if second_order:
        raise NotImplementedError(
            "second-order problems are not ported yet "
            "(ROADMAP.md queue 1, item 5, 'Widen the pair')"
        )
    if mesh is not None:
        raise NotImplementedError("mesh= is not supported: the port runs on one card")
