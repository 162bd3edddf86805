"""Fused blocked associative scans of square-root elements: the plain
PyTorch versions and the wrappers of the three CUDA kernels that replace
the JAX package's Pallas scan kernels (``odefilters/parallel/
pallas_scan.py``).

=============================  ============================================
this module                    ``odefilters/parallel/pallas_scan.py``
=============================  ============================================
``filter_combine``             ``_filter_combine_lists``
``smooth_combine``             ``_smooth_combine_lists``
``chunk_scan_plain`` /         ``_chunk_scan_kernel`` (CUDA:
``tp_chunk_scan``              ``csrc/tp_scan.cuh::tp_chunk_scan_kernel``
                               at D = 8, ``csrc/tp_group.cuh::
                               tp_chunk_scan_group_kernel`` at any other D
                               up to 32, ``csrc/tp_wide.cuh::
                               tp_chunk_scan_wide_kernel`` above)
``totals_scan_plain`` /        ``_totals_scan_kernel`` (CUDA:
``tp_totals_scan``             ``tp_totals_scan_group_kernel`` up to D =
                               32, ``tp_totals_scan_wide_kernel`` above;
                               cooperative)
``fixup_plain`` / ``tp_fixup``  ``_fixup_kernel`` (CUDA: ``tp_fixup_kernel``
                               at D = 8, ``tp_fixup_group_kernel`` at any
                               other D up to 32, ``tp_fixup_wide_kernel``
                               above)
``fused_associative_scan``     ``pallas_associative_scan``
=============================  ============================================

The scan is the JAX package's three-phase blocked scan over ``NC = 1024``
chunks of ``L = ceil(N / 1024)`` consecutive elements (the tail padded
with identity elements):

1. the inclusive prefix within each chunk, row by row;
2. the inclusive Hillis-Steele scan of the 1024 chunk totals, ten rounds
   of ``combine(x[i - shift], x[i])`` where ``i >= shift``, then one
   exclusive shift (``roll`` by one; entry 0 is unused);
3. ``combine(T_excl[c], prefix[k][c])`` for every row k of every chunk
   c > 0; chunk 0 passes through.

It equals ``associative_scan(combine, elems)`` up to floating-point
reassociation and the re-orthogonalization of factors (compare ``U U^T``).
``kind`` is ``"filter"`` for elements ``(A, b, U, eta, Z)`` or
``"smooth"`` for ``(E, g, P)``, batched on axis 0; ``reverse=True`` scans
the flipped sequence and flips the result, as JAX does.

Layout: a packed tensor ``(L, V, 1024)`` holds element ``c L + k`` at row
k, column c, its leaves one after the other (matrices row-major): V = 3 D^2
+ 2 D (filter) or 2 D^2 + D (smooth); the chunk index is contiguous, so a
thread per chunk reads coalesced. The totals are ``(V, 1024)``.

Rounding, decided once for the plain versions and the kernels alike: every
sum over an index runs in index order, ``x_0 y_0 + x_1 y_1 + ...``; the
modified Gram-Schmidt is `ek0_sample.list_mgs_tril`'s (pivots ``sqrt(max(ss,
1e-30))``, reciprocals ``1 / R``); the Cholesky solves and forward
substitutions divide by the pivots. The plain versions run these loops
vectorized over the other indices, which changes no rounding, and the
kernels are built without FMA contraction: they equal the plain versions
bit for bit. (The kernels skip the terms through the identity blocks'
structural zeros, which adds or subtracts exact zeros in the plain ones.)

Dispatch: each wrapper runs its plain version on CPU tensors, launches its
CUDA kernel on CUDA tensors (state dimension D from the elements, 2 <= D <=
``CUDA_D_MAX``: up to ``GROUP_D_MAX`` a group of lanes per combine, except
the D = 8 chunk scan and fixup, a thread per combine; above it a CTA per
combine, ``csrc/tp_wide.cuh``, its workspace in shared memory or, where
that is too small, in a global buffer the wrapper allocates), raises on any
other device, and counts its launches in ``.launches``. No VJP, as in
JAX.
"""

from __future__ import annotations

import ctypes
import math

import torch

from odefilters_torch.linalg import matmul_unrolled, solve_triangular_unrolled
from odefilters_torch.ops import _build, _launch

NC = 1024                       # chunks
KINDS = {"filter": ("mat", "vec", "mat", "vec", "mat"),
         "smooth": ("mat", "vec", "mat")}
_KIND_CODE = {"filter": 0, "smooth": 1}
GROUP_D_MAX = 32                # the group kernels' largest D (tp_group.cuh)
CUDA_D_MAX = 96                 # the kernels' largest D: the largest held
                                # on the card (csrc/tp_wide.cuh: D_MAX)


def width(kind: str, D: int) -> int:
    """Values per packed element: V."""
    return sum(D * D if k == "mat" else D for k in KINDS[kind])


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"kind must be 'filter' or 'smooth', got {kind!r}")


def _dim(kind: str, V: int) -> int:
    a = 3 if kind == "filter" else 2
    b = 2 if kind == "filter" else 1
    D = int(round((-b + math.sqrt(b * b + 4 * a * V)) / (2 * a)))
    if width(kind, D) != V:
        raise ValueError(f"{V} values is no {kind} element width")
    return D


# --------------------------------------------------------------------------
# small-matrix algebra on (..., D, D) / (..., D), sums in index order
# (the unrolled products and forward substitution keep that order)
# --------------------------------------------------------------------------


def _T(X):
    return X.transpose(-1, -2)


def _mm(A, B):
    """``A @ B``, each entry summed over k in index order at every D the
    kernels take (`linalg.matmul_unrolled` hands products above 16 to
    ``A @ B``)."""
    return matmul_unrolled(A, B, max_unroll=None)


def _mv(A, x):
    """``A x``: entry i is ``A[i][0] x[0] + A[i][1] x[1] + ...``."""
    return _mm(A, x[..., None])[..., 0]


def _fwd_rows(L, X):
    """Row r of the result solves ``L y = X[r]`` (lower L) by forward
    substitution: ``y[i] = (X[r][i] - L[i][0] y[0] - ...) / L[i][i]``."""
    return _T(solve_triangular_unrolled(L, _T(X), lower=True))


def _cho_solve(L, B):
    """Column c of the result solves ``L L^T x = B[:, c]``: forward, then
    back substitution (k ascending, as the kernels' ``ek0::cho_solve``),
    dividing by the pivots."""
    y = solve_triangular_unrolled(L, B, lower=True)
    D = L.shape[-1]
    x = [None] * D
    for i in range(D - 1, -1, -1):
        s = y[..., i, :]
        for k in range(i + 1, D):
            s = s - L[..., k, i, None] * x[k]
        x[i] = s / L[..., i, i, None]
    return torch.stack(x, dim=-2)


def _mgs(V):
    """Lower ``L`` with ``L L^T = V^T V`` for the ``(..., K, D)`` stack V,
    by modified Gram-Schmidt column by column (`ek0_sample.list_mgs_tril`,
    vectorized over the rows and the later columns). The stack is held
    row-major over its K rows, so that each term of a sum over the rows is
    one contiguous slice; the terms are added in index order. On the card
    the K products of a column are formed in one launch (its plain version
    is bound by launches), on the CPU one at a time into one buffer (bound
    by memory traffic): the same values either way."""
    K, D = V.shape[-2:]
    Vk = V.movedim(-2, 0).clone(memory_format=torch.contiguous_format)
    R = torch.zeros(V.shape[:-2] + (D, D), dtype=V.dtype, device=V.device)
    term = None if V.is_cuda else torch.empty_like(Vk[0])
    for j in range(D):
        col = Vk[..., j]                              # (K, ...)
        sq = col * col
        ss = sq[0].clone()
        for k in range(1, K):
            ss.add_(sq[k])
        rjj = torch.sqrt(torch.clamp(ss, min=1e-30))
        R[..., j, j] = rjj
        q = col * (1.0 / rjj)
        if j + 1 < D:
            rest = Vk[..., j + 1:]                    # (K, ..., D - j - 1)
            if term is None:
                prod = q[..., None] * rest
                r = prod[0].clone()
                for k in range(1, K):
                    r.add_(prod[k])
            else:
                t = term[..., :D - j - 1]
                r = q[0][..., None] * rest[0]
                for k in range(1, K):
                    r.add_(torch.mul(q[k][..., None], rest[k], out=t))
            R[..., j, j + 1:] = r
            rest.sub_(r * q[..., None])
    return _T(R)


def _stack2(X, Y):
    """The ``(..., 2D, D)`` stack ``[X^T ; Y^T]``."""
    return torch.cat([_T(X), _T(Y)], dim=-2)


def filter_combine(ea, eb):
    """``_filter_combine_lists`` on ``(..., D, D)`` / ``(..., D)`` leaves, in
    the kernels' order of operations."""
    Ai, bi, Ui, etai, Zi = ea
    Aj, bj, Uj, etaj, Zj = eb
    D = Ai.shape[-1]
    eye = torch.eye(D, dtype=Ai.dtype, device=Ai.device).expand(Ai.shape)
    W = _mm(_T(Ui), Zj)
    Lw = _mgs(torch.cat([_T(W), eye], dim=-2))        # chol(I + W W^T)
    Lv = _mgs(torch.cat([W, eye], dim=-2))            # chol(I + W^T W)
    # AjT = Aj (I - Ui (Lw Lw^T)^-1 W Zj^T)
    G = _cho_solve(Lw, _mm(W, _T(Zj)))
    AjT = _mm(Aj, eye - _mm(Ui, G))
    A = _mm(AjT, Ai)
    b = _mv(AjT, bi + _mv(Ui, _mv(_T(Ui), etaj))) + bj
    # U = tril of [(Aj V1)^T ; Uj^T], V1 = Ui Lw^-T
    U = _mgs(_stack2(_mm(Aj, _fwd_rows(Lw, Ui)), Uj))
    # eta = Ai^T [r - Zj (Lv Lv^T)^-1 W^T Ui^T r] + etai, r = etaj - Zj Zj^T bi
    r = etaj - _mv(Zj, _mv(_T(Zj), bi))
    inner = _cho_solve(Lv, _mv(_T(W), _mv(_T(Ui), r))[..., None])[..., 0]
    eta = _mv(_T(Ai), r - _mv(Zj, inner)) + etai
    # Z = tril of [(Ai^T V2)^T ; Zi^T], V2 = Zj Lv^-T
    Z = _mgs(_stack2(_mm(_T(Ai), _fwd_rows(Lv, Zj)), Zi))
    return A, b, U, eta, Z


def smooth_combine(ea, eb):
    """``_smooth_combine_lists`` (``ea`` the accumulated suffix), in the
    kernels' order of operations."""
    Ea, ga, Pa = ea
    Eb, gb, Pb = eb
    return (_mm(Eb, Ea), gb + _mv(Eb, ga), _mgs(_stack2(Pb, _mm(Eb, Pa))))


_COMBINES = {"filter": filter_combine, "smooth": smooth_combine}


# --------------------------------------------------------------------------
# packed layout
# --------------------------------------------------------------------------


def _leaves(kind, x, D):
    """The leaves of packed elements ``x`` ``(..., V, n)`` as ``(..., n, D,
    D)`` / ``(..., n, D)`` views."""
    out, off = [], 0
    for k in KINDS[kind]:
        w = D * D if k == "mat" else D
        part = x[..., off:off + w, :].movedim(-1, -2)
        out.append(part.reshape(part.shape[:-1] + ((D, D) if k == "mat"
                                                   else (D,))))
        off += w
    return tuple(out)


def _pack_leaves(kind, leaves, D):
    """Inverse of `_leaves`: ``(..., n, D, D)`` / ``(..., n, D)`` leaves to
    ``(..., V, n)``."""
    parts = [(e.reshape(e.shape[:-2] + (D * D,)) if k == "mat" else e)
             .movedim(-2, -1) for k, e in zip(KINDS[kind], leaves)]
    return torch.cat(parts, dim=-2).contiguous()


def identity_elements(kind, n, D, dtype, device):
    """``n`` identity elements: ``(I, 0, 0, 0, 0)`` or ``(I, 0, 0)``."""
    eye = torch.eye(D, dtype=dtype, device=device).expand(n, D, D)
    zm = torch.zeros((n, D, D), dtype=dtype, device=device)
    zv = torch.zeros((n, D), dtype=dtype, device=device)
    return (eye, zv, zm, zv, zm) if kind == "filter" else (eye, zv, zm)


def pack(kind, elems):
    """Elements (leading axis N) padded with identities to ``L * 1024``
    and packed ``(L, V, 1024)``, element ``c L + k`` at row k, column c."""
    _check_kind(kind)
    leaves = tuple(elems)
    N, D = leaves[0].shape[0], leaves[0].shape[-1]
    L = max(math.ceil(N / NC), 1)
    pad = L * NC - N
    if pad:
        ident = identity_elements(kind, pad, D, leaves[0].dtype,
                                  leaves[0].device)
        leaves = tuple(torch.cat([e, i], dim=0) for e, i in zip(leaves, ident))
    # element c L + k -> (k, c)
    grid = tuple(e.reshape((NC, L) + e.shape[1:]).transpose(0, 1)
                 for e in leaves)
    return _pack_leaves(kind, grid, D)


def unpack(kind, packed, N):
    """The first N elements of a packed ``(L, V, 1024)`` tensor."""
    L, V, _ = packed.shape
    D = _dim(kind, V)
    return tuple(e.transpose(0, 1).reshape((NC * L,) + e.shape[2:])[:N]
                 for e in _leaves(kind, packed, D))


# --------------------------------------------------------------------------
# the three phases: plain versions
# --------------------------------------------------------------------------


def chunk_scan_plain(kind, packed):
    """Phase 1: ``prefix[k][c] = combine(prefix[k-1][c], e[k][c])``,
    ``prefix[0] = e[0]``."""
    _check_kind(kind)
    D = _dim(kind, packed.shape[1])
    combine = _COMBINES[kind]
    rows = [_leaves(kind, packed[0], D)]
    for k in range(1, packed.shape[0]):
        rows.append(combine(rows[-1], _leaves(kind, packed[k], D)))
    return torch.stack([_pack_leaves(kind, r, D) for r in rows], dim=0)


def totals_scan_plain(kind, prefixes):
    """Phase 2: the Hillis-Steele scan of the chunk totals ``prefixes[-1]``
    and the exclusive shift; ``(V, 1024)``."""
    _check_kind(kind)
    D = _dim(kind, prefixes.shape[1])
    combine = _COMBINES[kind]
    x = _leaves(kind, prefixes[-1], D)
    idx = torch.arange(NC, device=prefixes.device)
    shift = 1
    while shift < NC:
        comb = combine(tuple(torch.roll(v, shift, dims=0) for v in x), x)
        x = tuple(torch.where((idx >= shift).reshape((NC,) + (1,) * (c.dim() - 1)),
                              c, v) for c, v in zip(comb, x))
        shift *= 2
    return _pack_leaves(kind, tuple(torch.roll(v, 1, dims=0) for v in x), D)


def fixup_plain(kind, prefixes, t_excl):
    """Phase 3: ``combine(t_excl[c], prefixes[k][c])`` for c > 0, chunk 0
    passed through."""
    _check_kind(kind)
    L, V, _ = prefixes.shape
    D = _dim(kind, V)
    pref = _leaves(kind, prefixes, D)
    T = tuple(t.expand((L,) + t.shape) for t in _leaves(kind, t_excl, D))
    comb = _COMBINES[kind](T, pref)
    first = torch.zeros((1, NC), dtype=torch.bool, device=prefixes.device)
    first[0, 0] = True
    out = tuple(torch.where(first.reshape((1, NC) + (1,) * (c.dim() - 2)), p, c)
                for c, p in zip(comb, pref))
    return _pack_leaves(kind, out, D)


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------


def _check_cuda(name, kind, tensors):
    """The state dimension D of the packed elements, after checking that
    the CUDA kernels take them: one dtype and device, contiguous, ``(...,
    V, 1024)`` with one V, and 2 <= D <= CUDA_D_MAX."""
    _check_kind(kind)
    x = next(iter(tensors.values()))
    _launch.check_cuda_inputs(name, tensors, x.dtype)
    V = x.shape[-2]
    D = _dim(kind, V)
    for tname, t in tensors.items():
        if t.shape[-2:] != (V, NC):
            raise ValueError(
                f"{name}: {tname} is {tuple(t.shape)}; every input holds "
                f"{kind} elements of {V} values in {NC} chunks"
            )
    if not 2 <= D <= CUDA_D_MAX:
        raise NotImplementedError(
            f"{name}: the CUDA kernels take state dimensions 2 <= D <= "
            f"{CUDA_D_MAX}, got D = {D}: {CUDA_D_MAX} is the largest D at "
            "which the CTA-per-combine kernels (csrc/tp_wide.cuh) are held "
            "on the card against their plain versions (ROADMAP queue 3)"
        )
    return D


def _launch_scan(wrapper, name, op, kind, D, x, a, b=None, work=None,
                 out=None, L=1):
    """Launch scan kernel ``op`` (0 chunk scan, 1 totals scan, 2 fixup) on
    ``x``'s card: the entries of ``tp_group.cu`` up to ``GROUP_D_MAX``,
    ``tp_wide.cu``'s above, with the global workspace its plan asks for."""
    sfx = _launch.suffix(x.dtype)
    code = _KIND_CODE[kind]
    ptr = [t.data_ptr() if t is not None else None for t in (a, b, work, out)]
    if D <= GROUP_D_MAX:
        entry = (f"{name}_{sfx}", code, D) + {
            0: (ptr[0], ptr[3], L), 1: (ptr[0], ptr[2], ptr[3]),
            2: (ptr[0], ptr[1], ptr[3], L)}[op]
        _launch.launch(wrapper, x.device, *entry)
        return
    n = ctypes.c_longlong(0)
    with torch.cuda.device(x.device):
        rc = getattr(_build.load(), f"tp_wide_ws_{sfx}")(op, code, D, L,
                                                         ctypes.byref(n))
    if rc:
        raise RuntimeError(f"tp_wide_ws_{sfx}: CUDA error {rc}")
    ws = x.new_empty((n.value,)) if n.value else None
    _launch.launch(wrapper, x.device, f"tp_wide_{sfx}", op, code, D, *ptr, L,
                   ws.data_ptr() if ws is not None else None)


def tp_chunk_scan(kind, packed):
    """Phase 1 on ``packed`` ``(L, V, 1024)``: the plain version on the
    CPU, on CUDA ``tp_chunk_scan_kernel`` (a thread per chunk) at D = 8,
    ``tp_chunk_scan_group_kernel`` (a group of lanes per chunk) at any
    other D up to 32 and ``tp_chunk_scan_wide_kernel`` (a CTA per chunk)
    above."""
    if _launch.dispatch_device("tp_chunk_scan", packed) == "cpu":
        return chunk_scan_plain(kind, packed)
    D = _check_cuda("tp_chunk_scan", kind, {"packed": packed})
    out = torch.empty_like(packed)
    _launch_scan(tp_chunk_scan, "tp_chunk_scan", 0, kind, D, packed, packed,
                 out=out, L=packed.shape[0])
    return out


tp_chunk_scan.launches = 0


def tp_totals_scan(kind, prefixes):
    """Phase 2 on the chunk prefixes ``(L, V, 1024)``: the plain version on
    the CPU, the cooperative ``tp_totals_scan_group_kernel`` (a group of
    lanes per chunk total, a grid barrier between rounds) on CUDA, or above
    D = 32 ``tp_totals_scan_wide_kernel`` (a CTA per total). Returns
    ``(V, 1024)``."""
    if _launch.dispatch_device("tp_totals_scan", prefixes) == "cpu":
        return totals_scan_plain(kind, prefixes)
    D = _check_cuda("tp_totals_scan", kind, {"prefixes": prefixes})
    V = prefixes.shape[1]
    work = prefixes.new_empty((2, V, NC))
    out = prefixes.new_empty((V, NC))
    _launch_scan(tp_totals_scan, "tp_totals_scan", 1, kind, D, prefixes,
                 prefixes[-1], work=work, out=out)
    return out


tp_totals_scan.launches = 0


def tp_fixup(kind, prefixes, t_excl):
    """Phase 3: the plain version on the CPU, on CUDA ``tp_fixup_kernel`` (a
    thread per element) at D = 8, ``tp_fixup_group_kernel`` (a group of
    lanes per element) at any other D up to 32 and ``tp_fixup_wide_kernel``
    (a CTA per element) above. Returns ``(L, V, 1024)``."""
    if _launch.dispatch_device("tp_fixup", prefixes) == "cpu":
        return fixup_plain(kind, prefixes, t_excl)
    D = _check_cuda("tp_fixup", kind, {"prefixes": prefixes,
                                       "t_excl": t_excl})
    out = torch.empty_like(prefixes)
    _launch_scan(tp_fixup, "tp_fixup", 2, kind, D, prefixes, prefixes,
                 b=t_excl, out=out, L=prefixes.shape[0])
    return out


tp_fixup.launches = 0


def fused_associative_scan(kind, elems, *, reverse=False):
    """Inclusive prefix scan of square-root elements (leading axis N) by
    the three phases: pad, pack, `tp_chunk_scan`, `tp_totals_scan`,
    `tp_fixup`, unpack. ``reverse=True`` gives the suffix scan ``r[i] =
    combine(r[i+1], x[i])``."""
    _check_kind(kind)
    leaves = tuple(elems)
    N = leaves[0].shape[0]
    if reverse:
        leaves = tuple(torch.flip(e, (0,)) for e in leaves)
    packed = pack(kind, leaves)
    prefixes = tp_chunk_scan(kind, packed)
    finals = tp_fixup(kind, prefixes, tp_totals_scan(kind, prefixes))
    out = unpack(kind, finals, N)
    return tuple(torch.flip(u, (0,)) for u in out) if reverse else out
