"""Associative prefix scans of batched elements (counterpart of
``odefilters/parallel/blocked.py``).

``associative_scan`` is the odd/even recursion of
``jax.lax.associative_scan``, which PyTorch lacks: combine adjacent pairs,
scan the half-length sequence, then fix the even positions. It does
O(N log N) combine work in log2(N) rounds.

``blocked_associative_scan`` splits N elements into nc chunks of ``block``:

  1. the inclusive prefixes within each chunk, sequential in the chunk and
     batched across the nc chunks (``block`` steps of ``(nc, ...)``-shaped
     combines);
  2. one associative scan over the nc chunk totals;
  3. one batched combine of every in-chunk prefix with the total of the
     chunks before it.

Total work O(2N + nc log nc). The combine must be associative and accept
tuples of tensors batched on the leading axes (every combine in
``associative.py`` and ``associative_sqrt.py`` does). With ``reverse=True``
the result is the suffix scan ``r[i] = fn(r[i+1], x[i])``, the accumulated
suffix as the first operand, as in ``lax.associative_scan``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch


def _flip(elems):
    return tuple(torch.flip(e, (0,)) for e in elems)


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``[a0, b0, a1, b1, ...]`` along axis 0 (``len(a) - len(b)`` is 0 or
    1)."""
    out = a.new_empty((a.shape[0] + b.shape[0],) + a.shape[1:])
    out[0::2] = a
    out[1::2] = b
    return out


def associative_scan(fn: Callable, elems, reverse: bool = False):
    """Inclusive prefix scan of the tuple ``elems`` (leading axis N) under
    ``fn``, by the recursion of ``jax.lax.associative_scan``."""
    elems = tuple(elems)
    if reverse:
        elems = _flip(elems)

    def scan(xs):
        n = xs[0].shape[0]
        if n < 2:
            return xs
        reduced = fn(tuple(x[0:-1:2] for x in xs), tuple(x[1::2] for x in xs))
        odd = scan(tuple(reduced))
        if n % 2 == 0:
            even = fn(tuple(o[:-1] for o in odd), tuple(x[2::2] for x in xs))
        else:
            even = fn(odd, tuple(x[2::2] for x in xs))
        even = tuple(torch.cat([x[:1], e], dim=0) for x, e in zip(xs, even))
        return tuple(_interleave(e, o) for e, o in zip(even, odd))

    out = scan(elems)
    return _flip(out) if reverse else tuple(out)


def blocked_associative_scan(combine: Callable, elems, block: Optional[int],
                             reverse: bool = False):
    """Inclusive prefix scan of ``elems`` under ``combine``: exactly
    `associative_scan` up to floating-point reassociation. ``block=None``
    or ``<= 1`` (or N <= block) runs `associative_scan` itself."""
    elems = tuple(elems)
    N = elems[0].shape[0]
    if block is None or block <= 1 or N <= block:
        return associative_scan(combine, elems, reverse=reverse)
    if reverse:
        # the suffix scan is the flipped prefix scan with the same operand
        # order: r[i] = fn(r[i+1], x[i]) becomes s[j] = fn(s[j-1], y[j])
        return _flip(blocked_associative_scan(combine, _flip(elems), block))

    block = int(block)
    nc, rem = divmod(N, block)
    main = tuple(e[: nc * block].reshape(nc, block, *e.shape[1:])
                 for e in elems)
    carry = tuple(m[:, 0] for m in main)
    prefixes = [carry]
    for k in range(1, block):
        carry = tuple(combine(carry, tuple(m[:, k] for m in main)))
        prefixes.append(carry)
    prefixes = tuple(torch.stack(p, dim=0) for p in zip(*prefixes))
    # (block, nc, ...)
    totals = tuple(p[-1] for p in prefixes)
    tot_scan = associative_scan(combine, totals)                # (nc, ...)
    later = tuple(p[:, 1:] for p in prefixes)                   # (block, nc-1)
    S = tuple(t[:-1].expand(block, *t[:-1].shape) for t in tot_scan)
    fixed = combine(S, later)
    out_main = tuple(
        torch.cat([p[:, :1], f], dim=1).transpose(0, 1)
        .reshape(nc * block, *p.shape[2:])
        for p, f in zip(prefixes, fixed))
    if not rem:
        return out_main
    carry = tuple(o[-1] for o in out_main)
    tail = []
    for k in range(nc * block, N):
        carry = tuple(combine(carry, tuple(e[k] for e in elems)))
        tail.append(carry)
    return tuple(torch.cat([o, torch.stack(t, dim=0)], dim=0)
                 for o, t in zip(out_main, zip(*tail)))


def auto_block(N: int, threshold: int = 2048) -> Optional[int]:
    """Default chunk length: ~sqrt(N), a power of two; None below
    ``threshold``, where the plain scan's extra work does not bite."""
    if N < threshold:
        return None
    return 1 << int(round(math.log2(math.sqrt(N))))
