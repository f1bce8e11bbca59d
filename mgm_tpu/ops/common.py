"""Shared array helpers for the compute path."""
from __future__ import annotations

import jax.numpy as jnp

INF = float("inf")


def shift_fill(a: jnp.ndarray, off: int, axis: int, fill) -> jnp.ndarray:
    """Return b with b[i] = a[i - off] along `axis`; vacated slots = fill.

    This reproduces the reference's Dvec/image boundary convention where
    out-of-range reads yield +inf (dvec.cc:129) or another fill value.
    """
    if off == 0:
        return a
    n = a.shape[axis]
    pad = [(0, 0)] * a.ndim
    if off > 0:
        pad[axis] = (off, 0)
        sl = [slice(None)] * a.ndim
        sl[axis] = slice(0, n)
    else:
        pad[axis] = (0, -off)
        sl = [slice(None)] * a.ndim
        sl[axis] = slice(-off, n - off)
    return jnp.pad(a, pad, constant_values=fill)[tuple(sl)]


def shift_edge(a: jnp.ndarray, off: int, axis: int) -> jnp.ndarray:
    """Shift with clamp-to-edge (Neumann) boundary (img_tools.h:76-84)."""
    if off == 0:
        return a
    n = a.shape[axis]
    pad = [(0, 0)] * a.ndim
    pad[axis] = (max(off, 0), max(-off, 0))
    sl = [slice(None)] * a.ndim
    sl[axis] = slice(0, n) if off > 0 else slice(-off, n - off)
    return jnp.pad(a, pad, mode="edge")[tuple(sl)]


def fmin3(a, b, c):
    return jnp.minimum(jnp.minimum(a, b), c)
