"""Subpixel refinement (vfit / parabola / cubic / parabolaOCV).

Vectorised replicas of refine.h, driven as in mgm_refine.h:40-70: a
pixel is refined only if [o-1, o+2] lies inside its S window; the fits
read the *post-overcount-fix* aggregated volume S.  All IEEE corner
cases (NaN guards comparing false, 0/0, inf clamps) follow the C
expressions exactly.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _vfit(v0, v1, v2, v3):
    guard = (v1 > v0) & (v1 > v2)
    slope = jnp.where((v2 - v1) < (v0 - v1), v0 - v1, v2 - v1)
    x = (v0 - v2) / (2.0 * slope)
    vm = v2 + (x - 1.0) * slope
    return jnp.where(guard, v1, vm), jnp.where(guard, 0.0, x)


def _parabola(v0, v1, v2, v3, ocv: bool):
    guard = (v1 > v0) & (v1 > v2)
    c = v1
    b = (v2 - v0) / 2.0
    a = (v2 - 2.0 * v1 + v0) / 2.0
    if ocv:
        a, b = a * 2.0, b * 2.0
        a = jnp.where(a > 1.0, a, 1.0)   # NaN -> 1.0, like the C ternary
        x = (-b + a) / (2.0 * a)
    else:
        x = -b / (2.0 * a)
    x = jnp.where(x > 1.0, 1.0, x)
    x = jnp.where(x < -1.0, -1.0, x)
    vm = (a * x + b) * x + c
    return jnp.where(guard, v1, vm), jnp.where(guard, 0.0, x)


def _cubic_interp(p0, p1, p2, p3, x):
    return p1 + 0.5 * x * (p2 - p0 + x * (
        2.0 * p0 - 5.0 * p1 + 4.0 * p2 - p3 + x * (3.0 * (p1 - p2) + p3 - p0)))


def _cubic(p0, p1, p2, p3):
    take1 = p1 < p2
    pmin = jnp.where(take1, p1, p2)
    xmin = jnp.where(take1, 0.0, 1.0)
    a = 0.5 * 3.0 * (3.0 * (p1 - p2) + p3 - p0)
    b = 2.0 * p0 - 5.0 * p1 + 4.0 * p2 - p3
    c = 0.5 * (p2 - p0)
    discr = b * b - 4.0 * a * c
    sq = jnp.sqrt(discr)  # NaN when discr < 0 -> conditions false
    for z in ((-b + sq) / (2.0 * a), (-b - sq) / (2.0 * a)):
        t = _cubic_interp(p0, p1, p2, p3, z)
        upd = (z > 0.0) & (z < 1.0) & (t < pmin)
        pmin = jnp.where(upd, t, pmin)
        xmin = jnp.where(upd, z, xmin)
    return pmin, xmin


_FITS = {"vfit": _vfit,
         "parabola": partial(_parabola, ocv=False),
         "parabolaOCV": partial(_parabola, ocv=True),
         "cubic": _cubic}


@partial(jax.jit, static_argnames=("method",))
def subpixel_refine(S, disp, cost, s_lo, s_hi, gmin, *, method: str):
    """S: (N, H, W, L); disp/cost: (N, H, W); gmin: (N,)."""
    if method == "none":
        return disp, cost
    L = S.shape[-1]
    o = (disp - gmin[:, None, None].astype(jnp.float32)).astype(jnp.int32)
    ok = (o - 1 >= s_lo) & (o + 2 <= s_hi)
    oc = jnp.clip(o, 1, max(L - 3, 1))
    idx = oc[..., None] + jnp.arange(-1, 3)
    v = jnp.take_along_axis(S, jnp.clip(idx, 0, L - 1), axis=-1)
    vmin, dx = _FITS[method](v[..., 0], v[..., 1], v[..., 2], v[..., 3])
    disp2 = (o + dx).astype(jnp.float32) + gmin[:, None, None]
    return (jnp.where(ok, disp2, disp).astype(jnp.float32),
            jnp.where(ok, vmin, cost).astype(jnp.float32))
