"""Post-processing: NaN-aware median, LR consistency, range update,
backflow warp.  Exact replicas of mgm.cc:68-158 and img_tools.h:203-238.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .common import INF, shift_fill, shift_edge


@partial(jax.jit, static_argnames=("radius",))
def median_filter(img, *, radius: int):
    """NaN-aware square median of (..., H, W); windows are clipped at
    image borders, NaNs excluded, median = sorted[n//2] (upper median,
    img_tools.h:203-238).  All-NaN windows keep their value."""
    if radius <= 0:
        return img
    vals = []
    for j in range(-radius, radius + 1):
        for i in range(-radius, radius + 1):
            vals.append(shift_fill(shift_fill(img, j, -2, jnp.nan), i, -1, jnp.nan))
    stack = jnp.stack(vals, axis=-1)
    finite = ~jnp.isnan(stack)
    n = jnp.sum(finite, axis=-1)
    svals = jnp.sort(jnp.where(finite, stack, INF), axis=-1)
    # one-hot select instead of take_along_axis, so the select fuses
    # into the reduction; exactly one term is non-zero so the sum is
    # bit-identical (NaNs were already replaced by +inf above)
    kidx = jax.lax.broadcasted_iota(jnp.int32, stack.shape,
                                    stack.ndim - 1)
    med = jnp.sum(jnp.where(kidx == (n // 2)[..., None], svals, 0.0),
                  axis=-1)
    return jnp.where(n > 0, med, img)


@jax.jit
def leftright_test(d_left, d_right, tau):
    """Invalidate (NaN) left disparities failing the LR check
    (mgm.cc:68-91).  Note: if the reprojected right disparity is NaN the
    comparison |Rx-x| > tau is false and the pixel *survives*, exactly
    like the C code.

    The d_right lookup at the reprojected column is written as a
    one-hot masked sum-reduction rather than take_along_axis: XLA
    fuses the (H, W, W) compare+select into the reduction loop with
    nothing materialised.  Exactly one term of the sum is non-zero, so
    the f32 result is bit-identical to the gather; NaNs travel as a
    sentinel (disparities are bounded by the image width, so 1e30 is
    unreachable) and are restored by exact compare."""
    H, W = d_left.shape[-2:]
    x = jnp.arange(W, dtype=jnp.float32)
    # C round() = half away from zero
    t = x + d_left
    lx = jnp.sign(t) * jnp.floor(jnp.abs(t) + 0.5)
    ok = (lx >= 0) & (lx < W)  # NaN compares false
    lxi = jnp.clip(jnp.nan_to_num(lx, nan=0.0), 0, W - 1).astype(jnp.int32)
    sent = jnp.float32(1e30)
    dr_s = jnp.where(jnp.isnan(d_right), sent, d_right)
    w_ix = jnp.arange(W, dtype=jnp.int32)
    rdx0 = jnp.sum(jnp.where(lxi[..., :, None] == w_ix,
                             dr_s[..., None, :], 0.0), axis=-1)
    rdx = jnp.where(rdx0 == sent, jnp.nan, rdx0)
    rx = lx + rdx
    bad = jnp.abs(rx - x) > tau
    return jnp.where(ok & ~bad, d_left, jnp.nan)


@partial(jax.jit, static_argnames=("slack", "radius"))
def update_dmin_dmax(disp, lo, hi, *, slack: int = 3, radius: int = 2):
    """Per-pixel disparity range tightening between iterations
    (mgm.cc:120-158): window min/max of the previous solution +- slack
    with clamp-to-edge windows; non-finite pixels contribute the global
    finite min/max.  Returns float (lo2, hi2, gmin, gmax)."""
    finite = jnp.isfinite(disp)
    any_finite = jnp.any(finite, axis=(-2, -1), keepdims=True)
    gmin = jnp.min(jnp.where(finite, disp, INF), axis=(-2, -1), keepdims=True)
    gmax = jnp.max(jnp.where(finite, disp, -INF), axis=(-2, -1), keepdims=True)
    a_lo = jnp.where(finite, disp, gmin)
    a_hi = jnp.where(finite, disp, gmax)
    for axis in (-2, -1):
        mn, mx = a_lo, a_hi
        for s in range(1, radius + 1):
            mn = jnp.minimum(mn, jnp.minimum(shift_edge(a_lo, s, axis),
                                             shift_edge(a_lo, -s, axis)))
            mx = jnp.maximum(mx, jnp.maximum(shift_edge(a_hi, s, axis),
                                             shift_edge(a_hi, -s, axis)))
        a_lo, a_hi = mn, mx
    lo2 = a_lo - slack
    hi2 = a_hi + slack
    upd = jnp.isfinite(lo2) & any_finite
    return (jnp.where(upd, lo2, lo), jnp.where(upd, hi2, hi), gmin, gmax)


def backflow_host(disp: "np.ndarray", v: "np.ndarray",
                  u: "np.ndarray") -> "np.ndarray":
    """Bitwise numpy twin of `backflow` for raw host images.

    Needed when the device holds census-exact uint16 codes instead of
    intensities (ops/census_codec.py): backflow is the one output that
    reads raw pixel VALUES, so it is rebuilt on the host from the
    fetched disparity and the original images (scrubbed like the
    device prep).  Same floor/clip/where ops on the same float32
    inputs -> identical bits."""
    import numpy as np
    u = np.nan_to_num(np.asarray(u, np.float32), nan=0.0, posinf=0.0,
                      neginf=0.0)
    v = np.nan_to_num(np.asarray(v, np.float32), nan=0.0, posinf=0.0,
                      neginf=0.0)
    H, W, C = u.shape
    x = np.arange(W, dtype=np.float32)[None, :]
    t = x + disp
    with np.errstate(invalid="ignore"):
        inside = (t >= 0) & (t < W)  # NaN -> False
    qx = np.floor(np.nan_to_num(t, nan=0.0)).astype(np.int32)
    qx = np.clip(qx, 0, W - 1)
    vg = np.take_along_axis(v, qx[..., None], axis=1)
    return np.where(inside[..., None], vg, u)


@jax.jit
def backflow(disp, v, u):
    """Backprojected right image (mgm.cc:432-443): syn(p) = v(x+d, y)
    with float->index truncation (= floor since x+d >= 0 inside the
    image), else the left pixel."""
    H, W, C = u.shape
    x = jnp.arange(W, dtype=jnp.float32)[None, :]
    t = x + disp
    inside = (t >= 0) & (t < W)  # NaN -> False
    qx = jnp.floor(jnp.nan_to_num(t, nan=0.0)).astype(jnp.int32)
    qx = jnp.clip(qx, 0, W - 1)
    vg = jnp.take_along_axis(v, qx[..., None], axis=1)
    return jnp.where(inside[..., None], vg, u)
