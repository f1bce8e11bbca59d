"""Dense cost-volume construction.

Implements the builder semantics of mgm_costvolume.h:337-424 on dense
(H, W, L) float32 volumes over the global label axis:
  - label index l corresponds to disparity d = gmin + l
  - q outside the target image => cost = trunc_dist * nch
  - all costs truncated at trunc_dist * nch
  - +inf outside each pixel's [lo, hi] label window (Dvec semantics)
  - pixels whose whole window is non-finite are reset to 0
Cost functions (mgm_costvolume.h:19-165): ad, sd, census (on packed
codes), ncc (clipped, x64), btad, btsd.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .common import INF, fmin3, shift_fill


def window_mask(lo, hi, L):
    """(..., H, W) int windows -> (..., H, W, L) bool mask."""
    l_idx = jnp.arange(L, dtype=jnp.int32)
    return (l_idx >= lo[..., None]) & (l_idx <= hi[..., None])


def _pad_cols(a, gmin: int, L: int):
    """Edge-pad columns so every disparity d = gmin..gmin+L-1 becomes a
    static slice a_pad[:, x + d - gmin].  Edge padding equals the
    index clamp the gather-based formulation used; out-of-image labels
    are masked to trunc_dist by build_cost_volume anyway.  Static slices
    instead of a (H, W, L, C) gather: slices fuse into the elementwise
    cost math."""
    left = max(0, -gmin)
    right = max(0, gmin + L - 1)
    return jnp.pad(a, [(0, 0), (left, right), (0, 0)], mode="edge"), left


def _shifted(a_pad, left: int, gmin: int, l: int, W: int):
    """Column slice of the padded image for label l (disparity gmin+l)."""
    return jax.lax.dynamic_slice_in_dim(a_pad, left + gmin + l, W, axis=1)


def _per_label(u, v, gmin: int, L: int, fn):
    """Stack fn(u, v_shifted_by_label) over labels -> (H, W, L)."""
    H, W, C = v.shape
    v_pad, left = _pad_cols(v, gmin, L)
    cols = [fn(u, _shifted(v_pad, left, gmin, l, W)) for l in range(L)]
    return jnp.stack(cols, axis=-1)


def _bt_aux(a):
    """Per-channel 3-tap min/max of half-sample shifts (BTAD,
    mgm_costvolume.h:82-110)."""
    H, W, C = a.shape
    x = jnp.arange(W)[None, :, None]
    ap = jnp.where(x < W - 1, (a + shift_fill(a, -1, 1, 0.0)) * 0.5, a)
    am = jnp.where(x >= 1, (a + shift_fill(a, 1, 1, 0.0)) * 0.5, a)
    amin = fmin3(am, ap, a)
    amax = -fmin3(-am, -ap, -a)
    return amin, amax


def _box(a, hw):
    """Separable windowed sum over (2hw+1)^2, zero outside image."""
    out = a
    for axis in (0, 1):
        acc = out
        for s in range(1, hw + 1):
            acc = acc + shift_fill(out, s, axis, 0.0) + shift_fill(out, -s, axis, 0.0)
        out = acc
    return out


def pointwise_costs(u, v, gmin: int, L: int, distance: str, ncc_win: int):
    """Raw per-(pixel,label) matching costs, before truncation/masking.

    u, v: (H, W, C) preprocessed images (uint32 census codes for
    'census').  Label l matches column x + gmin + l.  Returns (H, W, L).
    """
    if distance == "census":
        inv_nw = jnp.float32(1.0 / u.shape[2])

        def ham(cu, cv_sh):
            x = jnp.sum(jax.lax.population_count(cu ^ cv_sh), axis=-1)
            return x.astype(jnp.float32) * inv_nw

        return _per_label(u, v, gmin, L, ham)

    if distance in ("ad", "sd"):
        def diff(a, b_sh):
            d = jnp.abs(a - b_sh)
            if distance == "sd":
                d = d * d
            return jnp.sum(d, axis=-1)

        return _per_label(u, v, gmin, L, diff)

    if distance in ("btad", "btsd"):
        umin, umax = _bt_aux(u)
        vmin, vmax = _bt_aux(v)
        H, W, C = v.shape
        v3_pad, left = _pad_cols(jnp.concatenate([v, vmin, vmax], -1),
                                 gmin, L)
        zero = jnp.float32(0)

        def bt_cost(l):
            sh = _shifted(v3_pad, left, gmin, l, W)
            IR, vmin_g, vmax_g = sh[..., :C], sh[..., C:2 * C], sh[..., 2 * C:]
            dLR = -fmin3(zero, -(u - vmax_g), -(vmin_g - u))
            dRL = -fmin3(zero, -(IR - umax), -(umin - IR))
            bt = jnp.abs(jnp.minimum(dLR, dRL))
            if distance == "btsd":
                bt = bt * bt
            return jnp.sum(bt, axis=-1)

        return jnp.stack([bt_cost(l) for l in range(L)], axis=-1)

    if distance == "ncc":
        return _ncc_costs(u, v, gmin, L, ncc_win)

    raise ValueError(f"unknown distance {distance}")


def _ncc_costs(u, v, gmin, L, win):
    """Clipped NCC x64 (mgm_costvolume.h:137-165); windows touching the
    image border are +inf (valnan semantics)."""
    H, W, C = u.shape
    hw = win // 2
    n = jnp.float32((2 * hw + 1) ** 2)
    x = jnp.arange(W)
    if H <= 2 * hw:
        return jnp.full((H, W, L), INF, jnp.float32)
    y_ok = (jnp.arange(H) >= hw) & (jnp.arange(H) < H - hw)
    mu1 = _box(u, hw) / n
    s1 = _box(u * u, hw) / n
    mu2 = _box(v, hw) / n
    s2 = _box(v * v, hw) / n
    var1 = s1 - mu1 * mu1
    vms_pad, left = _pad_cols(jnp.concatenate([v, mu2, s2], -1), gmin, L)
    # room for the last label block's full (W + B - 1)-wide slice: the
    # overhang labels are discarded, but a clamped dynamic_slice would
    # silently shift the in-range ones
    vms_pad = jnp.pad(vms_pad, [(0, 0), (0, 8), (0, 0)], mode="edge")

    # Label-blocked, not per-label: the box filters run ONCE per block
    # of B labels on an (H, W, B, C) stack (the shift ops vectorise over
    # the label axis), so the sequential depth is L/B and the unrolled
    # op count stays ~L/B * const (an L-fold unroll of the filters
    # makes compile time explode; a lax.map over single labels
    # serialises 151 tiny steps).
    B = 8
    Lp = -(-L // B) * B
    blocks = []
    for l0 in range(0, Lp, B):
        sh = jax.lax.dynamic_slice_in_dim(
            vms_pad, left + gmin + l0, W + B - 1, axis=1)
        # (H, W, B, 3C): label l0+k reads columns shifted by k
        sb = jnp.stack([jax.lax.slice_in_dim(sh, k, k + W, axis=1)
                        for k in range(B)], axis=2)
        vg, mu2g, s2g = sb[..., :C], sb[..., C:2 * C], sb[..., 2 * C:]
        prod = _box(u[:, :, None, :] * vg, hw) / n
        denom = jnp.sqrt(jnp.maximum(jnp.float32(1e-7),
                                     var1[:, :, None, :]
                                     * (s2g - mu2g * mu2g)))
        ncc = jnp.sum((prod - mu1[:, :, None, :] * mu2g) / denom, axis=-1)
        clipped = (C - jnp.clip(ncc, 0.0, float(C))) * jnp.float32(64)
        qx_col = x[None, :, None] + (gmin + l0 + jnp.arange(B)[None, None])
        ok = ((x >= hw) & (x < W - hw))[None, :, None] \
            & (qx_col >= hw) & (qx_col < W - hw) & y_ok[:, None, None]
        blocks.append(jnp.where(ok, clipped, INF))
    return jnp.concatenate(blocks, axis=-1)[..., :L]


@partial(jax.jit, static_argnames=("gmin", "distance", "L", "trunc_dist",
                                   "ncc_win"))
def build_cost_volume(u, v, lo, hi, gmin: int, *, distance: str, L: int,
                      trunc_dist: float, ncc_win: int = 3):
    """Dense (H, W, L) cost volume.

    u, v: preprocessed images (H, W, C); lo/hi: (H, W) int32 label
    windows; gmin: static int, disparity of label 0.
    """
    H, W, C = u.shape
    tmax = jnp.float32(trunc_dist * C)
    d = gmin + jnp.arange(L, dtype=jnp.int32)          # (L,) disparities
    qx = jnp.arange(W, dtype=jnp.int32)[:, None] + d[None, :]   # (W, L)
    valid_q = (qx >= 0) & (qx < W)

    e = pointwise_costs(u, v, gmin, L, distance, ncc_win)
    e = jnp.where(valid_q[None], e, tmax)
    e = jnp.minimum(e, tmax)

    in_win = window_mask(lo, hi, L)
    allinvalid = ~jnp.any(in_win & jnp.isfinite(e), axis=-1, keepdims=True)
    e = jnp.where(allinvalid, 0.0, e)
    return jnp.where(in_win, e, INF).astype(jnp.float32)
