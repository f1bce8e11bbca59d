"""Seeded synthetic stereo pairs with a known disparity.

Two classes, at the sizes and value ranges of the benchmark configs:

- `fountain_pair`: a 500x700 RGB uint8 pair (the fountain23 class,
  BASELINE cfg1: AD cost over -120..30);
- `satellite_pair`: a 271x279 single-band float32 pair with values in
  -55..1746 and NaN no-data patches (the satellite class, BASELINE
  cfg3: census over -22..19).

The right image is band-limited noise; the left image samples it at
x + d(x, y) (the reference's convention: left pixel x matches right
pixel x + d), with d piecewise planar: a slanted background plane and
two slanted foreground regions.  `bad_pixel_rate` scores a disparity
map against that truth the way scripts/eval_fountain.py scores
fountain23.
"""
from __future__ import annotations

import numpy as np

FOUNTAIN_SHAPE = (500, 700, 3)
SATELLITE_SHAPE = (271, 279, 1)


def _smooth(a: np.ndarray, r: int, axis: int) -> np.ndarray:
    """Box filter of radius r along `axis` (edge-clamped), by cumsum."""
    n = a.shape[axis]
    idx = np.clip(np.arange(-r - 1, n + r), 0, n - 1)
    c = np.cumsum(np.take(a, idx, axis=axis), axis=axis, dtype=np.float64)
    hi = np.take(c, np.arange(2 * r + 1, n + 2 * r + 1), axis=axis)
    lo = np.take(c, np.arange(0, n), axis=axis)
    return ((hi - lo) / (2 * r + 1)).astype(np.float32)


def _texture(rng, h: int, w: int, c: int) -> np.ndarray:
    """Band-limited noise in [0, 1]: fine grain over coarse blobs."""
    fine = rng.random((h, w, c), dtype=np.float32)
    fine = _smooth(_smooth(fine, 1, 0), 1, 1)
    coarse = rng.random((h, w, c), dtype=np.float32)
    coarse = _smooth(_smooth(coarse, 6, 0), 6, 1)
    t = 0.6 * fine + 0.4 * coarse
    t -= t.min()
    return t / t.max()


def piecewise_planar(h: int, w: int, dmin: float, dmax: float) -> np.ndarray:
    """(h, w) float32 disparities in [dmin, dmax]: a slanted
    background, a slanted rectangle and a slanted ellipse."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    yn, xn = y / max(h - 1, 1), x / max(w - 1, 1)
    span = dmax - dmin
    d = dmin + span * (0.15 + 0.15 * xn + 0.1 * yn)          # background
    rect = (yn > 0.2) & (yn < 0.6) & (xn > 0.2) & (xn < 0.55)
    d = np.where(rect, dmin + span * (0.55 + 0.3 * xn), d)
    ell = ((xn - 0.75) / 0.17) ** 2 + ((yn - 0.68) / 0.22) ** 2 < 1.0
    d = np.where(ell, dmin + span * (0.95 - 0.25 * yn), d)
    return d.astype(np.float32)


def _render_left(canvas: np.ndarray, disp: np.ndarray, pad: int):
    """u(y, x) = canvas(y, x + d + pad), linearly interpolated."""
    h, w = disp.shape
    xs = np.arange(w, dtype=np.float32)[None, :] + disp + pad
    i0 = np.clip(np.floor(xs).astype(np.int64), 0, canvas.shape[1] - 2)
    f = (xs - i0)[..., None]
    rows = np.arange(h)[:, None]
    return (1 - f) * canvas[rows, i0] + f * canvas[rows, i0 + 1]


def _pair(rng, shape, dmin, dmax):
    h, w, c = shape
    disp = piecewise_planar(h, w, dmin, dmax)
    pad = int(np.ceil(max(abs(dmin), abs(dmax)))) + 2
    canvas = _texture(rng, h, w + 2 * pad, c)
    v = canvas[:, pad:pad + w]
    u = _render_left(canvas, disp, pad)
    return u, v, disp


def fountain_pair(seed: int = 0, shape=FOUNTAIN_SHAPE, dmin: float = -110.0,
                  dmax: float = -5.0):
    """(u, v, disp): uint8 (H, W, 3) images and the float32 (H, W) true
    left disparity (inside the cfg1 search range -120..30)."""
    rng = np.random.default_rng(seed)
    u, v, disp = _pair(rng, shape, dmin, dmax)
    noise = rng.normal(0.0, 1.0, u.shape).astype(np.float32)
    u8 = np.clip(np.rint(u * 250 + 2 + noise), 0, 255).astype(np.uint8)
    v8 = np.clip(np.rint(v * 250 + 2), 0, 255).astype(np.uint8)
    return u8, v8, disp


def satellite_pair(seed: int = 0, shape=SATELLITE_SHAPE, dmin: float = -15.0,
                   dmax: float = 12.0, vmin: float = -55.0,
                   vmax: float = 1746.0):
    """(u, v, disp): float32 (H, W, 1) images with values in
    [vmin, vmax] and NaN no-data patches, and the float32 (H, W) true
    left disparity (inside the satellite preset's range -22..19)."""
    rng = np.random.default_rng(seed)
    u, v, disp = _pair(rng, shape, dmin, dmax)
    u = u + rng.normal(0.0, 2e-3, u.shape).astype(np.float32)
    lo, hi = min(u.min(), v.min()), max(u.max(), v.max())
    u = vmin + (vmax - vmin) * (u - lo) / (hi - lo)
    v = vmin + (vmax - vmin) * (v - lo) / (hi - lo)
    h, w = disp.shape
    for img in (u, v):
        for _ in range(3):  # rectangular no-data patches
            y0, x0 = rng.integers(0, h - 8), rng.integers(0, w - 8)
            img[y0:y0 + rng.integers(3, 8), x0:x0 + rng.integers(3, 8)] = np.nan
    return u.astype(np.float32), v.astype(np.float32), disp


def bad_pixel_rate(disp: np.ndarray, truth: np.ndarray,
                   thresh: float = 2.0) -> dict:
    """bad-`thresh` (share of valid pixels off by more than `thresh`),
    the mean error and the invalidated share, as in
    scripts/eval_fountain.py."""
    valid = np.isfinite(disp)
    err = np.abs(disp - truth)[valid]
    return {"bad": float(np.mean(err > thresh)) if err.size else 1.0,
            "avg_err": float(np.mean(err)) if err.size else float("inf"),
            "invalid": float(np.mean(~valid))}
