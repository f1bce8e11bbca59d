"""The seeded synthetic pairs (mgm_tpu.synth): determinism, the classes'
shapes and value ranges, and that the known disparity scores a solve."""
import functools

import numpy as np
import pytest

from mgm_tpu import synth
from mgm_tpu.config import MGMConfig
from mgm_tpu.models.presets import get_preset
from mgm_tpu.stereo import compute_disparity


@functools.cache
def full_pairs():
    return synth.fountain_pair(seed=0), synth.satellite_pair(seed=0)


@pytest.mark.parametrize("make", [synth.fountain_pair, synth.satellite_pair])
def test_same_seed_same_pair(make):
    kw = dict(shape=(20, 30, 1))
    a, b = make(seed=5, **kw), make(seed=5, **kw)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    c = make(seed=6, **kw)
    assert not np.array_equal(a[0], c[0], equal_nan=True)


def test_fountain_class():
    u, v, d = full_pairs()[0]
    assert u.shape == v.shape == synth.FOUNTAIN_SHAPE
    assert u.dtype == v.dtype == np.uint8
    assert d.shape == u.shape[:2] and d.dtype == np.float32
    assert -120 <= d.min() and d.max() <= 30   # the cfg1 search range
    assert np.unique(u).size > 200             # textured


def test_satellite_class():
    u, v, d = full_pairs()[1]
    assert u.shape == v.shape == synth.SATELLITE_SHAPE
    assert u.dtype == v.dtype == np.float32
    for img in (u, v):
        assert np.isnan(img).any()
    fin = np.concatenate([u[np.isfinite(u)], v[np.isfinite(v)]])
    assert fin.min() == pytest.approx(-55.0) and fin.max() == pytest.approx(
        1746.0)
    assert np.unique(fin).size > 65536   # needs the grouped census codes
    sat = get_preset("satellite")
    assert sat.dmin <= d.min() and d.max() <= sat.dmax


def test_planes_are_piecewise_planar():
    d = synth.piecewise_planar(40, 60, -20.0, 10.0)
    assert -20.0 <= d.min() and d.max() <= 10.0
    # three planes: second differences vanish away from region borders
    dd = np.abs(np.diff(d, 2, axis=1))
    assert (dd < 1e-4).mean() > 0.9


def test_left_image_samples_right_at_the_disparity():
    """u(x) = v(x + d) on integer-disparity pixels (noise-free class)."""
    u, v, d = synth.satellite_pair(seed=1, shape=(24, 40, 1), dmin=-6,
                                   dmax=-2)
    ys, xs = np.nonzero(np.isclose(d, np.round(d), atol=1e-6)
                        & (np.arange(40)[None] + d >= 0))
    qx = (xs + np.round(d[ys, xs])).astype(int)
    ok = np.isfinite(u[ys, xs, 0]) & np.isfinite(v[ys, qx, 0])
    diff = np.abs(u[ys, xs, 0] - v[ys, qx, 0])[ok]
    assert diff.size and np.median(diff) < 20.0   # noise, not texture


def test_bad_pixel_rate():
    truth = np.zeros((4, 5), np.float32)
    disp = truth.copy()
    disp[0, :] = 3.0
    disp[1, 0] = np.nan
    r = synth.bad_pixel_rate(disp, truth)
    assert r["bad"] == pytest.approx(5 / 19)
    assert r["invalid"] == pytest.approx(1 / 20)
    assert synth.bad_pixel_rate(truth, truth)["bad"] == 0.0


def test_solve_recovers_fountain_class_disparity():
    u, v, d = synth.fountain_pair(seed=2, shape=(40, 72, 3), dmin=-12,
                                  dmax=-2)
    cfg = MGMConfig(dmin=-16, dmax=4, ndir=4, mgm=2, test_lr=True)
    q = synth.bad_pixel_rate(compute_disparity(u, v, cfg)["disp"], d)
    assert q["bad"] < 0.03 and q["invalid"] < 0.3
    wrong = synth.bad_pixel_rate(compute_disparity(u, v, cfg)["disp"], d + 3)
    assert wrong["bad"] > 0.9


def test_solve_recovers_satellite_class_disparity():
    u, v, d = synth.satellite_pair(seed=2, shape=(48, 60, 1), dmin=-6,
                                   dmax=5)
    cfg = get_preset("satellite", dmin=-8, dmax=7)
    q = synth.bad_pixel_rate(compute_disparity(u, v, cfg)["disp"], d)
    assert q["bad"] < 0.05 and q["invalid"] < 0.3
