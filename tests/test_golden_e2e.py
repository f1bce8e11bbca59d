"""End-to-end golden tests against the reference `mgm` binary.

The reference (gfacciol/mgm) is built from the read-only mount into
/tmp/mgm_ref and run on small crops of the bundled fountain23 pair; our
pipeline must reproduce its disparity/cost outputs within float-ordering
tolerance.  Skipped when the binary or data is unavailable.
"""
import os
import subprocess

import numpy as np
import pytest

from mgm_tpu.config import MGMConfig
from mgm_tpu.io import read_image, write_image
from mgm_tpu.stereo import compute_disparity

REF_BIN = "/tmp/mgm_ref/mgm"
REF_DATA = "/tmp/mgm_ref/data"

pytestmark = pytest.mark.skipif(
    not (os.path.exists(REF_BIN) and os.path.exists(REF_DATA)),
    reason="reference binary not built (cp -r /root/reference /tmp/mgm_ref && make -C /tmp/mgm_ref)")


@pytest.fixture(scope="module")
def crop(tmp_path_factory):
    d = tmp_path_factory.mktemp("fountain")
    u = read_image(f"{REF_DATA}/fountain23-imL.png")[200:264, 300:396]
    v = read_image(f"{REF_DATA}/fountain23-imR.png")[200:264, 300:396]
    write_image(str(d / "u.png"), u)
    write_image(str(d / "v.png"), v)
    return d, u, v


def run_reference(d, args, env):
    e = dict(os.environ)
    e.update({k: str(v) for k, v in env.items()})
    e.setdefault("TSGM_DEBUG", "0")
    out, cost = str(d / "disp_ref.tif"), str(d / "cost_ref.tif")
    subprocess.run([REF_BIN] + [str(a) for a in args] +
                   [str(d / "u.png"), str(d / "v.png"), out, cost],
                   check=True, env=e, capture_output=True)
    return read_image(out)[..., 0], read_image(cost)[..., 0]


def compare(d_ref, c_ref, d_got, c_got, disp_match=0.999, tol=0.125):
    nan_agree = np.mean(np.isnan(d_ref) == np.isnan(d_got))
    assert nan_agree >= 0.999, f"NaN masks agree only {nan_agree:.3%}"
    both = ~(np.isnan(d_ref) | np.isnan(d_got))
    # exact equality first: it covers +-inf pixels (the reference emits
    # infinities when refinement reads -inf S cells at tight iter-2 windows)
    with np.errstate(invalid="ignore"):
        close = ((d_ref[both] == d_got[both]) |
                 (np.abs(d_ref[both] - d_got[both]) <= tol))
    assert np.mean(close) >= disp_match, \
        f"disparity match {np.mean(close):.3%} < {disp_match:.0%}"
    cb = np.isfinite(c_ref) & np.isfinite(c_got)
    cd = np.abs(c_ref[cb] - c_got[cb]) / np.maximum(1.0, np.abs(c_ref[cb]))
    assert np.quantile(cd, 0.98) <= 0.02, "matching costs diverge"


CONFIGS = [
    # (id, argv, env, MGMConfig kwargs)
    ("ad_O4_sgm_nolr",
     ["-r", -12, "-R", 4, "-O", 4, "-P1", 8, "-P2", 32],
     {"TESTLRRL": 0, "TSGM": 2},
     dict(dmin=-12, dmax=4, ndir=4, p1=8, p2=32, mgm=2, test_lr=False)),
    ("ad_O8_mgm4_lr",
     ["-r", -12, "-R", 4, "-O", 8],
     {"TESTLRRL": 1, "TSGM": 4},
     dict(dmin=-12, dmax=4, ndir=8, mgm=4, test_lr=True)),
    ("census_tl_vfit_median",
     ["-r", -12, "-R", 4, "-O", 8, "-P1", 2, "-P2", 20000, "-t", "census",
      "-s", "vfit"],
     {"TESTLRRL": 1, "TSGM": 3, "MEDIAN": 1,
      "USE_TRUNCATED_LINEAR_POTENTIALS": 1},
     dict(dmin=-12, dmax=4, ndir=8, p1=2, p2=20000, mgm=3, distance="census",
          refinement="vfit", median_radius=1, use_trunc_linear=True,
          test_lr=True)),
    ("subpix_parabola_O2",
     ["-r", -12, "-R", 4, "-O", 2, "-s", "parabola"],
     {"TESTLRRL": 0, "TSGM": 2},
     dict(dmin=-12, dmax=4, ndir=2, mgm=2, refinement="parabola",
          test_lr=False)),
    ("adaptive_weights",
     ["-r", -12, "-R", 4, "-O", 4, "-aP2", 0.25, "-aThresh", 8],
     {"TESTLRRL": 0, "TSGM": 4},
     dict(dmin=-12, dmax=4, ndir=4, mgm=4, a_p2=0.25, a_thresh=8,
          test_lr=False)),
    ("truncdist_sobelx",
     ["-r", -12, "-R", 4, "-O", 4, "-truncDist", 63, "-p", "sobelx"],
     {"TESTLRRL": 0, "TSGM": 4},
     dict(dmin=-12, dmax=4, ndir=4, mgm=4, trunc_dist=63, prefilter="sobelx",
          test_lr=False)),
    ("iterations2",
     ["-r", -12, "-R", 4, "-O", 4, "-s", "vfit"],
     {"TESTLRRL": 0, "TSGM": 4, "TSGM_ITER": 2},
     dict(dmin=-12, dmax=4, ndir=4, mgm=4, refinement="vfit", iterations=2,
          test_lr=False)),
]


@pytest.mark.parametrize("cid,args,env,kw", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_golden(crop, cid, args, env, kw):
    d, u, v = crop
    d_ref, c_ref = run_reference(d, args, env)
    res = compute_disparity(u, v, MGMConfig(**kw))
    compare(d_ref, c_ref, res["disp"], res["cost"])


@pytest.mark.skipif(not os.path.exists(REF_BIN), reason="reference not built")
def test_golden_satellite(tmp_path):
    """cfg3-style run on the single-channel satellite pair (odd sizes,
    census 5x5, 8 directions)."""
    from mgm_tpu.io import read_image as rd
    u = rd(f"{REF_DATA}/rectified_ref.tif")[:96, :88]
    v = rd(f"{REF_DATA}/rectified_sec.tif")[:96, :88]
    write_image(str(tmp_path / "u.tif"), u)
    write_image(str(tmp_path / "v.tif"), v)
    env = dict(os.environ)
    env.update({"TESTLRRL": "1", "TSGM": "3", "CENSUS_NCC_WIN": "5",
                "MEDIAN": "1", "TSGM_DEBUG": "0"})
    args = ["-r", -22, "-R", 19, "-O", 8, "-t", "census", "-s", "vfit"]
    subprocess.run([REF_BIN] + [str(a) for a in args] +
                   [str(tmp_path / "u.tif"), str(tmp_path / "v.tif"),
                    str(tmp_path / "ref.tif"), str(tmp_path / "refc.tif")],
                   check=True, env=env, capture_output=True)
    res = compute_disparity(u, v, MGMConfig(
        dmin=-22, dmax=19, ndir=8, mgm=3, distance="census",
        census_ncc_win=5, refinement="vfit", median_radius=1, test_lr=True))
    d_ref = read_image(str(tmp_path / "ref.tif"))[..., 0]
    c_ref = read_image(str(tmp_path / "refc.tif"))[..., 0]
    compare(d_ref, c_ref, res["disp"], res["cost"])


@pytest.mark.skipif(os.environ.get("MGM_TPU_FULL_GOLDEN") != "1",
                    reason="full-image golden is slow; set "
                           "MGM_TPU_FULL_GOLDEN=1 (run it on a GPU)")
def test_golden_full_image(tmp_path):
    """BASELINE cfg1 on the FULL 700x500 fountain23 pair: disparities
    must be equal on every mutually-finite pixel, the NaN mask may
    differ only on LR-borderline ties (measured: 1 pixel, a right-side
    WTA tie at identical cost).  Run manually on a GPU:
        MGM_TPU_FULL_GOLDEN=1 pytest tests/test_golden_e2e.py -k full -p no:cacheprovider
    (on CPU the XLA path takes several minutes but passes too)."""
    u = read_image(f"{REF_DATA}/fountain23-imL.png")
    v = read_image(f"{REF_DATA}/fountain23-imR.png")
    env = dict(os.environ)
    env.update({"TESTLRRL": "1", "TSGM": "2", "TSGM_DEBUG": "0"})
    subprocess.run([REF_BIN, "-r", "-120", "-R", "30", "-O", "4",
                    f"{REF_DATA}/fountain23-imL.png",
                    f"{REF_DATA}/fountain23-imR.png",
                    str(tmp_path / "ref.tif"), str(tmp_path / "refc.tif")],
                   check=True, env=env, capture_output=True)
    res = compute_disparity(u, v, MGMConfig(dmin=-120, dmax=30, ndir=4,
                                            mgm=2, test_lr=True))
    d_ref = read_image(str(tmp_path / "ref.tif"))[..., 0]
    c_ref = read_image(str(tmp_path / "refc.tif"))[..., 0]
    fa, fb = np.isfinite(d_ref), np.isfinite(res["disp"])
    assert np.mean(fa == fb) >= 0.99999          # <= 3 borderline pixels
    both = fa & fb
    # every mutually-finite pixel equal, except WTA near-ties (which must
    # have matching costs to float tolerance, proving they ARE ties)
    eq = d_ref[both] == res["disp"][both]
    assert eq.mean() >= 0.99999, f"disp equal only {eq.mean():.6%}"
    cb = np.isfinite(c_ref) & np.isfinite(res["cost"])
    assert np.abs(c_ref[cb] - res["cost"][cb]).max() <= 1e-3


@pytest.mark.skipif(not os.path.exists(REF_BIN), reason="reference not built")
def test_golden_per_pixel_ranges(crop, tmp_path):
    """-m/-M per-pixel disparity windows (mgm.cc:338-353)."""
    d, u, v = crop
    H, W, _ = u.shape
    rng = np.random.default_rng(7)
    dmin_img = (-12 + rng.integers(0, 4, (H, W))).astype(np.float32)
    dmax_img = (4 - rng.integers(0, 4, (H, W))).astype(np.float32)
    write_image(str(tmp_path / "m.tif"), dmin_img)
    write_image(str(tmp_path / "M.tif"), dmax_img)
    env = dict(os.environ)
    env.update({"TESTLRRL": "0", "TSGM": "2", "TSGM_DEBUG": "0"})
    subprocess.run([REF_BIN, "-O", "4",
                    "-m", str(tmp_path / "m.tif"), "-M", str(tmp_path / "M.tif"),
                    str(d / "u.png"), str(d / "v.png"),
                    str(tmp_path / "ref.tif"), str(tmp_path / "refc.tif")],
                   check=True, env=env, capture_output=True)
    res = compute_disparity(u, v,
                            MGMConfig(dmin=-12, dmax=4, ndir=4, mgm=2,
                                      test_lr=False),
                            dmin_img=dmin_img, dmax_img=dmax_img)
    d_ref = read_image(str(tmp_path / "ref.tif"))[..., 0]
    c_ref = read_image(str(tmp_path / "refc.tif"))[..., 0]
    compare(d_ref, c_ref, res["disp"], res["cost"])
