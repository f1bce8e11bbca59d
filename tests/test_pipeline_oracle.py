"""compute_disparity's XLA route against the pure-numpy oracle, end to end.

The oracle pipeline chains tests/oracle.py's stages the way mgm.cc's
main() chains the reference's: adaptive weights, census, the cost
volumes of both sides (the right one over the negated range), the MGM
solve, subpixel refinement and the LR check.  The configuration grid
is the one the deleted fused-kernel tests pinned (passes, TSGM, cost
families, truncated-linear potential, weights, wide label windows).
Disparities may differ only at exact WTA ties of the oracle's S.
"""
import numpy as np
import pytest

import oracle
from mgm_tpu.config import MGMConfig
from mgm_tpu.stereo import compute_disparity


def oracle_side(u, v, cfg, gmin, L):
    H, W, C = u.shape
    lo = np.zeros((H, W), np.int32)
    hi = np.full((H, W), L - 1, np.int32)
    cu = cv = None
    if cfg.distance == "census":
        r = cfg.census_ncc_win // 2
        cu = oracle.census_transform_oracle(u, r)
        cv = oracle.census_transform_oracle(v, r)
    cc = oracle.cost_volume_oracle(u, v, lo, hi, gmin, L, cfg.distance,
                                   cfg.trunc_dist, census_u=cu, census_v=cv,
                                   ncc_win=cfg.census_ncc_win)
    w = (oracle.weights_oracle(u, np.float32(cfg.a_p2),
                               np.float32(cfg.a_thresh))
         if cfg.a_p2 != 1.0 else None)
    S, d, c = oracle.mgm_oracle(cc, w, lo, hi, lo, hi,
                                np.float32(cfg.p1 * C),
                                np.float32(cfg.p2 * C), cfg.ndir, cfg.mgm,
                                use_fh=cfg.use_trunc_linear,
                                fix_overcount=cfg.fix_overcount)
    if cfg.refinement != "none":
        d_r, c = oracle.refine_oracle(S, d, c, lo, hi, cfg.refinement)
    else:
        d_r = d
    return S, d, d_r + gmin, c


def assert_close_but_ties(got, want, S, d_int, gmin, scale, what):
    """Equal disparities except where the oracle's S has a tie."""
    fg, fw = np.isfinite(got), np.isfinite(want)
    np.testing.assert_array_equal(fg, fw, err_msg=what)
    bad = np.argwhere(fg & (np.abs(got - want) > 1e-3))
    L = S.shape[-1]
    for y, x in bad:
        la = int(d_int[y, x])
        lb = int(np.floor(got[y, x])) - gmin   # a refined value may sit
        gap = min(abs(S[y, x, la] - S[y, x, k])  # just below its label
                  for k in (lb, lb + 1) if 0 <= k < L)
        assert gap <= 3e-5 * scale, \
            f"{what}: non-tie disparity mismatch at {(y, x)}"
    assert len(bad) <= 0.02 * got.size, what


def run_case(rng, H=12, W=21, dmin=-6, dmax=4, C=2, test_lr=True, **kw):
    u = rng.uniform(0, 80, (H, W, C)).astype(np.float32)
    v = rng.uniform(0, 80, (H, W, C)).astype(np.float32)
    cfg = MGMConfig(dmin=dmin, dmax=dmax, test_lr=test_lr, **kw)
    got = compute_disparity(u, v, cfg, backend="xla")
    L = dmax - dmin + 1
    sides = [(u, v, dmin, "")] + ([(v, u, -dmax, "_right")]
                                  if test_lr else [])
    nolr = {}
    for a, b, gmin, suf in sides:
        S, d_int, d, c = oracle_side(a, b, cfg, gmin, L)
        fin = np.isfinite(S)
        scale = max(1.0, float(np.abs(S[fin]).max())) if fin.any() else 1.0
        assert_close_but_ties(got["disp_nolr" + suf], d, S, d_int, gmin,
                              scale, "disp_nolr" + suf)
        same = got["disp_nolr" + suf] == d
        np.testing.assert_allclose(got["cost" + suf][same], c[same],
                                   atol=3e-5 * scale, rtol=1e-5)
        nolr[suf] = got["disp_nolr" + suf]
    if test_lr:  # the LR check of our own pre-LR disparities
        want = oracle.lr_oracle(nolr[""], nolr["_right"], cfg.lr_tau)
        np.testing.assert_array_equal(got["disp"], want)


CASES = [
    dict(ndir=1, mgm=1),
    dict(ndir=4, mgm=2),
    dict(ndir=4, mgm=2, distance="census", C=1),
    dict(ndir=8, mgm=4),
    dict(ndir=8, mgm=3),
    dict(ndir=8, mgm=3, use_trunc_linear=True, p1=2.0, p2=50.0),
    dict(ndir=4, mgm=2, dmin=-40, dmax=26),   # window wider than image
    dict(ndir=4, mgm=4),
    dict(ndir=4, mgm=4, distance="census", C=1),
    dict(ndir=8, mgm=4, a_p2=0.5, a_thresh=40.0, use_trunc_linear=True),
]


@pytest.mark.parametrize("case", CASES,
                         ids=[str(sorted(c.items())) for c in CASES])
def test_pipeline_matches_oracle(rng, case):
    run_case(rng, **case)


WTA_CASES = [
    dict(ndir=1, mgm=1),
    dict(ndir=2, mgm=2),
    dict(ndir=4, mgm=2, test_lr=False),
    dict(ndir=4, mgm=2, distance="census", C=1),
    dict(ndir=4, mgm=3, use_trunc_linear=True, p1=2.0, p2=50.0),
    dict(ndir=2, mgm=4),
    dict(ndir=8, mgm=3, fix_overcount=False),
    dict(ndir=8, mgm=4, trunc_dist=20.0),
    dict(ndir=4, mgm=2, dmin=-40, dmax=8, H=8, W=13),   # L > 32
    dict(ndir=4, mgm=2, distance="btad"),
]


@pytest.mark.parametrize("case", WTA_CASES,
                         ids=[str(sorted(c.items())) for c in WTA_CASES])
def test_refined_pipeline_matches_oracle(rng, case):
    """The same chain with vfit subpixel refinement read from S."""
    run_case(rng, refinement="vfit", **case)
