"""Golden tests: the jitted solver vs the pure-numpy reference oracle.

The oracle (tests/oracle.py) replicates gfacciol/mgm's mgm() semantics
(mgm_core.cc:408-613) literally, pixel by pixel; these tests pin the
vectorised wavefront implementation to it on small random problems over
the full configuration grid: NDIR x TSGM(mgm) x potential x weights x
per-pixel label windows.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from mgm_tpu.solver import mgm_solve
from oracle import mgm_oracle

ATOL = 2e-3


def make_problem(rng, H=7, W=9, L=6, per_pixel=False, weighted=False,
                 tight_s=False):
    lo = np.zeros((H, W), np.int32)
    hi = np.full((H, W), L - 1, np.int32)
    if per_pixel:
        lo = rng.integers(0, L - 2, (H, W)).astype(np.int32)
        hi = (lo + rng.integers(1, L - 1, (H, W))).clip(max=L - 1).astype(np.int32)
    cc = rng.uniform(0, 50, (H, W, L)).astype(np.float32)
    l_idx = np.arange(L)
    mask = (l_idx >= lo[..., None]) & (l_idx <= hi[..., None])
    cc = np.where(mask, cc, np.inf).astype(np.float32)
    w = None
    if weighted:
        w = np.where(rng.random((H, W, 8)) < 0.5, 0.25, 1.0).astype(np.float32)
    s_lo, s_hi = lo, hi
    if tight_s:
        s_lo = np.minimum(lo + 1, hi).astype(np.int32)
        s_hi = np.maximum(hi - 1, s_lo).astype(np.int32)
    return cc, w, lo, hi, s_lo, s_hi


def run_both(cc, w, lo, hi, s_lo, s_hi, p1, p2, ndir, mgm, use_fh,
             fix_overcount=True):
    S0, d0, c0 = mgm_oracle(cc, w, s_lo, s_hi, lo, hi, np.float32(p1),
                            np.float32(p2), ndir, mgm, use_fh=use_fh,
                            fix_overcount=fix_overcount)
    use_w = w is not None
    N = 1
    w8 = jnp.asarray(w)[None] if use_w else None
    S1, d1, c1 = mgm_solve(
        jnp.asarray(cc)[None], w8, jnp.asarray(lo)[None], jnp.asarray(hi)[None],
        jnp.asarray(s_lo)[None], jnp.asarray(s_hi)[None],
        jnp.zeros((N,), jnp.int32),
        p1=float(p1), p2=float(p2), ndir=ndir, mgm=mgm, use_fh=use_fh,
        use_weights=use_w, per_pixel=True, fix_overcount=fix_overcount)
    return (S0, d0, c0), (np.asarray(S1[0]), np.asarray(d1[0]), np.asarray(c1[0]))


def check(oracle_out, jax_out, s_lo, s_hi):
    S0, d0, c0 = oracle_out
    S1, d1, c1 = jax_out
    L = S0.shape[-1]
    l_idx = np.arange(L)
    in_s = (l_idx >= s_lo[..., None]) & (l_idx <= s_hi[..., None])
    # S inside the S windows is what WTA/refinement observe
    a, b = S0[in_s], S1[in_s]
    both_inf = np.isinf(a) & np.isinf(b) & (np.sign(a) == np.sign(b))
    np.testing.assert_allclose(np.where(both_inf, 0, a), np.where(both_inf, 0, b),
                               atol=ATOL, rtol=1e-5)
    np.testing.assert_allclose(c0, c1, atol=ATOL, rtol=1e-5)
    # disparities must agree except where the two minima tie within tol
    close = np.abs(np.take_along_axis(
        S0, np.nan_to_num(d1, nan=0).astype(np.int64)[..., None], axis=-1
    )[..., 0] - c0) <= ATOL * 4
    assert np.all((d0 == d1) | (np.isnan(d0) & np.isnan(d1)) | close)


@pytest.mark.parametrize("ndir", [1, 2, 4, 8])
@pytest.mark.parametrize("mgm", [1, 2, 4])
def test_sgm_potential(rng, ndir, mgm):
    cc, w, lo, hi, s_lo, s_hi = make_problem(rng)
    o, j = run_both(cc, w, lo, hi, s_lo, s_hi, 8, 32, ndir, mgm, False)
    check(o, j, s_lo, s_hi)


@pytest.mark.parametrize("ndir", [4, 8])
@pytest.mark.parametrize("mgm", [1, 2, 4])
def test_fh_potential(rng, ndir, mgm):
    cc, w, lo, hi, s_lo, s_hi = make_problem(rng)
    o, j = run_both(cc, w, lo, hi, s_lo, s_hi, 5, 19, ndir, mgm, True)
    check(o, j, s_lo, s_hi)


@pytest.mark.parametrize("mgm", [1, 2, 4])
@pytest.mark.parametrize("use_fh", [False, True])
def test_weighted(rng, mgm, use_fh):
    cc, w, lo, hi, s_lo, s_hi = make_problem(rng, weighted=True)
    o, j = run_both(cc, w, lo, hi, s_lo, s_hi, 8, 32, 8, mgm, use_fh)
    check(o, j, s_lo, s_hi)


@pytest.mark.parametrize("use_fh", [False, True])
@pytest.mark.parametrize("mgm", [2, 4])
def test_per_pixel_windows(rng, mgm, use_fh):
    cc, w, lo, hi, s_lo, s_hi = make_problem(rng, per_pixel=True)
    o, j = run_both(cc, w, lo, hi, s_lo, s_hi, 8, 32, 8, mgm, use_fh)
    check(o, j, s_lo, s_hi)


@pytest.mark.parametrize("use_fh", [False, True])
def test_per_pixel_windows_weighted(rng, use_fh):
    cc, w, lo, hi, s_lo, s_hi = make_problem(rng, per_pixel=True, weighted=True)
    o, j = run_both(cc, w, lo, hi, s_lo, s_hi, 7, 23, 8, 4, use_fh)
    check(o, j, s_lo, s_hi)


def test_tight_s_windows(rng):
    cc, w, lo, hi, s_lo, s_hi = make_problem(rng, tight_s=True)
    o, j = run_both(cc, w, lo, hi, s_lo, s_hi, 8, 32, 4, 4, False)
    check(o, j, s_lo, s_hi)


def test_no_overcount_fix(rng):
    cc, w, lo, hi, s_lo, s_hi = make_problem(rng)
    o, j = run_both(cc, w, lo, hi, s_lo, s_hi, 8, 32, 4, 4, False,
                    fix_overcount=False)
    check(o, j, s_lo, s_hi)


def test_mgm3(rng):
    """TSGM=3: three causal messages per pass."""
    cc, w, lo, hi, s_lo, s_hi = make_problem(rng)
    o, j = run_both(cc, w, lo, hi, s_lo, s_hi, 8, 32, 8, 3, False)
    check(o, j, s_lo, s_hi)


def test_batched_sides_match_separate(rng):
    """The N axis (LR batching) must not couple problems."""
    cc1, _, lo, hi, s_lo, s_hi = make_problem(rng)
    cc2, _, _, _, _, _ = make_problem(rng)
    both = jnp.stack([jnp.asarray(cc1), jnp.asarray(cc2)])
    lo_b = jnp.asarray(np.stack([lo, lo]))
    hi_b = jnp.asarray(np.stack([hi, hi]))
    gmin = jnp.zeros((2,), jnp.int32)
    Sb, db, cb = mgm_solve(both, None, lo_b, hi_b, lo_b, hi_b, gmin,
                           p1=8.0, p2=32.0, ndir=4, mgm=4, use_fh=False,
                           use_weights=False, per_pixel=False,
                           fix_overcount=True)
    for i, cc in enumerate([cc1, cc2]):
        S1, d1, c1 = mgm_solve(jnp.asarray(cc)[None], None,
                               lo_b[:1], hi_b[:1], lo_b[:1], hi_b[:1],
                               gmin[:1],
                               p1=8.0, p2=32.0, ndir=4, mgm=4, use_fh=False,
                               use_weights=False, per_pixel=False,
                               fix_overcount=True)
        np.testing.assert_array_equal(np.asarray(db[i]), np.asarray(d1[0]))
        np.testing.assert_allclose(np.asarray(cb[i]), np.asarray(c1[0]),
                                   atol=1e-5)


@pytest.mark.parametrize("ndir", [12, 16])
@pytest.mark.parametrize("mgm", [1, 2, 4])
def test_knight_directions(rng, ndir, mgm):
    """-O 16 support (the 22.5-degree passes the reference crashes on)."""
    cc, w, lo, hi, s_lo, s_hi = make_problem(rng)
    o, j = run_both(cc, w, lo, hi, s_lo, s_hi, 8, 32, ndir, mgm, False)
    check(o, j, s_lo, s_hi)


def test_knight_weighted_fh(rng):
    cc, w, lo, hi, s_lo, s_hi = make_problem(rng, weighted=True)
    o, j = run_both(cc, w, lo, hi, s_lo, s_hi, 5, 19, 16, 4, True)
    check(o, j, s_lo, s_hi)
