"""Multi-device partitioned run == single-device run, exactly.

The determinism/equivalence tests that replace the reference's (absent)
race detection story (SURVEY.md section 5): the same solve executed over
a 1-, 2-, 4- and 8-device row-sharded mesh must produce bitwise-equal
disparities and costs.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mgm_tpu.parallel import make_mesh, sharded_solve


def make_problem(rng, N=2, H=16, W=12, L=8):
    cc = jnp.asarray(rng.uniform(0, 50, (N, H, W, L)).astype(np.float32))
    w8 = jnp.asarray(np.where(rng.random((N, H, W, 8)) < 0.5, 0.25, 1.0)
                     .astype(np.float32))
    lo = jnp.zeros((N, H, W), jnp.int32)
    hi = jnp.full((N, H, W), L - 1, jnp.int32)
    gmin = jnp.zeros((N,), jnp.int32)
    return cc, w8, lo, hi, gmin


def solve_on(n_dev, prob, **kw):
    cc, w8, lo, hi, gmin = prob
    mesh = make_mesh(n_dev)
    S, disp, cost = sharded_solve(mesh, cc, w8, lo, hi, lo, hi, gmin, **kw)
    return (np.asarray(S), np.asarray(disp), np.asarray(cost))


@pytest.mark.parametrize("n_dev", [2, 4, 8])
@pytest.mark.parametrize("use_fh", [False, True])
def test_sharded_equals_single(rng, n_dev, use_fh):
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    prob = make_problem(rng)
    kw = dict(p1=8.0, p2=32.0, ndir=8, mgm=4, use_fh=use_fh,
              use_weights=True)
    S1, d1, c1 = solve_on(1, prob, **kw)
    Sn, dn, cn = solve_on(n_dev, prob, **kw)
    np.testing.assert_array_equal(d1, dn)
    np.testing.assert_array_equal(c1, cn)
    np.testing.assert_array_equal(S1, Sn)


def test_graft_entry_dryrun():
    import __graft_entry__ as ge
    ge.dryrun_multichip(8)


def test_graft_entry_single():
    import jax
    import __graft_entry__ as ge
    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)


def test_solve_tiled_matches_mrf(rng):
    """solve_tiled (mesh entry) == solve_mrf (single-device entry)."""
    from mgm_tpu.mrf import solve_mrf
    from mgm_tpu.parallel import solve_tiled

    H, W, L = 12, 10, 7
    unary = rng.uniform(0, 40, (H, W, L)).astype(np.float32)
    want = solve_mrf(unary, ndir=8, p1=8, p2=32, mgm=2, vtype=0)
    mesh = make_mesh(4)
    disp, cost = solve_tiled(mesh, jnp.asarray(unary)[None],
                             p1=8.0 * 1, p2=32.0 * 1, ndir=8, mgm=2)
    np.testing.assert_array_equal(np.asarray(disp[0]), want)


@pytest.mark.parametrize("ndir,mgm", [(4, 2), (8, 4), (16, 4)])
def test_halo_aggregate_exact(rng, ndir, mgm):
    """Explicit halo-exchange tiled recursion == single-device
    aggregation (the halo carries the full directional state,
    SURVEY.md 'halo-exact tiled recursion').  Bitwise when the pass
    grouping matches (mgm=2); at mgm=4 the single-device xla backend
    mixes axis+diag passes into one scan, so the sums of identical
    per-pass volumes associate differently -> float-epsilon tolerance.
    """
    from mgm_tpu.ops.aggregate import aggregate
    from mgm_tpu.parallel.halo import halo_aggregate

    N, H, W, L = 2, 16, 8, 6
    cc = jnp.asarray(rng.uniform(0, 50, (N, H, W, L)).astype(np.float32))
    want = aggregate(cc, None, None, None, p1=8.0, p2=32.0, ndir=ndir,
                     mgm=mgm, backend="xla")
    mesh = make_mesh(4)
    got = halo_aggregate(mesh, cc, p1=8.0, p2=32.0, ndir=ndir, mgm=mgm)
    if mgm == 2:
        np.testing.assert_array_equal(np.asarray(want), np.asarray(got))
    else:
        np.testing.assert_allclose(np.asarray(want), np.asarray(got),
                                   atol=1e-3, rtol=1e-6)


def test_halo_aggregate_ragged_rows(rng):
    """Row/column counts that do NOT divide the mesh size: canonical
    rows pad with +inf cost rows (messages only flow downward, so the
    padding is inert) and the result still matches single-device."""
    from mgm_tpu.ops.aggregate import aggregate
    from mgm_tpu.parallel.halo import halo_aggregate

    N, H, W, L = 2, 13, 7, 6  # 13 rows over 4 devices -> pad to 16
    cc = jnp.asarray(rng.uniform(0, 50, (N, H, W, L)).astype(np.float32))
    w8 = jnp.asarray(np.where(rng.random((N, H, W, 8)) < 0.5, 0.25, 1.0)
                     .astype(np.float32))
    mesh = make_mesh(4)
    want = aggregate(cc, None, None, None, p1=8.0, p2=32.0, ndir=4, mgm=2,
                     backend="xla")
    got = halo_aggregate(mesh, cc, p1=8.0, p2=32.0, ndir=4, mgm=2)
    np.testing.assert_array_equal(np.asarray(want), np.asarray(got))
    want = aggregate(cc, w8, None, None, p1=5.0, p2=19.0, ndir=8, mgm=4,
                     use_fh=True, use_weights=True, backend="xla")
    got = halo_aggregate(mesh, cc, w8, p1=5.0, p2=19.0, ndir=8, mgm=4,
                         use_fh=True, use_weights=True)
    np.testing.assert_allclose(np.asarray(want), np.asarray(got),
                               atol=1e-3, rtol=1e-6)


def test_halo_aggregate_weighted_fh(rng):
    from mgm_tpu.ops.aggregate import aggregate
    from mgm_tpu.parallel.halo import halo_aggregate

    N, H, W, L = 1, 16, 8, 6
    cc = jnp.asarray(rng.uniform(0, 50, (N, H, W, L)).astype(np.float32))
    w8 = jnp.asarray(np.where(rng.random((N, H, W, 8)) < 0.5, 0.25, 1.0)
                     .astype(np.float32))
    want = aggregate(cc, w8, None, None, p1=5.0, p2=19.0, ndir=8, mgm=4,
                     use_fh=True, use_weights=True, backend="xla")
    mesh = make_mesh(4)
    got = halo_aggregate(mesh, cc, w8, p1=5.0, p2=19.0, ndir=8, mgm=4,
                         use_fh=True, use_weights=True)
    np.testing.assert_allclose(np.asarray(want), np.asarray(got),
                               atol=1e-3, rtol=1e-6)


def test_pipeline_mesh_ragged_rows(rng):
    """Full compute_disparity pipeline on an H that does NOT divide the
    mesh size: fake bottom rows are appended after the boundary-
    sensitive prep stages and masked out of the recursion
    (aggregate._pad_geometry), so the sharded run is BITWISE-equal to
    the single-device run."""
    from mgm_tpu.config import MGMConfig
    from mgm_tpu.stereo import compute_disparity

    H, W = 27, 24  # 27 rows over 4 devices -> pad to 28
    u = rng.uniform(0, 50, (H, W, 1)).astype(np.float32)
    v = (np.roll(u, 2, axis=1)
         + rng.normal(0, 1, (H, W, 1)).astype(np.float32))
    for cfg in (MGMConfig(dmin=-4, dmax=2, ndir=8, mgm=4, a_p2=0.5,
                          refinement="vfit", median_radius=1, test_lr=True),
                MGMConfig(dmin=-4, dmax=2, ndir=4, mgm=2, iterations=2,
                          distance="census", prefilter="census",
                          use_trunc_linear=True, p1=2, p2=100,
                          refinement="parabola", test_lr=True)):
        a = compute_disparity(u, v, cfg)
        b = compute_disparity(u, v, cfg, mesh=make_mesh(4))
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_pipeline_mesh_per_pixel(rng):
    """Full compute_disparity pipeline, row-sharded, with per-pixel
    -m/-M windows == the unsharded volume path."""
    from mgm_tpu import synth
    from mgm_tpu.models.presets import get_preset
    from mgm_tpu.stereo import compute_disparity

    u, v, _ = synth.fountain_pair(seed=0)
    u, v = u[200:232, 300:348], v[200:232, 300:348]
    H, W, _ = u.shape
    dmin_img = (-18 + 5 * rng.random((H, W))).astype(np.float32)
    dmax_img = (dmin_img + 10).astype(np.float32)
    cfg = get_preset("fast_ad", dmin=-18, dmax=4, test_lr=True)
    a = compute_disparity(u, v, cfg, dmin_img=dmin_img, dmax_img=dmax_img)
    b = compute_disparity(u, v, cfg, dmin_img=dmin_img, dmax_img=dmax_img,
                          mesh=make_mesh(4))
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)
