"""Tiled large-scene runner: mosaicking, exactness with full-context
margins, checkpoint/resume."""
import numpy as np

import mgm_tpu.runner as runner
from mgm_tpu.config import MGMConfig
from mgm_tpu.runner import tiled_disparity
from mgm_tpu.stereo import compute_disparity


def _pair(rng, H=24, W=40):
    u = rng.uniform(0, 50, (H, W, 1)).astype(np.float32)
    v = np.roll(u, 3, axis=1) + rng.normal(0, 1, (H, W, 1)).astype(np.float32)
    return u, v


CFG = MGMConfig(dmin=-6, dmax=2, ndir=4, mgm=2, test_lr=True)


def test_tiled_full_margin_exact(rng):
    """margin >= scene size: every tile sees the whole pair, so the
    mosaic equals the single-solve result bit-for-bit."""
    u, v = _pair(rng)
    ref = compute_disparity(u, v, CFG, outputs=("disp", "cost"))
    out = tiled_disparity(u, v, CFG, tile=16, margin=64)
    assert out["tiles_solved"] == 6  # 2x3 grid of 16-px tiles on 24x40
    np.testing.assert_array_equal(out["disp"], ref["disp"])
    np.testing.assert_array_equal(out["cost"], ref["cost"])


def test_tiled_realistic_margin(rng):
    """A realistic (smaller-than-scene) margin agrees with the single
    solve away from truncated-context effects."""
    u, v = _pair(rng, H=32, W=48)
    ref = compute_disparity(u, v, CFG, outputs=("disp",))["disp"]
    out = tiled_disparity(u, v, CFG, tile=16, margin=8)["disp"]
    both = np.isfinite(ref) & np.isfinite(out)
    assert both.mean() > 0.5
    assert (ref[both] == out[both]).mean() >= 0.9


def test_tiled_checkpoint_resume(rng, tmp_path, monkeypatch):
    u, v = _pair(rng)
    ck = str(tmp_path / "ck")
    first = tiled_disparity(u, v, CFG, tile=16, margin=64,
                            checkpoint_dir=ck)
    assert first["tiles_solved"] == 6
    # drop one tile's checkpoint: the resume must re-solve exactly it
    (tmp_path / "ck" / "tile_16_16.npz").unlink()
    calls = []
    real = compute_disparity

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(runner, "compute_disparity", counting)
    second = tiled_disparity(u, v, CFG, tile=16, margin=64,
                             checkpoint_dir=ck)
    assert second["tiles_solved"] == 1 and len(calls) == 1
    np.testing.assert_array_equal(second["disp"], first["disp"])
    np.testing.assert_array_equal(second["cost"], first["cost"])


def test_tiled_cli(rng, tmp_path):
    from mgm_tpu.io import read_image, write_image

    u, v = _pair(rng)
    lp, rp = str(tmp_path / "l.tif"), str(tmp_path / "r.tif")
    write_image(lp, u)
    write_image(rp, v)
    od = str(tmp_path / "d.tif")
    rc = runner.main([lp, rp, od, "--preset", "fast_ad", "-r", "-6",
                      "-R", "2", "--tile", "16", "--margin", "64"])
    assert rc == 0
    ref = compute_disparity(u, v, runner_cfg(), outputs=("disp",))["disp"]
    got = read_image(od)[..., 0]
    fa, fb = np.isfinite(ref), np.isfinite(got)
    np.testing.assert_array_equal(fa, fb)
    np.testing.assert_array_equal(got[fb], ref[fa])


def runner_cfg():
    from mgm_tpu.models.presets import get_preset
    return get_preset("fast_ad", dmin=-6, dmax=2)


def test_tiled_per_pixel_windows(rng):
    """-m/-M scene windows crop per tile; margin >= scene reproduces
    the single per-pixel solve exactly."""
    u, v = _pair(rng)
    H, W, _ = u.shape
    dmin_img = np.full((H, W), -6, np.float32)
    dmax_img = np.full((H, W), 2, np.float32)
    dmin_img[:10] = -4
    dmax_img[:, :20] = 1
    ref = compute_disparity(u, v, CFG, dmin_img=dmin_img,
                            dmax_img=dmax_img, outputs=("disp", "cost"))
    out = tiled_disparity(u, v, CFG, tile=16, margin=64,
                          dmin_img=dmin_img, dmax_img=dmax_img)
    np.testing.assert_array_equal(out["disp"], ref["disp"])
    np.testing.assert_array_equal(out["cost"], ref["cost"])


def test_tiled_batch_codec_stream_exact(rng, monkeypatch):
    """The streamed batch path with census-exact uint16 slab uploads
    (per-slab codecs) mosaics bitwise-identically to the raw-float32
    stream AND to the sequential tiling."""
    cfg = MGMConfig(dmin=-6, dmax=2, ndir=4, mgm=2, distance="census",
                    census_ncc_win=5, test_lr=True)
    u, v = _pair(rng, H=32, W=48)
    u += 300.0  # not uint8-representable -> the codec path engages
    v += 300.0
    from mgm_tpu.ops import census_codec
    assert census_codec.eligible(cfg)
    seq = tiled_disparity(u, v, cfg, tile=16, margin=4)
    monkeypatch.setenv("MGM_TPU_CODEC16", "0")
    raw = tiled_disparity(u, v, cfg, tile=16, margin=4, batch=3)
    monkeypatch.setenv("MGM_TPU_CODEC16", "1")
    coded = tiled_disparity(u, v, cfg, tile=16, margin=4, batch=3)
    for k in ("disp", "cost"):
        np.testing.assert_array_equal(raw[k], coded[k], err_msg=k)
        np.testing.assert_array_equal(seq[k], coded[k], err_msg=k)


def test_tiled_batch_matches_sequential(rng):
    """batch>1 groups same-shape tile crops into one batched call; the
    mosaic must equal the sequential tiling exactly (and pad a short
    trailing group without corrupting it)."""
    u, v = _pair(rng)
    a = tiled_disparity(u, v, CFG, tile=16, margin=4)
    b = tiled_disparity(u, v, CFG, tile=16, margin=4, batch=3)
    assert a["tiles_solved"] == b["tiles_solved"]
    np.testing.assert_array_equal(a["disp"], b["disp"])
    np.testing.assert_array_equal(a["cost"], b["cost"])
