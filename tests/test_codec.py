"""Census-exact uint16 upload codec (ops/census_codec.py).

The codec's claim is strong — bit-identical pipeline outputs from a
2-byte wire form — so it is tested at three levels: the comparison-
preserving property itself, grouped-encode behaviour on data with
more distinct values than uint16 levels, and end-to-end pipeline
equality on crops of the seeded satellite-class pair (BASELINE cfg3's
geometry and value range, mgm_tpu.synth)."""
import functools

import numpy as np
import pytest

from mgm_tpu import synth
from mgm_tpu.models.presets import get_preset
from mgm_tpu.ops import census_codec
from mgm_tpu.stereo import compute_disparity


@functools.cache
def _pairs():
    return synth.satellite_pair(seed=0)[:2], synth.fountain_pair(seed=0)[:2]


def _satellite_crop(h=96, w=104):
    u, v = _pairs()[0]
    return u[:h, :w], v[:h, :w]


def _fountain_crop(h, w):
    u, v = _pairs()[1]
    return u[:h, :w], v[:h, :w]


def test_eligibility_gates():
    sat = get_preset("satellite")
    assert census_codec.eligible(sat)
    assert census_codec.eligible(get_preset("census_tl"))
    assert not census_codec.eligible(get_preset("fast_ad"))  # ad cost
    assert not census_codec.eligible(get_preset("ncc"))  # value cost
    assert not census_codec.eligible(
        get_preset("sobelx_tl"))  # value prefilter
    assert not census_codec.eligible(get_preset("satellite", a_p2=8.0))


def test_codes_preserve_window_comparisons():
    rng = np.random.default_rng(7)
    img = rng.normal(size=(40, 52, 1)).astype(np.float32)
    img[3, 5, 0] = np.nan  # scrubbed to 0 like the device prep
    codes = census_codec.encode(img, win=5)
    assert codes is not None and codes.dtype == np.uint16
    assert census_codec.verify_codes(img, codes, radius=2)


def test_grouped_encode_when_over_u16():
    """> 65536 distinct values forces the grouped (merged-rank) path;
    the merge must stay comparison-exact.  A random-walk image has the
    structure the codec exploits: window-neighbour differences are
    orders of magnitude larger than the global value spacing."""
    rng = np.random.default_rng(3)
    img = np.cumsum(rng.normal(size=(300, 300)), axis=1)
    img = (img + rng.normal(scale=1e-4, size=img.shape)).astype(
        np.float32)[..., None]
    assert np.unique(img).size > 65536
    codes = census_codec.encode(img, win=3)
    assert codes is not None, "random-walk image must be groupable"
    assert census_codec.verify_codes(img, codes, radius=1)


def test_over_u16_random_data():
    """Even all-distinct random data must either encode exactly or be
    declined — never encode wrong.  (Co-occurrence is sparse — ~8
    partners per value — so grouping usually succeeds even here.)"""
    rng = np.random.default_rng(3)
    img = rng.normal(size=(300, 300, 1)).astype(np.float32)
    assert np.unique(img).size > 65536
    codes = census_codec.encode(img, win=3)
    if codes is not None:
        assert census_codec.verify_codes(img, codes, radius=1)


def test_satellite_fits_u16():
    u, v = _satellite_crop(271, 279)
    for img in (u, v):
        codes = census_codec.encode(img, win=5)
        assert codes is not None
        assert census_codec.verify_codes(img, codes, radius=2)


def test_pipeline_bit_identical_on_satellite(monkeypatch):
    """cfg3-class solve: uint16-coded upload == float32 upload, every
    output bitwise (NaNs included)."""
    u, v = _satellite_crop()
    cfg = get_preset("satellite", test_lr=True)
    monkeypatch.setenv("MGM_TPU_CODEC16", "0")
    raw = compute_disparity(u, v, cfg)
    monkeypatch.setenv("MGM_TPU_CODEC16", "1")
    coded = compute_disparity(u, v, cfg)
    assert raw.keys() == coded.keys()
    for k in raw:
        np.testing.assert_array_equal(raw[k], coded[k], err_msg=k)


def test_pipeline_bit_identical_grouped(monkeypatch):
    """Force the grouped path (distinct values > u16) on a smooth
    synthetic pair and require bitwise-equal pipeline outputs."""
    rng = np.random.default_rng(11)
    base = np.cumsum(rng.normal(size=(120, 600)), axis=1)
    u = (base + rng.normal(scale=1e-3, size=base.shape)).astype(
        np.float32)[..., None]
    v = np.roll(u, 3, axis=1)
    cfg = get_preset("satellite", dmin=-5, dmax=5)
    enc = census_codec.encode(u, win=5)
    if enc is None or np.unique(u).size <= 65536:
        pytest.skip("synthetic pair did not exercise the grouped path")
    monkeypatch.setenv("MGM_TPU_CODEC16", "0")
    raw = compute_disparity(u, v, cfg)
    monkeypatch.setenv("MGM_TPU_CODEC16", "1")
    coded = compute_disparity(u, v, cfg)
    for k in raw:
        np.testing.assert_array_equal(raw[k], coded[k], err_msg=k)


def test_fetch_buf_chunked_bit_exact():
    """_fetch_buf reassembles parallel chunk fetches verbatim."""
    import jax.numpy as jnp

    from mgm_tpu.stereo import _fetch_buf
    rng = np.random.default_rng(5)
    host = rng.integers(-2**15, 2**15, size=3_000_017).astype(np.int16)
    buf = jnp.asarray(host)
    np.testing.assert_array_equal(_fetch_buf(buf), host)


# ---- integer OUTPUT codec (stereo._pack_spec and friends) ----------------

def test_pack_spec_gates():
    """The static proof obligations of the integer output codec:
    integer disparities always pack; costs pack ONLY at mgm=1 (AD on
    uint8, integer P1/P2) — at mgm>=2 the /k compounds per front and
    the values leave every fixed-denominator lattice.  Refined,
    weighted, float-image and BT configs must not pack costs."""
    from mgm_tpu.stereo import _pack_spec

    cfg = get_preset("fast_ad", dmin=-120, dmax=30)  # mgm=2, no refine
    assert _pack_spec(cfg, 3, np.uint8, False) == ("int8", False)
    sgm = get_preset("fast_ad", mgm=1)  # plain SGM: ÷k never compounds
    assert _pack_spec(sgm, 3, np.uint8, False) == ("int8", True)
    assert _pack_spec(sgm, 3, np.uint8, True)[1] is False  # weights
    assert _pack_spec(sgm, 3, np.float32, False)[1] is False
    ref = get_preset("fast_ad", mgm=1, refinement="vfit")
    assert _pack_spec(ref, 3, np.uint8, False) == (None, False)
    bt = get_preset("fast_ad", mgm=1, distance="btad")
    assert _pack_spec(bt, 3, np.uint8, False)[1] is False  # half-pixels
    wide = get_preset("fast_ad", dmin=-300, dmax=30)
    assert _pack_spec(wide, 3, np.uint8, False)[0] == "int16"
    frac = get_preset("fast_ad", mgm=1, p1=2.5)  # 2.5*3 not integral
    assert _pack_spec(frac, 3, np.uint8, False)[1] is False
    assert _pack_spec(frac, 2, np.uint8, False)[1] is True  # 2.5*2 = 5


def test_output_codec_bit_identical(monkeypatch):
    """End-to-end equality of the packed-integer output wire form
    against the raw float32 fetch on a fountain-class crop (uint8
    images, AD, mgm=2: disparities ship as int8, costs as int16 =
    4*cost)."""
    from mgm_tpu.stereo import _pack_spec

    u, v = _fountain_crop(56, 64)
    for mgm, want in ((1, ("int8", True)), (2, ("int8", False))):
        cfg = get_preset("fast_ad", dmin=-12, dmax=4, mgm=mgm)
        assert _pack_spec(cfg, 3, np.uint8, False) == want
        monkeypatch.setenv("MGM_TPU_PACKOUT", "0")
        raw = compute_disparity(u, v, cfg)
        monkeypatch.setenv("MGM_TPU_PACKOUT", "1")
        packed = compute_disparity(u, v, cfg)
        assert set(raw) == set(packed)
        for k in raw:
            assert packed[k].dtype == np.float32, k
            np.testing.assert_array_equal(raw[k], packed[k], err_msg=k)
        assert np.isnan(packed["disp"]).any()  # LR invalidations survive


def test_output_codec_batch_bit_identical(monkeypatch):
    """Same equality through compute_disparity_batch (the serving /
    scene-tile entry)."""
    from mgm_tpu.stereo import compute_disparity_batch

    u, v = _fountain_crop(48, 56)
    us = np.stack([u, v])   # two distinct "pairs"
    vs = np.stack([v, u])
    cfg = get_preset("fast_ad", dmin=-8, dmax=4)
    monkeypatch.setenv("MGM_TPU_PACKOUT", "0")
    raw = compute_disparity_batch(us, vs, cfg)
    monkeypatch.setenv("MGM_TPU_PACKOUT", "1")
    packed = compute_disparity_batch(us, vs, cfg)
    for k in raw:
        assert packed[k].dtype == np.float32, k
        np.testing.assert_array_equal(raw[k], packed[k], err_msg=k)
