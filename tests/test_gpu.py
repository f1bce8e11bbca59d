"""On-card tests: the CUDA recursion kernel against the XLA scan, and each
preset's pipeline on both routes.  They need an NVIDIA GPU and skip
elsewhere:

    JAX_PLATFORMS=cuda python -m pytest tests/test_gpu.py
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mgm_tpu.ops.aggregate import aggregate

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU "
                    "(JAX_PLATFORMS=cuda python -m pytest tests/test_gpu.py)")


def _problem(rng, N=2, H=23, W=37, L=19, weighted=False):
    cc = rng.uniform(0, 50, (N, H, W, L)).astype(np.float32)
    w8 = None
    if weighted:
        w8 = jnp.asarray(np.where(rng.random((N, H, W, 8)) < 0.5, 0.25, 1.0)
                         .astype(np.float32))
    return jnp.asarray(cc), w8


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mgm", [1, 2, 3, 4])
@pytest.mark.parametrize("ndir", [1, 2, 4, 8])
def test_kernel_matches_xla_scan(gpu, rng, ndir, mgm, weighted):
    cc, w8 = _problem(rng, weighted=weighted)
    kw = dict(p1=8.0, p2=32.0, ndir=ndir, mgm=mgm, use_weights=weighted)
    a = np.asarray(aggregate(cc, w8, backend="xla", **kw))
    b = np.asarray(aggregate(cc, w8, backend="cuda", **kw))
    if weighted:  # p1*w may round differently where XLA contracts to fma
        np.testing.assert_allclose(b, a, rtol=1e-5)
    else:
        np.testing.assert_array_equal(b, a)


def test_kernel_label_windows(gpu, rng):
    """+inf outside per-pixel label windows (the Dvec convention)."""
    cc, _ = _problem(rng)
    N, H, W, L = cc.shape
    lo = rng.integers(0, L - 2, (N, H, W))
    hi = np.minimum(lo + rng.integers(1, L, (N, H, W)), L - 1)
    lab = np.arange(L)
    cc = jnp.where(jnp.asarray((lab >= lo[..., None]) & (lab <= hi[..., None])),
                   cc, jnp.inf)
    for mgm in (2, 4):
        kw = dict(p1=8.0, p2=32.0, ndir=8, mgm=mgm)
        np.testing.assert_array_equal(
            np.asarray(aggregate(cc, backend="cuda", **kw)),
            np.asarray(aggregate(cc, backend="xla", **kw)))


def test_kernel_wide_labels(gpu, rng):
    """L > 32 * lanes-per-pass and a tall, narrow plane."""
    cc, _ = _problem(rng, N=1, H=61, W=9, L=151)
    kw = dict(p1=8.0, p2=32.0, ndir=4, mgm=2)
    np.testing.assert_array_equal(
        np.asarray(aggregate(cc, backend="cuda", **kw)),
        np.asarray(aggregate(cc, backend="xla", **kw)))


@pytest.mark.parametrize("preset", ["fast_ad", "satellite", "census_tl",
                                    "bt", "ncc"])
def test_preset_routes_agree(gpu, preset):
    from mgm_tpu import synth
    from mgm_tpu.models.presets import get_preset
    from mgm_tpu.stereo import compute_disparity

    u, v, _ = synth.fountain_pair(seed=3, shape=(40, 64, 3), dmin=-10,
                                  dmax=-2)
    cfg = get_preset(preset, dmin=-12, dmax=4)
    a = compute_disparity(u, v, cfg, backend="auto")
    b = compute_disparity(u, v, cfg, backend="xla")
    for k in a:
        fa, fb = np.isfinite(a[k]), np.isfinite(b[k])
        assert (fa == fb).mean() >= 0.999, k
        both = fa & fb
        assert (np.abs(a[k][both] - b[k][both]) <= 0.05).mean() >= 0.995, k
