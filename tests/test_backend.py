"""The backend decision, the CUDA kernel's host-side wrapper, and the
compile-cache placement — everything around the GPU route that the CPU
can check.

The kernel itself has no interpreter.  `kernel_model` below replays its
index arithmetic (descriptor table -> canonical (r, c) -> image pixel,
neighbour offsets, border rule, message order) in numpy, so the table
and the pass sum are pinned to the XLA scan here; tests/test_gpu.py
pins the compiled kernel to the same scan on the card.
"""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

import mgm_tpu
from mgm_tpu.backend import kernel_supports, recursion_route
from mgm_tpu.ops import wavefront_cuda as wc
from mgm_tpu.ops.aggregate import _dir2off, _pass_groups, PASS_TABLE, aggregate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------- routes

@pytest.mark.parametrize("ndir,use_fh", [(1, False), (4, False), (8, True),
                                         (16, False)])
def test_cpu_takes_xla(ndir, use_fh):
    assert recursion_route(ndir=ndir, use_fh=use_fh,
                           platform="cpu") == "xla"


@pytest.mark.parametrize("ndir", [1, 2, 4, 8])
def test_gpu_takes_kernel(ndir):
    assert recursion_route(ndir=ndir, use_fh=False, platform="gpu") == "cuda"


@pytest.mark.parametrize("kw", [dict(ndir=16, use_fh=False),
                                dict(ndir=8, use_fh=True),
                                dict(ndir=4, use_fh=False, hpad=3)])
def test_gpu_leaves_unsupported_cases_to_xla(kw):
    assert not kernel_supports(**{"hpad": 0, **kw})
    assert recursion_route(platform="gpu", **kw) == "xla"


@pytest.mark.parametrize("platform", ["tpu", "rocm", "METAL", "interpret"])
def test_other_platforms_refused(platform):
    with pytest.raises(ValueError, match="unsupported platform"):
        recursion_route(ndir=4, use_fh=False, platform=platform)


@pytest.mark.parametrize("backend", ["pallas", "interpret", "tpu", ""])
def test_unknown_backend_refused(backend):
    with pytest.raises(ValueError, match="unknown backend"):
        recursion_route(backend, ndir=4, use_fh=False, platform="gpu")


def test_explicit_routes():
    assert recursion_route("xla", ndir=16, use_fh=True, platform="gpu") \
        == "xla"
    assert recursion_route("cuda", ndir=8, use_fh=False) == "cuda"
    with pytest.raises(ValueError, match="cuda recursion kernel"):
        recursion_route("cuda", ndir=16, use_fh=False)
    with pytest.raises(ValueError):
        aggregate(jnp.zeros((1, 4, 4, 3)), p1=1.0, p2=2.0, ndir=4, mgm=2,
                  backend="pallas")


def test_default_route_on_this_host():
    """The test suite runs on the CPU, where "auto" is the XLA scan."""
    assert recursion_route(ndir=4, use_fh=False) == "xla"


# ---------------------------------------------------------- kernel table

@pytest.mark.parametrize("mgm", [1, 2, 3, 4])
@pytest.mark.parametrize("ndir", [1, 2, 4, 8])
def test_plane_table(ndir, mgm):
    groups = _pass_groups(ndir, mgm)
    t = wc.plane_table(groups, 2, mgm)
    assert t.shape == (2 * ndir, wc.DESC_FIELDS) and t.dtype == np.int32
    order = [p for gp in groups for p in gp]
    assert sorted(order) == list(range(ndir))
    for i, row in enumerate(t):
        spec = PASS_TABLE[order[i // 2]]
        d2o = _dir2off(spec)[:mgm]
        assert row[0] == i % 2                              # problem
        assert tuple(row[1:4]) == (spec.flip_x, spec.flip_y, spec.row_major)
        assert row[4] == (2 if 3 in d2o else 1)             # slope
        assert row[5] == mgm
        assert tuple(row[6:6 + mgm]) == tuple(d2o)
        assert tuple(row[10:10 + mgm]) == tuple(spec.wch[:mgm])


def test_plane_table_refuses_knight_passes():
    with pytest.raises(AssertionError):
        wc.plane_table(_pass_groups(16, 2), 1, 2)


def _canon_to_pixel(r, c, H, W, flip_x, flip_y, row_major):
    """wavefront.cu Geometry::pixel."""
    y, x = (r, c) if row_major else (c, r)
    if flip_y:
        y = H - 1 - y
    if flip_x:
        x = W - 1 - x
    return y, x


def kernel_model(cc, w8, table, *, p1, p2, use_weights, div_each):
    """numpy replay of wavefront_kernel: per plane, front by front."""
    N, H, W, L = cc.shape
    f32 = np.float32
    out = np.zeros((len(table), H, W, L), f32)
    for p, row in enumerate(table):
        n, fx, fy, rm, slope, nd = (int(x) for x in row[:6])
        offs, wch = row[6:10], row[10:14]
        R, C = (H, W) if rm else (W, H)
        mins = np.zeros((R, C), f32)
        for t in range(C + slope * (R - 1)):
            for r in range(R):
                c = t - slope * r
                if not 0 <= c < C:
                    continue
                y, x = _canon_to_pixel(r, c, H, W, fx, fy, rm)
                v = cc[n, y, x].copy()
                if r >= 1 and 1 <= c <= C - 2:
                    msgs = []
                    for k in range(nd):
                        rn, cn = {0: (r, c - 1), 1: (r - 1, c),
                                  2: (r - 1, c - 1),
                                  3: (r - 1, c + 1)}[int(offs[k])]
                        lk = out[p][_canon_to_pixel(rn, cn, H, W, fx, fy, rm)]
                        mk = mins[rn, cn]
                        d = w8[n, y, x, wch[k]] if use_weights else f32(1)
                        p1w = f32(p1) * d if use_weights else f32(p1)
                        p2w = f32(p2) * d if use_weights else f32(p2)
                        sh = np.full(L + 2, np.inf, f32)
                        sh[1:-1] = lk
                        vlp1 = np.minimum(sh[:-2], sh[2:]) + p1w
                        msgs.append(np.minimum(np.minimum(lk, vlp1),
                                               mk + p2w) - mk)
                    if div_each:
                        e = msgs[0] * f32(0.5) + msgs[1] * f32(0.5)
                    else:
                        e = msgs[0]
                        for m in msgs[1:]:
                            e = e + m
                        if nd > 1:
                            e = e * (f32(1) / f32(nd))
                    v = v + e
                out[p, y, x] = v
                mins[r, c] = v.min()
    return out


@pytest.mark.parametrize("ndir,mgm,weighted", [
    (1, 1, False), (2, 2, False), (4, 2, False), (4, 3, True),
    (8, 1, False), (8, 2, True), (8, 3, False), (8, 4, False),
    (8, 4, True), (4, 4, False)])
def test_kernel_model_matches_xla_scan(rng, ndir, mgm, weighted):
    """Descriptor table + index arithmetic + pass sum == the XLA scan."""
    N, H, W, L = 2, 6, 7, 5
    cc = rng.uniform(0, 50, (N, H, W, L)).astype(np.float32)
    cc[0, 2, 3, :2] = np.inf  # label windows
    w8 = np.where(rng.random((N, H, W, 8)) < 0.5, 0.25, 1.0).astype(
        np.float32)
    groups = _pass_groups(ndir, mgm)
    div_each = mgm == 2 and not weighted
    lr = kernel_model(cc, w8, wc.plane_table(groups, N, mgm), p1=8.0,
                      p2=32.0, use_weights=weighted, div_each=div_each)
    got = np.asarray(wc.sum_passes(jnp.asarray(lr).reshape(-1, N, H, W, L),
                                   groups))
    want = np.asarray(aggregate(jnp.asarray(cc), jnp.asarray(w8), p1=8.0,
                                p2=32.0, ndir=ndir, mgm=mgm,
                                use_weights=weighted, backend="xla"))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    if not weighted and mgm != 3:
        # XLA:CPU contracts v + e * (1/3) (and p * w + m) into one fma,
        # 1 ulp off the kernel's rounded product, which is what XLA:GPU
        # computes (tests/test_gpu.py); with mgm in {1, 2, 4} and no
        # weights every product is exact
        np.testing.assert_array_equal(got, want)


def test_nvcc_command_targets_hopper():
    cmd = wc.nvcc_command(wc.BUILD_DIR / "x.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-fmad=false" in cmd  # per-op rounding, as the XLA scan
    assert str(wc.SOURCE) == cmd[-1]
    assert wc.library_path().parent == wc.BUILD_DIR
    assert wc.library_path().name.startswith("libmgm_wavefront_")


def test_kernel_source_matches_table_width():
    src = wc.SOURCE.read_text()
    assert f"constexpr int kDesc = {wc.DESC_FIELDS};" in src
    assert "XLA_FFI_DEFINE_HANDLER_SYMBOL(MgmWavefront" in src


# ------------------------------------------------------------ the cache

def test_cache_dir_from_environment():
    env = {"JAX_COMPILATION_CACHE_DIR": "/some/dir"}
    assert mgm_tpu.compilation_cache_dir(env) == "/some/dir"


def test_cache_dir_default_inside_checkout():
    got = mgm_tpu.compilation_cache_dir({})
    assert got == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_cache_off_on_cpu_only_runs():
    assert mgm_tpu.compilation_cache_dir({"JAX_PLATFORMS": "cpu"}) is None
    assert mgm_tpu.compilation_cache_dir(
        {"JAX_PLATFORMS": "cpu", "JAX_COMPILATION_CACHE_DIR": "/d"}) is None


def test_build_dir_is_ignored():
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "build/" in f.read().split()


# ------------------------------------------------------- chip_smoke.py

def _smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_refuses_cpu():
    r = _smoke(REPO)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        (tmp_path / "chip_smoke.py").write_text(f.read())
    r = _smoke(tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
