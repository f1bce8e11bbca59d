"""Multi-chip execution of the MGM solver over a device mesh.

The reference has no distributed story at all (its parallelism is dead
OpenMP pragmas, Makefile:1-4 of gfacciol/mgm); this module is the
scaling design that replaces it:

  - The (N, H, W, L) problem volumes are sharded over a 1-D mesh along
    the image row axis H (axis name "y"): cost-volume build, S
    accumulation, WTA, refinement and all post-processing are local.
  - The directional wavefront recursion is a `lax.scan` whose carry is
    the skewed volume sharded on rows.  The only cross-row dependency in
    a scan step is a shift-by-one-row of the previous fronts
    (aggregate.py `rsh`), which the XLA SPMD partitioner turns into a
    collective-permute of a single boundary row (an (BN, 1, L) tile)
    per step between devices — exactly the halo exchange a hand-written
    pipeline would do.
  - Passes whose canonical scan is column-major have their parallel
    axis along W; their canonical volumes are resharded once per pass
    group (an all-to-all), not per scan step.

This keeps one code path for 1 and N devices: `sharded_solve` is the
same `mgm_solve` jitted with sharded inputs, and tiled == single-device
output equality is asserted in tests/test_sharding.py.

`parallel.halo.halo_aggregate` is the explicit-collective counterpart:
the same recursion written as a shard_map pipeline that ppermutes one
boundary row of directional state per wavefront step — the pattern to
scale onto real multi-device links (and multi-host networks) where the
auto-partitioner's choices need to be pinned down.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..solver import mgm_solve


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the row axis."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), ("y",))


def row_sharding(mesh: Mesh, ndim: int, row_axis: int = 1) -> NamedSharding:
    spec = [None] * ndim
    spec[row_axis] = "y"
    return NamedSharding(mesh, P(*spec))


@partial(jax.jit, static_argnames=("p1", "p2", "ndir", "mgm", "use_fh",
                                   "use_weights", "per_pixel",
                                   "fix_overcount"))
def _solve(cc, w8, lo, hi, s_lo, s_hi, gmin, **kw):
    # the XLA scan: the CUDA recursion kernel is a single-device call
    return mgm_solve(cc, w8, lo, hi, s_lo, s_hi, gmin, backend="xla", **kw)


def sharded_solve(mesh: Mesh, cc, w8, lo, hi, s_lo, s_hi, gmin, *,
                  p1: float, p2: float, ndir: int, mgm: int,
                  use_fh: bool = False, use_weights: bool = False,
                  per_pixel: bool = False, fix_overcount: bool = True):
    """mgm_solve with inputs device_put onto a row-sharded layout; the
    SPMD partitioner distributes the wavefront scans with per-step
    boundary-row collective-permutes."""
    s4 = row_sharding(mesh, 4)
    s3 = row_sharding(mesh, 3)
    rep = NamedSharding(mesh, P())
    cc = jax.device_put(cc, s4)
    w8 = jax.device_put(w8, s4) if w8 is not None else None
    lo, hi, s_lo, s_hi = (jax.device_put(a, s3) for a in (lo, hi, s_lo, s_hi))
    gmin = jax.device_put(gmin, rep)
    return _solve(cc, w8, lo, hi, s_lo, s_hi, gmin,
                  p1=p1, p2=p2, ndir=ndir, mgm=mgm, use_fh=use_fh,
                  use_weights=use_weights, per_pixel=per_pixel,
                  fix_overcount=fix_overcount)


def solve_tiled(mesh: Mesh, cc, w8=None, *, p1: float, p2: float,
                ndir: int, mgm: int, use_fh: bool = False,
                fix_overcount: bool = True):
    """Convenience entry for full-window problems (labels 0..L-1
    everywhere, the mgm_o protocol): returns (disp, cost)."""
    N, H, W, L = cc.shape
    zeros = jnp.zeros((N, H, W), jnp.int32)
    full = jnp.full((N, H, W), L - 1, jnp.int32)
    gmin = jnp.zeros((N,), jnp.int32)
    use_w = w8 is not None
    _, disp, cost = sharded_solve(mesh, cc, w8, zeros, full, zeros, full,
                                  gmin, p1=p1, p2=p2, ndir=ndir, mgm=mgm,
                                  use_fh=use_fh, use_weights=use_w,
                                  per_pixel=False,
                                  fix_overcount=fix_overcount)
    return disp, cost
