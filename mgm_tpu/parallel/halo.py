"""Tiled directional recursion with explicit halo exchange.

The reference has no distributed story (its parallelism is dead OpenMP
pragmas, Makefile:1-4 of gfacciol/mgm); SURVEY.md section 2.9 specifies
the accelerator equivalent: partition the image into row tiles across
the mesh and run each directional pass as a block-sequential pipeline
where a device consumes one boundary row of directional state per
wavefront step from its upper neighbour.

This module implements that design literally with `shard_map`: the
skewed volume is sharded on canonical rows; every scan step each device
computes its rows' new front, then `ppermute`s the front's *last row*
(an L-vector per problem) plus its cached minimum to the next device,
which keeps a D-deep halo of received rows to serve the row-above
reads of its first row.  Exactness: tiled == single-device bitwise
(tests/test_sharding.py), because the halo carries the full Dvec state
(SURVEY.md section 5, "halo-exact tiled recursion").

This is the explicit-collective counterpart of parallel/shard.py's
auto-SPMD path, and the template for the multi-host pipeline.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from ._shard_map import shard_map

from ..ops.aggregate import (AXIS_DIR2OFF, DIAG_DIR2OFF, KNIGHT_DIR2OFF,
                             PASS_TABLE, _dir2off, _pass_groups, skew, unskew,
                             to_canonical, from_canonical, _sgm_msg, _fh_msg)
from ..ops.common import INF, shift_fill

AXIS = "y"  # mesh axis carrying the canonical row tiles


def _halo_scan(lr_sk, mins_sk, w_sk, *, T, C, p1, p2, mgm, dir2off, offsets,
               knight, use_fh, use_weights, axis=AXIS):
    """Per-device body: lax.scan over wavefront time with a ppermute of
    the last local row's (front, min) after every step.

    lr_sk: (BN, Rloc, T, L) local rows of the skewed volume.
    Returns the aggregated local rows.
    """
    n_dev = jax.lax.psum(1, axis)
    idx = jax.lax.axis_index(axis)
    BN, Rloc, _, L = lr_sk.shape
    D = 4 if knight else 3
    fwd = [(i, (i + 1) % n_dev) for i in range(n_dev)]

    jj_loc = idx * Rloc + jnp.arange(Rloc, dtype=jnp.int32)
    p1f, p2f = jnp.float32(p1), jnp.float32(p2)

    def rsh(a, halo_row):
        """Row shift: local row j reads j-1; row 0 reads the halo."""
        return jnp.concatenate([halo_row, a[:, :-1]], axis=1)

    def body(carry, t):
        lr, mins, halo_f, halo_m = carry
        # halo_f: (D, BN, 1, L) rows received from the device above for
        # fronts t-1 .. t-D (slot k = front t-1-k); top device sees INF
        front = lambda dt: jnp.maximum(t - dt, 0)
        cc_t = jax.lax.dynamic_slice_in_dim(lr, front(0), 1, axis=2)[:, :, 0]
        f = {d: jax.lax.dynamic_slice_in_dim(lr, front(d), 1,
                                             axis=2)[:, :, 0]
             for d in range(1, D + 1)}
        m = {d: jax.lax.dynamic_slice_in_dim(mins, front(d), 1,
                                             axis=2)[:, :, 0]
             for d in range(1, D + 1)}
        # offset -> (front, min): W same row; N/NW/NE/WWN row above
        neigh = {
            0: (f[1], m[1]),
            1: (rsh(f[2], halo_f[1]), rsh(m[2], halo_m[1])),
            2: (rsh(f[3], halo_f[2]), rsh(m[3], halo_m[2])),
            3: (rsh(f[1], halo_f[0]), rsh(m[1], halo_m[0])),
        }
        if knight:
            neigh[4] = (rsh(f[4], halo_f[3]), rsh(m[4], halo_m[3]))

        if use_weights:
            w_t = jax.lax.dynamic_slice_in_dim(w_sk, front(0), 1,
                                               axis=3)[..., 0]

        def message(off):
            Lk, mk = neigh[off]
            if use_weights:
                delta = w_t[:, off][..., None]
                p1w, p2w = p1f * delta, p2f * delta
            else:
                p1w, p2w = p1f, p2f
            mk_ = mk[..., None]
            if use_fh:
                return _fh_msg(Lk, mk_, p1w, p2w, None, None)
            return _sgm_msg(Lk, mk_, p1w, p2w)

        msgs = {off: message(off) for off in offsets}
        if mgm == 2 and not use_weights and not use_fh:
            e = msgs[dir2off[0]] * 0.5 + msgs[dir2off[1]] * 0.5
        else:
            e = msgs[dir2off[0]]
            for k in range(1, mgm):
                e = e + msgs[dir2off[k]]
            if mgm > 1:
                e = e / jnp.float32(mgm)

        ii = t - 2 * jj_loc
        if knight:
            interior = (jj_loc >= 1) & (ii >= 2) & (ii <= C - 1)
        else:
            interior = (jj_loc >= 1) & (ii >= 1) & (ii <= C - 2)
        new = jnp.where(interior[None, :, None], cc_t + e, cc_t)
        new_min = jnp.min(new, axis=-1)

        lr = jax.lax.dynamic_update_slice_in_dim(lr, new[:, :, None], t,
                                                 axis=2)
        mins = jax.lax.dynamic_update_slice_in_dim(
            mins, new_min[:, :, None], t, axis=2)

        # ship this front's last local row down the pipeline (one
        # boundary row of directional state per step, SURVEY.md 2.9)
        sent_f = jax.lax.ppermute(new[:, -1:, :], axis, fwd)
        sent_m = jax.lax.ppermute(new_min[:, -1:], axis, fwd)
        # device 0 has no upper neighbour: its halo stays +inf
        sent_f = jnp.where(jnp.equal(idx, 0), INF, sent_f)
        sent_m = jnp.where(jnp.equal(idx, 0), INF, sent_m)
        halo_f = jnp.concatenate([sent_f[None], halo_f[:-1]])
        halo_m = jnp.concatenate([sent_m[None], halo_m[:-1]])
        return (lr, mins, halo_f, halo_m), None

    halo_f0 = jnp.full((D, BN, 1, L), INF, jnp.float32)
    halo_m0 = jnp.full((D, BN, 1), INF, jnp.float32)
    mins0 = mins_sk
    (lr, _, _, _), _ = jax.lax.scan(
        body, (lr_sk, mins0, halo_f0, halo_m0),
        jnp.arange(T, dtype=jnp.int32))
    return lr


def halo_aggregate(mesh: Mesh, cc, w8=None, *, p1: float, p2: float,
                   ndir: int, mgm: int, use_fh: bool = False,
                   use_weights: bool = False):
    """Directional aggregation with explicit per-step halo exchange.

    cc: (N, H, W, L) replicated or sharded dense costs; returns the sum
    of the aggregated Lr volumes over the first `ndir` passes,
    identical to ops.aggregate (xla backend) bit for bit.

    Any H/W works: canonical rows pad to a multiple of the mesh size
    with +inf cost rows at the bottom (they receive messages but feed
    none back — rows only read the row above, and the ring wrap into
    device 0 is masked); label windows enter through +inf cells of cc,
    which the halo carries exactly.
    """
    n_dev = mesh.devices.size
    out = None
    for pids in _pass_groups(ndir, mgm, homogeneous=True):
        specs = [PASS_TABLE[p] for p in pids]
        B = len(specs)
        N, H, W, L = cc.shape
        rm = specs[0].row_major
        knight = specs[0].knight
        R0, C = (H, W) if rm else (W, H)
        R = -(-R0 // n_dev) * n_dev  # equal row tiles per device
        d2o = _dir2off(specs[0])[:mgm]
        offsets = sorted(set(d2o))
        T = C + 2 * R - 2

        cc_c = jnp.stack([to_canonical(cc, s, 1, 2) for s in specs])
        cc_c = cc_c.reshape(B * N, R0, C, L)
        if R != R0:
            cc_c = jnp.pad(cc_c, ((0, 0), (0, R - R0), (0, 0), (0, 0)),
                           constant_values=INF)
        lr_sk = skew(cc_c, INF, 1, 2)
        mins_sk = jnp.min(lr_sk, axis=-1)

        w_sk = None
        if use_weights:
            wmaps = []
            for s in specs:
                off2ch = {d2o[k]: s.wch[k] for k in range(mgm)}
                chs = [off2ch.get(o, s.wch[0])
                       for o in range(5 if knight else 4)]
                wm = jnp.stack([to_canonical(w8[..., c], s, 1, 2)
                                for c in chs], axis=1)
                wmaps.append(wm)
            w_c = jnp.stack(wmaps).reshape(B * N, -1, R0, C)
            if R != R0:
                w_c = jnp.pad(w_c, ((0, 0), (0, 0), (0, R - R0), (0, 0)),
                              constant_values=1.0)
            w_sk = skew(w_c, 1.0, 2, 3)

        fn = partial(_halo_scan, T=T, C=C, p1=p1, p2=p2, mgm=mgm,
                     dir2off=d2o, offsets=offsets, knight=knight,
                     use_fh=use_fh, use_weights=use_weights)
        in_specs = [P(None, AXIS, None, None), P(None, AXIS, None)]
        args = [lr_sk, mins_sk]
        if use_weights:
            in_specs.append(P(None, None, AXIS, None))
            args.append(w_sk)
        else:
            fn = partial(fn, w_sk=None)
        lr = shard_map(fn, mesh=mesh, in_specs=tuple(in_specs),
                       out_specs=P(None, AXIS, None, None),
                       check_rep=False)(*args)

        lr = unskew(lr, C, 1, 2).reshape(B, N, R, C, L)[:, :, :R0]
        part = from_canonical(lr[0], specs[0], 1, 2)
        for b in range(1, B):
            part = part + from_canonical(lr[b], specs[b], 1, 2)
        out = part if out is None else out + part
    return out
