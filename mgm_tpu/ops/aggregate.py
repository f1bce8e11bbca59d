"""MGM directional aggregation.

Design
------
The reference runs up to 8 directional scanline recursions, each with
1/2/4 causal neighbour messages, scheduled on a slope-2 anti-diagonal
wavefront (mgm_core.cc:408-613).  Instead of translating that pixel
loop, we exploit a structural fact of its pass table
(mgm_core.cc:463-471): after flipping/transposing each pass into its
canonical scan orientation, *every* pass has causal neighbours inside
{W, N, NW, NE} of scan space — axis passes in dir-order [W, N, NW, NE]
and diagonal passes in dir-order [NE, NW, N, W].  Hence a single
canonical wavefront kernel serves all 8 directions, and passes (and the
left/right solves of the LR check) are *batched* into one scan.

The wavefront t = ii + 2*jj is realised as a `lax.scan` over t on a
*skewed* volume: row jj of the skewed buffer holds the pixels of row jj
shifted right by 2*jj, so front t is the skewed column t and the causal
neighbours live at skewed columns t-1 (W, NE), t-2 (N), t-3 (NW) with a
one-row shift for N/NW/NE.  Skewing is a pure pad+reshape (zero gather
cost).  The label-axis inner update is fully vectorised: the SGM
potential needs only +-1 label shifts and the per-pixel min
(mgm_core.cc:66-144); the Felzenszwalb--Huttenlocher truncated-linear
potential's min-convolution (mgm_core.cc:152-163) is computed by
log2(L) min-plus doubling steps.

Dense semantics: +inf outside a pixel's label window reproduces the
Dvec out-of-range convention (dvec.cc:129) exactly, including the
1-pixel border that never aggregates (mgm_core.cc:538-541) and the
per-pixel cached minima.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

from ..backend import recursion_route
from .common import INF, fmin3, shift_fill


@dataclass(frozen=True)
class PassSpec:
    row_major: bool
    flip_x: bool        # inc_x == 0 in the reference table
    flip_y: bool        # inc_y == 0
    diag: bool          # 45-degree pass: canonical dir order is reversed
    wch: tuple          # weight channels for dir1..dir4 (mgm_core.cc:481-484)
    knight: bool = False  # 22.5-degree pass (main dir a knight move)


# Canonicalised reference pass table (mgm_core.cc:463-471), extended
# with the eight 22.5-degree passes the reference advertises via -O 16
# but crashes on (its table stops at 8, mgm_core.cc:473-474,489).
# Knight passes use canonical causal dirs (dir1..dir4) =
# [(-2,-1), (0,-1), (-1,-1), (-1,0)] of scan space; weight channels are
# the 8-neighbour channel with the same sign pattern (the weight image
# has no 22.5-degree planes).
PASS_TABLE = (
    PassSpec(True, False, False, False, (0, 3, 4, 5)),   # W->E
    PassSpec(True, True, True, False, (1, 2, 6, 7)),     # E->W
    PassSpec(False, False, True, False, (2, 0, 7, 4)),   # S->N scan of columns
    PassSpec(False, True, False, False, (3, 1, 5, 6)),   # N->S scan of columns
    PassSpec(True, True, False, True, (4, 5, 3, 1)),     # diag NW
    PassSpec(False, True, True, True, (5, 6, 1, 2)),     # diag NE
    PassSpec(True, False, True, True, (6, 7, 2, 0)),     # diag SE
    PassSpec(False, False, False, True, (7, 4, 0, 3)),   # diag SW
    PassSpec(True, False, False, False, (4, 3, 4, 0), True),   # (-2,-1)
    PassSpec(True, True, True, False, (6, 2, 6, 1), True),     # (2,1)
    PassSpec(True, True, False, False, (5, 3, 5, 1), True),    # (2,-1)
    PassSpec(True, False, True, False, (7, 2, 7, 0), True),    # (-2,1)
    PassSpec(False, False, False, False, (4, 0, 4, 3), True),  # (-1,-2)
    PassSpec(False, True, True, False, (6, 1, 6, 2), True),    # (1,2)
    PassSpec(False, True, False, False, (5, 1, 5, 3), True),   # (1,-2)
    PassSpec(False, False, True, False, (7, 0, 7, 2), True),   # (-1,2)
)

# stack order of the canonical causal offsets
#   W   = (ii-1, jj)   -> skewed (jj,   t-1)
#   N   = (ii,   jj-1) -> skewed (jj-1, t-2)
#   NW  = (ii-1, jj-1) -> skewed (jj-1, t-3)
#   NE  = (ii+1, jj-1) -> skewed (jj-1, t-1)
#   WWN = (ii-2, jj-1) -> skewed (jj-1, t-4)   (knight passes)
AXIS_DIR2OFF = (0, 1, 2, 3)     # dir k -> offset index, axis passes
DIAG_DIR2OFF = (3, 2, 1, 0)     # dir k -> offset index, diagonal passes
KNIGHT_DIR2OFF = (4, 1, 2, 0)   # dir k -> offset index, knight passes


def to_canonical(a, spec: PassSpec, h_axis: int, w_axis: int):
    if spec.flip_x:
        a = jnp.flip(a, axis=w_axis)
    if spec.flip_y:
        a = jnp.flip(a, axis=h_axis)
    if not spec.row_major:
        a = jnp.swapaxes(a, h_axis, w_axis)
    return a


def from_canonical(a, spec: PassSpec, h_axis: int, w_axis: int):
    if not spec.row_major:
        a = jnp.swapaxes(a, h_axis, w_axis)
    if spec.flip_y:
        a = jnp.flip(a, axis=h_axis)
    if spec.flip_x:
        a = jnp.flip(a, axis=w_axis)
    return a


def skew(a, fill, r_axis: int, c_axis: int, t_round: int = 1):
    """Skew rows: out[..., r, 2r+c, ...] = a[..., r, c, ...].

    Output column count T = C + 2R - 2 (the number of non-empty
    wavefronts), rounded up to a multiple of `t_round` with fill-valued
    columns (the wavefront kernel consumes fixed-depth front blocks).
    Implemented as pad+reshape: zero gathers.
    Requires c_axis == r_axis + 1.
    """
    assert c_axis == r_axis + 1
    shp = a.shape
    R, C = shp[r_axis], shp[c_axis]
    T = C + 2 * R - 2
    T = -(-T // t_round) * t_round
    pad = [(0, 0)] * a.ndim
    pad[c_axis] = (0, T + 2 - C)
    a = jnp.pad(a, pad, constant_values=fill)
    flat = a.reshape(shp[:r_axis] + (R * (T + 2),) + shp[c_axis + 1:])
    sl = [slice(None)] * flat.ndim
    sl[r_axis] = slice(0, R * T)
    flat = flat[tuple(sl)]
    return flat.reshape(shp[:r_axis] + (R, T) + shp[c_axis + 1:])


def unskew(a, C: int, r_axis: int, c_axis: int):
    """Inverse of `skew`: out[..., r, c, ...] = a[..., r, 2r+c, ...]."""
    assert c_axis == r_axis + 1
    shp = a.shape
    R, T = shp[r_axis], shp[c_axis]
    flat = a.reshape(shp[:r_axis] + (R * T,) + shp[c_axis + 1:])
    pad = [(0, 0)] * flat.ndim
    pad[r_axis] = (0, 2 * R)
    flat = jnp.pad(flat, pad)
    out = flat.reshape(shp[:r_axis] + (R, T + 2) + shp[c_axis + 1:])
    sl = [slice(None)] * out.ndim
    sl[c_axis] = slice(0, C)
    return out[tuple(sl)]


def _sgm_msg(Lk, mk, p1w, p2w):
    """min(Lk[o], min(Lk[o-1],Lk[o+1])+P1w, minLk+P2w) - minLk
    (mgm_core.cc:74-76,113-116)."""
    vlp1 = jnp.minimum(shift_fill(Lk, 1, -1, INF),
                       shift_fill(Lk, -1, -1, INF)) + p1w
    return fmin3(Lk, vlp1, mk + p2w) - mk


def _fh_msg(Lk, mk, p1w, p2w, win_lo, win_hi):
    """Truncated-linear (FH) message via min-plus doubling
    (mgm_core.cc:152-163 computed in log2(L) vector steps).

    win_lo/win_hi restrict the min-conv input to the target pixel's
    label window (the update_costW_trunclinear path has no boundary
    fix, mgm_core.cc:229-281); pass None for the full axis (exactly
    equivalent to update_cost2_trunclinear's boundary-fixed version).
    """
    L = Lk.shape[-1]
    M = Lk
    if win_lo is not None:
        l_idx = jnp.arange(L, dtype=jnp.int32)
        inw = (l_idx >= win_lo[..., None]) & (l_idx <= win_hi[..., None])
        M = jnp.where(inw, Lk, INF)
    s = 1
    while s < L:
        M = jnp.minimum(M, shift_fill(M, s, -1, INF) + p1w * s)
        s *= 2
    s = 1
    while s < L:
        M = jnp.minimum(M, shift_fill(M, -s, -1, INF) + p1w * s)
        s *= 2
    M = jnp.minimum(M, mk + p2w)
    return M - mk


def _dir2off(spec: PassSpec):
    if spec.knight:
        return KNIGHT_DIR2OFF
    return DIAG_DIR2OFF if spec.diag else AXIS_DIR2OFF


def _pass_groups(ndir: int, mgm: int, homogeneous: bool = False):
    """Group passes runnable in one batched scan: same canonical shape
    (row_major) and, when mgm < 4 or `homogeneous`, same class so the
    dir->offset order is static.  Knight passes always group alone
    (their offset set and border differ)."""
    groups = {}
    for p in range(ndir):
        spec = PASS_TABLE[p]
        if spec.knight:
            key = (spec.row_major, "knight")
        else:
            key = (spec.row_major,
                   spec.diag if (mgm < 4 or homogeneous) else None)
        groups.setdefault(key, []).append(p)
    return list(groups.values())


def _pad_geometry(spec: PassSpec, hpad: int, R: int, C: int):
    """Where `hpad` fake rows appended at the image bottom land in this
    pass's canonical space, as shifted border-mask bounds.

    Pads at the canonical BOTTOM are never read (all canonical deps
    point to the same row or the row above), so only flip_y passes need
    a shift: row-major passes get them at the canonical top (row0),
    col-major passes at the canonical left (col0) — flip_y=False
    col-major passes get them at the canonical right (C1 shrinks).
    Returns (row0, col0, C1): the first real canonical row, first real
    canonical column, and real column count.
    """
    if not hpad:
        return 0, 0, C
    if spec.row_major:
        return (hpad if spec.flip_y else 0), 0, C
    return 0, (hpad if spec.flip_y else 0), C - hpad


def _run_group(pids, cc, w8, lo, hi, *, p1, p2, mgm, use_fh, use_weights,
               fh_restrict, div_each, hpad=0):
    """One batched wavefront scan over the passes `pids`.

    cc: (N, H, W, L); returns sum over the group's passes of the
    per-pass aggregated volumes Lr, shape (N, H, W, L).
    hpad: trailing image rows that are mesh-padding fakes; the border
    masks shift so real border pixels keep cc and never read pad cells
    (mgm_core.cc:538-541 semantics on the real extent).
    """
    specs = [PASS_TABLE[p] for p in pids]
    B = len(specs)
    N, H, W, L = cc.shape
    rm = specs[0].row_major
    R, C = (H, W) if rm else (W, H)
    T = C + 2 * R - 2
    geo = [_pad_geometry(s, hpad, R, C) for s in specs]
    if hpad:
        row0v = jnp.repeat(jnp.asarray([g[0] for g in geo], jnp.int32), N)
        col0v = jnp.repeat(jnp.asarray([g[1] for g in geo], jnp.int32), N)
        c1v = jnp.repeat(jnp.asarray([g[2] for g in geo], jnp.int32), N)

    knight = specs[0].knight
    mixed = len({s.diag for s in specs}) > 1
    if mixed:
        # mgm == 4 here: every offset is active; per-pass dir order is
        # realised by reversing the message stack for diagonal passes.
        offsets = list(range(4))
        dir2off = None
        diag_flags = jnp.asarray([s.diag for s in specs], bool)
        diag_mask = jnp.repeat(diag_flags, N).reshape(B * N, 1, 1)
    else:
        dir2off = _dir2off(specs[0])[:mgm]
        offsets = sorted(set(dir2off))
        diag_mask = None

    # ---- canonicalise + stack passes --------------------------------
    cc_c = jnp.stack([to_canonical(cc, s, 1, 2) for s in specs])
    cc_c = cc_c.reshape(B * N, R, C, L)
    lr_sk = skew(cc_c, INF, 1, 2)                       # (BN, R, T, L)
    mins_sk = jnp.min(lr_sk, axis=-1)                   # (BN, R, T)

    w_sk = None
    if use_weights:
        wmaps = []
        for s in specs:
            if mixed:
                chs = s.wch if not s.diag else s.wch[::-1]  # offset order
            else:
                # channel at index `off` for each active offset; inactive
                # slots reuse channel 0 (never read)
                off2ch = {dir2off[k]: s.wch[k] for k in range(mgm)}
                chs = [off2ch.get(o, s.wch[0]) for o in range(5 if knight
                                                              else 4)]
            wm = jnp.stack([to_canonical(w8[..., c], s, 1, 2) for c in chs],
                           axis=1)                      # (N, nch, R, C)
            wmaps.append(wm)
        w_c = jnp.stack(wmaps).reshape(B * N, -1, R, C)
        w_sk = skew(w_c, 1.0, 2, 3)                     # (BN, nch, R, T)

    lo_sk = hi_sk = None
    if fh_restrict:
        lo_c = jnp.stack([to_canonical(lo, s, 1, 2) for s in specs])
        hi_c = jnp.stack([to_canonical(hi, s, 1, 2) for s in specs])
        lo_sk = skew(lo_c.reshape(B * N, R, C), 0, 1, 2)
        hi_sk = skew(hi_c.reshape(B * N, R, C), -1, 1, 2)

    jj = jnp.arange(R, dtype=jnp.int32)
    p1f, p2f = jnp.float32(p1), jnp.float32(p2)

    def rsh(a, fill=INF):
        # row jj reads row jj-1
        return shift_fill(a, 1, 1, fill)

    def body(carry, t):
        lr, mins = carry
        front = lambda dt: jnp.maximum(t - dt, 0)
        cc_t = jax.lax.dynamic_slice_in_dim(lr, front(0), 1, axis=2)[:, :, 0]
        depth = (1, 2, 3, 4) if knight else (1, 2, 3)
        f = {d: jax.lax.dynamic_slice_in_dim(lr, front(d), 1, axis=2)[:, :, 0]
             for d in depth}
        m = {d: jax.lax.dynamic_slice_in_dim(mins, front(d), 1, axis=2)[:, :, 0]
             for d in depth}
        # offset index -> (front values, mins): W, N, NW, NE[, WWN]
        neigh = {
            0: (f[1], m[1]),
            1: (rsh(f[2]), rsh(m[2])),
            2: (rsh(f[3]), rsh(m[3])),
            3: (rsh(f[1]), rsh(m[1])),
        }
        if knight:
            neigh[4] = (rsh(f[4]), rsh(m[4]))
        if use_weights:
            w_t = jax.lax.dynamic_slice_in_dim(w_sk, front(0), 1, axis=3)[..., 0]
        if fh_restrict:
            lo_t = jax.lax.dynamic_slice_in_dim(lo_sk, front(0), 1, axis=2)[:, :, 0]
            hi_t = jax.lax.dynamic_slice_in_dim(hi_sk, front(0), 1, axis=2)[:, :, 0]

        def message(off):
            Lk, mk = neigh[off]
            if use_weights:
                delta = w_t[:, off][..., None]          # (BN, R, 1)
                p1w, p2w = p1f * delta, p2f * delta
            else:
                p1w, p2w = p1f, p2f
            mk_ = mk[..., None]
            if use_fh:
                return _fh_msg(Lk, mk_, p1w, p2w,
                               lo_t if fh_restrict else None,
                               hi_t if fh_restrict else None)
            return _sgm_msg(Lk, mk_, p1w, p2w)

        msgs = {off: message(off) for off in offsets}
        if mixed:
            stack = [msgs[0], msgs[1], msgs[2], msgs[3]]
            msgs_dir = [jnp.where(diag_mask, stack[3 - k], stack[k])
                        for k in range(mgm)]
        else:
            msgs_dir = [msgs[o] for o in dir2off]

        if div_each:
            e = msgs_dir[0] * 0.5 + msgs_dir[1] * 0.5
        else:
            e = msgs_dir[0]
            for k in range(1, mgm):
                e = e + msgs_dir[k]
            if mgm > 1:
                e = e / jnp.float32(mgm)

        ii = t - 2 * jj
        if hpad:
            jb, ib = jj[None, :], ii[None, :]
            if knight:
                interior = ((jb >= row0v[:, None] + 1)
                            & (ib >= col0v[:, None] + 2)
                            & (ib <= col0v[:, None] + c1v[:, None] - 1))
            else:
                interior = ((jb >= row0v[:, None] + 1)
                            & (ib >= col0v[:, None] + 1)
                            & (ib <= col0v[:, None] + c1v[:, None] - 2))
            new = jnp.where(interior[:, :, None], cc_t + e, cc_t)
        else:
            if knight:
                interior = (jj >= 1) & (ii >= 2) & (ii <= C - 1)
            else:
                interior = (jj >= 1) & (ii >= 1) & (ii <= C - 2)
            new = jnp.where(interior[None, :, None], cc_t + e, cc_t)
        lr = jax.lax.dynamic_update_slice_in_dim(lr, new[:, :, None], t, axis=2)
        mins = jax.lax.dynamic_update_slice_in_dim(
            mins, jnp.min(new, axis=-1)[:, :, None], t, axis=2)
        return (lr, mins), None

    (lr_sk, _), _ = jax.lax.scan(body, (lr_sk, mins_sk),
                                 jnp.arange(T, dtype=jnp.int32))

    lr = unskew(lr_sk, C, 1, 2).reshape(B, N, R, C, L)
    out = from_canonical(lr[0], specs[0], 1, 2)
    for b in range(1, B):
        out = out + from_canonical(lr[b], specs[b], 1, 2)
    return out


@partial(jax.jit, static_argnames=("p1", "p2", "ndir", "mgm", "use_fh",
                                   "use_weights", "fh_restrict", "backend",
                                   "hpad"))
def aggregate(cc, w8=None, lo=None, hi=None, *, p1: float, p2: float,
              ndir: int, mgm: int, use_fh: bool = False,
              use_weights: bool = False, fh_restrict: bool = False,
              backend: str = "auto", hpad: int = 0):
    """Sum over the first `ndir` directional passes of the aggregated
    volumes Lr (before the S-window clip / overcount fix, which are
    applied by the solver).

    cc: (N, H, W, L) dense costs with +inf outside label windows.
    w8: (N, H, W, 8) edge weights (channel order W,E,S,N,NW,NE,SE,SW,
        mgm_weights.h:69) when use_weights.
    lo/hi: (N, H, W) int32 label windows, needed when fh_restrict
        (truncated-linear potential with per-pixel windows).
    backend: "auto", "xla" (lax.scan) or "cuda" (ops/wavefront.cu);
        backend.recursion_route resolves it.
    hpad: trailing fake image rows appended so a device mesh divides H
        (xla route only); real border pixels behave exactly as at the
        true image edge and never read pad cells.
    """
    backend = recursion_route(backend, ndir=ndir, use_fh=use_fh, hpad=hpad)
    # update_cost2 divides each of the 2 messages by 2 before summing
    # (mgm_core.cc:83-84); all other paths sum then divide.
    div_each = (mgm == 2) and (not use_weights) and (not use_fh)
    if fh_restrict:
        # the MGM==2 unweighted FH path uses the boundary-fixed full-axis
        # min-conv instead of the window-restricted one (mgm_core.cc:208)
        fh_restrict = not ((mgm == 2) and (not use_weights))
    groups = _pass_groups(ndir, mgm)
    if backend == "cuda":
        from . import wavefront_cuda

        return wavefront_cuda.aggregate(groups, cc, w8, p1=p1, p2=p2,
                                        mgm=mgm, use_weights=use_weights,
                                        div_each=div_each)
    out = None
    for gp in groups:
        part = _run_group(gp, cc, w8, lo, hi, p1=p1, p2=p2, mgm=mgm,
                          use_fh=use_fh, use_weights=use_weights,
                          fh_restrict=fh_restrict, div_each=div_each,
                          hpad=hpad)
        out = part if out is None else out + part
    return out
