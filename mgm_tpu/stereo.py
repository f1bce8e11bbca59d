"""End-to-end stereo pipeline (the `mgm` binary's capability).

Mirrors main() at mgm.cc:266-450 of gfacciol/mgm:
  scrub inputs -> per-pixel disparity windows -> P1/P2 *= nch ->
  adaptive weights -> prefilter -> cost volume -> TSGM_ITER x
  (solve -> refine -> tighten ranges) -> median -> LR check both ways ->
  backflow.

Two departures from the serial reference:
  - when the LR check is enabled, the left->right and right->left
    solves are *batched* through one aggregation (problem axis N=2),
    halving the sequential wavefront work;
  - the pipeline is staged into a few separately-jitted programs
    (weights + cost volumes / solve / refine / post) rather than one
    monolith, which keeps each program's compile time small.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

import os
import time

from .config import MGMConfig
from .ops import post
from .ops.census import census_transform
from .ops.cost import build_cost_volume
from .ops.prefilter import apply_prefilter
from .ops.refine import subpixel_refine
from .ops.weights import compute_weights
from .solver import mgm_solve


def _preprocess(img: jnp.ndarray, cfg: MGMConfig):
    if cfg.prefilter == "census":
        return census_transform(img, cfg.census_ncc_win // 2)
    return apply_prefilter(img, cfg.prefilter)


def _u8_lossless(a: np.ndarray) -> np.ndarray:
    """Upload 8-bit-valued images as uint8 (4x fewer bytes than
    float32); the jitted stages cast back to float32 on device.  Only
    when exactly lossless."""
    if a.dtype == np.float32 and a.size:
        m0, m1 = a.min(), a.max()
        if 0.0 <= m0 and m1 <= 255.0:
            r = a.astype(np.uint8)
            if np.array_equal(r.astype(np.float32), a):
                return r
    return a


@jax.jit
def _decode16(a):
    """Device-side decode of census-exact uint16 codes: a plain cast
    (the codes ARE the values the pipeline consumes).  Kept as its own
    tiny program so every downstream stage traces on float32 — the
    same jaxprs (and compiled executables) as the raw-float32 path."""
    return a.astype(jnp.float32)


def _upload_form(a: np.ndarray, cfg) -> np.ndarray:
    """Smallest lossless wire form of an image for this config:
    uint8 when the values are 8-bit, else census-exact uint16 codes
    (ops/census_codec.py) for census-cost configs, else the array
    itself.  Both compact forms are cast back to float32 by the jitted
    prep stages; outputs are bit-identical either way.
    MGM_TPU_CODEC16=0 disables the uint16 codes."""
    r = _u8_lossless(a)
    if (r.dtype == np.float32
            and os.environ.get("MGM_TPU_CODEC16", "1") != "0"):
        from .ops import census_codec
        if census_codec.eligible(cfg):
            enc = census_codec.encode(r, cfg.census_ncc_win)
            if enc is not None:
                return enc
    return r


def _prep_core(u, v, cfg: MGMConfig, n_sides: int):
    """Scrub + adaptive weights + prefilter (traced body shared by the
    single-device and mesh prep stages)."""
    u = jnp.nan_to_num(u.astype(jnp.float32), nan=0.0, posinf=0.0,
                       neginf=0.0)
    v = jnp.nan_to_num(v.astype(jnp.float32), nan=0.0, posinf=0.0,
                       neginf=0.0)
    w_u = compute_weights(u, cfg.a_p2, cfg.a_thresh)
    w_v = compute_weights(v, cfg.a_p2, cfg.a_thresh)
    w8 = jnp.stack([w_u, w_v][:n_sides])
    return _preprocess(u, cfg), _preprocess(v, cfg), w8, u, v


@partial(jax.jit, static_argnames=("cfg", "n_sides", "hpad", "mesh"))
def _prep_mesh(u, v, *, cfg: MGMConfig, n_sides: int, hpad: int, mesh):
    """Mesh-path prep: scrub/weights/prefilter run REPLICATED at the
    true image height (census, gblur and the adaptive weights read row
    neighbourhoods, so they must see the real bottom boundary), then
    `hpad` fake rows are appended so every downstream stage shards
    evenly over the mesh.  Float pads are NaN: their costs collapse to
    0 via the all-invalid rule and the shifted border masks
    (aggregate._pad_geometry) guarantee no real pixel ever reads a pad
    cell, so real-row outputs are bitwise those of the unpadded run.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    up, vp, w8, u_s, v_s = _prep_core(u, v, cfg, n_sides)

    def padrows(a, axis=0):
        if not hpad:
            return a
        fill = jnp.nan if jnp.issubdtype(a.dtype, jnp.floating) else 0
        pad = [(0, 0)] * a.ndim
        pad[axis] = (0, hpad)
        return jnp.pad(a, pad, constant_values=fill)

    def con(a, *spec):
        return jax.lax.with_sharding_constraint(
            a, NamedSharding(mesh, P(*spec)))

    return (con(padrows(up), "y"), con(padrows(vp), "y"),
            con(padrows(w8, axis=1), None, "y"),
            con(padrows(u_s), "y"), con(padrows(v_s), "y"))


def _volumes(up, vp, lo_idx, hi_idx, cfg: MGMConfig, L: int, gmins: tuple):
    """The (N, H, W, L) cost volumes of both sides from preprocessed
    images (traced body)."""
    kw = dict(distance=cfg.distance, L=L, trunc_dist=cfg.trunc_dist,
              ncc_win=cfg.census_ncc_win)
    ccs = [build_cost_volume(up, vp, lo_idx[0], hi_idx[0], gmins[0], **kw)]
    if len(gmins) == 2:
        ccs.append(build_cost_volume(vp, up, lo_idx[1], hi_idx[1], gmins[1],
                                     **kw))
    return jnp.stack(ccs)


@partial(jax.jit, static_argnames=("cfg", "L", "gmins", "n_sides"))
def _build_volumes(u, v, lo_idx, hi_idx, *, cfg: MGMConfig, L: int,
                   gmins: tuple, n_sides: int):
    """Adaptive weights + preprocess + the (N, H, W, L) cost volumes,
    one jitted dispatch."""
    up, vp, w8, u, v = _prep_core(u, v, cfg, n_sides)
    return _volumes(up, vp, lo_idx, hi_idx, cfg, L, gmins), w8, u, v


@partial(jax.jit, static_argnames=("cfg", "L", "gmins"))
def _volumes_from_prep(up, vp, lo_idx, hi_idx, *, cfg: MGMConfig, L: int,
                       gmins: tuple):
    """The cost volumes from already-preprocessed images (mesh path;
    the volume code shards row-wise under the mesh)."""
    return _volumes(up, vp, lo_idx, hi_idx, cfg, L, gmins)


@partial(jax.jit, static_argnames=("method",))
def _refine(S, disp, cost, s_lo, s_hi, gmin, *, method):
    return subpixel_refine(S, disp, cost, s_lo, s_hi, gmin, method=method)


@jax.jit
def _any_weighted(w8):
    return jnp.any(w8 != 1.0)


@partial(jax.jit, static_argnames=("H", "W", "los", "his", "flos", "fhis",
                                   "gmins"))
def _const_arrays(*, H, W, los, his, flos, fhis, gmins):
    """Constant-window arrays, built on device in ONE dispatch (rather
    than one eager dispatch per array)."""
    z_i = jnp.zeros((1, H, W), jnp.int32)
    z_f = jnp.zeros((1, H, W), jnp.float32)
    lo = jnp.concatenate([z_i + v for v in los])
    hi = jnp.concatenate([z_i + v for v in his])
    flo = jnp.concatenate([z_f + v for v in flos])
    fhi = jnp.concatenate([z_f + v for v in fhis])
    return lo, hi, flo, fhi, jnp.asarray(gmins, jnp.int32)


@partial(jax.jit, static_argnames=("n_sides", "gmin_l", "gmin_r",
                                   "dmin", "dmax"))
def _pp_expand(flo, fhi, *, n_sides, gmin_l, gmin_r, dmin, dmax):
    """Expand the left side's per-pixel float windows (the only
    per-pixel wire payload) into the pipeline's stacked window arrays
    on device: integer S-window indices by truncation toward zero
    (Dvec init, dvec.cc:49-60) plus the constant right-side planes
    over the negated global range (mgm.cc:368)."""
    lo = [flo.astype(jnp.int32) - gmin_l]
    hi = [fhi.astype(jnp.int32) - gmin_l]
    flos, fhis = [flo], [fhi]
    if n_sides == 2:
        lo.append(jnp.full(flo.shape, -dmax - gmin_r, jnp.int32))
        hi.append(jnp.full(flo.shape, -dmin - gmin_r, jnp.int32))
        flos.append(jnp.full(flo.shape, float(-dmax), jnp.float32))
        fhis.append(jnp.full(flo.shape, float(-dmin), jnp.float32))
    return (jnp.stack(lo), jnp.stack(hi), jnp.stack(flos),
            jnp.stack(fhis))


@jax.jit
def _tighten(disp, flo, fhi, gmin, L):
    """update_dmin_dmax between iterations -> new S windows."""
    flo, fhi, _, _ = post.update_dmin_dmax(disp, flo, fhi)
    s_lo = jnp.clip(flo.astype(jnp.int32) - gmin[:, None, None], 0, L - 1)
    s_hi = jnp.clip(fhi.astype(jnp.int32) - gmin[:, None, None], 0, L - 1)
    return flo, fhi, s_lo, s_hi


_I16_NAN = -32768  # NaN sentinel in packed integer disparities
_I8_NAN = -128     # NaN sentinel in packed int8 disparities
_COST_SCALE = 4    # fixed integer-cost wire scale (mgm in {1,2,4} | 4)


def _pack_spec(cfg, nch: int, img_dtype, use_weights: bool):
    """Static proof obligations for the integer output codec.

    Returns (disp_dtype, cost_pack): the narrowest exact wire dtype
    for disparities ("int8"/"int16"/None) and whether WTA costs are
    provably integers of magnitude < 2^15/_COST_SCALE — in which case
    they ship as int16 = cost * _COST_SCALE, bit-exactly.

    The proof: with integer-valued images (uint8, or the census-exact
    uint16 rank codes), integer P1·nch/P2·nch, unit weights and an
    integer (or infinite) truncation, every CC entry is an integer,
    and at mgm=1 the recursion (mgm_core.cc:66-144,152-281 semantics)
    is min-plus over integers divided by k=1 — closed over Z; S and
    the overcount-fixed WTA cost stay integers bounded by
    ndir·(ccmax + P2·nch).  At mgm>=2 the ÷k COMPOUNDS along the scan
    (Lr feeds the next front's messages), so denominators grow as
    k^depth and the values are arbitrary float32: excluded, as are
    BT distances (half-pixel interpolation), NCC and non-unit
    weights."""
    if (cfg.refinement != "none"
            or os.environ.get("MGM_TPU_PACKOUT", "1") == "0"):
        return None, False
    m = max(abs(cfg.dmin), abs(cfg.dmax)) + 4 * cfg.iterations
    disp_dtype = ("int8" if m <= 126
                  else "int16" if m < 32000 else None)
    cost_pack = False
    if (np.dtype(img_dtype) in (np.uint8, np.uint16)
            and cfg.mgm == 1 and not use_weights):
        vmax = 255 if np.dtype(img_dtype) == np.uint8 else 65535
        if cfg.distance == "ad":
            ccmax = vmax * nch
        elif cfg.distance == "sd":
            ccmax = vmax * vmax * nch
        elif cfg.distance == "census" and nch == 1:
            ccmax = cfg.census_ncc_win ** 2
        else:
            ccmax = None
        p1s, p2s = cfg.p1 * nch, cfg.p2 * nch
        tmax = cfg.trunc_dist * nch
        if ccmax is not None and np.isfinite(tmax):
            ccmax = min(ccmax, tmax) if float(tmax).is_integer() else None
        if (ccmax is not None
                and float(p1s).is_integer() and float(p2s).is_integer()
                and _COST_SCALE * cfg.ndir * (ccmax + p2s) < 32000):
            cost_pack = True
    return disp_dtype, cost_pack


def _pk_disp(d, disp_dtype: str):
    sent = _I8_NAN if disp_dtype == "int8" else _I16_NAN
    return jnp.where(jnp.isnan(d), sent, d).astype(disp_dtype)


def _pk_cost(c):
    return jnp.where(jnp.isfinite(c), c * _COST_SCALE,
                     _I16_NAN).astype(jnp.int16)


@partial(jax.jit, static_argnames=("median_radius", "test_lr", "n_sides",
                                   "want_backflow", "disp_dtype",
                                   "cost_pack"))
def _postprocess(disp, cost, u, v, lr_tau, *, median_radius, test_lr,
                 n_sides, want_backflow, disp_dtype=None,
                 cost_pack=False):
    disp = post.median_filter(disp, radius=median_radius)
    disp_nolr = disp
    if n_sides == 2 and test_lr:
        d_l = post.leftright_test(disp[0], disp[1], lr_tau)
        d_r = post.leftright_test(disp[1], disp[0], lr_tau)
        disp = jnp.stack([d_l, d_r])
    back = post.backflow(disp[0], v, u) if want_backflow else None
    if disp_dtype:
        # without subpixel refinement disparities are integers (+ NaN
        # invalidations): ship them to the host as narrow ints with a
        # NaN sentinel, 2-4x fewer bytes to fetch
        disp, disp_nolr = (_pk_disp(disp, disp_dtype),
                           _pk_disp(disp_nolr, disp_dtype))
    if cost_pack:
        cost = _pk_cost(cost)
    return disp, disp_nolr, cost, back


def _unpack_arr(k: str, a: np.ndarray) -> np.ndarray:
    """Host-side inverse of the integer output codec (key-driven:
    'disp*' are sentinel-NaN integer disparities, 'cost*' are
    _COST_SCALE-scaled integer costs)."""
    if a.dtype not in (np.int8, np.int16):
        return a
    sent = _I8_NAN if a.dtype == np.int8 else _I16_NAN
    f = a.astype(np.float32)
    f[a == sent] = np.nan
    if k.startswith("cost"):
        f /= _COST_SCALE
    return f


def _unpack_out(out: dict) -> dict:
    return {k: _unpack_arr(k, a) for k, a in out.items()}


@jax.jit
def _pack_cat(*arrs):
    flat = []
    for a in arrs:
        if a.dtype != jnp.int8:
            a = jax.lax.bitcast_convert_type(a, jnp.int8)
        flat.append(a.reshape(-1))
    return jnp.concatenate(flat)


_FETCH_POOL = None


@partial(jax.jit, static_argnames=("ln",))
def _dslice(buf, start, *, ln):
    """One chunk of a flat buffer.  `start` is a TRACED scalar, so all
    chunks of a given (buffer size, chunk length) share ONE compiled
    program instead of one per offset."""
    return jax.lax.dynamic_slice(buf, (start,), (ln,))


def _fetch_buf(buf) -> np.ndarray:
    """Fetch a flat device buffer in parallel chunk streams.

    One large transfer is split into ~MGM_TPU_FETCH_STREAMS (default
    12) concurrently fetched slices, for links whose per-stream rate
    is a fraction of their aggregate.  Chunks are power-of-two sized
    and >= 128 KiB so small outputs still take a single transfer.
    Whether this pays on a PCIe-attached GPU is not measured yet.
    Bit-exact: the slices are reassembled verbatim."""
    n = int(buf.size)
    try:
        streams = int(os.environ.get("MGM_TPU_FETCH_STREAMS", "12"))
    except ValueError:
        streams = 12
    itemsize = np.dtype(buf.dtype).itemsize
    nbytes = n * itemsize
    if streams <= 1 or nbytes <= 2 * 128 * 1024:
        return np.asarray(buf)
    cb = max(nbytes // streams, 128 * 1024)
    cb = 1 << (cb - 1).bit_length()  # pow2 chunk bytes
    ce = cb // itemsize
    k, rem = divmod(n, ce)
    global _FETCH_POOL
    if _FETCH_POOL is None:
        from concurrent.futures import ThreadPoolExecutor
        _FETCH_POOL = ThreadPoolExecutor(max_workers=16)
    try:
        parts = [_dslice(buf, np.int32(i * ce), ln=ce) for i in range(k)]
        if rem:  # tail rides the same program, re-anchored; host-trimmed
            parts.append(_dslice(buf, np.int32(n - ce), ln=ce))
        out = list(_FETCH_POOL.map(np.asarray, parts))
    except Exception:  # the slice program failed: single fetch
        return np.asarray(buf)
    if rem:
        out[-1] = out[-1][ce - rem:]
    return np.concatenate(out)


def _fetch_packed(out: dict) -> dict:
    """Fetch EVERY requested output in one device->host transfer:
    all arrays bitcast to their bytes and flatten into a single int8
    buffer, so the per-transfer latency is paid once.  Bit-exact —
    NaNs and the integer disparity sentinels ride through the bitcast
    unchanged."""
    keys = sorted(out)
    if any(out[k].dtype not in (jnp.float32, jnp.int16, jnp.int8)
           for k in keys):
        return {k: np.asarray(a) for k, a in jax.device_get(out).items()}
    buf = _fetch_buf(_pack_cat(*[out[k] for k in keys]))
    res, off = {}, 0
    for k in keys:
        a = out[k]
        dt = np.dtype(a.dtype)
        nb = int(np.prod(a.shape)) * dt.itemsize
        res[k] = np.frombuffer(buf[off:off + nb].tobytes(),
                               dt).reshape(a.shape).copy()
        off += nb
    return res


def compute_disparity_batch(us, vs, cfg: MGMConfig,
                            outputs: tuple = ("disp", "cost"),
                            device_out: bool = False) -> dict:
    """Solve K independent rectified pairs sharing one config and
    disparity range: us, vs are (K, H, W, C) stacks, host or device
    arrays (e.g. crops sliced on device from a resident scene,
    runner.tiled_disparity).  Each pair is solved by
    compute_disparity; device_out=True returns device arrays, so the
    caller can slice them before fetching.

    Returns {'disp': (K, H, W), 'cost': (K, H, W)} (+ _right variants
    when requested and cfg.test_lr)."""
    outs = [compute_disparity(np.asarray(us[k]), np.asarray(vs[k]), cfg,
                              outputs=outputs)
            for k in range(us.shape[0])]
    res = {key: np.stack([o[key] for o in outs]) for key in outs[0]}
    return ({key: jnp.asarray(a) for key, a in res.items()}
            if device_out else res)


def _mark(tag, prof, x=None):
    """MGM_TPU_PROFILE=1: sync + print per-stage wall times."""
    if prof:
        if x is not None:
            jax.block_until_ready(x)
        now = time.perf_counter()
        print(f"[profile] {tag}: {(now - prof[0]) * 1e3:.1f} ms", flush=True)
        prof[0] = now


def compute_disparity(u: np.ndarray, v: np.ndarray, cfg: MGMConfig,
                      dmin_img: np.ndarray | None = None,
                      dmax_img: np.ndarray | None = None,
                      outputs: tuple | None = None,
                      mesh=None, backend: str = "auto") -> dict:
    """Host entry point.  u, v: (H, W, C) float arrays (uint8 also
    accepted and uploaded as-is; the device stages cast to float32).

    Returns dict with 'disp', 'cost', 'disp_nolr', 'backflow' (left
    side) and 'disp_right', 'cost_right' when the LR check ran.
    `outputs` restricts which keys are fetched to the host.

    `backend`: the recursion's route ("auto", "xla" or "cuda";
    backend.recursion_route): "auto" takes the CUDA kernel on a GPU
    where it applies and the XLA scan otherwise.

    `mesh`: a 1-D jax.sharding.Mesh (axis "y") shards the WHOLE
    pipeline — weights, cost volumes, the directional recursions,
    refinement and post-processing — over the image rows; the XLA SPMD
    partitioner turns the wavefront scans' one-row shifts into per-step
    boundary-row collective-permutes (SURVEY.md 2.9).  Any H works:
    when the mesh size does not divide H, fake bottom rows are appended
    after the (boundary-sensitive) prefilter/weight stages and masked
    out of the recursion, so real-row outputs equal the unsharded run.
    """
    prof = [time.perf_counter()] if os.environ.get("MGM_TPU_PROFILE") else None
    u = np.asarray(u)
    v = np.asarray(v)
    if u.dtype != np.uint8:
        u = np.asarray(u, np.float32)
    if v.dtype != np.uint8:
        v = np.asarray(v, np.float32)
    H, W, C = u.shape
    hpad = (-H) % int(mesh.devices.size) if mesh is not None else 0
    Hs = H + hpad  # row extent of every sharded array

    # per-pixel disparity windows (mgm.cc:338-353)
    if dmin_img is not None:
        flo = np.nan_to_num(np.asarray(dmin_img, np.float32).reshape(H, W),
                            nan=cfg.dmin, posinf=cfg.dmin, neginf=cfg.dmin)
        fhi = np.nan_to_num(np.asarray(dmax_img, np.float32).reshape(H, W),
                            nan=cfg.dmax, posinf=cfg.dmax, neginf=cfg.dmax)
        fhi = np.where(fhi < flo + 1, np.ceil(flo + 1), fhi)
        if hpad:
            # pad-row windows reuse the existing extremes so the global
            # label axis does not widen; pad cells are never read
            flo = np.pad(flo, ((0, hpad), (0, 0)),
                         constant_values=float(flo.min()))
            fhi = np.pad(fhi, ((0, hpad), (0, 0)),
                         constant_values=float(fhi.max()))
        per_pixel = True
    else:
        flo = np.full((Hs, W), cfg.dmin, np.float32)
        fhi = np.full((Hs, W), cfg.dmax, np.float32)
        per_pixel = False

    lo_i = flo.astype(np.int32)  # Dvec init truncates toward zero
    hi_i = fhi.astype(np.int32)
    n_sides = 2 if cfg.test_lr else 1

    # global label axis covering both sides, padded for TSGM_ITER growth
    pad = 4 * max(cfg.iterations - 1, 0)
    gmin_l, gmax_l = int(lo_i.min()) - pad, int(hi_i.max()) + pad
    if n_sides == 2:
        gmin_r, gmax_r = -cfg.dmax - pad, -cfg.dmin + pad
        L = max(gmax_l - gmin_l, gmax_r - gmin_r) + 1
        gmin = np.array([gmin_l, gmin_r], np.int32)
    else:
        L = gmax_l - gmin_l + 1
        gmin = np.array([gmin_l], np.int32)

    # the reference scans the weight image for any value != 1
    # (mgm_core.cc:420-423); w != 1 requires aP != 1, so the scan is
    # skipped statically in the common a_p2 == 1 case and resolved
    # against the actual weights (one scalar fetch) otherwise — degenerate
    # images can produce all-ones weights even with a_p2 != 1.
    use_weights = cfg.a_p2 != 1.0

    if per_pixel and mesh is None:
        # upload ONLY the left side's two float planes (the actual
        # per-pixel payload) and expand the stacked window arrays on
        # device: the right side's planes are constants (mgm.cc:368)
        # and the integer S-indices are casts
        lo_idx, hi_idx, flo_j, fhi_j = _pp_expand(
            jnp.asarray(flo), jnp.asarray(fhi), n_sides=n_sides,
            gmin_l=gmin_l,
            gmin_r=int(gmin[1]) if n_sides == 2 else 0,
            dmin=cfg.dmin, dmax=cfg.dmax)
        gmin_j = jnp.asarray(gmin)
    elif per_pixel:
        # mesh path: arrays must exist on host for the multi-host
        # make_array_from_callback sharding (_shard below)
        lo_idx = [lo_i - gmin_l]
        hi_idx = [hi_i - gmin_l]
        if n_sides == 2:
            lo_idx.append(np.full((Hs, W), -cfg.dmax - gmin_r, np.int32))
            hi_idx.append(np.full((Hs, W), -cfg.dmin - gmin_r, np.int32))
        lo_idx = jnp.asarray(np.stack(lo_idx))
        hi_idx = jnp.asarray(np.stack(hi_idx))
        flo_s = [flo]
        fhi_s = [fhi]
        if n_sides == 2:
            flo_s.append(np.full((Hs, W), -cfg.dmax, np.float32))
            fhi_s.append(np.full((Hs, W), -cfg.dmin, np.float32))
        flo_j = jnp.asarray(np.stack(flo_s))
        fhi_j = jnp.asarray(np.stack(fhi_s))
        gmin_j = jnp.asarray(gmin)
    else:
        # constant windows, built on device in one jitted dispatch
        los = [cfg.dmin - gmin_l] + ([-cfg.dmax - gmin_r] if n_sides == 2
                                     else [])
        his = [cfg.dmax - gmin_l] + ([-cfg.dmin - gmin_r] if n_sides == 2
                                     else [])
        flo_v = [cfg.dmin] + ([-cfg.dmax] if n_sides == 2 else [])
        fhi_v = [cfg.dmax] + ([-cfg.dmin] if n_sides == 2 else [])
        lo_idx, hi_idx, flo_j, fhi_j, gmin_j = _const_arrays(
            H=Hs, W=W, los=tuple(los), his=tuple(his),
            flos=tuple(flo_v), fhis=tuple(fhi_v),
            gmins=tuple(int(g) for g in gmin))
    p1 = cfg.p1 * C  # scaled by the *original* channel count (mgm.cc:356)
    p2 = cfg.p2 * C
    gmins = tuple(int(g) for g in gmin)

    u_dev, v_dev = _upload_form(u, cfg), _upload_form(v, cfg)
    # census-exact uint16 codes on the wire: every cost/disparity
    # output is bit-identical, but backflow reads raw pixel VALUES, so
    # it is rebuilt host-side after the fetch (ops/post.backflow_host)
    coded = (np.dtype(u_dev.dtype) == np.uint16
             or np.dtype(v_dev.dtype) == np.uint16)
    if mesh is None:
        u_dev, v_dev = jnp.asarray(u_dev), jnp.asarray(v_dev)
    else:
        # row-shard the pipeline: images arrive replicated (prefilters
        # and weights read row neighbourhoods at the true boundary),
        # _prep_mesh pads+shards them, and jit propagates the shardings
        # through every later stage.  The recursion runs the XLA scan
        # whatever `backend` says (the CUDA kernel is a single-device
        # call).
        # make_array_from_callback builds the global arrays identically
        # in single- and multi-controller (DCN) runs.
        from jax.sharding import NamedSharding, PartitionSpec as P

        backend = "xla"

        def _shard(a, *spec):
            host = np.asarray(a)
            sh = NamedSharding(mesh, P(*spec))
            return jax.make_array_from_callback(host.shape, sh,
                                                lambda idx: host[idx])

        u_dev = _shard(u_dev)   # replicated; sharded after padding
        v_dev = _shard(v_dev)
        lo_idx = _shard(lo_idx, None, "y", None)
        hi_idx = _shard(hi_idx, None, "y", None)
        flo_j = _shard(flo_j, None, "y", None)
        fhi_j = _shard(fhi_j, None, "y", None)
        gmin_j = _shard(gmin_j)
    if coded:
        u_dev, v_dev = _decode16(u_dev), _decode16(v_dev)
    _mark("host prep", prof, (u_dev, v_dev))
    if mesh is None:
        cc, w8, u_j, v_j = _build_volumes(u_dev, v_dev, lo_idx, hi_idx,
                                          cfg=cfg, L=int(L), gmins=gmins,
                                          n_sides=n_sides)
    else:
        u_p, v_p, w8, u_j, v_j = _prep_mesh(
            u_dev, v_dev, cfg=cfg, n_sides=n_sides, hpad=hpad, mesh=mesh)
        cc = _volumes_from_prep(u_p, v_p, lo_idx, hi_idx, cfg=cfg,
                                L=int(L), gmins=gmins)
    _mark("weights + cost volumes", prof, (cc, w8))
    if use_weights:
        use_weights = bool(np.asarray(_any_weighted(w8)))

    s_lo, s_hi = lo_idx, hi_idx
    for it in range(cfg.iterations):
        S, disp, cost = mgm_solve(
            cc, w8 if use_weights else None, lo_idx, hi_idx, s_lo, s_hi,
            gmin_j, p1=p1, p2=p2, ndir=cfg.ndir, mgm=cfg.mgm,
            use_fh=cfg.use_trunc_linear, use_weights=use_weights,
            per_pixel=per_pixel, fix_overcount=cfg.fix_overcount,
            backend=backend, hpad=hpad)
        if cfg.debug:
            # per-iteration energy audit (TSGM_DEBUG, mgm_print_energy.h)
            from .ops.energy import print_solution_energy
            print_solution_energy(disp[0], cc[0], lo_idx[0], hi_idx[0],
                                  gmin[0], p1, p2,
                                  dump_path="/tmp/ENERGY_L1trunc.tif")
        _mark("mgm solve", prof, (S, disp, cost))
        if cfg.refinement != "none":
            disp, cost = _refine(S, disp, cost, s_lo, s_hi, gmin_j,
                                 method=cfg.refinement)
        _mark("refine", prof, (disp, cost))
        if it + 1 < cfg.iterations:
            d_t = disp
            if hpad:
                # update_dmin_dmax windows clamp at the true bottom edge
                # (shift_edge); replicating the last real row into the
                # pad rows reproduces that clamp exactly
                row_ok = (jnp.arange(Hs) < H)[None, :, None]
                d_t = jnp.where(row_ok, disp, disp[:, H - 1:H, :])
            flo_j, fhi_j, s_lo, s_hi = _tighten(d_t, flo_j, fhi_j, gmin_j,
                                                L)

    if hpad:
        # pad rows leave the pipeline as NaN: the NaN-aware median and
        # the LR test then treat the true bottom edge exactly like the
        # unpadded run (windows clip, NaN projections invalidate)
        row_ok = (jnp.arange(Hs) < H)[None, :, None]
        disp = jnp.where(row_ok, disp, jnp.nan)

    want_back = outputs is None or "backflow" in outputs
    disp_dtype, cost_pack = _pack_spec(cfg, C, np.dtype(u_dev.dtype)
                                       if not coded else np.uint16,
                                       use_weights)
    disp, disp_nolr, cost, back = _postprocess(
        disp, cost, u_j, v_j, jnp.float32(cfg.lr_tau),
        median_radius=cfg.median_radius, test_lr=cfg.test_lr,
        n_sides=n_sides, want_backflow=want_back and not coded,
        disp_dtype=disp_dtype, cost_pack=cost_pack)
    _mark("postprocess", prof, (disp, disp_nolr))

    out = {"disp": disp[0], "cost": cost[0], "disp_nolr": disp_nolr[0]}
    if want_back and not coded:
        out["backflow"] = back
    if n_sides == 2:
        out["disp_right"] = disp[1]
        out["cost_right"] = cost[1]
        out["disp_nolr_right"] = disp_nolr[1]
    if outputs is not None:
        keep = set(outputs)
        if want_back and coded:
            keep.add("disp")  # backflow_host rebuilds from disp
        out = {k: v for k, v in out.items() if k in keep}
    if mesh is not None and jax.process_count() > 1:
        # multi-controller: shards live on other hosts; allgather them
        from jax.experimental import multihost_utils

        out = {k: np.asarray(multihost_utils.process_allgather(a,
                                                               tiled=True))
               for k, a in out.items()}
    elif mesh is not None:
        out = {k: np.asarray(a) for k, a in jax.device_get(out).items()}
    else:
        out = _fetch_packed(out)
    out = _unpack_out(out)
    if hpad:
        out = {k: a[:H] for k, a in out.items()}  # drop the fake rows
    if want_back and coded:
        out["backflow"] = post.backflow_host(out["disp"], v, u)
        if outputs is not None and "disp" not in outputs:
            del out["disp"]
    _mark("device_get", prof)
    return out
