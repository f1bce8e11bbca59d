"""Tiled large-scene runner with checkpoint/resume.

The reference processes one image pair per invocation and keeps the
whole cost volume in RAM (mgm.cc:266-450 of gfacciol/mgm); satellite
pipelines built on it (s2p-style) tile big scenes into overlapping
crops and run the binary per tile.  This runner makes that pattern a
first-class, resumable library call: the scene is cut into tiles with
a `margin`-pixel context band, each tile solves on-device (optionally
mesh-sharded), the core of each result is mosaicked into the scene
arrays, and — with `checkpoint_dir` — every finished tile is persisted
(utils/checkpoint.py) so a preempted job resumes at the first
unfinished tile.

The data term of a core pixel is exact: the right-image crop is
widened by [dmin, dmax] so every candidate correspondence is present.
Aggregation context is truncated at `margin` pixels — the standard
tiling trade-off (regularisation influence decays with distance);
margin >= scene size reproduces the single-solve result exactly.
"""
from __future__ import annotations

import os

import numpy as np

from .config import MGMConfig
from .stereo import compute_disparity
from .utils.checkpoint import load_state, save_state


def _tile_starts(size: int, tile: int) -> list[int]:
    return list(range(0, size, tile)) if size else [0]


def tiled_disparity(u: np.ndarray, v: np.ndarray, cfg: MGMConfig,
                    tile: int = 512, margin: int = 64,
                    checkpoint_dir: str | None = None,
                    mesh=None, verbose: bool = False,
                    dmin_img: np.ndarray | None = None,
                    dmax_img: np.ndarray | None = None,
                    batch: int = 1) -> dict:
    """Solve a (H, W, C) scene pair tile-by-tile.

    Returns {'disp', 'cost'} scene-sized float32 arrays (left side).
    `tile`: core tile size (pixels, both axes).  `margin`: context
    pixels added on every tile side before solving (cropped off after).
    `checkpoint_dir`: persist each finished tile and skip tiles already
    present (resume after preemption).  `dmin_img`/`dmax_img`: scene
    per-pixel disparity windows (-m/-M), cropped per tile.
    `batch`: solve up to this many tiles per device launch set
    (stereo.compute_disparity_batch — every context crop has the same
    shape by construction, so they stack): small tiles are dominated
    by per-launch overheads, which batching amortises.  batch > 1
    requires constant windows and no mesh.
    """
    H, W, _ = u.shape
    assert v.shape == u.shape, "rectified pairs share geometry"
    pad_l, pad_r = max(0, -cfg.dmin), max(0, cfg.dmax)
    disp = np.full((H, W), np.nan, np.float32)
    cost = np.full((H, W), np.nan, np.float32)
    if checkpoint_dir:
        os.makedirs(checkpoint_dir, exist_ok=True)
    if dmin_img is not None or mesh is not None:
        batch = 1

    # enumerate pending tile jobs (loading checkpointed ones up front)
    jobs = []
    n_solved = 0
    for y0 in _tile_starts(H, tile):
        for x0 in _tile_starts(W, tile):
            y1, x1 = min(y0 + tile, H), min(x0 + tile, W)
            ckpt = (os.path.join(checkpoint_dir, f"tile_{y0}_{x0}.npz")
                    if checkpoint_dir else None)
            state = load_state(ckpt) if ckpt else None
            if state is not None:
                disp[y0:y1, x0:x1] = state["disp"]
                cost[y0:y1, x0:x1] = state["cost"]
                continue
            # context window: margin all around, plus the disparity
            # search band on the column axis so every candidate right
            # pixel of a core left pixel is inside the crop.  The
            # window has ONE constant shape, shifted inward at scene
            # edges (extra context there, never less): every tile then
            # reuses a single compiled program instead of compiling one
            # per edge-tile shape.
            ctx_h = min(H, tile + 2 * margin)
            ctx_w = min(W, tile + 2 * margin + pad_l + pad_r)
            cy0 = min(max(0, y0 - margin), H - ctx_h)
            cx0 = min(max(0, x0 - margin - pad_l), W - ctx_w)
            jobs.append((y0, x0, y1, x1, cy0, cx0, cy0 + ctx_h,
                         cx0 + ctx_w, ckpt))

    def finish(job, td, tc):
        nonlocal n_solved
        y0, x0, y1, x1, cy0, cx0, _, _, ckpt = job
        oy, ox = y0 - cy0, x0 - cx0
        td = td[oy:oy + (y1 - y0), ox:ox + (x1 - x0)]
        tc = tc[oy:oy + (y1 - y0), ox:ox + (x1 - x0)]
        disp[y0:y1, x0:x1] = td
        cost[y0:y1, x0:x1] = tc
        n_solved += 1
        if ckpt:
            save_state(ckpt, disp=td, cost=tc)
        if verbose:
            print(f"[tile] ({y0},{x0})..({y1},{x1}) solved", flush=True)

    use_batch = batch > 1 and len(jobs) > 1
    if use_batch:
        # STREAMED batching: the scene flows through a three-stage
        # host pipeline — per-group slab upload, batched solve, core
        # window fetch — with every stage overlapped, so over a link
        # whose up- and down-streams run concurrently the scene wall
        # is max(upload, fetch, device), not their sum:
        #   - uploads are per-group row slabs, dispatched ahead
        #     (device_put is async) while earlier groups compute and
        #     fetch; census-cost configs ship slabs as census-exact
        #     uint16 codes (ops/census_codec.py) at half the float32
        #     bytes, encoded concurrently on a host pool.  Non-codec
        #     scenes upload DISJOINT bands (no margin-overlap
        #     re-shipping) and assemble each slab by device concat.
        #   - each group's compute is dispatched as soon as its slab
        #     is in flight (one compiled program for every group);
        #   - only core-sized windows are fetched, each on a worker
        #     thread in parallel chunk streams (stereo._fetch_buf),
        #     overlapping later groups' uploads.
        import jax
        import jax.numpy as jnp
        from concurrent.futures import ThreadPoolExecutor
        from functools import partial
        from .stereo import (_fetch_packed, _u8_lossless, _unpack_out,
                             _upload_form, compute_disparity_batch)

        ctx_h = min(H, tile + 2 * margin)
        ctx_w = min(W, tile + 2 * margin + pad_l + pad_r)
        th, tw = min(tile, ctx_h), min(tile, ctx_w)

        @partial(jax.jit, static_argnames=("h", "w"))
        def crop_stack(img, offs, *, h, w):
            return jax.vmap(lambda o: jax.lax.dynamic_slice(
                img, (o[0], o[1], 0), (h, w, img.shape[2])))(offs)

        @partial(jax.jit, static_argnames=("h", "w"))
        def core_stack(a, offs, *, h, w):
            return jax.vmap(lambda x, o: jax.lax.dynamic_slice(
                x, (o[0], o[1]), (h, w)))(a, offs)

        # groups NEVER straddle tile rows: every group's jobs then
        # share one context row band (a constant-height slab -> one
        # compiled shape for all groups)
        groups = []
        row, cur = None, []
        for job in jobs:
            if job[0] != row or len(cur) == batch:
                if cur:
                    groups.append(cur)
                row, cur = job[0], []
            cur.append(job)
        if cur:
            groups.append(cur)

        wire_u, wire_v = _u8_lossless(u), _u8_lossless(v)
        use_codec = False
        if wire_u.dtype == np.float32 or wire_v.dtype == np.float32:
            from .ops import census_codec
            use_codec = (census_codec.eligible(cfg)
                         and os.environ.get("MGM_TPU_CODEC16", "1")
                         != "0")

        enc_pool = ThreadPoolExecutor(max_workers=4)
        fetch_pool = ThreadPoolExecutor(max_workers=4)
        if use_codec:
            # overlapping slabs, each ENCODED INDEPENDENTLY: a slab's
            # decoded values are only ever compared within that slab's
            # solve, so per-slab maps stay exact (census_codec.py)
            def slab_forms(g):
                cy0, cy1 = g[0][4], g[0][6]
                return (_upload_form(u[cy0:cy1], cfg),
                        _upload_form(v[cy0:cy1], cfg))
            forms = [enc_pool.submit(slab_forms, g) for g in groups]

        import time as _time
        prof = os.environ.get("MGM_TPU_PROFILE")
        t0 = _time.perf_counter()
        stats = {"encode_wait": 0.0, "upload_bytes": 0,
                 "dispatch_done": 0.0, "fetch_tail": 0.0}
        pending = []
        prev = None  # (cy0, slab_u, slab_v) of the previous group
        for gi, grp in enumerate(groups):
            cy0, cy1 = grp[0][4], grp[0][6]
            if use_codec:
                te = _time.perf_counter()
                su, sv = forms[gi].result()
                stats["encode_wait"] += _time.perf_counter() - te
                stats["upload_bytes"] += su.nbytes + sv.nbytes
                from .stereo import _decode16
                dec = (lambda h: _decode16(jnp.asarray(h))
                       if h.dtype == np.uint16 else jnp.asarray(h))
                slab_u, slab_v = dec(su), dec(sv)
            elif prev is not None and cy0 < prev[0] + prev[1].shape[0]:
                # disjoint band upload + device concat with the tail
                # of the previous slab
                b0 = prev[0] + prev[1].shape[0]
                bu, bv = (jnp.asarray(wire_u[b0:cy1]),
                          jnp.asarray(wire_v[b0:cy1]))
                slab_u = jnp.concatenate([prev[1][cy0 - prev[0]:], bu])
                slab_v = jnp.concatenate([prev[2][cy0 - prev[0]:], bv])
            else:
                slab_u = jnp.asarray(wire_u[cy0:cy1])
                slab_v = jnp.asarray(wire_v[cy0:cy1])
            prev = (cy0, slab_u, slab_v)
            padded = grp + [grp[-1]] * (batch - len(grp))
            offs = jnp.asarray([[j[4] - cy0, j[5]] for j in padded],
                               jnp.int32)
            us = crop_stack(slab_u, offs, h=ctx_h, w=ctx_w)
            vs = crop_stack(slab_v, offs, h=ctx_h, w=ctx_w)
            res = compute_disparity_batch(us, vs, cfg,
                                          outputs=("disp", "cost"),
                                          device_out=True)
            # core-sized fetch windows: anchored so the [y0,y1)x[x0,x1)
            # core always lies inside (edge tiles shift inward)
            anch = [(min(j[0] - j[4], ctx_h - th),
                     min(j[1] - j[5], ctx_w - tw)) for j in padded]
            aoffs = jnp.asarray(anch, jnp.int32)
            wins_dev = {k: core_stack(res[k], aoffs, h=th, w=tw)
                        for k in ("disp", "cost")}
            pending.append((grp, anch,
                            fetch_pool.submit(_fetch_packed, wins_dev)))
        stats["dispatch_done"] = _time.perf_counter() - t0
        for grp, anch, fut in pending:
            wins = _unpack_out(fut.result())
            for k, job in enumerate(grp):
                y0, x0, y1, x1, cy0, cx0 = job[:6]
                ay, ax = anch[k]
                oy, ox = y0 - cy0 - ay, x0 - cx0 - ax
                fake = list(job)
                fake[4], fake[5] = y0 - oy, x0 - ox  # window origin
                finish(tuple(fake), wins["disp"][k], wins["cost"][k])
        stats["fetch_tail"] = (_time.perf_counter() - t0
                               - stats["dispatch_done"])
        if prof:
            if not use_codec:
                stats["upload_bytes"] = wire_u.nbytes + wire_v.nbytes
            print(f"[profile] stream: groups={len(groups)} "
                  f"codec={use_codec} "
                  f"upload={stats['upload_bytes'] / 1e6:.1f}MB "
                  f"encode_wait={stats['encode_wait'] * 1e3:.0f}ms "
                  f"dispatch_done={stats['dispatch_done'] * 1e3:.0f}ms "
                  f"fetch_tail={stats['fetch_tail'] * 1e3:.0f}ms",
                  flush=True)
        enc_pool.shutdown()
        fetch_pool.shutdown()
    else:
        for job in jobs:
            y0, x0, y1, x1, cy0, cx0, cy1, cx1, ckpt = job
            kw = {}
            if dmin_img is not None:
                kw = dict(dmin_img=dmin_img[cy0:cy1, cx0:cx1],
                          dmax_img=dmax_img[cy0:cy1, cx0:cx1])
            res = compute_disparity(
                u[cy0:cy1, cx0:cx1], v[cy0:cy1, cx0:cx1], cfg,
                outputs=("disp", "cost"), mesh=mesh, **kw)
            finish(job, res["disp"], res["cost"])
    return {"disp": disp, "cost": cost, "tiles_solved": n_solved}


def main(argv=None):
    """CLI: mgm-tpu-tiled left right out_disp [out_cost] [options]."""
    import argparse

    from .io import read_image, write_image

    ap = argparse.ArgumentParser(
        prog="mgm-tpu-tiled",
        description="Tiled, resumable large-scene stereo (preset-based)")
    ap.add_argument("left")
    ap.add_argument("right")
    ap.add_argument("out_disp")
    ap.add_argument("out_cost", nargs="?")
    ap.add_argument("--preset", default="fast_ad")
    ap.add_argument("-r", "--dmin", type=int, default=-30)
    ap.add_argument("-R", "--dmax", type=int, default=30)
    ap.add_argument("--tile", type=int, default=512)
    ap.add_argument("--margin", type=int, default=64)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint dir (enables resume)")
    ap.add_argument("-m", "--dmin-img", default=None,
                    help="per-pixel minimum disparity image")
    ap.add_argument("-M", "--dmax-img", default=None,
                    help="per-pixel maximum disparity image")
    args = ap.parse_args(argv)

    from .models.presets import get_preset
    cfg = get_preset(args.preset, dmin=args.dmin, dmax=args.dmax)
    u, v = read_image(args.left), read_image(args.right)
    dmin_img = (read_image(args.dmin_img)[..., 0]
                if args.dmin_img else None)
    dmax_img = (read_image(args.dmax_img)[..., 0]
                if args.dmax_img else None)
    res = tiled_disparity(u, v, cfg, tile=args.tile, margin=args.margin,
                          checkpoint_dir=args.ckpt, verbose=True,
                          dmin_img=dmin_img, dmax_img=dmax_img)
    write_image(args.out_disp, res["disp"])
    if args.out_cost:
        write_image(args.out_cost, res["cost"])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
