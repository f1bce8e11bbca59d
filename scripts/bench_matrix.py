"""Benchmark the full BASELINE.md config matrix on the attached device.

Rows mirror the reference's measured configs (BASELINE.md:23-29;
reference configs from Makefile:16-18 / README.txt:90,107 of
gfacciol/mgm), driven through the preset registry.  Prints one JSON
line per config with MP*disp/s (W*H*L label evaluations per side, x2
when the LR check solves both sides — same accounting as BASELINE.md)
and the speedup over the reference serial-CPU number for that row.
The pairs are mgm_tpu.synth's seeded fountain- and satellite-class
pairs, at the shapes of the reference's fountain23 and satellite data.

    python scripts/bench_matrix.py [--reps N] [--trace DIR] [cfg ...]

--trace captures a jax.profiler device trace (xprof/TensorBoard) of
one steady-state run per config via mgm_tpu.utils.profiling.trace.
"""
import argparse
import json
import sys
import time

sys.path.insert(0, ".")

import numpy as np

from mgm_tpu import synth
from mgm_tpu.models.presets import get_preset
from mgm_tpu.stereo import compute_disparity
from mgm_tpu.utils import trace

FOUNTAIN = dict(dmin=-120, dmax=30, test_lr=True)

# name -> (preset, overrides, image pair, reference MP*disp/s)
MATRIX = {
    "cfg1": ("fast_ad", {}, "fountain", 5.8),
    "cfg1_tsgm4": ("fast_ad", {"mgm": 4}, "fountain", 4.0),
    "cfg2": ("census_tl", {}, "fountain", 2.5),
    "cfg4": ("sobelx_tl", {}, "fountain", 3.0),
    "cfg3": ("satellite", {"test_lr": True}, "satellite", 2.8),
    # per-pixel -m/-M windows at the cfg1 range (same work volume as
    # cfg1: the reference evaluates the full window band either way)
    "cfg1_mM": ("fast_ad", {"per_pixel": True}, "fountain", 5.8),
    # cfg3 at production scale: an 8x8 mosaic of the satellite pair
    # (2232x2168) through the tiled runner — the regime the 279x271
    # cfg3 crop stands in for.  Throughput counts SCENE work
    # (2*H*W*L), not the tiles' context overlap; the reference solves
    # the same scene at its cfg3 rate (its cost is linear in pixels).
    # 512-px tiles, 5 tiles per batched call: the 25 tiles go out as 5
    # identical-shape compute_disparity_batch calls.
    "cfg3_scene": ("satellite", {"test_lr": True, "scene": (8, 8),
                                 "tile": 512, "margin": 64, "batch": 5},
                   "satellite", 2.8),
    # the serving shape: 8 independent satellite pairs in one
    # stereo.compute_disparity_batch call; throughput counts all 8
    # pairs — the reference solves them sequentially at 2.8
    "cfg3_b8": ("satellite", {"test_lr": True, "pairs": 8},
                "satellite", 2.8),
    # deeper serving batch: 32 pairs (203 MP*disp of work)
    "cfg3_b32": ("satellite", {"test_lr": True, "pairs": 32},
                 "satellite", 2.8),
    # all 16 directions incl. the 22.5-degree knight passes — the
    # reference SEGFAULTS at -O 16 (8-entry pass table,
    # mgm_core.cc:463-471,489), so no reference number exists;
    # vs_baseline nominally uses cfg1's 5.8
    "full_16dir": ("fast_ad", {"ndir": 16}, "fountain", 5.8),
}


def load_pair(which):
    make = synth.fountain_pair if which == "fountain" else synth.satellite_pair
    u, v, _ = make(seed=0)
    return u, v


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("cfgs", nargs="*", default=None)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--trace", default=None,
                    help="capture a jax.profiler device trace per config here")
    args = ap.parse_args()
    names = args.cfgs or list(MATRIX)

    for name in names:
        preset, over, pair, ref_mpds = MATRIX[name]
        over = dict(over)
        per_pixel = over.pop("per_pixel", False)
        over_static = {k: over.pop(k)
                       for k in ("scene", "tile", "margin", "batch",
                                 "pairs")
                       if k in over}
        cfg = get_preset(preset, **(FOUNTAIN | over if pair == "fountain"
                                    else over))
        u, v = load_pair(pair)
        H, W, _ = u.shape
        sides = 2 if cfg.test_lr else 1
        mpd = sides * H * W * (cfg.dmax - cfg.dmin + 1) / 1e6
        scene = over_static.get("scene")
        if scene:
            from mgm_tpu.runner import tiled_disparity
            ty, tx = scene
            u = np.ascontiguousarray(np.tile(u, (ty, tx, 1)))
            v = np.ascontiguousarray(np.tile(v, (ty, tx, 1)))
            H, W, _ = u.shape
            mpd = sides * H * W * (cfg.dmax - cfg.dmin + 1) / 1e6

            def run():
                return tiled_disparity(u, v, cfg,
                                       tile=over_static["tile"],
                                       margin=over_static["margin"],
                                       batch=over_static.get("batch", 1))
        elif over_static.get("pairs"):
            from mgm_tpu.stereo import compute_disparity_batch
            K = over_static["pairs"]
            us = np.ascontiguousarray(np.stack([u] * K))
            vs = np.ascontiguousarray(np.stack([v] * K))
            mpd *= K

            def run():
                return compute_disparity_batch(us, vs, cfg,
                                               outputs=("disp", "cost"))
        else:
            kw = {}
            if per_pixel:
                kw = dict(dmin_img=np.full((H, W), cfg.dmin, np.float32),
                          dmax_img=np.full((H, W), cfg.dmax, np.float32))

            def run():
                return compute_disparity(u, v, cfg,
                                         outputs=("disp", "cost"), **kw)

        try:
            run()  # compile warmup
        except Exception as e:  # a crashing row must not kill the matrix
            print(json.dumps({"metric": f"{name} ({preset}, {pair})",
                              "error": f"{type(e).__name__}: {e}"[:300]}),
                  flush=True)
            continue
        times = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            run()
            times.append(time.perf_counter() - t0)
        if args.trace:
            with trace(f"{args.trace}/{name}"):
                run()
        value = mpd / float(np.median(times))
        print(json.dumps({
            "metric": f"{name} ({preset}, {pair}) throughput",
            "value": round(value, 2),
            "unit": "MP*disp/s",
            "vs_baseline": round(value / ref_mpds, 2),
            "stat": "median",
            "best": round(mpd / min(times), 2),
            "rep_times_s": [round(t, 4) for t in times],
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
