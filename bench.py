"""Headline benchmark: BASELINE.md cfg1 on the seeded fountain-class pair.

Config (BASELINE.json cfg1): AD cost, -r -120 -R 30 (L=151), -O 4,
TSGM=2, default P1/P2, LR consistency check on (both sides solved), on
the 500x700x3 uint8 pair of mgm_tpu.synth.fountain_pair(seed=0).
Reference serial-CPU baseline: 5.8 MP*disp/s over 2 sides
(BASELINE.md; measured there on fountain23, a pair of the same shape).

Each timed rep runs compute_disparity from host arrays to host arrays
(it returns numpy arrays, so the time ends in the device->host fetch).
Prints one JSON line after every rep: the median so far, the best rep,
every rep, the device as JAX reports it and the card's name and power
limit.  Refuses to run without a GPU.

    python bench.py            # MGM_TPU_BENCH_REPS=10 reps by default
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

BASELINE_MPDS = 5.8  # reference binary, same config, 1-core Xeon 2.10 GHz
REPS = int(os.environ.get("MGM_TPU_BENCH_REPS", "10"))


def main():
    import jax

    from mgm_tpu import synth
    from mgm_tpu.config import MGMConfig
    from mgm_tpu.stereo import compute_disparity

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices()), "card": card}

    u, v, _ = synth.fountain_pair(seed=0)
    cfg = MGMConfig(dmin=-120, dmax=30, ndir=4, mgm=2, distance="ad",
                    p1=8, p2=32, test_lr=True)
    H, W, _ = u.shape
    L = cfg.dmax - cfg.dmin + 1
    mpd = 2 * H * W * L / 1e6  # both sides

    def run():
        return compute_disparity(u, v, cfg, outputs=("disp", "cost"))

    run()  # warmup (compile; fast when the persistent cache is warm)
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
        value = mpd / float(np.median(times))
        print(json.dumps({
            "metric": ("fountain-class cfg1 (AD, L=151, O4, TSGM=2, LR) "
                       "throughput"),
            "value": round(value, 2),
            "unit": "MP*disp/s",
            "vs_baseline": round(value / BASELINE_MPDS, 2),
            "stat": "median",
            "best": round(mpd / min(times), 2),
            "rep_times_s": [round(t, 5) for t in times],
            "device": device,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
