"""Smoke test of the stereo and MRF main paths on one NVIDIA GPU.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --devices 4   # four cards: the row-sharded phase

Phases (one process; nothing here starts a second JAX process):

1. device: JAX's platform, kind and count, and the card's name and
   power limit from nvidia-smi; anything but a GPU is an error.
2. cfg1 through the `mgm` CLI (mgm_tpu.cli.main): the seeded 500x700x3
   fountain-class pair, AD, -r -120 -R 30 (L=151), -O 4, TSGM=2, LR on;
   compared with the XLA route on the same card and scored (bad-2.0)
   against the pair's known disparity.
3. the recursion kernel against the XLA scan at cfg1 shapes: the solve's
   S volume and disparities, plus the solve's memory analysis.
4. the satellite preset through the CLI on the seeded 271x279 float32
   pair with NaNs (census, 8 directions, TSGM=3, vfit, median, L=42),
   compared with the XLA route.
5. `mgm_o` protocol round trip through mgm_tpu.mrf_cli.main at
   512x512 pixels x 64 labels, compared with solve_mrf on the XLA route.
6. timing: cfg1 end to end (host arrays in, host arrays out) and the
   cfg1 solve alone, kernel and XLA scan in turns, compile apart.

With --devices 4: the cfg1 pipeline row-sharded over make_mesh(4)
against the one-card run, and parallel.sharded_solve against mgm_solve
on one card; both must be bitwise equal.

Any failed check exits non-zero.  The last line of standard output is
one JSON object: {"ok": true, "device": {...}}.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

CFG1_ARGS = ["-preset", "fast_ad", "-r", "-120", "-R", "30", "-O", "4"]
SAT_ARGS = ["-preset", "satellite"]
REPS = 5


def card() -> str:
    """`name, power.limit` of the card, read by a child without JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0] if out else "unknown"


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def agreement(a: np.ndarray, b: np.ndarray, tol: float = 0.05):
    """(NaN-mask agreement, share of mutually finite pixels within tol)."""
    fa, fb = np.isfinite(a), np.isfinite(b)
    both = fa & fb
    close = float((np.abs(a[both] - b[both]) <= tol).mean()) if both.any() \
        else 1.0
    return float((fa == fb).mean()), close


def gate(name: str, a: np.ndarray, b: np.ndarray) -> None:
    """The repo's disparity gate: masks agree on >= 99.95% of pixels,
    |dd| <= 0.05 on >= 99.8% of mutually finite ones."""
    mask, close = agreement(a, b)
    print(f"{name}: nan-mask agreement {mask:.6f}, |dd|<=0.05 on "
          f"{close:.6f}, bitwise {np.array_equal(a, b, equal_nan=True)}",
          flush=True)
    check(mask >= 0.9995 and close >= 0.998, f"{name} disagrees")


def timed(fn, reps=REPS):
    t0 = time.perf_counter()
    fn()
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return first, times


def report(what: str, first: float, times: list, name: str, work=None):
    med = float(np.median(times))
    line = {"measure": what, "card": name, "first_call_s": first,
            "median_s": med, "min_s": min(times), "max_s": max(times),
            "reps_s": times}
    if work:
        line["MPdisp_per_s"] = work / med
    print("TIME " + json.dumps(line), flush=True)


def run_cli(argv, env):
    from mgm_tpu import cli

    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        rc = cli.main(argv)
    finally:
        for k, val in old.items():
            if val is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = val
    check(rc == 0, f"cli exited {rc}")


def phase_cfg1(tmp, name):
    from mgm_tpu import synth
    from mgm_tpu.models.presets import get_preset
    from mgm_tpu.stereo import compute_disparity

    u, v, truth = synth.fountain_pair(seed=0)
    paths = [os.path.join(tmp, f) for f in ("u.npy", "v.npy", "d.npy",
                                            "c.npy")]
    np.save(paths[0], u)
    np.save(paths[1], v)
    t0 = time.perf_counter()
    run_cli(CFG1_ARGS + paths, {"TSGM": "2"})
    print(f"cfg1 cli: first call {time.perf_counter() - t0:.3f} s "
          f"(compile included)", flush=True)
    disp = np.load(paths[2])[..., 0]
    cost = np.load(paths[3])[..., 0]
    check(disp.shape == (500, 700) and cost.shape == (500, 700),
          f"cfg1 output shape {disp.shape}")
    check(np.isfinite(cost).all(), "cfg1 cost has non-finite values")
    cfg = get_preset("fast_ad", dmin=-120, dmax=30, mgm=2)
    ref = compute_disparity(u, v, cfg, outputs=("disp", "cost"),
                            backend="xla")
    gate("cfg1 cli vs xla route", disp, ref["disp"])
    q, qx = synth.bad_pixel_rate(disp, truth), synth.bad_pixel_rate(
        ref["disp"], truth)
    print(f"cfg1 quality vs known disparity: bad-2.0 {q['bad']:.5f} "
          f"avg_err {q['avg_err']:.4f} invalid {q['invalid']:.4f} "
          f"(xla route: bad-2.0 {qx['bad']:.5f})", flush=True)
    check(q["bad"] < 0.05, "cfg1 bad-2.0 above 5%")
    return u, v, cfg


def cfg1_solve_inputs(u, v, cfg):
    """The cfg1 solve's inputs, built as compute_disparity builds them."""
    import jax.numpy as jnp

    from mgm_tpu import stereo

    L = cfg.dmax - cfg.dmin + 1
    gmins = (cfg.dmin, -cfg.dmax)
    lo, hi, _, _, gmin = stereo._const_arrays(
        H=u.shape[0], W=u.shape[1], los=(0, 0), his=(L - 1, L - 1),
        flos=(float(cfg.dmin), float(-cfg.dmax)),
        fhis=(float(cfg.dmax), float(-cfg.dmin)), gmins=gmins)
    cc, _, _, _ = stereo._build_volumes(jnp.asarray(u), jnp.asarray(v), lo,
                                        hi, cfg=cfg, L=L, gmins=gmins,
                                        n_sides=2)
    kw = dict(p1=cfg.p1 * 3, p2=cfg.p2 * 3, ndir=cfg.ndir, mgm=cfg.mgm,
              use_fh=False, use_weights=False, per_pixel=False,
              fix_overcount=True)
    return (cc, None, lo, hi, lo, hi, gmin), kw


def phase_kernel(u, v, cfg):
    import jax

    from mgm_tpu.solver import mgm_solve

    args, kw = cfg1_solve_inputs(u, v, cfg)
    S_k, d_k, _ = jax.device_get(mgm_solve(*args, backend="cuda", **kw))
    S_x, d_x, _ = jax.device_get(mgm_solve(*args, backend="xla", **kw))
    fk, fx = np.isfinite(S_k), np.isfinite(S_x)
    check(np.array_equal(fk, fx), "kernel S finite mask differs")
    rel = float(np.max(np.abs(S_k[fk] - S_x[fk])
                       / np.maximum(np.abs(S_x[fk]), 1e-30)))
    same = float((d_k == d_x).mean())
    print(f"kernel vs xla scan at cfg1 (2x500x700x151): max |dS|/|S| "
          f"{rel:.3e}, S bitwise {np.array_equal(S_k, S_x, equal_nan=True)}"
          f", disparity agreement {same:.6f}", flush=True)
    check(rel <= 1e-5 and same >= 0.998, "kernel disagrees with xla scan")
    dev = jax.devices()[0]
    for route in ("cuda", "xla"):
        comp = mgm_solve.lower(*args, backend=route, **kw).compile()
        print(f"memory_analysis ({route}): {comp.memory_analysis()}",
              flush=True)
    stats = dev.memory_stats() or {}
    print(f"peak_bytes_in_use after the cfg1 solves: "
          f"{stats.get('peak_bytes_in_use')}", flush=True)
    return args, kw


def phase_satellite(tmp):
    from mgm_tpu import synth
    from mgm_tpu.models.presets import get_preset
    from mgm_tpu.stereo import compute_disparity

    u, v, truth = synth.satellite_pair(seed=0)
    check(bool(np.isnan(u).any()), "satellite pair has no NaNs")
    paths = [os.path.join(tmp, f) for f in ("su.npy", "sv.npy", "sd.npy",
                                            "sc.npy")]
    np.save(paths[0], u)
    np.save(paths[1], v)
    run_cli(SAT_ARGS + paths, {})
    disp = np.load(paths[2])[..., 0]
    check(disp.shape == (271, 279), f"satellite output {disp.shape}")
    ref = compute_disparity(u, v, get_preset("satellite"),
                            outputs=("disp",), backend="xla")
    gate("satellite cli vs xla route", disp, ref["disp"])
    q = synth.bad_pixel_rate(disp, truth)
    print(f"satellite quality vs known disparity: bad-2.0 {q['bad']:.5f} "
          f"invalid {q['invalid']:.4f}", flush=True)


def phase_mrf(tmp):
    from mgm_tpu import mrf_cli
    from mgm_tpu.mrf import solve_mrf

    H = W = 512
    L = 64
    rng = np.random.default_rng(0)
    labels = (np.add.outer(np.arange(H), np.arange(W)) // 48) % L
    unary = rng.uniform(0, 30, (H, W, L)).astype(np.float32)
    unary[np.arange(H)[:, None], np.arange(W)[None], labels] -= 20.0
    w8 = np.where(rng.random((H, W, 8)) < 0.1, 0.5, 1.0).astype(np.float32)
    path_in = os.path.join(tmp, "mrf_in.bin")
    path_out = os.path.join(tmp, "mrf_out.bin")
    with open(path_in, "wb") as f:
        np.asarray([W, H, L, 8], np.int32).tofile(f)
        unary.transpose(2, 0, 1).astype(np.float32).tofile(f)
        w8.transpose(2, 0, 1).astype(np.float32).tofile(f)
    check(mrf_cli.main([path_in, path_out, "8", "32", "2", "0"]) == 0,
          "mrf_cli failed")
    got = np.fromfile(path_out, np.float32).reshape(H, W)
    ref = solve_mrf(unary, ndir=8, p1=8, p2=32, mgm=2, vtype=0, weights=w8,
                    backend="xla")
    same = float((got == ref).mean())
    print(f"mrf_cli 512x512x64 vs solve_mrf xla route: label agreement "
          f"{same:.6f}, bitwise {np.array_equal(got, ref)}, "
          f"recovered planted labels {(got == labels).mean():.4f}",
          flush=True)
    check(same >= 0.999, "mrf_cli disagrees with the xla route")


def phase_timing(u, v, cfg, solve_args, solve_kw, name):
    import jax

    from mgm_tpu.solver import mgm_solve
    from mgm_tpu.stereo import compute_disparity

    work = 2 * u.shape[0] * u.shape[1] * (cfg.dmax - cfg.dmin + 1) / 1e6
    e2e = {route: (lambda r=route: compute_disparity(
        u, v, cfg, outputs=("disp", "cost"), backend=r))
        for route in ("cuda", "xla")}
    solve = {route: (lambda r=route: jax.block_until_ready(
        mgm_solve(*solve_args, backend=r, **solve_kw)))
        for route in ("cuda", "xla")}
    for label, fns in (("cfg1 end to end", e2e), ("cfg1 solve", solve)):
        res = {r: ([], None) for r in fns}
        firsts = {}
        for r, fn in fns.items():  # compile + warm both routes first
            t0 = time.perf_counter()
            fn()
            firsts[r] = time.perf_counter() - t0
        for _ in range(REPS):      # then alternate: cuda, xla, xla, cuda
            for r in ("cuda", "xla", "xla", "cuda"):
                t0 = time.perf_counter()
                fns[r]()
                res[r][0].append(time.perf_counter() - t0)
        for r in fns:
            report(f"{label} [{r}]", firsts[r], res[r][0], name,
                   work if label.endswith("end") else None)


def phase_mesh(name):
    import jax
    import jax.numpy as jnp

    from mgm_tpu import synth
    from mgm_tpu.models.presets import get_preset
    from mgm_tpu.parallel import make_mesh, sharded_solve
    from mgm_tpu.solver import mgm_solve
    from mgm_tpu.stereo import compute_disparity

    n = len(jax.devices())
    check(n >= 4, f"--devices 4 needs 4 devices, found {n}")
    mesh = make_mesh(4)
    u, v, _ = synth.fountain_pair(seed=0)
    cfg = get_preset("fast_ad", dmin=-120, dmax=30, mgm=2)
    one = compute_disparity(u, v, cfg, backend="xla")
    t0 = time.perf_counter()
    four = compute_disparity(u, v, cfg, mesh=mesh)
    print(f"mesh cfg1 first call {time.perf_counter() - t0:.3f} s", flush=True)
    for k in one:
        eq = np.array_equal(one[k], four[k], equal_nan=True)
        print(f"mesh(4) cfg1 vs 1 card [{k}]: bitwise {eq}", flush=True)
        check(eq, f"mesh cfg1 {k} differs from the one-card run")
    kern = compute_disparity(u, v, cfg)
    print("mesh(4) cfg1 vs 1 card, kernel route: bitwise "
          f"{all(np.array_equal(kern[k], four[k], equal_nan=True) for k in one)}",
          flush=True)
    work = 2 * 500 * 700 * 151 / 1e6
    for label, fn in (
            ("mesh(4) [xla]", lambda: compute_disparity(u, v, cfg, mesh=mesh)),
            ("1 card [xla]", lambda: compute_disparity(u, v, cfg,
                                                       backend="xla")),
            ("1 card [cuda]", lambda: compute_disparity(u, v, cfg))):
        first, times = timed(fn)
        report(f"cfg1 end to end, {label}", first, times, name, work)

    rng = np.random.default_rng(0)
    N, H, W, L = 2, 256, 320, 64
    cc = jnp.asarray(rng.uniform(0, 50, (N, H, W, L)).astype(np.float32))
    w8 = jnp.asarray(np.where(rng.random((N, H, W, 8)) < 0.5, 0.25, 1.0)
                     .astype(np.float32))
    lo = jnp.zeros((N, H, W), jnp.int32)
    hi = jnp.full((N, H, W), L - 1, jnp.int32)
    gmin = jnp.zeros((N,), jnp.int32)
    kw = dict(p1=8.0, p2=32.0, ndir=8, mgm=4, use_fh=False,
              use_weights=True)
    want = jax.device_get(mgm_solve(cc, w8, lo, hi, lo, hi, gmin,
                                    per_pixel=False, fix_overcount=True,
                                    backend="xla", **kw))
    got = jax.device_get(sharded_solve(mesh, cc, w8, lo, hi, lo, hi, gmin,
                                       **kw))
    for k, a, b in zip(("S", "disp", "cost"), want, got):
        eq = np.array_equal(a, b, equal_nan=True)
        print(f"sharded_solve(4) vs mgm_solve [{k}]: bitwise {eq}",
              flush=True)
        check(eq, f"sharded_solve {k} differs")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4: run only the row-sharded four-card phase")
    args = ap.parse_args(argv)

    import jax

    import mgm_tpu  # noqa: F401  (configures the compile cache)

    dev = jax.devices()[0]
    info = {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}
    print(f"device: {info}", flush=True)
    check(dev.platform == "gpu", f"no GPU: JAX found {dev.platform!r}")
    name = card()
    print(f"card (name, power.limit): {name}", flush=True)

    if args.devices == 4:
        phase_mesh(name)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            u, v, cfg = phase_cfg1(tmp, name)
            solve_args, solve_kw = phase_kernel(u, v, cfg)
            phase_satellite(tmp)
            phase_mrf(tmp)
        phase_timing(u, v, cfg, solve_args, solve_kw, name)
    print(f"card (name, power.limit): {name}", flush=True)
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
