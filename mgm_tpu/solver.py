"""One MGM solve on dense volumes: aggregation + S assembly + WTA.

Mirrors mgm() at mgm_core.cc:408-613 with dense (N, H, W, L) arrays:
  - the recursion runs on the CC label windows (Lr is a copy of CC);
  - S accumulates Lr only over CC-window cells that fall inside the
    (possibly tighter) S windows (increment_nolock clips), else stays 0;
  - the overcount fix S[o] -= (NDIR-1)*CC[o] mutates S *before* the
    argmin and before subpixel refinement reads it, including the
    -inf/NaN cells the reference produces where S and CC windows
    disagree (mgm_core.cc:592-609);
  - WTA takes the first finite minimum in ascending label order.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .ops.aggregate import aggregate
from .ops.cost import window_mask
from .ops.common import INF


@partial(jax.jit, static_argnames=("p1", "p2", "ndir", "mgm", "use_fh",
                                   "use_weights", "per_pixel",
                                   "fix_overcount", "backend", "hpad"))
def mgm_solve(cc, w8, lo, hi, s_lo, s_hi, gmin, *, p1: float, p2: float,
              ndir: int, mgm: int, use_fh: bool, use_weights: bool,
              per_pixel: bool, fix_overcount: bool, backend: str = "auto",
              hpad: int = 0):
    """Returns (S, disp, cost).

    cc: (N, H, W, L) dense cost volume (+inf outside [lo, hi] windows)
    lo/hi: recursion (CC) label windows; s_lo/s_hi: S/WTA windows
    gmin: (N,) disparity value of label index 0 per problem
    S: the post-overcount-fix aggregated volume (what refinement reads);
       cells outside the S windows hold +inf (never read by the
       reference; its zeros there are unobservable).
    disp: float disparities (label argmin + gmin); cost: the minima.
    """
    N, H, W, L = cc.shape
    # the barriers keep the cost-volume producer and the WTA consumer
    # out of the recursion's program: each stage fuses on its own
    cc = jax.lax.optimization_barrier(cc)
    lsum = aggregate(cc, w8, lo, hi, p1=p1, p2=p2, ndir=ndir, mgm=mgm,
                     use_fh=use_fh, use_weights=use_weights,
                     fh_restrict=use_fh and per_pixel, backend=backend,
                     hpad=hpad)
    lsum = jax.lax.optimization_barrier(lsum)

    in_cc = window_mask(lo, hi, L)
    in_s = window_mask(s_lo, s_hi, L)
    s_raw = jnp.where(in_cc, lsum, 0.0)
    if fix_overcount:
        cc_inf = jnp.where(in_cc, cc, INF)
        s_raw = s_raw - jnp.float32(ndir - 1) * cc_inf
    S = jnp.where(in_s, s_raw, INF)

    cand = jnp.where(jnp.isfinite(S), S, INF)
    idx = jnp.argmin(cand, axis=-1)
    cost = jnp.min(cand, axis=-1)
    disp = (gmin[:, None, None] + idx).astype(jnp.float32)
    return S, disp, cost
