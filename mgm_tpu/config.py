"""Typed configuration for the mgm_tpu stereo / MRF engine.

One flat config object mirrors every knob of the reference `mgm` binary
(CLI flags at mgm.cc:302-318 and env vars at mgm.cc:186-196 of
gfacciol/mgm) so that reference invocations map 1:1.  Unlike the
reference there is no hidden env-var state: everything is explicit here
(the CLI front-end still *reads* the reference env vars for drop-in
compatibility and materialises them into this object).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass


# Registries mirror the reference lookup tables, including the
# "unknown name silently falls back to the first entry" behaviour
# (mgm_costvolume.h:184-207, mgm_refine.h:28-35).
DISTANCES = ("ad", "sd", "census", "ncc", "btad", "btsd")
PREFILTERS = ("none", "census", "sobelx", "gblur")
REFINEMENTS = ("none", "vfit", "parabola", "cubic", "parabolaOCV")


def resolve_distance(name: str) -> str:
    """Unknown distance names resolve to 'ad' (mgm_costvolume.h:184-190)."""
    return name if name in DISTANCES else "ad"


def resolve_prefilter(name: str) -> str:
    """Unknown prefilter names resolve to 'none' (mgm_costvolume.h:201-207).

    Notably the README's flagship example uses ``-p sobel_x`` which is NOT
    a registered name, so it silently runs with no prefilter; we preserve
    that exact behaviour.
    """
    return name if name in PREFILTERS else "none"


def resolve_refinement(name: str) -> str:
    """Unknown refinement names resolve to 'none' (mgm_refine.h:28-35)."""
    return name if name in REFINEMENTS else "none"


@dataclass(frozen=True)
class MGMConfig:
    """All knobs of one MGM solve.  Defaults = reference defaults."""

    # disparity search range (CLI -r / -R, mgm.cc:305-306)
    dmin: int = -30
    dmax: int = 30
    # number of scan directions (CLI -O, mgm.cc:307). The reference
    # advertises 16 but segfaults for NDIR>8 (its pass table stops at 8,
    # mgm_core.cc:463-474); we support the full 1..16 (9..16 are the
    # 22.5-degree knight-move passes).
    ndir: int = 4
    # regularisation (CLI -P1/-P2, scaled by nch inside the pipeline
    # as at mgm.cc:356-357)
    p1: float = 8.0
    p2: float = 32.0
    # number of causal neighbours coupled per pass (env TSGM, mgm.cc:186)
    mgm: int = 4
    # cost/prefilter/refinement names (resolved through the registries)
    distance: str = "ad"
    prefilter: str = "none"
    refinement: str = "none"
    # cost truncation at nch*trunc_dist (CLI -truncDist, mgm.cc:317)
    trunc_dist: float = math.inf
    # adaptive-weight params (CLI -aP1/-aP2/-aThresh, mgm.cc:310-312).
    # NOTE: the reference parses aP1 but never uses it ("missing aP1 !!
    # TODO", mgm.cc:372): both weight images use aP2. We reproduce that.
    a_p1: float = 1.0
    a_p2: float = 1.0
    a_thresh: float = 5.0
    # census / NCC window size (env CENSUS_NCC_WIN, mgm_costvolume.h:61)
    census_ncc_win: int = 3
    # potential family (env USE_TRUNCATED_LINEAR_POTENTIALS, mgm.cc:189)
    use_trunc_linear: bool = False
    # overcount fix (env TSGM_FIX_OVERCOUNT, mgm.cc:187)
    fix_overcount: bool = True
    # range-refinement iterations (env TSGM_ITER, mgm.cc:193)
    iterations: int = 1
    # median postfilter radius (env MEDIAN, mgm.cc:196)
    median_radius: int = 0
    # left-right consistency check (env TESTLRRL / TESTLRRL_TAU)
    test_lr: bool = True
    lr_tau: float = 1.0
    # energy audit per iteration (env TSGM_DEBUG, mgm.cc:27)
    debug: bool = False

    def __post_init__(self):
        object.__setattr__(self, "distance", resolve_distance(self.distance))
        object.__setattr__(self, "prefilter", resolve_prefilter(self.prefilter))
        object.__setattr__(self, "refinement", resolve_refinement(self.refinement))
        # census distance and census prefilter force each other
        # (mgm_costvolume.h:358-362)
        if self.distance == "census" or self.prefilter == "census":
            object.__setattr__(self, "distance", "census")
            object.__setattr__(self, "prefilter", "census")
        if not (1 <= self.ndir <= 16):
            raise ValueError(f"ndir must be in 1..16, got {self.ndir}")
        if self.mgm not in (1, 2, 3, 4):
            raise ValueError(f"mgm (TSGM) must be in 1..4, got {self.mgm}")

    def replace(self, **kw) -> "MGMConfig":
        return dataclasses.replace(self, **kw)
