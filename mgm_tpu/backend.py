"""The one place where the platform picks the recursion's code path.

    cpu -> "xla":  the lax.scan wavefront (ops/aggregate._run_group);
    gpu -> "cuda": the Hopper recursion kernel (ops/wavefront_cuda.py)
                   for the cases it implements, "xla" for the rest;
    any other platform -> ValueError.

Callers may also name a route explicitly ("xla" or "cuda"); the
row-sharded mesh paths always ask for "xla", because the kernel is a
single-device custom call.
"""
from __future__ import annotations

import jax

ROUTES = ("xla", "cuda")


def kernel_supports(*, ndir: int, use_fh: bool, hpad: int) -> bool:
    """Cases the CUDA kernel implements: the SGM potential over the
    eight 45-degree passes on an unpadded image.  Knight passes
    (ndir > 8), the truncated-linear potential and mesh padding rows
    stay on the XLA scan."""
    return ndir <= 8 and not use_fh and hpad == 0


def recursion_route(backend: str = "auto", *, ndir: int, use_fh: bool,
                    hpad: int = 0, platform: str | None = None) -> str:
    """Resolve `backend` ("auto", "xla" or "cuda") to a concrete route."""
    if backend == "auto":
        platform = platform or jax.devices()[0].platform
        if platform == "cpu":
            return "xla"
        if platform == "gpu":
            return ("cuda" if kernel_supports(ndir=ndir, use_fh=use_fh,
                                              hpad=hpad) else "xla")
        raise ValueError(f"unsupported platform {platform!r}: "
                         "mgm_tpu runs on 'cpu' and 'gpu'")
    if backend not in ROUTES:
        raise ValueError(f"unknown backend {backend!r}; expected 'auto' "
                         f"or one of {ROUTES}")
    if backend == "cuda" and not kernel_supports(ndir=ndir, use_fh=use_fh,
                                                 hpad=hpad):
        raise ValueError("the cuda recursion kernel implements the SGM "
                         "potential on ndir <= 8 without mesh padding")
    return backend
