"""The directional recursion as one CUDA kernel launch (ops/wavefront.cu).

Every (pass, problem) plane of an `aggregate` call is one row of a
descriptor table; one launch runs all planes, each on its own
thread-block cluster, and writes the per-pass volumes Lr in image
layout.  The sum over passes happens here, in XLA, in exactly the
order of the XLA scan route (group by group, pass by pass), so the two
routes agree bitwise wherever the per-pass arithmetic does.

The library is compiled from the source beside this module by `nvcc`
(sm_90a) into `build/` at the repository root on first use, or ahead of
time with

    python -m mgm_tpu.ops.wavefront_cuda
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from .aggregate import PASS_TABLE, _dir2off

TARGET = "mgm_wavefront"
SOURCE = Path(__file__).with_name("wavefront.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
DESC_FIELDS = 16  # kDesc in wavefront.cu


def plane_table(groups, n_problems: int, mgm: int) -> np.ndarray:
    """(P, 16) int32 plane descriptors, P = passes x problems, in the
    order group -> pass -> problem (the layout of the kernel's output).

    Fields (wavefront.cu, D_*): problem, flip_x, flip_y, row_major,
    slope, active neighbours, the offset index of each dir, the weight
    channel of each dir."""
    rows = []
    for gp in groups:
        for p in gp:
            spec = PASS_TABLE[p]
            assert not spec.knight, "knight passes stay on the XLA scan"
            d2o = _dir2off(spec)[:mgm]
            slope = 2 if 3 in d2o else 1   # NE is on the previous front
            offs = list(d2o) + [0] * (4 - mgm)
            wch = list(spec.wch[:mgm]) + [0] * (4 - mgm)
            for n in range(n_problems):
                row = [n, spec.flip_x, spec.flip_y, spec.row_major, slope,
                       mgm] + offs + wch
                rows.append(row + [0] * (DESC_FIELDS - len(row)))
    return np.asarray(rows, np.int32)


def sum_passes(lr, groups):
    """Sum the (passes, N, H, W, L) per-pass volumes group by group,
    in the association of aggregate's XLA route."""
    out, i = None, 0
    for gp in groups:
        part = lr[i]
        for b in range(1, len(gp)):
            part = part + lr[i + b]
        i += len(gp)
        out = part if out is None else out + part
    return out


def library_path() -> Path:
    """The built library, named by a hash of its source so an edit
    rebuilds."""
    tag = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libmgm_wavefront_{tag}.so"


def nvcc_command(out: Path) -> list[str]:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-fmad=false", "-shared",
            "-Xcompiler", "-fPIC", "-I", jax.ffi.include_dir(),
            "-o", str(out), str(SOURCE)]


def build() -> Path:
    """Compile the kernel library unless this source is already built."""
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run(nvcc_command(tmp), capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed building {SOURCE.name}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.cache
def _register() -> None:
    lib = ctypes.cdll.LoadLibrary(str(build()))
    jax.ffi.register_ffi_target(TARGET, jax.ffi.pycapsule(lib.MgmWavefront),
                                platform="CUDA")


def aggregate(groups, cc, w8, *, p1: float, p2: float, mgm: int,
              use_weights: bool, div_each: bool):
    """Sum over `groups`' passes of Lr for the (N, H, W, L) volume `cc`
    (SGM potential), computed by the kernel."""
    _register()
    N, H, W, L = cc.shape
    desc = plane_table(groups, N, mgm)
    P = desc.shape[0]
    w = w8 if use_weights else jnp.ones((1, 1, 1, 8), jnp.float32)
    lr, _ = jax.ffi.ffi_call(
        TARGET,
        (jax.ShapeDtypeStruct((P, H, W, L), jnp.float32),
         jax.ShapeDtypeStruct((P, H * W), jnp.float32)),
    )(cc, w, jnp.asarray(desc), p1=np.float32(p1), p2=np.float32(p2),
      use_weights=np.int32(use_weights), div_each=np.int32(div_each))
    return sum_passes(lr.reshape(P // N, N, H, W, L), groups)


if __name__ == "__main__":
    print(build())
