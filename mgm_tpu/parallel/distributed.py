"""Multi-host (multi-controller) execution over the network.

The reference is a single serial process (SURVEY.md 2.9); this module
is the jax.distributed half of the scaling design: each host runs the
same program, contributes its local devices to one global 1-D row
mesh, and the row-sharded stereo pipeline
(stereo.compute_disparity(mesh=...)) executes with XLA collectives —
boundary-row collective-permutes ride the device links within a host
and the network across hosts.

Hermetic test: tests/test_distributed.py launches 2 CPU processes on
one machine (coordinator on localhost) and asserts the 2-process
result equals the single-process one bitwise.

Typical multi-host run (same command on every host):

    python -m mgm_tpu.parallel.distributed \
        --coordinator HOST0:9911 --num-processes 2 --process-id $ID \
        -r -120 -R 30 -O 8 left.png right.png out_disp.tif
"""
from __future__ import annotations

import os

import numpy as np


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               local_device_ids=None):
    """jax.distributed.initialize with env-var fallbacks
    (MGM_TPU_COORDINATOR / MGM_TPU_NUM_PROCS / MGM_TPU_PROC_ID).
    On clusters whose runtime jax detects, all arguments are optional;
    elsewhere pass all three."""
    import jax

    coordinator = coordinator or os.environ.get("MGM_TPU_COORDINATOR")
    if num_processes is None and os.environ.get("MGM_TPU_NUM_PROCS"):
        num_processes = int(os.environ["MGM_TPU_NUM_PROCS"])
    if process_id is None and os.environ.get("MGM_TPU_PROC_ID"):
        process_id = int(os.environ["MGM_TPU_PROC_ID"])
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id,
                               local_device_ids=local_device_ids)


def global_row_mesh():
    """1-D mesh (axis "y") over ALL devices of every process, ordered
    so each process's devices are contiguous in the row axis."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()), ("y",))


def compute_disparity_distributed(u, v, cfg, **kw):
    """Row-sharded compute_disparity over the global mesh.  Every
    process passes the SAME full images (cheap: megabytes) and receives
    the full outputs; the compute and memory of the volumes are sharded
    across all hosts' devices.

    jax.distributed must be initialized first (see `initialize`)."""
    import jax
    from ..stereo import compute_disparity

    mesh = global_row_mesh()
    out = compute_disparity(u, v, cfg, mesh=mesh, **kw)
    return out


def main(argv=None):
    """Distributed CLI front-end: `--coordinator/--num-processes/
    --process-id` plus the standard mgm flags; process 0 writes the
    outputs."""
    import sys

    from ..cli import main as cli_main, pick_option

    argv = list(sys.argv[1:] if argv is None else argv)
    coord = pick_option(argv, "-coordinator", None) or \
        pick_option(argv, "coordinator", None)
    nproc = pick_option(argv, "-num-processes", None) or \
        pick_option(argv, "num-processes", None)
    pid = pick_option(argv, "-process-id", None) or \
        pick_option(argv, "process-id", None)
    initialize(coord, int(nproc) if nproc else None,
               int(pid) if pid else None)

    import jax

    rc = cli_main(argv, mesh=global_row_mesh())
    # every process computes (and, on shared-nothing hosts, writes) the
    # same outputs; process 0's files are the canonical ones
    jax.effects_barrier()
    return rc


if __name__ == "__main__":
    import sys

    sys.exit(main())
