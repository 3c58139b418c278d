"""Multi-host execution: the replacement for the reference's cluster
story (SGE qsub + shared filesystem, Commet.py:119,204-236,580-582).

Single-controller-per-host JAX: every host runs the same CLI command;
`jax.distributed.initialize` wires them into one global runtime whose
`jax.devices()` spans every host's GPUs, so the same Mesh/GSPMD code paths
used for single-host multi-device runs (sharded.py) extend across hosts,
with collectives over NVLink within a host and the network between hosts
instead of files on an NFS mount.

Activation is environment-driven so the CLI surface stays reference-shaped:

    COMMET_TPU_COORDINATOR=host0:8476   # coordinator address
    COMMET_TPU_NUM_PROCESSES=4          # world size
    COMMET_TPU_PROCESS_ID=0..3          # this host's rank

All three are required: nothing in a GPU cluster tells JAX its layout.
COMMET_TPU_DISTRIBUTED=1 alone calls `jax.distributed.initialize()` with
no arguments, for clusters whose environment JAX can read itself (e.g. a
SLURM allocation).

Work placement mirrors the reference's SGE partitioning: the commet driver
strides its comparison rounds across processes (rank r runs rounds
r, r+P, ...) over the shared filesystem, and — exactly like the
reference's --sge mode — defers matrix aggregation to a post-hoc
commet_analysis run once every rank has finished. Within each process,
COMMET_TPU_DEVICES selects a mesh over that host's local devices
(sharded.auto_mesh), so device shardings never reference non-addressable
devices.
"""

from __future__ import annotations

import os

_initialized = False


def init_distributed() -> bool:
    """Initialize jax.distributed from COMMET_TPU_* env vars. Returns True
    when a multi-process runtime was (or already had been) set up. Safe to
    call unconditionally — a no-op without the env vars."""
    global _initialized
    if _initialized:
        return True
    coord = os.environ.get("COMMET_TPU_COORDINATOR")
    auto = os.environ.get("COMMET_TPU_DISTRIBUTED") == "1"
    if not coord and not auto:
        return False
    import jax

    kwargs = {}
    if coord:
        kwargs["coordinator_address"] = coord
        kwargs["num_processes"] = int(os.environ["COMMET_TPU_NUM_PROCESSES"])
        kwargs["process_id"] = int(os.environ["COMMET_TPU_PROCESS_ID"])
    jax.distributed.initialize(**kwargs)
    _initialized = True
    return True


def is_primary() -> bool:
    """True on the process that should write result files (rank 0)."""
    import jax

    return jax.process_index() == 0
