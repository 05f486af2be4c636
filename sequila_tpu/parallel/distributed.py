"""Multi-host runtime initialization.

The reference is single-process (SURVEY.md §2: no MPI/NCCL/Gloo; its
Spark-era ancestor handled clusters).  This engine scales across GPU
hosts with JAX's native distributed runtime: every host calls
``initialize()`` (one process per host), after which ``jax.devices()``
spans the cluster, ``parallel.mesh.make_mesh`` builds a global mesh,
and the shard_map joins in partitioned_join.py run unchanged — XLA hands
the psum/all-gather collectives to NCCL (NVLink within a host, the
network across hosts).

Single-host multi-chip needs no initialization at all.  This module is
exercised indirectly: the driver's ``dryrun_multichip`` and the test
suite validate the SPMD path on virtual device meshes, which compile to
the same collectives.
"""

from __future__ import annotations

import os

import jax


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Join the multi-host JAX runtime (idempotent).

    With no arguments, JAX auto-detects the cluster from its environment
    (for example a SLURM allocation); arguments are required elsewhere:
    coordinator address, process count and process id.  MUST be the first JAX call in the process — even
    jax.process_count() would initialize the XLA backend and make
    distributed initialization impossible.
    """
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError as e:
        msg = str(e).lower()
        if "already initialized" in msg or "already been called" in msg:
            return
        raise
    except ValueError:
        # Auto-detection found no cluster environment: single host.
        if coordinator_address is not None:
            raise


def is_multihost() -> bool:
    return jax.process_count() > 1


def local_host_info() -> dict:
    return {
        "process_id": jax.process_index(),
        "num_processes": jax.process_count(),
        "local_devices": [str(d) for d in jax.local_devices()],
        "global_devices": len(jax.devices()),
    }
