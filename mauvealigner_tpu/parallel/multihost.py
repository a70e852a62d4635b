"""Multi-process (multi-host / DCN) execution.

Reference analog: the MPI-distributed mpiMauveAligner whose sources are
absent from the snapshot (projects/mpiMauveAligner.vcproj:118-122) and the
file-based offset-partitioned match logs (src/mauveAligner.cpp:533-589).
Replacement: the same `shard_map` kernels run unchanged over a GLOBAL mesh
spanning processes — collectives between the devices of a host and across
hosts; no journal files, no MPI.

Usage (per process):
    init_multihost(coordinator, num_processes, process_id)
    mesh = global_mesh()
    ml = find_multi_mums_sharded(genomes, smls_dev, mesh, ...)  # unchanged

Genomes are replicated per host (SURVEY.md §5.8); inputs scatter by rows
into the global mesh and the compact per-partition candidate tables gather
back to every process, so all processes hold the identical MatchList
(determinism across process counts).

Tested cross-process on localhost (CPU Gloo backend,
tests/test_multihost.py); the same code path initializes across hosts.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

# NOTE: must stay import-light — init_multihost has to run before anything
# touches the XLA backend, and importing the kernel modules would (they
# build jnp constants at import time).  AXIS mirrors sharded.AXIS.
AXIS = "shard"


def init_multihost(
    coordinator: str, num_processes: int, process_id: int
) -> None:
    """jax.distributed bring-up (idempotent per process).

    Must run before anything initializes the XLA backend — notably even
    jax.process_count()/jax.devices() count, so the already-initialized
    check reads the distributed client state directly."""
    if num_processes <= 1:
        return
    from jax._src import distributed as _dist

    if getattr(_dist.global_state, "client", None) is not None:
        return
    jax.distributed.initialize(
        coordinator, num_processes=num_processes, process_id=process_id
    )


def global_mesh(n_devices: Optional[int] = None) -> Mesh:
    """One-axis mesh over every device of every process."""
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (AXIS,))


def scatter_global(x_host: np.ndarray, mesh: Mesh) -> jax.Array:
    """Replicated host array -> global device array sharded on axis 0.

    Each process carves out the rows its addressable devices own; with one
    process this is a plain device put."""
    if jax.process_count() == 1:
        return jax.device_put(
            x_host, NamedSharding(mesh, P(AXIS))
        )
    from jax.experimental import multihost_utils

    D = mesh.devices.size
    n = x_host.shape[0]
    assert n % D == 0
    per = n // D
    local_dev_ids = {d.id for d in jax.local_devices()}
    blocks = [
        x_host[i * per : (i + 1) * per]
        for i, d in enumerate(mesh.devices.reshape(-1))
        if d.id in local_dev_ids
    ]
    local = np.concatenate(blocks)
    return multihost_utils.host_local_array_to_global_array(
        local, mesh, P(AXIS)
    )


def fetch_replicated(x: jax.Array) -> np.ndarray:
    """Global (possibly non-addressable) array -> identical host copy on
    every process."""
    if jax.process_count() == 1:
        return np.asarray(x)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))
