"""Active-mesh context: opt whole pipelines into mesh execution.

The reference distributes work by wiring process topology through every
call site (file-based match logs + per-LCB task splits,
src/mauveAligner.cpp:533-589,723-744).  The analog here is ambient:
a model enters `use_mesh(mesh)` once, and every batched kernel underneath
(K3 Gotoh closure, K4 HMM decode) consults `active_mesh()` and shard-maps
its batch dimension over the mesh.  Per-element kernels shard losslessly,
so mesh output is bit-identical to single-device output.

Thread-local so concurrent node merges (models/tree_progressive.py) can
run under different meshes — or none — without interference; worker pools
must propagate the mesh explicitly (capture `active_mesh()` at submit time,
re-enter `use_mesh` in the worker).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

_state = threading.local()


def active_mesh() -> Optional[object]:
    """The mesh batched kernels should shard over, or None."""
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh: Optional[object]):
    """Make `mesh` the ambient mesh for this thread.  None is a no-op (the
    enclosing mesh, if any, stays active — so an un-meshed inner aligner
    inside a meshed pipeline still shards its kernels)."""
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh if mesh is not None else prev
    try:
        yield
    finally:
        _state.mesh = prev


def shard_batched_call_async(kernel, batch_arrays, replicated_args=(), mesh=None):
    """Dispatch `kernel(*batch_arrays, *replicated_args)` -> [B, ...] under
    the active mesh (batch axis sharded, replicated_args broadcast), padding
    the batch to a multiple of the mesh size with zero rows; without a mesh,
    call the kernel directly.  Returns a zero-arg `fetch()` closure that
    downloads and trims to B.

    Dispatch is asynchronous on every backend here, but a download
    (np.asarray) BLOCKS until the device is done — so drivers with many
    bucket launches dispatch them all first and fetch afterwards, paying one
    pipeline-fill latency instead of one round trip per launch.

    The kernel must be per-batch-element independent and treat zero-padded
    rows as inert (our DP/HMM kernels gate on per-element lengths, and a
    zero length disables every emission) — then sharded results are
    bit-identical to the direct call.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P

    from mauvealigner_tpu.parallel.sharded import AXIS

    if mesh is None:
        mesh = active_mesh()
    B = int(batch_arrays[0].shape[0])
    if mesh is None:
        out = kernel(*batch_arrays, *replicated_args)
        return lambda: np.asarray(out)
    D = int(mesh.devices.size)
    pad = (-B) % D
    if pad:
        batch_arrays = [
            jnp.concatenate(
                [jnp.asarray(a),
                 jnp.zeros((pad,) + tuple(a.shape[1:]), jnp.asarray(a).dtype)]
            )
            for a in batch_arrays
        ]
    specs_in = tuple([P(AXIS)] * len(batch_arrays) + [P()] * len(replicated_args))
    out = jax.shard_map(
        kernel,
        mesh=mesh,
        in_specs=specs_in,
        out_specs=P(AXIS),
        check_vma=False,
    )(*batch_arrays, *replicated_args)
    return lambda: np.asarray(out)[:B]


def shard_batched_call(kernel, batch_arrays, replicated_args=(), mesh=None):
    """Blocking shard_batched_call_async: returns the host np.ndarray."""
    return shard_batched_call_async(kernel, batch_arrays, replicated_args, mesh)()
