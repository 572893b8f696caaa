"""
Multi-host (multi-process) distributed evaluation (SURVEY §5.8).

The reference's only cross-machine story is a farm of TCP llh servers with
pickle framing (``pisa/utils/llh_server.py:64-120``). The design
scales past one host with ``jax.distributed``: every process joins a
cluster through a coordinator, contributes its local devices to a GLOBAL
mesh, and the same SPMD template program runs across all of them — XLA
routes collectives over the links within a host (NVLink between cards)
and over the network between hosts; no pickle, no sockets in user code.

Usage (one call per process, before any other jax use):

    from pisa_tpu.parallel import multihost
    multihost.init_multihost("host0:8476", num_processes=4, process_id=i)
    mesh = multihost.global_mesh()
    arr = multihost.make_global_array(events, mesh)   # host-local -> global

Every process loads the same event files (PISA inputs are small — MC event
tables, not training corpora); :func:`make_global_array` then forms a
globally-sharded array in which each process only materializes its own
shard on its own devices. For single-process multi-DEVICE use, the plain
``pisa_tpu.parallel.default_mesh`` path is unchanged.

Tested end-to-end by ``tests/test_multihost.py``: two separate processes
form a jax.distributed cluster over localhost (the multi-host path on CPU
devices), evaluate an oscillation-probability histogram over a globally
sharded event axis, and reproduce the single-process result exactly.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "init_multihost",
    "global_mesh",
    "make_global_array",
    "process_local_slice",
]


def init_multihost(
    coordinator_address,
    num_processes,
    process_id,
    local_device_count=None,
):
    """Join (or create) the jax.distributed cluster.

    Call once per process before any other JAX API. `coordinator_address`
    is "host:port" of process 0. For CPU-based testing, set
    `local_device_count` to force that many virtual devices per process
    (must be set before the backend initializes).
    """
    import os

    if local_device_count is not None:
        flags = os.environ.get("XLA_FLAGS", "")
        if "--xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags
                + f" --xla_force_host_platform_device_count="
                f"{int(local_device_count)}"
            )
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=int(num_processes),
        process_id=int(process_id),
    )
    return jax.process_count(), jax.process_index()


def global_mesh(axis_name="data") -> Mesh:
    """A 1-D mesh over ALL devices of the cluster (every process's local
    devices, in process order)."""
    return Mesh(np.array(jax.devices()), axis_names=(axis_name,))


def process_local_slice(n_global, mesh, axis_name="data"):
    """(start, stop) of this process's contiguous block of a length-
    `n_global` leading axis sharded over `mesh`. Requires divisibility by
    the global device count."""
    n_dev = mesh.devices.size
    if n_global % n_dev != 0:
        raise ValueError(
            f"global length {n_global} not divisible by {n_dev} devices"
        )
    local = [d for d in mesh.devices.ravel() if d.process_index == jax.process_index()]
    per_dev = n_global // n_dev
    flat = list(mesh.devices.ravel())
    starts = [flat.index(d) * per_dev for d in local]
    return min(starts), max(starts) + per_dev


def make_global_array(host_array, mesh, axis_name="data"):
    """A globally-sharded jax.Array from a HOST-LOCAL full copy of the
    data: each process materializes only its own devices' shards
    (``jax.make_array_from_callback``), so device memory per host is
    1/num_processes of the global array.

    `host_array` must be identical on every process (PISA event tables are
    loaded identically everywhere). Arrays whose leading axis is not
    divisible by the global device count are replicated.
    """
    host_array = np.asarray(host_array)
    n_dev = mesh.devices.size
    if (
        host_array.ndim >= 1
        and host_array.shape[0] % n_dev == 0
        and host_array.shape[0] >= n_dev
    ):
        spec = P(axis_name, *([None] * (host_array.ndim - 1)))
    else:
        spec = P()
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(
        host_array.shape, sharding, lambda idx: host_array[idx]
    )
