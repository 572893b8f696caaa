"""
Multi-device evaluation (SURVEY §5.8).

The reference scales template/llh evaluation with a farm of forked TCP
socket servers (``pisa/utils/llh_server.py:64-120``). The
replacement is in-program SPMD:

- :func:`default_mesh` — build a 1-D ``jax.sharding.Mesh`` over the
  available devices.
- :meth:`CompiledTemplate.shard` (via :func:`shard_containers`) — shard the
  event/grid axis of every container array across the mesh; XLA then
  partitions the whole compiled template program (oscillation chains, weight
  ops, histogram) over the mesh, inserting the collectives (psum for
  the binned reductions, all-gathers for grid->event lookups).
- :func:`build_batched_objective` — the llh-server use case (parallel MCMC
  walkers / scan points): a vmapped objective whose *batch* axis is sharded
  across the mesh, one full template evaluation per walker per device.
"""

from pisa_tpu.parallel.sharding import (
    build_batched_objective,
    default_mesh,
    shard_containers,
    shard_stacked_containers,
)
from pisa_tpu.parallel import multihost

__all__ = [
    "default_mesh",
    "shard_containers",
    "shard_stacked_containers",
    "build_batched_objective",
    "multihost",
]
