"""
Device meshes and event-axis sharding for compiled templates.

See package docstring. Replaces the reference's multi-process llh server
farm (``pisa/utils/llh_server.py``, ``llh_client.py``) with in-program SPMD
over a ``jax.sharding.Mesh``.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pisa_tpu.utils.log import logging

__all__ = [
    "default_mesh",
    "shard_containers",
    "shard_stacked_containers",
    "build_batched_objective",
]


def default_mesh(n_devices=None, axis_name="data") -> Mesh:
    """A 1-D mesh over (the first `n_devices` of) the available devices."""
    devices = jax.devices()
    if n_devices is not None:
        if len(devices) < n_devices:
            raise RuntimeError(
                f"need {n_devices} devices; have {len(devices)}"
            )
        devices = devices[:n_devices]
    return Mesh(np.array(devices), axis_names=(axis_name,))


def _shard_array(arr, mesh, axis_name):
    """device_put `arr` sharded on its leading axis if compatible, else
    replicated. Returns the placed jax array."""
    arr = np.asarray(arr) if not isinstance(arr, jax.Array) else arr
    n = mesh.devices.size
    if np.ndim(arr) >= 1 and arr.shape[0] % n == 0 and arr.shape[0] >= n:
        spec = P(axis_name, *([None] * (np.ndim(arr) - 1)))
    else:
        spec = P()
    return jax.device_put(arr, NamedSharding(mesh, spec))


def _pad_container_events(container, n, coord_keys):
    """Pad every events-representation array of `container` so its event
    axis is a multiple of `n`, using the stacking padding rules: binning
    coordinates pad with NaN (bin searches map NaN to the out-of-range
    sentinel, so padded events drop out of every histogram and lookup),
    integer arrays pad with 0, everything else pads with 0 so that
    ``weights * anything`` stays 0 on padded slots. Cached flat-index /
    one-hot entries are dropped (their event shapes changed); callers
    repopulate them. No-op when already divisible."""
    from pisa_tpu.core.container import _rep_hash

    ev_h = _rep_hash("events")
    sizes = set()
    for per_rep in container._data.values():
        if ev_h in per_rep and np.ndim(per_rep[ev_h]) >= 1:
            sizes.add(int(np.shape(per_rep[ev_h])[0]))
    if not sizes:
        return
    if len(sizes) != 1:
        raise ValueError(
            f"container {container.name!r}: inconsistent events-axis sizes"
            f" {sorted(sizes)}"
        )
    n_events = sizes.pop()
    pad = (-n_events) % n
    if pad == 0:
        return
    coord_keys = set(coord_keys)
    for key, per_rep in container._data.items():
        if ev_h not in per_rep or np.ndim(per_rep[ev_h]) < 1:
            continue
        arr = np.asarray(per_rep[ev_h])
        if arr.dtype.kind in ("i", "u", "b"):
            fill = 0
        else:
            fill = np.nan if key in coord_keys else 0
        per_rep[ev_h] = np.concatenate(
            [arr, np.full((pad,) + arr.shape[1:], fill, arr.dtype)], axis=0
        )
    container._flatidx.clear()
    container._flatidx_names.clear()
    logging.debug(
        "container %s: padded events %d -> %d for %d-way sharding",
        container.name, n_events, n_events + pad, n,
    )


def shard_containers(data, mesh, axis_name="data", coord_keys=()):
    """Shard every array of every container in a ContainerSet across `mesh`
    on its leading (event/grid-point) axis.

    Events-representation arrays whose event axis is not divisible by the
    mesh size are first PADDED to the next multiple (NaN coordinates / zero
    weights, so the pad slots drop out of every reduction; see
    :func:`_pad_container_events`) — pass the binning-dimension names via
    `coord_keys` so coordinates pad with NaN. Other arrays with an
    indivisible leading axis are replicated (with a debug log). After this,
    any computation traced over the containers — in particular a
    :class:`CompiledTemplate` — is partitioned by XLA across the mesh
    devices.
    """
    n = mesh.devices.size
    for container in data.containers:
        _pad_container_events(container, n, coord_keys)
        for key, per_rep in container._data.items():
            for rep_hash, arr in per_rep.items():
                if key.startswith("osc_blk_"):
                    # prepared chain-kernel geometry: layer-major slabs and
                    # per-block bounds, not point-leading arrays; replicate
                    per_rep[rep_hash] = jax.device_put(
                        np.asarray(arr)
                        if not isinstance(arr, jax.Array)
                        else arr,
                        NamedSharding(mesh, P()),
                    )
                    continue
                if np.ndim(arr) >= 1 and arr.shape[0] % n != 0:
                    logging.debug(
                        "container %s key %s: leading axis %d not divisible"
                        " by %d devices; replicating",
                        container.name, key, arr.shape[0], n,
                    )
                per_rep[rep_hash] = _shard_array(arr, mesh, axis_name)
        # cached translation indices are per-event too: shard them the same
        # way so gathers stay local to each shard
        for cache_key, arr in container._flatidx.items():
            container._flatidx[cache_key] = _shard_array(
                arr, mesh, axis_name
            )


def shard_stacked_containers(
    data, mesh, axis_name="data", shard_grid=True, grid_min=8192
):
    """Shard a STACKED ContainerSet (one :class:`StackedContainer` standing
    in for the per-category containers; see ``pisa_tpu/core/stacking.py``)
    across `mesh`, so the category-stacked production program IS the
    multi-device program:

    - events-representation arrays ``(C, n_pad, ...)`` partition on the
      padded event axis (axis 1). ``n_pad`` must be divisible by the mesh
      size — ``build_stacked_set(pad_multiple=mesh_size)`` guarantees it,
      and the pad slots carry NaN coordinates / zero weights so they drop
      out of every reduction.
    - shared binned arrays (``rows=None``, shape ``(size, ...)``) with a
      large (>= `grid_min`) divisible leading axis partition on the
      grid-point axis, EXCEPT flat-compaction index sets and the prepared
      chain-kernel geometry (``osc_blk_*``), which replicate; the
      container is marked ``grid_sharded`` so the oscillation stage drops
      the compacted-gather formulation (its flat indices are global over
      the (point, layer) space and would force cross-shard gathers) in
      favor of the purely elementwise XLA one, which GSPMD partitions
      cleanly over the grid axis.
    - grouped binned arrays ``(G, size, ...)`` partition on the size axis
      when it matches a sharded grid size; everything else replicates.
    - cached flat indices / one-hot histogram matrices ``(C, n_pad, ...)``
      partition on the event axis like the arrays they index.

    Each container records the mesh (``mesh``, ``mesh_axis``), so the
    oscillation stage runs its GPU chain kernel under ``shard_map`` over
    the replicated geometry (each device propagates its share of the
    points) instead of letting XLA replicate the kernel call.
    """
    n = mesh.devices.size
    # index sets whose values are GLOBAL flat indices over (point, layer):
    # their consumers must not see sharded operands (prob3._propagate skips
    # them when the container is marked grid_sharded)
    global_index_keys = ("layer_slot_index",)
    for sc in data.containers:
        if not getattr(sc, "is_stacked", False):
            raise ValueError(
                f"container {sc.name!r} is not stacked; use shard_containers"
            )
        n_cats, n_pad = sc.n_cats, sc.n_pad
        if n_pad % n != 0:
            raise ValueError(
                f"stacked event padding n_pad={n_pad} is not divisible by"
                f" the {n}-device mesh; rebuild the stacked set with"
                " build_stacked_set(pad_multiple=mesh_size)"
            )
        # first pass: which shared grid sizes get sharded
        grid_sizes = set()
        if shard_grid:
            for key, per_rep in sc._data.items():
                for h, arr in per_rep.items():
                    shape = np.shape(arr)
                    if (
                        sc.rows.get((key, h)) is None
                        and len(shape) >= 1
                        and shape[0] >= grid_min
                        and shape[0] % n == 0
                        and not key.startswith("osc_blk_")
                        and key not in global_index_keys
                    ):
                        grid_sizes.add(shape[0])
        for key, per_rep in sc._data.items():
            for h, arr in per_rep.items():
                rows = sc.rows.get((key, h))
                shape = np.shape(arr)
                spec = P()
                if (
                    isinstance(rows, str)
                    and rows == "cat"
                    and len(shape) >= 2
                    and shape[0] == n_cats
                    and shape[1] == n_pad
                ):
                    spec = P(None, axis_name, *([None] * (len(shape) - 2)))
                elif (
                    rows is None
                    and len(shape) >= 1
                    and shape[0] in grid_sizes
                    and not key.startswith("osc_blk_")
                    and key not in global_index_keys
                ):
                    spec = P(axis_name, *([None] * (len(shape) - 1)))
                elif (
                    rows is not None
                    and not isinstance(rows, str)
                    and len(shape) >= 2
                    and shape[1] in grid_sizes
                ):
                    spec = P(None, axis_name, *([None] * (len(shape) - 2)))
                per_rep[h] = jax.device_put(
                    np.asarray(arr) if not isinstance(arr, jax.Array)
                    else arr,
                    NamedSharding(mesh, spec),
                )
        for cache_key, arr in sc._flatidx.items():
            shape = np.shape(arr)
            if len(shape) >= 2 and shape[0] == n_cats and shape[1] == n_pad:
                spec = P(None, axis_name, *([None] * (len(shape) - 2)))
            else:
                spec = P()
            sc._flatidx[cache_key] = jax.device_put(
                np.asarray(arr) if not isinstance(arr, jax.Array) else arr,
                NamedSharding(mesh, spec),
            )
        if shard_grid and grid_sizes:
            sc.grid_sharded = True
        sc.mesh = mesh
        sc.mesh_axis = axis_name
        logging.debug(
            "stacked container %s sharded over %d devices (n_pad=%d,"
            " grid sizes %s)", sc.name, n, n_pad, sorted(grid_sizes),
        )


def build_batched_objective(
    compiled_template, data_dist, metric, mesh=None, axis_name="data",
    priors=True,
):
    """Batched objective over many parameter vectors at once — the
    replacement for the reference's llh-server farm serving emcee walkers
    (``llh_server.py:64``): one vmapped evaluation, batch axis sharded
    across the mesh.

    Returns a jitted ``(B, n_free) -> (B,)`` callable (minimization sign
    convention, as :meth:`CompiledTemplate.build_objective`).
    """
    value_only, _ = compiled_template.build_objective(
        data_dist, metric, priors=priors
    )
    # raw (un-jitted) objective (vec, los, his, data): vmap over the walker
    # axis only; bounds and container data stay non-mapped arguments (so the
    # big event arrays are device buffers, not re-embedded constants)
    raw = value_only.raw

    batched = jax.vmap(raw, in_axes=(0, None, None, None))
    if mesh is None:
        jitted = jax.jit(batched)
    else:
        sharding = NamedSharding(mesh, P(axis_name, None))
        out_sharding = NamedSharding(mesh, P(axis_name))
        jitted = jax.jit(
            batched,
            in_shardings=(sharding, None, None, None),
            out_shardings=out_sharding,
        )

    def batched_objective(vecs):
        los, his = compiled_template._current_bounds()
        return jitted(
            jnp.asarray(vecs), jnp.asarray(los), jnp.asarray(his),
            compiled_template._data_vals,
        )

    # the jitted (vecs, los, his, data) program, for lowering/inspection
    batched_objective.jitted = jitted
    return batched_objective
