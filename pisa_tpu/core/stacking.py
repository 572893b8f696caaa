"""
Container stacking: collapse a pipeline's per-category event containers into
ONE container whose arrays carry a leading category axis.

Motivation: the reference pipeline model — and the eager path here — runs
every stage once per event category (12 containers on the IceCube-3y
flagship), so a compiled template contains ~12 copies of every per-event op
chain. Each copy is a small fusion whose fixed launch cost, not its FLOPs or
bandwidth, dominates the downstream stages and their reverse-mode
gradients. Stacking turns those 12 chains into ONE chain over ``(C, N)``
arrays: same FLOPs, ~12x fewer HLO ops.

Representation model
--------------------
A :class:`StackedContainer` holds, per key and representation, ONE array:

- events representation: shape ``(C, n_pad, ...)`` — one row per category,
  padded to the largest category size. Padding rules: coordinate keys pad
  with NaN (bin searches map NaN to the overflow sentinel, so padded events
  drop out of histograms and lookups); everything else pads with 0 so that
  ``weights *= anything`` stays 0 on padded slots.
- binned representations: shape ``(G, size, ...)`` where ``G`` may be less
  than ``C`` when several categories share the same physical values (the
  stacked analog of the reference's container *linking*,
  ``pisa/core/container.py:279``: e.g. oscillation probabilities depend only
  on (nubar, flavor) — 6 distinct rows serve 12 categories). A per-(key,
  rep) ``rows`` entry maps category -> row:

  * ``None`` — single shared array, no leading group axis (e.g. the common
    calc-grid geometry);
  * ``"cat"`` — leading axis IS the category axis (``G == C``, identity);
  * an int array ``(C,)`` — explicit category -> group-row map.

Per-category scalar aux data (``nubar``, ``flav``) is kept as ``(C,)``
arrays; stacked-aware stage code reads it via :meth:`StackedContainer.cat_aux`
and vectorizes with masks/gathers instead of per-container Python branches.

Stages opt in via ``supports_stacked`` / ``stacked_ok()`` (see
:class:`pisa_tpu.core.stage.Stage`); :class:`pisa_tpu.core.template.CompiledTemplate`
stacks only when every traced stage opted in, and falls back silently
otherwise — the eager pipeline path never stacks.
"""

from __future__ import annotations

import os

import numpy as np

import jax
import jax.numpy as jnp

from pisa_tpu import FTYPE
from pisa_tpu.core.binning import MultiDimBinning
from pisa_tpu.core.container import Container, ContainerSet, _rep_hash
from pisa_tpu.core import translation

__all__ = ["StackedContainer", "StackingError", "build_stacked_set"]


class StackingError(ValueError):
    """Raised when a ContainerSet cannot be stacked; callers fall back to
    the per-container path."""


def _expand_rows(values, rows, n_cats):
    """Per-category view of a stacked array: shape ``(C, ...)`` (or an array
    broadcastable against one, for shared values)."""
    if rows is None:
        return values
    if isinstance(rows, str) and rows == "cat":
        return values
    return jnp.asarray(values)[jnp.asarray(rows, dtype=jnp.int32)]


class StackedContainer(Container):
    """One container standing in for C per-category containers (see module
    docstring for the array/rows model)."""

    is_stacked = True

    def __init__(self, name, cat_names, n_pad, representation="events"):
        super().__init__(name, representation=representation)
        self.cat_names = list(cat_names)
        self.n_cats = len(self.cat_names)
        self.n_pad = int(n_pad)
        #: (key, rep_hash) -> None | "cat" | int array (C,)
        self.rows = {}
        #: aux key -> (C,) array for per-category scalars
        self._cat_aux = {}

    # -- aux -------------------------------------------------------------
    def cat_aux(self, key):
        """Per-category values of an aux scalar as a (C,) numpy array."""
        if key in self._cat_aux:
            return self._cat_aux[key]
        if key in self._aux_data:
            return np.asarray([self._aux_data[key]] * self.n_cats)
        raise KeyError(f"No aux data {key!r} in stacked container")

    def __getitem__(self, key):
        if key in self._cat_aux:
            return self._cat_aux[key]
        return super().__getitem__(key)

    def __contains__(self, key):
        return key in self._cat_aux or super().__contains__(key)

    @property
    def all_keys_incl_aux_data(self):
        return (
            self.all_keys
            + list(self._aux_data.keys())
            + list(self._cat_aux.keys())
        )

    # -- shape -----------------------------------------------------------
    @property
    def shape(self):
        if self.is_map:
            return self._representation.shape
        return (self.n_cats, self.n_pad)

    @property
    def size(self):
        if self.is_map:
            return self._representation.size
        return self.n_cats * self.n_pad

    # -- get / set -------------------------------------------------------
    def set_stacked(self, key, data, rows):
        """Store `data` for `key` in the CURRENT representation with an
        explicit category->row map (see module docstring)."""
        if rows is not None and not (isinstance(rows, str) and rows == "cat"):
            rows = np.asarray(rows, dtype=np.int32)
            if rows.shape != (self.n_cats,):
                raise ValueError(
                    f"rows must be (C,)={self.n_cats}; got {rows.shape}"
                )
        h = _rep_hash(self._representation)
        self._data.setdefault(key, {})[h] = data
        if key not in self.translation_modes:
            self.translation_modes[key] = (
                "sum" if key in self.sum_mode_keys else "average"
            )
        self.rows[(key, h)] = rows
        self.mark_changed(key)

    def __setitem__(self, key, data):
        """Plain writes infer the rows entry from the shape: events-rep
        writes must be (C, n_pad, ...) ('cat'); binned-rep writes are 'cat'
        when shaped (C, size, ...) and shared when shaped (size, ...)."""
        if key in self._cat_aux:
            raise KeyError(f"Key {key!r} is per-category aux data")
        if self.is_map and key in self._representation.names:
            raise ValueError(f"Cannot set {key!r}: it is a binning dimension")
        h = _rep_hash(self._representation)
        if self.is_map:
            size = self._representation.size
            bshape = tuple(self._representation.shape)
            shape = tuple(np.shape(data))
            # accept unflattened (C,)+bshape+extra or bshape+extra
            if shape[:1] == (self.n_cats,) and shape[1 : 1 + len(bshape)] == bshape:
                data = data.reshape((self.n_cats, size) + shape[1 + len(bshape):])
                shape = tuple(np.shape(data))
            elif shape[: len(bshape)] == bshape and shape[:1] != (size,):
                data = data.reshape((size,) + shape[len(bshape):])
                shape = tuple(np.shape(data))
            if shape[:2] == (self.n_cats, size):
                rows = "cat"
            elif shape[:1] == (size,):
                rows = None
            else:
                raise ValueError(
                    f"Ambiguous stacked binned write for {key!r}: shape"
                    f" {shape} vs C={self.n_cats}, size={size}; use"
                    " set_stacked(key, data, rows)"
                )
        else:
            shape = tuple(np.shape(data))
            if shape[:2] != (self.n_cats, self.n_pad):
                raise ValueError(
                    f"Stacked events write for {key!r} must be (C, n_pad,"
                    f" ...)=({self.n_cats}, {self.n_pad}, ...); got {shape}"
                )
            rows = "cat"
        self._data.setdefault(key, {})[h] = data
        if key not in self.translation_modes:
            self.translation_modes[key] = (
                "sum" if key in self.sum_mode_keys else "average"
            )
        self.rows[(key, h)] = rows
        self.mark_changed(key)

    def expanded(self, key):
        """Read `key` in the current representation with the category axis
        materialized (or broadcastable): shared -> raw array, grouped ->
        gathered (C, ...) view."""
        values = self[key]
        rows = self.rows.get((key, _rep_hash(self._representation)))
        return _expand_rows(values, rows, self.n_cats)

    # -- translation -------------------------------------------------------
    def translate(self, key, src_representation):
        dest = self._representation
        if _rep_hash(src_representation) == _rep_hash(dest):
            return
        mode = self.translation_modes.get(key, "average")
        from_map = isinstance(src_representation, MultiDimBinning)
        to_map = isinstance(dest, MultiDimBinning)
        src_h = _rep_hash(src_representation)
        values = self._data[key][src_h]
        rows = self.rows.get((key, src_h))

        if from_map and not to_map and mode == "average":
            out = self._stacked_binned_to_array(
                values, rows, src_representation
            )
        elif to_map and not from_map:
            out = self.stacked_histogram(
                values, dest, averaged=(mode == "average")
            )
        else:
            raise NotImplementedError(
                f"stacked translation {src_representation} -> {dest}"
                f" (mode={mode})"
            )
        dest_h = _rep_hash(dest)
        self._data[key][dest_h] = out
        self.rows[(key, dest_h)] = "cat"
        self.validity[key][dest_h] = True

    def _events_flat_indices(self, binning):
        """(C, n_pad) sanitized flat indices of the stacked events under
        `binning` (padded slots hit the out-of-range sentinel via their NaN
        coordinates)."""
        idx = self.cached_flat_indices(binning, events_rep="events")
        if idx is None:
            sample = self._sample_arrays("events", binning.names)
            idx = translation.sanitized_flat_indices(sample, binning)
        return idx

    def _stacked_binned_to_array(self, values, rows, src_binning):
        """'average'-mode binned -> events: per-category gather with the
        rows indirection folded into one flat gather.

        The gather's reverse-mode transpose is XLA's scatter-add of the
        event cotangents into the grid cells."""
        idx = self._events_flat_indices(src_binning)
        size = src_binning.size
        vals = jnp.asarray(values)

        # Static-index fast path: the event->cell indices are
        # parameter-independent, so the gather's reverse-mode transpose can
        # be a precomputed padded PULL (translation.build_pull_transpose)
        # instead of XLA's serialized scatter-add — measured 1.5 ms/eval of
        # the flagship gradient for the scatter vs HBM-bandwidth for the
        # pull. linear_call keeps forward-mode (Fisher jacfwd) working.
        if (
            not isinstance(idx, jax.core.Tracer)
            and os.environ.get("PISA_TPU_PULL_TRANSPOSE", "1")
            not in ("0", "off", "false")
        ):
            idx_np = np.asarray(idx)
            if rows is None:
                flat_tbl = vals
                gidx = np.where(idx_np >= size, -1, idx_np)
            else:
                if isinstance(rows, str) and rows == "cat":
                    rows_np = np.arange(self.n_cats, dtype=np.int64)
                else:
                    rows_np = np.asarray(rows, dtype=np.int64)
                flat_tbl = vals.reshape(
                    (vals.shape[0] * size,) + vals.shape[2:]
                )
                gidx = np.where(
                    idx_np >= size,
                    -1,
                    rows_np[:, None] * size + np.clip(idx_np, 0, size - 1),
                )
            M = int(flat_tbl.shape[0])
            if M * 32 <= 64_000_000:
                cache = getattr(self, "_pull_cache", None)
                if cache is None:
                    cache = self._pull_cache = {}
                import hashlib

                key = (
                    M,
                    gidx.shape,
                    hashlib.blake2b(
                        np.ascontiguousarray(gidx), digest_size=16
                    ).hexdigest(),
                )
                pull = cache.get(key)
                if pull is None:
                    pull = translation.build_pull_transpose(gidx, M)
                    cache[key] = pull
                return translation.gather_pull_transpose(
                    flat_tbl, gidx, pull
                )

        invalid = idx >= size
        safe = jnp.clip(idx, 0, size - 1)
        if rows is None:
            out = vals[safe]
        else:
            if isinstance(rows, str) and rows == "cat":
                rows_arr = jnp.arange(self.n_cats, dtype=jnp.int32)
            else:
                rows_arr = jnp.asarray(rows, dtype=jnp.int32)
            flat = vals.reshape((vals.shape[0] * size,) + vals.shape[2:])
            gidx = rows_arr[:, None] * size + safe
            out = flat[gidx]
        inv = invalid
        if out.ndim > inv.ndim:
            inv = inv.reshape(inv.shape + (1,) * (out.ndim - inv.ndim))
        return jnp.where(inv, 0.0, out)

    def stacked_histogram(self, values, binning, averaged=False):
        """(C, n_pad[, k]) event values -> (C, size[, k]) per-category
        histogram: one batched matmul against the cached stacked one-hot
        when available, otherwise one offset scatter-add."""
        w = jnp.asarray(values)
        matrix = self.cached_hist_matrix(binning, events_rep="events")
        if matrix is not None:
            return translation.histogram_matmul_stacked(w, matrix)
        idx = self._events_flat_indices(binning)
        size = binning.size
        C = self.n_cats
        # offset each category into its own (size+1) block; sentinel slots
        # land in the per-category drop bucket
        off = (
            jnp.arange(C, dtype=jnp.int32)[:, None] * (size + 1)
            + jnp.clip(idx, 0, size)
        ).ravel()
        flat_w = w.reshape((C * self.n_pad,) + w.shape[2:])
        out = (
            jnp.zeros((C * (size + 1),) + w.shape[2:], dtype=w.dtype)
            .at[off]
            .add(flat_w)
            .reshape((C, size + 1) + w.shape[2:])[:, :size]
        )
        if averaged:
            ones = jnp.ones((C * self.n_pad,), dtype=w.dtype)
            counts = (
                jnp.zeros((C * (size + 1),), dtype=w.dtype)
                .at[off]
                .add(ones)
                .reshape((C, size + 1))[:, :size]
            )
            if out.ndim > 2:
                counts = counts.reshape(counts.shape + (1,) * (out.ndim - 2))
            out = jnp.where(
                counts > 0, out / jnp.where(counts > 0, counts, 1.0), 0.0
            )
        return out

    def cached_hist_matrix(self, binning, events_rep=None, max_bins=None):
        """Stacked one-hot membership matrix (C, n_pad, size); padded and
        out-of-range events get all-zero rows. Budgeted on the TOTAL element
        count like the per-container version."""
        import os

        if max_bins is None:
            max_bins = int(
                os.environ.get("PISA_TPU_HIST_MATMUL_MAX_BINS", "512")
            )
        size = binning.size
        if size > max_bins:
            return None
        if events_rep is None:
            events_rep = self._representation
        key = (_rep_hash(events_rep), _rep_hash(binning), "hist_matrix")
        if key in self._flatidx:
            return self._flatidx[key]
        idx = self.cached_flat_indices(binning, events_rep=events_rep)
        if idx is None or isinstance(idx, jax.core.Tracer):
            return None
        max_elems = int(
            float(os.environ.get("PISA_TPU_HIST_MATMUL_MAX_ELEMS", "5e7"))
        )
        if max_elems and int(np.size(idx)) * size > max_elems:
            return None
        matrix = jax.nn.one_hot(idx, size, dtype=FTYPE)
        self._flatidx[key] = matrix
        self._flatidx_names[key] = tuple(binning.names)
        return matrix


# ---------------------------------------------------------------------------
# builder
# ---------------------------------------------------------------------------

_INT_KINDS = ("i", "u", "b")


def _events_size(container):
    ev_h = _rep_hash("events")
    for key, per in container._data.items():
        if ev_h in per and container.validity.get(key, {}).get(ev_h, False):
            return int(np.shape(per[ev_h])[0])
    raise StackingError(
        f"container {container.name!r} has no valid events-rep array"
    )


def _pad_stack(arrays, n_pad, pad_value):
    """Stack per-category arrays along a new leading axis, padding the event
    axis to n_pad with `pad_value`."""
    out = []
    for arr in arrays:
        arr = np.asarray(arr)
        n = arr.shape[0]
        if n < n_pad:
            pad = np.full((n_pad - n,) + arr.shape[1:], pad_value, arr.dtype)
            arr = np.concatenate([arr, pad], axis=0)
        out.append(arr)
    return np.stack(out, axis=0)


def _dedup_rows(arrays):
    """Group per-category arrays by identity (then by value): returns
    (unique_list, rows) with rows[c] = index into unique_list."""
    uniq = []
    uniq_ids = {}
    rows = np.empty(len(arrays), dtype=np.int32)
    for c, arr in enumerate(arrays):
        key = id(arr)
        if key in uniq_ids:
            rows[c] = uniq_ids[key]
            continue
        # value-level merge (e.g. distinct-but-equal numpy outputs written
        # per container by an unlinked stage)
        found = None
        for gi, rep_arr in enumerate(uniq):
            a, b = np.asarray(rep_arr), np.asarray(arr)
            if a.shape == b.shape and a.dtype == b.dtype and np.array_equal(
                a, b
            ):
                found = gi
                break
        if found is None:
            uniq.append(arr)
            found = len(uniq) - 1
        uniq_ids[key] = found
        rows[c] = found
    return uniq, rows


def build_stacked_set(container_set, coord_keys=(), name=None,
                      pad_multiple=1, exclude_keys=()):
    """Build a ContainerSet holding ONE StackedContainer standing in for all
    containers of `container_set` (which is NOT mutated).

    Parameters
    ----------
    container_set : ContainerSet
    coord_keys : collection of str
        Event keys that are binning coordinates (padded with NaN so padded
        events fall outside every binning); all other float keys pad with 0.
    pad_multiple : int
        Round the padded per-category event count up to a multiple of this
        (device-mesh size for sharded templates, so the stacked event axis
        partitions evenly; the extra slots follow the same NaN/0 padding
        rules and drop out of every reduction).
    exclude_keys : collection of str
        Keys omitted from the stacked copy (stages declare per-container
        helper arrays that cannot pad-stack via
        ``Stage.stacking_exclude_keys``).

    Raises
    ------
    StackingError
        When the containers are not structurally uniform enough to stack.
    """
    containers = list(container_set.containers)
    if len(containers) < 2:
        raise StackingError("nothing to stack (fewer than 2 containers)")
    if container_set.linked_containers:
        raise StackingError("cannot stack while containers are linked")

    key_sets = [tuple(sorted(c._data.keys())) for c in containers]
    if len(set(key_sets)) != 1:
        raise StackingError(
            f"containers have differing key sets: {sorted(set(key_sets))}"
        )
    aux_sets = [tuple(sorted(c._aux_data.keys())) for c in containers]
    if len(set(aux_sets)) != 1:
        raise StackingError("containers have differing aux-data keys")

    ev_h = _rep_hash("events")
    sizes = [_events_size(c) for c in containers]
    pad_multiple = max(1, int(pad_multiple))
    n_pad = -(-max(sizes) // pad_multiple) * pad_multiple

    sc = StackedContainer(
        name or container_set.name or "stacked",
        [c.name for c in containers],
        n_pad,
    )
    # register every representation any container knows
    reps = {}
    for c in containers:
        reps.update(c._representations)
    sc._representations.update(reps)

    coord_keys = set(coord_keys)
    exclude_keys = set(exclude_keys)
    first = containers[0]

    for key in first._data.keys():
        if key in exclude_keys:
            continue
        mode = first.translation_modes.get(key, None)
        if mode is not None:
            sc.translation_modes[key] = mode
        # representation hashes where every container has this key
        common_hashes = set(first._data[key].keys())
        for c in containers[1:]:
            common_hashes &= set(c._data[key].keys())
        for h in common_hashes:
            arrays = [c._data[key][h] for c in containers]
            valid = all(
                c.validity.get(key, {}).get(h, False) for c in containers
            )
            if h == ev_h:
                a0 = np.asarray(arrays[0])
                if a0.dtype.kind in _INT_KINDS:
                    pad_value = 0
                else:
                    pad_value = np.nan if key in coord_keys else 0
                stacked = _pad_stack(arrays, n_pad, pad_value)
                rows = "cat"
            else:
                uniq, rows_arr = _dedup_rows(arrays)
                if len(uniq) == 1:
                    stacked = uniq[0]
                    rows = None
                else:
                    shapes = {tuple(np.shape(a)) for a in uniq}
                    if len(shapes) != 1:
                        raise StackingError(
                            f"key {key!r}: mixed shapes {shapes} in binned"
                            " representation"
                        )
                    stacked = np.stack([np.asarray(a) for a in uniq], axis=0)
                    rows = (
                        "cat" if len(uniq) == len(containers) and np.all(
                            rows_arr == np.arange(len(containers))
                        ) else rows_arr
                    )
            sc._data.setdefault(key, {})[h] = stacked
            sc.rows[(key, h)] = rows
            sc.validity.setdefault(key, {})[h] = valid

    # aux data: shared scalars stay scalars; per-category values become (C,)
    for key in first._aux_data.keys():
        vals = [c._aux_data[key] for c in containers]
        try:
            uniform = all(v == vals[0] for v in vals[1:])
        except Exception:
            uniform = False
        if uniform:
            sc._aux_data[key] = vals[0]
        else:
            sc._cat_aux[key] = np.asarray(vals)

    out = ContainerSet(
        container_set.name, containers=[sc],
    )
    for k, v in container_set._glob_aux.items():
        out[k] = v
    return out
