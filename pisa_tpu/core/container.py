"""
Containers: per-event-category data with multiple simultaneous
representations (event arrays and any number of binned grids), lazily
translated via the JAX translation kernels.

Rebuild of reference ``pisa/core/container.py:199,363,451``. Key semantics
preserved:

- a variable lives in one or more representations; reading it in an invalid
  representation triggers auto-translation from a valid one
- per-variable translation mode 'average' (values, e.g. probabilities) or
  'sum' (additive weights) — cf. reference docstring ``container.py:73-90``
- aux data (scalars like nubar/flav) available in every representation
- reading a binning-dimension name in a binned representation returns the
  unrolled weighted-center grid
- ``link_containers`` groups physically-identical containers so shared
  quantities are computed once (``VirtualContainer``)

Deltas from the reference: no 'log_events' representation (the
JAX lookup kernels use one uniform search path), and arrays may be jax
device arrays so stage code can be traced into a single compiled template
function.
"""

from __future__ import annotations

import numpy as np

from pisa_tpu import FTYPE
from pisa_tpu.core.binning import MultiDimBinning
from pisa_tpu.core.map import Map, MapSet
from pisa_tpu.core import translation

__all__ = ["Container", "ContainerSet", "VirtualContainer"]


def _rep_hash(rep):
    return hash(rep)


#: When not None, a list collecting (container, events_rep, binning) triples
#: for flat-index cache misses hit while coordinates were JAX tracers (i.e.
#: during template tracing, when the cache cannot be populated). The template
#: compiler installs a list here during its discovery pass, then populates
#: the caches concretely and re-traces. See CompiledTemplate.
_FLATIDX_RECORDER = None


class Container:
    """Data for one event category ('nue_cc', ...).

    Parameters
    ----------
    name : str
    representation : 'events' or MultiDimBinning
    """

    valid_translation_modes = ("average", "sum")
    #: variables that default to 'sum' translation (additive quantities)
    sum_mode_keys = ("weights", "initial_weights", "astro_weights", "errors")

    def __init__(self, name, representation="events"):
        self.name = str(name)
        self._representations = {}
        self._data = {}  # key -> {rep_hash: array}
        self.validity = {}  # key -> {rep_hash: bool}
        self.translation_modes = {}
        self._aux_data = {}
        self.linked = False
        self._representation = None
        #: (events_rep_hash, binning_hash) -> int32 sanitized flat indices;
        #: param-independent, so cached across template evaluations (and fed
        #: to the compiled template as explicit device arguments)
        self._flatidx = {}
        #: cache key -> coordinate names the entry depends on (for
        #: invalidation when a stage rewrites a coordinate, e.g.
        #: reco.resolutions scaling reco variables by a fit param)
        self._flatidx_names = {}
        self.representation = representation

    # -- representation handling --------------------------------------------
    @property
    def representation(self):
        return self._representation

    @representation.setter
    def representation(self, rep):
        if not (isinstance(rep, MultiDimBinning) or rep == "events"):
            raise ValueError(
                f"Representation must be 'events' or a MultiDimBinning; got"
                f" {rep!r}"
            )
        self._representations[_rep_hash(rep)] = rep
        self._representation = rep

    @property
    def is_map(self):
        return isinstance(self._representation, MultiDimBinning)

    @property
    def representations(self):
        return tuple(self._representations.values())

    @property
    def representation_keys(self):
        return tuple(self._representations.keys())

    @property
    def shape(self):
        if self.is_map:
            return self._representation.shape
        for per_rep in self._data.values():
            arr = per_rep.get(_rep_hash(self._representation))
            if arr is not None:
                return (np.shape(arr)[0],)
        return None

    @property
    def size(self):
        if self.is_map:
            return self._representation.size
        shape = self.shape
        return None if shape is None else int(np.prod(shape))

    @property
    def num_dims(self):
        return self._representation.num_dims if self.is_map else 1

    # -- keys ----------------------------------------------------------------
    @property
    def keys(self):
        """Variables valid in the current representation (plus binning dims
        when binned)."""
        h = _rep_hash(self._representation)
        out = [
            k
            for k, validity in self.validity.items()
            if validity.get(h, False)
        ]
        if self.is_map:
            out.extend(self._representation.names)
        return out

    @property
    def all_keys(self):
        return list(self._data.keys())

    @property
    def all_keys_incl_aux_data(self):
        return self.all_keys + list(self._aux_data.keys())

    @property
    def keys_incl_aux_data(self):
        return self.keys + list(self._aux_data.keys())

    def __contains__(self, key):
        return key in self._data or key in self._aux_data

    def __iter__(self):
        return iter(self.keys)

    # -- aux data -------------------------------------------------------------
    def set_aux_data(self, key, val):
        """Representation-independent scalar metadata (e.g. nubar, flav)."""
        if key in self._data:
            raise KeyError(f"Key {key!r} already used for a variable")
        self._aux_data[key] = val

    # -- get / set ------------------------------------------------------------
    def __getitem__(self, key):
        if self.is_map and key in self._representation.names:
            return self.unroll_binning(key, self._representation)
        if key not in self._data:
            if key in self._aux_data:
                return self._aux_data[key]
            raise KeyError(
                f"Key {key!r} not in Container {self.name!r}; have"
                f" {self.all_keys_incl_aux_data}"
            )
        h = _rep_hash(self._representation)
        if not self.validity[key].get(h, False):
            self.auto_translate(key)
        return self._data[key][h]

    def __setitem__(self, key, data):
        if self.is_map and key in self._representation.names:
            raise ValueError(
                f"Cannot set {key!r}: it is a binning dimension"
            )
        if key in self._aux_data:
            raise KeyError(f"Key {key!r} is aux data; cannot set as variable")
        if not self.is_map:
            data = np.asarray(data) if isinstance(data, (list, tuple)) else data
        h = _rep_hash(self._representation)
        self._data.setdefault(key, {})[h] = self._flatten(data)
        if key not in self.translation_modes:
            self.translation_modes[key] = (
                "sum" if key in self.sum_mode_keys else "average"
            )
        self.mark_changed(key)

    def _flatten(self, data):
        if isinstance(data, Map):
            return data.hist.ravel()
        if self.is_map:
            shape = np.shape(data)
            bshape = self._representation.shape
            if shape[: len(bshape)] == bshape:
                extra = shape[len(bshape) :]
                return np.reshape(data, (-1,) + tuple(extra)) if isinstance(
                    data, np.ndarray
                ) else data.reshape((-1,) + tuple(extra))
        return data

    def mark_changed(self, key):
        """Current representation becomes the only valid one for `key`."""
        h = _rep_hash(self._representation)
        self.validity[key] = {h: True}
        # a rewritten coordinate invalidates flat-index caches built on it
        if self._flatidx:
            stale = [
                k
                for k, names in self._flatidx_names.items()
                if key in names and k in self._flatidx
            ]
            for k in stale:
                del self._flatidx[k]

    def mark_valid(self, key):
        self.validity.setdefault(key, {})[_rep_hash(self._representation)] = True

    @staticmethod
    def unroll_binning(key, binning):
        grid = binning.meshgrid(entity="weighted_centers", attach_units=False)
        return grid[binning.index(key)].ravel()

    # -- translation ----------------------------------------------------------
    def auto_translate(self, key):
        if key not in self._data:
            raise KeyError(f"Key {key!r} not in Container {self.name!r}")
        src = None
        for h, valid in self.validity[key].items():
            if valid:
                src = self._representations[h]
                break
        if src is None:
            raise ValueError(f"No valid representation for {key!r}")
        self.translate(key, src)

    def translate(self, key, src_representation):
        """Translate `key` from `src_representation` into the current one;
        both end up valid (cf. reference ``container.py:806``)."""
        dest = self._representation
        if _rep_hash(src_representation) == _rep_hash(dest):
            return
        mode = self.translation_modes.get(key, "average")
        from_map = isinstance(src_representation, MultiDimBinning)
        to_map = isinstance(dest, MultiDimBinning)
        src_h = _rep_hash(src_representation)
        values = self._data[key][src_h]

        if mode == "average":
            if from_map and to_map:
                out = self._resample(key, src_representation, dest)
            elif to_map:
                out = self._array_to_binned(
                    values, src_representation, dest, averaged=True
                )
            elif from_map:
                out = self._binned_to_array(values, src_representation, dest)
            else:
                raise NotImplementedError(
                    f"average translation {src_representation} -> {dest}"
                )
        elif mode == "sum":
            if to_map and not from_map:
                out = self._array_to_binned(
                    values, src_representation, dest, averaged=False
                )
            else:
                raise NotImplementedError(
                    f"sum translation {src_representation} -> {dest}"
                )
        else:
            raise ValueError(f"Unknown translation mode {mode!r}")

        self._data[key][_rep_hash(dest)] = out
        self.validity[key][_rep_hash(dest)] = True

    def _sample_arrays(self, rep, names):
        """Coordinate arrays for `names` as seen in representation `rep`."""
        prev = self._representation
        self._representation = rep
        try:
            return [self[n] for n in names]
        finally:
            self._representation = prev

    def cached_flat_indices(self, binning, events_rep=None):
        """Sanitized flat bin indices of this container's events under
        `binning`, cached across calls (the indices are param-independent;
        recomputing the per-dimension bin searches per template evaluation
        measured ~35 ms/template on the IceCube-3y pipeline).

        Returns None when the cache is cold and the coordinates are JAX
        tracers (inside a template trace) — callers then fall back to
        computing indices inline, and the miss is recorded for the template
        compiler's discovery pass.
        """
        import jax

        if events_rep is None:
            events_rep = self._representation
        key = (_rep_hash(events_rep), _rep_hash(binning))
        if key in self._flatidx:
            return self._flatidx[key]
        sample = self._sample_arrays(events_rep, binning.names)
        if any(isinstance(a, jax.core.Tracer) for a in sample):
            if _FLATIDX_RECORDER is not None:
                _FLATIDX_RECORDER.append((self, events_rep, binning))
            return None
        idx = translation.sanitized_flat_indices(sample, binning)
        self._flatidx[key] = idx
        self._flatidx_names[key] = tuple(binning.names)
        return idx

    def cached_hist_matrix(self, binning, events_rep=None, max_bins=None):
        """Dense one-hot ``(n_events, binning.size)`` bin-membership matrix
        (FTYPE; out-of-range events get an all-zero row), cached like
        :meth:`cached_flat_indices` so :class:`CompiledTemplate` feeds it to
        the traced program as a device *argument*.

        ``weights @ matrix`` is then the histogram as one dense matmul
        (:func:`pisa_tpu.core.translation.histogram_matmul`) instead of a
        scatter-add.

        Returns None (callers fall back to the scatter histogram) when the
        cache is cold under tracing, or when the dense matrix would be
        unreasonably large: ``binning.size > max_bins`` (default 512 bins,
        env ``PISA_TPU_HIST_MATMUL_MAX_BINS``; 0 disables) OR total element
        count ``n_events * binning.size`` above the per-container budget
        (default 5e7 elements = 200 MB fp32, env
        ``PISA_TPU_HIST_MATMUL_MAX_ELEMS``) — a million-event container at
        512 bins would otherwise device_put a 2 GB one-hot per container.
        """
        import os

        import jax

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
        if max_elems and int(np.shape(idx)[0]) * size > max_elems:
            return None
        matrix = jax.nn.one_hot(idx, size, dtype=FTYPE)
        self._flatidx[key] = matrix
        self._flatidx_names[key] = tuple(binning.names)
        return matrix

    def _array_to_binned(self, values, src_rep, dest_binning, averaged=True):
        idx = (
            self.cached_flat_indices(dest_binning, events_rep=src_rep)
            if not isinstance(src_rep, MultiDimBinning)
            else None
        )
        sample = self._sample_arrays(src_rep, dest_binning.names)
        hist = translation.histogram(
            sample, values, dest_binning, averaged=averaged, idx=idx
        )
        return hist

    def _binned_to_array(self, values, src_binning, dest_rep):
        idx = (
            self.cached_flat_indices(src_binning, events_rep=dest_rep)
            if not isinstance(dest_rep, MultiDimBinning)
            else None
        )
        sample = self._sample_arrays(dest_rep, src_binning.names)
        return translation.lookup(sample, values, src_binning, idx=idx)

    def _resample(self, key, src_binning, dest_binning):
        old_sample = self._sample_arrays(src_binning, src_binning.names)
        new_sample = self._sample_arrays(dest_binning, dest_binning.names)
        weights = self._data[key][_rep_hash(src_binning)]
        return translation.resample(
            weights, old_sample, src_binning, new_sample, dest_binning
        )

    # Public API parity with reference
    def array_to_binned(self, key, src_representation, dest_representation, averaged=True):
        values = self._data[key][_rep_hash(src_representation)]
        return self._array_to_binned(
            values, src_representation, dest_representation, averaged=averaged
        )

    def binned_to_array(self, key, src_representation, dest_representation):
        values = self._data[key][_rep_hash(src_representation)]
        return self._binned_to_array(
            values, src_representation, dest_representation
        )

    def resample(self, key, src_representation, dest_representation):
        return self._resample(key, src_representation, dest_representation)

    # -- outputs --------------------------------------------------------------
    def get_hist(self, key):
        """(ndarray reshaped to binning shape, binning)."""
        if not self.is_map:
            raise ValueError("Cannot retrieve hists from non-map data")
        data = np.asarray(self[key])
        binning = self._representation
        if data.ndim > 1:
            return data.reshape(tuple(binning.shape) + (-1,)), binning
        return data.reshape(binning.shape), binning

    def get_map(self, key, error=None):
        hist, binning = self.get_hist(key)
        error_hist = None
        if error is not None:
            error_hist = np.abs(self.get_hist(error)[0])
        return Map(
            name=self.name, hist=hist, error_hist=error_hist, binning=binning
        )

    def get_keep_mask(self, cut_expression):
        """Boolean mask from a cut expression over event variables, e.g.
        ``"(pid >= -3) & (true_energy > 1)"`` (cf. reference
        ``container.py:1014``; evaluated in a restricted namespace)."""
        names = {}
        for key in self.all_keys_incl_aux_data:
            try:
                names[key] = np.asarray(self[key])
            except (KeyError, ValueError):
                continue
        names["np"] = np
        mask = eval(  # noqa: S307 - namespace restricted to event arrays
            cut_expression, {"__builtins__": {}}, names
        )
        return np.asarray(mask, dtype=bool)

    def keep(self, keep_mask):
        """Apply a boolean mask to all event arrays (events rep only)."""
        if self.is_map:
            raise ValueError("Cannot apply event mask in binned representation")
        h = _rep_hash(self._representation)
        keep_mask = np.asarray(keep_mask, dtype=bool)
        for key, per_rep in self._data.items():
            if h in per_rep and self.validity[key].get(h, False):
                per_rep[h] = np.asarray(per_rep[h])[keep_mask]
                self.validity[key] = {h: True}

    def __str__(self):
        return (
            f"Container('{self.name}', rep="
            f"{'binned' + str(self._representation.shape) if self.is_map else 'events'},"
            f" keys={self.all_keys})"
        )

    __repr__ = __str__


class VirtualContainer:
    """Proxy over several linked, physically-identical containers: reads come
    from the first, writes go to all (cf. reference ``container.py:363``)."""

    def __init__(self, name, containers):
        self.name = name
        first = containers[0]
        for c in containers[1:]:
            if c.size != first.size:
                raise ValueError(
                    f"Cannot link containers of different sizes:"
                    f" {c.name}({c.size}) vs {first.name}({first.size})"
                )
        self.containers = list(containers)
        for c in self.containers:
            c.linked = True

    def unlink(self):
        for c in self.containers:
            c.linked = False

    @property
    def representation(self):
        return self.containers[0].representation

    @representation.setter
    def representation(self, rep):
        for c in self.containers:
            c.representation = rep

    @property
    def is_map(self):
        return self.containers[0].is_map

    @property
    def size(self):
        return self.containers[0].size

    @property
    def shape(self):
        return self.containers[0].shape

    def __getitem__(self, key):
        return self.containers[0][key]

    def __setitem__(self, key, value):
        for c in self.containers:
            c[key] = value

    def set_aux_data(self, key, val):
        for c in self.containers:
            c.set_aux_data(key, val)

    def mark_changed(self, key):
        for c in self.containers:
            c.mark_changed(key)

    def mark_valid(self, key):
        for c in self.containers:
            c.mark_valid(key)

    def __contains__(self, key):
        return key in self.containers[0]

    def __str__(self):
        return f"VirtualContainer('{self.name}', {[c.name for c in self.containers]})"

    __repr__ = __str__


class ContainerSet:
    """Collection of containers (one per event category) shared by all stages
    of a pipeline (cf. reference ``container.py:199``)."""

    def __init__(self, name, containers=None, representation=None):
        self.name = name
        self.linked_containers = []
        self.containers = []
        if containers:
            for c in containers:
                self.add_container(c)
        if representation is not None:
            self.representation = representation
        self._glob_aux = {}

    def add_container(self, container):
        if container.name in self.names:
            raise ValueError(
                f"Container {container.name!r} already in set {self.names}"
            )
        self.containers.append(container)

    @property
    def names(self):
        return [c.name for c in self.containers]

    def __iter__(self):
        """Iterate linked (virtual) containers once plus unlinked ones."""
        if self.linked_containers:
            linked_names = {
                c.name for vc in self.linked_containers for c in vc.containers
            }
            out = list(self.linked_containers) + [
                c for c in self.containers if c.name not in linked_names
            ]
            return iter(out)
        return iter(self.containers)

    def __len__(self):
        return len(self.containers)

    def __getitem__(self, key):
        if isinstance(key, int):
            return self.containers[key]
        for c in self.containers:
            if c.name == key:
                return c
        if key in self._glob_aux:
            return self._glob_aux[key]
        raise KeyError(f"No container or global aux {key!r}; have {self.names}")

    def __setitem__(self, key, value):
        """Global auxiliary data shared by all stages (e.g. 'output_binning';
        cf. reference ``container.py:323``)."""
        self._glob_aux[key] = value

    def get_shared_keys(self, rep_indep=True):
        if not self.containers:
            return ()
        keys = None
        for c in self.containers:
            ck = set(
                c.all_keys_incl_aux_data if rep_indep else c.keys_incl_aux_data
            )
            keys = ck if keys is None else keys & ck
        return tuple(sorted(keys))

    # -- representation -------------------------------------------------------
    @property
    def representation(self):
        reps = {id(c.representation): c.representation for c in self.containers}
        if len(reps) == 1:
            return next(iter(reps.values()))
        # fall back: all equal by hash?
        hs = {_rep_hash(c.representation) for c in self.containers}
        if len(hs) == 1:
            return self.containers[0].representation
        raise ValueError("Containers have mixed representations")

    @representation.setter
    def representation(self, rep):
        for c in self.containers:
            c.representation = rep

    @property
    def is_map(self):
        return all(c.is_map for c in self.containers)

    # -- linking --------------------------------------------------------------
    def link_containers(self, key, names):
        """Link containers `names` under a VirtualContainer called `key`
        (cf. reference ``container.py:279``)."""
        containers = [self[n] for n in names if n in self.names]
        if not containers:
            return
        self.linked_containers.append(VirtualContainer(key, containers))

    def unlink_containers(self):
        for vc in self.linked_containers:
            vc.unlink()
        self.linked_containers = []

    # -- outputs --------------------------------------------------------------
    def get_mapset(self, key, error=None):
        """One Map per container in the current (binned) representation
        (cf. reference ``container.py:339``)."""
        maps = [c.get_map(key, error=error) for c in self.containers]
        return MapSet(maps, name=self.name)

    def __str__(self):
        return f"ContainerSet('{self.name}', {self.names})"

    __repr__ = __str__
