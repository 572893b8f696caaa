"""
Histogram binning structures: OneDimBinning, MultiDimBinning, VarBinning.

Rebuild of reference ``pisa/core/binning.py:142,1484,3043``. These
are immutable, hashable host-side objects: inside jitted code only their
``edge`` arrays (plain numpy/jax arrays, static shapes) appear. Unit handling
follows the reference: bin edges are unit-tagged at the API boundary and
stripped to magnitudes for compute.
"""

from __future__ import annotations

import re
from functools import cached_property

import numpy as np

from pisa_tpu import FTYPE, HASH_SIGFIGS, ureg
from pisa_tpu.units import Quantity, Unit
from pisa_tpu.utils.hash import hash_obj

__all__ = ["OneDimBinning", "MultiDimBinning", "VarBinning"]


NAME_FIXES = (("true", "true_"), ("reco", "reco_"))

_VALID_NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


class OneDimBinning:
    """Binning of a single dimension.

    Parameters
    ----------
    name : str
        Name of the dimension (e.g. 'true_energy').
    tex : str, optional
        TeX label.
    bin_edges : array, Quantity, or None
        Explicit bin edges. Mutually exclusive with domain/num_bins.
    units : Unit, str, or None
        Units of the edges (if `bin_edges` isn't already a Quantity).
    domain : 2-sequence, optional
        (low, high) edges; used with `num_bins` and is_log/is_lin.
    num_bins : int, optional
    is_log, is_lin : bool, optional
        Spacing of generated edges (and declared regularity of explicit ones).
    bin_names : sequence of str, optional
        One name per bin.
    """

    def __init__(
        self,
        name,
        tex=None,
        bin_edges=None,
        units=None,
        domain=None,
        num_bins=None,
        is_log=None,
        is_lin=None,
        bin_names=None,
    ):
        if not isinstance(name, str):
            raise TypeError(f"`name` must be a string; got {type(name)}")
        self._name = name
        self._tex = tex if tex is not None else name.replace("_", r"\,")

        # Resolve units
        if isinstance(units, str):
            units = ureg.parse_units(units)
        if isinstance(bin_edges, Quantity):
            if units is not None and bin_edges.units != units:
                bin_edges = bin_edges.to(units)
            units = bin_edges.units
            bin_edges = bin_edges.magnitude
        if isinstance(domain, Quantity):
            if units is not None and domain.units != units:
                domain = domain.to(units)
            units = domain.units
            domain = domain.magnitude
        if units is None:
            units = ureg.dimensionless
        self._units: Unit = units

        if bin_edges is None:
            if domain is None or num_bins is None:
                raise ValueError(
                    "Must provide either `bin_edges` or both `domain` and"
                    " `num_bins`"
                )
            lo, hi = float(domain[0]), float(domain[1])
            if is_log:
                if lo <= 0:
                    raise ValueError("Log binning requires positive domain")
                bin_edges = np.logspace(np.log10(lo), np.log10(hi), num_bins + 1)
            else:
                bin_edges = np.linspace(lo, hi, num_bins + 1)
                if is_lin is None:
                    is_lin = True
        bin_edges = np.asarray(bin_edges, dtype=np.float64)
        if bin_edges.ndim != 1 or len(bin_edges) < 2:
            raise ValueError("bin_edges must be 1-d with >= 2 entries")
        if not np.all(np.diff(bin_edges) > 0) and not np.all(
            np.diff(bin_edges) < 0
        ):
            raise ValueError(f"bin_edges must be monotonic; got {bin_edges}")
        self._edges = bin_edges
        self._edges.setflags(write=False)

        # Determine spacing flags if not given
        if is_log is None and is_lin is None:
            is_lin = self._check_lin(bin_edges)
            is_log = False if is_lin else self._check_log(bin_edges)
        elif is_log is None:
            is_log = False if is_lin else self._check_log(bin_edges)
        elif is_lin is None:
            is_lin = False if is_log else self._check_lin(bin_edges)
        self._is_log = bool(is_log)
        self._is_lin = bool(is_lin)

        if bin_names is not None:
            bin_names = tuple(str(b) for b in bin_names)
            if len(bin_names) != self.num_bins:
                raise ValueError(
                    f"Got {len(bin_names)} bin_names for {self.num_bins} bins"
                )
            if len(set(bin_names)) != len(bin_names):
                raise ValueError("bin_names must be unique")
        self._bin_names = bin_names

    @staticmethod
    def _check_lin(edges):
        d = np.diff(edges)
        return bool(np.allclose(d, d[0], rtol=1e-8))

    @staticmethod
    def _check_log(edges):
        if np.any(edges <= 0):
            return False
        d = np.diff(np.log(edges))
        return bool(np.allclose(d, d[0], rtol=1e-8))

    # -- basic attributes ---------------------------------------------------
    @property
    def name(self):
        return self._name

    @property
    def tex(self):
        return self._tex

    @property
    def basename(self):
        """Name stripped of 'true'/'reco' prefixes (for compat checks)."""
        return basename(self._name)

    @property
    def units(self):
        return self._units

    @property
    def bin_edges(self) -> Quantity:
        return Quantity(self._edges, self._units)

    @property
    def edge_magnitudes(self) -> np.ndarray:
        return self._edges

    @property
    def inbounds_criteria(self):
        """Boolean cut string keeping values inside the binning's domain,
        e.g. ``'(true_energy >= 1e0) & (true_energy <= 8e1)'``
        (cf. reference ``binning.py:994``; used by ``Events.keepInbounds``)."""
        be = self.edge_magnitudes
        return "(%s >= %.15e) & (%s <= %.15e)" % (
            self.name, float(np.min(be)), self.name, float(np.max(be))
        )

    @property
    def bin_names(self):
        return self._bin_names

    @property
    def num_bins(self):
        return len(self._edges) - 1

    def __len__(self):
        return self.num_bins

    @property
    def size(self):
        return self.num_bins

    @property
    def shape(self):
        return (self.num_bins,)

    @property
    def is_log(self):
        return self._is_log

    @property
    def is_lin(self):
        return self._is_lin

    @property
    def is_irregular(self):
        return not (self._is_lin or self._is_log)

    @property
    def domain(self) -> Quantity:
        return Quantity(
            np.array([self._edges[0], self._edges[-1]]), self._units
        )

    @property
    def range(self) -> Quantity:
        return Quantity(self._edges[-1] - self._edges[0], self._units)

    @cached_property
    def midpoints(self) -> Quantity:
        return Quantity(
            (self._edges[:-1] + self._edges[1:]) / 2.0, self._units
        )

    @cached_property
    def weighted_centers(self) -> Quantity:
        """Geometric means for log binnings, arithmetic midpoints otherwise
        (cf. reference ``binning.py:901``)."""
        if self._is_log:
            centers = np.sqrt(self._edges[:-1] * self._edges[1:])
        else:
            centers = (self._edges[:-1] + self._edges[1:]) / 2.0
        return Quantity(centers, self._units)

    @cached_property
    def bin_widths(self) -> Quantity:
        return Quantity(np.abs(np.diff(self._edges)), self._units)

    @property
    def weighted_bin_widths(self) -> Quantity:
        """Log-width (dlog) for log binnings, else linear widths."""
        if self._is_log:
            return Quantity(np.diff(np.log(self._edges)), ureg.dimensionless)
        return self.bin_widths

    # -- transforms ---------------------------------------------------------
    def oversample(self, factor) -> "OneDimBinning":
        """Subdivide each bin into `factor` bins (log-uniformly for log
        binnings; cf. reference ``binning.py:1213``)."""
        factor = int(factor)
        if factor == 1:
            return self
        if factor < 1:
            raise ValueError(f"factor must be >= 1; got {factor}")
        if self._is_log:
            work = np.log(self._edges)
        else:
            work = self._edges
        pieces = [
            np.linspace(work[i], work[i + 1], factor, endpoint=False)
            for i in range(self.num_bins)
        ]
        new = np.concatenate(pieces + [work[-1:]])
        if self._is_log:
            new = np.exp(new)
        return OneDimBinning(
            name=self._name,
            tex=self._tex,
            bin_edges=new,
            units=self._units,
            is_log=self._is_log,
            is_lin=self._is_lin,
        )

    def downsample(self, factor) -> "OneDimBinning":
        """Merge every `factor` adjacent bins (cf. reference
        ``binning.py:1273``)."""
        factor = int(factor)
        if factor == 1:
            return self
        if self.num_bins % factor != 0:
            raise ValueError(
                f"Cannot downsample {self.num_bins} bins by factor {factor}"
            )
        return OneDimBinning(
            name=self._name,
            tex=self._tex,
            bin_edges=self._edges[::factor],
            units=self._units,
            is_log=self._is_log,
            is_lin=self._is_lin,
        )

    def is_compat(self, other) -> bool:
        """Can `self`'s events be binned into `other`? True iff every edge of
        `other` coincides with an edge of self (cf. ``binning.py:1140``)."""
        if self.name != other.name:
            return False
        my_edges = self.bin_edges.m_as(other.units)
        for edge in other.edge_magnitudes:
            if not np.any(np.isclose(my_edges, edge, rtol=1e-9, atol=0)):
                return False
        return True

    def __getitem__(self, index) -> "OneDimBinning":
        """Sub-binning by bin index or slice."""
        if isinstance(index, slice):
            sl = index
        elif isinstance(index, int):
            index = index if index >= 0 else index + self.num_bins
            sl = slice(index, index + 1)
        else:
            raise TypeError(f"Cannot index OneDimBinning with {index!r}")
        idx = list(range(self.num_bins))[sl]
        if not idx:
            raise ValueError("Empty sub-binning")
        if idx != list(range(idx[0], idx[-1] + 1)):
            raise ValueError("Sub-binning must be contiguous")
        edges = self._edges[idx[0] : idx[-1] + 2]
        names = self._bin_names[idx[0] : idx[-1] + 1] if self._bin_names else None
        return OneDimBinning(
            name=self._name,
            tex=self._tex,
            bin_edges=edges,
            units=self._units,
            bin_names=names,
        )

    def __iter__(self):
        for i in range(self.num_bins):
            yield self[i]

    # -- identity / serialization ------------------------------------------
    @property
    def state(self):
        return dict(
            name=self._name,
            bin_edges=self.bin_edges,
            is_log=self._is_log,
            is_lin=self._is_lin,
            bin_names=list(self._bin_names) if self._bin_names else None,
            tex=self._tex,
        )

    @property
    def hashable_state(self):
        return dict(
            name=self._name,
            edges=np.round(self._edges * self._units.scale, 12).tobytes(),
            bin_names=self._bin_names,
        )

    @cached_property
    def hash(self):
        return hash_obj(self.hashable_state, sigfigs=HASH_SIGFIGS)

    def __hash__(self):
        return self.hash

    def __eq__(self, other):
        if not isinstance(other, OneDimBinning):
            return False
        if self._name != other._name or self._bin_names != other._bin_names:
            return False
        if self._units.dims != other._units.dims:
            return False
        if len(self._edges) != len(other._edges):
            return False
        return bool(
            np.allclose(
                self._edges * self._units.scale,
                other._edges * other._units.scale,
                rtol=1e-12,
            )
        )

    def __ne__(self, other):
        return not self == other

    @classmethod
    def from_state(cls, state):
        return cls(**state)

    def to_json(self, filename, **kwargs):
        from pisa_tpu.utils.jsons import to_json

        to_json(self.state, filename, **kwargs)

    @classmethod
    def from_json(cls, filename):
        from pisa_tpu.utils.jsons import from_json

        return cls.from_state(from_json(filename))

    def __str__(self):
        kind = "log" if self._is_log else ("lin" if self._is_lin else "irreg")
        return (
            f"OneDimBinning('{self._name}', {self.num_bins} {kind} bins in "
            f"[{self._edges[0]}, {self._edges[-1]}] {self._units})"
        )

    __repr__ = __str__

    def __mul__(self, other):
        if isinstance(other, OneDimBinning):
            return MultiDimBinning([self, other])
        if isinstance(other, MultiDimBinning):
            return MultiDimBinning([self] + list(other.dims))
        return NotImplemented


class MultiDimBinning:
    """Binning in multiple dimensions (cf. reference ``binning.py:1484``).

    Parameters
    ----------
    dimensions : OneDimBinning or iterable thereof (or state dicts)
    name : str, optional
        Name of this binning (e.g. 'reco_binning').
    mask : array of bool, optional
        Bins to include (True) / exclude (False); shape must match.
    """

    def __init__(self, dimensions, name=None, mask=None):
        if isinstance(dimensions, (OneDimBinning, MultiDimBinning)):
            dimensions = [dimensions]
        dims = []
        for d in dimensions:
            if isinstance(d, OneDimBinning):
                dims.append(d)
            elif isinstance(d, MultiDimBinning):
                dims.extend(d.dims)
            elif isinstance(d, dict):
                dims.append(OneDimBinning(**d))
            else:
                raise TypeError(f"Cannot interpret dimension {d!r}")
        names = [d.name for d in dims]
        if len(set(names)) != len(names):
            raise ValueError(f"Duplicate dimension names: {names}")
        self._dims = tuple(dims)
        self._name = name
        if mask is not None:
            mask = np.asarray(mask, dtype=bool)
            if mask.shape != self.shape:
                if mask.size == self.size:
                    mask = mask.reshape(self.shape)
                else:
                    raise ValueError(
                        f"mask shape {mask.shape} != binning shape {self.shape}"
                    )
            mask.setflags(write=False)
        self._mask = mask

    # -- basic attributes ---------------------------------------------------
    @property
    def name(self):
        return self._name

    @property
    def dims(self):
        return self._dims

    @property
    def mask(self):
        return self._mask

    @property
    def names(self):
        return [d.name for d in self._dims]

    @property
    def basenames(self):
        return [d.basename for d in self._dims]

    @property
    def num_dims(self):
        return len(self._dims)

    @property
    def shape(self):
        return tuple(d.num_bins for d in self._dims)

    @property
    def size(self):
        return int(np.prod(self.shape))

    @property
    def tot_num_bins(self):
        return self.size

    @property
    def inbounds_criteria(self):
        """AND of every dimension's inbounds cut (cf. reference
        ``binning.py:1989``)."""
        return " & ".join(f"({d.inbounds_criteria})" for d in self._dims)

    @property
    def units(self):
        return [d.units for d in self._dims]

    @property
    def bin_edges(self):
        return [d.bin_edges for d in self._dims]

    @property
    def midpoints(self):
        return [d.midpoints for d in self._dims]

    @property
    def weighted_centers(self):
        return [d.weighted_centers for d in self._dims]

    def index(self, dim_name):
        """Integer index of dimension `dim_name`."""
        if isinstance(dim_name, int):
            if not 0 <= dim_name < self.num_dims:
                raise ValueError(f"dim index {dim_name} out of range")
            return dim_name
        try:
            return self.names.index(dim_name)
        except ValueError:
            raise ValueError(
                f"No dimension {dim_name!r} in binning {self.names}"
            ) from None

    def __getitem__(self, key):
        if isinstance(key, str):
            return self._dims[self.index(key)]
        if isinstance(key, int):
            return self._dims[key]
        if isinstance(key, (list, tuple)) and all(
            isinstance(k, str) for k in key
        ):
            return MultiDimBinning([self[k] for k in key], name=self._name)
        raise TypeError(f"Cannot index MultiDimBinning with {key!r}")

    def __getattr__(self, name):
        # Allow binning.true_energy style access
        if name.startswith("_"):
            raise AttributeError(name)
        for d in self.__dict__.get("_dims", ()):
            if d.name == name:
                return d
        raise AttributeError(name)

    def __iter__(self):
        return iter(self._dims)

    def __len__(self):
        return self.num_dims

    def __contains__(self, item):
        if isinstance(item, str):
            return item in self.names
        if isinstance(item, OneDimBinning):
            return item in self._dims
        return False

    # -- derived quantities -------------------------------------------------
    def meshgrid(self, entity="midpoints", attach_units=True):
        """Coordinate arrays of shape `self.shape` per dimension.

        entity : 'midpoints' | 'weighted_centers' | 'bin_edges' |
                 'bin_widths' | 'weighted_bin_widths'
        """
        arrays = [np.asarray(getattr(d, entity).magnitude) for d in self._dims]
        mg = np.meshgrid(*arrays, indexing="ij")
        if attach_units:
            return [Quantity(m, d.units) for m, d in zip(mg, self._dims)]
        return mg

    def bin_volumes(self, attach_units=True):
        """Outer product of bin widths."""
        mg = self.meshgrid(entity="bin_widths", attach_units=False)
        vols = np.ones(self.shape)
        for m in mg:
            vols = vols * m
        if attach_units:
            unit = self._dims[0].units
            for d in self._dims[1:]:
                unit = unit * d.units
            return Quantity(vols, unit)
        return vols

    def weighted_bin_volumes(self, attach_units=True):
        mg = self.meshgrid(entity="weighted_bin_widths", attach_units=False)
        vols = np.ones(self.shape)
        for m in mg:
            vols = vols * m
        if attach_units:
            return Quantity(vols, ureg.dimensionless)
        return vols

    # -- transforms ---------------------------------------------------------
    def oversample(self, *args, **kwargs) -> "MultiDimBinning":
        factors = self._resolve_factors(args, kwargs)
        return MultiDimBinning(
            [d.oversample(f) for d, f in zip(self._dims, factors)],
            name=self._name,
        )

    def downsample(self, *args, **kwargs) -> "MultiDimBinning":
        factors = self._resolve_factors(args, kwargs)
        return MultiDimBinning(
            [d.downsample(f) for d, f in zip(self._dims, factors)],
            name=self._name,
        )

    def _resolve_factors(self, args, kwargs):
        if args and kwargs:
            raise ValueError("Provide either positional or keyword factors")
        if args:
            if len(args) == 1:
                return [args[0]] * self.num_dims
            if len(args) != self.num_dims:
                raise ValueError(
                    f"Got {len(args)} factors for {self.num_dims} dims"
                )
            return list(args)
        factors = [1] * self.num_dims
        for k, v in kwargs.items():
            factors[self.index(k)] = v
        return factors

    def reorder_dimensions(self, order) -> "MultiDimBinning":
        """Return new binning with dims in `order` (names or indices);
        all of self's dims must be present in `order` or vice versa."""
        if isinstance(order, MultiDimBinning):
            order = order.names
        indices = []
        for entry in order:
            try:
                indices.append(self.index(entry))
            except ValueError:
                continue
        missing = set(range(self.num_dims)) - set(indices)
        if missing:
            raise ValueError(
                f"Dimensions {[self.names[i] for i in sorted(missing)]} not in"
                f" requested order {order}"
            )
        return MultiDimBinning(
            [self._dims[i] for i in indices], name=self._name, mask=None
        )

    def is_compat(self, other) -> bool:
        for od in other.dims:
            try:
                mine = self[od.name]
            except (KeyError, ValueError, AttributeError):
                return False
            if not mine.is_compat(od):
                return False
        return True

    def empty(self, dtype=None):
        return np.empty(self.shape, dtype=dtype or FTYPE)

    def zeros(self, dtype=None):
        return np.zeros(self.shape, dtype=dtype or FTYPE)

    def ones(self, dtype=None):
        return np.ones(self.shape, dtype=dtype or FTYPE)

    # -- identity / serialization ------------------------------------------
    @property
    def state(self):
        return dict(
            dimensions=[d.state for d in self._dims],
            name=self._name,
            mask=self._mask,
        )

    @property
    def hashable_state(self):
        return dict(
            dims=[d.hashable_state for d in self._dims],
            mask=None if self._mask is None else self._mask.tobytes(),
        )

    @cached_property
    def hash(self):
        return hash_obj(self.hashable_state, sigfigs=HASH_SIGFIGS)

    def __hash__(self):
        return self.hash

    def __eq__(self, other):
        if not isinstance(other, MultiDimBinning):
            return False
        if (self._mask is None) != (other._mask is None):
            return False
        if self._mask is not None and not np.array_equal(self._mask, other._mask):
            return False
        return self._dims == other._dims

    def __ne__(self, other):
        return not self == other

    @classmethod
    def from_state(cls, state):
        state = dict(state)
        return cls(
            dimensions=state["dimensions"],
            name=state.get("name"),
            mask=state.get("mask"),
        )

    def to_json(self, filename, **kwargs):
        from pisa_tpu.utils.jsons import to_json

        to_json(self.state, filename, **kwargs)

    @classmethod
    def from_json(cls, filename):
        from pisa_tpu.utils.jsons import from_json

        return cls.from_state(from_json(filename))

    def __str__(self):
        inner = ", ".join(str(d) for d in self._dims)
        return f"MultiDimBinning([{inner}])"

    __repr__ = __str__

    def __mul__(self, other):
        if isinstance(other, OneDimBinning):
            return MultiDimBinning(list(self._dims) + [other])
        if isinstance(other, MultiDimBinning):
            return MultiDimBinning(list(self._dims) + list(other.dims))
        return NotImplemented


class VarBinning:
    """A list of MultiDimBinnings applied to mutually-exclusive event
    selections (cf. reference ``binning.py:3043``).

    Parameters
    ----------
    binnings : sequence of MultiDimBinning
    selections : OneDimBinning or sequence of str
        Either a OneDimBinning whose bins define the selections (one
        MultiDimBinning per bin) or a list of cut-expression strings (e.g.
        ``"(true_energy > 10) & (true_coszen <= 0)"``), one per binning.
    name : str, optional
    """

    def __init__(self, binnings, selections, name=None):
        binnings = [
            b if isinstance(b, MultiDimBinning) else MultiDimBinning(b)
            for b in binnings
        ]
        if isinstance(selections, OneDimBinning):
            nsel = selections.num_bins
        else:
            selections = [str(s) for s in selections]
            nsel = len(selections)
        if len(binnings) != nsel:
            raise ValueError(
                f"Got {len(binnings)} binnings for {nsel} selections"
            )
        # All binnings must share dimension names
        names0 = binnings[0].names
        for b in binnings[1:]:
            if b.names != names0:
                raise ValueError(
                    "All binnings in a VarBinning must have the same"
                    f" dimensions; got {b.names} vs {names0}"
                )
        self._binnings = tuple(binnings)
        self._selections = selections
        self._name = name

    @property
    def binnings(self):
        return self._binnings

    @property
    def selections(self):
        return self._selections

    @property
    def name(self):
        return self._name

    @property
    def nselections(self):
        return len(self._binnings)

    @property
    def names(self):
        return self._binnings[0].names

    def __iter__(self):
        return iter(self._binnings)

    def __len__(self):
        return len(self._binnings)

    def __getitem__(self, i):
        return self._binnings[i]

    def __eq__(self, other):
        if not isinstance(other, VarBinning):
            return False
        if isinstance(self._selections, OneDimBinning) != isinstance(
            other._selections, OneDimBinning
        ):
            return False
        return (
            self._binnings == other._binnings
            and self._selections == other._selections
        )

    def __ne__(self, other):
        return not self == other

    @cached_property
    def hash(self):
        sel = self._selections
        sel_state = sel.hashable_state if isinstance(sel, OneDimBinning) else sel
        return hash_obj(
            dict(
                binnings=[b.hashable_state for b in self._binnings],
                selections=sel_state,
            ),
            sigfigs=HASH_SIGFIGS,
        )

    def __hash__(self):
        return self.hash

    @property
    def state(self):
        sel = self._selections
        return dict(
            binnings=[b.state for b in self._binnings],
            selections=sel.state if isinstance(sel, OneDimBinning) else sel,
            name=self._name,
        )

    def __str__(self):
        return (
            f"VarBinning({len(self._binnings)} binnings, "
            f"selections={self._selections})"
        )

    __repr__ = __str__


def basename(name):
    """Strip 'true'/'reco' prefixes/suffixes and separators from a dimension
    name (cf. reference ``binning.py`` basename)."""
    name = name.lower()
    for prefix in ("true", "reco"):
        name = re.sub(rf"^{prefix}[_\-\s]*|[_\-\s]*{prefix}$", "", name)
    return name.strip("_- ")
