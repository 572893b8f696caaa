"""
Map and MapSet: binned templates with optional per-bin uncertainties.

Rebuild of reference ``pisa/core/map.py:221,2108``. A Map is a
host-boundary object — the jitted pipeline produces raw (hist, variance)
arrays which are wrapped into Maps at the end. Error propagation through Map
arithmetic uses explicit (value, variance) pairs assuming independent
operands (replacing the reference's `uncertainties` package; correlations
between two *different* maps — the meaningful use case — are zero anyway).
"""

from __future__ import annotations

import fnmatch
import numbers
import re
from functools import cached_property

import numpy as np

from pisa_tpu import FTYPE, HASH_SIGFIGS
from pisa_tpu.core.binning import MultiDimBinning, OneDimBinning
from pisa_tpu.utils import stats
from pisa_tpu.utils.format import make_valid_python_name
from pisa_tpu.utils.hash import hash_obj
from pisa_tpu.utils.random_numbers import get_random_state

__all__ = ["Map", "MapSet", "rebin", "reduceToHist"]


def reduceToHist(obj):
    """Return a bare histogram ndarray from a Map, MapSet (sum of maps), or
    array (cf. reference ``map.py:85``)."""
    if isinstance(obj, Map):
        return obj.nominal_values
    if isinstance(obj, MapSet):
        total = None
        for m in obj:
            total = m.nominal_values if total is None else total + m.nominal_values
        return total
    return np.asarray(obj)


def rebin(hist, orig_binning, new_binning, normalize_values=True):
    """Rebin `hist` from `orig_binning` to the coarser, edge-aligned
    `new_binning` by summation (cf. reference ``map.py:115``)."""
    if orig_binning == new_binning:
        return hist
    if not orig_binning.is_compat(new_binning):
        raise ValueError(
            f"Cannot rebin from {orig_binning} to incompatible {new_binning}"
        )
    # permute hist axes into the new binning's dimension order
    perm = [orig_binning.index(n) for n in new_binning.names]
    out = np.transpose(np.asarray(hist), perm)
    orig_dims = [orig_binning.dims[i] for i in perm]
    for ax, (od, nd) in enumerate(zip(orig_dims, new_binning.dims)):
        orig_edges = od.bin_edges.m_as(nd.units)
        new_edges = nd.edge_magnitudes
        # indices in orig edges where new edges fall
        idx = [int(np.argmin(np.abs(orig_edges - e))) for e in new_edges]
        out = np.add.reduceat(out, idx[:-1], axis=ax)
    return out


class Map:
    """A binned histogram with name, binning, and optional per-bin variance.

    Parameters
    ----------
    name : str
    hist : array with shape matching `binning`
    binning : MultiDimBinning (or state)
    error_hist : array, optional
        Per-bin standard deviations (converted to variance internally).
    variance : array, optional
        Per-bin variance (mutually exclusive with error_hist).
    tex : str, optional
    full_comparison : bool
    """

    _state_attrs = ("name", "hist", "binning", "error_hist", "tex", "full_comparison")

    def __init__(
        self,
        name,
        hist,
        binning,
        error_hist=None,
        variance=None,
        tex=None,
        full_comparison=False,
    ):
        self.name = name
        self.tex = tex if tex is not None else name
        self.full_comparison = full_comparison
        if not isinstance(binning, MultiDimBinning):
            if isinstance(binning, (OneDimBinning, dict)):
                binning = MultiDimBinning(
                    binning["dimensions"]
                    if isinstance(binning, dict)
                    else [binning]
                )
            else:
                binning = MultiDimBinning(binning)
        self._binning = binning
        hist = np.asarray(hist, dtype=FTYPE)
        if hist.shape != binning.shape:
            if hist.size == binning.size:
                hist = hist.reshape(binning.shape)
            else:
                raise ValueError(
                    f"hist shape {hist.shape} incompatible with binning shape"
                    f" {binning.shape}"
                )
        self._hist = hist
        if error_hist is not None and variance is not None:
            raise ValueError("Provide error_hist or variance, not both")
        if error_hist is not None:
            err = np.asarray(error_hist, dtype=FTYPE).reshape(binning.shape)
            variance = err**2
        if variance is not None:
            variance = np.asarray(variance, dtype=FTYPE).reshape(binning.shape)
        self._variance = variance

    # -- accessors ----------------------------------------------------------
    @property
    def binning(self):
        return self._binning

    @property
    def shape(self):
        return self._binning.shape

    @property
    def size(self):
        return self._binning.size

    @property
    def num_entries(self):
        return self.size

    @property
    def hist(self):
        """Nominal histogram (alias: nominal_values)."""
        return self._hist

    @property
    def nominal_values(self):
        return self._hist

    @property
    def variance(self):
        return self._variance

    @property
    def std_devs(self):
        if self._variance is None:
            return np.zeros_like(self._hist)
        return np.sqrt(self._variance)

    @property
    def error_hist(self):
        return None if self._variance is None else np.sqrt(self._variance)

    def set_errors(self, error_hist):
        """Return a copy with the given per-bin standard deviations (None
        clears errors). The reference mutates in place (``map.py``); Maps here
        are value-like, so we return a new instance."""
        return Map(
            name=self.name,
            hist=self._hist,
            binning=self._binning,
            error_hist=error_hist,
            tex=self.tex,
            full_comparison=self.full_comparison,
        )

    # -- internal helpers ---------------------------------------------------
    def _new(self, hist, variance, name=None, binning=None):
        return Map(
            name=name or self.name,
            hist=hist,
            binning=binning or self._binning,
            variance=variance,
            tex=self.tex,
            full_comparison=self.full_comparison,
        )

    @staticmethod
    def _split_operand(other):
        """-> (values, variance_or_None) for Map / scalar / array operand."""
        if isinstance(other, Map):
            return other._hist, other._variance
        if isinstance(other, numbers.Number):
            return other, None
        arr = np.asarray(other)
        return arr, None

    @staticmethod
    def _combine_var(va, vb, da, db):
        """Combine variances with sensitivities da = d(out)/d(a) etc."""
        if va is None and vb is None:
            return None
        total = 0.0
        if va is not None:
            total = total + np.square(da) * va
        if vb is not None:
            total = total + np.square(db) * vb
        return total

    # -- arithmetic (uncorrelated error propagation) ------------------------
    def __add__(self, other):
        b, vb = self._split_operand(other)
        return self._new(
            self._hist + b, self._combine_var(self._variance, vb, 1.0, 1.0)
        )

    __radd__ = __add__

    def __sub__(self, other):
        b, vb = self._split_operand(other)
        return self._new(
            self._hist - b, self._combine_var(self._variance, vb, 1.0, 1.0)
        )

    def __rsub__(self, other):
        b, vb = self._split_operand(other)
        return self._new(
            b - self._hist, self._combine_var(self._variance, vb, 1.0, 1.0)
        )

    def __mul__(self, other):
        b, vb = self._split_operand(other)
        return self._new(
            self._hist * b, self._combine_var(self._variance, vb, b, self._hist)
        )

    __rmul__ = __mul__

    def __truediv__(self, other):
        b, vb = self._split_operand(other)
        with np.errstate(divide="ignore", invalid="ignore"):
            out = self._hist / b
            var = self._combine_var(
                self._variance, vb, 1.0 / b, self._hist / np.square(b)
            )
        return self._new(out, var)

    def __rtruediv__(self, other):
        b, vb = self._split_operand(other)
        with np.errstate(divide="ignore", invalid="ignore"):
            out = b / self._hist
            var = self._combine_var(
                vb, self._variance, 1.0 / self._hist, b / np.square(self._hist)
            )
        return self._new(out, var)

    def __pow__(self, n):
        with np.errstate(divide="ignore", invalid="ignore"):
            out = self._hist**n
            var = (
                None
                if self._variance is None
                else np.square(n * self._hist ** (n - 1)) * self._variance
            )
        return self._new(out, var)

    def __neg__(self):
        return self._new(-self._hist, self._variance)

    def __abs__(self):
        return self._new(np.abs(self._hist), self._variance)

    def log(self):
        with np.errstate(divide="ignore", invalid="ignore"):
            var = (
                None
                if self._variance is None
                else self._variance / np.square(self._hist)
            )
            return self._new(np.log(self._hist), var)

    def log10(self):
        with np.errstate(divide="ignore", invalid="ignore"):
            var = (
                None
                if self._variance is None
                else self._variance / np.square(self._hist * np.log(10.0))
            )
            return self._new(np.log10(self._hist), var)

    def sqrt(self):
        with np.errstate(divide="ignore", invalid="ignore"):
            out = np.sqrt(self._hist)
            var = (
                None
                if self._variance is None
                else self._variance / (4.0 * self._hist)
            )
        return self._new(out, var)

    def __eq__(self, other):
        if not isinstance(other, Map):
            return False
        if self._binning != other._binning:
            return False
        same_hist = np.allclose(
            self._hist, other._hist, rtol=1e-12, atol=0, equal_nan=True
        )
        if self.full_comparison:
            return (
                same_hist
                and self.name == other.name
                and _var_equal(self._variance, other._variance)
            )
        return same_hist and _var_equal(self._variance, other._variance)

    def __ne__(self, other):
        return not self == other

    def allclose(self, other, rtol=1e-5, atol=0):
        return self._binning == other._binning and np.allclose(
            self._hist, other._hist, rtol=rtol, atol=atol, equal_nan=True
        )

    # -- reductions / transforms --------------------------------------------
    def sum(self, axis=None, keepdims=False):
        """Sum over `axis` (dim name(s) or None for everything)."""
        if axis is None:
            total = float(np.sum(self._hist))
            if self._variance is None:
                return total
            return total  # scalar: errors dropped, as in common usage
        if isinstance(axis, str):
            axis = [axis]
        idxs = tuple(sorted(self._binning.index(a) for a in axis))
        hist = self._hist.sum(axis=idxs, keepdims=keepdims)
        var = (
            None
            if self._variance is None
            else self._variance.sum(axis=idxs, keepdims=keepdims)
        )
        if keepdims:
            return self._new(hist, var)
        keep = [d for i, d in enumerate(self._binning.dims) if i not in idxs]
        return self._new(
            hist, var, binning=MultiDimBinning(keep, name=self._binning.name)
        )

    def project(self, axis, keepdims=False):
        """Project onto a single dimension, summing all others."""
        keep = self._binning.index(axis)
        others = [
            d.name for i, d in enumerate(self._binning.dims) if i != keep
        ]
        return self.sum(axis=others, keepdims=keepdims)

    def rebin(self, new_binning):
        hist = rebin(self._hist, self._binning, new_binning)
        var = (
            None
            if self._variance is None
            else rebin(self._variance, self._binning, new_binning)
        )
        return self._new(hist, var, binning=new_binning)

    def downsample(self, *args, **kwargs):
        new_binning = self._binning.downsample(*args, **kwargs)
        return self.rebin(new_binning)

    def split(self, dim, bin=None):
        """Split along `dim`: return a MapSet with one map per bin of `dim`
        (named by bin_names when available), or a single Map if `bin` given
        (cf. reference ``map.py:1449``)."""
        dim_idx = self._binning.index(dim)
        dim_binning = self._binning.dims[dim_idx]
        keep = [d for i, d in enumerate(self._binning.dims) if i != dim_idx]
        maps = []
        indices = range(dim_binning.num_bins)
        if bin is not None:
            if isinstance(bin, str):
                indices = [dim_binning.bin_names.index(bin)]
            else:
                indices = [bin]
        for i in indices:
            bin_name = (
                dim_binning.bin_names[i]
                if dim_binning.bin_names
                else f"bin_{i}"
            )
            slicer = [slice(None)] * self._binning.num_dims
            slicer[dim_idx] = i
            slicer = tuple(slicer)
            maps.append(
                Map(
                    name=f"{self.name}_{bin_name}",
                    hist=self._hist[slicer],
                    binning=MultiDimBinning(keep),
                    variance=None
                    if self._variance is None
                    else self._variance[slicer],
                    tex=self.tex,
                )
            )
        if bin is not None:
            return maps[0]
        return MapSet(maps, name=self.name)

    def plot(self, ax=None, fname=None, outdir=".", **kwargs):
        """Quick plot of this map (2-D pcolormesh or 1-D step plot) via
        :class:`pisa_tpu.utils.plotter.Plotter` (cf. reference
        ``map.py:573``). Returns the axis (or saved paths with `fname`)."""
        from pisa_tpu.utils.plotter import Plotter

        plotter = Plotter(outdir=outdir, fmt=kwargs.pop("fmt", "png"),
                          log=kwargs.pop("log", False))
        if len(self.binning.names) >= 2:
            if len(self.binning.names) > 2:
                raise ValueError("plot 2-D slices of >2-D maps via split()")
            ax = plotter.plot_2d_map(self, ax=ax, **kwargs)
        else:
            ax = plotter.plot_1d_projection(
                self, self.binning.names[0], ax=ax, **kwargs
            )
        if fname is not None:
            return plotter.dump(fname)
        return ax

    def fluctuate(self, method, random_state=None, jumpahead=0):
        """Pseudo-experiment fluctuation (cf. reference ``map.py:1118``).

        method : 'poisson' | 'scaled_poisson' | 'gauss' | 'gauss+poisson' | None
        """
        rs = get_random_state(random_state, jumpahead)
        method = None if method is None else str(method).strip().lower()
        hist = self._hist
        if method in (None, "none"):
            return self._new(hist.copy(), self._variance)
        if method == "poisson":
            out = rs.poisson(np.clip(hist, 0, None)).astype(FTYPE)
            return self._new(out, out.copy())
        if method == "scaled_poisson":
            # Bohm-Zech: n ~ Poisson(mu^2/var) * var/mu  (scaled to match
            # mean & variance of the weighted histogram)
            if self._variance is None:
                raise ValueError("scaled_poisson requires errors on the map")
            with np.errstate(divide="ignore", invalid="ignore"):
                scale = np.where(self._variance > 0, hist / self._variance, 0.0)
            lam = np.clip(hist * scale, 0, None)
            draw = rs.poisson(lam)
            with np.errstate(divide="ignore", invalid="ignore"):
                out = np.where(scale > 0, draw / scale, 0.0).astype(FTYPE)
            return self._new(out, self._variance)
        if method == "gauss":
            if self._variance is None:
                raise ValueError("gauss fluctuation requires errors")
            out = rs.normal(hist, np.sqrt(self._variance)).astype(FTYPE)
            return self._new(out, self._variance)
        if method == "gauss+poisson":
            if self._variance is None:
                raise ValueError("gauss+poisson fluctuation requires errors")
            gauss = rs.normal(hist, np.sqrt(self._variance))
            out = rs.poisson(np.clip(gauss, 0, None)).astype(FTYPE)
            return self._new(out, out.copy())
        raise ValueError(f"Unknown fluctuation method {method!r}")

    # -- metrics ------------------------------------------------------------
    def metric_per_map(self, expected_values, metric):
        """Per-bin metric values summed over this map, with `self` as the
        'actual' (data) distribution (cf. reference ``map.py:1572``)."""
        metric = str(metric).strip().lower()
        if metric not in stats.ALL_METRICS:
            raise ValueError(
                f"Unknown metric {metric!r}; valid: {stats.ALL_METRICS}"
            )
        if isinstance(expected_values, Map):
            exp = expected_values._hist
            var = expected_values._variance
        else:
            exp = np.asarray(expected_values)
            var = None
        fn = getattr(stats, metric)
        if var is None:
            var = np.zeros_like(exp)
        if metric in ("chi2", "llh", "poisson_llh"):
            vals = fn(self._hist, exp)
        else:
            vals = fn(self._hist, exp, var)
        return float(np.sum(np.asarray(vals)))

    def metric_total(self, expected_values, metric):
        return self.metric_per_map(expected_values, metric)

    def llh(self, expected_values):
        return self.metric_per_map(expected_values, "llh")

    def chi2(self, expected_values):
        return self.metric_per_map(expected_values, "chi2")

    def mod_chi2(self, expected_values):
        return self.metric_per_map(expected_values, "mod_chi2")

    # -- identity / serialization ------------------------------------------
    @property
    def state(self):
        return dict(
            name=self.name,
            hist=self._hist,
            binning=self._binning.state,
            error_hist=self.error_hist,
            tex=self.tex,
            full_comparison=self.full_comparison,
        )

    @property
    def serializable_state(self):
        return self.state

    @cached_property
    def hash(self):
        return hash_obj(
            dict(
                name=self.name,
                hist=self._hist,
                variance=self._variance,
                binning=self._binning.hashable_state,
            ),
            sigfigs=HASH_SIGFIGS,
        )

    @classmethod
    def from_state(cls, state):
        state = dict(state)
        state["binning"] = MultiDimBinning.from_state(state["binning"])
        state.pop("variance", None)
        return cls(**state)

    def to_json(self, filename, **kwargs):
        from pisa_tpu.utils.jsons import to_json

        to_json(self.state, filename, **kwargs)

    @classmethod
    def from_json(cls, filename):
        from pisa_tpu.utils.jsons import from_json

        return cls.from_state(from_json(filename))

    def __str__(self):
        return (
            f"Map('{self.name}', shape={self.shape}, total={self._hist.sum():.6g}"
            + (", with errors)" if self._variance is not None else ")")
        )

    __repr__ = __str__


def _var_equal(a, b):
    if a is None and b is None:
        return True
    if (a is None) != (b is None):
        return False
    return np.allclose(a, b, rtol=1e-12, atol=0, equal_nan=True)


class MapSet:
    """An ordered collection of Maps (cf. reference ``map.py:2108``)."""

    def __init__(self, maps, name=None, tex=None, collate_by_name=True):
        if isinstance(maps, Map):
            maps = [maps]
        maps = list(maps)
        for m in maps:
            if not isinstance(m, Map):
                raise TypeError(f"Expected Map; got {type(m)}")
        names = [m.name for m in maps]
        if len(set(names)) != len(names):
            raise ValueError(f"Duplicate map names: {names}")
        self.maps = tuple(maps)
        self.name = name
        self.tex = tex
        self.collate_by_name = collate_by_name

    # -- access -------------------------------------------------------------
    @property
    def names(self):
        return [m.name for m in self.maps]

    def __len__(self):
        return len(self.maps)

    def __iter__(self):
        return iter(self.maps)

    def __getitem__(self, key):
        if isinstance(key, (int, slice)):
            result = self.maps[key]
            if isinstance(result, tuple):
                return MapSet(result, name=self.name)
            return result
        if isinstance(key, str):
            for m in self.maps:
                if m.name == key:
                    return m
            raise KeyError(f"No map named {key!r}; have {self.names}")
        raise TypeError(f"Cannot index MapSet with {key!r}")

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        for m in self.__dict__.get("maps", ()):
            if m.name == name:
                return m
        raise AttributeError(name)

    def __contains__(self, name):
        return name in self.names

    def pop(self, key):
        m = self[key] if not isinstance(key, int) else self.maps[key]
        remaining = [x for x in self.maps if x is not m]
        self.maps = tuple(remaining)
        return m

    # -- arithmetic (broadcast over maps) -----------------------------------
    def _apply_binary(self, other, op):
        if isinstance(other, MapSet):
            if set(self.names) != set(other.names):
                raise ValueError(
                    f"MapSet names mismatch: {self.names} vs {other.names}"
                )
            return MapSet(
                [op(m, other[m.name]) for m in self.maps], name=self.name
            )
        return MapSet([op(m, other) for m in self.maps], name=self.name)

    def __add__(self, other):
        return self._apply_binary(other, lambda a, b: a + b)

    __radd__ = __add__

    def __sub__(self, other):
        return self._apply_binary(other, lambda a, b: a - b)

    def __mul__(self, other):
        return self._apply_binary(other, lambda a, b: a * b)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._apply_binary(other, lambda a, b: a / b)

    def __pow__(self, n):
        return MapSet([m**n for m in self.maps], name=self.name)

    def __neg__(self):
        return MapSet([-m for m in self.maps], name=self.name)

    def apply_to_maps(self, attr, *args, **kwargs):
        return MapSet(
            [getattr(m, attr)(*args, **kwargs) for m in self.maps],
            name=self.name,
        )

    def fluctuate(self, method, random_state=None, jumpahead=0):
        rs = get_random_state(random_state, jumpahead)
        return MapSet(
            [m.fluctuate(method, rs) for m in self.maps], name=self.name
        )

    # -- combination --------------------------------------------------------
    def sum(self, axis=None, keepdims=False):
        """Elementwise sum of all maps (all must share binning)."""
        total = self.maps[0]
        for m in self.maps[1:]:
            total = total + m
        if axis is not None or keepdims:
            return total.sum(axis=axis, keepdims=keepdims)
        return Map(
            name=self.name or "total",
            hist=total.hist,
            binning=total.binning,
            variance=total.variance,
        )

    def combine_re(self, regexes):
        """Combine (sum) maps whose names match each regex; one output map per
        regex, named by the pattern's sub-match groups joined or the pattern
        itself (cf. reference ``map.py:2326``)."""
        if isinstance(regexes, (str, re.Pattern)):
            regexes = [regexes]
        out = []
        for rx in regexes:
            pattern = re.compile(rx) if isinstance(rx, str) else rx
            matches = [m for m in self.maps if pattern.match(m.name)]
            if not matches:
                raise ValueError(
                    f"Regex {pattern.pattern!r} matched no maps of"
                    f" {self.names}"
                )
            total = matches[0]
            for m in matches[1:]:
                total = total + m
            out.append(
                Map(
                    name=pattern.pattern,
                    hist=total.hist,
                    binning=total.binning,
                    variance=total.variance,
                )
            )
        return MapSet(out, name=self.name)

    def combine_wildcard(self, wildcards):
        """Like combine_re but with fnmatch wildcards (cf. ``map.py:2446``)."""
        if isinstance(wildcards, str):
            wildcards = [wildcards]
        out = []
        for wc in wildcards:
            matches = [
                m for m in self.maps if fnmatch.fnmatchcase(m.name, wc)
            ]
            if not matches:
                raise ValueError(
                    f"Wildcard {wc!r} matched no maps of {self.names}"
                )
            total = matches[0]
            for m in matches[1:]:
                total = total + m
            # name as the reference does (``map.py:2515-2528``): a canonical
            # flavint-group name when all matched names parse, else the
            # sanitized wildcard
            try:
                from pisa_tpu.utils.flavint import NuFlavIntGroup

                new_name = make_valid_python_name(
                    str(NuFlavIntGroup([m.name for m in matches]))
                )
            except Exception:
                new_name = make_valid_python_name(wc) or "combined"
            if len(matches) == 1:
                new_name = matches[0].name
            out.append(
                Map(
                    name=new_name,
                    hist=total.hist,
                    binning=total.binning,
                    variance=total.variance,
                )
            )
        return MapSet(out, name=self.name)

    # -- metrics ------------------------------------------------------------
    def metric_per_map(self, expected_values, metric):
        """dict of map name -> metric total vs corresponding expected map."""
        out = {}
        for m in self.maps:
            exp = (
                expected_values[m.name]
                if isinstance(expected_values, MapSet)
                else expected_values
            )
            out[m.name] = m.metric_per_map(exp, metric)
        return out

    def metric_total(self, expected_values, metric):
        return sum(self.metric_per_map(expected_values, metric).values())

    def llh_total(self, expected_values):
        return self.metric_total(expected_values, "llh")

    def chi2_total(self, expected_values):
        return self.metric_total(expected_values, "chi2")

    def compare(self, ref):
        """Summary statistics of (self - ref) / ref per map (cf. reference
        ``map.py:2543``)."""
        out = {}
        for m in self.maps:
            r = ref[m.name]
            with np.errstate(divide="ignore", invalid="ignore"):
                diff = m.nominal_values - r.nominal_values
                fract = np.where(
                    r.nominal_values != 0, diff / r.nominal_values, np.nan
                )
            out[m.name] = dict(
                diff=diff,
                fract=fract,
                max_abs_diff=np.nanmax(np.abs(diff)),
                max_abs_fract=np.nanmax(np.abs(fract)),
            )
        return out

    # -- identity / serialization ------------------------------------------
    @property
    def state(self):
        return dict(
            maps=[m.state for m in self.maps],
            name=self.name,
            tex=self.tex,
            collate_by_name=self.collate_by_name,
        )

    @property
    def serializable_state(self):
        return self.state

    @cached_property
    def hash(self):
        return hash_obj([m.hash for m in self.maps])

    @classmethod
    def from_state(cls, state):
        state = dict(state)
        state["maps"] = [Map.from_state(s) for s in state["maps"]]
        return cls(**state)

    def to_json(self, filename, **kwargs):
        from pisa_tpu.utils.jsons import to_json

        to_json(self.state, filename, **kwargs)

    @classmethod
    def from_json(cls, filename):
        from pisa_tpu.utils.jsons import from_json

        return cls.from_state(from_json(filename))

    def __str__(self):
        return f"MapSet('{self.name}', maps={self.names})"

    __repr__ = __str__

    def __eq__(self, other):
        if not isinstance(other, MapSet):
            return False
        return self.names == other.names and all(
            a == b for a, b in zip(self.maps, other.maps)
        )

    def __ne__(self, other):
        return not self == other
