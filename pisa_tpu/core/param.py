"""
Parameters, parameter sets, and parameter selectors.

Rebuild of reference ``pisa/core/param.py:77,579,769,1604``.
Params are mutable host-side objects; identity-sharing (one Param object
aliased by several stages/pipelines) is the mechanism by which a single
fit parameter steers multiple pipeline components, exactly as in the
reference (``pipeline.py:342-346``). Magnitudes are stripped before anything
enters jitted code.
"""

from __future__ import annotations

from collections.abc import MutableSequence, Sequence

import numpy as np

from pisa_tpu import FTYPE, HASH_SIGFIGS, ureg
from pisa_tpu.core.prior import Prior
from pisa_tpu.units import Quantity
from pisa_tpu.utils.callable import Funct, Var, node_from_state
from pisa_tpu.utils.comparisons import interpret_quantity, recursiveEquality
from pisa_tpu.utils.hash import hash_obj
from pisa_tpu.utils.log import logging
from pisa_tpu.utils.random_numbers import get_random_state

__all__ = ["Param", "DerivedParam", "ParamSet", "ParamSelector"]

FTYPE_PREC = np.finfo(FTYPE).eps


class Param:
    """A single analysis parameter: unit-tagged value, prior, range,
    fixed/free state, and [0,1]-rescaling for minimizers.

    Parameters
    ----------
    name : str
    value : Quantity, string, or number
    prior : Prior, None, or state dict
    range : 2-sequence of Quantity/number, or None
    is_fixed : bool
    is_discrete : bool
    scales_as_log : bool
        Rescale to [0,1] in log space (range must not straddle 0).
    nominal_value : like value, optional (defaults to value)
    tex : str, optional
    unique_id : str, optional
    help : str, optional
    """

    def __init__(
        self,
        name,
        value,
        prior=None,
        range=None,
        is_fixed=True,
        is_discrete=False,
        scales_as_log=False,
        nominal_value=None,
        tex=None,
        unique_id=None,
        help="",  # noqa: A002 - mirror reference API
    ):
        self.name = str(name)
        self._tex = tex
        self.unique_id = unique_id if unique_id is not None else self.name
        self.help = help
        self.is_fixed = bool(is_fixed)
        self.is_discrete = bool(is_discrete)
        self.scales_as_log = bool(scales_as_log)
        self.normalize_values = False

        self._range = None
        self._value = None
        self._prior = None
        self._nominal_value = None

        value = self._interpret(value)
        self._units = value.units if isinstance(value, Quantity) else None
        if range is not None:
            self.range = range
        self.value = value
        self.prior = prior
        self.nominal_value = value if nominal_value is None else nominal_value

        if self.scales_as_log and self._range is not None:
            lo = self._range[0].magnitude
            hi = self._range[1].magnitude
            if lo * hi <= 0:
                raise ValueError(
                    f"{self.name}: scales_as_log requires a range that does"
                    f" not include 0; got [{lo}, {hi}]"
                )

    @staticmethod
    def _interpret(value):
        if value is None or isinstance(value, (bool, str)):
            return value
        return interpret_quantity(value)

    # -- value --------------------------------------------------------------
    @property
    def value(self):
        return self._value

    @value.setter
    def value(self, val):
        val = self._interpret(val)
        if isinstance(val, Quantity) and self._units is not None:
            val = val.to(self._units)
        self.validate_value(val)
        self._value = val

    @property
    def m(self):  # noqa: D102 - Quantity-like convenience
        return self._value.magnitude

    def m_as(self, units):
        return self._value.m_as(units)

    @property
    def units(self):
        return self._units

    @property
    def magnitude(self):
        return self._value.magnitude

    def validate_value(self, value):
        if self._range is None or value is None or isinstance(value, (bool, str)):
            return
        lo, hi = self._range
        if isinstance(value, Quantity):
            v = value.m_as(lo.units)
        else:
            v = value
        vlo, vhi = lo.magnitude, hi.magnitude
        if self.is_discrete:
            return
        if not (min(vlo, vhi) - 4 * FTYPE_PREC <= v <= max(vlo, vhi) + 4 * FTYPE_PREC):
            raise ValueError(
                f"{self.name}: value {value} out of range [{lo}, {hi}]"
            )

    # -- range --------------------------------------------------------------
    @property
    def range(self):
        return self._range

    @range.setter
    def range(self, new_range):
        if new_range is None:
            self._range = None
            return
        lo, hi = new_range
        lo = interpret_quantity(lo)
        hi = interpret_quantity(hi)
        if self._units is not None:
            lo = lo.to(self._units)
            hi = hi.to(self._units)
        self._range = (lo, hi)

    # -- prior / penalty -----------------------------------------------------
    @property
    def prior(self):
        return self._prior

    @prior.setter
    def prior(self, value):
        if value is None or isinstance(value, Prior):
            self._prior = value
        elif isinstance(value, dict):
            self._prior = Prior(**value)
        else:
            raise TypeError(f"Cannot interpret prior {value!r}")

    def prior_penalty(self, metric):
        """Prior penalty of the current value under `metric` ('llh' family ->
        llh, 'chi2' family -> chi2; cf. reference ``param.py:478``)."""
        if self._prior is None:
            return 0.0
        metric = str(metric).strip().lower()
        from pisa_tpu.utils.stats import (
            METRICS_TO_MAXIMIZE,
            METRICS_TO_MINIMIZE,
        )

        if metric in METRICS_TO_MAXIMIZE:
            return float(np.squeeze(self._prior.llh(self._value)))
        if metric in METRICS_TO_MINIMIZE:
            return float(np.squeeze(self._prior.chi2(self._value)))
        raise ValueError(f"Unknown metric {metric!r}")

    @property
    def prior_llh(self):
        return self.prior_penalty("llh")

    @property
    def prior_chi2(self):
        return self.prior_penalty("chi2")

    # -- nominal / reset -----------------------------------------------------
    @property
    def nominal_value(self):
        return self._nominal_value

    @nominal_value.setter
    def nominal_value(self, value):
        value = self._interpret(value)
        if isinstance(value, Quantity) and self._units is not None:
            value = value.to(self._units)
        self.validate_value(value)
        self._nominal_value = value

    def reset(self):
        self._value = self._nominal_value

    def set_nominal_to_current_value(self):
        self._nominal_value = self._value

    # -- [0,1] rescaling (minimizer space) -----------------------------------
    @property
    def _rescaled_value(self):
        """Value mapped to [0,1] over `range` (log-space if scales_as_log;
        cf. reference ``param.py:358-424``)."""
        if self.is_discrete:
            return self._value
        if self._range is None:
            raise ValueError(
                f"Cannot rescale {self.name} without a range"
            )
        lo = self._range[0].m_as(self._units)
        hi = self._range[1].m_as(self._units)
        v = self._value.m_as(self._units)
        if self.scales_as_log:
            if lo < 0:
                lo, hi, v = -lo, -hi, -v
            return (np.log(v) - np.log(lo)) / (np.log(hi) - np.log(lo))
        return (v - lo) / (hi - lo)

    @_rescaled_value.setter
    def _rescaled_value(self, rval):
        if self._range is None:
            raise ValueError(f"Cannot rescale {self.name} without a range")
        if rval < 0 or rval > 1 + FTYPE_PREC:
            raise ValueError(
                f"{self.name}: rescaled value {rval!r} outside [0, 1]"
            )
        rval = min(1.0, float(rval))
        lo = self._range[0].m_as(self._units)
        hi = self._range[1].m_as(self._units)
        if self.scales_as_log:
            v = (
                np.exp(rval * (np.log(np.abs(hi)) - np.log(np.abs(lo))))
                * lo
            )
        else:
            v = lo + (hi - lo) * rval
        v = np.clip(v, min(lo, hi), max(lo, hi))
        self._value = Quantity(v, self._units)

    def randomize(self, random_state=None):
        """Set value uniform-randomly within range (in rescaled space)."""
        rs = get_random_state(random_state)
        self._rescaled_value = rs.rand()

    # -- misc ---------------------------------------------------------------
    @property
    def tex(self):
        return self._tex if self._tex is not None else rf"{{\rm {self.name}}}"

    @tex.setter
    def tex(self, val):
        self._tex = val

    @property
    def state(self):
        return dict(
            name=self.name,
            value=self._value,
            prior=None if self._prior is None else self._prior.state,
            range=self._range,
            is_fixed=self.is_fixed,
            is_discrete=self.is_discrete,
            scales_as_log=self.scales_as_log,
            nominal_value=self._nominal_value,
            tex=self._tex,
            unique_id=self.unique_id,
        )

    @property
    def serializable_state(self):
        return self.state

    @property
    def hashable_state(self):
        return dict(
            name=self.name,
            value=self._value,
            prior=None if self._prior is None else self._prior.state,
            range=self._range,
            is_fixed=self.is_fixed,
        )

    @property
    def hash(self):
        return hash_obj(self.hashable_state, sigfigs=HASH_SIGFIGS)

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

    def __eq__(self, other):
        if not isinstance(other, Param):
            return False
        return recursiveEquality(self.hashable_state, other.hashable_state)

    def __ne__(self, other):
        return not self == other

    def __hash__(self):
        return hash(self.name)

    def __str__(self):
        fixed = "fixed" if self.is_fixed else "free"
        return f"Param('{self.name}', {self._value}, {fixed})"

    __repr__ = __str__


class DerivedParam(Param):
    """A parameter whose value is a function of other params
    (cf. reference ``param.py:579``). Carries zero prior penalty; never
    directly fitted."""

    def __init__(
        self,
        name,
        value,
        unique_id=None,
        depends_names=None,
        function=None,
        function_file=None,
        tex=None,
        help="",  # noqa: A002
    ):
        super().__init__(
            name=name,
            value=value,
            prior=None,
            range=None,
            is_fixed=True,
            tex=tex,
            unique_id=unique_id,
            help=help,
        )
        self._depends_names = tuple(depends_names or ())
        if isinstance(function, dict):
            function = node_from_state(function)
        self._function = function
        self._dependson: dict[str, Param] = {}

    @property
    def depends_names(self):
        return self._depends_names

    @property
    def function(self):
        return self._function

    @property
    def dependson(self):
        return self._dependson

    def bind(self, params):
        """Resolve dependency names against a ParamSet."""
        self._dependson = {n: params[n] for n in self._depends_names}

    @property
    def value(self):
        if self._function is not None and self._dependson:
            env = {
                n: p.value.magnitude if isinstance(p.value, Quantity) else p.value
                for n, p in self._dependson.items()
            }
            mag = self._function.evaluate(env)
            return Quantity(mag, self._units)
        return self._value

    @value.setter
    def value(self, val):
        # setting a derived param's value only updates the cached fallback
        val = self._interpret(val)
        if isinstance(val, Quantity) and self._units is not None:
            val = val.to(self._units)
        self._value = val

    def prior_penalty(self, metric):
        return 0.0

    @property
    def state(self):
        s = super().state
        s.pop("prior", None)
        s.pop("range", None)
        s.pop("is_fixed", None)
        s.pop("is_discrete", None)
        s.pop("scales_as_log", None)
        s.pop("nominal_value", None)
        s["depends_names"] = list(self._depends_names)
        s["function"] = None if self._function is None else self._function.state
        s["value"] = self._value
        return s

    @classmethod
    def from_state(cls, state):
        return cls(**state)


class ParamSet(MutableSequence):
    """Ordered set of Params with name-keyed access
    (cf. reference ``param.py:769``)."""

    def __init__(self, *args):
        params = []
        for arg in args:
            if isinstance(arg, (ParamSet, Sequence)) and not isinstance(
                arg, (str, Param)
            ):
                for p in arg:
                    params.append(self._as_param(p))
            else:
                params.append(self._as_param(arg))
        names = [p.name for p in params]
        if len(set(names)) != len(names):
            raise ValueError(f"Duplicate param names: {names}")
        self._params: list[Param] = params
        self._bind_derived()

    @staticmethod
    def _as_param(p):
        if isinstance(p, Param):
            return p
        # duck-typed param views (e.g. Detectors' suffixed-param proxies)
        if hasattr(p, "name") and hasattr(p, "prior_penalty"):
            return p
        if isinstance(p, dict):
            if "depends_names" in p or "function" in p:
                return DerivedParam.from_state(p)
            return Param.from_state(p)
        raise TypeError(f"Cannot interpret param {p!r}")

    def _bind_derived(self):
        for p in self._params:
            if isinstance(p, DerivedParam) and p.depends_names:
                try:
                    p.bind(self)
                except KeyError:
                    pass  # dependencies may arrive later via update/extend

    # -- sequence protocol ---------------------------------------------------
    def __len__(self):
        return len(self._params)

    def __getitem__(self, key):
        if isinstance(key, int):
            return self._params[key]
        if isinstance(key, slice):
            return ParamSet(self._params[key])
        if isinstance(key, str):
            for p in self._params:
                if p.name == key:
                    return p
            raise KeyError(
                f"No param named {key!r}; have {self.names}"
            )
        if isinstance(key, Param):
            return self[key.name]
        raise TypeError(f"Cannot index ParamSet with {key!r}")

    def __setitem__(self, key, value):
        if isinstance(key, int):
            self._params[key] = self._as_param(value)
        else:
            raise TypeError("Can only set by integer index")
        self._bind_derived()

    def __delitem__(self, key):
        if isinstance(key, str):
            self._params.remove(self[key])
        else:
            del self._params[key]

    def insert(self, index, value):
        self._params.insert(index, self._as_param(value))
        self._bind_derived()

    def __iter__(self):
        return iter(self._params)

    def __contains__(self, item):
        name = item.name if isinstance(item, Param) else item
        return any(p.name == name for p in self._params)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        for p in self.__dict__.get("_params", ()):
            if p.name == name:
                return p
        raise AttributeError(name)

    # -- update / merge -----------------------------------------------------
    def update(self, obj, existing_must_match=False, extend=True):
        """Merge `obj` (Param or ParamSet). With `existing_must_match`, a
        same-named incoming param must equal the existing one; the existing
        *object* is kept so identity-sharing is preserved
        (cf. reference ``pipeline.py:342-346``)."""
        if isinstance(obj, Param):
            obj = [obj]
        for p in obj:
            p = self._as_param(p)
            if p.name in self:
                existing = self[p.name]
                if existing_must_match and existing != p:
                    raise ValueError(
                        f"Param {p.name!r} conflicts with existing:"
                        f" {existing.hashable_state} vs {p.hashable_state}"
                    )
                if existing is not p:
                    # replace so callers end up sharing the same object
                    idx = self._params.index(existing)
                    self._params[idx] = p
            elif extend:
                self._params.append(p)
        self._bind_derived()

    def extend(self, obj):
        self.update(obj, extend=True)

    def replace(self, new):
        """Replace the same-named param with `new` (object identity swap)."""
        idx = self._params.index(self[new.name])
        self._params[idx] = new
        self._bind_derived()

    # -- views --------------------------------------------------------------
    @property
    def names(self):
        return tuple(p.name for p in self._params)

    @property
    def values(self):
        return tuple(p.value for p in self._params)

    @values.setter
    def values(self, values):
        if len(values) != len(self._params):
            raise ValueError("Length mismatch")
        for p, v in zip(self._params, values):
            p.value = v

    @property
    def name_val_dict(self):
        return {p.name: p.value for p in self._params}

    @property
    def is_nominal(self):
        return all(
            recursiveEquality(p.value, p.nominal_value) for p in self._params
        )

    @property
    def nominal_values(self):
        return tuple(p.nominal_value for p in self._params)

    @property
    def are_fixed(self):
        return tuple(p.is_fixed for p in self._params)

    @property
    def are_discrete(self):
        return tuple(p.is_discrete for p in self._params)

    @property
    def free(self) -> "ParamSet":
        return ParamSet([p for p in self._params if not p.is_fixed])

    @property
    def fixed(self) -> "ParamSet":
        return ParamSet([p for p in self._params if p.is_fixed])

    @property
    def continuous(self) -> "ParamSet":
        return ParamSet([p for p in self._params if not p.is_discrete])

    @property
    def discrete(self) -> "ParamSet":
        return ParamSet([p for p in self._params if p.is_discrete])

    def fix(self, names):
        for n in self._iter_names(names):
            self[n].is_fixed = True

    def unfix(self, names):
        for n in self._iter_names(names):
            self[n].is_fixed = False

    @staticmethod
    def _iter_names(names):
        if isinstance(names, (str, Param)):
            names = [names]
        return [n.name if isinstance(n, Param) else n for n in names]

    # -- fitting interface ---------------------------------------------------
    @property
    def _rescaled_values(self):
        return tuple(p._rescaled_value for p in self._params)

    @_rescaled_values.setter
    def _rescaled_values(self, vals):
        if len(vals) != len(self._params):
            raise ValueError("Length mismatch")
        for p, v in zip(self._params, vals):
            p._rescaled_value = v

    def priors_penalty(self, metric):
        # daemonflux switch (cf. reference ``param.py:1388-1402``): when a
        # daemon_chi2 param is present, the daemon_* params' penalty is the
        # single covariance chi2 the flux stage computed, not their
        # individual priors
        if "daemon_chi2" in self.names:
            from pisa_tpu.utils import stats

            total = sum(
                p.prior_penalty(metric)
                for p in self._params
                if "daemon_" not in p.name
            )
            conv = -0.5 if metric in stats.METRICS_TO_MAXIMIZE else 1.0
            return total + conv * self["daemon_chi2"].value.m_as(
                "dimensionless"
            )
        return sum(p.prior_penalty(metric) for p in self._params)

    def priors_penalties(self, metric):
        return tuple(p.prior_penalty(metric) for p in self._params)

    @property
    def priors_llh(self):
        return self.priors_penalty("llh")

    @property
    def priors_chi2(self):
        return self.priors_penalty("chi2")

    def randomize_free(self, random_state=None):
        rs = get_random_state(random_state)
        for p in self._params:
            if not p.is_fixed:
                p.randomize(rs)

    def reset_all(self):
        for p in self._params:
            p.reset()

    def reset_free(self):
        for p in self._params:
            if not p.is_fixed:
                p.reset()

    def set_nominal_by_current_values(self):
        for p in self._params:
            p.set_nominal_to_current_value()

    # -- covariance ----------------------------------------------------------
    def add_covariance(self, covmat: dict) -> None:
        """Rotate correlated params into an uncorrelated basis: new free
        ``<name>_rotated`` params with zero-centered gaussian priors are
        added, the originals become DerivedParams (affine functions of the
        rotated ones). Cf. reference ``param.py:949``."""
        names = list(covmat.keys())
        dim = len(names)
        if dim == 0:
            return
        cov = np.zeros((dim, dim))
        for i, ki in enumerate(names):
            if ki not in self:
                raise KeyError(f"Param {ki!r} not in ParamSet")
            if not isinstance(covmat[ki], dict):
                raise TypeError("covmat entries must be dicts")
            for j, kj in enumerate(names):
                cov[i, j] = covmat[ki].get(kj, 0.0)
        if np.linalg.det(cov) < 0:
            raise ValueError("Covariance matrix must be positive definite")

        params = [self[n] for n in names]
        means = []
        for p in params:
            if p.prior is not None and p.prior.kind == "gaussian":
                means.append(p.prior.mean.m_as(p.units))
            elif p.prior is None or p.prior.kind == "uniform":
                means.append(
                    0.5
                    * (p.range[0].m_as(p.units) + p.range[1].m_as(p.units))
                )
            else:
                raise NotImplementedError(
                    f"No mean available for prior kind {p.prior.kind!r}"
                )

        evals, inv_t = np.linalg.eig(cov)
        new_sigmas = np.sqrt(evals)
        if np.any(np.abs(new_sigmas) < 1e-20):
            raise ValueError(
                "Zero-width rotated param: inputs may be linearly dependent"
            )
        transformation = np.linalg.inv(inv_t)

        ranges = [
            (p.range[0].m_as(p.units), p.range[1].m_as(p.units))
            for p in params
        ]

        rotated = []
        for i, p in enumerate(params):
            v_max, v_min = 0.0, 0.0
            for j in range(dim):
                t = inv_t[j][i]
                hi_c = ranges[j][1] - means[j]
                lo_c = ranges[j][0] - means[j]
                v_max += t * hi_c if t > 0 else t * lo_c
                v_min += t * hi_c if t < 0 else t * lo_c
            newp = Param(
                name=p.name + "_rotated",
                value=0.0 * ureg.dimensionless,
                prior=Prior(
                    kind="gaussian", mean=0.0, stddev=float(new_sigmas[i])
                ),
                range=(float(v_min), float(v_max)),
                is_fixed=False,
                tex=p.tex + r"^{\mathrm{rot}}",
            )
            rotated.append(newp)
        for newp in rotated:
            self._params.append(newp)

        # originals become derived: x_i = mean_i + sum_j T^-1[i,j] * v_j
        for i, p in enumerate(params):
            acc = None
            for j in range(dim):
                # x = v @ T^-1 + mu  =>  x_i = sum_j T^-1[j,i] * v_j + mu_i
                term = float(transformation[j][i]) * Var(
                    rotated[j].name
                )
                acc = term if acc is None else acc + term
            acc = acc + float(means[i])
            derived = DerivedParam(
                name=p.name,
                value=p.value,
                depends_names=[r.name for r in rotated],
                function=acc,
                tex=p.tex,
            )
            idx = self._params.index(p)
            self._params[idx] = derived
        self._bind_derived()

    # -- identity / serialization --------------------------------------------
    @property
    def values_hash(self):
        return hash_obj(
            [
                v.magnitude if isinstance(v, Quantity) else v
                for v in self.values
            ]
            + [str(v.units) if isinstance(v, Quantity) else "" for v in self.values],
            sigfigs=HASH_SIGFIGS,
        )

    @property
    def nominal_values_hash(self):
        return hash_obj(
            [
                v.magnitude if isinstance(v, Quantity) else v
                for v in self.nominal_values
            ],
            sigfigs=HASH_SIGFIGS,
        )

    @property
    def hash(self):
        return hash_obj([p.hashable_state for p in self._params])

    @property
    def state(self):
        return [p.state for p in self._params]

    @property
    def serializable_state(self):
        return self.state

    @classmethod
    def from_state(cls, state):
        return cls(state)

    def to_json(self, filename, **kwargs):
        from pisa_tpu.utils.jsons import to_json

        to_json(self.state, filename, **kwargs)

    @classmethod
    def from_json(cls, filename):
        from pisa_tpu.utils.jsons import from_json

        return cls.from_state(from_json(filename))

    def __eq__(self, other):
        if not isinstance(other, ParamSet):
            return False
        return self.names == other.names and all(
            a == b for a, b in zip(self._params, other._params)
        )

    def __ne__(self, other):
        return not self == other

    def __str__(self):
        inner = ", ".join(
            f"{p.name}={p.value}{'' if p.is_fixed else ' (free)'}"
            for p in self._params
        )
        return f"ParamSet({inner})"

    __repr__ = __str__


class ParamSelector:
    """Groups of alternate parameter values selected by name (e.g. 'nh' vs
    'ih' oscillation params); cf. reference ``param.py:1604``.

    Parameters
    ----------
    regular_params : ParamSet or list, optional
    selector_param_sets : dict of selector -> ParamSet/list, optional
    selections : str or list of str, optional
        Initially-selected selector names.
    """

    def __init__(
        self, regular_params=None, selector_param_sets=None, selections=None
    ):
        self._regular_params = ParamSet(regular_params or [])
        self._selector_params: dict[str, ParamSet] = {}
        if selector_param_sets:
            for sel, ps in selector_param_sets.items():
                self._selector_params[str(sel).strip().lower()] = ParamSet(ps)
        self._selections = []
        self._current = ParamSet(self._regular_params)
        if selections is not None:
            self.select_params(selections)
        else:
            self._rebuild()

    @property
    def params(self) -> ParamSet:
        return self._current

    @property
    def param_selections(self):
        return list(self._selections)

    @property
    def selections(self):
        return list(self._selections)

    def _rebuild(self):
        current = ParamSet()
        for sel in self._selections:
            if sel in self._selector_params:
                current.update(self._selector_params[sel])
        # regular params: only add names not overridden by selections
        for p in self._regular_params:
            if p.name not in current:
                current.extend(p)
        self._current = current

    def select_params(self, selections=None, error_on_missing=False):
        if selections is None:
            self._rebuild()
            return
        if isinstance(selections, str):
            selections = selections.split(",")
        selections = [str(s).strip().lower() for s in selections]
        missing = [
            s for s in selections if s not in self._selector_params
        ]
        if missing and error_on_missing:
            raise KeyError(
                f"Selections {missing} not found; have"
                f" {list(self._selector_params)}"
            )
        self._selections = selections
        self._rebuild()
        return self._current

    def get_selector_params(self, selector):
        return self._selector_params.get(str(selector).strip().lower())

    def update(self, other, existing_must_match=False):
        """Merge another ParamSelector or ParamSet (regular params)."""
        if isinstance(other, ParamSelector):
            self._regular_params.update(
                other._regular_params, existing_must_match=existing_must_match
            )
            for sel, ps in other._selector_params.items():
                if sel in self._selector_params:
                    self._selector_params[sel].update(
                        ps, existing_must_match=existing_must_match
                    )
                else:
                    self._selector_params[sel] = ParamSet(ps)
        else:
            ps = other if isinstance(other, ParamSet) else ParamSet(other)
            for p in ps:
                placed = False
                for sel_ps in self._selector_params.values():
                    if p.name in sel_ps:
                        sel_ps.update(
                            p, existing_must_match=existing_must_match
                        )
                        placed = True
                if p.name in self._regular_params or not placed:
                    self._regular_params.update(
                        p, existing_must_match=existing_must_match
                    )
        self._rebuild()

    def add_selector_param(self, selector, param):
        selector = str(selector).strip().lower()
        self._selector_params.setdefault(selector, ParamSet()).update(param)
        self._rebuild()

    def get(self, name, selector=None) -> Param:
        """Param by name, from the given selector group or the regular set
        (raises KeyError if absent; cf. reference ``ParamSelector.get``)."""
        if selector is not None:
            sel = str(selector).strip().lower()
            if sel in self._selector_params and name in self._selector_params[sel]:
                return self._selector_params[sel][name]
            raise KeyError(f"No param {name!r} under selector {selector!r}")
        if name in self._regular_params:
            return self._regular_params[name]
        # fall back: search all selector groups for a unique match
        for ps in self._selector_params.values():
            if name in ps:
                return ps[name]
        raise KeyError(f"No param {name!r} in selector")

    def update_param(self, param, selector=None, existing_must_match=False):
        """Place `param` under `selector` (or the regular set)."""
        if selector is None:
            self._regular_params.update(
                param, existing_must_match=existing_must_match
            )
        else:
            sel = str(selector).strip().lower()
            self._selector_params.setdefault(sel, ParamSet()).update(
                param, existing_must_match=existing_must_match
            )
        self._rebuild()

    def __iter__(self):
        seen = set()
        for ps in [self._regular_params, *self._selector_params.values()]:
            for p in ps:
                if id(p) not in seen:
                    seen.add(id(p))
                    yield p
