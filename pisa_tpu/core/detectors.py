"""
Detectors: joint fits over several detectors (cf. reference
``pisa/core/detectors.py:36``).

Groups pipelines by ``detector_name`` into one DistributionMaker each and
exposes a joint ParamSet: shared params appear once; same-named non-shared
params get a ``_<detector_name>`` suffix (the first detector keeps the bare
name) (cf. reference ``detectors.py:209-238``).

Delta from the reference: instead of the reference's deepcopy-rename + re-sync-on-
hash-change dance, *shared* params are made shared by object identity across
the distribution makers (one Param object, exactly like param sharing inside
a pipeline), so setting them anywhere updates every detector with no
synchronization step. Only suffixed (detector-private, name-colliding)
params need a proxy, handled by value forwarding on access.
"""

from __future__ import annotations

import numpy as np

from pisa_tpu.core.distribution_maker import DistributionMaker
from pisa_tpu.core.param import Param, ParamSet
from pisa_tpu.core.pipeline import Pipeline
from pisa_tpu.utils.random_numbers import get_random_state

__all__ = ["Detectors"]


class _SuffixedParam:
    """Lightweight forwarding proxy: a detector-private param exposed in the
    joint ParamSet under ``<name>_<detector>``. All state lives on the
    wrapped Param; only the externally-visible name differs."""

    __slots__ = ("_target", "name")

    def __init__(self, target, name):
        object.__setattr__(self, "_target", target)
        object.__setattr__(self, "name", name)

    def __getattr__(self, attr):
        return getattr(object.__getattribute__(self, "_target"), attr)

    def __setattr__(self, attr, value):
        if attr == "name":
            object.__setattr__(self, attr, value)
        else:
            setattr(object.__getattribute__(self, "_target"), attr, value)

    def __repr__(self):
        return f"<{self.name} -> {object.__getattribute__(self, '_target')!r}>"


class Detectors:
    """Parameters
    ----------
    pipelines : config path(s) / Pipeline(s)
    shared_params : list of str
        param names treated as one parameter across all detectors.
    """

    def __init__(self, pipelines, label=None, shared_params=None, profile=False):
        self.label = label
        self.shared_params = list(shared_params or [])

        if isinstance(pipelines, (str, Pipeline)):
            pipelines = [pipelines]

        self._distribution_makers = []
        self.det_names = []
        groups = {}
        for pipeline in pipelines:
            if not isinstance(pipeline, Pipeline):
                pipeline = Pipeline(pipeline, profile=profile)
            name = pipeline.detector_name
            groups.setdefault(name, []).append(pipeline)
        for name, group in groups.items():
            self.det_names.append(name)
            self._distribution_makers.append(
                DistributionMaker(group, label=name, profile=profile)
            )

        if None in self.det_names and len(self.det_names) > 1:
            raise NameError(
                "At least one of the used pipelines has no detector_name."
            )

        # validate shared params (cf. reference detectors.py:85-95)
        for sp in self.shared_params:
            n_have = sum(
                sp in dm.params.names for dm in self._distribution_makers
            )
            n_free = sum(
                sp in dm.params.free.names
                for dm in self._distribution_makers
            )
            if n_have < 2:
                raise NameError(
                    f"Shared param {sp} only exists in {n_have} detectors."
                )
            if n_free > 0 and n_free != n_have:
                raise NameError(
                    f"Shared param {sp} exists in {n_have} detectors but is"
                    f" free in only {n_free}."
                )

        # make shared params shared by OBJECT IDENTITY across detectors
        for sp in self.shared_params:
            master = None
            for dm in self._distribution_makers:
                if sp in dm.params.names:
                    if master is None:
                        master = dm.params[sp]
                    else:
                        dm.update_params(
                            ParamSet([master]), existing_must_match=False
                        )

        self.init_params()

    # -- interface --------------------------------------------------------------
    def __iter__(self):
        return iter(self._distribution_makers)

    def __len__(self):
        return len(self._distribution_makers)

    @property
    def distribution_makers(self):
        return self._distribution_makers

    @property
    def detector_names(self):
        return self.det_names

    def init_params(self):
        """Joint ParamSet: shared once, then per-detector; collisions
        suffixed with the detector name (cf. reference :209-238)."""
        params = []
        seen = {}
        for sp in self.shared_params:
            for dm in self._distribution_makers:
                if sp in dm.params.names:
                    params.append(dm.params[sp])
                    seen[sp] = True
                    break
        for dm, det in zip(self._distribution_makers, self.det_names):
            for param in dm.params:
                if param.name in self.shared_params:
                    continue
                if param.name in seen:
                    proxy = _SuffixedParam(param, f"{param.name}_{det}")
                    params.append(proxy)
                else:
                    params.append(param)
                    seen[param.name] = True
        self._params = ParamSet(params)

    @property
    def params(self) -> ParamSet:
        return self._params

    @property
    def param_selections(self):
        selections = None
        for dm in self._distribution_makers:
            s = sorted(dm.param_selections)
            if selections is not None and s != selections:
                raise AssertionError(
                    "Different param_selections for different detectors."
                )
            selections = s
        return selections

    def select_params(self, selections, error_on_missing=True):
        for dm in self._distribution_makers:
            dm.select_params(selections, error_on_missing=error_on_missing)
        self.init_params()

    def run(self):
        for dm in self._distribution_makers:
            dm.run()

    def setup(self):
        for dm in self._distribution_makers:
            dm.setup()

    def get_outputs(self, **kwargs):
        """List of per-detector outputs (MapSets if return_sum=True)."""
        return [dm.get_outputs(**kwargs) for dm in self._distribution_makers]

    # -- fitting interface --------------------------------------------------------
    def set_free_params(self, values):
        free = self.params.free
        if len(values) != len(free):
            raise ValueError(
                f"Got {len(values)} values for {len(free)} free params"
            )
        for p, v in zip(free, values):
            p.value = v

    def _set_rescaled_free_params(self, rvalues):
        free = self.params.free
        if len(rvalues) != len(free):
            raise ValueError(
                f"Got {len(rvalues)} values for {len(free)} free params"
            )
        for p, v in zip(free, rvalues):
            p._rescaled_value = float(v)

    def randomize_free_params(self, random_state=None):
        rs = get_random_state(random_state)
        self.params.randomize_free(rs)

    def reset_all(self):
        for dm in self._distribution_makers:
            dm.reset_all()

    def reset_free(self):
        for dm in self._distribution_makers:
            dm.reset_free()

    def set_nominal_by_current_values(self):
        for dm in self._distribution_makers:
            dm.set_nominal_by_current_values()

    @property
    def shared_param_ind_list(self):
        """Per detector: positions of shared params in that detector's free
        params, with their index in the shared list (cf. reference :238)."""
        if not self.shared_params:
            return []
        out = []
        for dm in self._distribution_makers:
            free_names = dm.params.free.names
            out.append(
                [
                    (free_names.index(n), self.shared_params.index(n))
                    for n in free_names
                    if n in self.shared_params
                ]
            )
        return out

    @property
    def num_events_per_bin(self):
        return [dm.num_events_per_bin for dm in self._distribution_makers]

    @property
    def empty_bin_indices(self):
        return [
            np.where(np.asarray(n) == 0)[0] for n in self.num_events_per_bin
        ]

    def __str__(self):
        return (
            f"Detectors({self.det_names}, shared={self.shared_params})"
        )
