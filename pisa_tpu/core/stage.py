"""
Stage base class (cf. reference ``pisa/core/stage.py:26``).

A Stage is one step of a pipeline (a "service"): ``setup_function`` runs once
(load events, precompute geometry), ``compute_function`` re-runs when params
change (physics factors), ``apply_function`` runs every evaluation (weight
multiplication). ``compute`` is cached on the params hash exactly like the
reference (``stage.py:536-557``); the cache is bypassed while a pipeline is
being traced into a compiled template function.
"""

from __future__ import annotations

from pisa_tpu.core.binning import MultiDimBinning
from pisa_tpu.core.param import ParamSelector, ParamSet
from pisa_tpu.utils.log import logging

__all__ = ["Stage"]


class Stage:
    """Base class for all services.

    Parameters
    ----------
    data : ContainerSet, optional
    params : ParamSet, ParamSelector, or sequence, optional
    expected_params : sequence of str
        Param names this service requires.
    expected_container_keys : sequence of str
        Container variables this service expects to exist.
    debug_mode : None or str
    error_method : None or str (e.g. 'sumw2')
    calc_mode : 'events' or MultiDimBinning, optional
        Representation selected before compute_function.
    apply_mode : 'events' or MultiDimBinning, optional
        Representation selected before apply_function.
    profile : bool
    in_standalone_mode : bool
    supported_reps : dict, optional
        Optional constraints: keys 'calc_mode'/'apply_mode' mapping to lists
        of allowed representation types (MultiDimBinning or 'events').
    """

    def __init__(
        self,
        data=None,
        params=None,
        expected_params=None,
        expected_container_keys=None,
        debug_mode=None,
        error_method=None,
        calc_mode=None,
        apply_mode=None,
        profile=False,
        in_standalone_mode=False,
        supported_reps=None,
    ):
        module_path = self.__class__.__module__.split(".")
        self.stage_name = module_path[-2] if len(module_path) >= 2 else ""
        self.service_name = self.__class__.__name__
        self.data = data
        self.debug_mode = debug_mode
        self.error_method = error_method
        self.calc_mode = calc_mode
        self.apply_mode = apply_mode
        self.profile = profile
        self.in_standalone_mode = in_standalone_mode
        self.supported_reps = supported_reps or {}
        self.expected_container_keys = tuple(expected_container_keys or ())
        self.setup_times = []
        self.calc_times = []
        self.apply_times = []

        if isinstance(params, ParamSelector):
            self._param_selector = params
        elif isinstance(params, ParamSet):
            self._param_selector = ParamSelector(regular_params=params)
        elif params is None:
            self._param_selector = ParamSelector()
        else:
            self._param_selector = ParamSelector(regular_params=ParamSet(params))

        self.expected_params = tuple(expected_params or ())
        self._check_params()

        self.param_hash = None
        self._trace_mode = False  # disables the compute cache while tracing

    #: class-level opt-in: the service's compute/apply functions handle a
    #: StackedContainer (category-stacked arrays; see
    #: :mod:`pisa_tpu.core.stacking`). CompiledTemplate stacks a pipeline's
    #: containers only when every traced stage opts in.
    supports_stacked = False

    def stacked_ok(self):
        """Whether THIS instance (with its configured modes) can run on a
        stacked ContainerSet; override for mode-dependent support."""
        return self.supports_stacked

    def prepare_stacked(self, data):
        """Hook: one-time concrete precomputation on the freshly stacked
        ContainerSet (e.g. cached one-hot histogram matrices), called by
        CompiledTemplate before tracing. Default: nothing."""

    def stacking_exclude_keys(self):
        """Container keys this stage wants OMITTED from the stacked copy —
        per-container helper arrays whose leading axis is not the event
        axis (e.g. prob3's point orderings / pre-blocked kernel geometry in
        events calc mode), which cannot pad-stack and which the stacked
        code path does not read. Default: none."""
        return ()

    #: Rate-deferral contract (stacked grid-calc templates; see
    #: CompiledTemplate._setup_rate_deferral): True declares that this
    #: stage is safe to run in a template whose oscillation stage DEFERS
    #: the flux x probability rate to the histogram stage as a grid-level
    #: factor — i.e. the stage either never touches event-representation
    #: 'weights', applies at the binned representation only, or multiplies
    #: event weights by (static per-event field) x (per-category scalar).
    #: Under deferral the factorized histogram H[c, b] =
    #: s_c * sum_g rate[row_c, g] * S_c[g, b] replaces the 240k-index
    #: grid->events gather and its reverse-mode scatter with one static
    #: dense contraction. Default False: any undeclared
    #: stage in the lineup disables deferral.
    stacked_rate_defer_safe = False

    #: Container keys of STATIC per-event weight factors this stage
    #: multiplies into 'weights' (e.g. aeff's 'weighted_aeff'); folded into
    #: the factorized histogram's setup-time matrices.
    stacked_static_weight_keys = ()

    def stacked_rate_defer_ok(self):
        """Whether THIS instance (with its configured modes) honors the
        rate-deferral contract; override for mode-dependent safety."""
        return self.stacked_rate_defer_safe

    # -- params ---------------------------------------------------------------
    @property
    def params(self) -> ParamSet:
        return self._param_selector.params

    @property
    def param_selections(self):
        return self._param_selector.param_selections

    def select_params(self, selections, error_on_missing=False):
        self._param_selector.select_params(
            selections, error_on_missing=error_on_missing
        )
        self._check_params()

    def _check_params(self):
        have = set(self.params.names)
        want = set(self.expected_params)
        missing = want - have
        excess = have - want
        if missing:
            raise ValueError(
                f"{self.stage_name}.{self.service_name}: missing expected"
                f" params {sorted(missing)} (have {sorted(have)})"
            )
        if excess:
            logging.debug(
                "%s.%s: unused params %s",
                self.stage_name,
                self.service_name,
                sorted(excess),
            )

    # -- container key validation ---------------------------------------------
    def _check_exp_keys_in_data(self, error_on_missing=False):
        if self.data is None or not self.expected_container_keys:
            return True
        for container in self.data:
            missing = [
                k
                for k in self.expected_container_keys
                if k not in container
            ]
            if missing:
                msg = (
                    f"{self.stage_name}.{self.service_name}: container"
                    f" {container.name!r} missing expected keys {missing}"
                )
                if error_on_missing:
                    raise KeyError(msg)
                logging.debug(msg)
                return False
        return True

    # -- lifecycle ------------------------------------------------------------
    @property
    def is_map(self):
        return isinstance(self.calc_mode, MultiDimBinning)

    def setup(self):
        if self.data is None and not self.in_standalone_mode:
            raise ValueError(f"{self}: no data container set")
        if self.calc_mode is not None and self.data is not None:
            self.data.representation = self.calc_mode
        if self.profile:
            import time as _time

            t0 = _time.time()
            self.setup_function()
            self.setup_times.append(_time.time() - t0)
        else:
            self.setup_function()
        if not self.in_standalone_mode:
            self._check_exp_keys_in_data(error_on_missing=False)

    def setup_function(self):
        """Override: one-time setup."""

    def compute(self):
        if len(self.params) == 0 and len(self.expected_container_keys) == 0:
            return
        if not self._trace_mode:
            new_param_hash = self.params.values_hash
            if new_param_hash == self.param_hash:
                logging.trace("cached %s.compute", self.service_name)
                return
        if self.calc_mode is not None:
            self.data.representation = self.calc_mode
        if self.profile and not self._trace_mode:
            import time as _time

            t0 = _time.time()
            self.compute_function()
            self.calc_times.append(_time.time() - t0)
        else:
            self.compute_function()
        if not self._trace_mode:
            self.param_hash = self.params.values_hash

    def compute_function(self):
        """Override: parameter-dependent computation."""

    def apply(self):
        if self.apply_mode is not None:
            self.data.representation = self.apply_mode
        if self.profile and not self._trace_mode:
            import time as _time

            t0 = _time.time()
            self.apply_function()
            self.apply_times.append(_time.time() - t0)
        else:
            self.apply_function()

    def apply_function(self):
        """Override: per-evaluation application (weights *= ...)."""

    def run(self):
        self.compute()
        self.apply()

    def __str__(self):
        return f"{self.stage_name}.{self.service_name}"

    __repr__ = __str__

    @property
    def has_calc_mode(self):
        return self.calc_mode is not None

    @property
    def has_apply_mode(self):
        return self.apply_mode is not None
