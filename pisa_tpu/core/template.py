"""
Compiled template evaluation: one jitted, differentiable function for an
entire pipeline.

This is the central redesign (SURVEY §7.1): instead of the
reference's per-stage compute/apply with param-hash caches, the whole stage
chain is traced once into a pure XLA program

    rescaled_free_params (vector in [0,1]^n) -> {category: flat binned hist}

making a minimizer iteration a single device execution, and enabling
``jax.grad`` of any metric w.r.t. the physics parameters — replacing the
reference's finite-difference gradients (~2*N templates per step,
``analysis.py:1561``).

Mechanics: free params' magnitudes are injected into the shared Param
objects as JAX tracers (wrapped in unit-tagged Quantities so stage code is
unchanged); stage compute caches are bypassed; container states are
snapshotted and restored around tracing so the eager path stays usable.

Params whose effects run through host-side precomputation (Earth-layer
geometry from Ye fractions, file paths, RNG seeds) cannot be traced; stages
declare them via ``host_param_names`` and they must be fixed when compiling.
"""

from __future__ import annotations

import os

import numpy as np

import jax
import jax.numpy as jnp

from pisa_tpu.core.map import Map, MapSet
from pisa_tpu.units import Quantity
from pisa_tpu.utils.log import logging

__all__ = ["CompiledTemplate"]

# params that steer host-side precomputation and hence cannot be traced
HOST_PARAM_NAMES = {
    "earth_model",
    "detector_depth",
    "prop_height",
    "YeI",
    "YeO",
    "YeM",
    "density_scale",
    "core_density_scale",
    "innermantle_density_scale",
    "middlemantle_density_scale",
    "n_events",
    "seed",
    "random",
}
# NSI/decay/LRI couplings are NOT host params: prob3 builds their matrices
# with the trace-safe split-complex builders (ops/osc/nonstandard.py), so
# compiled templates take analytic gradients w.r.t. them.


class CompiledTemplate:
    """Jitted ``rescaled free params -> histograms`` for a Pipeline.

    Parameters
    ----------
    pipeline : Pipeline
    output_binning : MultiDimBinning
    output_key : str or (key, error_key)

    Notes
    -----
    The returned callable evaluates in the *rescaled* [0,1] parameter space
    used by minimizers (cf. reference ``param.py:358``); conversion to
    physical magnitudes happens inside the traced function so gradients flow.
    """

    def __init__(self, pipeline, output_binning, output_key):
        self.pipeline = pipeline
        self.output_binning = output_binning
        if isinstance(output_key, (tuple, list)):
            self.output_key, self.error_key = output_key[0], output_key[1]
        else:
            self.output_key, self.error_key = output_key, None

        # host params: the global default blacklist plus whatever each stage
        # declares via a `host_param_names` attribute (preferred; new stages
        # with host-side precomputation must declare theirs)
        host_params = set(HOST_PARAM_NAMES)
        for stage in pipeline.stages:
            host_params.update(getattr(stage, "host_param_names", ()))

        free = pipeline.params.free
        for p in free:
            if p.name in host_params:
                raise ValueError(
                    f"Free param {p.name!r} steers host-side precomputation"
                    " and cannot be part of a compiled template; fix it or"
                    " use the eager path"
                )
        self.free_names = list(free.names)
        self._free_params = list(free)
        # static rescaling data per free param
        self._rescale = []
        for p in free:
            lo = p.range[0].m_as(p.units)
            hi = p.range[1].m_as(p.units)
            self._rescale.append((float(lo), float(hi), bool(p.scales_as_log)))
        self.names = list(pipeline.data.names) if pipeline.data.names else None

        # Constant-stage hoisting: the leading prefix of stages with no
        # free-parameter dependence is executed ONCE here (eagerly,
        # concretely) and its container writes ride along as device
        # arguments; only the remaining stages are traced into the
        # per-template program. This is the compiled-template analog of the
        # reference's per-stage param-hash compute cache
        # (``pisa/core/stage.py:536-557``): a free-param-less stage's
        # output never changes between minimizer iterations, so
        # re-evaluating it per template is pure waste.
        self._hoisted_stages, self._traced_stages = self._split_stages()
        for stage in self._hoisted_stages:
            stage.run()

        # Container stacking (see pisa_tpu/core/stacking.py): when every
        # traced stage supports it, the per-category containers collapse
        # into ONE container with a leading category axis, cutting the
        # traced program's op count ~C-fold (the per-category op chains —
        # and especially their reverse-mode gradients — were latency-bound
        # small-fusion tails, not FLOPs). Disable with PISA_TPU_STACK=0.
        self._trace_data = pipeline.data
        self._build_stacked()

        self._place_container_data()
        self._populate_flatidx_caches()
        self._jitted = jax.jit(self._build_fn())
        self._grad_cache = {}

    def _split_stages(self):
        """(hoisted, traced): the maximal leading run of stages none of
        whose params is free (directly or through a DerivedParam
        dependency) is hoisted — run once at compile time; everything from
        the first free-param-dependent stage onward is traced per template.

        Only a PREFIX is safe: a free-param-less stage downstream of a
        traced one (e.g. utils.hist) consumes per-template values. Stages
        may opt out with a ``never_hoist = True`` attribute; the env flag
        ``PISA_TPU_HOIST=0`` disables hoisting entirely.
        """
        import os

        stages = list(self.pipeline.stages)
        if os.environ.get("PISA_TPU_HOIST", "1") in ("0", "off", "false"):
            return [], stages

        def _expand(p):
            # a DerivedParam is free-dependent if any dependency is
            yield p
            for dep in getattr(p, "dependson", {}).values() or ():
                yield from _expand(dep)

        free_ids = {id(p) for p in self._free_params}
        hoisted = []
        for stage in stages:
            depends_on_free = any(
                id(q) in free_ids for p in stage.params for q in _expand(p)
            )
            if depends_on_free or getattr(stage, "never_hoist", False):
                break
            hoisted.append(stage)
        return hoisted, stages[len(hoisted):]

    def _coord_keys(self):
        """Event keys that are binning coordinates (NaN-padded when stacking
        or pad-and-mask sharding): any dimension name of any binning the
        template touches."""
        coord_keys = set(self.output_binning.names)
        for stage in self.pipeline.stages:
            for mode in (stage.calc_mode, stage.apply_mode):
                if hasattr(mode, "names"):
                    coord_keys.update(mode.names)
        return coord_keys

    def _build_stacked(self, pad_multiple=1):
        """Try to stack the pipeline's containers for tracing; fall back
        silently (self._trace_data stays pipeline.data) when ineligible."""
        import os

        from pisa_tpu.core import stacking

        if os.environ.get("PISA_TPU_STACK", "1") in ("0", "off", "false"):
            return
        if len(self.pipeline.data.containers) < 2:
            return
        unsupported = [
            str(s) for s in self._traced_stages if not s.stacked_ok()
        ]
        if unsupported:
            logging.debug(
                "stacking disabled: stages without stacked support: %s",
                unsupported,
            )
            return
        exclude = set()
        for s in self._traced_stages:
            exclude.update(s.stacking_exclude_keys())
        try:
            self._trace_data = stacking.build_stacked_set(
                self.pipeline.data, coord_keys=self._coord_keys(),
                pad_multiple=pad_multiple, exclude_keys=exclude,
            )
        except stacking.StackingError as exc:
            logging.info("stacking disabled: %s", exc)
            return
        for stage in self._traced_stages:
            stage.prepare_stacked(self._trace_data)
        logging.debug(
            "stacked %d containers (n_pad=%d) for template tracing",
            len(self.pipeline.data.containers),
            self._trace_data.containers[0].n_pad,
        )
        self._setup_rate_deferral()

    def _setup_rate_deferral(self):
        """Enable the factorized histogram when the stage lineup allows it:
        ONE grid-calc oscillation stage, ONE events->binned hist stage, and
        every other traced stage declaring ``stacked_rate_defer_ok`` (the
        category-scalar weight contract, core/stage.py). The osc stage then
        hands its (6, ngrid) flux x probability rate to the hist stage as a
        grid-level factor (prob3._apply_stacked) and the hist contracts it
        against static (grid x bins) matrices
        (hist.prepare_rate_defer) — replacing the grid->events gather and
        its reverse-mode scatter with dense matmuls.
        Kill switch: PISA_TPU_RATE_DEFER=0."""
        try:
            from pisa_tpu.stages.osc.prob3 import prob3 as _prob3
            from pisa_tpu.stages.utils.hist import hist as _hist
        except Exception:  # pragma: no cover
            return
        stages = self._traced_stages
        # stage objects are shared across template builds: reset both sides
        # of the handshake so a build that does NOT qualify can never leave
        # a stale deferral flag from an earlier one
        for s in stages:
            if isinstance(s, _prob3):
                s._defer_rate_to_hist = False
            if isinstance(s, _hist):
                s._defer = None
        if os.environ.get("PISA_TPU_RATE_DEFER", "1") in (
            "0", "off", "false"
        ):
            return
        oscs = [s for s in stages if isinstance(s, _prob3)]
        hists = [s for s in stages if isinstance(s, _hist)]
        if len(oscs) != 1 or len(hists) != 1:
            return
        osc, hs = oscs[0], hists[0]
        if not osc.is_map:
            return
        if stages.index(hs) < stages.index(osc):
            return
        others = [s for s in stages if s is not osc and s is not hs]
        if not all(s.stacked_rate_defer_ok() for s in others):
            return
        static_keys = []
        for s in others:
            static_keys.extend(s.stacked_static_weight_keys)
        try:
            ok = hs.prepare_rate_defer(
                self._trace_data, osc.calc_mode, static_keys
            )
        except Exception as exc:  # deferral must never break compilation
            logging.info("rate deferral disabled (%s)", exc)
            return
        if ok:
            osc._defer_rate_to_hist = True
            logging.info(
                "rate deferral ON: factorized histogram (%d static keys)",
                len(static_keys),
            )

    def _populate_flatidx_caches(self):
        """Discovery pass: abstractly trace the template once, recording
        every events<->binned translation whose param-independent flat bin
        indices could not be cached (coordinates were tracers), then compute
        those indices concretely and re-collect the data slots so they ride
        along as device arguments. Collapses the per-template bin searches
        (~35 ms/template on the IceCube-3y pipeline) into one-time setup
        work."""
        from pisa_tpu.core import container as container_mod

        fn = self._build_fn()
        vec_struct = jax.ShapeDtypeStruct(
            (len(self._free_params),), jnp.asarray(0.0).dtype
        )
        data_structs = [
            jax.ShapeDtypeStruct(v.shape, v.dtype) for v in self._data_vals
        ]
        misses = []
        container_mod._FLATIDX_RECORDER = misses
        try:
            jax.eval_shape(fn, vec_struct, data=data_structs)
        except Exception as exc:  # discovery must never break compilation
            logging.warning(
                "flat-index discovery trace failed (%s); falling back to"
                " inline bin searches", exc
            )
            misses = []
        finally:
            container_mod._FLATIDX_RECORDER = None
        seen = set()
        for c, events_rep, binning in misses:
            key = (id(c), hash(events_rep), hash(binning))
            if key in seen:
                continue
            seen.add(key)
            c.cached_flat_indices(binning, events_rep=events_rep)
        if seen:
            self._place_container_data()

    def _place_container_data(self):
        """device_put every container array once (bulk host->device copies)
        and record the (container, key, rep) slots so the arrays can be fed
        to the traced function as explicit *arguments* rather than closure
        constants. Embedded numpy constants are uploaded inside the first
        execution of every distinct compiled program, repaid again by every
        objective / batched / gradient variant (and read *back* during
        lowering when left as closed-over device buffers). As arguments they
        upload once,
        here, and never cross the wire again."""
        self._data_slots = []
        self._data_vals = []
        for container in self._trace_data.containers:
            for key, per_rep in container._data.items():
                for h, arr in per_rep.items():
                    if isinstance(arr, jax.Array) or (
                        isinstance(arr, np.ndarray) and arr.dtype != object
                    ):
                        placed = jax.device_put(arr)
                        per_rep[h] = placed
                        self._data_slots.append((container, key, h))
                        self._data_vals.append(placed)
            # cached translation indices ride along as arguments too (slot
            # key None marks a _flatidx entry keyed by `h`)
            for cache_key, arr in container._flatidx.items():
                placed = jax.device_put(arr)
                container._flatidx[cache_key] = placed
                self._data_slots.append((container, None, cache_key))
                self._data_vals.append(placed)

    # -- trace construction ----------------------------------------------------
    def _current_bounds(self):
        """Live param-range bounds (magnitudes) — passed as runtime inputs so
        range changes (octant / ranges fit strategies) do NOT recompile."""
        los, his = [], []
        for p in self._free_params:
            los.append(float(p.range[0].m_as(p.units)))
            his.append(float(p.range[1].m_as(p.units)))
        return np.asarray(los), np.asarray(his)

    def _magnitudes_from_rescaled(self, vec, los=None, his=None):
        if los is None or his is None:
            los, his = self._current_bounds()
        mags = []
        for i, (_, _, log_scale) in enumerate(self._rescale):
            v = vec[i]
            lo, hi = los[i], his[i]
            if log_scale:
                mag = jnp.exp(
                    v * (jnp.log(jnp.abs(hi)) - jnp.log(jnp.abs(lo)))
                ) * lo
            else:
                mag = lo + (hi - lo) * v
            mags.append(mag)
        return mags

    def _snapshot(self):
        state = []
        for c in self._trace_data.containers:
            state.append(
                (
                    c,
                    {k: dict(v) for k, v in c._data.items()},
                    {k: dict(v) for k, v in c.validity.items()},
                    c.representation,
                    dict(c._flatidx),
                    dict(c.rows) if hasattr(c, "rows") else None,
                )
            )
        return state

    @staticmethod
    def _restore(state):
        for c, data, validity, rep, flatidx, rows in state:
            c._data = data
            c.validity = validity
            c.representation = rep
            c._flatidx = flatidx
            if rows is not None:
                c.rows = rows

    def _build_fn(self):
        pipeline = self.pipeline

        def fn(vec, los=None, his=None, data=None):
            mags = self._magnitudes_from_rescaled(vec, los, his)
            snapshot = self._snapshot()
            saved_values = [p._value for p in self._free_params]
            for stage in pipeline.stages:
                stage._trace_mode = True
            swapped_data = self._trace_data is not pipeline.data
            if swapped_data:
                for stage in self._traced_stages:
                    stage.data = self._trace_data
            try:
                if data is not None:
                    # container data arrives as traced arguments; install
                    # into the (snapshotted) containers for the stage run
                    # (key None: cached flat-index entry keyed by `h`)
                    for (c, key, h), arr in zip(self._data_slots, data):
                        if key is None:
                            c._flatidx[h] = arr
                        else:
                            c._data[key][h] = arr
                for p, mag in zip(self._free_params, mags):
                    p._value = Quantity(mag, p.units)
                for stage in getattr(
                    self, "_traced_stages", pipeline.stages
                ):
                    stage.run()
                self._trace_data.representation = self.output_binning
                hists = {}
                errs = {}
                extras = {}
                for c in self._trace_data.containers:
                    if getattr(c, "is_stacked", False):
                        # unstack: one flat (size,) hist per category
                        stacked = jnp.asarray(c.expanded(self.output_key))
                        for i, nm in enumerate(c.cat_names):
                            hists[nm] = stacked[i].ravel()
                        if self.error_key is not None:
                            errstk = jnp.asarray(c.expanded(self.error_key))
                            for i, nm in enumerate(c.cat_names):
                                errs[nm] = errstk[i].ravel()
                        for key in ("llh_alphas", "llh_betas", "n_mc_events"):
                            if key in c.keys:
                                xs = jnp.asarray(c.expanded(key))
                                for i, nm in enumerate(c.cat_names):
                                    extras.setdefault(key, {})[nm] = xs[
                                        i
                                    ].ravel()
                        continue
                    hists[c.name] = jnp.asarray(c[self.output_key]).ravel()
                    if self.error_key is not None:
                        errs[c.name] = jnp.asarray(c[self.error_key]).ravel()
                    # generalized-llh inputs, when the pipeline produces them
                    for key in ("llh_alphas", "llh_betas", "n_mc_events"):
                        if key in c.keys:
                            extras.setdefault(key, {})[c.name] = jnp.asarray(
                                c[key]
                            ).ravel()
                out = {"hist": hists}
                if self.error_key is not None:
                    out["error"] = errs
                out.update(extras)
                return out
            finally:
                for p, v in zip(self._free_params, saved_values):
                    p._value = v
                for stage in pipeline.stages:
                    stage._trace_mode = False
                if swapped_data:
                    for stage in self._traced_stages:
                        stage.data = pipeline.data
                self._restore(snapshot)

        return fn

    # -- sharding ----------------------------------------------------------------
    def shard(self, mesh, axis_name="data"):
        """Shard the template's event/grid axis across a device mesh.

        Every container array is device_put with its event (and, where
        clean, grid-point) axis partitioned over `mesh`; XLA then partitions
        the compiled template program (SPMD), inserting the needed
        collectives (psum for binned reductions). Works on the stacked
        production program directly (see inline notes) — the multi-chip
        program IS the single-device fast path. The replacement for the
        reference's llh server farm
        (``pisa/utils/llh_server.py:64-120``). Returns self.
        """
        from pisa_tpu.parallel import (
            shard_containers, shard_stacked_containers,
        )

        n = mesh.devices.size
        if self._trace_data is not self.pipeline.data:
            # the category-STACKED container set (the production fast path;
            # pisa_tpu/core/stacking.py) shards as the SAME program: the
            # padded event axis is re-padded to a multiple of the mesh size
            # and partitioned (axis 1 of the (C, n_pad, ...) arrays), shared
            # calc-grid arrays partition on the grid axis, and the one-hot
            # histogram matmul reduces with a psum — matching the
            # reference's mode-independent container linking
            # (pisa/core/container.py:279-337)
            sc = self._trace_data.containers[0]
            if sc.n_pad % n != 0:
                # re-stack with the padding rounded up to the mesh size
                # (re-runs the stages' prepare_stacked hooks so cached
                # one-hot matrices / blocked geometry match the new n_pad)
                logging.debug(
                    "shard(): re-stacking with pad_multiple=%d"
                    " (n_pad %d %% %d != 0)", n, sc.n_pad, n,
                )
                self._trace_data = self.pipeline.data
                self._build_stacked(pad_multiple=n)
            if self._trace_data is not self.pipeline.data:
                import os

                shard_stacked_containers(
                    self._trace_data, mesh, axis_name=axis_name,
                    shard_grid=os.environ.get(
                        "PISA_TPU_SHARD_GRID", "1"
                    ) not in ("0", "off", "false"),
                )
            else:  # re-stacking unexpectedly fell back: shard per-container
                logging.warning(
                    "shard(): stacked re-pad failed; sharding per-container"
                )
                shard_containers(
                    self.pipeline.data, mesh, axis_name=axis_name,
                    coord_keys=self._coord_keys(),
                )
        else:
            shard_containers(
                self.pipeline.data, mesh, axis_name=axis_name,
                coord_keys=self._coord_keys(),
            )
        # refresh the data-argument slots with the sharded placements (jit
        # picks the partitioning up from the argument shardings)
        self._place_container_data()
        # repopulate flat-index caches invalidated by re-stacking / padding
        self._populate_flatidx_caches()
        self._jitted = jax.jit(self._build_fn())
        self._grad_cache = {}
        self._scan_totals_jit = None
        return self

    # -- evaluation -------------------------------------------------------------
    def __call__(self, rescaled_vector):
        """Raw evaluation: dict with 'hist' (and 'error') name->flat array."""
        los, his = self._current_bounds()
        return self._jitted(
            jnp.asarray(rescaled_vector), jnp.asarray(los), jnp.asarray(his),
            self._data_vals,
        )

    def current_rescaled_values(self):
        return np.asarray(
            [p._rescaled_value for p in self._free_params], dtype=np.float64
        )

    def scan_totals(self, vecs, data=None):
        """Summed-template totals for a sequence of rescaled parameter
        vectors, evaluated back-to-back INSIDE one device program.

        A ``lax.scan`` over the (n, n_free) parameter batch matches the
        access pattern of the on-device fit loops
        (:mod:`pisa_tpu.analysis.device_fit`) and of the reference's
        pipeline benchmark — N randomized templates evaluated one after
        another (``pisa/scripts/benchmark_pipeline_performance.py:196-223``)
        — but needs a single dispatch/synchronization instead of one per
        template, which matters through high-latency device transports.
        Returns an (n,) array of per-template summed bin counts.
        """
        if getattr(self, "_scan_totals_jit", None) is None:
            fn = self._build_fn()

            @jax.jit
            def scan_fn(vecs, los, his, data):
                def step(carry, v):
                    out = fn(v, los, his, data=data)
                    tot = sum(jnp.sum(h) for h in out["hist"].values())
                    return carry, tot

                _, tots = jax.lax.scan(
                    step, jnp.zeros((), dtype=vecs.dtype), vecs
                )
                return tots

            self._scan_totals_jit = scan_fn
        los, his = self._current_bounds()
        return self._scan_totals_jit(
            jnp.asarray(vecs),
            jnp.asarray(los),
            jnp.asarray(his),
            self._data_vals if data is None else data,
        )

    def get_outputs(self, rescaled_vector=None) -> MapSet:
        """Host-side MapSet (mirrors Pipeline.get_outputs)."""
        if rescaled_vector is None:
            rescaled_vector = self.current_rescaled_values()
        out = self(rescaled_vector)
        maps = []
        # jit canonicalizes dict outputs to sorted-key order; restore the
        # pipeline's container order so the MapSet matches the eager path
        names = [n for n in (self.names or []) if n in out["hist"]] or list(
            out["hist"]
        )
        for name in names:
            flat = out["hist"][name]
            err = (
                np.asarray(out["error"][name]) if "error" in out else None
            )
            maps.append(
                Map(
                    name=name,
                    hist=np.asarray(flat),
                    binning=self.output_binning,
                    error_hist=err,
                )
            )
        return MapSet(maps, name=self.pipeline.name)

    # -- objectives ---------------------------------------------------------------
    def build_objective(self, data_dist, metric, priors=True, sum_maps=False):
        """Return jitted (value, grad) functions of the rescaled vector for
        fitting `data_dist` (MapSet or dict name->array) under `metric`.

        The objective follows the reference's minimizer convention
        (``analysis.py:2493``): metric total over maps plus prior penalties,
        sign-flipped for llh-family metrics so it is always *minimized*.
        """
        from pisa_tpu.utils import stats

        maximize = stats.is_metric_to_maximize(metric)
        metric_fn = getattr(stats, metric)

        if isinstance(data_dist, MapSet):
            data = {
                m.name: jnp.asarray(m.hist.ravel()) for m in data_dist
            }
        elif isinstance(data_dist, Map):
            data = {data_dist.name: jnp.asarray(data_dist.hist.ravel())}
        else:
            data = {k: jnp.asarray(v).ravel() for k, v in data_dist.items()}

        prior_list = []
        if priors:
            for p in self._free_params:
                if p.prior is not None:
                    prior_list.append((p.prior, p.units))

        # daemonflux covariance switch (reference param.py:1388-1402): the
        # daemon_* params' penalty is ONE correlated chi2, not their
        # individual priors
        from pisa_tpu.utils.daemonflux_native import compiled_daemon_penalty

        daemon = (
            compiled_daemon_penalty(self._free_params, [self.pipeline])
            if priors else None
        )
        daemon_skip = daemon[0] if daemon is not None else frozenset()

        rescale = self._rescale
        base_fn = self._build_fn()

        generalized = metric == "generalized_poisson_llh"
        if generalized:
            # static recursion length from the (concrete) summed data counts
            total_data = sum(np.asarray(v) for v in data.values())
            k_max = max(1, int(np.ceil(np.max(total_data))))

        def objective(vec, los=None, his=None, cdata=None):
            out = base_fn(vec, los, his, cdata)
            hists = out["hist"]
            if generalized:
                # per-source stacked mixture inputs (cf. reference
                # stats.py:792: expected_values as dict of MapSets)
                names = list(hists.keys())
                expected = {
                    "weights": jnp.stack([hists[n] for n in names]),
                    "llh_alphas": jnp.stack(
                        [out["llh_alphas"][n] for n in names]
                    ),
                    "llh_betas": jnp.stack(
                        [out["llh_betas"][n] for n in names]
                    ),
                    "n_mc_events": jnp.stack(
                        [out["n_mc_events"][n] for n in names]
                    ),
                }
                total_dat = sum(data.values())
                total = jnp.sum(
                    metric_fn(total_dat, expected, k_max=k_max)
                )
            elif sum_maps:
                total_exp = sum(hists.values())
                total_dat = sum(data.values())
                total = jnp.sum(metric_fn(total_dat, total_exp))
            else:
                total = 0.0
                for name, d in data.items():
                    total = total + jnp.sum(metric_fn(d, hists[name]))
            # prior penalties, in the same metric family (llh or chi2 = -2llh)
            penalty = 0.0
            mags = self._magnitudes_from_rescaled(vec, los, his)
            for i, (p, mag) in enumerate(zip(self._free_params, mags)):
                if i in daemon_skip:
                    continue  # replaced by the correlated daemon chi2
                if priors and p.prior is not None:
                    if p.prior.units is not None:
                        x = Quantity(mag, p.units).m_as(p.prior.units)
                    else:
                        x = mag
                    llh = p.prior.llh_jax(x)
                    penalty = penalty + jnp.squeeze(llh) * (
                        1.0 if maximize else -2.0
                    )
            if daemon is not None:
                llh = daemon[1](mags)
                penalty = penalty + llh * (1.0 if maximize else -2.0)
            total = total + penalty
            return -total if maximize else total

        value_jit = jax.jit(objective)
        vg_jit = jax.jit(jax.value_and_grad(objective, argnums=0))

        def value_only(vec):
            los, his = self._current_bounds()
            return value_jit(
                jnp.asarray(vec), jnp.asarray(los), jnp.asarray(his),
                self._data_vals,
            )

        def value_and_grad(vec):
            los, his = self._current_bounds()
            return vg_jit(
                jnp.asarray(vec), jnp.asarray(los), jnp.asarray(his),
                self._data_vals,
            )

        # expose the un-jitted objective (vec, los, his, data) for
        # composition (vmapped/batched objectives keep data a non-mapped
        # argument instead of re-embedding it as constants)
        value_only.raw = objective
        return value_only, value_and_grad
