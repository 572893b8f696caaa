"""
Pipeline: an ordered chain of stages producing a binned template.

Rebuild of reference ``pisa/core/pipeline.py:73``. A pipeline is constructed
from a config (file path, parsed OrderedDict, or python dict), instantiates
its stage services by import path ``pisa_tpu.stages.<stage>.<service>``,
unifies same-named params across stages into shared objects
(cf. ``pipeline.py:342-346``), and evaluates templates via ``get_outputs()``.

Addition to the reference: :meth:`Pipeline.compile` traces the full stage chain
into a single jitted, differentiable ``rescaled_free_params -> histograms``
function (see :mod:`pisa_tpu.core.template`), which the fitting layer uses
for analytic-gradient minimization; ``get_outputs`` remains the eager path.
"""

from __future__ import annotations

import importlib
import time
from collections import OrderedDict

import numpy as np

from pisa_tpu.core.binning import MultiDimBinning, VarBinning
from pisa_tpu.core.container import Container, ContainerSet
from pisa_tpu.core.map import MapSet
from pisa_tpu.core.param import ParamSet
from pisa_tpu.utils.log import logging

__all__ = ["Pipeline"]


class Pipeline:
    """
    Parameters
    ----------
    config : str (cfg file path), OrderedDict from parse_pipeline_config, or
        dict with keys 'pipeline' and stage tuples
    profile : bool
    """

    def __init__(self, config, profile=False):
        if isinstance(config, str):
            from pisa_tpu.config.parser import parse_pipeline_config

            config = parse_pipeline_config(config)
        if not isinstance(config, (dict, OrderedDict)):
            raise TypeError(f"Cannot interpret config of type {type(config)}")
        self._config = config
        pipeline_settings = config.get("pipeline", {})
        self.name = pipeline_settings.get("name", "pipeline")
        self.detector_name = pipeline_settings.get("detector_name")
        self._output_binning = pipeline_settings.get("output_binning")
        self._output_key = pipeline_settings.get("output_key")
        self.param_selections_applied = pipeline_settings.get(
            "param_selections", []
        )
        self.profile = profile
        self._get_outputs_times = []
        self._run_times = []
        self._setup_times = []

        self.data = ContainerSet(self.name)
        self.stages = []
        self._init_stages()
        self.setup()

    # -- construction ----------------------------------------------------------
    def _init_stages(self):
        """Instantiate stage services, unify shared params
        (cf. reference ``pipeline.py:249-358``)."""
        self.stages = []
        shared_params = ParamSet()
        all_selections = set(
            s.strip().lower()
            for s in self.param_selections_applied
            if s
        )

        for key, settings in self._config.items():
            if not isinstance(key, tuple):
                continue
            stage_name, service_name = key
            cls = self._import_service(stage_name, service_name)
            settings = dict(settings)
            settings.setdefault("profile", self.profile)
            stage = cls(**settings)
            stage.data = self.data
            self.stages.append(stage)

            # parameter identity-sharing: same-named params across stages
            # must be the same object (so one fit param steers all uses)
            for p in list(stage.params):
                if p.name in shared_params:
                    existing = shared_params[p.name]
                    if existing != p:
                        raise ValueError(
                            f"Stage {stage}: param {p.name!r} conflicts with"
                            " the same-named param of an earlier stage"
                        )
                    stage._param_selector.update(
                        existing, existing_must_match=True
                    )
                else:
                    shared_params.extend(p)
            for sel in stage.param_selections:
                all_selections.add(sel)

        if all_selections:
            self.select_params(sorted(all_selections))

    @staticmethod
    def _import_service(stage_name, service_name):
        # pi_* legacy names map to bare names (cf. reference pipeline.py:273)
        if service_name.startswith("pi_"):
            service_name = service_name[3:]
        module_path = f"pisa_tpu.stages.{stage_name}.{service_name}"
        try:
            module = importlib.import_module(module_path)
        except ImportError as exc:
            try:
                module = importlib.import_module(
                    f"{stage_name}.{service_name}"
                )
            except ImportError:
                raise ImportError(
                    f"Cannot import service {module_path}: {exc}"
                ) from exc
        return getattr(module, service_name)

    def setup(self):
        """Fresh ContainerSet; every stage shares it; run every stage's setup
        (cf. reference ``pipeline.py:560-577``)."""
        t0 = time.perf_counter()
        self.data = ContainerSet(self.name)
        if self._output_binning is not None:
            self.data["output_binning"] = self._output_binning
        for stage in self.stages:
            stage.data = self.data
            stage.param_hash = None
            stage.setup()
        self._setup_times.append(time.perf_counter() - t0)

    # -- params -----------------------------------------------------------------
    @property
    def params(self) -> ParamSet:
        params = ParamSet()
        for stage in self.stages:
            params.extend(stage.params)
        return params

    @property
    def param_selections(self):
        selections = set()
        for stage in self.stages:
            selections.update(stage.param_selections)
        return sorted(selections)

    def select_params(self, selections, error_on_missing=False):
        successes = 0
        for stage in self.stages:
            try:
                stage.select_params(selections, error_on_missing=True)
                successes += 1
            except KeyError:
                pass
        if error_on_missing and successes == 0:
            raise KeyError(
                f"No stage accepted param selections {selections}"
            )

    def update_params(self, params, existing_must_match=False, extend=False):
        for stage in self.stages:
            for p in params if isinstance(params, ParamSet) else ParamSet(params):
                if p.name in stage.params:
                    stage._param_selector.update(
                        p, existing_must_match=existing_must_match
                    )

    def index(self, stage_id):
        """Index of a stage by int, 'stage_name', or 'stage_name.service'."""
        if isinstance(stage_id, int):
            return stage_id
        for i, s in enumerate(self.stages):
            if stage_id in (s.stage_name, f"{s.stage_name}.{s.service_name}"):
                return i
        raise ValueError(f"No stage {stage_id!r} in {self}")

    def __getitem__(self, stage_id):
        return self.stages[self.index(stage_id)]

    def __iter__(self):
        return iter(self.stages)

    def __len__(self):
        return len(self.stages)

    # -- evaluation --------------------------------------------------------------
    @property
    def output_binning(self):
        return self._output_binning

    @output_binning.setter
    def output_binning(self, binning):
        self._output_binning = binning

    @property
    def output_key(self):
        return self._output_key

    @output_key.setter
    def output_key(self, key):
        self._output_key = key

    def run(self):
        t0 = time.perf_counter()
        for stage in self.stages:
            logging.trace("running %s", stage)
            stage.run()
        self._run_times.append(time.perf_counter() - t0)

    def get_outputs(self, output_binning=None, output_key=None,
                    return_sum=False):
        """Evaluate the template: run all stages, histogram into the output
        binning (cf. reference ``pipeline.py:360-483``).

        Returns a MapSet, or a list of MapSets for VarBinning output. With
        `return_sum`, all maps are summed into a single-map MapSet (so a
        lone Pipeline duck-types the DistributionMaker hypo-maker surface).
        """
        if return_sum:
            out = self.get_outputs(output_binning, output_key)
            if isinstance(out, list):
                return [MapSet([ms.sum()], name=self.name) for ms in out]
            return MapSet([out.sum()], name=self.name)
        t0 = time.perf_counter()
        output_binning = output_binning or self._output_binning
        output_key = output_key or self._output_key
        if output_binning is None:
            raise ValueError("No output binning defined")

        if isinstance(output_binning, VarBinning):
            outputs = self._get_outputs_varbinning(output_binning, output_key)
        else:
            outputs = self._get_outputs_multidimbinning(
                output_binning, output_key
            )
        self._get_outputs_times.append(time.perf_counter() - t0)
        return outputs

    def _get_outputs_multidimbinning(self, output_binning, output_key):
        self.run()
        if isinstance(output_key, (tuple, list)):
            key, error_key = output_key[0], output_key[1]
        else:
            key, error_key = output_key, None
        self.data.representation = output_binning
        # 'errors' (if requested) is produced binned by the histogramming
        # stage (utils.hist with error_method='sumw2'); both keys are read in
        # the output binning (weights translate in 'sum' mode)
        return self.data.get_mapset(key, error=error_key)

    def _get_outputs_varbinning(self, output_binning, output_key):
        """Per-selection MapSets: mask events per selection, histogram under
        that selection's binning (cf. reference ``pipeline.py:389``)."""
        self.run()
        if isinstance(output_key, (tuple, list)):
            key, error_key = output_key[0], output_key[1]
        else:
            key, error_key = output_key, None

        selections = output_binning.selections
        outputs = []
        from pisa_tpu.core.binning import OneDimBinning

        for i, binning in enumerate(output_binning.binnings):
            maps = []
            for container in self.data.containers:
                container.representation = "events"
                if isinstance(selections, OneDimBinning):
                    var = np.asarray(container[selections.name])
                    edges = selections.edge_magnitudes
                    mask = (var >= edges[i]) & (
                        var < edges[i + 1]
                        if i < selections.num_bins - 1
                        else var <= edges[i + 1]
                    )
                else:
                    mask = container.get_keep_mask(selections[i])
                sample = [
                    np.asarray(container[n])[mask] for n in binning.names
                ]
                weights = np.asarray(container[key])[mask]
                from pisa_tpu.core import translation

                hist = np.asarray(
                    translation.histogram(sample, weights, binning)
                )
                from pisa_tpu.core.map import Map

                err = None
                if error_key is not None or error_key == "errors":
                    sumw2 = np.asarray(
                        translation.histogram(
                            sample, np.square(weights), binning
                        )
                    )
                    err = np.sqrt(sumw2)
                maps.append(
                    Map(
                        name=container.name,
                        hist=hist,
                        binning=binning,
                        error_hist=err,
                    )
                )
            outputs.append(MapSet(maps, name=f"{self.name}_sel{i}"))
        return outputs

    # -- compiled fast path --------------------------------------------------
    def compile(self, output_binning=None, output_key=None):
        """Build a jitted, differentiable template function; see
        :class:`pisa_tpu.core.template.CompiledTemplate`."""
        from pisa_tpu.core.template import CompiledTemplate

        return CompiledTemplate(
            self,
            output_binning=output_binning or self._output_binning,
            output_key=output_key or self._output_key,
        )

    # -- fitting interface (same surface as DistributionMaker, so a single
    # Pipeline can serve as a hypo maker directly) ------------------------------
    def _set_rescaled_free_params(self, rvalues):
        free = self.params.free
        if len(rvalues) != len(free):
            raise ValueError(
                f"Got {len(rvalues)} values for {len(free)} free params"
            )
        for p, v in zip(free, rvalues):
            p._rescaled_value = float(v)

    def set_free_params(self, values):
        free = self.params.free
        if len(values) != len(free):
            raise ValueError(
                f"Got {len(values)} values for {len(free)} free params"
            )
        for p, v in zip(free, values):
            p.value = v

    def reset_free(self):
        self.params.reset_free()

    def reset_all(self):
        self.params.reset_all()

    # -- profiling -------------------------------------------------------------
    @staticmethod
    def _format_times(times):
        """'n=..., total=..., mean +- std, min/max' summary of a timing list
        (cf. reference ``format.format_times``)."""
        t = np.asarray(times, dtype=np.float64)
        if t.size == 0:
            return "n=0"
        return (
            f"n={t.size}, total={t.sum():.4f} s,"
            f" mean={t.mean() * 1e3:.2f} +- {t.std() * 1e3:.2f} ms,"
            f" min={t.min() * 1e3:.2f} ms, max={t.max() * 1e3:.2f} ms"
        )

    def report_profile(self, detailed=False):
        """Per-pipeline (and with `detailed`, per-stage setup/compute/apply)
        timing summary (cf. reference ``pipeline.py:148-187``,
        ``stage.py:233-246``)."""
        print(f"Pipeline: {self.name}")
        if self._setup_times:
            print(f"  setup:       {self._format_times(self._setup_times)}")
        if self._run_times:
            print(f"  run:         {self._format_times(self._run_times)}")
        if self._get_outputs_times:
            print(
                f"  get_outputs: {self._format_times(self._get_outputs_times)}"
            )
        if detailed:
            for stage in self.stages:
                print(f"  {stage}:")
                for label, times in (
                    ("setup", stage.setup_times),
                    ("compute", stage.calc_times),
                    ("apply", stage.apply_times),
                ):
                    if times:
                        print(f"    {label}: {self._format_times(times)}")

    # -- notebook display --------------------------------------------------------
    def _stage_table_rows(self):
        """(headers, rows) describing each stage (cf. reference
        ``pipeline.py:138-146`` ``tabulate``)."""
        headers = [
            "stage number",
            "name",
            "calc_mode",
            "apply_mode",
            "# fixed params",
            "# free params",
        ]
        rows = []
        for i, s in enumerate(self.stages):
            rows.append(
                [
                    str(i),
                    f"{s.stage_name}.{s.service_name}",
                    str(getattr(s, "calc_mode", None)),
                    str(getattr(s, "apply_mode", None)),
                    str(len(s.params.fixed)),
                    str(len(s.params.free)),
                ]
            )
        return headers, rows

    def tabulate(self, tablefmt="plain"):
        """Plain-text ('plain'/'presto') or 'html' table of the pipeline's
        stages (cf. reference ``pipeline.py:138``)."""
        headers, rows = self._stage_table_rows()
        if tablefmt == "html":
            cells = "".join(f"<th>{h}</th>" for h in headers)
            body = "".join(
                "<tr>" + "".join(f"<td>{c}</td>" for c in row) + "</tr>"
                for row in rows
            )
            return (
                f"<table><thead><tr>{cells}</tr></thead>"
                f"<tbody>{body}</tbody></table>"
            )
        widths = [
            max(len(h), *(len(r[j]) for r in rows)) if rows else len(h)
            for j, h in enumerate(headers)
        ]
        sep = " | " if tablefmt == "presto" else "  "
        lines = [sep.join(h.ljust(w) for h, w in zip(headers, widths))]
        if tablefmt == "presto":
            lines.append("-+-".join("-" * w for w in widths))
        for row in rows:
            lines.append(sep.join(c.ljust(w) for c, w in zip(row, widths)))
        return "\n".join(lines)

    def _repr_html_(self):
        return self.tabulate(tablefmt="html")

    def __str__(self):
        stages = " -> ".join(str(s) for s in self.stages)
        return f"Pipeline('{self.name}': {stages})"

    __repr__ = __str__
