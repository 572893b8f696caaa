"""
Store each event's flat bin index under the calc binning (cf. reference
``pisa/stages/utils/add_indices.py``, which stores per-bin boolean masks via
``bin_indexing.lookup_indices``).

Delta from the reference: one ``(N,)`` int index array per container instead of
``num_bins`` boolean masks (O(N) memory instead of O(N*B); downstream
per-bin reductions become segment-sums over the index array). Consumed by
``likelihood.generalized_llh_params``.
"""

from __future__ import annotations

import numpy as np

from pisa_tpu.core.binning import MultiDimBinning
from pisa_tpu.core.stage import Stage
from pisa_tpu.core import translation

__all__ = ["add_indices", "init_test"]


class add_indices(Stage):  # noqa: N801
    """Adds 'bin_indices' (flat index; -1 underflow / size overflow)."""

    def __init__(self, **std_kwargs):
        if not isinstance(std_kwargs.get("calc_mode"), MultiDimBinning):
            raise ValueError(
                "add_indices requires a binning as calc_mode"
            )
        if std_kwargs.get("apply_mode", "events") != "events":
            raise ValueError("apply_mode must be 'events'")
        std_kwargs.setdefault("apply_mode", "events")
        super().__init__(
            expected_params=(),
            expected_container_keys=(),
            supported_reps={"apply_mode": ["events"]},
            **std_kwargs,
        )

    def setup_function(self):
        binning = self.calc_mode
        self.data.representation = "events"
        for container in self.data:
            sample = [container[name] for name in binning.names]
            container["bin_indices"] = np.asarray(
                translation.lookup_indices_flat(sample, binning)
            )


def init_test(**param_kwargs):
    """Instantiation example."""
    from pisa_tpu import ureg
    from pisa_tpu.core.binning import OneDimBinning

    binning = MultiDimBinning(
        [
            OneDimBinning(
                "true_energy", num_bins=5, is_log=True,
                domain=[1, 100] * ureg.GeV,
            )
        ],
        name="test",
    )
    return add_indices(calc_mode=binning, apply_mode="events")
