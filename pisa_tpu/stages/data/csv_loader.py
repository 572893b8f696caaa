"""
Event loader for IceCube data-release CSV files (cf. reference
``pisa/stages/data/csv_loader.py``): one container per requested neutrino
category, selected from the file by PDG code and current type.

Used by the flagship ``IceCube_3y_neutrinos.cfg`` pipeline with the 3-year
oscillation data release (https://icecube.wisc.edu/science/data/highstats_nuosc_3y).
"""

from __future__ import annotations

import ast

import numpy as np

from pisa_tpu import FTYPE
from pisa_tpu.core.container import Container
from pisa_tpu.core.stage import Stage
from pisa_tpu.utils.fileio import read_csv
from pisa_tpu.utils.resources import find_resource

__all__ = ["csv_loader", "init_test"]


class csv_loader(Stage):  # noqa: N801
    """CSV data-release event loader.

    Parameters
    ----------
    events_file : str or sequence of str
        csv file path(s); comma-separated string allowed.
    data_dict : dict or str (python-literal dict)
        container key -> csv column (or list of columns, stacked to 2-D).
    output_names : sequence of str
        neutrino categories ('nue_cc', 'numubar_nc', ...).
    neutrinos : bool
        select events by PDG code / current type per category.
    dis_idx : int, optional
        integer value of the 'interaction' column identifying DIS events;
        fills a boolean 'dis' key for the DIS systematics stage.
    scale_aeff : bool
        convert weighted_aeff cm^2 -> m^2 (factor 1e-4).
    """

    def __init__(
        self,
        events_file,
        data_dict,
        output_names,
        neutrinos=True,
        dis_idx=None,
        scale_aeff=False,
        fraction_events_to_keep=None,
        **std_kwargs,
    ):
        # deterministic down-sampling, mirroring EventsPi's
        # fraction_events_to_keep (reference events_pi.py:118-160; the
        # reference csv_loader has no such option — added for fast tests
        # and prototyping on the data-release files)
        self.fraction_events_to_keep = (
            None
            if fraction_events_to_keep is None
            else float(fraction_events_to_keep)
        )
        if self.fraction_events_to_keep is not None and not (
            0.0 < self.fraction_events_to_keep <= 1.0
        ):
            raise ValueError("fraction_events_to_keep must be in (0, 1]")
        if isinstance(events_file, str):
            events_file = [s.strip() for s in events_file.split(",")]
        self.events_file = [find_resource(f) for f in events_file]

        if isinstance(data_dict, str):
            data_dict = ast.literal_eval(data_dict)
        if not isinstance(data_dict, dict):
            raise ValueError(f"unsupported data_dict type {type(data_dict)}")
        self.data_dict = data_dict

        if len(output_names) != len(set(output_names)):
            raise ValueError("duplicate entries in output_names")
        self.output_names = output_names
        self.neutrinos = neutrinos
        self.dis_idx = None if dis_idx is None else int(dis_idx)
        self.scale_aeff = scale_aeff

        super().__init__(
            expected_params=(),
            expected_container_keys=(),
            supported_reps={"calc_mode": ["events"], "apply_mode": ["events"]},
            **std_kwargs,
        )

    def setup_function(self):
        tables = [read_csv(f) for f in self.events_file]
        raw = {
            key: np.concatenate([t[key] for t in tables])
            for key in tables[0]
        }

        for name in self.output_names:
            container = Container(name, representation="events")

            if self.neutrinos:
                nubar = -1 if "bar" in name else 1
                if "e" in name:
                    flav = 0
                if "mu" in name:
                    flav = 1
                if "tau" in name:
                    flav = 2
                container.set_aux_data("nubar", nubar)
                container.set_aux_data("flav", flav)

                pdg = nubar * (12 + 2 * flav)
                if "pdg_code" in raw:
                    mask = raw["pdg_code"] == pdg
                elif "pdg" in raw:
                    mask = raw["pdg"] == pdg
                else:
                    raise ValueError(
                        "either 'pdg' or 'pdg_code' must be in the file"
                    )
                if "cc" in name:
                    mask &= raw["type"] >= 1
                else:
                    mask &= raw["type"] == 0
                events = {key: col[mask] for key, col in raw.items()}
            else:
                events = raw
            n_events = len(next(iter(events.values())))

            if self.fraction_events_to_keep is not None:
                n_keep = max(
                    1,
                    int(
                        round(
                            self.fraction_events_to_keep * n_events
                        )
                    ),
                )
                # deterministic stride (not RNG): identical subsample for
                # every run/container ordering
                step = max(1, n_events // n_keep)
                events = {
                    key: col[::step][:n_keep] for key, col in events.items()
                }
                n_events = len(next(iter(events.values())))

            container["initial_weights"] = np.ones(n_events, dtype=FTYPE)
            container["weights"] = np.ones(n_events, dtype=FTYPE)
            for key, col in self.data_dict.items():
                if isinstance(col, (list, tuple)):
                    container[key] = np.stack(
                        [events[c].astype(FTYPE) for c in col], axis=1
                    )
                else:
                    container[key] = events[col].astype(FTYPE)

            if self.scale_aeff and "weighted_aeff" in container.keys:
                container["weighted_aeff"] = (
                    container["weighted_aeff"] * FTYPE(1e-4)
                )

            if (
                "dis" not in container.keys
                and "interaction" in container.keys
                and self.dis_idx is not None
            ):
                container["dis"] = (
                    np.asarray(container["interaction"]) == self.dis_idx
                ).astype(FTYPE)

            self.data.add_container(container)

        if len(self.data.names) == 0:
            raise ValueError("no containers created during data loading")

    # elementwise apply: works unchanged on category-stacked arrays
    supports_stacked = True

    # resets weights to the static initial_weights (no param dependence)
    stacked_rate_defer_safe = True

    def apply_function(self):
        # reset weights before downstream stages multiply them
        for container in self.data:
            container["weights"] = container["initial_weights"] * 1.0


def init_test(**param_kwargs):
    """Instantiation example."""
    data_dict = {
        "true_energy": "true_energy",
        "true_coszen": "true_coszen",
        "weighted_aeff": "weight",
        "reco_energy": "reco_energy",
        "reco_coszen": "reco_coszen",
        "pid": "pid",
    }
    return csv_loader(
        events_file="events/IceCube_3y_oscillations/neutrino_mc.csv.bz2",
        data_dict=data_dict,
        output_names=["nue_cc", "numu_cc"],
    )
