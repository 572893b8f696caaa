"""
Neutrino absorption in the Earth (cf. reference
``pisa/stages/absorption/earth_absorption.py``): survival probability
``exp(-rho_int * xsec * N_A)`` with the water-equivalent column depth from
the Earth-layer chains and per-flavor total (CC+NC) cross-sections.

Deltas from the reference: the column-depth reduction is a fused jnp sum over the
padded layer axis instead of a per-event guvectorize; cross-sections come
from the vendored GENIE ``cross_sections/cross_sections.json`` tables
(log-interpolated) instead of the reference's ROOT file (ROOT is not a
dependency of this framework).
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from pisa_tpu import FTYPE, ureg
from pisa_tpu.core.stage import Stage
from pisa_tpu.ops.osc.layers import Layers
from pisa_tpu.utils.fileio import from_file
from pisa_tpu.utils.resources import find_resource

__all__ = ["earth_absorption", "init_test"]

N_A = 6.022e23  # nuclei per mol

_ALL_NU = [
    "nue_cc", "numu_cc", "nutau_cc", "nue_nc", "numu_nc", "nutau_nc",
    "nuebar_cc", "numubar_cc", "nutaubar_cc", "nuebar_nc", "numubar_nc",
    "nutaubar_nc",
]
_FLAV_KEY = {
    (0, 1): "nue", (0, -1): "nue_bar",
    (1, 1): "numu", (1, -1): "numu_bar",
    (2, 1): "nutau", (2, -1): "nutau_bar",
}


class earth_absorption(Stage):  # noqa: N801
    """Parameters: earth_model (PREM path), xsec_file (GENIE JSON),
    xsec_version, detector_depth, prop_height."""

    def __init__(
        self,
        earth_model,
        xsec_file="cross_sections/cross_sections.json",
        xsec_version="genie_2.8.6",
        detector_depth=2.0 * ureg.km,
        prop_height=20.0 * ureg.km,
        **std_kwargs,
    ):
        super().__init__(
            expected_params=(),
            expected_container_keys=(
                "true_coszen", "true_energy", "flav", "nubar", "weights",
            ),
            **std_kwargs,
        )
        self.earth_model = earth_model
        self.xsec_file = xsec_file
        self.xsec_version = xsec_version
        self.detector_depth = detector_depth.m_as("km")
        self.prop_height = prop_height.m_as("km")
        self.layers = None
        self.xsec_tables = None

    def setup_function(self):
        self.layers = Layers(
            self.earth_model, self.detector_depth, self.prop_height
        )
        # electron fraction 1 -> total matter density (cf. reference)
        self.layers.setElecFrac(1.0, 1.0, 1.0)

        xs = from_file(find_resource(self.xsec_file))[self.xsec_version]
        self.xsec_tables = {
            "energy": np.asarray(xs["energy"], dtype=np.float64),
            "xsec": {
                k: np.asarray(v["cc"], dtype=np.float64)
                + np.asarray(v["nc"], dtype=np.float64)
                for k, v in xs["xsec"].items()
            },
        }

        if self.is_map:
            self.data.link_containers("nu", _ALL_NU)
        for container in self.data:
            self.layers.calcLayers(np.asarray(container["true_coszen"]))
            container["densities"] = self.layers.density.reshape(
                (container.size, self.layers.max_layers)
            )
            container["distances"] = self.layers.distance.reshape(
                (container.size, self.layers.max_layers)
            )
        self.data.unlink_containers()

    def _xsec_cm2(self, flav, nubar, energy):
        """Per-nucleon total cross-section in cm^2 (tables in m^2)."""
        table = self.xsec_tables["xsec"][_FLAV_KEY[(flav, nubar)]]
        e_grid = self.xsec_tables["energy"]
        return np.interp(np.asarray(energy), e_grid, table) * 1e4

    def compute_function(self):
        if self.is_map:
            self.data.link_containers("nu", _ALL_NU)
        for container in self.data:
            # water-equivalent column depth in cm (distances in km)
            rho_int = (
                jnp.sum(
                    jnp.asarray(container["distances"])
                    * jnp.asarray(container["densities"]),
                    axis=1,
                )
                * 1e5
            )
            container["rho_int"] = rho_int
            container.mark_changed("rho_int")
        self.data.unlink_containers()

        for container in self.data:
            xsec = self._xsec_cm2(
                int(container["flav"]),
                int(container["nubar"]),
                container["true_energy"],
            ).astype(FTYPE)
            container["xsection"] = xsec
            container["survival_prob"] = jnp.exp(
                -jnp.asarray(container["rho_int"]) * xsec * N_A
            )
            container.mark_changed("xsection")
            container.mark_changed("survival_prob")

    def apply_function(self):
        for container in self.data:
            container["weights"] = (
                container["weights"] * container["survival_prob"]
            )


def init_test(**param_kwargs):
    """Instantiation example."""
    return earth_absorption(earth_model="osc/PREM_4layer.dat")
