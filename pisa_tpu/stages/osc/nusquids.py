"""
Native 3+1 / 3-flavor oscillation service with nuSQuIDS-compatible
parameters (cf. reference ``pisa/stages/osc/nusquids.py:36-140``).

The reference wraps the external nuSQuIDS C++ engine (numerical evolution
on a node grid, interpolation to events, low-pass filtering of fast sterile
oscillations). This service provides the same physics natively:

- ``num_neutrinos=3``: the split-complex layer-chain kernel
  (:func:`pisa_tpu.ops.osc.kernels.osc_probs_layers`);
- ``num_neutrinos=4``: the 3+1 kernel
  (:func:`pisa_tpu.ops.osc.sterile.osc_probs_layers_4nu`) — Barger
  spectral-projector transitions on split-complex 4x4 algebra, CC potential
  on nu_e and the neutral-current potential on the sterile state via
  neutron-weighted layer densities, differentiable w.r.t. all couplings
  (the reference engine has no gradients at all);
- ``prop_lowpass_cutoff/frac``: the nuSQuIDS low-pass semantics — the 3+1
  kernel's density-matrix path damps interference between eigenstate pairs
  above the cutoff frequency, so eV^2-scale oscillations average instead of
  aliasing on coarse grids;
- node-grid machinery: the framework's ``calc_mode`` grid + container
  translation IS the node_mode + interpolation mechanism (SURVEY §5.7); a
  ``node_mode`` argument equal to ``calc_mode`` is accepted for config
  compatibility.

Parameter vocabulary matches the reference exactly (theta12..theta34,
deltam21/31/41, deltacp, deltacp14, deltacp24, Earth model and electron
fractions), so nusquids pipeline configs port by changing nothing but the
unsupported engine-tuning knobs (rel_err/abs_err etc., which have no native
analog and are ignored with a log message).
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from pisa_tpu import FTYPE, ureg
from pisa_tpu.core.param import Param, ParamSet
from pisa_tpu.core.stage import Stage
from pisa_tpu.ops.osc.kernels import osc_probs_layers
from pisa_tpu.ops.osc.layers import Layers
from pisa_tpu.ops.osc.pmns import dm_matrix, pmns_matrix
from pisa_tpu.ops.osc.sterile import osc_probs_layers_4nu, pmns4_matrix
from pisa_tpu.utils.log import logging

__all__ = ["nusquids", "init_test"]

_ALL_FLAVS = [
    "nue_cc", "numu_cc", "nutau_cc", "nue_nc", "numu_nc", "nutau_nc",
    "nuebar_cc", "numubar_cc", "nutaubar_cc", "nuebar_nc", "numubar_nc",
    "nutaubar_nc",
]
_NU_FLAVS = _ALL_FLAVS[:6]
_NUBAR_FLAVS = _ALL_FLAVS[6:]

#: accepted-but-inert engine-tuning options of the reference wrapper
_IGNORED_OPTIONS = (
    "rel_err", "abs_err", "suppress_interpolation_warning",
    "apply_lowpass_above_hor", "apply_height_avg_below_hor",
    "prop_height_range", "eval_lowpass_cutoff", "eval_lowpass_frac",
    "exact_mode", "use_taus",
)


class nusquids(Stage):  # noqa: N801
    """See module docstring; reference parameters at
    ``nusquids.py:161-173,321-331``."""

    def __init__(
        self,
        num_neutrinos=3,
        vacuum=False,
        node_mode=None,
        prop_lowpass_cutoff=None,
        prop_lowpass_frac=None,
        use_decoherence=False,
        use_nsi=False,
        **std_kwargs,
    ):
        self.num_neutrinos = int(num_neutrinos)
        if self.num_neutrinos not in (3, 4):
            raise ValueError(
                "This implementation is restricted to 3 or 4 neutrino"
                " flavors (as is the reference wrapper,"
                " nusquids.py:319-333)"
            )
        if use_decoherence:
            raise ValueError(
                "use_decoherence: use the native osc.decoherence service"
            )
        if use_nsi:
            raise ValueError("use_nsi: use osc.prob3 with nsi_type")
        self.vacuum = bool(vacuum)
        self.node_mode = node_mode

        # low-pass config: quantities like the reference (1/km; frac
        # dimensionless). Plain floats are accepted as 1/km.
        def _as_inv_km(v):
            if v is None:
                return 0.0
            if hasattr(v, "m_as"):
                return float(v.m_as("1/km"))
            return float(v)

        self.prop_lowpass_cutoff = _as_inv_km(prop_lowpass_cutoff)
        self.prop_lowpass_frac = (
            float(
                prop_lowpass_frac.m_as("dimensionless")
                if hasattr(prop_lowpass_frac, "m_as")
                else prop_lowpass_frac
            )
            if prop_lowpass_frac is not None
            else 0.1
        )

        for opt in _IGNORED_OPTIONS:
            if opt in std_kwargs:
                logging.info(
                    "osc.nusquids: option %r is engine tuning of the"
                    " external nuSQuIDS integrator and has no effect on"
                    " the native kernel; ignored", opt,
                )
                std_kwargs.pop(opt)

        expected_params = [
            "earth_model", "detector_depth", "prop_height",
            "YeI", "YeO", "YeM",
            "theta12", "theta13", "theta23",
            "deltam21", "deltam31", "deltacp",
        ]
        if self.num_neutrinos == 4:
            expected_params += [
                "theta14", "theta24", "theta34",
                "deltam41", "deltacp14", "deltacp24",
            ]

        super().__init__(
            expected_params=tuple(expected_params),
            expected_container_keys=(
                "true_energy",
                "true_coszen",
                "nubar",
                "flav",
                "nu_flux",
                "weights",
            ),
            **std_kwargs,
        )

    # ------------------------------------------------------------- lifecycle
    def setup_function(self):
        if self.node_mode is not None and hasattr(self, "calc_mode"):
            # the calc grid IS the node grid in this framework
            logging.info(
                "osc.nusquids: node placement/interpolation is performed"
                " by the calc_mode grid + container translation"
            )

        prop_height = self.params.prop_height.m_as("km")
        detector_depth = self.params.detector_depth.m_as("km")
        self.YeI = self.params.YeI.m_as("dimensionless")
        self.YeO = self.params.YeO.m_as("dimensionless")
        self.YeM = self.params.YeM.m_as("dimensionless")
        self.layers = Layers(
            self.params.earth_model.value, detector_depth, prop_height
        )
        self.layers.setElecFrac(self.YeI, self.YeO, self.YeM)

        if self.is_map:
            self.data.link_containers("nu", _ALL_FLAVS)
        for container in self.data:
            self.layers.calcLayers(np.asarray(container["true_coszen"]))
            shape = (container.size, self.layers.max_layers)
            if self.vacuum:
                container["densities"] = np.zeros(shape, dtype=FTYPE)
                container["densities_neutron"] = np.zeros(
                    shape, dtype=FTYPE
                )
            else:
                container["densities"] = self.layers.density.reshape(shape)
                container["densities_neutron"] = (
                    self.layers.density_neutron_weighted.reshape(shape)
                )
            container["distances"] = self.layers.distance.reshape(shape)
        self.data.unlink_containers()
        for container in self.data:
            container["prob_e"] = np.empty(container.size, dtype=FTYPE)
            container["prob_mu"] = np.empty(container.size, dtype=FTYPE)

    def compute_function(self):
        if self.is_map:
            self.data.link_containers("nu", _NU_FLAVS)
            self.data.link_containers("nubar", _NUBAR_FLAVS)

        for angle in (
            self.params.theta12, self.params.theta13, self.params.theta23,
            self.params.deltacp,
        ):
            if angle.value.units == ureg.dimensionless:
                raise ValueError(
                    f"{angle.name} is dimensionless; give rad or deg"
                )

        th12 = self.params.theta12.m_as("rad")
        th13 = self.params.theta13.m_as("rad")
        th23 = self.params.theta23.m_as("rad")
        dcp13 = self.params.deltacp.m_as("rad")
        dm21 = self.params.deltam21.m_as("eV**2")
        dm31 = self.params.deltam31.m_as("eV**2")

        if self.num_neutrinos == 4:
            U4 = pmns4_matrix(
                th12, th13, th23,
                self.params.theta14.m_as("rad"),
                self.params.theta24.m_as("rad"),
                self.params.theta34.m_as("rad"),
                dcp13,
                self.params.deltacp14.m_as("rad"),
                self.params.deltacp24.m_as("rad"),
            )
            dms = jnp.stack(
                [
                    jnp.zeros_like(jnp.asarray(dm21)),
                    jnp.asarray(dm21),
                    jnp.asarray(dm31),
                    jnp.asarray(self.params.deltam41.m_as("eV**2")),
                ]
            )
        else:
            mix = pmns_matrix(
                jnp.sin(th12), jnp.sin(th13), jnp.sin(th23), dcp13
            )
            dm = dm_matrix(dm21, dm31)
            mat_pot = np.diag([1.0, 0.0, 0.0]).astype(complex)
            zeros3 = np.zeros((3, 3), dtype=complex)

        for container in self.data:
            energy = jnp.asarray(container["true_energy"], dtype=FTYPE)
            densities = jnp.asarray(container["densities"], dtype=FTYPE)
            distances = jnp.asarray(container["distances"], dtype=FTYPE)
            nubar = int(container["nubar"])

            if self.num_neutrinos == 4:
                probs4 = osc_probs_layers_4nu(
                    dms, U4, nubar, energy, densities,
                    jnp.asarray(
                        container["densities_neutron"], dtype=FTYPE
                    ),
                    distances,
                    lowpass_cutoff=self.prop_lowpass_cutoff,
                    lowpass_frac=self.prop_lowpass_frac,
                )
                container["probability"] = probs4[:, :3, :3]
            else:
                container["probability"] = osc_probs_layers(
                    dm, mix, mat_pot, zeros3, np.zeros((3, 3)), nubar,
                    energy, densities, distances,
                )
            container.mark_changed("probability")

        self.data.unlink_containers()

        for container in self.data:
            flav = int(container["flav"])
            probs = container["probability"]
            container["prob_e"] = probs[:, 0, flav]
            container["prob_mu"] = probs[:, 1, flav]
            container.mark_changed("prob_e")
            container.mark_changed("prob_mu")

    def apply_function(self):
        for container in self.data:
            nu_flux = container["nu_flux"]
            container["weights"] = container["weights"] * (
                nu_flux[:, 0] * container["prob_e"]
                + nu_flux[:, 1] * container["prob_mu"]
            )


def init_test(**param_kwargs):
    """Instantiation example: a 3+1 sterile configuration."""
    param_set = ParamSet(
        [
            Param(name="earth_model", value="osc/PREM_12layer.dat",
                  **param_kwargs),
            Param(name="detector_depth", value=2 * ureg.km, **param_kwargs),
            Param(name="prop_height", value=20 * ureg.km, **param_kwargs),
            Param(name="YeI", value=0.4656, **param_kwargs),
            Param(name="YeO", value=0.4656, **param_kwargs),
            Param(name="YeM", value=0.4957, **param_kwargs),
            Param(name="theta12", value=33.4 * ureg.degree, **param_kwargs),
            Param(name="theta13", value=8.5 * ureg.degree, **param_kwargs),
            Param(name="theta23", value=42.3 * ureg.degree, **param_kwargs),
            Param(name="deltam21", value=7.42e-5 * ureg.eV**2,
                  **param_kwargs),
            Param(name="deltam31", value=2.514e-3 * ureg.eV**2,
                  **param_kwargs),
            Param(name="deltacp", value=0 * ureg.degree, **param_kwargs),
            Param(name="theta14", value=5 * ureg.degree, **param_kwargs),
            Param(name="theta24", value=8 * ureg.degree, **param_kwargs),
            Param(name="theta34", value=0 * ureg.degree, **param_kwargs),
            Param(name="deltam41", value=1.0 * ureg.eV**2, **param_kwargs),
            Param(name="deltacp14", value=0 * ureg.degree, **param_kwargs),
            Param(name="deltacp24", value=0 * ureg.degree, **param_kwargs),
        ]
    )
    return nusquids(num_neutrinos=4, params=param_set)
