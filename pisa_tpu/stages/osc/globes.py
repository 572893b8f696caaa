"""
Native 3+1 sterile-neutrino oscillation service with the GLoBES wrapper's
parameter vocabulary and weight conventions (cf. reference
``pisa/stages/osc/globes.py:33-291``).

The reference wraps the external GLoBES C library (via Andrii Terliuk's
python wrapper) and loops ``MatterProbabilityPrevBaseline`` per event — a
scalar C call per (event, initial-flavor) pair. This service provides the
same physics natively on the 3+1 kernel
(:func:`pisa_tpu.ops.osc.sterile.osc_probs_layers_4nu`): one batched
split-complex 4x4 layer-chain propagation per (nu, nubar) link, fully
differentiable w.r.t. every mixing parameter (the reference engine has no
gradients at all).

Reference weight conventions preserved exactly
(``globes.py:155-172,245-291``):

- charged-current events: ``prob_e = P(nue->flav)``,
  ``prob_mu = P(numu->flav)`` including sterile effects;
  ``prob_nonsterile = 1``;
- neutral-current events: ``prob_nonsterile = sum_x P(flav->x)`` over the
  three active flavors (the sterile-depletion survival factor), while
  ``prob_e``/``prob_mu`` are the fixed flavor-identity indicators set at
  setup (``globes.py:158-172``);
- ``weights *= (flux_e*prob_e + flux_mu*prob_mu) * prob_nonsterile``
  (``globes.py:283-291``).

Mixing convention matches the reference's ``SetParametersArr`` call
(``globes.py:219-232``): a 3+1 rotation with ``theta14 = 0`` and both
sterile CP phases fixed to zero — only ``theta24``, ``theta34`` and
``deltam41`` extend the standard 3-flavor sector.

One deliberate deviation: the reference hands GLoBES raw densities and
lets the SNU patch pick electron fractions internally by a core/mantle
density threshold (``globes.py:131-135``). The native kernel uses the
framework's explicit PREM electron fractions (``YeI/YeO/YeM`` constructor
arguments, defaulting to the standard values used everywhere else), which
is both more accurate and consistent with ``osc.prob3``/``osc.nusquids``.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from pisa_tpu import FTYPE, ureg
from pisa_tpu.core.param import Param, ParamSet
from pisa_tpu.core.stage import Stage
from pisa_tpu.ops.osc.layers import Layers
from pisa_tpu.ops.osc.sterile import osc_probs_layers_4nu, pmns4_matrix
from pisa_tpu.utils.log import logging

__all__ = ["globes", "init_test"]

_ALL_FLAVS = [
    "nue_cc", "numu_cc", "nutau_cc", "nue_nc", "numu_nc", "nutau_nc",
    "nuebar_cc", "numubar_cc", "nutaubar_cc", "nuebar_nc", "numubar_nc",
    "nutaubar_nc",
]
_NU_FLAVS = _ALL_FLAVS[:6]
_NUBAR_FLAVS = _ALL_FLAVS[6:]


class globes(Stage):  # noqa: N801
    """See module docstring; reference parameters at
    ``globes.py:36-66,297-312``.

    Parameters
    ----------
    earth_model : PREM file path (resource-resolved)
    globes_wrapper : ignored (the reference needs the external wrapper
        checkout path; the native engine needs nothing)
    detector_depth, prop_height : quantities (km)
    YeI, YeO, YeM : electron fractions (see module docstring)
    """

    def __init__(
        self,
        earth_model,
        globes_wrapper=None,
        detector_depth=2.0 * ureg.km,
        prop_height=20.0 * ureg.km,
        YeI=0.4656,
        YeO=0.4656,
        YeM=0.4957,
        **std_kwargs,
    ):
        if globes_wrapper is not None:
            logging.info(
                "osc.globes: 'globes_wrapper' (%r) is the external GLoBES"
                " checkout path needed by the reference wrapper; the native"
                " engine ignores it", globes_wrapper,
            )
        self.earth_model = earth_model
        self.detector_depth = detector_depth
        self.prop_height = prop_height
        self.YeI = float(YeI)
        self.YeO = float(YeO)
        self.YeM = float(YeM)

        super().__init__(
            expected_params=(
                "theta12",
                "theta13",
                "theta23",
                "deltam21",
                "deltam31",
                "deltam41",
                "theta24",
                "theta34",
                "deltacp",
            ),
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
        prop_height = (
            self.prop_height.m_as("km")
            if hasattr(self.prop_height, "m_as")
            else float(self.prop_height)
        )
        detector_depth = (
            self.detector_depth.m_as("km")
            if hasattr(self.detector_depth, "m_as")
            else float(self.detector_depth)
        )
        self.layers = Layers(self.earth_model, detector_depth, prop_height)
        self.layers.setElecFrac(self.YeI, self.YeO, self.YeM)

        if self.is_map:
            self.data.link_containers("nu", _ALL_FLAVS)
        for container in self.data:
            self.layers.calcLayers(np.asarray(container["true_coszen"]))
            shape = (container.size, self.layers.max_layers)
            container["densities"] = self.layers.density.reshape(shape)
            container["densities_neutron"] = (
                self.layers.density_neutron_weighted.reshape(shape)
            )
            container["distances"] = self.layers.distance.reshape(shape)
        self.data.unlink_containers()

        # Fixed probability slots per the reference's setup_function
        # (globes.py:155-172): CC events always have prob_nonsterile = 1;
        # NC events always have flavor-identity (prob_e, prob_mu).
        for container in self.data:
            flav = int(container["flav"])
            if container.name.endswith("_cc"):
                container["prob_e"] = np.empty(container.size, dtype=FTYPE)
                container["prob_mu"] = np.empty(container.size, dtype=FTYPE)
                container["prob_nonsterile"] = np.ones(
                    container.size, dtype=FTYPE
                )
            elif container.name.endswith("_nc"):
                container["prob_e"] = np.full(
                    container.size, 1.0 if flav == 0 else 0.0, dtype=FTYPE
                )
                container["prob_mu"] = np.full(
                    container.size, 1.0 if flav == 1 else 0.0, dtype=FTYPE
                )
                container["prob_nonsterile"] = np.empty(
                    container.size, dtype=FTYPE
                )
            else:
                raise ValueError(
                    f"unknown container name: {container.name!r} — osc.globes"
                    " requires *_cc / *_nc containers (reference"
                    " globes.py:160)"
                )

    def compute_function(self):
        for angle in (
            self.params.theta12, self.params.theta13, self.params.theta23,
            self.params.theta24, self.params.theta34, self.params.deltacp,
        ):
            if angle.value.units == ureg.dimensionless:
                raise ValueError(
                    f"{angle.name} is dimensionless; give rad or deg"
                )

        # SetParametersArr equivalent (reference globes.py:219-232):
        # theta14 and both sterile CP phases pinned to zero.
        U4 = pmns4_matrix(
            self.params.theta12.m_as("rad"),
            self.params.theta13.m_as("rad"),
            self.params.theta23.m_as("rad"),
            0.0,
            self.params.theta24.m_as("rad"),
            self.params.theta34.m_as("rad"),
            self.params.deltacp.m_as("rad"),
            0.0,
            0.0,
        )
        dm21 = self.params.deltam21.m_as("eV**2")
        dms = jnp.stack(
            [
                jnp.zeros_like(jnp.asarray(dm21)),
                jnp.asarray(dm21),
                jnp.asarray(self.params.deltam31.m_as("eV**2")),
                jnp.asarray(self.params.deltam41.m_as("eV**2")),
            ]
        )

        if self.is_map:
            self.data.link_containers("nu", _NU_FLAVS)
            self.data.link_containers("nubar", _NUBAR_FLAVS)

        for container in self.data:
            probs4 = osc_probs_layers_4nu(
                dms,
                U4,
                int(container["nubar"]),
                jnp.asarray(container["true_energy"], dtype=FTYPE),
                jnp.asarray(container["densities"], dtype=FTYPE),
                jnp.asarray(container["densities_neutron"], dtype=FTYPE),
                jnp.asarray(container["distances"], dtype=FTYPE),
            )
            container["probability4"] = probs4
            container.mark_changed("probability4")

        self.data.unlink_containers()

        for container in self.data:
            flav = int(container["flav"])
            probs4 = container["probability4"]
            if container.name.endswith("_cc"):
                # P(nue -> flav), P(numu -> flav) incl. sterile effects
                container["prob_e"] = probs4[:, 0, flav]
                container["prob_mu"] = probs4[:, 1, flav]
                container.mark_changed("prob_e")
                container.mark_changed("prob_mu")
            else:
                # survival into ANY active flavor (globes.py:195-214)
                container["prob_nonsterile"] = probs4[:, flav, :3].sum(
                    axis=-1
                )
                container.mark_changed("prob_nonsterile")

    def apply_function(self):
        for container in self.data:
            nu_flux = container["nu_flux"]
            container["weights"] = container["weights"] * (
                (
                    nu_flux[:, 0] * container["prob_e"]
                    + nu_flux[:, 1] * container["prob_mu"]
                )
                * container["prob_nonsterile"]
            )


def init_test(**param_kwargs):
    """Instantiation example (reference globes.py:297-312)."""
    param_set = ParamSet(
        [
            Param(name="theta12", value=33 * ureg.degree, **param_kwargs),
            Param(name="theta13", value=8 * ureg.degree, **param_kwargs),
            Param(name="theta23", value=50 * ureg.degree, **param_kwargs),
            Param(name="theta24", value=8 * ureg.degree, **param_kwargs),
            Param(name="theta34", value=0 * ureg.degree, **param_kwargs),
            Param(name="deltam21", value=8e-5 * ureg.eV**2, **param_kwargs),
            Param(name="deltam31", value=3e-3 * ureg.eV**2, **param_kwargs),
            Param(name="deltam41", value=1.0 * ureg.eV**2, **param_kwargs),
            Param(name="deltacp", value=180 * ureg.degree, **param_kwargs),
        ]
    )
    return globes(
        earth_model="osc/PREM_12layer.dat",
        params=param_set,
    )
