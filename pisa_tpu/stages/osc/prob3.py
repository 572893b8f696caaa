"""
Three-flavor matter-oscillation service (cf. reference
``pisa/stages/osc/prob3.py:37``): computes P(nu_e -> flav) and
P(nu_mu -> flav) per event/grid-point through Earth-layer chains and applies
``weights *= flux_e * P_e + flux_mu * P_mu``.

Options mirror the reference: NLO CC potential, NSI ('standard' /
'vacuum-like'), reparameterized mixing matrix, neutrino decay, Earth
tomography, and LRI. The propagation itself is the jitted split-complex
kernel (:func:`pisa_tpu.ops.osc.kernels.osc_probs_layers`), batched over all
points of a container; flavor-independent layer chains are computed once for
linked containers.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from pisa_tpu import FTYPE, ureg
from pisa_tpu.core.binning import MultiDimBinning
from pisa_tpu.core.param import Param, ParamSet
from pisa_tpu.core.stage import Stage
from pisa_tpu.ops.cplx import C
from pisa_tpu.ops.osc.kernels import osc_probs_layers
from pisa_tpu.ops.osc.layers import Layers
from pisa_tpu.ops.osc.nonstandard import (
    Core_scaling_w_constrain,
    Core_scaling_wo_constrain,
    DecayParams,
    FIVE_LAYER_RADII_KM,
    FIVE_LAYER_RHOS,
    LRIParams,
    Mass_scaling,
    StdNSIParams,
    TOMOGRAPHY_ERROR_MSG,
    VacuumLikeNSIParams,
    decay_matrix_C,
    lri_potential,
    std_nsi_eps_C,
    vacuum_nsi_eps_C,
)
from pisa_tpu.ops.osc.pallas_chain import (
    osc_probs_planar,
    prepare_chain_geometry,
    target_platform,
    use_chain_kernel,
)
from pisa_tpu.ops.osc.pmns import OscParams, dm_matrix, pmns_matrix, pmns_matrix_reparam
from pisa_tpu.utils.log import logging

__all__ = ["prob3", "init_test", "LRI_TYPES", "NSI_TYPES", "TOMOGRAPHY_TYPES"]

LRI_TYPES = ["emu-symmetry", "etau-symmetry", "mutau-symmetry"]
NSI_TYPES = ["standard", "vacuum-like"]
TOMOGRAPHY_TYPES = [
    "mass_of_earth",
    "mass_of_core_w_constrain",
    "mass_of_core_wo_constrain",
]

_ALL_FLAVS = [
    "nue_cc", "numu_cc", "nutau_cc", "nue_nc", "numu_nc", "nutau_nc",
    "nuebar_cc", "numubar_cc", "nutaubar_cc", "nuebar_nc", "numubar_nc",
    "nutaubar_nc",
]
_NU_FLAVS = _ALL_FLAVS[:6]
_NUBAR_FLAVS = _ALL_FLAVS[6:]

# container keys of the prepared chain-kernel geometry
# (pallas_chain.prepare_chain_geometry), stored as osc_blk_<key>
_GEOM_KEYS = ("e", "dens", "dist", "nl", "inv")


class prob3(Stage):  # noqa: N801
    """See module docstring; parameters as in the reference
    (``prob3.py:124-161``)."""

    def __init__(
        self,
        include_nlo=False,
        nsi_type=None,
        reparam_mix_matrix=False,
        neutrino_decay=False,
        tomography_type=None,
        lri_type=None,
        layer_dedup=False,
        **std_kwargs,
    ):
        # collapse mirrored chain segments to unique (density, distance)
        # pairs (the reference kernel's layer cache, done once at setup);
        # off by default: the re-expansion gather can cost more than the
        # saved transition algebra
        self.layer_dedup = layer_dedup
        expected_params = [
            "detector_depth",
            "earth_model",
            "prop_height",
            "YeI",
            "YeO",
            "YeM",
            "theta12",
            "theta13",
            "theta23",
            "deltam21",
            "deltam31",
            "deltacp",
        ]

        self.include_nlo = include_nlo

        if nsi_type is not None:
            nsi_type = nsi_type.strip().lower()
            if nsi_type not in NSI_TYPES:
                raise ValueError(
                    f"nsi_type {nsi_type!r} invalid; choose from {NSI_TYPES}"
                )
        self.nsi_type = nsi_type
        self.reparam_mix_matrix = reparam_mix_matrix
        self.neutrino_decay = neutrino_decay

        if nsi_type == "vacuum-like":
            expected_params += [
                "eps_scale", "eps_prime", "phi12", "phi13", "phi23",
                "alpha1", "alpha2", "deltansi",
            ]
        elif nsi_type == "standard":
            expected_params += [
                "eps_ee", "eps_emu_magn", "eps_emu_phase", "eps_etau_magn",
                "eps_etau_phase", "eps_mumu", "eps_mutau_magn",
                "eps_mutau_phase", "eps_tautau",
            ]
        if neutrino_decay:
            expected_params += ["decay_alpha3"]

        if lri_type is not None:
            lri_type = lri_type.strip().lower()
            if lri_type not in LRI_TYPES:
                raise ValueError(
                    f"lri_type {lri_type!r} invalid; choose from {LRI_TYPES}"
                )
            expected_params += ["v_lri"]
        self.lri_type = lri_type

        if tomography_type is not None:
            tomography_type = tomography_type.strip().lower()
            if tomography_type not in TOMOGRAPHY_TYPES:
                raise ValueError(
                    f"tomography_type {tomography_type!r} invalid; choose"
                    f" from {TOMOGRAPHY_TYPES}"
                )
            if tomography_type == "mass_of_earth":
                expected_params += ["density_scale"]
            elif tomography_type == "mass_of_core_w_constrain":
                expected_params += ["core_density_scale"]
            else:
                expected_params += [
                    "core_density_scale",
                    "innermantle_density_scale",
                    "middlemantle_density_scale",
                ]
        self.tomography_type = tomography_type

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

        self.layers = None
        self.osc_params = None
        self.nsi_params = None
        self.decay_params = None
        self.lri_params = None
        self.tomography_params = None
        self.YeI = self.YeO = self.YeM = None

    # -- setup ---------------------------------------------------------------
    def setup_function(self):
        self.osc_params = OscParams()
        if self.nsi_type == "vacuum-like":
            self.nsi_params = VacuumLikeNSIParams()
        elif self.nsi_type == "standard":
            self.nsi_params = StdNSIParams()
        if self.neutrino_decay:
            self.decay_params = DecayParams()
        if self.lri_type is not None:
            self.lri_params = LRIParams()

        earth_model = self.params.earth_model.value
        self.YeI = self.params.YeI.m_as("dimensionless")
        self.YeO = self.params.YeO.m_as("dimensionless")
        self.YeM = self.params.YeM.m_as("dimensionless")
        prop_height = self.params.prop_height.m_as("km")
        detector_depth = self.params.detector_depth.m_as("km")
        self.layers = Layers(earth_model, detector_depth, prop_height)
        self.layers.setElecFrac(self.YeI, self.YeO, self.YeM)

        if self.tomography_type == "mass_of_earth":
            self.tomography_params = Mass_scaling()
        elif self.tomography_type is not None:
            radii_ext = self.layers.radii[::-1][:-1]
            rhos_ext = self.layers.rhos_unweighted[::-1][:-1]
            if not (
                len(radii_ext) == len(FIVE_LAYER_RADII_KM)
                and np.allclose(radii_ext, FIVE_LAYER_RADII_KM)
                and np.allclose(rhos_ext, FIVE_LAYER_RHOS)
            ):
                raise ValueError(TOMOGRAPHY_ERROR_MSG)
            if self.tomography_type == "mass_of_core_w_constrain":
                self.tomography_params = Core_scaling_w_constrain()
            else:
                self.tomography_params = Core_scaling_wo_constrain()

        self._calc_layers_into_containers()

        # probability outputs
        if self.is_map:
            self.data.link_containers("nu", _NU_FLAVS)
            self.data.link_containers("nubar", _NUBAR_FLAVS)
        for container in self.data:
            container["probability"] = np.empty(
                (container.size, 3, 3), dtype=FTYPE
            )
        self.data.unlink_containers()
        for container in self.data:
            container["prob_e"] = np.empty(container.size, dtype=FTYPE)
            container["prob_mu"] = np.empty(container.size, dtype=FTYPE)

    def _calc_layers_into_containers(self):
        if self.is_map:
            # layers are flavor-independent: compute once for all categories
            self.data.link_containers("nu", _ALL_FLAVS)
        for container in self.data:
            self.layers.calcLayers(np.asarray(container["true_coszen"]))
            densities = self.layers.density.reshape(
                (container.size, self.layers.max_layers)
            )
            distances = self.layers.distance.reshape(
                (container.size, self.layers.max_layers)
            )
            if self.layer_dedup:
                from pisa_tpu.ops.osc.layers import dedup_layers

                uniq_d, uniq_x, chain_map = dedup_layers(
                    densities, distances
                )
                container["densities"] = uniq_d
                container["distances"] = uniq_x
                container["layer_chain_map"] = chain_map
            else:
                container["densities"] = densities
                container["distances"] = distances
                # flat layer-major indices of the real (distance > 0) layer
                # slots: the XLA/backward path then runs the transition
                # algebra only over these instead of the padded rectangle
                from pisa_tpu.ops.osc.layers import layer_slot_index

                container["layer_slot_index"] = layer_slot_index(distances)

                # chain-kernel geometry (sorted, blocked, layer-major),
                # prepared once here since the geometry is parameter-free
                if self._use_kernel():
                    geom = prepare_chain_geometry(
                        np.asarray(container["true_energy"], dtype=FTYPE),
                        np.asarray(densities, dtype=FTYPE),
                        np.asarray(distances, dtype=FTYPE),
                    )
                    for gk in _GEOM_KEYS:
                        container[f"osc_blk_{gk}"] = geom[gk]
        self.data.unlink_containers()

    def _use_kernel(self):
        """The GPU chain kernel runs for standard three-flavour matter
        physics in float32 on a GPU; everything else (CPU, fp64, decay,
        NSI, LRI, tomography, layer dedup) runs the XLA formulation."""
        standard = not (
            self.neutrino_decay
            or self.nsi_type is not None
            or self.lri_type is not None
            or self.tomography_type is not None
            or self.layer_dedup
        )
        return use_chain_kernel(target_platform(), FTYPE, standard)

    # -- compute --------------------------------------------------------------
    def compute_function(self):
        if self.is_map:
            self.data.link_containers("nu", _NU_FLAVS)
            self.data.link_containers("nubar", _NUBAR_FLAVS)

        # re-derive layers if electron fractions changed
        YeI = self.params.YeI.m_as("dimensionless")
        YeO = self.params.YeO.m_as("dimensionless")
        YeM = self.params.YeM.m_as("dimensionless")
        if (YeI, YeO, YeM) != (self.YeI, self.YeO, self.YeM):
            self.YeI, self.YeO, self.YeM = YeI, YeO, YeM
            self.data.unlink_containers()
            self.layers.setElecFrac(YeI, YeO, YeM)
            self._calc_layers_into_containers()
            if self.is_map:
                self.data.link_containers("nu", _NU_FLAVS)
                self.data.link_containers("nubar", _NUBAR_FLAVS)

        # angles must carry units (cf. reference prob3.py:480-482)
        for angle in (
            self.params.theta12,
            self.params.theta13,
            self.params.theta23,
            self.params.deltacp,
        ):
            if angle.value.units == ureg.dimensionless:
                raise ValueError(
                    f"{angle.name} is dimensionless; give rad or deg"
                )

        # trace-safe mixing-matrix construction (params may be JAX tracers
        # when the pipeline is compiled into a template function)
        theta12 = self.params.theta12.m_as("rad")
        theta13 = self.params.theta13.m_as("rad")
        theta23 = self.params.theta23.m_as("rad")
        dm21 = self.params.deltam21.m_as("eV**2")
        dm31 = self.params.deltam31.m_as("eV**2")
        deltacp = self.params.deltacp.m_as("rad")

        # NSI / decay / LRI matrices via the trace-safe split-complex
        # builders (ops/osc/nonstandard.py): the coupling parameters may be
        # JAX tracers, so compiled templates take analytic gradients w.r.t.
        # them (the reference fits these by finite differences only)
        eps_C = None
        if self.nsi_type == "vacuum-like":
            eps_C = vacuum_nsi_eps_C(
                self.params.eps_scale.m_as("dimensionless"),
                self.params.eps_prime.m_as("dimensionless"),
                self.params.phi12.m_as("rad"),
                self.params.phi13.m_as("rad"),
                self.params.phi23.m_as("rad"),
                self.params.alpha1.m_as("rad"),
                self.params.alpha2.m_as("rad"),
                self.params.deltansi.m_as("rad"),
            )
        elif self.nsi_type == "standard":
            eps_C = std_nsi_eps_C(
                self.params.eps_ee.m_as("dimensionless"),
                self.params.eps_emu_magn.m_as("dimensionless"),
                self.params.eps_emu_phase.m_as("rad"),
                self.params.eps_etau_magn.m_as("dimensionless"),
                self.params.eps_etau_phase.m_as("rad"),
                self.params.eps_mumu.m_as("dimensionless"),
                self.params.eps_mutau_magn.m_as("dimensionless"),
                self.params.eps_mutau_phase.m_as("rad"),
                self.params.eps_tautau.m_as("dimensionless"),
            )

        if self.tomography_type is not None:
            if self.tomography_type == "mass_of_earth":
                self.tomography_params.density_scale = (
                    self.params.density_scale.m_as("dimensionless")
                )
                self.layers.scaling(self.tomography_params.density_scale)
            elif self.tomography_type == "mass_of_core_w_constrain":
                self.tomography_params.core_density_scale = (
                    self.params.core_density_scale.m_as("dimensionless")
                )
                self.layers.scaling(self.tomography_params.scaling_array)
            else:
                tp = self.tomography_params
                tp.core_density_scale = self.params.core_density_scale.m_as(
                    "dimensionless"
                )
                tp.innermantle_density_scale = (
                    self.params.innermantle_density_scale.m_as("dimensionless")
                )
                tp.middlemantle_density_scale = (
                    self.params.middlemantle_density_scale.m_as("dimensionless")
                )
                self.layers.scaling(tp.scaling_factor_array)
            self.data.unlink_containers()
            self.layers.setElecFrac(self.YeI, self.YeO, self.YeM)
            self._calc_layers_into_containers()
            if self.is_map:
                self.data.link_containers("nu", _NU_FLAVS)
                self.data.link_containers("nubar", _NUBAR_FLAVS)

        # generalized matter potential (split-complex; trace-safe)
        std_re = np.zeros((3, 3), dtype=np.float64)
        std_re[0, 0] = 1.020 if self.include_nlo else 1.0
        if eps_C is not None:
            mat_pot = C(
                jnp.asarray(std_re, dtype=FTYPE) + eps_C.re.astype(FTYPE),
                eps_C.im.astype(FTYPE),
            )
        else:
            mat_pot = C(
                jnp.asarray(std_re, dtype=FTYPE),
                jnp.zeros((3, 3), dtype=FTYPE),
            )

        if self.neutrino_decay:
            mat_decay = decay_matrix_C(
                self.params.decay_alpha3.m_as("eV**2")
            )
            mat_decay = C(
                mat_decay.re.astype(FTYPE), mat_decay.im.astype(FTYPE)
            )
        else:
            mat_decay = C(
                jnp.zeros((3, 3), dtype=FTYPE),
                jnp.zeros((3, 3), dtype=FTYPE),
            )
        if self.lri_type is not None:
            lri_pot = lri_potential(
                self.params.v_lri.m_as("eV"), self.lri_type
            ).astype(FTYPE)
        else:
            lri_pot = np.zeros((3, 3))

        pmns_fn = (
            pmns_matrix_reparam if self.reparam_mix_matrix else pmns_matrix
        )
        mix = pmns_fn(
            jnp.sin(theta12), jnp.sin(theta13), jnp.sin(theta23), deltacp
        )
        dm = dm_matrix(dm21, dm31)

        # GPU chain kernel (standard physics, float32): propagation and
        # forward-mode gradients in one Pallas kernel over the geometry
        # prepared at setup; the XLA formulation otherwise
        use_kernel = self._use_kernel()
        theta_vec = (
            jnp.stack(
                [
                    jnp.asarray(x, dtype=FTYPE)
                    for x in (theta12, theta13, theta23, deltacp, dm21, dm31)
                ]
            )
            if use_kernel
            else None
        )

        stacked = any(
            getattr(c, "is_stacked", False) for c in self.data.containers
        )
        if stacked and not self.is_map:
            # stacked containers, PER-EVENT calc: every (category, event)
            # slot is propagated with its category's nubar sign — two
            # fixed-sign kernel launches over the category-partitioned
            # stacked event axis, the same total work as the unstacked
            # per-container path but ONE trace
            for container in self.data:
                self._compute_stacked_events(
                    container, dm, mix, mat_pot, mat_decay, lri_pot,
                )
            return
        if stacked:
            # stacked containers (grid calc): one propagation per nubar sign
            # — exactly the linked path's work — stacked into a 2-row
            # probability array; the per-flavor projections become 6 rows
            # (nubar-group x final flavor) mapped onto the categories by a
            # rows index instead of 12 per-container slices
            for container in self.data:
                grp = (
                    np.asarray(container.cat_aux("nubar")) < 0
                ).astype(np.int32)
                flav_arr = np.asarray(
                    container.cat_aux("flav"), dtype=np.int32
                )
                rows_pf = grp * 3 + flav_arr
                if use_kernel and "osc_blk_e" in container:
                    # both signs in one launch; the kernel's point-last
                    # (sign, init, final, point) output reshapes straight
                    # into the (group x final flavour) rate rows
                    pl_ = self._propagate_planar(
                        container, (1, -1), theta_vec
                    )
                    n = pl_.shape[-1]
                    container.set_stacked(
                        "prob_e", pl_[:, 0].reshape(6, n), rows=rows_pf
                    )
                    container.set_stacked(
                        "prob_mu", pl_[:, 1].reshape(6, n), rows=rows_pf
                    )
                    # full 3x3 probability (unused by the rates; XLA drops
                    # it unless read)
                    container.set_stacked(
                        "probability",
                        jnp.stack([_full_probs(p) for p in pl_]),
                        rows=grp,
                    )
                    continue
                p_nu = self._propagate(
                    container, 1, dm, mix, mat_pot, mat_decay, lri_pot,
                    theta_vec,
                )
                p_nub = self._propagate(
                    container, -1, dm, mix, mat_pot, mat_decay, lri_pot,
                    theta_vec,
                )
                probability = jnp.stack([p_nu, p_nub])  # (2, n, 3, 3)
                container.set_stacked("probability", probability, rows=grp)
                # (group, final flavor) rows: P(e->f), P(mu->f)
                pe = jnp.moveaxis(probability[:, :, 0, :], -1, 1).reshape(
                    6, -1
                )
                pm = jnp.moveaxis(probability[:, :, 1, :], -1, 1).reshape(
                    6, -1
                )
                container.set_stacked("prob_e", pe, rows=rows_pf)
                container.set_stacked("prob_mu", pm, rows=rows_pf)
            return

        for container in self.data:
            probs = self._propagate(
                container, int(container["nubar"]), dm, mix, mat_pot,
                mat_decay, lri_pot, theta_vec,
            )
            container["probability"] = probs
            container.mark_changed("probability")

        self.data.unlink_containers()

        # per-flavor projections: P(e -> flav), P(mu -> flav)
        for container in self.data:
            flav = int(container["flav"])
            probs = container["probability"]
            container["prob_e"] = probs[:, 0, flav]
            container["prob_mu"] = probs[:, 1, flav]
            container.mark_changed("prob_e")
            container.mark_changed("prob_mu")

    def _propagate(
        self, container, nubar, dm, mix, mat_pot, mat_decay, lri_pot,
        theta_vec,
    ):
        """One propagation over a container's points for a given nubar sign;
        returns (n_points, 3, 3) probabilities."""
        if theta_vec is not None and "osc_blk_e" in container:
            return _full_probs(
                self._propagate_planar(container, (nubar,), theta_vec)[0]
            )
        chain_map = (
            jnp.asarray(container["layer_chain_map"])
            if self.layer_dedup
            else None
        )
        import os as _os

        slot_index = (
            jnp.asarray(container["layer_slot_index"])
            if not self.layer_dedup
            and "layer_slot_index" in container
            and _os.environ.get("PISA_TPU_OSC_SLOT_COMPACT", "1")
            not in ("0", "off")
            # grid-sharded containers (shard_stacked_containers): the slot
            # indices are GLOBAL over the flat (point, layer) space, so the
            # compacted gather would force cross-shard collectives; the
            # uncompacted XLA formulation is purely elementwise over the
            # grid axis and partitions cleanly
            and not getattr(container, "grid_sharded", False)
            else None
        )
        physics = (dm, mix, mat_pot, mat_decay,
                   jnp.asarray(lri_pot, dtype=FTYPE))
        points = (
            jnp.asarray(container["true_energy"], dtype=FTYPE),
            jnp.asarray(container["densities"], dtype=FTYPE),
            jnp.asarray(container["distances"], dtype=FTYPE),
        ) + (() if chain_map is None else (chain_map,))

        def propagate(physics, e, dens, dist, cmap=None):
            return osc_probs_layers(
                *physics, nubar, e, dens, dist,
                decay_flag=bool(self.neutrino_decay), chain_map=cmap,
                slot_index=slot_index,
            )

        if getattr(container, "grid_sharded", False):
            # pointwise over the grid: each device propagates its own
            # shard (under plain GSPMD the layer-major reshapes lose the
            # point sharding and every device would run the whole grid)
            ax = container.mesh_axis
            propagate = jax.shard_map(
                propagate, mesh=container.mesh,
                in_specs=(P(),) + (P(ax),) + (P(ax, None),) * (
                    len(points) - 1
                ),
                out_specs=P(ax), check_vma=False,
            )
        return propagate(physics, *points)

    # stacked-container support: grid calc + events apply (the flagship
    # shape), where the probabilities live on the shared grid as
    # (group x flavor) rows and translate to the stacked events via one
    # batched gather; OR per-event calc (calc_mode=events, a first-class
    # reference mode — reference ``prob3.py:452`` runs any representation),
    # where each stacked (category, event) slot is propagated directly with
    # its category's nubar sign (two fixed-sign kernel launches over the
    # category-partitioned event axis)
    def stacked_ok(self):
        return (self.is_map or self.calc_mode == "events") and not isinstance(
            self.apply_mode, MultiDimBinning
        )

    def stacking_exclude_keys(self):
        # events-calc helper arrays whose leading axis is NOT the event
        # axis (compacted slot indices, prepared kernel geometry) cannot
        # pad-stack; the stacked events path runs the plain XLA formulation
        # and never reads them
        if self.is_map:
            return ()
        return ("layer_slot_index", "layer_chain_map") + tuple(
            f"osc_blk_{gk}" for gk in _GEOM_KEYS
        )

    def _propagate_planar(self, container, signs, theta_vec):
        """Chain-kernel propagation over the container's prepared geometry
        for the neutrino `signs`: returns ``(len(signs), 2, 3, n)`` --
        (sign, initial state e/mu, final flavour, point). Tangent launches
        run only for the free oscillation parameters (a fixed one's
        cotangent is discarded upstream); on a sharded container the
        launches run under shard_map over its mesh."""
        geom = {
            gk: jnp.asarray(container[f"osc_blk_{gk}"]) for gk in _GEOM_KEYS
        }
        active = tuple(
            i
            for i, prm in enumerate(
                (
                    self.params.theta12,
                    self.params.theta13,
                    self.params.theta23,
                    self.params.deltacp,
                    self.params.deltam21,
                    self.params.deltam31,
                )
            )
            if not prm.is_fixed
        )
        return osc_probs_planar(
            theta_vec,
            signs,
            geom,
            reparam=self.reparam_mix_matrix,
            nlo_factor=1.020 if self.include_nlo else 1.0,
            active=active,
            mesh=getattr(container, "mesh", None),
            axis_name=getattr(container, "mesh_axis", "data"),
        )

    def _compute_stacked_events(self, container, dm, mix, mat_pot,
                                mat_decay, lri_pot):
        """Per-event osc on a stacked container (calc_mode=events): flatten
        each nubar group's (categories x padded events) block, run one
        fixed-sign propagation per group (the kernel's nubar is static,
        ``ops/osc/kernels.py`` get_H_mat), and scatter the (C, n_pad)
        flavor projections back. Padded slots (NaN coordinate energy,
        zero-padded chains) are sanitized to E=1 GeV with zero-length
        chains (identity transition) so they stay finite under
        differentiation; their weights are zero-padded downstream."""
        e = jnp.asarray(container["true_energy"], dtype=FTYPE)   # (C, n_pad)
        dens = jnp.asarray(container["densities"], dtype=FTYPE)  # (C,n_pad,L)
        dist = jnp.asarray(container["distances"], dtype=FTYPE)
        grp = (np.asarray(container.cat_aux("nubar")) < 0).astype(np.int32)
        flav = np.asarray(container.cat_aux("flav"), dtype=np.int32)
        n_cats, n_pad = e.shape
        one = jnp.asarray(1.0, dtype=FTYPE)
        e = jnp.where(jnp.isfinite(e) & (e > 0), e, one)
        dens = jnp.where(jnp.isfinite(dens), dens, 0.0)
        dist = jnp.where(jnp.isfinite(dist), dist, 0.0)
        probs = jnp.zeros((n_cats, n_pad, 3, 3), dtype=FTYPE)
        for sign in (1, -1):
            idx = np.where(grp == (1 if sign < 0 else 0))[0]
            if idx.size == 0:
                continue
            p = osc_probs_layers(
                dm, mix, mat_pot, mat_decay,
                jnp.asarray(lri_pot, dtype=FTYPE), sign,
                e[idx].reshape(-1),
                dens[idx].reshape(-1, dens.shape[-1]),
                dist[idx].reshape(-1, dist.shape[-1]),
                decay_flag=bool(self.neutrino_decay),
            )
            probs = probs.at[idx].set(
                p.reshape(idx.size, n_pad, 3, 3)
            )
        container["probability"] = probs
        # per-category flavor projections: P(e->flav_c), P(mu->flav_c)
        fl = jnp.asarray(flav, dtype=jnp.int32)[:, None, None]
        pe = jnp.take_along_axis(probs[:, :, 0, :], fl, axis=2)[..., 0]
        pm = jnp.take_along_axis(probs[:, :, 1, :], fl, axis=2)[..., 0]
        container["prob_e"] = pe
        container["prob_mu"] = pm

    def _apply_stacked(self, container):
        """Fused grid-rate path for a stacked container: one (6, ngrid) rate
        array (nubar-group x final flavor — flux is flavor-independent, so
        each of the 2 flux rows serves 3 rate rows) gathered to the stacked
        events in a single op.

        When the flux is PER-EVENT (events-calc flux stage upstream, e.g.
        example.cfg / kde_example.cfg), the grid fusion identity does not
        apply — gather the probabilities to the stacked events instead and
        take the per-event product, exactly like the unstacked unfused
        branch (reference ``barr_simple.py:146`` apply semantics)."""
        from pisa_tpu.core.container import _rep_hash

        rep = container.representation
        apply_h = _rep_hash(rep)
        flux_valid_events = isinstance(rep, str) and container.validity.get(
            "nu_flux", {}
        ).get(apply_h, False)
        # per-event calc mode writes the probabilities directly in the
        # events representation; the per-event product branch then applies
        # regardless of where the flux lives (reading nu_flux translates
        # grid -> stacked events in one gather if needed)
        prob_valid_events = isinstance(rep, str) and container.validity.get(
            "prob_e", {}
        ).get(apply_h, False)
        if flux_valid_events or prob_valid_events:
            nu_flux = container["nu_flux"]  # (C, n_pad, 2) per event
            # reading prob_e/prob_mu in the events representation folds the
            # (group-row x grid) -> stacked-events gather into ONE op
            # (StackedContainer._stacked_binned_to_array; padded slots
            # gather 0)
            pe = container["prob_e"]
            pm = container["prob_mu"]
            container["weights"] = container["weights"] * (
                nu_flux[..., 0] * pe + nu_flux[..., 1] * pm
            )
            return
        container.representation = self.calc_mode
        nu_flux = container["nu_flux"]  # (2, n, 2), rows = nubar group
        rows_flux = container.rows[("nu_flux", _rep_hash(self.calc_mode))]
        pe = container["prob_e"]  # (6, n), rows = group*3 + flav
        pm = container["prob_mu"]
        rows_pf = container.rows[("prob_e", _rep_hash(self.calc_mode))]
        if nu_flux.ndim == 2:
            # flux shared across categories (single row)
            nf6 = nu_flux[None]
        elif (
            nu_flux.shape[0] == 2
            and rows_flux is not None
            and not (isinstance(rows_flux, str) and rows_flux == "cat")
            and np.array_equal(
                np.asarray(rows_flux), np.asarray(rows_pf) // 3
            )
        ):
            # expand each flux group row to its 3 flavor rows, ordered to
            # match rows_pf = group*3 + flav
            nf6 = jnp.repeat(nu_flux, 3, axis=0)
        else:
            raise NotImplementedError(
                "stacked prob3 expects a shared or nubar-grouped nu_flux on"
                f" the calc grid (got shape {nu_flux.shape}, rows"
                f" {rows_flux!r})"
            )
        rate = nf6[..., 0] * pe + nf6[..., 1] * pm
        if getattr(self, "_defer_rate_to_hist", False):
            # rate DEFERRAL (CompiledTemplate._setup_rate_deferral): hand
            # the (6, ngrid) grid rate to the histogram stage as a factor
            # instead of gathering it to 240k events here — the factorized
            # histogram contracts it against a static (grid x bins) matrix,
            # removing both the forward gather and its reverse-mode scatter
            # from every template/gradient.
            container.deferred_rate = {"rate": rate, "rows": rows_pf}
            container.representation = rep
            return
        container.set_stacked("osc_flux_rate", rate, rows=rows_pf)
        container.representation = rep
        container["weights"] = (
            container["weights"] * container["osc_flux_rate"]
        )

    def apply_function(self):
        from pisa_tpu.core.container import _rep_hash

        calc_h = _rep_hash(self.calc_mode)
        for container in self.data:
            if getattr(container, "is_stacked", False):
                self._apply_stacked(container)
                continue
            # When flux and probabilities are both valid on the calc grid and
            # must be translated to the apply representation, fuse the
            # flux*probability product ON the grid first and translate the
            # single resulting rate channel: an 'average'-mode lookup gathers
            # the event's own grid cell, so gather(flux)*gather(prob) ==
            # gather(flux*prob) exactly — and one gather per container
            # replaces three.
            #
            # This identity holds ONLY for events-rep lookups of grid-sourced
            # values. It does NOT hold when the apply representation is a
            # binning (resample averages: avg(f*p) != avg(f)*avg(p)), nor when
            # nu_flux is already valid per-event in the apply representation
            # (the unfused path would use the exact per-event flux, not the
            # grid-averaged one). Both cases fall through to the unfused
            # branch below.
            apply_rep = container.representation
            apply_h = _rep_hash(apply_rep)
            apply_is_events = isinstance(apply_rep, str)
            fusable = (
                apply_h != calc_h
                and apply_is_events
                and not container.validity.get("nu_flux", {}).get(
                    apply_h, False
                )
                and container.validity.get("nu_flux", {}).get(calc_h, False)
                and container.validity.get("prob_e", {}).get(calc_h, False)
                and container.validity.get("prob_mu", {}).get(calc_h, False)
            )
            if fusable:
                rep = container.representation
                container.representation = self.calc_mode
                nu_flux = container["nu_flux"]
                rate = (
                    nu_flux[:, 0] * container["prob_e"]
                    + nu_flux[:, 1] * container["prob_mu"]
                )
                container["osc_flux_rate"] = rate
                container.mark_changed("osc_flux_rate")
                container.representation = rep
                container["weights"] = (
                    container["weights"] * container["osc_flux_rate"]
                )
            else:
                nu_flux = container["nu_flux"]
                container["weights"] = container["weights"] * (
                    nu_flux[:, 0] * container["prob_e"]
                    + nu_flux[:, 1] * container["prob_mu"]
                )


def _full_probs(planar):
    """(2, 3, n) e/mu initial-state rows -> (n, 3, 3) probabilities, the
    tau row from double stochasticity (|U|^2 of a unitary has unit column
    sums)."""
    tau = jnp.maximum(1.0 - planar[0] - planar[1], 0.0)
    return jnp.stack([planar[0], planar[1], tau]).transpose(2, 0, 1)


def init_test(**param_kwargs):
    """Instantiation example."""
    param_set = ParamSet(
        [
            Param(name="detector_depth", value=10 * ureg.km, **param_kwargs),
            Param(name="prop_height", value=18 * ureg.km, **param_kwargs),
            Param(
                name="earth_model", value="osc/PREM_4layer.dat", **param_kwargs
            ),
            Param(name="YeI", value=0.5, **param_kwargs),
            Param(name="YeO", value=0.5, **param_kwargs),
            Param(name="YeM", value=0.5, **param_kwargs),
            Param(name="theta12", value=33 * ureg.degree, **param_kwargs),
            Param(name="theta13", value=8 * ureg.degree, **param_kwargs),
            Param(name="theta23", value=50 * ureg.degree, **param_kwargs),
            Param(name="deltam21", value=8e-5 * ureg.eV**2, **param_kwargs),
            Param(name="deltam31", value=3e-3 * ureg.eV**2, **param_kwargs),
            Param(name="deltacp", value=180 * ureg.degree, **param_kwargs),
        ]
    )
    return prob3(include_nlo=True, params=param_set)
