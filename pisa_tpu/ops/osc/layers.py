"""
Earth-layer geometry: chord segment lengths and electron/neutron-weighted
densities per cos(zenith) through PREM shells.

Rebuild of reference ``pisa/stages/osc/layers.py:38-170`` (numba per-coszen
loop) as a single closed-form, fully-vectorized computation:

For a path from the production point (radius ``r_det + depth + prop_height``)
to the detector (radius ``r_det``), parameterize by distance ``s`` from the
detector toward the source. The radius along the path satisfies
``r(s)^2 = r_det^2 + s^2 + 2 s r_det cz``, so each shell boundary of radius
``R`` is crossed at ``s = -r_det cz ± sqrt(r_det^2 cz^2 - r_det^2 + R^2)``.
Collecting all in-range crossings, sorting them, and differencing yields the
segment lengths; each segment's density is that of the shell containing its
midpoint. Segments are emitted production-first (reference convention), padded
with zeros to ``max_layers = 2 * n_boundaries``.

This runs in numpy at setup time (it depends only on geometry, not on fit
params except Ye fractions / tomography scalings which only re-weight
densities).
"""

from __future__ import annotations

import numpy as np

from pisa_tpu.utils.resources import find_resource

__all__ = ["Layers", "calc_path_layers", "dedup_layers", "layer_slot_index"]

# Electron-fraction region boundaries (PREM, km); cf. reference
# ``layers.py:419-421``; the crust shares the mantle's electron fraction.
R_INNER = 1221.5
R_OUTER = 3480.0
R_MANTLE = 6371.0


def calc_path_layers(cz, radii, rhos, r_detector, max_layers=None):
    """Segment lengths and densities along paths for each cos(zenith).

    Parameters
    ----------
    cz : array (N,)
        cos(zenith) values (+1 = down-going).
    radii : array (B,)
        Shell boundary radii in km, strictly descending; ``radii[0]`` is the
        outermost boundary (production height), and shell ``i`` spans
        (radii[i+1], radii[i]].
    rhos : array (B,)
        Density of shell ``i`` (inside boundary ``radii[i]``).
    r_detector : float
        Detector radius in km.
    max_layers : int
        Output segment-slot count (default ``2 * B``).

    Returns
    -------
    distances : array (N, max_layers)
        Segment lengths (km), ordered production-first, zero-padded.
    densities : array (N, max_layers)
        Matching segment densities.
    n_layers : array (N,) int
        Number of nonzero segments.
    """
    cz = np.atleast_1d(np.asarray(cz, dtype=np.float64))
    radii = np.asarray(radii, dtype=np.float64)
    rhos = np.asarray(rhos, dtype=np.float64)
    if not np.all(np.diff(radii) < 0):
        raise ValueError("radii must be strictly descending")
    n_b = len(radii)
    if max_layers is None:
        max_layers = 2 * n_b
    rd = float(r_detector)

    disc = rd**2 * cz[:, None] ** 2 - rd**2 + radii[None, :] ** 2  # (N, B)
    valid = disc >= 0
    root = np.sqrt(np.where(valid, disc, 0.0))
    base = -rd * cz[:, None]
    s_plus = base + root  # far/production-side crossing
    s_minus = base - root  # near-side crossing (below-detector shells)

    # total path length = crossing of the outermost boundary
    s_total = s_plus[:, 0]

    eps = 1e-12
    crossings = np.concatenate([s_plus, s_minus], axis=1)  # (N, 2B)
    cross_valid = np.concatenate([valid, valid], axis=1)
    in_range = cross_valid & (crossings > eps) & (
        crossings <= s_total[:, None] + eps
    )
    # invalid crossings collapse onto the endpoint -> zero-length segments
    crossings = np.where(in_range, crossings, s_total[:, None])
    crossings.sort(axis=1)

    bounds = np.concatenate(
        [np.zeros((len(cz), 1)), crossings], axis=1
    )  # (N, 2B+1)
    seg_len = np.diff(bounds, axis=1)  # (N, 2B), detector-outward
    midpoints = 0.5 * (bounds[:, :-1] + bounds[:, 1:])
    r_mid_sq = rd**2 + midpoints**2 + 2.0 * midpoints * rd * cz[:, None]
    r_mid = np.sqrt(np.clip(r_mid_sq, 0.0, None))

    # shell index containing each midpoint: smallest descending-index i with
    # radii[i] >= r_mid (shell i spans (radii[i+1], radii[i]])
    rad_asc = radii[::-1].copy()
    k_asc = np.searchsorted(rad_asc, r_mid, side="left")
    shell_idx = (n_b - 1) - np.clip(k_asc, 0, n_b - 1)
    seg_density = rhos[shell_idx]

    # order production-first (reverse) and zero out empty segments
    seg_len = seg_len[:, ::-1]
    seg_density = seg_density[:, ::-1]
    nonzero = seg_len > eps
    seg_density = np.where(nonzero, seg_density, 0.0)
    seg_len = np.where(nonzero, seg_len, 0.0)

    # compact: shift nonzero segments to the front, preserving order
    order = np.argsort(~nonzero, axis=1, kind="stable")
    seg_len = np.take_along_axis(seg_len, order, axis=1)
    seg_density = np.take_along_axis(seg_density, order, axis=1)
    nonzero = seg_len > 0

    # merge adjacent same-density segments (grazing a boundary splits a chord
    # into two identical-density halves; T(d1) @ T(d2) == T(d1+d2) exactly
    # for equal density, so merging is lossless and shortens the layer chain)
    n_cz, n_seg = seg_len.shape
    same = np.zeros_like(nonzero)
    same[:, 1:] = (
        (seg_density[:, 1:] == seg_density[:, :-1])
        & nonzero[:, 1:]
        & nonzero[:, :-1]
    )
    group = np.cumsum(~same, axis=1) - 1  # (N, M) group index per segment
    rows = np.broadcast_to(np.arange(n_cz)[:, None], (n_cz, n_seg))
    merged_len = np.zeros_like(seg_len)
    np.add.at(merged_len, (rows, group), seg_len)
    merged_density = np.zeros_like(seg_density)
    np.add.at(merged_density, (rows, group), np.where(~same, seg_density, 0.0))
    seg_len, seg_density = merged_len, merged_density
    nonzero = seg_len > 0
    seg_density = np.where(nonzero, seg_density, 0.0)

    n_layers = nonzero.sum(axis=1)

    if max_layers < seg_len.shape[1]:
        if np.any(n_layers > max_layers):
            raise ValueError(
                f"Some paths cross more than max_layers={max_layers} segments"
            )
        seg_len = seg_len[:, :max_layers]
        seg_density = seg_density[:, :max_layers]
    elif max_layers > seg_len.shape[1]:
        pad = max_layers - seg_len.shape[1]
        seg_len = np.pad(seg_len, ((0, 0), (0, pad)))
        seg_density = np.pad(seg_density, ((0, 0), (0, pad)))

    return seg_len, seg_density, n_layers


class Layers:
    """Earth-model layer calculator (API-compatible with reference
    ``Layers``, ``layers.py:172``).

    Parameters
    ----------
    prem_file : str or None
        Whitespace-separated (radius_km, density) PREM table, ordered from the
        core outward. None -> no Earth model (only path lengths available).
    detector_depth : float
        Detector depth below surface, km.
    prop_height : float
        Neutrino production height in the atmosphere, km.
    """

    def __init__(self, prem_file, detector_depth=1.0, prop_height=2.0):
        if prem_file is not None:
            self.using_earth_model = True
            prem = np.loadtxt(find_resource(prem_file))
            # file rows go from the core outward; flip so index 0 = surface
            self.rhos_unweighted = prem[::-1, 1].astype(np.float64)
            self.radii = prem[::-1, 0].astype(np.float64)
            r_earth = float(prem[-1, 0])
            # prepend the atmosphere shell
            self.radii = np.concatenate(([r_earth + prop_height], self.radii))
            self.rhos_unweighted = np.concatenate(([1.0], self.rhos_unweighted))
            self.rhos = self.rhos_unweighted.copy()
            self.rhos_neutron_weighted = self.rhos_unweighted.copy()
            self.max_layers = 2 * len(self.radii)
            self._scaling_array = None
        else:
            self.using_earth_model = False
            r_earth = 6371.0

        assert detector_depth > 0, "detector depth must be positive"
        assert detector_depth <= r_earth, "detector deeper than Earth radius"
        assert prop_height >= 0, "production height must be non-negative"

        self.r_detector = r_earth - detector_depth
        self.prop_height = prop_height
        self.detector_depth = detector_depth

        if self.using_earth_model:
            self.computeMinLengthToLayers()

    # -- density weighting ---------------------------------------------------
    def setElecFrac(self, YeI, YeO, YeM):
        """Set electron fractions of inner core / outer core / mantle and
        re-weight densities (from the unscaled values each time, cf. reference
        issue #868 / ``layers.py:270``)."""
        if not self.using_earth_model:
            raise ValueError("No Earth model; cannot set electron fractions")
        self.YeFrac = np.asarray([YeI, YeO, YeM], dtype=np.float64)
        self.YnFrac = 1.0 - self.YeFrac
        base = self.rhos_unweighted
        if self._scaling_array is not None:
            base = base * self._scaling_array
        self.rhos = self._weight(base, self.YeFrac)
        self.rhos_neutron_weighted = self._weight(base, self.YnFrac)

    def _weight(self, rhos, frac):
        r = self.radii
        return (
            rhos * frac[0] * (r <= R_INNER)
            + rhos * frac[1] * (r <= R_OUTER) * (r > R_INNER)
            + rhos * frac[2] * (r <= R_MANTLE) * (r > R_OUTER)
        )

    def scaling(self, scaling_array):
        """Apply per-shell density scaling factors (Earth tomography); factors
        are indexed surface-first (like the reference's reversed-PREM order,
        ``layers.py:291-306``), excluding the atmosphere. Electron fractions
        must be re-applied afterwards (as the reference does,
        ``prob3.py:533``)."""
        if not self.using_earth_model:
            raise ValueError("No Earth model; cannot scale densities")
        if scaling_array is None:
            self._scaling_array = None
            return
        factors = np.atleast_1d(np.asarray(scaling_array, dtype=np.float64))
        full = np.ones_like(self.rhos_unweighted)
        full[1:] = factors  # broadcast scalar or per-shell, surface-first
        self._scaling_array = full

    # -- geometry ------------------------------------------------------------
    def computeMinLengthToLayers(self):
        """cos(zenith) at which a track is tangent to each boundary
        (cf. reference ``layers.py:308``)."""
        limits = np.ones_like(self.radii)
        below = self.radii < self.r_detector
        limits[below] = -np.sqrt(
            1.0 - (self.radii[below] ** 2 / self.r_detector**2)
        )
        self.coszen_limit = limits

    def calcLayers(self, cz):
        if not self.using_earth_model:
            raise ValueError("No Earth model; cannot calculate layers")
        dist, dens_e, n_layers = calc_path_layers(
            cz, self.radii, self.rhos, self.r_detector, self.max_layers
        )
        _, dens_n, _ = calc_path_layers(
            cz,
            self.radii,
            self.rhos_neutron_weighted,
            self.r_detector,
            self.max_layers,
        )
        self._distance = dist.ravel()
        self._density = dens_e.ravel()
        self._density_neutron_weighted = dens_n.ravel()
        self._n_layers = n_layers

    def calcPathLength(self, cz):
        """Total path length through a sphere out to the production radius
        (vacuum; cf. reference ``layers.py:388``)."""
        cz = np.atleast_1d(np.asarray(cz, dtype=np.float64))
        r_prop = self.r_detector + self.detector_depth + self.prop_height
        self._distance = -self.r_detector * cz + np.sqrt(
            self.r_detector**2 * cz**2 - (self.r_detector**2 - r_prop**2)
        )

    @property
    def n_layers(self):
        return self._n_layers

    @property
    def density(self):
        return self._density

    @property
    def density_neutron_weighted(self):
        return self._density_neutron_weighted

    @property
    def distance(self):
        return self._distance


def dedup_layers(densities, distances):
    """Collapse each padded layer chain to its unique (density, distance)
    pairs plus an index chain — the analog of the reference kernel's
    in-loop layer cache (``numba_osc_kernels.py:224-271``): chords traverse
    each shell twice (down/up) with identical segment properties, so only
    ~half the transition matrices are distinct.

    Parameters
    ----------
    densities, distances : (N, L) padded chains

    Returns
    -------
    unique_densities, unique_distances : (N, Lu) with Lu = max unique count
    chain_map : (N, L) int32 — chain slot -> unique slot
    """
    densities = np.asarray(densities)
    distances = np.asarray(distances)
    n, l = densities.shape

    # lexicographic per-row sort of (density, distance) pairs via complex.
    # Mirrored down/up segments of the same shell can differ by 1 ulp (their
    # lengths come from differently-ordered subtractions), so the MATCHING
    # key is quantized to float32 — the kernel computes in FTYPE (fp32 on
    # an accelerator) anyway; the stored values keep full precision.
    key = (
        densities.astype(np.float32).astype(np.complex128)
        + 1j * distances.astype(np.float32)
    )
    order = np.argsort(key, axis=1)
    sorted_key = np.take_along_axis(key, order, axis=1)
    is_new = np.ones((n, l), dtype=bool)
    is_new[:, 1:] = sorted_key[:, 1:] != sorted_key[:, :-1]
    rank_sorted = np.cumsum(is_new, axis=1) - 1  # (N, L) rank in sorted order

    # invert the sort: rank of each original slot
    chain_map = np.empty((n, l), dtype=np.int32)
    np.put_along_axis(chain_map, order, rank_sorted.astype(np.int32), axis=1)

    lu = int(rank_sorted.max()) + 1
    unique_densities = np.zeros((n, lu), dtype=densities.dtype)
    unique_distances = np.zeros((n, lu), dtype=distances.dtype)
    rows = np.repeat(np.arange(n), l).reshape(n, l)
    unique_densities[rows[is_new], rank_sorted[is_new]] = np.take_along_axis(
        densities, order, axis=1
    )[is_new]
    unique_distances[rows[is_new], rank_sorted[is_new]] = np.take_along_axis(
        distances, order, axis=1
    )[is_new]
    return unique_densities, unique_distances, chain_map


def layer_slot_index(distances):
    """Flat layer-major indices (layer * n_points + point) of the real
    (distance > 0) layer slots of an (N, L) chain array — the single
    source of truth for the slot-compaction convention consumed by
    :func:`pisa_tpu.ops.osc.kernels.osc_probs_layers` (``slot_index=``)
    and produced at setup by ``stages/osc/prob3.py``."""
    import numpy as np

    return np.flatnonzero(
        np.swapaxes(np.asarray(distances), 0, 1).ravel() > 0.0
    ).astype(np.int32)
