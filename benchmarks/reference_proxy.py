"""
Numba-free vectorized-numpy transcription of the reference PISA per-template
algorithm, for BASELINE CALIBRATION only (cf. BASELINE.md; VERDICT round 1,
item 2).

Reference PISA cannot run in this environment (numba/pint/etc. are not
installed and there is no network), so the reference-CPU baseline is
calibrated with this proxy: the same published algorithm the reference's
numba kernels implement — Barger et al. 3-flavor matter oscillations
(``pisa/stages/osc/prob3numba/numba_osc_kernels.py:122,349,835``), grid ->
event 'average' lookup (``pisa/core/translation.py:228``), per-event weight
products, and ``numpy.histogramdd`` binning (the reference's own correctness
oracle, ``pisa/core/translation.py:779``) — expressed as vectorized
complex128 numpy over the full point batch.

Why this is a fair stand-in for numba-compiled reference throughput: the
per-template cost is dominated by dense small-matrix arithmetic over ~40k
grid points x ~#layers (the reference JIT-compiles a per-point scalar loop;
vectorized numpy runs the identical flop stream through compiled C loops).
Per-op dispatch overhead is amortized over the 40k-point batch. On this
box's single vCPU the proxy is if anything FASTER than single-thread numba
scalar code would be; the recorded
baseline additionally multiplies by the CI benchmark box's 4 vCPUs
(``.github/workflows/benchmark_pipeline_times.yml``: PISA_TARGET=parallel,
4 threads) as a conservative upper bound on reference parallel scaling.

Numerical parity of the oscillation math with the framework's own kernels
is pinned by ``tests/test_reference_proxy.py`` (<=1e-9 fp64), which makes
the calibration defensible: same inputs, same probabilities, independently
implemented twice.

Run: ``python benchmarks/reference_proxy.py [--templates N] [--quick]``
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

TWO_SQRT2_GF = 1.52588e-4  # 2*sqrt(2)*G_F in (eV^2 cm^3)/(mole GeV)
HBAR_C_FACTOR = 2.534  # (1/2)/(hbar c) in GeV/(eV^2 km)


# ---------------------------------------------------------------------------
# oscillation probabilities: vectorized complex128 numpy
# ---------------------------------------------------------------------------
def pmns_numpy(theta12, theta13, theta23, deltacp):
    """Standard PDG 3-flavor mixing matrix (complex128), angles in rad
    (cf. reference ``pisa/stages/osc/osc_params.py:175``)."""
    s12, s13, s23 = np.sin([theta12, theta13, theta23])
    c12, c13, c23 = np.cos([theta12, theta13, theta23])
    ed = np.exp(1j * deltacp)
    edc = np.conj(ed)
    return np.array(
        [
            [c12 * c13, s12 * c13, s13 * edc],
            [
                -s12 * c23 - c12 * s23 * s13 * ed,
                c12 * c23 - s12 * s23 * s13 * ed,
                s23 * c13,
            ],
            [
                s12 * s23 - c12 * c23 * s13 * ed,
                -c12 * s23 - s12 * c23 * s13 * ed,
                c23 * c13,
            ],
        ],
        dtype=np.complex128,
    )


def osc_probs_numpy(dm21, dm31, U, nubar, energy, densities, distances):
    """P(nu_a -> nu_b) through layered matter, complex128 numpy.

    Same algorithm as the reference's ``osc_probs_layers_kernel``
    (Barger et al.; ``numba_osc_kernels.py:122``), vectorized over the
    point batch with a python loop over the (small) layer axis.

    Parameters
    ----------
    dm21, dm31 : float (eV^2)
    U : (3,3) complex128 PMNS
    nubar : +1 nu / -1 nubar
    energy : (N,) GeV
    densities : (N, L) electron column densities (mol/cm^3)
    distances : (N, L) layer path lengths (km); 0-length slots = identity

    Returns
    -------
    probs : (N, 3, 3)
    """
    energy = np.asarray(energy, dtype=np.float64)
    n_pts = energy.shape[0]
    n_layers = distances.shape[1]

    if nubar < 0:
        U = np.conj(U)

    H_vac = (U * np.array([0.0, dm21, dm31])) @ U.conj().T  # (3,3)

    eye = np.eye(3, dtype=np.complex128)
    product = np.broadcast_to(eye, (n_pts, 3, 3)).copy()

    one_over_2e = (0.5 / energy)[:, None, None]  # (N,1,1)
    two_e = 2.0 * energy

    for il in range(n_layers):
        rho = densities[:, il]
        baseline = distances[:, il]
        live = baseline > 0.0
        if not np.any(live):
            continue

        # flavor-basis Hamiltonian with the standard matter potential
        # diag(a, 0, 0); nubar flips the sign (conj of a real diagonal)
        a = 0.5 * rho * TWO_SQRT2_GF * (1.0 if nubar > 0 else -1.0)
        H_full = H_vac[None, :, :] * one_over_2e
        H_full = H_full.copy()
        H_full[:, 0, 0] += a

        # eigenvalues of the Hermitian Hamiltonian; the Barger amplitude is
        # permutation-symmetric so no vacuum-matched ordering is needed
        m = np.linalg.eigvalsh(H_full) * two_e[:, None]  # (N,3) "2E*lambda"

        H_mass_2e = (
            U.conj().T[None, :, :] @ H_full @ U[None, :, :]
        ) * two_e[:, None, None]

        # Barger et al. eq. 10: T = sum_k exp(-i m_k L/(2E) / hbar-c) P_k,
        # P_k = prod_{j != k} (2E H_mass - m_j) / (m_k - m_j)
        h = [
            H_mass_2e - m[:, k, None, None] * eye[None, :, :]
            for k in range(3)
        ]
        d01 = m[:, 0] - m[:, 1]
        d02 = m[:, 0] - m[:, 2]
        d12 = m[:, 1] - m[:, 2]
        prod0 = (h[1] @ h[2]) / (d01 * d02)[:, None, None]
        prod1 = (h[2] @ h[0]) / (d12 * -d01)[:, None, None]
        prod2 = (h[0] @ h[1]) / (d02 * d12)[:, None, None]

        s = -(baseline / energy) * HBAR_C_FACTOR
        p = np.exp(1j * m * s[:, None])  # (N,3)

        T = (
            p[:, 0, None, None] * prod0
            + p[:, 1, None, None] * prod1
            + p[:, 2, None, None] * prod2
        )
        T[~live] = eye  # padding slots act as identity

        product = T @ product  # each layer left-multiplies

    # mass -> flavor basis, then probabilities
    Tf = U[None, :, :] @ product @ U.conj().T[None, :, :]
    return np.abs(np.swapaxes(Tf, 1, 2)) ** 2  # probs[n, a, b]


# ---------------------------------------------------------------------------
# grid -> events lookup and histogramming (reference translation kernels)
# ---------------------------------------------------------------------------
def lookup_grid_to_events(grid_vals, edges_per_dim, event_coords):
    """'average'-mode lookup of grid-cell values at event coordinates
    (cf. reference ``pisa/core/translation.py:228``)."""
    idx = 0
    stride = 1
    shape = [len(e) - 1 for e in edges_per_dim]
    for d in range(len(edges_per_dim) - 1, -1, -1):
        k = np.clip(
            np.searchsorted(edges_per_dim[d], event_coords[d], side="right")
            - 1,
            0,
            shape[d] - 1,
        )
        idx = idx + k * stride
        stride *= shape[d]
    return grid_vals.reshape(-1)[idx]


def histogram_events(sample, weights, edges):
    """Weighted histogramdd + sumw2 (the reference's binning oracle,
    ``pisa/core/translation.py:90,779``)."""
    hist, _ = np.histogramdd(sample, bins=edges, weights=weights)
    sumw2, _ = np.histogramdd(sample, bins=edges, weights=weights**2)
    return hist, sumw2


# ---------------------------------------------------------------------------
# the flagship per-template workload
# ---------------------------------------------------------------------------
def build_flagship_workload(n_grid=200):
    """Assemble the IceCube-3y per-template inputs using the framework's
    setup machinery (setup cost is NOT timed — the reference also builds
    layers/grids once at setup)."""
    from pisa_tpu.core.binning import OneDimBinning, MultiDimBinning
    from pisa_tpu.ops.osc.layers import Layers
    from pisa_tpu.utils.resources import find_resource
    import pandas as pd

    # calc grid: true_allsky_fine (200 x 200)
    e_bins = OneDimBinning(
        "true_energy", num_bins=n_grid, is_log=True, domain=[1, 1000],
        units="GeV",
    )
    cz_bins = OneDimBinning(
        "true_coszen", num_bins=n_grid, is_lin=True, domain=[-1, 1],
    )
    grid = MultiDimBinning([e_bins, cz_bins])
    e_centers = np.asarray(e_bins.weighted_centers.m)
    cz_centers = np.asarray(cz_bins.weighted_centers.m)
    ee, cc = np.meshgrid(e_centers, cz_centers, indexing="ij")
    grid_e, grid_cz = ee.ravel(), cc.ravel()

    layers = Layers(
        find_resource("osc/PREM_12layer.dat"),
        detector_depth=2.0,
        prop_height=20.0,
    )
    layers.setElecFrac(0.4656, 0.4656, 0.4957)
    layers.calcLayers(grid_cz)
    densities = layers.density.reshape(grid_cz.size, -1)
    distances = layers.distance.reshape(grid_cz.size, -1)

    # events (240k, 12 flavint containers)
    df = pd.read_csv(
        find_resource(
            "events/IceCube_3y_oscillations/neutrino_mc.csv.bz2"
        )
    )
    containers = []
    for flav, pdg_base in (("e", 12), ("mu", 14), ("tau", 16)):
        for nubar in (1, -1):
            for current in ("cc", "nc"):
                mask = (df["pdg"] == nubar * pdg_base) & (
                    (df["type"] >= 1) if current == "cc" else (df["type"] == 0)
                )
                sub = df[mask]
                containers.append(
                    dict(
                        flav={"e": 0, "mu": 1, "tau": 2}[flav],
                        nubar=nubar,
                        true_energy=sub["true_energy"].to_numpy(),
                        true_coszen=sub["true_coszen"].to_numpy(),
                        reco_energy=sub["reco_energy"].to_numpy(),
                        reco_coszen=sub["reco_coszen"].to_numpy(),
                        pid=sub["pid"].to_numpy(),
                        weighted_aeff=sub["weight"].to_numpy() * 1e-4,
                    )
                )

    # output binning: dragon_datarelease (8E x 8cz x 2pid;
    # settings/binning/IceCube_3y_oscillations.cfg)
    out_edges = [
        np.array(
            [5.62341325, 7.49894209, 10.0, 13.33521432, 17.7827941,
             23.71373706, 31.6227766, 42.16965034, 56.23413252]
        ),
        np.linspace(-1.0, 1.0, 9),
        np.array([-0.5, 0.5, 1.5]),
    ]

    edges_per_dim = [
        np.asarray(e_bins.bin_edges.m),
        np.asarray(cz_bins.bin_edges.m),
    ]
    return dict(
        grid_e=grid_e,
        grid_cz=grid_cz,
        densities=densities,
        distances=distances,
        containers=containers,
        out_edges=out_edges,
        edges_per_dim=edges_per_dim,
        grid_shape=tuple(grid.shape),
    )


def run_template(wl, theta12, theta13, theta23, deltacp, dm21, dm31,
                 barr_params, aeff_scale, livetime_s):
    """ONE full template: flux mod + osc + lookup + weights + histogram —
    the per-minimizer-iteration work of the reference flagship pipeline."""
    U = pmns_numpy(theta12, theta13, theta23, deltacp)

    # oscillation probabilities on the calc grid, nu and nubar chains
    # (the reference links the 6 nu / 6 nubar containers to 2 calcs,
    # prob3.py:398-422)
    probs = {}
    for nubar in (1, -1):
        probs[nubar] = osc_probs_numpy(
            dm21, dm31, U, nubar, wl["grid_e"], wl["densities"],
            wl["distances"],
        )

    # simple Barr-style flux modification on the grid (stand-in for
    # barr_simple's per-point gufunc; same arithmetic intensity class)
    delta_index = barr_params.get("delta_index", 0.0)
    flux_e = np.power(wl["grid_e"] / 24.0900951261, -delta_index)
    flux_mu = flux_e * (1.0 + barr_params.get("nue_numu_ratio", 0.0) * 0.0)

    totals = None
    sample_cache = {}
    for c in wl["containers"]:
        pe = lookup_grid_to_events(
            probs[c["nubar"]][:, 0, c["flav"]],
            wl["edges_per_dim"],
            [c["true_energy"], c["true_coszen"]],
        )
        pm = lookup_grid_to_events(
            probs[c["nubar"]][:, 1, c["flav"]],
            wl["edges_per_dim"],
            [c["true_energy"], c["true_coszen"]],
        )
        fe = lookup_grid_to_events(
            flux_e, wl["edges_per_dim"],
            [c["true_energy"], c["true_coszen"]],
        )
        fm = lookup_grid_to_events(
            flux_mu, wl["edges_per_dim"],
            [c["true_energy"], c["true_coszen"]],
        )
        w = c["weighted_aeff"] * livetime_s * aeff_scale * (
            fe * pe + fm * pm
        )
        key = id(c)
        if key not in sample_cache:
            sample_cache[key] = np.stack(
                [c["reco_energy"], c["reco_coszen"], c["pid"]], axis=1
            )
        hist, sumw2 = histogram_events(
            sample_cache[key], w, wl["out_edges"]
        )
        totals = hist if totals is None else totals + hist
    return totals


# ---------------------------------------------------------------------------
# KDE-pipeline workload (BASELINE workload 3)
# ---------------------------------------------------------------------------
# Reference algorithm: the KDE stage (``pisa/stages/utils/kde.py``) maps each
# container's events through ``kde_histogramdd``
# (``pisa/utils/kde_hist.py:220``): per PID channel (stack_pid=True), an
# adaptive-bandwidth gaussian-product KDE over (log10 E, coszen) with coszen
# boundary reflection (fraction 0.25), evaluated on the oversample=3 bin-center
# grid and reduced back down. The KDE itself is the external `kde` package's
# two-pass scheme: silverman pilot bandwidths -> pilot density at the sample
# points (N x N gaussian matrix) -> local bandwidths
# lambda_i = (pilot_i / geomean)^-alpha (alpha=0.3) -> weighted mixture
# evaluated at the M grid points (N x M). The proxy below is that exact flop
# stream in vectorized float64 numpy.


def _silverman_bw(x, w):
    n_eff = np.sum(w) ** 2 / np.sum(w**2)
    mu = np.average(x, weights=w)
    sig = np.sqrt(np.average((x - mu) ** 2, weights=w))
    return sig * (4.0 / (3.0 * n_eff)) ** 0.2


def kde_channel_numpy(coords, weights, eval_pts, alpha=0.3):
    """One adaptive gaussian-product KDE channel: pilot pass + adaptive
    local bandwidths + mixture evaluation (cf. external kde package as
    driven by ``pisa/utils/kde_hist.py:89-140``).

    coords : (N, D) sample; eval_pts : (M, D); returns (M,) density.
    """
    n, d = coords.shape
    w = weights / np.sum(weights)
    bw = np.array([_silverman_bw(coords[:, j], w) for j in range(d)])
    bw = np.maximum(bw, 1e-12)

    # pilot density at the sample points (N x N)
    z2 = np.zeros((n, n))
    for j in range(d):
        dz = (coords[:, j][:, None] - coords[:, j][None, :]) / bw[j]
        z2 += dz * dz
    kern = np.exp(-0.5 * z2)
    pilot = (kern * w[None, :]).sum(axis=1) / np.prod(bw)
    pilot = np.maximum(pilot, 1e-300)

    # local bandwidth factors
    g = np.exp(np.average(np.log(pilot), weights=w))
    lam = (pilot / g) ** (-alpha)

    # mixture at the evaluation points (N x M)
    m = eval_pts.shape[0]
    z2 = np.zeros((n, m))
    for j in range(d):
        dz = (coords[:, j][:, None] - eval_pts[:, j][None, :]) / (
            bw[j] * lam[:, None]
        )
        z2 += dz * dz
    norm = w / (np.prod(bw) * lam**d * (2.0 * np.pi) ** (d / 2.0))
    return (np.exp(-0.5 * z2) * norm[:, None]).sum(axis=0)


def build_kde_workload(n_grid=200, n_per_container=100, seed=7):
    """The kde_example pipeline's shapes: 12 flavint containers x 100
    events (toy vlvnt set), 200x200 osc calc grid, 10E x 10cz x 2pid
    output binning with oversample 3 (-> 30x30 eval grid per pid)."""
    wl = build_flagship_workload(n_grid=n_grid)
    rng = np.random.default_rng(seed)
    containers = []
    for flav in (0, 1, 2):
        for nubar in (1, -1):
            for _current in ("cc", "nc"):
                e = 10.0 ** (rng.uniform(0.0, 1.9, n_per_container))
                cz = rng.uniform(-1, 1, n_per_container)
                containers.append(
                    dict(
                        flav=flav, nubar=nubar,
                        true_energy=e, true_coszen=cz,
                        reco_energy=e * rng.lognormal(0, 0.2, e.size),
                        reco_coszen=np.clip(
                            cz + rng.normal(0, 0.1, e.size), -1, 1
                        ),
                        pid=rng.choice([0.0, 1.0], e.size),
                        weighted_aeff=rng.uniform(
                            0.5, 1.5, e.size
                        ) * 1e-4,
                    )
                )
    wl["containers"] = containers
    # oversampled eval grid: 30 log-E x 30 cz bin centers
    e_edges = np.logspace(np.log10(5.0), 2.0, 31)
    e_centers = np.sqrt(e_edges[:-1] * e_edges[1:])
    cz_centers = np.linspace(-1, 1, 61)[1::2]
    ee, cc = np.meshgrid(np.log10(e_centers), cz_centers, indexing="ij")
    wl["kde_eval_pts"] = np.stack([ee.ravel(), cc.ravel()], axis=1)
    return wl


def run_kde_template(wl, theta23, dm31):
    """ONE KDE-pipeline template: osc on the calc grid + per-event flux x
    osc weights + adaptive-KDE mapping per container per PID channel."""
    U = pmns_numpy(np.deg2rad(33.4), np.deg2rad(8.5), theta23, 0.0)
    probs = {}
    for nubar in (1, -1):
        probs[nubar] = osc_probs_numpy(
            7.4e-5, dm31, U, nubar, wl["grid_e"], wl["densities"],
            wl["distances"],
        )

    totals = np.zeros(wl["kde_eval_pts"].shape[0])
    for c in wl["containers"]:
        pe = lookup_grid_to_events(
            probs[c["nubar"]][:, 0, c["flav"]], wl["edges_per_dim"],
            [c["true_energy"], c["true_coszen"]],
        )
        pm = lookup_grid_to_events(
            probs[c["nubar"]][:, 1, c["flav"]], wl["edges_per_dim"],
            [c["true_energy"], c["true_coszen"]],
        )
        w = c["weighted_aeff"] * (0.1 * pe + pm)

        # coszen boundary reflection (kde_hist.py:150-190, fraction 0.25)
        log_e = np.log10(c["reco_energy"])
        cz = c["reco_coszen"]
        for pid_val in (0.0, 1.0):
            sel = c["pid"] == pid_val
            le, zz, ww = log_e[sel], cz[sel], w[sel]
            lo = zz < -1.0 + 0.5
            hi = zz > 1.0 - 0.5
            le_r = np.concatenate([le, le[lo], le[hi]])
            zz_r = np.concatenate([zz, -2.0 - zz[lo], 2.0 - zz[hi]])
            ww_r = np.concatenate([ww, ww[lo], ww[hi]])
            if ww_r.sum() <= 0 or le_r.size < 3:
                continue
            coords = np.stack([le_r, zz_r], axis=1)
            totals += kde_channel_numpy(
                coords, ww_r, wl["kde_eval_pts"]
            ) * ww_r.sum()
    return totals


# ---------------------------------------------------------------------------
# hypersurface-fit workload (BASELINE workload 4)
# ---------------------------------------------------------------------------
#: the bench hypersurface ensemble: 3 systematic params (linear forms),
#: nominal + 12 variation datasets, over the toy_flux pipeline's
#: 24x24-bin x 3-map output — production-scale bin count (1728 bin fits)
#: with dataset generation as SETUP (untimed, per the reference's own
#: benchmark convention of excluding one-time JIT/setup,
#: benchmark_pipeline_performance.py:196) and the fit itself timed.
HS_NOMINAL = {"delta_index": 0.0, "theta23": 0.85, "aeff_scale": 1.0}
HS_SYS_POINTS = [
    {"delta_index": -0.10, "theta23": 0.85, "aeff_scale": 1.0},
    {"delta_index": +0.10, "theta23": 0.85, "aeff_scale": 1.0},
    {"delta_index": 0.0, "theta23": 0.70, "aeff_scale": 1.0},
    {"delta_index": 0.0, "theta23": 0.95, "aeff_scale": 1.0},
    {"delta_index": 0.0, "theta23": 0.85, "aeff_scale": 0.8},
    {"delta_index": 0.0, "theta23": 0.85, "aeff_scale": 1.2},
    {"delta_index": -0.05, "theta23": 0.75, "aeff_scale": 0.9},
    {"delta_index": +0.05, "theta23": 0.90, "aeff_scale": 1.1},
    {"delta_index": -0.08, "theta23": 0.95, "aeff_scale": 1.15},
    {"delta_index": +0.08, "theta23": 0.72, "aeff_scale": 0.85},
    {"delta_index": +0.03, "theta23": 0.80, "aeff_scale": 0.95},
    {"delta_index": -0.03, "theta23": 0.92, "aeff_scale": 1.05},
]


def _toy_flux_maps(delta_index, theta23, aeff_scale, grid_e, grid_cz):
    """Per-container toy_flux_fit.cfg maps (see _toy_flux_template)."""
    l1, r = 19.0, 6378.2 + 19.0
    phi = np.arcsin((1 - l1 / r) * np.sin(np.arccos(grid_cz)))
    psi = np.arccos(grid_cz) - phi
    dist = np.sqrt(
        (r - l1) ** 2 + r**2 - 2 * (r - l1) * r * np.cos(psi)
    )
    p_trans = theta23 * np.sin(1.267 * 2.5e-3 * dist / grid_e) ** 2
    idx_scale = np.power(grid_e / 24.0900951261, -delta_index)
    return {
        "nue_cc": np.zeros_like(grid_e),
        "numu_cc": idx_scale * (1.0 - p_trans) * aeff_scale,
        "nutau_cc": idx_scale * p_trans * aeff_scale * 0.5,
    }


def run_hypersurface_proxy():
    """Reference hypersurface fit (``pisa/utils/hypersurface/
    hypersurface.py:477``): per-bin ``scipy.optimize.curve_fit`` of the
    3-param linear hypersurface over the 13 dataset points, looped over
    all 24x24 bins x 3 maps in Python exactly as the reference does.
    Dataset generation is SETUP (untimed); returns the fit wall-clock."""
    from scipy.optimize import curve_fit

    e_bins = np.logspace(0, 3, 25)
    e_centers = np.sqrt(e_bins[:-1] * e_bins[1:])
    cz_centers = np.linspace(-1, 1, 49)[1::2]
    ee, cc = np.meshgrid(e_centers, cz_centers, indexing="ij")
    grid_e, grid_cz = ee.ravel(), cc.ravel()

    points = [HS_NOMINAL] + HS_SYS_POINTS
    datasets = [
        _toy_flux_maps(
            pv["delta_index"], pv["theta23"], pv["aeff_scale"],
            grid_e, grid_cz,
        )
        for pv in points
    ]
    x = np.array(
        [[pv["delta_index"], pv["theta23"], pv["aeff_scale"]]
         for pv in points]
    )

    def linear_form(xpts, intercept, s0, s1, s2):
        return (
            intercept
            + s0 * (xpts[:, 0] - HS_NOMINAL["delta_index"])
            + s1 * (xpts[:, 1] - HS_NOMINAL["theta23"])
            + s2 * (xpts[:, 2] - HS_NOMINAL["aeff_scale"])
        )

    t0 = time.time()
    n_fits = 0
    for name in ("nue_cc", "numu_cc", "nutau_cc"):
        nom = datasets[0][name]
        ys = np.stack([ds[name] for ds in datasets], axis=1)  # (B, 13)
        for b in range(ys.shape[0]):
            if nom[b] <= 0:  # norm=True skips empty nominal bins
                continue
            y = ys[b] / nom[b]
            try:
                curve_fit(
                    linear_form, x, y, p0=[1.0, 0.0, 0.0, 0.0],
                    maxfev=10000,
                )
                n_fits += 1
            except RuntimeError:
                pass
    dt = time.time() - t0
    return dt, n_fits


# ---------------------------------------------------------------------------
# Asimov-fit workload (BASELINE workload 5)
# ---------------------------------------------------------------------------
def _toy_flux_template(delta_index, theta23, aeff_scale, grid_e, grid_cz):
    """The toy_flux_fit.cfg per-template math in numpy: Barr spectral
    tilt -> two-flavor vacuum osc (production-height path length,
    two_nu_osc.py:24-36) -> aeff scaling; events == grid cells (24x24),
    3 containers (nue_cc/numu_cc/nutau_cc, nutau_cc_norm=0.5)."""
    l1, r = 19.0, 6378.2 + 19.0
    phi = np.arcsin((1 - l1 / r) * np.sin(np.arccos(grid_cz)))
    psi = np.arccos(grid_cz) - phi
    dist = np.sqrt(
        (r - l1) ** 2 + r**2 - 2 * (r - l1) * r * np.cos(psi)
    )
    p_trans = theta23 * np.sin(1.267 * 2.5e-3 * dist / grid_e) ** 2

    idx_scale = np.power(grid_e / 24.0900951261, -delta_index)
    flux_mu = idx_scale  # nominal [0, 1] flux pair; nue flux = 0
    w_nue = np.zeros_like(grid_e)
    w_numu = flux_mu * (1.0 - p_trans) * aeff_scale
    w_nutau = flux_mu * p_trans * aeff_scale * 0.5
    return w_nue + w_numu + w_nutau


def run_asimov_proxy():
    """Reference Asimov fit: bounded L-BFGS-B with FINITE-DIFFERENCE
    gradients (the reference has no autodiff; scipy numerically
    differentiates, 1+n_params evaluations per gradient;
    cf. reference ``analysis.py:1561`` _fit_scipy + benchmark fit) over
    the 3 free params of the toy flux pipeline. Returns the full fit
    wall-clock and evaluation count."""
    from scipy.optimize import minimize

    e_bins = np.logspace(0, 3, 25)
    e_centers = np.sqrt(e_bins[:-1] * e_bins[1:])
    cz_centers = np.linspace(-1, 1, 49)[1::2]
    ee, cc = np.meshgrid(e_centers, cz_centers, indexing="ij")
    grid_e, grid_cz = ee.ravel(), cc.ravel()

    truth = (0.0, 0.85, 1.2)
    data = _toy_flux_template(*truth, grid_e, grid_cz)

    nev = [0]

    def objective(x):
        nev[0] += 1
        exp = _toy_flux_template(x[0], x[1], x[2], grid_e, grid_cz)
        exp = np.maximum(exp, 1e-10)
        return float(np.sum((exp - data) ** 2 / exp))

    t0 = time.time()
    res = minimize(
        objective, x0=np.array([-0.05, 0.95, 0.8]), method="L-BFGS-B",
        bounds=[(-0.5, 0.5), (0.0, 1.0), (0.0, 3.0)],
        options={"ftol": 1e-12, "gtol": 1e-8},
    )
    dt = time.time() - t0
    return dt, nev[0], res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--templates", type=int, default=10)
    ap.add_argument(
        "--workload", default="flagship",
        choices=["flagship", "kde", "hypersurface", "asimov"],
    )
    ap.add_argument(
        "--quick", action="store_true",
        help="1/10 grid + 1/10 events (CI smoke)",
    )
    args = ap.parse_args(argv)

    import json

    if args.workload == "kde":
        print("# building kde workload (setup, not timed)", file=sys.stderr)
        wl = build_kde_workload(n_grid=20 if args.quick else 200)
        rng = np.random.default_rng(0)
        times = []
        for i in range(args.templates + 1):
            th23 = np.deg2rad(45.0 + rng.uniform(-5, 5))
            dm31 = 2.5e-3 + rng.uniform(-2e-4, 2e-4)
            t0 = time.time()
            totals = run_kde_template(wl, th23, dm31)
            dt = time.time() - t0
            if i > 0:
                times.append(dt)
            print(
                f"# kde template {i}: {dt:.3f}s"
                f" (sum {float(np.sum(totals)):.3e})",
                file=sys.stderr,
            )
        mean = float(np.mean(times))
        print(json.dumps({
            "metric": "reference_proxy_kde_templates_per_sec",
            "value": round(1.0 / mean, 4), "unit": "templates/s",
            "mean_s": round(mean, 4), "n": len(times),
            "quick": bool(args.quick),
        }))
        return

    if args.workload == "hypersurface":
        dt, n_fits = run_hypersurface_proxy()
        print(json.dumps({
            "metric": "reference_proxy_hypersurface_fit_wall_s",
            "value": round(dt, 3), "unit": "s", "n_bin_fits": n_fits,
        }))
        return

    if args.workload == "asimov":
        # warm numpy caches, then time
        run_asimov_proxy()
        dt, nev, res = run_asimov_proxy()
        print(
            f"# asimov proxy: {nev} evals,"
            f" x={np.round(res.x, 4).tolist()}", file=sys.stderr,
        )
        print(json.dumps({
            "metric": "reference_proxy_asimov_fit_wall_s",
            "value": round(dt, 4), "unit": "s", "n_evals": nev,
        }))
        return

    print("# building flagship workload (setup, not timed)", file=sys.stderr)
    wl = build_flagship_workload(n_grid=20 if args.quick else 200)
    if args.quick:
        sel = slice(None, None, 10)
        for c in wl["containers"]:
            for k, v in c.items():
                if isinstance(v, np.ndarray):
                    c[k] = v[sel]

    rng = np.random.default_rng(0)
    t_first = None
    times = []
    for i in range(args.templates + 1):
        th23 = np.deg2rad(45.0 + rng.uniform(-5, 5))
        dm31 = 2.5e-3 + rng.uniform(-2e-4, 2e-4)
        t0 = time.time()
        totals = run_template(
            wl,
            theta12=np.deg2rad(33.4),
            theta13=np.deg2rad(8.5),
            theta23=th23,
            deltacp=0.0,
            dm21=7.4e-5,
            dm31=dm31,
            barr_params={"delta_index": rng.uniform(-0.1, 0.1)},
            aeff_scale=1.0,
            livetime_s=2.5 * 365.25 * 86400.0,
        )
        dt = time.time() - t0
        if i == 0:
            t_first = dt
        else:
            times.append(dt)
        print(
            f"# template {i}: {dt:.3f}s (sum {float(np.sum(totals)):.1f})",
            file=sys.stderr,
        )
    mean = float(np.mean(times))
    print(
        f"# first {t_first:.3f}s; mean of {len(times)}: {mean:.3f}s",
        file=sys.stderr,
    )
    import json

    print(
        json.dumps(
            {
                "metric": "reference_proxy_templates_per_sec",
                "value": round(1.0 / mean, 4),
                "unit": "templates/s",
                "mean_s": round(mean, 4),
                "n": len(times),
                "quick": bool(args.quick),
            }
        )
    )


if __name__ == "__main__":
    main()
