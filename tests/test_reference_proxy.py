"""
Parity of the baseline-calibration proxy (``benchmarks/reference_proxy.py``)
with the framework's own oscillation kernels: same algorithm (Barger et al.,
cf. reference ``numba_osc_kernels.py:122``), independently implemented twice
— complex128 numpy vs split-complex JAX. Agreement at fp64 makes the proxy a
defensible stand-in for reference-PISA throughput measurements.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "benchmarks"))

from reference_proxy import (  # noqa: E402
    lookup_grid_to_events,
    osc_probs_numpy,
    pmns_numpy,
)

from pisa_tpu import FTYPE  # noqa: E402
from pisa_tpu.ops.osc.kernels import osc_probs_layers  # noqa: E402
from pisa_tpu.ops.osc.pmns import dm_matrix, pmns_matrix_complex  # noqa: E402


@pytest.mark.parametrize("nubar", [1, -1])
def test_osc_probs_parity(nubar):
    rng = np.random.default_rng(7)
    n, L = 64, 5
    energy = rng.uniform(1.0, 100.0, n)
    densities = rng.uniform(1.0, 6.0, (n, L))
    distances = rng.uniform(50.0, 2000.0, (n, L))
    # zero-pad some slots (identity transitions)
    distances[:, -1] = 0.0
    distances[::3, -2] = 0.0

    th12, th13, th23, dcp = 0.5839, 0.1496, 0.7854, 1.2
    dm21, dm31 = 7.42e-5, 2.514e-3

    probs_np = osc_probs_numpy(
        dm21, dm31, pmns_numpy(th12, th13, th23, dcp), nubar, energy,
        densities, distances,
    )

    U = pmns_matrix_complex(np.sin(th12), np.sin(th13), np.sin(th23), dcp)
    mat_pot = np.diag([1.0, 0.0, 0.0]).astype(complex)
    probs_jax = np.asarray(
        osc_probs_layers(
            dm_matrix(dm21, dm31),
            U,
            mat_pot,
            np.zeros((3, 3), complex),
            np.zeros((3, 3)),
            nubar,
            energy,
            densities,
            distances,
        )
    )

    assert probs_np.shape == probs_jax.shape == (n, 3, 3)
    # the 1e-9 calibration contract is an fp64 statement (the proxy is
    # complex128 numpy); at fp32 the kernels themselves carry ~1e-3
    # relative probability error (same scale as the reference's fp32 leg)
    if FTYPE == np.float64:
        tol = dict(atol=1e-9, rtol=1e-9)
    else:
        tol = dict(atol=1e-5, rtol=5e-3)
    np.testing.assert_allclose(probs_np, probs_jax, **tol)
    # unitarity of the proxy itself (always fp64 numpy)
    np.testing.assert_allclose(probs_np.sum(axis=2), 1.0, atol=1e-9)


def test_lookup_matches_translation():
    """The proxy's grid->events gather against the framework's lookup."""
    rng = np.random.default_rng(3)
    edges = [np.linspace(0.0, 1.0, 11), np.linspace(-1.0, 1.0, 6)]
    grid_vals = rng.normal(size=(10, 5))
    ev = [rng.uniform(0.01, 0.99, 200), rng.uniform(-0.99, 0.99, 200)]

    got = lookup_grid_to_events(grid_vals, edges, ev)

    ix = np.clip(np.searchsorted(edges[0], ev[0], "right") - 1, 0, 9)
    iy = np.clip(np.searchsorted(edges[1], ev[1], "right") - 1, 0, 4)
    np.testing.assert_array_equal(got, grid_vals[ix, iy])
