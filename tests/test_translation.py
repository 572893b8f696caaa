"""Translation kernel tests: correctness is defined as matching
numpy.histogramdd (cf. reference ``translation.py:779-821``), including
inf edges, NaN samples, and values exactly on edges."""

import numpy as np
import pytest

from pisa_tpu import FTYPE, ureg

# fp32 scatter-add accumulates in fp32; numpy histogramdd sums in fp64
HIST_RTOL = 1e-10 if FTYPE == np.float64 else 3e-5
from pisa_tpu.core.binning import MultiDimBinning, OneDimBinning
from pisa_tpu.core import translation as tr


def np_histdd(sample, weights, binning):
    edges = [d.edge_magnitudes for d in binning.dims]
    h, _ = np.histogramdd(np.stack(sample, axis=1), bins=edges, weights=weights)
    return h.ravel()


@pytest.fixture
def binning():
    e = OneDimBinning("energy", domain=[1, 80] * ureg.GeV, num_bins=10, is_log=True)
    cz = OneDimBinning("coszen", domain=[-1, 1], num_bins=7, is_lin=True)
    return e * cz


class TestFindIndex:
    """Mirror reference test_find_index edge cases."""

    def check(self, edges, val, expected):
        got = int(np.asarray(tr.find_index(np.array([val]), np.asarray(edges)))[0])
        assert got == expected, f"edges={edges} val={val}: got {got}, want {expected}"

    def test_basic(self):
        edges = [0.0, 1.0, 2.0, 3.0]
        self.check(edges, -0.5, -1)  # underflow
        self.check(edges, 0.0, 0)
        self.check(edges, 0.5, 0)
        self.check(edges, 1.0, 1)  # left-closed
        self.check(edges, 2.999, 2)
        self.check(edges, 3.0, 2)  # last bin closed
        self.check(edges, 3.5, 3)  # overflow

    def test_inf_edges(self):
        edges = [-np.inf, 0.55, np.inf]
        self.check(edges, -1e300, 0)
        self.check(edges, 0.54, 0)
        self.check(edges, 0.55, 1)
        self.check(edges, 1e300, 1)
        self.check(edges, np.inf, 1)  # last bin closed at +inf
        self.check(edges, -np.inf, 0)

    def test_nan(self):
        self.check([0.0, 1.0, 2.0], np.nan, 2)  # overflow -> dropped

    def test_ulp_near_edges(self):
        edges = np.array([0.0, 1.0, 2.0])
        # ulps of the ACTIVE precision: an fp64 1-ulp offset rounds back
        # onto the edge when the kernel runs in fp32
        below = np.nextafter(FTYPE(1.0), FTYPE(0.0))
        above = np.nextafter(FTYPE(1.0), FTYPE(2.0))
        self.check(edges, below, 0)
        self.check(edges, above, 1)


class TestHistogram:
    def test_matches_numpy_histogramdd(self, binning):
        rng = np.random.RandomState(0)
        n = 10000
        sample = [
            rng.uniform(0.5, 100, n),  # includes under+overflow
            rng.uniform(-1.2, 1.2, n),
        ]
        w = rng.uniform(0, 2, n)
        ours = np.asarray(tr.histogram(sample, w, binning))
        np.testing.assert_allclose(ours, np_histdd(sample, w, binning), rtol=HIST_RTOL)

    def test_unweighted(self, binning):
        rng = np.random.RandomState(1)
        sample = [rng.uniform(1, 80, 1000), rng.uniform(-1, 1, 1000)]
        ours = np.asarray(tr.histogram(sample, None, binning))
        np.testing.assert_allclose(ours, np_histdd(sample, None, binning))
        assert ours.sum() <= 1000

    def test_multichannel(self, binning):
        rng = np.random.RandomState(2)
        n = 500
        sample = [rng.uniform(1, 80, n), rng.uniform(-1, 1, n)]
        w = rng.uniform(0, 1, (n, 2))
        ours = np.asarray(tr.histogram(sample, w, binning))
        assert ours.shape == (binning.size, 2)
        for ch in range(2):
            np.testing.assert_allclose(
                ours[:, ch], np_histdd(sample, w[:, ch], binning), rtol=HIST_RTOL
            )

    def test_averaged(self, binning):
        rng = np.random.RandomState(3)
        n = 2000
        sample = [rng.uniform(1, 80, n), rng.uniform(-1, 1, n)]
        vals = rng.uniform(0, 1, n)
        avg = np.asarray(tr.histogram(sample, vals, binning, averaged=True))
        sums = np_histdd(sample, vals, binning)
        counts = np_histdd(sample, None, binning)
        with np.errstate(invalid="ignore"):
            expect = np.nan_to_num(sums / counts)
        np.testing.assert_allclose(avg, expect, rtol=HIST_RTOL)

    def test_values_on_edges(self, binning):
        # events exactly on interior and outer edges
        e_edges = binning["energy"].edge_magnitudes
        cz_edges = binning["coszen"].edge_magnitudes
        sample = [
            np.array([e_edges[0], e_edges[3], e_edges[-1], e_edges[-1]]),
            np.array([cz_edges[0], cz_edges[2], cz_edges[-1], cz_edges[0]]),
        ]
        w = np.ones(4)
        ours = np.asarray(tr.histogram(sample, w, binning))
        np.testing.assert_allclose(ours, np_histdd(sample, w, binning))

    def test_nan_dropped(self, binning):
        sample = [np.array([10.0, np.nan]), np.array([0.0, 0.0])]
        ours = np.asarray(tr.histogram(sample, np.ones(2), binning))
        assert ours.sum() == 1.0

    def test_jit(self, binning):
        import jax

        spec = tr.binning_to_spec(binning)
        f = jax.jit(lambda s, w: tr.histogram(s, w, spec))
        rng = np.random.RandomState(4)
        sample = [rng.uniform(1, 80, 100), rng.uniform(-1, 1, 100)]
        w = np.ones(100)
        np.testing.assert_allclose(
            np.asarray(f(sample, w)), np_histdd(sample, w, binning), rtol=1e-6
        )


class TestLookupIndices:
    """Mirror reference test_lookup_indices (bin_indexing.py:169)."""

    def test_flat_index(self, binning):
        rng = np.random.RandomState(5)
        n = 300
        sample = [rng.uniform(1, 80, n), rng.uniform(-1, 1, n)]
        idx = np.asarray(tr.lookup_indices_flat(sample, binning))
        assert idx.min() >= 0 and idx.max() < binning.size
        # verify against explicit digitize
        e = np.clip(
            np.digitize(sample[0], binning["energy"].edge_magnitudes) - 1, 0, 9
        )
        c = np.clip(
            np.digitize(sample[1], binning["coszen"].edge_magnitudes) - 1, 0, 6
        )
        np.testing.assert_array_equal(idx, e * 7 + c)

    def test_out_of_range(self, binning):
        sample = [np.array([0.5, 100.0, 10.0]), np.array([0.0, 0.0, -2.0])]
        idx = np.asarray(tr.lookup_indices_flat(sample, binning))
        assert idx[0] == -1  # underflow
        assert idx[1] == binning.size  # overflow
        assert idx[2] == -1  # cz underflow


class TestLookup:
    def test_roundtrip(self, binning):
        """histogram then lookup at the same points returns each event's bin
        value."""
        rng = np.random.RandomState(6)
        n = 1000
        sample = [rng.uniform(1, 80, n), rng.uniform(-1, 1, n)]
        w = rng.uniform(0, 1, n)
        hist = tr.histogram(sample, w, binning)
        vals = np.asarray(tr.lookup(sample, hist, binning))
        # check a few events explicitly
        flat_idx = np.asarray(tr.lookup_indices_flat(sample, binning))
        np.testing.assert_allclose(vals, np.asarray(hist)[flat_idx], rtol=HIST_RTOL)

    def test_out_of_range_zero(self, binning):
        hist = np.ones(binning.size)
        vals = np.asarray(
            tr.lookup([np.array([0.1]), np.array([0.0])], hist, binning)
        )
        assert vals[0] == 0.0

    def test_multichannel(self, binning):
        hist = np.arange(binning.size * 2, dtype=float).reshape(binning.size, 2)
        sample = [np.array([10.0]), np.array([0.1])]
        vals = np.asarray(tr.lookup(sample, hist, binning))
        assert vals.shape == (1, 2)


class TestResample:
    def test_downsample_conserves(self, binning):
        """Resampling binned data to a coarser binning of the same domain
        averages correctly."""
        fine = binning
        coarse = binning.downsample(2, 7)
        # binned data: value 1.0 everywhere; resample to coarse -> 1.0
        old_sample = [
            g.ravel() for g in fine.meshgrid(entity="weighted_centers", attach_units=False)
        ]
        new_sample = [
            g.ravel()
            for g in coarse.meshgrid(entity="weighted_centers", attach_units=False)
        ]
        weights = np.ones(fine.size)
        out = np.asarray(tr.resample(weights, old_sample, fine, new_sample, coarse))
        np.testing.assert_allclose(out, 1.0)


class TestHistogramMatmul:
    """The one-hot matmul histogram must match the scatter-add path
    (and therefore numpy.histogramdd) bit-for-bit up to accumulation
    order."""

    def test_matches_scatter(self, binning):
        rng = np.random.RandomState(7)
        n = 5000
        sample = [
            rng.uniform(0.5, 90.0, n),   # includes out-of-range events
            rng.uniform(-1.2, 1.2, n),
        ]
        w = rng.rand(n).astype(FTYPE)
        idx = tr.sanitized_flat_indices(sample, binning)
        import jax
        matrix = jax.nn.one_hot(idx, binning.size, dtype=FTYPE)
        got = np.asarray(tr.histogram_matmul(w, matrix))
        want = np.asarray(tr.histogram(sample, w, binning))
        np.testing.assert_allclose(got, want, rtol=HIST_RTOL)
        # out-of-range events (idx == size -> all-zero row) are dropped
        np.testing.assert_allclose(got, np_histdd(sample, w, binning), rtol=HIST_RTOL)

    def test_multichannel(self, binning):
        rng = np.random.RandomState(8)
        n = 3000
        sample = [rng.uniform(1.0, 80.0, n), rng.uniform(-1.0, 1.0, n)]
        w = rng.rand(n, 3).astype(FTYPE)
        idx = tr.sanitized_flat_indices(sample, binning)
        import jax
        matrix = jax.nn.one_hot(idx, binning.size, dtype=FTYPE)
        got = np.asarray(tr.histogram_matmul(w, matrix))
        want = np.asarray(tr.histogram(sample, w, binning))
        assert got.shape == (binning.size, 3)
        np.testing.assert_allclose(got, want, rtol=HIST_RTOL)

    def test_container_cached_matrix_rides_template(self):
        """Flagship-shaped check: a pipeline with a hist stage produces
        identical output with the matmul path enabled vs disabled."""
        import os
        from pisa_tpu.core.pipeline import Pipeline

        p = Pipeline("settings/pipeline/toy_flux_fit.cfg")
        out_mat = p.get_outputs()
        os.environ["PISA_TPU_HIST_MATMUL_MAX_BINS"] = "0"
        try:
            p2 = Pipeline("settings/pipeline/toy_flux_fit.cfg")
            out_sca = p2.get_outputs()
        finally:
            del os.environ["PISA_TPU_HIST_MATMUL_MAX_BINS"]
        for m in out_mat:
            np.testing.assert_allclose(
                np.asarray(out_mat[m.name].hist),
                np.asarray(out_sca[m.name].hist),
                rtol=HIST_RTOL * 10,
                err_msg=m.name,
            )
