"""
Multi-source Barlow-Beeston likelihood solver
(cf. reference ``pisa/utils/barlow.py:64`` ``Likelihoods``; Barlow &
Beeston, Comput. Phys. Commun. 77 (1993) 219,
doi:10.1016/0010-4655(93)90005-W).

API-compatible with the reference class (``set_data`` / ``set_mc`` /
``set_unweighted`` / ``get_llh('barlow'|'poisson')`` / ``get_plot`` /
``get_single_plots``), but compiled in its solution method: instead of an
independent scipy Powell minimization per bin (the reference loops bins on
the host), the per-bin profile over the latent per-source MC counts A_j is
reduced to the Barlow-Beeston scalar equation and solved for EVERY bin at
once by a vectorized safeguarded-Newton iteration
(:func:`pisa_tpu.utils.stats.barlow_solve_t`) — one fixed-shape device
program, jit/grad-able and usable inside compiled objectives.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from pisa_tpu.utils.stats import SMALL_POS, barlow_solve_t

__all__ = ["Likelihoods"]


class Likelihoods:
    """Poisson and Barlow-Beeston likelihoods over N MC sources.

    Usage (same protocol as the reference):

    >>> llh = Likelihoods()
    >>> llh.set_data(data_hist)               # (..., bins)
    >>> llh.set_mc(weight_per_event_hists)    # (n_sources, ..., bins)
    >>> llh.set_unweighted(unweighted_hists)  # (n_sources, ..., bins)
    >>> value = llh.get_llh('barlow')         # scalar, to MINIMIZE
    """

    def __init__(self):
        self.mc_histograms = None
        self.unweighted_histograms = None
        self.data_histogram = None
        self.shape = None
        self.bestfit_plots = None

    def reset(self):
        """Re-initialize for reuse."""
        self.__init__()

    # ----------------------------------------------------------- inputs
    def _check_shape(self, hist, what):
        if self.shape is None:
            self.shape = hist.shape
        if hist.shape != self.shape:
            raise ValueError(
                f"{what} has shape {hist.shape}, expected {self.shape}"
            )

    def set_data(self, data_histogram):
        """Observed counts; flattened internally."""
        data_histogram = np.asarray(data_histogram)
        self._check_shape(data_histogram, "data histogram")
        self.data_histogram = data_histogram.reshape(-1)

    def set_mc(self, mc_histograms):
        """Per-source histograms of the weight-PER-EVENT in each bin (not
        the total weight; same convention as the reference)."""
        mc_histograms = np.asarray(mc_histograms)
        if np.any(np.isnan(mc_histograms)):
            raise ValueError("NaN in MC histogram")
        flat = []
        for j in range(mc_histograms.shape[0]):
            self._check_shape(mc_histograms[j], f"MC histogram {j}")
            flat.append(mc_histograms[j].reshape(-1))
        self.mc_histograms = np.asarray(flat)

    def set_unweighted(self, unweighted_histograms):
        """Per-source unweighted (raw MC count) histograms."""
        unweighted_histograms = np.asarray(unweighted_histograms)
        flat = []
        for j in range(unweighted_histograms.shape[0]):
            self._check_shape(
                unweighted_histograms[j], f"unweighted histogram {j}"
            )
            flat.append(unweighted_histograms[j].reshape(-1))
        self.unweighted_histograms = np.asarray(flat)

    # ---------------------------------------------------------- outputs
    def get_plot(self):
        """Total weighted best-fit histogram post-fit."""
        if self.bestfit_plots is None:
            return None
        return np.sum(self.get_single_plots(), axis=0)

    def get_single_plots(self):
        """Per-source weighted best-fit histograms post-fit."""
        if self.bestfit_plots is None:
            return None
        result = np.multiply(self.mc_histograms, self.bestfit_plots)
        return result.reshape((result.shape[0],) + self.shape)

    # ------------------------------------------------------- likelihoods
    def get_llh(self, llh_type):
        """Negative log-likelihood ('poisson' or 'barlow'), 0-referenced by
        the Stirling-expansion saturated terms exactly like the
        reference (``barlow.py:200-305``)."""
        llh_type = str(llh_type).lower()
        if llh_type == "poisson":
            self.bestfit_plots = np.array(self.unweighted_histograms)
            return self.get_llh_poisson()
        if llh_type != "barlow":
            raise ValueError(
                f"Unknown llh_type {llh_type!r}: choose 'poisson' or"
                " 'barlow'"
            )

        d = self.data_histogram
        w = self.mc_histograms
        a = self.unweighted_histograms

        # profile the latent counts: A_j = a_j / (1 + w_j t), t per bin
        # from the Barlow-Beeston scalar equation (all bins in parallel)
        t = np.asarray(barlow_solve_t(d, w, a))
        A = a / np.clip(1.0 + w * t[None], SMALL_POS, None)
        self.bestfit_plots = A

        f = np.sum(w * A, axis=0)
        llh = np.zeros_like(np.asarray(d, dtype=float))
        pos_f = f > 0
        llh[pos_f] += d[pos_f] * np.log(f[pos_f]) - f[pos_f]
        pos_d = d > 0
        llh[pos_d] -= d[pos_d] * np.log(d[pos_d]) - d[pos_d]
        pos_A = A > 0
        llh += np.sum(
            np.where(pos_A, a * np.log(np.where(pos_A, A, 1.0)) - A, 0.0),
            axis=0,
        )
        pos_a = a > 0
        llh -= np.sum(
            np.where(pos_a, a * np.log(np.where(pos_a, a, 1.0)) - a, 0.0),
            axis=0,
        )
        return -float(np.sum(llh))

    def get_llh_barlow_bin(self, a_i, bin_n):
        """Per-bin objective -llh(A) at latent counts ``a_i`` for bin
        ``bin_n`` — the function the reference minimizes per bin with
        Powell (``barlow.py:247``); exposed for validation."""
        a_i = np.asarray(a_i, dtype=float)
        if np.any(a_i < 0):
            return 1e10
        di = self.data_histogram[bin_n]
        wi = self.mc_histograms[:, bin_n]
        ai = self.unweighted_histograms[:, bin_n]
        fi = float(np.sum(wi * a_i))
        llh = 0.0
        if fi > 0:
            llh += di * np.log(fi) - fi
        if di > 0:
            llh -= di * np.log(di) - di
        cut = a_i > 0
        llh += float(np.sum(ai[cut] * np.log(a_i[cut]) - a_i[cut]))
        cut = ai > 0
        llh -= float(np.sum(ai[cut] * np.log(ai[cut]) - ai[cut]))
        return -llh

    def get_llh_poisson(self):
        """Standard binned Poisson -llh against the total weighted MC."""
        di = self.data_histogram
        fi = np.sum(self.mc_histograms * self.unweighted_histograms, axis=0)
        llh = 0.0
        cut = fi > 0
        llh += float(np.sum(di[cut] * np.log(fi[cut]) - fi[cut]))
        cut = di > 0
        llh -= float(np.sum(di[cut] * np.log(di[cut]) - di[cut]))
        return -llh
