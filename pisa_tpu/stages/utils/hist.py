"""
Histogramming stage (cf. reference ``pisa/stages/utils/hist.py:17``):
converts per-event weights into binned weights under the output binning,
or re-bins binned weights via a precomputed transform matrix.

Events->binned is one dense one-hot matmul per template (the scatter-add
histogram kernel is the fallback; no regularized/log special-casing
needed); the binned->binned path keeps the reference's ``hist_transform``
matmul.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from pisa_tpu.core.binning import MultiDimBinning
from pisa_tpu.core.stage import Stage
from pisa_tpu.core import translation

__all__ = ["hist", "init_test"]


class hist(Stage):  # noqa: N801
    """Parameters: unweighted (bool), apply_unc_weights (bool)."""

    def __init__(self, apply_unc_weights=False, unweighted=False, **std_kwargs):
        expected_container_keys = ["weights"]
        if apply_unc_weights:
            expected_container_keys.append("unc_weights")
        super().__init__(
            expected_params=(),
            expected_container_keys=tuple(expected_container_keys),
            supported_reps={
                "calc_mode": [MultiDimBinning, "events"],
                "apply_mode": [None, MultiDimBinning],
            },
            **std_kwargs,
        )
        self.apply_unc_weights = apply_unc_weights
        self.unweighted = unweighted
        self._binning_spec = None

    def setup_function(self):
        if self.apply_mode is None:
            self.apply_mode = self.data["output_binning"]
        self._binning_spec = translation.binning_to_spec(self.apply_mode)

        if isinstance(self.calc_mode, MultiDimBinning):
            # binned->binned: precompute the (calc_size, apply_size) transform
            # as an unweighted 2-binning joint histogram of the events
            # (cf. reference hist.py:95-160); applied as a matmul
            if set(self.calc_mode.names) & set(self.apply_mode.names):
                raise ValueError(
                    "calc and apply binnings must use disjoint dimensions"
                )
            transform_binning = self.calc_mode * self.apply_mode
            for container in self.data:
                self.data.representation = "events"
                sample = [
                    container[name] for name in transform_binning.names
                ]
                h = translation.histogram(
                    sample, None, transform_binning, averaged=False
                )
                transform = np.asarray(h).reshape(
                    (self.calc_mode.size, self.apply_mode.size)
                )
                self.data.representation = self.calc_mode
                container["hist_transform"] = transform
        else:
            # events->binned: precompute the dense one-hot bin-membership
            # matrix per container while coordinates are concrete, so the
            # per-template histogram is one matmul (the scatter-add
            # remains the fallback when the matrix is unavailable)
            self.data.representation = "events"
            for container in self.data:
                container.cached_hist_matrix(self.apply_mode)

    # stacked-container support: events->binned only (the binned->binned
    # transform path keeps per-container matrices)
    def stacked_ok(self):
        return not isinstance(self.calc_mode, MultiDimBinning)

    def prepare_stacked(self, data):
        # build the stacked one-hot membership matrix while coordinates are
        # concrete so the per-template histogram is ONE batched matmul
        if isinstance(self.calc_mode, MultiDimBinning):
            return
        if self.apply_mode is None:
            self.apply_mode = data["output_binning"]
        for container in data.containers:
            if getattr(container, "is_stacked", False):
                prev = container.representation
                container.representation = "events"
                try:
                    container.cached_hist_matrix(self.apply_mode)
                finally:
                    container.representation = prev

    def prepare_rate_defer(self, data, calc_binning, static_keys):
        """One-time setup of the FACTORIZED histogram for rate deferral
        (see CompiledTemplate._setup_rate_deferral and
        prob3._apply_stacked): precompute, per category, the static

            S_c[g, b]  = sum_{events e in cat c, calc-cell g, output bin b}
                         A0_e
            S2_c[g, b] = the same with A0_e^2  (sumw2 channel)

        where A0 is the static per-event weight base (initial weights x
        the declared static factors, e.g. weighted_aeff). The per-template
        histogram then is H[c, :] = s_c * rate[row_c, :] @ S_c — one dense
        contraction instead of a 240k-index grid->events gather and its
        reverse-mode scatter. The
        per-category scalar s_c (all parameter dependence of the non-rate
        weight factors, guaranteed scalar by the stages'
        ``stacked_rate_defer_safe`` contract) is extracted in-trace from a
        reference event. Exact because every event of a calc cell shares
        the cell's rate (the 'average'-mode lookup semantics, reference
        ``pisa/core/translation.py:228``); the sumw2 channel stays exact
        through S2 since rate enters each event's weight linearly.

        Returns True when the factorization is prepared for every stacked
        container; False -> the caller leaves deferral disabled."""
        from pisa_tpu.core.container import _rep_hash

        if self.apply_mode is None:
            self.apply_mode = data["output_binning"]
        if self.apply_unc_weights or self.unweighted:
            return False
        B = self.apply_mode.size
        G = calc_binning.size
        self._defer = None
        prepared = {}
        for sc in data.containers:
            if not getattr(sc, "is_stacked", False):
                return False
            if "astro_weights" in sc.keys:
                return False
            gidx = np.asarray(sc._events_flat_indices(calc_binning))
            bidx = np.asarray(
                sc._events_flat_indices(self.apply_mode)
            )
            prev = sc.representation
            sc.representation = "events"
            try:
                # the loader RESETS weights = initial_weights at the start
                # of every traced evaluation (csv_loader apply), so the
                # static per-event base is initial_weights x the declared
                # static factors — NOT the possibly already-run 'weights'
                base_key = (
                    "initial_weights"
                    if "initial_weights" in sc.keys
                    else "weights"
                )
                A0 = np.asarray(sc[base_key], dtype=np.float64)
                for k in static_keys:
                    A0 = A0 * np.asarray(sc[k], dtype=np.float64)
            finally:
                sc.representation = prev
            C, n_pad = gidx.shape
            if C * G * B * np.dtype("float32").itemsize * 2 > 4_000_000_000:
                return False
            A0 = np.where(np.isfinite(A0), A0, 0.0)
            valid = (gidx < G) & (bidx < B)
            comb = gidx.astype(np.int64) * B + bidx.astype(np.int64)
            from pisa_tpu import FTYPE

            S = np.zeros((C, G, B), dtype=FTYPE)
            S2 = np.zeros((C, G, B), dtype=FTYPE)
            for c in range(C):
                v = valid[c]
                S[c] = np.bincount(
                    comb[c][v], weights=A0[c][v], minlength=G * B
                ).reshape(G, B).astype(FTYPE)
                S2[c] = np.bincount(
                    comb[c][v], weights=A0[c][v] ** 2, minlength=G * B
                ).reshape(G, B).astype(FTYPE)
            # reference event per category for the in-trace scalar ratio
            e0 = np.zeros(C, dtype=np.int64)
            a0 = np.ones(C, dtype=np.float64)
            for c in range(C):
                vv = np.nonzero(valid[c] & (np.abs(A0[c]) > 0))[0]
                if vv.size:
                    e0[c] = vv[np.argmax(np.abs(A0[c][vv]))]
                    a0[c] = A0[c][e0[c]]
            # stash the matrices as container DATA so the template's
            # _place_container_data ships them once as device arguments
            # (embedded 300 MB closure constants re-upload per program);
            # rows=arange(C) marks the grid axis for the sharding pass
            h = _rep_hash("events")
            for key, arr in (("_rate_defer_S", S), ("_rate_defer_S2", S2)):
                sc._data.setdefault(key, {})[h] = arr
                sc.rows[(key, h)] = np.arange(C, dtype=np.int32)
                sc.validity.setdefault(key, {})[h] = True
            prepared[id(sc)] = {"e0": e0, "a0": a0, "hash": h}
        if not prepared:
            return False
        self._defer = prepared
        return True

    def _apply_stacked_deferred(self, container, dr):
        """Factorized-histogram apply (rate deferral active this trace)."""
        defer = self._defer[id(container)]
        rate = dr["rate"]  # (R, G) traced
        rows = np.asarray(dr["rows"])
        C = rows.size
        container.representation = "events"
        A = container["weights"]  # (C, n_pad) pre-rate weights, traced
        e0 = jnp.asarray(defer["e0"])
        a0 = jnp.asarray(defer["a0"], dtype=A.dtype)
        s = jnp.where(
            a0 != 0, A[jnp.arange(C), e0] / jnp.where(a0 != 0, a0, 1.0), 1.0
        )
        h = defer["hash"]
        S = jnp.asarray(container._data["_rate_defer_S"][h])
        rate_c = rate[jnp.asarray(rows, dtype=jnp.int32)]  # (C, G)
        hi = jax.lax.Precision.HIGHEST
        hist_w = (
            jnp.einsum("cg,cgb->cb", rate_c, S, precision=hi)
            * s[:, None]
        )
        if self.error_method == "sumw2":
            S2 = jnp.asarray(container._data["_rate_defer_S2"][h])
            sumw2 = (
                jnp.einsum(
                    "cg,cgb->cb", jnp.square(rate_c), S2, precision=hi
                )
                * jnp.square(s)[:, None]
            )
        container.representation = self.apply_mode
        container["weights"] = hist_w
        # the events-representation weights are PRE-rate under deferral:
        # mark them invalid so any later events-rep consumer re-translates
        # instead of silently reading rate-less weights
        from pisa_tpu.core.container import _rep_hash

        container.validity["weights"][_rep_hash("events")] = False
        if self.error_method == "sumw2":
            container["errors"] = jnp.sqrt(sumw2)
            container["bin_unc2"] = hist_w

    def _apply_stacked(self, container):
        """All categories histogrammed in one batched op: (C, n) weights x
        (C, n, size) one-hot -> (C, size) (with the sumw2 channels stacked
        into the same matmul, as in the per-container path)."""
        dr = getattr(container, "deferred_rate", None)
        if dr is not None:
            container.deferred_rate = None
            defer = getattr(self, "_defer", None)
            if defer is None or id(container) not in defer:
                # the osc stage deferred its rate but this hist was not
                # prepared for it — a handshake bug; failing loud beats a
                # silently rate-less histogram
                raise RuntimeError(
                    "deferred_rate present but the hist stage has no"
                    " factorized matrices for this container"
                )
            self._apply_stacked_deferred(container, dr)
            return
        container.representation = "events"
        weights = container["weights"]
        if "astro_weights" in container.keys:
            weights = weights + container["astro_weights"]
        if self.unweighted:
            # padded slots carry the out-of-range index sentinel, so their
            # unit weights drop out of the histogram like any OOR event
            weights = jnp.ones_like(weights)
        if self.apply_unc_weights:
            unc = container["unc_weights"]
        else:
            unc = 1.0
        w = unc * weights
        if self.error_method == "sumw2":
            chans = jnp.stack(
                [
                    w,
                    jnp.square(w),
                    jnp.square(unc) * weights
                    if self.apply_unc_weights
                    else w,
                ],
                axis=-1,
            )
            res = container.stacked_histogram(chans, self.apply_mode)
            hist_w, sumw2, bin_unc2 = res[..., 0], res[..., 1], res[..., 2]
        else:
            hist_w = container.stacked_histogram(w, self.apply_mode)
        container.representation = self.apply_mode
        container["weights"] = hist_w
        # histogramming does not invalidate the events representation
        container.validity["weights"][hash("events")] = True
        if self.error_method == "sumw2":
            container["errors"] = jnp.sqrt(sumw2)
            container["bin_unc2"] = bin_unc2

    def apply_function(self):
        if isinstance(self.calc_mode, MultiDimBinning):
            if self.unweighted:
                raise NotImplementedError(
                    "unweighted only implemented for event-wise calc"
                )
            for container in self.data:
                container.representation = self.calc_mode
                weights = container["weights"]
                if "astro_weights" in container.keys:
                    weights = weights + container["astro_weights"]
                if self.apply_unc_weights:
                    unc = container["unc_weights"]
                else:
                    unc = 1.0
                w = unc * weights
                transform = container["hist_transform"]
                hi = jax.lax.Precision.HIGHEST
                hist_w = jnp.matmul(w, transform, precision=hi)
                if self.error_method == "sumw2":
                    sumw2 = jnp.matmul(jnp.square(w), transform, precision=hi)
                    bin_unc2 = jnp.matmul(
                        jnp.square(unc) * weights
                        if self.apply_unc_weights
                        else w,
                        transform,
                        precision=hi,
                    )
                container.representation = self.apply_mode
                container["weights"] = hist_w
                if self.error_method == "sumw2":
                    container["errors"] = jnp.sqrt(sumw2)
                    container["bin_unc2"] = bin_unc2
        else:
            for container in self.data:
                if getattr(container, "is_stacked", False):
                    self._apply_stacked(container)
                    continue
                container.representation = "events"
                sample = [
                    container[name] for name in self.apply_mode.names
                ]
                weights = container["weights"]
                if "astro_weights" in container.keys:
                    weights = weights + container["astro_weights"]
                if self.unweighted:
                    weights = jnp.ones_like(weights)
                if self.apply_unc_weights:
                    unc = container["unc_weights"]
                else:
                    unc = 1.0
                w = unc * weights
                # all weight channels histogrammed in ONE dense matmul
                # against the cached one-hot membership matrix (one read of
                # the matrix per template)
                matrix = container.cached_hist_matrix(self.apply_mode)
                if matrix is not None:
                    if self.error_method == "sumw2":
                        chans = jnp.stack(
                            [
                                w,
                                jnp.square(w),
                                jnp.square(unc) * weights
                                if self.apply_unc_weights
                                else w,
                            ],
                            axis=-1,
                        )
                        res = translation.histogram_matmul(chans, matrix)
                        hist_w, sumw2, bin_unc2 = res[:, 0], res[:, 1], res[:, 2]
                    else:
                        hist_w = translation.histogram_matmul(w, matrix)
                else:
                    # param-independent bin indices: cached across template
                    # evaluations (None during a cold-cache trace -> inline)
                    idx = container.cached_flat_indices(self.apply_mode)
                    hist_w = translation.histogram(
                        sample, w, self._binning_spec, averaged=False, idx=idx
                    )
                    if self.error_method == "sumw2":
                        sumw2 = translation.histogram(
                            sample, jnp.square(w), self._binning_spec,
                            averaged=False, idx=idx,
                        )
                        bin_unc2 = translation.histogram(
                            sample,
                            jnp.square(unc) * weights
                            if self.apply_unc_weights
                            else w,
                            self._binning_spec,
                            averaged=False,
                            idx=idx,
                        )
                container.representation = self.apply_mode
                container["weights"] = hist_w
                # histogramming does not invalidate the events representation
                container.validity["weights"][hash("events")] = True
                if self.error_method == "sumw2":
                    container["errors"] = jnp.sqrt(sumw2)
                    container["bin_unc2"] = bin_unc2


def init_test(**param_kwargs):
    """Instantiation example."""
    return hist(calc_mode="events")
