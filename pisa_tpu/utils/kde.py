"""
KDE-smoothed histograms.

Rebuild of the reference ``pisa/utils/kde_hist.py`` (``get_hist:35``,
``kde_histogramdd:220``), which delegates the density estimate to the
external CUDA ``kde`` package (``from kde.cudakde import gaussian_kde,
bootstrap_kde``). Here the adaptive weighted Gaussian KDE itself is
implemented natively in JAX:

- diagonal bandwidth matrix, per-dimension Scott/Silverman factors from the
  weighted sample standard deviation and effective sample size;
- Abramson-style adaptive local bandwidths: a fixed-bandwidth pilot density
  is evaluated at the sample points and local scale factors
  ``lambda_i = (pilot_i / g)^(-alpha)`` (g = geometric mean) widen kernels
  in low-density regions;
- evaluation is one jitted einsum-shaped (N_events x N_gridpoints)
  elementwise contraction.

The histogram conveniences mirror the reference exactly: coszen reflection
at the +-1 edges (fraction of bins mirrored and folded back), evaluation at
(oversampled) bin centers scaled by bin volumes, per-PID-bin stacking, and
bootstrap error estimation by multinomial resampling.

Structure: everything derived from the *binning* (evaluation
grid, reflection fold maps, oversample reduction, bin volumes) is
precomputed host-side once; the per-call computation — bandwidths, pilot,
density, reflection fold, oversample reduction — is pure ``jnp`` and safe
to call with JAX tracers. PID channels are selected by *weight zeroing*
(``w * mask``) rather than boolean gathering, which is bit-equivalent for
every weighted statistic (zero-weight events contribute nothing to the
weighted mean/std, the effective sample size, the pilot geometric mean, or
the density sum) while keeping shapes static. This lets the whole KDE
stage trace into a compiled pipeline template
(:class:`pisa_tpu.core.template.CompiledTemplate`), so KDE pipelines get
the same one-dispatch-per-batch evaluation as histogram pipelines instead
of a host round-trip per (container, channel) per template.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from pisa_tpu.core.binning import MultiDimBinning

__all__ = ["adaptive_gaussian_kde", "get_hist", "kde_histogramdd"]


@partial(jax.jit, static_argnames=("bw_method", "adaptive"))
def adaptive_gaussian_kde(
    x, weights, points, bw_method="scott", adaptive=True, alpha=0.3
):
    """Weighted (adaptive) Gaussian KDE evaluated at `points`.

    Parameters
    ----------
    x : (D, N) sample
    weights : (N,) weights (need not be normalized)
    points : (D, G) evaluation points
    bw_method : 'scott' or 'silverman'
    adaptive : bool — Abramson local bandwidths
    alpha : float — adaptivity exponent

    Returns
    -------
    (G,) density, normalized to integrate to 1.
    """
    x = jnp.atleast_2d(jnp.asarray(x))
    points = jnp.atleast_2d(jnp.asarray(points))
    d, n = x.shape
    w = jnp.asarray(weights)
    # zero-total-weight guard (e.g. an empty PID channel selected by weight
    # zeroing): return an all-zero density instead of 0/0 = NaN, matching
    # the reference's masked path which histograms an empty subset to zeros
    sum_w = jnp.sum(w)
    w = jnp.where(sum_w > 0, w / jnp.where(sum_w > 0, sum_w, 1.0), 0.0)
    tiny_w = jnp.finfo(w.dtype).tiny
    n_eff = 1.0 / jnp.clip(jnp.sum(w**2), tiny_w, None)
    # a NaN coordinate on a zero-weight event would otherwise poison every
    # evaluation point through 0 * NaN kernel terms
    x = jnp.where((w > 0)[None, :], x, jnp.nan_to_num(x))

    # weighted per-dimension std
    mean = jnp.sum(w[None, :] * x, axis=1)
    var = jnp.sum(w[None, :] * (x - mean[:, None]) ** 2, axis=1)
    sigma = jnp.sqrt(var)

    if bw_method == "scott":
        factor = n_eff ** (-1.0 / (d + 4))
    elif bw_method == "silverman":
        factor = (n_eff * (d + 2.0) / 4.0) ** (-1.0 / (d + 4))
    else:
        raise ValueError(f"unknown bw_method {bw_method!r}")
    h = sigma * factor  # (D,)
    h = jnp.clip(h, 1e-30, None)

    def density_at(pts, lam):
        # pts (D, M); lam (N,) local bandwidth scales
        # z2[i, m] = sum_d ((pts[d,m] - x[d,i]) / (h_d lam_i))^2
        diff = (pts[:, None, :] - x[:, :, None]) / h[:, None, None]
        z2 = jnp.sum(diff**2, axis=0) / lam[:, None] ** 2  # (N, M)
        kern = jnp.exp(-0.5 * z2)
        norm = (2.0 * jnp.pi) ** (d / 2.0) * jnp.prod(h) * lam**d
        # fp32 underflow guard: a zero-weight channel clamps every h to
        # the 1e-30 floor, so prod(h) (1e-60 for d=2) underflows to 0 in
        # float32 and w/norm becomes 0/0 = NaN, which poisons the whole
        # channel even though every weight is zero. The kernel terms are
        # 0 in that regime, so replacing the underflowed norm keeps the
        # density exactly zero (fp64 is unaffected: 1e-60 is normal).
        norm = jnp.where(norm > 0, norm, 1.0)
        return jnp.sum((w / norm)[:, None] * kern, axis=0)

    ones = jnp.ones(n, dtype=x.dtype)
    if adaptive:
        pilot = density_at(x, ones)  # pilot at sample points
        # dtype-aware floor: a 1e-300 literal underflows to 0 in fp32,
        # turning log(pilot) into -inf and 0-weight terms into NaN
        tiny = jnp.finfo(x.dtype).tiny
        log_pilot = jnp.log(jnp.clip(pilot, tiny, None))
        log_g = jnp.sum(w * log_pilot)
        lam = jnp.exp(-alpha * (log_pilot - log_g))
    else:
        lam = ones
    return density_at(points, lam)


def _prepare_static(binning, coszen_name, coszen_reflection, oversample):
    """Host-side precomputation from the binning alone: evaluation grid,
    coszen-reflection fold geometry, oversample reduction shape, bin
    volumes and the axis permutation that puts coszen first. Everything
    here is independent of sample and weights, so per-template evaluation
    stays pure-jnp."""
    out_shape = tuple(binning.shape)
    binning = binning.oversample(oversample)
    names = list(binning.names)
    if coszen_name not in names:
        raise ValueError(f"binning must contain {coszen_name!r}")
    cz_bin = names.index(coszen_name)
    if cz_bin != 0:
        order = [cz_bin] + [i for i in range(len(names)) if i != cz_bin]
        binning = MultiDimBinning([binning[names[i]] for i in order])
    else:
        order = list(range(len(names)))

    cz_dim = binning[coszen_name]
    n_refl = int(cz_dim.num_bins * float(coszen_reflection))
    reflect_lower = (
        float(cz_dim.bin_edges[0].magnitude) == -1.0 and n_refl > 0
    )
    reflect_upper = (
        float(cz_dim.bin_edges[-1].magnitude) == 1.0 and n_refl > 0
    )

    bin_points = []
    l = 0
    for b in binning:
        c = np.asarray(b.weighted_centers.magnitude)
        if b.name == coszen_name:
            l = int(len(c) * float(coszen_reflection))
            c0 = 2 * c[0] - c[1 : l + 1][::-1] if reflect_lower else []
            c1 = 2 * c[-1] - c[-l - 1 : -1][::-1] if reflect_upper else []
            c = np.concatenate([c0, c, c1])
        bin_points.append(c)

    ext_shape = (
        binning.shape[0] + (int(reflect_lower) + int(reflect_upper)) * l,
    ) + tuple(binning.shape[1:])
    grid = np.meshgrid(*bin_points, indexing="ij")
    points = np.stack([g.ravel() for g in grid])  # (D, G)

    return {
        "order": order,
        "cz_bin": cz_bin,
        "points": points,
        "ext_shape": ext_shape,
        "os_shape": tuple(binning.shape),  # oversampled, coszen-first
        "n_refl": l,
        "reflect_lower": reflect_lower,
        "reflect_upper": reflect_upper,
        "volume": binning.bin_volumes(attach_units=False),
        "oversample": int(oversample),
        "out_shape": out_shape,
    }


def _kde_hist_core(
    x, weights, static, bw_method="scott", adaptive=True, alpha=0.3,
    total=None,
):
    """Pure-jnp KDE histogram for a prepared binning (tracer-safe).

    x : (D, N) sample ordered like the ORIGINAL binning; weights (N,).
    Returns an array of the original ``binning.shape``, scaled to
    ``sum(weights)`` (or to ``total`` when given — the bootstrap scales
    every replicate to the original total, as the reference does).
    """
    x = jnp.atleast_2d(jnp.asarray(x))
    w = jnp.nan_to_num(jnp.asarray(weights))
    norm = jnp.sum(w) if total is None else total
    order = static["order"]
    if order != list(range(len(order))):
        x = x[np.asarray(order)]

    dens = adaptive_gaussian_kde(
        x, w, static["points"],
        bw_method=bw_method, adaptive=adaptive, alpha=alpha,
    )
    h = dens.reshape(static["ext_shape"])

    # fold the reflected coszen slabs back inside the physical range
    l = static["n_refl"]
    os_shape = static["os_shape"]
    if static["reflect_lower"] or static["reflect_upper"]:
        pad = jnp.zeros((os_shape[0] - l,) + os_shape[1:], dtype=h.dtype)
        h0 = h1 = None
        if static["reflect_lower"]:
            h0 = jnp.flip(jnp.concatenate([pad, h[:l]], axis=0), axis=0)
            h = h[l:]
        if static["reflect_upper"]:
            h1 = jnp.flip(jnp.concatenate([h[-l:], pad], axis=0), axis=0)
            h = h[:-l]
        if h0 is not None:
            h = h + h0
        if h1 is not None:
            h = h + h1

    h = h * static["volume"]

    # oversample reduction: each oversampled dim is an exact multiple, so
    # reduceat(stride=oversample) == reshape + sum
    ov = static["oversample"]
    if ov != 1:
        for axis in range(h.ndim):
            shape = h.shape
            n_out = shape[axis] // ov
            h = h.reshape(
                shape[:axis] + (n_out, ov) + shape[axis + 1 :]
            ).sum(axis=axis + 1)

    cz_bin = static["cz_bin"]
    if cz_bin != 0:
        # invert _prepare_static's move-to-front permutation; swapaxes
        # would only be correct for cz_bin <= 1 (reference kde_hist.py:210
        # swaps symmetrically because it also builds with swapaxes)
        h = jnp.moveaxis(h, 0, cz_bin)
    return h * norm


def get_hist(
    sample,
    binning,
    weights=None,
    bw_method="scott",
    adaptive=True,
    alpha=0.3,
    use_cuda=False,  # accepted for API compat; ignored (XLA picks devices)
    coszen_reflection=0.25,
    coszen_name="coszen",
    oversample=1,
    bootstrap=False,
    bootstrap_niter=10,
    bootstrap_seed=None,
):
    """KDE histogram with coszen-edge reflection
    (cf. reference ``kde_hist.py:35-218``).

    sample : (N, D) array ordered like `binning`; returns an array of
    `binning.shape` (pre-oversampling), scaled to sum(weights). Safe to
    call with traced sample/weights when ``bootstrap=False`` (the
    bootstrap loop draws host-side random resamples).
    """
    if bootstrap and oversample > 1:
        raise ValueError("Bootstrapping cannot be combined with oversampling.")

    traced = isinstance(sample, jax.core.Tracer) or isinstance(
        weights, jax.core.Tracer
    )
    if not traced:
        sample = np.asarray(sample)
    n_evts = sample.shape[0]
    if weights is None or (
        not traced and len(np.atleast_1d(weights)) == 0
    ):
        weights = jnp.ones(n_evts)

    x = jnp.asarray(sample).T  # (D, N)
    if x.shape[0] != len(binning.names):
        raise ValueError("sample dims != binning dims")

    static = _prepare_static(
        binning, coszen_name, coszen_reflection, oversample
    )
    kw = dict(bw_method=bw_method, adaptive=adaptive, alpha=alpha)

    if bootstrap:
        rng = np.random.default_rng(bootstrap_seed)
        w_host = np.nan_to_num(np.asarray(weights, dtype=np.float64))
        hists = []
        for _ in range(bootstrap_niter):
            idx = rng.integers(n_evts, size=n_evts)
            counts = np.bincount(idx, minlength=n_evts)
            hists.append(
                np.asarray(
                    _kde_hist_core(
                        x, w_host * counts, static,
                        total=w_host.sum(), **kw,
                    )
                )
            )
        hists = np.stack(hists)
        return hists.mean(axis=0), hists.std(axis=0)

    hist = _kde_hist_core(x, weights, static, **kw)
    return hist if traced else np.asarray(hist)


def kde_histogramdd(
    sample,
    binning,
    weights=None,
    bw_method="scott",
    adaptive=True,
    alpha=0.3,
    use_cuda=False,
    coszen_reflection=0.25,
    coszen_name="coszen",
    oversample=1,
    stack_pid=True,
    bootstrap=False,
    bootstrap_niter=10,
    bootstrap_seed=None,
):
    """N-dim KDE histogram; with `stack_pid` the 'pid' dimension is treated
    as separate channels, each KDE'd in the remaining dimensions
    (cf. reference ``kde_hist.py:220-341``).

    Tracer-safe for ``bootstrap=False``: PID channels are selected by
    weight zeroing, which is numerically identical to event masking for
    every weighted KDE statistic while keeping shapes static under jit.
    """
    traced = isinstance(sample, jax.core.Tracer) or isinstance(
        weights, jax.core.Tracer
    )
    if not traced:
        sample = np.asarray(sample)
        if weights is not None and len(np.atleast_1d(weights)) not in (
            0, sample.shape[0],
        ):
            raise ValueError("length of sample and weights incompatible")

    kwargs = dict(
        bw_method=bw_method, adaptive=adaptive, alpha=alpha,
        coszen_reflection=coszen_reflection, coszen_name=coszen_name,
        oversample=oversample, bootstrap=bootstrap,
        bootstrap_niter=bootstrap_niter, bootstrap_seed=bootstrap_seed,
    )
    if not stack_pid:
        return get_hist(sample, binning, weights=weights, **kwargs)

    names = list(binning.names)
    pid_bin = names.index("pid")
    pid_dim = binning[names[pid_bin]]
    pid_edges = np.asarray(pid_dim.bin_edges.magnitude)
    other = [i for i in range(len(names)) if i != pid_bin]
    other_binning = MultiDimBinning([binning[names[i]] for i in other])

    hists, errs = [], []
    sample = jnp.asarray(sample) if traced else sample
    for k in range(len(pid_edges) - 1):
        if bootstrap:
            # host path: true per-channel resampling needs the masked
            # subset (resample N_k events of channel k)
            mask = np.asarray(
                (sample[:, pid_bin] >= pid_edges[k])
                & (sample[:, pid_bin] < pid_edges[k + 1])
            )
            sub = np.asarray(sample)[mask][:, other]
            w = None if weights is None else np.asarray(weights)[mask]
            res = get_hist(sub, other_binning, weights=w, **kwargs)
            hists.append(res[0])
            errs.append(res[1])
        else:
            mask = (sample[:, pid_bin] >= pid_edges[k]) & (
                sample[:, pid_bin] < pid_edges[k + 1]
            )
            w_all = (
                jnp.ones(sample.shape[0])
                if weights is None
                else jnp.asarray(weights)
            )
            w_k = w_all * jnp.asarray(mask, dtype=w_all.dtype)
            sub = jnp.asarray(sample)[:, np.asarray(other)]
            hists.append(
                get_hist(sub, other_binning, weights=w_k, **kwargs)
            )

    def stack_back(channel_hists):
        stack = jnp if traced else np
        stacked = stack.stack(
            [stack.asarray(c) for c in channel_hists], axis=0
        )
        # move pid channel to its original axis position
        return stack.moveaxis(stacked, 0, pid_bin)

    if bootstrap:
        return stack_back(hists), stack_back(errs)
    return stack_back(hists)
