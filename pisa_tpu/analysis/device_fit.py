"""
Fully on-device minimization and batched ensemble fits.

The host `gradient` fit path (`analysis/analysis.py`) already evaluates
value+gradient in one XLA call, but the minimizer loop itself runs on the
host — one device round-trip per iteration. Here the ENTIRE L-BFGS loop
runs inside one
jitted program (`lax.while_loop`), so a complete fit costs ONE dispatch;
and because the program is a pure function of (start point, data
histogram), `jax.vmap` turns N fits into one device program:

- multi-start fits (octant seeds, global-ish searches) in parallel;
- pseudo-experiment ensembles: Poisson-fluctuate the Asimov expectation on
  device and fit every trial in parallel — the replacement for
  the reference's llh-server process farm + emcee-style host loops
  (cf. ``pisa/utils/llh_server.py:64-120``).

Bounds: the [0,1] box of rescaled params (``param.py _rescaled_value``) is
enforced by optimizing an unconstrained vector z with x = sigmoid(z), so
the objective never sees out-of-box (blowup) corners; boundary optima are
approached asymptotically (adequate for wrong-octant branches, whose only
requirement is to score worse than the right octant).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
import optax
import optax.tree_utils as otu

from pisa_tpu import FTYPE

__all__ = [
    "lbfgs_while",
    "minimize_on_device",
    "fit_batch_on_device",
    "fit_pseudo_ensemble",
]

_EPS = 1e-6  # sigmoid clip for the initial logit transform

# Default gradient-norm stopping tolerance: at fp32 the objective's
# gradient noise floor sits around 1e-4, so insisting on 1e-6 just burns
# the full max_steps budget after convergence.
DEFAULT_GTOL = 1e-6 if FTYPE == np.float64 else 3e-4


def _to_z(x):
    x = jnp.clip(jnp.asarray(x, dtype=FTYPE), _EPS, 1.0 - _EPS)
    return jnp.log(x) - jnp.log1p(-x)


def _to_x(z):
    return jax.nn.sigmoid(z)


def _guard(fun):
    """Replace non-finite objective values so the line search backtracks
    instead of silently stalling (cf. the host-path sanitization in
    ``analysis.py _fit_scipy``)."""

    def guarded(z):
        v = fun(z)
        return jnp.where(jnp.isfinite(v), v, jnp.asarray(1e30, v.dtype))

    return guarded


def lbfgs_while(fun, z0, max_steps=200, gtol=None, memory_size=10):
    """optax L-BFGS (zoom linesearch) inside ``lax.while_loop``.

    Returns (z_final, value_final, n_iters). Trace-safe: usable inside jit
    and under vmap (the loop runs until every batch lane converges).
    """
    if gtol is None:
        gtol = DEFAULT_GTOL
    fun = _guard(fun)
    opt = optax.lbfgs(memory_size=memory_size)
    value_and_grad = optax.value_and_grad_from_state(fun)

    def step(carry):
        z, state = carry
        value, grad = value_and_grad(z, state=state)
        updates, state = opt.update(
            grad, state, z, value=value, grad=grad, value_fn=fun
        )
        z = optax.apply_updates(z, updates)
        return z, state

    def keep_going(carry):
        _, state = carry
        count = otu.tree_get(state, "count")
        grad = otu.tree_get(state, "grad")
        return (count == 0) | (
            (count < max_steps) & (otu.tree_l2_norm(grad) >= gtol)
        )

    z0 = jnp.asarray(z0, dtype=FTYPE)
    state0 = opt.init(z0)
    z, state = jax.lax.while_loop(keep_going, step, (z0, state0))
    return z, otu.tree_get(state, "value"), otu.tree_get(state, "count")


def minimize_on_device(raw_objective, x0, los, his, datas,
                       max_steps=200, gtol=None, platform=None):
    """One complete bounded fit in ONE device program.

    Parameters
    ----------
    raw_objective : callable
        The un-jitted objective ``(vec, los, his, datas) -> scalar`` (always
        minimized), e.g. ``value_fn.raw`` from
        :meth:`CompiledDistribution.build_objective`.
    x0 : array (n_free,)
        Start point in [0,1] rescaled space.
    los, his : arrays (n_free,)
        Current physical bounds (runtime inputs: octant/range changes do
        not recompile).
    datas : pytree
        Container-data arguments (``CompiledDistribution._all_data_vals``).
    platform : str or None
        Backend to run the fit program on (e.g. ``"cpu"``). Small-workload
        routing: a toy-scale fit is dominated by per-iteration launch
        overhead, so it can be faster on the host backend than on the
        accelerator. The container data is copied to the target backend
        once and memoized on the objective. None = ambient default backend.

    Returns
    -------
    dict with ``x`` ([0,1] space), ``fun``, ``nit`` (host values).
    """
    import contextlib

    if gtol is None:
        gtol = DEFAULT_GTOL
    attr = (
        "_device_fit_runner"
        if platform is None
        else f"_device_fit_runner_{platform}"
    )
    run = getattr(raw_objective, attr, None)
    if run is None:

        @jax.jit
        def run(x0, los, his, datas, max_steps, gtol):
            fun = lambda z: raw_objective(  # noqa: E731
                _to_x(z), los, his, datas
            )
            z, val, nit = lbfgs_while(fun, _to_z(x0), max_steps, gtol)
            return _to_x(z), val, nit

        try:  # reuse the compiled program across fits on the same objective
            setattr(raw_objective, attr, run)
        except AttributeError:
            pass

    if platform is not None:
        dev = jax.local_devices(backend=platform)[0]
        key = (platform,) + tuple(
            id(a) for a in jax.tree_util.tree_leaves(datas)
        )
        cache = getattr(raw_objective, "_device_fit_datas_cache", None)
        if cache is not None and cache[0] == key:
            datas = cache[1]
        else:
            datas = jax.device_put(datas, dev)
            try:
                raw_objective._device_fit_datas_cache = (key, datas)
            except AttributeError:
                pass
        ctx = jax.default_device(dev)
    else:
        ctx = contextlib.nullcontext()

    with ctx:
        x, val, nit = run(
            jnp.asarray(x0), jnp.asarray(los), jnp.asarray(his), datas,
            jnp.asarray(max_steps, dtype=jnp.int32),
            jnp.asarray(gtol, FTYPE),
        )
    return {
        "x": np.asarray(x, dtype=np.float64),
        "fun": float(val),
        "nit": int(nit),
    }


def fit_batch_on_device(raw_with_data, x0_batch, los, his, datas, data_batch,
                        max_steps=100, gtol=None):
    """N independent bounded fits in ONE device program (vmapped L-BFGS).

    ``raw_with_data`` is the data-as-argument objective
    (``value_fn.raw_with_data``): ``(vec, los, his, datas, data_hist) ->
    scalar``. ``x0_batch`` is (N, n_free); ``data_batch`` is (N, n_bins)
    (or None to reuse the closed-over data for every lane — multi-start
    mode). Returns device arrays (x_batch, fun_batch, nit_batch).
    """

    if gtol is None:
        gtol = DEFAULT_GTOL
    attr = (
        "_device_fit_batch_runner"
        if data_batch is not None
        else "_device_fit_multistart_runner"
    )
    run = getattr(raw_with_data, attr, None)
    if run is None:

        @jax.jit
        def run(x0_batch, los, his, datas, data_batch, max_steps, gtol):
            def one(x0, data_hist):
                fun = lambda z: raw_with_data(  # noqa: E731
                    _to_x(z), los, his, datas, data_hist
                )
                z, val, nit = lbfgs_while(fun, _to_z(x0), max_steps, gtol)
                return _to_x(z), val, nit

            if data_batch is None:
                return jax.vmap(lambda x0: one(x0, None))(x0_batch)
            return jax.vmap(one)(x0_batch, data_batch)

        try:
            setattr(raw_with_data, attr, run)
        except AttributeError:
            pass

    return run(
        jnp.asarray(x0_batch), jnp.asarray(los), jnp.asarray(his), datas,
        None if data_batch is None else jnp.asarray(data_batch),
        jnp.asarray(max_steps, dtype=jnp.int32), jnp.asarray(gtol, FTYPE),
    )


def fit_pseudo_ensemble(compiled_dist, metric, n_trials, seed=0,
                        max_steps=100, gtol=None, x0=None):
    """Poisson pseudo-experiment ensemble, generated AND fit on device.

    Fluctuates the current-parameter expectation (Asimov template) of
    `compiled_dist` with Poisson noise `n_trials` times and runs all fits
    in one vmapped device program (cf. reference ``Map.fluctuate``
    (``map.py:1118``) + per-pseudo-experiment host fit loops).

    Returns
    -------
    dict with ``x`` (n_trials, n_free) best-fit rescaled values,
    ``magnitudes`` (n_trials, n_free) in physical units, ``fun``
    (n_trials,), ``nit`` (n_trials,).
    """
    cd = compiled_dist
    x_nom = cd.current_rescaled_values()
    los, his = cd._current_bounds()
    datas = cd._all_data_vals()
    asimov = cd.sum_hist(x_nom)

    value_fn, _ = cd.build_objective(asimov, metric)
    raw_with_data = value_fn.raw_with_data

    key = jax.random.PRNGKey(seed)
    lam = jnp.asarray(np.clip(asimov.ravel(), 0.0, None), dtype=FTYPE)
    data_batch = jax.random.poisson(
        key, lam, shape=(int(n_trials),) + lam.shape
    ).astype(FTYPE)

    if x0 is None:
        x0 = x_nom
    x0_batch = jnp.broadcast_to(
        jnp.asarray(x0, dtype=FTYPE), (int(n_trials), len(x_nom))
    )

    xb, fb, nb = fit_batch_on_device(
        raw_with_data, x0_batch, los, his, datas, data_batch,
        max_steps=max_steps, gtol=gtol,
    )
    xb = np.asarray(xb, dtype=np.float64)

    # physical magnitudes (log-aware, cf. param.py _rescaled_value)
    mags = np.empty_like(xb)
    for i, p in enumerate(cd._free_params):
        lo, hi = los[i], his[i]
        if p.scales_as_log:
            mags[:, i] = lo * np.exp(
                xb[:, i] * (np.log(abs(hi)) - np.log(abs(lo)))
            )
        else:
            mags[:, i] = lo + (hi - lo) * xb[:, i]
    return {
        "x": xb,
        "magnitudes": mags,
        "fun": np.asarray(fb, dtype=np.float64),
        "nit": np.asarray(nb),
        "data": np.asarray(data_batch),
        "free_names": list(cd.free_names),
    }
