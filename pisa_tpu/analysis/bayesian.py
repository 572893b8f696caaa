"""
Bayesian posterior sampling (cf. reference ``pisa/analysis/bayesian_analysis.py:23``,
which wraps serial emcee fed by a TCP llh-server farm,
``pisa/utils/llh_server.py``).

Redesign: a Goodman & Weare (2010) affine-invariant ensemble
("stretch move") sampler written in JAX — all walkers evaluate the compiled
template objective in one vmapped call per half-ensemble, and the whole
chain is a single ``lax.scan`` on device. No sockets, no processes.

Sampling happens in the minimizer's rescaled [0, 1] parameter space (flat
prior over the param ranges; Param priors enter through the objective's
penalty term); proposals outside the box are rejected.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

__all__ = ["mcmc_sampling", "MCMC_sampling"]


def mcmc_sampling(
    compiled_template,
    data_dist,
    metric="llh",
    n_walkers=32,
    n_steps=500,
    n_burnin=100,
    stretch_a=2.0,
    seed=0,
    x0=None,
    init_spread=0.05,
):
    """Sample the posterior of a compiled template's free parameters.

    Parameters
    ----------
    compiled_template : CompiledTemplate
    data_dist : MapSet / dict — the data distribution
    metric : str — llh-family metric (the objective is -log posterior)
    n_walkers : int (even)
    n_steps : int — post-burn-in steps to record
    n_burnin : int
    stretch_a : float — stretch-move scale parameter
    seed : int
    x0 : (n_params,) rescaled start (default: current values)
    init_spread : float — walker initialization ball width

    Returns
    -------
    chain : (n_steps, n_walkers, n_params) rescaled samples
    logp : (n_steps, n_walkers)
    acceptance : float — mean acceptance fraction
    """
    if n_walkers % 2:
        raise ValueError("n_walkers must be even")

    value_only, _ = compiled_template.build_objective(data_dist, metric)
    obj = value_only.__wrapped__ if hasattr(value_only, "__wrapped__") else value_only

    def log_prob_one(x):
        # objective is minimized; posterior log-prob is its negation.
        # out-of-box proposals are vetoed with -inf
        inside = jnp.all((x >= 0.0) & (x <= 1.0))
        lp = -obj(jnp.clip(x, 0.0, 1.0))
        return jnp.where(inside, lp, -jnp.inf)

    log_prob = jax.vmap(log_prob_one)

    n_params = len(compiled_template.free_names)
    if x0 is None:
        x0 = compiled_template.current_rescaled_values()
    x0 = np.asarray(x0, dtype=np.float64)

    key = jax.random.PRNGKey(seed)
    key, sub = jax.random.split(key)
    walkers = jnp.clip(
        jnp.asarray(x0)[None, :]
        + init_spread
        * jax.random.normal(sub, (n_walkers, n_params)),
        1e-4,
        1.0 - 1e-4,
    )
    lp = log_prob(walkers)

    half = n_walkers // 2

    def half_step(carry, move_second):
        walkers, lp, key, n_acc = carry
        key, k_z, k_pair, k_acc = jax.random.split(key, 4)
        if_first = 1 - move_second
        # moving set S and complementary set C
        movers = jax.lax.dynamic_slice_in_dim(
            walkers, move_second * half, half, axis=0
        )
        movers_lp = jax.lax.dynamic_slice_in_dim(
            lp, move_second * half, half, axis=0
        )
        others = jax.lax.dynamic_slice_in_dim(
            walkers, if_first * half, half, axis=0
        )
        # z ~ g(z) ∝ 1/sqrt(z) on [1/a, a]
        u = jax.random.uniform(k_z, (half,))
        z = ((stretch_a - 1.0) * u + 1.0) ** 2 / stretch_a
        partners = others[jax.random.randint(k_pair, (half,), 0, half)]
        proposal = partners + z[:, None] * (movers - partners)
        prop_lp = log_prob(proposal)
        log_ratio = (n_params - 1) * jnp.log(z) + prop_lp - movers_lp
        accept = (
            jnp.log(jax.random.uniform(k_acc, (half,))) < log_ratio
        )
        new_movers = jnp.where(accept[:, None], proposal, movers)
        new_lp = jnp.where(accept, prop_lp, movers_lp)
        walkers = jax.lax.dynamic_update_slice_in_dim(
            walkers, new_movers, move_second * half, axis=0
        )
        lp = jax.lax.dynamic_update_slice_in_dim(
            lp, new_lp, move_second * half, axis=0
        )
        return (
            walkers, lp, key, n_acc + jnp.sum(accept).astype(jnp.int32)
        ), None

    def step(carry, _):
        carry, _ = half_step(carry, 0)
        carry, _ = half_step(carry, 1)
        walkers, lp, key, n_acc = carry
        return carry, (walkers, lp)

    @jax.jit
    def run(walkers, lp, key):
        carry = (walkers, lp, key, jnp.zeros((), dtype=jnp.int32))
        carry, _ = jax.lax.scan(step, carry, None, length=n_burnin)
        carry, (chain, chain_lp) = jax.lax.scan(
            step, carry, None, length=n_steps
        )
        _, _, _, n_acc = carry
        return chain, chain_lp, n_acc

    chain, chain_lp, n_acc = run(walkers, lp, key)
    total_proposals = (n_burnin + n_steps) * n_walkers
    acceptance = float(n_acc) / total_proposals
    return np.asarray(chain), np.asarray(chain_lp), acceptance


# reference-compatible alias (cf. ``bayesian_analysis.py:23``)
MCMC_sampling = mcmc_sampling
