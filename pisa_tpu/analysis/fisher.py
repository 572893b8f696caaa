"""
Fisher-matrix sensitivity estimation and the linearized "pull" method
(cf. reference ``pisa/utils/fisher_matrix.py`` and
``pisa/utils/pull_method.py``).

Redesign: the reference builds Fisher matrices from
finite-difference template derivatives; here the per-bin template jacobian
w.r.t. the free parameters is ANALYTIC (one ``jax.jacfwd`` of the compiled
template), so the matrix is exact at the linearization point and costs a
single compiled evaluation per parameter tangent.

Conventions: the Poisson Fisher information of a binned template mu(p) is
F_ij = sum_b (1/mu_b) dmu_b/dp_i dmu_b/dp_j; Gaussian priors add
delta_ij / sigma_i^2. Derivatives are w.r.t. the *physical* parameter
magnitudes (chain rule from the rescaled [0,1] space).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from pisa_tpu.utils.jsons import from_json, to_json

__all__ = ["FisherMatrix", "get_fisher_matrix", "calculate_pulls"]


def _template_jacobian(compiled_template, rescaled_vec=None):
    """(total template (B,), jacobian (B, n_params)) in rescaled space."""
    fn = compiled_template._build_fn()

    def total_hist(vec, data):
        out = fn(vec, data=data)
        return jnp.concatenate(
            [jnp.ravel(h) for _, h in sorted(out["hist"].items())]
        )

    if rescaled_vec is None:
        rescaled_vec = compiled_template.current_rescaled_values()
    vec = jnp.asarray(rescaled_vec)
    data = compiled_template._data_vals
    mu = jax.jit(total_hist)(vec, data)
    jac = jax.jit(jax.jacfwd(total_hist))(vec, data)
    return np.asarray(mu), np.asarray(jac)


def _rescale_derivatives(compiled_template):
    """d(physical magnitude)/d(rescaled value) per free param, evaluated at
    the current values (linear ranges exactly; log ranges locally)."""
    out = []
    for (lo, hi, log_scale), p in zip(
        compiled_template._rescale, compiled_template._free_params
    ):
        if log_scale:
            # mag = lo * exp(v * ln(hi/lo)) -> d mag/dv = mag * ln(hi/lo)
            mag = p.value.magnitude
            out.append(abs(mag * np.log(abs(hi) / abs(lo))))
        else:
            out.append(hi - lo)
    return np.asarray(out)


def get_fisher_matrix(compiled_template, priors=True, rescaled_vec=None):
    """Poisson Fisher matrix of a compiled template at the current (or
    given) parameter point. Returns a :class:`FisherMatrix`."""
    mu, jac = _template_jacobian(compiled_template, rescaled_vec)
    dphys = _rescale_derivatives(compiled_template)
    jac_phys = jac / dphys[None, :]

    good = mu > 0
    inv_mu = np.where(good, 1.0 / np.clip(mu, 1e-300, None), 0.0)
    fisher = np.einsum("b,bi,bj->ij", inv_mu, jac_phys, jac_phys)

    names = list(compiled_template.free_names)
    fm = FisherMatrix(
        matrix=fisher,
        parameters=names,
        best_fits=[
            p.value.magnitude for p in compiled_template._free_params
        ],
        units=[str(p.units) for p in compiled_template._free_params],
    )
    if priors:
        for p in compiled_template._free_params:
            if p.prior is not None and getattr(p.prior, "kind", "") == "gaussian":
                sigma = p.prior.stddev
                sigma = getattr(sigma, "magnitude", sigma)
                fm.add_prior(p.name, float(sigma))
    return fm


def calculate_pulls(compiled_template, data_dist, rescaled_vec=None):
    """Linearized best-fit parameter shifts (the "pull method",
    cf. reference ``pull_method.py``): dp = F^-1 b with
    b_i = sum_b (d_b - mu_b)/mu_b * dmu_b/dp_i. Returns dict name->shift
    (physical units' magnitudes)."""
    mu, jac = _template_jacobian(compiled_template, rescaled_vec)
    dphys = _rescale_derivatives(compiled_template)
    jac_phys = jac / dphys[None, :]

    if hasattr(data_dist, "names"):  # MapSet
        d = np.concatenate(
            [
                np.ravel(np.asarray(data_dist[n].hist))
                for n in sorted(compiled_template.names or data_dist.names)
            ]
        )
    else:
        d = np.concatenate(
            [np.ravel(np.asarray(v)) for _, v in sorted(data_dist.items())]
        )

    good = mu > 0
    inv_mu = np.where(good, 1.0 / np.clip(mu, 1e-300, None), 0.0)
    fisher = np.einsum("b,bi,bj->ij", inv_mu, jac_phys, jac_phys)
    b = np.einsum("b,bi->i", (d - mu) * inv_mu, jac_phys)
    shifts = np.linalg.solve(fisher, b)
    return dict(zip(compiled_template.free_names, shifts))


class FisherMatrix:
    """Fisher matrix with parameter bookkeeping
    (cf. reference ``fisher_matrix.py``)."""

    def __init__(self, matrix, parameters, best_fits, units=None, priors=None):
        self.matrix = np.asarray(matrix, dtype=np.float64)
        self.parameters = list(parameters)
        self.best_fits = [float(b) for b in best_fits]
        self.units = list(units) if units else [""] * len(self.parameters)
        if self.matrix.shape != (len(self.parameters),) * 2:
            raise ValueError("matrix shape does not match parameters")
        if priors:
            for name, sigma in priors.items():
                self.add_prior(name, sigma)

    # -- bookkeeping -----------------------------------------------------------
    def index(self, name):
        return self.parameters.index(name)

    def add_prior(self, name, sigma):
        """Add a Gaussian prior of width `sigma` on parameter `name`."""
        i = self.index(name)
        self.matrix[i, i] += 1.0 / float(sigma) ** 2

    def remove_parameter(self, name):
        """Marginalize a parameter out entirely (drop row/column of the
        covariance — i.e. invert, delete, re-invert)."""
        i = self.index(name)
        cov = np.delete(np.delete(self.covariance(), i, 0), i, 1)
        del self.parameters[i], self.best_fits[i], self.units[i]
        self.matrix = np.linalg.inv(cov)

    def fix_parameter(self, name):
        """Condition on a parameter (drop row/column of the Fisher matrix)."""
        i = self.index(name)
        self.matrix = np.delete(np.delete(self.matrix, i, 0), i, 1)
        del self.parameters[i], self.best_fits[i], self.units[i]

    # -- uncertainties ------------------------------------------------------------
    def covariance(self):
        return np.linalg.inv(self.matrix)

    def correlation(self):
        cov = self.covariance()
        s = np.sqrt(np.diag(cov))
        return cov / np.outer(s, s)

    def get_sigma(self, name, marginalized=True):
        """1-sigma uncertainty: marginalized (from the covariance) or with
        all other parameters fixed (1/sqrt(F_ii))."""
        i = self.index(name)
        if marginalized:
            return float(np.sqrt(self.covariance()[i, i]))
        return float(1.0 / np.sqrt(self.matrix[i, i]))

    # -- serialization -------------------------------------------------------------
    @property
    def state(self):
        return {
            "matrix": self.matrix,
            "parameters": self.parameters,
            "best_fits": self.best_fits,
            "units": self.units,
        }

    def to_json(self, path):
        to_json(self.state, path)

    @classmethod
    def from_json(cls, path):
        return cls(**from_json(path))

    def __str__(self):
        lines = ["FisherMatrix:"]
        for name in self.parameters:
            lines.append(
                f"  {name}: sigma(marg)={self.get_sigma(name):.4g},"
                f" sigma(fixed)={self.get_sigma(name, False):.4g}"
            )
        return "\n".join(lines)
