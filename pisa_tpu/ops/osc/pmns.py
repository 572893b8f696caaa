"""
PMNS mixing matrix and mass-splitting matrix construction.

JAX-differentiable equivalents of reference ``pisa/stages/osc/osc_params.py``
(``mix_matrix:175``, ``mix_matrix_reparam:214``, ``dm_matrix:266``), plus an
``OscParams`` host-side container mirroring the reference API.

Matrices are built in split (re, im) representation (:class:`C`), as all
device-side complex algebra is; ``*_complex`` helpers materialize
numpy complex arrays for host-side use.

Conventions (reference Appendix B / ``osc_params.py``):
- standard 3x3 PDG parameterization U = R23(t23) . U13(t13, dcp) . R12(t12)
- reparameterized variant U' = diag(e^{i dcp},1,1) U diag(e^{-i dcp},1,1)
- dm_matrix[i,j] = m_i^2 - m_j^2 with (m1^2, m2^2, m3^2) = (0, dm21, dm31),
  degeneracies broken by +/- 5e-9 eV^2
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from pisa_tpu.ops.cplx import C, to_numpy

__all__ = [
    "pmns_matrix",
    "pmns_matrix_reparam",
    "pmns_matrix_complex",
    "dm_matrix",
    "OscParams",
]

DEGENERACY_DELTA = 5.0e-9  # eV^2, cf. reference osc_params.py:270


def pmns_matrix(sin12, sin13, sin23, deltacp) -> C:
    """Standard-parameterization PMNS matrix (split re/im) from sines of the
    mixing angles and the CPV phase (radians). JAX-traceable/differentiable."""
    s12, s13, s23 = jnp.asarray(sin12), jnp.asarray(sin13), jnp.asarray(sin23)
    c12 = jnp.sqrt(1.0 - s12**2)
    c13 = jnp.sqrt(1.0 - s13**2)
    c23 = jnp.sqrt(1.0 - s23**2)
    cd, sd = jnp.cos(deltacp), jnp.sin(deltacp)
    zero = jnp.zeros_like(s12)
    re = jnp.stack(
        [
            jnp.stack([c12 * c13, s12 * c13, s13 * cd]),
            jnp.stack(
                [
                    -s12 * c23 - c12 * s23 * s13 * cd,
                    c12 * c23 - s12 * s23 * s13 * cd,
                    s23 * c13,
                ]
            ),
            jnp.stack(
                [
                    s12 * s23 - c12 * c23 * s13 * cd,
                    -c12 * s23 - s12 * c23 * s13 * cd,
                    c23 * c13,
                ]
            ),
        ]
    )
    im = jnp.stack(
        [
            jnp.stack([zero, zero, -s13 * sd]),
            jnp.stack(
                [-c12 * s23 * s13 * sd, -s12 * s23 * s13 * sd, zero]
            ),
            jnp.stack(
                [-c12 * c23 * s13 * sd, -s12 * c23 * s13 * sd, zero]
            ),
        ]
    )
    return C(re, im)


def pmns_matrix_reparam(sin12, sin13, sin23, deltacp) -> C:
    """Reparameterized PMNS matrix diag(e^{i dcp},1,1) U diag(e^{-i dcp},1,1)
    (cf. reference ``osc_params.py:214``)."""
    u = pmns_matrix(sin12, sin13, sin23, deltacp)
    cd, sd = jnp.cos(deltacp), jnp.sin(deltacp)
    one = jnp.ones_like(cd)
    zero = jnp.zeros_like(cd)
    left = C(jnp.stack([cd, one, one]), jnp.stack([sd, zero, zero]))
    right = C(jnp.stack([cd, one, one]), jnp.stack([-sd, zero, zero]))
    lu = C(
        left.re[:, None] * u.re - left.im[:, None] * u.im,
        left.re[:, None] * u.im + left.im[:, None] * u.re,
    )
    return C(
        lu.re * right.re[None, :] - lu.im * right.im[None, :],
        lu.re * right.im[None, :] + lu.im * right.re[None, :],
    )


def pmns_matrix_complex(sin12, sin13, sin23, deltacp, reparam=False):
    """Host-side numpy complex PMNS matrix."""
    fn = pmns_matrix_reparam if reparam else pmns_matrix
    return to_numpy(fn(sin12, sin13, sin23, deltacp))


def dm_matrix(dm21, dm31):
    """Antisymmetric vacuum mass-splitting matrix dm[i,j] = m_i^2 - m_j^2
    with degeneracy-breaking (cf. reference ``osc_params.py:266``)."""
    dm21 = jnp.asarray(dm21)
    dm31 = jnp.asarray(dm31)
    m0 = jnp.where(dm21 == 0.0, -DEGENERACY_DELTA, 0.0)
    m1 = dm21
    m2 = jnp.where(dm31 == 0.0, DEGENERACY_DELTA, dm31)
    m = jnp.stack([m0, m1, m2])
    return m[:, None] - m[None, :]


class OscParams:
    """Host-side oscillation-parameter container mirroring the reference
    ``OscParams`` API (angles set via theta or sin properties; matrices
    exposed as numpy arrays)."""

    def __init__(self):
        self.sin12 = 0.0
        self.sin13 = 0.0
        self.sin23 = 0.0
        self.deltacp = 0.0
        self.dm21 = 0.0
        self.dm31 = 0.0

    @property
    def theta12(self):
        return np.arcsin(self.sin12)

    @theta12.setter
    def theta12(self, value):
        self.sin12 = np.sin(value)

    @property
    def theta13(self):
        return np.arcsin(self.sin13)

    @theta13.setter
    def theta13(self, value):
        self.sin13 = np.sin(value)

    @property
    def theta23(self):
        return np.arcsin(self.sin23)

    @theta23.setter
    def theta23(self, value):
        self.sin23 = np.sin(value)

    @property
    def mix_matrix_complex(self):
        return pmns_matrix_complex(
            self.sin12, self.sin13, self.sin23, self.deltacp
        )

    @property
    def mix_matrix(self):
        m = self.mix_matrix_complex
        return np.stack([m.real, m.imag], axis=-1)

    @property
    def mix_matrix_reparam_complex(self):
        return pmns_matrix_complex(
            self.sin12, self.sin13, self.sin23, self.deltacp, reparam=True
        )

    @property
    def mix_matrix_reparam(self):
        m = self.mix_matrix_reparam_complex
        return np.stack([m.real, m.imag], axis=-1)

    @property
    def dm_matrix(self):
        return np.asarray(dm_matrix(self.dm21, self.dm31))
