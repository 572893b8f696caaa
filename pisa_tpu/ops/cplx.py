"""
Complex arithmetic on split (re, im) real arrays.

Every complex computation in the framework — most importantly the 3x3
oscillation algebra — is expressed over a :class:`C` pair of real arrays,
so the same code runs in XLA formulations and inside Pallas kernels (which
take real arrays only), in fp32 and fp64 alike. As a NamedTuple, ``C`` is automatically a
JAX pytree, so it flows through jit/vmap/scan/grad transparently; XLA fuses
the split arithmetic exactly as it would have lowered native complex ops.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

import jax.numpy as jnp

__all__ = ["C", "cplx", "to_numpy"]


class C(NamedTuple):
    """A complex value/array as (real, imag) parts."""

    re: jnp.ndarray
    im: jnp.ndarray

    # keep numpy scalars/arrays from absorbing C as a sequence; forces
    # np_scalar * C to dispatch to C.__rmul__
    __array_ufunc__ = None

    # -- construction -------------------------------------------------------
    @staticmethod
    def of(z):
        """From a (numpy/jax) complex or real array. Complex numpy inputs are
        split on the host, so complex dtypes never reach the device."""
        if isinstance(z, C):
            return z
        if isinstance(z, (np.ndarray, np.generic, complex)) and np.iscomplexobj(z):
            z = np.asarray(z)
            return C(jnp.asarray(z.real.copy()), jnp.asarray(z.imag.copy()))
        z = jnp.asarray(z)
        if jnp.iscomplexobj(z):
            return C(jnp.real(z), jnp.imag(z))
        return C(z, jnp.zeros_like(z))

    @staticmethod
    def zeros(shape, dtype=None):
        return C(jnp.zeros(shape, dtype=dtype), jnp.zeros(shape, dtype=dtype))

    @staticmethod
    def eye(n, dtype=None, batch_shape=()):
        e = jnp.broadcast_to(jnp.eye(n, dtype=dtype), batch_shape + (n, n))
        return C(e, jnp.zeros_like(e))

    # -- arithmetic ----------------------------------------------------------
    def __add__(self, o):
        o = C.of(o)
        return C(self.re + o.re, self.im + o.im)

    __radd__ = __add__

    def __sub__(self, o):
        o = C.of(o)
        return C(self.re - o.re, self.im - o.im)

    def __rsub__(self, o):
        return C.of(o) - self

    def __mul__(self, o):
        if isinstance(o, C):
            return C(
                self.re * o.re - self.im * o.im,
                self.re * o.im + self.im * o.re,
            )
        o = jnp.asarray(o)
        return C(self.re * o, self.im * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, C):
            d = o.re * o.re + o.im * o.im
            return C(
                (self.re * o.re + self.im * o.im) / d,
                (self.im * o.re - self.re * o.im) / d,
            )
        o = jnp.asarray(o)
        return C(self.re / o, self.im / o)

    def __rtruediv__(self, o):
        return C.of(o) / self

    def __neg__(self):
        return C(-self.re, -self.im)

    def conj(self):
        return C(self.re, -self.im)

    def abs2(self):
        return self.re * self.re + self.im * self.im

    def abs(self):
        return jnp.sqrt(self.abs2())

    def angle(self):
        return jnp.arctan2(self.im, self.re)

    # -- linear algebra (last two axes) --------------------------------------
    def matmul(self, o):
        """Batched matrix product over the last two axes.

        Always full precision: a float32 matmul on a GPU may otherwise run
        in TF32 (about three decimal digits), which is catastrophic for
        chained 3x3 transition products."""
        import jax

        o = C.of(o)
        hi = jax.lax.Precision.HIGHEST
        rr = jnp.matmul(self.re, o.re, precision=hi)
        ii = jnp.matmul(self.im, o.im, precision=hi)
        ri = jnp.matmul(self.re, o.im, precision=hi)
        ir = jnp.matmul(self.im, o.re, precision=hi)
        return C(rr - ii, ri + ir)

    __matmul__ = matmul

    def conj_T(self):
        """Conjugate transpose over the last two axes."""
        return C(
            jnp.swapaxes(self.re, -1, -2), -jnp.swapaxes(self.im, -1, -2)
        )

    def T(self):
        return C(jnp.swapaxes(self.re, -1, -2), jnp.swapaxes(self.im, -1, -2))

    # -- elementary functions -------------------------------------------------
    def exp(self):
        """exp(x + iy) = e^x (cos y + i sin y)."""
        ex = jnp.exp(self.re)
        return C(ex * jnp.cos(self.im), ex * jnp.sin(self.im))

    def sqrt(self):
        """Principal square root via the stable half-angle identity."""
        r = self.abs()
        re = jnp.sqrt(jnp.maximum((r + self.re) / 2.0, 0.0))
        im_mag = jnp.sqrt(jnp.maximum((r - self.re) / 2.0, 0.0))
        im = jnp.where(self.im < 0, -im_mag, im_mag)
        return C(re, im)

    def cbrt(self):
        """Principal cube root via polar form."""
        r = self.abs()
        theta = self.angle() / 3.0
        m = jnp.cbrt(r)
        return C(m * jnp.cos(theta), m * jnp.sin(theta))

    def at_get(self, idx):
        """Array-style indexing into both parts. (Plain ``c[i]`` keeps
        NamedTuple field semantics; always use ``at_get`` for slicing.)"""
        return C(self.re[idx], self.im[idx])

    @property
    def shape(self):
        return jnp.shape(self.re)

    @property
    def dtype(self):
        return jnp.asarray(self.re).dtype


def cplx(re, im=None):
    """Construct a C from parts or a complex array."""
    if im is None:
        return C.of(re)
    return C(jnp.asarray(re), jnp.asarray(im))


def to_numpy(c: C) -> np.ndarray:
    """Materialize as a host numpy complex array."""
    return np.asarray(c.re) + 1j * np.asarray(c.im)
