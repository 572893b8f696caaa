"""
pisa_tpu — a JAX/XLA/Pallas framework for binned statistical inference on
neutrino-oscillation measurements via Monte-Carlo reweighting.

Provides the capabilities of IceCube's PISA (reference ``pisa/__init__.py``)
redesigned for accelerators: each analysis pipeline compiles to a single
jit-compiled, differentiable ``params -> MapSet`` function.

Global runtime configuration (cf. reference ``pisa/__init__.py:50-82``):

- ``FTYPE``/``CTYPE``/``ITYPE``: float/complex/int dtypes selected once at
  import via the ``PISA_TPU_FTYPE`` env var (``fp32``/``fp64``; ``fp64``
  enables JAX x64 globally). Accelerator runs use fp32; fp64 is used for
  CPU-side golden-parity tests.
- ``HASH_SIGFIGS``: significant figures used when normalizing quantities for
  hashing (12 for fp64, 5 for fp32 — matches reference
  ``pisa/__init__.py:277-283``).
- ``EPSILON``: comparison tolerance derived from HASH_SIGFIGS.
- ``CACHE_DIR``: on-disk cache location for generated test files.
- float32 contractions run at full precision everywhere: importing the
  package sets ``jax_default_matmul_precision="highest"`` (no TF32).
- ``COMPILATION_CACHE_DIR``: the persistent XLA compilation cache
  (``JAX_COMPILATION_CACHE_DIR`` when set, else ``.jax_cache`` in a source
  checkout, else None: an installed package sets no cache).
- ``ureg``/``Q_``: unit registry (minimal pint-compatible implementation in
  ``pisa_tpu.units``).
"""

import os

import numpy as np

__all__ = [
    "__version__",
    "FTYPE",
    "CTYPE",
    "ITYPE",
    "FTYPE_NAME",
    "HASH_SIGFIGS",
    "EPSILON",
    "CACHE_DIR",
    "COMPILATION_CACHE_DIR",
    "PISA_TPU_NUM_DEVICES",
    "ureg",
    "Q_",
]

__version__ = "0.1.0"

# ---------------------------------------------------------------------------
# Float-type policy. Must run BEFORE the first `import jax` triggers backend
# initialization, since x64 must be enabled globally.
# ---------------------------------------------------------------------------
_ftype_env = os.environ.get("PISA_TPU_FTYPE", "fp32").strip().lower()
if _ftype_env in ("fp64", "float64", "double", "64"):
    FTYPE_NAME = "fp64"
    FTYPE = np.float64
    CTYPE = np.complex128
    ITYPE = np.int64
    HASH_SIGFIGS = 12
    import jax

    jax.config.update("jax_enable_x64", True)
elif _ftype_env in ("fp32", "float32", "single", "32"):
    FTYPE_NAME = "fp32"
    FTYPE = np.float32
    CTYPE = np.complex64
    ITYPE = np.int32
    HASH_SIGFIGS = 5
else:
    raise ValueError(
        f"Invalid PISA_TPU_FTYPE={_ftype_env!r}; expected 'fp32' or 'fp64'"
    )

EPSILON = 10 ** -HASH_SIGFIGS

# Number of (virtual) devices to target for sharded evaluation; actual mesh
# construction happens lazily in pisa_tpu.parallel.
PISA_TPU_NUM_DEVICES = int(os.environ.get("PISA_TPU_NUM_DEVICES", "0"))

CACHE_DIR = os.environ.get(
    "PISA_TPU_CACHE_DIR",
    os.path.join(
        os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache")),
        "pisa_tpu",
    ),
)

# Float32 contractions run at full fp32 precision on every backend: on a
# GPU a float32 matmul/einsum would otherwise run in TF32 (about three
# decimal digits), which the histogram, translation and oscillation
# contractions cannot afford.
import jax as _jax  # noqa: E402

_jax.config.update("jax_default_matmul_precision", "highest")

# Persistent XLA compilation cache (cf. reference CACHE_DIR holding numba's
# compiled-function disk cache, ``pisa/__init__.py:96-120``): repeat runs of
# bench/tests/fits skip recompiles of the big template programs. Where
# JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and no other
# directory is set here. Otherwise, when the package sits in a source
# checkout (pyproject.toml beside it), the cache lives at one fixed path
# inside that checkout, so every process run from it finds the same
# entries; an installed package keeps JAX's own default (no cache).
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMPILATION_CACHE_DIR = os.environ.get("JAX_COMPILATION_CACHE_DIR") or (
    os.path.join(_CHECKOUT, ".jax_cache")
    if os.path.isfile(os.path.join(_CHECKOUT, "pyproject.toml"))
    else None
)
if COMPILATION_CACHE_DIR and os.environ.get(
    "PISA_TPU_COMPILATION_CACHE", "1"
) not in ("0", "off"):
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        _jax.config.update("jax_compilation_cache_dir", COMPILATION_CACHE_DIR)
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    _jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

from pisa_tpu.units import ureg, Quantity as Q_  # noqa: E402
