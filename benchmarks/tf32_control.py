"""
Control run for the tolerances of ``chip_smoke.py``: are they tight enough
that TF32 would fail them?

    PYTHONPATH=. python benchmarks/tf32_control.py

Runs the smoke's template and objective phases on one GPU (eager and
compiled flagship template, the template against the CPU backend, the
objective's value_and_grad against the CPU backend) with every float32
contraction on the card in TF32: the default matmul precision, and the
sites that ask for full precision explicitly (they read
``jax.lax.Precision.HIGHEST`` when traced). Every limit is opened so each
comparison prints its reading; at the end the readings are set beside the
smoke's limits. Exits nonzero if TF32 is not in effect on the card or if
it breaks none of the limits.
"""

from __future__ import annotations

import json
import sys

import chip_smoke as cs


def main():
    card = cs.card_lines()[0]
    import jax
    import jax.numpy as jnp
    import numpy as np

    import pisa_tpu  # noqa: F401  (sets "highest"; overridden below)

    if jax.devices()[0].platform != "gpu":
        raise SystemExit("needs a GPU")
    high = jax.lax.Precision.HIGH  # what JAX calls "tensorfloat32"
    a = jax.random.normal(jax.random.PRNGKey(0), (1024, 1024), jnp.float32)
    tf32_err = float(jnp.max(jnp.abs(
        jnp.matmul(a, a, precision=high)
        - jnp.matmul(a, a, precision=jax.lax.Precision.HIGHEST)
    )) / jnp.max(jnp.abs(a @ a)))
    print(f"TF32 in effect: 1024^2 matmul, HIGH vs HIGHEST max deviation"
          f" {tf32_err:.2e} of max |c| on {card}", flush=True)
    if not tf32_err > 1e-5:
        raise SystemExit("Precision.HIGH does not run in TF32 here")

    jax.config.update("jax_default_matmul_precision", "tensorfloat32")

    class _TF32Precision:
        DEFAULT = HIGH = HIGHEST = high

    jax.lax.Precision = _TF32Precision

    limits = dict(compiled_vs_eager=cs.TEMPLATE_RTOL,
                  gpu_vs_cpu=cs.TEMPLATE_RTOL, objective=cs.OBJECTIVE_RTOL,
                  gradient=cs.GRADIENT_ATOL_REL)
    cs.TEMPLATE_RTOL = cs.OBJECTIVE_RTOL = cs.GRADIENT_ATOL_REL = np.inf
    cpu = jax.devices("cpu")[0]
    _, ct, v0, v1, readings = cs.template_phases(card, cpu)
    _, _, dv, dg = cs.gradient_phase(card, ct, v0, v1, cpu)
    readings.update(objective=dv, gradient=dg)
    broken = [k for k in readings if not readings[k] <= limits[k]]
    print(json.dumps({"card": card, "precision": "tensorfloat32",
                      "readings": readings, "limits": limits,
                      "broken": broken}), flush=True)
    return 0 if broken else 1


if __name__ == "__main__":
    sys.exit(main())
