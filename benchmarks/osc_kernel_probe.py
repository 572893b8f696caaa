"""
Oscillation chain kernel vs the XLA formulation on one NVIDIA GPU.

In one process, at the flagship shapes (IceCube 3-year pipeline, 200x200
grid over PREM-12 chains, 15 free parameters), times in turns
(XLA, kernel, kernel, XLA):

- the compiled template (one evaluation, ending in block_until_ready);
- the objective's full value_and_grad;

and at the kernel level, the primal launch with both neutrino signs on one
grid against two single-sign launches, and one tangent launch.
``--sweep`` also times the primal and the 3-tangent gradient for a set of
(BLOCK, NUM_WARPS) settings.

Usage: python benchmarks/osc_kernel_probe.py [--reps 30] [--sweep]
Prints one JSON line per measurement and a table at the end; every line
names the card and its power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

CFG = "settings/pipeline/IceCube_3y_neutrinos.cfg"
SWEEP = [(32, 1), (64, 1), (64, 2), (128, 2), (128, 4)]


def wall_ms(fn, args, reps):
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps * 1e3


def build(use_kernel):
    """Compiled template + value_and_grad programs with the oscillation
    path forced, compiled while forced (programs trace on first call)."""
    import jax
    import jax.numpy as jnp

    from pisa_tpu.core.pipeline import Pipeline
    from pisa_tpu.stages.osc import prob3 as prob3_mod

    real = prob3_mod.use_chain_kernel
    if not use_kernel:
        prob3_mod.use_chain_kernel = lambda *a: False
    try:
        ct = Pipeline(CFG).compile()
        v0 = ct.current_rescaled_values()
        los, his = ct._current_bounds()
        v = jnp.asarray(np.clip(v0 + 0.05, 0.05, 0.95))
        targs = (v, jnp.asarray(los), jnp.asarray(his), ct._data_vals)
        value_fn, _ = ct.build_objective(ct.get_outputs(v0), "mod_chi2")
        vg = jax.jit(jax.value_and_grad(value_fn.raw))
        t0 = time.perf_counter()
        jax.block_until_ready(ct._jitted(*targs))
        t_tmpl = time.perf_counter() - t0
        t0 = time.perf_counter()
        jax.block_until_ready(vg(*targs))
        t_vg = time.perf_counter() - t0
    finally:
        prob3_mod.use_chain_kernel = real
    kernel_used = "osc_blk_e" in ct._trace_data.containers[0]
    assert kernel_used == use_kernel
    return dict(tmpl=ct._jitted, vg=vg, args=targs, compile_tmpl=t_tmpl,
                compile_vg=t_vg, ct=ct)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()

    limit = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.splitlines()[0].strip()

    import jax
    import jax.numpy as jnp

    from pisa_tpu.ops.osc import pallas_chain as pc

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU; JAX found {dev.platform}")
    tag = {"device_kind": dev.device_kind, "card": limit}
    rows = []

    def emit(**rec):
        rec.update(tag)
        rows.append(rec)
        print(json.dumps(rec), flush=True)

    progs = {"xla": build(False), "kernel": build(True)}
    for name, p in progs.items():
        emit(path=name, what="set-up: compile+first template s",
             value=round(p["compile_tmpl"], 2))
        emit(path=name, what="set-up: compile+first value_and_grad s",
             value=round(p["compile_vg"], 2))
    for name in ("xla", "kernel", "kernel", "xla"):
        p = progs[name]
        emit(path=name, what="template ms",
             value=round(wall_ms(p["tmpl"], p["args"], args.reps), 4))
        emit(path=name, what="value_and_grad ms",
             value=round(wall_ms(p["vg"], p["args"], args.reps), 4))

    # kernel level, at the flagship grid
    ct = progs["kernel"]["ct"]
    stage = [s for s in ct.pipeline.stages
             if type(s).__name__ == "prob3"][0]
    c = stage.data.containers[0]
    c.representation = stage.calc_mode
    e, dens, dist = (np.asarray(c[k], np.float32)
                     for k in ("true_energy", "densities", "distances"))
    theta = jnp.asarray([0.5836, 0.1496, 0.8587, 0.0, 7.4e-5, 2.5e-3],
                        jnp.float32)

    def kernel_fns():
        geom = {k: jnp.asarray(v) for k, v in pc.prepare_chain_geometry(
            e, dens, dist, block=pc.BLOCK).items()}
        both = jax.jit(lambda t, g: pc.osc_probs_planar(t, (1, -1), g))
        two = jax.jit(lambda t, g: [pc.osc_probs_planar(t, (s,), g)
                                    for s in (1, -1)])
        grad = jax.jit(jax.grad(lambda t, g: jnp.sum(pc.osc_probs_planar(
            t, (1, -1), g, active=(1, 2, 5)))))
        return geom, both, two, grad

    geom, both, two, grad = kernel_fns()
    emit(path="kernel", what="primal both signs, one launch ms",
         value=round(wall_ms(both, (theta, geom), args.reps * 10), 4))
    emit(path="kernel", what="primal, two single-sign launches ms",
         value=round(wall_ms(two, (theta, geom), args.reps * 10), 4))
    emit(path="kernel", what="primal + 3 tangents (grad) ms",
         value=round(wall_ms(grad, (theta, geom), args.reps * 10), 4))

    if args.sweep:
        for block, warps in SWEEP:
            pc.BLOCK, pc.NUM_WARPS = block, warps
            geom, both, _two, grad = kernel_fns()
            cfg = f"BLOCK={block} NUM_WARPS={warps}"
            emit(path="kernel", what=f"sweep {cfg} primal ms",
                 value=round(wall_ms(both, (theta, geom),
                                     args.reps * 10), 4))
            emit(path="kernel", what=f"sweep {cfg} grad ms",
                 value=round(wall_ms(grad, (theta, geom),
                                     args.reps * 10), 4))

    print(f"\n{dev.device_kind} ({limit})", file=sys.stderr)
    for r in rows:
        print(f"{r['path']:7s} {r['what']:55s} {r['value']}",
              file=sys.stderr)


if __name__ == "__main__":
    main()
