#!/usr/bin/env python3
"""
Smoke test of the flagship analysis on NVIDIA GPUs.

    python chip_smoke.py               # one card
    python chip_smoke.py --devices 4   # the multi-device path on four cards

One card: runs the card-only test lane (``pytest -m gpu``) in a child
process before this process touches the card, then drives the IceCube
3-year analysis (``settings/pipeline/IceCube_3y_neutrinos.cfg``: 240k MC
events, 200x200 oscillation grid over PREM-12 chains, 15 free parameters)
at full size through the public API -- ``Pipeline`` and an eager
``get_outputs()``, ``pipeline.compile()``, ``build_objective`` and its
``value_and_grad``, an on-device L-BFGS fit, a 32-vector batched objective
-- and compares each result with a plain reference:

- the GPU template and objective gradient against the same compiled
  program run on this process's CPU backend (which takes the XLA
  oscillation formulation);
- the oscillation kernel's probabilities and tangents (reverse and forward
  mode) at the flagship grid against the XLA formulation in float64, and
  against the reference's float64 golden pickles.

``--devices 4`` runs only the multi-device path and what it is compared
with: the template and ``value_and_grad`` on ``CompiledTemplate.shard`` over
a 1-D ``data`` mesh of four cards against one card, and a trial-sharded
batched objective against the unsharded one.

Prints the card's name and power limit, set-up (compile) times,
``memory_analysis()`` of the template and gradient programs and
informational wall times, and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits nonzero, printing no such line, when a phase fails or JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import pickle
import re
import subprocess
import sys
import tempfile
import time
import warnings
import xml.etree.ElementTree as ET

ROOT = os.path.dirname(os.path.abspath(__file__))
CFG = "settings/pipeline/IceCube_3y_neutrinos.cfg"
THETA_FLAGSHIP = (0.5836, 0.1496, 0.8587, 0.0, 7.4e-5, 2.5e-3)

# Tolerances (float32 on the card). The contractions on the template and
# gradient path run in full fp32 (pisa_tpu sets the default matmul
# precision to "highest"); benchmarks/tf32_control.py runs the template and
# objective comparisons with every contraction in TF32 and shows which of
# these limits that breaks (readings in PERF.md). The probability checks
# involve no contraction.
# Template bins holding >= 1 expected event, GPU vs CPU backend: the two
# sides differ by oscillation formulation (kernel vs XLA, ~1e-5 absolute on
# probabilities) and by fp32 summation order over ~20k events per bin.
TEMPLATE_RTOL = 1e-4
# Objective value and gradient, GPU vs CPU: a sum of ~1k per-bin chi2
# terms; gradient entries are compared on the scale of the largest one
# because some entries are near-cancelling sums (fp32 reads ~4e-7).
OBJECTIVE_RTOL = 1e-4
GRADIENT_ATOL_REL = 2e-5
# Oscillation probabilities at the flagship grid, fp32 kernel vs the XLA
# formulation in float64: the chain product of up to 24 layer transitions
# in fp32 (the XLA formulation's own fp32 error there is ~4e-5).
PROB_ATOL = 1e-4
# Golden pickles, per case: 2e-5 absolute, or the reference's own fp32 vs
# fp64 spread for that case where larger (the 1000-Earth-diameter
# stability case, where fp32 phases lose ~1e-3).
GOLDEN_ATOL = 2e-5
# Tangents of a weighted probability sum (480k terms), per component.
TANGENT_RTOL = 1e-3
# The same tangents in forward vs reverse mode: the same per-component
# launches, summed over 480k terms in another order.
FORWARD_RTOL = 1e-4
# Batched (vmapped) vs sequential objective: the same program, fused and
# reduced in another order.
BATCHED_RTOL = 1e-5


def card_lines():
    """name, power.limit of each card, read by a child that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def run_gpu_lane():
    """The card-only pytest lane, in a child, before this process opens the
    card. Every selected test must pass; a skip means no card was found."""
    env = dict(os.environ)
    env.setdefault("JAX_PLATFORMS", "cuda,cpu")
    with tempfile.TemporaryDirectory() as tmp:
        xml_path = os.path.join(tmp, "gpu_lane.xml")
        rc = subprocess.run(
            [sys.executable, "-m", "pytest", "tests", "-m", "gpu", "-q",
             "-p", "no:cacheprovider", f"--junitxml={xml_path}"],
            cwd=ROOT, env=env, timeout=900,
        ).returncode
        suite = ET.parse(xml_path).getroot()
        suite = suite if suite.tag == "testsuite" else suite[0]
        counts = {k: int(suite.get(k, 0))
                  for k in ("tests", "failures", "errors", "skipped")}
    print(f"gpu test lane: rc={rc} {counts}", flush=True)
    if rc != 0 or counts["tests"] == 0 or counts["failures"] or (
        counts["errors"] or counts["skipped"]
    ):
        raise RuntimeError(f"gpu test lane failed: rc={rc} {counts}")


@contextlib.contextmanager
def phase(name):
    t0 = time.perf_counter()
    print(f"[{name}] ...", flush=True)
    yield
    print(f"[{name}] ok ({time.perf_counter() - t0:.1f} s)", flush=True)


def wall_ms(fn, *args, reps=20):
    """Mean wall time per call after a warm call, ending in
    block_until_ready."""
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps * 1e3


def print_memory(label, compiled):
    m = compiled.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    print(f"memory_analysis {label}: " + ", ".join(
        f"{f.replace('_size_in_bytes', '')}={getattr(m, f, 0) / 2**20:.1f} MiB"
        for f in fields), flush=True)


def hist_map(maps):
    import numpy as np

    return {m.name: np.asarray(m.hist, dtype=np.float64).ravel()
            for m in maps}


def compare_bins(label, got, ref, rtol):
    """Relative agreement on bins with >= 1 expected event; every bin
    finite."""
    import numpy as np

    worst = 0.0
    for name, r in ref.items():
        g = got[name]
        if g.shape != r.shape or not np.all(np.isfinite(g)):
            raise AssertionError(f"{label}: {name} shape/finite check")
        sel = r >= 1.0
        if sel.any():
            worst = max(worst, float(np.max(np.abs(g[sel] / r[sel] - 1))))
    print(f"{label}: max relative deviation {worst:.3e} (limit {rtol})",
          flush=True)
    if not worst <= rtol:
        raise AssertionError(f"{label}: {worst:.3e} > {rtol}")
    return worst


def objective_on(ct, data_maps, backend_device):
    """Value-and-gradient of the chi2 objective compiled for one device
    (the default device while tracing decides the oscillation path)."""
    import jax
    import jax.numpy as jnp

    value_fn, _ = ct.build_objective(data_maps, "mod_chi2")
    los, his = ct._current_bounds()
    data = jax.device_put(ct._data_vals, backend_device)
    vg = jax.jit(jax.value_and_grad(value_fn.raw))

    def run(v):
        # traced (on first call) and run with the device as default
        with jax.default_device(backend_device):
            return vg(jnp.asarray(v), jnp.asarray(los), jnp.asarray(his),
                      data)

    return run, value_fn


def flagship_grid(pipeline):
    """The oscillation stage's calc grid: energies and layer chains."""
    import numpy as np

    stage = [s for s in pipeline.stages if type(s).__name__ == "prob3"][0]
    c = stage.data.containers[0]
    rep = c.representation
    c.representation = stage.calc_mode
    try:
        return tuple(np.asarray(c[k], np.float32)
                     for k in ("true_energy", "densities", "distances"))
    finally:
        c.representation = rep


def check_kernels(pipeline, cpu):
    """The chain kernel compiled for the card vs float64 references at the
    flagship width, and vs the golden pickles."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from pisa_tpu.ops.cplx import C
    from pisa_tpu.ops.osc import pallas_chain as pc
    from pisa_tpu.ops.osc.kernels import osc_probs_layers
    from pisa_tpu.ops.osc.pmns import dm_matrix, pmns_matrix

    e, dens, dist = flagship_grid(pipeline)
    geom = {k: jnp.asarray(v)
            for k, v in pc.prepare_chain_geometry(e, dens, dist).items()}
    theta = jnp.asarray(THETA_FLAGSHIP, jnp.float32)
    rng = np.random.RandomState(0)
    w = rng.uniform(-1, 1, (2, 2, 3, e.size))

    def xla_planar(th, signs, e_, dens_, dist_, lri=None):
        mix = pmns_matrix(jnp.sin(th[0]), jnp.sin(th[1]), jnp.sin(th[2]),
                          th[3])
        dm = dm_matrix(th[4], th[5])
        zeros = np.zeros((3, 3))
        return jnp.stack([
            osc_probs_layers(
                dm, mix, C.of(np.diag([1.0, 0.0, 0.0])), C.of(zeros),
                zeros if lri is None else lri, s, e_, dens_, dist_,
            )[:, :2, :].transpose(1, 2, 0)
            for s in signs
        ])

    primal = jax.jit(lambda t, g: pc.osc_probs_planar(t, (1, -1), g))
    t0 = time.perf_counter()
    got = np.asarray(primal(theta, geom))
    print(f"kernel compile+first (primal): {time.perf_counter() - t0:.1f} s",
          flush=True)
    wj = jnp.asarray(w, jnp.float32)
    tangent = jax.jit(jax.grad(lambda t, g: jnp.sum(
        wj * pc.osc_probs_planar(t, (1, -1), g, active=(1, 2, 5)))))
    t0 = time.perf_counter()
    g_kernel = np.asarray(tangent(theta, geom))
    print(f"kernel compile+first (3 tangents): "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # forward mode (jax.jacfwd, as the Fisher matrix takes it) through the
    # same tangent launches
    forward = jax.jit(jax.jacfwd(lambda t, g: jnp.sum(
        wj * pc.osc_probs_planar(t, (1, -1), g, active=(1, 2, 5)))))
    g_fwd = np.asarray(forward(theta, geom))
    xla32 = np.asarray(jax.jit(
        lambda t: xla_planar(t, (1, -1), e, dens, dist))(theta))

    with jax.enable_x64(True), jax.default_device(cpu):
        th64 = jnp.asarray(THETA_FLAGSHIP, jnp.float64)
        args64 = [jnp.asarray(x, jnp.float64) for x in (e, dens, dist)]
        ref64 = np.asarray(jax.jit(
            lambda t: xla_planar(t, (1, -1), *args64))(th64))
        g_ref = np.asarray(jax.jit(jax.grad(lambda t: jnp.sum(
            jnp.asarray(w) * xla_planar(t, (1, -1), *args64))))(th64))

    err_k = float(np.abs(got - ref64).max())
    err_x = float(np.abs(xla32 - ref64).max())
    print(f"probabilities at the flagship grid ({e.size} points x 2 signs):"
          f" kernel fp32 vs XLA fp64 max abs {err_k:.2e}, XLA fp32 vs XLA"
          f" fp64 {err_x:.2e} (limit {PROB_ATOL})", flush=True)
    if not err_k <= PROB_ATOL:
        raise AssertionError(f"kernel probabilities off by {err_k:.2e}")
    rel = np.abs(g_kernel[[1, 2, 5]] / g_ref[[1, 2, 5]] - 1)
    print(f"tangents (theta13, theta23, dm31): kernel fp32 vs XLA fp64"
          f" reverse mode, relative {rel.max():.2e} (limit {TANGENT_RTOL});"
          f" inactive components {g_kernel[[0, 3, 4]].tolist()}", flush=True)
    if not (rel.max() <= TANGENT_RTOL and np.all(g_kernel[[0, 3, 4]] == 0)):
        raise AssertionError("kernel tangents disagree with the reference")
    d_fwd = float(np.abs(g_fwd - g_kernel).max() / np.abs(g_kernel).max())
    print(f"forward mode (jacfwd) vs reverse mode on the card: max deviation"
          f" {d_fwd:.2e} of max |g| (limit {FORWARD_RTOL})", flush=True)
    if not d_fwd <= FORWARD_RTOL:
        raise AssertionError("forward-mode derivatives disagree")

    # the reference's float64 golden pickles (cases whose physics the
    # kernel covers: no decay, standard matter potential)
    worst = 0.0  # error / limit, over the cases
    n_cases = 0
    for path in sorted(glob.glob(os.path.join(
        ROOT, "pisa_tpu/resources/osc/numba_osc_tests_data",
        "propagate_scalar__*__f8.pkl",
    ))):
        with open(path, "rb") as f, warnings.catch_warnings():
            warnings.simplefilter("ignore")
            d = pickle.load(f)
        mp = np.asarray(d["mat_pot"])
        if int(d["decay_flag"]) == 1 or not np.allclose(
            mp, np.diag([1.0, 0.0, 0.0])
        ):
            continue
        mix = np.asarray(d["mix"])
        s13 = abs(mix[0, 2])
        c13 = np.sqrt(1 - s13 ** 2)
        th = np.array([
            np.arcsin(abs(mix[0, 1]) / c13), np.arcsin(s13),
            np.arcsin(abs(mix[1, 2]) / c13), -np.angle(mix[0, 2]),
            d["dm"][1, 0], d["dm"][2, 0],
        ])
        rebuilt = pmns_matrix(*(np.sin(th[:3])), th[3])
        if not np.allclose(np.asarray(rebuilt.re) + 1j * np.asarray(
            rebuilt.im
        ), mix, atol=1e-6):
            raise AssertionError(f"{path}: PMNS angles not recovered")
        g1 = {k: jnp.asarray(v) for k, v in pc.prepare_chain_geometry(
            np.float32([d["energy"]]), np.float32(d["densities"])[None],
            np.float32(d["distances"])[None],
        ).items()}
        nubar = int(d["nubar"])
        p = np.asarray(pc.osc_probs_planar(
            jnp.asarray(th, jnp.float32), (nubar,), g1,
            lri_pot=d["lri_pot"],
        ))[0, :, :, 0]
        with open(path.replace("__f8.pkl", "__f4.pkl"), "rb") as f, \
                warnings.catch_warnings():
            warnings.simplefilter("ignore")
            spread = np.abs(
                np.asarray(pickle.load(f)["probability"]) - d["probability"]
            ).max()
        err = float(np.abs(p - d["probability"][:2]).max())
        worst = max(worst, err / max(GOLDEN_ATOL, spread))
        n_cases += 1
    print(f"golden pickles: {n_cases} cases, kernel fp32 vs reference fp64:"
          f" worst case at {worst:.2f} of its limit (limit {GOLDEN_ATOL} or"
          f" the reference's own fp32 spread)", flush=True)
    if n_cases < 5 or not worst <= 1.0:
        raise AssertionError("kernel disagrees with the golden pickles")


def template_phases(card, cpu):
    """Pipeline, eager and compiled template, and the template against the
    CPU backend. Returns (pipeline, compiled template, v0, v1, readings:
    the worst relative deviation of compiled vs eager and of GPU vs
    CPU)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pisa_tpu.core.pipeline import Pipeline

    with phase("pipeline + eager get_outputs"):
        pipeline = Pipeline(CFG)
        t0 = time.perf_counter()
        eager = hist_map(pipeline.get_outputs())
        print(f"eager template: {time.perf_counter() - t0:.1f} s"
              f" (first, includes compiles) on {card}", flush=True)
        print(f"maps: { {k: v.shape for k, v in eager.items()} }", flush=True)

    with phase("compiled template"):
        t0 = time.perf_counter()
        ct = pipeline.compile()
        v0 = ct.current_rescaled_values()
        compiled = hist_map(ct.get_outputs(v0))
        print(f"set-up: compile + first template "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        readings = {"compiled_vs_eager": compare_bins(
            "compiled vs eager (GPU)", compiled, eager, TEMPLATE_RTOL)}
        los, his = ct._current_bounds()
        targs = (jnp.asarray(v0), jnp.asarray(los), jnp.asarray(his),
                 ct._data_vals)
        exe = ct._jitted.lower(*targs).compile()
        print_memory("template", exe)
        shapes = kernel_shapes(exe.as_text())
        print(f"chain kernel launches (output shape): {shapes}", flush=True)
        if not shapes:
            raise AssertionError("template runs no chain kernel")
        print(f"template wall {wall_ms(ct._jitted, *targs):.3f} ms on {card}",
              flush=True)

    v1 = np.clip(v0 + 0.07 * np.sign(0.5 - v0), 0.05, 0.95)
    worst = 0.0
    with phase("template vs CPU backend"):
        fn_cpu = jax.jit(ct._build_fn())
        data_cpu = jax.device_put(ct._data_vals, cpu)
        for v in (v0, v1):
            got = ct(v)["hist"]
            # traced and run with the CPU as default device, which takes
            # the XLA oscillation formulation
            with jax.default_device(cpu):
                ref = fn_cpu(jnp.asarray(v), jnp.asarray(los),
                             jnp.asarray(his), data_cpu)["hist"]
            if {next(iter(x.devices())).platform
                    for x in (*got.values(), *ref.values())} != {"gpu",
                                                                 "cpu"}:
                raise AssertionError("template comparison ran on one backend")
            worst = max(worst, compare_bins(
                "template GPU vs CPU",
                {k: np.asarray(x, np.float64) for k, x in got.items()},
                {k: np.asarray(x, np.float64) for k, x in ref.items()},
                TEMPLATE_RTOL,
            ))
    readings["gpu_vs_cpu"] = worst
    return pipeline, ct, v0, v1, readings


def gradient_phase(card, ct, v0, v1, cpu):
    """value_and_grad of the chi2 objective on the card against the CPU
    backend. Returns (Asimov data maps, objective, relative objective
    deviation, gradient deviation on the scale of max |g|)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    data_maps = ct.get_outputs(v0)
    with phase("value_and_grad"):
        vg_gpu, value_fn = objective_on(ct, data_maps, jax.devices()[0])
        t0 = time.perf_counter()
        val, grad = jax.block_until_ready(vg_gpu(v1))
        print(f"set-up: value_and_grad compile + first "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        vg_cpu, _ = objective_on(ct, data_maps, cpu)
        val_c, grad_c = vg_cpu(v1)
        val, grad = float(val), np.asarray(grad, np.float64)
        val_c, grad_c = float(val_c), np.asarray(grad_c, np.float64)
        dv = abs(val / val_c - 1)
        dg = np.abs(grad - grad_c).max() / np.abs(grad_c).max()
        print(f"objective GPU {val:.6e} vs CPU {val_c:.6e} (relative"
              f" {dv:.2e}); gradient max deviation {dg:.2e} of max |g|"
              f" (limits {OBJECTIVE_RTOL}, {GRADIENT_ATOL_REL})", flush=True)
        if not (dv <= OBJECTIVE_RTOL and dg <= GRADIENT_ATOL_REL
                and np.all(np.isfinite(grad))):
            raise AssertionError("objective/gradient disagree with CPU")
        los, his = ct._current_bounds()
        gargs = (jnp.asarray(v1), jnp.asarray(los), jnp.asarray(his),
                 ct._data_vals)
        vg_jit = jax.jit(jax.value_and_grad(value_fn.raw))
        print_memory("value_and_grad", vg_jit.lower(*gargs).compile())
        print(f"value_and_grad wall {wall_ms(vg_jit, *gargs):.3f} ms"
              f" on {card}", flush=True)
    return data_maps, value_fn, dv, dg


def single_card(card):
    import jax
    import numpy as np

    from pisa_tpu.analysis import device_fit
    from pisa_tpu.parallel import build_batched_objective

    cpu = jax.devices("cpu")[0]
    pipeline, ct, v0, v1, _ = template_phases(card, cpu)
    data_maps, value_fn, _, _ = gradient_phase(card, ct, v0, v1, cpu)
    los, his = ct._current_bounds()

    with phase("on-device L-BFGS fit"):
        x0 = np.clip(v0 + 0.08, 0.02, 0.98)
        loss0 = float(value_fn(x0))
        t0 = time.perf_counter()
        res = device_fit.minimize_on_device(
            value_fn.raw, x0, los, his, ct._data_vals, max_steps=30,
        )
        fun, nit = float(res["fun"]), int(res["nit"])
        print(f"fit: {nit} iterations, loss {loss0:.4e} -> {fun:.4e}"
              f" ({time.perf_counter() - t0:.1f} s incl. compile)",
              flush=True)
        if not (nit >= 2 and np.isfinite(fun) and fun < loss0):
            raise AssertionError("on-device fit did not descend")
        t0 = time.perf_counter()
        device_fit.minimize_on_device(
            value_fn.raw, x0, los, his, ct._data_vals, max_steps=30,
        )
        print(f"fit wall (warm, {nit} iterations) "
              f"{time.perf_counter() - t0:.3f} s on {card}", flush=True)

    with phase("batched objective (32 vectors)"):
        vecs = np.random.RandomState(1).uniform(0.2, 0.8, (32, len(v0)))
        batched = build_batched_objective(ct, data_maps, "mod_chi2")
        t0 = time.perf_counter()
        vals = np.asarray(batched(vecs), np.float64)
        print(f"set-up: batched compile + first "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        seq = np.asarray([float(value_fn(v)) for v in vecs])
        dev = float(np.max(np.abs(vals / seq - 1)))
        print(f"batched vs sequential: max relative deviation {dev:.2e}"
              f" (limit {BATCHED_RTOL})", flush=True)
        if vals.shape != (32,) or not dev <= BATCHED_RTOL:
            raise AssertionError("batched objective disagrees")
        print(f"batched wall (32 vectors) "
              f"{wall_ms(batched, vecs, reps=5):.3f} ms on {card}",
              flush=True)

    with phase("oscillation kernel vs references"):
        check_kernels(pipeline, cpu)


_TRITON_CALL = re.compile(
    r"=\s*[a-z0-9]+\[([0-9,]+)\]\S*\s+custom-call\([^\n]*"
    r'custom_call_target="__gpu\$xla\.gpu\.triton"'
)


def kernel_shapes(hlo_text):
    """Output shape of every Triton kernel launch in a compiled program's
    HLO (for a sharded program, the shape each card runs); the last axis
    is the point axis."""
    return sorted(tuple(int(x) for x in m.group(1).split(","))
                  for m in _TRITON_CALL.finditer(hlo_text))


def check_spread(ct1, args1, ctn, argsn, n):
    """The sharded program runs every chain-kernel launch on 1/n of the
    points on each card, and each card holds under half the one-card
    template data."""
    import jax

    s1 = kernel_shapes(ct1._jitted.lower(*args1).compile().as_text())
    sn = kernel_shapes(ctn._jitted.lower(*argsn).compile().as_text())
    print(f"chain kernel launches (output shape): 1 card {s1}, each of"
          f" {n} cards {sn}", flush=True)
    if not s1 or sn != [s[:-1] + (s[-1] // n,) for s in s1] or any(
        s[-1] % n for s in s1
    ):
        raise AssertionError("kernel launches not split over the cards")
    total = sum(a.nbytes for a in ct1._data_vals)
    per = {}
    for a in ctn._data_vals:
        for sh in a.addressable_shards:
            per[sh.device.id] = per.get(sh.device.id, 0) + sh.data.nbytes
    print(f"template data per card (MiB): "
          f"{[round(per[k] / 2**20, 1) for k in sorted(per)]}, one card"
          f" {total / 2**20:.1f}", flush=True)
    if len(per) != n or max(per.values()) > total / 2:
        raise AssertionError("template data not spread over the cards")
    peaks = [d.memory_stats()["peak_bytes_in_use"] / 2**20
             for d in jax.devices()[:n]]
    print(f"peak device memory per card (MiB; card 0 also holds the"
          f" one-card reference): {[round(p) for p in peaks]}", flush=True)


def multi_card(card, n):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pisa_tpu.core.pipeline import Pipeline
    from pisa_tpu.parallel import build_batched_objective, default_mesh

    mesh = default_mesh(n)
    with phase(f"template on 1 card vs sharded over {n}"):
        ct1 = Pipeline(CFG).compile()
        t0 = time.perf_counter()
        ct4 = Pipeline(CFG).compile().shard(mesh)
        v0 = ct1.current_rescaled_values()
        v1 = np.clip(v0 + 0.07 * np.sign(0.5 - v0), 0.05, 0.95)
        out4 = ct4.get_outputs(v1)
        print(f"set-up: shard + compile + first "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        compare_bins(f"{n} cards vs 1", hist_map(out4),
                     hist_map(ct1.get_outputs(v1)), TEMPLATE_RTOL)
        los, his = ct4._current_bounds()
        args4 = (jnp.asarray(v1), jnp.asarray(los), jnp.asarray(his),
                 ct4._data_vals)
        args1 = (jnp.asarray(v1), jnp.asarray(los), jnp.asarray(his),
                 ct1._data_vals)
        check_spread(ct1, args1, ct4, args4, n)
        print(f"template wall: 1 card {wall_ms(ct1._jitted, *args1):.3f} ms,"
              f" {n} cards {wall_ms(ct4._jitted, *args4):.3f} ms on {card}",
              flush=True)

    with phase(f"value_and_grad on 1 card vs {n}"):
        data = ct1.get_outputs(v0)
        _, vg1 = ct1.build_objective(data, "mod_chi2")
        _, vg4 = ct4.build_objective(data, "mod_chi2")
        val1, g1 = vg1(v1)
        val4, g4 = vg4(v1)
        g1 = np.asarray(g1, np.float64)
        g4 = np.asarray(g4, np.float64)
        dg = np.abs(g4 - g1).max() / np.abs(g1).max()
        print(f"objective 1 card {float(val1):.6e} vs {n} {float(val4):.6e};"
              f" gradient max deviation {dg:.2e} of max |g|", flush=True)
        if not (abs(float(val4) / float(val1) - 1) <= OBJECTIVE_RTOL
                and dg <= GRADIENT_ATOL_REL):
            raise AssertionError("sharded objective disagrees")

    with phase(f"trial-sharded batched objective over {n} cards"):
        vecs = np.random.RandomState(1).uniform(0.2, 0.8, (32, len(v0)))
        b1 = build_batched_objective(ct1, data, "mod_chi2")
        bn = build_batched_objective(ct1, data, "mod_chi2", mesh=mesh)
        ref = np.asarray(b1(vecs), np.float64)
        got = bn(vecs)
        if len(got.sharding.device_set) != n:
            raise AssertionError("batched output not spread over the mesh")
        los1, his1 = ct1._current_bounds()
        bargs = (jnp.asarray(vecs), jnp.asarray(los1), jnp.asarray(his1),
                 ct1._data_vals)
        print(f"chain kernel launches (output shape): 1 card "
              f"{kernel_shapes(b1.jitted.lower(*bargs).compile().as_text())},"
              f" each of {n} cards "
              f"{kernel_shapes(bn.jitted.lower(*bargs).compile().as_text())}",
              flush=True)
        dev = float(np.max(np.abs(np.asarray(got, np.float64) / ref - 1)))
        print(f"trial-sharded vs one card: max relative deviation {dev:.2e}"
              f" (limit {BATCHED_RTOL})", flush=True)
        if not dev <= BATCHED_RTOL:
            raise AssertionError("trial-sharded batched objective disagrees")
        print(f"batched wall (32 vectors): 1 card "
              f"{wall_ms(b1, vecs, reps=5):.3f} ms, {n} cards "
              f"{wall_ms(bn, vecs, reps=5):.3f} ms on {card}", flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--devices", type=int, default=1, choices=(1, 4))
    args = parser.parse_args()

    cards = card_lines()
    for line in cards:
        print(f"card: {line}", flush=True)
    card = cards[0]
    if args.devices == 1:
        with phase("gpu test lane"):
            run_gpu_lane()

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"no GPU: JAX found {devices[0].platform}", file=sys.stderr)
        return 1
    if len(devices) < args.devices:
        print(f"need {args.devices} GPUs, JAX found {len(devices)}",
              file=sys.stderr)
        return 1
    print(f"device_kind: {devices[0].device_kind} x {len(devices)}",
          flush=True)
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    if args.devices == 1:
        single_card(card)
    else:
        multi_card(card, args.devices)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
