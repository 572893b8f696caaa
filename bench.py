"""
Benchmark: compiled-template throughput and fit wall time of the flagship
IceCube 3-year oscillation pipeline on one NVIDIA GPU, plus the
oscillogram pipeline, the hypersurface fit and a toy Asimov fit.

Mirrors the reference's benchmark procedure
(``pisa/scripts/benchmark_pipeline_performance.py:35-46,196-223``): evaluate
N randomized-parameter templates, excluding the first (compile) call, and
report the mean rate.

Every leg runs in turn in this one process on the one card; every timing
ends in ``block_until_ready`` or a host transfer. Each metric is one JSON
line on stdout naming the card (``device_kind``) and its power limit; the
flagship templates/s line is printed again last. Exits nonzero when JAX
finds no GPU.

``vs_baseline`` divides by reference-PISA CPU rates, calibrated with the
numba-free transcription of the reference per-template algorithm
(benchmarks/reference_proxy.py, oscillation math pinned against this
framework's kernels at 1e-9) and scaled linearly to the reference CI
benchmark box's 4 vCPUs.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

CPU_BASELINE = {
    "icecube_3y": 0.655,  # templates/s (proxy: 6.10 s/template on 1 vCPU)
    "osc_example": 0.64,  # templates/s (osc-only proxy x 4)
    # per-bin scipy curve_fit over 13 datasets x 1152 non-empty bins,
    # fit-only wall, serial as the reference's loop is
    # (reference hypersurface.py:699)
    "hypersurface_fit_wall_s": 0.415,  # s
}
FLAGSHIP = "settings/pipeline/IceCube_3y_neutrinos.cfg"
N_TEMPLATES = 100
N_DISPATCH = 50
BATCH = 32


def card():
    """(device_kind, power limit) of the card; the limit read by
    nvidia-smi in a child that stays off JAX."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {dev.platform}")
    limit = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.splitlines()[0].strip()
    return dev.device_kind, limit


def emit(rec, device):
    rec = dict(rec, device_kind=device[0], power_limit=device[1])
    print(json.dumps(rec), flush=True)
    return rec


def log(msg):
    print(f"# {msg}", file=sys.stderr, flush=True)


def flagship_legs(device):
    import jax
    import jax.numpy as jnp

    from pisa_tpu.analysis import device_fit
    from pisa_tpu.core.pipeline import Pipeline
    from pisa_tpu.parallel import build_batched_objective

    t0 = time.perf_counter()
    ct = Pipeline(FLAGSHIP).compile()
    v0 = ct.current_rescaled_values()
    rng = np.random.RandomState(0)
    vecs = rng.uniform(0.05, 0.95, (N_TEMPLATES, len(v0))).astype(np.float32)

    # sequential randomized templates inside ONE device program (the
    # access pattern of the on-device fits)
    tots = np.asarray(ct.scan_totals(vecs))
    assert np.all(np.isfinite(tots)), "non-finite template totals"
    log(f"icecube_3y set-up + compile {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    np.asarray(ct.scan_totals(vecs + np.float32(1e-6)))
    rate = N_TEMPLATES / (time.perf_counter() - t0)
    headline = emit({
        "metric": "icecube_3y_templates_per_sec", "value": round(rate, 3),
        "unit": "templates/s",
        "vs_baseline": round(rate / CPU_BASELINE["icecube_3y"], 2),
    }, device)

    # one host round trip per template (the reference's wall-clock loop)
    fn = ct._build_fn()
    tot_fn = jax.jit(lambda v, data: sum(
        jnp.sum(h) for h in fn(v, data=data)["hist"].values()
    ))
    float(tot_fn(vecs[0], ct._data_vals))
    t0 = time.perf_counter()
    for v in vecs[:N_DISPATCH]:
        float(tot_fn(v, ct._data_vals))
    rate = N_DISPATCH / (time.perf_counter() - t0)
    emit({
        "metric": "icecube_3y_dispatch_loop_templates_per_sec",
        "value": round(rate, 3), "unit": "templates/s",
        "vs_baseline": round(rate / CPU_BASELINE["icecube_3y"], 2),
    }, device)

    # batched evaluation (scans, MCMC, pseudo-experiments)
    data = ct.get_outputs(v0)
    batched = build_batched_objective(ct, data, "mod_chi2")
    jax.block_until_ready(batched(vecs[:BATCH]))
    t0 = time.perf_counter()
    reps = 5
    for i in range(reps):
        out = batched(vecs[i:i + BATCH])
    jax.block_until_ready(out)
    rate = BATCH * reps / (time.perf_counter() - t0)
    emit({
        "metric": "icecube_3y_batched_templates_per_sec",
        "value": round(rate, 3), "unit": "templates/s",
        "vs_baseline": round(rate / CPU_BASELINE["icecube_3y"], 2),
    }, device)

    # objective value_and_grad
    value_fn, vg = ct.build_objective(data, "mod_chi2")
    jax.block_until_ready(vg(vecs[0]))
    t0 = time.perf_counter()
    for v in vecs:
        out = vg(v)
    jax.block_until_ready(out)
    emit({
        "metric": "icecube_3y_value_and_grad_ms",
        "value": round((time.perf_counter() - t0) / len(vecs) * 1e3, 4),
        "unit": "ms",
    }, device)

    # Asimov theta23 fit: bounded L-BFGS in one device program
    names = list(ct.free_names)
    x0 = np.asarray(v0, np.float64).copy()
    x0[names.index("theta23")] = min(0.95, x0[names.index("theta23")] + 0.1)
    los, his = ct._current_bounds()

    def fit():
        return device_fit.minimize_on_device(
            value_fn.raw, x0, los, his, ct._data_vals
        )

    fit()
    t0 = time.perf_counter()
    res = fit()
    emit({
        "metric": "asimov_flagship_fit_wall_s",
        "value": round(time.perf_counter() - t0, 4), "unit": "s",
        "device_lbfgs_iterations": int(res["nit"]),
    }, device)
    return headline


def osc_example_leg(device):
    from pisa_tpu.core.pipeline import Pipeline

    ct = Pipeline("settings/pipeline/osc_example.cfg").compile()
    n = 20
    vecs = np.random.RandomState(0).uniform(
        0.05, 0.95, (n, len(ct.current_rescaled_values()))
    ).astype(np.float32)
    np.asarray(ct.scan_totals(vecs))
    t0 = time.perf_counter()
    np.asarray(ct.scan_totals(vecs + np.float32(1e-6)))
    rate = n / (time.perf_counter() - t0)
    emit({
        "metric": "osc_example_templates_per_sec", "value": round(rate, 3),
        "unit": "templates/s",
        "vs_baseline": round(rate / CPU_BASELINE["osc_example"], 2),
    }, device)


def hypersurface_leg(device):
    """Vmapped Gauss-Newton over a 13-dataset, 3-systematic ensemble on
    the toy_flux pipeline (576 bins x 3 maps); keep the ensemble in sync
    with reference_proxy.HS_NOMINAL / HS_SYS_POINTS."""
    from pisa_tpu.core.pipeline import Pipeline
    from pisa_tpu.utils.hypersurface import fit_hypersurfaces_from_maps

    nominal = {"delta_index": 0.0, "theta23": 0.85, "aeff_scale": 1.0}
    points = [
        {"delta_index": -0.10, "theta23": 0.85, "aeff_scale": 1.0},
        {"delta_index": +0.10, "theta23": 0.85, "aeff_scale": 1.0},
        {"delta_index": 0.0, "theta23": 0.70, "aeff_scale": 1.0},
        {"delta_index": 0.0, "theta23": 0.95, "aeff_scale": 1.0},
        {"delta_index": 0.0, "theta23": 0.85, "aeff_scale": 0.8},
        {"delta_index": 0.0, "theta23": 0.85, "aeff_scale": 1.2},
        {"delta_index": -0.05, "theta23": 0.75, "aeff_scale": 0.9},
        {"delta_index": +0.05, "theta23": 0.90, "aeff_scale": 1.1},
        {"delta_index": -0.08, "theta23": 0.95, "aeff_scale": 1.15},
        {"delta_index": +0.08, "theta23": 0.72, "aeff_scale": 0.85},
        {"delta_index": +0.03, "theta23": 0.80, "aeff_scale": 0.95},
        {"delta_index": -0.03, "theta23": 0.92, "aeff_scale": 1.05},
    ]
    pipeline = Pipeline("settings/pipeline/toy_flux_fit.cfg")

    def mapset(pv):
        for name, value in pv.items():
            prm = pipeline.params[name]
            prm.value = value * prm.value.units
        return pipeline.get_outputs()

    kwargs = dict(
        nominal_mapset=mapset(nominal), nominal_param_values=nominal,
        sys_mapsets=[mapset(pv) for pv in points], sys_param_values=points,
        binning=pipeline.output_binning,
        params={k: "linear" for k in nominal}, norm=True,
        include_nominal=True,
    )
    fit_hypersurfaces_from_maps(**kwargs)
    t0 = time.perf_counter()
    fits = fit_hypersurfaces_from_maps(**kwargs)
    dt = time.perf_counter() - t0
    emit({
        "metric": "hypersurface_fit_wall_s", "value": round(dt, 4),
        "unit": "s",
        "vs_baseline": round(CPU_BASELINE["hypersurface_fit_wall_s"] / dt, 2),
        "n_bin_fits": sum(int(np.sum(h.fit_valid)) for h in fits.values()),
    }, device)


def toy_fit_leg(device):
    """Toy Asimov truth-recovery fit through the public Analysis "device"
    method."""
    from pisa_tpu.analysis.analysis import Analysis
    from pisa_tpu.core.distribution_maker import DistributionMaker

    hm = DistributionMaker(["settings/pipeline/toy_flux_fit.cfg"])
    for name, val in {"delta_index": 0.0, "theta23": 0.85,
                      "aeff_scale": 1.2}.items():
        hm.params[name].value = val
    data = hm.get_outputs(return_sum=True)
    hm.reset_free()

    def fit():
        hm.params["delta_index"].value = -0.05
        hm.params["theta23"].value = 0.95
        hm.params["aeff_scale"].value = 0.8
        return Analysis().fit_recursively(
            data, hm, "mod_chi2", None, "device", {}, None
        )

    fit()
    t0 = time.perf_counter()
    res = fit()
    emit({
        "metric": "asimov_toy_fit_wall_s",
        "value": round(time.perf_counter() - t0, 4), "unit": "s",
        "metric_val": float(res.metric_val),
    }, device)


def main():
    device = card()
    log(f"card: {device[0]}, power limit {device[1]}")
    headline = flagship_legs(device)
    osc_example_leg(device)
    hypersurface_leg(device)
    toy_fit_leg(device)
    print(json.dumps(headline), flush=True)


if __name__ == "__main__":
    main()
