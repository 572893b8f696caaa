"""
Roofline / MFU accounting for the flagship compiled template.

For each flagship program variant (single template, in-device sequential
scan step, batched vmap step, value_and_grad) this script reports

  - XLA's own cost model for the compiled program
    (``jax.stages.Compiled.cost_analysis()``: ``flops``,
    ``bytes accessed`` and per-memory-space breakdowns),
  - measured wall-clock per template on the current backend,
  - achieved FLOP/s and HBM GB/s as a fraction of the chip's peaks,

so the perf story is anchored to the hardware roof rather than only to
templates/s (cf. reference benchmark procedure
``pisa/scripts/benchmark_pipeline_performance.py:196-223``, which reports
wall-clock only).

Peaks are looked up by ``device_kind`` in ``PEAKS`` (an unknown device
is an error). The template is float32 elementwise, gather and reduction
work, so the compute roof is the float32 rate outside the tensor cores.
XLA's cost model does not see inside Pallas kernels (the oscillation
chain kernel counts as zero FLOPs), so achieved FLOP/s is a lower bound.

Usage:  python benchmarks/roofline.py [--templates 100] [--batch 32]
Output: one markdown table on stdout + one JSON line per program on stderr.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

# device_kind -> (float32 FLOP/s outside the tensor cores, memory bytes/s);
# NVIDIA H100 data sheet, dense rates, at the full power limit
PEAKS = {
    "NVIDIA H100 80GB HBM3": (67e12, 3.35e12),  # SXM5
    "NVIDIA H100 PCIe": (51e12, 2.0e12),
}


def _cost(compiled):
    ca = compiled.cost_analysis()
    if isinstance(ca, (list, tuple)):  # older jax returns [dict]
        ca = ca[0]
    flops = float(ca.get("flops", 0.0))
    by = float(ca.get("bytes accessed", 0.0))
    # operand/output HBM traffic when the breakdown is present (space 0 =
    # default memory space = device memory)
    hbm = ca.get("bytes accessed0{}", None)
    return flops, by, (float(hbm) if hbm is not None else by), ca


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--templates", type=int, default=100)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument(
        "--cfg", default="settings/pipeline/IceCube_3y_neutrinos.cfg"
    )
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from pisa_tpu.core.pipeline import Pipeline

    kind = jax.devices()[0].device_kind
    if kind not in PEAKS:
        raise SystemExit(f"no peak rates for device_kind {kind!r}; add them"
                         " to PEAKS with their source")
    peak_f, peak_b = PEAKS[kind]
    platform = f"{jax.default_backend()} ({kind})"

    t0 = time.time()
    pipeline = Pipeline(args.cfg)
    ct = pipeline.compile()
    v0 = jnp.asarray(ct.current_rescaled_values())
    los, his = ct._current_bounds()
    los, his = jnp.asarray(los), jnp.asarray(his)
    data = ct._data_vals
    n_free = int(v0.shape[0])
    print(
        f"# setup {time.time()-t0:.1f}s; platform={platform}; "
        f"{n_free} free params",
        file=sys.stderr,
    )

    fn = ct._build_fn()

    def single(v, los, his, data):
        out = fn(v, los, his, data=data)
        return sum(jnp.sum(h) for h in out["hist"].values())

    def scan_prog(vecs, los, his, data):
        def step(c, v):
            return c, single(v, los, his, data)

        _, tots = jax.lax.scan(step, jnp.zeros(()), vecs)
        return tots

    def batch_prog(vb, los, his, data):
        return jax.vmap(single, in_axes=(0, None, None, None))(
            vb, los, his, data
        )

    # value_and_grad of a mod_chi2 objective against the nominal template
    data_ms = ct.get_outputs(np.asarray(v0))
    _value_fn, value_and_grad = ct.build_objective(data_ms, "mod_chi2")

    rng = np.random.RandomState(0)
    vecs = jnp.asarray(
        rng.uniform(0.05, 0.95, size=(args.templates, n_free)),
        dtype=jnp.float32,
    )
    vb = jnp.asarray(vecs[: args.batch])

    rows = []

    def measure(name, jitted, call_args, n_templates, reps=3):
        lowered = jitted.lower(*call_args)
        compiled = lowered.compile()
        flops, by, hbm, ca = _cost(compiled)
        out = compiled(*call_args)  # warm (excluded, as the reference does)
        jax.block_until_ready(out)
        t0 = time.time()
        for _ in range(reps):
            out = compiled(*call_args)
        jax.block_until_ready(out)
        dt = (time.time() - t0) / reps
        per_template = dt / n_templates
        rows.append(
            {
                "program": name,
                "templates_per_call": n_templates,
                "wall_s_per_call": dt,
                "ms_per_template": per_template * 1e3,
                "gflops_per_template": flops / n_templates / 1e9,
                "mbytes_per_template": by / n_templates / 1e6,
                "achieved_tflops": flops / dt / 1e12,
                "achieved_gbs": by / dt / 1e9,
                "pct_peak_flops": 100.0 * flops / dt / peak_f,
                "pct_peak_hbm": 100.0 * by / dt / peak_b,
            }
        )
        print(json.dumps(rows[-1]), file=sys.stderr)
        return compiled

    measure(
        "single_template",
        jax.jit(single),
        (v0, los, his, data),
        1,
        reps=10,
    )
    measure(
        f"indevice_scan[{args.templates}]",
        jax.jit(scan_prog),
        (vecs, los, his, data),
        args.templates,
    )
    measure(
        f"batched_vmap[{args.batch}]",
        jax.jit(batch_prog),
        (vb, los, his, data),
        args.batch,
    )

    # value_and_grad via the library path (already jitted inside)
    v, g = value_and_grad(np.asarray(v0))
    jax.block_until_ready((v, g))
    t0 = time.time()
    reps = 5
    for _ in range(reps):
        v, g = value_and_grad(np.asarray(v0))
        float(v)
    dt = (time.time() - t0) / reps
    # cost analysis of the same program through the cached jit
    from pisa_tpu.utils.log import logging  # noqa: F401

    vg_row = {
        "program": "value_and_grad(mod_chi2)",
        "templates_per_call": 1,
        "wall_s_per_call": dt,
        "ms_per_template": dt * 1e3,
    }
    rows.append(vg_row)
    print(json.dumps(vg_row), file=sys.stderr)

    # markdown table
    cols = [
        ("program", "program"),
        ("ms_per_template", "ms/template"),
        ("gflops_per_template", "GFLOP/templ"),
        ("mbytes_per_template", "MB/templ"),
        ("achieved_tflops", "TFLOP/s"),
        ("achieved_gbs", "GB/s"),
        ("pct_peak_flops", "% peak FLOP"),
        ("pct_peak_hbm", "% peak HBM"),
    ]
    print(f"\n## Roofline ({platform}; peaks {peak_f/1e12:.0f} TFLOP/s "
          f"fp32, {peak_b/1e9:.0f} GB/s HBM)\n")
    print("| " + " | ".join(h for _, h in cols) + " |")
    print("|" + "---|" * len(cols))
    for r in rows:
        cells = []
        for k, _ in cols:
            v = r.get(k)
            cells.append(
                v if isinstance(v, str) else
                ("" if v is None else f"{v:.3g}")
            )
        print("| " + " | ".join(cells) + " |")


if __name__ == "__main__":
    main()
