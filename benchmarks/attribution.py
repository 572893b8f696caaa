"""
Per-stage cost attribution for the flagship compiled template.

Builds truncated templates (stages[:k] for k = 1..n) and reports, per
truncation, XLA's cost model (flops / bytes accessed) and the measured
in-device per-template wall-clock (20 sequential templates in one
``lax.scan`` program, first call excluded). Successive deltas attribute
the roofline totals (benchmarks/roofline.py) to individual stages — the
answer to the reference's per-stage ``report_profile`` breakdown
(``pisa/core/pipeline.py:148-187``).

Usage: python benchmarks/attribution.py [--cfg ...] [--scan 20]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--cfg", default="settings/pipeline/IceCube_3y_neutrinos.cfg"
    )
    ap.add_argument("--scan", type=int, default=20)
    ap.add_argument(
        "--no-time", action="store_true",
        help="cost-analysis only (skip the in-device scan timing programs;"
        " ~half the compiles)",
    )
    ap.add_argument(
        "--ks", default=None,
        help="comma-separated truncation lengths to run (default: all)",
    )
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from pisa_tpu.core.pipeline import Pipeline
    from pisa_tpu.units import Quantity

    t0 = time.time()
    pipeline = Pipeline(args.cfg)
    ct = pipeline.compile()
    v0 = jnp.asarray(ct.current_rescaled_values())
    los, his = ct._current_bounds()
    los, his = jnp.asarray(los), jnp.asarray(his)
    data = ct._data_vals
    print(
        f"# setup {time.time()-t0:.1f}s; platform={jax.default_backend()}",
        file=sys.stderr,
    )

    # label/truncate over the TRACED stage chain (free-param-independent
    # prefix stages are hoisted out of the per-template program and do not
    # contribute to its cost)
    stage_names = [
        f"{s.stage_name}.{s.service_name}" for s in ct._traced_stages
    ]

    def truncated_fn(k):
        # mirror CompiledTemplate._build_fn: run the TRACED (stacked)
        # stage chain on the trace containers, truncated to the first k
        # stages, and reduce whatever weights exist at that point
        traced_stages = list(ct._traced_stages)

        def fn(vec, los, his, data):
            mags = ct._magnitudes_from_rescaled(vec, los, his)
            snapshot = ct._snapshot()
            saved = [p._value for p in ct._free_params]
            for s in pipeline.stages:
                s._trace_mode = True
            swapped = ct._trace_data is not pipeline.data
            if swapped:
                for s in traced_stages:
                    s.data = ct._trace_data
            try:
                for (c, key, h), arr in zip(ct._data_slots, data):
                    if key is None:
                        c._flatidx[h] = arr
                    else:
                        c._data[key][h] = arr
                for p, mag in zip(ct._free_params, mags):
                    p._value = Quantity(mag, p.units)
                for s in traced_stages[:k]:
                    s.run()
                tot = jnp.zeros(())
                for c in ct._trace_data.containers:
                    if "weights" in c.keys:
                        tot = tot + jnp.sum(
                            jnp.asarray(c["weights"])
                        ).astype(tot.dtype)
                return tot
            finally:
                for p, v in zip(ct._free_params, saved):
                    p._value = v
                for s in pipeline.stages:
                    s._trace_mode = False
                if swapped:
                    for s in traced_stages:
                        s.data = pipeline.data
                ct._restore(snapshot)

        return fn

    rng = np.random.RandomState(0)
    vecs = jnp.asarray(
        rng.uniform(0.05, 0.95, size=(args.scan, v0.shape[0])),
        dtype=jnp.float32,
    )

    ks = (
        [int(x) for x in args.ks.split(",")]
        if args.ks
        else list(range(1, len(ct._traced_stages) + 1))
    )
    rows = []
    for k in ks:
        fn = truncated_fn(k)

        def scan_prog(vecs, los, his, data, fn=fn):
            def step(c, v):
                return c, fn(v, los, his, data)

            _, tots = jax.lax.scan(step, jnp.zeros(()), vecs)
            return tots

        # cost model from the SINGLE-template program (the scan program's
        # cost analysis does not multiply the loop body by trip count)
        single = jax.jit(fn).lower(v0, los, his, data).compile()
        ca = single.cost_analysis()
        if isinstance(ca, (list, tuple)):
            ca = ca[0]
        flops = float(ca.get("flops", 0.0))
        byt = float(ca.get("bytes accessed", 0.0))

        if args.no_time:
            per_t = float("nan")
        else:
            scomp = (
                jax.jit(scan_prog).lower(vecs, los, his, data).compile()
            )
            out = scomp(vecs, los, his, data)
            np.asarray(out)  # sync
            t1 = time.time()
            reps = 3
            for _ in range(reps):
                np.asarray(scomp(vecs, los, his, data))
            per_t = (time.time() - t1) / reps / args.scan
        rows.append(
            dict(
                upto=stage_names[k - 1],
                ms=per_t * 1e3,
                gflops=flops / 1e9,
                gbytes=byt / 1e9,
            )
        )
        print(
            f"# upto {stage_names[k-1]:32s} {per_t*1e3:7.3f} ms/t "
            f"{flops/1e9:8.3f} GFLOP  {byt/1e9:8.3f} GB",
            file=sys.stderr,
        )

    print("\n| stages up to | ms/template | Δms | GFLOP | ΔGFLOP | GB accessed | ΔGB |")
    print("|---|---|---|---|---|---|---|")
    prev = dict(ms=0.0, gflops=0.0, gbytes=0.0)
    for r in rows:
        print(
            f"| {r['upto']} | {r['ms']:.3f} | {r['ms']-prev['ms']:+.3f} "
            f"| {r['gflops']:.3f} | {r['gflops']-prev['gflops']:+.3f} "
            f"| {r['gbytes']:.3f} | {r['gbytes']-prev['gbytes']:+.3f} |"
        )
        prev = r


if __name__ == "__main__":
    main()
