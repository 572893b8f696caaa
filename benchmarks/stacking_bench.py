"""Measure the container-stacking effect on the flagship template and its
gradient, on whatever backend JAX selects (run on the GPU for the numbers of
record). Usage: python benchmarks/stacking_bench.py [--no-stack]"""

import os
import sys
import time

import numpy as np


def main():
    stack = "--no-stack" not in sys.argv
    os.environ["PISA_TPU_STACK"] = "1" if stack else "0"

    import jax

    from pisa_tpu.core.pipeline import Pipeline

    t0 = time.time()
    pipeline = Pipeline("settings/pipeline/IceCube_3y_neutrinos.cfg")
    ct = pipeline.compile()
    stacked = ct._trace_data is not ct.pipeline.data
    print(
        f"backend={jax.default_backend()} stacked={stacked}"
        f" setup={time.time()-t0:.1f}s",
        flush=True,
    )

    v0 = ct.current_rescaled_values()
    n_free = len(v0)
    rng = np.random.RandomState(0)
    n_scan = 64
    vecs = rng.uniform(0.05, 0.95, size=(n_scan, n_free)).astype(np.float32)

    # in-device sequential scan (headline access pattern)
    t0 = time.time()
    tots = np.asarray(ct.scan_totals(vecs))
    print(f"scan compile+first: {time.time()-t0:.1f}s", flush=True)
    assert np.all(np.isfinite(tots))
    reps = 3
    t0 = time.time()
    for i in range(reps):
        np.asarray(ct.scan_totals(vecs + np.float32((i + 1) * 1e-6)))
    per = (time.time() - t0) / (n_scan * reps)
    print(
        f"in-device scan: {per*1000:.3f} ms/template ({1/per:.1f} t/s)",
        flush=True,
    )

    # value_and_grad (fit-loop gradient pattern)
    data = ct.get_outputs(v0)
    _, vg = ct.build_objective(data, "mod_chi2")
    v = np.clip(v0 + 0.05, 0.05, 0.95)
    t0 = time.time()
    val, g = vg(v)
    val = float(val)
    print(f"value_and_grad compile+first: {time.time()-t0:.1f}s", flush=True)
    n = 20
    t0 = time.time()
    for i in range(n):
        val, g = vg(v + (i + 1) * 1e-6)
        val = float(val)
    per_g = (time.time() - t0) / n
    print(
        f"value_and_grad: {per_g*1000:.1f} ms/call (val {val:.4e},"
        f" |g| {float(np.max(np.abs(np.asarray(g)))):.3e})",
        flush=True,
    )

    # single-template dispatch latency
    fn_t0 = time.time()
    tot = float(np.sum(np.asarray(ct(v0)["hist"]["numu_cc"])))
    print(f"single template first: {time.time()-fn_t0:.1f}s tot={tot:.3e}")
    t0 = time.time()
    for i in range(10):
        float(np.sum(np.asarray(ct(v0 + i * 1e-6)["hist"]["numu_cc"])))
    print(
        f"single-template dispatch: {(time.time()-t0)/10*1000:.1f} ms",
        flush=True,
    )


if __name__ == "__main__":
    main()
