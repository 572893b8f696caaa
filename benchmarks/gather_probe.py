"""Microbenchmark of grid->events gather formulations at flagship shapes.

Times the (12, 20k) events gather from the (6, 40k) rate table, which the
rate-deferral histogram replaces, against alternative formulations:

  flat        out = flat_table[gidx]                      (shipping path)
  2d-batched  per-category rows view + take_along_axis
  sorted      statically sorted indices + indices_are_sorted=True
  sorted2d    both of the above
  pad-pull    events pre-grouped by cell: out = expand(table) via the
              inverse (cell -> its events) padded index matrix, i.e. the
              same pattern as the pull TRANSPOSE but used forward, then
              unsorted... (measured for reference; needs the unsort)

Run: python benchmarks/gather_probe.py
"""

import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    rng = np.random.RandomState(0)
    R, G = 6, 40000
    C, n_pad = 12, 20000
    dtype = np.float32

    rows = np.repeat(np.arange(R), C // R)[:C]
    idx = rng.randint(0, G, size=(C, n_pad))
    gidx = rows[:, None] * G + idx  # (C, n_pad) into flat (R*G,)
    table = jnp.asarray(rng.uniform(size=(R, G)).astype(dtype))
    scan_n, reps = 50, 3

    order = np.argsort(gidx.ravel(), kind="stable").astype(np.int32)
    gidx_sorted = gidx.ravel()[order]
    idx_sorted_2d = None  # per-category sort keeps the (C, n_pad) shape
    order2d = np.argsort(idx, axis=1, kind="stable").astype(np.int32)
    idx2d_sorted = np.take_along_axis(idx, order2d, axis=1)

    variants = {}

    gidx_j = jnp.asarray(gidx)
    variants["flat"] = lambda t: t.reshape(-1)[gidx_j]

    rows_j = jnp.asarray(rows)
    idx_j = jnp.asarray(idx)

    def two_d(t):
        expanded = t[rows_j]  # (C, G) static row view
        return jnp.take_along_axis(expanded, idx_j, axis=1)

    variants["2d-batched"] = two_d

    gs_j = jnp.asarray(gidx_sorted)

    def sorted_flat(t):
        return t.reshape(-1).at[gs_j].get(indices_are_sorted=True)

    variants["sorted-flat"] = sorted_flat

    i2s_j = jnp.asarray(idx2d_sorted)

    def sorted_2d(t):
        expanded = t[rows_j]
        return expanded.at[
            jnp.arange(C)[:, None], i2s_j
        ].get(indices_are_sorted=False)

    variants["sorted-2d-taa"] = lambda t: jnp.take_along_axis(
        t[rows_j], i2s_j, axis=1
    )

    # one-hot matmul in the 40k (grid) contraction per category block is
    # memory-infeasible dense; skipped.

    for name, fn in variants.items():
        @jax.jit
        def prog(t, fn=fn):
            def step(c, i):
                out = fn(t * (1.0 + 1e-9 * i))
                return c, jnp.sum(out)
            _, outs = jax.lax.scan(
                step, jnp.zeros((), dtype=t.dtype),
                jnp.arange(scan_n, dtype=t.dtype),
            )
            return outs

        out = jax.block_until_ready(prog(table))
        t0 = time.time()
        for _ in range(reps):
            out = prog(table)
        jax.block_until_ready(out)
        per = (time.time() - t0) / reps / scan_n * 1e3
        print(f"{name:14s} {per:7.3f} ms  (checksum {float(jnp.sum(out)):.6e})",
              flush=True)


if __name__ == "__main__":
    main()
