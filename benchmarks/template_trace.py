"""
Where the flagship template's time goes on the card, from a profiler trace.

    PYTHONPATH=. python benchmarks/template_trace.py [--devices 4] [--reps 20]
        [--out chiprun_out/template_trace]

Builds the flagship template (``settings/pipeline/IceCube_3y_neutrinos.cfg``)
on the first card and, with ``--devices n`` (n > 1), also sharded with
``CompiledTemplate.shard`` over a 1-D mesh of n cards. Each program is
warmed, then `reps` calls of it are traced in a window of its own. For every
card in the window it prints, per call:

- busy time: the union of the intervals in which a kernel runs on the card,
  and the idle share of the window;
- the summed device time of the oscillation chain kernel, of collectives
  (NCCL), of copies, and of everything else;
- the operations with the most device time.

Writes the reduction as JSON, and the raw ``.xplane.pb`` files, under
``--out``. Fails without a GPU. Every line names the card and its power
limit.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import time
from collections import defaultdict

CFG = "settings/pipeline/IceCube_3y_neutrinos.cfg"


def category(name):
    low = name.lower()
    if "chain_kernel" in low or "tangent_kernel" in low:
        return "chain_kernel"
    if "nccl" in low or any(c in low for c in (
        "all-gather", "all-reduce", "allgather", "allreduce",
        "reduce-scatter", "collective-permute", "all-to-all",
    )):
        return "collective"
    if "memcpy" in low or "memset" in low or low.startswith("copy"):
        return "copy"
    return "other"


def union_ns(intervals):
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def reduce_trace(xplane, reps):
    """Per GPU plane: busy and idle over the window, device time per
    category and the top operations, all per call. Kernel executions are
    the events of the plane's stream lines."""
    from jax.profiler import ProfileData

    out = {}
    for plane in ProfileData.from_file(xplane).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        events = []
        for line in plane.lines:
            if not line.name.lower().startswith("stream"):
                continue
            events += [(e.name, int(e.start_ns), int(e.start_ns +
                        e.duration_ns)) for e in line.events]
        if not events:
            continue
        t0 = min(s for _, s, _ in events)
        t1 = max(e for _, _, e in events)
        busy = union_ns([(s, e) for _, s, e in events])
        by_cat = defaultdict(int)
        by_name = defaultdict(lambda: [0, 0])
        for name, s, e in events:
            by_cat[category(name)] += e - s
            by_name[name][0] += e - s
            by_name[name][1] += 1
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
        out[plane.name] = dict(
            window_ms_per_call=(t1 - t0) / reps / 1e6,
            busy_ms_per_call=busy / reps / 1e6,
            idle_share=1 - busy / max(t1 - t0, 1),
            ms_per_call={k: v / reps / 1e6 for k, v in sorted(by_cat.items())},
            top=[dict(name=n, ms_per_call=t / reps / 1e6, count=c / reps)
                 for n, (t, c) in top],
        )
    return out


def traced(label, fn, args, reps, out_dir):
    import jax

    for _ in range(3):
        jax.block_until_ready(fn(*args))
    tdir = os.path.join(out_dir, label)
    shutil.rmtree(tdir, ignore_errors=True)
    with jax.profiler.trace(tdir):
        t = time.perf_counter()
        for _ in range(reps):
            res = fn(*args)
        jax.block_until_ready(res)
        wall = (time.perf_counter() - t) / reps * 1e3
    xplane = sorted(glob.glob(os.path.join(
        tdir, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    return wall, reduce_trace(xplane, reps)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default="chiprun_out/template_trace")
    args = ap.parse_args()

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.splitlines()[0].strip()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from pisa_tpu.core.pipeline import Pipeline
    from pisa_tpu.parallel import default_mesh

    dev = jax.devices()
    if dev[0].platform != "gpu" or len(dev) < args.devices:
        raise SystemExit(f"needs {args.devices} GPU(s); JAX found"
                         f" {len(dev)} {dev[0].platform}")
    os.makedirs(args.out, exist_ok=True)

    programs = [("1card", Pipeline(CFG).compile())]
    if args.devices > 1:
        programs.append((f"{args.devices}cards", Pipeline(CFG).compile()
                         .shard(default_mesh(args.devices))))
    report = {"card": card, "device_kind": dev[0].device_kind}
    for label, ct in programs:
        v = ct.current_rescaled_values()
        v = np.clip(v + 0.07 * np.sign(0.5 - v), 0.05, 0.95)
        los, his = ct._current_bounds()
        fargs = (jnp.asarray(v), jnp.asarray(los), jnp.asarray(his),
                 ct._data_vals)
        wall, planes = traced(label, ct._jitted, fargs, args.reps, args.out)
        report[label] = dict(traced_wall_ms_per_call=wall, planes=planes)
        print(f"== {label}: template, traced wall {wall:.3f} ms per call"
              f" on {card}", flush=True)
        for pname, p in planes.items():
            cats = ", ".join(f"{k} {v:.4f}" for k, v in p["ms_per_call"].items())
            print(f"  {pname}: window {p['window_ms_per_call']:.4f} ms,"
                  f" busy {p['busy_ms_per_call']:.4f} ms, idle share"
                  f" {p['idle_share']:.3f}; device ms per call: {cats}",
                  flush=True)
            for t in p["top"][:6]:
                print(f"      {t['ms_per_call']:.4f} ms x{t['count']:g}"
                      f"  {t['name'][:90]}", flush=True)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
