"""
Build and execute the walkthrough notebooks, the counterpart of the
reference's executed ``pisa_examples/*.ipynb``
(``IceCube_3y_oscillations_example.ipynb``, ``README.ipynb``).

Writes examples/notebooks/*.ipynb, executed in order with nbclient on the
CPU backend so the outputs are reproducible anywhere; the committed copies
carry no outputs.

Usage: python docs/make_notebooks.py [outdir]
"""

from __future__ import annotations

import nbformat
from nbclient import NotebookClient


def _nb(cells):
    nb = nbformat.v4.new_notebook()
    nb.metadata["kernelspec"] = {
        "display_name": "Python 3",
        "language": "python",
        "name": "python3",
    }
    nb.cells = [
        (
            nbformat.v4.new_markdown_cell(src)
            if kind == "md"
            else nbformat.v4.new_code_cell(src)
        )
        for kind, src in cells
    ]
    return nb


OSC = [
    ("md", """\
# Oscillograms quick-start

The compiled counterpart of the reference's `pisa_examples/README.ipynb`:
build the oscillogram pipeline (`osc_example.cfg`: a grid of toy "events"
→ Barr-parameterized atmospheric flux → full 3-flavor matter oscillations
through the PREM Earth model), run it, and look at the resulting
P(νμ→νμ) survival map over (energy, cos zenith).

Everything below a `Pipeline` is one differentiable JAX program; the same
config drives the eager per-stage path used here and the compiled
single-dispatch template used by fits."""),
    ("code", """\
import os
os.environ.setdefault("JAX_PLATFORMS", "cpu")  # reproducible CPU outputs
import jax
import numpy as np
import matplotlib
matplotlib.use("Agg")
%matplotlib inline

from pisa_tpu.core.pipeline import Pipeline

pipeline = Pipeline("settings/pipeline/osc_example.cfg")
maps = pipeline.get_outputs()
print(f"{len(maps)} maps:", [m.name for m in maps])"""),
    ("md", """\
Each `Map` holds the binned, oscillation-weighted template for one
flavor/interaction category. For the grid pipeline the "weights" are the
oscillation probabilities themselves, so the `numu_cc` map is the νμ
survival oscillogram."""),
    ("code", """\
import matplotlib.pyplot as plt

numu = maps["numu_cc"]
e = numu.binning["true_energy"].bin_edges.magnitude
cz = numu.binning["true_coszen"].bin_edges.magnitude
fig, ax = plt.subplots(figsize=(7, 4.2))
pc = ax.pcolormesh(cz, e, numu.hist.T, cmap="viridis", vmin=0, vmax=1)
ax.set_yscale("log")
ax.set_xlabel(r"$\\cos\\theta_z$ (true)")
ax.set_ylabel("energy (true) [GeV]")
ax.set_title(r"P($\\nu_\\mu\\to\\nu_\\mu$) oscillogram")
fig.colorbar(pc, label="survival probability")
fig.tight_layout()
print(f"map shape {numu.hist.shape}, total {numu.hist.sum():.5g}")"""),
    ("md", """\
## Compiled templates

`pipeline.compile()` traces the whole stage chain into ONE jitted
`rescaled_params -> template` function — a minimizer iteration is a single
device dispatch, and `jax.grad` flows through the full physics chain
(oscillations included)."""),
    ("code", """\
import time

ct = pipeline.compile()
v0 = ct.current_rescaled_values()
ms = ct.get_outputs(v0)          # first call compiles
t0 = time.time()
reps = 5
totals = np.asarray(ct.scan_totals(np.tile(v0, (reps, 1))))
dt = (time.time() - t0) / reps
print(f"{len(v0)} free params: {ct.free_names}")
print(f"compiled in-device template: {dt*1e3:.1f} ms/template (CPU backend)")
print("per-template summed bin counts:", totals.round(3))"""),
]


ICECUBE = [
    ("md", """\
# IceCube 3-year oscillation analysis

The compiled counterpart of the reference's
`pisa_examples/IceCube_3y_oscillations_example.ipynb`: the
neutrino pipeline (`csv_loader → honda_ip → barr_simple → prob3 → aeff →
hist → hypersurfaces`, 240k MC events) plus the atmospheric-muon
background pipeline, combined by a `DistributionMaker`, then an Asimov
θ₂₃ fit with ANALYTIC gradients through the compiled template.

> The vendored `neutrino_mc.csv.bz2` is a synthetic stand-in with the
> data-release schema; swap in the real release file for physics
> results."""),
    ("code", """\
import os
os.environ.setdefault("JAX_PLATFORMS", "cpu")  # reproducible CPU outputs
import jax
import numpy as np

from pisa_tpu import ureg
from pisa_tpu.core.distribution_maker import DistributionMaker

dm = DistributionMaker(
    [
        "settings/pipeline/IceCube_3y_neutrinos.cfg",
        "settings/pipeline/IceCube_3y_muons.cfg",
    ],
    label="IceCube 3y",
)
print(f"{len(dm.params.free)} free params:")
for p in dm.params.free:
    print(f"  {p.name:24s} = {p.value}")"""),
    ("md", """\
## Asimov dataset

The "data" is the model's own prediction at the truth parameters — the
fit should recover the truth exactly, which is the standard closure test
(and the sensitivity workhorse)."""),
    ("code", """\
truth_t23 = dm.params["theta23"].value
data = dm.get_outputs(return_sum=True)
print("Asimov data:", [f"{m.name}: {m.hist.sum():.1f} events" for m in data])"""),
    ("md", """\
## Gradient fit

Perturb θ₂₃ by 3° and fit it back. The `gradient` method runs bounded
L-BFGS on the compiled template with `jax.value_and_grad` — one analytic
gradient costs ~2 templates, where the reference's finite-difference
L-BFGS-B burns ~2·N templates per gradient step
(reference `analysis.py:1561`)."""),
    ("code", """\
import time

from pisa_tpu.analysis.analysis import Analysis

dm.params["theta23"].value = truth_t23 + 3.0 * ureg.degree
ana = Analysis()
t0 = time.time()
result = ana.fit_recursively(data, dm, "mod_chi2", None, "gradient", {}, None)
print(f"fit wall-clock {time.time()-t0:.1f}s (CPU backend)")
print(f"metric_val {result.metric_val:.4g}")
print(f"theta23 fit = {result.params['theta23'].value}")
print(f"theta23 truth = {truth_t23}")"""),
    ("code", """\
import matplotlib
matplotlib.use("Agg")
%matplotlib inline
import matplotlib.pyplot as plt

total = sum(np.asarray(m.hist) for m in data)
fig, axes = plt.subplots(1, 2, figsize=(9, 3.6))
for k, ax in enumerate(axes):
    im = ax.imshow(total[:, :, k].T, origin="lower", aspect="auto",
                   cmap="viridis")
    ax.set_title(f"Asimov counts, PID bin {k}")
    ax.set_xlabel("energy bin")
    ax.set_ylabel("coszen bin")
    fig.colorbar(im, ax=ax)
fig.tight_layout()"""),
]


MCMC = [
    ("md", """\
# Bayesian posterior sampling (MCMC)

The compiled counterpart of the reference's
`pisa_examples/MCMC_example.ipynb`. The reference farms a serial `emcee`
sampler out to a fork-server of llh processes over TCP sockets
(`pisa/utils/llh_server.py`); here the affine-invariant stretch-move
ensemble is NATIVE and vmapped — every walker's template is one row of a
single batched device program, so one MCMC step costs one dispatch."""),
    ("code", """\
import os
os.environ.setdefault("JAX_PLATFORMS", "cpu")  # reproducible CPU outputs
import jax
import numpy as np

from pisa_tpu import ureg
from pisa_tpu.analysis.bayesian import mcmc_sampling
from pisa_tpu.analysis.gradient import CompiledDistribution
from pisa_tpu.core.distribution_maker import DistributionMaker

dm = DistributionMaker(["settings/pipeline/toy_fit_example.cfg"],
                       label="toy")
dm.params["theta23"].value = 42.0 * ureg.degree
data = dm.get_outputs(return_sum=True)   # Asimov "data" at the truth
dm.reset_free()
print("free params:", dm.params.free.names)"""),
    ("md", """\
## Sample

`mcmc_sampling` runs the whole ensemble inside one `lax.scan` — the chain
below (16 walkers x 150 steps after burn-in) is a single compiled device
program, not 2400 Python-loop likelihood calls."""),
    ("code", """\
ct = CompiledDistribution(dm)
chain, logp, acceptance = mcmc_sampling(
    ct, data, metric="llh", n_walkers=16, n_steps=150, n_burnin=50,
    seed=7,
)  # CPU-sized; raise walkers/steps on a GPU
print(f"chain shape {chain.shape} (steps, walkers, params)")
print(f"acceptance fraction: {acceptance:.2f}")"""),
    ("code", """\
import matplotlib
matplotlib.use("Agg")
%matplotlib inline
import matplotlib.pyplot as plt

names = dm.params.free.names
flat = np.asarray(chain).reshape(-1, chain.shape[-1])
fig, axes = plt.subplots(1, len(names), figsize=(4 * len(names), 3.2))
for i, (ax, name) in enumerate(zip(np.atleast_1d(axes), names)):
    ax.hist(flat[:, i], bins=40, color="#3a7ca5")
    ax.set_xlabel(f"{name} (rescaled [0,1])")
    mean, std = flat[:, i].mean(), flat[:, i].std()
    ax.set_title(f"{mean:.3f} ± {std:.3f}")
fig.suptitle("marginal posteriors")
fig.tight_layout()
for i, name in enumerate(names):
    print(f"  {name}: {flat[:, i].mean():.4f} ± {flat[:, i].std():.4f}")"""),
    ("md", """\
## Chain diagnostics

Walker traces should mix quickly around the truth (the Asimov data were
generated at θ₂₃ = 42°, so the rescaled posterior should cover the
corresponding rescaled value). The reference gets the same ensemble from
`emcee` + its TCP llh-server farm; here the walker batch IS the device
batch, so scaling walkers is free up to the chip's template throughput."""),
    ("code", """\
fig, ax = plt.subplots(figsize=(7, 3))
for w in range(chain.shape[1]):
    ax.plot(np.asarray(chain[:, w, 0]), lw=0.5, alpha=0.6)
ax.set_xlabel("step (post burn-in)")
ax.set_ylabel(f"{names[0]} (rescaled)")
ax.set_title("walker traces")
fig.tight_layout()
print(f"per-walker std of final step: "
      f"{np.asarray(chain)[-1, :, 0].std():.4f}")"""),
]


MULTIDET = [
    ("md", """\
# Multi-detector joint fit

The compiled counterpart of the reference's
`pisa_examples/Multi_detector_test.ipynb`: two detectors observe the same
oscillation physics — `theta23`/`deltam31` are SHARED `Param` objects
across both pipelines, while detector systematics stay independent (the
`Detectors` container suffixes them `_detA`/`_detB`; cf. reference
`pisa/core/detectors.py:224-234`)."""),
    ("code", """\
import os
os.environ.setdefault("JAX_PLATFORMS", "cpu")  # reproducible CPU outputs
import jax
import tempfile
from pathlib import Path

from pisa_tpu import ureg
from pisa_tpu.core.detectors import Detectors
from pisa_tpu.utils.resources import find_resource

tmpdir = tempfile.mkdtemp()

def detector_config(det_name):
    text = open(
        find_resource("settings/pipeline/toy_fit_example.cfg")).read()
    text = text.replace(
        "name = neutrinos",
        f"name = neutrinos\\ndetector_name = {det_name}")
    path = Path(tmpdir) / f"{det_name}.cfg"
    path.write_text(text)
    return str(path)

detectors = Detectors(
    [detector_config("detA"), detector_config("detB")],
    shared_params=["theta23", "deltam31", "theta13", "delta_index"],
)
print("joint free params:")
for p in detectors.params.free:
    print(f"  {p.name}")"""),
    ("md", """\
## Joint Asimov fit

Fit the shared angle plus ONE per-detector systematic (`aeff_scale_detB`)
against Asimov data generated at the truth. The gradient method
differentiates through both compiled detector templates at once."""),
    ("code", """\
from pisa_tpu.analysis.analysis import Analysis

for p in detectors.params.free:
    if p.name not in ("theta23", "aeff_scale_detB"):
        p.is_fixed = True

detectors.params["theta23"].value = 42.0 * ureg.degree
data = detectors.get_outputs(return_sum=True)
detectors.params["theta23"].value = 44.0 * ureg.degree  # perturb

result = Analysis().fit_recursively(
    data, detectors, "mod_chi2", None, "gradient", {}, None)
print(f"joint fit metric: {result.metric_val:.3g}")
print(f"theta23 fit  = {result.params['theta23'].value}")
print("theta23 truth = 42 degree")
print(f"aeff_scale_detB fit = {result.params['aeff_scale_detB'].value}")"""),
    ("md", """\
## Shared-param identity

Setting the shared angle once moves BOTH detectors' templates — the
`Param` objects are literally the same across the two pipelines (the
reference relies on the same aliasing invariant,
`pisa/core/detectors.py:209-238`)."""),
    ("code", """\
import numpy as np

def grand_total(x):
    if hasattr(x, "hist"):
        return float(np.asarray(x.hist).sum())
    return sum(grand_total(y) for y in x)

detectors.params["theta23"].value = 40.0 * ureg.degree
out40 = detectors.get_outputs(return_sum=False)
detectors.params["theta23"].value = 45.0 * ureg.degree
out45 = detectors.get_outputs(return_sum=False)
for det, a, b in zip(("detA", "detB"), out40, out45):
    ta, tb = grand_total(a), grand_total(b)
    print(f"{det}: total @40deg {ta:.2f} -> @45deg {tb:.2f}"
          f"  (shift {(tb - ta) / ta:+.2%})")"""),
]


VARBIN = [
    ("md", """\
# Variable binning

The compiled counterpart of the reference's
`pisa_examples/Variable_binning_example.ipynb`: a `VarBinning` output
splits the events into mutually-exclusive selections (here two PID
bands), each histogrammed under its OWN `MultiDimBinning` — e.g. a
fine binning where the detector resolves well and a coarse one where it
does not. `get_outputs()` returns one MapSet per selection."""),
    ("code", """\
import os
os.environ.setdefault("JAX_PLATFORMS", "cpu")  # reproducible CPU outputs
import jax
import numpy as np

from pisa_tpu.core.pipeline import Pipeline

pipeline = Pipeline("settings/pipeline/varbin_example.cfg")
outputs = pipeline.get_outputs()
for i, mapset in enumerate(outputs):
    shape = next(iter(mapset)).hist.shape
    total = sum(float(np.asarray(m.hist).sum()) for m in mapset)
    print(f"selection {i} ({mapset.name}): shape {shape},"
          f" total {total:.5g}")"""),
    ("code", """\
import matplotlib
matplotlib.use("Agg")
%matplotlib inline
import matplotlib.pyplot as plt

fig, axes = plt.subplots(1, len(outputs), figsize=(9, 3.4))
for ax, mapset in zip(np.atleast_1d(axes), outputs):
    total = sum(np.asarray(m.hist) for m in mapset)
    im = ax.imshow(total.T, origin="lower", aspect="auto", cmap="viridis")
    ax.set_title(f"{mapset.name}: {total.shape}")
    ax.set_xlabel("energy bin")
    ax.set_ylabel("coszen bin")
    fig.colorbar(im, ax=ax)
fig.tight_layout()"""),
    ("md", """\
The two selections are mutually exclusive by construction — the pipeline
validates the selection cuts at init (cf. reference
`pipeline.py:685,714`) — so the same event can never be double-counted
across MapSets."""),
]


EVENT_INFO = [
    ("md", """\
# Event-wise information from a pipeline

The compiled counterpart of the reference's
`pisa_examples/event_info.ipynb`: run a pipeline WITHOUT the final
histogramming stage and read the per-event arrays (weights, energies,
flux factors, oscillation probabilities) straight off the shared
`ContainerSet` — the event-level view of exactly the same computation
that normally lands in binned templates.

Every `Container` holds its variables simultaneously in an `events`
representation and any number of binned representations, translated
lazily on access (cf. reference `container.py:1-181`)."""),
    ("code", """\
import os
os.environ.setdefault("JAX_PLATFORMS", "cpu")  # reproducible CPU outputs
import jax
import numpy as np

from pisa_tpu.core.pipeline import Pipeline

pipeline = Pipeline("settings/pipeline/example.cfg")
print("stages:", [f"{s.stage_name}.{s.service_name}"
                  for s in pipeline.stages])"""),
    ("md", """\
Drop the `utils.hist` stage (events → binned templates) so the pipeline
stops at per-event weights, then run it."""),
    ("code", """\
pipeline.stages = [
    s for s in pipeline.stages if s.service_name != "hist"
]
pipeline.run()
containers = pipeline.data.containers
print(f"{len(containers)} containers:",
      [c.name for c in containers][:6], "...")"""),
    ("code", """\
nc = {c.name: c for c in containers}["numu_cc"]
nc.representation = "events"
print("per-event keys:", sorted(nc.keys)[:10], "...")
for key in ("true_energy", "true_coszen", "weights",
            "prob_e", "prob_mu"):
    arr = np.asarray(nc[key])
    print(f"{key:13s} shape {arr.shape}  "
          f"[{arr.min():.4g}, {arr.max():.4g}]")"""),
    ("md", """\
The weights at this point carry flux x oscillation x effective-area
factors per event. Histogram them manually to confirm they reproduce the
pipeline's binned output."""),
    ("code", """\
import matplotlib
matplotlib.use("Agg")
%matplotlib inline
import matplotlib.pyplot as plt

e = np.asarray(nc["true_energy"])
w = np.asarray(nc["weights"])
fig, ax = plt.subplots(figsize=(6.5, 3.6))
bins = np.logspace(0, 2, 25)
ax.hist(e, bins=bins, weights=w, histtype="step", lw=2,
        label=r"$\\nu_\\mu$ CC (weighted)")
ax.hist(e, bins=bins, histtype="step", lw=1.2, ls="--",
        label="raw MC counts")
ax.set_xscale("log")
ax.set_xlabel("true energy [GeV]")
ax.set_ylabel("events / bin")
ax.legend()
fig.tight_layout()
print(f"sum of weights: {w.sum():.5g} over {w.size} events")"""),
]


PISA_MODES = [
    ("md", """\
# Stage calc/apply modes

The compiled counterpart of the reference's
`pisa_examples/pisa_modes.ipynb`: every stage has a `calc_mode`
(representation its physics is computed in) and an `apply_mode`
(representation its weight modification is applied in). The same
pipeline can compute oscillations on a coarse grid that events look up
('mixed', the fast production shape) or per event ('events', exact but
most work).

The auto-generated service support matrix lives at
`artifacts/ci/service_matrix.md` (the analog of the reference's
`test_services.py` table)."""),
    ("code", """\
import time

import os
os.environ.setdefault("JAX_PLATFORMS", "cpu")  # reproducible CPU outputs
import jax
import numpy as np

from pisa_tpu.config.parser import parse_pipeline_config
from pisa_tpu.core.pipeline import Pipeline

mixed = Pipeline("settings/pipeline/fast_example.cfg")

cfg = parse_pipeline_config("settings/pipeline/fast_example.cfg")
cfg[("osc", "prob3")]["calc_mode"] = "events"  # osc.prob3 per event
cfg[("osc", "prob3")]["apply_mode"] = "events"
events = Pipeline(cfg)
print("mixed osc calc_mode:", mixed.stages[2].calc_mode.names)
print("events osc calc_mode:", events.stages[2].calc_mode)"""),
    ("code", """\
t0 = time.time(); ms_mixed = mixed.get_outputs()
t_mixed = time.time() - t0
t0 = time.time(); ms_events = events.get_outputs()
t_events = time.time() - t0
print(f"mixed (grid-calc osc):  {t_mixed:.2f}s")
print(f"events (per-event osc): {t_events:.2f}s")"""),
    ("md", """\
The grid-calc template approximates each event's oscillation probability
by its grid cell average; per-event calc is exact. Compare the binned
totals:"""),
    ("code", """\
for m in ms_mixed:
    a = float(np.asarray(m.hist).sum())
    b = float(np.asarray(ms_events[m.name].hist).sum())
    if a > 0:
        print(f"{m.name:14s} grid {a:9.4f}  events {b:9.4f}  "
              f"ratio {b / a:.4f}")"""),
    ("md", """\
## Compiled per-event-oscillation templates

Both modes compile to ONE jitted template program — the per-event osc
pipeline stacks its 12 flavor categories into a single category-axis
trace (two fixed-nubar-sign propagations over the stacked event axis)
rather than tracing 12 separate chains."""),
    ("code", """\
ct = events.compile()
print("stacked:", ct._trace_data is not ct.pipeline.data)
v0 = ct.current_rescaled_values()
ct.get_outputs(v0)  # compile
t0 = time.time()
reps = 5
np.asarray(ct.scan_totals(np.tile(v0, (reps, 1))))
print(f"compiled per-event-osc template:"
      f" {(time.time() - t0) / reps * 1e3:.1f} ms/template"
      f" (CPU backend)")"""),
]


DAEMONFLUX = [
    ("md", """\
# DAEMONFLUX stage

The compiled counterpart of the reference's
`pisa_examples/test_daemonflux_stage.ipynb`: the daemonflux calibrated
atmospheric flux (arXiv:2303.00022) with 24 correlated `daemon_*`
parameters and a single covariance chi2 penalty replacing their
individual priors (reference `param.py:1388`).

Here the stage runs its NATIVE traceable response model (the external
`daemonflux` package is not installed), with the VENDORED correlation
matrix whose inverse diagonal reproduces the reference's published
single-pull penalties exactly — see
`scripts/make_daemonflux_correlations.py` for the derivation."""),
    ("code", """\
import os
os.environ.setdefault("JAX_PLATFORMS", "cpu")  # reproducible CPU outputs
import jax
import numpy as np

from pisa_tpu.core.pipeline import Pipeline
from pisa_tpu import ureg

model = Pipeline("settings/pipeline/IceCube_3y_neutrinos_daemon.cfg")
daemon_names = [p.name for p in model.params
                if p.name.startswith("daemon_")
                and p.name not in ("daemon_chi2", "daemon_params_len")]
print(f"{len(daemon_names)} daemon params; "
      f"{len(model.params.free)} free params total")"""),
    ("md", """\
## Penalty term with covariance

Pull single parameters by +1 sigma and read back the correlated chi2
penalty (through `ParamSet.priors_penalty`, which switches all
`daemon_*` params to the one covariance chi2). The printed reference
values are the penalties the reference repo itself publishes in its
executed `test_daemonflux_stage.ipynb` — they match because the
vendored correlation matrix is constructed from them."""),
    ("code", """\
PUBLISHED = {  # reference notebook outputs (mod_chi2, +1 sigma pulls)
    "daemon_K_158G": 20.669470253081645,
    "daemon_antiK_2P": 1031.85177816583,
    "daemon_pi_20T": 502.47445811353646,
    "daemon_pi_31G": 4.444786009326376,
    "daemon_GSF_1": 16.409186227794525,
    "daemon_GSF_4": 1.1634572364445062,
}
model.reset_free()
model.get_outputs()
for name, ref_val in PUBLISHED.items():
    model.reset_free()
    model.params[name].value = 1.0 * ureg.dimensionless
    model.get_outputs()  # recomputes daemon_chi2
    pen = float(model.params.priors_penalty("mod_chi2"))
    print(f"pulling {name:18s} by +1 sigma -> penalty ="
          f" {pen:12.6f}   (reference: {ref_val:.6f})")"""),
    ("md", """\
Without the covariance term each pull would cost exactly 1.0 (one unit
Gaussian at 1 sigma); the calibrated penalties range from ~1.2 to ~1032
because the daemonflux parameters are strongly constrained by their
correlations with the rest of the calibration."""),
    ("code", """\
from pisa_tpu.utils.daemonflux_native import (
    DAEMON_PARAM_NAMES, NativeDaemonFlux,
)
import matplotlib
matplotlib.use("Agg")
%matplotlib inline
import matplotlib.pyplot as plt

native = NativeDaemonFlux(
    correlations="flux/daemonflux_correlations.json")
log10e = np.linspace(-0.5, 4, 300)
values = {n: 0.0 for n in DAEMON_PARAM_NAMES}
fig, ax = plt.subplots(figsize=(6.8, 3.8))
for pulled in ("pi_31G", "K_158G", "pi_20T", "GSF_3"):
    v = dict(values); v[pulled] = 1.0
    mod_e, mod_mu = native.modification(log10e, 1, v)
    ax.plot(10.0 ** log10e, np.asarray(mod_mu),
            label=f"{pulled} +1$\\sigma$")
ax.set_xscale("log")
ax.axhline(1.0, color="k", lw=0.6)
ax.set_xlabel("neutrino energy [GeV]")
ax.set_ylabel(r"$\\nu_\\mu$ flux modification")
ax.legend(fontsize=8)
fig.tight_layout()
print("native response model: analytic log-normal kernels"
      " (stand-in shapes; calibrated gradients need the real package)")"""),
    ("md", """\
Inside a COMPILED template the same correlated chi2 is applied by the
objective builders (`CompiledTemplate`/`CompiledDistribution`), and the
daemon parameters get analytic gradients end-to-end — the reference
cannot differentiate through the daemonflux package at all."""),
]


ALL_NOTEBOOKS = (
    ("oscillograms", OSC),
    ("icecube_3y_fit", ICECUBE),
    ("mcmc", MCMC),
    ("multi_detector", MULTIDET),
    ("variable_binning", VARBIN),
    ("event_info", EVENT_INFO),
    ("pisa_modes", PISA_MODES),
    ("daemonflux_stage", DAEMONFLUX),
)


def main():
    import argparse
    import os
    import pathlib

    known = [name for name, _ in ALL_NOTEBOOKS]
    ap = argparse.ArgumentParser(
        description="Execute and write the example notebooks."
    )
    ap.add_argument(
        "notebooks", nargs="*", metavar="NOTEBOOK",
        help=f"subset to build (default: all). Choices: {', '.join(known)}",
    )
    ap.add_argument(
        "--outdir", default="examples/notebooks",
        help="output directory (default: %(default)s)",
    )
    args = ap.parse_args()
    unknown = sorted(set(args.notebooks) - set(known))
    if unknown:
        ap.error(f"unknown notebook name(s) {unknown};"
                 f" choices: {', '.join(known)}")
    only = set(args.notebooks)
    outdir = pathlib.Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    todo = [
        (name, cells)
        for name, cells in ALL_NOTEBOOKS
        if not only or name in only
    ]
    for name, cells in todo:
        nb = _nb(cells)
        print(f"executing {name}.ipynb ...", flush=True)
        client = NotebookClient(
            nb, timeout=1800, kernel_name="python3",
            resources={"metadata": {"path": "."}},
        )
        client.execute()
        path = outdir / f"{name}.ipynb"
        nbformat.write(nb, path)
        n_out = sum(len(c.get("outputs", [])) for c in nb.cells)
        print(f"wrote {path} ({n_out} outputs)")


if __name__ == "__main__":
    main()
