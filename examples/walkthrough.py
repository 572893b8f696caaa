"""
End-to-end walkthrough (cf. the reference's README/IceCube-3y notebooks):
build the flagship pipeline, look at templates, compile it, run an Asimov
fit with analytic gradients, and sample a posterior.

Run:  python examples/walkthrough.py  (CPU ok; GPU if available)
"""

import numpy as np

from pisa_tpu.core.pipeline import Pipeline

# --- 1. build + run a pipeline eagerly -------------------------------------
pipeline = Pipeline("settings/pipeline/toy_fit_example.cfg")
maps = pipeline.get_outputs()
print("maps:", maps.names)
print("numu_cc total:", float(np.asarray(maps["numu_cc"].hist).sum()))

# --- 2. compile to one differentiable template function --------------------
ct = pipeline.compile()
print("free params:", ct.free_names)
asimov = ct.get_outputs()  # data = template at truth

value_only, value_and_grad = ct.build_objective(asimov, "mod_chi2")
v0 = ct.current_rescaled_values()
val, grad = value_and_grad(np.clip(v0 + 0.05, 0, 1))
print("objective:", float(val), "| analytic gradient:", np.asarray(grad))

# --- 3. gradient-based Asimov fit ------------------------------------------
from pisa_tpu.analysis.analysis import Analysis

pipeline.params["theta23"].value = 45.0 * pipeline.params["theta23"].value.units
ana = Analysis()
result = ana.fit_recursively(
    asimov, pipeline, "mod_chi2", None, "gradient", {}, None
)
print("best fit:", {p.name: str(p.value) for p in result.params.free})
print("metric at best fit:", float(result.metric_val))

# --- 4. posterior sampling (on-device ensemble MCMC) ------------------------
from pisa_tpu.analysis.bayesian import mcmc_sampling

chain, logp, acc = mcmc_sampling(
    ct, asimov, metric="llh", n_walkers=8, n_steps=100, n_burnin=50, seed=0
)
print(f"MCMC acceptance {acc:.2f}; posterior means:",
      chain.reshape(-1, chain.shape[-1]).mean(axis=0))

# --- 5. plot ----------------------------------------------------------------
try:
    from pisa_tpu.utils.plotter import Plotter

    Plotter(outdir="/tmp/pisa_tpu_example", fmt="png").plot_2d_array(
        maps, fname="templates"
    )
    print("wrote /tmp/pisa_tpu_example/templates.png")
except ImportError:
    pass
