"""
Bayesian posterior sampling (cf. reference
``pisa_examples/MCMC_example.ipynb``): affine-invariant ensemble MCMC over
the compiled template objective, with all walkers evaluated as one vmapped
batch per step (the replacement for the reference's
llh-server/emcee farm).
"""

import numpy as np

from pisa_tpu import ureg
from pisa_tpu.analysis.bayesian import mcmc_sampling
from pisa_tpu.core.distribution_maker import DistributionMaker


def main(n_walkers=32, n_steps=300, n_burnin=100):
    dm = DistributionMaker(
        ["settings/pipeline/toy_fit_example.cfg"], label="toy"
    )
    dm.params["theta23"].value = 42.0 * ureg.degree
    data = dm.get_outputs(return_sum=True)
    dm.reset_free()

    from pisa_tpu.analysis.gradient import CompiledDistribution

    ct = CompiledDistribution(dm)
    chain, logp, acceptance = mcmc_sampling(
        ct, data, metric="llh", n_walkers=n_walkers, n_steps=n_steps,
        n_burnin=n_burnin, seed=7,
    )  # sized for a GPU; pass smaller numbers on CPU
    names = dm.params.free.names
    print(f"acceptance: {acceptance:.2f}")
    for i, name in enumerate(names):
        samples = np.asarray(chain[..., i]).ravel()
        print(
            f"  {name}: mean {samples.mean():.4f} +- {samples.std():.4f}"
            " (rescaled [0,1] units)"
        )
    return chain


if __name__ == "__main__":
    main()
