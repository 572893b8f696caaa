"""
Worker process for tests/test_multihost.py: joins a 2-process
jax.distributed cluster over localhost (the multi-host code path, on CPU
devices), evaluates an oscillation-probability sum over a globally sharded
event axis, and prints the scalar.

Usage: python multihost_worker.py <coordinator> <num_procs> <pid>
"""

import os
import sys

coordinator, num_procs, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])

os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

from pisa_tpu.parallel import multihost  # noqa: E402

multihost.init_multihost(
    coordinator, num_procs, pid, local_device_count=4
)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pisa_tpu.ops.osc.kernels import osc_probs_layers  # noqa: E402
from pisa_tpu.ops.osc.pmns import dm_matrix, pmns_matrix_complex  # noqa: E402

assert jax.process_count() == num_procs
mesh = multihost.global_mesh()
assert mesh.devices.size == 4 * num_procs

rng = np.random.default_rng(7)
n = 64
energy = rng.uniform(1.0, 80.0, n)
densities = rng.uniform(1.0, 10.0, (n, 3))
distances = rng.uniform(100.0, 4000.0, (n, 3))

e_g = multihost.make_global_array(energy, mesh)
d_g = multihost.make_global_array(densities, mesh)
x_g = multihost.make_global_array(distances, mesh)

U = pmns_matrix_complex(np.sin(0.5839), np.sin(0.1496), np.sin(0.7854), 1.2)
dm = dm_matrix(7.42e-5, 2.514e-3)
mat_pot = np.diag([1.0, 0.0, 0.0]).astype(complex)
zeros3 = np.zeros((3, 3), complex)


@jax.jit
def total_mumu(e, d, x):
    probs = osc_probs_layers(
        dm, U, mat_pot, zeros3, np.zeros((3, 3)), 1, e, d, x
    )
    # global reduction across all shards (DCN collective between processes)
    return jnp.sum(probs[:, 1, 1])


val = float(total_mumu(e_g, d_g, x_g))
print(f"MULTIHOST_RESULT {pid} {val:.12e}", flush=True)
